"""End-to-end demonstration of OSSID on the card (the port of
ossid_code_tpu/scripts/demo_e2e.py; the same arguments and the same JSON
summary line):

  1. build a synthetic BOP world (objects, scenes, template grids);
  2. evaluate DTOID before training (`test_dtoid_model`);
  3. pretrain DTOID offline (`OfflineTrainer`, GT masks); with --hard on a
     disjoint object world, as the reference pretrains on other objects;
     with --use_maskrcnn, the class-conditional detector in DTOID's place,
     pretrained on the test world's frames with every visible object
     labelled (`data/detect.py`), which --hard then implies (--same_pretrain);
  4. evaluate DTOID again;
  5. build PPF hypothesis generators with host ICP of the top 30;
  6. train the Zephyr scorer offline (`ZephyrOfflineTrainer`) and calibrate
     its alignment head;
  7. with --hard, score every target's full scene with the trained scorer
     (the bootstrap rows the loop falls back on while DTOID is unconfident);
  8. run the online self-supervised loop with host ICP of the pick;
  9. report detection IoU (before/after), ADD(-S)<0.1d and BOP AR.

Usage: python -m ossid_code_torch.scripts.demo_e2e [--hard] [--frames 12] [--epochs 20]
Runs on the card unless --device cpu. Prints a JSON summary line at the end.

Beyond the JAX script's arguments: `--device`, and three sizes for small
test runs on the CPU, whose defaults are the JAX script's fixed values:
`--densenet_blocks` (12,24,16), `--num_points` (the scorer's 256 model
points) and `--zephyr_hypos` (64 hypotheses a scorer training frame).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

STAGES = ("world", "eval_untrained", "pretraining", "eval_pretrained", "hypothesis_generators",
          "scorer_training", "calibration", "bootstrap", "loop", "ar")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=None,
                        help="frames per object stream (default 12; 60 with --hard)")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--zephyr_epochs", type=int, default=16)
    parser.add_argument("--img_h", type=int, default=240)
    parser.add_argument("--img_w", type=int, default=320)
    parser.add_argument("--root", type=str, default=None)
    parser.add_argument("--hard", action="store_true",
                        help="LM-O-difficulty world: 6 asymmetric textured objects, two-row cluttered "
                             "layout with inter-object occlusion, unannotated distractor clutter, 60+ "
                             "frame streams")
    parser.add_argument("--n_objects", type=int, default=0,
                        help="limit the test world to the first N objects (0 = all)")
    parser.add_argument("--n_views", type=int, default=10, help="template-grid views per object")
    parser.add_argument("--n_templates", type=int, default=6,
                        help="local templates per detection forward (n_local_test)")
    parser.add_argument("--pretrain_n", type=int, default=0,
                        help="size of the procedurally sampled pretraining object set (0 = the fixed "
                             "6-object pretrain_objects() world)")
    parser.add_argument("--pretrain_frames", type=int, default=None,
                        help="frames in the pretraining world (default: --frames)")
    parser.add_argument("--rank_blend", type=float, default=None,
                        help="host-side blend weight of the z-scored alignment statistic in "
                             "hypothesis ranking (default: net-only argmax)")
    parser.add_argument("--align_feats", type=int, default=1,
                        help="feed the 12-cell alignment-fraction grid to the scorer head "
                             "(0 reverts to the plain scorer)")
    parser.add_argument("--use_maskrcnn", action="store_true",
                        help="the class-conditional detector (models/maskrcnn.py) in DTOID's place; implies "
                             "--same_pretrain (it has no templates, so it trains on its classes)")
    parser.add_argument("--same_pretrain", action="store_true",
                        help="pretrain DTOID on the TEST objects (legacy upper-bound protocol)")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--densenet_blocks", type=str, default="12,24,16",
                        help="DenseNet block depths of DTOID's backbone")
    parser.add_argument("--num_points", type=int, default=256, help="the scorer's model points")
    parser.add_argument("--zephyr_hypos", type=int, default=64,
                        help="hypotheses a scorer training frame")
    args = parser.parse_args(argv)
    if args.frames is None:
        args.frames = 60 if args.hard else 12
    return args


def main(argv=None, on_stage=None):
    """Run the demo; prints the JSON summary line and returns the summary
    with the wall seconds of each stage ('stage_s') and the schedule's
    counts ('counts'). `on_stage(name, **objects)`, when given, is called as
    each stage of STAGES ends (after the last kernel of the stage has been
    queued)."""
    import torch

    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.detect import DetectDataset
    from ossid_code_torch.data.dtoid_bop import NumpyLoader, get_dataloaders
    from ossid_code_torch.data.synthetic import (
        default_objects, hard_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
        pretrain_objects, sampled_objects,
    )
    from ossid_code_torch.device import resolve_device
    from ossid_code_torch.eval.bop_ar import BopEvaluator
    from ossid_code_torch.hypo.ppf import PPFModelMeters
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop, model_cloud_from_ply, test_dtoid_model
    from ossid_code_torch.models.maskrcnn import MaskRCNN
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.render.mesh import load_ply
    from ossid_code_torch.train.offline import GenericTrainer, OfflineTrainer
    from ossid_code_torch.train.zephyr_offline import ZephyrOfflineTrainer
    from ossid_code_torch.utils.geometry import depth2cloud

    args = parse_args(argv)
    device = resolve_device(args.device)
    stage_s: dict = {}
    clock = [time.perf_counter()]

    def stage(name, **objects):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stage_s[name] = now - clock[0]
        clock[0] = now
        if on_stage is not None:
            on_stage(name, **objects)

    h, w = args.img_h, args.img_w
    assert h % 16 == 0 and w % 16 == 0
    root = args.root or tempfile.mkdtemp(prefix="ossid_demo_")
    log("world ->", root, "(hard)" if args.hard else "")
    objects = hard_objects() if args.hard else default_objects()
    if args.n_objects:
        objects = dict(list(objects.items())[: args.n_objects])
    make_synthetic_bop(root, n_frames=args.frames, img_h=h, img_w=w, objects=objects,
                       layout="cluttered" if args.hard else "spread", n_clutter=3 if args.hard else 0)
    grid = os.path.join(root, "grid")
    make_template_grid(grid, objects, n_views=args.n_views)

    cfg = default_config()
    cfg.dataset.bop_root = root
    cfg.dataset.test_dataset_name = "synth"
    cfg.dataset.grid_root = grid
    cfg.dataset.shorter_length = h
    fh, fw = h // 16 - 1, w // 16 - 1
    cfg.dataset.heatmap_shorter_length = fh
    cfg.dataset.n_local_test = args.n_templates
    cfg.model.img_h, cfg.model.img_w = h, w
    cfg.model.heatmap_h, cfg.model.heatmap_w = fh, fw
    cfg.model.densenet_blocks = tuple(int(b) for b in args.densenet_blocks.split(","))
    cfg.train.batch_size = 4
    cfg.dataset.load_zephyr_result = True

    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    zr_path = os.path.join(root, "zr.pkl")
    make_zephyr_results_pkl(zr_path, bop, score=50.0)
    with open(zr_path, "rb") as f:
        zr_list = pickle.load(f)
    zephyr_results = {(r["obj_id"], r["scene_id"], r["im_id"]): r for r in zr_list}
    cfg.dataset.zephyr_result_path = zr_path

    train_loader, _, test_loader = get_dataloaders(cfg, zr_list)
    test_loader.dataset.sortTargets()
    if args.use_maskrcnn:
        if args.hard and not args.same_pretrain:
            log("--use_maskrcnn implies --same_pretrain (class-conditional detector; see --help)")
            args.same_pretrain = True
        cfg.dataset.n_classes = int(max(bop.obj_ids))
        # its anchors and decoder follow the dataset's image size
        cfg.dataset.img_h, cfg.dataset.img_w = h, w
        model = MaskRCNN(cfg, seed=0, device=device)
    else:
        model = DtoidModel(cfg, seed=0, device=device)
    detector = "MaskRCNN" if args.use_maskrcnn else "DTOID"
    disjoint = args.hard and not args.same_pretrain
    pre_updates = {"dataset": {"load_zephyr_result": False}}
    if disjoint:
        # the reference pretrains on other objects (ShapeNet renders); the
        # stream's objects are novel, and the online loop adapts to them
        log("building disjoint pretraining world ...")
        pre_objects = sampled_objects(args.pretrain_n, seed=11) if args.pretrain_n else pretrain_objects()
        make_synthetic_bop(root, dataset_name="synth_pre", n_frames=args.pretrain_frames or args.frames,
                           img_h=h, img_w=w, objects=pre_objects, layout="cluttered", n_clutter=3, seed=7,
                           max_per_frame=6)
        grid_pre = os.path.join(root, "grid_pre")
        make_template_grid(grid_pre, pre_objects, n_views=args.n_views, seed=1)
        pre_updates["dataset"].update({"test_dataset_name": "synth_pre", "grid_root": grid_pre})
    pre_cfg = cfg.merged(pre_updates)
    pre_train_loader, _, _ = get_dataloaders(pre_cfg, None)
    stage("world")

    # ---- detection quality before any training ----------------------------
    log(f"eval: untrained {detector} ...")
    res0 = test_dtoid_model(model, test_loader)
    iou_untrained = float(np.mean([r["dtoid_iou"] for r in res0]))
    stage("eval_untrained", rows=res0)

    # ---- offline DTOID pretraining (GT masks, single templates) -----------
    log(f"pretraining {detector} for {args.epochs} epochs ({'disjoint' if disjoint else 'test'} objects) ...")
    if args.use_maskrcnn:
        # one row a frame with every visible object labelled: rows of one
        # object each would teach the detector that the others are background
        pre_loader = NumpyLoader(DetectDataset(bop, cfg.dataset), batch_size=int(cfg.train.batch_size),
                                 shuffle=True, seed=0, drop_last=True)
        trainer = GenericTrainer(model, cfg)
    else:
        pre_loader, trainer = pre_train_loader, OfflineTrainer(model, cfg, n_devices=1)
    pretrain_steps = 0
    for ep in range(args.epochs):
        m = trainer.train_epoch(pre_loader)
        pretrain_steps += len(pre_loader)
        if ep % 5 == 0 or ep == args.epochs - 1:
            seg = m.get("loss_mask" if args.use_maskrcnn else "loss_seg", float("nan"))
            log(f"  epoch {ep}: loss {m.get('loss', float('nan')):.3f} seg {seg:.3f}")
    model.clear_cache()
    stage("pretraining", trainer=trainer)

    log(f"eval: pretrained {detector} ...")
    res1 = test_dtoid_model(model, test_loader)
    iou_pretrained = float(np.mean([r["dtoid_iou"] for r in res1]))
    stage("eval_pretrained", rows=res1)

    # ---- hypothesis generators (native PPF, host ICP of the top 30) -------
    hypo_gens = {oid: PPFModelMeters(bop.getObjPath(oid), ModelSamplingDist=0.04, scene_sampling_dist=0.04,
                                     ref_pt_rate=0.3, refine_top=30)
                 for oid in bop.obj_ids}
    clouds = {oid: model_cloud_from_ply(load_ply(bop.getObjPath(oid)), n_points=1024) for oid in bop.obj_ids}
    stage("hypothesis_generators")

    # ---- offline zephyr training (hard negatives from real PPF hypos) -----
    log("training zephyr scorer ...")
    zmodel = ZephyrModel(num_points=args.num_points, inconst_ratio_th=100.0, seed=0, need_uv=False,
                         align_feats=bool(args.align_feats), device=device)
    if args.rank_blend is not None:
        zmodel.rank_blend = float(args.rank_blend)
    ztrainer = ZephyrOfflineTrainer(zmodel, bop, clouds, hypo_gens=hypo_gens, n_hypos=args.zephyr_hypos, seed=0)
    for ep in range(args.zephyr_epochs):
        loss = ztrainer.train_epoch(max_frames=24, seed=ep)
        log(f"  zephyr epoch {ep}: loss {loss:.3f}")
    stage("scorer_training")
    cal = None
    if args.align_feats:
        # deterministic post-hoc fit of the residual alignment head
        cal = ztrainer.calibrate_align_head(max_frames=None)
        log(f"align head calibrated: {cal}")
    stage("calibration", ztrainer=ztrainer, calibration=cal)

    # ---- bootstrap: full-scene zephyr results ------------------------------
    # The reference pseudo-labels unconfident-detector frames from zephyr
    # results precomputed over the whole scene (ref
    # scripts/online_learning.py:246-248,367-378); in the disjoint protocol
    # these rows are made the same way, by the trained scorer.
    confident_th = 1.25
    bootstrap_scored = 0
    if disjoint:
        log("generating full-scene zephyr results (bootstrap) ...")
        zr_rows = []
        for t in bop.targets:
            oid = t["obj_id"]
            d = bop.getDataByIds(oid, t["scene_id"], t["im_id"])
            depth = np.asarray(d["depth"], np.float32)
            # in front of the synthetic background plane
            cloud = depth2cloud(depth, depth < 1.2, np.asarray(d["scene_camera"]["cam_K"], np.float64).reshape(3, 3))
            poses, _, _ = hypo_gens[oid].find_surface_model(cloud, max_poses=256)
            row = {"obj_id": oid, "scene_id": t["scene_id"], "im_id": t["im_id"], "score": float("-inf"),
                   "pred_pose": np.eye(4), "pred_mask_visib": np.zeros_like(depth, bool)}
            if len(poses):
                pts, cols, nrms = clouds[oid]
                out = zmodel.score_hypotheses(
                    {"img": d["img"], "depth": depth, "cam_K": np.asarray(d["scene_camera"]["cam_K"]),
                     "model_points": pts, "model_colors": cols, "model_normals": nrms,
                     "pose_hypos": poses.astype(np.float32)}, obj_id=oid)
                row["score"] = float(out["pred_score"])
                row["pred_pose"] = np.asarray(out["pred_pose"])
                bootstrap_scored += 1
            zr_rows.append(row)
        zephyr_results = {(r["obj_id"], r["scene_id"], r["im_id"]): r for r in zr_rows}
        n_conf = sum(r["score"] > confident_th for r in zr_rows)
        log(f"bootstrap: {n_conf}/{len(zr_rows)} rows above the confidence gate")
    stage("bootstrap")

    # ---- the online self-supervised loop -----------------------------------
    log("running the online loop (PPF + zephyr + finetuning) ...")
    loop_args = argparse.Namespace(
        dataset_name="synth", exp_name="demo", use_offline_model=False, use_pretrained_dtoid=False,
        dtoid_weights_path=None, n_local_test=args.n_templates, use_dtoid_segmask=True,
        ignore_dtoid_mask=False,
        # disjoint protocol: masks only once the detector is confident; the
        # bootstrap rows carry the unconfident frames
        always_dtoid_mask=not disjoint, use_oracle_gt=False, use_sift_hypos=False, test_seen=False,
        backward=False, use_maskrcnn=args.use_maskrcnn, finetune_interval=8, finetune_warmup=0, finetune_epochs=1,
        finetune_reset=False, finetune_batch_size=4, non_cum=False, save_each=False, raw_dtoid=False,
        no_finetune=False, fast=True, zephyr_confident_threshold=confident_th)
    train_ds = train_loader.dataset
    train_ds.clearTargets()
    train_ds.zephyr_results = dict(zephyr_results)
    loop = OnlineLearningLoop(loop_args, cfg, model, bop, train_ds, test_loader, dict(zephyr_results),
                              zephyr_model=zmodel, hypo_gens=hypo_gens, use_icp=True)
    results = loop.run(progress=True)
    stage("loop", loop=loop, rows=results)

    # ---- metrics -------------------------------------------------------------
    ar = BopEvaluator(bop).evaluate(results)
    summary = {
        "dtoid_iou_untrained": round(iou_untrained, 4),
        "dtoid_iou_pretrained": round(iou_pretrained, 4),
        "dtoid_iou_online": round(float(np.mean([r["dtoid_iou"] for r in results])), 4),
        "pose_add01d": round(float(np.mean([r["pred_add01d"] for r in results])), 4),
        "zephyr_visib_recall": round(float(np.mean([r["pred_iou_visib"] > 0.5 for r in results])), 4),
        "n_finetunes": int(sum(r["finetune"] for r in results)),
        "AR": round(ar["AR"], 4),
        "AR_vsd": round(ar["AR_vsd"], 4),
        "AR_mssd": round(ar["AR_mssd"], 4),
        "AR_mspd": round(ar["AR_mspd"], 4),
    }
    stage("ar")
    print(json.dumps(summary))
    counts = {"detects_per_eval": len(res0), "pretrain_steps": pretrain_steps,
              "finetune_steps": sum(len(ep) for logs in loop.finetune_logs for ep in logs),
              "loop_frames": len(results), "loop_scored": sum(r["n_hypos"] > 0 for r in results),
              "calibration_scored": cal["frames"] if cal else 0, "bootstrap_scored": bootstrap_scored}
    return dict(summary, stage_s=stage_s, counts=counts)


if __name__ == "__main__":
    out = main()
    log(f"stage seconds: {json.dumps(out['stage_s'])}; counts: {json.dumps(out['counts'])}")
