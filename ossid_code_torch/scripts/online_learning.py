"""The online-learning CLI on the card (the port of
ossid_code_tpu/scripts/online_learning.py, with its flags, their `dest`s
and defaults, plus `--device`):

    python -m ossid_code_torch.scripts.online_learning --dataset_name lmo ...

It runs the OSSID online self-supervised loop over a BOP test split and
writes the JAX CLI's results pickle (results_<exp_name>.pkl) and BOP19 CSV,
then prints BOP AR (VSD, MSSD, MSPD), DTOID mean IoU and IoU recall, the
scorer's IoU recall, ADD(-S) < 0.1d and detection mAP@0.5. `--raw_dtoid`
runs detection alone and writes before_finetune_dtoid_results_<exp>.pkl.

Path roots are read from the environment when the CLI runs, with the JAX
package's defaults (core/config.py::roots): BOP_DATASETS_ROOT,
OSSID_DATA_ROOT (template grids, precomputed scorer results),
OSSID_CKPT_ROOT, OSSID_RESULT_ROOT, BOP_RESULTS_FOLDER, BOP_TOOLKIT_PATH
(bop_toolkit's evaluation runs only where it is installed). On `ycbv` the
scorers are two, chosen by object-id parity, and the pick gets host ICP.

Not ported: `--use_maskrcnn` (ROADMAP.md §1 item 8) and `--yuv_transfer`
(item 6) raise. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from ossid_code_torch.core.config import Config, default_config, roots


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Arguments for test-time training")
    parser.add_argument("--dataset_name", type=str, default="lmo",
                        help="The name of the dataset to be used (lmo, ycbv, or a synthetic one)")
    parser.add_argument("--exp_name", type=str, default="exp")

    parser.add_argument("--use_offline_model", action="store_true")
    parser.add_argument("--use_pretrained_dtoid", action="store_true")
    parser.add_argument("--dtoid_weights_path", type=str, default=None)
    parser.add_argument("--n_local_test", type=int, default=None)
    parser.add_argument("--use_dtoid_segmask", action="store_true")
    parser.add_argument("--ignore_dtoid_mask", action="store_true")
    parser.add_argument("--always_dtoid_mask", action="store_true")
    parser.add_argument("--use_oracle_gt", action="store_true")

    parser.add_argument("--use_sift_hypos", action="store_true")
    parser.add_argument("--test_seen", action="store_true")
    parser.add_argument("--backward", action="store_true")
    parser.add_argument("--use_maskrcnn", action="store_true",
                        help="not ported: raises (ROADMAP.md §1 item 8)")

    parser.add_argument("--finetune_interval", type=int, default=8)
    parser.add_argument("--finetune_warmup", type=int, default=0)
    parser.add_argument("--finetune_epochs", type=int, default=1)
    parser.add_argument("--finetune_reset", action="store_true")
    parser.add_argument("--finetune_batch_size", type=int, default=8)
    parser.add_argument("--non_cum", action="store_true")
    parser.add_argument("--save_each", action="store_true")

    parser.add_argument("--raw_dtoid", action="store_true")
    parser.add_argument("--no_finetune", action="store_true")
    parser.add_argument("--fast", action="store_true")

    parser.add_argument("--zephyr_confident_threshold", type=float, default=20.0,
                        help="Pseudo-label gate on the scorer output (ref uses 20; scorers trained in "
                             "this framework emit logits, so 0.0 is the natural gate)")
    parser.add_argument("--zephyr_depth_crop", type=int, default=0,
                        help="Score on an SxS detection-centred depth crop (0 = full frame)")
    parser.add_argument("--model_shift_path", type=str, default=None,
                        help="JSON of per-object model-frame offsets (meters), {obj_id: [x,y,z]}: the "
                             "YCB-V original-frame vs BOP-frame shift the scorer checkpoints expect")
    parser.add_argument("--yuv_transfer", action="store_true",
                        help="not ported: raises (ROADMAP.md §1 item 6)")
    parser.add_argument("--bf16_finetune", action="store_true",
                        help="Mixed-precision online finetuning: bf16 forward/backward with float32 "
                             "master weights and float32 loss and optimizer")
    parser.add_argument("--hypo_backend", type=str, default="auto", choices=["auto", "ppf", "fake"],
                        help="Pose hypothesis generator backend (auto: PPF when its host library "
                             "builds, else fake)")
    parser.add_argument("--n_fake_hypos", type=int, default=100)
    parser.add_argument("--conf_path", type=str, default=None,
                        help="Explicit config yaml (else built from defaults)")
    parser.add_argument("--model_sampling_dist", type=float, default=None,
                        help="PPF model sampling distance (default: 0.03 ycbv, 0.025 else)")
    parser.add_argument("--scene_sampling_dist", type=float, default=None,
                        help="PPF scene sampling distance (default = model_sampling_dist)")
    parser.add_argument("--ref_pt_rate", type=float, default=0.4, help="PPF reference point rate")
    parser.add_argument("--max_pose_hypos", type=int, default=100,
                        help="Cap on PPF pose hypotheses per frame")
    parser.add_argument("--align_feats", type=int, default=0,
                        help="1: the scorer reads the 12-cell alignment-fraction grid as head inputs "
                             "(checkpoints trained with it); reference checkpoints load either way")
    parser.add_argument("--rank_blend", type=float, default=None,
                        help="blend weight of the geometric alignment statistic in hypothesis ranking "
                             "(z-scored net score + w * z-scored statistic). Unset means 0, net-only "
                             "argmax: the JAX CLI's default when its OSSID_RANK_BLEND is unset (the "
                             "port reads no environment switch)")
    parser.add_argument("--refine_top", type=int, default=10,
                        help="ICP-refine the top-N PPF hypotheses (0 = throughput config)")
    parser.add_argument("--refine_device", action="store_true",
                        help="Refine the top-N on the card inside the score call (batched "
                             "point-to-point ICP) instead of host ICP in PPF")
    parser.add_argument("--zephyr_ckpt_path", type=str, default=None,
                        help="Scorer ckpt (torch .ckpt or the JAX package's); default "
                             "OSSID_CKPT_ROOT/final_<dataset>.ckpt if present")
    parser.add_argument("--zephyr_ckpt_path_even", type=str, default=None,
                        help="YCB-V: scorer applied to even obj_ids")
    parser.add_argument("--zephyr_ckpt_path_odd", type=str, default=None,
                        help="YCB-V: scorer applied to odd obj_ids")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return parser


def build_config(args) -> Config:
    R = roots()
    if args.conf_path:
        cfg = default_config().merged(Config.load(args.conf_path).to_dict())
    else:
        cfg = default_config()
    d = cfg.dataset
    d.bop_root = R.BOP_DATASETS_ROOT
    d.test_dataset_name = args.dataset_name
    d.train_dataset_name = args.dataset_name
    d.zephyr_filter_key = None
    d.zephyr_results_percent = 1
    d.train_local_template_sample_from = 10  # ref online_learning.py:136
    # frame caches sized to the finetune buffer
    d.cache_frames = max(4, 2 * int(args.finetune_interval) + 16) if args.finetune_interval < 10 ** 6 else 4
    d.proc_cache_frames = d.cache_frames

    if args.dataset_name == "ycbv":
        d.grid_root = os.path.join(R.OSSID_DATA_ROOT, "templates_YCBV_BOP")
        d.zephyr_result_path = os.path.join(R.OSSID_DATA_ROOT, "test_ycbv_boptest_zephyr_result_unseen.pkl")
    elif args.dataset_name == "lmo":
        d.grid_root = os.path.join(R.OSSID_DATA_ROOT, "templates_LMO_DTOID")
        d.zephyr_result_path = os.path.join(R.OSSID_DATA_ROOT, "lmo_boptest_zephyr_result.pkl")
    else:  # synthetic / custom datasets
        d.grid_root = os.path.join(R.BOP_DATASETS_ROOT, "grid")
        d.zephyr_result_path = os.path.join(R.BOP_DATASETS_ROOT, f"{args.dataset_name}_zephyr_results.pkl")
        # custom worlds need not be 480x640: the frame size comes from the
        # BOP camera.json, so anchors, network and dataset agree
        cam_json = os.path.join(R.BOP_DATASETS_ROOT, args.dataset_name, "camera.json")
        if os.path.exists(cam_json):
            with open(cam_json) as fp:
                cam = json.load(fp)
            if "height" in cam and "width" in cam:
                h, w = int(cam["height"]), int(cam["width"])
                cfg.model.img_h, cfg.model.img_w = h, w
                d.shorter_length = min(h, w)
                # stride-16 heat map (29x39 at 480x640)
                cfg.model.heatmap_h, cfg.model.heatmap_w = h // 16 - 1, w // 16 - 1
                d.heatmap_shorter_length = min(cfg.model.heatmap_h, cfg.model.heatmap_w)

    if args.n_local_test is not None:
        d.n_local_test = args.n_local_test
    elif args.use_pretrained_dtoid:
        d.n_local_test = 160
    else:
        d.n_local_test = 10
    d.use_provided_template = bool(args.use_pretrained_dtoid)
    return cfg


def build_hypo_gens(args, bop_dataset, zephyr_results):
    """PPF when its host library builds (or when forced), else fake."""
    backend = args.hypo_backend
    if backend in ("auto", "ppf"):
        from ossid_code_torch.hypo.ppf import PPFModelMeters
        from ossid_code_torch.kernels.build import build_native

        try:
            build_native("ppf")
            available = True
        except RuntimeError as e:
            if backend == "ppf":
                raise
            print(f"PPF host library unavailable ({e}); fake hypotheses")
            available = False
        if available:
            sampling = args.model_sampling_dist
            if sampling is None:
                sampling = 0.03 if args.dataset_name == "ycbv" else 0.025
            return {oid: PPFModelMeters(
                bop_dataset.getObjPath(oid), ModelSamplingDist=sampling,
                scene_sampling_dist=args.scene_sampling_dist or sampling, ref_pt_rate=args.ref_pt_rate,
                # with --refine_device the scorer refines on the card
                refine_top=0 if args.refine_device else args.refine_top,
                max_poses=getattr(args, "max_pose_hypos", 100)) for oid in bop_dataset.obj_ids}
    from ossid_code_torch.hypo.fake import FakeHypoGen

    return {oid: FakeHypoGen(n_hypos=args.n_fake_hypos, seed=oid) for oid in bop_dataset.obj_ids}


def select_dtoid_weights(args) -> str | None:
    """Which DTOID checkpoint to load (ref online_learning.py:94-109): an
    explicit --dtoid_weights_path wins; --use_pretrained_dtoid selects the
    original author's weights; --use_offline_model the transductively
    finetuned ones, else the offline-pretrained ones. None when the selected
    file does not exist (fresh init)."""
    if args.dtoid_weights_path:
        return args.dtoid_weights_path
    ckpt_root = roots().OSSID_CKPT_ROOT
    if args.use_pretrained_dtoid:
        cand = os.path.join(ckpt_root, "dtoid_pretrained_original.pth.tar")
    elif args.use_offline_model:
        cand = os.path.join(ckpt_root, f"dtoid_transductive_{args.dataset_name}.ckpt")
    else:
        cand = os.path.join(ckpt_root, "dtoid_pretrained.ckpt")
    if os.path.exists(cand):
        return cand
    print(f"DTOID checkpoint {cand} not found; starting from fresh init")
    return None


def select_zephyr_ckpts(args) -> dict:
    """Scorer checkpoints (ref online_learning.py:171-181,212-227): one on
    LM-O; two on YCB-V by object-id parity, swapped by --test_seen (each was
    trained with the other half of the objects held out). Returns
    {'single', 'even', 'odd'}: paths that exist, else None."""
    ckpt_root = roots().OSSID_CKPT_ROOT
    out = {"single": None, "even": None, "odd": None}
    if args.dataset_name == "ycbv":
        for_odd, for_even = args.zephyr_ckpt_path_odd, args.zephyr_ckpt_path_even
        if for_odd is None and for_even is None:
            if args.test_seen:
                for_odd = os.path.join(ckpt_root, "final_ycbv.ckpt")
                for_even = os.path.join(ckpt_root, "final_ycbv_valodd.ckpt")
            else:
                for_odd = os.path.join(ckpt_root, "final_ycbv_valodd.ckpt")
                for_even = os.path.join(ckpt_root, "final_ycbv.ckpt")
        out["odd"] = for_odd if for_odd and os.path.exists(for_odd) else None
        out["even"] = for_even if for_even and os.path.exists(for_even) else None
    else:
        cand = args.zephyr_ckpt_path or os.path.join(ckpt_root, f"final_{args.dataset_name}.ckpt")
        out["single"] = cand if os.path.exists(cand) else None
    return out


def _rate(values, threshold=None) -> float:
    v = np.asarray(values, np.float64)
    return (v > threshold).astype(float).mean() if threshold is not None else v.mean()


def main(args) -> dict:
    """Run the CLI; returns its printed summary (and output paths)."""
    from ossid_code_torch.core.checkpoint import load_checkpoint
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import get_dataloaders
    from ossid_code_torch.eval.bop_ar import BopEvaluator
    from ossid_code_torch.eval.bop_csv import save_results_bop
    from ossid_code_torch.eval.detection_map import eval_detection_results
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop, refuse_unported, test_dtoid_model
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.utils.geometry import load_model_shifts, mask_to_bbox

    refuse_unported(args)
    np.random.seed(42)
    R = roots()
    cfg = build_config(args)
    save_root = R.OSSID_RESULT_ROOT
    os.makedirs(save_root, exist_ok=True)
    os.makedirs(R.BOP_RESULTS_FOLDER, exist_ok=True)
    assert not (args.ignore_dtoid_mask and args.always_dtoid_mask)

    with open(cfg.dataset.zephyr_result_path, "rb") as f:
        zephyr_results_list = pickle.load(f)
    zephyr_results = {(r["obj_id"], r["scene_id"], r["im_id"]): r for r in zephyr_results_list}

    cfg.dataset.load_zephyr_result = True
    train_loader, _, test_loader = get_dataloaders(cfg, zephyr_results_list)
    test_loader.dataset.sortTargets(reverse=args.backward)

    if args.bf16_finetune:
        cfg.model.bf16_finetune = True
    model = DtoidModel(cfg, seed=cfg.seed, device=args.device)
    dtoid_ckpt = select_dtoid_weights(args)
    if dtoid_ckpt:
        print("Loading DTOID model weights from", dtoid_ckpt)
        model.load_state_dict(load_checkpoint(dtoid_ckpt))

    train_dataset = train_loader.dataset
    train_dataset.clearTargets()
    train_dataset.zephyr_results = zephyr_results

    if args.raw_dtoid:
        test_results = test_dtoid_model(model, test_loader)
        save_path = os.path.join(save_root, f"before_finetune_dtoid_results_{args.exp_name}.pkl")
        with open(save_path, "wb") as f:
            pickle.dump({"test_results": test_results, "main_args": vars(args)}, f)
        ious = [r["dtoid_iou"] for r in test_results]
        summary = {"dtoid_mean_iou": _rate(ious), "dtoid_iou_recall": _rate(ious, 0.5)}
        print("DTOID mean IoU:", summary["dtoid_mean_iou"])
        print("DTOID Valid IoU recall", summary["dtoid_iou_recall"])
        return dict(summary, results_path=save_path)

    bop_dataset = BopDataset(BopDatasetArgs(bop_root=R.BOP_DATASETS_ROOT, dataset_name=args.dataset_name,
                                            split_name="bop_test", split="test"))
    inconst_th = 10 if args.dataset_name == "ycbv" else 100

    def make_scorer(ckpt_path):
        zm = ZephyrModel(num_points=512, inconst_ratio_th=inconst_th, need_uv=False,
                         refine_top=(args.refine_top if args.refine_device else 0),
                         rank_blend=float(args.rank_blend or 0.0), align_feats=bool(args.align_feats),
                         device=args.device)
        if ckpt_path:
            print("Loading zephyr scorer weights from", ckpt_path)
            zm.load_state_dict(load_checkpoint(ckpt_path, align_feats=bool(args.align_feats)))
        return zm

    zckpts = select_zephyr_ckpts(args)
    zephyr_model_even = zephyr_model_odd = None
    if args.dataset_name == "ycbv" and (zckpts["even"] or zckpts["odd"]):
        # two scorers chosen by object-id parity (ref :212-227,461-464)
        zephyr_model_even = make_scorer(zckpts["even"])
        zephyr_model_odd = make_scorer(zckpts["odd"])
        zephyr_model = zephyr_model_even
    else:
        zephyr_model = make_scorer(zckpts["single"])
    hypo_gens = build_hypo_gens(args, bop_dataset, zephyr_results)

    sift_gens = {}
    if args.use_sift_hypos:
        # per-object SIFT feature banks from the template grids (ref
        # online_learning.py:283-285)
        from ossid_code_torch.hypo.sift import SiftFeatureModel, SiftHypoGen
        from ossid_code_torch.ops.sift import SiftError

        td = test_loader.dataset.template_dataset
        for oid in bop_dataset.obj_ids:
            try:
                fm = SiftFeatureModel(device=model.device).construct_from_templates(td, oid)
            except SiftError as e:
                print(f"SIFT featurization failed for obj {oid}: {e}")
                continue
            sift_gens[oid] = SiftHypoGen(fm, bop_dataset.dataset_camera["K"])

    loop = OnlineLearningLoop(
        args, cfg, model, bop_dataset, train_dataset, test_loader, zephyr_results,
        zephyr_model=zephyr_model, zephyr_model_even=zephyr_model_even, zephyr_model_odd=zephyr_model_odd,
        hypo_gens=hypo_gens, sift_gens=sift_gens, use_icp=(args.dataset_name == "ycbv"),
        model_shifts=load_model_shifts(args.model_shift_path) if args.model_shift_path else None)
    test_results = loop.run()

    save_path = os.path.join(save_root, f"results_{args.exp_name}.pkl")
    loop.save_results(save_path, test_results)
    print("Saved results to", save_path)
    csv_path = save_results_bop(test_results, R.BOP_RESULTS_FOLDER, f"online-{args.exp_name}", args.dataset_name,
                                pose_key="pred_pose", score_key="pred_score", run_eval_script=True)

    # in-repo BOP AR (the bop19 definitions, without bop_toolkit)
    ar = BopEvaluator(bop_dataset).evaluate(test_results)
    print(f"BOP AR: {ar['AR']:.4f} (VSD {ar['AR_vsd']:.4f} MSSD {ar['AR_mssd']:.4f} MSPD {ar['AR_mspd']:.4f})")
    ious = [r["dtoid_iou"] for r in test_results]
    summary = {k: ar[k] for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd")}
    summary.update(dtoid_mean_iou=_rate(ious), dtoid_iou_recall=_rate(ious, 0.5),
                   zephyr_iou_recall=_rate([r["pred_iou_visib"] for r in test_results], 0.5),
                   add01d=_rate([r["pred_add01d"] for r in test_results]))
    print("DTOID mean IoU:", summary["dtoid_mean_iou"])
    print("DTOID Valid IoU recall", summary["dtoid_iou_recall"])
    print("Zephyr Valid IoU recall", summary["zephyr_iou_recall"])
    print("ADD(-S) < 0.1d:", summary["add01d"])

    # in-repo detection mAP (in place of the Cartucho/mAP subprocess)
    gt_boxes = {}
    for t in bop_dataset.targets:
        box = mask_to_bbox(np.asarray(bop_dataset.getMaskByIds(t["obj_id"], t["scene_id"], t["im_id"], visib=True)))
        if box is not None:
            gt_boxes[(t["obj_id"], t["scene_id"], t["im_id"])] = box
    _, summary["mAP"] = eval_detection_results(test_results, gt_boxes)
    print("Detection mAP@0.5:", summary["mAP"])
    return dict(summary, results_path=save_path, csv_path=csv_path, loop=loop)


if __name__ == "__main__":
    main(build_parser().parse_args())
