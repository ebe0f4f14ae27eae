"""A/B: blending a geometric alignment statistic into hypothesis ranking (the
port of ossid_code_tpu/scripts/ab_rank_blend.py).

On the hard hermetic world (oracle GT masks, host-refined PPF sets) this
script measures, for each sampled target, the trained scorer's picks against
a HAND-CRAFTED statistic, the fraction of valid projected model points that
are both depth-aligned and hue-consistent, over a (tau_depth, tau_hue) grid,
and their ensembles:

  * net score alone (argmax over the hypothesis set)         [baseline]
  * alignment statistic alone, over the grid
  * additive blends  score + lambda * stat_z (z-scored per set)
  * top-k rerank: among the net's top-k, argmax statistic

It reuses the demo_e2e --hard training recipe (same world seeds, same
`ZephyrOfflineTrainer`), with PPF through the port's `hypo/ppf.py` (its own
build of native/ppf.cpp). The statistic (`alignment_stats`) and the
strategies (`pick_rate`, `blend`, `rerank`, `strategies`) are module-level
functions here; in the JAX script they are closures. The scorer (kernel 2 on
the card) scores every set; the statistic is plain PyTorch on the scorer's
device. Prints one JSON line per strategy plus a summary, as the JAX script.

Usage: python -m ossid_code_torch.scripts.ab_rank_blend [--targets 72] [--device cpu]
Runs on the card unless --device cpu. Beyond the JAX script's arguments:
`--device`. `--rank_weight` (default 1.0) is the scorer's
`ZephyrModel(rank_weight=)`, the weight of its listwise loss term (0: BCE
alone), as in the JAX script.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from ossid_code_torch.device import resolve_device


def log(msg):
    print(f"[ab_rank_blend] {msg}", file=sys.stderr, flush=True)


TAU_D = (0.005, 0.0075, 0.01, 0.015, 0.02)   # depth-alignment tolerance (m)
TAU_H = (0.05, 0.08, 0.12, 0.2, 0.5)          # circular hue tolerance ([0,0.5])
CELLS = [(a, b) for a in TAU_D for b in TAU_H]


@torch.no_grad()
def alignment_stats(img, depth, cam_K, pd, cd, nd, poses) -> torch.Tensor:
    """Per-hypothesis alignment statistics over the (tau_d, tau_h) grid, from
    the blurred-frame features the scorer consumes: img (H, W, 3) [0, 1],
    depth (H, W) metres, cam_K (3, 3), the object's prepared points, colours
    and normals, poses (M, 4, 4) -> (M, len(TAU_D) * len(TAU_H)), the
    fraction of valid points within both tolerances (JAX's `_stats`)."""
    from ossid_code_torch.models.zephyr.features import assemble_score_features
    from ossid_code_torch.models.zephyr.module import _blur5

    point_x, _, _ = assemble_score_features(_blur5(img), depth, cam_K, pd, cd, nd, poses, return_uv=False)
    dh = point_x[..., 3]               # circular hue diff, [0, 0.5]
    dd = torch.abs(point_x[..., 6])    # |depth diff| (clipped 0.1 m)
    ok = point_x[..., 10]              # validity
    nvalid = ok.sum(-1).clamp(min=1.0)
    return torch.stack([(ok * (dd < td) * (dh < th)).sum(-1) / nvalid for td, th in CELLS], -1)


def pick_rate(rows: list, rank_fn) -> float:
    """Share of the sets whose pick by `rank_fn(row)` is ADD-correct (< 0.1
    of the diameter)."""
    return float(np.mean([r["errs"][int(rank_fn(r))] < 0.1 * r["diam"] for r in rows]))


def blend(r: dict, lam: float, gi: int) -> int:
    """Additive blend: both z-scored per set, score + lam * stat of grid cell
    `gi`; the statistic alone where fewer than 2 scores are finite."""
    s = r["scores"].copy()
    finite = np.isfinite(s)
    if finite.sum() < 2:
        return int(np.argmax(r["stats"][:, gi]))
    mu, sd = s[finite].mean(), max(s[finite].std(), 1e-6)
    sz = np.where(finite, (s - mu) / sd, -1e9)
    st = r["stats"][:, gi]
    tz = (st - st.mean()) / max(st.std(), 1e-6)
    return int(np.argmax(sz + lam * tz))


def rerank(r: dict, k: int, gi: int) -> int:
    """Among the net's top k, the argmax of grid cell `gi`'s statistic."""
    order = np.argsort(r["scores"])[::-1][:k]
    return int(order[np.argmax(r["stats"][order, gi])])


def strategies(rows: list) -> tuple[dict, dict]:
    """(results, stat_cells): the ceiling, the net alone, the statistic's best
    cell, the blends and reranks at that cell; each cell's pick rate."""
    results = {"ceiling": float(np.mean([r["errs"].min() < 0.1 * r["diam"] for r in rows])),
               "net_only": pick_rate(rows, lambda r: np.argmax(r["scores"]))}
    stat_cells = {f"stat_d{td}_h{th}": pick_rate(rows, lambda r, gi=gi: np.argmax(r["stats"][:, gi]))
                  for gi, (td, th) in enumerate(CELLS)}
    best_cell = max(stat_cells, key=stat_cells.get)
    results["stat_best"] = stat_cells[best_cell]
    results["stat_best_cell"] = best_cell
    gi_best = list(stat_cells).index(best_cell)
    for lam in (0.25, 0.5, 1.0, 2.0, 4.0):
        results[f"blend_lam{lam}"] = pick_rate(rows, lambda r, lam=lam: blend(r, lam, gi_best))
    for k in (4, 8, 16, 32):
        results[f"rerank_top{k}"] = pick_rate(rows, lambda r, k=k: rerank(r, k, gi_best))
    return results, stat_cells


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--targets", type=int, default=72,
                        help="sampled targets to evaluate picks on")
    parser.add_argument("--zephyr_epochs", type=int, default=16)
    parser.add_argument("--img_h", type=int, default=240)
    parser.add_argument("--img_w", type=int, default=320)
    parser.add_argument("--root", type=str, default=None)
    parser.add_argument("--max_poses", type=int, default=128)
    parser.add_argument("--align_feats", type=int, default=1,
                        help="scorer consumes the 12-cell alignment-fraction "
                             "grid as a head input (0 = r3 scorer)")
    parser.add_argument("--rank_weight", type=float, default=1.0)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.synthetic import hard_objects, make_synthetic_bop
    from ossid_code_torch.eval.pose_metrics import add_err, object_diameter
    from ossid_code_torch.hypo.ppf import PPFModelMeters
    from ossid_code_torch.loop.online_learning import model_cloud_from_ply
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.render.mesh import load_ply
    from ossid_code_torch.train.zephyr_offline import ZephyrOfflineTrainer
    from ossid_code_torch.utils.geometry import depth2cloud

    dev = resolve_device(args.device)
    root = args.root or tempfile.mkdtemp(prefix="ab_rank_blend_")
    h, w = args.img_h, args.img_w
    log(f"building hard world under {root} ...")
    make_synthetic_bop(root, n_frames=args.frames, img_h=h, img_w=w,
                       objects=hard_objects(), layout="cluttered", n_clutter=3)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))

    hypo_gens = {
        oid: PPFModelMeters(bop.getObjPath(oid), ModelSamplingDist=0.04,
                            scene_sampling_dist=0.04, ref_pt_rate=0.3,
                            refine_top=30)
        for oid in bop.obj_ids
    }
    clouds = {
        oid: model_cloud_from_ply(load_ply(bop.getObjPath(oid)), n_points=1024)
        for oid in bop.obj_ids
    }
    zmodel = ZephyrModel(num_points=256, inconst_ratio_th=100.0, seed=0,
                         need_uv=False, align_feats=bool(args.align_feats),
                         rank_weight=args.rank_weight, device=dev)
    ztrainer = ZephyrOfflineTrainer(zmodel, bop, clouds, hypo_gens=hypo_gens,
                                    n_hypos=64, seed=0)
    log(f"training scorer ({args.zephyr_epochs} epochs, demo recipe) ...")
    t0 = time.time()
    for ep in range(args.zephyr_epochs):
        loss = ztrainer.train_epoch(max_frames=24, seed=ep)
        log(f"  epoch {ep}: loss {loss:.3f}")
    log(f"scorer training took {time.time() - t0:.0f}s")
    if args.align_feats:
        cal = ztrainer.calibrate_align_head(max_frames=None)
        log(f"align head calibrated: {cal}")

    rng = np.random.default_rng(0)
    targets = list(bop.targets)
    rng.shuffle(targets)
    targets = targets[: args.targets]

    rows = []
    log(f"evaluating {len(targets)} targets (oracle masks, refined PPF) ...")
    t0 = time.time()
    for ti, t in enumerate(targets):
        oid = t["obj_id"]
        d = bop.getDataByIds(oid, t["scene_id"], t["im_id"])
        depth = np.asarray(d["depth"], np.float32)
        cam_K = np.asarray(d["scene_camera"]["cam_K"], np.float64).reshape(3, 3)
        gt = np.asarray(d["mat_gt"], np.float64)
        mask = np.asarray(d["mask_gt_visib"]) > 0
        cloud = depth2cloud(depth, mask & (depth > 0), cam_K)
        if len(cloud) < 50:
            continue
        poses, _, _ = hypo_gens[oid].find_surface_model(cloud, max_poses=args.max_poses)
        if not len(poses):
            continue
        poses = poses.astype(np.float32)
        out = zmodel.score_hypotheses(
            {"img": d["img"], "depth": depth, "cam_K": cam_K,
             "model_points": clouds[oid][0], "model_colors": clouds[oid][1],
             "model_normals": clouds[oid][2], "pose_hypos": poses},
            obj_id=oid,
        )
        pd_, cd_, nd_, *_ = zmodel._objects[oid]
        stats = alignment_stats(
            torch.from_numpy(d["img"].astype(np.float32) / 255.0).to(dev),
            torch.from_numpy(depth).to(dev), torch.from_numpy(cam_K.astype(np.float32)).to(dev),
            pd_, cd_, nd_, torch.from_numpy(poses).to(dev),
        ).cpu().numpy()
        pts = clouds[oid][0]
        errs = np.asarray([
            add_err(p[:3, :3], p[:3, 3], gt[:3, :3], gt[:3, 3], pts)
            for p in poses
        ])
        rows.append({
            "scores": out["scores"], "stats": stats, "errs": errs,
            "diam": object_diameter(pts),
        })
        if (ti + 1) % 12 == 0:
            log(f"  {ti + 1}/{len(targets)} ({time.time() - t0:.0f}s)")

    log(f"eval data collected in {time.time() - t0:.0f}s over {len(rows)} frames")
    results, stat_cells = strategies(rows)
    for k, v in sorted(stat_cells.items()):
        log(f"  {k}: {v:.3f}")
    for k, v in results.items():
        if isinstance(v, float):
            print(json.dumps({"strategy": k, "pick_add01d": round(v, 4)}))
    print(json.dumps({"summary": {k: (round(v, 4) if isinstance(v, float) else v)
                                  for k, v in results.items()},
                      "n_frames": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
