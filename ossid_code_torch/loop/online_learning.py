"""The OSSID online self-supervised learning loop on the card (the port of
ossid_code_tpu/loop/online_learning.py).

Each frame, in order: DTOID detection over all templates -> confidence gate
(0.5) -> region mask -> host PPF (or fake) hypotheses in the region, after
SIFT hypotheses with `use_sift_hypos` -> Zephyr scoring by the object's
scorer (one, or two by object-id parity as on YCB-V), with device ICP of the
top hypotheses (`refine_top`) ->
with `use_icp`, host ICP of the picked pose (hypo/icp.py) -> render of the
picked pose -> visible pseudo-mask -> Zephyr gate (20) ->
the frame joins the finetune buffer, and every `finetune_interval` buffered
frames DTOID is finetuned from the device replay buffer (loop/replay.py).

The frame's uint8 image is uploaded to the card once and shared by
detection, scoring and the replay buffer (and by every target on the same
image, through a 4-frame cache); with `yuv_transfer` it travels as a YUV
4:2:0 buffer and is rebuilt there (ops/yuv.py). Result rows keep the JAX
loop's schema. `test_dtoid_model` is the detection-only pass
(`--raw_dtoid`).

`pipeline_scoring=True`, the default, is the JAX loop's pipelined schedule:
  * the detections of frames N+1 and N+2 are dispatched before frame N's
    results are fetched, and checked against `weights_version` when their
    frame comes: a finetune in between makes them stale, and they are
    dispatched again on the uploads they already made;
  * their results and the deferred completions' come to the host in one
    bundled fetch on a fetch thread (copies into pinned memory and an event
    after them; utils/host_copy.py), decoded there;
  * a frame's completion (score fetch -> pseudo-label -> finetune gate) is
    deferred past later frames' dispatches only while that cannot change
    the weights (`_can_defer_completion`);
  * an IO thread reads, packs and uploads frames two ahead.
Every launch and copy goes to the current stream of the thread that makes
it, the default stream, which the threads share: an upload made on the IO
thread is ordered before the detection that reads it. A weight change in
place (the optimizer's) is ordered after the speculative detections already
enqueued, which then read the old weights and are discarded by the version
check. An error on either thread surfaces where the main thread reads its
future; nothing falls back to another path. The environment knobs of the
JAX loop, read in the constructor with its defaults: OSSID_SPEC_FETCH
(thread | inline; auto = thread), OSSID_FETCH_BUNDLE (2), OSSID_PIPELINE_DEPTH
(the effective bundle), OSSID_MERGED_FETCH (1), OSSID_COMPLETE_PREFETCH (1),
OSSID_FRAME_SHARE (1). `utils/rpc_stats.STATS` counts the fetches and the
speculation's outcomes. `pipeline_scoring=False` runs each frame to its end
before the next one starts, with no speculation and no side threads.

While spans are on (utils/rpc_stats.py), each stage is a span in STATS
tagged with its target's ids: on the main thread an `iteration` (the
dispatch half) around `frame.wait`, `detect.build` / `.dispatch` / `.wait` /
`.decode`, `mask`, `hypotheses`, `score.dispatch`, `pp_err.dispatch` and
the completions it runs; a `complete` around `complete.wait` / `.decode`,
`icp`, `label`, `gate`, `finetune` (tagged with the event's index, around
each step's `finetune.feed` and `finetune.step`) and `row`; the latency
spans `queue` (loader to iteration) and `deferred` (dispatch half to
completion); `resolve.wait` at the run's end; `io.prefetch` on the IO
thread, `fetch.wait` and `fetch.decode` on the fetch thread (on while the
caller of `run` has them on: `STATS.across_threads`). On the card a
finetune row's `time_finetune` is the event's device time (CUDA events
read at the run's end), on the CPU the host's.

With the class-conditional detector (`models/maskrcnn.py`, `--use_maskrcnn`)
in DTOID's place, detection is its `forward_test_time` for the target's
class (it has no speculative dispatch), and the finetune trains it from the
host loader through `_maskrcnn_feed` (no replay buffer: it has no
`train_step_u8`).
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ossid_code_torch.core.checkpoint import save_checkpoint
from ossid_code_torch.data.dtoid_bop import NumpyLoader
from ossid_code_torch.hypo.icp import icp_refinement
from ossid_code_torch.loop.replay import DeviceReplayBuffer
from ossid_code_torch.eval.pose_metrics import (
    add_err, adi_err, object_diameter, pp_err_batch_async, pp_err_fetch,
)
from ossid_code_torch.ops.sift import SiftError
from ossid_code_torch.ops.yuv import ship_rgb_yuv420
from ossid_code_torch.render.mesh import load_ply
from ossid_code_torch.render.rasterizer import Renderer
from ossid_code_torch.render.visib import estimate_visib_mask_gt
from ossid_code_torch.utils.geometry import K2meta, depth2cloud, expand_box, shift_model_points
from ossid_code_torch.utils.host_copy import HostCopy, to_device
from ossid_code_torch.utils.image import resize_linear
from ossid_code_torch.utils.rpc_stats import STATS
from ossid_code_torch.utils.timing import Timer

DTOID_CONFIDENT_THRESHOLD = 0.5  # ref online_learning.py:84
ZEPHYR_CONFIDENT_THRESHOLD = 20  # ref online_learning.py:85
# identity poses that stand in for SIFT's when SIFT fails on a frame
SIFT_FALLBACK_POSES = 20
# frames whose uploads the targets of one image share (_frame_cache_put)
FRAME_CACHE = 4


class _PartFut:
    """View into one element of a bundled fetch's future (one transfer that
    carries upcoming frames' detections and deferred frames' completions);
    `path` indexes the nested tuples."""

    def __init__(self, fut, *path: int):
        self._fut, self._path = fut, path

    def result(self):
        out = self._fut.result()
        for i in self._path:
            out = out[i]
        return out


def _ids(batch) -> tuple:
    return int(batch["obj_id"][0]), int(batch["scene_id"][0]), int(batch["im_id"][0])


def _depth_mm(depth: np.ndarray) -> np.ndarray:
    """Metres -> uint16 millimetres, as the scorer reads depth."""
    return (depth * 1000.0).round().clip(0, 65535).astype(np.uint16)


def model_cloud_from_ply(mesh, n_points: int = 2048, seed: int = 0):
    """Sample a colored, normal-equipped model cloud (meters) from a BOP mesh
    (mm), replacing the reference's precomputed model_cloud_{:02d}.npz files
    (ref online_learning.py:303-311) when they are absent."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices / 1000.0
    faces = mesh.faces
    # sample on faces proportionally to area
    a, b, c = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = areas / areas.sum()
    fidx = rng.choice(len(faces), n_points, p=probs)
    r1, r2 = rng.random((2, n_points))
    s1 = np.sqrt(r1)
    w0, w1, w2 = 1 - s1, s1 * (1 - r2), s1 * r2
    pts = w0[:, None] * v[faces[fidx, 0]] + w1[:, None] * v[faces[fidx, 1]] + w2[:, None] * v[faces[fidx, 2]]
    fn = np.cross(b - a, c - a)
    fn /= np.clip(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12, None)
    # orient normals outward: stored vertex normals win when present (the
    # centroid rule mis-orients concave regions of compound shapes)
    if mesh.normals is not None and len(mesh.normals) == len(v):
        vn = (mesh.normals[faces[:, 0]] + mesh.normals[faces[:, 1]]
              + mesh.normals[faces[:, 2]])
        flip = np.einsum("ij,ij->i", fn, vn) < 0
    else:
        centroid = v.mean(axis=0)
        face_centers = (a + b + c) / 3.0
        flip = np.einsum("ij,ij->i", fn, face_centers - centroid) < 0
    fn[flip] *= -1.0
    normals = fn[fidx]
    if mesh.colors is not None:
        cols = (
            w0[:, None] * mesh.colors[faces[fidx, 0]]
            + w1[:, None] * mesh.colors[faces[fidx, 1]]
            + w2[:, None] * mesh.colors[faces[fidx, 2]]
        )
    else:
        cols = np.full((n_points, 3), 0.5)
    return pts.astype(np.float32), cols.astype(np.float32), normals.astype(np.float32)


class OnlineLearningLoop:
    def __init__(self, args, cfg, dtoid_model, bop_dataset, train_dataset, test_loader,
                 zephyr_results: dict, zephyr_model=None, zephyr_model_even=None,
                 zephyr_model_odd=None, hypo_gens: dict | None = None, sift_gens: dict | None = None,
                 use_icp: bool = False, pipeline_scoring: bool = True, model_shifts: dict | None = None):
        self.args = args
        # host ICP (hypo/icp.py) of the picked pose against the frame's depth
        self.use_icp = bool(use_icp)
        self.pipeline_scoring = pipeline_scoring
        self._yuv = bool(getattr(args, "yuv_transfer", False))
        self.cfg = cfg
        self.model = dtoid_model
        # share the test dataset's reader when it reads the same data, so
        # each frame's PNGs are decoded once
        reader = getattr(getattr(test_loader, "dataset", None), "bop_dataset", None)
        if (reader is not None and reader.dataset_root == bop_dataset.dataset_root
                and reader.split == bop_dataset.split):
            bop_dataset = reader
        self.bop_dataset = bop_dataset
        self.train_dataset = train_dataset
        self.test_loader = test_loader
        self.zephyr_results = zephyr_results
        self.zephyr_model = zephyr_model
        # YCB-V: two scorers chosen by object-id parity, each trained with
        # the other half of the objects held out (_zephyr_for)
        self.zephyr_model_even = zephyr_model_even
        self.zephyr_model_odd = zephyr_model_odd
        self.hypo_gens = hypo_gens or {}
        self.sift_gens = sift_gens or {}

        # model clouds (points m, colors, normals) sampled from the meshes
        model_clouds = {oid: model_cloud_from_ply(load_ply(bop_dataset.getObjPath(oid)))
                        for oid in bop_dataset.obj_ids}
        if model_shifts:
            # per-object model-frame offsets: YCB-V scorer checkpoints expect
            # clouds in the original YCB frame
            model_clouds = {oid: ((shift_model_points(pc[0], model_shifts[oid]), pc[1], pc[2])
                                  if oid in model_shifts else pc)
                            for oid, pc in model_clouds.items()}
        self.model_clouds = model_clouds
        self.diameters = {oid: object_diameter(pc[0]) for oid, pc in model_clouds.items()}
        for zm in {id(m): m for m in (zephyr_model, zephyr_model_even, zephyr_model_odd)
                   if m is not None}.values():
            # per-object model data and grouping indices go to the card once
            for oid, (pts, cols, nrms) in model_clouds.items():
                zm.prepare_object(oid, pts, cols, nrms)

        self.initial_state_dict = dtoid_model.state_dict()
        self.renderers: dict = {}
        self._pp_pts_dev: dict = {}
        # the IO thread (made on first use): frames two ahead are read,
        # packed and uploaded there (_prefetch_frame)
        self._io_pool = None
        self._prefetched: dict = {}  # ids -> Future[bop_data]
        self._extras: dict = {}  # ids -> {img_shared_dev, depth_u16, depth_dev}
        # uploads shared by the targets of one image, keyed (scene_id, im_id),
        # the FRAME_CACHE latest images; OSSID_FRAME_SHARE=0 uploads per target
        self._frame_uploads: dict = {}
        self._frame_uploads_order: list = []
        self._frame_uploads_lock = threading.Lock()
        self._frame_share = os.environ.get("OSSID_FRAME_SHARE", "1") == "1"
        # the fetch thread (made on first use) waits for the bundled
        # transfers and decodes the detections while the main thread runs
        # PPF and dispatches; OSSID_SPEC_FETCH=inline fetches on the main
        # thread, one frame's detection a fetch
        self._fetch_pool = None
        self._fetch_futs: list = []  # read at the end of a run: no error goes unseen
        mode = os.environ.get("OSSID_SPEC_FETCH", "auto")
        self._spec_fetch_thread = mode == "thread" if mode in ("thread", "inline") else True
        self.next_finetune_number = args.finetune_interval
        # a deferred frame's completion outputs (scores, refined poses,
        # pp_err) ride an earlier transfer instead of their own fetch in
        # _complete_frame; OSSID_COMPLETE_PREFETCH=0 fetches them there
        self._complete_prefetch = os.environ.get("OSSID_COMPLETE_PREFETCH", "1") == "1"
        # thread mode: the completions ride the next detection bundle;
        # OSSID_MERGED_FETCH=0 gives each its own fetch on the fetch thread
        self._merged_fetch = os.environ.get("OSSID_MERGED_FETCH", "1") == "1"
        # how many upcoming frames' detections one transfer carries (thread
        # mode; inline mode fetches one a frame)
        self._fetch_bundle = max(1, int(os.environ.get("OSSID_FETCH_BUNDLE", "2")))
        # how many frames a deferred completion may trail its dispatch
        eff_bundle = self._fetch_bundle if self._spec_fetch_thread else 1
        self._pipeline_depth = max(1, int(os.environ.get("OSSID_PIPELINE_DEPTH", str(eff_bundle))))
        self.finetune_logs: list = []
        # (finetune row, CUDA events around its steps) until the run's end
        self._finetune_clocks: list = []
        # frames stay on the device for the finetune of a detector that
        # trains from them (DtoidModel.train_step_u8); the class-conditional
        # detector trains from the host loader
        self.replay = DeviceReplayBuffer() if hasattr(dtoid_model, "train_step_u8") else None

    def _io_submit(self, fn, *fn_args):
        if self._io_pool is None:
            self._io_pool = ThreadPoolExecutor(max_workers=1)
        return self._io_pool.submit(fn, *fn_args)

    def _fetch_submit(self, fn, *fn_args):
        if self._fetch_pool is None:
            self._fetch_pool = ThreadPoolExecutor(max_workers=1)
        fut = self._fetch_pool.submit(fn, *fn_args)
        self._fetch_futs.append(fut)
        return fut

    def _timed_get(self, kind: str, copy: HostCopy, span: str, ids=None):
        """Wait for a started transfer; one fetch of `kind` in STATS, and a
        `span` (a `.wait`) in its span log."""
        t0 = time.perf_counter()
        with STATS.span(span, ids):
            out = copy.wait()
        STATS.rpc(kind, time.perf_counter() - t0)
        return out

    def _thread_fetch_multi(self, items, copy: HostCopy, kind: str):
        """Fetch-thread task: wait for one transfer that carries upcoming
        frames' detections ((out_dev, det_batch) pairs, oldest first) and
        deferred frames' completions, and decode the detections (unpackbits,
        IoU) here. Consumers read their part through _PartFut views: (0, j)
        the j-th detection, (1, j) the j-th completion."""
        fetched_outs, pend_fetched = self._timed_get(kind, copy, "fetch.wait")
        with STATS.span("fetch.decode"):
            dets = tuple(self.model.fetch_detections(o, db, fetched=f)
                         for (o, db), f in zip(items, fetched_outs))
        return dets, pend_fetched

    def _frame_cache_get(self, fk) -> dict:
        """A copy of the shared uploads of image fk."""
        if not self._frame_share:
            return {}
        with self._frame_uploads_lock:
            entry = self._frame_uploads.get(fk)
            return dict(entry) if entry else {}

    def _frame_cache_put(self, fk, new: dict) -> None:
        if not self._frame_share:
            return
        with self._frame_uploads_lock:
            entry = self._frame_uploads.get(fk)
            if entry is None:
                self._frame_uploads[fk] = entry = {}
                self._frame_uploads_order.append(fk)
                while len(self._frame_uploads_order) > FRAME_CACHE:
                    self._frame_uploads.pop(self._frame_uploads_order.pop(0), None)
            entry.update(new)

    def close(self) -> None:
        """Stop the IO and fetch threads (after their tasks) and drop the
        prefetched frames; run() calls it last, and may be called again."""
        for pool in (self._io_pool, self._fetch_pool):
            if pool is not None:
                pool.shutdown(wait=True)
        self._io_pool = self._fetch_pool = None
        self._fetch_futs.clear()
        self._prefetched.clear()
        self._extras.clear()
        with self._frame_uploads_lock:
            self._frame_uploads.clear()
            self._frame_uploads_order.clear()

    # ------------------------------------------------------------ stages
    def _dtoid_mask(self, out, depth):
        """Region mask from the detections (ref online_learning.py:381-408)."""
        if self.args.use_dtoid_segmask:
            seg = out["segmentation"]
            if seg.shape != depth.shape:
                seg = resize_linear(seg.astype(np.float32), (depth.shape[1], depth.shape[0]))
            mask = seg > 0.5
            if mask.sum() <= 25:
                mask = np.ones_like(mask)
            return mask
        mask = np.zeros_like(depth, dtype=bool)
        img_h, img_w = depth.shape
        # boxes are in processed-image coordinates; rescale to the raw frame
        ph, pw = self.proc_hw
        sx, sy = img_w / pw, img_h / ph
        depth_pos = depth > 0
        has_depth_mask = False
        for bbox, score in zip(out["final_bbox"][0], out["final_score"][0]):
            # scores are sorted descending: once below threshold with a
            # non-empty mask, every later box is skipped too (ref :393-405)
            if score < 0.5 and has_depth_mask:
                break
            x1, y1, x2, y2 = bbox
            x1, y1, x2, y2 = expand_box(x1 * sx, y1 * sy, x2 * sx, y2 * sy, img_h, img_w, 1.2)
            region = np.s_[int(y1):int(y2), int(x1):int(x2)]
            mask[region] = True
            if not has_depth_mask:
                has_depth_mask = bool(depth_pos[region].any())
        return mask

    def _generate_hypotheses(self, obj_id, img, depth, dist_mask, cam_K, scene_meta, times):
        """Hypothesis generation (ref online_learning.py:410-449): PPF or
        fake on the host; with `use_sift_hypos`, SIFT's poses go first (its
        keypoints on the image's device). When SIFT itself fails, 20
        identity poses stand in and `time_sift` is None."""
        scene_pc = depth2cloud(depth, np.logical_and(dist_mask, depth > 0), cam_K)
        with Timer() as t:
            poses, _, gen_time = self.hypo_gens[obj_id].find_surface_model(scene_pc)
        times["time_ppf"] = gen_time if gen_time else t.interval
        if not (getattr(self.args, "use_sift_hypos", False) and obj_id in self.sift_gens):
            times["time_sift"] = 0
            return poses
        with Timer() as t:
            try:
                poses_sift = self.sift_gens[obj_id].match(img, depth, dist_mask, scene_meta)
            except SiftError:
                poses_sift = None
        if poses_sift is None:
            poses_sift = np.stack([np.eye(4)] * SIFT_FALLBACK_POSES)
            times["time_sift"] = None
        else:
            times["time_sift"] = t.interval
        return np.concatenate([poses_sift, poses], axis=0)

    def _zephyr_for(self, obj_id):
        """The object's scorer: the parity-selected one of a pair (YCB-V,
        ref online_learning.py:461-464), else the single scorer."""
        if self.zephyr_model_even is not None or self.zephyr_model_odd is not None:
            zm = self.zephyr_model_even if obj_id % 2 == 0 else self.zephyr_model_odd
            if zm is not None:
                return zm
        return self.zephyr_model

    def _depth_crop_window(self, dist_mask, img_hw):
        """Fixed-size square window centred on the detection mask (clamped to
        the image): scoring samples depth only around the object."""
        s = int(self.args.zephyr_depth_crop)
        h, w = img_hw
        ys, xs = np.nonzero(dist_mask)
        if len(ys):
            cy, cx = int(ys.mean()), int(xs.mean())
        else:
            cy, cx = h // 2, w // 2
        y0 = int(np.clip(cy - s // 2, 0, max(h - s, 0)))
        x0 = int(np.clip(cx - s // 2, 0, max(w - s, 0)))
        return y0, x0, min(s, h), min(s, w)

    def _pp_pts(self, obj_id):
        """Device model clouds (full, query-subsampled) for pp_err."""
        if obj_id not in self._pp_pts_dev:
            pts = self.model_clouds[obj_id][0]
            pts_q = pts[np.linspace(0, len(pts) - 1, 1000).round().astype(int)] if len(pts) > 1000 else pts
            dev = self.model.device
            self._pp_pts_dev[obj_id] = (torch.as_tensor(pts, device=dev),
                                        torch.as_tensor(pts_q, device=dev))
        return self._pp_pts_dev[obj_id]

    def _render_pred(self, obj_id, cam_K, pred_pose, img_hw):
        if obj_id not in self.renderers:
            r = Renderer(K2meta(cam_K), img_h=img_hw[0], img_w=img_hw[1])
            r.addObject(obj_id, self.bop_dataset.getObjPath(obj_id), pose=pred_pose,
                        mm2m=True, simplify=self.args.fast)
            self.renderers[obj_id] = r
        r = self.renderers[obj_id]
        r.obj_nodes[obj_id].matrix = pred_pose
        _, pred_depth = r.render(depth_only=True)
        return pred_depth

    def _upload_frame(self, raw: np.ndarray) -> torch.Tensor:
        """(1, H, W, 3) uint8 frame on the detector's device: a direct
        upload, or with `yuv_transfer` (even sizes) the I420 buffer
        unpacked there."""
        if self._yuv and raw.shape[0] % 2 == 0 and raw.shape[1] % 2 == 0:
            return ship_rgb_yuv420(raw, self.model.device)[None]
        return to_device(raw[None], self.model.device)

    def _prefetch_frame(self, obj_id, scene_id, im_id, ph, pw):
        """IO-thread task, queued two frames ahead: the PNG decode and the
        frame's uploads that _build_det_batch would otherwise make inline,
        shared through the frame cache. The values are those of the inline
        path."""
        t0, ids = STATS.now(), (obj_id, scene_id, im_id)
        bop_data = self.bop_dataset.getDataByIds(*ids)
        fk = (scene_id, im_id)
        extras = self._frame_cache_get(fk)
        new = {}
        raw = bop_data["img"]
        if "img_shared_dev" not in extras and raw.shape[:2] == (ph, pw) and raw.dtype == np.uint8:
            new["img_shared_dev"] = self._upload_frame(raw)
        if "depth_u16" not in extras:
            new["depth_u16"] = _depth_mm(bop_data["depth"])
        if not getattr(self.args, "zephyr_depth_crop", 0) and "depth_dev" not in extras:
            u16 = extras.get("depth_u16", new.get("depth_u16"))
            new["depth_dev"] = to_device(u16.astype(np.int32), self.model.device)
        if new:
            self._frame_cache_put(fk, new)
            extras.update(new)
        self._extras[ids] = extras
        STATS.add_span("io.prefetch", t0, ids=ids)
        return bop_data

    def _frame_data(self, ids):
        """The frame's BopDataset record: its prefetch's result when one was
        queued (an IO-thread error is raised here), else read now."""
        fut = self._prefetched.pop(ids, None)
        with STATS.span("frame.wait", ids):
            return fut.result() if fut is not None else self.bop_dataset.getDataByIds(*ids)

    def _build_det_batch(self, batch, bop_data) -> dict:
        """Detection input for one loader batch. When the processed image has
        the raw resolution, the raw uint8 frame goes to the card once and is
        shared by detection, scoring and the replay buffer; the depth in
        millimetres goes with it unless scoring takes a crop."""
        t0, ids = STATS.now(), _ids(batch)
        fk = ids[1:]
        ex = self._extras.pop(ids, None)
        if ex is None:
            # no prefetch for this target; an earlier target on the same
            # image may have made the uploads
            ex = self._frame_cache_get(fk)
        raw = bop_data["img"]
        ph, pw = batch["img"].shape[1:3]
        img_shared_dev = None
        if raw.shape[:2] == (ph, pw) and raw.dtype == np.uint8:
            img_shared_dev = ex.get("img_shared_dev")
            if img_shared_dev is None:
                img_shared_dev = self._upload_frame(raw)
                self._frame_cache_put(fk, {"img_shared_dev": img_shared_dev})
        depth_u16 = ex.get("depth_u16")
        if depth_u16 is None:
            depth_u16 = _depth_mm(bop_data["depth"])
            self._frame_cache_put(fk, {"depth_u16": depth_u16})
        depth_dev = None
        if not getattr(self.args, "zephyr_depth_crop", 0):
            # the full depth goes up now: it does not depend on the detection
            depth_dev = ex.get("depth_dev")
            if depth_dev is None:
                depth_dev = to_device(depth_u16.astype(np.int32), self.model.device)
                self._frame_cache_put(fk, {"depth_dev": depth_dev})
        det_batch = {
            "img": img_shared_dev if img_shared_dev is not None else batch["img"][0],
            "obj_id": ids[0],
            "limg": batch["limg"][0],
            "lmask": batch["lmask"][0],
            "mask": batch["mask"][0],
            "_img_shared_dev": img_shared_dev,
            "_depth_dev": depth_dev,
            "_depth_u16": depth_u16,
        }
        STATS.add_span("detect.build", t0, ids=ids)
        return det_batch

    @staticmethod
    def _completion_dev(ctx) -> tuple:
        """The device tensors a frame's completion fetches: scores, refined
        poses (or None), pp_err."""
        zh = ctx["zhandle"]
        return zh["dev"], zh.get("refined_dev"), ctx["pp_handle"]

    def _pending_completion_dev(self, pending):
        """A deferred frame's completion tensors, or None when there is
        nothing to prefetch (JAX loop :623-636)."""
        if (not self._complete_prefetch or pending is None or pending.get("zhandle") is None
                or "prefetched" in pending or "prefetch_fut" in pending):
            return None
        return self._completion_dev(pending)

    # -------------------------------------------------------------- run
    def _can_defer_completion(self, n_pending: int = 0) -> bool:
        """A frame's completion (score fetch -> pseudo-label -> finetune gate)
        may be deferred past later frames' dispatches only if it cannot
        change the detector's weights: a finetune fires when the buffer
        reaches `next_finetune_number`, and a frame adds at most one target,
        so with `n_pending` completions in flight one more may wait iff
        buffer + n_pending + 1 stays below the boundary. Any frame that could
        finetune completes in order first, so the next frame's detection and
        hypotheses see the weights after it (ref online_learning.py:470-546)."""
        if not self.pipeline_scoring:
            return False
        if self.args.no_finetune:
            return True
        return len(self.train_dataset) + n_pending + 1 < self.next_finetune_number

    def run(self, progress: bool = True) -> list:
        # a profiler session on this thread turns spans on for the IO and
        # fetch threads' work too
        with STATS.across_threads():
            try:
                return self._run(progress)
            finally:
                self.close()

    def _detect(self, batch, ids, bop_data, times, specs, pending, lookahead):
        """This frame's detection on the host, and with pipelining the
        upcoming frames' dispatches and the bundled fetch (JAX loop
        :741-862). Returns (host detections, det_batch)."""
        if not hasattr(self.model, "detect_async"):
            # a detector without the speculative API: one call, results on the host
            det_batch = self._build_det_batch(batch, bop_data)
            return self.model.forward_test_time(det_batch), det_batch
        t0 = time.perf_counter()
        if not self.pipeline_scoring:
            det_batch = self._build_det_batch(batch, bop_data)
            with STATS.span("detect.dispatch", ids):
                out_dev = self.model.detect_async(det_batch)
            times["time_det_miss"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            fetched = self._timed_get("det_fetch", HostCopy(out_dev), "detect.wait", ids)
            with STATS.span("detect.decode", ids):
                out = self.model.fetch_detections(out_dev, det_batch, fetched=fetched)
            times["time_det_fetch"] = time.perf_counter() - t0
            return out, det_batch

        out = out_dev = None
        wv = self.model.weights_version
        entry = specs.pop(ids, None)
        if entry is not None and entry["wv"] == wv:
            # a hit: the handle is the dispatched outputs (not fetched yet),
            # a fetch-thread view, or the decoded host dict
            STATS.count("spec_hit")
            det_batch = entry["det_batch"]
            h = entry["handle"]
            if not entry["fetched"]:
                out_dev = h
            elif isinstance(h, _PartFut):
                tw = time.perf_counter()
                with STATS.span("detect.wait", ids):
                    out = h.result()
                # the main thread's block on the speculative fetch
                STATS.rpc("spec_wait", time.perf_counter() - tw)
            else:
                out = h
        else:
            STATS.count("spec_stale" if entry is not None else "spec_absent")
            # the uploads do not depend on the weights: a stale entry's
            # det_batch is dispatched again under the new weights
            det_batch = entry["det_batch"] if entry is not None else self._build_det_batch(batch, bop_data)
            with STATS.span("detect.dispatch", ids):
                out_dev = self.model.detect_async(det_batch)
        times["time_det_miss"] = time.perf_counter() - t0

        # dispatch the upcoming frames' detections before fetching this
        # one's; stale entries (a finetune) go again on their uploads
        bundle = self._fetch_bundle if self._spec_fetch_thread else 1
        for la in list(lookahead)[:bundle]:
            la_ids = _ids(la)
            e = specs.get(la_ids)
            if e is not None and e["wv"] == wv:
                continue
            if e is not None:
                # its frame will count a hit: the launch count needs this
                STATS.count("spec_redispatch")
            n_det_batch = e["det_batch"] if e is not None else self._build_det_batch(la, self._frame_data(la_ids))
            with STATS.span("detect.dispatch", la_ids):
                n_out = self.model.detect_async(n_det_batch)
            if not self._spec_fetch_thread:
                # inline mode: the copy starts now, behind the detection
                n_out = HostCopy(n_out)
            specs[la_ids] = {"wv": wv, "handle": n_out, "det_batch": n_det_batch, "fetched": False}

        # thread mode: when the next frame's entry has no fetch under way,
        # every unfetched entry and the deferred completions go to the host
        # in one transfer, waited for and decoded on the fetch thread while
        # this frame's PPF and scoring run
        if self._spec_fetch_thread and lookahead:
            ne = specs.get(_ids(lookahead[0]))
            if ne is not None and not ne["fetched"]:
                to_fetch = [e for e in specs.values() if not e["fetched"] and e["wv"] == wv]
                pend = []
                if self._merged_fetch:
                    pend = [(c, d) for c in pending if (d := self._pending_completion_dev(c)) is not None]
                copy = HostCopy((tuple(e["handle"] for e in to_fetch), tuple(d for _, d in pend)))
                fut = self._fetch_submit(self._thread_fetch_multi,
                                         tuple((e["handle"], e["det_batch"]) for e in to_fetch), copy,
                                         "det+complete" if pend else "det_fetch")
                for j, e in enumerate(to_fetch):
                    e["handle"] = _PartFut(fut, 0, j)
                    e["fetched"] = True
                for j, (c, _) in enumerate(pend):
                    c["prefetch_fut"] = _PartFut(fut, 1, j)
        times["time_det_spec"] = time.perf_counter() - t0 - times["time_det_miss"]

        t0 = time.perf_counter()
        if out is None:
            # one transfer for this frame's detection and the deferred
            # frames' completions
            pend = [(c, d) for c in pending if (d := self._pending_completion_dev(c)) is not None]
            fetched_det, pend_fetched = self._timed_get(
                "det+complete" if pend else "det_fetch", HostCopy((out_dev, tuple(d for _, d in pend))),
                "detect.wait", ids)
            for (c, _), f in zip(pend, pend_fetched):
                c["prefetched"] = f
            with STATS.span("detect.decode", ids):
                out = self.model.fetch_detections(out_dev, det_batch, fetched=fetched_det)
        times["time_det_fetch"] = time.perf_counter() - t0
        return out, det_batch

    def _run(self, progress: bool) -> list:
        args = self.args
        test_results = []
        # upcoming frames' speculative detections by ids, in dispatch order:
        # {wv, handle, det_batch, fetched} (see _detect)
        specs: dict = {}
        # completions deferred past later frames' dispatches, oldest first
        pending: deque = deque()

        def complete_pending():
            while pending:
                self._complete_frame(pending.popleft(), test_results, progress)

        it = iter(self.test_loader)
        # ids -> the span clock's time when the loop took the batch from the
        # loader (the start of its `queue` span)
        taken: dict = {}

        def take():
            b = next(it, None)
            if b is not None:
                taken[_ids(b)] = STATS.now()
            return b

        batch = take()
        # with pipelining, the next two loader batches: [0] for the
        # speculation, both for the IO thread's prefetch
        lookahead: deque = deque()
        iteration = -1
        while batch is not None:
            iteration += 1
            ids = _ids(batch)
            STATS.add_span("queue", taken.pop(ids, None), ids=ids)
            t_iter0, t_iter0_ns = time.perf_counter(), STATS.now()
            if self.pipeline_scoring:
                while len(lookahead) < 2:
                    b = take()
                    if b is None:
                        break
                    lookahead.append(b)
                for la in lookahead:
                    la_ids = _ids(la)
                    if la_ids not in self._prefetched and la_ids not in specs:
                        self._prefetched[la_ids] = self._io_submit(
                            self._prefetch_frame, *la_ids, *la["img"].shape[1:3])
            obj_id, scene_id, im_id = ids

            with Timer() as t_data:
                bop_data = self._frame_data(ids)
            depth = bop_data["depth"]
            mat_gt = bop_data["mat_gt"]
            cam_K = np.asarray(bop_data["scene_camera"]["cam_K"])
            is_sym = obj_id in self.bop_dataset.sym_obj_ids
            err_func = add_err if args.fast else (adi_err if is_sym else add_err)
            self.proc_hw = batch["img"].shape[1:3]
            times = {"time_ppf": None, "time_sift": None, "time_zephyr": None,
                     "time_icp": None, "time_finetune": 0,
                     "time_data": t_data.interval, "time_mask": 0.0,
                     "time_pperr": 0.0, "time_label": 0.0, "time_iter": 0.0,
                     "time_det_miss": 0.0, "time_det_spec": 0.0, "time_det_fetch": 0.0}

            # ---- DTOID detection ------------------------------------------
            with Timer() as t:
                out, det_batch = self._detect(batch, ids, bop_data, times, specs, pending, lookahead)
            final_score = out["final_score"][0]
            dtoid_confident = bool(final_score[0] > DTOID_CONFIDENT_THRESHOLD)
            if args.ignore_dtoid_mask:
                use_dtoid_mask = False
            elif args.always_dtoid_mask:
                use_dtoid_mask = True
            else:
                use_dtoid_mask = dtoid_confident
            if iteration < args.finetune_warmup:
                use_dtoid_mask = False

            ctx = {
                "iteration": iteration, "obj_id": obj_id, "scene_id": scene_id, "im_id": im_id,
                "depth": depth, "mat_gt": mat_gt, "cam_K": cam_K,
                "model_points": self.model_clouds[obj_id][0], "err_func": err_func,
                "mask_gt": bop_data["mask_gt"], "mask_gt_visib": bop_data["mask_gt_visib"],
                "times": times, "time_dtoid": t.interval,
                "final_bbox": out["final_bbox"][0], "final_score": final_score,
                "dtoid_iou": out.get("seg_IoU", 0.0), "dtoid_pred_mask": out["segmentation"],
                "dtoid_confident": dtoid_confident, "use_dtoid_mask": use_dtoid_mask,
                "zhandle": None, "zr": self.zephyr_results.get(ids),
                "pp_err": None, "n_hypos": 0, "img_dev": det_batch["_img_shared_dev"],
            }
            if not use_dtoid_mask and ctx["zr"] is None:
                raise RuntimeError(f"no precomputed zephyr result for {ids}")
            if use_dtoid_mask and self._pose_estimate(ctx, bop_data, det_batch, out) \
                    and self._can_defer_completion(n_pending=len(pending)):
                # completes while later frames run on the device; only the
                # entries older than the pipeline depth complete now
                while len(pending) >= self._pipeline_depth:
                    self._complete_frame(pending.popleft(), test_results, progress)
                pending.append(ctx)
                if self._spec_fetch_thread and not self._merged_fetch:
                    # OSSID_MERGED_FETCH=0: the completion's own transfer,
                    # waited for on the fetch thread
                    d = self._pending_completion_dev(ctx)
                    if d is not None:
                        ctx["prefetch_fut"] = self._fetch_submit(self._timed_get, "complete_thread",
                                                                 HostCopy(d), "fetch.wait")
            else:
                # no hypotheses (the precomputed result stands in, else an
                # unconfident identity: ref online_learning.py:367-378), or a
                # frame that may finetune: everything in flight completes in
                # order, then this frame
                complete_pending()
                times["time_iter"] = time.perf_counter() - t_iter0
                self._complete_frame(ctx, test_results, progress)
            # dispatch half of the iteration (a deferred completion lands in
            # a later iteration's wall)
            times["time_iter"] = time.perf_counter() - t_iter0
            STATS.add_span("iteration", t_iter0_ns, ids=ids)
            if pending and pending[-1] is ctx:
                ctx["t_dispatched"] = STATS.now()
            batch = lookahead.popleft() if lookahead else take()
        complete_pending()
        with STATS.span("resolve.wait"):
            # a bundle whose every part went stale is read by no frame
            for fut in self._fetch_futs:
                fut.result()
            self._resolve_finetunes()
        return test_results

    def _resolve_finetunes(self) -> None:
        """The finetune losses, fetched once each now that their steps ran,
        and on the card each finetune row's `time_finetune`: the device time
        between the events recorded before its first step and after its
        last."""
        self.finetune_logs = [l.resolve() for l in self.finetune_logs]
        for row, start, end in self._finetune_clocks:
            end.synchronize()
            row["time_finetune"] = start.elapsed_time(end) / 1e3
        self._finetune_clocks = []

    def _pose_estimate(self, ctx, bop_data, det_batch, out) -> bool:
        """Region mask -> hypotheses -> scoring with device ICP dispatched,
        and the per-hypothesis pp_err beside it (ctx['zhandle'],
        ctx['pp_handle']). False when hypothesis generation found nothing."""
        args, times, obj_id = self.args, ctx["times"], ctx["obj_id"]
        depth, cam_K = ctx["depth"], ctx["cam_K"]
        t0, ids = STATS.now(), (obj_id, ctx["scene_id"], ctx["im_id"])
        with Timer() as t_mask:
            dist_mask = self._dtoid_mask(out, depth)
        times["time_mask"] = t_mask.interval
        # scoring's depth: the detection-time upload, or a crop around the
        # region sent now, to travel during hypothesis generation
        depth_mm, depth_origin = det_batch["_depth_dev"], None
        if int(getattr(args, "zephyr_depth_crop", 0) or 0):
            y0, x0, sh, sw = self._depth_crop_window(dist_mask, depth.shape)
            crop = det_batch["_depth_u16"][y0:y0 + sh, x0:x0 + sw]
            depth_mm = to_device(crop.astype(np.int32), self.model.device)
            depth_origin = np.asarray([y0, x0], np.int32)
        STATS.add_span("mask", t0, ids=ids)
        frame = det_batch["_img_shared_dev"]
        img = frame[0] if frame is not None else bop_data["img"]
        # SIFT reads the raw image: the shared frame is it unless rebuilt from YUV
        with STATS.span("hypotheses", ids):
            poses = self._generate_hypotheses(obj_id, bop_data["img"] if self._yuv else img, depth,
                                              dist_mask, cam_K, bop_data["scene_meta"], times)
        if len(poses) == 0:
            return False
        pts, cols, nrms = self.model_clouds[obj_id]
        data = {"img": img, "depth": depth_mm, "cam_K": cam_K, "model_points": pts,
                "model_colors": cols, "model_normals": nrms, "pose_hypos": poses}
        if depth_origin is not None:
            data["depth_origin"] = depth_origin
        with STATS.span("score.dispatch", ids), Timer() as t:
            ctx["zhandle"] = self._zephyr_for(obj_id).score_hypotheses_async(data, obj_id=obj_id)
        times["time_zephyr"] = t.interval
        ctx["n_hypos"] = len(poses)
        with STATS.span("pp_err.dispatch", ids), Timer() as t_pp:
            pts_dev, pts_q_dev = self._pp_pts(obj_id)
            ctx["pp_handle"] = pp_err_batch_async(poses, ctx["mat_gt"], pts_dev,
                                                  symmetric=ctx["err_func"] is adi_err, pts_q_dev=pts_q_dev)
        times["time_pperr"] = t_pp.interval
        return True

    def _complete_frame(self, ctx, test_results, progress):
        """Post-scoring half of one frame (ref online_learning.py:470-589):
        score fetch, host ICP, pseudo-label render, self-supervision gate,
        finetune and the result row. Runs at once or deferred (see
        _can_defer_completion)."""
        ids = (ctx["obj_id"], ctx["scene_id"], ctx["im_id"])
        STATS.add_span("deferred", ctx.pop("t_dispatched", None), ids=ids)
        t_complete0, t_complete0_ns = time.perf_counter(), STATS.now()
        args = self.args
        obj_id, scene_id, im_id = ids
        depth, mat_gt, cam_K = ctx["depth"], ctx["mat_gt"], ctx["cam_K"]
        times, iteration = ctx["times"], ctx["iteration"]
        zh, hypo_scores = ctx["zhandle"], None
        if zh is None:
            zr = ctx["zr"]
            if zr is None:
                # no hypotheses and no precomputed result: the Zephyr gate
                # never opens for this frame
                pred_pose, pred_score = np.eye(4), float("-inf")
            else:
                pred_pose, pred_score = np.asarray(zr["pred_pose"]), zr["score"]
        else:
            with Timer() as t:
                # a deferred frame's outputs usually came with an earlier
                # transfer (merged into a detection fetch, or on the fetch
                # thread); else one transfer for all three now
                fut = ctx.pop("prefetch_fut", None)
                if fut is not None:
                    tw = time.perf_counter()
                    with STATS.span("complete.wait", ids):
                        pre = fut.result()
                    STATS.rpc("complete_wait", time.perf_counter() - tw)
                else:
                    pre = ctx.pop("prefetched", None)
                if pre is None:
                    pre = self._timed_get("complete", HostCopy(self._completion_dev(ctx)), "complete.wait", ids)
                fz, fref, fpp = pre
                with STATS.span("complete.decode", ids):
                    zout = self._zephyr_for(obj_id).fetch_scores(zh, fetched=fz, refined_fetched=fref)
            times["time_zephyr"] += t.interval
            with STATS.span("complete.decode", ids):
                ctx["pp_err"] = pp_err_fetch(ctx["pp_handle"], fetched=fpp)
            pred_pose, pred_score, hypo_scores = zout["pred_pose"], zout["pred_score"], zout["scores"]
            if self.use_icp:
                with STATS.span("icp", ids), Timer() as t:
                    # crop box from the model points projected on the host
                    # under the picked pose (the device uv map's row for it)
                    pts = ctx["model_points"]
                    cam = pts @ pred_pose[:3, :3].T + pred_pose[:3, 3]
                    z = np.clip(cam[:, 2], 1e-6, None)
                    uv = np.stack([cam_K[0, 0] * cam[:, 0] / z + cam_K[0, 2],
                                   cam_K[1, 1] * cam[:, 1] / z + cam_K[1, 2]], axis=1).round().astype(int)
                    pred_pose, _ = icp_refinement(depth, uv, pred_pose, cam_K, pts, icp_max_dist=0.01)
                times["time_icp"] = t.interval

        pred_err = ctx["err_func"](pred_pose[:3, :3], pred_pose[:3, 3], mat_gt[:3, :3],
                                   mat_gt[:3, 3], ctx["model_points"])

        # ---- pseudo-label mask ----------------------------------------
        with STATS.span("label", ids), Timer() as t_label:
            pred_depth = self._render_pred(obj_id, cam_K, pred_pose, depth.shape)
            pred_mask = pred_depth > 0
            gt_mask = np.asarray(ctx["mask_gt"]) > 0
            gt_mask_visib = np.asarray(ctx["mask_gt_visib"]) > 0
            pred_mask_visib = estimate_visib_mask_gt(depth, pred_depth, 15 / 1000.0)
        times["time_label"] = t_label.interval

        # ---- self-supervision gate + finetune -------------------------
        z_th = getattr(args, "zephyr_confident_threshold", ZEPHYR_CONFIDENT_THRESHOLD)
        zephyr_confident = True if args.use_oracle_gt else pred_score > z_th
        finetune, clock = False, None
        if not args.no_finetune and zephyr_confident:
            with STATS.span("gate", ids):
                self.train_dataset.addTarget(obj_id, scene_id, im_id)
                label_mask = gt_mask_visib if args.use_oracle_gt else pred_mask_visib
                self.train_dataset.updateZephyrMask(obj_id, scene_id, im_id, label_mask, pred_score)
                if self.replay is not None:
                    self.replay.add(ids, ctx["img_dev"], label_mask, mat_gt)
            if len(self.train_dataset) == self.next_finetune_number:
                finetune = True
                t_event, event = STATS.now(), len(self.finetune_logs)
                if args.finetune_reset:
                    self.model.load_state_dict(self.initial_state_dict)
                    self.model.reset_optimizer()
                if self.model.device.type == "cuda":
                    # on the card the event is timed on the device, read at
                    # the run's end (_resolve_finetunes): no wait here
                    clock = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    clock[0].record()
                with Timer() as t:
                    logs = finetune_dtoid(self.model, self.train_dataset,
                                          epochs=args.finetune_epochs,
                                          batch_size=args.finetune_batch_size, replay=self.replay, event=event)
                if clock is not None:
                    clock[1].record()
                times["time_finetune"] = t.interval
                self.finetune_logs.append(logs)
                if args.save_each:
                    self._save_each_ckpt(iteration)
                STATS.add_span("finetune", t_event, ids=event)
                if args.non_cum:
                    self.train_dataset.clearTargets()
                    self.next_finetune_number = args.finetune_interval
                else:
                    self.next_finetune_number += args.finetune_interval

        t_row = STATS.now()
        iou = np.logical_and(pred_mask, gt_mask).sum() / max(np.logical_or(pred_mask, gt_mask).sum(), 1)
        iou_visib = np.logical_and(pred_mask_visib, gt_mask_visib).sum() / max(
            np.logical_or(pred_mask_visib, gt_mask_visib).sum(), 1)
        result = {
            "obj_id": obj_id, "scene_id": scene_id, "im_id": im_id,
            "dtoid_confident": ctx["dtoid_confident"],
            "zephyr_confident": bool(zephyr_confident),
            "use_dtoid_mask": bool(ctx["use_dtoid_mask"]),
            "finetune": finetune,
            "dtoid_iou": float(ctx["dtoid_iou"]),
            "dtoid_pred_mask": ctx["dtoid_pred_mask"],
            "dtoid_bbox": ctx["final_bbox"],
            "dtoid_score": ctx["final_score"],
            "pred_pose": pred_pose,
            "pred_score": float(pred_score),
            "pred_err": float(pred_err),
            "pred_add01d": float(pred_err < 0.1 * self.diameters[obj_id]),
            "pred_mask": pred_mask,
            "pred_mask_visib": pred_mask_visib,
            "pred_iou": float(iou),
            "pred_iou_visib": float(iou_visib),
            "n_hypos": int(ctx["n_hypos"]),
            "pp_err": ctx["pp_err"],
            "hypo_scores": hypo_scores,
            "time_dtoid": ctx["time_dtoid"],
            **times,
        }
        if clock is not None:
            self._finetune_clocks.append((result, *clock))
        result["time_complete"] = time.perf_counter() - t_complete0
        test_results.append(result)
        STATS.add_span("row", t_row, ids=ids)
        STATS.add_span("complete", t_complete0_ns, ids=ids)
        if progress and iteration % 10 == 0:
            print(f"[{iteration + 1}/{len(self.test_loader)}] obj {obj_id} "
                  f"score {pred_score:.2f} add01d {result['pred_add01d']:.0f} "
                  f"dtoid {ctx['time_dtoid'] * 1000:.0f}ms", flush=True)

    def _save_each_ckpt(self, iteration: int) -> None:
        """--save_each: the weights right after each finetune, as
        <save_root>/<exp_name>/epoch_<iteration>.ckpt (ref
        online_learning.py:535-546), a torch file with the iteration and the
        configuration beside the state_dict, under `args.save_root`."""
        root = getattr(self.args, "save_root", None)
        if not root:
            raise ValueError("--save_each needs args.save_root")
        folder = os.path.join(root, self.args.exp_name)
        os.makedirs(folder, exist_ok=True)
        save_checkpoint(os.path.join(folder, f"epoch_{iteration}.ckpt"), self.model.state_dict(),
                        extra={"iteration": iteration, "conf": self.cfg.to_dict()})

    def save_results(self, path: str, test_results: list) -> None:
        """The JAX CLI's results pickle: rows, arguments, finetune logs and
        the final DTOID weights (numpy, under the port's key names)."""
        with open(path, "wb") as f:
            pickle.dump({
                "test_results": test_results,
                "main_args": vars(self.args),
                "finetune_logs": self.finetune_logs,
                "final_state_dict": {k: v.cpu().numpy() for k, v in self.model.state_dict().items()},
            }, f)


def _maskrcnn_feed(batch: dict, n_classes: int) -> dict:
    """A DtoidBopDataset batch as the class-conditional detector's train feed
    (JAX loop/online_learning.py:1196-1214): class index obj_id - 1,
    per-class masks, and `cls_valid` marking only each row's labelled class:
    a row annotates one object, and the frame's other objects, unlabelled,
    must add no loss (trained as background they collapse the detector)."""
    b, h, w, _ = batch["mask"].shape
    masks = np.zeros((b, h, w, n_classes), np.float32)
    cls_valid = np.zeros((b, n_classes), np.float32)
    bbox = np.asarray(batch["bbox_gt"], np.float32).copy()
    for i in range(b):
        cls = int(batch["obj_id"][i]) - 1
        masks[i, ..., cls] = batch["mask"][i, ..., 0]
        cls_valid[i, cls] = 1.0
        valid = bbox[i, :, 4] >= 0
        bbox[i, valid, 4] = cls
    return {"img": batch["img"], "bbox_gt": bbox, "masks": masks, "cls_valid": cls_valid}


def _collect_loss_logs(loss_per_epoch: list) -> list:
    """[[loss tensor, ...], ...] -> reference-schema logs, fetched from the
    device in one copy."""
    flat = [l for ep in loss_per_epoch for l in ep]
    if flat:
        flat = torch.stack(flat).cpu().tolist()
    it = iter(flat)
    return [[{"train_loss": next(it)} for _ in ep] for ep in loss_per_epoch]


class DeferredLogs:
    """Finetune loss logs whose device scalars are not fetched yet: the
    weight updates are already enqueued, so the finetune event need not wait
    for its steps; the loop resolves these at the end of the run, one fetch
    an event (JAX loop :1233-1251)."""

    def __init__(self, loss_per_epoch):
        self._raw = loss_per_epoch
        self._resolved = None

    def resolve(self) -> list:
        if self._resolved is None:
            self._resolved = _collect_loss_logs(self._raw)
            self._raw = None
        return self._resolved


def _finetune_replay(model, train_dataset, replay, epochs: int, batch_size: int, event=None):
    """Device-feed finetune pass: frames come from the detection-time uploads
    held by the replay buffer (uint8 + bit-packed pseudo-masks); only
    templates, heat maps and boxes ship from the host. Returns None when the
    buffer cannot serve the pass (an uncovered target, a resolution mismatch,
    a non-u8 frame, a model without `train_step_u8`), and the caller runs
    the host-loader pass."""
    targets = train_dataset.bop_dataset.targets
    if not hasattr(model, "train_step_u8") or not replay.covers(targets):
        return None
    img_h, img_w = model.img_size
    keys = [(int(t["obj_id"]), int(t["scene_id"]), int(t["im_id"])) for t in targets]
    if any(replay.bits(k).shape[1] * 8 != img_h * img_w for k in keys):
        return None  # pseudo-labels not at the model's native resolution

    # host frames for buffer misses, checked before any step runs so that a
    # fallback never trains twice
    host_frames: dict = {}
    for k in keys:
        if replay.frame(k) is None:
            raw = np.asarray(train_dataset.bop_dataset.getDataByIds(*k)["img"])
            if raw.shape[:2] != (img_h, img_w) or raw.dtype != np.uint8:
                return None
            host_frames[k] = torch.from_numpy(raw[None]).to(model.device)

    rng = np.random.default_rng(len(keys))
    loss_per_epoch = []
    for _ in range(epochs):
        order = rng.permutation(len(keys))
        epoch_losses = []
        for i0 in range(0, len(order), batch_size):
            with STATS.span("finetune.feed", event):
                sel = order[i0:i0 + batch_size]
                if len(sel) < batch_size:  # pad by repetition to the batch size
                    sel = np.resize(sel, batch_size)
                bkeys = [keys[j] for j in sel]
                frames = [replay.frame(k) if replay.frame(k) is not None else host_frames[k]
                          for k in bkeys]
                feed = {"img_u8": torch.cat(frames, 0),
                        "mask_bits": np.concatenate([replay.bits(k) for k in bkeys], axis=0)}
                anns = [train_dataset.replay_annotations(
                            k[0], replay.mat_gt(k), train_dataset.zephyr_results[k]["pred_mask_visib"])
                        for k in bkeys]
                for f in ("limg_u8", "lmask_u8", "gimg_u8", "gmask_u8", "bbox_gt", "heatmap"):
                    feed[f] = np.stack([a[f] for a in anns])
            with STATS.span("finetune.step", event):
                epoch_losses.append(model.train_step_u8(feed)["loss"])
        loss_per_epoch.append(epoch_losses)
    model.clear_cache()  # template features are stale after weight updates
    replay.n_replay_events += 1
    return DeferredLogs(loss_per_epoch)


def finetune_dtoid(model, train_dataset, epochs: int = 1, batch_size: int = 8,
                   replay=None, event=None) -> DeferredLogs:
    """Online finetuning pass (ref online_learning.py:650-679): one train
    step per batch of the pseudo-labelled buffer, padded to `batch_size`;
    from the replay buffer when it covers the buffer, else from the host
    loader. Returns the per-step losses as a DeferredLogs: the steps are
    enqueued, and `.resolve()` fetches the losses in one copy. `event` (the
    loop's index of this finetune) tags each step's `finetune.feed` and
    `finetune.step` spans."""
    if replay is not None:
        logs = _finetune_replay(model, train_dataset, replay, epochs, batch_size, event)
        if logs is not None:
            return logs
    loader = NumpyLoader(train_dataset, batch_size=batch_size, shuffle=True,
                         seed=len(train_dataset), prefetch=2)
    loss_per_epoch = []
    for _ in range(epochs):
        epoch_losses = []
        batches = iter(loader)
        while True:
            t_feed = STATS.now()
            batch = next(batches, None)
            if batch is None:
                break
            b = len(batch["img"])
            if b < batch_size:  # pad by repetition to the batch size
                idx = np.resize(np.arange(b), batch_size)
                batch = {k: v[idx] if isinstance(v, np.ndarray) and len(v) == b else v
                         for k, v in batch.items()}
            if hasattr(model, "n_classes"):  # the class-conditional detector
                feed = _maskrcnn_feed(batch, model.n_classes)
            else:
                feed = {k: batch[k] for k in ("img", "limg", "lmask", "gimg", "gmask",
                                              "bbox_gt", "heatmap", "mask")}
            STATS.add_span("finetune.feed", t_feed, ids=event)
            with STATS.span("finetune.step", event):
                epoch_losses.append(model.train_step(feed)["loss"])
        loss_per_epoch.append(epoch_losses)
    model.clear_cache()
    return DeferredLogs(loss_per_epoch)


def test_dtoid_model(model, test_loader, bop_dataset=None):
    """Detection-only evaluation pass (`--raw_dtoid`, ref
    online_learning.py:620-648): one row per target."""
    test_results = []
    for batch in test_loader:
        obj_id = int(batch["obj_id"][0])
        out = model.forward_test_time({
            "img": batch["img"][0], "obj_id": obj_id, "limg": batch["limg"][0],
            "lmask": batch["lmask"][0], "mask": batch["mask"][0]})
        test_results.append({
            "obj_id": obj_id,
            "scene_id": int(batch["scene_id"][0]),
            "im_id": int(batch["im_id"][0]),
            "dtoid_bbox": out["final_bbox"][0],
            "dtoid_score": out["final_score"][0],
            "dtoid_iou": float(out.get("seg_IoU", 0.0)),
            "dtoid_pred_mask": out["segmentation"],
            "gt_bbox": np.asarray(batch["bbox_gt"][0, 0, :4]),
        })
    return test_results
