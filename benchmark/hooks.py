"""What the benchmark wraps around the program's instances, from its own
files: the spans of each layer, the hand-off and completion times of each
target, and what the check needs of each completed target.

Every wrapper is an instance attribute, installed once and doing only host
bookkeeping: a clock read, a reference kept. Spans are logged only while a
trace runs (`SpanLog.on`), and read against it (trace.py).
"""

from __future__ import annotations

import threading
import time

import numpy as np

def target_ids(batch) -> tuple:
    return int(batch["obj_id"][0]), int(batch["scene_id"][0]), int(batch["im_id"][0])


class Stream:
    """The harness's stream of targets: a closed loop over the test loader.
    `use(targets)` sets the targets of the next pass; each target's hand-off
    is the moment the loop takes it from the stream."""

    def __init__(self, loader):
        self.loader = loader
        self.dataset = loader.dataset
        self.handoff: dict = {}

    def use(self, targets: list) -> None:
        self.dataset.bop_dataset.targets = [dict(t) for t in targets]
        self.handoff = {}

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.handoff[target_ids(batch)] = time.perf_counter()
            yield batch


class SpanLog:
    """The benchmark's spans while `on`: (name, native thread id, start ns,
    end ns) on the wall clock the profiler stamps its records with
    (`time.time_ns`), so that a CUDA-only trace can be read against them."""

    def __init__(self):
        self.on = False
        self.spans: list = []

    def spanned(self, name: str, fn):
        def call(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((name, threading.get_native_id(), t0, time.time_ns()))
        return call


class Hooks:
    """Installs the spans and captures on one loop, its detector and scorer.

    For each completed target it keeps a record (`records`, in completion
    order): its ids, completion time, row, the detections' template ids,
    the weights version its detection ran on, and the hypotheses it scored.
    Counters: detections dispatched, score calls with their hypothesis
    counts, train steps."""

    def __init__(self, loop, dtoid, zephyr):
        self.loop, self.dtoid, self.zephyr = loop, dtoid, zephyr
        self._lock = threading.Lock()
        self._dispatch_wv: dict = {}   # id(detect outputs) -> weights version at dispatch
        self._fetched: dict = {}       # id(host scores) -> (template ids, weights version)
        self._scored: dict = {}        # id(score handle) -> hypotheses
        self.records: list = []
        self.log = SpanLog()
        # called with each train step's outputs when set (set-up's capture)
        self.on_step = None
        self.reset_counts()
        self._install()

    def reset_counts(self) -> None:
        with self._lock:
            self.detects = 0
            self.score_hypos: list = []
            self.steps = 0

    def clear(self) -> None:
        """Drop the captures (not the installed wrappers)."""
        with self._lock:
            self._dispatch_wv.clear()
            self._fetched.clear()
            self._scored.clear()
            self.records = []

    def _install(self) -> None:
        dtoid, zephyr, loop = self.dtoid, self.zephyr, self.loop
        _spanned = self.log.spanned

        detect_async = _spanned("detect", dtoid.detect_async)

        def detect(batch, *a, **k):
            out = detect_async(batch, *a, **k)
            with self._lock:
                self.detects += 1
                self._dispatch_wv[id(out)] = dtoid.weights_version
            return out
        dtoid.detect_async = detect

        fetch_detections = _spanned("detect_fetch", dtoid.fetch_detections)

        def fetch(out_dev, *a, **k):
            res = fetch_detections(out_dev, *a, **k)
            with self._lock:
                wv = self._dispatch_wv.pop(id(out_dev), None)
                self._fetched[id(res["pred_scores"])] = (np.asarray(res["pred_template_ids"]), wv)
            return res
        dtoid.fetch_detections = fetch

        score_async = _spanned("score", zephyr.score_hypotheses_async)

        def score(data, *a, **k):
            handle = score_async(data, *a, **k)
            with self._lock:
                self.score_hypos.append(int(len(data["pose_hypos"])))
                self._scored[id(handle)] = np.asarray(data["pose_hypos"], np.float32)
            return handle
        zephyr.score_hypotheses_async = score
        zephyr.fetch_scores = _spanned("score_fetch", zephyr.fetch_scores)

        train_step_u8 = _spanned("step", dtoid.train_step_u8)

        def step(feed):
            out = train_step_u8(feed)
            self.steps += 1
            if self.on_step is not None:
                self.on_step(out)
            return out
        dtoid.train_step_u8 = step

        loop._generate_hypotheses = _spanned("hypotheses", loop._generate_hypotheses)
        loop._render_pred = _spanned("label", loop._render_pred)
        complete_frame = _spanned("complete", loop._complete_frame)

        def complete(ctx, test_results, progress):
            n = len(test_results)
            complete_frame(ctx, test_results, progress)
            t = time.perf_counter()
            if len(test_results) == n:
                return
            with self._lock:
                tids, wv = self._fetched.pop(id(ctx["final_score"]), (None, None))
                hypos = self._scored.pop(id(ctx["zhandle"]), None) if ctx.get("zhandle") is not None else None
                self.records.append({"ids": (ctx["obj_id"], ctx["scene_id"], ctx["im_id"]), "done": t,
                                     "row": test_results[-1], "template_ids": tids, "weights_version": wv,
                                     "hypotheses": hypos})
        loop._complete_frame = complete
