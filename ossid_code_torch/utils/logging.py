"""Metric logging and log reading (the port of ossid_code_tpu/utils/logging.py).

`MetricLogger` is the train CLI's metric stream: one JSON object a line,
{'step', 'time', **scalars}, and the same scalars as TensorBoard events where
`torch.utils.tensorboard` imports (observability only; the JSONL stream is
the record).

The readers have the JAX module's names and roles (ref utils/tb.py:8-53,
utils/results.py:12, utils/ttt.py:5). The card's machine has no pandas, so
where JAX's return a DataFrame these return a dict of numpy columns in the
DataFrame's column order (a column with missing numbers holds NaN, as
pandas' does); `tflog2pandas` reads the event files with the port's own
`utils/event_file.py`.
"""

from __future__ import annotations

import json
import os
import pickle
import time

import numpy as np

from ossid_code_torch.utils.event_file import read_scalars


class MetricLogger:
    """Append-only JSONL metric stream, with TensorBoard events in `tb_dir`
    when given and available."""

    def __init__(self, path: str, tb_dir: str | None = None):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._tb = None
        if tb_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"MetricLogger: tensorboard writer unavailable ({e!r}); jsonl only")
            else:
                self._tb = SummaryWriter(log_dir=tb_dir)

    def log(self, step: int, **scalars):
        row = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            row[k] = float(v) if np.isscalar(v) or hasattr(v, "item") else v
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, int(step))
            self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def tflog2pandas(path: str) -> dict:
    """TensorBoard event file, or a directory of them (`*tfevents*`, in name
    order), -> long-form columns {"metric": str, "value": float64, "step":
    int64}: the scalars grouped by tag in the order the tags first appear,
    each tag's in file order. JAX's returns these columns as a DataFrame
    (the reference's tflog2pandas shape, ref utils/tb.py:8-53). Unlike
    TensorBoard's reader this one does not drop events a restarted run
    wrote over (a step that goes back)."""
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path) if "tfevents" in f)
    else:
        files = [path]
    by_tag: dict[str, list] = {}
    for f in files:
        for s in read_scalars(f):
            by_tag.setdefault(s.tag, []).append(s)
    rows = [s for scalars in by_tag.values() for s in scalars]
    return {"metric": np.asarray([s.tag for s in rows], dtype=object),
            "value": np.asarray([float(s.value) for s in rows], dtype=np.float64),
            "step": np.asarray([int(s.step) for s in rows], dtype=np.int64)}


def _columns(rows: list[dict]) -> dict:
    """Row dicts -> {column: numpy array}, the columns in order of first
    appearance: integers int64 and booleans bool where no row lacks them,
    other numbers float64 with NaN for a missing value (as pandas builds
    them), anything else an object array with None for a missing value."""
    keys: dict = {}
    for r in rows:
        keys.update(dict.fromkeys(r))
    out = {}
    for k in keys:
        vals = [r.get(k) for r in rows]
        present = [v for v in vals if v is not None]
        missing = len(present) < len(vals)
        if present and all(isinstance(v, (bool, np.bool_)) for v in present) and not missing:
            out[k] = np.asarray(vals, dtype=bool)
        elif present and all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
                             for v in present) and not missing:
            out[k] = np.asarray(vals, dtype=np.int64)
        elif present and all(isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, (bool, np.bool_))
                             for v in present):
            out[k] = np.asarray([np.nan if v is None else float(v) for v in vals], dtype=np.float64)
        else:
            out[k] = np.asarray(vals, dtype=object)
    return out


def read_log(path: str) -> dict:
    """JSONL metric stream -> columns (JAX's DataFrame; role of ref
    utils/tb.py:8-53)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return _columns(rows)


def load_result(path: str) -> dict:
    """Online-loop result pickle -> per-frame columns of the rows' scalar
    fields (role of ref utils/results.py:12 and utils/ttt.py:5). The pickle
    is one this program wrote."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    rows = payload["test_results"] if isinstance(payload, dict) else payload
    return _columns([{k: v for k, v in r.items() if np.isscalar(v) or isinstance(v, (bool, int, float, str))}
                     for r in rows])


def summarize_result(path: str) -> dict:
    """Headline numbers the reference prints at the end of a run
    (ref scripts/online_learning.py:610-613)."""
    cols = load_result(path)
    out = {}

    def num(k):
        return np.asarray([np.nan if v is None else float(v) for v in cols[k]], dtype=np.float64)

    if "dtoid_iou" in cols:
        out["dtoid_mean_iou"] = float(np.nanmean(num("dtoid_iou")))
        out["dtoid_valid_iou_recall"] = float((num("dtoid_iou") > 0.5).mean())
    if "pred_iou_visib" in cols:
        out["zephyr_valid_iou_recall"] = float((num("pred_iou_visib") > 0.5).mean())
    if "pred_add01d" in cols:
        out["add01d"] = float(np.nanmean(num("pred_add01d")))
    for k in ("time_dtoid", "time_ppf", "time_zephyr", "time_finetune"):
        if k in cols:
            out[f"mean_{k}"] = float(np.nanmean(num(k)))
    return out
