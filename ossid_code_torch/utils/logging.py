"""The train CLI's metric stream (the port of ossid_code_tpu/utils/logging.py's
MetricLogger): one JSON object a line, {'step', 'time', **scalars}, and the
same scalars as TensorBoard events where `torch.utils.tensorboard` imports
(observability only; the JSONL stream is the record). The JAX module's log
readers (`tflog2pandas`, `read_log`, `load_result`) are not ported
(ROADMAP.md §1 item 5.2)."""

from __future__ import annotations

import json
import os
import time

import numpy as np


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
