"""Per-run accounting of device->host fetches and speculation outcomes (the
port's copy of ossid_code_tpu/utils/rpc_stats.py, same kinds and semantics).

The pipelined loop dispatches detections ahead and fetches their results,
bundled with deferred completions, on a fetch thread. Whether that schedule
works shows in these counts: how many fetches a frame takes, how long each
took, how long the main thread blocked on one, and whether the next-frame
speculation hit. Beside the JAX package's kinds the port counts
`spec_redispatch`: a speculative detection that a finetune made stale and
that is dispatched again before its frame comes (its frame then counts a
hit), so that a run's detections are its targets plus spec_stale plus
spec_redispatch. On the card a fetch is one device->host transfer of a
bundle: copies into pinned host memory and an event after them, the fetch
waiting on that event (utils/host_copy.py). The loop records into STATS;
a caller resets it before a run and reads it after.

Counters are thread-safe: the fetch and IO threads record too.
"""

from __future__ import annotations

import threading


class RunStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            # event counters (speculation outcomes, ...)
            self.counts: dict[str, int] = {}
            # fetch timings: kind -> [n_calls, total_seconds]
            self.rpcs: dict[str, list] = {}

    def count(self, kind: str, n: int = 1):
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + n

    def rpc(self, kind: str, seconds: float):
        """Kinds ending in '_wait' are main-thread blocks on side-thread
        futures, not fetches: reported, but left out of the per-frame
        fetch count."""
        with self._lock:
            e = self.rpcs.setdefault(kind, [0, 0.0])
            e[0] += 1
            e[1] += seconds

    # ------------------------------------------------------------- reporting
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counts": dict(self.counts),
                "rpcs": {k: (v[0], v[1]) for k, v in self.rpcs.items()},
            }

    def summary(self, n_frames: int | None = None) -> str:
        s = self.snapshot()
        parts = []
        c = s["counts"]
        hits = c.get("spec_hit", 0)
        misses = c.get("spec_stale", 0) + c.get("spec_absent", 0)
        if hits + misses:
            parts.append(
                f"spec hit {hits}/{hits + misses}"
                + (f" (stale {c['spec_stale']})" if c.get("spec_stale") else "")
            )
        total_rpcs = 0
        for k in sorted(s["rpcs"]):
            n, t = s["rpcs"][k]
            if not k.endswith("_wait"):
                total_rpcs += n
            parts.append(f"{k} n={n} mean={t / max(n, 1) * 1e3:.1f}ms")
        if n_frames:
            parts.append(f"fetch_rpc/frame={total_rpcs / n_frames:.2f}")
        return "; ".join(parts) if parts else "(no rpc stats)"

    def fetch_rpcs_per_frame(self, n_frames: int) -> float:
        s = self.snapshot()
        return sum(n for k, (n, _) in s["rpcs"].items()
                   if not k.endswith("_wait")) / max(n_frames, 1)

    def spec_hit_rate(self) -> float | None:
        c = self.snapshot()["counts"]
        hits = c.get("spec_hit", 0)
        total = hits + c.get("spec_stale", 0) + c.get("spec_absent", 0)
        return hits / total if total else None


# module-level instance shared by the loop and its callers
STATS = RunStats()
