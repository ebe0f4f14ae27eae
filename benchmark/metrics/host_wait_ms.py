"""The main thread's time blocked in the traced pass, per target: the union
of its `*.wait` spans (frames from the IO thread, detections and
completions from the device or the fetch thread, the run's last fetches),
from the program's span log (`STATS.snapshot()["spans"]`, the thread of
its `iteration` spans). The other readers of that thread's time take the
helpers here."""


def main_thread(run) -> dict | None:
    """{span name: [(start ns, end ns), ...]} of the main thread, or None
    where the run has no span log."""
    spans = (run.stats or {}).get("spans")
    tids = {tid for name, tid, *_ in spans or () if name == "iteration"}
    if not tids:
        return None
    out: dict = {}
    for name, tid, start, end, _ in spans:
        if tid in tids:
            out.setdefault(name, []).append((start, end))
    return out


def union(*groups) -> list:
    out = []
    for start, end in sorted(tuple(iv) for g in groups for iv in g):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def length_less(a: list, b: list) -> int:
    """The length of union a less its overlap with union b (ns)."""
    overlap, j = 0, 0
    for start, end in a:
        while j < len(b) and b[j][1] <= start:
            j += 1
        k = j
        while k < len(b) and b[k][0] < end:
            overlap += min(end, b[k][1]) - max(start, b[k][0])
            k += 1
    return sum(end - start for start, end in a) - overlap


def waits(spans: dict) -> list:
    return union(*(v for k, v in spans.items() if k.endswith(".wait")))


def per_target_ms(run, ns: int) -> float | None:
    targets = sum(p["targets"] for p in run.passes)
    return ns / 1e6 / targets if targets else None


def read(run):
    spans = main_thread(run)
    return None if spans is None else per_target_ms(run, sum(end - start for start, end in waits(spans)))
