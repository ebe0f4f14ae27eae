"""Kernels, copies and memsets in the traced pass, over the targets it
completed."""


def read(run):
    tr = run.trace
    targets = sum(p["targets"] for p in run.passes)
    if tr is None or not tr["device_records"] or not targets:
        return None
    return tr["device_records"] / targets
