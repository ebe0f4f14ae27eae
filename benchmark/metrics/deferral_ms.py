"""The `deferred` spans of the traced pass over all its targets: the time
from the end of a target's dispatch half to the start of its completion,
for the targets whose completion waited past later dispatches, and 0 for
those completed at once (program span log)."""


def read(run):
    spans = (run.stats or {}).get("spans") or ()
    targets = sum(p["targets"] for p in run.passes)
    if not targets or not any(name == "iteration" for name, *_ in spans):
        return None
    return sum(end - start for name, _, start, end, _ in spans if name == "deferred") / 1e6 / targets
