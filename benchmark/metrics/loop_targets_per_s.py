"""Targets completed over all the time of the window's passes (host clock,
each pass between two device synchronisations)."""


def read(run):
    seconds = sum(p["seconds"] for p in run.passes)
    return sum(p["targets"] for p in run.passes) / seconds if seconds > 0 else None
