"""The mean `finetune.feed` span of the traced pass: the host's time to
gather one train step's feed (the replay annotations, the stacked frames
and labels), per step (program span log)."""


def read(run):
    feeds = [end - start for name, _, start, end, _ in (run.stats or {}).get("spans") or () if name == "finetune.feed"]
    return sum(feeds) / len(feeds) / 1e6 if feeds else None
