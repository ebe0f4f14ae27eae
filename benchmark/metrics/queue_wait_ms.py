"""The mean `queue` span of the traced pass: from the loop's taking a
target from the stream (into its look-ahead) to the start of the target's
iteration (program span log)."""


def read(run):
    waits = [end - start for name, _, start, end, _ in (run.stats or {}).get("spans") or () if name == "queue"]
    return sum(waits) / len(waits) / 1e6 if waits else None
