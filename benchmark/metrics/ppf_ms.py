"""The mean of the window's rows' `time_ppf`: the program's host clock
around its synchronous PPF call."""


def read(run):
    t = [r["time_ppf"] for r in run.rows if r.get("time_ppf") is not None]
    return 1e3 * sum(t) / len(t) if t else None
