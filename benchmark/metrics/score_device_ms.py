"""Device time launched inside the benchmark's span around
`ZephyrModel.score_hypotheses_async`, per score call, in the traced pass."""


def read(run):
    tr = run.trace
    if tr is None or not run.score_hypos or not tr["span_records"].get("score"):
        return None
    return 1e3 * tr["span_device_s"]["score"] / len(run.score_hypos)
