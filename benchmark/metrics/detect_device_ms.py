"""Device time launched inside the benchmark's span around
`DtoidModel.detect_async`, per detection dispatched (redispatches
included), in the traced pass."""


def read(run):
    tr = run.trace
    if tr is None or not run.detects or not tr["span_records"].get("detect"):
        return None
    return 1e3 * tr["span_device_s"]["detect"] / run.detects
