"""Device time launched inside the benchmark's span around
`DtoidModel.train_step_u8`, per finetune step, in the traced pass."""


def read(run):
    tr = run.trace
    if tr is None or not run.steps or not tr["span_records"].get("step"):
        return None
    return 1e3 * tr["span_device_s"]["step"] / run.steps
