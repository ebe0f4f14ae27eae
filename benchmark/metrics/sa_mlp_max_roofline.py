"""Kernel 2's share of its roofline in the traced pass: each call's three
layers over the hypotheses its score call scored (not the padded bucket) at
the TF32 tensor-core peak, or its bytes, whichever needs longer
(counts.py), over the device time of its records. Each score call makes two
calls (SA1, SA2), in order."""


def read(run):
    tr, calls = run.trace, run.kernel_calls
    if tr is None or calls is None or not calls.sa or tr["kernel_device_s"]["sa_mlp_max"] <= 0:
        return None
    if len(calls.sa) != 2 * len(run.score_hypos):
        return None
    bound = 0.0
    for i, c in enumerate(calls.sa):
        m = run.score_hypos[i // 2]
        rows = c["n"] * (3 + c["cf"]) * c["elt"] + c["s"] * c["dims"][-1] * 4
        nbytes = m * rows + 4 * c["s"] * (1 + c["k"]) + c["w_bytes"]
        bound += run.counts.sa_mlp_max_bound_s(m, c["s"], c["k"], c["dims"], nbytes)
    return 100.0 * bound / tr["kernel_device_s"]["sa_mlp_max"]
