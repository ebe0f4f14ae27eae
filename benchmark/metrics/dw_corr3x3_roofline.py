"""Kernel 1's share of its roofline in the traced pass: the least time its
calls' distinct bytes and operations need at the card's peaks (counts.py,
from each call's shapes), over the device time of its records."""


def read(run):
    tr, calls = run.trace, run.kernel_calls
    if tr is None or calls is None or not calls.dw or tr["kernel_device_s"]["dw_corr3x3"] <= 0:
        return None
    bound = sum(run.counts.dw_corr3x3_bound_s(xs, xst, ks, kst, elt) for xs, xst, ks, kst, elt, _ in calls.dw)
    return 100.0 * bound / tr["kernel_device_s"]["dw_corr3x3"]
