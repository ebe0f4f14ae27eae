"""The pipelined schedule's speculation hit rate over the traced window:
detections dispatched ahead that were still valid when their target came
(the program's counters, utils/rpc_stats.STATS)."""


def read(run):
    return None if run.spec_hit_rate is None else 100.0 * run.spec_hit_rate
