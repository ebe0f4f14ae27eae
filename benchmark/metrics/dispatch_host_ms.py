"""The main thread's own time in each target's dispatch half in the traced
pass, per target: its `iteration` spans less the completions they run and
the waits (`*.wait`) in them (program span log)."""

from benchmark.metrics.host_wait_ms import length_less, main_thread, per_target_ms, union, waits


def read(run):
    spans = main_thread(run)
    if spans is None:
        return None
    return per_target_ms(run, length_less(union(spans["iteration"]), union(spans.get("complete", []),
                                                                             waits(spans))))
