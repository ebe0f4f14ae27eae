"""The main thread's own time in the targets' completions in the traced
pass, per target: its `complete` spans less their waits (`*.wait`) and
their `finetune` events (program span log)."""

from benchmark.metrics.host_wait_ms import length_less, main_thread, per_target_ms, union, waits


def read(run):
    spans = main_thread(run)
    if spans is None or "complete" not in spans:
        return None
    return per_target_ms(run, length_less(union(spans["complete"]), union(waits(spans), spans.get("finetune", []))))
