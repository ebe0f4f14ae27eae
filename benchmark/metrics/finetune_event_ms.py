"""The mean `time_finetune` of the traced pass's finetune rows: on the card
the device time from an event recorded before the finetune's first step to
one recorded after its last. Read only where the program logs its
`finetune` spans, which marks a program whose rows carry that clock."""


def read(run):
    spans = (run.stats or {}).get("spans") or ()
    events = [r["time_finetune"] for r in run.rows if r.get("finetune")]
    if not events or not any(name == "finetune" for name, *_ in spans):
        return None
    return 1e3 * sum(events) / len(events)
