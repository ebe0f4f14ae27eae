"""Faults planted under the timed path, for the tests that show the check
fails them (`run.py --fault <name>`; never in a measured run):

  * `frozen_step`: the optimizer's step leaves the weights as they were;
  * `half_batch`: each train step sees half its batch, the loss the mean
    over the rest;
  * `altered_pick`: the scorer hands back the runner-up hypothesis's pose
    as the pick;
  * `altered_detection`: the detector's scores come back raised by 0.01;
  * `skipped_events`: the window's finetune events (a buffer past set-up's
    prefix) return at once, with no step.
"""

from __future__ import annotations

import numpy as np

NAMES = ("frozen_step", "half_batch", "altered_pick", "altered_detection", "skipped_events")


def install(name: str, session) -> None:
    if name not in NAMES:
        raise ValueError(f"unknown fault {name}; known: {', '.join(NAMES)}")
    dtoid, zephyr = session.dtoid, session.zephyr
    if name == "frozen_step":
        dtoid.optimizer.step = lambda closure=None: None
    elif name == "half_batch":
        step = dtoid.train_step_u8

        def half(feed):
            b = len(feed["img_u8"]) // 2
            return step({k: v[:b] for k, v in feed.items()})
        dtoid.train_step_u8 = half
    elif name == "altered_pick":
        fetch = zephyr.fetch_scores

        def runner_up(handle, *a, **k):
            out = fetch(handle, *a, **k)
            scores = np.asarray(out["scores"])
            if len(scores) > 1:
                i = int(np.argsort(scores)[-2])
                refined = out.get("refined")
                out["pred_pose"] = refined[i] if refined is not None and i < len(refined) else handle["poses"][i]
            return out
        zephyr.fetch_scores = runner_up
    elif name == "altered_detection":
        fetch = dtoid.fetch_detections

        def raised(*a, **k):
            out = fetch(*a, **k)
            out["pred_scores"] = out["pred_scores"] + np.float32(0.01)
            out["final_score"] = [out["pred_scores"]]
            return out
        dtoid.fetch_detections = raised
    elif name == "skipped_events":
        from ossid_code_torch.loop import online_learning

        finetune = online_learning.finetune_dtoid
        prefix = int(session.traffic["prefix_targets"])

        def skipped(model, train_dataset, *a, **k):
            if len(train_dataset) > prefix:
                return online_learning.DeferredLogs([[]])
            return finetune(model, train_dataset, *a, **k)
        online_learning.finetune_dtoid = skipped
