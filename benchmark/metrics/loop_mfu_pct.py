"""The whole loop's share of the card's peak over the traced window: the
model FLOPs of the work it completed (a detection over T templates a
target, the scorer network over the hypotheses each call scored, each
finetune step's forward and backward; counts.py, on the reference's plain
networks) over the window's seconds at 495 TFLOP/s, dense TF32 (float32
convolutions run in TF32 under cuDNN's default). The card's power limit is
printed beside the result (`card`)."""


def read(run):
    tr = run.trace
    if tr is None or not tr["device_records"] or tr["window_s"] <= 0:
        return None
    c, m = run.counts, run.config["model"]
    hw, blocks = (int(m["img_h"]), int(m["img_w"])), tuple(m["densenet_blocks"])
    targets = sum(p["targets"] for p in run.passes)
    flops = targets * c.detect_flops(hw, blocks, int(run.config["dataset"]["n_local_test"]), int(m["template_size"]))
    flops += sum(c.score_flops(int(run.config["scorer"]["num_points"]), n) for n in run.score_hypos)
    if run.steps:
        flops += run.steps * c.step_flops(hw, blocks, int(run.config["loop"]["finetune_batch_size"]),
                                          int(m["template_size"]))
    return 100.0 * flops / (tr["window_s"] * c.PEAKS["tf32_flops"])
