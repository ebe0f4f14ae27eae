"""The port's pipelined online loop against the JAX package's pipelined loop
on the CPU: part (b) of tests/test_torch_pipeline.py, on its world.

Both loops run at the JAX loop's default knobs (the fetch thread, bundles
of 2, merged completion fetches, shared frame uploads) with the bench's
transport flags (YUV 4:2:0 frames, a 96-px depth crop), from the same DTOID
and scorer weights. Held: test_loop_matches_jax_sync_path's criteria on the
rows, the same STATS counts (the speculation's outcomes and the fetches by
kind) and the same finetune logs (losses 1e-4 relative in the first event,
3e-3 after a step, as tests/test_torch_maskrcnn_train.py holds them).
Beside it: every weight change bumps weights_version, which the
speculation's staleness check reads.
"""

import numpy as np

from test_torch_loop import _configure, _run_jax, _run_port, assert_rows_match_jax, jax_native_libraries, world  # noqa: F401
from test_torch_pipeline import ENV, FLAGS, make_args


def test_pipelined_loop_matches_jax_pipelined(world, monkeypatch):
    """The pipelined loops of both packages at the default knobs with the
    YUV transport and a 96-px depth crop."""
    from ossid_code_tpu.utils.rpc_stats import STATS as JSTATS

    from ossid_code_torch.utils.rpc_stats import STATS

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    args = make_args(**FLAGS["yuv"])
    JSTATS.reset()
    want, weights, jloop = _run_jax(world, args, pipeline_scoring=True)
    jstats = JSTATS.snapshot()
    STATS.reset()
    got, loop = _run_port(world, args, weights)
    stats = STATS.snapshot()
    assert loop.pipeline_scoring and loop._spec_fetch_thread and loop._fetch_bundle == 2
    assert_rows_match_jax(got, want, loop)
    # the port counts spec_redispatch beside the JAX package's kinds
    redispatched = stats["counts"].pop("spec_redispatch", 0)
    assert stats["counts"] == jstats["counts"]
    assert stats["counts"].get("spec_stale", 0) + redispatched >= 1
    assert {k: n for k, (n, _) in stats["rpcs"].items()} == {k: n for k, (n, _) in jstats["rpcs"].items()}
    logs = [[[[s["train_loss"] for s in ep] for ep in event] for event in run]
            for run in (loop.finetune_logs, jloop.finetune_logs)]
    assert len(logs[0]) == 2 and [[len(ep) for ep in ev] for ev in logs[0]] == [[len(ep) for ep in ev]
                                                                                for ev in logs[1]]
    np.testing.assert_allclose(logs[0][0], logs[1][0], rtol=1e-4)
    for got_ev, want_ev in zip(logs[0][1:], logs[1][1:]):
        np.testing.assert_allclose(got_ev, want_ev, rtol=3e-3)


def test_every_weight_change_bumps_weights_version(world):
    """The speculation's staleness check reads weights_version: train_step,
    train_step_u8, the bf16 step and load_state_dict each bump it."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel

    cfg = _configure(default_config(), world)
    cfg.model.heatmap_h, cfg.model.heatmap_w = 7, 9
    rng = np.random.default_rng(0)
    b = 2
    ann = np.full((b, 1, 5), -1.0, np.float32)
    ann[:, 0] = [20, 20, 80, 90, 1]
    u8 = {"img_u8": rng.integers(0, 256, (b, 128, 160, 3), np.uint8),
          "mask_bits": np.packbits(rng.uniform(size=(b, 128 * 160)) > 0.8, axis=1, bitorder="little"),
          "limg_u8": rng.integers(0, 256, (b, 124, 124, 3), np.uint8),
          "lmask_u8": (rng.uniform(size=(b, 124, 124, 1)) > 0.4).astype(np.uint8),
          "gimg_u8": rng.integers(0, 256, (b, 124, 124, 3), np.uint8),
          "gmask_u8": (rng.uniform(size=(b, 124, 124, 1)) > 0.4).astype(np.uint8),
          "bbox_gt": ann, "heatmap": rng.uniform(size=(b, 7, 9, 1)).astype(np.float32)}
    for bf16 in (False, True):
        m = DtoidModel(cfg.merged({"model": {"bf16_finetune": bf16}}), seed=0, device="cpu")
        v = m.weights_version
        m.train_step_u8(u8)
        assert m.weights_version == v + 1
        m.load_state_dict(m.state_dict())
        assert m.weights_version == v + 2
    m = DtoidModel(cfg, seed=0, device="cpu")
    feed = {"img": u8["img_u8"] / 255.0, "limg": u8["limg_u8"] / 255.0, "lmask": u8["lmask_u8"] * 1.0,
            "gimg": u8["gimg_u8"] / 255.0, "gmask": u8["gmask_u8"] * 1.0, "bbox_gt": ann,
            "heatmap": u8["heatmap"], "mask": np.zeros((b, 128, 160, 1), np.float32)}
    m.train_step({k: np.asarray(x, np.float32) for k, x in feed.items()})
    assert m.weights_version == 1
