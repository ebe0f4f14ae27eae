"""Device-resident finetune replay buffer (the port's copy of
ossid_code_tpu/loop/replay.py).

When the finetune gate opens, the frame is already on the card: detection
uploaded it as uint8 RGB. The buffer keeps that device tensor, pairs it with
the pseudo-label mask packed to bits on the host (H*W/8 bytes, about 38 KB
at 480x640), and the finetune pass trains straight from device memory via
`DtoidModel.train_step_u8`. Frames that miss the buffer (capacity) ship as
uint8 from the host. The replay feed is the host path's `process_data`
output exactly (u8 / 255 at native resolution), so losses and updates match
the float feed (tests/test_torch_train.py).
"""

from __future__ import annotations

import numpy as np


class DeviceReplayBuffer:
    """Maps (obj_id, scene_id, im_id) -> (frame_dev, mask_bits_dev, mat_gt).

    frame_dev: (1, H, W, 3) uint8 tensor on the card (the detection-time
    upload), or None when only metadata was recorded. mask_bits:
    (1, H*W//8) uint8 HOST array, little-endian bit-packed pseudo-label mask
    (uploaded once per batch at finetune time, unpacked on the device by
    `train_step_u8`). mat_gt: host 4x4, needed for the nearest-rotation
    local-template draw at finetune time."""

    def __init__(self, max_frames: int = 192):
        # 192 full-res uint8 frames = 177 MB of device memory; beyond it
        # new frames ship u8 from the host at finetune time
        self.max_frames = int(max_frames)
        self.entries: dict = {}
        # observability: finetune events served from the buffer (bench/tests)
        self.n_replay_events = 0

    def __len__(self):
        return len(self.entries)

    def add(self, key, frame_dev, mask: np.ndarray, mat_gt: np.ndarray) -> bool:
        """Insert/refresh one gated frame. `mask` is the (H, W) bool/float
        pseudo-label at frame resolution. When the buffer is full (or the
        detection upload was not shareable) only metadata+bits are stored and
        the finetune pass ships that frame u8 from the host.

        Runs on the per-frame path and does no device work: the bits stay
        on the host and ship with their batch at finetune time."""
        key = tuple(int(k) for k in key)
        if frame_dev is not None and (
            key in self.entries or len(self.entries) < self.max_frames
        ):
            frame = frame_dev
        else:
            frame = None
        m = np.asarray(mask)
        bits = np.packbits((m.reshape(-1) > 0), bitorder="little")[None]
        self.entries[key] = (frame, bits, np.asarray(mat_gt))
        return frame is not None

    def __contains__(self, key):
        return tuple(int(k) for k in key) in self.entries

    def covers(self, targets) -> bool:
        """True iff every target dict has a replay entry (frame or metadata)."""
        return all(
            (int(t["obj_id"]), int(t["scene_id"]), int(t["im_id"])) in self.entries
            for t in targets
        )

    def frame(self, key):
        """Device frame for key, or None (caller ships u8 from host)."""
        return self.entries[tuple(int(k) for k in key)][0]

    def bits(self, key):
        """(1, H*W//8) uint8 host array of packed pseudo-label bits."""
        return self.entries[tuple(int(k) for k in key)][1]

    def mat_gt(self, key):
        return self.entries[tuple(int(k) for k in key)][2]

    def clear(self):
        self.entries.clear()
