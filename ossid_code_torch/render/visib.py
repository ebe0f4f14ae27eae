"""Visible-mask estimation, matching bop_toolkit's semantics exactly.

The online loop turns a rendered depth of the predicted pose into a
pseudo-label mask for DTOID finetuning via
`bop_toolkit_lib.visibility.estimate_visib_mask_gt(depth, pred_depth, 15mm)`
(ref scripts/online_learning.py:500), and the VSD evaluator (eval/bop_ar.py)
needs the same gt/est masks bop_toolkit computes. The port's copy of
ossid_code_tpu/render/visib.py.

bop19 mode (the default everywhere in BOP19+ evals): a rendered pixel is
visible iff the rendered surface is not behind the observed surface by more
than `delta` OR the test depth is missing there (sensor holes count as
visible). bop18 additionally required valid test depth.
"""

from __future__ import annotations

import numpy as np


def _estimate_visib_mask(
    d_test: np.ndarray, d_model: np.ndarray, delta: float, visib_mode: str = "bop19"
) -> np.ndarray:
    d_diff = d_model.astype(np.float32) - d_test.astype(np.float32)
    if visib_mode == "bop19":
        return ((d_diff <= delta) | (d_test == 0)) & (d_model > 0)
    if visib_mode == "bop18":
        return (d_test > 0) & (d_model > 0) & (d_diff <= delta)
    raise ValueError(f"unknown visib_mode {visib_mode}")


def estimate_visib_mask(
    d_test: np.ndarray, d_model: np.ndarray, delta: float, visib_mode: str = "bop19"
) -> np.ndarray:
    return _estimate_visib_mask(d_test, d_model, delta, visib_mode)


def estimate_visib_mask_gt(
    d_test: np.ndarray, d_gt: np.ndarray, delta: float, visib_mode: str = "bop19"
) -> np.ndarray:
    return _estimate_visib_mask(d_test, d_gt, delta, visib_mode)



def estimate_visib_mask_est(
    d_test: np.ndarray,
    d_est: np.ndarray,
    visib_gt: np.ndarray,
    delta: float,
    visib_mode: str = "bop19",
) -> np.ndarray:
    """Estimated-pose visibility: the plain visibility mask, plus every
    estimated-surface pixel that the GT sees (bop_toolkit
    visibility.estimate_visib_mask_est)."""
    visib_est = _estimate_visib_mask(d_test, d_est, delta, visib_mode)
    return visib_est | (visib_gt & (d_est > 0))
