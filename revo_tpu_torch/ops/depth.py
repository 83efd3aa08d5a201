"""Valid-pixel depth downsampling (counterpart of revo_tpu/ops/depth.py).

Each output pixel is the mean of the >0 pixels of its 2x2 source block, 0
when the whole block is invalid (FilterSubsampleWithHoles,
imgpyramidrgbd.h:218-249).  The block sum is taken in the JAX module's
order, row pairs first and then column pairs, ``(a + c) + (b + d)`` (its
``sh @ x @ sw.T`` selector matmuls), so the result is bit-equal.
"""
from __future__ import annotations

import torch


def _pair_sum(x: torch.Tensor) -> torch.Tensor:
    h2, w2 = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    rows = x[..., 0:h2:2, :w2] + x[..., 1:h2:2, :w2]
    return rows[..., :, 0::2] + rows[..., :, 1::2]


def subsample_depth_with_holes(depth: torch.Tensor) -> torch.Tensor:
    """(H, W) float depth -> (H//2, W//2); odd sizes drop the last row/col."""
    valid = depth > 0.0
    total = _pair_sum(torch.where(valid, depth, 0.0))
    count = _pair_sum(valid.to(torch.float32))
    return torch.where(
        count > 0, total / torch.clamp(count, min=1.0), 0.0
    )
