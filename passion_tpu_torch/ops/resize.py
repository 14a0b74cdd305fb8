"""Trilinear and nearest upsampling (counterpart of
`passion_tpu/ops/resize.py:50-83` and `:124-135`).

The JAX trilinear version is plain XLA (per-axis interpolation matrices),
pinned to torch's `align_corners=True` semantics by tests/test_ops.py, so
here it is `F.interpolate` itself. Nearest upsampling by an integer factor
is a repeat along each spatial axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_trilinear(x: torch.Tensor, scale: int,
                       align_corners: bool = True) -> torch.Tensor:
    """Upsample (B, C, H, W, Z) by an integer `scale`; the result is
    contiguous (B, C, H, W, Z)."""
    if scale == 1:
        return x
    # On CUDA an input whose spatial extent is 1^3 is also channels-last,
    # and the output may follow that layout; the model's tensors (and the
    # norm kernels) are contiguous NCDHW.
    return F.interpolate(x, scale_factor=scale, mode="trilinear",
                         align_corners=align_corners).contiguous()


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest upsampling of (B, C, H, W, Z) by an integer `scale`, as
    torch's `nn.Upsample(mode='nearest')`: output voxel d reads input voxel
    floor(d / scale)."""
    if scale == 1:
        return x
    for dim in (2, 3, 4):
        x = x.repeat_interleave(scale, dim=dim)
    return x
