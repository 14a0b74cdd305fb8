"""Reflect padding of the three spatial axes, in front of every
reflect-padded k=3 conv of the three backbones.

`reflect_pad3d(x, pad)` pads a (N, C, D, H, W) tensor by `pad` on each side
of D, H and W with numpy/jnp "reflect" indices (the JAX package's
`jnp.pad(mode="reflect")`, passion_tpu/models/layers.py:178-182), for any
sizes: torch's reflect mode needs pad < size, and where an axis is shorter
(the 1-voxel bottleneck of a 16-voxel patch) the plain version takes
numpy's indices instead. On the card it is K6 (`csrc/reflect_pad.cu`), the
port's own kernel: a copy at the card's memory rate where
`F.pad(mode="reflect")` moved its bytes at about a tenth of it. The kernel
reads numpy's periodic reflect index, which `reflect_index` transcribes.

A wrapper given a CPU tensor takes the plain PyTorch version below; given a
CUDA tensor it launches K6 or raises. K6 reads a contiguous tensor, so the
wrapper copies a view first (M2FTrans's fusion tokens reach a pad as a
channels-last view at the bottleneck; the models hand it their layouts as
they are, because a layout changes the convs' float32 rounding). Under
autograd (grad enabled and x requiring a gradient) it takes the plain
version on either device, so the train step keeps autograd's own pad
backward. It counts its launches in `.launches`. While a byte counter
(`roofline.ByteCounter`) is active, it hands it K6's bytes (x read once, y
written once, and a view's copy: x read and written once more) and runs
unseen by it, on the CPU as on the card, so a count depends on shapes,
dtypes and layouts alone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from passion_tpu_torch.ops import _build

# the dtypes K6 takes, by their code in `pt_reflect_pad3d` (raw 2-, 4- and
# 8-byte words)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
MAX_PLANE = 2 ** 31 - 1  # output elements of one padded plane K6 indexes

# the active `roofline.ByteCounter`, which the wrapper hands its bytes to
byte_counter = None


def reflect_index(i: int, n: int) -> int:
    """numpy's "reflect" index of coordinate i (any integer) on an axis of
    n voxels, as K6 computes it: 0 when n == 1, else periodic with period
    2(n - 1), mirrored about n - 1."""
    if n == 1:
        return 0
    m = 2 * (n - 1)
    j = abs(i)
    if j >= m:
        j %= m
    return m - j if j >= n else j


def _padded(x: torch.Tensor, pad: int) -> tuple[int, ...]:
    """y's shape, after checking what the wrapper takes."""
    if x.dim() != 5:
        raise ValueError(f"expected (N, C, D, H, W), got {tuple(x.shape)}")
    if not isinstance(pad, int) or pad < 0:
        raise ValueError(f"pad must be a non-negative int, got {pad!r}")
    if min(x.shape[2:]) < 1:
        raise ValueError(f"empty spatial axis in {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"reflect_pad3d takes float32, bfloat16 or float64, "
                        f"got {x.dtype}")
    return tuple(x.shape[:2]) + tuple(s + 2 * pad for s in x.shape[2:])


def reflect_pad3d_plain(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy/jnp "reflect" padding of the three spatial axes: F.pad where
    torch's reflect mode takes the sizes, numpy's indices where an axis is
    too short for it."""
    if min(x.shape[2:]) > pad:
        return F.pad(x, (pad,) * 6, mode="reflect")
    for dim in (2, 3, 4):
        idx = np.pad(np.arange(x.shape[dim]), pad, mode="reflect")
        x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


def reflect_pad3d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """K6: x padded by `pad` on each side of its three spatial axes."""
    if torch.is_grad_enabled() and x.requires_grad:
        return reflect_pad3d_plain(x, pad)
    shape = _padded(x, pad)
    if byte_counter is not None:  # x read, y written (and a view's copy)
        copy = 0 if x.is_contiguous() else 2 * x.nbytes
        return byte_counter.hand_kernel(
            "K6 reflect_pad3d",
            copy + x.nbytes + int(np.prod(shape)) * x.itemsize,
            reflect_pad3d, x, pad)
    if x.device.type == "cpu":
        return reflect_pad3d_plain(x, pad)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if int(np.prod(shape[2:])) > MAX_PLANE:
        raise ValueError(f"a padded plane of {shape[2:]} exceeds K6's "
                         f"{MAX_PLANE} elements")
    x = x.contiguous()  # K6 reads (N, C, D, H, W) rows; a view is copied
    n, c, d, h, w = x.shape
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.pt_reflect_pad3d(
            _DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(), n * c, d, h, w,
            pad, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"K6 (reflect pad) launch failed: CUDA error "
                           f"{err} for {tuple(x.shape)} {x.dtype} pad {pad}")
    reflect_pad3d.launches += 1
    return y


reflect_pad3d.launches = 0
