"""Exact squared Euclidean distance to a region's border (K5): the distance
transform of HD95, on the card.

`edt_sq(labels, classes)` takes a batch of uint8 label volumes (N, H, W, Z)
and a class set (WT (1, 2, 3), TC (1, 3), ET (3,)) and returns int32
(N, H, W, Z): for every voxel the squared distance to the nearest voxel of
the region's border, where the border is the region less its 6-neighbour
erosion with voxels outside the volume counted as background (what
`metrics._surface_distances` takes from `ndimage.binary_erosion`). A
volume whose region is empty has no border and gets `INF` everywhere. So
`edt_sq(labels, classes)[k] == ndimage.distance_transform_edt(~border_k)
** 2` exactly, and a voxel is a border voxel exactly where its value is 0.

On the card it is one hand-written CUDA kernel in three launches
(`csrc/edt.cu`, whose note says what bounds it); it is not the port of a
TPU kernel but takes the place of the host's scipy transform in the
15-mask evaluation (`metrics.score_masks`). Given a CPU tensor the wrapper
takes the plain PyTorch version below, an exact min-plus over each line;
given a CUDA tensor it launches the kernel or raises. `edt_sq.launches`
counts the kernel's launches (one per call).
"""

from __future__ import annotations

import torch

from passion_tpu_torch.ops import _build

INF = 2 ** 31 - 1  # the distance where a volume has no border voxel
MAX_Z = 1024  # the kernel's first pass runs one thread per voxel of a Z line
MAX_HW = 10000  # squared distances stay inside int32


def _class_bits(classes) -> int:
    """The kernel's class mask: bit c set for each label c of the region."""
    bits = 0
    for c in classes:
        if not 0 <= int(c) < 32:
            raise ValueError(f"class {c} outside 0..31")
        bits |= 1 << int(c)
    if bits == 0:
        raise ValueError("empty class set")
    return bits


def _check(labels: torch.Tensor) -> None:
    if labels.dim() != 4 or labels.dtype != torch.uint8:
        raise TypeError(f"expected (N, H, W, Z) uint8 labels, got "
                        f"{tuple(labels.shape)} {labels.dtype}")
    if not labels.is_contiguous():
        raise ValueError("edt_sq needs contiguous labels")
    n, h, w, z = labels.shape
    if min(n, h, w, z) < 1:
        raise ValueError(f"empty labels {tuple(labels.shape)}")
    if z > MAX_Z or h > MAX_HW or w > MAX_HW:
        raise ValueError(f"edt_sq takes Z <= {MAX_Z} and H, W <= {MAX_HW}, "
                         f"got {tuple(labels.shape)}")


# --- plain PyTorch version (CPU path, and the reference on the card) ------

def border_plain(labels: torch.Tensor, classes) -> torch.Tensor:
    """(N, H, W, Z) bool: the region's voxels with a 6-neighbour outside it
    (outside the volume counts as outside the region)."""
    region = torch.zeros(labels.shape, dtype=torch.bool,
                         device=labels.device)
    for c in classes:
        region |= labels == c
    n, h, w, z = labels.shape
    p = torch.zeros((n, h + 2, w + 2, z + 2), dtype=torch.bool,
                    device=labels.device)
    p[:, 1:-1, 1:-1, 1:-1] = region
    inner = region
    for nb in (p[:, :-2, 1:-1, 1:-1], p[:, 2:, 1:-1, 1:-1],
               p[:, 1:-1, :-2, 1:-1], p[:, 1:-1, 2:, 1:-1],
               p[:, 1:-1, 1:-1, :-2], p[:, 1:-1, 1:-1, 2:]):
        inner = inner & nb
    return region & ~inner


def _min_plus(f: torch.Tensor, axis: int) -> torch.Tensor:
    """min_j (i - j)^2 + f[j] along `axis` of an int64 tensor."""
    m = f.shape[axis]
    shape = [1] * f.dim()
    shape[axis] = m
    pos = torch.arange(m, device=f.device).view(shape)
    out = torch.full_like(f, 2 ** 62)
    for j in range(m):
        out = torch.minimum(out, f.narrow(axis, j, 1) + (pos - j) ** 2)
    return out


def edt_sq_plain(labels: torch.Tensor, classes) -> torch.Tensor:
    """Plain version of K5: the border, then an exact min-plus over every
    line along each axis in int64; `INF` where a volume has no border."""
    _check(labels)
    _class_bits(classes)
    big = 2 ** 40  # beyond any squared distance, and no overflow when added
    f = torch.where(border_plain(labels, classes), 0, big).to(torch.int64)
    for axis in (3, 2, 1):
        f = _min_plus(f, axis)
    return f.clamp_(max=INF).to(torch.int32)


# --- wrapper: plain version on the CPU, kernel on the card ----------------

def edt_sq(labels: torch.Tensor, classes) -> torch.Tensor:
    """K5: (N, H, W, Z) int32 squared distances to the border of the region
    `classes` of each uint8 label volume."""
    _check(labels)
    bits = _class_bits(classes)
    if labels.device.type == "cpu":
        return edt_sq_plain(labels, classes)
    if labels.device.type != "cuda":
        raise ValueError(f"no kernel for device {labels.device}")
    lib = _build.load()
    out = torch.empty(labels.shape, dtype=torch.int32, device=labels.device)
    tmp = torch.empty_like(out)
    n, h, w, z = labels.shape
    with torch.cuda.device(labels.device):
        err = lib.pt_edt_sq(labels.data_ptr(), n, h, w, z, bits,
                            tmp.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream(
                                labels.device).cuda_stream)
    if err:
        raise RuntimeError(f"K5 (distance transform) launch failed: CUDA "
                           f"error {err} for {tuple(labels.shape)}")
    edt_sq.launches += 1
    return out


edt_sq.launches = 0
