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

On the card it is one hand-written CUDA kernel in two launches
(`csrc/edt.cu`, whose note says what bounds it): pass A finds the border
and the distances along Z and W of one (n, h) plane a block, in shared
memory; pass B runs the envelopes along H in place. It is not the port of
a TPU kernel but takes the place of the host's scipy transform in the
15-mask evaluation (`metrics.score_masks`). Given a CPU tensor the wrapper
takes the plain PyTorch version below, an exact min-plus over each line;
given a CUDA tensor it launches the kernel or raises. `edt_sq.launches`
counts the kernel's launches (one per call).

Limits (`_check`; the wrapper raises `ValueError` beyond them, on any
device): Z, W <= 10000 and H <= 900 (squared distances stay inside int32,
and a block of pass B holds 32 whole H lines); and a W x Z plane whose
pass A fits a block's shared memory (`MAX_SHARED`): 4 W Z + 4 W ceil(Z /
32) + 16 bytes for W <= 256 (the 16-bit Z distances and the envelopes'
two byte indices a voxel, over the three label planes; the border bits;
the mbarrier), 6 W Z + ... above, so W x Z up to 240 x 234 for W <= 256
and 300 x 126 above. A 240x240x155 case takes 153,616 bytes.
`_plan(shape)` gives the launch geometry the C side takes.
"""

from __future__ import annotations

import torch

from passion_tpu_torch.ops import _build

INF = 2 ** 31 - 1  # the distance where a volume has no border voxel
MAX_Z = 10000  # squared distances stay inside int32
MAX_W = 10000  # squared distances stay inside int32
MAX_H = 900  # pass B: 32 lines of H int32 values and 16-bit envelopes
MAX_SHARED = 232_448  # shared memory a block can use on sm_90
LANES = 4  # threads that share one line's envelope, both passes
A_THREADS = 768  # pass A's threads a block, at most
B_LINES = 32  # pass B's lines a block


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


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _plan(shape) -> dict:
    """Launch geometry of the kernel for (N, H, W, Z) labels, as
    `csrc/edt.cu` lays out shared memory (`layout_a`, `layout_b`).

    Pass A: one block per (n, h) plane (`a_blocks`), `a_threads` threads
    (`LANES` a z column in its W envelope), `a_shared` bytes: three label
    slots of W Z + 16 bytes (16-byte aligned) and, over them once the
    border is known, the 16-bit Z distances and the W envelopes' vertices
    and starts (1 byte each a voxel, 2 for W > 256); then the border bits
    (W ceil(Z / 32) words) and the mbarrier. Pass B: `b_lines` H lines of
    `LANES` threads a block (`b_threads`), `b_shared` bytes (an int32
    value and a vertex and a start of 1 byte, or 2 for H > 256, a line and
    value), `b_blocks` blocks. The C side takes `a_threads`, `a_shared`
    and `b_shared`; `b_lines` is its constant `kBLines`."""
    n, h, w, z = (int(v) for v in shape)
    p = w * z
    sw = 1 if w <= 256 else 2
    sh = 1 if h <= 256 else 2
    stack = _round16(p * sw)
    words = w * -(-z // 32)
    a_shared = (max(3 * _round16(p + 16), _round16(2 * p) + 2 * stack)
                + _round16(4 * words) + 16)
    a_threads = min(A_THREADS, max(128, -(-z * LANES // 32) * 32))
    return dict(a_threads=a_threads, a_shared=a_shared, a_blocks=n * h,
                b_lines=B_LINES, b_threads=B_LINES * LANES,
                b_shared=B_LINES * h * (4 + 2 * sh),
                b_blocks=n * -(-p // B_LINES))


def _check(labels: torch.Tensor) -> None:
    if labels.dim() != 4 or labels.dtype != torch.uint8:
        raise TypeError(f"expected (N, H, W, Z) uint8 labels, got "
                        f"{tuple(labels.shape)} {labels.dtype}")
    if not labels.is_contiguous():
        raise ValueError("edt_sq needs contiguous labels")
    n, h, w, z = labels.shape
    if min(n, h, w, z) < 1:
        raise ValueError(f"empty labels {tuple(labels.shape)}")
    if z > MAX_Z or w > MAX_W or h > MAX_H:
        raise ValueError(f"edt_sq takes Z <= {MAX_Z}, W <= {MAX_W} and "
                         f"H <= {MAX_H}, got {tuple(labels.shape)}")
    plan = _plan(labels.shape)
    if plan["a_shared"] > MAX_SHARED or plan["b_shared"] > MAX_SHARED:
        raise ValueError(f"edt_sq's W x Z plane {w} x {z} needs "
                         f"{plan['a_shared']} bytes of shared memory, over "
                         f"the {MAX_SHARED} a block has")


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
    plan = _plan(labels.shape)
    lib = _build.load()
    out = torch.empty(labels.shape, dtype=torch.int32, device=labels.device)
    n, h, w, z = labels.shape
    with torch.cuda.device(labels.device):
        err = lib.pt_edt_sq(labels.data_ptr(), n, h, w, z, bits,
                            plan["a_threads"], plan["a_shared"],
                            plan["b_shared"], out.data_ptr(),
                            torch.cuda.current_stream(
                                labels.device).cuda_stream)
    if err:
        raise RuntimeError(f"K5 (distance transform) launch failed: CUDA "
                           f"error {err} for {tuple(labels.shape)}")
    edt_sq.launches += 1
    return out


edt_sq.launches = 0
