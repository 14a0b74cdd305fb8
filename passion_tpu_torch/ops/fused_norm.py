"""Fused InstanceNorm + LeakyReLU: the port's counterpart of
`passion_tpu/ops/fused_norm.py`.

`instance_norm_lrelu(x)` is `leaky_relu(instance_norm(x), 0.2)` with torch
InstanceNorm3d semantics: biased variance, float32 statistics, output in
the input dtype. It runs at every conv unit of mmFormer (about 20 sites per
forward), so on the card it is a hand-written CUDA kernel pair
(`csrc/fused_norm.cu`):

  * K1 `norm_stats`  replaces `_stats_kernel` + the host glue of
    `_pallas_norm_lrelu`: one read of x -> per-(batch, channel group)
    float32 (mean, rsqrt(var + eps));
  * K2 `norm_apply`  replaces `_apply_kernel`: one read and one write,
    y = (x - mean) * inv, LeakyReLU, cast to x's dtype.

Both are memory-bound; the note at the top of the CUDA source says why and
what the design does about it.

Tensors are (B, C, spatial...) and contiguous. `phase_group=g` pools the
statistics over groups of g adjacent channels (the JAX package's
space-to-depth contract, tests/test_ops.py). A wrapper given a CPU tensor
takes the plain PyTorch version below (which follows `_inl_jnp`); given a
CUDA tensor it launches its kernel or raises. Each wrapper counts its
launches in `.launches`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from passion_tpu_torch.ops import _build

CHUNK = 16384  # elements of one row that one CUDA block streams
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _rows(x: torch.Tensor, phase_group: int) -> tuple[int, int]:
    """(rows, n): statistics groups and elements per group, after checking
    what the kernels take."""
    if x.dim() < 3:
        raise ValueError(f"expected (B, C, spatial...), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"instance_norm_lrelu takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("instance_norm_lrelu needs a contiguous "
                         "(B, C, spatial...) tensor")
    b, c = x.shape[:2]
    if phase_group < 1 or c % phase_group:
        raise ValueError(f"{c} channels do not split into groups of "
                         f"{phase_group}")
    rows = b * (c // phase_group)
    if rows == 0 or x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    return rows, x.numel() // rows


def _vectorized(x: torch.Tensor, n: int, *others: torch.Tensor) -> int:
    return int(n % 8 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x,) + others))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# --- plain PyTorch version (CPU path, and the reference on the card) ------

def norm_stats_plain(x: torch.Tensor, eps: float = 1e-5,
                     phase_group: int = 1) -> torch.Tensor:
    """(rows, 2) float32 [mean, rsqrt(var + eps)] per (batch, group)."""
    rows, n = _rows(x, phase_group)
    xf = x.reshape(rows, n).float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    return torch.cat([mean, torch.rsqrt(var + eps)], dim=1)


def norm_apply_plain(x: torch.Tensor, stats: torch.Tensor,
                     negative_slope: float = 0.2,
                     phase_group: int = 1) -> torch.Tensor:
    """As `_inl_jnp`: normalize in float32, cast to x's dtype, then
    LeakyReLU in that dtype."""
    rows, n = _rows(x, phase_group)
    xf = x.reshape(rows, n).float()
    y = ((xf - stats[:, :1]) * stats[:, 1:]).to(x.dtype)
    return F.leaky_relu(y, negative_slope).reshape(x.shape)


def instance_norm_lrelu_plain(x: torch.Tensor, eps: float = 1e-5,
                              negative_slope: float = 0.2,
                              phase_group: int = 1) -> torch.Tensor:
    return norm_apply_plain(x, norm_stats_plain(x, eps, phase_group),
                            negative_slope, phase_group)


# --- wrappers: plain version on the CPU, kernel on the card ---------------

def norm_stats(x: torch.Tensor, eps: float = 1e-5,
               phase_group: int = 1) -> torch.Tensor:
    """K1: (rows, 2) float32 [mean, inv] per (batch, channel group)."""
    rows, n = _rows(x, phase_group)
    if x.device.type == "cpu":
        return norm_stats_plain(x, eps, phase_group)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = _build.load()
    splits = -(-n // CHUNK)
    part = torch.empty((rows * splits, 2), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pt_inl_stats(_DTYPE_CODE[x.dtype], x.data_ptr(), rows, n,
                               CHUNK, _vectorized(x, n), float(eps),
                               part.data_ptr(), stats.data_ptr(), _stream(x))
    if err:
        raise RuntimeError(f"K1 (norm stats) launch failed: CUDA error {err} "
                           f"for {tuple(x.shape)} {x.dtype}")
    norm_stats.launches += 1
    return stats


def norm_apply(x: torch.Tensor, stats: torch.Tensor,
               negative_slope: float = 0.2,
               phase_group: int = 1) -> torch.Tensor:
    """K2: LeakyReLU((x - mean) * inv) in x's dtype."""
    rows, n = _rows(x, phase_group)
    if stats.shape != (rows, 2) or stats.dtype != torch.float32:
        raise ValueError(f"stats must be ({rows}, 2) float32, got "
                         f"{tuple(stats.shape)} {stats.dtype}")
    if stats.device != x.device or not stats.is_contiguous():
        raise ValueError("stats must be contiguous and on x's device")
    if x.device.type == "cpu":
        return norm_apply_plain(x, stats, negative_slope, phase_group)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = _build.load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pt_inl_apply(_DTYPE_CODE[x.dtype], x.data_ptr(),
                               stats.data_ptr(), y.data_ptr(), rows, n,
                               CHUNK, _vectorized(x, n, y),
                               float(negative_slope), _stream(x))
    if err:
        raise RuntimeError(f"K2 (norm apply) launch failed: CUDA error {err} "
                           f"for {tuple(x.shape)} {x.dtype}")
    norm_apply.launches += 1
    return y


norm_stats.launches = 0
norm_apply.launches = 0


def instance_norm_lrelu(x: torch.Tensor, eps: float = 1e-5,
                        negative_slope: float = 0.2,
                        phase_group: int = 1) -> torch.Tensor:
    """Fused `leaky_relu(instance_norm(x))` over (B, C, spatial...)."""
    return norm_apply(x, norm_stats(x, eps, phase_group), negative_slope,
                      phase_group)
