"""Fused InstanceNorm + LeakyReLU: the port's counterpart of
`passion_tpu/ops/fused_norm.py`, forward and backward.

`instance_norm_lrelu(x)` is `leaky_relu(instance_norm(x), 0.2)` with torch
InstanceNorm3d semantics: biased variance, float32 statistics, output in
the input dtype. It runs at every conv unit of mmFormer (about 20 sites per
forward, 53 per training step), so on the card it is a hand-written CUDA
kernel pair each way (`csrc/fused_norm.cu`, `csrc/fused_norm_bwd.cu`):

  * K1 `norm_stats`      replaces `_stats_kernel` + the host glue of
    `_pallas_norm_lrelu`: one read of x -> per-(batch, channel group)
    float32 (mean, rsqrt(var + eps));
  * K2 `norm_apply`      replaces `_apply_kernel`: one read and one write,
    y = (x - mean) * inv, LeakyReLU, cast to x's dtype;
  * K3 `norm_bwd_stats`  the gradient's row reductions, which the JAX
    package leaves to autodiff of `_inl_jnp` (ops/norm.py:55-66 writes them
    out): one read of x and g -> per-row float32 (mean(g'), mean(g' x^));
  * K4 `norm_bwd_apply`  one read of x and g and one write:
    dx = inv (g' - mean(g') - x^ mean(g' x^)) in x's dtype.

All four are memory-bound; the notes at the top of the CUDA sources say why
and what the design does about it. Under autograd `instance_norm_lrelu`
is a `torch.autograd.Function` that saves x and the (rows, 2) statistics,
never y, and recomputes x^ in the backward.

Tensors are (B, C, spatial...) and contiguous. `phase_group=g` pools the
statistics over groups of g adjacent channels (the JAX package's
space-to-depth contract, tests/test_ops.py). A wrapper given a CPU tensor
takes the plain PyTorch version below (which follows `_inl_jnp` and its
autodiff); given a CUDA tensor it launches its kernel or raises. Each
wrapper counts its launches in `.launches`. While a byte counter
(`roofline.ByteCounter`) is active, each wrapper hands it its kernel's
bytes (inputs read once, outputs written once) and runs unseen by it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from passion_tpu_torch.ops import _build

CHUNK = 16384  # elements of one row that one CUDA block streams
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # what the kernels take


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Statistics dtype: float32, or float64 for a float64 input (the plain
    version only, for gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rows(x: torch.Tensor, phase_group: int) -> tuple[int, int]:
    """(rows, n): statistics groups and elements per group, after checking
    what the kernels take (and float64, which only the plain version
    takes)."""
    if x.dim() < 3:
        raise ValueError(f"expected (B, C, spatial...), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE and x.dtype != torch.float64:
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


def _check_stats(name: str, stats: torch.Tensor, x: torch.Tensor,
                 rows: int) -> None:
    if stats.shape != (rows, 2) or stats.dtype != _acc(x.dtype):
        raise ValueError(f"{name} must be ({rows}, 2) {_acc(x.dtype)}, got "
                         f"{tuple(stats.shape)} {stats.dtype}")
    if stats.device != x.device or not stats.is_contiguous():
        raise ValueError(f"{name} must be contiguous and on x's device")


def _check_grad(g: torch.Tensor, x: torch.Tensor) -> None:
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise TypeError(f"gradient {tuple(g.shape)} {g.dtype} {g.device} "
                        f"does not match x {tuple(x.shape)} {x.dtype} "
                        f"{x.device}")
    if not g.is_contiguous():
        raise ValueError("the gradient must be contiguous")


def _kernel_dtype(x: torch.Tensor) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{x.dtype}")
    return _DTYPE_CODE[x.dtype]


def _vectorized(x: torch.Tensor, n: int, *others: torch.Tensor) -> int:
    return int(n % 8 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x,) + others))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _stats_bytes(x: torch.Tensor, rows: int) -> int:
    """Bytes of one (rows, 2) statistics tensor of x."""
    return 2 * rows * _acc(x.dtype).itemsize


# the active `roofline.ByteCounter`, which the wrappers hand their bytes to
byte_counter = None


# --- plain PyTorch version (CPU path, and the reference on the card) ------

def norm_stats_plain(x: torch.Tensor, eps: float = 1e-5,
                     phase_group: int = 1) -> torch.Tensor:
    """(rows, 2) float32 [mean, rsqrt(var + eps)] per (batch, group)."""
    rows, n = _rows(x, phase_group)
    xf = x.reshape(rows, n).to(_acc(x.dtype))
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    return torch.cat([mean, torch.rsqrt(var + eps)], dim=1)


def norm_apply_plain(x: torch.Tensor, stats: torch.Tensor,
                     negative_slope: float = 0.2,
                     phase_group: int = 1) -> torch.Tensor:
    """As `_inl_jnp`: normalize in float32, cast to x's dtype, then
    LeakyReLU in that dtype."""
    rows, n = _rows(x, phase_group)
    xf = x.reshape(rows, n).to(_acc(x.dtype))
    y = ((xf - stats[:, :1]) * stats[:, 1:]).to(x.dtype)
    return F.leaky_relu(y, negative_slope).reshape(x.shape)


def instance_norm_lrelu_plain(x: torch.Tensor, eps: float = 1e-5,
                              negative_slope: float = 0.2,
                              phase_group: int = 1) -> torch.Tensor:
    return norm_apply_plain(x, norm_stats_plain(x, eps, phase_group),
                            negative_slope, phase_group)


def _xhat_and_slope_grad(x, g, stats, negative_slope, rows, n):
    """(rows, n) x^ = (x - mean) * inv in the statistics' dtype, and g': g
    where x^ rounded to x's dtype is >= 0, else g * slope computed in x's
    dtype (as jnp differentiates `leaky_relu` of `_inl_jnp`'s output)."""
    xh = (x.reshape(rows, n).to(stats.dtype) - stats[:, :1]) * stats[:, 1:]
    g = g.reshape(rows, n)
    slope = torch.tensor(negative_slope, dtype=x.dtype, device=x.device)
    gp = torch.where(xh.to(x.dtype) >= 0, g, g * slope)
    return xh, gp.to(stats.dtype)


def norm_bwd_stats_plain(x: torch.Tensor, g: torch.Tensor,
                         stats: torch.Tensor, negative_slope: float = 0.2,
                         phase_group: int = 1) -> torch.Tensor:
    """(rows, 2) float32 [mean(g'), mean(g' x^)] per (batch, group)."""
    rows, n = _rows(x, phase_group)
    xh, gp = _xhat_and_slope_grad(x, g, stats, negative_slope, rows, n)
    return torch.stack([gp.mean(dim=1), (gp * xh).mean(dim=1)], dim=1)


def norm_bwd_apply_plain(x: torch.Tensor, g: torch.Tensor,
                         stats: torch.Tensor, bstats: torch.Tensor,
                         negative_slope: float = 0.2,
                         phase_group: int = 1) -> torch.Tensor:
    """dx = inv (g' - mean(g') - x^ mean(g' x^)) in x's dtype."""
    rows, n = _rows(x, phase_group)
    xh, gp = _xhat_and_slope_grad(x, g, stats, negative_slope, rows, n)
    dx = stats[:, 1:] * (gp - bstats[:, :1] - xh * bstats[:, 1:])
    return dx.to(x.dtype).reshape(x.shape)


# --- wrappers: plain version on the CPU, kernel on the card ---------------

def norm_stats(x: torch.Tensor, eps: float = 1e-5,
               phase_group: int = 1) -> torch.Tensor:
    """K1: (rows, 2) float32 [mean, inv] per (batch, channel group)."""
    rows, n = _rows(x, phase_group)
    if byte_counter is not None:  # x read, the statistics written
        return byte_counter.hand_kernel(
            "K1 norm_stats", x.nbytes + _stats_bytes(x, rows), norm_stats, x,
            eps, phase_group)
    if x.device.type == "cpu":
        return norm_stats_plain(x, eps, phase_group)
    code = _kernel_dtype(x)
    lib = _build.load()
    splits = -(-n // CHUNK)
    part = torch.empty((rows * splits, 2), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pt_inl_stats(code, x.data_ptr(), rows, n, CHUNK,
                               _vectorized(x, n), float(eps),
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
    _check_stats("stats", stats, x, rows)
    if byte_counter is not None:  # x and the statistics read, y written
        return byte_counter.hand_kernel(
            "K2 norm_apply", 2 * x.nbytes + _stats_bytes(x, rows), norm_apply,
            x, stats, negative_slope, phase_group)
    if x.device.type == "cpu":
        return norm_apply_plain(x, stats, negative_slope, phase_group)
    code = _kernel_dtype(x)
    lib = _build.load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pt_inl_apply(code, x.data_ptr(), stats.data_ptr(),
                               y.data_ptr(), rows, n, CHUNK,
                               _vectorized(x, n, y), float(negative_slope),
                               _stream(x))
    if err:
        raise RuntimeError(f"K2 (norm apply) launch failed: CUDA error {err} "
                           f"for {tuple(x.shape)} {x.dtype}")
    norm_apply.launches += 1
    return y


def norm_bwd_stats(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                   negative_slope: float = 0.2,
                   phase_group: int = 1) -> torch.Tensor:
    """K3: (rows, 2) float32 [mean(g'), mean(g' x^)] per (batch, group);
    g is the gradient of the forward's output, contiguous, in x's dtype."""
    rows, n = _rows(x, phase_group)
    _check_grad(g, x)
    _check_stats("stats", stats, x, rows)
    if byte_counter is not None:  # x, g, stats read, the row sums written
        return byte_counter.hand_kernel(
            "K3 norm_bwd_stats", 2 * x.nbytes + 2 * _stats_bytes(x, rows),
            norm_bwd_stats, x, g, stats, negative_slope, phase_group)
    if x.device.type == "cpu":
        return norm_bwd_stats_plain(x, g, stats, negative_slope, phase_group)
    code = _kernel_dtype(x)
    lib = _build.load()
    splits = -(-n // CHUNK)
    part = torch.empty((rows * splits, 2), dtype=torch.float32,
                       device=x.device)
    bstats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pt_inl_bwd_stats(code, x.data_ptr(), g.data_ptr(),
                                   stats.data_ptr(), rows, n, CHUNK,
                                   _vectorized(x, n, g),
                                   float(negative_slope), part.data_ptr(),
                                   bstats.data_ptr(), _stream(x))
    if err:
        raise RuntimeError(f"K3 (norm backward stats) launch failed: CUDA "
                           f"error {err} for {tuple(x.shape)} {x.dtype}")
    norm_bwd_stats.launches += 1
    return bstats


def norm_bwd_apply(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                   bstats: torch.Tensor, negative_slope: float = 0.2,
                   phase_group: int = 1) -> torch.Tensor:
    """K4: dx = inv (g' - mean(g') - x^ mean(g' x^)) in x's dtype."""
    rows, n = _rows(x, phase_group)
    _check_grad(g, x)
    _check_stats("stats", stats, x, rows)
    _check_stats("bstats", bstats, x, rows)
    if byte_counter is not None:  # x, g, stats, row sums read, dx written
        return byte_counter.hand_kernel(
            "K4 norm_bwd_apply", 3 * x.nbytes + 2 * _stats_bytes(x, rows),
            norm_bwd_apply, x, g, stats, bstats, negative_slope, phase_group)
    if x.device.type == "cpu":
        return norm_bwd_apply_plain(x, g, stats, bstats, negative_slope,
                                    phase_group)
    code = _kernel_dtype(x)
    lib = _build.load()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pt_inl_bwd_apply(code, x.data_ptr(), g.data_ptr(),
                                   stats.data_ptr(), bstats.data_ptr(),
                                   dx.data_ptr(), rows, n, CHUNK,
                                   _vectorized(x, n, g, dx),
                                   float(negative_slope), _stream(x))
    if err:
        raise RuntimeError(f"K4 (norm backward apply) launch failed: CUDA "
                           f"error {err} for {tuple(x.shape)} {x.dtype}")
    norm_bwd_apply.launches += 1
    return dx


norm_stats.launches = 0
norm_apply.launches = 0
norm_bwd_stats.launches = 0
norm_bwd_apply.launches = 0
WRAPPERS = (norm_stats, norm_apply, norm_bwd_stats, norm_bwd_apply)


class InstanceNormLReLU(torch.autograd.Function):
    """K1 + K2 forward, K3 + K4 backward. Saves x and the (rows, 2)
    statistics, never y; the backward recomputes x^ from them."""

    @staticmethod
    def forward(ctx, x, eps, negative_slope, phase_group):
        stats = norm_stats(x, eps, phase_group)
        ctx.save_for_backward(x, stats)
        ctx.negative_slope, ctx.phase_group = negative_slope, phase_group
        return norm_apply(x, stats, negative_slope, phase_group)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        if g.dtype != x.dtype:
            raise TypeError(f"gradient dtype {g.dtype} differs from the "
                            f"input's {x.dtype}")
        g = g.contiguous()  # cuDNN's conv backward may hand a strided one
        b = norm_bwd_stats(x, g, stats, ctx.negative_slope, ctx.phase_group)
        dx = norm_bwd_apply(x, g, stats, b, ctx.negative_slope,
                            ctx.phase_group)
        return dx, None, None, None


def instance_norm_lrelu(x: torch.Tensor, eps: float = 1e-5,
                        negative_slope: float = 0.2,
                        phase_group: int = 1) -> torch.Tensor:
    """Fused `leaky_relu(instance_norm(x))` over (B, C, spatial...);
    differentiable through K3 + K4 when x requires a gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormLReLU.apply(x, eps, negative_slope, phase_group)
    return norm_apply(x, norm_stats(x, eps, phase_group), negative_slope,
                      phase_group)
