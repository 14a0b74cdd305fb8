"""passion_tpu_torch.ops.fused_norm (K1 stats + K2 apply) against the JAX
package's `instance_norm_lrelu`, run as tests/test_ops.py runs it: the
Pallas kernel pair in interpret mode (with `_MIN_PALLAS_ELEMS` at 0) and
the jnp path. Here, on the CPU, the port's wrapper takes its plain PyTorch
version; tests/test_torch_gpu.py holds the CUDA kernels against it on a
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import passion_tpu.ops.fused_norm as jfn
from passion_tpu_torch.ops import fused_norm as tfn

torch.set_num_threads(2)

# (shape channels-last, dtype, phase_group, atol): test_ops.py's cases and
# tolerances (rtol 1e-2 throughout)
CASES = {
    "narrow_f32": ((2, 8, 8, 8, 64), np.float32, 1, 2e-5),
    "wide_bf16": ((2, 4, 4, 4, 256), jnp.bfloat16, 1, 2e-2),
    "phase_group8_f32": ((2, 8, 8, 8, 64), np.float32, 8, 2e-5),
    "phase_group8_bf16": ((2, 4, 6, 4, 64), jnp.bfloat16, 8, 2e-2),
}


def _inputs(rng, shape, dtype):
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    if dtype == jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    return xj, xt


def _to_channels_last(y: torch.Tensor) -> np.ndarray:
    return y.float().permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "jnp"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax(case, pallas, rng, monkeypatch):
    shape, dtype, pg, atol = CASES[case]
    xj, xt = _inputs(rng, shape, dtype)
    if pallas:
        monkeypatch.setattr(jfn, "_MIN_PALLAS_ELEMS", 0)
        with jfn.enabled():
            ref = jfn.instance_norm_lrelu(xj, phase_group=pg)
    else:
        ref = jfn.instance_norm_lrelu(xj, phase_group=pg)
    got = tfn.instance_norm_lrelu(xt, phase_group=pg)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_to_channels_last(got),
                               np.asarray(ref, np.float32),
                               atol=atol, rtol=1e-2)


def test_stats_match_float64(rng):
    """K1's plain version: mean and rsqrt(var + eps) per (batch, group)."""
    x = rng.standard_normal((2, 16, 5, 6, 7)) * 2 + 3
    st = tfn.norm_stats(torch.from_numpy(x).float(), phase_group=4)
    v = x.reshape(2 * 4, -1)
    np.testing.assert_allclose(st[:, 0].numpy(), v.mean(1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st[:, 1].numpy(), 1 / np.sqrt(v.var(1) + 1e-5),
                               rtol=1e-5)


def test_large_mean_plain_within_fp32_reach(rng):
    """|mean| >> std: the plain float32 version stays within the ~1.4e-4
    that test_ops.py documents for float32 at this scale (the kernel is
    held to 5e-5 against float64 on the card)."""
    x64 = rng.standard_normal((1, 128, 20, 20, 20)) * 0.5 + 50.0
    m = x64.mean(axis=(2, 3, 4), keepdims=True)
    v = ((x64 - m) ** 2).mean(axis=(2, 3, 4), keepdims=True)
    y64 = (x64 - m) / np.sqrt(v + 1e-5)
    y64 = np.where(y64 >= 0, y64, 0.2 * y64)
    got = tfn.instance_norm_lrelu(torch.from_numpy(x64).float()).double()
    np.testing.assert_allclose(got.numpy(), y64, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["non_contiguous", "float16", "2d",
                                 "group_split", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.randn(2, 8, 4, 4, 4)
    kw = {}
    if bad == "non_contiguous":
        x = x.transpose(1, 2)
    elif bad == "float16":
        x = x.half()
    elif bad == "2d":
        x = x.reshape(2, -1)
    elif bad == "group_split":
        kw = {"phase_group": 3}
    elif bad == "meta_device":
        x = x.to("meta")
    with pytest.raises((ValueError, TypeError)):
        tfn.instance_norm_lrelu(x, **kw)


def test_cpu_path_counts_no_launch():
    before = (tfn.norm_stats.launches, tfn.norm_apply.launches)
    tfn.instance_norm_lrelu(torch.randn(1, 4, 3, 3, 3))
    assert (tfn.norm_stats.launches, tfn.norm_apply.launches) == before
