"""The gradient of passion_tpu_torch.ops.fused_norm.instance_norm_lrelu (the
autograd Function: K3 + K4 on the card, their plain version here) against
`jax.grad` of passion_tpu's `instance_norm_lrelu`, whose custom_jvp
differentiates `_inl_jnp`: float32 within 1e-5, bf16 within one bf16 ulp
of dx, at phase_group 1 and 8; and `torch.autograd.gradcheck` of the plain
path in float64. tests/test_torch_gpu.py holds the CUDA kernels against
the plain version on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import passion_tpu.ops.fused_norm as jfn
from passion_tpu_torch.ops import fused_norm as tfn

torch.set_num_threads(2)

# (channels-last shape, dtype, phase_group)
CASES = {
    "f32": ((2, 6, 5, 4, 16), np.float32, 1),
    "f32_rfm5_rows": ((2, 5, 5, 5, 32), np.float32, 1),
    "bf16": ((2, 6, 5, 4, 16), jnp.bfloat16, 1),
    "f32_phase_group8": ((2, 4, 6, 4, 16), np.float32, 8),
    "bf16_phase_group8": ((2, 4, 6, 4, 16), jnp.bfloat16, 8),
}


def _cf(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def _ulp_bf16(v: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_matches_jax(case):
    shape, dtype, pg = CASES[case]
    rng = np.random.default_rng(17)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    ref = jax.grad(lambda v: jnp.sum(
        (jfn.instance_norm_lrelu(v, phase_group=pg) * wj).astype(jnp.float32)
    ))(xj)
    ref = _cf(np.asarray(ref, np.float32))

    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = torch.from_numpy(_cf(x)).to(tdt).requires_grad_()
    wt = torch.from_numpy(_cf(w)).to(tdt)
    y = tfn.instance_norm_lrelu(xt, phase_group=pg)
    (got,) = torch.autograd.grad((y * wt).float().sum(), xt)
    assert got.dtype == tdt and got.shape == xt.shape
    got = got.float().numpy()
    if dtype == jnp.bfloat16:
        assert (np.abs(got - ref) <= _ulp_bf16(ref) + 1e-6).all()
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_branch_is_taken_after_the_cast():
    """A value that rounds to zero in x's dtype takes slope 1, as
    jax.nn.leaky_relu on `_inl_jnp`'s cast output does; the plain
    backward decides it the same way."""
    x = torch.tensor([[[0.0, 1.0, -1.0, 3.0, -3.0, 2e-3]]])
    st = tfn.norm_stats_plain(x)
    xh = (x - st[:, :1, None]) * st[:, 1:, None]
    g = torch.ones_like(x)
    b = tfn.norm_bwd_stats_plain(x, g, st)
    gp_mean = torch.where(xh >= 0, 1.0, 0.2).mean()
    torch.testing.assert_close(b[0, 0], gp_mean)


@pytest.mark.parametrize("pg", [1, 4])
def test_gradcheck_plain_float64(pg):
    x = (torch.randn(2, 8, 3, 4, 5, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(pg)) * 2
         + 1).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: tfn.instance_norm_lrelu(v, phase_group=pg), (x,))


def test_saves_x_and_stats_only():
    """The Function keeps x and the (rows, 2) statistics for the backward,
    never its output."""
    x = torch.randn(2, 4, 3, 3, 3, requires_grad=True)
    y = tfn.instance_norm_lrelu(x)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == x.data_ptr()
    assert saved[1].shape == (8, 2) and saved[1].dtype == torch.float32


def test_no_grad_path_is_the_forward_pair():
    """Without autograd the call is K1 + K2 as before: no graph, and on the
    CPU no launch is counted."""
    before = tuple(w.launches for w in tfn.WRAPPERS)
    with torch.no_grad():
        y = tfn.instance_norm_lrelu(torch.randn(1, 4, 3, 3, 3,
                                                requires_grad=True))
    assert y.grad_fn is None
    assert tuple(w.launches for w in tfn.WRAPPERS) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "stats"])
def test_backward_wrappers_reject_mismatches(bad):
    x = torch.randn(2, 4, 3, 3, 3)
    g = torch.randn(2, 4, 3, 3, 3)
    st = tfn.norm_stats(x)
    if bad == "dtype":
        g = g.to(torch.bfloat16)
    elif bad == "shape":
        g = g[:, :2].contiguous()
    else:
        st = st[:4]
    with pytest.raises((TypeError, ValueError)):
        tfn.norm_bwd_stats(x, g, st)
    with pytest.raises((TypeError, ValueError)):
        tfn.norm_bwd_apply(x, g, st, tfn.norm_stats(x))
