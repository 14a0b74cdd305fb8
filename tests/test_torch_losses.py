"""passion_tpu_torch.losses against passion_tpu.losses on the same inputs
(channels-first here, channels-last there), float32 on the CPU, atol 1e-5:
every per-sample `_bs` loss at up_scale 1, 2 and 4, bf16 inputs (the fp32
upcast), a batch where a class is absent from one sample (the prototype
loss's include flag) and one where no class is included (zeros); the four
batch-mean forms (passion_tpu/losses.py:201-233) at up_scale 1 and 2 and
both prototype batches, scalars, at the same tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import passion_tpu.losses as jl
from passion_tpu_torch import losses as tl

torch.set_num_threads(2)
B, S, K, C = 2, 6, 4, 5


def _cf(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _probs(rng, s=S):
    logits = rng.standard_normal((B, s, s, s, K)) * 2
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _onehot(rng, s=S, absent=None):
    labels = rng.integers(0, K, (B, s, s, s))
    if absent is not None:  # class `absent` missing from sample 0
        labels[0][labels[0] == absent] = (absent + 1) % K
    return np.eye(K, dtype=np.float32)[labels]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("up", [1, 2, 4])
def test_dice_and_wce_match_jax(up):
    rng = np.random.default_rng(up)
    p = _probs(rng)
    t = _onehot(rng, S * up)
    _close(tl.dice_loss_bs(_cf(p), _cf(t), K, up_scale=up),
           jl.dice_loss_bs(jnp.asarray(p), jnp.asarray(t), K, up_scale=up))
    _close(tl.softmax_weighted_loss_bs(_cf(p), _cf(t), K, up_scale=up),
           jl.softmax_weighted_loss_bs(jnp.asarray(p), jnp.asarray(t), K,
                                       up_scale=up))


def test_fuse_loss_matches_jax_with_zero_probabilities():
    """Masked (all-zero) predictions stay finite through the 0.005 clamp."""
    rng = np.random.default_rng(3)
    p = _probs(rng)
    p[1] = 0.0
    t = _onehot(rng)
    got = tl.fuse_loss_bs(_cf(p), _cf(t), K)
    assert torch.isfinite(got).all()
    _close(got, jl.fuse_loss_bs(jnp.asarray(p), jnp.asarray(t), K))


@pytest.mark.parametrize("up", [1, 2, 4])
def test_temp_kl_matches_jax(up):
    rng = np.random.default_rng(10 + up)
    ls = (rng.standard_normal((B, S, S, S, K)) * 3).astype(np.float32)
    lt = (rng.standard_normal((B, S, S, S, K)) * 3).astype(np.float32)
    _close(tl.temp_kl_loss_bs(_cf(ls), _cf(lt), None, K, 4.0, up_scale=up),
           jl.temp_kl_loss_bs(jnp.asarray(ls), jnp.asarray(lt), None, K, 4.0,
                              up_scale=up))


def test_bf16_inputs_reduce_in_float32():
    rng = np.random.default_rng(4)
    p = _probs(rng)
    t = _onehot(rng)
    pb = jnp.asarray(p, jnp.bfloat16)
    got = tl.dice_loss_bs(_cf(np.asarray(pb, np.float32)).to(torch.bfloat16),
                          _cf(t), K)
    assert got.dtype == torch.float32
    _close(got, jl.dice_loss_bs(pb, jnp.asarray(t), K))


@pytest.mark.parametrize("absent", [None, 2], ids=["all_classes",
                                                    "class_absent"])
def test_prototype_loss_matches_jax(absent):
    rng = np.random.default_rng(20 if absent is None else 21)
    fs = rng.standard_normal((B, S, S, S, C)).astype(np.float32)
    ft = (fs + 0.3 * rng.standard_normal(fs.shape)).astype(np.float32)
    t = _onehot(rng, absent=absent)
    got = tl.prototype_passion_loss_bs(_cf(fs), _cf(ft), _cf(t), None, None,
                                       K)
    want = jl.prototype_passion_loss_bs(jnp.asarray(fs), jnp.asarray(ft),
                                        jnp.asarray(t), None, None, K)
    for g, w in zip(got, want):
        assert g.shape == (B, 1)
        _close(g, w)
        assert (g > 0).all()


def test_prototype_loss_without_included_classes_is_zero():
    rng = np.random.default_rng(5)
    fs = rng.standard_normal((B, S, S, S, C)).astype(np.float32)
    t = np.zeros((B, S, S, S, K), np.float32)
    t[0, ..., 0] = 1.0  # sample 1 has no class at all
    got = tl.prototype_passion_loss_bs(_cf(fs), _cf(fs * 0.5), _cf(t), None,
                                       None, K)
    want = jl.prototype_passion_loss_bs(jnp.asarray(fs), jnp.asarray(fs * .5),
                                        jnp.asarray(t), None, None, K)
    for g, w in zip(got, want):
        _close(g, w)
        assert (g == 0).all()


def test_safe_norm_gradient_is_finite_at_zero():
    """Zero feature vectors (fully masked paths) give a finite gradient."""
    f = torch.zeros((1, C, 2, 2, 2), requires_grad=True)
    t = _cf(_onehot(np.random.default_rng(6))[:1, :2, :2, :2])
    proto, _ = tl.prototype_passion_loss_bs(f, torch.ones_like(f), t, None,
                                            None, K)
    (g,) = torch.autograd.grad(proto.sum(), f)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("up", [1, 2])
def test_batch_mean_dice_and_wce_match_jax(up):
    """Their own sums over the batch, not means of the `_bs` forms."""
    rng = np.random.default_rng(30 + up)
    p = _probs(rng)
    t = _onehot(rng, S * up)
    dice = tl.dice_loss(_cf(p), _cf(t), K, up_scale=up)
    assert dice.shape == ()
    _close(dice, jl.dice_loss(jnp.asarray(p), jnp.asarray(t), K,
                              up_scale=up))
    # the batch sum differs from the mean of the per-sample dice losses
    assert abs(float(dice) - float(
        tl.dice_loss_bs(_cf(p), _cf(t), K, up_scale=up).mean())) > 1e-6
    wce = tl.softmax_weighted_loss(_cf(p), _cf(t), K, up_scale=up)
    assert wce.shape == ()
    _close(wce, jl.softmax_weighted_loss(jnp.asarray(p), jnp.asarray(t), K,
                                         up_scale=up))


@pytest.mark.parametrize("up", [1, 2])
def test_batch_mean_temp_kl_matches_jax(up):
    rng = np.random.default_rng(40 + up)
    ls = (rng.standard_normal((B, S, S, S, K)) * 3).astype(np.float32)
    lt = (rng.standard_normal((B, S, S, S, K)) * 3).astype(np.float32)
    got = tl.temp_kl_loss(_cf(ls), _cf(lt), None, K, 4.0, up_scale=up)
    assert got.shape == ()
    _close(got, jl.temp_kl_loss(jnp.asarray(ls), jnp.asarray(lt), None, K,
                                4.0, up_scale=up))


@pytest.mark.parametrize("absent", [None, 2], ids=["all_classes",
                                                    "class_absent"])
def test_batch_mean_prototype_loss_matches_jax(absent):
    rng = np.random.default_rng(50 if absent is None else 51)
    fs = rng.standard_normal((B, S, S, S, C)).astype(np.float32)
    ft = (fs + 0.3 * rng.standard_normal(fs.shape)).astype(np.float32)
    t = _onehot(rng, absent=absent)
    got = tl.prototype_passion_loss(_cf(fs), _cf(ft), _cf(t), None, None, K)
    want = jl.prototype_passion_loss(jnp.asarray(fs), jnp.asarray(ft),
                                     jnp.asarray(t), None, None, K)
    for g, w in zip(got, want):
        assert g.shape == () and float(g) > 0
        _close(g, w)
