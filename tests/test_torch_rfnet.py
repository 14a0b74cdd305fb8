"""passion_tpu_torch's RFNet against passion_tpu's, float32 on the CPU, at
basic_dims 4 (not 2: the PRM embedding has basic_dims // 4 channels) and
patch 16, with JAX params from `init_params_host(scale=0.3)` carried
across by `rfnet_from_jax_params` and loaded with strict=True. The JAX
model runs as its own CPU tests run it (default `use_s2d=True`, the jnp
norm); each JAX function is jitted once per module.

  * the softmax of `forward` and of `fuse_inference(features)` for all 15
    masks (atol 1e-4);
  * `train_losses` with PASSION on and off, dropout off (1e-4);
  * one train step's gradients, per tensor within 1e-3 in relative L2,
    or, where float32 rounding moves them more, held through the port's
    float64 gradient (see the test);
  * the .npz loader, the converter's refusals, `init_model`'s scheme.

RegionAwareModalFusion divides a region's mean feature by the region's
mean probability + 1e-7; with these weights every region holds a fair
share of the probability, so the division is well conditioned and 1e-4
holds (the test asserts the smallest share).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from passion_tpu.engine import train_loop as jloop
from passion_tpu.masks import MASK_ARRAY
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch.engine import schedule as tsched
from passion_tpu_torch.engine import train_loop as tloop
from passion_tpu_torch.interop.jax_weights import (load_jax_npz,
                                                   m2ftrans_from_jax_params,
                                                   rfnet_from_jax_params)
from passion_tpu_torch.models import get_model, init_model
from passion_tpu_torch.models.layers import ModalFusion

torch.set_num_threads(2)
PATCH = 16
KW = dict(basic_dims=4)
MASKS = np.array([[True, True, True, True],  # full
                  [True, False, True, False],  # partial
                  [False, False, False, True]])  # unimodal (T2)
KEYS = ("fuse_pred", "prm_loss", "sep_loss", "kl_loss", "proto_loss", "dist")
BETA = np.array([1.2, 0.8, 1.0, 0.9], np.float32)
MODAL_W = np.array([1.0, 1.5, 2.0, 3.0], np.float32)


def _cf(a: np.ndarray) -> torch.Tensor:  # channels-last -> channels-first
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _batch(seed=7, masks=MASKS):
    rng = np.random.default_rng(seed)
    b = len(masks)
    x = rng.standard_normal((b, PATCH, PATCH, PATCH, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (b, PATCH, PATCH, PATCH))
    labels[:, :2] = np.arange(4).repeat(PATCH * PATCH * 2 // 4).reshape(
        2, PATCH, PATCH)  # every class in every sample
    return x, np.asarray(masks, bool), np.eye(4, dtype=np.float32)[labels]


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, port model with the same weights)."""
    jm = jax_get_model("rfnet", mask_type="idt", **KW)
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     batch_size=3, scale=0.3))
    tm = get_model("rfnet", mask_type="idt", **KW)
    tm.load_state_dict(rfnet_from_jax_params(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """JAX softmax of every mask, for `__call__` and `fuse_inference`."""
    jm, params, _ = pair
    x = np.random.default_rng(1037).standard_normal(
        (2, PATCH, PATCH, PATCH, 4)).astype(np.float32)
    fwd = jax.jit(lambda p, x, m: jm.apply(p, x, m))
    fuse = jax.jit(lambda p, f, m: jm.apply(
        p, f, m, method=type(jm).fuse_inference))
    fts = jax.jit(lambda p, x: jm.apply(p, x, method=type(jm).features))(
        params, x)
    out = {}
    for i, mask in enumerate(MASK_ARRAY):
        m = np.stack([mask, mask])
        out[i] = (np.asarray(fwd(params, x, m)),
                  np.asarray(fuse(params, fts, m)))
    return x, out


@pytest.mark.parametrize("mask_id", range(15))
def test_softmax_matches_jax(pair, jax_outputs, mask_id):
    _, _, tm = pair
    x, out = jax_outputs
    ref_fwd, ref_fuse = out[mask_id]
    assert np.abs(ref_fwd - 0.25).max() > 0.05  # not a uniform softmax
    xt = _cf(x)
    m = torch.from_numpy(np.stack([MASK_ARRAY[mask_id]] * 2))
    with torch.no_grad():
        got_fwd = tm(xt, m).permute(0, 2, 3, 4, 1).numpy()
        got_fuse = tm.fuse_inference(tm.features(xt), m).permute(
            0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got_fwd, ref_fwd, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_fuse, ref_fuse, atol=1e-4, rtol=0)
    # the sweep's split is exact (encoder per modality, decoder masks)
    np.testing.assert_allclose(got_fuse, got_fwd, atol=1e-6, rtol=0)


def test_regions_are_well_conditioned(pair, jax_outputs):
    """Every PRM region of the deepest scale holds a fair share of the
    probability, so ModalFusion's division by it does not amplify
    rounding (the premise of the 1e-4 tolerance)."""
    _, _, tm = pair
    x, _ = jax_outputs
    xt = _cf(x)
    mask = torch.ones((2, 4), dtype=torch.bool)
    with torch.no_grad():
        _, prms, _ = tm.decoder_fuse(*tm.encode(xt, mask), mask[None],
                                     heads=True)
    for prm in prms:
        share = torch.softmax(prm, 1).mean(dim=(2, 3, 4))
        assert share.min().item() > 0.01


@pytest.fixture(scope="module")
def jax_train_losses(pair):
    """JAX `train_losses` with PASSION on, jitted once. With PASSION off the
    JAX model runs lane 0 alone, whose per-sample outputs are the same;
    kl_loss, proto_loss and dist are then zero."""
    jm, params, _ = pair
    x, mask, target = _batch()
    ref = jax.jit(lambda p, x, m, t: jm.apply(
        p, x, m, t, 4.0, True, method=type(jm).train_losses))(
            params, x, mask, target)
    return {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("use_passion", [True, False],
                         ids=["passion", "no_passion"])
def test_train_losses_match_jax(pair, jax_train_losses, use_passion):
    _, _, tm = pair
    x, mask, target = _batch()
    with torch.no_grad():
        got = tm.train_losses(_cf(x), torch.from_numpy(mask), _cf(target),
                              temp=4.0, use_passion=use_passion)
    for k in KEYS:
        want = jax_train_losses[k]
        if k == "fuse_pred":
            want = np.moveaxis(want, -1, 1)
        elif not use_passion and k in ("kl_loss", "proto_loss", "dist"):
            want = np.zeros_like(want)
        have = got[k].numpy()
        assert have.shape == want.shape, k
        np.testing.assert_allclose(have, want, atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    if use_passion:
        assert np.abs(jax_train_losses["kl_loss"]).max() > 1e-4
        assert got["dist"][2, 3] == 0 and jax_train_losses["dist"][2, 3] == 0
        assert (got["dist"][0] > 0).all()


def test_generator_changes_nothing(pair):
    """RFNet has no dropout: a generator (the train step passes one) leaves
    the training forward as it was."""
    _, _, tm = pair
    x, mask, target = _batch(3)
    args = (_cf(x), torch.from_numpy(mask), _cf(target))
    with torch.no_grad():
        a = tm.train_losses(*args)["fuse_pred"]
        b = tm.train_losses(*args, generator=torch.Generator().manual_seed(
            1))["fuse_pred"]
    assert torch.equal(a, b)


def _grab_grads():
    """An optax transformation whose update is zero: the JAX step then
    hands back its exact gradients as the optimizer state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _port_grads(params, batch, dtype):
    """Gradients of one port step (lr 0) in `dtype`, as float64 numpy."""
    tm = get_model("rfnet", mask_type="idt", **KW)
    tm.load_state_dict(rfnet_from_jax_params(params), strict=True)
    tm = tm.to(dtype)
    opt = tsched.make_optimizer(tm.parameters(), 0.0)
    step = tloop.make_train_step(tm, opt, True, compute_dtype=None)
    m = step(dict(x=_cf(batch["x"]).to(dtype),
                  target=_cf(batch["target"]).to(dtype),
                  mask=torch.from_numpy(batch["mask"])),
             torch.from_numpy(BETA).to(dtype),
             torch.from_numpy(MODAL_W).to(dtype), 4.0)
    return m["loss"].item(), {n: p.grad.double().numpy()
                              for n, p in tm.named_parameters()}


def test_one_step_gradients_match_jax(pair):
    """Gradients of one PASSION step, float32, dropout off, against JAX's,
    in relative L2: per tensor within 1e-3 (at least half of them), else
    within ten times the port's own float32 rounding error of the port's
    float64 gradient (|g_jax32 - g_port64| <= 10 |g_port32 - g_port64|);
    over all params together, JAX within three times that rounding and
    within 5e-3 of the port. Norm rows of a few voxels (the 2^3 bottleneck)
    and LeakyReLU kinks make float32 gradients of this tiny network move
    by up to a few percent with rounding, on either side
    (tests/test_torch_train_step.py); a fault in the port would part JAX
    from the port's float64 gradient by far more than the port's
    rounding."""
    jm, params, _ = pair
    x, mask, target = _batch(11, [[1, 1, 1, 1], [1, 0, 1, 0], [0, 1, 1, 1]])
    batch = dict(x=x, target=target, mask=mask)
    tx = _grab_grads()
    step = jloop.make_train_step(jm, tx, True, with_dropout=False,
                                 compute_dtype=None)
    _, grads, ref_m = step(params, tx.init(params), batch, jnp.asarray(BETA),
                           jnp.asarray(MODAL_W), jnp.float32(4.0),
                           jax.random.PRNGKey(0), False)
    ref = {k: v.numpy().astype(np.float64) for k, v in rfnet_from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads)).items()}

    loss32, g32 = _port_grads(params, batch, torch.float32)
    np.testing.assert_allclose(loss32, float(ref_m["loss"]), rtol=1e-5)
    loss64, g64 = _port_grads(params, batch, torch.float64)
    np.testing.assert_allclose(loss64, float(ref_m["loss"]), rtol=1e-5)
    floor = 1e-6 * max(np.linalg.norm(v) for v in ref.values())
    strict = 0
    for n, want in ref.items():
        gap = np.linalg.norm(g32[n] - want)
        if gap <= max(1e-3 * np.linalg.norm(want), floor):
            strict += 1
            continue
        rounding = np.linalg.norm(g32[n] - g64[n])
        assert np.linalg.norm(want - g64[n]) <= max(10 * rounding, floor), (
            n, gap / np.linalg.norm(want), rounding / np.linalg.norm(want))
    assert strict >= len(ref) // 2, (strict, len(ref))

    def total(a, b):
        return np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in ref))

    norm = np.sqrt(sum(np.sum(v ** 2) for v in ref.values()))
    assert total(ref, g64) <= 3 * total(g32, g64)
    assert total(g32, ref) <= 5e-3 * norm
    mf = "decoder_fuse.RFM1.modal_fusion_0.fc1.weight"
    assert np.abs(ref[mf]).max() > 0  # the region fusion gets a gradient


def test_pdt_forward_is_the_unmasked_decode(pair, jax_outputs):
    """mask_type 'pdt' skips the input masking of `encode`, so its forward
    is the fusion decode of the unmasked features: JAX's
    `fuse_inference(features(x), m)` for the same weights."""
    _, params, _ = pair
    x, out = jax_outputs
    tm = get_model("rfnet", mask_type="pdt", **KW)
    tm.load_state_dict(rfnet_from_jax_params(params), strict=True)
    m = torch.from_numpy(np.stack([MASK_ARRAY[6]] * 2))
    with torch.no_grad():
        got = tm(_cf(x), m).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, out[6][1], atol=1e-4, rtol=0)


def test_npz_loader_and_refusals(pair, tmp_path):
    """The .npz recipe with the model's name; a tree handed to the wrong
    converter, or holding a name no rule maps, is refused."""
    from flax import traverse_util

    _, params, tm = pair
    flat = traverse_util.flatten_dict(params, sep="/")
    np.savez(tmp_path / "p.npz", **flat)
    sd = load_jax_npz(str(tmp_path / "p.npz"), "rfnet")
    ref = tm.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not a JAX mmformer"):
        load_jax_npz(str(tmp_path / "p.npz"))
    with pytest.raises(ValueError, match="not a JAX m2ftrans"):
        m2ftrans_from_jax_params(params)
    with pytest.raises(ValueError, match="unknown model"):
        load_jax_npz(str(tmp_path / "p.npz"), "unet")
    bad = {**params["params"], "decoder_fuse": {
        **params["params"]["decoder_fuse"], "Dense_7": {"bias": np.zeros(1)}}}
    with pytest.raises(ValueError, match="Dense_7"):
        rfnet_from_jax_params(bad)


def test_init_model_follows_the_jax_scheme():
    m = init_model(get_model("rfnet", **KW), seed=3)
    w = m.encoders.e2_c2.conv.weight  # He normal, fan_in 27 * 8
    assert abs(w.std().item() - np.sqrt(2 / (27 * 8))) < 0.1 * np.sqrt(
        2 / (27 * 8))
    fc = m.decoder_fuse.RFM4.modal_fusion_2.fc1.weight  # He, not truncated
    std = np.sqrt(2 / fc.shape[1])
    assert abs(fc.std().item() - std) < 0.05 * std
    assert fc.abs().max().item() > 2.5 * std
    assert torch.all(m.decoder_fuse.RFM4.modal_fusion_2.fc1.bias == 0)
    assert sum(isinstance(x, ModalFusion) for x in m.modules()) == 16
    again = init_model(get_model("rfnet", **KW), seed=3)
    for (k, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_full_width_builds():
    """The published width (basic_dims 8) builds; its param count is the
    JAX model's."""
    m = get_model("rfnet")
    n = sum(p.numel() for p in m.parameters())
    jm = jax_get_model("rfnet")
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 16, 16, 16, 4)), jnp.ones((1, 4), bool),
        jnp.zeros((1, 16, 16, 16, 4)), 1.0, True,
        method=type(jm).train_losses), jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes))
    with pytest.raises(ValueError, match="basic_dims"):
        get_model("rfnet", basic_dims=2)
