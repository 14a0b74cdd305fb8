"""passion_tpu_torch's M2FTrans against passion_tpu's, float32 on the CPU, at
the sizes of tests/test_m2ftrans.py (basic_dims 2, patch 32 so 8 tokens per
modality, heads 4, mlp_dim 32, depth 2; at patch 16 the one-voxel
bottleneck's InstanceNorm zeroes everything), with JAX params from
`init_params_host(scale=0.3)` carried across by `m2ftrans_from_jax_params`
and loaded with strict=True. The JAX model runs as its own CPU tests run it
(default `use_s2d=True`, the jnp norm); each JAX function is jitted once
per module.

  * the attention-mask biases against `passion_tpu/ops/attn_mask.py`,
    exactly;
  * the softmax of `forward` and of `fuse_inference(features)` for all 15
    masks (atol 1e-4);
  * `train_losses` with PASSION on and off, dropout off (1e-4);
  * one train step's gradients, per tensor within 1e-3 in relative L2,
    or, where float32 rounding moves them more, held through the port's
    float64 gradient (see the test);
  * dropout only with a generator; the converter and `init_model`.
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
from passion_tpu.ops import attn_mask as jmask
from passion_tpu_torch.engine import schedule as tsched
from passion_tpu_torch.engine import train_loop as tloop
from passion_tpu_torch.interop.jax_weights import (load_jax_npz,
                                                   m2ftrans_from_jax_params)
from passion_tpu_torch.models import get_model, init_model
from passion_tpu_torch.ops import attn_mask as tmask

torch.set_num_threads(2)
PATCH = 32
KW = dict(basic_dims=2, heads=4, mlp_dim=32, depth=2)
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


@pytest.mark.parametrize("tokens", [1, 8])
def test_attention_biases_match_jax(tokens):
    masks = np.array([list(m) for m in MASK_ARRAY] + [[0, 0, 0, 0]], bool)
    got = tmask.fusion_attention_bias(torch.from_numpy(masks), tokens)
    want = np.asarray(jmask.fusion_attention_bias(masks, tokens))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got = tmask.cross_key_bias(torch.from_numpy(masks), tokens)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmask.cross_key_bias(masks, tokens)))
    assert tmask.NEG_INF == jmask.NEG_INF == -1e9


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, port model with the same weights)."""
    jm = jax_get_model("m2ftrans", mask_type="idt", patch_size=PATCH, **KW)
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     batch_size=3, scale=0.3))
    tm = get_model("m2ftrans", mask_type="idt", patch_size=PATCH, **KW)
    tm.load_state_dict(m2ftrans_from_jax_params(params), strict=True)
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
    # the sweep's split is exact (block-diagonal encoder)
    np.testing.assert_allclose(got_fuse, got_fwd, atol=1e-6, rtol=0)


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


def test_dropout_only_with_a_generator(pair):
    """Dropout is off without a generator (the JAX deterministic=True) and
    on with one, repeatably for a seeded generator."""
    _, _, tm = pair
    x, mask, target = _batch(5)
    args = (_cf(x), torch.from_numpy(mask), _cf(target))

    def run(seed=None):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tm.train_losses(*args, generator=g)["fuse_pred"]

    a = run()
    assert torch.equal(a, run())
    c = run(1)
    assert not torch.equal(a, c)
    assert torch.equal(c, run(1))


def _grab_grads():
    """An optax transformation whose update is zero: the JAX step then
    hands back its exact gradients as the optimizer state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _port_grads(params, batch, dtype):
    """Gradients of one port step (lr 0) in `dtype`, as float64 numpy."""
    tm = get_model("m2ftrans", mask_type="idt", patch_size=PATCH, **KW)
    tm.load_state_dict(m2ftrans_from_jax_params(params), strict=True)
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
    ref = {k: v.numpy().astype(np.float64) for k, v in m2ftrans_from_jax_params(
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
    # the bottleneck and the cross-attention get a gradient
    for k in ("fuse_path.trans_bottle.layers.0.attn.qkv.weight", "fusion",
              "fuse_path.decoder_fusion.CT4.layer_0.cross_attn.key_map_t2."
              "convs.1.weight"):
        assert np.abs(ref[k]).max() > 0, k


def test_pdt_forward_is_the_unmasked_decode(pair, jax_outputs):
    """mask_type 'pdt' skips every feature masking, so its forward and its
    fuse of the features agree, and match JAX's pdt model."""
    _, params, _ = pair
    x, _ = jax_outputs
    tm = get_model("m2ftrans", mask_type="pdt", patch_size=PATCH, **KW)
    tm.load_state_dict(m2ftrans_from_jax_params(params), strict=True)
    jm = jax_get_model("m2ftrans", mask_type="pdt", patch_size=PATCH, **KW)
    m = np.stack([MASK_ARRAY[6]] * 2)
    ref = np.asarray(jax.jit(lambda p, f, m: jm.apply(
        p, f, m, method=type(jm).fuse_inference))(
            params, jax.jit(lambda p, x: jm.apply(
                p, x, method=type(jm).features))(params, x), m))
    with torch.no_grad():
        xt, mt = _cf(x), torch.from_numpy(m)
        got = tm(xt, mt)
        fused = tm.fuse_inference(tm.features(xt), mt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref,
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(fused, got, rtol=0, atol=1e-6)


def test_npz_loader_and_names(pair, tmp_path):
    """The .npz recipe with the model's name; the LayerNorm conv blocks'
    auto-named children take `convs.N` / `norms.N`, the units'
    `layers.N`."""
    from flax import traverse_util

    _, params, tm = pair
    flat = traverse_util.flatten_dict(params, sep="/")
    np.savez(tmp_path / "p.npz", **flat)
    sd = load_jax_npz(str(tmp_path / "p.npz"), "m2ftrans")
    ref = tm.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
    cross = "fuse_path.decoder_fusion.CT5.layer_0.cross_attn."
    assert {cross + "query_map.convs.1.weight",
            cross + "value_map_t1ce.norms.2.weight",
            "fuse_path.decoder_fusion.CT5.layer_0.ffn2.convs.2.bias",
            "fuse_path.decoder_fusion.RFM2.layers.1.conv.weight",
            "fuse_path.decoder_fusion.prm_fusion3.conv.weight",
            "pos", "fusion"} <= set(sd)
    assert "fuse_path.decoder_fusion.CT5.layer_1.ffn2.convs.0.weight" \
        not in sd  # the last cross block leaves the feature maps alone


def test_init_model_follows_the_jax_scheme():
    m = init_model(get_model("m2ftrans", patch_size=PATCH, **KW), seed=3)
    assert torch.all(m.pos == 0)
    assert abs(m.fusion.std().item() - 1.0) < 0.15  # N(0, 1)
    dw = m.fuse_path.decoder_fusion.CT4.layer_0.cross_attn.query_map
    lim = 2 * np.sqrt(1 / 27) / 0.87962566103423978  # lecun, truncated
    assert dw.convs[1].weight.abs().max().item() <= lim + 1e-6
    assert torch.all(dw.norms[0].weight == 1) and torch.all(
        dw.norms[0].bias == 0)
    again = init_model(get_model("m2ftrans", patch_size=PATCH, **KW), seed=3)
    for (k, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_full_width_builds():
    """The published configuration (basic_dims 8, depth 3, heads 8,
    mlp_dim 4096, patch 80: 125 tokens of width 128) builds; its param
    count is the JAX model's."""
    m = get_model("m2ftrans")
    assert tuple(m.fusion.shape) == (1, 125, 128)
    assert tuple(m.pos.shape) == (1, 625, 128)
    assert len(m.fuse_path.trans_bottle.layers) == 3
    n = sum(p.numel() for p in m.parameters())
    jm = jax_get_model("m2ftrans")
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 80, 80, 80, 4)), jnp.ones((1, 4), bool),
        jnp.zeros((1, 80, 80, 80, 4)), 1.0, True,
        method=type(jm).train_losses), jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes))
    with pytest.raises(ValueError, match="patch_size"):
        with torch.no_grad():
            get_model("m2ftrans", patch_size=32, **KW).features  # noqa
            small = get_model("m2ftrans", patch_size=32, **KW)
            small(torch.zeros((1, 4, 16, 16, 16)),
                  torch.ones((1, 4), dtype=torch.bool))
