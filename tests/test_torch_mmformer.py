"""passion_tpu_torch's mmFormer against passion_tpu's at the fast-tier
sizes of tests/test_sweep_engine.py (patch 16, basic_dims 4, trans_dim 32,
mlp_dim 64, heads 4), float32 on the CPU: the softmax over all 15 masks,
both `forward` and the sweep's `fuse_inference(features)`, with the JAX
params carried across by interop.jax_weights (atol 1e-4)."""

import jax
import numpy as np
import pytest
import torch

from passion_tpu.masks import MASK_ARRAY
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch.interop.jax_weights import (load_jax_npz,
                                                   mmformer_from_jax_params)
from passion_tpu_torch.models import get_model, init_model
from passion_tpu_torch.models.layers import Conv3d

torch.set_num_threads(2)
PATCH = 16
KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, port model with the same weights, window)."""
    jm = jax_get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    # scale 0.3 (not init_params_host's default 0.02): the softmax must
    # spread well away from uniform for a 1e-4 comparison to mean anything
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     batch_size=2, scale=0.3))
    tm = get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)
    x = np.random.default_rng(1037).standard_normal(
        (2, PATCH, PATCH, PATCH, 4)).astype(np.float32)
    return jm, params, tm.eval(), x


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """JAX softmax of every mask, for `__call__` and `fuse_inference`."""
    jm, params, _, x = pair
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
    return out


def _port(x):
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()


@pytest.mark.parametrize("mask_id", range(15))
def test_softmax_matches_jax(pair, jax_outputs, mask_id):
    _, _, tm, x = pair
    ref_fwd, ref_fuse = jax_outputs[mask_id]
    assert np.abs(ref_fwd - 0.25).max() > 0.05  # not a uniform softmax
    xt = _port(x)
    m = torch.from_numpy(np.stack([MASK_ARRAY[mask_id]] * 2))
    with torch.no_grad():
        got_fwd = tm(xt, m).permute(0, 2, 3, 4, 1).numpy()
        got_fuse = tm.fuse_inference(tm.features(xt), m).permute(
            0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got_fwd, ref_fwd, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_fuse, ref_fuse, atol=1e-4, rtol=0)
    # the sweep's split is exact in the port as in JAX (test_sweep_engine)
    np.testing.assert_allclose(got_fuse, got_fwd, atol=1e-5, rtol=0)


def test_pdt_forward_matches_jax(pair):
    """mask_type 'pdt' skips the input masking of `encode`."""
    _, params, _, x = pair
    jm = jax_get_model("mmformer", mask_type="pdt", patch_size=PATCH, **KW)
    tm = get_model("mmformer", mask_type="pdt", patch_size=PATCH, **KW)
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)
    m = np.stack([MASK_ARRAY[6]] * 2)
    ref = np.asarray(jm.apply(params, x, m))
    with torch.no_grad():
        got = tm(_port(x), torch.from_numpy(m)).permute(
            0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_npz_loader_matches_tree_converter(pair, tmp_path):
    """The README's .npz recipe: flattened "/"-joined keys of the tree."""
    from flax import traverse_util

    _, params, tm, _ = pair
    flat = traverse_util.flatten_dict(params, sep="/")
    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    sd = load_jax_npz(str(path))
    ref = tm.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)


def test_converter_skips_training_only_params(pair):
    """The training-only modules are no longer skipped: one JAX tree gives
    the whole port state_dict, the shared decoder and the deep-supervision
    heads included."""
    _, params, tm, _ = pair
    sd = mmformer_from_jax_params(params)
    assert any(k.startswith("decoder_sep.") for k in sd)
    assert {f"fuse_path.decoder_fuse.seg_d{k}.weight" for k in range(1, 5)
            } <= set(sd)
    assert set(sd) == set(tm.state_dict())


def test_init_model_follows_the_jax_scheme():
    m = init_model(get_model("mmformer", patch_size=PATCH, **KW), seed=3)
    w = m.encoders.e2_c2.conv.weight  # He normal, fan_in 27 * 8
    assert abs(w.std().item() - np.sqrt(2 / (27 * 8))) < 0.1 * np.sqrt(
        2 / (27 * 8))
    q = m.fuse_path.multimodal_transformer.layers[0].attn.qkv.weight
    lim = 2 * np.sqrt(1 / 32) / 0.87962566103423978  # truncated at 2 std
    assert q.abs().max().item() <= lim + 1e-6
    assert torch.all(m.pos == 0)
    assert torch.all(m.encoders.e1_c1.bias == 0)
    norm = m.intra_transformers[2].layers[0].ffn_norm
    assert torch.all(norm.weight == 1) and torch.all(norm.bias == 0)
    again = init_model(get_model("mmformer", patch_size=PATCH, **KW), seed=3)
    for (k, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert sum(isinstance(x, Conv3d) for x in m.modules()) > 40


@pytest.mark.parametrize("name", ["rfnet", "m2ftrans"])
def test_unported_backbones_raise(name):
    """The other backbones are ported now: `get_model` builds them at full
    width, and an unknown name still raises."""
    model = get_model(name)
    assert sum(p.numel() for p in model.parameters()) > 1e6
    assert callable(model.features) and callable(model.train_losses)
    with pytest.raises(ValueError, match="unknown model"):
        get_model(name + "x")
