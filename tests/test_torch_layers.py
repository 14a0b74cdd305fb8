"""passion_tpu_torch.models.layers against passion_tpu.models.layers in
float32 on the CPU, with the JAX modules' params carried across by
passion_tpu_torch.interop.jax_weights. Inputs and params come from a numpy
seed; every leaf (biases and LayerNorm scales included) is drawn at
random so a wrong mapping cannot hide behind a zero or a one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passion_tpu.models import layers as jl
from passion_tpu_torch.interop.jax_weights import mmformer_from_jax_params
from passion_tpu_torch.models import layers as tl

torch.set_num_threads(2)
ATOL = 1e-5


def _random_params(module, rng, *args, **kw):
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


def _to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()


def _to_numpy(y: torch.Tensor) -> np.ndarray:
    return y.detach().permute(0, 2, 3, 4, 1).numpy()


# (JAX module, port module, input channels, in_mask) — the conv variants
# of the mmFormer path: reflect and zero padding, stride 2, groups 4, 1x1,
# and the premasked in_mask rows
CONVS = {
    "reflect_k3": (jl.Conv3d(6), tl.Conv3d(8, 6), 8, None),
    "zeros_k3": (jl.Conv3d(6, pad_type="zeros"),
                 tl.Conv3d(8, 6, pad_type="zeros"), 8, None),
    "grouped_stride2": (jl.Conv3d(16, stride=2, groups=4),
                        tl.Conv3d(8, 16, stride=2, groups=4), 8, None),
    "grouped_stem": (jl.Conv3d(16, groups=4), tl.Conv3d(4, 16, groups=4), 4,
                     None),
    "k1_in_mask": (jl.Conv3d(5, k_size=1, padding=0),
                   tl.Conv3d(12, 5, 1, padding=0), 12,
                   [True, False, True, True]),
    "k3_in_mask": (jl.Conv3d(5), tl.Conv3d(12, 5), 12,
                   [False, True, False, False]),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv3d_matches_jax(name, rng):
    jm, tm, cin, in_mask = CONVS[name]
    x = rng.standard_normal((2, 7, 6, 5, cin)).astype(np.float32)
    kw = {} if in_mask is None else {"in_mask": jnp.asarray(in_mask)}
    params = _random_params(jm, rng, x, **kw)
    ref = np.asarray(jm.apply(params, x, **kw))
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)
    tkw = {} if in_mask is None else {"in_mask": torch.tensor(in_mask)}
    with torch.no_grad():
        got = _to_numpy(tm(_to_torch(x), **tkw))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-5)


def test_reflect_pad_of_a_one_voxel_axis_matches_numpy(rng):
    """torch's reflect mode refuses pad >= size; the 1-voxel bottleneck of
    a 16-voxel patch takes numpy's reflect indices."""
    x = rng.standard_normal((1, 2, 1, 3, 4)).astype(np.float32)
    got = tl.reflect_pad3d(torch.from_numpy(x), 1).numpy()
    ref = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1), (1, 1)), mode="reflect")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("skip_norm", [False, True])
def test_general_conv_prenorm_matches_jax(skip_norm, rng):
    x = (rng.standard_normal((2, 6, 6, 6, 8)) * 2 + 1).astype(np.float32)
    jm = jl.GeneralConv3dPreNorm(8, stride=2, groups=4)
    params = _random_params(jm, rng, x)
    ref = np.asarray(jm.apply(params, x, skip_norm=skip_norm))
    tm = tl.GeneralConv3dPreNorm(8, 8, stride=2, groups=4)
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = _to_numpy(tm(_to_torch(x), skip_norm=skip_norm))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("premasked", [False, True])
def test_fusion_prenorm_matches_jax(premasked, rng):
    """Plain mode on masked features, and the sweep's premasked mode:
    prenormed unmasked features with the mask folded into the first conv
    must equal the plain mode on the same mask."""
    c = 3
    x = (rng.standard_normal((2, 5, 6, 4, 4 * c)) + 0.5).astype(np.float32)
    mask = np.array([[True, False, True, True]] * 2)
    jm = jl.FusionPreNorm(c)
    params = _random_params(jm, rng, x)
    ref = np.asarray(jm.apply(params, jl.mask_channels(x, mask)))
    tm = tl.FusionPreNorm(4 * c, c)
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)
    xt = _to_torch(x)
    with torch.no_grad():
        if premasked:
            from passion_tpu_torch.ops.fused_norm import instance_norm_lrelu
            got = tm(instance_norm_lrelu(xt), in_mask=torch.tensor(mask[0]),
                     prenormed=True)
        else:
            got = tm(tl.mask_channels(xt, torch.tensor(mask)))
    np.testing.assert_allclose(_to_numpy(got), ref, atol=ATOL, rtol=1e-5)


def test_transformer_matches_jax(rng):
    dim, n = 32, 10
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    pos = rng.standard_normal((1, n, dim)).astype(np.float32)
    jm = jl.Transformer(depth=2, heads=4, mlp_dim=64)
    params = _random_params(jm, rng, x, pos, True)
    ref = np.asarray(jm.apply(params, x, pos, True))
    tm = tl.Transformer(dim, depth=2, heads=4, mlp_dim=64)
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_masking_helpers_match_jax(rng):
    mask = np.array([[True, False, True, False], [False, True, True, True]])
    stack = rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
    flat = rng.standard_normal((2, 3, 3, 3, 12)).astype(np.float32)
    kernel = rng.standard_normal((1, 1, 1, 12, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.mask_modalities(torch.from_numpy(stack),
                           torch.tensor(mask)).numpy(),
        np.asarray(jl.mask_modalities(stack, mask)))
    np.testing.assert_array_equal(
        _to_numpy(tl.mask_channels(_to_torch(flat), torch.tensor(mask))),
        np.asarray(jl.mask_channels(flat, mask)))
    w = torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy())
    np.testing.assert_array_equal(
        tl.mask_kernel_rows(w, torch.tensor(mask[0])).numpy(),
        np.asarray(jl.mask_kernel_rows(kernel, mask[0])).transpose(
            4, 3, 0, 1, 2))
