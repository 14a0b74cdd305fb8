"""passion_tpu_torch.engine.sliding_window against the JAX engine: the
window protocol, and the 15-mask sweep's labels against
`passion_tpu.engine.sliding_window.SlidingWindowSweep(compute_dtype=
float32)` on small non-cubic volumes (patch 16, the fast-tier mmFormer).
Labels must be equal except at voxels whose top-2 probability gap is under
1e-4, where float32 sums in another order may break the tie either way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passion_tpu.engine import sliding_window as jsw
from passion_tpu.masks import MASK_ARRAY
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch.engine import sliding_window as tsw
from passion_tpu_torch.interop.jax_weights import mmformer_from_jax_params
from passion_tpu_torch.models import get_model

torch.set_num_threads(2)
PATCH = 16
KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)
MASKS = [np.asarray(m) for m in MASK_ARRAY]


@pytest.fixture(scope="module")
def engines():
    jm = jax_get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     scale=0.3))
    tm = get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)
    jax_engine = jsw.SlidingWindowSweep(jm, num_cls=4, patch=PATCH,
                                        window_batch=4,
                                        compute_dtype=jnp.float32)
    port_engine = tsw.SlidingWindowSweep(tm, num_cls=4, patch=PATCH,
                                         window_batch=4,
                                         compute_dtype=torch.float32,
                                         device="cpu")
    return jax_engine, params, port_engine, tm


def _assert_labels_match(jax_engine, params, jprep, mask, got, ref):
    diff = got != ref
    if not diff.any():
        return
    h, w, z = jprep["shape"]
    probs = np.sort(np.asarray(jax_engine.run(params, jprep, mask))
                    [:h, :w, :z], axis=-1)
    gap = probs[..., -1] - probs[..., -2]
    assert (gap[diff] < 1e-4).all(), (
        f"{diff.sum()} labels differ, gaps {gap[diff].max()}")


@pytest.mark.parametrize("shape", [(24, 24, 20), (20, 14, 18)],
                         ids=["noncubic", "axis_below_patch"])
def test_sweep_labels_match_jax(engines, shape):
    jax_engine, params, port_engine, _ = engines
    vol = np.random.default_rng(7).standard_normal(shape + (4,)).astype(
        np.float32)
    masks = MASKS if shape == (24, 24, 20) else MASKS[::4]
    jprep = jax_engine.prepare(vol)
    ref = jax_engine.sweep_labels(params, jprep, masks)
    got = port_engine.sweep_labels(port_engine.prepare(vol), masks)
    assert len(got) == len(masks)
    for m, g, r in zip(masks, got, ref):
        assert g.shape == shape and g.dtype == np.uint8
        _assert_labels_match(jax_engine, params, jprep, m, g, r)
    assert len(np.unique(np.concatenate([g.ravel() for g in got]))) > 1


def test_chunking_does_not_change_labels(engines):
    """Auto window batch (one chunk of 8) == uneven chunks of 3."""
    _, _, port_engine, tm = engines
    vol = np.random.default_rng(8).standard_normal((24, 24, 20, 4)).astype(
        np.float32)
    auto = tsw.SlidingWindowSweep(tm, 4, PATCH, compute_dtype=torch.float32,
                                  device="cpu")
    threes = tsw.SlidingWindowSweep(tm, 4, PATCH, window_batch=3,
                                    compute_dtype=torch.float32, device="cpu")
    pa, p3 = auto.prepare(vol), threes.prepare(vol)
    assert pa["window_batch"] == 8 and p3["window_batch"] == 3
    fa, f3 = auto.encode_case(pa), threes.encode_case(p3)
    for m in MASKS[::5]:
        np.testing.assert_array_equal(auto.infer_labels_masked(pa, fa, m),
                                      threes.infer_labels_masked(p3, f3, m))


@pytest.mark.parametrize("extent", [80, 96, 155, 240, 17, 16])
def test_window_protocol_matches_jax(extent):
    assert tsw.window_starts(extent, 16) == jsw.window_starts(extent, 16)
    assert tsw.window_starts(max(extent, 80), 80) == jsw.window_starts(
        max(extent, 80), 80)


def test_window_coords_and_coverage_match_jax():
    shape = (240, 240, 155)
    np.testing.assert_array_equal(tsw.window_coords(shape, 80),
                                  jsw.window_coords(shape, 80))
    assert len(tsw.window_coords(shape, 80)) == 75
    np.testing.assert_array_equal(
        tsw.coverage_weight(shape, shape, 80),
        jsw.coverage_weight(shape, shape, 80)[..., 0])


@pytest.mark.parametrize("n,shards,cap", [(75, 1, 80), (9, 8, 80),
                                          (75, 8, 80), (200, 1, 80),
                                          (75, 1, 37), (1, 1, 80)])
def test_auto_window_batch_matches_jax(n, shards, cap):
    assert tsw._auto_window_batch(n, shards, cap) == jsw._auto_window_batch(
        n, shards, cap)


def test_oom_halves_the_auto_window_batch(engines):
    _, _, port_engine, tm = engines
    auto = tsw.SlidingWindowSweep(tm, 4, PATCH, compute_dtype=torch.float32,
                                  device="cpu")
    prepared = auto.prepare(np.zeros((24, 24, 20, 4), np.float32))
    seen = []

    def fn():
        seen.append(prepared["window_batch"])
        if len(seen) < 3:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return "done"

    assert auto._with_oom_fallback(prepared, fn) == "done"
    assert seen == [8, 4, 2]

    def always_oom():
        raise torch.cuda.OutOfMemoryError("out of memory")

    # an explicit --window_batch is never changed
    fixed = port_engine.prepare(np.zeros((24, 24, 20, 4), np.float32))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        port_engine._with_oom_fallback(fixed, always_oom)
    assert fixed["window_batch"] == 4
