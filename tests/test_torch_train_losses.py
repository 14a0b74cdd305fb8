"""passion_tpu_torch's `MMFormer.train_losses` against passion_tpu's, float32
on the CPU at the fast-tier widths (basic_dims 4, trans_dim 32, mlp_dim 64,
heads 4), dropout off, with the JAX params carried across by
interop.jax_weights: an IDT batch with a full, a partial and a unimodal
mask, with and without PASSION (atol 1e-4 on every loss column and on the
fused prediction). The patch is 32, not the fast tier's 16: at 16 the
bottleneck is one voxel, whose InstanceNorm is 0 whatever the
transformers compute, so neither they nor their dropout would be seen."""

import jax
import numpy as np
import pytest
import torch

from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch.interop.jax_weights import mmformer_from_jax_params
from passion_tpu_torch.models import get_model

torch.set_num_threads(2)
PATCH = 32
KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)
MASKS = np.array([[True, True, True, True],  # full
                  [True, False, True, False],  # partial
                  [False, False, False, True]])  # unimodal (T2)
KEYS = ("fuse_pred", "prm_loss", "sep_loss", "kl_loss", "proto_loss", "dist")


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, PATCH, PATCH, PATCH, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (3, PATCH, PATCH, PATCH))
    labels[:, :2] = np.arange(4).repeat(PATCH * PATCH * 2 // 4).reshape(
        2, PATCH, PATCH)  # every class in every sample
    target = np.eye(4, dtype=np.float32)[labels]
    return x, MASKS.copy(), target


@pytest.fixture(scope="module")
def setup():
    jm = jax_get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     batch_size=3, scale=0.3))
    tm = get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)
    return jm, params, tm


def _cf(a: np.ndarray) -> torch.Tensor:  # channels-last -> channels-first
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("use_passion", [True, False],
                         ids=["passion", "no_passion"])
def test_train_losses_match_jax(setup, use_passion):
    jm, params, tm = setup
    x, mask, target = _batch()
    ref = jax.jit(lambda p, x, m, t: jm.apply(
        p, x, m, t, 4.0, use_passion, method=type(jm).train_losses))(
            params, x, mask, target)
    with torch.no_grad():
        got = tm.train_losses(_cf(x), torch.from_numpy(mask), _cf(target),
                              temp=4.0, use_passion=use_passion)
    for k in KEYS:
        want = np.asarray(ref[k])
        have = got[k].numpy()
        if k == "fuse_pred":
            want = np.moveaxis(want, -1, 1)
        assert have.shape == want.shape, k
        np.testing.assert_allclose(have, want, atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    if use_passion:
        # the distillation lanes differ from the teacher, so the losses are
        # not trivially zero, and the unimodal sample's self-distance is 0
        assert np.abs(np.asarray(ref["kl_loss"])).max() > 1e-4
        assert got["dist"][2, 3] == 0 and np.asarray(ref["dist"])[2, 3] == 0
        assert (got["dist"][0] > 0).all()


def test_absent_modalities_carry_no_loss(setup):
    """IDT: the modal gate zeroes every column of an absent modality."""
    _, _, tm = setup
    x, mask, target = _batch(3)
    with torch.no_grad():
        got = tm.train_losses(_cf(x), torch.from_numpy(mask), _cf(target),
                              temp=4.0)
    absent = ~torch.from_numpy(mask)
    for k in ("sep_loss", "kl_loss", "proto_loss", "dist"):
        assert (got[k][absent] == 0).all(), k
        assert torch.isfinite(got[k]).all(), k


def test_dropout_only_with_a_generator(setup):
    """Dropout is off without a generator (the JAX deterministic=True) and
    on with one, repeatably for a seeded generator."""
    _, _, tm = setup
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
