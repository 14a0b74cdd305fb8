"""Validation in the port against the JAX package's, float32 on the CPU at
patch 16 and the fast-tier widths (mmFormer basic_dims 4, trans_dim 32,
mlp_dim 64, heads 4; RFNet basic_dims 4), JAX params from
`init_params_host(scale=0.3)` carried across by `interop.jax_weights`:

  * `MASK_VALID_ARRAY`, `BratsVal` items and the loader's batches over it
    (equal, channels-first here);
  * `make_val_step` against the JAX val step (1e-4) and `run_validation`'s
    15 scores over two batches (1e-4); the 15 losses of a batch are read
    back as one tensor, at most VAL_RING batches behind;
  * `fit` with `use_valid`: the first validated epoch only sets the best
    score, `model_best.pt` is written when a later epoch beats it, and the
    TensorBoard tags of the 15 masks and `score_average`.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passion_tpu import masks as jmasks
from passion_tpu.config import train_transforms_for
from passion_tpu.data import datasets as jds
from passion_tpu.data import loader as jloader
from passion_tpu.engine import train_loop as jloop
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch import masks as tmasks
from passion_tpu_torch.data import datasets as tds
from passion_tpu_torch.data import loader as tloader
from passion_tpu_torch.data.synth import make_synthetic_dataset
from passion_tpu_torch.engine import checkpoint as ckpt
from passion_tpu_torch.engine import train_loop as tloop
from passion_tpu_torch.engine.tb_writer import TensorBoardWriter, read_scalars
from passion_tpu_torch.interop.jax_weights import from_jax_params
from passion_tpu_torch.models import get_model, init_model

torch.set_num_threads(2)
PATCH = 16
KW = {"mmformer": dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4),
      "rfnet": dict(basic_dims=4)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("val_synth"))
    make_synthetic_dataset(root, n_cases=8, shape=(24, 24, 20), seed=6)
    return root


def _pair(name):
    jm = jax_get_model(name, mask_type="idt", patch_size=PATCH, **KW[name])
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     batch_size=2, scale=0.3))
    tm = get_model(name, mask_type="idt", patch_size=PATCH, **KW[name])
    tm.load_state_dict(from_jax_params(params, name), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def mmformer():
    return _pair("mmformer")


def _loaders(root):
    spec = train_transforms_for(PATCH)
    jset = jds.BratsVal(spec, root=root)
    tset = tds.BratsVal(spec, root=root)
    return (jloader.PrefetchLoader(jset, batch_size=2, seed=3,
                                   num_threads=2),
            tloader.PrefetchLoader(tset, batch_size=2, seed=3,
                                   num_threads=2))


def test_mask_valid_array_matches_jax():
    np.testing.assert_array_equal(tmasks.MASK_VALID_ARRAY,
                                  jmasks.MASK_VALID_ARRAY)


def test_brats_val_items_match_jax(root):
    spec = train_transforms_for(PATCH)
    jset, tset = jds.BratsVal(spec, root=root), tds.BratsVal(spec, root=root)
    assert tset.names == jset.names and len(tset) == 2
    for i in range(len(tset)):
        j = jset.get(i, np.random.default_rng(10 + i))
        t = tset.get(i, np.random.default_rng(10 + i))
        assert t["name"] == j["name"]
        np.testing.assert_array_equal(t["mask"], j["mask"])
        np.testing.assert_array_equal(t["x"], np.moveaxis(j["x"], -1, 0))
        np.testing.assert_array_equal(t["target"],
                                      np.moveaxis(j["target"], -1, 0))
        assert any((t["mask"] == m).all() for m in tmasks.MASK_VALID_ARRAY)


def test_val_loader_batches_match_jax(root):
    jl, tl = _loaders(root)
    for _ in range(2):
        for jb, tb in zip(jl, tl, strict=True):
            assert tb["name"] == jb["name"]
            np.testing.assert_array_equal(tb["x"],
                                          np.moveaxis(jb["x"], -1, 1))


def _cf(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("name", ["mmformer", "rfnet"])
def test_val_step_matches_jax(mmformer, name):
    jm, params, tm = mmformer if name == "mmformer" else _pair(name)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, PATCH, PATCH, PATCH, 4)).astype(np.float32)
    target = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2,) + (PATCH,)
                                                      * 3)]
    jstep = jloop.make_val_step(jm, 4, compute_dtype=None)
    tstep = tloop.make_val_step(tm, 4, compute_dtype=None)
    for m in (jmasks.MASK_ARRAY[14], jmasks.MASK_ARRAY[6],
              jmasks.MASK_ARRAY[0]):
        mask = np.broadcast_to(m, (2, 4))
        ref = float(jstep(params, jnp.asarray(x), jnp.asarray(mask),
                          jnp.asarray(target), jnp.float32(4.0)))
        got = tstep(_cf(x), torch.from_numpy(mask.copy()), _cf(target), 4.0)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert not got.requires_grad
        np.testing.assert_allclose(got.item(), ref, rtol=1e-4)


def test_run_validation_matches_jax(root, mmformer):
    """Two batches of 2 under all 15 masks: the 15 scores at 1e-4."""
    jm, params, tm = mmformer
    jl, tl = _loaders(root)
    ref = jloop.run_validation(jloop.make_val_step(jm, 4, compute_dtype=None),
                               params, jl, 4.0)
    got = tloop.run_validation(tloop.make_val_step(tm, 4, compute_dtype=None),
                               tm, tl, 4.0)
    assert got.shape == (15,) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert (got < 0).all() and len(np.unique(got)) == 15


def test_run_validation_reads_a_batch_at_a_time(monkeypatch):
    """Batch k's 15 losses come back as one read, before batch
    k + VAL_RING is staged; `iters` caps the batches."""
    staged, reads = [], []
    batches = [dict(x=np.full((1, 4, 2, 2, 2), i, np.float32),
                    target=np.zeros((1, 4, 2, 2, 2), np.float32))
               for i in range(7)]

    def loader():
        for b in batches:
            staged.append(len(reads))
            yield b

    def read(t):
        reads.append(t.shape)
        return t.cpu().numpy().astype(np.float64)

    def val_step(x, mask, target, temp):
        return x[0, 0, 0, 0, 0] + mask.float().sum() / 10

    monkeypatch.setattr(tloop, "_losses_to_host", read)
    scores = tloop.run_validation(val_step, torch.nn.Linear(1, 1), loader(),
                                  4.0, iters=6)
    want = -np.array([sum(i + m.sum() / 10 for i in range(6))
                      for m in tmasks.MASK_ARRAY])
    np.testing.assert_allclose(scores, want, rtol=1e-6)
    assert reads == [(15,)] * 6
    # when batch k is staged, batches 0 .. k - VAL_RING have been read
    assert staged[:6] == [max(0, k - tloop.VAL_RING + 1) for k in range(6)]


def _tiny_fit(tmp_path, scores_by_epoch, monkeypatch, root):
    """`fit` for len(scores_by_epoch) epochs with validation on and the
    validation's average score forced to the given values."""
    seq = iter(scores_by_epoch)
    monkeypatch.setattr(tloop, "run_validation",
                        lambda *a, **k: np.full((15,), next(seq)))
    cfg = SimpleNamespace(
        lr=2e-4, weight_decay=1e-4, num_epochs=len(scores_by_epoch), temp=4.0,
        region_fusion_start_epoch=0, use_passion=True, mask_type="idt",
        savepath=str(tmp_path), seed=1, resume=None, use_pretrain=False,
        batch_size=1, iters_per_epoch=1, use_valid=True)
    spec = train_transforms_for(PATCH)
    train = tloader.PrefetchLoader(tds.BratsVal(spec, root=root),
                                   batch_size=1, seed=1, num_threads=1)
    model = get_model("mmformer", patch_size=PATCH, **KW["mmformer"])
    writer = TensorBoardWriter(str(tmp_path))
    try:
        tloop.fit(model, train, cfg, writer=writer, device="cpu",
                  val_loader=train)
    finally:
        writer.close()
    (events,) = os.listdir(tmp_path / "summary")
    return read_scalars(str(tmp_path / "summary" / events))


@pytest.mark.parametrize("scores,best_epoch", [([-5.0, -6.0], None),
                                               ([-5.0, -6.0, -4.0], 2)],
                         ids=["first_stays_best", "later_epoch_beats"])
def test_model_best_only_when_a_later_epoch_beats_the_first(
        tmp_path, monkeypatch, root, scores, best_epoch):
    rows = _tiny_fit(tmp_path, scores, monkeypatch, root)
    best = tmp_path / "model_best.pt"
    if best_epoch is None:
        assert not best.exists()
    else:
        assert ckpt.load_checkpoint(str(best))["epoch"] == best_epoch
    tags = {t for _, t, _ in rows}
    assert set(tmasks.MASK_NAMES) | {"score_average"} <= tags
    avg = sorted((s, v) for s, t, v in rows if t == "score_average")
    assert [v for _, v in avg] == scores


def test_fit_without_a_val_loader_skips_validation(tmp_path, monkeypatch,
                                                    root):
    monkeypatch.setattr(tloop, "run_validation", None)  # never called
    cfg = SimpleNamespace(
        lr=2e-4, weight_decay=1e-4, num_epochs=1, temp=4.0,
        region_fusion_start_epoch=0, use_passion=False, mask_type="idt",
        savepath=str(tmp_path), seed=1, resume=None, use_pretrain=False,
        batch_size=1, iters_per_epoch=1, use_valid=True)
    spec = train_transforms_for(PATCH)
    train = tloader.PrefetchLoader(tds.BratsVal(spec, root=root),
                                   batch_size=1, seed=1, num_threads=1)
    model = init_model(get_model("rfnet", **KW["rfnet"]), 0)
    _, _, history = tloop.fit(model, train, cfg, device="cpu")
    assert len(history) == 1 and not (tmp_path / "model_best.pt").exists()
