"""The port's training data path against the JAX package's, for the same
seeds: the synthetic dataset and its imbalanced-missing-rate CSV (byte for
byte), the augmentation pipeline, and the loader's batches over
BratsTrainIDT / BratsTrainPDT (the port's x and target are channels-first,
the JAX package's channels-last; otherwise equal)."""

import filecmp
import os

import numpy as np
import pytest

from passion_tpu import masks as jmasks
from passion_tpu.config import train_transforms_for
from passion_tpu.data import datasets as jds
from passion_tpu.data import loader as jloader
from passion_tpu.data import preprocess as jpre
from passion_tpu.data import synth as jsynth
from passion_tpu.data import transforms as jT
from passion_tpu_torch import masks as tmasks
from passion_tpu_torch.config import train_transforms_for as t_transforms_for
from passion_tpu_torch.data import datasets as tds
from passion_tpu_torch.data import loader as tloader
from passion_tpu_torch.data import preprocess as tpre
from passion_tpu_torch.data import synth as tsynth
from passion_tpu_torch.data import transforms as tT

SHAPE = (24, 24, 20)
PATCH = 16


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    jroot = str(tmp_path_factory.mktemp("jax_synth"))
    troot = str(tmp_path_factory.mktemp("port_synth"))
    jsynth.make_synthetic_dataset(jroot, n_cases=7, shape=SHAPE, seed=4)
    tsynth.make_synthetic_dataset(troot, n_cases=7, shape=SHAPE, seed=4)
    return jroot, troot


def test_synthetic_dataset_is_byte_identical(roots):
    jroot, troot = roots
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert "imb_split.csv" in files and len(files) == 2 * 7 + 4
    for f in files:
        assert filecmp.cmp(os.path.join(jroot, f), os.path.join(troot, f),
                           shallow=False), f


@pytest.mark.parametrize("p,seed", [((0.2, 0.4, 0.6, 0.8), 1037),
                                    ((0.5, 0.1, 0.9, 0.3), 3)])
def test_imb_mr_csv_matches_jax(tmp_path, p, seed):
    names = [f"case_{i:03d}" for i in range(40)]
    jc = jpre.generate_imb_mr(names, str(tmp_path / "j.csv"), p=p, seed=seed)
    tc = tpre.generate_imb_mr(names, str(tmp_path / "t.csv"), p=p,
                              seed=seed)
    np.testing.assert_array_equal(tc, jc)
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv"
                                                 ).read_bytes()


def test_sub_combination_ids_match_jax():
    for row in tmasks.MASK_ARRAY:
        assert tmasks.sub_combination_ids(row) == jmasks.sub_combination_ids(
            row)


def test_train_pipeline_matches_jax():
    """The reference train pipeline (RandCrop3D, RandomRotion(10),
    RandomIntensityChange, RandomFlip, NumpyType) on the same arrays with
    the same generator."""
    spec = train_transforms_for(PATCH)
    assert t_transforms_for(PATCH) == spec
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1,) + SHAPE + (4,)).astype(np.float32)
    y = rng.integers(0, 4, (1,) + SHAPE).astype(np.uint8)
    for seed in range(4):
        jx, jy = jT.from_string(spec)([x, y], np.random.default_rng(seed))
        tx, ty = tT.from_string(spec)([x, y], np.random.default_rng(seed))
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tx.shape == (1, PATCH, PATCH, PATCH, 4) and ty.dtype == np.int64
    with pytest.raises(Exception):
        tT.from_string("__import__('os')")


@pytest.mark.parametrize("mask_type", ["idt", "idt_drop", "pdt"])
def test_loader_batches_match_jax(roots, mask_type):
    jroot, troot = roots
    spec = train_transforms_for(PATCH)
    csv = "imb_split.csv"
    jset = jds.BratsTrainIDT(spec, root=jroot, mask_type=mask_type,
                             train_file=os.path.join(jroot, csv))
    tset = tds.BratsTrainIDT(spec, root=troot, mask_type=mask_type,
                             train_file=os.path.join(troot, csv))
    np.testing.assert_array_equal(tset.modal_counts(), jset.modal_counts())
    jl = jloader.PrefetchLoader(jset, batch_size=2, seed=5, num_threads=2)
    tl = tloader.PrefetchLoader(tset, batch_size=2, seed=5, num_threads=2)
    assert len(tl) == len(jl) == 3
    for _ in range(2):  # two epochs: the order and the draws change
        for jb, tb in zip(jl, tl, strict=True):
            assert tb["name"] == jb["name"]
            np.testing.assert_array_equal(tb["mask"], jb["mask"])
            np.testing.assert_array_equal(tb["x"],
                                          np.moveaxis(jb["x"], -1, 1))
            np.testing.assert_array_equal(tb["target"],
                                          np.moveaxis(jb["target"], -1, 1))
            assert tb["x"].shape[1:] == (4, PATCH, PATCH, PATCH)
            assert tb["target"].dtype == np.float32


def test_pdt_dataset_matches_jax(roots):
    jroot, troot = roots
    spec = train_transforms_for(PATCH)
    jset = jds.BratsTrainPDT(spec, root=jroot)
    tset = tds.BratsTrainPDT(spec, root=troot)
    assert tset.names == jset.names
    for i in range(len(tset)):
        j = jset.get(i, np.random.default_rng(i))
        t = tset.get(i, np.random.default_rng(i))
        np.testing.assert_array_equal(t["mask"], j["mask"])
        np.testing.assert_array_equal(t["x"], np.moveaxis(j["x"], -1, 0))
        np.testing.assert_array_equal(t["target"],
                                      np.moveaxis(j["target"], -1, 0))
