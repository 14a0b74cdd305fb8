"""The port's offline preprocessing (`passion_tpu_torch.data.preprocess`)
against the JAX package's (`passion_tpu.data.preprocess`), exactly: the
crop bounds, the z-score, the HG_/LG_ rename, the split lists, the NIfTI
conversion (through a stub `nibabel` in `sys.modules`: seeded int16
volumes and a seg holding label 4) and the `convert`, `split` and `imbmr`
subcommands of both CLIs, file for file and byte for byte."""

import filecmp
import os
import sys
import types

import numpy as np
import pytest

from passion_tpu.data import preprocess as jpre
from passion_tpu_torch.data import preprocess as tpre

CASES = ("BraTS20_Training_001", "BraTS20_Training_260",
         "BraTS20_Training_336")
RAW_SHAPE = (56, 48, 40)


def _same_tree(a, b):
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f
    return files


def _brain_volume(rng, shape, lo, size, dtype=np.int16):
    """(4, *shape) with a nonzero box of `size` at `lo` (per axis), zero
    elsewhere; each modality's box has its own scale and a few zeros."""
    vol = np.zeros((4,) + shape, dtype)
    box = tuple(slice(l, l + s) for l, s in zip(lo, size))
    for k in range(4):
        vals = rng.integers(0, 900 + 300 * k, size=size)
        vol[k][box] = vals.astype(dtype)
    return vol


@pytest.mark.parametrize("shape,lo,size,min_size", [
    ((160, 150, 140), (30, 41, 22), (70, 83, 95), 128),  # brain < 128
    ((160, 150, 140), (0, 2, 0), (60, 50, 77), 128),  # at the border
    ((160, 150, 140), (5, 10, 3), (140, 131, 128), 128),  # >= 128 already
    ((40, 36, 30), (3, 0, 9), (17, 11, 12), 24),
])
def test_crop_bounds_match_jax(shape, lo, size, min_size):
    vol = _brain_volume(np.random.default_rng(sum(lo)), shape, lo, size)
    got = tpre.crop_bounds(vol, min_size)
    assert got == jpre.crop_bounds(vol, min_size)
    for (a, b), extent in zip(got, size):
        assert a >= 0 and b - a >= min(min_size, extent)
    if lo[0] == 0:  # the lo < 0 shift of _sup_128
        assert got[0][0] == 0
    assert tpre._sup_128(-3, 5, 16) == jpre._sup_128(-3, 5, 16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalize_is_bit_identical(seed):
    rng = np.random.default_rng(seed)
    vol = _brain_volume(rng, (30, 28, 26), (4, 3, 5), (20, 21, 17))
    got, want = tpre.normalize(vol), jpre.normalize(vol)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    f64 = rng.standard_normal((4, 12, 10, 8))  # cast to float32 first
    f64[:, :2] = 0
    np.testing.assert_array_equal(tpre.normalize(f64), jpre.normalize(f64))


@pytest.mark.parametrize("num,prefix", [(1, "HG_"), (259, "HG_"),
                                        (260, "LG_"), (335, "LG_"),
                                        (336, "HG_")])
def test_case_prefix_matches_jax(num, prefix):
    name = f"BraTS20_Training_{num:03d}"
    assert tpre.case_prefix(name) == jpre.case_prefix(name) == prefix


@pytest.mark.parametrize("seed", [1037, 0, 7, 2024])
def test_split_dataset_matches_jax(tmp_path, seed):
    names = [f"HG_BraTS20_Training_{i:03d}" for i in range(1, 38)]
    got = tpre.split_dataset(names, str(tmp_path / "t"), seed=seed)
    want = jpre.split_dataset(names, str(tmp_path / "j"), seed=seed)
    assert got == want
    assert sorted(sum(got.values(), [])) == names
    assert [len(got[f]) for f in ("train.txt", "val.txt", "test.txt")] == [
        27, 3, 7]
    assert _same_tree(str(tmp_path / "t"), str(tmp_path / "j")) == [
        "test.txt", "train.txt", "val.txt"]


@pytest.fixture
def raw_cases(tmp_path, monkeypatch):
    """A raw BraTS tree of three cases read through a stub nibabel: the
    four modalities as seeded int16 volumes, the seg with labels 0, 1, 2,
    4."""
    src = tmp_path / "raw"
    data = {}
    for i, case in enumerate(CASES):
        (src / case).mkdir(parents=True)
        rng = np.random.default_rng(100 + i)
        lo = (3 + i, 5, 2 + 2 * i)
        size = (40 - 2 * i, 33, 30)
        vol = _brain_volume(rng, RAW_SHAPE, lo, size)
        for k, suf in enumerate(jpre.MODALITY_SUFFIXES):
            data[str(src / case / f"{case}_{suf}.nii.gz")] = vol[k]
        seg = np.zeros(RAW_SHAPE, np.int16)
        box = tuple(slice(l + 4, l + s - 4) for l, s in zip(lo, size))
        seg[box] = rng.choice(np.array([0, 1, 2, 4], np.int16),
                              size=seg[box].shape)
        data[str(src / case / f"{case}_seg.nii.gz")] = seg
    stub = types.ModuleType("nibabel")
    stub.load = lambda path: types.SimpleNamespace(dataobj=data[str(path)])
    monkeypatch.setitem(sys.modules, "nibabel", stub)
    return src


@pytest.mark.parametrize("min_size,rename", [(24, True), (128, True),
                                             (24, False)])
def test_convert_dataset_is_byte_identical(tmp_path, raw_cases, min_size,
                                           rename):
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    tpre.convert_dataset(str(raw_cases), t, rename=rename, min_size=min_size)
    jpre.convert_dataset(str(raw_cases), j, rename=rename, min_size=min_size)
    files = _same_tree(t, j)
    prefixes = ("HG_", "LG_", "HG_") if rename else ("", "", "")
    assert files == sorted(
        [f"seg/{p}{c}_seg.npy" for p, c in zip(prefixes, CASES)]
        + [f"vol/{p}{c}_vol.npy" for p, c in zip(prefixes, CASES)])
    for p, c in zip(prefixes, CASES):
        vol = np.load(os.path.join(t, "vol", f"{p}{c}_vol.npy"))
        seg = np.load(os.path.join(t, "seg", f"{p}{c}_seg.npy"))
        assert vol.dtype == np.float32 and vol.ndim == 4 and vol.shape[3] == 4
        assert seg.dtype == np.uint8 and seg.shape == vol.shape[:3]
        assert set(np.unique(seg)) == {0, 1, 2, 3}


def test_cli_subcommands_write_identical_files(tmp_path, raw_cases, capsys):
    """convert, split, then imbmr, through each package's `main`."""
    roots = {}
    for tag, mod in (("t", tpre), ("j", jpre)):
        root = str(tmp_path / tag)
        mod.main(["convert", "--src", str(raw_cases), "--dst", root,
                  "--min-size", "24"])
        mod.main(["split", "--npy-root", root, "--seed", "5"])
        mod.main(["imbmr", "--train-file", os.path.join(root, "train.txt"),
                  "--out-csv", os.path.join(root, "imb_split.csv"),
                  "--missing-probs", "0.3", "0.5", "0.1", "0.7",
                  "--seed", "11"])
        roots[tag] = root
    files = _same_tree(roots["t"], roots["j"])
    assert {"imb_split.csv", "train.txt", "val.txt", "test.txt"} <= set(files)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].startswith("present counts")
