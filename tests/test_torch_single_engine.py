"""The port's single-mask sliding-window engine against the JAX package's
`SlidingWindowInference`, float32 on the CPU at patch 16 and the fast-tier
widths, on small non-cubic volumes (one axis below the patch too):

  * coverage-averaged probabilities of `__call__` at 1e-4 and the labels
    of `infer_labels` equal, for mmFormer and RFNet, several masks;
  * `evaluator.test_dice_hd95_softmax`'s CSV rows against the JAX one's
    (1e-6) for a fixed mask;
  * `run_test_sweep` over an engine with only `infer_labels` writes the
    sweep engine's CSV byte for byte;
  * `make_engine` picks the sweep for a backbone with the features /
    fuse_inference split and the single-mask engine otherwise; chunking
    and the OOM halving are shared with the sweep.
"""

import csv
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passion_tpu.data.datasets import BratsTest as JaxBratsTest
from passion_tpu.data.loader import PrefetchLoader
from passion_tpu.engine import evaluator as jev
from passion_tpu.engine import sliding_window as jsw
from passion_tpu.masks import MASK_ARRAY
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch.data.datasets import TEST_TRANSFORMS, BratsTest, \
    CaseLoader
from passion_tpu_torch.data.synth import make_synthetic_dataset
from passion_tpu_torch.engine import evaluator as tev
from passion_tpu_torch.engine import sliding_window as tsw
from passion_tpu_torch.interop.jax_weights import from_jax_params
from passion_tpu_torch.models import get_model
from passion_tpu_torch.parallel.world import World

torch.set_num_threads(2)
PATCH = 16
KW = {"mmformer": dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4),
      "rfnet": dict(basic_dims=4)}


def _pair(name):
    jm = jax_get_model(name, mask_type="idt", patch_size=PATCH, **KW[name])
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     scale=0.3))
    tm = get_model(name, mask_type="idt", patch_size=PATCH, **KW[name])
    tm.load_state_dict(from_jax_params(params, name), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def mmformer():
    jm, params, tm = _pair("mmformer")
    jeng = jsw.SlidingWindowInference(jm.apply, 4, PATCH, window_batch=4,
                                      compute_dtype=jnp.float32)
    teng = tsw.SlidingWindowInference(tm, 4, PATCH, window_batch=4,
                                      compute_dtype=torch.float32,
                                      device="cpu")
    return jeng, params, teng, tm


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("single_engine_synth")
    make_synthetic_dataset(str(root), n_cases=6, shape=(24, 24, 20), seed=9)
    return str(root)


def _check(jeng, params, teng, vol, masks):
    for m in masks:
        ref = np.asarray(jeng(params, vol, m))
        got = teng(vol, m)
        assert got.shape == vol.shape[:3] + (4,) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
        lab = teng.infer_labels(teng.prepare(vol), m)
        assert lab.dtype == np.uint8 and lab.shape == vol.shape[:3]
        np.testing.assert_array_equal(
            lab, jeng.infer_labels(params, jeng.prepare(vol), m))
        np.testing.assert_array_equal(lab, got.argmax(-1))


@pytest.mark.parametrize("shape", [(24, 24, 20), (20, 14, 18)],
                         ids=["noncubic", "axis_below_patch"])
def test_mmformer_probabilities_and_labels_match_jax(mmformer, shape):
    jeng, params, teng, _ = mmformer
    vol = np.random.default_rng(3).standard_normal(shape + (4,)).astype(
        np.float32)
    _check(jeng, params, teng, vol, [MASK_ARRAY[i] for i in (14, 9, 3, 0)])


def test_rfnet_probabilities_and_labels_match_jax():
    jm, params, tm = _pair("rfnet")
    jeng = jsw.SlidingWindowInference(jm.apply, 4, PATCH, window_batch=3,
                                      compute_dtype=jnp.float32)
    teng = tsw.SlidingWindowInference(tm, 4, PATCH, window_batch=3,
                                      compute_dtype=torch.float32,
                                      device="cpu")
    vol = np.random.default_rng(5).standard_normal((24, 24, 20, 4)).astype(
        np.float32)
    _check(jeng, params, teng, vol, [MASK_ARRAY[i] for i in (14, 5)])


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_dice_hd95_softmax_rows_match_jax(mmformer, dataset, tmp_path):
    jeng, params, teng, _ = mmformer
    mask = MASK_ARRAY[12]
    jl = PrefetchLoader(JaxBratsTest(TEST_TRANSFORMS, root=dataset),
                        batch_size=1, shuffle=False, num_threads=1)
    jdice, jhd = jev.test_dice_hd95_softmax(
        jl, jeng, params, feature_mask=mask, mask_name="flairt1cet2",
        csv_name=str(tmp_path / "jax.csv"))
    dice, hd = tev.test_dice_hd95_softmax(
        CaseLoader(BratsTest(TEST_TRANSFORMS, root=dataset)), teng, mask,
        mask_name="flairt1cet2", csv_name=str(tmp_path / "port.csv"))
    ref, got = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "port.csv")
    assert len(got) == len(ref) == 2 and all(len(r) == 8 for r in got)
    np.testing.assert_allclose(np.float64(got), np.float64(ref), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(dice, jdice, atol=1e-6)
    np.testing.assert_allclose(hd, jhd, atol=1e-6)


def test_run_test_sweep_takes_an_infer_labels_engine(mmformer, dataset,
                                                      tmp_path):
    """An engine with only `prepare` and `infer_labels` (here the sweep's
    labels one mask at a time) gives the sweep's CSV byte for byte; the
    single-mask engine writes the same layout."""
    _, _, teng, tm = mmformer
    sweep = tsw.SlidingWindowSweep(tm, 4, PATCH, window_batch=4,
                                   compute_dtype=torch.float32, device="cpu")
    one_at_a_time = SimpleNamespace(
        prepare=sweep.prepare,
        infer_labels=lambda p, m: sweep.sweep_labels(p, [m])[0])
    loader = CaseLoader(BratsTest(TEST_TRANSFORMS, root=dataset))
    paths = {k: str(tmp_path / f"{k}.csv") for k in ("sweep", "one", "single")}
    tev.run_test_sweep(loader, sweep, csv_name=paths["sweep"])
    tev.run_test_sweep(loader, one_at_a_time, csv_name=paths["one"])
    tev.run_test_sweep(loader, teng, csv_name=paths["single"])
    with open(paths["sweep"], "rb") as a, open(paths["one"], "rb") as b:
        assert a.read() == b.read()
    single, ref = _rows(paths["single"]), _rows(paths["sweep"])
    assert len(single) == len(ref) == 1 + 15 * 3
    assert [r for r in single if len(r) < 8] == [r for r in ref if len(r) < 8]


class _ForwardOnly(torch.nn.Module):
    """A backbone without the features / fuse_inference split."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, mask):
        return self.net(x, mask)


def test_make_engine_picks_by_the_split(mmformer, caplog):
    _, _, _, tm = mmformer
    assert type(tsw.make_engine(tm, 4, PATCH, device="cpu")) is \
        tsw.SlidingWindowSweep
    plain = tsw.make_engine(_ForwardOnly(tm), 4, PATCH, device="cpu",
                            compute_dtype=torch.float32)
    assert type(plain) is tsw.SlidingWindowInference
    with caplog.at_level(logging.WARNING):
        one = tsw.make_engine(_ForwardOnly(tm), 4, PATCH,
                              world=World(0, 2, torch.device("cpu")),
                              compute_dtype=torch.float32)
    assert type(one) is tsw.SlidingWindowInference
    assert one.device == torch.device("cpu")
    assert "one device" in caplog.text
    vol = np.random.default_rng(6).standard_normal((24, 24, 20, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(plain.infer_labels(plain.prepare(vol),
                                                     MASK_ARRAY[7]),
                                  one.infer_labels(one.prepare(vol),
                                                   MASK_ARRAY[7]))


def test_chunking_does_not_change_probabilities(mmformer):
    """Auto window batch (one chunk of 8) against uneven chunks of 3."""
    _, _, _, tm = mmformer
    vol = np.random.default_rng(8).standard_normal((24, 24, 20, 4)).astype(
        np.float32)
    auto = tsw.SlidingWindowInference(tm, 4, PATCH,
                                      compute_dtype=torch.float32,
                                      device="cpu")
    threes = tsw.SlidingWindowInference(tm, 4, PATCH, window_batch=3,
                                        compute_dtype=torch.float32,
                                        device="cpu")
    assert auto.prepare(vol)["window_batch"] == 8
    torch.testing.assert_close(auto.run(auto.prepare(vol), MASK_ARRAY[4]),
                               threes.run(threes.prepare(vol), MASK_ARRAY[4]),
                               rtol=0, atol=1e-6)


def test_oom_halves_the_auto_window_batch(mmformer):
    _, _, teng, tm = mmformer
    auto = tsw.SlidingWindowInference(tm, 4, PATCH,
                                      compute_dtype=torch.float32,
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
    fixed = teng.prepare(np.zeros((24, 24, 20, 4), np.float32))

    def always_oom():
        raise torch.cuda.OutOfMemoryError("out of memory")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        teng._with_oom_fallback(fixed, always_oom)
    assert fixed["window_batch"] == 4
