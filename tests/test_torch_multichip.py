"""passion_tpu_torch.multichip on the CPU (gloo ranks), and the sharded
sweep it drives held against the JAX package:

  * `python -m passion_tpu_torch.multichip --device cpu --small --cards 2`
    end to end (mmFormer, every phase; run in this process, its ranks and
    CLIs are processes of their own): every check passes and the JSON line
    carries every result; `--cards 0`, a repeated count and more cards
    than are visible raise before anything starts;
  * the sharded float32 sweep on 4 gloo ranks of a (40, 24, 20) volume (16
    windows of 16^3) in chunks of 3 (6 chunks: ranks 0 and 1 hold two,
    rank 1's second the one-window tail, ranks 2 and 3 one) and in one
    chunk of 16 (ranks 1-3 hold none and still join every all-reduce). Labels
    against the JAX package's single-device `SlidingWindowSweep` on the
    same params (`init_params_host`, scale 0.3, carried across by
    `interop.jax_weights`), float32: equal except where JAX's top two
    probabilities are within 1e-4 (tests/test_torch_sweep.py's rule); every
    rank's probabilities against the port's one-process sweep, atol 1e-5;
  * the margin-aware label comparison of multichip's sweep check: float32
    sums in another order pass, a flipped voxel with a wide margin fails.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_ranks
from passion_tpu.engine import sliding_window as jsw
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch import multichip
from passion_tpu_torch.engine.sliding_window import (SlidingWindowSweep,
                                                     coverage_weight)
from passion_tpu_torch.interop.jax_weights import mmformer_from_jax_params
from passion_tpu_torch.masks import MASK_ARRAY
from passion_tpu_torch.parallel import world as pw

torch.set_num_threads(2)
PATCH = 16
KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)
MASKS = [np.asarray(m) for m in MASK_ARRAY[::3]]
VOLUME = (40, 24, 20)  # 4 x 2 x 2 windows of 16^3
CHUNKS = {3: [[3, 3], [3, 1], [3], [3]], 16: [[16], [], [], []]}


def test_small_run_on_two_ranks_passes_every_check(tmp_path, capsys):
    rc = multichip.main(["--cards", "2", "--models", "mmformer", "--device",
                         "cpu", "--small", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    row = json.loads(out.strip().splitlines()[-1])
    checks = [ln for ln in out.splitlines() if ln.startswith("check ")]
    assert rc == 0 and row["ok"] and row["failed"] == [], checks
    assert len(checks) == row["checks"] == 13
    assert all(": ok (" in ln for ln in checks)
    assert (row["device"], row["cards"], row["models"]) == (
        "cpu", [2], ["mmformer"])
    res = row["results"]["mmformer"]["2"]
    assert set(res) == {"step", "time", "sweep", "train_cli", "eval_cli"}
    step = res["step"]
    assert step["loss_rel"] <= 1e-5 and step["grad_rel_global"] <= 5e-3
    assert step["params_vs_rank0"] == [0.0, 0.0]
    assert step["launches"] == [dict.fromkeys(multichip.KERNELS, 0)] * 2
    t = res["time"]
    assert len(t["dp_median_ms"]) == len(t["allreduce_ms"]) == 2
    assert t["samples_per_s"] > 0 and t["scaling"] > 0
    assert t["n_params"] * 4 == round(t["allreduce_mb"] * 1e6)
    sweep = res["sweep"]
    assert sweep["chunks"] == [[4], [4]] and sweep["window_batch"] == 4
    assert sweep["max_abs_err"] <= 1e-5 and sweep["label_diff_wide"] == 0
    assert sweep["rate"] > 0 and sweep["rate_one"] > 0
    assert res["train_cli"] == dict(rc=0, seconds=res["train_cli"]["seconds"],
                                    csv_rows=46)
    ev = res["eval_cli"]
    assert ev["rc"] == 0 and ev["rows"] == ev["ref_rows"] == 46
    assert ev["differ"] == 0 and ev["rate"] > 0 and ev["one_rate"] > 0
    assert row["ranks"]["2"]["build_s"] == [0.0, 0.0]  # no kernel on the CPU


@pytest.mark.parametrize("cards", [["0"], ["2", "0"]])
def test_zero_cards_raise(cards):
    with pytest.raises(ValueError, match="1 or more"):
        multichip.main(["--cards", *cards, "--device", "cpu", "--small"])


def test_repeated_cards_raise(tmp_path):
    out = tmp_path / "out"
    with pytest.raises(ValueError, match="distinct"):
        multichip.main(["--cards", "2", "1", "2", "--device", "cpu",
                        "--small", "--out", str(out)])
    assert not out.exists()  # refused before any work


def test_more_cards_than_visible_raise():
    n = torch.cuda.device_count() + 1  # 1 where there is no card
    with pytest.raises(RuntimeError, match="visible"):
        multichip.main(["--cards", str(n)])


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """4 gloo ranks at window batches 3 and 16 (one launch), the JAX
    labels of the same params and volume, and the port's one-process
    engine."""
    out = tmp_path_factory.mktemp("sharded")
    jm = jax_get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     scale=0.3))
    torch.save(mmformer_from_jax_params(params), out / "state.pt")
    spec = dict(name="mmformer", patch=PATCH, kw=KW,
                state=str(out / "state.pt"))
    vol = np.random.default_rng(9).standard_normal(VOLUME + (4,)).astype(
        np.float32)
    np.save(out / "vol.npy", vol)
    failed = []

    def launch_ranks():  # beside the JAX sweep below
        try:
            pw.launch(torch_ranks.sweep_rank, 4, "cpu",
                      args=(str(out), spec, MASKS, list(CHUNKS)),
                      init_method=f"file://{out}/store", timeout_s=180,
                      threads=1)
        except Exception as e:  # noqa: BLE001 -- raised below
            failed.append(e)

    launch = threading.Thread(target=launch_ranks)
    launch.start()
    jax_engine = jsw.SlidingWindowSweep(jm, num_cls=4, patch=PATCH,
                                        window_batch=4,
                                        compute_dtype=jnp.float32)
    jprep = jax_engine.prepare(vol)
    jax_labels = jax_engine.sweep_labels(params, jprep, MASKS)
    launch.join(timeout=240)
    assert not launch.is_alive() and not failed, failed
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    one = SlidingWindowSweep(torch_ranks.build_model(spec), 4, PATCH,
                             compute_dtype=torch.float32, device="cpu")
    return dict(ranks=ranks, jax=(jax_engine, params, jprep, jax_labels),
                one=one, vol=vol)


@pytest.mark.parametrize("wb", list(CHUNKS))
def test_sharded_labels_match_the_jax_sweep(sharded, wb):
    jax_engine, params, jprep, jax_labels = sharded["jax"]
    assert [r[wb]["chunks"] for r in sharded["ranks"]] == CHUNKS[wb]
    for r in sharded["ranks"]:
        for m, got, ref in zip(MASKS, r[wb]["labels"], jax_labels):
            assert got.shape == VOLUME and got.dtype == np.uint8
            diff = got != ref
            if diff.any():
                probs = np.sort(np.asarray(jax_engine.run(params, jprep, m)),
                                axis=-1)
                gap = probs[..., -1] - probs[..., -2]
                assert (gap[diff] < 1e-4).all(), (
                    f"{diff.sum()} labels differ, gaps {gap[diff].max()}")
    assert len(np.unique(np.concatenate([v.ravel() for v in jax_labels]))) > 1


@pytest.mark.parametrize("wb", list(CHUNKS))
def test_sharded_probabilities_match_one_process(sharded, wb):
    one = sharded["one"]
    prepared = one.prepare(sharded["vol"])
    fts = one.encode_case(prepared)
    wgt = torch.from_numpy(coverage_weight(prepared["eff"], prepared["eff"],
                                           PATCH))
    for j, m in enumerate(MASKS):
        ref = one.sum_masked(prepared, fts, m) / wgt
        for r in sharded["ranks"]:
            torch.testing.assert_close(r[wb]["probs"][j], ref, rtol=0,
                                       atol=1e-5)


def _order_sums(rng, voxels=4096, windows=8):
    """Window scores of 4 classes summed in two orders (float32). At every
    tenth voxel classes 1 and 2 lead and hold the same values in reversed
    window order: their sums tie but for rounding, which the order moves."""
    p = rng.random((windows, 4, voxels)).astype(np.float32)
    p[:, 1, ::10] += 1.0
    p[:, 2, ::10] = p[::-1, 1, ::10]
    fwd, rev = np.zeros((4, voxels), np.float32), np.zeros((4, voxels),
                                                           np.float32)
    for w in range(windows):
        fwd += p[w]
        rev += p[windows - 1 - w]
    top2 = np.sort(fwd, axis=0)[-2:]
    return fwd.argmax(0), rev.argmax(0), top2[1] - top2[0]


def test_label_margin_passes_summation_order_and_fails_a_wide_flip():
    labels, ref, gap = _order_sums(np.random.default_rng(3))
    wide, narrow = multichip.label_diff(labels, ref, gap)
    assert wide == 0 and narrow > 0
    flipped = labels.copy()
    v = int(np.argmax(gap))  # the widest margin
    flipped[v] = (flipped[v] + 1) % 4
    assert multichip.label_diff(flipped, ref, gap) == (1, narrow)
    # the sweep check fails on it
    chk = multichip.Checks()
    res = dict(window_batch=4, chunks=[4], max_abs_err=0.0,
               label_diff_wide=1, label_diff_narrow=narrow, classes=4,
               launches=dict.fromkeys(multichip.KERNELS, 0), rate_one=[1.0],
               rate_dp=[1.0], one_window_batch=8, encode_ms=1.0,
               fuse_ms=1.0, allreduce_ms=1.0, allreduce_mb=1.0,
               peak_gib=None)
    multichip.judge_sweep(chk, "mmformer", 1, [{"sweep": res}], False, "cpu")
    assert chk.failed == ["mmformer x1 sweep labels"]
