"""The port's benchmark on the CPU: `BENCHMARK.json` itself, the FLOP
counts of `benchmark/counts.py` against `FlopCounterMode` over today's
program, and `benchmark/run.py --device cpu --small` for one cell of each
kind (its reference-vs-JAX half is tests/test_torch_benchmark_reference.py).

It also holds the pieces of the cells' checks on the CPU: the reference's
seeded weights equal the program's `init_model`, the eval CLI's
`SweepSpans` leave its CSV as it was and hand out the labels it scored,
the sweep check and the two-update check refuse a wrong program, the
bounds recompute a window rate from the pieces an older log kept, and the
readings of `benchmark/limits.py` straddle every limit.

The counts are held to `FlopCounterMode` within 1%: the sweep's encode and
fuse pass and one window's forward as it counts them, and the train step
with one formula of its replaced. `FlopCounterMode` counts a grouped conv's
weight gradient as `groups` times its forward (its `conv_backward_flop`
takes the input's full channel count); counts.py counts it equal to the
forward, as every other gradient. So the train step is held to
`FlopCounterMode` with that term divided by `groups`, which is what the
port's own counter (`passion_tpu_torch.flops.counter`) counts.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_backward_flop

from benchmark import bounds, cells, counts, run
from benchmark import reference as ref_pkg
from benchmark.reference.init import init_weights
from passion_tpu_torch import flops, roofline
from passion_tpu_torch.engine.schedule import make_optimizer
from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
from passion_tpu_torch.engine.train_loop import make_train_step
from passion_tpu_torch.models import get_model, init_model

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "benchmark", "run.py")
with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = {w["name"]: w for w in BENCH["workloads"]}
KW = {"mmformer": dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4),
      "rfnet": dict(basic_dims=4),
      "m2ftrans": dict(basic_dims=2, heads=4, mlp_dim=32, depth=2)}
NAMES = ("mmformer", "rfnet", "m2ftrans")


# --- BENCHMARK.json -------------------------------------------------------

def test_cells_and_configs():
    assert "benchmark/" in BENCH["paths"]
    assert set(CELLS) == {
        "sweep_mmformer_1c", "sweep_rfnet_1c", "sweep_m2ftrans_1c",
        "train_mmformer_1c", "train_rfnet_1c", "train_m2ftrans_1c",
        "evalcli_mmformer_1c", "sweep_m2ftrans_4c"}
    for w in BENCH["workloads"]:
        assert w["config"] in BENCH["configs"], w["name"]
        assert w["chips"] in (1, 4), w["name"]
        assert w["kind"] in cells.KINDS, w["name"]
        assert w["kind"] in BENCH["correctness"], w["name"]
        assert w["who"] and w["why"], w["name"]
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert four == ["sweep_m2ftrans_4c"]
    assert len(four) <= 0.25 * len(CELLS)
    for name, cfg in BENCH["configs"].items():
        assert cfg["reduced"] == [], name
        assert 0 < len(cfg["source"]) <= 200, name
        assert cfg["model"] in NAMES
        # the published widths: what get_model builds by default
        full = get_model(cfg["model"], **cfg["widths"])
        default = get_model(cfg["model"])
        assert [p.shape for p in full.parameters()] == [
            p.shape for p in default.parameters()], name


def test_metrics_name_existing_cells_and_bounds():
    names = [m["name"] for m in BENCH["metrics"]]
    assert len(names) == len(set(names))
    for m in BENCH["metrics"]:
        assert m["workloads"], m["name"]
        assert set(m["workloads"]) <= set(CELLS), m["name"]
        if m["kind"] == "end_to_end":
            assert set(m["bound"]) == set(m["workloads"]), m["name"]
            assert all(b >= 0.02 for b in m["bound"].values()), m["name"]
    for name, w in CELLS.items():
        for metric in w["metrics"]:
            spec = next(m for m in BENCH["metrics"] if m["name"] == metric)
            assert spec["kind"] == "end_to_end" and name in spec["workloads"]
    mfu = next(m for m in BENCH["metrics"] if m["name"] == "mfu")
    assert set(mfu["workloads"]) == set(CELLS)


# --- counts.py against FlopCounterMode ------------------------------------

def _patch(name):
    return 32 if name == "m2ftrans" else 16


def _model(name, patch):
    return init_model(get_model(name, patch_size=patch, **KW[name]), seed=0)


@pytest.mark.parametrize("name", NAMES)
def test_sweep_flops_equal_flop_counter(name):
    patch = _patch(name)
    shape = (patch + 8, patch + 4, patch + 2)
    got = counts.sweep_counts(name, shape, patch, torch.float32, KW[name])
    engine = SlidingWindowSweep(_model(name, patch), 4, patch,
                                compute_dtype=torch.float32, device="cpu")
    prepared = engine.prepare(np.random.default_rng(0).standard_normal(
        shape + (4,)).astype(np.float32))
    assert got["windows"] == len(prepared["coords"]) == 8
    want = roofline.sweep_counts(engine, prepared)
    for part in ("encode", "fuse"):
        assert got[part]["flops"] == pytest.approx(want[part]["flops"],
                                                   rel=1e-2), part
        # a floor of the blocks' traffic, below the op-by-op count
        assert 0 < got[part]["bytes"] < want[part]["bytes"], part
    one = counts.sweep_counts(name, (patch,) * 3, patch, torch.float32,
                              KW[name])
    window = flops.window_forward_flops(_model(name, patch), patch)
    assert one["encode"]["flops"] + one["fuse"]["flops"] == pytest.approx(
        window, rel=1e-2)


def _grouped_wgrad_once(*args, out_val=None, **kwargs):
    """FlopCounterMode's conv backward with the weight gradient counted
    once, not `groups` times."""
    args = list(args)
    mask, groups = args[10], args[9]
    args[10] = [mask[0], False]
    n = conv_backward_flop(*args, out_val=out_val)
    if mask[1]:
        args[10] = [False, True]
        n += conv_backward_flop(*args, out_val=out_val) // groups
    return n


_grouped_wgrad_once._get_raw = True


@pytest.mark.parametrize("name", NAMES)
def test_train_flops_equal_flop_counter(name):
    patch = 32
    model = _model(name, patch)
    step = make_train_step(model, make_optimizer(model.parameters()), True,
                           with_dropout=name != "rfnet",
                           compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 4, (1, patch, patch, patch))
    batch = {"x": torch.from_numpy(rng.standard_normal(
        (1, 4, patch, patch, patch)).astype(np.float32)),
             "target": torch.from_numpy(np.ascontiguousarray(np.moveaxis(
                 np.eye(4, dtype=np.float32)[lab], -1, 1))),
             "mask": torch.tensor([[True, False, True, True]])}
    ones = torch.ones(4)
    gen = torch.Generator().manual_seed(1)
    fixed = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _grouped_wgrad_once})
    fixed.mod_tracker = flops._NoModules()
    with fixed:
        step(batch, ones, ones, 4.0, gen, False)
    as_counted = roofline.count(lambda: step(batch, ones, ones, 4.0, gen,
                                             False))
    got = counts.train_counts(name, patch, 1, torch.bfloat16, KW[name])
    assert got["flops"] == pytest.approx(fixed.get_total_flops(), rel=1e-2)
    assert 0 < got["bytes"] < as_counted["bytes"]
    # the port's counter (roofline.count through flops.counter) counts
    # each weight gradient once, as `fixed` does, so it agrees with counts.py
    assert as_counted["flops"] == fixed.get_total_flops()
    assert as_counted["flops"] == pytest.approx(got["flops"], rel=1e-2)


def test_shares_use_the_card_peaks():
    s = counts.shares(989.4e12, 3.35e12, 2.0, "NVIDIA H100 80GB HBM3")
    assert s["mfu"] == pytest.approx(0.5)
    assert s["roofline"] == pytest.approx(0.5)
    assert counts.shares(1.0, 1e9, 1.0, "NVIDIA H100 80GB HBM3")[
        "bound"] == "bytes"
    assert counts.shares(1.0, 1.0, 1.0, "some other card")["mfu"] is None


# --- run.py on the CPU ----------------------------------------------------

def _run(*args, env_extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="2", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, RUN, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)


@pytest.mark.parametrize("cell", ["sweep_m2ftrans_1c", "train_rfnet_1c",
                                  "evalcli_mmformer_1c", "sweep_m2ftrans_4c"])
def test_small_cell_prints_every_declared_metric(cell, tmp_path):
    out = _run("--cell", cell, "--device", "cpu", "--small", "--out",
               str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["cell"] == cell and last["correct"] is True
    declared = {m["name"] for m in BENCH["metrics"]
                if cell in m["workloads"]}
    printed = {ln.split()[1] for ln in lines if ln.startswith("metric ")}
    assert declared <= printed and declared <= set(last["metrics"])
    assert any(ln.startswith("correct true ") for ln in lines)
    for name in CELLS[cell]["metrics"]:
        assert np.isfinite(last["metrics"][name]) and \
            last["metrics"][name] > 0
    for c in last["checks"].values():
        assert c["ok"] and np.isfinite(c["value"])


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run("--cell", "sweep_mmformer_1c")
    assert out.returncode != 0 and '"cell"' not in out.stdout
    out = _run("--cell", "sweep_mmformer_1c", "--device", "cpu")
    assert out.returncode != 0 and '"cell"' not in out.stdout


def test_a_failed_check_fails_the_run(tmp_path, monkeypatch):
    from benchmark import run

    bench = json.loads(json.dumps(BENCH))
    bench["correctness"]["train"]["loss_rtol"] = -1.0  # cannot hold
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    monkeypatch.setattr(run, "BENCHMARK", str(path))
    rc = run.main(["--cell", "train_mmformer_1c", "--device", "cpu",
                   "--small", "--out", str(tmp_path)])
    assert rc == 1


# --- the pieces of the checks ---------------------------------------------

def _cell(name, seed=0):
    args = argparse.Namespace(seed=seed, device="cpu", small=True,
                              out=os.path.join(REPO, "build", "benchmark"))
    return run.resolve(BENCH, name, args)


@pytest.mark.parametrize("name", NAMES)
def test_reference_weights_equal_the_program_init(name):
    patch = _patch(name)
    want = _model(name, patch).state_dict()
    got = init_weights(ref_pkg.get_model(name, patch_size=patch, **KW[name]),
                       seed=0).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_sweep_spans_leave_the_csv_and_hand_out_the_labels(tmp_path):
    from passion_tpu_torch.engine.evaluator import SweepSpans, run_test_sweep
    from passion_tpu_torch.masks import MASK_ARRAY

    engine = SlidingWindowSweep(_model("rfnet", 16), 4, 16,
                                compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(2)
    cases = [dict(x=rng.standard_normal((1, 20, 18, 16, 4)).astype(
        np.float32), target=rng.integers(0, 4, (1, 20, 18, 16)),
        name=[f"c{i}"]) for i in range(2)]
    run_test_sweep(cases, engine, csv_name=str(tmp_path / "plain.csv"))
    spans = SweepSpans(keep_labels=True)
    run_test_sweep(cases, engine, csv_name=str(tmp_path / "spans.csv"),
                   spans=spans)
    assert (tmp_path / "plain.csv").read_text() == \
        (tmp_path / "spans.csv").read_text()
    assert spans.first_dispatch is not None
    assert spans.sweep_s > 0 and spans.score_s > 0
    assert len(spans.labels) == 2
    for case, scored in zip(cases, spans.labels):
        want = engine.sweep_labels(engine.prepare(case["x"][0]),
                                   [np.asarray(m) for m in MASK_ARRAY[::-1]])
        assert len(scored) == 15
        for a, b in zip(scored, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,sound", [(0, True), (1, False)])
def test_sweep_check_refuses_other_weights(seed, sound):
    """The program's float32 sweep with the cell's weights passes the
    reference; with another seed's weights it fails both limits."""
    cell = _cell("sweep_rfnet_1c")
    masks = cells._masks()[::4]
    vol = cells.case_volume((24, 20, 18), 0)
    engine = SlidingWindowSweep(
        cells.program_model(cell, cells.seeded_weights(cell, seed)), 4,
        cell.patch, compute_dtype=torch.float32, device="cpu")
    prepared = engine.prepare(vol)
    probs_of = cells.program_probs(engine, prepared, masks)
    labels = engine.sweep_labels(prepared, masks)
    ref = cells.reference_model(cell, cells.seeded_weights(cell)).eval()
    got = cells.against_reference(ref, vol, masks, cell.patch, "cpu",
                                  probs_of, labels)
    ok = (got["probs_max_abs_err"] <= cell.limits["probs_atol"],
          got["labels_agree"] >= cells.label_limit(cell))
    assert ok == (sound, sound), got


@pytest.mark.parametrize("fault", [None, "no_decay", "one_update",
                                   "no_running_max"])
def test_update_check_refuses_optimizer_faults(fault):
    """Two updates of the program against the reference optimizer: sound
    within `update_rel`; a reference that decays no weight, stops after
    one update or keeps no running maximum lies outside it."""
    cell = _cell("train_rfnet_1c")
    lim = cell.limits
    weights = cells.seeded_weights(cell)
    batches = [cells.train_batch(cell), cells.train_batch(cell, 1)]
    got = cells.program_steps(cell, weights, batches,
                              lim["update_weight_decay"], torch.ones(4),
                              cell.traffic["temp"])
    lr, wd = cell.traffic["lr"], lim["update_weight_decay"]
    grads = got["grads"]
    if fault == "no_decay":
        wd = 0.0
    elif fault == "one_update":
        grads = grads[:1]
    want = cells.reference_updates(got["p0"], grads, lr, wd)
    if fault == "no_running_max":  # plain Adam: the second nu^ alone
        b1, b2 = 0.9, 0.999
        want = {}
        for n, p in got["p0"].items():
            p, (g1, g2) = p.double(), (grads[0][n].double(),
                                      grads[1][n].double())
            mu, nu = (1 - b1) * g1, (1 - b2) * g1 * g1
            p = p - lr * (mu / (1 - b1) / ((nu / (1 - b2)).sqrt() + 1e-8)
                          + wd * p)
            mu, nu = b1 * mu + (1 - b1) * g2, b2 * nu + (1 - b2) * g2 * g2
            want[n] = p - lr * (mu / (1 - b1 ** 2) / (
                (nu / (1 - b2 ** 2)).sqrt() + 1e-8) + wd * p)
    err, _ = cells.update_rel_err(got["p0"], got["after"], want)
    assert (err <= lim["update_rel"]) == (fault is None), err


def test_bounds_take_the_window_rate():
    old = dict(metrics=dict(mask_cases_per_s=9.0, steps_per_s=3.0),
               breakdown=dict(sweep_s=[1.0, 3.0], step_ms=[100.0, 300.0]))
    assert bounds.window_rate(old, "mask_cases_per_s") == 7.5
    assert bounds.window_rate(old, "steps_per_s") == 5.0
    new = dict(metrics=dict(mask_cases_per_s=9.0),
               breakdown=dict(sweep_s=[1.0, 3.0], window_s=4.0))
    assert bounds.window_rate(new, "mask_cases_per_s") == 9.0
    assert bounds.piece_rate(new, "mask_cases_per_s") == 7.5


def test_limits_lie_between_their_readings():
    """benchmark/limits.py at the small sizes: every limit refuses the
    control (a stand-in of lower precision) and passes the sound reading."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "limits.py"),
         "--device", "cpu", "--small", "--seeds", "0", "--models", "rfnet",
         "--kinds", "sweep", "train"], cwd=REPO, capture_output=True,
        text=True, timeout=900,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    readings = json.loads(out.stdout.strip().splitlines()[-1])["readings"]
    roles = {(r["kind"], r["name"], r["role"]) for r in readings}
    for kind, name in {(r["kind"], r["name"]) for r in readings}:
        limit = BENCH["correctness"][kind][name]
        if isinstance(limit, dict):
            limit = limit["rfnet"]
        low = name == "label_agreement"  # a least share, not a most error
        for r in readings:
            if (r["kind"], r["name"]) != (kind, name):
                continue
            passes = r["value"] >= limit if low else r["value"] <= limit
            assert passes == (r["role"] == "sound"), r
    assert ("train", "update_rel", "control") in roles
    assert ("sweep", "label_agreement", "control") in roles
