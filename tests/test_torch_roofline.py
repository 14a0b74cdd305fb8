"""`passion_tpu_torch.roofline` on the CPU: the byte rules of its counter,
the hand kernels' own bytes, counts of the port's programs by shapes
alone, the floor and share arithmetic, and the entry point's refusal
without a card. Its measurements run on the card (chip_smoke.py phases
19-20)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from passion_tpu_torch import bench, flops, roofline
from passion_tpu_torch.engine.schedule import make_optimizer
from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
from passion_tpu_torch.engine.train_loop import make_train_step
from passion_tpu_torch.masks import MASK_ARRAY
from passion_tpu_torch.models import get_model, init_model
from passion_tpu_torch.ops import fused_norm as fn

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_sweep_engine.py's mmFormer; patch 32 for the train step
KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)
F32 = 4  # bytes of a float32


def _rand(*shape):
    return torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32))


a, b, c = _rand(4, 5), _rand(4, 5), _rand(5)
x, w, bias = _rand(2, 3, 6, 6, 6), _rand(4, 3, 3, 3, 3), _rand(4)
m1, m2 = _rand(2, 3, 4), _rand(2, 4, 5)
h, gamma, beta = (_rand(*shape).bfloat16() for shape in ((2, 8, 16), (16,),
                                                         (16,)))
RULES = {
    # each input read once, each output written once
    "add": (lambda: a + b, 3 * 20 * F32),
    # in place: both inputs read, the output written once
    "add_": (lambda: a.clone().add_(b), (2 * 20 + 3 * 20) * F32),
    # out=: the destination is written, not read
    "add_out": (lambda: torch.add(a, b, out=torch.empty(4, 5)),
                3 * 20 * F32),
    # the source read, the destination written
    "copy_": (lambda: torch.empty(4, 5).copy_(a), 2 * 20 * F32),
    "view": (lambda: a.view(20).t(), 0),
    "as_strided": (lambda: a.as_strided((3, 3), (1, 1)), 0),
    "empty": (lambda: torch.empty(100), 0),
    # a fill reads only its input's shape
    "zeros_like": (lambda: torch.zeros_like(a), 20 * F32),
    # a broadcast input counts its distinct elements
    "broadcast": (lambda: a + c.expand(4, 5), (20 + 5 + 20) * F32),
    # input, weight, bias read, output written
    "conv3d": (lambda: F.conv3d(x, w, bias),
               (2 * 3 * 6 ** 3 + 4 * 3 * 27 + 4 + 2 * 4 * 4 ** 3) * F32),
    "matmul": (lambda: m1 @ m2, (2 * 3 * 4 + 2 * 4 * 5 + 2 * 3 * 5) * F32),
    # bf16 input, weight, bias read, output written; the (2, 8) mean and
    # rstd it saves count as float32, as the card keeps them
    "layer_norm_bf16": (lambda: F.layer_norm(h, (16,), gamma, beta),
                        2 * (256 + 16 + 16 + 256) + 2 * 16 * F32),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_byte_rules(rule):
    call, want = RULES[rule]
    got = roofline.count(call)
    assert got["bytes"] == want
    assert sum(got["by_op"].values()) == want


def _norm_calls(x, g):
    """{kernel: (wrapper, plain version, its reads, its writes)}."""
    st = fn.norm_stats_plain(x)
    bst = fn.norm_bwd_stats_plain(x, g, st)
    return {"K1 norm_stats": (fn.norm_stats, fn.norm_stats_plain, (x,),
                              [st]),
            "K2 norm_apply": (fn.norm_apply, fn.norm_apply_plain, (x, st),
                              [x]),
            "K3 norm_bwd_stats": (fn.norm_bwd_stats, fn.norm_bwd_stats_plain,
                                  (x, g, st), [st]),
            "K4 norm_bwd_apply": (fn.norm_bwd_apply, fn.norm_bwd_apply_plain,
                                  (x, g, st, bst), [x])}


@pytest.mark.parametrize("kernel", ["K1 norm_stats", "K2 norm_apply",
                                    "K3 norm_bwd_stats", "K4 norm_bwd_apply"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_wrappers_count_their_own_operands(kernel, dtype):
    """Each wrapper hands the counter its kernel's bytes (inputs read
    once, outputs written once; (rows, 2) float32 statistics); the plain
    version it runs on the CPU adds nothing, and the result is the plain
    version's."""
    x = (_rand(2, 8, 6, 6, 6) * 3 + 1).to(dtype)
    g = _rand(2, 8, 6, 6, 6).to(dtype)
    wrapper, plain, args, writes = _norm_calls(x, g)[kernel]
    out = []
    got = roofline.count(lambda: out.append(wrapper(*args)))
    want = sum(t.nbytes for t in list(args) + writes)
    assert got == {"flops": 0, "bytes": want, "by_op": {kernel: want}}
    torch.testing.assert_close(out[0], plain(*args), rtol=0, atol=0)
    assert fn.byte_counter is None
    assert all(wr.launches == 0 for wr in fn.WRAPPERS)


def test_fused_norm_under_autograd_counts_k1_to_k4():
    x = _rand(1, 8, 6, 6, 6).requires_grad_()
    got = roofline.count(lambda: fn.instance_norm_lrelu(x).sum().backward())
    n, s = x.nbytes, 2 * 8 * F32
    assert {k: v for k, v in got["by_op"].items() if k[0] == "K"} == {
        "K1 norm_stats": n + s, "K2 norm_apply": 2 * n + s,
        "K3 norm_bwd_stats": 2 * n + 2 * s, "K4 norm_bwd_apply": 3 * n + 2 * s}


def _sweep_counts(seed, patch=16):
    model = init_model(get_model("mmformer", patch_size=patch, **KW),
                       seed=seed)
    engine = SlidingWindowSweep(model, 4, patch, device="cpu")
    vol = np.random.default_rng(seed).standard_normal((24, 20, 18, 4))
    prepared = engine.prepare(vol.astype(np.float32))
    return engine, prepared, roofline.sweep_counts(engine, prepared)


def _step_counts(seed, patch=32):
    model = init_model(get_model("mmformer", patch_size=patch, **KW),
                       seed=seed)
    rng = np.random.default_rng(seed)
    batch = {"x": torch.from_numpy(rng.standard_normal(
                 (1, 4) + (patch,) * 3).astype(np.float32)),
             "target": torch.from_numpy(np.moveaxis(np.eye(
                 4, dtype=np.float32)[rng.integers(0, 4, (1,) + (patch,) * 3)],
                 -1, 1).copy()),
             "mask": torch.from_numpy(np.asarray(MASK_ARRAY[[9]]))}
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-4),
                           use_passion=True, with_dropout=True)
    ones, gen = torch.ones(4), torch.Generator().manual_seed(seed)
    step(batch, ones, ones, 4.0, gen)  # the optimizer's state
    call = lambda: step(batch, ones, ones, 4.0, gen)  # noqa: E731
    return call, roofline.count(call)


@pytest.fixture(scope="module")
def programs():
    """Counts of a small bf16 mmFormer's encode, fuse pass and train step
    under two seeds (weights and data)."""
    return [dict(**_sweep_counts(seed)[2], train=_step_counts(seed)[1])
            for seed in (0, 1)]


@pytest.mark.parametrize("program", ["encode", "fuse", "train"])
def test_counts_depend_on_shapes_alone(programs, program):
    one, two = programs[0][program], programs[1][program]
    assert one == two
    assert one["bytes"] > 0 and one["flops"] > 0
    assert sum(one["by_op"].values()) == one["bytes"]
    kernels = {k for k in one["by_op"] if k[0] == "K"}
    # K6 pads every input that needs no gradient: all of the sweep's, the
    # train step's raw images; the rest of the step pads under autograd
    assert kernels == ({"K1 norm_stats", "K2 norm_apply", "K6 reflect_pad3d"}
                       if program != "train" else
                       {"K1 norm_stats", "K2 norm_apply", "K3 norm_bwd_stats",
                        "K4 norm_bwd_apply", "K6 reflect_pad3d"})
    assert ("aten.reflection_pad3d" in one["by_op"]) == (program == "train")


def test_flops_equal_flops_count():
    engine, prepared, counted = _sweep_counts(0)
    fts = engine.encode_case(prepared)
    mask = np.ones(4, bool)
    assert counted["encode"]["flops"] == flops.count(
        lambda: engine.encode_case(prepared))
    assert counted["fuse"]["flops"] == flops.count(
        lambda: engine.labels_device(prepared, fts, mask)) == \
        flops.sweep_flops(engine, prepared)["fuse"]
    call, got = _step_counts(0)
    assert got["flops"] == flops.count(call)


H100 = bench.PEAKS["NVIDIA H100 80GB HBM3"]


def test_floor_share_and_ceiling():
    """t_comp = FLOPs / bf16 peak, t_mem = bytes / HBM rate, the larger
    binds; the share is the floor over the measured time, unclamped; the
    sweep's ceiling is 15 / (encode floor + 15 fuse floors)."""
    assert H100 == dict(bf16=989.4e12, fp32=67e12, hbm=3.35e12)
    enc = roofline.program_row(dict(flops=2e12, bytes=67e9), H100, 0.2, 0.19)
    assert enc["t_comp"] == pytest.approx(2e12 / 989.4e12)
    assert enc["t_mem"] == pytest.approx(0.02) and enc["bound"] == "mem"
    assert enc["pct_of_roofline"] == pytest.approx(10.0)
    assert (enc["tflop"], enc["gb"], enc["t_meas"], enc["t_best"]) == (
        2.0, 67.0, 0.2, 0.19)
    fuse = roofline.program_row(dict(flops=989.4e12, bytes=3.35e9), H100,
                                0.5, 0.5)
    assert fuse["bound"] == "comp" and fuse["pct_of_roofline"] == \
        pytest.approx(200.0)  # above 1: reported, not clamped
    floor, bound = roofline.sweep_floor(enc, fuse)
    assert floor == pytest.approx(0.02 + 15 * 1.0) and bound == "mixed"
    rates = roofline.sweep_rates(enc, fuse)
    assert rates["sweep_roofline_mask_cases_per_s"] == pytest.approx(
        15 / 15.02)
    assert rates["sweep_measured_serial_mask_cases_per_s"] == pytest.approx(
        15 / (0.2 + 15 * 0.5))
    assert roofline.sweep_floor(enc, enc) == (pytest.approx(0.32), "mem")


def test_unknown_card_gives_null_floors(capsys):
    assert bench.peaks_of("some other card") is None
    assert "some other card" in capsys.readouterr().err
    row = roofline.program_row(dict(flops=1e12, bytes=1e9), None, 0.1, 0.1)
    assert row["tflop"] == 1.0 and row["gb"] == 1.0
    assert all(row[k] is None for k in ("t_comp", "t_mem", "bound",
                                        "pct_of_roofline"))
    assert roofline.sweep_floor(row, row) == (None, None)
    assert roofline.sweep_rates(row, row)[
        "sweep_roofline_mask_cases_per_s"] is None


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "stub card"])
def test_entry_point_line(monkeypatch, capsys, kind):
    """The JSON line of `roofline sweep` with the sweep's measurement
    stubbed: roofline_sweep.py's fields, null floors on a card missing from
    the peak table."""
    def fake_sweep(name, reps, peaks=None):
        enc = dict(flops=1e12, bytes=6.7e9)
        fuse = dict(flops=0.5e12, bytes=3.35e9)
        return {"rows": dict(
            encode=roofline.program_row(enc, peaks, 0.2, 0.2),
            fuse_labels=roofline.program_row(fuse, peaks, 0.1, 0.09)),
            "by_op": dict(encode={"aten.reflection_pad3d": 3, "K1": 1},
                          fuse_labels={"aten.convolution": 1})}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: kind)
    monkeypatch.setattr(bench, "card_line", lambda: f"{kind}, 700.00 W")
    monkeypatch.setattr(bench, "bench_sweep", fake_sweep)
    assert roofline.main(["sweep", "--model", "rfnet"]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["chip"] == f"{kind}, 700.00 W" and line["model"] == "rfnet"
    for prog in ("encode", "fuse_labels"):
        assert set(line[prog]) == {"tflop", "gb", "t_comp", "t_mem", "bound",
                                   "t_meas", "t_best", "pct_of_roofline"}
    assert line["sweep_measured_serial_mask_cases_per_s"] == pytest.approx(
        15 / 1.7)
    assert line["bytes_by_op"]["encode"] == {"aten.reflection_pad3d": 3,
                                             "K1": 1}
    assert "encode: bytes by op: aten.reflection_pad3d 0.750, K1 0.250" in \
        out.out
    if kind == "stub card":
        assert line["encode"]["pct_of_roofline"] is None
        assert line["sweep_roofline_mask_cases_per_s"] is None
        assert "stub card" in out.err
    else:
        assert line["encode"]["bound"] == "mem"
        assert line["encode"]["pct_of_roofline"] == pytest.approx(1.0)
        assert line["sweep_roofline_mask_cases_per_s"] == pytest.approx(
            15 / 0.017)


def test_entry_point_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    out = subprocess.run([sys.executable, "-m", "passion_tpu_torch.roofline",
                          "sweep"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
