"""The port's measurement entry points on the CPU: `passion_tpu_torch.flops`
(FLOP counts of the port's own programs), `passion_tpu_torch.bench` (its
refusal without a card, and its host-only loader mode) and
`passion_tpu_torch.profile` (the kernel table of a trace). Their device
modes run only on the card (chip_smoke.py phase 19)."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from passion_tpu_torch import bench, flops, profile
from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
from passion_tpu_torch.masks import MASK_ARRAY
from passion_tpu_torch.models import get_model, init_model
from passion_tpu_torch.models.layers import Conv3d, SelfAttention

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = 16
KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)


def test_grouped_conv_counts_its_true_work():
    """A groups=4 conv costs 2 x out elements x in-channels per group x
    kernel volume: 2 * 8^3 * 32 * 8 * 27, with the port's reflect padding
    counted as no work."""
    conv = Conv3d(32, 32, 3, groups=4)
    x = torch.zeros(1, 32, 8, 8, 8)
    assert flops.count(lambda: conv(x)) == 2 * 8 ** 3 * 32 * 8 * 27 == 7077888


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_conv_backward_counts_the_weight_gradient_once(groups):
    """Forward plus backward of a conv whose input needs a gradient is 3x
    its forward: the data and the weight gradient each equal the forward,
    whatever `groups` is (torch's own formula counts the weight gradient
    `groups` times)."""
    conv = Conv3d(32, 32, 3, groups=groups)
    x = torch.zeros(1, 32, 8, 8, 8, requires_grad=True)
    fwd = flops.count(lambda: conv(x))
    assert fwd == 2 * 8 ** 3 * 32 * (32 // groups) * 27
    assert flops.count(lambda: conv(x).sum().backward()) == 3 * fwd


def test_attention_counts_its_matmuls():
    """qkv (C -> 3C), q k^T and attn v over every head, and the projection:
    8 B N C^2 + 4 B N^2 C."""
    b, n, c = 2, 27, 32
    attn = SelfAttention(c, heads=4)
    x = torch.randn(b, n, c)
    assert flops.count(lambda: attn(x)) == 8 * b * n * c * c + 4 * b * n * n * c


@pytest.fixture(scope="module")
def engine_case():
    model = init_model(get_model("mmformer", patch_size=PATCH, **KW), seed=0)
    engine = SlidingWindowSweep(model, 4, PATCH, compute_dtype=torch.float32,
                                device="cpu")
    vol = np.random.default_rng(0).standard_normal((24, 20, 18, 4)).astype(
        np.float32)
    return model, engine, engine.prepare(vol)


def test_sweep_is_encode_plus_15_fuse_passes(engine_case):
    """The sweep's count is encode + 15 fuse passes, and equals the count
    of a whole `sweep_labels` run (the labels' argmax and copies add no
    FLOPs)."""
    _, engine, prepared = engine_case
    got = flops.sweep_flops(engine, prepared)
    assert got["windows"] == len(prepared["coords"]) == 8
    assert got["encode"] > 0 and got["fuse"] > 0
    assert got["sweep"] == got["encode"] + 15 * got["fuse"]
    masks = [np.asarray(m) for m in MASK_ARRAY]
    assert flops.count(lambda: engine.sweep_labels(prepared, masks)) == \
        got["sweep"]


def test_counting_leaves_the_output_alone(engine_case):
    model, engine, _ = engine_case
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 4, PATCH, PATCH, PATCH)).astype(np.float32))
    mask = torch.from_numpy(np.asarray(MASK_ARRAY[[3, 14]]))
    model.eval()
    with torch.no_grad():
        ref = model(x, mask)
        out = []
        n = flops.count(lambda: out.append(model(x, mask)))
    assert n > 0
    torch.testing.assert_close(out[0], ref, rtol=0, atol=0)
    assert flops.window_forward_flops(engine.model, PATCH) * 2 == n


def test_train_step_counts_forward_and_backward():
    """A train step's count holds its backward: more than twice the
    training forward's."""
    from passion_tpu_torch.engine.schedule import make_optimizer
    from passion_tpu_torch.engine.train_loop import make_train_step

    model = init_model(get_model("mmformer", patch_size=PATCH, **KW), seed=0)
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.standard_normal(
                 (1, 4) + (PATCH,) * 3).astype(np.float32)),
             "target": torch.from_numpy(np.moveaxis(np.eye(4, dtype=np.float32)[
                 rng.integers(0, 4, (1,) + (PATCH,) * 3)], -1, 1).copy()),
             "mask": torch.from_numpy(np.asarray(MASK_ARRAY[[9]]))}
    with torch.no_grad():
        fwd = flops.count(lambda: model.train_losses(
            batch["x"], batch["mask"], batch["target"], 4.0))
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-4),
                           use_passion=True, compute_dtype=None)
    ones = torch.ones(4)
    assert flops.count(lambda: step(batch, ones, ones, 4.0)) > 2 * fwd > 0


def _run(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("module", [("passion_tpu_torch.bench", "--sweep"),
                                    ("passion_tpu_torch.bench", "--eval_cli"),
                                    ("passion_tpu_torch.profile", "fuse")])
def test_device_modes_refuse_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(*module)
    assert out.returncode != 0
    assert out.stdout.strip() == ""  # no rate, no JSON
    assert "CUDA" in out.stderr


def test_loader_mode_runs_on_the_host(capsys):
    """`--loader` (bench_loader.py's measurement) at a small shape: one
    JSON line with bench_loader.py's fields and a positive rate."""
    assert bench.main(["--loader", "--loader_cases", "3", "--loader_iters",
                       "3", "--loader_threads", "2", "--loader_shape", "84",
                       "86", "82"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("metric", "aug_crops_per_sec", "unit", "volume_shape",
              "threads", "host_cores", "stage_full_np_load_s",
              "stage_one_item_s", "device_train_steps_per_sec",
              "keeps_device_busy"):
        assert k in row, k
    assert row["metric"] == "loader_throughput"
    assert row["aug_crops_per_sec"] > 0 and row["volume_shape"] == [84, 86,
                                                                    82]
    assert row["device_train_steps_per_sec"] is None  # no step was timed
    assert "chip" not in row and "value" not in row


def test_mode_flags_combine():
    args = bench.parse_args([])
    assert (args.sweep, args.train, args.single, args.loader) == (
        True, True, False, False)
    args = bench.parse_args(["--single", "--loader", "--model", "rfnet"])
    assert (args.sweep, args.train, args.single, args.loader,
            args.model) == (False, False, True, True, "rfnet")
    assert bench.PEAKS["NVIDIA H100 80GB HBM3"]["bf16"] == 989.4e12


def _event(key, ms, count, device=DeviceType.CUDA, **kw):
    return SimpleNamespace(key=key, device_type=device,
                           self_device_time_total=ms * 1e3, count=count, **kw)


def _chrome(tmp_path, kernels):
    """A chrome trace of `kernels` (ms each) on the device, beside host
    events and a range on the device timeline; returns its path."""
    events = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": 0,
               "dur": ms * 1e3} for i, ms in enumerate(kernels)]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": 0, "dur": 1},
               {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
                "ts": 0, "dur": 5e3},
               {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 0,
                "dur": 500}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_kernel_table_skips_ranges_and_host_ops(capsys):
    """Only device kernels count: the optimizer's range and user
    annotations sit on the device timeline over kernels already counted,
    and host ops are not kernels."""
    events = [
        _event("void stats_partial_kernel<bf16>", 1.0, 10),
        _event("void apply_kernel<bf16>", 2.0, 10),
        _event("cudnn_conv_kernel", 6.0, 3),
        _event("Optimizer.step#AdamWAMSGrad.step", 50.0, 1),
        _event("## fuse ##", 40.0, 1, is_user_annotation=True),
        _event("aten::conv3d", 30.0, 3, device=DeviceType.CPU),
    ]
    prof = SimpleNamespace(key_averages=lambda: events)
    assert profile.kernel_times(prof) == {
        "void stats_partial_kernel<bf16>": (1.0, 10),
        "void apply_kernel<bf16>": (2.0, 10), "cudnn_conv_kernel": (6.0, 3)}
    t = profile.report_trace(dict(prof=prof, wall_ms=18.0, event_ms=17.0,
                                  chrome_ms=9.0), "stub", "card", top=2)
    assert (t["busy_ms"], t["norm_ms"], t["calls"]) == (9.0, 3.0, 23)
    assert (t["chrome_ms"], t["event_ms"]) == (9.0, 17.0)
    assert [k for k, _ in t["top"]] == ["cudnn_conv_kernel",
                                        "void apply_kernel<bf16>"]
    lines = capsys.readouterr().out.splitlines()
    assert "busy share 0.500" in lines[0] and "23 kernel launches" in lines[0]
    assert len(lines) == 3


def test_kernel_table_reads_the_reflect_pad(capsys):
    """K6's launches (by its CUDA function's name) are the trace's pad
    time, apart from the norm kernels'."""
    events = [_event("void (anonymous namespace)::reflect_pad3d_kernel"
                     "<unsigned short>(...)", 1.5, 8),
              _event("void apply_kernel<bf16>", 2.0, 10),
              _event("cudnn_conv_kernel", 6.5, 3)]
    t = profile.report_trace(dict(
        prof=SimpleNamespace(key_averages=lambda: events), wall_ms=11.0,
        event_ms=10.5, chrome_ms=10.0), "stub", "card")
    assert (t["pad_ms"], t["norm_ms"], t["busy_ms"]) == (1.5, 2.0, 10.0)
    assert "reflect pad K6 1.500 ms (0.150)" in capsys.readouterr().out


@pytest.mark.parametrize("kernels,agrees", [
    ([1.0, 2.0, 5.5], True),  # 9.0 ms with the memset
    ([1.0, 2.0, 5.55], True),  # 0.6% more than the kernel table
    ([1.0, 2.0, 5.7], False),  # 2.2% more
])
def test_trace_checked_against_its_chrome_trace(tmp_path, kernels, agrees):
    """A chrome trace's device time counts kernels, copies and memsets,
    not host events or ranges; a trace is reported only if its kernel
    table agrees with that time within 1%."""
    ms = profile.chrome_device_ms(_chrome(tmp_path, kernels))
    assert ms == pytest.approx(sum(kernels) + 0.5)
    prof = SimpleNamespace(key_averages=lambda: [
        _event("k1", 1.0, 1), _event("k2", 2.0, 1), _event("k3", 6.0, 1)])
    t = dict(prof=prof, wall_ms=10.0, event_ms=9.5, chrome_ms=ms)
    if agrees:
        assert profile.report_trace(t, "stub", "card")["busy_ms"] == 9.0
    else:
        with pytest.raises(AssertionError, match="disagree"):
            profile.report_trace(t, "stub", "card")
