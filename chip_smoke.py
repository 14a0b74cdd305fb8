#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`passion_tpu_torch`) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

  python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

  1. device header: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; no CUDA device -> fail;
  2. build: the CUDA kernels from the sources in the checkout (nvcc,
     sm_90a);
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes (75 windows), plus the large-mean case against float64;
  4. main path: the full-width mmFormer 15-mask sliding-window sweep of one
     240x240x155 case in bf16, with every kernel's launch count read
     around it; in that sweep, the first input of every distinct shape the
     model hands the norm is held against the plain version; the kernel
     path against the plain-norm path in float32 on two windows; encode /
     fuse / sweep times and peak memory;
  4b. profile: torch.profiler over one encode and one fuse pass of the
     same case, after the timed sweeps: device busy share and kernel time
     by name;
  5. entry point: `passion_tpu_torch.eval.main` on two synthetic cases;
  6. kernel timing at the largest main-path shape, beside the bandwidth
     bound, the plain version and one PyTorch library call; the timed
     outputs are held against the plain version.

TF32 stays at torch's default (as `passion_tpu_torch.eval` runs) except
around the float32 comparisons, where it is off.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Weights are random, drawn from a seed; the volume is seeded noise.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")  # listed in .gitignore
VOLUME = (240, 240, 155)  # one BraTS case
WINDOWS = 75  # windows of 80^3 in VOLUME: one chunk at the auto batch
TOP = 15  # kernels listed per traced phase (4b)
NORM_KERNELS = ("stats_partial_kernel", "stats_merge_kernel", "apply_kernel")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
OPS_PER_ELEMENT = 4  # K1: sub, add, fma (2); K2: sub, mul, compare, mul
NORM_SITES_ENCODE = 18  # instance_norm_lrelu calls per features() chunk
NORM_SITES_FUSE = 23  # ... per fuse_inference() chunk


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts(fn) -> None:
    fn.norm_stats.launches = 0
    fn.norm_apply.launches = 0


@contextlib.contextmanager
def plain_norm(fn):
    """Route the model's norm sites to the plain PyTorch version (the
    reference the kernel path is held against)."""
    saved = fn.instance_norm_lrelu
    fn.instance_norm_lrelu = fn.instance_norm_lrelu_plain
    try:
        yield
    finally:
        fn.instance_norm_lrelu = saved


@contextlib.contextmanager
def full_float32(torch):
    """TF32 off for convolutions and matmuls, restored afterwards: float32
    results are compared in full float32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def check_pair(torch, dtype, st_k, st_p, y_k, y_p) -> tuple[float, float]:
    """Hold K1's statistics and K2's output against the plain version's;
    return both max abs errors. Tolerances: statistics rtol 1e-4 / atol
    1e-5 (float32 sums in another order); outputs those of
    tests/test_ops.py (bf16 2e-2, float32 2e-5, rtol 1e-2: the plain
    version rounds to bf16 before its LeakyReLU, the kernel after)."""
    torch.cuda.synchronize()
    torch.testing.assert_close(st_k, st_p, rtol=1e-4, atol=1e-5)
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(y_k.float(), y_p.float(), rtol=1e-2,
                               atol=atol)
    return ((st_k - st_p).abs().max().item(),
            (y_k.float() - y_p.float()).abs().max().item())


@contextlib.contextmanager
def checked_norm(torch, fn, seen: dict):
    """Run the model's norm sites through K1 + K2 as usual, and hold the
    first input of every distinct (shape, dtype, phase_group) against the
    plain version on that same input. `seen` maps each key to [calls, K1
    err, K2 err]. Only the plain version is added: the launches are the
    model's own."""
    saved = fn.instance_norm_lrelu

    def checked(x, eps=1e-5, negative_slope=0.2, phase_group=1):
        stats = fn.norm_stats(x, eps, phase_group)
        y = fn.norm_apply(x, stats, negative_slope, phase_group)
        key = (tuple(x.shape), str(x.dtype)[6:], phase_group)
        if key in seen:
            seen[key][0] += 1
        else:
            st_p = fn.norm_stats_plain(x, eps, phase_group)
            y_p = fn.norm_apply_plain(x, st_p, negative_slope, phase_group)
            seen[key] = [1, *check_pair(torch, x.dtype, stats, st_p, y,
                                        y_p)]
        return y

    fn.instance_norm_lrelu = checked
    try:
        yield
    finally:
        fn.instance_norm_lrelu = saved


def phase_kernels(torch, fn):
    """Phase 3: K1/K2 against the plain version (tolerances in
    `check_pair`), at the main path's shapes and batch of windows."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [((WINDOWS, 32, 80, 80, 80), torch.bfloat16, 1),  # scale 1
             ((WINDOWS, 64, 40, 40, 40), torch.bfloat16, 1),  # scale 2
             ((WINDOWS, 128, 20, 20, 20), torch.bfloat16, 1),  # scale 3
             ((WINDOWS, 512, 5, 5, 5), torch.bfloat16, 1),  # RFM5, scalar
             ((2, 64, 20, 20, 20), torch.bfloat16, 8),  # phase_group 8
             ((2, 64, 8, 8, 8), torch.float32, 1)]
    err = {"K1": 0.0, "K2": 0.0}
    for shape, dt, pg in cases:
        x = (torch.randn(shape, generator=g, device="cuda") * 3 + 1).to(dt)
        st_k = fn.norm_stats(x, phase_group=pg)
        st_p = fn.norm_stats_plain(x, phase_group=pg)
        y_k = fn.norm_apply(x, st_k, phase_group=pg)
        y_p = fn.instance_norm_lrelu_plain(x, phase_group=pg)
        e1, e2 = check_pair(torch, dt, st_k, st_p, y_k, y_p)
        err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)
        log(f"  {tuple(shape)} {str(dt)[6:]} phase_group={pg}: "
            f"stats err {e1:.3g}, output err {e2:.3g}")
        del x, st_k, st_p, y_k, y_p
    # |mean| >> std (tests/test_ops.py:219-243): against float64 truth
    x64 = torch.randn((1, 128, 40, 40, 40), generator=g, device="cuda",
                      dtype=torch.float64) * 0.5 + 50.0
    m = x64.mean(dim=(2, 3, 4), keepdim=True)
    v = ((x64 - m) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    y64 = (x64 - m) / torch.sqrt(v + 1e-5)
    y64 = torch.where(y64 >= 0, y64, 0.2 * y64)
    with full_float32(torch):
        got = fn.instance_norm_lrelu(x64.float()).double()
        plain = fn.instance_norm_lrelu_plain(x64.float()).double()
    torch.testing.assert_close(got, y64, rtol=1e-4, atol=5e-5)
    log(f"  large mean (1, 128, 40^3) f32 vs float64: kernel err "
        f"{(got - y64).abs().max().item():.3g} (bound 5e-5), plain err "
        f"{(plain - y64).abs().max().item():.3g}")
    return err


def phase_main_path(torch, fn, card, err):
    """Phase 4: the full-width 15-mask sweep of one 240x240x155 case.
    Folds the on-path check's errors into `err`."""
    from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model

    model = init_model(get_model("mmformer"), seed=0)  # full width, patch 80
    vol = np.random.default_rng(0).standard_normal(VOLUME + (4,)).astype(
        np.float32)
    masks = [np.asarray(m) for m in MASK_ARRAY]
    engine = SlidingWindowSweep(model, num_cls=4, patch=80)
    prepared = engine.prepare(vol)
    n_win, wb = len(prepared["coords"]), prepared["window_batch"]
    log(f"  {n_win} windows of 80^3, window batch {wb}")
    if (n_win, wb) != (WINDOWS, WINDOWS):
        raise AssertionError(f"phase 3 checked batches of {WINDOWS} windows")

    seen = {}
    reset_counts(fn)
    t0 = time.perf_counter()
    with checked_norm(torch, fn, seen):
        labels = engine.sweep_labels(prepared, masks)
    first_s = time.perf_counter() - t0
    launches = {"K1": fn.norm_stats.launches, "K2": fn.norm_apply.launches}
    chunks = -(-n_win // prepared["window_batch"])
    expect = chunks * (NORM_SITES_ENCODE + 15 * NORM_SITES_FUSE)
    log(f"  first sweep (cuDNN set-up and the on-path check included) "
        f"{first_s:.3f} s; launches K1 {launches['K1']}, K2 "
        f"{launches['K2']} (expected {expect})")
    if launches != {"K1": expect, "K2": expect}:
        raise AssertionError(f"launches {launches}, expected {expect} each")
    log(f"  on-path check: {len(seen)} distinct norm inputs, each held "
        f"against the plain version on the sweep's own tensor:")
    for (shape, dt, pg), (calls, e1, e2) in seen.items():
        log(f"    {shape} {dt} phase_group={pg}: {calls} calls; stats err "
            f"{e1:.3g}, output err {e2:.3g}")
        err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)
    if sum(c for c, _, _ in seen.values()) != launches["K1"]:
        raise AssertionError("norm calls and K1 launches disagree")
    if len(labels) != 15:
        raise AssertionError(f"{len(labels)} label volumes, expected 15")
    for lab in labels:
        if lab.shape != VOLUME or lab.dtype != np.uint8 or lab.max() > 3:
            raise AssertionError(f"bad labels {lab.shape} {lab.dtype} "
                                 f"max {lab.max()}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    log(f"  labels: 15 x {VOLUME} uint8 in 0..3; class shares of the full "
        f"mask {np.bincount(labels[-1].ravel(), minlength=4) / labels[-1].size}")

    # times: host clock around synchronized work
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fts = engine.encode_case(prepared)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    fuse_ms = []
    for m in masks:
        t0 = time.perf_counter()
        engine._labels_device(prepared, fts, m)
        torch.cuda.synchronize()
        fuse_ms.append((time.perf_counter() - t0) * 1e3)
    del fts
    sweeps = []
    for _ in range(2):
        t0 = time.perf_counter()
        engine.sweep_labels(prepared, masks)
        sweeps.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = [15 / s for s in sweeps]
    log(f"  [{card}] encode {encode_ms:.1f} ms; fuse pass mean "
        f"{np.mean(fuse_ms):.1f} ms (min {min(fuse_ms):.1f}, max "
        f"{max(fuse_ms):.1f}); sweep {[round(s, 4) for s in sweeps]} s -> "
        f"{[round(r, 4) for r in rate]} mask-cases/s; peak memory "
        f"{peak_gib:.2f} GiB")

    # kernel path against the plain-norm path, float32 (TF32 off), on two
    # windows of this case, for one mask; and the sweep's premasked split
    # against the plain forward
    x = torch.stack([prepared["vol"][:, h:h + 80, w:w + 80, z:z + 80]
                     for h, w, z in prepared["coords"][:2].tolist()]).float()
    net = model.to("cuda", torch.float32).eval()
    mask = torch.as_tensor(MASK_ARRAY[10], device="cuda").expand(2, 4)
    with torch.inference_mode(), full_float32(torch):
        p_kernel = net.fuse_inference(net.features(x), mask)
        p_fwd = net(x, mask)
        with plain_norm(fn):
            p_plain = net.fuse_inference(net.features(x), mask)
    if not torch.isfinite(p_kernel).all():
        raise AssertionError("non-finite probabilities")
    torch.testing.assert_close(p_kernel, p_plain, rtol=0, atol=1e-4)
    torch.testing.assert_close(p_kernel, p_fwd, rtol=0, atol=1e-4)
    log(f"  float32, 2 windows, mask {MASK_ARRAY[10].astype(int)}: kernel vs "
        f"plain-norm probs max err "
        f"{(p_kernel - p_plain).abs().max().item():.3g}, fuse(features) vs "
        f"forward {(p_kernel - p_fwd).abs().max().item():.3g} (atol 1e-4)")
    return model, launches, engine, prepared


def _kernel_times(prof) -> dict[str, tuple[float, int]]:
    """{kernel name: (device ms, calls)} of a torch.profiler trace."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:  # older torch
            us = e.self_cuda_time_total
        out[e.key] = (us / 1e3, e.count)
    return out


def phase_profile(torch, engine, prepared, card):
    """Phase 4b: torch.profiler over one encode and one fuse pass of the
    main path's case, after its sweeps have set up cuDNN. For
    each: host-clock wall time, summed kernel time and their ratio (the
    device's busy share; the kernels run on one stream, so they do not
    overlap), the share of K1 + K2 and the kernels that take the most
    device time. Tracing is on only here, so no other phase pays for it."""
    from torch.profiler import ProfilerActivity, profile

    from passion_tpu_torch.masks import MASK_ARRAY

    mask = np.asarray(MASK_ARRAY[-1])
    fts = None
    for phase in ("encode", "fuse"):
        if phase == "fuse":
            fts = engine.encode_case(prepared)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "encode":
                engine.encode_case(prepared)
            else:
                engine._labels_device(prepared, fts, mask)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = _kernel_times(prof)
        busy = sum(ms for ms, _ in kernels.values())
        norm = sum(ms for k, (ms, _) in kernels.items()
                   if any(s in k for s in NORM_KERNELS))
        log(f"  [{card}] {phase}: wall {wall_ms:.3f} ms, kernels "
            f"{busy:.3f} ms (busy share {busy / wall_ms:.3f}); K1 + K2 "
            f"{norm:.3f} ms ({norm / max(busy, 1e-9):.3f} of kernel time)")
        for name, (ms, n) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])[:TOP]:
            log(f"    {ms:9.3f} ms {ms / max(busy, 1e-9):6.3f} x{n:<5d} "
                f"{name[:110]}")
    del fts


def phase_entry_point(torch, fn, model):
    """Phase 5: `python -m passion_tpu_torch.eval`'s main on 2 cases."""
    from passion_tpu_torch import eval as port_eval
    from passion_tpu_torch.data.synth import make_synthetic_dataset

    data, out = os.path.join(WORK, "data"), os.path.join(WORK, "out")
    make_synthetic_dataset(data, n_cases=6, shape=(96, 96, 80), seed=0)
    ckpt = os.path.join(WORK, "mmformer.pt")
    torch.save(model.state_dict(), ckpt)
    reset_counts(fn)
    port_eval.main(["--model", "mmformer", "--resume", ckpt, "--dataroot",
                    data, "--datapath", ".", "--savepath", out])
    launches = (fn.norm_stats.launches, fn.norm_apply.launches)
    with open(os.path.join(out, "mmformer.csv")) as f:
        rows = list(csv.reader(f))
    if rows[0][-1] != "ET HD95ETPro HD95" or len(rows) != 1 + 15 * 3:
        raise AssertionError(f"unexpected CSV layout: {len(rows)} rows")
    names = [r[0] for r in rows[1:] if len(r) == 1]
    scores = np.array([[float(v) for v in r] for r in rows[1:] if len(r) == 8])
    if len(names) != 15 or scores.shape != (30, 8) or not np.isfinite(
            scores).all():
        raise AssertionError(f"CSV: {len(names)} masks, scores "
                             f"{scores.shape}")
    if min(launches) <= 0:
        raise AssertionError(f"a kernel of the eval path never ran: "
                             f"{launches}")
    log(f"  eval CSV: 15 mask sections x 2 cases, finite scores; launches "
        f"K1 {launches[0]}, K2 {launches[1]}")


def phase_timing(torch, fn, err):
    """Phase 6: K1 and K2 at the hoisted scale-1 shape of the sweep; the
    timed outputs are held against the plain version's (errors folded into
    `err`)."""
    import torch.nn.functional as F

    shape = (WINDOWS, 32, 80, 80, 80)
    x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
    n = x.numel()
    rows = shape[0] * shape[1]
    stats = fn.norm_stats(x)
    k1 = cuda_ms(lambda: fn.norm_stats(x), 10)
    k2 = cuda_ms(lambda: fn.norm_apply(x, stats), 10)
    p1 = cuda_ms(lambda: fn.norm_stats_plain(x), 3, 1)
    p2 = cuda_ms(lambda: fn.norm_apply_plain(x, stats), 3, 1)
    e1, e2 = check_pair(torch, x.dtype, fn.norm_stats(x),
                        fn.norm_stats_plain(x), fn.norm_apply(x, stats),
                        fn.norm_apply_plain(x, stats))
    err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)
    log(f"  timed outputs vs plain: stats err {e1:.3g}, output err {e2:.3g}")
    xv = x.view(rows, -1)
    lib1 = cuda_ms(lambda: torch.var_mean(xv, dim=1, correction=0), 10)
    pair = cuda_ms(lambda: F.leaky_relu(F.instance_norm(x), 0.2), 5)
    # bound: the larger of the bytes (each input read once, each output
    # written once) over the memory rate and the float32 operations over
    # the card's float32 rate
    ops_ms = OPS_PER_ELEMENT * n / FP32_OPS_PER_S * 1e3
    bytes1 = (2 * n + 8 * rows) / HBM_BYTES_PER_S * 1e3
    bytes2 = (2 * 2 * n + 8 * rows) / HBM_BYTES_PER_S * 1e3
    b1, b2 = max(bytes1, ops_ms), max(bytes2, ops_ms)
    by1 = "bytes" if bytes1 >= ops_ms else "operations"
    by2 = "bytes" if bytes2 >= ops_ms else "operations"
    log(f"  {shape} bf16 ({n / 1e9:.3f} G elements): K1 {k1:.4f} ms (bound "
        f"{b1:.4f}), K2 {k2:.4f} ms (bound {b2:.4f}); plain {p1:.4f} / "
        f"{p2:.4f} ms; torch.var_mean {lib1:.4f} ms; F.instance_norm + "
        f"F.leaky_relu {pair:.4f} ms against K1+K2 {k1 + k2:.4f} ms")
    return dict(k1=k1, k2=k2, p1=p1, p2=p2, lib1=lib1, pair=pair, b1=b1,
                b2=b2, by1=by1, by2=by2)


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "passion_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the repo "
                         "(passion_tpu_torch/ not found beside it)")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    card = card_line()
    log(f"== 1. device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(card)

    from passion_tpu_torch.ops import _build
    from passion_tpu_torch.ops import fused_norm as fn

    log("== 2. build")
    t0 = time.perf_counter()
    _build.load()
    log(f"  {_build.library_path().name}: nvcc {_build.build_seconds:.2f} s, "
        f"load {time.perf_counter() - t0:.2f} s")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                       _build.build_log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill",
                                            _build.build_log))
    if regs:
        log(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {spills} bytes of spills")

    log("== 3. kernels vs plain version")
    errs = phase_kernels(torch, fn)
    log("== 4. main path: mmFormer 15-mask sweep, full width, bf16")
    model, launches, engine, prepared = phase_main_path(torch, fn, card,
                                                        errs)
    log("== 4b. profile: one encode and one fuse pass")
    phase_profile(torch, engine, prepared, card)
    del engine, prepared
    log("== 5. entry point: passion_tpu_torch.eval")
    phase_entry_point(torch, fn, model)
    log("== 6. kernel timing")
    t = phase_timing(torch, fn, errs)

    src = "passion_tpu_torch/csrc/fused_norm.cu"
    kernels = [
        dict(name="K1 instance_norm_lrelu stats", route="cuda", source=src,
             replaces="passion_tpu/ops/fused_norm.py:84",
             launches=launches["K1"], max_abs_err=errs["K1"], ms=t["k1"],
             plain_ms=t["p1"], bound_ms=t["b1"], bound_by=t["by1"],
             library_ms=t["lib1"]),
        dict(name="K2 instance_norm_lrelu apply", route="cuda", source=src,
             replaces="passion_tpu/ops/fused_norm.py:101",
             launches=launches["K2"], max_abs_err=errs["K2"], ms=t["k2"],
             plain_ms=t["p2"], bound_ms=t["b2"], bound_by=t["by2"],
             library_ms=None),
    ]
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                   "bound_ms")):
            raise AssertionError(f"non-finite timing in {k}")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
