#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`passion_tpu_torch`) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

  python3 chip_smoke.py
  python3 chip_smoke.py --k5 ROOT [ROOT ...]

The second form runs no phase: it times K5 (`ops.edt.edt_sq`) of the
checkout at each ROOT (this one is `.`; another, such as a `git archive`
of a parent commit, is any directory holding `passion_tpu_torch/`), each in
a process of its own and in the order given (parent, change, change,
parent, to compare two on one card), on the same seeded inputs: a speckled
batch of 15 240x240x155 volumes and one clean volume (`data.synth`), each
held to its plain version, then each shape's time as phase 6b takes it and
each kernel's launch by name. One JSON line a ROOT, then one with all.

Phases (each raises on failure; any failure exits non-zero):

  1. device header: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; no CUDA device -> fail;
  2. build: the CUDA kernels from the sources in the checkout (nvcc,
     sm_90a);
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes (75 windows), plus the large-mean case against float64;
  3c. K6, the reflect pad (`ops.pad.reflect_pad3d`), against its plain
     version bit for bit at the sweeps' pad inputs ((75, 32, 80^3), (75,
     16, 80^3), (75, 64, 40^3), (75, 512, 5^3) bf16), one float32 shape,
     axes shorter than the pad and float64 (a float64 train step's raw
     image); at the first five, K6, the plain
     version and `F.pad(mode="reflect")` timed as phase 6 times K1/K2,
     beside K6's byte bound;
  4. main path: the full-width mmFormer 15-mask sliding-window sweep of one
     240x240x155 case in bf16, with every kernel's launch count read
     around it (K1/K2 and K6 against the counts from the code,
     `multichip.PAD_SITES` for K6); in that sweep, the first input of
     every distinct shape the model hands the norm is held against the
     plain version; the kernel
     path against the plain-norm path in float32 on two windows; encode /
     fuse / sweep times and peak memory;
  4b. profile (`passion_tpu_torch.profile`): torch.profiler over one
     encode and one fuse pass of the same case, after the timed sweeps:
     device busy share and kernel time by name, beside CUDA events around
     the same call; the kernel table's sum must agree with the chrome
     trace within 1% and fill 0.9 of the time between the events; no pad
     kernel of torch's runs, and K6's share of a sweep's kernel time
     (one encode, 15 fuse passes) is printed;
  5. entry point: `passion_tpu_torch.eval.main` on 2 synthetic 240x240x155
     cases, timed end to end as `bench --eval_cli` times it (loading,
     staging, sweeps, Dice and HD95 scored on the card, CSV): mask-cases/s
     beside phase 4's engine rate; K5's launches in the run;
  6. kernel timing at the largest main-path shape, beside the bound (the
     bytes the wrapper hands `roofline.ByteCounter` over the card's HBM
     rate, or its float32 operations over the card's float32 rate: the
     table `bench.PEAKS`), the plain version and one PyTorch library
     call, each the median of launches queued behind a device-side wait
     and timed one by one (`kernel_ms`); the timed outputs are held
     against the plain version;
  6b. K5, the distance transform of HD95 (`ops.edt.edt_sq`): against its
     plain version at small shapes and at the main path's (phase 4's 15
     label volumes, one target), and against scipy's
     `distance_transform_edt` on a speckled and a clean 240x240x155
     volume, exactly; `metrics.score_masks` on the 15 masks against
     `dice_class4` (bit for bit) and `cal_hd95` (1e-9); K5's time at 15
     volumes and at one beside its bound, the plain version's and scipy's
     for one volume on the host; each of K5's two launches (pass A: the
     border, Z and W; pass B: H) timed by kernel name through
     torch.profiler at both shapes, beside the bytes a voxel it moves
     through device memory (in a process of its own, `--k5-one`, on the
     same batch and volume, whose passes must sum to within 10% of this
     phase's time); each K5 kernel's registers and shared memory
     (ptxas `-v` in the build's log, and the launch's dynamic share);
  10, 11. phases 4, 4b and 5 for RFNet (10, 10b, 10c) and M2FTrans (11,
     11b, 11c) at their published widths: each sweep's K1/K2 launches,
     every distinct norm input held against the plain version, the window
     batch held at 75 (no out-of-memory fallback), the float32 check,
     times, a trace, the eval CLI with `--model` on two small cases.

  Training (the sweeps' tensors are freed first):

  3b. backward kernels K3/K4 vs their plain version at the training
     step's shapes, bf16 and float32, the large-mean case against float64,
     and the autograd Function's gradient against autograd of the plain
     forward;
  7. main path: the full-width mmFormer PASSION train step (bs 1, 80^3
     crop of seeded noise, one-hot labels, mask [T, F, T, T], bf16 over
     float32 master params, dropout on): untimed steps, then timed steps
     with K1-K4's launches read around them; steps/s and peak memory;
     one float32 step (TF32 off) on the kernel path and on the plain-norm
     path, loss, gradients and updated params held together;
  7b. profile: torch.profiler over one train step: device busy share and
     kernel time by name;
  8. entry point: `passion_tpu_torch.train.main` on synthetic cases at
     full width, 1 epoch x 2 iterations, then `--resume` for epoch 2;
  9. K3/K4 timing at the largest training shape, beside the bandwidth
     bound, the plain version and the library's backward (as phase 6);
  12, 13. phases 7, 7b and 8 for RFNet (12, 12b, 12c; no dropout) and
     M2FTrans (13, 13b, 13c): K1-K4 launches per step, steps/s, peak
     memory, the float32 kernel-vs-plain-norm step, a trace, the train CLI
     with `--model` for 1 epoch x 2 iterations.

  Validation, the single-mask engine and data parallelism (mmFormer):

  14. the single-mask engine (`SlidingWindowInference`, the whole forward
     per chunk) on the phase-4 case under the full mask, bf16, 75 windows:
     K1/K2 launches against the count from the code, every distinct norm
     input held against the plain version, its labels against the sweep
     engine's (share of voxels that differ printed: two bf16 graphs), the
     float32 kernel-vs-plain-norm check on two windows, cases/s over 3
     runs, peak memory;
  15. validation: `make_val_step` on one full-width batch (bs 1, 80^3)
     under all 15 masks (K1/K2 per mask, no K3/K4, every distinct norm
     input held against the plain version, ms per batch), then the train
     CLI with `--use_valid` (2 epochs x 2 iterations): the 15 mask tags
     and `score_average` in TensorBoard, finite;
  16. data parallelism at world size 1 over NCCL (a process group of this
     process): the data-parallel float32 step against the one-process
     step (loss rtol 1e-5, gradients at phase 7's tolerances); the bf16
     one-process and data-parallel steps timed in turn (one, dp, dp, one,
     four times over),
     the data-parallel step's launches, and one traced step of each with
     the kernels whose counts differ; the sharded sweep's labels against
     phase 4's; and the train CLI with `--data_parallel 1` (and 2 where
     two cards are visible);
  16b. `python -m passion_tpu_torch.multichip` in a process of its own,
     its ranks spawned and joined over NCCL: with one visible card
     `--cards 1 --models mmformer --phases step sweep` (the float32
     data-parallel step against one process, the sharded sweep against one
     card; phase 16 times the bf16 steps at world size 1, phases 5, 8 and
     16 run the CLIs),
     with two or more `--cards min(count, 4)` for every backbone and
     phase; every check must pass.

  Reference checkpoints and preprocessing:

  17. for each backbone at its published width, an upstream-format
     checkpoint (`{epoch, state_dict, optim_dict}`, `module.` prefix;
     seeded normal values, scale 0.02) built from the converter's table
     read backwards, loaded by `load_torch_checkpoint` and the backbone's
     `*_params_from_torch` strictly into a model on the card, each port
     tensor equal to its upstream slice(s); then mmFormer's phase-4 sweep
     under those weights (363 K1/K2 launches, every distinct norm input
     held against the plain version, the float32 check, mask-cases/s), and
     one encode and one fuse pass each for RFNet and M2FTrans;
  18. `python -m passion_tpu_torch.data.preprocess split` and `imbmr` on
     phase 8's npy root: the lists equal `split_dataset`'s, the CSV equals
     `generate_imb_mr`'s byte for byte (host only).

  Measurement entry points:

  19. `python -m passion_tpu_torch.bench` (mmFormer: sweep, train, single
     and loader at a few reps) in a process of its own: every rate finite
     and positive, `mfu_sweep` and `mfu_train` in (0, 1), the `bytes_*`
     positive, `roofline_sweep` and `roofline_train` in (0, 1.05] with
     their `bound_*`, one window's forward FLOPs beside bench.py's XLA
     count of the TPU program; then `python -m passion_tpu_torch.profile
     fuse --model rfnet`: its trace file and kernel table;
  20. `python -m passion_tpu_torch.roofline sweep --model rfnet` and
     `roofline train --model m2ftrans` (each backbone has a row across
     19-20), every program's share in (0, 105]% with its bound; then a
     small mmFormer (patch 32, basic_dims 4) counted on the card through
     K1-K4 and on the CPU through the plain versions: one encode, one fuse
     pass and one train step, the bytes and FLOPs equal op by op.

The kernels' JSON lists each kernel's launches on every path
(`launches_by_path`: one sweep and the timed train steps of each
backbone; phase 14's single-mask run, phase 15's 15-mask validation
batch, phase 16's timed data-parallel steps and sharded sweep, rank 0's
float32 step and sharded sweep in phase 16b (`multichip_step:{name}`,
`multichip_sweep:{name}`, counted in that rank's process), phase 17's
run of each backbone under imported weights, `import:{name}`);
`launches` is mmFormer's, the first main path. K6's entry adds its time
at each timed shape (`by_shape`) and its share of each sweep's kernel
time in phases 4b, 10b, 11b (`sweep_kernel_share`). K5's entry counts its
launches in the three eval CLI runs (`eval_cli:{name}`; `launches` and
`launches_per_case` are phase 5's) and adds its time at one volume beside
scipy's (`scipy_ms_one_volume`), the 15-mask scorer's, each pass's time
(`passes_ms`, `passes_ms_one_volume`), bytes a voxel and ptxas reading.
TF32 stays at torch's default (as `passion_tpu_torch.eval` and `.train`
run) except around the float32 comparisons, where it is off.
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
# phase 5: synthetic 240x240x155 cases through the eval CLI (scored on the
# card; two, so that the second case's sweep runs beside the first's
# scoring; `bench --eval_cli` times 4)
CLI_CASES = 2
# phase 19's bench: the modes and reps it runs (a few of each)
BENCH_ARGS = ("--sweep", "--train", "--single", "--loader", "--reps", "2",
              "--train_reps", "2", "--train_steps", "5", "--single_reps", "2",
              "--loader_cases", "4", "--loader_iters", "20")
# phases 4b, 10b, 11b: the least share of the time between CUDA events
# around an encode or a fuse pass that its trace's kernels must fill (the
# card is busy for 0.95-0.99 of it)
MIN_TRACED = 0.9
# phase 20: the roofline runs beside phase 19's mmFormer bench (a few reps)
ROOFLINE_RUNS = (("sweep", "rfnet", "--reps", "1"),
                 ("train", "m2ftrans", "--train_reps", "2", "--train_steps",
                  "5"))
# phase 20's small mmFormer (tests/test_sweep_engine.py's widths)
SMALL = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)
XLA_WINDOW_FLOPS = 71.33e9  # bench.py:49, the canonical TPU program's count
# cycles of torch.cuda._sleep per second: at least the SM clock of an H100
# (1.98 GHz at most), so a wait lasts at least as long as asked
SLEEP_CYCLES_PER_S = 2.0e9
OPS_PER_ELEMENT = 4  # K1: sub, add, fma (2); K2: sub, mul, compare, mul
# K3: sub, mul, round-compare, select-mul, add, fma; K4: those less the
# sums, plus sub, fma, mul
OPS_PER_ELEMENT_BWD = 8
# instance_norm_lrelu calls of each backbone, counted from the code: per
# features() chunk, per fuse_inference() chunk, and per PASSION train step
# (encoder + five-lane fuse path + four-modality sep decoder, each with one
# backward)
NORM_SITES = {
    "mmformer": dict(encode=18, fuse=23, train=14 + 27 + 12),
    "rfnet": dict(encode=12, fuse=49, train=12 + 49 + 9),
    "m2ftrans": dict(encode=15, fuse=28, train=15 + 28 + 12),
}
# mmFormer's forward (the single-mask engine, per chunk): the encoder's 14
# sites and the unpremasked fuse path's 27
FORWARD_SITES = 14 + 27
VAL_SITES = 14 + 27 + 12  # the training forward, one lane, no backward
BACKBONES = ("mmformer", "rfnet", "m2ftrans")
TRAIN_STEPS = 5  # timed full-width train steps (after 2 untimed ones)
DP_TURNS = 4  # phase 16: one, dp, dp, one timings of TRAIN_STEPS, repeated
KERNELS = ("K1", "K2", "K3", "K4")
COUNTED = KERNELS + ("K6",)  # the kernels `counts` reads
# phase 3c: K6's shapes (the sweeps' pad inputs at a window batch of 75,
# one float32 shape, axes shorter than the pad, float64 at the raw image
# of a train step, which `benchmark/limits.py` runs in float64), and the
# pad; the first five are timed
PAD_CASES = (((WINDOWS, 32, 80, 80, 80), "bfloat16", 1),
             ((WINDOWS, 16, 80, 80, 80), "bfloat16", 1),
             ((WINDOWS, 64, 40, 40, 40), "bfloat16", 1),
             ((WINDOWS, 512, 5, 5, 5), "bfloat16", 1),
             ((4, 32, 80, 80, 80), "float32", 1),
             ((1, 8, 1, 2, 3), "bfloat16", 1),
             ((2, 3, 1, 1, 1), "bfloat16", 1),
             ((2, 3, 1, 1, 1), "float32", 1),
             ((2, 3, 5, 4, 3), "bfloat16", 4),
             ((1, 4, 80, 80, 80), "float64", 1),
             ((2, 3, 1, 2, 3), "float64", 2))
PAD_TIMED = 5
# K5: the border test (seven label reads and compares, a ballot), the
# search of the Z row's border words (a few bit operations), and in each of
# the W and H envelopes a step of one lane (a compare, and for a parabola
# kept an exact division: a float estimate and multiply-compares) and four
# lanes' evaluations of (u - s)^2 + g with two shuffles' mins; counted at
# the float32 rate (the guide's table has no int32 rate)
K5_OPS_PER_VOXEL = 80
# K5's two passes: the bytes a voxel each moves through device memory (pass
# A reads the labels and writes int32; the planes h - 1 and h + 1 come from
# L2; pass B reads and writes the int32 in place)
K5_PASS_BYTES = {"edt_pass_a": 5, "edt_pass_b": 8}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of one call of `fn` over `reps` calls between two CUDA
    events: the device's time and any gaps the host leaves it."""
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


def kernel_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call of `fn`: the `reps` calls are queued
    behind a device-side wait (`torch.cuda._sleep`) that lasts twice their
    enqueue, each between its own pair of events, so time in which the
    host is still enqueuing does not count as the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * (2 * enqueue_s + 1e-3)))
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def kernel_bound(call, n_ops: float, peaks: dict) -> tuple[float, str]:
    """(ms, by) of a hand kernel's bound: the bytes its wrapper hands a
    `roofline.ByteCounter` (each input read once, each output written
    once) over the card's HBM rate, or its `n_ops` float32 operations over
    the card's float32 rate, whichever takes longer (`roofline.floor_s`,
    the programs' floors' formula)."""
    from passion_tpu_torch import roofline

    nbytes = roofline.count(call)["bytes"]
    t_comp, t_mem, bound = roofline.floor_s(n_ops, nbytes, peaks["fp32"],
                                            peaks["hbm"])
    return max(t_comp, t_mem) * 1e3, ("bytes" if bound == "mem"
                                      else "operations")


def device_kernels_ms(fn, reps: int) -> dict[str, float]:
    """{kernel name: device ms a call} over `reps` calls of `fn` under
    torch.profiler, as `profile.kernel_times` reads a trace: each kernel's
    mean over its own records times its launches a call (its records over
    `reps`, rounded), so that a record the tracer lost does not lower it.
    The session first traces one call it then drops (warm-up step), as
    `profile.trace` does: the tracer can lose a session's first device
    records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    out = {}
    for e in prof.key_averages():
        # the session's step ranges show on the device timeline too, over
        # the kernels: skip them
        if e.device_type != DeviceType.CUDA or e.count == 0 or getattr(
                e, "is_user_annotation", False) or e.key.startswith(
                    "ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:  # older torch
            us = e.self_cuda_time_total
        out[e.key] = us / 1e3 / e.count * max(1, round(e.count / reps))
    return out


def ptxas_kernels(build_log: str, part: str) -> dict[str, dict]:
    """{mangled kernel name: {registers, static_smem}} from `nvcc -Xptxas
    -v`'s output, for the kernels whose name holds `part`."""
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and part in name:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = dict(registers=int(m.group(1)),
                             static_smem=int(smem.group(1)) if smem else 0)
            name = None
    return out


def reset_counts(fn) -> None:
    from passion_tpu_torch.ops import pad

    for w in fn.WRAPPERS + (pad.reflect_pad3d,):
        w.launches = 0


def counts(fn) -> dict[str, int]:
    """Launch counts of K1-K4 (fn.WRAPPERS is in that order) and K6."""
    from passion_tpu_torch.ops import pad

    return {k: w.launches for k, w in zip(COUNTED, fn.WRAPPERS + (
        pad.reflect_pad3d,))}


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
             ((WINDOWS, 2, 80, 80, 80), torch.bfloat16, 1),  # RFNet PRM emb
             ((WINDOWS, 256, 10, 10, 10), torch.bfloat16, 1),  # RFNet 4th
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


def phase_pad(torch, peaks) -> dict:
    """Phase 3c: K6 (`ops.pad.reflect_pad3d`) against its plain version bit
    for bit (`torch.equal`: it is a copy) at PAD_CASES; then at the first
    PAD_TIMED shapes K6, the plain version and `F.pad(mode="reflect")`,
    each the median of launches queued behind a device-side wait
    (`kernel_ms`), beside K6's bound: x read and y written once (the bytes
    its wrapper hands `roofline.ByteCounter`) over the card's HBM rate."""
    import torch.nn.functional as F

    from passion_tpu_torch.ops import pad

    g = torch.Generator(device="cuda").manual_seed(6)
    rows, err = [], 0.0
    for i, (shape, dt, p) in enumerate(PAD_CASES):
        x = torch.randn(shape, generator=g, device="cuda").to(
            getattr(torch, dt))
        before = pad.reflect_pad3d.launches
        with torch.inference_mode():
            y = pad.reflect_pad3d(x, p)
            want = pad.reflect_pad3d_plain(x, p)
        torch.cuda.synchronize()
        if pad.reflect_pad3d.launches != before + 1:
            raise AssertionError("K6 did not launch")
        err = max(err, (y.float() - want.float()).abs().max().item())
        if not torch.equal(y, want):
            raise AssertionError(f"K6 differs from its plain version on "
                                 f"{shape} {dt} pad {p}: max {err}")
        line = f"  {shape} {dt} pad {p}: K6 equal to the plain version"
        if i < PAD_TIMED:
            with torch.inference_mode():
                ms = kernel_ms(lambda: pad.reflect_pad3d(x, p), 10)
                plain = kernel_ms(lambda: pad.reflect_pad3d_plain(x, p), 5)
                lib = kernel_ms(lambda: F.pad(x, (p,) * 6, mode="reflect"),
                                5)
                bound, by = kernel_bound(lambda: pad.reflect_pad3d(x, p), 0,
                                         peaks)
            rows.append(dict(shape=shape, dtype=dt, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bound, bound_by=by))
            line += (f"; K6 {ms:.4f} ms ({bound / ms:.3f} of its bound "
                     f"{bound:.4f} ms, {by}), plain {plain:.4f} ms, F.pad "
                     f"{lib:.4f} ms ({bound / lib:.3f} of the bound)")
        log(line)
        del x, y, want
    torch.cuda.empty_cache()
    return dict(rows[0], rows=rows, err=err)


def phase_main_path(torch, fn, card, err, name, model=None):
    """Phases 4, 10, 11 (and 17): the full-width 15-mask sweep of one
    240x240x155 case by backbone `name`, with `model`'s weights if given
    (else seed 0's). Folds the on-path check's errors into `err`; returns
    the model, the launches, the engine, the prepared case, the labels
    and the timed sweeps' mask-cases/s."""
    from passion_tpu_torch import bench
    from passion_tpu_torch.multichip import PAD_SITES
    from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model

    tag = name
    if model is None:
        model = init_model(get_model(name), seed=0)  # full width, patch 80
    else:
        tag = f"{name} (upstream checkpoint)"
    sites = NORM_SITES[name]
    vol = bench.volume()
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
    launches = counts(fn)
    chunks = -(-n_win // prepared["window_batch"])
    expect = chunks * (sites["encode"] + 15 * sites["fuse"])
    pads = chunks * (PAD_SITES[name]["encode"] +
                     15 * PAD_SITES[name]["fuse"])
    log(f"  first sweep (cuDNN set-up and the on-path check included) "
        f"{first_s:.3f} s; launches {launches} (expected {expect} of K1 "
        f"and K2, none of K3/K4, {pads} of K6)")
    if launches != {"K1": expect, "K2": expect, "K3": 0, "K4": 0,
                    "K6": pads}:
        raise AssertionError(f"launches {launches}, expected {expect} of "
                             f"K1 and K2, {pads} of K6")
    log(f"  on-path check: {len(seen)} distinct norm inputs, each held "
        f"against the plain version on the sweep's own tensor:")
    for (shape, dt, pg), (calls, e1, e2) in seen.items():
        log(f"    {shape} {dt} phase_group={pg}: {calls} calls; stats err "
            f"{e1:.3g}, output err {e2:.3g}")
        err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)
    if sum(c for c, _, _ in seen.values()) != launches["K1"]:
        raise AssertionError("norm calls and K1 launches disagree")
    if prepared["window_batch"] != WINDOWS:
        raise AssertionError(f"the sweep fell back to a window batch of "
                             f"{prepared['window_batch']} (out of memory)")
    if len(labels) != 15:
        raise AssertionError(f"{len(labels)} label volumes, expected 15")
    for lab in labels:
        if lab.shape != VOLUME or lab.dtype != np.uint8 or lab.max() > 3:
            raise AssertionError(f"bad labels {lab.shape} {lab.dtype} "
                                 f"max {lab.max()}")
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
        engine.labels_device(prepared, fts, m)
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
    if prepared["window_batch"] != WINDOWS:
        raise AssertionError("the timed sweeps fell back to a smaller "
                             "window batch (out of memory)")
    log(f"  [{card}] {tag}: encode {encode_ms:.1f} ms; fuse pass mean "
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
    del net, x, p_kernel, p_fwd, p_plain
    return model, launches, engine, prepared, labels, rate


def phase_profile(torch, engine, prepared, card, name):
    """Phases 4b, 10b, 11b: torch.profiler over one encode and one fuse
    pass of the sweep's case, after its sweeps have set up cuDNN. For
    each: host-clock wall time, summed kernel time and their ratio (the
    device's busy share; the kernels run on one stream, so they do not
    overlap), the share of K1 + K2 and the kernels that take the most
    device time (`passion_tpu_torch.profile`, which raises if the kernel
    table and the chrome trace disagree by more than 1%). The kernels must
    also fill MIN_TRACED of the time between CUDA events around the call:
    these programs keep the card busy, so a trace that lost kernels reads
    less. Tracing is on only here and in 7b, so no other phase pays for
    it. No pad kernel of torch's may run (K6 pads every input), and K6's
    share of a sweep's kernel time (one encode and 15 fuse passes) is
    returned."""
    from passion_tpu_torch import profile
    from passion_tpu_torch.masks import MASK_ARRAY

    def traced(prog, call):
        t = profile.report_trace(profile.trace(
            call, os.path.join(WORK, f"trace_{name}_{prog}.json")),
            f"{name} {prog}", card)
        if t["busy_ms"] < MIN_TRACED * t["event_ms"]:
            raise AssertionError(
                f"{name} {prog}: the trace holds {t['busy_ms']:.3f} ms of "
                f"kernels for {t['event_ms']:.3f} ms between CUDA events")
        torch_pads = [k for k in t["kernels"] if "reflection_pad" in k]
        if torch_pads or not t["pad_ms"]:
            raise AssertionError(f"{name} {prog}: K6 {t['pad_ms']} ms, "
                                 f"torch's pad kernels {torch_pads}")
        return t

    mask = np.asarray(MASK_ARRAY[-1])
    enc = traced("encode", lambda: engine.encode_case(prepared))
    fts = engine.encode_case(prepared)
    fuse = traced("fuse", lambda: engine.labels_device(prepared, fts, mask))
    del fts
    share = (enc["pad_ms"] + 15 * fuse["pad_ms"]) / (
        enc["busy_ms"] + 15 * fuse["busy_ms"])
    log(f"  K6 {enc['pad_ms']:.3f} ms of the encode's kernels, "
        f"{fuse['pad_ms']:.3f} ms of a fuse pass's: {share:.4f} of a "
        f"sweep's kernel time; no pad kernel of torch's")
    return share


def phase_entry_point(torch, fn, card, model, name, engine_rate=None):
    """Phases 5, 10c, 11c: `python -m passion_tpu_torch.eval --model name`.
    mmFormer (5, `engine_rate` given): `bench.bench_eval_cli`, the timing
    of `bench --eval_cli`, on CLI_CASES synthetic 240x240x155 cases, end to
    end (case loading, staging, the sweeps, Dice, HD95 and the CSV) beside
    the engine's rate of phase 4; RFNet and M2FTrans (10c, 11c): `model`
    on 2 small cases."""
    from passion_tpu_torch import bench
    from passion_tpu_torch import eval as port_eval
    from passion_tpu_torch.data.synth import make_synthetic_dataset
    from passion_tpu_torch.ops import edt

    from passion_tpu_torch.ops import pad

    out = os.path.join(WORK, f"out_{name}")
    timed = engine_rate is not None
    edt.edt_sq.launches = 0  # the CLI's scoring on the card (K5)
    pad.reflect_pad3d.launches = 0
    if timed:
        n_cases = CLI_CASES
        run = bench.bench_eval_cli(name, n_cases, out=out)
        launches = run["launches"][:2]
    else:
        data, n_cases = os.path.join(WORK, "data"), 2
        if not os.path.isdir(data):
            make_synthetic_dataset(data, n_cases=6, shape=(96, 96, 80),
                                   seed=0)
        ckpt = os.path.join(WORK, f"{name}.pt")
        torch.save(model.state_dict(), ckpt)
        reset_counts(fn)
        port_eval.main(["--model", name, "--resume", ckpt, "--dataroot",
                        data, "--datapath", ".", "--savepath", out])
        launches = (fn.norm_stats.launches, fn.norm_apply.launches)
    k5, k6 = edt.edt_sq.launches, pad.reflect_pad3d.launches
    with open(os.path.join(out, f"{name}.csv")) as f:
        rows = list(csv.reader(f))
    if rows[0][-1] != "ET HD95ETPro HD95" or len(rows) != 1 + 15 * (
            1 + n_cases):
        raise AssertionError(f"unexpected CSV layout: {len(rows)} rows")
    names = [r[0] for r in rows[1:] if len(r) == 1]
    scores = np.array([[float(v) for v in r] for r in rows[1:] if len(r) == 8])
    if len(names) != 15 or scores.shape != (15 * n_cases, 8) or \
            not np.isfinite(scores).all():
        raise AssertionError(f"CSV: {len(names)} masks, scores "
                             f"{scores.shape}")
    if min(launches) <= 0 or k5 <= 0 or k6 <= 0:
        raise AssertionError(f"a kernel of the eval path never ran: K1, K2 "
                             f"{launches}, K5 {k5}, K6 {k6}")
    log(f"  {name} eval CSV: 15 mask sections x {n_cases} cases, finite "
        f"scores; launches K1 {launches[0]}, K2 {launches[1]}, K5 {k5} "
        f"(scored on the card), K6 {k6}")
    if timed:
        log(f"  [{card}] eval CLI end to end: {n_cases} cases x 15 masks in "
            f"{run['seconds']:.3f} s -> {run['rate']:.4f} mask-cases/s; the "
            f"engine alone (phase 4) {[round(r, 4) for r in engine_rate]} "
            f"mask-cases/s")
    return k5, k6


def phase_timing(torch, fn, err, peaks):
    """Phase 6: K1 and K2 at the hoisted scale-1 shape of the sweep; the
    timed outputs are held against the plain version's (errors folded into
    `err`); their bounds from the card's `peaks` (`kernel_bound`)."""
    import torch.nn.functional as F

    shape = (WINDOWS, 32, 80, 80, 80)
    x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
    n = x.numel()
    stats = fn.norm_stats(x)
    k1 = kernel_ms(lambda: fn.norm_stats(x), 10)
    k2 = kernel_ms(lambda: fn.norm_apply(x, stats), 10)
    p1 = kernel_ms(lambda: fn.norm_stats_plain(x), 3, 1)
    p2 = kernel_ms(lambda: fn.norm_apply_plain(x, stats), 3, 1)
    e1, e2 = check_pair(torch, x.dtype, fn.norm_stats(x),
                        fn.norm_stats_plain(x), fn.norm_apply(x, stats),
                        fn.norm_apply_plain(x, stats))
    err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)
    log(f"  timed outputs vs plain: stats err {e1:.3g}, output err {e2:.3g}")
    xv = x.view(shape[0] * shape[1], -1)
    lib1 = kernel_ms(lambda: torch.var_mean(xv, dim=1, correction=0), 10)
    pair = kernel_ms(lambda: F.leaky_relu(F.instance_norm(x), 0.2), 5)
    b1, by1 = kernel_bound(lambda: fn.norm_stats(x), OPS_PER_ELEMENT * n,
                           peaks)
    b2, by2 = kernel_bound(lambda: fn.norm_apply(x, stats),
                           OPS_PER_ELEMENT * n, peaks)
    log(f"  {shape} bf16 ({n / 1e9:.3f} G elements), medians of launches "
        f"queued behind a device-side wait: K1 {k1:.4f} ms (bound "
        f"{b1:.4f}), K2 {k2:.4f} ms (bound {b2:.4f}); plain {p1:.4f} / "
        f"{p2:.4f} ms; torch.var_mean {lib1:.4f} ms; F.instance_norm + "
        f"F.leaky_relu {pair:.4f} ms against K1+K2 {k1 + k2:.4f} ms")
    return dict(k1=k1, k2=k2, p1=p1, p2=p2, lib1=lib1, pair=pair, b1=b1,
                b2=b2, by1=by1, by2=by2)


def phase_distance_transform(torch, peaks, labels) -> dict:
    """Phase 6b: K5 (`ops.edt.edt_sq`) against its plain version at small
    shapes and at the main path's (the 15 masks' labels of phase 4 and one
    target, every region), exactly; against scipy's distance transform on
    a speckled 240x240x155 volume (phase 4's full-mask labels) and a clean
    one (`data.synth.make_case`), exactly (square roots of the same
    integers); the device scorer (`metrics.score_masks`) on those 15
    masks against `dice_class4` (bit for bit) and `cal_hd95` (1e-9, in 8
    host threads). Times K5 at the 15-mask batch and at one volume beside
    its bound and scipy's time for one volume."""
    from concurrent.futures import ThreadPoolExecutor

    from scipy import ndimage

    from passion_tpu_torch import metrics
    from passion_tpu_torch.data.synth import make_case
    from passion_tpu_torch.ops import _build, edt

    errs = []  # max abs difference of every comparison (all must be 0)

    def held(x, classes, want=None):
        got = edt.edt_sq(x, classes)
        want = edt.edt_sq_plain(x, classes) if want is None else want
        errs.append((got.long() - want.long()).abs().max().item())
        if errs[-1]:
            raise AssertionError(f"K5 differs from its plain version on "
                                 f"{tuple(x.shape)} {classes}: max "
                                 f"{errs[-1]}")

    rng = np.random.default_rng(0)
    for shape in ((3, 24, 20, 16), (2, 7, 1, 5), (2, 40, 300, 33)):
        x = torch.from_numpy(rng.integers(0, 4, shape).astype(np.uint8))
        for classes in metrics.REGIONS:
            held(x.cuda(), classes, edt.edt_sq_plain(x, classes).cuda())
    log("  small shapes (W 300: the 16-bit envelope): K5 equal to the plain "
        "version on every region")

    target = make_case(VOLUME, np.random.default_rng(1))[1]
    footprint = ndimage.generate_binary_structure(3, 1)
    scipy_s = []
    for kind, lab in (("speckled", labels[-1]), ("clean", target)):
        x = torch.from_numpy(np.ascontiguousarray(lab))[None].cuda()
        for classes in metrics.REGIONS:
            region = np.isin(lab, classes)
            border = region ^ ndimage.binary_erosion(region, footprint, 1)
            got = edt.edt_sq(x, classes)[0].cpu().numpy()
            t0 = time.perf_counter()
            want = ndimage.distance_transform_edt(~border,
                                                  sampling=(1.0, 1.0, 1.0))
            scipy_s.append(time.perf_counter() - t0)
            errs.append(float(np.abs(np.sqrt(got.astype(np.float64))
                                     - want).max()))
            if errs[-1]:
                raise AssertionError(f"K5 differs from scipy on the {kind} "
                                     f"volume, region {classes}: max "
                                     f"{errs[-1]}")
    scipy_ms = float(np.median(scipy_s)) * 1e3
    log(f"  {VOLUME} speckled and clean, every region: K5 equal to scipy's "
        f"distance_transform_edt (its square roots); scipy "
        f"{min(scipy_s):.3f}-{max(scipy_s):.3f} s a volume on the host")

    batch = torch.from_numpy(np.stack(labels)).cuda()
    one = torch.from_numpy(target)[None].cuda()
    for x in (one, batch):
        for classes in metrics.REGIONS:
            held(x, classes)
    log(f"  main-path shapes {tuple(one.shape)} and {tuple(batch.shape)}: "
        f"K5 equal to the plain version on every region")

    ms = kernel_ms(lambda: edt.edt_sq(batch, (1, 2, 3)), 10)
    ms_one = kernel_ms(lambda: edt.edt_sq(one, (1, 2, 3)), 10)
    plain_ms = kernel_ms(lambda: edt.edt_sq_plain(batch, (1, 2, 3)), 1, 0)
    # each launch by kernel name through torch.profiler, in a process of
    # its own on this batch (a profiler session here can cost a later
    # phase's trace its first device records)
    saved = os.path.join(WORK, "k5_batch.npy")
    np.save(saved, np.stack(labels))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--k5-one", REPO, saved], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"--k5-one failed:\n{proc.stdout}"
                             f"{proc.stderr[-4000:]}")
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    passes = {}  # kernel: (ms at the batch, ms for one volume)
    for name, t in run["kernels"].items():
        short = re.search(r"edt_pass_\w", name)
        passes[short.group(0) if short else name[:60]] = (
            t, run["kernels_one"].get(name))
    if set(passes) != set(K5_PASS_BYTES):
        raise AssertionError(f"K5's launches ran {sorted(passes)}, not "
                             f"{sorted(K5_PASS_BYTES)}")
    traced = sum(t for t, _ in passes.values())
    for what, t in (("that process's CUDA events", run["ms"]),
                    ("this phase's CUDA events", ms)):
        if not math.isclose(traced, t, rel_tol=0.1):
            raise AssertionError(f"K5's traced launches ({traced:.4f} ms) "
                                 f"and {what} ({t:.4f} ms) disagree")
    log(f"  K5 in a process of its own (the same batch and volume): "
        f"{run['ms']:.4f} ms, one volume {run['ms_one']:.4f} ms; its "
        f"traced launches {traced:.4f} ms")
    for name, (t, t_one) in sorted(passes.items()):
        gbs = K5_PASS_BYTES[name] * batch.numel() / (t * 1e-3) / 1e9
        log(f"  K5 {name}: {t:.4f} ms at {tuple(batch.shape)}, {t_one:.4f} "
            f"ms for one volume; {K5_PASS_BYTES[name]} bytes a voxel "
            f"through device memory, {gbs:.0f} GB/s at the batch")
    plan = edt._plan(batch.shape)
    ptxas = ptxas_kernels(_build.build_log, "edt_pass")
    for name, p in sorted(ptxas.items()):
        p["dynamic_smem"] = plan[("a" if "edt_pass_a" in name else "b")
                                 + "_shared"]
        log(f"  ptxas {name[-40:]}: {p['registers']} registers, "
            f"{p['static_smem']} bytes static shared memory; dynamic "
            f"{p['dynamic_smem']} bytes at {tuple(batch.shape)}")

    def bound(x):
        from passion_tpu_torch import roofline

        t_comp, t_mem, by = roofline.floor_s(
            K5_OPS_PER_VOXEL * x.numel(), 5 * x.numel(), peaks["fp32"],
            peaks["hbm"])
        return max(t_comp, t_mem) * 1e3, "bytes" if by == "mem" else \
            "operations"

    (b, by), (b_one, _) = bound(batch), bound(one)
    log(f"  K5 {tuple(batch.shape)}: {ms:.4f} ms (bound {b:.4f} ms, "
        f"{by}); one volume {ms_one:.4f} ms (bound {b_one:.4f} ms) against "
        f"scipy's {scipy_ms:.1f} ms on the host; plain version {plain_ms:.1f} "
        f"ms")

    tgt = torch.from_numpy(target).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dice, hd = metrics.score_masks(batch, tgt)
    score_ms = (time.perf_counter() - t0) * 1e3
    with ThreadPoolExecutor(max_workers=8) as pool:
        host_hd = list(pool.map(lambda lab: metrics.cal_hd95(lab, target),
                                labels))
    hd_err = 0.0
    for m, lab in enumerate(labels):
        _, want = metrics.dice_class4(lab[None], target[None])
        if not np.array_equal(dice[m], want[0]):
            raise AssertionError(f"mask {m}: Dice {dice[m]} on the card, "
                                 f"{want[0]} on the host")
        hd_err = max(hd_err, float(np.abs(hd[m] - np.asarray(
            host_hd[m])).max()))
    if hd_err > 1e-9:
        raise AssertionError(f"HD95 on the card {hd_err} from cal_hd95")
    log(f"  device scorer, 15 masks x {VOLUME} against one target: "
        f"{score_ms:.1f} ms; Dice equal to dice_class4 bit for bit, HD95 "
        f"within {hd_err:.3g} of cal_hd95 (HD95 of the full mask "
        f"{hd[-1].round(4).tolist()})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                err=max(errs), ms_one=ms_one, bound_ms_one=b_one,
                scipy_ms=scipy_ms, score_ms=score_ms,
                passes={k: v[0] for k, v in passes.items()},
                passes_one={k: v[1] for k, v in passes.items()},
                ptxas=ptxas)


def _ulp_bf16(torch, v):
    """One bf16 ulp at |v| (8 bits of mantissa)."""
    e = torch.floor(torch.log2(v.abs().float().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_bwd(torch, fn, x, g, pg=1) -> tuple[float, float]:
    """K3's row sums against the plain version's (rtol 1e-4, atol 1e-5:
    float sums in another order), and K4's dx against the plain dx from
    the same row sums: within one bf16 ulp for bf16 (one rounding of
    values that agree to float32 rounding), 1e-5 for float32. Returns both
    max abs errors."""
    st = fn.norm_stats(x, phase_group=pg)
    b = fn.norm_bwd_stats(x, g, st, phase_group=pg)
    dx = fn.norm_bwd_apply(x, g, st, b, phase_group=pg)
    b_p = fn.norm_bwd_stats_plain(x, g, st, phase_group=pg)
    dx_p = fn.norm_bwd_apply_plain(x, g, st, b, phase_group=pg)
    torch.cuda.synchronize()
    torch.testing.assert_close(b, b_p, rtol=1e-4, atol=1e-5)
    diff = (dx.float() - dx_p.float()).abs()
    if x.dtype == torch.bfloat16:
        if not (diff <= _ulp_bf16(torch, dx_p) + 1e-6).all():
            raise AssertionError(f"K4 off by more than one bf16 ulp: "
                                 f"{diff.max().item():.3g}")
    else:
        torch.testing.assert_close(dx, dx_p, rtol=1e-5, atol=1e-5)
    return (b - b_p).abs().max().item(), diff.max().item()


def phase_backward_kernels(torch, fn, err):
    """Phase 3b: K3/K4 against the plain version at the train step's
    shapes (tolerances in `check_bwd`), the |mean| >> std case against
    float64, and the autograd Function against autograd of the plain
    forward in float32."""
    g0 = torch.Generator(device="cuda").manual_seed(3)
    cases = [((5, 32, 80, 80, 80), torch.bfloat16),  # fuse lanes, scale 1
             ((1, 32, 80, 80, 80), torch.bfloat16),  # encoder, scale 1
             ((4, 16, 80, 80, 80), torch.bfloat16),  # sep decoder, scale 1
             ((5, 2, 80, 80, 80), torch.bfloat16),  # RFNet PRM embedding
             ((5, 512, 5, 5, 5), torch.bfloat16),  # RFM5 rows: scalar path
             ((5, 32, 80, 80, 80), torch.float32),
             ((5, 512, 5, 5, 5), torch.float32)]
    for shape, dt in cases:
        x = (torch.randn(shape, generator=g0, device="cuda") * 3 + 1).to(dt)
        g = torch.randn(shape, generator=g0, device="cuda").to(dt)
        e3, e4 = check_bwd(torch, fn, x, g)
        err["K3"], err["K4"] = max(err["K3"], e3), max(err["K4"], e4)
        log(f"  {shape} {str(dt)[6:]}: row sums err {e3:.3g}, dx err "
            f"{e4:.3g}")
        del x, g
    # |mean| >> std: float32 kernels against float64 autograd of the plain
    # version on the same float32 values; elements within 1e-3 of the
    # LeakyReLU kink are left out (their branch may differ by rounding)
    x32 = (torch.randn((1, 128, 40, 40, 40), generator=g0, device="cuda")
           * 0.5 + 50.0)
    g32 = torch.randn(x32.shape, generator=g0, device="cuda")
    x64 = x32.double().requires_grad_()
    (dx64,) = torch.autograd.grad(
        (fn.instance_norm_lrelu_plain(x64) * g32.double()).sum(), x64)
    st64 = fn.norm_stats_plain(x64.detach())
    xh = (x64.detach().reshape(128, -1) - st64[:, :1]) * st64[:, 1:]
    far = (xh.abs() > 1e-3).reshape(x32.shape)
    xk = x32.clone().requires_grad_()
    (dxk,) = torch.autograd.grad((fn.instance_norm_lrelu(xk) * g32).sum(), xk)
    xp = x32.clone().requires_grad_()
    with full_float32(torch):
        (dxp,) = torch.autograd.grad(
            (fn.instance_norm_lrelu_plain(xp) * g32).sum(), xp)
    ek = (dxk.double() - dx64).abs()[far].max().item()
    ep = (dxp.double() - dx64).abs()[far].max().item()
    if ek > 1e-4:
        raise AssertionError(f"large-mean backward err {ek:.3g} > 1e-4")
    log(f"  large mean (1, 128, 40^3) f32 backward vs float64: kernel err "
        f"{ek:.3g} (bound 1e-4), plain err {ep:.3g}; "
        f"{int((~far).sum())} elements at the kink left out")
    # the autograd Function (K1-K4) against autograd of the plain forward;
    # elements within 1e-4 of the kink are left out: K1's and the plain
    # statistics differ by float rounding, which may flip their branch
    x = (torch.randn((1, 32, 80, 80, 80), generator=g0, device="cuda") * 2
         + 0.5)
    w = torch.randn(x.shape, generator=g0, device="cuda")
    xk = x.clone().requires_grad_()
    (gk,) = torch.autograd.grad((fn.instance_norm_lrelu(xk) * w).sum(), xk)
    xp = x.clone().requires_grad_()
    (gp,) = torch.autograd.grad((fn.instance_norm_lrelu_plain(xp) * w).sum(),
                                xp)
    st = fn.norm_stats_plain(x)
    far = (((x.reshape(32, -1) - st[:, :1]) * st[:, 1:]).abs() > 1e-4
           ).reshape(x.shape)
    torch.testing.assert_close(gk[far], gp[far], rtol=1e-4, atol=1e-4)
    log(f"  autograd Function vs autograd of the plain forward, (1, 32, "
        f"80^3) f32: max err {(gk - gp)[far].abs().max().item():.3g} (atol "
        f"1e-4); {int((~far).sum())} elements at the kink left out")


def phase_train(torch, fn, card, name) -> dict:
    """Phases 7, 12, 13: the full-width PASSION train step of `name`, bf16
    over float32 master params, dropout on where the backbone has it, as
    `fit` runs it."""
    from passion_tpu_torch import bench
    from passion_tpu_torch.multichip import PAD_SITES
    batch = bench.train_batch()
    ones = torch.ones(4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    model, step = bench.train_setup(name)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {name} full width: {n_params / 1e6:.2f} M params")

    def one():
        return step(batch, ones, ones, 4.0, gen, False)

    t0 = time.perf_counter()
    for _ in range(2):  # untimed: cuDNN set-up
        m = one()
    torch.cuda.synchronize()
    log(f"  2 untimed steps {time.perf_counter() - t0:.3f} s, loss "
        f"{m['loss'].item():.4f}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [one()["loss"] for _ in range(TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    launches = counts(fn)
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [v.item() for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    per_step = NORM_SITES[name]["train"]
    expect = TRAIN_STEPS * per_step
    want = dict.fromkeys(KERNELS, expect)
    want["K6"] = TRAIN_STEPS * PAD_SITES[name]["train"]
    log(f"  launches over {TRAIN_STEPS} steps {launches} (expected "
        f"{expect} of K1-K4: {per_step} norm sites per step; {want['K6']} "
        f"of K6)")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    log(f"  [{card}] {name}: {step_ms:.3f} ms per step -> "
        f"{1e3 / step_ms:.4f} steps/s; peak memory {peak_gib:.2f} GiB; "
        f"losses {[round(v, 4) for v in losses]}")
    return dict(launches=launches, step_ms=step_ms, peak_gib=peak_gib,
                step=one)


def phase_train_profile(torch, run, card, name, top: int = 30) -> dict:
    """Phases 7b, 12b, 13b (and 16): torch.profiler over one full-width
    train step (`passion_tpu_torch.profile`)."""
    from passion_tpu_torch import profile

    path = os.path.join(WORK, f"trace_{name.replace(' ', '_')}_step.json")
    return profile.report_trace(profile.trace(run["step"], path),
                                f"{name} train step", card, top=top)


def phase_train_float32(torch, fn, name):
    """Phases 7, 12, 13, float32: one step (TF32 off, dropout off) of the
    same model and batch on the kernel path and on the plain-norm path. Held
    together: the loss (rtol 1e-4), each gradient in relative L2 (2e-2;
    all of them together 5e-3) and the updated params (atol 2 lr + 1e-6).
    Why these: the two paths' statistics differ by float rounding, which
    flips LeakyReLU branches at the kink and, behind the 5^3 bottleneck's
    norm rows, moves some gradients by tenths of a percent (the CPU tests
    measure the JAX package's own gradient moving that much for a 1e-6
    change of its input); the trilinear upsampling's backward also adds
    with atomics, in no fixed order. AMSGrad moves a param by about lr
    whatever the size of its gradient, so rounding-level gradients of
    opposite sign part by 2 lr. ModalFusion divides a region's mean
    feature by the region's mean probability (+1e-7), so a region that
    holds little of the probability scales those rounding differences up
    in its gradients by the inverse of its share (1.8e-2 seen at RFM3's
    fourth region on the first run on the card)."""
    from passion_tpu_torch import bench
    batch = bench.train_batch()
    ones = torch.ones(4, device="cuda")
    res = {}
    with full_float32(torch):
        for path in ("kernel", "plain"):
            model, step = bench.train_setup(name, None, False)
            ctx = plain_norm(fn) if path == "plain" else contextlib.nullcontext()
            reset_counts(fn)
            torch.cuda.reset_peak_memory_stats()
            with ctx:
                m = step(batch, ones, ones, 4.0, None, False)
            torch.cuda.synchronize()
            res[path] = dict(
                loss=m["loss"].item(), k3=counts(fn)["K3"],
                peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                grads={n: p.grad.detach().clone()
                       for n, p in model.named_parameters()},
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})
            del model, step, m
            torch.cuda.empty_cache()
    k, p = res["kernel"], res["plain"]
    if k["k3"] != NORM_SITES[name]["train"] or p["k3"] != 0:
        raise AssertionError(f"K3 launches kernel {k['k3']}, plain {p['k3']}")
    if not math.isfinite(k["loss"]) or abs(k["loss"] - p["loss"]) > 1e-4 * abs(
            p["loss"]):
        raise AssertionError(f"float32 losses {k['loss']} vs {p['loss']}")
    rels, num, den = [], 0.0, 0.0
    for n, gp in p["grads"].items():
        d = (k["grads"][n] - gp).norm().item()
        num, den = num + d * d, den + gp.norm().item() ** 2
        if gp.norm().item() > 1e-6:
            rels.append((d / gp.norm().item(), n))
    rels.sort(reverse=True)
    glob_rel = math.sqrt(num / den)
    over = [(r, n) for r, n in rels
            if r > (5e-2 if ".modal_fusion_" in n else 2e-2)]
    if over or glob_rel > 5e-3:
        raise AssertionError(f"gradients: {over[:5]}, global {glob_rel}")
    worst = rels[0]
    dp = max((k["params"][n] - v).abs().max().item()
             for n, v in p["params"].items())
    if dp > 2 * 2e-4 + 1e-6:
        raise AssertionError(f"updated params differ by {dp}")
    log(f"  {name} float32 step, kernel vs plain-norm path: loss "
        f"{k['loss']:.6f} vs "
        f"{p['loss']:.6f}; gradients rel L2 global {glob_rel:.3g}, worst "
        f"{worst[0]:.3g} ({worst[1]}), next "
        f"{[(round(r, 5), n) for r, n in rels[1:3]]}; updated params max "
        f"diff {dp:.3g}; "
        f"peak {k['peak']:.2f} / {p['peak']:.2f} GiB")


def phase_train_entry(torch, fn, name, resume):
    """Phases 8, 12c, 13c: `python -m passion_tpu_torch.train --model name`
    at full width on synthetic cases: 1 epoch x 2 iterations, then (with
    `resume`) `--resume` for epoch 2."""
    from passion_tpu_torch import train as port_train
    from passion_tpu_torch.data.synth import make_synthetic_dataset
    from passion_tpu_torch.engine.checkpoint import load_checkpoint

    data = os.path.join(WORK, "train_data")
    if not os.path.isdir(data):
        make_synthetic_dataset(data, n_cases=6, shape=(96, 96, 80), seed=0)

    def run(out, epochs, *extra):
        port_train.main(["--model", name, "--dataroot", data, "--datapath",
                         ".",
                         "--imbmrpath", "imb_split.csv", "--savepath", out,
                         "--num_epochs", str(epochs), "--iters_per_epoch",
                         "2", "--use_passion", "--num_workers", "4", *extra])
        with open(os.path.join(out, "idt_training.txt")) as f:
            return f.read()

    out1 = os.path.join(WORK, f"train1_{name}")
    out2 = os.path.join(WORK, f"train2_{name}")
    reset_counts(fn)
    t0 = time.perf_counter()
    run(out1, 1)
    first = counts(fn)
    ck = os.path.join(out1, "model_last.pt")
    if load_checkpoint(ck)["epoch"] != 0 or min(first.values()) <= 0:
        raise AssertionError(f"epoch-1 checkpoint or launches wrong: {first}")
    with open(os.path.join(out1, f"{name}.csv")) as f:
        if len(f.read().strip().splitlines()) != 1 + 15 * 3:
            raise AssertionError("the final sweep's CSV is incomplete")
    if not resume:
        log(f"  {name} train CLI: epoch 1 checkpoint and the final 15-mask "
            f"CSV written; {time.perf_counter() - t0:.1f} s; launches "
            f"{first}")
        return
    log_text = run(out2, 2, "--resume", ck)
    if f"resumed from {ck} at epoch 1" not in log_text or \
            "Epoch 2/2, Iter 2/2" not in log_text:
        raise AssertionError("--resume did not continue at epoch 2")
    state = load_checkpoint(os.path.join(out2, "model_last.pt"))
    n_upd = {s["count"] for s in state["optimizer"]["state"].values()}
    if state["epoch"] != 1 or n_upd != {4}:
        raise AssertionError(f"resumed checkpoint: epoch {state['epoch']}, "
                             f"updates {n_upd}")
    with open(os.path.join(out2, f"{name}.csv")) as f:
        if len(f.read().strip().splitlines()) != 1 + 15 * 3:
            raise AssertionError("the final sweep's CSV is incomplete")
    log(f"  {name} train CLI: epoch 1 checkpoint written, --resume ran epoch 2 "
        f"(4 updates in the optimizer state), final 15-mask CSVs written; "
        f"{time.perf_counter() - t0:.1f} s; launches of the first run "
        f"{first}")


def phase_backward_timing(torch, fn, err, peaks) -> dict:
    """Phase 9: K3 and K4 at the train step's largest norm input, the
    five-lane scale-1 tensor; the timed outputs are held against the plain
    version (errors folded into `err`); their bounds as in phase 6."""
    import torch.nn.functional as F

    shape = (5, 32, 80, 80, 80)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    n = x.numel()
    st = fn.norm_stats(x)
    b = fn.norm_bwd_stats(x, g, st)
    k3 = kernel_ms(lambda: fn.norm_bwd_stats(x, g, st), 10)
    k4 = kernel_ms(lambda: fn.norm_bwd_apply(x, g, st, b), 10)
    p3 = kernel_ms(lambda: fn.norm_bwd_stats_plain(x, g, st), 3, 1)
    p4 = kernel_ms(lambda: fn.norm_bwd_apply_plain(x, g, st, b), 3, 1)
    e3, e4 = check_bwd(torch, fn, x, g)
    err["K3"], err["K4"] = max(err["K3"], e3), max(err["K4"], e4)
    log(f"  timed outputs vs plain: row sums err {e3:.3g}, dx err {e4:.3g}")
    # the library's backward alone of F.leaky_relu(F.instance_norm(x))
    xr = x.detach().requires_grad_()
    y = F.leaky_relu(F.instance_norm(xr), 0.2)
    lib = kernel_ms(lambda: torch.autograd.grad(y, xr, g, retain_graph=True),
                    5)
    del y
    b3, by3 = kernel_bound(lambda: fn.norm_bwd_stats(x, g, st),
                           OPS_PER_ELEMENT_BWD * n, peaks)
    b4, by4 = kernel_bound(lambda: fn.norm_bwd_apply(x, g, st, b),
                           OPS_PER_ELEMENT_BWD * n, peaks)
    log(f"  {shape} bf16 ({n / 1e6:.2f} M elements), medians of launches "
        f"queued behind a device-side wait: K3 {k3:.4f} ms (bound "
        f"{b3:.4f}), K4 {k4:.4f} ms (bound {b4:.4f}); plain {p3:.4f} / "
        f"{p4:.4f} ms; backward of F.leaky_relu(F.instance_norm) {lib:.4f} "
        f"ms against K3+K4 {k3 + k4:.4f} ms")
    return dict(k3=k3, k4=k4, p3=p3, p4=p4, lib=lib, b3=b3, b4=b4, by3=by3,
                by4=by4)

def phase_single_mask(torch, fn, card, err) -> dict:
    """Phase 14: the single-mask engine (`SlidingWindowInference`) on the
    phase-4 case under the full mask, full-width mmFormer, bf16. Folds the
    on-path check's errors into `err`; returns the launches."""
    from passion_tpu_torch import bench
    from passion_tpu_torch.multichip import PAD_SITES
    from passion_tpu_torch.engine.sliding_window import (
        SlidingWindowInference, SlidingWindowSweep)
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model

    model = init_model(get_model("mmformer"), seed=0)
    mask = np.asarray(MASK_ARRAY[-1])
    engine = SlidingWindowInference(model, num_cls=4, patch=80)
    prepared = engine.prepare(bench.volume())
    if (len(prepared["coords"]), prepared["window_batch"]) != (WINDOWS,
                                                               WINDOWS):
        raise AssertionError("phase 14 runs one chunk of 75 windows")
    seen = {}
    reset_counts(fn)
    with checked_norm(torch, fn, seen):
        labels = engine.infer_labels(prepared, mask)
    launches = counts(fn)
    expect = FORWARD_SITES  # one chunk
    pads = PAD_SITES["mmformer"]["forward"]
    log(f"  launches {launches} (expected {expect} of K1 and K2: the "
        f"forward's 14 encoder + 27 fuse-path norm sites per chunk; {pads} "
        f"of K6)")
    if launches != {"K1": expect, "K2": expect, "K3": 0, "K4": 0,
                    "K6": pads}:
        raise AssertionError(f"launches {launches}, expected {expect}, "
                             f"{pads} of K6")
    for (shape, dt, pg), (calls, e1, e2) in seen.items():
        log(f"    {shape} {dt} phase_group={pg}: {calls} calls; stats err "
            f"{e1:.3g}, output err {e2:.3g}")
        err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)
    if sum(c for c, _, _ in seen.values()) != launches["K1"]:
        raise AssertionError("norm calls and K1 launches disagree")
    if labels.shape != VOLUME or labels.dtype != np.uint8 or labels.max() > 3:
        raise AssertionError(f"bad labels {labels.shape} {labels.dtype}")
    sweep = SlidingWindowSweep(model, num_cls=4, patch=80)
    ref = sweep.sweep_labels(sweep.prepare(bench.volume()), [mask])[0]
    del sweep
    differ = float((labels != ref).mean())
    log(f"  {len(seen)} distinct norm inputs held against the plain version; "
        f"labels vs the sweep engine's (full mask, both bf16): "
        f"{differ:.6f} of voxels differ")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.infer_labels(prepared, mask)
        runs.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if prepared["window_batch"] != WINDOWS:
        raise AssertionError("the timed runs fell back to a smaller window "
                             "batch (out of memory)")
    log(f"  [{card}] single-mask engine, one case one mask: "
        f"{[round(r, 4) for r in runs]} s -> "
        f"{[round(1 / r, 4) for r in runs]} cases/s; peak memory "
        f"{peak_gib:.2f} GiB")

    # kernel path against the plain-norm path of the forward, float32
    # (TF32 off), on two windows
    x = torch.stack([prepared["vol"][:, h:h + 80, w:w + 80, z:z + 80]
                     for h, w, z in prepared["coords"][:2].tolist()]).float()
    del engine, prepared
    net = model.to("cuda", torch.float32).eval()
    m2 = torch.as_tensor(MASK_ARRAY[10], device="cuda").expand(2, 4)
    with torch.inference_mode(), full_float32(torch):
        p_kernel = net(x, m2)
        with plain_norm(fn):
            p_plain = net(x, m2)
    if not torch.isfinite(p_kernel).all():
        raise AssertionError("non-finite probabilities")
    torch.testing.assert_close(p_kernel, p_plain, rtol=0, atol=1e-4)
    log(f"  float32, 2 windows, forward: kernel vs plain-norm probs max err "
        f"{(p_kernel - p_plain).abs().max().item():.3g} (atol 1e-4)")
    return launches


def phase_validation(torch, fn, card, err) -> dict:
    """Phase 15: the validation step of full-width mmFormer on one batch
    (bs 1, 80^3) under all 15 masks, then the train CLI with
    `--use_valid`. Returns the launches of the 15-mask batch."""
    from passion_tpu_torch import bench
    from passion_tpu_torch.multichip import PAD_SITES
    from passion_tpu_torch import train as port_train
    from passion_tpu_torch.data.synth import make_synthetic_dataset
    from passion_tpu_torch.engine.tb_writer import read_scalars
    from passion_tpu_torch.engine.train_loop import make_val_step
    from passion_tpu_torch.masks import MASK_ARRAY, MASK_NAMES
    from passion_tpu_torch.models import get_model, init_model

    model = init_model(get_model("mmformer"), seed=0).cuda()
    val_step = make_val_step(model, 4)
    batch = bench.train_batch()
    masks = torch.as_tensor(MASK_ARRAY, device="cuda")

    def one_batch():
        return torch.stack([val_step(batch["x"], m[None], batch["target"],
                                     4.0) for m in masks])

    seen = {}
    reset_counts(fn)
    with checked_norm(torch, fn, seen):
        losses = one_batch()
    launches = counts(fn)
    expect = 15 * VAL_SITES
    pads = 15 * PAD_SITES["mmformer"]["val"]
    log(f"  launches for one batch under 15 masks {launches} (expected "
        f"{expect} of K1 and K2, {VAL_SITES} per mask; none of K3/K4; "
        f"{pads} of K6)")
    if launches != {"K1": expect, "K2": expect, "K3": 0, "K4": 0,
                    "K6": pads}:
        raise AssertionError(f"launches {launches}, expected {expect}, "
                             f"{pads} of K6")
    for (shape, dt, pg), (calls, e1, e2) in seen.items():
        err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)
    losses = losses.cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite validation losses {losses}")
    batch_ms = cuda_ms(one_batch, 3, 1)
    log(f"  {len(seen)} distinct norm inputs held against the plain version; "
        f"[{card}] {batch_ms:.3f} ms per batch (15 masks, "
        f"{batch_ms / 15:.3f} ms per mask); losses "
        f"{[round(float(v), 4) for v in losses]}")
    del model, val_step, batch
    torch.cuda.empty_cache()

    data = os.path.join(WORK, "train_data")
    if not os.path.isdir(data):
        make_synthetic_dataset(data, n_cases=6, shape=(96, 96, 80), seed=0)
    out = os.path.join(WORK, "train_valid")
    t0 = time.perf_counter()
    port_train.main(["--dataroot", data, "--datapath", ".", "--imbmrpath",
                     "imb_split.csv", "--savepath", out, "--num_epochs", "2",
                     "--iters_per_epoch", "2", "--use_passion",
                     "--use_valid", "--num_workers", "4"])
    (events,) = os.listdir(os.path.join(out, "summary"))
    rows = read_scalars(os.path.join(out, "summary", events))
    tags = {t for _, t, _ in rows}
    scores = {(t, st): v for st, t, v in rows
              if t in MASK_NAMES or t == "score_average"}
    if not set(MASK_NAMES) | {"score_average"} <= tags or len(scores) != 32:
        raise AssertionError(f"validation tags missing: {sorted(tags)}")
    if not all(math.isfinite(v) for v in scores.values()):
        raise AssertionError(f"non-finite validation scores {scores}")
    avg = [scores[("score_average", e)] for e in (1, 2)]
    best = os.path.exists(os.path.join(out, "model_best.pt"))
    if best != (avg[1] > avg[0]):
        raise AssertionError(f"model_best.pt {best} for scores {avg}")
    log(f"  train CLI --use_valid, 2 epochs x 2 iterations: 15 mask tags and "
        f"score_average per epoch, finite; score_average {avg}; "
        f"model_best.pt {'written' if best else 'not written'}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_data_parallel(torch, fn, card, step_ms, sweep_labels) -> dict:
    """Phase 16: data parallelism at world size 1 over NCCL, in a process
    group of this process. Returns the launches of the timed bf16 steps
    and of the sharded sweep."""
    from passion_tpu_torch import bench, multichip
    from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model
    from passion_tpu_torch.parallel import world as pw

    world = pw.init(0, 1, "cuda", pw.free_tcp_address(), timeout_s=120)
    out = {}
    try:
        batch = bench.train_batch()
        ones = torch.ones(4, device="cuda")
        res = {}
        with full_float32(torch):
            for path in ("one", "dp"):
                model, step = bench.train_setup(
                    "mmformer", None, False, world if path == "dp" else None)
                m = step(batch, ones, ones, 4.0, None, False)
                res[path] = dict(loss=m["loss"].item(), grads={
                    n: p.grad.detach().clone()
                    for n, p in model.named_parameters()})
                del model, step, m
                torch.cuda.empty_cache()
        a, b = res["one"], res["dp"]
        if abs(a["loss"] - b["loss"]) > 1e-5 * abs(a["loss"]):
            raise AssertionError(f"losses {a['loss']} vs {b['loss']}")
        err = multichip.grad_errors(a["grads"], b["grads"])
        if err["over"] or err["global_rel"] > multichip.GRAD_GLOBAL:
            raise AssertionError(f"gradients: global {err['global_rel']}, "
                                 f"over their bound {err['over']}")
        log(f"  float32 step, data-parallel (world 1, NCCL) vs one process: "
            f"loss {b['loss']:.6f} vs {a['loss']:.6f}; gradients rel L2 "
            f"global {err['global_rel']:.3g}, worst {err['worst'][0]:.3g}")
        del res, a, b

        # the bf16 step as fit runs it (dropout on), one process and
        # data-parallel side by side, timed in turn (one, dp, dp, one, ...)
        # so that the host's drift over the run falls on both
        runs = {}
        for path in ("one", "dp"):
            model, step = bench.train_setup(
                "mmformer", torch.bfloat16, True,
                world if path == "dp" else None)
            gen = torch.Generator(device="cuda").manual_seed(1)

            def one(step=step, gen=gen):
                return step(batch, ones, ones, 4.0, gen, False)

            for _ in range(2):
                one()
            runs[path] = dict(step=one, model=model, ms=[])
        torch.cuda.synchronize()
        for path in ("one", "dp", "dp", "one") * DP_TURNS:
            count = path == "dp" and not runs["dp"]["ms"]
            if count:
                reset_counts(fn)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses = [runs[path]["step"]()["loss"]
                      for _ in range(TRAIN_STEPS)]
            end.record()
            torch.cuda.synchronize()
            if count:
                out["train"] = counts(fn)
            runs[path]["ms"].append(start.elapsed_time(end) / TRAIN_STEPS)
            if not all(math.isfinite(v.item()) for v in losses):
                raise AssertionError(f"non-finite {path} loss")
        want = dict.fromkeys(KERNELS, TRAIN_STEPS * NORM_SITES["mmformer"][
            "train"])
        want["K6"] = TRAIN_STEPS * multichip.PAD_SITES["mmformer"]["train"]
        if out["train"] != want:
            raise AssertionError(f"launches {out['train']}, expected {want}")
        one_ms, dp_ms = runs["one"]["ms"], runs["dp"]["ms"]
        log(f"  [{card}] bf16 step, {TRAIN_STEPS} steps per timing, in turn "
            f"one/dp/dp/one x {DP_TURNS}: one process "
            f"{[round(v, 3) for v in one_ms]} ms, median "
            f"{float(np.median(one_ms)):.3f}; data-parallel "
            f"{[round(v, 3) for v in dp_ms]} ms, median "
            f"{float(np.median(dp_ms)):.3f} (phase 7: {step_ms:.3f} ms); "
            f"launches over the first {TRAIN_STEPS} data-parallel steps "
            f"{out['train']}")
        traces = {path: phase_train_profile(torch, runs[path], card,
                                            f"mmformer {path}", top=5)
                  for path in ("one", "dp")}
        one_k, dp_k = traces["one"]["kernels"], traces["dp"]["kernels"]
        diff = {k: traces["dp"][k] - traces["one"][k]
                for k in ("calls", "busy_ms", "wall_ms")}
        log(f"  traced step, data-parallel minus one process: "
            f"{diff['calls']} kernel launches, {diff['busy_ms']:.3f} ms of "
            f"kernels, {diff['wall_ms']:.3f} ms of wall time; kernels whose "
            f"count differs (launches, ms):")
        for k in sorted(set(one_k) | set(dp_k)):
            (t1, n1), (t2, n2) = one_k.get(k, (0.0, 0)), dp_k.get(k, (0.0, 0))
            if n1 != n2:
                log(f"    {n2 - n1:+5d} {t2 - t1:+9.3f} ms  {k[:100]}")
        out["dp_ms"], out["one_ms"] = dp_ms, one_ms
        out["traces"] = {p: {k: v for k, v in t.items() if k != "kernels"}
                         for p, t in traces.items()}
        del runs, traces
        torch.cuda.empty_cache()

        # the sharded sweep at world size 1 against phase 4's labels
        engine = SlidingWindowSweep(init_model(get_model("mmformer"), seed=0),
                                    num_cls=4, patch=80, world=world)
        prepared = engine.prepare(bench.volume())
        reset_counts(fn)
        labels = engine.sweep_labels(prepared, [np.asarray(m)
                                                for m in MASK_ARRAY])
        out["sweep"] = counts(fn)
        differ = [int((g != r).sum()) for g, r in zip(labels, sweep_labels)]
        sites, pads = NORM_SITES["mmformer"], multichip.PAD_SITES["mmformer"]
        if any(differ) or \
                out["sweep"]["K1"] != sites["encode"] + 15 * sites["fuse"] or \
                out["sweep"]["K6"] != pads["encode"] + 15 * pads["fuse"]:
            raise AssertionError(f"sharded sweep: {differ} voxels differ, "
                                 f"launches {out['sweep']}")
        log(f"  sharded sweep (world 1, window batch "
            f"{prepared['window_batch']}): 15 label volumes equal phase 4's; "
            f"launches {out['sweep']}")
        del engine, prepared, labels
        torch.cuda.empty_cache()
    finally:
        pw.shutdown()

    from passion_tpu_torch import train as port_train
    from passion_tpu_torch.engine.checkpoint import load_checkpoint

    data = os.path.join(WORK, "train_data")
    worlds = [1] + ([2] if torch.cuda.device_count() >= 2 else [])
    for n in worlds:
        out_dir = os.path.join(WORK, f"train_dp{n}")
        t0 = time.perf_counter()
        port_train.main(["--dataroot", data, "--datapath", ".", "--imbmrpath",
                         "imb_split.csv", "--savepath", out_dir,
                         "--num_epochs", "1", "--iters_per_epoch", "2",
                         "--use_passion", "--num_workers", "4",
                         "--batch_size", str(n), "--data_parallel", str(n)])
        state = load_checkpoint(os.path.join(out_dir, "model_last.pt"))
        with open(os.path.join(out_dir, "mmformer.csv")) as f:
            n_rows = len(f.read().strip().splitlines())
        if state["epoch"] != 0 or n_rows != 1 + 15 * 3:
            raise AssertionError(f"--data_parallel {n}: epoch "
                                 f"{state['epoch']}, {n_rows} CSV rows")
        log(f"  train CLI --data_parallel {n} (bs {n}): epoch-1 checkpoint "
            f"and the final 15-mask CSV written by rank 0; "
            f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_multichip(torch) -> dict:
    """Phase 16b: `python -m passion_tpu_torch.multichip` through its spawn
    path (module docstring). Returns rank 0's K1-K4 launches of the float32
    step and of the sharded sweep by `multichip_{step,sweep}:{name}`."""
    count = torch.cuda.device_count()
    n = min(count, 4)
    args = ["--cards", str(n), "--out", os.path.join(WORK, "multichip")]
    if n == 1:
        args += ["--models", "mmformer", "--phases", "step", "sweep"]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "passion_tpu_torch.multichip",
                          *args], cwd=REPO, capture_output=True, text=True,
                         timeout=300 if n == 1 else 3000)
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        if line.startswith(("check ", "  rank ")):
            log(f"  {line.strip()}")
    if out.returncode:
        raise AssertionError(f"multichip {' '.join(args)} exited "
                             f"{out.returncode}: {out.stdout[-2000:]} "
                             f"{out.stderr[-2000:]}")
    row = json.loads(lines[-1])
    if not row["ok"] or row["failed"] or row["cards"] != [n]:
        raise AssertionError(f"multichip: {row['failed']}")
    launches = {}
    for name, by_n in row["results"].items():
        for phase in ("step", "sweep"):
            launches[f"multichip_{phase}:{name}"] = by_n[str(n)][phase][
                "launches"][0]
    log(f"  multichip: {count} card(s) visible, world size {n}, "
        f"{row['models']}; {row['checks']} checks passed; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def upstream_state_dict(torch, table, port_sd, rng, scale=0.02):
    """An upstream-format (reference PyTorch) state_dict for `table`, its
    rows read backwards: shapes from the port's state_dict (a slotted conv
    row holds a quarter of the port tensor's dim 0, a slotted `pos` one
    slice, a ModalFusion Linear a 1x1x1 conv), seeded normal values."""
    sd = {}
    for up, port, slot in table:
        shape = tuple(port_sd[port].shape)
        if slot is not None:
            shape = ((shape[0] // 4,) + shape[1:]
                     if port.endswith((".weight", ".bias")) else shape[1:])
        elif ".weight_layer." in up and up.endswith(".weight"):
            shape += (1, 1, 1)
        sd[up] = torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))
    return sd


def phase_import(torch, fn, card, err, name) -> dict:
    """Phase 17: a reference checkpoint of backbone `name` at its published
    width, written as the upstream train.py writes it (`{epoch,
    state_dict, optim_dict}`, DataParallel's `module.` prefix), loaded with
    `load_torch_checkpoint` and the backbone's converter into a model on
    the card (strict), every port tensor held equal to its upstream
    slice(s). Then, under those weights: mmFormer's whole phase-4 sweep;
    RFNet and M2FTrans one encode and one fuse pass of the phase-4 case
    (full mask), every distinct norm input held against the plain
    version. Folds the errors into `err`; returns the launches."""
    from passion_tpu_torch import bench
    from passion_tpu_torch.multichip import PAD_SITES
    from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
    from passion_tpu_torch.interop import torch_weights as tw
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model

    table, convert = {
        "mmformer": (tw.mmformer_table(), tw.mmformer_params_from_torch),
        "rfnet": (tw.rfnet_table(), tw.rfnet_params_from_torch),
        "m2ftrans": (tw.m2ftrans_table(), tw.m2ftrans_params_from_torch),
    }[name]
    model = get_model(name)  # published width, patch 80
    sd = upstream_state_dict(torch, table, model.state_dict(),
                             np.random.default_rng(0))
    path = os.path.join(WORK, f"upstream_{name}.pth")
    torch.save({"epoch": 0, "state_dict": {"module." + k: v
                                           for k, v in sd.items()},
                "optim_dict": {}}, path)
    t0 = time.perf_counter()
    model = model.cuda()
    model.load_state_dict(convert(tw.load_torch_checkpoint(path)),
                          strict=True)
    load_s = time.perf_counter() - t0
    held = model.state_dict()
    for up, port, slot in table:
        got = held[port]
        if slot is not None:
            got = (got.chunk(4, 0)[slot] if port.endswith((".weight", ".bias"))
                   else got[slot])
        if not torch.equal(got.reshape(sd[up].shape).cpu(), sd[up]):
            raise AssertionError(f"{port} differs from upstream {up}")
    log(f"  {name}: {os.path.getsize(path) / 2 ** 20:.1f} MiB upstream "
        f"checkpoint, {len(sd)} upstream tensors -> {len(held)} port "
        f"tensors, loaded strictly onto the card in {load_s:.2f} s; every "
        f"port tensor equals its upstream slice(s)")
    del sd, held

    if name == "mmformer":
        model, launches, engine, prepared, _, _ = phase_main_path(
            torch, fn, card, err, name, model=model)
        del model, engine, prepared
        return launches
    engine = SlidingWindowSweep(model, num_cls=4, patch=80)
    del model
    prepared = engine.prepare(bench.volume())
    seen = {}
    reset_counts(fn)
    with checked_norm(torch, fn, seen):
        fts = engine.encode_case(prepared)
        labels = engine.infer_labels_masked(prepared, fts,
                                            np.asarray(MASK_ARRAY[-1]))
    launches = counts(fn)
    chunks = len(fts)
    expect = chunks * (NORM_SITES[name]["encode"] + NORM_SITES[name]["fuse"])
    pads = chunks * (PAD_SITES[name]["encode"] + PAD_SITES[name]["fuse"])
    if launches != {"K1": expect, "K2": expect, "K3": 0, "K4": 0,
                    "K6": pads}:
        raise AssertionError(f"launches {launches}, expected {expect} of "
                             f"K1 and K2, {pads} of K6")
    if sum(c for c, _, _ in seen.values()) != expect:
        raise AssertionError("norm calls and K1 launches disagree")
    for (shape, dt, pg), (calls, e1, e2) in seen.items():
        err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)
    if labels.shape != VOLUME or labels.dtype != np.uint8 or labels.max() > 3:
        raise AssertionError(f"bad labels {labels.shape} {labels.dtype}")
    log(f"  {name} under the upstream weights, one encode and one fuse pass "
        f"(full mask, bf16, {chunks} chunk): launches {launches}; "
        f"{len(seen)} distinct norm inputs held against the plain version; "
        f"labels {VOLUME} uint8 in 0..{labels.max()}")
    del engine, prepared, fts
    return launches


def phase_preprocess() -> None:
    """Phase 18: the offline preprocessing CLI on phase 8's synthetic npy
    root (host only; `convert` needs nibabel, which is not installed):
    `split` then `imbmr`, each a `python -m passion_tpu_torch.data.preprocess`
    process; the lists against `split_dataset`, the CSV against
    `generate_imb_mr` on the same train list, byte for byte."""
    from passion_tpu_torch.data.preprocess import (generate_imb_mr,
                                                   split_dataset)

    data = os.path.join(WORK, "train_data")
    root, ref = os.path.join(WORK, "preprocess"), os.path.join(WORK,
                                                               "split_ref")
    os.makedirs(root)
    os.symlink(os.path.join(data, "vol"), os.path.join(root, "vol"))

    def cli(*args):
        subprocess.run([sys.executable, "-m",
                        "passion_tpu_torch.data.preprocess", *args],
                       cwd=REPO, check=True, timeout=300)

    t0 = time.perf_counter()
    cli("split", "--npy-root", root)
    names = sorted(f[:-len("_vol.npy")] for f in os.listdir(
        os.path.join(root, "vol")) if f.endswith("_vol.npy"))
    want = split_dataset(names, ref)
    for fname, lst in want.items():
        with open(os.path.join(root, fname)) as f:
            got = f.read()
        if got != "".join(n + "\n" for n in lst):
            raise AssertionError(f"{fname}: {got!r}, expected {lst}")
    if sorted(sum(want.values(), [])) != names:
        raise AssertionError(f"the split lost cases: {want}")
    csv_path = os.path.join(root, "imb_split.csv")
    cli("imbmr", "--train-file", os.path.join(root, "train.txt"),
        "--out-csv", csv_path)
    generate_imb_mr(want["train.txt"], os.path.join(ref, "imb_split.csv"))
    with open(csv_path, "rb") as f, open(os.path.join(
            ref, "imb_split.csv"), "rb") as g:
        got, direct = f.read(), g.read()
    if got != direct or len(got.splitlines()) != 1 + len(want["train.txt"]):
        raise AssertionError("the imb-MR CSV of the CLI differs from "
                             "generate_imb_mr's")
    log(f"  split of {len(names)} cases: "
        f"{ {k: len(v) for k, v in want.items()} }, equal to split_dataset; "
        f"imb-MR CSV of {len(want['train.txt'])} rows equal to "
        f"generate_imb_mr's byte for byte; "
        f"{time.perf_counter() - t0:.1f} s")


def _module(*args: str) -> dict:
    """Run `python -m passion_tpu_torch.{args}` in a process of its own;
    its output's last line parsed as JSON."""
    out = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"{' '.join(args)} exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_bench() -> None:
    """Phase 19: `python -m passion_tpu_torch.bench` (mmFormer; sweep,
    train, single and loader at a few reps, BENCH_ARGS): every rate finite
    and positive, each `mfu_*` in (0, 1), every `bytes_*` positive, each
    `roofline_*` share in (0, 1.05] with its `bound_*`; one window's forward
    FLOPs beside the TPU program's XLA count (a count, not a speed). Then
    `python -m passion_tpu_torch.profile fuse --model rfnet`: its trace file
    and kernel table."""
    t0 = time.perf_counter()
    row = _module("passion_tpu_torch.bench", *BENCH_ARGS)
    log(f"  bench {json.dumps(row)}")
    rates = ("value", "value_best", "train_steps_per_sec",
             "train_steps_per_sec_best", "single_cases_per_sec",
             "single_cases_per_sec_best", "aug_crops_per_sec")
    for k in rates:
        if not (math.isfinite(row[k]) and row[k] > 0):
            raise AssertionError(f"bench {k} = {row[k]}")
    for k in ("mfu_sweep", "mfu_train"):
        if row[k] is None or not 0 < row[k] < 1:
            raise AssertionError(f"bench {k} = {row[k]}")
    for k in ("bytes_sweep", "bytes_sweep_encode", "bytes_sweep_fuse",
              "bytes_train_step"):
        if not row[k] > 0:
            raise AssertionError(f"bench {k} = {row[k]}")
    for k in ("sweep", "train"):
        share, bound = row[f"roofline_{k}"], row[f"bound_{k}"]
        if share is None or not 0 < share <= 1.05 or bound not in (
                "mem", "comp", "mixed"):
            raise AssertionError(f"bench roofline_{k} = {share}, bound_{k} "
                                 f"= {bound}")
    if row["metric"] != "brats_eval_sweep_throughput" or not row["chip"]:
        raise AssertionError(f"bench line: {row['metric']}, {row['chip']}")
    log(f"  {row['value']} mask-cases/s (mfu {row['mfu_sweep']}; "
        f"{row['bytes_sweep'] / 1e9:.2f} GB, {row['roofline_sweep']} of "
        f"the {row['bound_sweep']} floor), {row['train_steps_per_sec']} "
        f"steps/s (mfu {row['mfu_train']}; "
        f"{row['bytes_train_step'] / 1e9:.2f} GB, {row['roofline_train']} "
        f"of the {row['bound_train']} floor), "
        f"{row['single_cases_per_sec']} single-mask cases/s, "
        f"{row['aug_crops_per_sec']} aug-crops/s; FLOPs of one 80^3 "
        f"window's forward {row['flops_window_forward'] / 1e9:.2f} G (the "
        f"port's aten ops) against {XLA_WINDOW_FLOPS / 1e9:.2f} G, bench.py's "
        f"XLA count of the canonical TPU program; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = os.path.join(WORK, "profile")
    prof = _module("passion_tpu_torch.profile", "fuse", "--model", "rfnet",
                   "--out", out)
    if not os.path.getsize(prof["trace"]) or prof["launches"] <= 0 or \
            not 0 < prof["busy_share"] <= 1.05:
        raise AssertionError(f"profile: {prof}")
    mib = os.path.getsize(prof["trace"]) / 2 ** 20
    log(f"  profile fuse --model rfnet: trace {mib:.1f} MiB, wall "
        f"{prof['wall_ms']} ms, kernels "
        f"{prof['kernel_ms']} ms (busy {prof['busy_share']}), "
        f"{prof['launches']} launches, norm share {prof['norm_share']}; "
        f"{time.perf_counter() - t0:.1f} s")


def small_counts(torch, device: str) -> dict:
    """roofline.count of a small mmFormer (SMALL widths, patch 32, bf16)
    on `device`: the encode of a (48, 40, 36) case's 8 windows, one fuse
    pass and one train step (after one untimed step), each by shapes
    alone."""
    from passion_tpu_torch import roofline
    from passion_tpu_torch.engine.schedule import (make_optimizer,
                                                   set_learning_rate)
    from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
    from passion_tpu_torch.engine.train_loop import make_train_step
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model

    p = 32
    model = init_model(get_model("mmformer", mask_type="idt", patch_size=p,
                                 **SMALL), seed=0)
    rng = np.random.default_rng(0)
    engine = SlidingWindowSweep(model, 4, p, device=device)
    out = roofline.sweep_counts(engine, engine.prepare(
        rng.standard_normal((48, 40, 36, 4)).astype(np.float32)))
    model = model.to(device)
    opt = make_optimizer(model.parameters(), 1e-4)
    set_learning_rate(opt, 2e-4)
    step = make_train_step(model, opt, use_passion=True, with_dropout=True)
    lab = rng.integers(0, 4, (1, p, p, p))
    batch = {"x": torch.from_numpy(rng.standard_normal(
                 (1, 4, p, p, p)).astype(np.float32)).to(device),
             "target": torch.from_numpy(np.moveaxis(np.eye(
                 4, dtype=np.float32)[lab], -1, 1).copy()).to(device),
             "mask": torch.from_numpy(np.asarray(MASK_ARRAY[[9]])).to(
                 device)}
    ones = torch.ones(4, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    step(batch, ones, ones, 4.0, gen)
    out["train"] = roofline.count(lambda: step(batch, ones, ones, 4.0, gen))
    return out


def phase_roofline(torch, fn) -> None:
    """Phase 20: `python -m passion_tpu_torch.roofline` for the backbones
    phase 19's bench left out (ROOFLINE_RUNS: RFNet's sweep, M2FTrans's
    step), each in a process of its own: every program's share of its
    binding floor in (0, 105]% with its bound. Then `small_counts` on the
    card, through K1-K4, and on the CPU, through the plain versions: the
    two counts of each program must be equal, op by op."""
    for program, name, *extra in ROOFLINE_RUNS:
        t0 = time.perf_counter()
        out = _module("passion_tpu_torch.roofline", program, "--model",
                      name, *extra)
        rows = {k: v for k, v in out.items()
                if isinstance(v, dict) and "pct_of_roofline" in v}
        for k, r in rows.items():
            if r["pct_of_roofline"] is None or not 0 < r[
                    "pct_of_roofline"] <= 105 or r["bound"] not in (
                        "mem", "comp"):
                raise AssertionError(f"roofline {program} {name} {k}: {r}")
            log(f"  [{out['chip']}] {name} {k}: {r['tflop']:.4f} TFLOP, "
                f"{r['gb']:.4f} GB, t_comp {r['t_comp'] * 1e3:.3f} ms, "
                f"t_mem {r['t_mem'] * 1e3:.3f} ms, bound {r['bound']}, "
                f"measured {r['t_meas'] * 1e3:.3f} ms (best "
                f"{r['t_best'] * 1e3:.3f}): {r['pct_of_roofline']:.2f}% of "
                f"the floor")
        if program == "sweep":
            log(f"  {name} sweep at roofline "
                f"{out['sweep_roofline_mask_cases_per_s']:.3f} mask-cases/s; "
                f"measured serially "
                f"{out['sweep_measured_serial_mask_cases_per_s']:.4f}")
        log(f"  roofline {program} --model {name}: "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reset_counts(fn)
    card = small_counts(torch, "cuda")
    launched = counts(fn)
    reset_counts(fn)
    host = small_counts(torch, "cpu")
    if min(launched.values()) <= 0 or max(counts(fn).values()) != 0:
        raise AssertionError(f"K1-K4 launches: card {launched}, CPU "
                             f"{counts(fn)}")
    for prog in ("encode", "fuse", "train"):
        c, h = card[prog], host[prog]
        if (c["bytes"], c["flops"], c["by_op"]) != (h["bytes"], h["flops"],
                                                    h["by_op"]):
            diff = {k: (c["by_op"].get(k), h["by_op"].get(k))
                    for k in set(c["by_op"]) | set(h["by_op"])
                    if c["by_op"].get(k) != h["by_op"].get(k)}
            raise AssertionError(
                f"small mmFormer {prog}: card {c['bytes']} B, "
                f"{c['flops']} FLOP; CPU {h['bytes']} B, {h['flops']} FLOP; "
                f"ops that differ (card, CPU): {diff}")
        log(f"  small mmFormer {prog}: {c['bytes']} B, {c['flops']} FLOP on "
            f"the card and on the CPU; hand kernels "
            f"{ {k: v for k, v in c['by_op'].items() if k[0] == 'K'} } B")
    log(f"  K1-K4 launches in the card's counts {launched}; "
        f"{time.perf_counter() - t0:.1f} s")


def k5_one(root: str, saved: str | None = None) -> int:
    """`--k5-one ROOT [BATCH.npy]`: K5 of the checkout at ROOT on the
    seeded inputs of `--k5`, or on the (15, 240, 240, 155) uint8 batch
    saved in BATCH.npy (phase 6b's) in place of the seeded one; one JSON
    line."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from passion_tpu_torch.data.synth import make_case
    from passion_tpu_torch.ops import edt

    if not edt.__file__.startswith(root):
        raise AssertionError(f"{edt.__file__} is not under {root}")
    if saved is None:
        batch = np.random.default_rng(0).integers(0, 4, (15, *VOLUME)).astype(
            np.uint8)
    else:
        batch = np.load(saved)
    batch = torch.from_numpy(batch).cuda()
    one = torch.from_numpy(make_case(VOLUME, np.random.default_rng(1))[1])[
        None].cuda()
    for x in (batch, one):
        for classes in ((1, 2, 3), (3,)):
            if not torch.equal(edt.edt_sq(x, classes),
                               edt.edt_sq_plain(x, classes)):
                raise AssertionError(f"K5 of {root} differs from its plain "
                                     f"version on {tuple(x.shape)}")
    run = dict(root=root,
               ms=kernel_ms(lambda: edt.edt_sq(batch, (1, 2, 3)), 10),
               ms_one=kernel_ms(lambda: edt.edt_sq(one, (1, 2, 3)), 10),
               kernels=device_kernels_ms(
                   lambda: edt.edt_sq(batch, (1, 2, 3)), 5),
               kernels_one=device_kernels_ms(
                   lambda: edt.edt_sq(one, (1, 2, 3)), 5))
    print(json.dumps(run), flush=True)
    return 0


def k5_turns(roots: list[str]) -> int:
    """`--k5 ROOT ...`: `--k5-one` for each ROOT in turn, each in its own
    process; their lines, then one JSON line with every run."""
    from passion_tpu_torch import bench

    card = bench.card_line()
    log(card)
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--k5-one", root], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            raise SystemExit(f"--k5-one {root} failed:\n{proc.stdout}"
                             f"{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        log(f"  {root}: K5 {r['ms']:.4f} ms at (15, 240, 240, 155), "
            f"{r['ms_one']:.4f} ms for one volume; by kernel: " + "; ".join(
                f"{k[:50]} {v:.4f} / {r['kernels_one'].get(k, 0):.4f} ms"
                for k, v in r["kernels"].items()))
    log(card)
    print(json.dumps({"k5_turns": runs}), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--k5-one":
        return k5_one(*sys.argv[2:4])
    if not os.path.isdir(os.path.join(REPO, "passion_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the repo "
                         "(passion_tpu_torch/ not found beside it)")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    if len(sys.argv) > 2 and sys.argv[1] == "--k5":
        return k5_turns(sys.argv[2:])
    t_start = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    from passion_tpu_torch import bench

    card = bench.card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"== 1. device: {kind} x {torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(card)
    peaks = bench.PEAKS.get(kind)
    if peaks is None:
        peaks = bench.PEAKS["NVIDIA H100 80GB HBM3"]
        log(f"  no peaks for {kind!r}: the kernels' bounds take the H100 "
            f"SXM data sheet's")

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
    log("== 3c. K6 reflect pad vs plain version, bit for bit; timing")
    t6 = phase_pad(torch, peaks)
    errs.update(K3=0.0, K4=0.0)
    by_path = {k: {} for k in COUNTED}  # launches on each backbone's paths
    k5_by_path = {}  # K5's launches in each eval CLI run
    pad_share = {}  # K6's share of each sweep's kernel time (4b, 10b, 11b)
    title = {"mmformer": "mmFormer", "rfnet": "RFNet", "m2ftrans": "M2FTrans"}
    number = {"mmformer": ("4", "5"), "rfnet": ("10", "10c"),
              "m2ftrans": ("11", "11c")}
    for name in BACKBONES:
        main_no, cli_no = number[name]
        log(f"== {main_no}. {title[name]} 15-mask sweep, full width, bf16")
        model, launches, engine, prepared, labels, rate = phase_main_path(
            torch, fn, card, errs, name)
        if name == "mmformer":
            sweep_labels = labels  # phase 16 holds the sharded sweep to it
        del labels
        for k in COUNTED:
            by_path[k][f"sweep:{name}"] = launches[k]
        log(f"== {main_no}b. profile: {title[name]}, one encode and one "
            f"fuse pass")
        pad_share[name] = phase_profile(torch, engine, prepared, card, name)
        del engine, prepared
        log(f"== {cli_no}. entry point: passion_tpu_torch.eval --model "
            f"{name}")
        (k5_by_path[f"eval_cli:{name}"],
         by_path["K6"][f"eval_cli:{name}"]) = phase_entry_point(
            torch, fn, card, model, name,
            rate if name == "mmformer" else None)
        if name == "mmformer":
            log("== 6. kernel timing")
            t = phase_timing(torch, fn, errs, peaks)
            log("== 6b. K5 distance transform and the device scorer")
            t5 = phase_distance_transform(torch, peaks, sweep_labels)
        del model
        torch.cuda.empty_cache()

    log("== 3b. backward kernels vs plain version")
    phase_backward_kernels(torch, fn, errs)
    number = {"mmformer": ("7", "8"), "rfnet": ("12", "12c"),
              "m2ftrans": ("13", "13c")}
    for name in BACKBONES:
        main_no, cli_no = number[name]
        log(f"== {main_no}. {title[name]} PASSION train step, full width, "
            f"bf16")
        run = phase_train(torch, fn, card, name)
        for k in COUNTED:
            by_path[k][f"train_steps:{name}"] = run["launches"][k]
        if name == "mmformer":
            mmformer_step_ms = run["step_ms"]
        log(f"== {main_no}b. profile: {title[name]}, one train step")
        phase_train_profile(torch, run, card, name)
        del run
        torch.cuda.empty_cache()
        phase_train_float32(torch, fn, name)
        log(f"== {cli_no}. entry point: passion_tpu_torch.train --model "
            f"{name}")
        phase_train_entry(torch, fn, name, resume=name == "mmformer")
        if name == "mmformer":
            log("== 9. backward kernel timing")
            tb = phase_backward_timing(torch, fn, errs, peaks)

    log("== 14. single-mask engine (SlidingWindowInference), mmFormer, full "
        "width, bf16")
    single = phase_single_mask(torch, fn, card, errs)
    torch.cuda.empty_cache()
    log("== 15. validation: make_val_step under 15 masks, train CLI "
        "--use_valid")
    val = phase_validation(torch, fn, card, errs)
    torch.cuda.empty_cache()
    log("== 16. data parallelism over torch.distributed (world size "
        f"{1 if torch.cuda.device_count() < 2 else '1 and 2'})")
    dp = phase_data_parallel(torch, fn, card, mmformer_step_ms, sweep_labels)
    del sweep_labels
    torch.cuda.empty_cache()
    log(f"== 16b. python -m passion_tpu_torch.multichip, "
        f"{min(torch.cuda.device_count(), 4)} card(s)")
    multi = phase_multichip(torch)
    for k in COUNTED:
        by_path[k]["single_mask:mmformer"] = single[k]
        by_path[k]["val_15_masks:mmformer"] = val[k]
        by_path[k]["train_steps_dp:mmformer"] = dp["train"][k]
        by_path[k]["sweep_dp:mmformer"] = dp["sweep"][k]
        for path, launches in multi.items():
            by_path[k][path] = launches[k]
    log("== 17. reference checkpoint import (upstream .pth), published "
        "widths; mmFormer's 15-mask sweep under it")
    for name in BACKBONES:
        launches = phase_import(torch, fn, card, errs, name)
        for k in COUNTED:
            by_path[k][f"import:{name}"] = launches[k]
        torch.cuda.empty_cache()
    log("== 18. preprocessing CLI (split, imbmr) on phase 8's npy root")
    phase_preprocess()
    torch.cuda.empty_cache()
    log("== 19. python -m passion_tpu_torch.bench and .profile")
    phase_bench()
    log("== 20. python -m passion_tpu_torch.roofline; byte counts on the "
        "card and on the CPU")
    phase_roofline(torch, fn)
    for k in COUNTED:
        log(f"  {k} launches by path: {by_path[k]}")
    log(f"  K5 launches by path: {k5_by_path}")

    fwd, bwd = ("passion_tpu_torch/csrc/fused_norm.cu",
                "passion_tpu_torch/csrc/fused_norm_bwd.cu")
    kernels = [
        dict(name="K1 instance_norm_lrelu stats", route="cuda", source=fwd,
             replaces="passion_tpu/ops/fused_norm.py:84",
             launches=by_path["K1"]["sweep:mmformer"],
             launches_by_path=by_path["K1"],
             max_abs_err=errs["K1"], ms=t["k1"], plain_ms=t["p1"],
             bound_ms=t["b1"], bound_by=t["by1"], library_ms=t["lib1"]),
        dict(name="K2 instance_norm_lrelu apply", route="cuda", source=fwd,
             replaces="passion_tpu/ops/fused_norm.py:101",
             launches=by_path["K2"]["sweep:mmformer"],
             launches_by_path=by_path["K2"],
             max_abs_err=errs["K2"], ms=t["k2"], plain_ms=t["p2"],
             bound_ms=t["b2"], bound_by=t["by2"], library_ms=None),
        dict(name="K3 instance_norm_lrelu backward row sums", route="cuda",
             source=bwd, replaces="passion_tpu/ops/fused_norm.py:221",
             launches=by_path["K3"]["train_steps:mmformer"],
             launches_by_path=by_path["K3"],
             max_abs_err=errs["K3"], ms=tb["k3"], plain_ms=tb["p3"],
             bound_ms=tb["b3"], bound_by=tb["by3"], library_ms=tb["lib"]),
        dict(name="K4 instance_norm_lrelu backward apply", route="cuda",
             source=bwd, replaces="passion_tpu/ops/fused_norm.py:221",
             launches=by_path["K4"]["train_steps:mmformer"],
             launches_by_path=by_path["K4"],
             max_abs_err=errs["K4"], ms=tb["k4"], plain_ms=tb["p4"],
             bound_ms=tb["b4"], bound_by=tb["by4"], library_ms=None),
        dict(name="K5 distance transform (HD95)", route="cuda",
             source="passion_tpu_torch/csrc/edt.cu",
             replaces="passion_tpu/metrics.py:80",
             launches=k5_by_path["eval_cli:mmformer"],
             launches_by_path=k5_by_path, launches_per_case=(
                 k5_by_path["eval_cli:mmformer"] / CLI_CASES),
             max_abs_err=t5["err"], ms=t5["ms"], plain_ms=t5["plain_ms"],
             bound_ms=t5["bound_ms"], bound_by=t5["bound_by"],
             library_ms=None, ms_one_volume=t5["ms_one"],
             bound_ms_one_volume=t5["bound_ms_one"],
             scipy_ms_one_volume=t5["scipy_ms"],
             score_15_masks_ms=t5["score_ms"], passes_ms=t5["passes"],
             passes_ms_one_volume=t5["passes_one"],
             bytes_per_voxel=K5_PASS_BYTES, ptxas=t5["ptxas"]),
        dict(name="K6 reflect pad", route="cuda",
             source="passion_tpu_torch/csrc/reflect_pad.cu",
             replaces="passion_tpu/models/layers.py:181",
             launches=by_path["K6"]["sweep:mmformer"],
             launches_by_path=by_path["K6"], max_abs_err=t6["err"],
             ms=t6["ms"], plain_ms=t6["plain_ms"], bound_ms=t6["bound_ms"],
             bound_by=t6["bound_by"], library_ms=t6["library_ms"],
             shape=list(t6["shape"]), by_shape=t6["rows"],
             sweep_kernel_share=pad_share),
    ]
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                   "bound_ms")):
            raise AssertionError(f"non-finite timing in {k}")
    log(f"  all phases {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
