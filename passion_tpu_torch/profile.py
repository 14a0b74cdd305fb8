"""Traces of the port's workloads on the card (counterpart of
`scripts/profile.py`, `trace_fuse.py`, `trace_train.py`,
`fuse_op_table.py`, `xplane_stats.py`, `profile_fuse.py` and
`profile_sweep_breakdown.py`, which trace the TPU programs):

  python -m passion_tpu_torch.profile {sweep,fuse,train,single}
      [--model mmformer|rfnet|m2ftrans] [--out DIR] [--top N]

Each mode builds its workload at the backbone's published width (seed-0
weights, bench.py's data: `bench.volume()`, `bench.train_batch()`), runs
it once untimed (cuDNN's set-up), then once under `torch.profiler` with
CPU and CUDA activities:

  * sweep: one 15-mask sweep of the 240x240x155 case (encode + 15 fuse
    passes + the labels' copies to the host);
  * fuse: one fuse pass (full mask) from the case's stored features;
  * train: one bf16 PASSION step (bs 1, 80^3);
  * single: the single-mask engine's whole forward of the case's one chunk
    of 75 windows, full mask.

It writes the chrome trace to `DIR/{mode}_{model}.json`, logs the kernel
table and prints one JSON line: the wall time (host clock, ended by a
synchronize), the time between two CUDA events around the call, the summed
kernel time and its ratio to the wall time (the device's busy share: the
port's kernels run on one stream, so they do not overlap), the kernel
launches, the norm kernels' (K1-K4) time and share, the reflect pad's (K6)
time and share, and the `top` kernels by device time with their calls.

A trace is checked before it is reported: the kernel table's sum must
agree with the chrome trace's device events within 1%. Both come from
kineto's records, which now and then lack the first kernels a profiling
session launches (on an H100 with torch 2.11, up to 40% of an encode's
kernel time); only the CUDA events around the call and the launches on
the host side show the gap. So a session first runs an untraced warm-up
step of `PRIMERS` tiny kernels, then records the call.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from functools import partial

import numpy as np
import torch

TOP = 15  # kernels listed per trace
NORM_KERNELS = ("stats_partial_kernel", "stats_merge_kernel", "apply_kernel",
                "bwd_partial_kernel", "bwd_merge_kernel", "bwd_apply_kernel")
PAD_KERNEL = "reflect_pad3d_kernel"  # K6 (csrc/reflect_pad.cu)
MODES = ("sweep", "fuse", "train", "single")
PRIMERS = 8  # kernels of the untraced warm-up step of a session
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # chrome trace events


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_times(prof) -> dict[str, tuple[float, int]]:
    """{kernel name: (device ms, calls)} of a torch.profiler trace."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        # user ranges (the optimizer's step) show on the device timeline
        # too, over kernels already counted: skip them
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False) or e.key.startswith(
                    "Optimizer."):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:  # older torch
            us = e.self_cuda_time_total
        out[e.key] = (us / 1e3, e.count)
    return out


def chrome_device_ms(path: str) -> float:
    """Summed duration (ms) of a chrome trace's device events: kernels,
    copies, memsets."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e["dur"] for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS) / 1e3


def report_trace(t: dict, label: str, card: str, top: int = TOP) -> dict:
    """Log a trace's (`trace`) device busy share, its kernel launches, the
    norm kernels' share and the `top` kernels that take the most device
    time; return the totals and the per-kernel table. Raises if the kernel
    table and the chrome trace disagree by more than 1%."""
    kernels = kernel_times(t["prof"])
    busy = sum(ms for ms, _ in kernels.values())
    calls = sum(n for _, n in kernels.values())
    norm = sum(ms for k, (ms, _) in kernels.items()
               if any(s in k for s in NORM_KERNELS))
    pad = sum(ms for k, (ms, _) in kernels.items() if PAD_KERNEL in k)
    chrome_ms = t["chrome_ms"]
    log(f"  [{card}] {label}: wall {t['wall_ms']:.3f} ms, CUDA events "
        f"{t['event_ms']:.3f} ms, kernels {busy:.3f} ms (busy share "
        f"{busy / t['wall_ms']:.3f}; chrome trace {chrome_ms:.3f} ms), "
        f"{calls} kernel launches; norm "
        f"kernels {norm:.3f} ms ({norm / max(busy, 1e-9):.3f} of kernel "
        f"time), reflect pad K6 {pad:.3f} ms ({pad / max(busy, 1e-9):.3f})")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    for name, (ms, n) in ranked:
        log(f"    {ms:9.3f} ms {ms / max(busy, 1e-9):6.3f} x{n:<5d} "
            f"{name[:110]}")
    if not math.isclose(busy, chrome_ms, rel_tol=0.01):
        raise AssertionError(
            f"{label}: the kernel table ({busy:.3f} ms) and the chrome "
            f"trace ({chrome_ms:.3f} ms) disagree")
    return dict(wall_ms=t["wall_ms"], event_ms=t["event_ms"], busy_ms=busy,
                chrome_ms=chrome_ms, norm_ms=norm, pad_ms=pad, calls=calls,
                kernels=kernels, top=ranked)


def trace(fn, path: str) -> dict:
    """One call of `fn` under torch.profiler (CPU and CUDA activities),
    after an untraced warm-up step of PRIMERS kernels; its chrome trace
    written to `path`: {prof, wall_ms (host clock, up to a synchronize),
    event_ms (two CUDA events around the call), chrome_ms
    (`chrome_device_ms`)}."""
    from torch.profiler import ProfilerActivity, profile, schedule

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    primer = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path),
                 acc_events=True) as prof:
        for _ in range(PRIMERS):
            primer.add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    return dict(prof=prof, wall_ms=wall_ms, event_ms=start.elapsed_time(end),
                chrome_ms=chrome_device_ms(path), path=path)


def workload(mode: str, name: str):
    """The call that `mode` traces, after its untimed first run."""
    from passion_tpu_torch import bench
    from passion_tpu_torch.engine.sliding_window import (
        SlidingWindowInference, SlidingWindowSweep)
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model

    if mode == "train":
        fn = bench.train_step_fn(name)
        for _ in range(2):
            fn()
        return fn
    model = init_model(get_model(name, mask_type="idt"), seed=0)
    full = np.ones(4, bool)
    if mode == "single":
        engine = SlidingWindowInference(model, num_cls=4, patch=bench.PATCH)
        prepared = engine.prepare(bench.volume())
        fn = partial(engine.infer_labels, prepared, full)
    else:
        engine = SlidingWindowSweep(model, num_cls=4, patch=bench.PATCH)
        prepared = engine.prepare(bench.volume())
        if mode == "sweep":
            masks = [np.asarray(m) for m in MASK_ARRAY]
            fn = partial(engine.sweep_labels, prepared, masks)
        else:
            fts = engine.encode_case(prepared)
            fn = partial(engine.labels_device, prepared, fts, full)
    fn()
    return fn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="torch.profiler trace and "
                                "kernel table of one workload of the port")
    p.add_argument("mode", choices=MODES)
    p.add_argument("--model", default="mmformer",
                   choices=("mmformer", "rfnet", "m2ftrans"))
    p.add_argument("--out", default=os.path.join("build", "profile"),
                   help="directory of the chrome trace")
    p.add_argument("--top", type=int, default=TOP)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: tracing the card needs a CUDA device "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from passion_tpu_torch import bench

    card = bench.card_line()
    fn = workload(args.mode, args.model)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.mode}_{args.model}.json")
    t = report_trace(trace(fn, path), f"{args.model} {args.mode}", card,
                     args.top)
    print(json.dumps({
        "mode": args.mode, "model": args.model,
        "wall_ms": round(t["wall_ms"], 3),
        "event_ms": round(t["event_ms"], 3),
        "kernel_ms": round(t["busy_ms"], 3),
        "chrome_kernel_ms": round(t["chrome_ms"], 3),
        "busy_share": round(t["busy_ms"] / t["wall_ms"], 4),
        "launches": t["calls"], "norm_ms": round(t["norm_ms"], 3),
        "norm_share": round(t["norm_ms"] / max(t["busy_ms"], 1e-9), 4),
        "pad_ms": round(t["pad_ms"], 3),
        "pad_share": round(t["pad_ms"] / max(t["busy_ms"], 1e-9), 4),
        "top": [{"name": k, "ms": round(ms, 3), "calls": n}
                for k, (ms, n) in t["top"]],
        "trace": path, "chip": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
