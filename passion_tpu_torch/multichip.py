"""Data parallelism on N cards, held against one card: the port's
counterpart of `__graft_entry__.dryrun_multichip` (the JAX package's
data-parallel PASSION step of every backbone and its sharded sweep on n
devices), at full width.

  python -m passion_tpu_torch.multichip --cards N [N ...]
      [--models rfnet mmformer m2ftrans] [--phases step time sweep cli]
      [--seed 0] [--out build/multichip] [--device cpu --small]

The card counts run in turn. The processes of count N see the first N
cards only (CUDA_VISIBLE_DEVICES). N ranks are spawned through
`parallel.world.launch` (NCCL on the card, gloo with `--device cpu`); each
builds the kernel library on first use, all at once, before the first
collective. For each backbone at its published width (patch 80, seed-0
weights, `init_model`) the ranks run:

  step   one float32 PASSION step (TF32 off, dropout off) of a global batch
         of N samples, one per rank (full masks on even rows, one random
         modality on the others, one-hot targets, from `--seed`), against
         one process on rank 0's card over the whole batch
         (`bench.train_setup`): loss rtol 1e-5; summed gradients relative
         L2 5e-3 over all tensors and 2e-2 per tensor (5e-2 for RFNet's
         ModalFusion); every rank's updated params equal rank 0's; K1-K4
         launches per rank those of one step on one card (53 / 70 / 55),
         K6's 1 (the raw image's pad);
  time   the bf16 step as `fit` runs it (dropout on; RFNet has none): N
         ranks at bs 1 each against one process at bs 1 on rank 0's card,
         timed in turns (one, dp, dp, one, ...); global samples/s, each
         rank's median step ms and their spread; `GradBuffer.all_reduce_`
         alone (CUDA events); each rank's peak memory over the
         data-parallel steps;
  sweep  the 15-mask sweep of `bench.volume()` in bf16, sharded over the
         ranks at the automatic window batch (`_auto_window_batch(75, N)`:
         one chunk per rank), against one card at the same window batch,
         so only the order of the float32 sums differs: coverage-averaged
         probabilities atol 1e-5; labels equal wherever the one card's top
         two probabilities are more than 1e-5 apart (the voxels below that
         margin that differ are counted); K1/K2 and K6 launches per rank
         those of its chunks (363 / 747 / 435 and 135 / 282 / 195 for one
         chunk); then mask-cases/s against one card at its own automatic
         batch (75), in turns;
         encode ms and mean fuse-pass ms (with its all-reduce) per rank;
         the 142.8 MB accumulator's all-reduce alone; each rank's peak
         memory.

Then, in processes of their own, each backbone's CLIs at N (the
backbones' runs of one CLI started together):

  cli    `python -m passion_tpu_torch.train --data_parallel N --batch_size
         N`, 1 epoch x 2 iterations on `data.synth` cases (rank 0 writes
         the checkpoint and the 15-mask CSV); `python -m
         passion_tpu_torch.eval --data_parallel N` on 2 synthetic
         240x240x155 cases, its CSV against the one-card CSV of the same
         weights (run once per backbone, beside the first count's train
         CLIs). Both runs take the window batch that splits the windows
         over 4 ranks (19 of 75), so every window's arithmetic is the same
         at every N: Dice within 1e-4 and HD95 within 0.5 where a label
         flipped at a near-tie. The CLIs' end-to-end
         mask-cases/s are reported (the host's HD95 bounds them).

The ranks measure; this process judges: one line per check
(`check <backbone> x<N> <what>: ok|FAIL ...`), then one JSON line with
every result by backbone and N. The exit code is non-zero if any check
failed. `--device cpu --small` runs the same steps on gloo ranks at the
fast-tier widths (patch 32 for the float32 step, 16 for the timed steps,
the sweep and the CLIs; basic_dims 4, trans_dim 32, mlp_dim 64, heads 4,
a backbone dropping the widths it does not have) and small volumes, with
one timed turn; nothing runs on the CPU unless asked.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from passion_tpu_torch import bench
from passion_tpu_torch.config import WIDTH_FLAGS
from passion_tpu_torch.engine.sliding_window import (SlidingWindowSweep,
                                                     _auto_window_batch,
                                                     coverage_weight,
                                                     window_coords)
from passion_tpu_torch.engine.train_loop import _to_device
from passion_tpu_torch.masks import MASK_ARRAY
from passion_tpu_torch.ops import _build
from passion_tpu_torch.ops import fused_norm, pad
from passion_tpu_torch.parallel import world as pw
from passion_tpu_torch.parallel.world import GradBuffer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONES = ("rfnet", "mmformer", "m2ftrans")
PHASES = ("step", "time", "sweep", "cli")
KERNELS = ("K1", "K2", "K3", "K4", "K6")
WRAPPERS = fused_norm.WRAPPERS + (pad.reflect_pad3d,)  # in KERNELS' order
# instance_norm_lrelu calls of each backbone, counted from the code: per
# PASSION train step (each with one backward), per features() chunk and
# per fuse_inference() chunk
TRAIN_SITES = {"mmformer": 53, "rfnet": 70, "m2ftrans": 55}
SWEEP_SITES = {"mmformer": (18, 23), "rfnet": (12, 49), "m2ftrans": (15, 28)}
# reflect pads run by K6, counted from the code (the one table of them;
# chip_smoke.py reads it too): per PASSION train step (the encoders' first
# conv pads the raw image, which needs no gradient; the other pads run
# under autograd, as autograd's own pad), per features() chunk, per
# fuse_inference() chunk, per forward (the single-mask engine's chunk) and
# per validation mask (mmFormer: the forward and the sep decoder)
PAD_SITES = {
    "mmformer": dict(train=1, encode=15, fuse=8, forward=23, val=31),
    "rfnet": dict(train=1, encode=12, fuse=18, forward=30),
    "m2ftrans": dict(train=1, encode=15, fuse=12, forward=27),
}
# the step's tolerances (PERF.md §2): loss rtol; gradients' relative L2
# over all tensors, per tensor, per tensor of RFNet's ModalFusion
LOSS_RTOL, GRAD_GLOBAL, GRAD_TENSOR, GRAD_MODAL_FUSION = 1e-5, 5e-3, 2e-2, 5e-2
PROB_ATOL = 1e-5  # the sweep's coverage-averaged probabilities
MARGIN = 1e-5  # a label may differ only where the top two are this close
# the eval CLI's CSV where a near-tie label flipped (tests/test_torch_
# parallel.py's bounds)
DICE_ATOL, HD95_ATOL = 1e-4, 0.5
SMALL_KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)
EVAL_CASES = 2
# the CLIs' window batch splits a case's windows over this many ranks at
# every count (19 of the 75), so every window's arithmetic is the same at
# every N and one card holds three eval runs at once
EVAL_SHARDS = 4


def sizes(small: bool) -> dict:
    """Patch sizes, volumes and repetitions of a full or a `--small` run
    (the CLIs take the sweep's patch)."""
    if small:
        return dict(step_patch=32, time_patch=16, sweep_patch=16,
                    volume=(24, 24, 20), train_shape=(32, 32, 24), warmup=1,
                    turns=1, steps=1, reps=2, cli_timeout=600)
    return dict(step_patch=bench.PATCH, time_patch=bench.PATCH,
                sweep_patch=bench.PATCH, volume=bench.VOLUME,
                train_shape=(96, 96, 80), warmup=2, turns=2, steps=5,
                reps=10, cli_timeout=1200)


def model_kw(name: str, small: bool) -> dict:
    """The widths of `name` in a `--small` run (none: published)."""
    if not small:
        return {}
    return {k: v for k, v in SMALL_KW.items() if k in WIDTH_FLAGS[name]}


def global_batch(n: int, patch: int, seed: int) -> dict:
    """`_dryrun_one`'s batch (__graft_entry__.py:221-233), channels-first:
    n samples; full masks on even rows, one random modality on the others;
    one-hot targets with every class present."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((n, 4), bool)
    masks[np.arange(n), rng.integers(0, 4, n)] = True
    masks[::2] = True
    lab = rng.integers(0, 4, size=(n, patch, patch, patch))
    lab[:, 0, 0, :4] = np.arange(4)
    x = rng.standard_normal((n, patch, patch, patch, 4)).astype(np.float32)
    return {"x": np.moveaxis(x, -1, 1).copy(),
            "target": np.moveaxis(np.eye(4, dtype=np.float32)[lab], -1,
                                  1).copy(),
            "mask": masks}


def sweep_volume(shape, small: bool) -> np.ndarray:
    """`bench.volume()`, or the same draw at a `--small` shape."""
    if not small:
        return bench.volume()
    return np.random.default_rng(0).standard_normal(
        tuple(shape) + (4,)).astype(np.float32)


def label_diff(labels, ref_labels, gap) -> tuple[int, int]:
    """(voxels whose labels differ where the reference's top-two gap is
    above MARGIN, those that differ at or below it)."""
    differ = np.asarray(labels) != np.asarray(ref_labels)
    wide = differ & (np.asarray(gap) > MARGIN)
    return int(wide.sum()), int(differ.sum() - wide.sum())


def grad_errors(ref: dict, got: dict) -> dict:
    """Relative L2 of `got` against `ref` over all tensors and per tensor
    (where the reference's norm is above 1e-6), the tensors over their
    bound, the worst."""
    num = den = 0.0
    rels = []
    for n, g in ref.items():
        d = (got[n] - g).norm().item()
        gn = g.norm().item()
        num, den = num + d * d, den + gn * gn
        if gn > 1e-6:
            rels.append((d / gn, n))
    rels.sort(reverse=True)
    over = [(r, n) for r, n in rels
            if r > (GRAD_MODAL_FUSION if ".modal_fusion_" in n
                    else GRAD_TENSOR)]
    return dict(global_rel=math.sqrt(num / den) if den else 0.0,
                worst=rels[0] if rels else (0.0, ""), over=over[:5])


def csv_diff(got_rows, ref_rows) -> dict:
    """Rows of two evaluator CSVs that differ, and the largest Dice and
    HD95 differences."""
    if len(got_rows) != len(ref_rows):
        return dict(rows=len(got_rows), ref_rows=len(ref_rows), differ=-1,
                    dice=math.inf, hd95=math.inf)
    differ, dice, hd95 = 0, 0.0, 0.0
    for g, r in zip(got_rows, ref_rows):
        if g == r:
            continue
        differ += 1
        if len(r) < 8 or len(g) != len(r):
            return dict(rows=len(got_rows), ref_rows=len(ref_rows),
                        differ=differ, dice=math.inf, hd95=math.inf)
        dg, dr = np.float64(g), np.float64(r)
        d = np.where(np.isnan(dg) & np.isnan(dr), 0.0, np.abs(dg - dr))
        d[np.isnan(d)] = math.inf  # a NaN on one side only
        dice, hd95 = max(dice, d[:4].max()), max(hd95, d[4:].max())
    return dict(rows=len(got_rows), ref_rows=len(ref_rows), differ=differ,
                dice=float(dice), hd95=float(hd95))


# --- the ranks ------------------------------------------------------------

@contextlib.contextmanager
def _full_float32():
    """TF32 off for convolutions and matmuls, restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _sync(world) -> None:
    """Every rank waits here for every other (and for its own card)."""
    world.all_reduce_(torch.zeros(1, device=world.device))
    if world.device.type == "cuda":
        torch.cuda.synchronize(world.device)


def _ms(world, fn) -> float:
    """Milliseconds of `fn()`: between CUDA events on the card (the
    device's time and the gaps the host leaves it), on the host clock on
    the CPU."""
    if world.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _wall_ms(world, fn) -> float:
    """Milliseconds of `fn()` on the host clock between two synchronizes."""
    cuda = world.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(world.device)
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize(world.device)
    return (time.perf_counter() - t0) * 1e3


def _reset_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def _counts() -> dict:
    return {k: w.launches for k, w in zip(KERNELS, WRAPPERS)}


def _reset_peak(world) -> None:
    if world.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(world.device)


def _peak_gib(world):
    if world.device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(world.device) / 2 ** 30


def _free(world) -> None:
    if world.device.type == "cuda":
        torch.cuda.empty_cache()


def _setup(world, name, opts, patch, dtype, dropout, dp: bool):
    return bench.train_setup(name, dtype, dropout, world if dp else None,
                             world.device, patch,
                             **model_kw(name, opts["small"]))


def rank_step(world, name: str, opts: dict) -> dict:
    """Phase `step` on this rank (module docstring)."""
    n, patch = world.size, opts["sizes"]["step_patch"]
    host = global_batch(n, patch, opts["seed"])
    ones = torch.ones(4, device=world.device)
    out = {}
    with _full_float32():
        if world.is_main:  # one process over the whole global batch
            model, step = _setup(world, name, opts, patch, None, False,
                                 dp=False)
            m = step(_to_device(host, n, world.device), ones, ones, 4.0,
                     None, False)
            out["loss_one"] = m["loss"].item()
            ref = {k: p.grad.detach().clone()
                   for k, p in model.named_parameters()}
            del model, step, m
            _free(world)
        _sync(world)
        model, step = _setup(world, name, opts, patch, None, False,
                             dp=True)
        _reset_counts()
        m = step(_to_device(host, n, world.device, world), ones, ones, 4.0,
                 None, False)
        loss = m["loss"].item()
        out["launches"] = _counts()
    out["loss"] = loss
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    first = flat.clone()
    torch.distributed.broadcast(first, 0)
    out["params_vs_rank0"] = (flat - first).abs().max().item()
    if world.is_main:
        out.update(grad_errors(ref, {k: p.grad for k, p in
                                     model.named_parameters()}))
        out["loss_rel"] = abs(loss - out["loss_one"]) / abs(out["loss_one"])
    del model, step, m, flat, first
    _free(world)
    return out


def rank_time(world, name: str, opts: dict) -> dict:
    """Phase `time` on this rank (module docstring)."""
    sz = opts["sizes"]
    patch = sz["time_patch"]
    host = global_batch(world.size, patch, opts["seed"])
    ones = torch.ones(4, device=world.device)
    dropout = name != "rfnet"
    runs = {}
    for path in ("dp", "one"):
        if path == "one" and not world.is_main:
            continue
        if path == "dp":
            _reset_peak(world)
        model, step = _setup(world, name, opts, patch, torch.bfloat16,
                             dropout, dp=path == "dp")
        batch = _to_device(host, world.size, world.device, world) \
            if path == "dp" else _to_device(
                {k: v[:1] for k, v in host.items()}, 1, world.device)
        gen = torch.Generator(device=world.device).manual_seed(
            1 + world.rank)

        def one(step=step, batch=batch, gen=gen):
            return step(batch, ones, ones, 4.0, gen, False)

        for _ in range(sz["warmup"]):
            m = one()
        if not math.isfinite(m["loss"].item()):
            raise AssertionError(f"non-finite {path} loss on rank "
                                 f"{world.rank}")
        runs[path] = dict(step=one, model=model, ms=[])
        if path == "dp":
            peak = _peak_gib(world)

    for path in ("one", "dp", "dp", "one") * sz["turns"]:
        _sync(world)
        if path in runs:
            run = runs[path]
            run["ms"].append(_ms(world, lambda: [
                run["step"]() for _ in range(sz["steps"])]) / sz["steps"])
    _sync(world)

    # the gradient all-reduce alone, on the data-parallel model's params
    grads = GradBuffer(runs["dp"]["model"].parameters(), world)
    ar = []
    for i in range(sz["reps"] + 2):
        _sync(world)
        t = _ms(world, grads.all_reduce_)
        if i >= 2:
            ar.append(t)
    out = dict(dp_ms=runs["dp"]["ms"],
               dp_median_ms=float(np.median(runs["dp"]["ms"])),
               allreduce_ms=float(np.median(ar)),
               allreduce_mb=grads.flat.numel() * grads.flat.element_size()
               / 1e6, n_params=int(grads.flat.numel()), peak_gib=peak)
    if world.is_main:
        out.update(one_ms=runs["one"]["ms"],
                   one_median_ms=float(np.median(runs["one"]["ms"])))
    del runs, grads
    _free(world)
    return out


def rank_sweep(world, name: str, opts: dict) -> dict:
    """Phase `sweep` on this rank (module docstring)."""
    from passion_tpu_torch.models import get_model, init_model

    sz = opts["sizes"]
    patch = sz["sweep_patch"]
    model = init_model(get_model(name, mask_type="idt", patch_size=patch,
                                 **model_kw(name, opts["small"])), seed=0)
    vol = sweep_volume(sz["volume"], opts["small"])
    masks = [np.asarray(m) for m in MASK_ARRAY]
    engine = SlidingWindowSweep(model, 4, patch, world=world)
    prepared = engine.prepare(vol)
    wb = prepared["window_batch"]
    out = dict(window_batch=wb, chunks=[len(c) for c in engine._rank_chunks(prepared)])
    if world.is_main:  # one card: the same chunks; its own automatic batch
        one = SlidingWindowSweep(model, 4, patch, device=world.device)
        one_prep = one.prepare(vol)
        ref_prep = dict(one_prep, window_batch=wb)
        out["one_window_batch"] = one_prep["window_batch"]
    del model
    _sync(world)
    _reset_counts()
    labels = engine.sweep_labels(prepared, masks)
    out["launches"] = _counts()
    if world.is_main:
        ref_labels = one.sweep_labels(ref_prep, masks)

    # coverage-averaged probabilities of every mask against one card's
    fts = engine.encode_case(prepared)
    if world.is_main:
        ref_fts = one.encode_case(ref_prep)
        wgt = torch.from_numpy(coverage_weight(
            prepared["eff"], prepared["eff"], patch)).to(world.device)
        h, w, z = prepared["shape"]
        err, wide, narrow = 0.0, 0, 0
    for j, m in enumerate(masks):
        acc = engine.sum_masked(prepared, fts, m)
        if not world.is_main:
            continue
        got = acc / wgt
        ref = one.sum_masked(ref_prep, ref_fts, m) / wgt
        err = max(err, (got - ref).abs().max().item())
        top2 = ref[:, :h, :w, :z].topk(2, dim=0).values
        a, b = label_diff(labels[j], ref_labels[j],
                          (top2[0] - top2[1]).cpu().numpy())
        wide, narrow = wide + a, narrow + b
        del acc, got, ref, top2
    if world.is_main:
        out.update(max_abs_err=err, label_diff_wide=wide,
                   label_diff_narrow=narrow,
                   classes=int(len(np.unique(np.concatenate(
                       [v.ravel() for v in labels])))))
        del ref_fts, ref_labels
    del fts, labels
    _free(world)

    # mask-cases/s: one card at its automatic batch against the ranks
    rate_one, rate_dp, peak = [], [], None
    for path in ("one", "dp", "dp", "one"):
        _sync(world)
        if path == "one":
            if world.is_main:
                rate_one.append(15e3 / _wall_ms(
                    world, lambda: one.sweep_labels(one_prep, masks)))
            continue
        first = not rate_dp
        if first:
            _reset_peak(world)
        rate_dp.append(15e3 / _wall_ms(world, lambda: engine.sweep_labels(
            prepared, masks)))
        if first:
            peak = _peak_gib(world)
    _sync(world)

    # encode and each fuse pass (with its all-reduce) between events
    fts = None

    def encode():
        nonlocal fts
        fts = engine.encode_case(prepared)

    encode_ms = _ms(world, encode)
    fuse = [_ms(world, lambda m=m: engine.labels_device(prepared, fts, m))
            for m in masks]
    del fts
    # the accumulator's all-reduce alone
    acc = engine._new_sum(prepared)
    ar = []
    for i in range(len(masks) + 2):
        _sync(world)
        t = _ms(world, lambda: world.all_reduce_(acc))
        if i >= 2:
            ar.append(t)
    out.update(rate_dp=rate_dp, encode_ms=encode_ms,
               fuse_ms=float(np.mean(fuse)),
               allreduce_ms=float(np.median(ar)),
               allreduce_mb=acc.numel() * acc.element_size() / 1e6,
               peak_gib=peak)
    if world.is_main:
        out["rate_one"] = rate_one
    del acc, engine, prepared
    if world.is_main:
        del one, one_prep, ref_prep
    _free(world)
    return out


def rank_main(world, opts: dict) -> None:
    """Every phase of `opts` for each backbone on this rank; the results
    go to `{opts["dir"]}/rank{r}.json`."""
    t0 = time.perf_counter()
    res = dict(rank=world.rank, device=str(world.device))
    if world.device.type == "cuda":
        _build.load()  # every rank at once: the first collective waits
        res["card"] = torch.cuda.get_device_name(world.device)
    res.update(build_s=_build.build_seconds,
               load_s=time.perf_counter() - t0)
    _sync(world)
    res["first_sync_s"] = time.perf_counter() - t0
    # one write, so the ranks' lines do not interleave
    sys.stdout.write(f"  rank {world.rank}/{world.size} on {world.device}: "
                     f"kernel library built in {res['build_s']:.2f} s (0: "
                     f"reused), loaded in {res['load_s']:.2f} s, first "
                     f"collective after {res['first_sync_s']:.2f} s\n")
    sys.stdout.flush()
    phases = {"step": rank_step, "time": rank_time, "sweep": rank_sweep}
    for name in opts["models"]:
        res[name] = {}
        for phase in opts["phases"]:
            if phase in phases:
                t = time.perf_counter()
                res[name][phase] = phases[phase](world, name, opts)
                res[name][phase]["seconds"] = time.perf_counter() - t
                if world.is_main:
                    print(f"  {name} x{world.size} {phase}: "
                          f"{time.perf_counter() - t:.1f} s", flush=True)
    with open(os.path.join(opts["dir"], f"rank{world.rank}.json"), "w") as f:
        json.dump(res, f)


# --- this process: the counts, the CLIs, the checks -----------------------

class Checks:
    """One printed line per check; the names of those that failed."""

    def __init__(self):
        self.n = 0
        self.failed: list[str] = []

    def __call__(self, name: str, n: int, what: str, ok: bool,
                 detail: str) -> bool:
        self.n += 1
        print(f"check {name} x{n} {what}: {'ok' if ok else 'FAIL'} "
              f"({detail})", flush=True)
        if not ok:
            self.failed.append(f"{name} x{n} {what}")
        return ok


@contextlib.contextmanager
def _visible(n: int, device: str):
    """Processes started inside see the first `n` cards only."""
    if device != "cuda":
        yield
        return
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = saved.split(",") if saved else [
        str(i) for i in range(torch.cuda.device_count())]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:n])
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


def _finite(*values) -> bool:
    return all(v is not None and math.isfinite(v) and v > 0 for v in values)


def _r(v, nd=3):
    return None if v is None else round(v, nd)


def judge_step(chk, name, n, ranks, cuda) -> dict:
    r0 = ranks[0]["step"]
    chk(name, n, "step loss", math.isfinite(r0["loss"])
        and r0["loss_rel"] <= LOSS_RTOL,
        f"{n} ranks {r0['loss']:.6f}, one process {r0['loss_one']:.6f}, "
        f"rel {r0['loss_rel']:.3g} (<= {LOSS_RTOL})")
    worst = r0["worst"]
    chk(name, n, "step gradients", not r0["over"]
        and r0["global_rel"] <= GRAD_GLOBAL,
        f"summed over the ranks vs one process: rel L2 global "
        f"{r0['global_rel']:.3g} (<= {GRAD_GLOBAL}), worst {worst[0]:.3g} "
        f"({worst[1]}); over their bound: {r0['over']}")
    diffs = [r["step"]["params_vs_rank0"] for r in ranks]
    chk(name, n, "step updated params", max(diffs) == 0.0,
        f"max abs difference from rank 0's, per rank: {diffs}")
    launches = [r["step"]["launches"] for r in ranks]
    want = dict.fromkeys(KERNELS, 0)
    if cuda:
        want.update(dict.fromkeys(KERNELS[:4], TRAIN_SITES[name]),
                    K6=PAD_SITES[name]["train"])
    chk(name, n, "step launches", all(l == want for l in launches),
        f"K1-K4, K6 per rank {[list(l.values()) for l in launches]}, "
        f"expected {list(want.values())}" + (
            "" if cuda else " (the CPU takes the plain versions)"))
    return dict(loss=r0["loss"], loss_one=r0["loss_one"],
                loss_rel=r0["loss_rel"], grad_rel_global=r0["global_rel"],
                grad_rel_worst=worst[0], worst_tensor=worst[1],
                launches=launches, params_vs_rank0=diffs)


def judge_time(chk, name, n, ranks, card) -> dict:
    t0 = ranks[0]["time"]
    med = [r["time"]["dp_median_ms"] for r in ranks]
    one = t0["one_median_ms"]
    out = dict(one_ms=t0["one_ms"], one_median_ms=one,
               dp_ms=[r["time"]["dp_ms"] for r in ranks], dp_median_ms=med,
               samples_per_s=n * 1e3 / max(med), one_samples_per_s=1e3 / one,
               spread=(max(med) - min(med)) / min(med),
               allreduce_ms=[r["time"]["allreduce_ms"] for r in ranks],
               allreduce_mb=t0["allreduce_mb"], n_params=t0["n_params"],
               peak_gib=[r["time"]["peak_gib"] for r in ranks])
    out["scaling"] = out["samples_per_s"] / out["one_samples_per_s"]
    chk(name, n, "bf16 step timing", _finite(one, *med,
                                             *out["allreduce_ms"]),
        f"[{card}] {n} ranks {out['samples_per_s']:.3f} samples/s (rank "
        f"medians {[_r(v) for v in med]} ms, spread "
        f"{out['spread']:.3f}), one process {out['one_samples_per_s']:.3f} "
        f"samples/s ({one:.3f} ms): {out['scaling']:.3f}x; gradient "
        f"all-reduce of {out['allreduce_mb']:.1f} MB "
        f"({out['n_params']} params) {[_r(v) for v in out['allreduce_ms']]} "
        f"ms; peak {[_r(v, 2) for v in out['peak_gib']]} GiB")
    return out


def judge_sweep(chk, name, n, ranks, cuda, card) -> dict:
    s0 = ranks[0]["sweep"]
    chk(name, n, "sweep probabilities", s0["max_abs_err"] <= PROB_ATOL,
        f"window batch {s0['window_batch']}, chunks per rank "
        f"{[r['sweep']['chunks'] for r in ranks]}: coverage-averaged "
        f"float32 probabilities vs one card max abs diff "
        f"{s0['max_abs_err']:.3g} (<= {PROB_ATOL})")
    chk(name, n, "sweep labels", s0["label_diff_wide"] == 0
        and s0["classes"] > 1,
        f"15 masks: {s0['label_diff_wide']} voxels differ where the top two "
        f"are > {MARGIN} apart, {s0['label_diff_narrow']} below that "
        f"margin; {s0['classes']} classes predicted")
    enc, fuse = SWEEP_SITES[name]
    pads = PAD_SITES[name]
    want = [dict(K1=len(r["sweep"]["chunks"]) * (enc + 15 * fuse),
                 K2=len(r["sweep"]["chunks"]) * (enc + 15 * fuse), K3=0,
                 K4=0, K6=len(r["sweep"]["chunks"]) * (pads["encode"] +
                                                       15 * pads["fuse"]))
            if cuda else dict.fromkeys(KERNELS, 0) for r in ranks]
    launches = [r["sweep"]["launches"] for r in ranks]
    chk(name, n, "sweep launches", launches == want,
        f"K1-K4, K6 per rank {[list(l.values()) for l in launches]}, "
        f"expected {[list(w.values()) for w in want]}")
    one = float(np.median(s0["rate_one"]))
    dp = float(np.median(s0["rate_dp"]))
    out = dict(window_batch=s0["window_batch"],
               chunks=[r["sweep"]["chunks"] for r in ranks],
               max_abs_err=s0["max_abs_err"],
               label_diff_wide=s0["label_diff_wide"],
               label_diff_narrow=s0["label_diff_narrow"], launches=launches,
               rate=dp, rate_reps=s0["rate_dp"], rate_one=one,
               rate_one_reps=s0["rate_one"],
               one_window_batch=s0["one_window_batch"],
               scaling=dp / one,
               encode_ms=[r["sweep"]["encode_ms"] for r in ranks],
               fuse_ms=[r["sweep"]["fuse_ms"] for r in ranks],
               allreduce_ms=[r["sweep"]["allreduce_ms"] for r in ranks],
               allreduce_mb=s0["allreduce_mb"],
               peak_gib=[r["sweep"]["peak_gib"] for r in ranks])
    chk(name, n, "sweep timing", _finite(dp, one, *out["encode_ms"],
                                         *out["fuse_ms"]),
        f"[{card}] {n} ranks {dp:.4f} mask-cases/s, one card (window batch "
        f"{s0['one_window_batch']}) {one:.4f}: {out['scaling']:.3f}x; encode "
        f"{[_r(v) for v in out['encode_ms']]} ms, fuse pass "
        f"{[_r(v) for v in out['fuse_ms']]} ms; accumulator all-reduce "
        f"({out['allreduce_mb']:.1f} MB) "
        f"{[_r(v) for v in out['allreduce_ms']]} ms; peak "
        f"{[_r(v, 2) for v in out['peak_gib']]} GiB")
    return out


def run_ranks(chk, n, opts, results, card) -> dict:
    """Launch the n ranks of `opts` and judge what they measured."""
    rank_phases = [p for p in opts["phases"] if p != "cli"]
    if not rank_phases:
        return {}
    run = os.path.join(opts["out"], f"x{n}", "ranks")
    os.makedirs(run)
    t0 = time.perf_counter()
    try:
        pw.launch(rank_main, n, opts["device"],
                  args=(dict(opts, dir=run, phases=rank_phases),),
                  timeout_s=opts["sizes"]["cli_timeout"] * 3,
                  threads=1 if opts["device"] == "cpu" else None)
    except Exception as e:  # noqa: BLE001 -- reported as a failed check
        chk("ranks", n, "launch", False, "".join(
            traceback.format_exception_only(type(e), e)).strip()[-2000:])
        return {}
    ranks = []
    for r in range(n):
        with open(os.path.join(run, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    cuda = opts["device"] == "cuda"
    chk("ranks", n, "launch", True,
        f"{n} ranks in {time.perf_counter() - t0:.1f} s; kernel library "
        f"built per rank {[_r(r['build_s'], 2) for r in ranks]} s (0: "
        f"reused); first collective after "
        f"{[_r(r['first_sync_s'], 2) for r in ranks]} s")
    for name in opts["models"]:
        res = results.setdefault(name, {}).setdefault(str(n), {})
        per = [r[name] for r in ranks]
        if "step" in rank_phases:
            res["step"] = judge_step(chk, name, n, per, cuda)
        if "time" in rank_phases:
            res["time"] = judge_time(chk, name, n, per, card)
        if "sweep" in rank_phases:
            res["sweep"] = judge_sweep(chk, name, n, per, cuda, card)
    return dict(build_s=[r["build_s"] for r in ranks],
                first_sync_s=[r["first_sync_s"] for r in ranks])


def _cli_flags(opts) -> list[str]:
    if not opts["small"]:
        return []
    flags = ["--patch_size", str(opts["sizes"]["sweep_patch"])]
    for k, v in SMALL_KW.items():
        flags += [f"--{k}", str(v)]
    return flags + ["--device", "cpu"]


def _run_group(cmds: dict, opts) -> dict:
    """Run `python -m ...` commands {key: (args, log)} together; each one's
    exit code and wall seconds. A command past the CLI time limit is
    killed."""
    env = dict(os.environ)
    if opts["device"] == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = {}
    t0 = time.perf_counter()
    for key, (args, log) in cmds.items():
        with open(log, "w") as f:
            procs[key] = subprocess.Popen([sys.executable, "-m", *args],
                                          cwd=REPO, env=env, stdout=f,
                                          stderr=subprocess.STDOUT)
    out = {}
    try:
        while len(out) < len(procs):
            time.sleep(0.2)
            late = time.perf_counter() - t0 > opts["sizes"]["cli_timeout"]
            for key, p in procs.items():
                if key in out:
                    continue
                if p.poll() is None and late:
                    p.kill()
                if p.poll() is not None:
                    out[key] = dict(rc=p.wait(), log=cmds[key][1],
                                    seconds=time.perf_counter() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _tail(log: str) -> str:
    with open(log) as f:
        return f.read()[-1500:]


def _csv_rows(path: str) -> list[list[str]]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return list(csv.reader(f))


def cli_data(opts) -> dict:
    """The CLIs' synthetic data and each backbone's seed-0 weights."""
    from passion_tpu_torch.data.synth import make_synthetic_dataset
    from passion_tpu_torch.models import get_model, init_model

    sz = opts["sizes"]
    root = os.path.join(opts["out"], "data")
    train, evals = os.path.join(root, "train"), os.path.join(root, "eval")
    make_synthetic_dataset(train, n_cases=6, shape=sz["train_shape"], seed=0)
    names = make_synthetic_dataset(evals, n_cases=EVAL_CASES,
                                   shape=sz["volume"], seed=0)
    with open(os.path.join(evals, "test.txt"), "w") as f:
        f.writelines(n + "\n" for n in names)
    with open(os.path.join(train, "test.txt")) as f:
        n_test = len(f.read().split())
    ckpts = {}
    for name in opts["models"]:
        ckpts[name] = os.path.join(root, f"{name}.pt")
        model = init_model(get_model(name, mask_type="idt",
                                     patch_size=sz["sweep_patch"],
                                     **model_kw(name, opts["small"])), seed=0)
        torch.save(model.state_dict(), ckpts[name])
    eff = tuple(max(e, sz["sweep_patch"]) for e in sz["volume"])
    windows = len(window_coords(eff, sz["sweep_patch"]))
    return dict(train=train, eval=evals, ckpts=ckpts,
                train_rows=1 + 15 * (1 + n_test),
                eval_rows=1 + 15 * (1 + EVAL_CASES),
                window_batch=_auto_window_batch(windows, EVAL_SHARDS)[0])


def eval_cmd(name, data, opts, n, out) -> list[str]:
    return ["passion_tpu_torch.eval", "--model", name, "--resume",
            data["ckpts"][name], "--dataroot", data["eval"], "--datapath",
            ".", "--savepath", out, "--window_batch",
            str(data["window_batch"]), "--data_parallel", str(n),
            *_cli_flags(opts)]


def run_clis(chk, n, opts, data, results, card) -> None:
    """The train CLI and the eval CLI of every backbone at n ranks; at the
    first count, the one-card eval CLI of every backbone as well, beside
    the train CLIs."""
    from passion_tpu_torch.engine.checkpoint import load_checkpoint

    run = os.path.join(opts["out"], f"x{n}")
    one_dir = os.path.join(opts["out"], "eval_one")
    os.makedirs(run, exist_ok=True)
    os.makedirs(one_dir, exist_ok=True)
    cmds = {}
    for name in opts["models"]:
        out = os.path.join(run, f"train_{name}")
        cmds[name] = (["passion_tpu_torch.train", "--model", name,
                       "--dataroot", data["train"], "--datapath", ".",
                       "--imbmrpath", "imb_split.csv", "--savepath", out,
                       "--num_epochs", "1", "--iters_per_epoch", "2",
                       "--use_passion", "--num_workers", "4", "--batch_size",
                       str(n), "--data_parallel", str(n), *_cli_flags(opts)],
                      os.path.join(run, f"train_{name}.log"))
        if "one" not in data:  # the one-card reference, once per backbone
            cmds["one", name] = (eval_cmd(name, data, opts, 0,
                                          os.path.join(one_dir, name)),
                                 os.path.join(one_dir, f"{name}.log"))
    with _visible(n, opts["device"]):
        done = _run_group(cmds, opts)
    if "one" not in data:
        data["one"] = {name: done.pop(("one", name))
                       for name in opts["models"]}
        for name, d in data["one"].items():
            chk(name, 1, "eval CLI on one card", d["rc"] == 0,
                f"exit {d['rc']}, {d['seconds']:.1f} s (beside the train "
                f"CLIs)" + ("" if d["rc"] == 0 else
                            f"; log: {_tail(d['log'])}"))
    for name, d in done.items():
        out = cmds[name][0][cmds[name][0].index("--savepath") + 1]
        rows = len(_csv_rows(os.path.join(out, f"{name}.csv")))
        epoch = load_checkpoint(os.path.join(out, "model_last.pt"))[
            "epoch"] if d["rc"] == 0 else None
        ok = d["rc"] == 0 and epoch == 0 and rows == data["train_rows"]
        chk(name, n, "train CLI", ok,
            f"--data_parallel {n} --batch_size {n}, 1 epoch x 2 iterations: "
            f"exit {d['rc']}, epoch-1 checkpoint {epoch == 0}, CSV rows "
            f"{rows}/{data['train_rows']}; {d['seconds']:.1f} s"
            + ("" if ok else f"; log: {_tail(d['log'])}"))
        results.setdefault(name, {}).setdefault(str(n), {})["train_cli"] = \
            dict(rc=d["rc"], seconds=d["seconds"], csv_rows=rows)

    cmds = {name: (eval_cmd(name, data, opts, n,
                            os.path.join(run, f"eval_{name}")),
                   os.path.join(run, f"eval_{name}.log"))
            for name in opts["models"]}
    with _visible(n, opts["device"]):
        done = _run_group(cmds, opts)
    mask_cases = EVAL_CASES * len(MASK_ARRAY)
    for name, d in done.items():
        got = _csv_rows(os.path.join(run, f"eval_{name}", f"{name}.csv"))
        ref = _csv_rows(os.path.join(one_dir, name, f"{name}.csv"))
        diff = csv_diff(got, ref)
        one_s = data["one"][name]["seconds"]
        ok = (d["rc"] == 0 and diff["rows"] == data["eval_rows"]
              and diff["differ"] >= 0 and diff["dice"] <= DICE_ATOL
              and diff["hd95"] <= HD95_ATOL)
        chk(name, n, "eval CLI", ok,
            f"[{card}] --data_parallel {n} --window_batch "
            f"{data['window_batch']} on {EVAL_CASES} cases: exit {d['rc']}, "
            f"{diff['rows']}/{data['eval_rows']} CSV rows, "
            f"{diff['differ']} differ from one card's, largest Dice "
            f"difference {diff['dice']:.3g} (<= {DICE_ATOL}), HD95 "
            f"{diff['hd95']:.3g} (<= {HD95_ATOL}); "
            f"{mask_cases / d['seconds']:.4f} mask-cases/s end to end "
            f"({d['seconds']:.1f} s), one card "
            f"{mask_cases / one_s:.4f} ({one_s:.1f} s)"
            + ("" if d["rc"] == 0 else f"; log: {_tail(d['log'])}"))
        results.setdefault(name, {}).setdefault(str(n), {})["eval_cli"] = \
            dict(rc=d["rc"], seconds=d["seconds"],
                 rate=mask_cases / d["seconds"], one_seconds=one_s,
                 one_rate=mask_cases / one_s, **diff)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, nargs="+", required=True,
                   help="card counts (ranks), run in turn")
    p.add_argument("--models", nargs="+", choices=BACKBONES,
                   default=list(BACKBONES))
    p.add_argument("--phases", nargs="+", choices=PHASES,
                   default=list(PHASES))
    p.add_argument("--seed", type=int, default=0,
                   help="draws the step's global batch")
    p.add_argument("--out", default=os.path.join(REPO, "build", "multichip"),
                   help="the ranks' results, the CLIs' data, logs and "
                        "outputs; its subdirectories data, eval_one and "
                        "x{N} of each count are removed and written anew")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--small", action="store_true",
                   help="the fast-tier widths and small volumes")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if min(args.cards) < 1 or len(set(args.cards)) < len(args.cards):
        raise ValueError(f"--cards takes distinct counts of 1 or more, got "
                         f"{args.cards}")
    for n in args.cards:  # raises without enough cards
        pw.world_size_for(n, args.device)
    opts = dict(cards=args.cards, models=args.models, phases=args.phases,
                seed=args.seed, out=os.path.abspath(args.out),
                device=args.device, small=args.small,
                sizes=sizes(args.small))
    for sub in ["data", "eval_one"] + [f"x{n}" for n in args.cards]:
        shutil.rmtree(os.path.join(opts["out"], sub), ignore_errors=True)
    os.makedirs(opts["out"], exist_ok=True)
    cuda = args.device == "cuda"
    card = bench.card_line() if cuda else "cpu"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(f"multichip: {kind} x {torch.cuda.device_count() if cuda else 0} "
          f"visible; counts {args.cards}; {args.models}; phases "
          f"{args.phases}; torch {torch.__version__}", flush=True)
    print(card, flush=True)
    chk = Checks()
    results, ranks = {}, {}
    data = cli_data(opts) if "cli" in args.phases else None
    t0 = time.perf_counter()
    for n in args.cards:
        print(f"== {n} card(s)" if cuda else f"== {n} gloo rank(s)",
              flush=True)
        with _visible(n, args.device):
            ranks[str(n)] = run_ranks(chk, n, opts, results, card)
        if data is not None:
            run_clis(chk, n, opts, data, results, card)
    ok = not chk.failed
    print(f"multichip: {chk.n} checks, {len(chk.failed)} failed "
          f"{chk.failed}; {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(dict(ok=ok, device=kind, card=card, cards=args.cards,
                          models=args.models, phases=args.phases,
                          checks=chk.n, failed=chk.failed, ranks=ranks,
                          results=results)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
