"""Benchmark of the port on one NVIDIA GPU (counterpart of the repo's
`bench.py` and `scripts/bench_loader.py`):

  python -m passion_tpu_torch.bench [--sweep] [--train] [--single]
      [--loader] [--eval_cli] [--model mmformer|rfnet|m2ftrans]

With no mode flag it runs the sweep and the train step; the flags combine.
The workloads are bench.py's, at the backbone's published width with
seed-0 weights:

  * sweep: the 15-mask sliding-window sweep of one 240x240x155x4 volume of
    `default_rng(0)` normals (75 windows of 80^3, the automatic window
    batch: one chunk), bf16; one untimed sweep, then `--reps` timed ones,
    then one more timed by CUDA events for the encode and the fuse passes;
  * train: the PASSION step (bs 1, an 80^3 crop of seeded noise, mask
    [T, F, T, T], temp 4, lr 2e-4, bf16 over float32 master params,
    dropout on but for RFNet, which has none); `--train_warmup` untimed
    steps, then `--train_reps` reps of `--train_steps` steps. The step is
    bound by the host's launches, whose speed drifts, hence more reps than
    bench.py's 2 x 5;
  * single: the single-mask engine on the sweep's volume under the full
    mask, `--single_reps` reps after one untimed run;
  * loader (host only, runs without a card): aug-crops/s of
    `PrefetchLoader` over `BratsTrainIDT` with the training transforms on
    `data.synth` cases at `--loader_shape` (bench_loader.py's);
  * eval_cli: mask-cases/s of `passion_tpu_torch.eval.main` end to end
    (case loading, staging, sweep, Dice, HD95, CSV) on `EVAL_CASES`
    synthetic 240x240x155 cases, after one untimed sweep of a case; one
    run, most of it the sweeps (Dice and HD95 are scored on the card).

A rep is timed on the host clock between two `torch.cuda.synchronize()`
calls. The JSON line carries bench.py's field names: `value` is the rate
over the mean rep time, `value_best` over the best, `reps_*` each rep's
rate and `std_*` their spread. `flops_*` and `bytes_*` are the work's FLOPs
and bytes (`roofline.count`: the port's own programs, counted once on an
untimed run after the timed ones). `mfu_*` is the FLOPs times the rate over
the card's dense bf16 peak; `roofline_*` the share of its binding floor
the work reaches at the mean rate (the sweep's floor: the encode's plus 15
fuse passes'), `bound_*` which floor binds ("mem", "comp"; "mixed" for a
sweep whose programs differ). All three are null, with a line on stderr,
for a card missing from `PEAKS`. `chip` is the card's name and power limit
as nvidia-smi gives them. Without CUDA the device modes exit non-zero
before anything is timed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

VOLUME = (240, 240, 155)
PATCH = 80
EVAL_CASES = 4  # --eval_cli: synthetic cases through the eval CLI
# the card's peaks by torch.cuda.get_device_name, from its data sheet:
# dense bf16 tensor-core FLOP/s (without sparsity), float32 FLOP/s outside
# the tensor cores, HBM bytes/s
PEAKS = {"NVIDIA H100 80GB HBM3": dict(bf16=989.4e12, fp32=67e12,
                                       hbm=3.35e12)}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks_of(kind: str) -> dict | None:
    """The peaks of card `kind`, or None with a line on stderr."""
    peaks = PEAKS.get(kind)
    if peaks is None:
        print(f"no peaks for {kind!r}: mfu_*, roofline_* and bound_* are "
              f"null", file=sys.stderr)
    return peaks


def volume() -> np.ndarray:
    """bench.py's case: a 240x240x155x4 volume of default_rng(0) normals."""
    return np.random.default_rng(0).standard_normal(VOLUME + (4,)).astype(
        np.float32)


def train_batch() -> dict:
    """bench.py:164-173 at bs 1, channels-first: seeded-noise 80^3 crop,
    one-hot labels, mask [T, F, T, T]."""
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 4, size=(1, PATCH, PATCH, PATCH))
    masks = np.ones((1, 4), bool)
    masks[0, :2] = [True, False]
    x = rng.standard_normal((1, PATCH, PATCH, PATCH, 4)).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[lab]
    return {"x": torch.from_numpy(np.moveaxis(x, -1, 1).copy()).cuda(),
            "target": torch.from_numpy(np.moveaxis(onehot, -1, 1).copy()
                                       ).cuda(),
            "mask": torch.from_numpy(masks).cuda()}


def train_setup(name, compute_dtype=torch.bfloat16, with_dropout=None,
                world=None, device="cuda", patch=PATCH, **model_kw):
    """The model `name` (seed 0, idt; published width unless `model_kw`
    overrides it) on `world.device`, else `device`, its optimizer at lr
    2e-4 and the train step (data-parallel over `world` if given), as
    `engine.train_loop.fit` builds them; dropout on but for RFNet unless
    `with_dropout` says otherwise."""
    from passion_tpu_torch.engine.schedule import (make_optimizer,
                                                   set_learning_rate)
    from passion_tpu_torch.engine.train_loop import make_train_step
    from passion_tpu_torch.models import get_model, init_model

    model = init_model(get_model(name, mask_type="idt", patch_size=patch,
                                 **model_kw), seed=0)
    model.to(world.device if world is not None else device)
    opt = make_optimizer(model.parameters(), 1e-4)
    set_learning_rate(opt, 2e-4)
    if with_dropout is None:
        with_dropout = name != "rfnet"
    step = make_train_step(model, opt, use_passion=True,
                           with_dropout=with_dropout,
                           compute_dtype=compute_dtype, world=world)
    return model, step


def train_step_fn(name):
    """A closure running one bf16 PASSION step of bench.py's batch."""
    batch = train_batch()
    ones = torch.ones(4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    _, step = train_setup(name)
    return lambda: step(batch, ones, ones, 4.0, gen, False)


def _reps(fn, n: int) -> list[float]:
    """Seconds of each of n calls, each between two synchronizes."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _rates(work: float, times: list[float]) -> dict:
    """Rate over the mean and over the best time, each rep's rate, their
    spread."""
    reps = [work / t for t in times]
    return dict(mean=work / float(np.mean(times)), best=work / min(times),
                reps=[round(r, 4) for r in reps],
                std=round(float(np.std(reps)), 4))


def _mfu(flops_per_s: float, peaks):
    return None if peaks is None else flops_per_s / peaks["bf16"]


def bench_sweep(name: str, reps: int, window_batch=None, peaks=None) -> dict:
    from passion_tpu_torch import flops, roofline
    from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model

    model = init_model(get_model(name, mask_type="idt"), seed=0)
    engine = SlidingWindowSweep(model, num_cls=4, patch=PATCH,
                                window_batch=window_batch)
    masks = [np.asarray(m) for m in MASK_ARRAY]
    prepared = engine.prepare(volume())
    out = engine.sweep_labels(prepared, masks)  # cuDNN set-up, untimed
    if len(out) != 15 or out[0].shape != VOLUME:
        raise AssertionError(f"{len(out)} label volumes of {out[0].shape}")
    r = _rates(len(masks), _reps(lambda: engine.sweep_labels(prepared,
                                                             masks), reps))
    # one more sweep, its encode and each fuse pass between CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 + len(masks))]
    ev[0].record()
    fts = engine.encode_case(prepared)
    ev[1].record()
    for m, e in zip(masks, ev[2:]):
        engine.labels_device(prepared, fts, m)
        e.record()
    torch.cuda.synchronize()
    fuse = [a.elapsed_time(b) for a, b in zip(ev[1:], ev[2:])]
    encode_ms, fuse_ms = ev[0].elapsed_time(ev[1]), float(np.mean(fuse))
    del fts
    counts = roofline.sweep_counts(engine, prepared)  # untimed
    n = len(masks)
    counted = dict(encode=counts["encode"]["flops"],
                   fuse=counts["fuse"]["flops"],
                   window_forward=flops.window_forward_flops(engine.model,
                                                             PATCH))
    counted["sweep"] = counted["encode"] + n * counted["fuse"]
    moved = dict(encode=counts["encode"]["bytes"],
                 fuse=counts["fuse"]["bytes"])
    moved["sweep"] = moved["encode"] + n * moved["fuse"]
    rows = dict(encode=roofline.program_row(counts["encode"], peaks,
                                            encode_ms / 1e3,
                                            encode_ms / 1e3),
                fuse_labels=roofline.program_row(counts["fuse"], peaks,
                                                 fuse_ms / 1e3,
                                                 min(fuse) / 1e3))
    floor, bound = roofline.sweep_floor(rows["encode"], rows["fuse_labels"],
                                        n)
    return dict(rate=r, flops=counted, bytes=moved, rows=rows,
                by_op=dict(encode=counts["encode"]["by_op"],
                           fuse_labels=counts["fuse"]["by_op"]),
                encode_ms=encode_ms, fuse_ms=fuse_ms,
                window_batch=prepared["window_batch"],
                mfu=_mfu(counted["sweep"] * r["mean"] / n, peaks),
                roofline=None if floor is None else floor * r["mean"] / n,
                bound=bound)


def bench_train(name: str, warmup: int, reps: int, steps: int,
                peaks=None) -> dict:
    from passion_tpu_torch import roofline

    one = train_step_fn(name)
    for _ in range(warmup):
        m = one()
    if not np.isfinite(m["loss"].item()):
        raise AssertionError(f"non-finite loss {m['loss'].item()}")

    def run():
        for _ in range(steps):
            m = one()
        return m

    r = _rates(steps, _reps(run, reps))
    counts = roofline.count(one)  # untimed
    row = roofline.program_row(counts, peaks, 1 / r["mean"], 1 / r["best"])
    share = row["pct_of_roofline"]
    return dict(rate=r, flops=counts["flops"], bytes=counts["bytes"],
                by_op=counts["by_op"], row=row,
                mfu=_mfu(counts["flops"] * r["mean"], peaks),
                roofline=None if share is None else share / 100,
                bound=row["bound"])


def bench_single(name: str, reps: int) -> dict:
    from passion_tpu_torch.engine.sliding_window import SlidingWindowInference
    from passion_tpu_torch.models import get_model, init_model

    model = init_model(get_model(name, mask_type="idt"), seed=0)
    engine = SlidingWindowInference(model, num_cls=4, patch=PATCH)
    mask = np.ones(4, bool)
    prepared = engine.prepare(volume())
    out = engine.infer_labels(prepared, mask)  # cuDNN set-up, untimed
    if out.shape != VOLUME or out.dtype != np.uint8:
        raise AssertionError(f"labels {out.shape} {out.dtype}")
    return dict(rate=_rates(1, _reps(lambda: engine.infer_labels(prepared,
                                                                 mask), reps)))


def bench_loader(cases: int, iters: int, threads: int, shape) -> dict:
    """bench_loader.py through the port's data layer: aug-crops/s of the
    idt training pipeline, and two single-threaded stage probes."""
    from passion_tpu_torch.config import train_transforms_for
    from passion_tpu_torch.data.datasets import BratsTrainIDT
    from passion_tpu_torch.data.loader import PrefetchLoader
    from passion_tpu_torch.data.synth import make_synthetic_dataset

    with tempfile.TemporaryDirectory() as root:
        make_synthetic_dataset(root, n_cases=cases, shape=tuple(shape),
                               seed=0)
        ds = BratsTrainIDT(train_transforms_for(PATCH), root=root,
                           mask_type="idt",
                           train_file=os.path.join(root, "imb_split.csv"))
        loader = PrefetchLoader(ds, batch_size=1, shuffle=True,
                                num_threads=threads, prefetch=2)
        ds.get(0, np.random.default_rng(0))  # warms the page cache
        t0 = time.perf_counter()
        np.load(os.path.join(root, "vol", ds.names[0] + "_vol.npy"))
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds.get(0, np.random.default_rng(1))
        t_item = time.perf_counter() - t0

        it = iter(loader)
        next(it)  # thread pool spin-up and a cold page cache
        n_items, done = 0, 0
        t0 = time.perf_counter()
        while done < iters:
            try:
                b = next(it)
            except StopIteration:
                it = iter(loader)
                continue
            n_items += b["x"].shape[0]
            done += 1
        dt = time.perf_counter() - t0
        it.close()  # stops the producer thread before the data goes
    return dict(rate=n_items / dt, load_s=t_load, item_s=t_item)


def bench_eval_cli(name: str, n_cases: int = EVAL_CASES, out=None) -> dict:
    """Seconds and mask-cases/s of one `passion_tpu_torch.eval.main` run, in
    this process, on `n_cases` synthetic 240x240x155 cases (`data.synth`,
    seed 0), after one untimed sweep (cuDNN set-up); the CSV goes to `out`
    (default: a temporary directory). `launches` are K1-K4's in the timed
    run."""
    from passion_tpu_torch import eval as port_eval
    from passion_tpu_torch.data.synth import make_synthetic_dataset
    from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model
    from passion_tpu_torch.ops import fused_norm

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        names = make_synthetic_dataset(data, n_cases=n_cases, shape=VOLUME,
                                       seed=0)
        with open(os.path.join(data, "test.txt"), "w") as f:
            f.writelines(n + "\n" for n in names)
        model = init_model(get_model(name, mask_type="idt"), seed=0)
        ckpt = os.path.join(tmp, f"{name}.pt")
        torch.save(model.state_dict(), ckpt)
        engine = SlidingWindowSweep(model, num_cls=4, patch=PATCH)
        engine.sweep_labels(engine.prepare(volume()),
                            [np.asarray(m) for m in MASK_ARRAY])
        del engine
        for w in fused_norm.WRAPPERS:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port_eval.main(["--model", name, "--resume", ckpt, "--dataroot", data,
                        "--datapath", ".", "--savepath",
                        out or os.path.join(tmp, "out")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return dict(seconds=secs, cases=n_cases,
                rate=n_cases * len(MASK_ARRAY) / secs,
                launches=[w.launches for w in fused_norm.WRAPPERS])


def _round(share):
    return None if share is None else round(share, 5)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for mode in ("sweep", "train", "single", "loader", "eval_cli"):
        p.add_argument(f"--{mode}", action="store_true")
    p.add_argument("--model", default="mmformer",
                   choices=("mmformer", "rfnet", "m2ftrans"))
    p.add_argument("--window_batch", type=int, default=0,
                   help="windows per chunk of the sweep (0: automatic, "
                        "all 75 in one chunk)")
    p.add_argument("--reps", type=int, default=8, help="timed sweeps")
    p.add_argument("--train_warmup", type=int, default=2)
    p.add_argument("--train_reps", type=int, default=5)
    p.add_argument("--train_steps", type=int, default=10,
                   help="steps per timed train rep")
    p.add_argument("--single_reps", type=int, default=3)
    p.add_argument("--loader_cases", type=int, default=8)
    p.add_argument("--loader_iters", type=int, default=40)
    p.add_argument("--loader_threads", type=int, default=8)
    p.add_argument("--loader_shape", type=int, nargs=3,
                   default=(160, 192, 146),
                   help="volume extents (typical cropped BraTS)")
    args = p.parse_args(argv)
    if not (args.sweep or args.train or args.single or args.loader
            or args.eval_cli):
        args.sweep = args.train = True
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device_modes = args.sweep or args.train or args.single or args.eval_cli
    row = {}
    if device_modes:
        if not torch.cuda.is_available():
            print("bench: the sweep, train, single and eval_cli modes need "
                  "a CUDA device (torch.cuda.is_available() is False)",
                  file=sys.stderr)
            return 2
        kind = torch.cuda.get_device_name(0)
        peaks = peaks_of(kind)
        row.update(chip=card_line(), device=kind)
    title = {"mmformer": "mmFormer", "rfnet": "RFNet",
             "m2ftrans": "M2FTrans"}[args.model]
    first = {}  # metric, value, value_best, unit of the first mode run

    def headline(metric, rate, unit):
        if not first:
            first.update(metric=metric, value=round(rate["mean"], 4),
                         value_best=round(rate["best"], 4), unit=unit)

    if args.sweep:
        s = bench_sweep(args.model, args.reps, args.window_batch or None,
                        peaks)
        headline("brats_eval_sweep_throughput", s["rate"],
                 f"mask-cases/sec/chip ({title} 15-mask sliding-window "
                 f"sweep, 240x240x155, {s['window_batch']}-window chunks "
                 f"of 80^3)")
        row.update(
            mfu_sweep=_round(s["mfu"]),
            reps_sweep=s["rate"]["reps"], std_sweep=s["rate"]["std"],
            sweep_encode_ms=round(s["encode_ms"], 3),
            sweep_fuse_ms=round(s["fuse_ms"], 3),
            flops_sweep=s["flops"]["sweep"],
            flops_sweep_encode=s["flops"]["encode"],
            flops_sweep_fuse=s["flops"]["fuse"],
            flops_window_forward=s["flops"]["window_forward"],
            bytes_sweep=s["bytes"]["sweep"],
            bytes_sweep_encode=s["bytes"]["encode"],
            bytes_sweep_fuse=s["bytes"]["fuse"],
            roofline_sweep=_round(s["roofline"]), bound_sweep=s["bound"])
    if args.train:
        t = bench_train(args.model, args.train_warmup, args.train_reps,
                        args.train_steps, peaks)
        unit = (f"steps/sec/chip ({title} 80^3 batch=1, use_passion, bf16 "
                f"over float32, AdamW-AMSGrad)")
        headline("passion_train_step", t["rate"], unit)
        row.update(
            train_steps_per_sec=round(t["rate"]["mean"], 4),
            train_steps_per_sec_best=round(t["rate"]["best"], 4),
            train_unit=unit,
            mfu_train=_round(t["mfu"]),
            reps_train=t["rate"]["reps"], std_train=t["rate"]["std"],
            flops_train_step=t["flops"], bytes_train_step=t["bytes"],
            roofline_train=_round(t["roofline"]), bound_train=t["bound"])
    if args.single:
        g = bench_single(args.model, args.single_reps)
        headline("brats_sliding_window_inference", g["rate"],
                 f"cases/sec/chip ({title} single-mask engine, full mask, "
                 f"240x240x155, 75x80^3 windows)")
        row.update(single_cases_per_sec=round(g["rate"]["mean"], 4),
                   single_cases_per_sec_best=round(g["rate"]["best"], 4),
                   reps_single=g["rate"]["reps"],
                   std_single=g["rate"]["std"])
    if args.eval_cli:
        e = bench_eval_cli(args.model)
        rate = dict(mean=e["rate"], best=e["rate"])
        headline("eval_cli_throughput", rate,
                 f"mask-cases/sec ({title} python -m passion_tpu_torch.eval "
                 f"end to end, {e['cases']} synthetic 240x240x155 cases)")
        row.update(eval_cli_mask_cases_per_sec=round(e["rate"], 4),
                   eval_cli_s=round(e["seconds"], 3),
                   eval_cli_cases=e["cases"])
    if args.loader:
        ld = bench_loader(args.loader_cases, args.loader_iters,
                          args.loader_threads, args.loader_shape)
        steps = row.get("train_steps_per_sec")
        unit = ("aug-crops/sec (idt pipeline, RandCrop3D 80^3 + "
                "RandomRotion + intensity + flip)")
        if first:
            row["loader_unit"] = unit
        else:
            first.update(metric="loader_throughput", unit=unit)
        row.update(
            aug_crops_per_sec=round(ld["rate"], 3),
            volume_shape=list(args.loader_shape),
            threads=args.loader_threads, host_cores=os.cpu_count(),
            stage_full_np_load_s=round(ld["load_s"], 4),
            stage_one_item_s=round(ld["item_s"], 4),
            device_train_steps_per_sec=steps,
            keeps_device_busy=None if steps is None else ld["rate"] >= steps)
    row = {**first, **row}
    row["methodology"] = ("value=rate over the mean of N reps (headline), "
                          "value_best=over the best; reps_*/std_* the raw "
                          "per-rep rates; each rep on the host clock between "
                          "two torch.cuda.synchronize() calls")
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
