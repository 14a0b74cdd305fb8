"""Roofline accounting of the port's programs on the card (counterpart of
`scripts/roofline_sweep.py` and `scripts/roofline_train.py`, which ask
XLA's cost analysis of the compiled TPU programs):

  python -m passion_tpu_torch.roofline {sweep,train}
      [--model mmformer|rfnet|m2ftrans]

For each program it reports the FLOPs (`flops.py`'s count), the bytes it
moves, the compute floor (FLOPs over the card's dense bf16 peak), the
memory floor (bytes over its HBM bandwidth), which of the two binds, the
measured time and the share of the binding floor the program reaches
(floor / measured time). The programs are bench.py's, at the backbone's
published width with seed-0 weights:

  * sweep: the encode of the 240x240x155 case's 75 windows
    (`SlidingWindowSweep.encode_case`) and one fuse pass
    (`labels_device`: fusion decoder, window sums and argmax), each timed
    by the CUDA events `bench.bench_sweep` takes (the encode once; the fuse
    pass's mean and best over the 15 masks); then the sweep's ceiling
    at roofline, 15 / (encode floor + 15 x fuse floor) mask-cases/s,
    beside the measured serial rate 15 / (encode + 15 x fuse);
  * train: one bf16 PASSION step (`bench.train_step_fn`: forward,
    backward, optimizer), timed by `bench.bench_train`. The JAX script's
    loop over remat policies has no counterpart: the port has one policy.

It prints the JAX script's table, then one JSON line with its field names
(`tflop`, `gb`, `t_comp`, `t_mem` in s, `bound` "mem" or "comp", `t_meas`,
`t_best` in s, `pct_of_roofline`) per program, the sweep's two rates and
the card line; each program's bytes by op (`bytes_by_op`), the largest
shares listed after the table. On a card missing from `bench.PEAKS` the floors and shares
are null, with a line on stderr. Without CUDA it exits 2.

Bytes (`ByteCounter`, a TorchDispatchMode) are counted per aten op the
program runs, by the usual rule for a roofline: each tensor input read once and each output written once, at the elements it
spans (`tensor_bytes`) times the item size:

  * an op whose outputs alias its inputs (a view, reshape, `expand`,
    `as_strided`: the alias annotations of `func._schema`) moves nothing;
    so do the factories that write nothing (`empty*`) and `_unsafe_view`,
    a view without the annotation;
  * an in-place op reads its inputs and writes its output once; an `out=`
    argument is written, not read; `copy_` (and the fills) write their
    destination without reading it;
  * the statistics layer norm saves for its backward count as float32,
    as the card keeps them (the CPU keeps them in a bf16 input's dtype);
  * the hand kernels K1-K4 and K6 count by their own operands (a ctypes
    launch is unseen by a dispatch mode): while a counter is active each
    wrapper of `HAND_KERNEL_MODULES` (`ops/fused_norm.py`, `ops/pad.py`)
    adds its formula's bytes and the counter does not see what it runs
    (the plain version on the CPU, the allocations on the card), so a
    count depends on shapes and dtypes only and the CPU's equals the
    card's.

It is the eager counterpart of XLA's "bytes accessed": what the program
asks HBM for, op by op. It cannot see what cuDNN moves inside a call (its
NCDHW <-> NDHWC transforms of operands and results, its workspace), reads
an op repeats (a conv's taps), nor what the 50 MB L2 serves between ops,
which makes a real run move more or fewer bytes than counted. A share
above 1 says the count misses traffic or the timed window misses work; it
is reported as it is.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from passion_tpu_torch import flops
from passion_tpu_torch.ops import fused_norm, pad

N_MASKS = 15
# the modules whose wrappers hand an active counter their kernels' bytes
HAND_KERNEL_MODULES = (fused_norm, pad)
TOP_OPS = 8  # ops listed by their share of a program's bytes
# ops that move no data: allocations, and views the schema does not mark
NO_TRAFFIC = frozenset({
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::empty_permuted", "aten::new_empty", "aten::new_empty_strided",
    "aten::resize_", "aten::set_", "aten::record_stream",
    "aten::_unsafe_view", "aten::unsafe_split", "aten::unsafe_chunk",
    "aten::unsafe_split_with_sizes"})
# in-place ops that write their destination without reading it
WRITE_ONLY = frozenset({
    "aten::copy_", "aten::fill_", "aten::zero_", "aten::normal_",
    "aten::uniform_", "aten::random_", "aten::bernoulli_",
    "aten::exponential_"})
# the statistics layer norm saves (by argument name, or return index): the
# card keeps them in float32 whatever the input's dtype, the CPU in a bf16
# input's dtype; they count as the card moves them
F32_STATS = {"aten::native_layer_norm": (1, 2),
             "aten::native_layer_norm_backward": ("mean", "rstd")}
# ops that read only the shape and dtype of their tensor input
OUTPUT_ONLY = frozenset({
    "aten::zeros_like", "aten::ones_like", "aten::full_like",
    "aten::rand_like", "aten::randn_like", "aten::randint_like",
    "aten::new_zeros", "aten::new_ones", "aten::new_full"})


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor spans: the elements it addresses (the product of its
    sizes along axes of nonzero stride, so a broadcast input counts its
    distinct elements; at most the extent of its strides, so overlapping
    windows count once) times the item size."""
    if t.numel() == 0:
        return 0
    if t.layout != torch.strided:
        return t.numel() * t.element_size()
    distinct, extent = 1, 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            distinct *= size
        extent += (size - 1) * abs(stride)
    return min(distinct, extent) * t.element_size()


def _bytes(v, as_f32: bool = False) -> int:
    """Bytes of a tensor or a list of tensors (`tensor_bytes`); float32's
    if `as_f32`."""
    if isinstance(v, torch.Tensor):
        ts = [v]
    elif isinstance(v, (list, tuple)):
        ts = [t for t in v if isinstance(t, torch.Tensor)]
    else:
        return 0
    if as_f32:
        return sum(tensor_bytes(t) // t.element_size() * 4 for t in ts)
    return sum(map(tensor_bytes, ts))


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op reads and writes (module docstring)."""
    schema = func._schema
    if schema.name in NO_TRAFFIC:
        return 0
    total = 0
    f32 = F32_STATS.get(schema.name, ())
    for i, arg in enumerate(schema.arguments):
        v = args[i] if i < len(args) else kwargs.get(arg.name)
        nbytes = _bytes(v, arg.name in f32)
        info = arg.alias_info
        if info is None:  # an input, read (unless only its shape is)
            if schema.name not in OUTPUT_ONLY:
                total += nbytes
        elif info.is_write:  # mutated: written; read too if in place
            total += nbytes
            if not arg.kwarg_only and schema.name not in WRITE_ONLY:
                total += nbytes
        # else: the input of a view, which moves nothing
    outs = out if len(schema.returns) > 1 else (out,)
    for j, (ret, v) in enumerate(zip(schema.returns, outs)):
        if ret.alias_info is None:  # a new tensor, written
            total += _bytes(v, j in f32)
    return total


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every aten op run under it (`op_bytes`), by op
    name in `by_op`, and the hand kernels' own bytes (`hand_kernel`)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.by_op = defaultdict(int)
        self._outer = None

    def add(self, name: str, nbytes: int) -> None:
        if nbytes:
            self.bytes += nbytes
            self.by_op[name] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.add(str(func.overloadpacket), op_bytes(func, args, kwargs, out))
        return out

    def hand_kernel(self, name: str, nbytes: int, wrapper, *args):
        """Count `nbytes` for hand kernel `name`, then run `wrapper(*args)`
        with no counter active and no dispatch mode on (what it runs is not
        counted)."""
        self.add(name, nbytes)
        _point(None)
        try:
            with _disable_current_modes():
                return wrapper(*args)
        finally:
            _point(self)

    def __enter__(self):
        self._outer = fused_norm.byte_counter
        _point(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _point(self._outer)
        return super().__exit__(*exc)


def _point(counter) -> None:
    """Make `counter` the one the hand kernels' wrappers report to."""
    for module in HAND_KERNEL_MODULES:
        module.byte_counter = counter


def count(fn) -> dict:
    """{flops, bytes, by_op} of one call of `fn`, in one pass: the FLOPs
    as `flops.count` gives them, the bytes as `ByteCounter` counts them
    (`by_op`: bytes by aten op and hand kernel)."""
    with flops.counter() as flop, ByteCounter() as moved:
        fn()
    return dict(flops=int(flop.get_total_flops()), bytes=moved.bytes,
                by_op=dict(moved.by_op))


def sweep_counts(engine, prepared) -> dict:
    """{encode, fuse}: `count` of the encode of a prepared case's windows
    and of one fuse pass (full mask) as `bench.bench_sweep` times it."""
    mask = np.ones(4, bool)
    encode = count(lambda: engine.encode_case(prepared))
    fts = engine.encode_case(prepared)
    return dict(encode=encode, fuse=count(
        lambda: engine.labels_device(prepared, fts, mask)))


def floor_s(work: float, nbytes: float, op_rate: float,
            byte_rate: float) -> tuple[float, float, str]:
    """(t_comp, t_mem, bound) in seconds: `work` operations at `op_rate`,
    `nbytes` at `byte_rate`; `bound` names the larger, "comp" or "mem"."""
    t_comp, t_mem = work / op_rate, nbytes / byte_rate
    return t_comp, t_mem, "mem" if t_mem >= t_comp else "comp"


def program_row(counted: dict, peaks: dict | None, t_meas: float,
                t_best: float) -> dict:
    """One program's row: roofline_sweep.py's fields (times in s,
    `pct_of_roofline` in percent of the measured time); the floors, bound
    and share null without the card's peaks."""
    row = dict(tflop=counted["flops"] / 1e12, gb=counted["bytes"] / 1e9,
               t_comp=None, t_mem=None, bound=None, t_meas=t_meas,
               t_best=t_best, pct_of_roofline=None)
    if peaks is not None:
        t_comp, t_mem, bound = floor_s(counted["flops"], counted["bytes"],
                                       peaks["bf16"], peaks["hbm"])
        row.update(t_comp=t_comp, t_mem=t_mem, bound=bound,
                   pct_of_roofline=100.0 * max(t_comp, t_mem) / t_meas)
    return row


def sweep_floor(encode: dict, fuse: dict, n: int = N_MASKS):
    """(seconds, bound) of a sweep of one encode and n fuse passes with
    every program at its floor; the bound is the programs' if they share
    it, else "mixed"; (None, None) without the peaks."""
    if encode["bound"] is None:
        return None, None
    floor = (max(encode["t_comp"], encode["t_mem"])
             + n * max(fuse["t_comp"], fuse["t_mem"]))
    bound = encode["bound"] if encode["bound"] == fuse["bound"] else "mixed"
    return floor, bound


def sweep_rates(encode: dict, fuse: dict, n: int = N_MASKS) -> dict:
    """The sweep's mask-cases/s at roofline (null without the peaks) and
    measured serially."""
    floor, _ = sweep_floor(encode, fuse, n)
    return dict(sweep_roofline_mask_cases_per_s=None if floor is None
                else n / floor,
                sweep_measured_serial_mask_cases_per_s=n / (
                    encode["t_meas"] + n * fuse["t_meas"]))


def _cell(v, width: int, prec: int) -> str:
    return f"{'-':>{width}}" if v is None else f"{v:{width}.{prec}f}"


def table(rows: dict) -> list[str]:
    """roofline_sweep.py's table of the program rows."""
    lines = [f"{'program':<12} {'TFLOP':>7} {'GB':>8} {'t_comp':>8} "
             f"{'t_mem':>8} {'bound':>6} {'meas':>8} {'best':>8} "
             f"{'%roof':>6}"]
    for k, r in rows.items():
        lines.append(
            f"{k:<12} {r['tflop']:7.3f} {r['gb']:8.2f} "
            f"{_cell(r['t_comp'], 8, 4)} {_cell(r['t_mem'], 8, 4)} "
            f"{r['bound'] or '-':>6} {r['t_meas']:8.4f} {r['t_best']:8.4f} "
            f"{_cell(r['pct_of_roofline'], 5, 1)}%")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="roofline of one program of "
                                "the port on the card")
    p.add_argument("program", choices=("sweep", "train"))
    p.add_argument("--model", default="mmformer",
                   choices=("mmformer", "rfnet", "m2ftrans"))
    p.add_argument("--reps", type=int, default=3, help="timed sweeps")
    p.add_argument("--train_reps", type=int, default=5)
    p.add_argument("--train_steps", type=int, default=10,
                   help="steps per timed train rep")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("roofline: measuring the card needs a CUDA device "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from passion_tpu_torch import bench

    kind = torch.cuda.get_device_name(0)
    peaks = bench.peaks_of(kind)
    card = bench.card_line()
    out = dict(model=args.model, program=args.program,
               peak_flops=peaks and peaks["bf16"],
               peak_bw=peaks and peaks["hbm"])
    if args.program == "sweep":
        run = bench.bench_sweep(args.model, args.reps, peaks=peaks)
        rows, by_op = run["rows"], run["by_op"]
    else:
        run = bench.bench_train(args.model, 2, args.train_reps,
                                args.train_steps, peaks)
        rows, by_op = dict(train_step=run["row"]), dict(
            train_step=run["by_op"])
    for line in table(rows):
        print(line)
    for k, ops in by_op.items():
        total = sum(ops.values())
        print(f"{k}: bytes by op: " + ", ".join(
            f"{op} {n / total:.3f}" for op, n in sorted(
                ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]))
    out.update(rows)
    out["bytes_by_op"] = by_op
    if args.program == "sweep":
        out.update(sweep_rates(rows["encode"], rows["fuse_labels"]))
        roof = out["sweep_roofline_mask_cases_per_s"]
        print(f"sweep ceiling at roofline: "
              f"{'-' if roof is None else format(roof, '.2f')} "
              f"mask-cases/s; serial measured: "
              f"{out['sweep_measured_serial_mask_cases_per_s']:.2f}")
    out["chip"] = card
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
