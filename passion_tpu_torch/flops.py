"""FLOP counts of the port's own programs (counterpart of
`scripts/flops.py`, which asks XLA's cost analysis of the TPU programs).
`python -m passion_tpu_torch.bench` prints them (`flops_*`) beside the
rates they turn into `mfu_*`.

`torch.utils.flop_counter.FlopCounterMode` counts the aten ops the program
runs: convolutions (grouped ones at their true cost, 2 x out elements x
in-channels per group x kernel volume), matrix products (and attention,
where it goes through them) and their backward. Elementwise passes,
reductions, resampling and the hand kernels are not counted: K1-K4 are
launched through a C interface, not as aten ops, and are memory-bound.
So a count is the matrix-unit work of the program, as a utilization
(`mfu`) wants it. Counting is by shapes, independent of dtype and values,
and is done once, on an untimed run: on the card, or on the CPU at any
size. No constant of the TPU programs is carried over: theirs include the
structural zeros of their space-to-depth and block-diagonal layouts.

What `bench` counts with these: one window's full forward (`model(x,
mask)`, batch 1, the unit of bench.py's `REF_FWD_WINDOW_FLOPS`); the
sweep's encode of a case's windows, one fuse pass (one mask) and the whole
15-mask sweep (encode + 15 fuse passes); one PASSION train step, forward
and backward (`count` of the step).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


class _NoModules:
    """Stands in for FlopCounterMode's module tracker, whose per-module
    attribution is not needed here and whose hooks fail when a module
    whose parameters require a gradient runs under `inference_mode` or
    `no_grad` (the sweep engines, the losses' detached parts)."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def counter() -> FlopCounterMode:
    """A FlopCounterMode without its module tracker, to enter around the
    call it counts."""
    c = FlopCounterMode(display=False)
    c.mod_tracker = _NoModules()
    return c


def count(fn) -> int:
    """FLOPs of the aten ops that one call of `fn` runs."""
    with counter() as c:
        fn()
    return int(c.get_total_flops())


def window_forward_flops(model: torch.nn.Module, patch: int) -> int:
    """One full forward of `model` (mask-conditioned backbone) on one
    patch^3 window under the full mask, in its dtype and on its device."""
    p = next(model.parameters())
    x = torch.zeros((1, 4, patch, patch, patch), dtype=p.dtype,
                    device=p.device)
    mask = torch.ones((1, 4), dtype=torch.bool, device=p.device)
    with torch.inference_mode():
        return count(lambda: model(x, mask))


def sweep_flops(engine, prepared, n_masks: int = 15) -> dict:
    """{encode, fuse, sweep} FLOPs of a `SlidingWindowSweep` on a prepared
    case: the encode of every window, one fuse pass (full mask) and
    encode + n_masks fuse passes."""
    mask = np.ones(4, bool)
    encode = count(lambda: engine.encode_case(prepared))
    fts = engine.encode_case(prepared)
    fuse = count(lambda: engine.sum_masked(prepared, fts, mask))
    return dict(encode=encode, fuse=fuse, sweep=encode + n_masks * fuse,
                windows=len(prepared["coords"]))
