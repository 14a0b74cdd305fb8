"""FLOP counts of the port's own programs (counterpart of
`scripts/flops.py`, which asks XLA's cost analysis of the TPU programs).
`python -m passion_tpu_torch.bench` prints them (`flops_*`) beside the
rates they turn into `mfu_*`.

`torch.utils.flop_counter.FlopCounterMode` counts the aten ops the program
runs: convolutions (grouped ones at their true cost, 2 x out elements x
in-channels per group x kernel volume), matrix products (and attention,
where it goes through them) and their backward. A conv's backward counts
its data gradient as torch does and its weight gradient equal to its
forward, once per conv: torch's own formula counts a `groups=g` conv's
weight gradient g times, so `counter()` replaces it. Elementwise passes,
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
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count


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


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        groups, output_mask, out_shape, **kwargs) -> int:
    """`aten.convolution_backward`: the data gradient as torch counts it
    (a transposed conv of the output gradient), the weight gradient as
    torch counts it over `groups` (torch's term takes every input channel
    against every output channel, where a grouped conv pairs each with
    its own group's only), which equals the conv's forward."""
    def t(shape):
        return [shape[1], shape[0], *shape[2:]]

    n = 0
    if output_mask[0]:
        n += conv_flop_count(grad_out_shape, w_shape, out_shape[0],
                             not transposed)
    if output_mask[1]:
        a, b = (grad_out_shape, x_shape) if transposed else (x_shape,
                                                             grad_out_shape)
        n += conv_flop_count(t(a), t(b), t(out_shape[1])) // groups
    return n


def counter() -> FlopCounterMode:
    """A FlopCounterMode without its module tracker, with a conv's weight
    gradient counted once (`_conv_backward_flop`), to enter around the
    call it counts."""
    c = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop})
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
