"""Sliding-window inference engines (counterpart of
`passion_tpu/engine/sliding_window.py`).

Both keep the reference's exact window protocol (50%-overlap starts plus a
tail window flush with the far edge, predict.py:182-195) and its
coverage-weighted averaging, and run the windows as device batches
(chunks of `window_batch` windows):

  * `SlidingWindowInference` runs the whole `model(windows, mask)` per
    chunk, for one mask at a time (the reference's per-mask evaluation,
    `evaluator.test_dice_hd95_softmax`);
  * `SlidingWindowSweep` encodes each window once (`model.features`) and
    runs only the fusion decoder per mask (`model.fuse_inference`), so the
    15-mask sweep costs one encode and 15 fuse passes per case.

`make_engine` picks the sweep for a backbone that has the split.

Window probabilities accumulate into a float32 volume; labels are the
argmax of that sum (the coverage weight is a positive per-voxel scalar, so
it does not move the argmax). The JAX engine's spatial bucketing, coset
block adds and 2-bit label packing are TPU compile and transfer tricks and
are not needed here.

With a `world` (parallel/world.py) the sweep splits a case's window chunks
over the ranks: each rank encodes and fuses its own chunks into a float32
partial volume, and the partial volumes are summed with an all-reduce
before the argmax (sliding_window.py:488-502), so every rank gets the
labels. The single-mask engine is not sharded.
"""

from __future__ import annotations

import copy
import logging

import numpy as np
import torch

from passion_tpu_torch import resolve_device

# Largest auto window batch: all 75 windows of a 240x240x155 BraTS case in
# one chunk (the JAX engine's measured-best setting). An OOM halves it.
_AUTO_WINDOW_BATCH_CAP = 80


def _auto_window_batch(n: int, n_shards: int = 1,
                       cap: int = _AUTO_WINDOW_BATCH_CAP) -> tuple[int, int]:
    """(window_batch, n_chunks) minimizing pad waste for `n` windows: the
    fewest chunks of at most `cap` windows, a multiple of `n_shards`,
    sized evenly. n=75 -> (75, 1)."""
    nc = max(1, -(-n // cap))
    nc = -(-nc // n_shards) * n_shards
    return -(-n // nc), nc


def window_starts(extent: int, patch: int) -> list[int]:
    """50%-overlap start indices + tail window (predict.py:182-195)."""
    stride = int(patch * 0.5)
    cnt = int(np.ceil((extent - patch) / stride))
    starts = [i * stride for i in range(cnt)]
    starts.append(extent - patch)
    return starts


def window_coords(shape, patch: int) -> np.ndarray:
    """(N, 3) int32 window origins for an (H, W, Z) extent."""
    hs = window_starts(shape[0], patch)
    ws = window_starts(shape[1], patch)
    zs = window_starts(shape[2], patch)
    coords = [(h, w, z) for h in hs for w in ws for z in zs]
    return np.asarray(coords, dtype=np.int32)


def coverage_weight(shape3, padded3, patch: int) -> np.ndarray:
    """(Hp, Wp, Zp) per-voxel window-coverage count (predict.py:198-203),
    computed analytically as a product of per-axis counts."""
    axes = []
    for extent, padded in zip(shape3, padded3):
        cov = np.zeros((padded,), np.float32)
        for s in window_starts(extent, patch):
            cov[s:s + patch] += 1.0
        axes.append(cov)
    return axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]


class SlidingWindowInference:
    """Single-mask sliding-window evaluator around the backbone's forward
    `model(windows (N, 4, p, p, p), mask (N, 4)) -> softmax (N, C, p, p,
    p)` (sliding_window.py:204-406).

    The engine keeps its own copy of the model's weights in
    `compute_dtype` on `device` (the JAX engine casts the params inside its
    trace): bf16 is the serving dtype, float32 the parity dtype. Window
    probabilities always accumulate in float32. `window_batch` None (or 0)
    sizes the chunks per case (`_auto_window_batch`: one chunk of the 75
    windows of a BraTS case), and a device out-of-memory error halves it;
    an explicit `window_batch` is never changed.
    """

    def __init__(self, model: torch.nn.Module, num_cls: int = 4,
                 patch: int = 80, window_batch: int | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model).to(self.device,
                                             compute_dtype).eval()
        self.num_cls = num_cls
        self.patch = patch
        self.window_batch = window_batch or None  # 0 (CLI) == None == auto
        self.compute_dtype = compute_dtype

    def prepare(self, x) -> dict:
        """Stage one (H, W, Z, 4) volume on the device for repeated
        inference. Axes shorter than the patch are zero-padded up to it (one
        window covers them); outputs are cropped back to (H, W, Z)."""
        x = np.asarray(x, np.float32)
        h, w, z, _ = x.shape
        eff = tuple(max(e, self.patch) for e in (h, w, z))
        xpad = np.zeros(eff + (x.shape[3],), np.float32)
        xpad[:h, :w, :z] = x
        coords = window_coords(eff, self.patch)
        wb = self.window_batch or _auto_window_batch(len(coords),
                                                     self._n_shards())[0]
        vol = torch.from_numpy(xpad).to(self.device).permute(3, 0, 1, 2)
        return dict(vol=vol.to(self.compute_dtype).contiguous(),
                    coords=coords, window_batch=wb, shape=(h, w, z),
                    eff=eff)

    def _n_shards(self) -> int:
        """The ranks the automatic window batch splits the chunks over."""
        return 1

    def _chunks(self, prepared):
        coords, wb = prepared["coords"], prepared["window_batch"]
        return [coords[i:i + wb] for i in range(0, len(coords), wb)]

    def _windows(self, vol: torch.Tensor, cc) -> torch.Tensor:
        p = self.patch
        return torch.stack([vol[:, h:h + p, w:w + p, z:z + p]
                            for h, w, z in cc.tolist()])

    def _mask(self, mask, n: int) -> torch.Tensor:
        m = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        return m.expand(n, m.shape[0])

    def _new_sum(self, prepared) -> torch.Tensor:
        return torch.zeros((self.num_cls,) + prepared["eff"],
                           dtype=torch.float32, device=self.device)

    def _add_windows(self, acc: torch.Tensor, cc, probs: torch.Tensor):
        """Add each window's probabilities (N, C, p, p, p) at its origin."""
        p = self.patch
        for (h, w, z), pr in zip(cc.tolist(), probs.float()):
            acc[:, h:h + p, w:w + p, z:z + p] += pr

    @torch.inference_mode()
    def _sum_device(self, prepared, mask) -> torch.Tensor:
        """(C, *eff) float32 sum of the window probabilities for one mask."""
        acc = self._new_sum(prepared)
        for cc in self._chunks(prepared):
            wins = self._windows(prepared["vol"], cc)
            self._add_windows(acc, cc, self.model(wins,
                                                  self._mask(mask, len(cc))))
        return acc

    def _labels(self, prepared, acc: torch.Tensor) -> torch.Tensor:
        """(H, W, Z) uint8 argmax labels of a window sum, on the device."""
        h, w, z = prepared["shape"]
        return acc.argmax(dim=0).to(torch.uint8)[:h, :w, :z]

    def run(self, prepared, mask) -> torch.Tensor:
        """Coverage-averaged softmax probabilities (C, *eff) float32 on the
        device (predict.py:198-215)."""

        def go():
            wgt = torch.from_numpy(coverage_weight(
                prepared["eff"], prepared["eff"], self.patch)).to(self.device)
            return self._sum_device(prepared, mask) / wgt.clamp_min(1e-8)

        return self._with_oom_fallback(prepared, go)

    def infer_labels(self, prepared, mask) -> np.ndarray:
        """Argmax labels (H, W, Z) uint8 for one mask."""
        return self._with_oom_fallback(prepared, lambda: self._labels(
            prepared, self._sum_device(prepared, mask)).cpu().numpy())

    def __call__(self, x, mask) -> np.ndarray:
        """x: (H, W, Z, 4) volume; mask: (4,) bool. Returns the (H, W, Z, C)
        coverage-averaged softmax probabilities on the host
        (sliding_window.py:401-406)."""
        prepared = self.prepare(x)
        h, w, z = prepared["shape"]
        probs = self.run(prepared, mask)[:, :h, :w, :z]
        return probs.permute(1, 2, 3, 0).cpu().numpy()

    def _with_oom_fallback(self, prepared, fn):
        """Run `fn`; when the card runs out of memory at an automatic window
        batch, halve the batch and retry. An explicit `window_batch` is the
        user's instruction and is never changed."""
        while True:
            try:
                return fn()
            except torch.cuda.OutOfMemoryError:
                wb = prepared["window_batch"]
                if wb <= 1 or self.window_batch is not None:
                    raise
            # retried outside the handler, so the failed attempt's tensors
            # are released first
            cap = max(1, wb // 2)
            logging.warning("sliding-window inference ran out of device "
                            "memory at window_batch=%d; retrying with chunks "
                            "of <= %d windows (pass --window_batch to pin a "
                            "size)", wb, cap)
            prepared["window_batch"] = _auto_window_batch(
                len(prepared["coords"]), 1, cap)[0]


class SlidingWindowSweep(SlidingWindowInference):
    """Multi-mask sliding-window evaluator for a backbone that exposes
    `features(x)` and `fuse_inference(features, mask)`: each window is
    encoded once and only the fusion decoder runs per mask. Window
    protocol, padding, chunking and the OOM fallback are the single-mask
    engine's.

    `world` (parallel.world.World): shard the window chunks over the ranks
    (module docstring); every rank must call the same methods on the same
    case. Rank 0 (`is_main`) is the one that scores."""

    def __init__(self, model: torch.nn.Module, num_cls: int = 4,
                 patch: int = 80, window_batch: int | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda", world=None):
        super().__init__(model, num_cls, patch, window_batch, compute_dtype,
                         world.device if world is not None else device)
        self.world = world
        self.is_main = world is None or world.is_main

    def _n_shards(self) -> int:
        return 1 if self.world is None else self.world.size

    def _with_oom_fallback(self, prepared, fn):
        """A sharded sweep does not retry at a smaller window batch: its
        ranks would have to agree on the retry."""
        if self.world is not None:
            return fn()
        return super()._with_oom_fallback(prepared, fn)

    def _rank_chunks(self, prepared):
        """The chunks this rank encodes and fuses: every chunk without a
        world, else chunks rank, rank + size, ... (a rank may have none).
        The inherited whole-model methods (`run`, `infer_labels`) run every
        chunk on every rank."""
        chunks = self._chunks(prepared)
        if self.world is None:
            return chunks
        return chunks[self.world.rank::self.world.size]

    @torch.inference_mode()
    def encode_case(self, prepared) -> list[dict]:
        """Mask-independent features of this rank's windows, one entry per
        chunk."""
        return [self.model.features(self._windows(prepared["vol"], cc))
                for cc in self._rank_chunks(prepared)]

    @torch.inference_mode()
    def sum_masked(self, prepared, fts, mask) -> torch.Tensor:
        """(C, *eff) float32 sum of every window's probabilities for one
        mask from stored features; with a world, the ranks' partial sums
        all-reduced."""
        acc = self._new_sum(prepared)
        for cc, ft in zip(self._rank_chunks(prepared), fts):
            self._add_windows(acc, cc, self.model.fuse_inference(
                ft, self._mask(mask, len(cc))))
        if self.world is not None:
            self.world.all_reduce_(acc)
        return acc

    def labels_device(self, prepared, fts, mask) -> torch.Tensor:
        """(H, W, Z) uint8 argmax labels for one mask, left on the device."""
        return self._labels(prepared, self.sum_masked(prepared, fts, mask))

    def infer_labels_masked(self, prepared, fts, mask) -> np.ndarray:
        """Argmax labels (H, W, Z) uint8 for one mask from stored features."""
        return self.labels_device(prepared, fts, mask).cpu().numpy()

    def dispatch_labels(self, prepared, masks):
        """Queue the labels of every mask in `masks` without waiting for
        them: one encode, every mask's fuse pass, then on the card one
        non-blocking copy of each label volume into pinned host memory.
        `fetch_labels` of the result waits and returns them, so the host
        can stage the next case meanwhile; `device_labels` hands out the
        volumes on the device."""

        def go():
            fts = self.encode_case(prepared)
            labs = [self.labels_device(prepared, fts, m) for m in masks]
            if self.device.type != "cuda":
                return labs, None, labs
            host = torch.empty((len(labs),) + tuple(labs[0].shape),
                               dtype=torch.uint8, pin_memory=True)
            for dst, lab in zip(host, labs):
                dst.copy_(lab, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return list(host), done, labs

        return self._with_oom_fallback(prepared, go)

    @staticmethod
    def fetch_labels(pending) -> list[np.ndarray]:
        """(H, W, Z) uint8 labels of a `dispatch_labels` result, one per
        mask, once the card has written them."""
        labs, done, _ = pending
        if done is not None:
            done.synchronize()
        return [lab.numpy() for lab in labs]

    @staticmethod
    def device_labels(pending) -> list[torch.Tensor]:
        """The (H, W, Z) uint8 label tensors of a `dispatch_labels` result
        on the engine's device, in the order of its masks; after
        `fetch_labels` the card has written them."""
        return pending[2]

    def sweep_labels(self, prepared, masks) -> list[np.ndarray]:
        """Labels for every mask in `masks`, encoding each window once. All
        fuse passes are queued before any label volume is copied back."""
        return self.fetch_labels(self.dispatch_labels(prepared, masks))


def make_engine(model: torch.nn.Module, num_cls: int = 4, patch: int = 80,
                window_batch: int | None = None, world=None, **kw):
    """The sweep engine for a backbone with the features/fuse_inference
    split, else the single-mask engine (sliding_window.py:409-424). `world`
    shards the sweep only: the single-mask engine warns and runs on this
    rank's device alone."""
    if hasattr(type(model), "features") and hasattr(type(model),
                                                    "fuse_inference"):
        return SlidingWindowSweep(model, num_cls, patch, window_batch,
                                  world=world, **kw)
    if world is not None:
        logging.warning("sharding needs the sweep engine; %s lacks the "
                        "features/fuse_inference split: running on one "
                        "device", type(model).__name__)
        kw["device"] = world.device
    return SlidingWindowInference(model, num_cls, patch, window_batch, **kw)
