"""Sliding-window evaluation sweep (counterpart of
`passion_tpu/engine/sliding_window.py`).

Keeps the reference's exact window protocol (50%-overlap starts plus a
tail window flush with the far edge, predict.py:182-195) and its
coverage-weighted averaging, and runs the windows as device batches: each
window is encoded once (`model.features`) and only the fusion decoder runs
per mask (`model.fuse_inference`), so the 15-mask sweep costs one encode
and 15 fuse passes per case.

Window probabilities accumulate into a float32 volume; labels are the
argmax of that sum (the coverage weight is a positive per-voxel scalar, so
it does not move the argmax). The JAX engine's spatial bucketing, coset
block adds and 2-bit label packing are TPU compile and transfer tricks and
are not needed here.
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


class SlidingWindowSweep:
    """Multi-mask sliding-window evaluator for a backbone that exposes
    `features(x)` and `fuse_inference(features, mask)`.

    The engine keeps its own copy of the model's weights in
    `compute_dtype` on `device` (the JAX engine casts the params inside its
    trace): bf16 is the serving dtype, float32 the parity dtype. Window
    probabilities always accumulate in float32.
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
        window covers them); labels are cropped back to (H, W, Z)."""
        x = np.asarray(x, np.float32)
        h, w, z, _ = x.shape
        eff = tuple(max(e, self.patch) for e in (h, w, z))
        xpad = np.zeros(eff + (x.shape[3],), np.float32)
        xpad[:h, :w, :z] = x
        coords = window_coords(eff, self.patch)
        wb = self.window_batch or _auto_window_batch(len(coords))[0]
        vol = torch.from_numpy(xpad).to(self.device).permute(3, 0, 1, 2)
        return dict(vol=vol.to(self.compute_dtype).contiguous(),
                    coords=coords, window_batch=wb, shape=(h, w, z),
                    eff=eff)

    def _chunks(self, prepared):
        coords, wb = prepared["coords"], prepared["window_batch"]
        return [coords[i:i + wb] for i in range(0, len(coords), wb)]

    def _windows(self, vol: torch.Tensor, cc) -> torch.Tensor:
        p = self.patch
        return torch.stack([vol[:, h:h + p, w:w + p, z:z + p]
                            for h, w, z in cc.tolist()])

    @torch.inference_mode()
    def encode_case(self, prepared) -> list[dict]:
        """Mask-independent features of every window, one dict per chunk."""
        return [self.model.features(self._windows(prepared["vol"], cc))
                for cc in self._chunks(prepared)]

    @torch.inference_mode()
    def _labels_device(self, prepared, fts, mask) -> torch.Tensor:
        """(H, W, Z) uint8 argmax labels for one mask, left on the device."""
        p = self.patch
        acc = torch.zeros((self.num_cls,) + prepared["eff"],
                          dtype=torch.float32, device=self.device)
        m = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        for cc, ft in zip(self._chunks(prepared), fts):
            probs = self.model.fuse_inference(
                ft, m.expand(len(cc), m.shape[0])).float()
            for (h, w, z), pr in zip(cc.tolist(), probs):
                acc[:, h:h + p, w:w + p, z:z + p] += pr
        h, w, z = prepared["shape"]
        return acc.argmax(dim=0).to(torch.uint8)[:h, :w, :z]

    def infer_labels_masked(self, prepared, fts, mask) -> np.ndarray:
        """Argmax labels (H, W, Z) uint8 for one mask from stored features."""
        return self._labels_device(prepared, fts, mask).cpu().numpy()

    def sweep_labels(self, prepared, masks) -> list[np.ndarray]:
        """Labels for every mask in `masks`, encoding each window once. All
        fuse passes are queued before any label volume is copied back."""

        def go():
            fts = self.encode_case(prepared)
            pending = [self._labels_device(prepared, fts, m) for m in masks]
            return [lab.cpu().numpy() for lab in pending]

        return self._with_oom_fallback(prepared, go)

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
            logging.warning("sliding-window sweep ran out of device memory "
                            "at window_batch=%d; retrying with chunks of <= "
                            "%d windows (pass --window_batch to pin a size)",
                            wb, cap)
            prepared["window_batch"] = _auto_window_batch(
                len(prepared["coords"]), 1, cap)[0]
