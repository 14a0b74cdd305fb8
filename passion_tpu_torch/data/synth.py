"""Synthetic BraTS-like test data (copy of `passion_tpu/data/synth.py`'s
`make_case` / `make_synthetic_dataset`; the same seed gives the same
volumes).

Writes the on-disk layout the data layer reads: vol/*.npy (H, W, Z, 4)
float32, seg/*.npy (H, W, Z) uint8 in {0..3}, and train/val/test lists,
with tumour-like gaussian blobs so Dice scores are not degenerate. The
imbalanced-missing-rate training CSV comes with the training slice.

Usage: `python -m passion_tpu_torch.data.synth OUTDIR [--cases 6]
[--shape 96 96 80]`
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _blob(shape, center, radius):
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = sum((g - c) ** 2 / (radius ** 2) for g, c in zip(grids, center))
    return d2 <= 1.0


def make_case(shape, rng):
    h, w, z = shape
    vol = rng.standard_normal((h, w, z, 4)).astype(np.float32) * 0.3
    seg = np.zeros((h, w, z), np.uint8)
    center = [int(rng.integers(s // 4, 3 * s // 4)) for s in shape]
    r_whole = int(min(shape) * 0.22)
    for cls, frac in ((2, 1.0), (1, 0.6), (3, 0.33)):
        seg[_blob((h, w, z), center, max(2, int(r_whole * frac)))] = cls
    # tumour brightens each modality differently
    for c in range(4):
        vol[..., c] += (seg > 0) * (0.5 + 0.5 * c) + (seg == 3) * 0.8
    return vol, seg


def make_synthetic_dataset(root, n_cases=6, shape=(96, 96, 80), seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "vol"), exist_ok=True)
    os.makedirs(os.path.join(root, "seg"), exist_ok=True)
    names = [f"SYN_{i:03d}" for i in range(n_cases)]
    for name in names:
        vol, seg = make_case(shape, rng)
        np.save(os.path.join(root, "vol", name + "_vol.npy"), vol)
        np.save(os.path.join(root, "seg", name + "_seg.npy"), seg)
    n_test = max(1, n_cases // 3)
    for fname, part in (("train.txt", names[n_test:]),
                        ("val.txt", names[:n_test]),
                        ("test.txt", names[:n_test])):
        with open(os.path.join(root, fname), "w") as f:
            f.writelines(n + "\n" for n in part)
    return names


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--cases", type=int, default=6)
    ap.add_argument("--shape", type=int, nargs=3, default=(96, 96, 80))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    names = make_synthetic_dataset(args.outdir, args.cases,
                                   tuple(args.shape), args.seed)
    print(f"wrote {len(names)} cases to {args.outdir}")
