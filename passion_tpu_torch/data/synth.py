"""Synthetic BraTS-like data (copy of `passion_tpu/data/synth.py`, with
`generate_imb_mr` from `passion_tpu/data/preprocess.py:137-200`; the same
seed gives the same volumes and the same CSV).

Writes the on-disk layout the data layer reads: vol/*.npy (H, W, Z, 4)
float32, seg/*.npy (H, W, Z) uint8 in {0..3}, train/val/test lists, and
the imbalanced-missing-rate training CSV `imb_split.csv`, with tumour-like
gaussian blobs so Dice scores are not degenerate.

Usage: `python -m passion_tpu_torch.data.synth OUTDIR [--cases 6]
[--shape 96 96 80]`
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from passion_tpu_torch.masks import mask_id_of, sub_combination_ids

# The reference's combination allocation order, as (t1, t1c, flair, t2)
# presence tuples (generate_imb_mr.py:46-173: tttt, ttft, tttf, ttff, ...).
_COMBO_ORDER = [
    tuple(ch == "t" for ch in name)
    for name in ("tttt", "ttft", "tttf", "ttff", "tftt", "tftf", "tfft",
                 "tfff", "fttt", "ftft", "fttf", "ftff", "fftt", "fftf",
                 "ffft")
]


def generate_imb_mr(train_names, csv_path, p=(0.2, 0.4, 0.6, 0.8),
                    seed=1037):
    """Write the imbalanced-missing-rate CSV as the reference generator
    does (generate_imb_mr.py:20-283), bit for bit: the legacy MT19937
    stream of np.random.seed/rand/shuffle/get_state, four i.i.d. presence
    draws, the expected-count overwrite of the first `count` slots in
    `_COMBO_ORDER` (count = int(n * prod(present ? 1 - p_i : p_i)), 1 if
    0), an all-missing tail, an identical-state co-shuffle of the four
    presence arrays, and per-row re-rolls of all-missing rows at write
    time. Rows are `data_name, mask_id, mask, pos_mask_ids`.

    p: per-modality MISSING probabilities in the reference's (t1, t1c,
    flair, t2) order. Returns the per-modality present counts in canonical
    (flair, t1ce, t1, t2) order."""
    names = sorted(train_names)
    n = len(names)
    rs = np.random.RandomState(seed)  # legacy MT19937 == np.random.seed

    # i.i.d. draws (generate_imb_mr.py:37-41), consumed from the stream
    # even though the first `count` slots are overwritten below
    cols = [rs.rand(n) > pi for pi in p]  # t1, t1c, flair, t2
    count = 0
    for bits in _COMBO_ORDER:
        prob = 1.0
        for present, miss_p in zip(bits, p):
            prob *= (1.0 - miss_p) if present else miss_p
        c = int(n * prob)
        c = c if c > 0 else c + 1
        for col, present in zip(cols, bits):
            col[count:count + c] = present
        count += c
    for col in cols:  # all-missing tail (generate_imb_mr.py:167-171)
        col[count:] = False

    # identical-state co-shuffle (generate_imb_mr.py:191-198)
    state = rs.get_state()
    for col in cols:
        rs.set_state(state)
        rs.shuffle(col)

    t1, t1c, flair, t2 = cols
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    modal_counts = np.zeros(4, dtype=np.int64)
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["data_name", "mask_id", "mask", "pos_mask_ids"])
        for i, name in enumerate(names):
            # all-missing rows re-rolled at write time
            # (generate_imb_mr.py:213-219)
            while not (t1[i] or t1c[i] or flair[i] or t2[i]):
                t1[i] = rs.rand(1) > p[0]
                t1c[i] = rs.rand(1) > p[1]
                flair[i] = rs.rand(1) > p[2]
                t2[i] = rs.rand(1) > p[3]
            # canonical column order: flair, t1ce, t1, t2 (masks.MODALITIES)
            mask = [bool(flair[i]), bool(t1c[i]), bool(t1[i]), bool(t2[i])]
            modal_counts += np.array(mask, dtype=np.int64)
            w.writerow([name, mask_id_of(mask), mask,
                        sub_combination_ids(mask)])
    return modal_counts


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


def make_synthetic_dataset(root, n_cases=6, shape=(96, 96, 80), seed=0,
                           p=(0.2, 0.4, 0.6, 0.8)):
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
    generate_imb_mr(names[n_test:], os.path.join(root, "imb_split.csv"),
                    p=p, seed=seed)
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
