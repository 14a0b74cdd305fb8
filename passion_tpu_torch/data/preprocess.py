"""Offline preprocessing: NIfTI -> npy, train/val/test split, imb-MR CSVs
(counterpart of `passion_tpu/data/preprocess.py`; the same inputs give
byte-identical files).

Rebuilds of the reference's three standalone scripts:
  * `convert_dataset`  — code/preprocessing/preprocess_brats.py: per case load
    4 modality NIfTIs + seg, nonzero-crop expanded to >=128/axis, per-modality
    z-score over the brain mask, transpose to (H, W, Z, 4), seg label 4->3,
    HG_/LG_ rename by case number, save vol/ + seg/ npys.
  * `split_dataset`    — code/preprocessing/data_split.py: shuffled
    70/10/20 train/val/test txt lists, sorted.
  * `generate_imb_mr`  — code/preprocessing/generate_imb_mr.py: the
    imbalanced-missing-rate (imb-MR) CSV, the per-case modality dropping
    PASSION trains under.

Host work in numpy; nothing here runs on the card. nibabel reads NIfTI
(imported inside `convert_case` only: training on preprocessed npys does
not need it).

Usage: `python -m passion_tpu_torch.data.preprocess convert --src RAW --dst
NPY`, then `split --npy-root NPY`, then `imbmr --train-file NPY/train.txt
--out-csv NPY/imb_split.csv`.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from passion_tpu_torch.masks import mask_id_of, sub_combination_ids

MODALITY_SUFFIXES = ("flair", "t1ce", "t1", "t2")


def _sup_128(lo, hi, min_size=128):
    """Expand [lo, hi) to at least `min_size` (preprocess_brats.py:15-24)."""
    if hi - lo < min_size:
        pad = int((min_size - (hi - lo)) / 2)
        hi = hi + pad + 1
        lo = lo - pad
    if lo < 0:
        hi -= lo
        lo = 0
    return lo, hi


def crop_bounds(vol, min_size=128):
    """Union-nonzero bounding box expanded to >= min_size per axis.

    vol: (4, X, Y, Z) stacked modalities (preprocess_brats.py:26-42).
    """
    if vol.ndim == 4:
        vol = np.amax(vol, axis=0)
    bounds = []
    for ax in range(3):
        nz = np.where(np.any(vol != 0, axis=tuple(i for i in range(3) if i != ax)))[0]
        lo, hi = _sup_128(int(nz.min()), int(nz.max()), min_size)
        bounds.append((lo, hi))
    return bounds


def normalize(vol):
    """Per-modality z-score over the brain mask (preprocess_brats.py:44-52).

    vol: (4, X, Y, Z); mask = sum over modalities > 0.
    """
    vol = vol.astype(np.float32)
    mask = vol.sum(0) > 0
    for k in range(vol.shape[0]):
        brain = vol[k][mask]
        vol[k] = (vol[k] - brain.mean()) / brain.std()
    return vol


def case_prefix(case_name):
    """HG_/LG_ rename by BraTS2020 case number (preprocess_brats.py:62-64)."""
    num = int(case_name.split("_")[2])
    return "HG_" if num <= 259 or num >= 336 else "LG_"


def convert_case(src_dir, case_name, min_size=128):
    """Load one raw BraTS case -> (vol (H,W,Z,4) float32, seg (H,W,Z) uint8)."""
    import nibabel as nib  # only NIfTI conversion needs it

    mods = []
    for suf in MODALITY_SUFFIXES:
        path = os.path.join(src_dir, case_name, f"{case_name}_{suf}.nii.gz")
        mods.append(np.asanyarray(nib.load(path).dataobj))
    vol = np.stack(mods, axis=0).astype(np.float32)
    (x0, x1), (y0, y1), (z0, z1) = crop_bounds(vol, min_size)
    vol = normalize(vol[:, x0:x1, y0:y1, z0:z1]).transpose(1, 2, 3, 0)

    seg_path = os.path.join(src_dir, case_name, f"{case_name}_seg.nii.gz")
    seg = np.asanyarray(nib.load(seg_path).dataobj).astype(np.uint8)
    seg = seg[x0:x1, y0:y1, z0:z1]
    seg[seg == 4] = 3
    return vol, seg


def convert_dataset(src_path, tar_path, rename=True, min_size=128):
    """Every case directory under `src_path` -> `tar_path`/vol/*_vol.npy and
    `tar_path`/seg/*_seg.npy."""
    os.makedirs(os.path.join(tar_path, "vol"), exist_ok=True)
    os.makedirs(os.path.join(tar_path, "seg"), exist_ok=True)
    for case in sorted(os.listdir(src_path)):
        vol, seg = convert_case(src_path, case, min_size)
        name = (case_prefix(case) if rename else "") + case
        np.save(os.path.join(tar_path, "vol", name + "_vol.npy"), vol)
        np.save(os.path.join(tar_path, "seg", name + "_seg.npy"), seg)


def split_dataset(case_names, tar_path, seed=1037, val_frac=0.1,
                  test_frac=0.2):
    """70/10/20 split, sorted lists (data_split.py:11-44)."""
    names = list(case_names)
    rng = np.random.default_rng(seed)
    rng.shuffle(names)
    ntest = int(test_frac * len(names))
    nval = int(val_frac * len(names))
    splits = {
        "test.txt": sorted(names[:ntest]),
        "val.txt": sorted(names[ntest:ntest + nval]),
        "train.txt": sorted(names[ntest + nval:]),
    }
    os.makedirs(tar_path, exist_ok=True)
    for fname, lst in splits.items():
        with open(os.path.join(tar_path, fname), "w") as f:
            f.writelines(n + "\n" for n in lst)
    return splits


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


def main(argv=None):
    """CLI covering the reference's three standalone preprocessing scripts.

    convert: preprocess_brats.py    split: data_split.py
    imbmr:   generate_imb_mr.py
    """
    import argparse

    ap = argparse.ArgumentParser(prog="passion_tpu_torch.data.preprocess")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="NIfTI cases -> vol/seg npy")
    c.add_argument("--src", required=True, help="dir of per-case NIfTI dirs")
    c.add_argument("--dst", required=True, help="output npy root (vol/, seg/)")
    c.add_argument("--no-rename", action="store_true",
                   help="skip the HG_/LG_ case-number rename")
    c.add_argument("--min-size", type=int, default=128)

    s = sub.add_parser("split", help="70/10/20 train/val/test txt lists")
    s.add_argument("--npy-root", required=True,
                   help="npy root from `convert` (reads vol/*.npy names)")
    s.add_argument("--seed", type=int, default=1037)

    m = sub.add_parser("imbmr", help="imbalanced-missing-rate CSV")
    m.add_argument("--train-file", required=True,
                   help="train.txt from `split`")
    m.add_argument("--out-csv", required=True)
    m.add_argument("--missing-probs", type=float, nargs=4,
                   default=(0.2, 0.4, 0.6, 0.8),
                   metavar=("T1", "T1C", "FLAIR", "T2"),
                   help="per-modality missing probabilities in the "
                        "reference's (t1, t1c, flair, t2) order")
    m.add_argument("--seed", type=int, default=1037)

    args = ap.parse_args(argv)
    if args.cmd == "convert":
        convert_dataset(args.src, args.dst, rename=not args.no_rename,
                        min_size=args.min_size)
    elif args.cmd == "split":
        vol_dir = os.path.join(args.npy_root, "vol")
        names = sorted(f[:-len("_vol.npy")] for f in os.listdir(vol_dir)
                       if f.endswith("_vol.npy"))
        split_dataset(names, args.npy_root, seed=args.seed)
    else:
        with open(args.train_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        counts = generate_imb_mr(names, args.out_csv,
                                 p=tuple(args.missing_probs), seed=args.seed)
        print("present counts (flair, t1ce, t1, t2):", counts.tolist())


if __name__ == "__main__":
    main()
