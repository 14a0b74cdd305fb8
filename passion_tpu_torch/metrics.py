"""Evaluation metrics: BraTS composite-region Dice and HD95 (counterpart of
`passion_tpu/metrics.py`).

Dice mirrors `softmax_output_dice_class4` (reference predict.py:78-124):
NCR/NET, ED, ET dice plus WT/TC/ET composite regions and the ET
post-processing rule (predicted ET zeroed when under 500 voxels). HD95
mirrors `cal_hd95` / `compute_BraTS_HD95` (predict.py:23-76) with the same
0 / 1.0 conventions for empty masks, on scipy distance transforms.

Those are numpy and scipy on the host. `score_masks` computes both for a
batch of label volumes against one target where the tensors lie, with the
distance transform of K5 (`ops/edt.py`) on the card: Dice from one 4x4
confusion matrix per volume, finished on the host in float64 with
`dice_class4`'s arithmetic (bit for bit), and HD95 as the 95th percentile
of a histogram of squared surface distances, interpolated on the host as
`np.percentile` does (equal to `cal_hd95` to rounding: square roots of the
same integers).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from passion_tpu_torch.ops.edt import edt_sq

EPS = 1e-8
ET_POSTPRO_MIN_VOXELS = 500


def dice_class4(output, target):
    """BraTS 4-class dice scores from (B, H, W, Z) integer label volumes.

    Returns float32 (dice_separate (B, 3) [NCR/NET, ED, ET],
    dice_evaluate (B, 4) [WT, TC, ET, ET-postpro]). Voxel counts are exact
    integers; the ET-postpro rule is gated per sample.
    """
    output = np.asarray(output)
    target = np.asarray(target)
    axes = (1, 2, 3)

    def _dice(o, t):
        inter = 2.0 * np.sum(o & t, axis=axes) + EPS
        return inter / (np.sum(o, axis=axes) + np.sum(t, axis=axes) + EPS)

    o1, t1 = output == 1, target == 1
    o2, t2 = output == 2, target == 2
    o3, t3 = output == 3, target == 3
    keep_et = np.sum(o3, axis=axes) >= ET_POSTPRO_MIN_VOXELS
    o4 = o3 & keep_et[:, None, None, None]

    separate = np.stack([_dice(o1, t1), _dice(o2, t2), _dice(o3, t3)], axis=1)
    evaluate = np.stack([_dice(o1 | o2 | o3, t1 | t2 | t3),
                         _dice(o1 | o3, t1 | t3),
                         _dice(o3, t3), _dice(o4, t3)], axis=1)
    return separate.astype(np.float32), evaluate.astype(np.float32)


def _surface_distances(result: np.ndarray, reference: np.ndarray,
                       spacing=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Distances from `result` border voxels to `reference` border."""
    footprint = ndimage.generate_binary_structure(result.ndim, 1)
    result_border = result ^ ndimage.binary_erosion(result, structure=footprint,
                                                    iterations=1)
    reference_border = reference ^ ndimage.binary_erosion(
        reference, structure=footprint, iterations=1)
    dt = ndimage.distance_transform_edt(~reference_border, sampling=spacing)
    return dt[result_border]


def hd95(result: np.ndarray, reference: np.ndarray,
         spacing=(1.0, 1.0, 1.0)) -> float:
    """95th-percentile symmetric Hausdorff distance of binary volumes."""
    sd1 = _surface_distances(result, reference, spacing)
    sd2 = _surface_distances(reference, result, spacing)
    return float(np.percentile(np.hstack((sd1, sd2)), 95))


def compute_brats_hd95(ref: np.ndarray, pred: np.ndarray) -> float:
    """Empty-mask conventions of predict.py:23-47 (spacing (1,1,1))."""
    num_ref = int(np.sum(ref))
    num_pred = int(np.sum(pred))
    if num_ref == 0:
        return 0.0 if num_pred == 0 else 1.0
    if num_pred == 0:
        return 1.0
    return hd95(pred.astype(bool), ref.astype(bool))


def cal_hd95(output: np.ndarray, target: np.ndarray):
    """(WT, TC, ET, ET-postpro) HD95 from integer label volumes."""
    out = np.asarray(output)
    tgt = np.asarray(target)

    hd_whole = compute_brats_hd95((tgt != 0).astype(int), (out != 0).astype(int))
    hd_core = compute_brats_hd95(((tgt == 1) | (tgt == 3)).astype(int),
                                 ((out == 1) | (out == 3)).astype(int))
    pred_et = (out == 3).astype(int)
    hd_enh = compute_brats_hd95((tgt == 3).astype(int), pred_et)
    pred_et_post = pred_et * 0 if pred_et.sum() < ET_POSTPRO_MIN_VOXELS else pred_et
    hd_enh_post = compute_brats_hd95((tgt == 3).astype(int), pred_et_post)
    return (hd_whole, hd_core, hd_enh, hd_enh_post)


# --- the same scores on the labels' device ----------------------------------

REGIONS = ((1, 2, 3), (1, 3), (3,))  # WT, TC, ET: the labels of each region
N_CLASSES = 4  # labels 0..3


def _order_stats(hist: torch.Tensor):
    """(n, lo, hi) per row of (R, B) counts of squared distances 0..B-1: the
    sample size and the squared values at the sorted positions floor and
    ceil of 0.95 (n - 1), as numpy's 'linear' percentile picks them (both
    the last value when 0.95 (n - 1) >= n - 1)."""
    cum = hist.cumsum(1)
    n = cum[:, -1]
    vi = (n - 1).double() * 0.95  # numpy: (n - 1) * (95 / 100)
    top = vi >= n - 1
    lo = torch.where(top, n - 1, vi.floor().long())
    hi = torch.where(top, n - 1, lo + 1)
    at = torch.searchsorted(cum, torch.stack([lo, hi], 1), right=True)
    return torch.stack([n, at[:, 0], at[:, 1]], 1)


def _lerp95(n: int, lo: int, hi: int) -> float:
    """np.percentile(a, 95) of n values whose order statistics at floor and
    ceil of 0.95 (n - 1) are sqrt(lo) and sqrt(hi): numpy's linear method
    step for step in float64."""
    vi = (n - 1) * np.true_divide(95, 100)
    t = vi - np.floor(vi)
    a, b = np.sqrt(np.float64(lo)), np.sqrt(np.float64(hi))
    diff = b - a
    return float(b - diff * (1 - t) if t >= 0.5 else a + diff * t)


def percentile95_of_histograms(hist: torch.Tensor) -> np.ndarray:
    """(R,) float64: np.percentile(sqrt(values), 95) of each row's multiset
    of squared distances, given as (R, B) counts of the values 0..B-1."""
    return np.array([_lerp95(*row) for row in
                     _order_stats(hist).cpu().tolist()], np.float64)


def score_masks(labels: torch.Tensor, target: torch.Tensor):
    """Dice and HD95 of M label volumes against one target, where they lie.

    labels: (M, H, W, Z) uint8; target: (H, W, Z) uint8 on the same device;
    labels in 0..3 (ValueError otherwise). Returns numpy (dice (M, 4)
    float32, hd95 (M, 4) float64), both [WT, TC, ET, ET-postpro]: row m is
    `dice_class4(labels[m][None], target[None])[1][0]` bit for bit and
    `cal_hd95(labels[m], target)`. Per region with a non-empty target,
    one transform of the target's border and one of the non-empty
    predictions' borders (K5 on the card); the ET-postpro column reuses
    ET's distances, as `cal_hd95` does.
    """
    m, dev = labels.shape[0], labels.device
    k = N_CLASSES + 1  # a label above 3 lands in row or column 4
    mask_ids = torch.arange(m, device=dev, dtype=torch.int32).view(
        m, 1, 1, 1)
    keys = ((mask_ids * k + labels.clamp(max=N_CLASSES).to(torch.int32)) * k
            + target.clamp(max=N_CLASSES).to(torch.int32))
    conf = torch.bincount(keys.view(-1), minlength=m * k * k).view(
        m, k, k).cpu().numpy()
    del keys
    if conf[:, N_CLASSES].any() or conf[:, :, N_CLASSES].any():
        raise ValueError("score_masks takes labels 0..3")

    def dice(oc, tc, keep=True):
        inter = np.where(keep, conf[:, oc][:, :, tc].sum((1, 2)), 0)
        n_out = np.where(keep, conf[:, oc, :].sum((1, 2)), 0)
        n_tgt = conf[:, :, tc].sum((1, 2))
        return (2.0 * inter + EPS) / (n_out + n_tgt + EPS)

    n_et = conf[:, 3, :].sum(1)
    keep_et = n_et >= ET_POSTPRO_MIN_VOXELS
    evaluate = np.stack([dice([1, 2, 3], [1, 2, 3]), dice([1, 3], [1, 3]),
                         dice([3], [3]), dice([3], [3], keep_et)],
                        axis=1).astype(np.float32)

    hd = np.zeros((m, 4))
    nb = sum((s - 1) ** 2 for s in labels.shape[1:]) + 1  # squared values
    pending, hists = [], []  # (region, rows), their squared-distance counts
    for r, classes in enumerate(REGIONS):
        cls = list(classes)
        n_ref = int(conf[0][:, cls].sum())
        n_pred = conf[:, cls, :].sum((1, 2))
        if n_ref == 0:
            hd[:, r] = np.where(n_pred == 0, 0.0, 1.0)
            continue
        hd[:, r] = 1.0  # an empty prediction
        rows_r = np.flatnonzero(n_pred > 0)
        if rows_r.size == 0:
            continue
        sel = labels if rows_r.size == m else labels[
            torch.as_tensor(rows_r, device=dev)]
        e_ref = edt_sq(target[None].contiguous(), classes).view(-1)
        e_pred = edt_sq(sel.contiguous(), classes).view(rows_r.size, -1)
        ref_at = (e_ref == 0).nonzero().squeeze(1)  # the target's border
        pm, pv = (e_pred == 0).nonzero(as_tuple=True)  # each prediction's
        keys = torch.cat([
            pm * nb + e_ref[pv],  # prediction border -> target border
            (torch.arange(rows_r.size, device=dev).view(-1, 1) * nb
             + e_pred[:, ref_at]).view(-1)])  # target border -> prediction
        hists.append(torch.bincount(keys, minlength=rows_r.size * nb).view(
            rows_r.size, nb))
        pending.append((r, rows_r))
        del e_pred, keys
    if pending:
        values = iter(percentile95_of_histograms(torch.cat(hists)))
        for r, rows_r in pending:
            hd[rows_r, r] = [next(values) for _ in rows_r]
    n_ref_et = int(conf[0][:, 3].sum())
    hd[:, 3] = np.where(keep_et, hd[:, 2], 0.0 if n_ref_et == 0 else 1.0)
    return evaluate, hd


class AverageMeter:
    """Running average (predict.py:127-142)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum = self.sum + val * n
        self.count += n
        self.avg = self.sum / self.count
