"""Evaluation metrics: BraTS composite-region Dice and HD95 (counterpart of
`passion_tpu/metrics.py`; numpy and scipy, on the host).

Dice mirrors `softmax_output_dice_class4` (reference predict.py:78-124):
NCR/NET, ED, ET dice plus WT/TC/ET composite regions and the ET
post-processing rule (predicted ET zeroed when under 500 voxels). HD95
mirrors `cal_hd95` / `compute_BraTS_HD95` (predict.py:23-76) with the same
0 / 1.0 conventions for empty masks, on scipy distance transforms.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

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
