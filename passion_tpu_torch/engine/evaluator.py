"""Evaluation: per-mask scoring and the 15-combination sweep, with their
CSVs (counterpart of `passion_tpu/engine/evaluator.py`).

`test_dice_hd95_softmax` scores one modality combination over the test set
(utils/predict.py:144-252): per case the engine's argmax labels, Dice
WT/TC/ET(+postpro) and HD95, one CSV row per case.

`run_test_sweep` scores all 15: for each test case one
`SlidingWindowSweep.dispatch_labels` over every mask (cases outer, masks
inner: each volume is staged on the card once), or one `infer_labels` per
mask for an engine without the sweep, then Dice and HD95 per (case, mask).
It runs one case deep, as the JAX evaluator does: case i + 1 is staged and
its device work queued before case i's labels are fetched and scored.
HD95 (four full-volume distance transforms per case and mask) runs in a
thread pool beside the device work, and after each case the results are
read back until at most two cases of jobs (and their label volumes) wait
(JAX evaluator.py:131-138, 196-209). The CSV keeps the
reference's layout byte for byte: masks in reversed canonical order, a
mask-name row before each mask's case rows, and the merged 'ET HD95ETPro
HD95' header cell of the reference's string-concatenation quirk
(train.py:587). With a sharded sweep every rank runs the sweep and only
the engine's main rank scores and writes.
"""

from __future__ import annotations

import csv
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from passion_tpu_torch.masks import MASK_ARRAY, MASK_NAMES
from passion_tpu_torch.metrics import AverageMeter, cal_hd95, dice_class4

CLASS_EVALUATION = ("whole", "core", "enhancing", "enhancing_postpro")


def _csv_append(csv_name, row):
    if csv_name is None:
        return
    os.makedirs(os.path.dirname(csv_name) or ".", exist_ok=True)
    with open(csv_name, "a+", newline="") as f:
        csv.writer(f).writerow(row)


def test_dice_hd95_softmax(test_loader, engine, feature_mask,
                           mask_name=None, csv_name=None):
    """Score one modality combination over the test set (JAX
    evaluator.py:35-97; predict.py:144-252).

    test_loader: batches {'x': (B, H, W, Z, 4), 'target': (B, H, W, Z) int
    labels, 'name': [B names]}; engine: a sliding-window engine with
    `prepare` and `infer_labels`; feature_mask: the (4,) bool mask of every
    case (predict.py:174-179). Appends one CSV row per case (Dice WT, TC,
    ET, ETPro, then their HD95) and returns (avg_dice (4,), avg_hd95
    (4,))."""
    vals_dice, vals_hd95 = AverageMeter(), AverageMeter()
    n_batches = len(test_loader) if hasattr(test_loader, "__len__") else "?"
    mask = np.asarray(feature_mask, bool)
    if mask_name:
        logging.info("mask %s", mask_name)
    for i, batch in enumerate(test_loader):
        x, target = np.asarray(batch["x"]), np.asarray(batch["target"])
        names = batch["name"]
        pred = np.stack([engine.infer_labels(engine.prepare(x[b]), mask)
                         for b in range(x.shape[0])])
        _, scores_eval = dice_class4(pred, target)
        scores_eval = np.asarray(scores_eval)
        # the reference takes HD95 of batch element 0 only (predict.py:222)
        # at its test batch size of 1; every element here
        for k, name in enumerate(names):
            hd = np.array(cal_hd95(pred[k], target[k]))
            vals_dice.update(scores_eval[k])
            vals_hd95.update(hd)
            logging.info(
                "Subject %d/%s, %d/%d%20s, DSC: %s, HD95: %s", i + 1,
                n_batches, k + 1, len(names), name,
                ", ".join(f"{c}: {v:.4f}"
                          for c, v in zip(CLASS_EVALUATION, scores_eval[k])),
                ", ".join(f"{c}: {v:.4f}"
                          for c, v in zip(CLASS_EVALUATION, hd)))
            _csv_append(csv_name, list(scores_eval[k][:4]) + list(hd[:4]))
    logging.info("Average scores: DSC: %s, HD95: %s",
                 ", ".join(f"{c}: {v:.4f}"
                           for c, v in zip(CLASS_EVALUATION, vals_dice.avg)),
                 ", ".join(f"{c}: {v:.4f}"
                           for c, v in zip(CLASS_EVALUATION, vals_hd95.avg)))
    return vals_dice.avg, vals_hd95.avg


def run_test_sweep(test_loader, engine, csv_name=None, masks=None,
                   mask_names=None):
    """Score every mask over the test set with a `SlidingWindowSweep`, or
    with an engine that has only `infer_labels` (one pass per mask).

    test_loader: iterable of batches {'x': (B, H, W, Z, 4), 'target':
    (B, H, W, Z) int labels, 'name': [B names]}. Returns (avg_dice (4,),
    avg_hd95 (4,), per_mask {name: {'dice', 'hd95'}}), or (None, None,
    None) on a rank of a sharded sweep other than the main one, which only
    takes its part of the sweep.
    """
    masks = MASK_ARRAY if masks is None else masks
    mask_names = MASK_NAMES if mask_names is None else mask_names
    order = list(zip(list(masks)[::-1], list(mask_names)[::-1]))
    sweep_masks = [np.asarray(m, bool) for m, _ in order]
    if not getattr(engine, "is_main", True):
        for batch in test_loader:
            for xk in np.asarray(batch["x"]):
                engine.sweep_labels(engine.prepare(xk), sweep_masks)
        return None, None, None
    rows = {name: [] for _, name in order}
    scores = {name: (AverageMeter(), AverageMeter()) for _, name in order}
    n_batches = len(test_loader) if hasattr(test_loader, "__len__") else "?"
    sweep = hasattr(engine, "dispatch_labels")
    pending = []  # (mask name, dice row, hd95 future), in emission order

    def drain(keep):
        while len(pending) > keep:
            mname, ev, fut = pending.pop(0)
            hd = np.asarray(fut.result())
            dm, hm = scores[mname]
            dm.update(ev)
            hm.update(hd)
            rows[mname].append(list(ev) + list(hd))

    def dispatch(batch):
        """Stage each case of a batch and queue its device work."""
        prepared = [engine.prepare(xk) for xk in np.asarray(batch["x"])]
        return dict(
            target=np.asarray(batch["target"]), names=batch["name"],
            labels=[engine.dispatch_labels(p, sweep_masks) if sweep else
                    [engine.infer_labels(p, m) for m in sweep_masks]
                    for p in prepared])

    def score(i, staged, pool):
        target = staged["target"]
        for k, name in enumerate(staged["names"]):
            labels = staged["labels"][k]
            if sweep:
                labels = engine.fetch_labels(labels)
            for (_, mname), lab in zip(order, labels):
                _, ev = dice_class4(lab[None], target[k][None])
                pending.append((mname, ev[0], pool.submit(
                    cal_hd95, lab, target[k])))
                logging.info(
                    "Subject %d/%s [%s]%20s, DSC: %s", i + 1, n_batches,
                    mname, name, ", ".join(
                        f"{c}: {v:.4f}"
                        for c, v in zip(CLASS_EVALUATION, ev[0])))
        # at most two cases of label volumes wait for the pool
        drain(keep=2 * len(order) * len(staged["names"]))

    # one case deep: case i + 1 is staged and its device work queued before
    # case i's labels are fetched and scored
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 4)) as pool:
        prev = None
        for i, batch in enumerate(test_loader):
            staged = dispatch(batch)
            if prev is not None:
                score(*prev, pool)
            prev = (i, staged)
        if prev is not None:
            score(*prev, pool)
        drain(keep=0)

    dice_meter = AverageMeter()
    hd95_meter = AverageMeter()
    per_mask = {}
    _csv_append(csv_name, ["WT Dice", "TC Dice", "ET Dice", "ETPro Dice",
                           "WT HD95", "TC HD95", "ET HD95" "ETPro HD95"])
    for _, mname in order:
        _csv_append(csv_name, [mname])
        for row in rows[mname]:
            _csv_append(csv_name, row)
        dm, hm = scores[mname]
        logging.info("%s: DSC %s, HD95 %s", mname, dm.avg, hm.avg)
        per_mask[mname] = dict(dice=np.asarray(dm.avg), hd95=np.asarray(hm.avg))
        dice_meter.update(dm.avg)
        hd95_meter.update(hm.avg)
    logging.info("Avg Dice scores: %s", dice_meter.avg)
    logging.info("Avg HD95 scores: %s", hd95_meter.avg)
    return dice_meter.avg, hd95_meter.avg, per_mask
