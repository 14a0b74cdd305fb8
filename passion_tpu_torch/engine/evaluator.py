"""The 15-combination evaluation sweep and its CSV (counterpart of
`passion_tpu/engine/evaluator.py:100-229`).

For each test case: one `SlidingWindowSweep.sweep_labels` over every mask
(cases outer, masks inner: each volume is staged on the card once), then
Dice WT/TC/ET(+postpro) and HD95 per (case, mask). HD95 (four full-volume
distance transforms per case and mask) runs in a thread pool beside the
next case's device work. The CSV keeps the reference's layout byte for
byte: masks in reversed canonical order, a mask-name row before each
mask's case rows, and the merged 'ET HD95ETPro HD95' header cell of the
reference's string-concatenation quirk (train.py:587).
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


def run_test_sweep(test_loader, engine, csv_name=None, masks=None,
                   mask_names=None):
    """Score every mask over the test set with a `SlidingWindowSweep`.

    test_loader: iterable of batches {'x': (B, H, W, Z, 4), 'target':
    (B, H, W, Z) int labels, 'name': [B names]}. Returns (avg_dice (4,),
    avg_hd95 (4,), per_mask {name: {'dice', 'hd95'}}).
    """
    masks = MASK_ARRAY if masks is None else masks
    mask_names = MASK_NAMES if mask_names is None else mask_names
    order = list(zip(list(masks)[::-1], list(mask_names)[::-1]))
    sweep_masks = [np.asarray(m, bool) for m, _ in order]
    rows = {name: [] for _, name in order}
    scores = {name: (AverageMeter(), AverageMeter()) for _, name in order}
    n_batches = len(test_loader) if hasattr(test_loader, "__len__") else "?"
    pending = []  # (mask name, dice row, hd95 future), in emission order

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 4)) as pool:
        for i, batch in enumerate(test_loader):
            x = np.asarray(batch["x"])
            target = np.asarray(batch["target"])
            for k, name in enumerate(batch["name"]):
                labels = engine.sweep_labels(engine.prepare(x[k]),
                                             sweep_masks)
                for (_, mname), lab in zip(order, labels):
                    _, ev = dice_class4(lab[None], target[k][None])
                    pending.append((mname, ev[0], pool.submit(
                        cal_hd95, lab, target[k])))
                    logging.info(
                        "Subject %d/%s [%s]%20s, DSC: %s", i + 1, n_batches,
                        mname, name, ", ".join(
                            f"{c}: {v:.4f}"
                            for c, v in zip(CLASS_EVALUATION, ev[0])))
        for mname, ev, fut in pending:
            hd = np.asarray(fut.result())
            dm, hm = scores[mname]
            dm.update(ev)
            hm.update(hd)
            rows[mname].append(list(ev) + list(hd))

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
