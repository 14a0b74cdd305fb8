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
A sweep engine on a CUDA device scores each case's 15 label volumes on the
card where the sweep left them (`metrics.score_masks`: Dice from confusion
matrices, HD95 on K5's distance transforms), on a stream of its own so
that case i + 1's sweep, already queued, runs meanwhile; the host gets 15
x 8 numbers a case. Any other engine scores on the host: HD95 (four
full-volume scipy distance transforms per case and mask) runs in a thread
pool beside the device work, and after each case the results are read
back until at most two cases of jobs (and their label volumes) wait (JAX
evaluator.py:131-138, 196-209). Both write the same CSV. The CSV keeps the
reference's layout byte for byte: masks in reversed canonical order, a
mask-name row before each mask's case rows, and the merged 'ET HD95ETPro
HD95' header cell of the reference's string-concatenation quirk
(train.py:587). With a sharded sweep every rank runs the sweep and only
the engine's main rank scores and writes. A `SweepSpans` handed to
`run_test_sweep` records where the host's time goes (and, if asked, keeps
the label volumes it scored) for a caller that measures the evaluation.
"""

from __future__ import annotations

import contextlib
import csv
import logging
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from passion_tpu_torch.masks import MASK_ARRAY, MASK_NAMES
from passion_tpu_torch.metrics import AverageMeter, cal_hd95, dice_class4, \
    score_masks

CLASS_EVALUATION = ("whole", "core", "enhancing", "enhancing_postpro")


class SweepSpans:
    """Host spans of one `run_test_sweep`: `first_dispatch`, the
    `time.perf_counter()` at which the first case's device work was queued;
    `sweep_s`, the host's seconds queueing the sweeps and waiting for their
    labels; `score_s`, the seconds of every Dice and HD95 call summed over
    the scoring threads. With `keep_labels`, `labels` gets each case's label
    volumes in the CSV's mask order (reversed canonical order)."""

    def __init__(self, keep_labels: bool = False):
        self.first_dispatch = None
        self.sweep_s = 0.0
        self.score_s = 0.0
        self.labels = [] if keep_labels else None
        self._lock = threading.Lock()

    def scored(self, fn):
        """`fn` with its seconds added to `score_s` (from any thread)."""
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            with self._lock:
                self.score_s += time.perf_counter() - t
            return out
        return run


def _scores_on_device(engine) -> bool:
    """Whether `run_test_sweep` scores on the engine's card: a sweep engine
    that hands out its device labels, on a CUDA device."""
    return hasattr(engine, "device_labels") and engine.device.type == "cuda"


def _done(value) -> Future:
    fut = Future()
    fut.set_result(value)
    return fut


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
                   mask_names=None, spans: SweepSpans | None = None):
    """Score every mask over the test set with a `SlidingWindowSweep`, or
    with an engine that has only `infer_labels` (one pass per mask).

    test_loader: iterable of batches {'x': (B, H, W, Z, 4), 'target':
    (B, H, W, Z) int labels, 'name': [B names]}. Returns (avg_dice (4,),
    avg_hd95 (4,), per_mask {name: {'dice', 'hd95'}}), or (None, None,
    None) on a rank of a sharded sweep other than the main one, which only
    takes its part of the sweep. `spans` (main rank) records the host's
    time (`SweepSpans`).
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
    on_device = sweep and _scores_on_device(engine)
    dice, hd95, masks_scores = ((dice_class4, cal_hd95, score_masks)
                                if spans is None else
                                (spans.scored(dice_class4),
                                 spans.scored(cal_hd95),
                                 spans.scored(score_masks)))
    # the card's scoring runs beside the next case's queued sweep
    side = (torch.cuda.Stream(engine.device)
            if on_device and engine.device.type == "cuda" else None)
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
        t = time.perf_counter()
        labels = [engine.dispatch_labels(p, sweep_masks) if sweep else
                  [engine.infer_labels(p, m) for m in sweep_masks]
                  for p in prepared]
        if spans is not None:
            if spans.first_dispatch is None:
                spans.first_dispatch = t
            spans.sweep_s += time.perf_counter() - t
        return dict(target=np.asarray(batch["target"]), names=batch["name"],
                    labels=labels)

    def score(i, staged, pool):
        target = staged["target"]
        for k, name in enumerate(staged["names"]):
            labels = staged["labels"][k]
            if sweep:
                t = time.perf_counter()
                labels = engine.fetch_labels(labels)
                if spans is not None:
                    spans.sweep_s += time.perf_counter() - t
            if spans is not None and spans.labels is not None:
                spans.labels.append(labels)
            if on_device:
                if target[k].min() < 0 or target[k].max() >= 4:
                    raise ValueError("scoring on the card takes target "
                                     "labels 0..3")
                # fetch_labels has waited for the card to write them
                with (torch.cuda.stream(side) if side is not None
                      else contextlib.nullcontext()):
                    vols = engine.device_labels(staged["labels"][k])
                    tgt = torch.from_numpy(np.ascontiguousarray(
                        target[k], np.uint8)).to(vols[0].device)
                    evs, hds = masks_scores(torch.stack(vols), tgt)
                scored = [(ev, _done(hd)) for ev, hd in zip(evs, hds)]
            else:
                scored = []
                for lab in labels:
                    _, ev = dice(lab[None], target[k][None])
                    scored.append((ev[0], pool.submit(hd95, lab,
                                                      target[k])))
            for (_, mname), (ev, fut) in zip(order, scored):
                pending.append((mname, ev, fut))
                logging.info(
                    "Subject %d/%s [%s]%20s, DSC: %s", i + 1, n_batches,
                    mname, name, ", ".join(
                        f"{c}: {v:.4f}" for c, v in zip(CLASS_EVALUATION, ev)))
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
