"""Logging set-up, seeding and per-sample scalar logging (copies of
`passion_tpu/logging_utils.py`'s `setup`, `set_seed` and `record_loss`;
reference code/utils/parser.py:63-105, utils/lr_scheduler.py:63-69)."""

from __future__ import annotations

import logging
import os
import random
import sys

import numpy as np
import torch


def setup(cfg, mode: str = "training", rank: int = 0) -> None:
    """File + console logging to `{savepath}/{mask_type}_{mode}.txt`
    (parser.py:90-105), replacing the handlers of an earlier set-up. A
    data-parallel rank other than 0 logs warnings to the console only."""
    os.makedirs(cfg.savepath, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(message)s", "%m-%d %H:%M:%S")
    handlers = [logging.StreamHandler(sys.stdout)]
    if rank == 0:
        path = os.path.join(cfg.savepath, f"{cfg.mask_type}_{mode}.txt")
        handlers.insert(0, logging.FileHandler(path))
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)


def set_seed(seed: int) -> None:
    """Seed the host RNGs (parser.py:63-68). The port's own randomness
    (weights, dropout, data) comes from explicit generators seeded from
    the config; this covers anything else that reads the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def record_loss(writer, masks, loss_list, loss_names, step, mask_table,
                mask_names, p_types) -> None:
    """Per-sample, per-mask-combination scalars (utils/lr_scheduler.py:63-69,
    unused by the reference's loop): for each sample i whose mask equals
    row j of `mask_table`, `{p_types[i]}_{mask_names[j]}_{name}` for every
    (loss array, name) pair, read as `loss_list[k][i]`. `writer` needs only
    `add_scalar(tag, value, global_step)`."""
    masks = np.asarray(masks).astype(bool)
    table = np.asarray(mask_table).astype(bool)
    for i in range(masks.shape[0]):
        for j in range(table.shape[0]):
            if (masks[i] == table[j]).all():
                for k, name in enumerate(loss_names):
                    writer.add_scalar(f"{p_types[i]}_{mask_names[j]}_{name}",
                                      float(np.asarray(loss_list[k][i])),
                                      step)
