"""Logging set-up and seeding (copy of `passion_tpu/logging_utils.py`'s
`setup` / `set_seed`; reference code/utils/parser.py:63-105)."""

from __future__ import annotations

import logging
import os
import random
import sys

import numpy as np
import torch


def setup(cfg, mode: str = "training") -> None:
    """File + console logging to `{savepath}/{mask_type}_{mode}.txt`
    (parser.py:90-105), replacing the handlers of an earlier set-up."""
    os.makedirs(cfg.savepath, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(message)s", "%m-%d %H:%M:%S")
    path = os.path.join(cfg.savepath, f"{cfg.mask_type}_{mode}.txt")
    for h in (logging.FileHandler(path), logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        root.addHandler(h)


def set_seed(seed: int) -> None:
    """Seed the host RNGs (parser.py:63-68). The port's own randomness
    (weights, dropout, data) comes from explicit generators seeded from
    the config; this covers anything else that reads the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
