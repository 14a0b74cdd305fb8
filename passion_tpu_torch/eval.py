"""Evaluation CLI of the port (counterpart of the repo's `eval.py`).

Loads weights and runs the 15-modality-combination sliding-window sweep
with Dice WT/TC/ET(+postpro) and HD95, writing per-case CSV rows to
`{savepath}/{model}.csv`:

  python -m passion_tpu_torch.eval --resume model.pt --dataroot DATA \
      --datapath . --savepath outputs/eval

`--resume` takes a port checkpoint (`torch.save(model.state_dict())`) or an
.npz of the JAX package's flattened params (README, "PyTorch/CUDA port").
"""

from __future__ import annotations

import logging
import os
import random
import sys

import numpy as np
import torch

from passion_tpu_torch import resolve_device
from passion_tpu_torch.config import parse_config
from passion_tpu_torch.data.datasets import (TEST_TRANSFORMS, BratsTest,
                                             CaseLoader)
from passion_tpu_torch.engine.evaluator import run_test_sweep
from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
from passion_tpu_torch.interop.jax_weights import load_jax_npz
from passion_tpu_torch.models import get_model


def setup_logging(savepath: str, mask_type: str) -> None:
    """File + console logging to `{savepath}/{mask_type}_eval.txt`
    (reference parser.py:90-105)."""
    os.makedirs(savepath, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(message)s", "%m-%d %H:%M:%S")
    for h in (logging.FileHandler(os.path.join(savepath,
                                               f"{mask_type}_eval.txt")),
              logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        root.addHandler(h)


def load_weights(path: str) -> dict:
    if path.endswith(".npz"):
        return load_jax_npz(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv=None):
    cfg = parse_config(argv)
    setup_logging(cfg.savepath, cfg.mask_type)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    logging.info(str(cfg))
    if not cfg.resume:  # fail before the model is built
        raise SystemExit("--resume checkpoint path is required")
    device = resolve_device(cfg.device)

    model = get_model(cfg.model, num_cls=cfg.num_cls, mask_type=cfg.mask_type,
                      patch_size=cfg.patch_size, **cfg.model_kwargs)
    model.load_state_dict(load_weights(cfg.resume), strict=True)
    logging.info("loaded %s", cfg.resume)

    test_set = BratsTest(TEST_TRANSFORMS, root=cfg.dataset_path,
                         test_file="test.txt")
    engine = SlidingWindowSweep(model, cfg.num_cls, cfg.patch_size,
                                window_batch=cfg.window_batch, device=device)
    csv_name = os.path.join(cfg.savepath, f"{cfg.model}.csv")
    avg_dice, avg_hd95, _ = run_test_sweep(CaseLoader(test_set), engine,
                                           csv_name=csv_name)
    return avg_dice, avg_hd95


if __name__ == "__main__":
    main()
