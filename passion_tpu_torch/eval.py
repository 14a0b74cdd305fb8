"""Evaluation CLI of the port (counterpart of the repo's `eval.py`).

Loads weights and runs the 15-modality-combination sliding-window sweep
with Dice WT/TC/ET(+postpro) and HD95, writing per-case CSV rows to
`{savepath}/{model}.csv`:

  python -m passion_tpu_torch.eval --resume model.pt --dataroot DATA \
      --datapath . --savepath outputs/eval

`--resume` takes a port checkpoint (`torch.save(model.state_dict())`, or
a training checkpoint of `python -m passion_tpu_torch.train`) or an .npz
of the JAX package's flattened params (README, "PyTorch/CUDA port").
"""

from __future__ import annotations

import logging
import os

from passion_tpu_torch import resolve_device
from passion_tpu_torch.config import parse_config
from passion_tpu_torch.data.datasets import (TEST_TRANSFORMS, BratsTest,
                                             CaseLoader)
from passion_tpu_torch.engine.checkpoint import load_weights
from passion_tpu_torch.engine.evaluator import run_test_sweep
from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
from passion_tpu_torch.logging_utils import set_seed, setup
from passion_tpu_torch.models import get_model


def main(argv=None):
    cfg = parse_config(argv)
    setup(cfg, "eval")
    set_seed(cfg.seed)
    logging.info(str(cfg))
    if not cfg.resume:  # fail before the model is built
        raise SystemExit("--resume checkpoint path is required")
    device = resolve_device(cfg.device)

    model = get_model(cfg.model, num_cls=cfg.num_cls, mask_type=cfg.mask_type,
                      patch_size=cfg.patch_size, **cfg.model_kwargs)
    model.load_state_dict(load_weights(cfg.resume, cfg.model), strict=True)
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
