"""Evaluation CLI of the port (counterpart of the repo's `eval.py`).

Loads weights and runs the 15-modality-combination sliding-window sweep
with Dice WT/TC/ET(+postpro) and HD95, writing per-case CSV rows to
`{savepath}/{model}.csv`:

  python -m passion_tpu_torch.eval --resume model.pt --dataroot DATA \
      --datapath . --savepath outputs/eval

`--resume` takes a port checkpoint (`torch.save(model.state_dict())`, or
a training checkpoint of `python -m passion_tpu_torch.train`), a
checkpoint of the reference's PyTorch code (`model_last.pth`) or an .npz
of the JAX package's flattened params (README, "PyTorch/CUDA port"), and
loads it strictly. Cases are read by a `PrefetchLoader` thread while the
card sweeps the one before. `--data_parallel N` splits each case's windows
over N ranks, one process per card (parallel/world.py; rank 0 writes the
CSV).
"""

from __future__ import annotations

import logging
import os

from passion_tpu_torch import resolve_device
from passion_tpu_torch.config import parse_config
from passion_tpu_torch.data.datasets import TEST_TRANSFORMS, BratsTest
from passion_tpu_torch.data.loader import PrefetchLoader
from passion_tpu_torch.engine.checkpoint import load_weights
from passion_tpu_torch.engine.evaluator import run_test_sweep
from passion_tpu_torch.engine.sliding_window import make_engine
from passion_tpu_torch.logging_utils import set_seed, setup
from passion_tpu_torch.models import get_model
from passion_tpu_torch.parallel.world import launch, world_size_for


def main(argv=None):
    cfg = parse_config(argv)
    if not cfg.resume:  # fail before the model is built
        raise SystemExit("--resume checkpoint path is required")
    ranks = world_size_for(cfg.data_parallel, cfg.device)
    if ranks:
        launch(eval_rank, ranks, cfg.device, args=(cfg,))
        return None
    return eval_rank(None, cfg)


def eval_rank(world, cfg):
    """One rank's evaluation (`world` None: the single-device run)."""
    setup(cfg, "eval", rank=world.rank if world is not None else 0)
    set_seed(cfg.seed)
    logging.info(str(cfg))
    device = world.device if world is not None else resolve_device(
        cfg.device)

    model = get_model(cfg.model, num_cls=cfg.num_cls, mask_type=cfg.mask_type,
                      patch_size=cfg.patch_size, **cfg.model_kwargs)
    model.load_state_dict(load_weights(cfg.resume, model), strict=True)
    logging.info("loaded %s", cfg.resume)

    test_set = BratsTest(TEST_TRANSFORMS, root=cfg.dataset_path,
                         test_file="test.txt")
    loader = PrefetchLoader(test_set, batch_size=1, shuffle=False,
                            num_threads=1)
    engine = make_engine(model, cfg.num_cls, cfg.patch_size,
                         window_batch=cfg.window_batch, device=device,
                         world=world)
    csv_name = os.path.join(cfg.savepath, f"{cfg.model}.csv")
    avg_dice, avg_hd95, _ = run_test_sweep(loader, engine, csv_name=csv_name)
    return avg_dice, avg_hd95


if __name__ == "__main__":
    main()
