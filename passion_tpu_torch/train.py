"""Training CLI of the port (counterpart of the repo's `train.py`): the
reference's `python train.py` flags, plus `--device` and width overrides.

  python -m passion_tpu_torch.train --model mmformer --use_passion \
      --mask_type idt --dataroot DATA --datapath . \
      --imbmrpath imb_split.csv --num_epochs 300 --savepath outputs/run

Trains with the PASSION step (engine/train_loop.py), writes checkpoints
(`model_last.pt`, `model_{N}.pt`) and TensorBoard scalars under
`{savepath}/summary/` every epoch, and ends with the 15-mask test sweep of
the last epoch's model, as train.py:90-102 does. `--resume` continues a
run from its checkpoint; with `--use_pretrain` it takes matching weights
only. `--use_valid` scores `val.txt` (with the train transforms) under
all 15 masks after every epoch and keeps `model_best.pt`.

`--data_parallel N` trains on N ranks, one process per card
(parallel/world.py), spawned by this command, or run by `torchrun
--nproc_per_node N -m passion_tpu_torch.train ...`; `--device cpu` runs N
gloo ranks on the CPU. Only rank 0 writes files.
"""

from __future__ import annotations

import logging
import os

from passion_tpu_torch import resolve_device
from passion_tpu_torch.config import parse_train_config
from passion_tpu_torch.data.datasets import (TEST_TRANSFORMS, BratsTest,
                                             BratsTrainIDT, BratsVal,
                                             CaseLoader)
from passion_tpu_torch.data.loader import PrefetchLoader
from passion_tpu_torch.engine.evaluator import run_test_sweep
from passion_tpu_torch.engine.sliding_window import make_engine
from passion_tpu_torch.engine.tb_writer import TensorBoardWriter
from passion_tpu_torch.engine.train_loop import fit
from passion_tpu_torch.logging_utils import set_seed, setup
from passion_tpu_torch.models import get_model
from passion_tpu_torch.parallel.world import launch, world_size_for


def main(argv=None):
    cfg = parse_train_config(argv)
    if cfg.dataname not in ("BraTS/BRATS2021", "BraTS/BRATS2020",
                            "BraTS/BRATS2018"):
        raise SystemExit("dataset is error")
    if cfg.mask_type not in ("pdt", "idt", "idt_drop"):
        raise SystemExit("training setting is error")
    ranks = world_size_for(cfg.data_parallel, cfg.device)
    if ranks:
        launch(train_rank, ranks, cfg.device, args=(cfg,))
        return None
    return train_rank(None, cfg)


def train_rank(world, cfg):
    """One rank's run (`world` None: the single-device run)."""
    setup(cfg, "training", rank=world.rank if world is not None else 0)
    set_seed(cfg.seed)
    logging.info(str(cfg))
    device = world.device if world is not None else resolve_device(
        cfg.device)
    main_rank = world is None or world.is_main

    model = get_model(cfg.model, num_cls=cfg.num_cls, mask_type=cfg.mask_type,
                      patch_size=cfg.patch_size, **cfg.model_kwargs)
    train_set = BratsTrainIDT(
        transforms=cfg.train_transforms, root=cfg.dataset_path,
        num_cls=cfg.num_cls, mask_type=cfg.mask_type,
        train_file=cfg.imbmr_path)
    loader = PrefetchLoader(train_set, batch_size=cfg.batch_size,
                            shuffle=True, seed=cfg.seed,
                            num_threads=cfg.num_workers)
    val_loader = None
    if cfg.use_valid:  # val.txt with the train transforms (train.py:122)
        val_set = BratsVal(transforms=cfg.train_transforms,
                           root=cfg.dataset_path, num_cls=cfg.num_cls,
                           train_file="val.txt")
        val_loader = PrefetchLoader(val_set, batch_size=cfg.batch_size,
                                    shuffle=True, seed=cfg.seed,
                                    num_threads=cfg.num_workers)
    # the reference's SummaryWriter location and tag set (train.py:39)
    writer = TensorBoardWriter(cfg.savepath) if main_rank else None
    try:
        model, _, _ = fit(model, loader, cfg,
                          modal_num=train_set.modal_counts(), writer=writer,
                          device=device, val_loader=val_loader, world=world)
    finally:
        if writer is not None:
            writer.close()

    # the final 15-combination test sweep (train.py:578-607)
    test_set = BratsTest(TEST_TRANSFORMS, root=cfg.dataset_path,
                         test_file="test.txt")
    engine = make_engine(model, cfg.num_cls, cfg.patch_size,
                         window_batch=cfg.window_batch, device=device,
                         world=world)
    csv_name = os.path.join(cfg.savepath, f"{cfg.model}.csv")
    logging.info("###########test last epoch model###########")
    avg_dice, avg_hd95, _ = run_test_sweep(CaseLoader(test_set), engine,
                                           csv_name=csv_name)
    logging.info("Avg Dice scores: %s", avg_dice)
    logging.info("Avg HD95 scores: %s", avg_hd95)
    return avg_dice, avg_hd95


if __name__ == "__main__":
    main()
