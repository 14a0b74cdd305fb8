"""Evaluation configuration: the eval subset of `passion_tpu/config.py`'s
flags (the reference's options.py names) plus `--device`."""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass


@dataclass
class EvalConfig:
    model: str = "mmformer"
    num_cls: int = 4
    mask_type: str = "idt"  # pdt | idt | idt_drop
    patch_size: int = 80
    basic_dims: int | None = None  # backbone width override (small runs)
    dataname: str = "BraTS/BRATS2020"
    datapath: str = "BraTS/BRATS2020_Training_none_npy"
    dataroot: str | None = None
    savepath: str = "outputs/run"
    resume: str | None = None
    window_batch: int = 0  # 0 = auto (per-case chunk sizing)
    seed: int = 1037
    device: str = "cuda"

    @property
    def model_kwargs(self) -> dict:
        return {"basic_dims": self.basic_dims} if self.basic_dims else {}

    @property
    def dataset_path(self) -> str:
        root = (os.path.abspath(self.dataroot) if self.dataroot else
                os.path.abspath(os.path.join(os.path.dirname(__file__),
                                             "..", "datasets")))
        return os.path.abspath(os.path.join(root, self.datapath))


def parse_config(argv=None) -> EvalConfig:
    d = EvalConfig()
    p = argparse.ArgumentParser(description="15-mask sliding-window "
                                "evaluation of a passion_tpu_torch model")
    p.add_argument("--model", default=d.model, type=str)
    p.add_argument("--num_cls", default=d.num_cls, type=int)
    p.add_argument("--mask_type", default=d.mask_type, type=str)
    p.add_argument("--patch_size", default=d.patch_size, type=int)
    p.add_argument("--basic_dims", default=None, type=int,
                   help="override the backbone conv width (the reference "
                        "hardcodes 8)")
    p.add_argument("--dataname", default=d.dataname, type=str)
    p.add_argument("--datapath", default=d.datapath, type=str)
    p.add_argument("--dataroot", default=None, type=str,
                   help="dataset root (default: ../datasets next to package)")
    p.add_argument("--savepath", default=d.savepath, type=str)
    p.add_argument("--resume", default=None, type=str,
                   help="port checkpoint (torch.save of the state_dict) or "
                        ".npz of the JAX package's flattened params")
    p.add_argument("--window_batch", default=d.window_batch, type=int)
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--device", default=d.device, choices=("cuda", "cpu"))
    return EvalConfig(**vars(p.parse_args(argv)))
