"""Configuration: the reference's argparse surface (options.py names, as
`passion_tpu/config.py` has them) backed by dataclasses, plus `--device`.
`EvalConfig` / `parse_config` for `python -m passion_tpu_torch.eval`,
`TrainConfig` / `parse_train_config` for `python -m passion_tpu_torch.train`.
The reference's config helpers (`str2bool`, `AttrDict`, `parse_value`,
`load_yaml_config`) are copies of the JAX package's.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

DATA_PARALLEL_HELP = ("data-parallel ranks, one process per card: 0 = one "
                      "device, -1 = every visible card, N = the first N "
                      "(with --device cpu: N gloo ranks)")


def str2bool(v: str) -> bool:
    """Boolean flag parser (utils/str2bool.py:1-8): the same accepted
    tokens, ValueError on anything else."""
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError("Unsupported value encountered.")


class AttrDict(dict):
    """Attribute-style nested config dict (utils/parser.py:18-61): reading a
    missing attribute creates a nested AttrDict; `merge` deep-merges
    another mapping."""

    def __getattr__(self, name):
        if name in self.__dict__:
            return self.__dict__[name]
        if name in self:
            return self[name]
        if name.startswith("__"):
            raise AttributeError(name)
        self[name] = AttrDict()
        return self[name]

    def __setattr__(self, name, value):
        if name in self.__dict__:
            self.__dict__[name] = value
        else:
            self[name] = value

    def merge(self, other) -> None:
        for k, v in other.items():
            if k in self and isinstance(v, dict) and isinstance(self[k],
                                                               dict):
                AttrDict.merge(self[k], v)
            else:
                self[k] = AttrDict.cast(v) if isinstance(v, dict) else v

    @staticmethod
    def cast(d):
        if not isinstance(d, dict):
            return d
        return AttrDict({k: AttrDict.cast(v) for k, v in d.items()})


def parse_value(d):
    """Recursive literal coercion (utils/parser.py:70-82): strings that
    parse as Python literals or fractions become values, dicts become
    AttrDicts. `ast.literal_eval`, never eval."""
    from ast import literal_eval
    from fractions import Fraction

    if isinstance(d, dict):
        return AttrDict({k: parse_value(v) for k, v in d.items()})
    if isinstance(d, str):
        try:
            return literal_eval(d)
        except (ValueError, SyntaxError):
            try:
                return float(Fraction(d))
            except (ValueError, ZeroDivisionError):
                return d
    return d


def load_yaml_config(fname: str) -> AttrDict:
    """YAML file -> AttrDict with literal coercion (utils/parser.py:84-87),
    through `yaml.safe_load`. PyYAML is imported here only: the package
    does not need it otherwise."""
    import yaml

    with open(fname) as f:
        return parse_value(yaml.safe_load(f))

# the width overrides each backbone takes (M2FTrans's token width is
# 16 * basic_dims, so it has no trans_dim; RFNet has no transformer)
WIDTH_FLAGS = {"rfnet": ("basic_dims",),
               "mmformer": ("basic_dims", "trans_dim", "mlp_dim", "heads",
                            "depth"),
               "m2ftrans": ("basic_dims", "mlp_dim", "heads", "depth")}


def _model_kwargs(cfg) -> dict:
    """kwargs for models.get_model beyond the reference surface: the width
    overrides that were given and that `cfg.model` takes."""
    return {k: getattr(cfg, k) for k in WIDTH_FLAGS.get(cfg.model, ())
            if getattr(cfg, k)}


def _add_width_args(p: argparse.ArgumentParser) -> None:
    for name, ref in (("basic_dims", "8"),
                      ("trans_dim", "512 (mmFormer)"),
                      ("mlp_dim", "4096"), ("heads", "8"),
                      ("depth", "1 (mmFormer), 3 (M2FTrans)")):
        p.add_argument(f"--{name}", default=None, type=int,
                       help=f"override the backbone's {name} (the reference "
                            f"has {ref}; small values for smoke runs; a "
                            f"backbone without it ignores it)")


@dataclass
class EvalConfig:
    model: str = "mmformer"
    num_cls: int = 4
    mask_type: str = "idt"  # pdt | idt | idt_drop
    patch_size: int = 80
    basic_dims: int | None = None  # backbone width overrides (small runs)
    trans_dim: int | None = None
    mlp_dim: int | None = None
    heads: int | None = None
    depth: int | None = None
    dataname: str = "BraTS/BRATS2020"
    datapath: str = "BraTS/BRATS2020_Training_none_npy"
    dataroot: str | None = None
    savepath: str = "outputs/run"
    resume: str | None = None
    window_batch: int = 0  # 0 = auto (per-case chunk sizing)
    data_parallel: int = 0  # ranks: 0 one device, -1 every card, N first N
    seed: int = 1037
    device: str = "cuda"

    @property
    def model_kwargs(self) -> dict:
        return _model_kwargs(self)

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
    _add_width_args(p)
    p.add_argument("--dataname", default=d.dataname, type=str)
    p.add_argument("--datapath", default=d.datapath, type=str)
    p.add_argument("--dataroot", default=None, type=str,
                   help="dataset root (default: ../datasets next to package)")
    p.add_argument("--savepath", default=d.savepath, type=str)
    p.add_argument("--resume", default=None, type=str,
                   help="port checkpoint (torch.save of the state_dict), "
                        "reference checkpoint (model_last.pth) or .npz of "
                        "the JAX package's flattened params")
    p.add_argument("--window_batch", default=d.window_batch, type=int)
    p.add_argument("--data_parallel", default=d.data_parallel, type=int,
                   help=DATA_PARALLEL_HELP)
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--device", default=d.device, choices=("cuda", "cpu"))
    return EvalConfig(**vars(p.parse_args(argv)))


def train_transforms_for(patch_size: int = 80) -> str:
    """The reference training pipeline (options.py:50) at a given crop."""
    s = patch_size
    return (f"Compose([RandCrop3D(({s},{s},{s})), RandomRotion(10), "
            "RandomIntensityChange((0.1,0.1)), RandomFlip(0), "
            "NumpyType((np.float32, np.int64)),])")


@dataclass
class TrainConfig:
    model: str = "mmformer"
    batch_size: int = 1
    lr: float = 2e-4
    weight_decay: float = 1e-4
    num_epochs: int = 300
    temp: float = 4.0
    region_fusion_start_epoch: int = 0
    seed: int = 1037
    gpu: str = ""  # accepted for CLI parity; the device is --device
    mask_type: str = "idt"  # pdt | idt | idt_drop
    use_pretrain: bool = False
    use_passion: bool = False
    use_valid: bool = False
    dataname: str = "BraTS/BRATS2020"
    datapath: str = "BraTS/BRATS2020_Training_none_npy"
    imbmrpath: str = "BraTS/brats_split/Brats2020_imb_split_mr2468.csv"
    savepath: str = "outputs/run"
    resume: str | None = None
    dataroot: str | None = None
    patch_size: int = 80
    basic_dims: int | None = None  # backbone width overrides (small runs)
    trans_dim: int | None = None
    mlp_dim: int | None = None
    heads: int | None = None
    depth: int | None = None
    data_parallel: int = 0  # ranks: 0 one device, -1 every card, N first N
    num_cls: int = 4
    window_batch: int = 0  # 0 = auto
    num_workers: int = 8
    iters_per_epoch: int | None = None  # cap for smoke runs
    device: str = "cuda"

    @property
    def train_transforms(self) -> str:
        return train_transforms_for(self.patch_size)

    @property
    def model_kwargs(self) -> dict:
        return _model_kwargs(self)

    @property
    def dataroot_path(self) -> str:
        if self.dataroot:
            return os.path.abspath(self.dataroot)
        return os.path.abspath(os.path.join(os.path.dirname(__file__),
                                            "..", "datasets"))

    @property
    def dataset_path(self) -> str:
        return os.path.abspath(os.path.join(self.dataroot_path,
                                            self.datapath))

    @property
    def imbmr_path(self) -> str:
        if os.path.isabs(self.imbmrpath):
            return self.imbmrpath
        return os.path.join(self.dataroot_path, self.imbmrpath)


def parse_train_config(argv=None) -> TrainConfig:
    """train.py's flags (passion_tpu/config.py `add_common_args`) plus
    `--device` and the width overrides."""
    d = TrainConfig()
    p = argparse.ArgumentParser(description="PASSION training of a "
                                "passion_tpu_torch model")
    p.add_argument("--model", default=d.model, type=str)
    p.add_argument("-batch_size", "--batch_size", default=d.batch_size,
                   type=int)
    p.add_argument("--lr", default=d.lr, type=float)
    p.add_argument("--weight_decay", default=d.weight_decay, type=float)
    p.add_argument("--num_epochs", default=d.num_epochs, type=int)
    p.add_argument("--temp", default=d.temp, type=float)
    p.add_argument("--region_fusion_start_epoch",
                   default=d.region_fusion_start_epoch, type=int)
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--gpu", default=d.gpu, type=str)
    p.add_argument("--mask_type", default=d.mask_type, type=str)
    p.add_argument("--use_pretrain", action="store_true")
    p.add_argument("--use_passion", action="store_true")
    p.add_argument("--use_valid", action="store_true")
    p.add_argument("--dataname", default=d.dataname, type=str)
    p.add_argument("--datapath", default=d.datapath, type=str)
    p.add_argument("--imbmrpath", default=d.imbmrpath, type=str)
    p.add_argument("--savepath", default=d.savepath, type=str)
    p.add_argument("--resume", default=None, type=str)
    p.add_argument("--dataroot", default=None, type=str,
                   help="dataset root (default: ../datasets next to package)")
    p.add_argument("--patch_size", default=d.patch_size, type=int)
    _add_width_args(p)
    p.add_argument("--data_parallel", default=d.data_parallel, type=int,
                   help=DATA_PARALLEL_HELP)
    p.add_argument("--window_batch", default=d.window_batch, type=int)
    p.add_argument("--num_workers", default=d.num_workers, type=int)
    p.add_argument("--iters_per_epoch", default=None, type=int)
    p.add_argument("--device", default=d.device, choices=("cuda", "cpu"))
    return TrainConfig(**vars(p.parse_args(argv)))
