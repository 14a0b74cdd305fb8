"""Checkpoints: save and restore {epoch, model, optimizer} (counterpart of
`passion_tpu/engine/checkpoint.py`).

`torch.save` of the model's and the optimizer's state_dicts, read back with
`torch.load(weights_only=True)`. The retention follows the reference
(train.py:357-373): `model_last.pt` every epoch, plus `model_{N}.pt` every
100 epochs and for the last 5. `load_pretrained_params` is the
`--use_pretrain` filtered merge (train.py:144-152): only keys present in
both, with the same shape, are taken from the checkpoint, which may be a
port checkpoint, an .npz of the JAX package's params or a checkpoint of the
reference's PyTorch code (`{epoch, state_dict, optim_dict}`, the file its
own `--use_pretrain` reads).
"""

from __future__ import annotations

import os

import torch
from torch import nn

from passion_tpu_torch.interop import torch_weights as tw
from passion_tpu_torch.interop.jax_weights import load_jax_npz


def save_checkpoint(path: str, state: dict) -> None:
    """Write `state` ({epoch, model, optimizer} state_dicts) atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """The saved {epoch, model, optimizer} dict, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_weights(path: str, model: nn.Module) -> dict:
    """A state_dict for `model` (one of the port's backbones) from a port
    checkpoint (a full {epoch, model, optimizer} one, or a bare
    state_dict), a reference checkpoint (a `state_dict` key: converted by
    `interop.torch_weights`) or a JAX .npz (read as the tree of `model`'s
    backbone, its class name in lower case)."""
    if path.endswith(".npz"):
        return load_jax_npz(path, type(model).__name__.lower())
    state = load_checkpoint(path)
    if "model" in state:
        return state["model"]
    if "state_dict" in state:
        return tw.params_from_torch(state, model)
    return state


def load_pretrained_params(path: str, model: nn.Module) -> list[str]:
    """Copy into `model` every tensor of the checkpoint whose key and shape
    it has; the rest keep their values. Returns the keys taken, and raises
    `ValueError` when the checkpoint matches none of them."""
    target = model.state_dict()
    taken = {k: v for k, v in load_weights(path, model).items()
             if k in target and tuple(target[k].shape) == tuple(v.shape)}
    if not taken:
        raise ValueError(f"{path} holds no tensor of {type(model).__name__}'s "
                         f"{len(target)} (no key and shape in common)")
    model.load_state_dict(taken, strict=False)
    return sorted(taken)


def checkpoint_paths(savepath: str, epoch: int, num_epochs: int) -> list[str]:
    """Which files to write after `epoch` (train.py:357-373)."""
    paths = [os.path.join(savepath, "model_last.pt")]
    if (epoch + 1) % 100 == 0 or epoch >= num_epochs - 5:
        paths.append(os.path.join(savepath, f"model_{epoch + 1}.pt"))
    return paths
