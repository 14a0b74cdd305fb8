"""Backbones of the port: RFNet, mmFormer and M2FTrans, each for inference
(the 15-mask sweep) and the PASSION training forward.

`get_model(name, ...)` resolves the reference's `--model` flag;
`init_model(model, seed)` draws seeded weights with the JAX package's
initializer scheme.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from passion_tpu_torch.models.layers import Conv3d, ModalFusion


def get_model(name: str, num_cls: int = 4, mask_type: str = "idt",
              patch_size: int = 80, **kwargs) -> nn.Module:
    """Resolve the reference's `--model` flag. `patch_size` sizes the
    transformer backbones' learned tokens ((patch/16)^3 per modality);
    RFNet has none and takes no `patch_size`."""
    if name == "rfnet":
        from passion_tpu_torch.models.rfnet import RFNet
        return RFNet(num_cls=num_cls, mask_type=mask_type, **kwargs)
    if name == "mmformer":
        from passion_tpu_torch.models.mmformer import MMFormer
        return MMFormer(num_cls=num_cls, mask_type=mask_type,
                        patch_size=patch_size, **kwargs)
    if name == "m2ftrans":
        from passion_tpu_torch.models.m2ftrans import M2FTrans
        return M2FTrans(num_cls=num_cls, mask_type=mask_type,
                        patch_size=patch_size, **kwargs)
    raise ValueError(f"unknown model: {name!r} (rfnet | mmformer | m2ftrans)")


def _trunc_normal(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    # flax lecun_normal: variance_scaling(1, fan_in, "truncated_normal"),
    # a normal cut at +-2 std and rescaled to keep the variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


@torch.no_grad()
def init_model(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded weights in the JAX package's scheme, from an explicit
    `torch.Generator` (the numbers differ from jax.random's):

      * the model's own `Conv3d`: He normal, variance 2 / fan_in
        (`conv_kernel_init`, layers.py:65-66), zero bias;
      * plain `nn.Conv3d` and `nn.Linear` (flax `nn.Conv` / `nn.Dense`
        defaults): truncated LeCun normal, zero bias; but RFNet's
        `ModalFusion` Linears, which the JAX package gives
        `conv_kernel_init` (layers.py:767-769): He normal, not truncated;
      * LayerNorm: weight 1, bias 0; positional embeddings: 0; M2FTrans's
        fusion tokens: N(0, 1) (m2ftrans.py:319-323).
    """
    g = torch.Generator(device="cpu").manual_seed(seed)
    he_normal = {id(m) for f in model.modules()
                 if isinstance(f, ModalFusion) for m in (f.fc1, f.fc2)}
    for mod in model.modules():
        if isinstance(mod, Conv3d) or id(mod) in he_normal:
            fan_in = mod.weight[0].numel()
            w = torch.randn(mod.weight.shape, generator=g)
            mod.weight.copy_(w * math.sqrt(2.0 / fan_in))
        elif isinstance(mod, (nn.Conv3d, nn.Linear)):
            w = torch.empty(mod.weight.shape)
            _trunc_normal(w, mod.weight[0].numel(), g)
            mod.weight.copy_(w)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
        else:
            continue
        if mod.bias is not None:
            mod.bias.zero_()
    if isinstance(getattr(model, "pos", None), nn.Parameter):
        model.pos.zero_()
    if isinstance(getattr(model, "fusion", None), nn.Parameter):
        model.fusion.copy_(torch.randn(model.fusion.shape, generator=g))
    return model
