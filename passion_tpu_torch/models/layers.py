"""mmFormer's building blocks (counterpart of the parts of
`passion_tpu/models/layers.py` that mmFormer runs, for inference and for
the PASSION training step).

Tensors are (B, C, H, W, Z). Per-modality features lie flat on the channel
axis, modality-major ((B, 4*C, ...)), as in the JAX package, so that the
four modality encoders are one grouped conv. The transformer's dropout
(rate 0.1, at the places layers.py:423-515 puts it) is active only when a
`torch.Generator` is passed, which only the training forward does; the
JAX package's `deterministic=True` is the port's `generator=None`.

The block-diagonal grouped kernels (layers.py:133-145) and space-to-depth
execution (ops/s2d.py) are TPU layout rewrites of the same arithmetic and
are not ported: a grouped conv here is `F.conv3d(groups=4)`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from passion_tpu_torch.ops import fused_norm

NUM_MODALS = 4
DROPOUT_RATE = 0.1  # the JAX Transformer's default


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate), with the keep mask drawn from `generator`
    (on x's device). The identity when `generator` is None."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def mask_modalities(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero absent modalities of a stacked (B, M, ...) tensor; mask (B, M)."""
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    return x * mask.to(x.dtype).reshape(shape)


def mask_channels(x: torch.Tensor, mask: torch.Tensor,
                  num_modals: int = NUM_MODALS) -> torch.Tensor:
    """Zero absent modalities on a flat modality-major channel axis:
    x (B, M*C, ...), mask (B, M)."""
    b, c = x.shape[0], x.shape[1] // num_modals
    m = mask.to(x.dtype).repeat_interleave(c, dim=1)
    return x * m.reshape((b, num_modals * c) + (1,) * (x.dim() - 2))


def mask_channels_lanes(x: torch.Tensor, masks: torch.Tensor,
                        num_modals: int = NUM_MODALS) -> torch.Tensor:
    """`mask_channels` of one batch under L masks at once: x (B, M*C, ...),
    masks (L, B, M) -> (L*B, M*C, ...), lane-major (row l*B + b is sample b
    under masks[l, b]). With L = 1 it is `mask_channels`."""
    lanes, b, _ = masks.shape
    c = x.shape[1] // num_modals
    w = masks.to(x.dtype).repeat_interleave(c, dim=2)
    w = w.reshape((lanes, b, num_modals * c) + (1,) * (x.dim() - 2))
    return (x.unsqueeze(0) * w).reshape((lanes * b,) + tuple(x.shape[1:]))


def split_modalities(x: torch.Tensor,
                     num_modals: int = NUM_MODALS) -> torch.Tensor:
    """Flat (B, M*C, ...) -> (M*B, C, ...), modality-major: the M
    per-modality tensors of layers.py:127 stacked on the batch axis, so that
    a module with tied params runs them as one batch."""
    b, mc = x.shape[:2]
    c = mc // num_modals
    return x.reshape((b, num_modals, c) + tuple(x.shape[2:])).transpose(
        0, 1).reshape((num_modals * b, c) + tuple(x.shape[2:]))


def unimodal_mask_stack(mask: torch.Tensor) -> torch.Tensor:
    """(B, 4) -> (5, B, 4): [real mask, mod0-only, ..., mod3-only]
    (copy of `_unimodal_mask_stack`, passion_tpu/models/rfnet.py:257-263)."""
    b = mask.shape[0]
    eye = torch.eye(NUM_MODALS, dtype=mask.dtype, device=mask.device)
    return torch.cat([mask[None], eye[:, None, :].expand(NUM_MODALS, b,
                                                         NUM_MODALS)], dim=0)


def zero_unimodal_self_dist(dist: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Zero dist[b, k] where sample b's mask IS the unimodal mask k
    (layers.py:886-903). For such a sample the mod-k distillation lane and
    the teacher lane compute the same thing, so the reference's distance is
    exactly 0, which the train step turns into 0/0 = NaN and an all-False
    preference gate for the iteration. Enforced here by construction rather
    than left to rounding."""
    mask_f = mask.to(torch.float32)
    unimodal = (mask_f.sum(dim=1, keepdim=True) == 1.0).to(torch.float32)
    return dist * (1.0 - mask_f * unimodal)


def mask_kernel_rows(weight: torch.Tensor, in_mask: torch.Tensor,
                     num_modals: int = NUM_MODALS) -> torch.Tensor:
    """Fold a modality mask (M,) into a conv weight's input-channel rows,
    weight (O, M*C, k, k, k). For inputs whose absent-modality channels are
    zero, `conv(mask_channels(x), w) == conv(x, mask_kernel_rows(w, m))`
    exactly; the sweep masks the small kernel instead of the large
    activation (layers.py:111-124)."""
    c = weight.shape[1] // num_modals
    rows = in_mask.to(weight.dtype).repeat_interleave(c)
    return weight * rows.reshape(1, -1, 1, 1, 1)


class Conv3d(nn.Module):
    """3-D conv with torch-style explicit reflect or zero padding
    (layers.py:148-227). `groups=4` on modality-major channels is four
    independent per-modality convs."""

    def __init__(self, in_channels: int, out_channels: int, k_size: int = 3,
                 stride: int = 1, padding: int = 1, pad_type: str = "reflect",
                 groups: int = 1, bias: bool = True):
        super().__init__()
        if pad_type not in ("reflect", "zeros"):
            raise ValueError(f"pad_type must be 'reflect' or 'zeros', got "
                             f"{pad_type!r}")
        self.stride, self.padding, self.pad_type = stride, padding, pad_type
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, k_size, k_size, k_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor, in_mask: torch.Tensor | None = None):
        """`in_mask` ((M,) bool, groups == 1 only): fold a modality mask into
        the kernel's input rows instead of masking x (`mask_kernel_rows`)."""
        w = self.weight
        if in_mask is not None:
            if self.groups != 1:
                raise ValueError("in_mask is for ungrouped convs only")
            w = mask_kernel_rows(w, in_mask)
        pad = self.padding
        if pad and self.pad_type == "reflect":
            x = reflect_pad3d(x, pad)
            pad = 0
        return F.conv3d(x, w, self.bias, self.stride, pad, 1, self.groups)


def reflect_pad3d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy/jnp "reflect" padding of the three spatial axes. torch's
    reflect mode needs pad < size; an axis too short for it (the 1-voxel
    bottleneck of a 16-voxel patch) takes numpy's indices instead."""
    if min(x.shape[2:]) > pad:
        return F.pad(x, (pad,) * 6, mode="reflect")
    for dim in (2, 3, 4):
        idx = np.pad(np.arange(x.shape[dim]), pad, mode="reflect")
        x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


class GeneralConv3dPreNorm(nn.Module):
    """InstanceNorm -> LeakyReLU(0.2) -> conv (layers.py:392-415)."""

    def __init__(self, in_channels: int, out_channels: int, k_size: int = 3,
                 stride: int = 1, padding: int = 1, pad_type: str = "reflect",
                 groups: int = 1):
        super().__init__()
        self.conv = Conv3d(in_channels, out_channels, k_size, stride, padding,
                           pad_type, groups)

    def forward(self, x: torch.Tensor, in_mask: torch.Tensor | None = None,
                skip_norm: bool = False):
        """`skip_norm`: x already carries IN+LReLU (hoisted into the sweep's
        mask-independent encode)."""
        if not skip_norm:
            x = fused_norm.instance_norm_lrelu(x)
        return self.conv(x, in_mask)


class SelfAttention(nn.Module):
    """Multi-head self-attention, qkv without bias (layers.py:423-441)."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)  # each (B, H, N, hd)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * (hd ** -0.5), dim=-1)
        attn = dropout(attn, DROPOUT_RATE, generator)
        y = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return dropout(self.proj(y), DROPOUT_RATE, generator)


class FeedForward(nn.Module):
    """Linear -> GELU (erf) -> Dropout -> Linear -> Dropout
    (layers.py:474-487)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = dropout(F.gelu(self.fc1(x)), DROPOUT_RATE, generator)
        return dropout(self.fc2(h), DROPOUT_RATE, generator)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = SelfAttention(dim, heads)
        self.ffn_norm = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FeedForward(dim, mlp_dim)


class Transformer(nn.Module):
    """Pre-norm transformer that re-adds the positional embedding before
    every layer (layers.py:490-515)."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8,
                 mlp_dim: int = 4096):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(dim, heads, mlp_dim) for _ in range(depth))

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """`generator`: dropout on, masks drawn from it (training only)."""
        for blk in self.layers:
            x = x + pos
            h = blk.attn(blk.attn_norm(x), generator)
            x = x + dropout(h, DROPOUT_RATE, generator)  # layers.py:509
            x = x + blk.ffn(blk.ffn_norm(x), generator)
        return x


class FusionPreNorm(nn.Module):
    """3x GeneralConv3dPreNorm (k = 1, 3, 1) on the flat modality stack
    (layers.py:843-868). The middle conv is ZERO-padded, unlike every other
    k=3 conv of the model (the reference's fusion_prenorm default)."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.layers = nn.ModuleList([
            GeneralConv3dPreNorm(in_channels, channels, 1, padding=0),
            GeneralConv3dPreNorm(channels, channels, 3, padding=1,
                                 pad_type="zeros"),
            GeneralConv3dPreNorm(channels, channels, 1, padding=0),
        ])

    def forward(self, x: torch.Tensor, in_mask: torch.Tensor | None = None,
                prenormed: bool = False) -> torch.Tensor:
        """Premasked sweep mode (`in_mask` + `prenormed`): x arrives unmasked
        with the first conv's IN+LReLU already applied, and the mask is
        folded into that conv's kernel rows."""
        x = self.layers[0](x, in_mask=in_mask, skip_norm=prenormed)
        return self.layers[2](self.layers[1](x))
