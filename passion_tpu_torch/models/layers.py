"""Building blocks of the three backbones (counterpart of
`passion_tpu/models/layers.py`), for inference and the PASSION training
step.

Tensors are (B, C, H, W, Z). Per-modality features lie flat on the channel
axis, modality-major ((B, 4*C, ...)), as in the JAX package, so that the
four modality encoders are one grouped conv. Dropout (rate 0.1, at the
places layers.py puts it) is active only when a `torch.Generator` is
passed, which only the training forward does; the JAX package's
`deterministic=True` is the port's `generator=None`.

The block-diagonal grouped kernels (layers.py:133-145) and space-to-depth
execution (ops/s2d.py) are TPU layout rewrites of the same arithmetic and
are not ported: a grouped conv here is `F.conv3d(groups=4)`.

Attention in bf16: the float32 mask bias promotes the logits, so the
softmax runs in float32 as in JAX; its probabilities are cast back to the
values' dtype for the product, where JAX's type promotion would carry
float32 on through the rest of the model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from passion_tpu_torch import losses
from passion_tpu_torch.ops import fused_norm
from passion_tpu_torch.ops.attn_mask import cross_key_bias
from passion_tpu_torch.ops.pad import reflect_pad3d
from passion_tpu_torch.ops.resize import upsample_trilinear

NUM_MODALS = 4
MODALITY_NAMES = ("flair", "t1ce", "t1", "t2")
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
    (layers.py:148-227): reflect padding is `ops.pad.reflect_pad3d` (K6 on
    the card without autograd), zero padding cuDNN's own. `groups=4` on
    modality-major channels is four independent per-modality convs."""

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


class MaskedAttention(nn.Module):
    """Self-attention under the M2FTrans fusion-visibility bias
    (layers.py:444-471). Returns (output, probabilities before dropout);
    Weight_Attention reads the probabilities."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                generator: torch.Generator | None = None):
        """x (B, N, C); bias (B, 1, N, N) float32 (`fusion_attention_bias`)."""
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        logits = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        probs = torch.softmax(logits.float() + bias, dim=-1)
        attn = dropout(probs, DROPOUT_RATE, generator)
        y = (attn.to(v.dtype) @ v).transpose(1, 2).reshape(b, n, c)
        return dropout(self.proj(y), DROPOUT_RATE, generator), probs


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 attention: type[nn.Module] = SelfAttention):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = attention(dim, heads)
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


class MaskedTransformer(nn.Module):
    """Pre-norm transformer of the M2FTrans bottleneck (layers.py:518-543),
    without a positional re-add. Returns the tokens and the first layer's
    attention probabilities, before dropout and without a gradient (the
    reference's `attn.detach()`): the only ones Weight_Attention reads."""

    def __init__(self, dim: int, depth: int = 3, heads: int = 8,
                 mlp_dim: int = 4096):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(dim, heads, mlp_dim, MaskedAttention)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                generator: torch.Generator | None = None):
        attn0 = None
        for blk in self.layers:
            h, attn = blk.attn(blk.attn_norm(x), bias, generator)
            if attn0 is None:
                attn0 = attn.detach()
            x = x + dropout(h, DROPOUT_RATE, generator)
            x = x + blk.ffn(blk.ffn_norm(x), generator)
        return x, attn0


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


# --- post-norm units, PRM heads and region fusion (RFNet, M2FTrans) -------

class GeneralConv3d(nn.Module):
    """conv -> InstanceNorm -> LeakyReLU(0.2) (layers.py:375-389)."""

    def __init__(self, in_channels: int, out_channels: int, k_size: int = 3,
                 stride: int = 1, padding: int = 1, pad_type: str = "reflect",
                 groups: int = 1):
        super().__init__()
        self.conv = Conv3d(in_channels, out_channels, k_size, stride, padding,
                           pad_type, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # cuDNN may hand back a channels-last tensor (a 1^3 input's strides
        # fit either layout); the norm takes contiguous NCDHW
        return fused_norm.instance_norm_lrelu(self.conv(x).contiguous())


def conv_stack(*units: tuple[int, int, int]) -> nn.ModuleList:
    """GeneralConv3d units (in, out, k), padded to keep the size (reflect)."""
    return nn.ModuleList(GeneralConv3d(i, o, k, padding=k // 2)
                         for i, o, k in units)


def run_stack(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = layer(x)
    return x


class GroupedEncoder(nn.Module):
    """Post-norm residual encoder of all 4 modalities at once, grouped per
    modality (rfnet.py:55-109 with 4 stages, m2ftrans.py:53-100 with 5; the
    non-space-to-depth branch). (B, 4, H, W, Z) -> flat scales
    (B, 4*c*2^k, ...), each stage after the first at half the size."""

    def __init__(self, basic_dims: int = 8, stages: int = 4):
        super().__init__()
        c, g = basic_dims, NUM_MODALS
        for i in range(1, stages + 1):
            cin = 1 if i == 1 else c * 2 ** (i - 2)
            co = c * 2 ** (i - 1)
            setattr(self, f"e{i}_c1", GeneralConv3d(
                cin * g, co * g, stride=1 if i == 1 else 2, groups=g))
            for j in (2, 3):
                setattr(self, f"e{i}_c{j}",
                        GeneralConv3d(co * g, co * g, groups=g))
        self.stages = stages

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        outs, xi = [], x
        for i in range(1, self.stages + 1):
            xi = getattr(self, f"e{i}_c1")(xi)
            xi = xi + getattr(self, f"e{i}_c3")(getattr(self, f"e{i}_c2")(xi))
            outs.append(xi)
        return tuple(outs)


class DecoderSep(nn.Module):
    """Shared per-modality U-Net decoder -> softmax (mmformer.py:119-170
    with pre-norm units, rfnet.py:112-156 and m2ftrans.py:103-146 with
    post-norm ones; the non-space-to-depth branch). Inputs are
    single-modality scales (N, c*2^k, ...); the training forward stacks the
    4 modalities on the batch axis (`split_modalities`) and runs it once."""

    def __init__(self, num_cls: int = 4, basic_dims: int = 8,
                 scales: int = 5, unit: type[nn.Module] = GeneralConv3d):
        super().__init__()
        c = basic_dims
        for k in range(scales - 1, 0, -1):
            ck = c * 2 ** (k - 1)
            setattr(self, f"d{k}_c1", unit(2 * ck, ck))
            setattr(self, f"d{k}_c2", unit(2 * ck, ck))
            setattr(self, f"d{k}_out", unit(ck, ck, 1, padding=0))
        self.seg_layer = Conv3d(c, num_cls, 1, padding=0)
        self.scales = scales

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        de = xs[-1]
        for k in range(self.scales - 1, 0, -1):
            de = getattr(self, f"d{k}_c1")(upsample_trilinear(de, 2))
            de = getattr(self, f"d{k}_out")(getattr(self, f"d{k}_c2")(
                torch.cat([de, xs[k - 1]], dim=1)))
        return torch.softmax(self.seg_layer(de), dim=1)


class PRMGenerator(nn.Module):
    """Probability-region-map head (layers.py:693-738): an embedding
    (general_conv3d x3, 4C -> C/4 -> C/4 -> C) of the masked modality
    stack, optionally concatenated after the decoded features, then a
    16-channel unit and a 1x1 conv to class logits. `decoded=False` is the
    deepest scale's `PRMGeneratorLastStage`."""

    def __init__(self, in_channel: int, num_cls: int = 4,
                 decoded: bool = True):
        super().__init__()
        c = in_channel
        self.embedding_layer = nn.Module()
        self.embedding_layer.layers = conv_stack((4 * c, c // 4, 1),
                                                 (c // 4, c // 4, 3),
                                                 (c // 4, c, 1))
        self.layers = conv_stack((2 * c if decoded else c, 16, 1))
        self.conv = Conv3d(16, num_cls, 1, padding=0)

    def forward(self, ym: torch.Tensor,
                decoded: torch.Tensor | None = None) -> torch.Tensor:
        """ym: masked flat stack (N, 4C, ...); decoded (N, C, ...)."""
        y = run_stack(self.embedding_layer.layers, ym)
        if decoded is not None:
            y = torch.cat([decoded, y], dim=1)
        return self.conv(run_stack(self.layers, y))


class PRMFusion(nn.Module):
    """Plain PRM head, a 16-channel unit and a 1x1 conv to logits
    (layers.py:741-749)."""

    def __init__(self, in_channels: int, num_cls: int = 4):
        super().__init__()
        self.layers = conv_stack((in_channels, 16, 1))
        self.conv = Conv3d(16, num_cls, 1, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(run_stack(self.layers, x))


class ModalFusion(nn.Module):
    """Learned sigmoid weights of the 4 modalities inside one region
    (layers.py:752-774): from each modality's mean feature over the region,
    divided by the region's mean probability (+1e-7), and that mean."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc1 = nn.Linear(NUM_MODALS * channels + 1, 128)
        self.fc2 = nn.Linear(128, NUM_MODALS)

    def forward(self, xs: list[torch.Tensor],
                prm_region: torch.Tensor) -> torch.Tensor:
        """xs: the 4 modalities' region features (N, C, ...); prm_region:
        the region's probability (N, ...)."""
        prm_avg = prm_region.mean(dim=(1, 2, 3)) + 1e-7  # (N,)
        feat_avg = torch.cat([x.mean(dim=(2, 3, 4)) for x in xs],
                             dim=1) / prm_avg[:, None]
        vec = torch.cat([feat_avg, prm_avg[:, None]], dim=1)
        w = torch.sigmoid(self.fc2(F.leaky_relu(self.fc1(vec), 0.2)))
        w = w.reshape(w.shape + (1, 1, 1, 1))
        out = xs[0] * w[:, 0]
        for m in range(1, NUM_MODALS):
            out = out + xs[m] * w[:, m]
        return out


class RegionAwareModalFusion(nn.Module):
    """Region-aware modality fusion (layers.py:803-840): per PRM region, the
    modalities' features weighted by the region's probability are fused
    with learned weights; the regions' fusion and a shortcut fusion of the
    masked stack are concatenated. The 4 regions are built one after
    another, so only one region's features are alive at a time."""

    def __init__(self, in_channel: int, num_cls: int = 4):
        super().__init__()
        c = in_channel
        for r in range(num_cls):
            setattr(self, f"modal_fusion_{r}", ModalFusion(c))
        self.region_fusion_c1 = GeneralConv3d(num_cls * c, c, 1, padding=0)
        self.region_fusion_c2 = GeneralConv3d(c, c, 3)
        self.region_fusion_c3 = GeneralConv3d(c, c // 2, 1, padding=0)
        self.layers = conv_stack((NUM_MODALS * c, c, 1), (c, c, 3),
                                 (c, c // 2, 1))  # the shortcut
        self.num_cls = num_cls

    def forward(self, ym: torch.Tensor, prm: torch.Tensor) -> torch.Tensor:
        """ym: masked flat stack (N, 4C, ...); prm: (N, K, ...) softmax
        probabilities, without a gradient."""
        c = ym.shape[1] // NUM_MODALS
        ys = [ym[:, m * c:(m + 1) * c] for m in range(NUM_MODALS)]
        fused = []
        for r in range(self.num_cls):
            pr = prm[:, r:r + 1]
            fused.append(getattr(self, f"modal_fusion_{r}")(
                [y * pr for y in ys], prm[:, r]))
        rf = torch.cat(fused, dim=1)  # region-major channels
        del fused
        rf = self.region_fusion_c3(self.region_fusion_c2(
            self.region_fusion_c1(rf)))
        return torch.cat([rf, run_stack(self.layers, ym)], dim=1)


class FusionPostNorm(nn.Module):
    """Mask, then 3x general_conv3d (k = 1, 3, 1) on the flat modality
    stack (layers.py:871-883)."""

    def __init__(self, in_channel: int):
        super().__init__()
        c = in_channel
        self.layers = conv_stack((NUM_MODALS * c, c, 1), (c, c, 3), (c, c, 1))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (N, 4C, ...); mask (N, 4)."""
        return run_stack(self.layers, mask_channels(x, mask))


# --- LayerNorm + GELU conv blocks and channel cross-attention (M2FTrans) ---

def channel_layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channel axis of (N, C, ...), contiguous out."""
    return norm(x.movedim(1, -1)).movedim(-1, 1).contiguous()


def conv_norm_chain(convs: nn.ModuleList, norms: nn.ModuleList,
                    x: torch.Tensor) -> torch.Tensor:
    """conv -> channel LayerNorm for each pair, exact GELU between them."""
    for i, (conv, norm) in enumerate(zip(convs, norms)):
        if i:
            x = F.gelu(x)
        x = channel_layer_norm(norm, conv(x))
    return x


class DepthWiseConvBlock(nn.Module):
    """1x1 conv -> LN -> GELU -> depthwise 3x3x3 -> LN -> GELU -> 1x1 conv
    -> LN (layers.py:552-567): flax `nn.Conv`s, zero-padded, LayerNorm eps
    1e-6 over channels, exact GELU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        mid = in_channels
        self.convs = nn.ModuleList([
            nn.Conv3d(mid, mid, 1),
            nn.Conv3d(mid, mid, 3, padding=1, groups=mid),
            nn.Conv3d(mid, out_channels, 1)])
        self.norms = nn.ModuleList(nn.LayerNorm(n, eps=1e-6)
                                   for n in (mid, mid, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_norm_chain(self.convs, self.norms, x)


class GroupConvBlock(nn.Module):
    """Inverted-bottleneck conv FFN with a residual (layers.py:570-592):
    1x1 to 4c -> LN -> GELU -> 3x3x3 grouped (groups=c, 4 channels each)
    -> LN -> GELU -> 1x1 to c -> LN, then GELU(x + that). Its dropout rate
    is 0 in M2FTrans."""

    def __init__(self, channels: int, expand_ratio: int = 4):
        super().__init__()
        c, e = channels, channels * expand_ratio
        self.convs = nn.ModuleList([
            nn.Conv3d(c, e, 1), nn.Conv3d(e, e, 3, padding=1, groups=c),
            nn.Conv3d(e, c, 1)])
        self.norms = nn.ModuleList(nn.LayerNorm(n, eps=1e-6)
                                   for n in (e, e, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x + conv_norm_chain(self.convs, self.norms, x))


class MultiMaskAttentionLayer(nn.Module):
    """Channel cross-attention with per-modality K/V maps
    (layers.py:595-637): the query's channels (N, C, L) attend over the
    4C key channels of the stacked feature maps, scaled by L^-0.5, with
    absent modalities' key channels masked (`cross_key_bias`)."""

    def __init__(self, channels: int, proj_drop: float = 0.1):
        super().__init__()
        self.query_map = DepthWiseConvBlock(channels, channels)
        for nm in MODALITY_NAMES:
            setattr(self, f"key_map_{nm}", DepthWiseConvBlock(channels,
                                                              channels))
            setattr(self, f"value_map_{nm}", DepthWiseConvBlock(channels,
                                                                channels))
        self.out_project = DepthWiseConvBlock(channels, channels)
        self.proj_drop = proj_drop

    def forward(self, query: torch.Tensor, feature_maps: torch.Tensor,
                mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """query (N, C, ...); feature_maps (N, 4, C, ...); mask (N, 4)."""
        n, cq = query.shape[:2]
        ck = feature_maps.shape[2]
        l = query[0, 0].numel()
        q = self.query_map(query).reshape(n, cq, l)
        k = torch.cat([getattr(self, f"key_map_{nm}")(feature_maps[:, m])
                       .reshape(n, ck, l)
                       for m, nm in enumerate(MODALITY_NAMES)], dim=1)
        v = torch.cat([getattr(self, f"value_map_{nm}")(feature_maps[:, m])
                       .reshape(n, ck, l)
                       for m, nm in enumerate(MODALITY_NAMES)], dim=1)
        logits = (q @ k.transpose(1, 2)) * (l ** -0.5)  # (N, C, 4C)
        attn = torch.softmax(logits.float() + cross_key_bias(mask, ck),
                             dim=-1)
        y = (attn.to(v.dtype) @ v).reshape(query.shape)
        y = dropout(self.out_project(y), self.proj_drop, generator)
        return query + y


class MultiMaskCrossBlock(nn.Module):
    """Masked cross-attention, then the conv FFNs: `ffn1` on the query,
    `ffn2` (tied over modalities, which run as one batch) on the feature
    maps (layers.py:640-663)."""

    def __init__(self, channels: int, ffn_feature_maps: bool = True):
        super().__init__()
        self.cross_attn = MultiMaskAttentionLayer(channels)
        self.ffn1 = GroupConvBlock(channels)
        self.ffn2 = GroupConvBlock(channels) if ffn_feature_maps else None

    def forward(self, kernels, feature_maps, mask, generator=None):
        kernels = self.ffn1(self.cross_attn(kernels, feature_maps, mask,
                                            generator))
        if self.ffn2 is not None:
            n, m = feature_maps.shape[:2]
            feature_maps = self.ffn2(feature_maps.reshape(
                (n * m,) + tuple(feature_maps.shape[2:]))).reshape(
                    feature_maps.shape)
        return kernels, feature_maps


class MultiCrossToken(nn.Module):
    """Two MultiMaskCrossBlocks refining the fusion volume
    (layers.py:666-685); the last one leaves the feature maps alone."""

    def __init__(self, channels: int, num_layers: int = 2):
        super().__init__()
        for i in range(num_layers):
            setattr(self, f"layer_{i}", MultiMaskCrossBlock(
                channels, ffn_feature_maps=i != num_layers - 1))
        self.num_layers = num_layers

    def forward(self, feature_maps, kernels, mask, generator=None):
        for i in range(self.num_layers):
            kernels, feature_maps = getattr(self, f"layer_{i}")(
                kernels, feature_maps, mask, generator)
        return kernels


# --- the PASSION training outputs, shared by the three backbones ----------

def passion_outputs(fuse_logits: torch.Tensor, prms, de_x1: torch.Tensor,
                    sep: torch.Tensor, mask: torch.Tensor,
                    target: torch.Tensor, *, num_cls: int, temp: float,
                    use_passion: bool, idt: bool, weights, upscales) -> dict:
    """Per-sample losses of a backbone's training forward
    (rfnet.py:339-425, mmformer.py:479-554, m2ftrans.py:366-443).

    fuse_logits, each of `prms` and de_x1 hold L lanes of B samples,
    lane-major: lane 0 is the real mask, lanes 1-4 (PASSION only) the
    unimodal masks. sep: (4B, num_cls, ...) softmax of the shared decoder,
    modality-major. `prms[k]` is supervised at `weights[k]`, upsampled by
    `upscales[k]`. Returns fuse_pred (B, num_cls, ...) and the float32
    columns prm_loss (B, 1), sep_loss, kl_loss, proto_loss, dist (B, 4)."""
    b, k_cls = mask.shape[0], num_cls
    lanes = fuse_logits.shape[0] // b
    dev = fuse_logits.device

    def lane(t: torch.Tensor, i: int) -> torch.Tensor:
        return t.reshape((lanes, b) + tuple(t.shape[1:]))[i]

    sep = sep.reshape((NUM_MODALS, b) + tuple(sep.shape[1:]))
    modal_gate = (mask.to(torch.float32) if idt else
                  torch.ones((b, NUM_MODALS), device=dev))
    gate5 = modal_gate[:, :, None, None, None]
    sep_cols = []
    for m in range(NUM_MODALS):
        p = sep[m] * gate5[:, m:m + 1] if idt else sep[m]
        sep_cols.append(losses.softmax_weighted_loss_bs(p, target, k_cls)
                        + losses.dice_loss_bs(p, target, k_cls))
    sep_loss = torch.cat(sep_cols, dim=1) * modal_gate

    prm_loss = torch.zeros((b, 1), device=dev)
    for k, (w, up) in enumerate(zip(weights, upscales)):
        p = torch.softmax(lane(prms[k], 0), dim=1)
        prm_loss = prm_loss + w * (
            losses.softmax_weighted_loss_bs(p, target, k_cls, up_scale=up)
            + losses.dice_loss_bs(p, target, k_cls, up_scale=up))

    fuse_pred = torch.softmax(lane(fuse_logits, 0), dim=1)
    if not use_passion:
        zeros = torch.zeros((b, NUM_MODALS), device=dev)
        return dict(fuse_pred=fuse_pred, prm_loss=prm_loss,
                    sep_loss=sep_loss, kl_loss=zeros, proto_loss=zeros,
                    dist=zeros)

    kl_cols, proto_cols, dist_cols = [], [], []
    teacher_fuse = lane(fuse_logits, 0).detach()
    teacher_feat = lane(de_x1, 0).detach()
    for m in range(NUM_MODALS):
        kl = losses.temp_kl_loss_bs(lane(fuse_logits, m + 1), teacher_fuse,
                                    target, k_cls, temp)
        for k, (w, up) in enumerate(zip(weights, upscales)):
            kl = kl + w * losses.temp_kl_loss_bs(
                lane(prms[k], m + 1), lane(prms[k], 0).detach(), target,
                k_cls, temp, up_scale=up)
        proto, dist = losses.prototype_passion_loss_bs(
            lane(de_x1, m + 1), teacher_feat, target,
            lane(fuse_logits, m + 1), teacher_fuse, k_cls, temp)
        kl_cols.append(kl)
        proto_cols.append(proto)
        dist_cols.append(dist)

    kl_loss = torch.cat(kl_cols, dim=1) * modal_gate
    proto_loss = torch.cat(proto_cols, dim=1) * modal_gate
    dist = torch.cat(dist_cols, dim=1) * modal_gate
    dist = zero_unimodal_self_dist(dist, mask)
    return dict(fuse_pred=fuse_pred, prm_loss=prm_loss, sep_loss=sep_loss,
                kl_loss=kl_loss, proto_loss=proto_loss, dist=dist)
