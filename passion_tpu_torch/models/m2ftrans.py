"""M2FTrans (counterpart of `passion_tpu/models/m2ftrans.py`): inference
and the PASSION training forward.

Five-stage post-norm conv encoders for the four modalities, run as one
grouped encoder on modality-major channels; a bottleneck of 4T modality
tokens and T learned fusion tokens (T = (patch/16)^3) through a masked
transformer, whose bias lets fusion tokens see only present modalities and
modality tokens only their own block; Weight_Attention, which turns the
first layer's fusion-row attention into per-modality spatial weights,
upsampled x2 (nearest) from scale to scale, that modulate every skip; and a
fusion decoder with channel cross-attention (MultiCrossToken) at the two
deepest scales, FusionPostNorm at the others and a PRM head at each.
Tensors are (B, C, H, W, Z); tokens are taken in (h, w, z) row-major
order, as the JAX package's channels-last reshape gives them.

`features(x)` is the encoder alone: it is block-diagonal over modalities,
so masking its input and masking its outputs are the same, and
`fuse_inference(features(x), m) == forward(x, m)` for every mask m.
`fuse_inference` masks every scale, as the JAX package does.

`train_losses`: the JAX package's vmap of the fuse path over the 5 masks
(the real one and the 4 unimodal ones) and its 4 runs of the shared
decoder are one batch of 5B and one of 4B here, lane-major. Dropout (rate
0.1, in the transformer and after the cross-attention's projection) is on
only when a generator is passed.
"""

from __future__ import annotations

import torch
from torch import nn

from passion_tpu_torch.models.layers import (
    Conv3d,
    DecoderSep,
    FusionPostNorm,
    GeneralConv3d,
    GroupedEncoder,
    MaskedTransformer,
    MultiCrossToken,
    PRMFusion,
    mask_channels_lanes,
    passion_outputs,
    split_modalities,
    unimodal_mask_stack,
)
from passion_tpu_torch.ops.attn_mask import fusion_attention_bias
from passion_tpu_torch.ops.resize import upsample_nearest, upsample_trilinear

NUM_MODALS = 4
MLP_DIM = 4096
NUM_HEADS = 8
DEPTH = 3


class DecoderFusion(nn.Module):
    """Fusion decoder (m2ftrans.py:149-206). wx1..wx3 are flat modality
    stacks (N, 4*C_k, ...), wx4 and wx5 stacked (N, 4, C_k, ...), all
    modulated by the weight maps; fusion (N, 16c, s, s, s) is the fusion
    tokens' volume; mask (N, 4). Returns the logits, or with `heads`
    (logits, (prm1..prm5 logits), de_x1)."""

    def __init__(self, num_cls: int = 4, basic_dims: int = 8):
        super().__init__()
        c = basic_dims
        self.prm_fusion5 = PRMFusion(16 * c, num_cls)
        self.CT5 = MultiCrossToken(16 * c)
        self.d5_c2 = GeneralConv3d(32 * c, 16 * c)
        self.d5_out = GeneralConv3d(16 * c, 16 * c, 1, padding=0)
        self.d4_c1 = GeneralConv3d(16 * c, 8 * c)
        self.prm_fusion4 = PRMFusion(8 * c, num_cls)
        self.CT4 = MultiCrossToken(8 * c)
        for k in (4, 3, 2, 1):
            ck = c * 2 ** (k - 1)
            if k < 4:
                setattr(self, f"prm_fusion{k}", PRMFusion(ck, num_cls))
                setattr(self, f"RFM{k}", FusionPostNorm(ck))
            setattr(self, f"d{k}_c2", GeneralConv3d(2 * ck, ck))
            setattr(self, f"d{k}_out", GeneralConv3d(ck, ck, 1, padding=0))
            if k > 1:
                setattr(self, f"d{k - 1}_c1", GeneralConv3d(ck, ck // 2))
        self.seg_layer = Conv3d(c, num_cls, 1, padding=0)

    def forward(self, wx1, wx2, wx3, wx4, wx5, fusion, mask,
                generator: torch.Generator | None = None,
                heads: bool = False):
        prms = [self.prm_fusion5(fusion)]
        de = self.CT5(wx5, fusion, mask, generator)
        de = self.d5_out(self.d5_c2(torch.cat([de, fusion], dim=1)))
        up = self.d4_c1(upsample_trilinear(de, 2))
        prms.append(self.prm_fusion4(up))
        de = self.CT4(wx4, up, mask, generator)
        for k, wx in ((4, None), (3, wx3), (2, wx2), (1, wx1)):
            if k < 4:
                prms.append(getattr(self, f"prm_fusion{k}")(up))
                de = getattr(self, f"RFM{k}")(wx, mask)
            de = getattr(self, f"d{k}_out")(getattr(self, f"d{k}_c2")(
                torch.cat([de, up], dim=1)))
            if k > 1:
                up = getattr(self, f"d{k - 1}_c1")(upsample_trilinear(de, 2))
        logits = self.seg_layer(de)
        if not heads:
            return logits
        return logits, tuple(prms[::-1]), de


def weight_maps(attn0: torch.Tensor, s: int) -> torch.Tensor:
    """Fusion-row attention -> per-modality spatial weights
    (`_weight_maps`, m2ftrans.py:209-222): the attention each modality
    token receives from all fusion tokens and heads. attn0: (N, heads, 5T,
    5T) first-layer probabilities; returns (N, 4, s, s, s)."""
    t = s ** 3
    per_token = attn0[:, :, NUM_MODALS * t:, :].sum(dim=(1, 2))  # (N, 5T)
    return per_token[:, :NUM_MODALS * t].reshape(-1, NUM_MODALS, s, s, s)


class FusePath(nn.Module):
    """Bottleneck + Weight_Attention + fusion decoder for the masks of one
    batch (m2ftrans.py:225-285)."""

    def __init__(self, num_cls: int = 4, basic_dims: int = 8,
                 heads: int = NUM_HEADS, mlp_dim: int = MLP_DIM,
                 depth: int = DEPTH):
        super().__init__()
        self.trans_bottle = MaskedTransformer(16 * basic_dims, depth, heads,
                                              mlp_dim)
        self.decoder_fusion = DecoderFusion(num_cls, basic_dims)

    def forward(self, feats, fusion_tokens: torch.Tensor, pos: torch.Tensor,
                lanes: torch.Tensor,
                generator: torch.Generator | None = None,
                heads: bool = False):
        """feats: the 5 flat scales (B, 4*C_k, ...); fusion_tokens (1, T,
        E); pos (1, 5T, E); lanes (L, B, 4): L masks over the batch, run as
        one batch of L*B, lane-major (the JAX vmap over the mask stack)."""
        x5 = feats[4]
        b, s = x5.shape[0], x5.shape[2]
        t, e, n_lanes = s ** 3, x5.shape[1] // NUM_MODALS, lanes.shape[0]
        n = n_lanes * b
        embed = x5.reshape(b, NUM_MODALS, e, t).transpose(2, 3).reshape(
            b, NUM_MODALS * t, e)
        tokens = torch.cat([embed, fusion_tokens.expand(b, t, e)],
                           dim=1) + pos
        tokens = tokens.expand((n_lanes,) + tokens.shape).reshape(
            n, (NUM_MODALS + 1) * t, e)
        mask = lanes.reshape(n, NUM_MODALS)
        tokens, attn0 = self.trans_bottle(
            tokens, fusion_attention_bias(mask, t), generator)
        chunks = tokens.reshape(n, NUM_MODALS + 1, t, e)
        modal = chunks[:, :NUM_MODALS].transpose(2, 3).reshape(
            n, NUM_MODALS, e, s, s, s)
        fusion = chunks[:, NUM_MODALS].transpose(1, 2).reshape(n, e, s, s, s)

        # Weight_Attention (m2ftrans.py:261-281), in the features' dtype
        ws = [weight_maps(attn0, s).to(x5.dtype)]
        for _ in range(4):
            ws.append(upsample_nearest(ws[-1]))

        def modulate(feat: torch.Tensor, wmap: torch.Tensor) -> torch.Tensor:
            """(B, 4*C, ...) x lanes' (N, 4, ...) maps -> (N, 4, C, ...)."""
            rest = tuple(feat.shape[2:])
            f = feat.reshape((1, b, NUM_MODALS, -1) + rest)
            w = wmap.reshape((n_lanes, b, NUM_MODALS, 1) + rest)
            return (f * w).reshape((n, NUM_MODALS, -1) + rest)

        def flat(t4: torch.Tensor) -> torch.Tensor:
            return t4.reshape((n, -1) + tuple(t4.shape[3:]))

        wx5 = modal * ws[0][:, :, None]
        wx4 = modulate(feats[3], ws[1])
        wx3, wx2, wx1 = (flat(modulate(feats[k], ws[4 - k]))
                         for k in (2, 1, 0))
        return self.decoder_fusion(wx1, wx2, wx3, wx4, wx5, fusion, mask,
                                   generator, heads)


class M2FTrans(nn.Module):
    """M2FTrans backbone with the PASSION training outputs
    (m2ftrans.py:288-443)."""

    # Deep supervision at full..1/16 resolution (m2ftrans.py:300-302).
    PRM_WEIGHTS = (0.5, 0.25, 0.125, 0.0625, 0.03125)
    PRM_UPSCALES = (1, 2, 4, 8, 16)

    def __init__(self, num_cls: int = 4, basic_dims: int = 8,
                 mask_type: str = "idt", patch_size: int = 80,
                 heads: int = NUM_HEADS, mlp_dim: int = MLP_DIM,
                 depth: int = DEPTH):
        super().__init__()
        self.num_cls, self.mask_type = num_cls, mask_type
        self.patch_size = patch_size
        e, t = 16 * basic_dims, (patch_size // 16) ** 3
        self.encoders = GroupedEncoder(basic_dims, stages=5)
        self.decoder_sep = DecoderSep(num_cls, basic_dims, scales=5)
        self.fuse_path = FusePath(num_cls, basic_dims, heads, mlp_dim, depth)
        # positional embedding, zero at init; fusion tokens, N(0, 1) at init
        # (`init_model`; m2ftrans.py:319-323)
        self.pos = nn.Parameter(torch.zeros(1, (NUM_MODALS + 1) * t, e))
        self.fusion = nn.Parameter(torch.zeros(1, t, e))

    def _fuse(self, feats, lanes, generator=None, heads=False):
        t = feats[4][0, 0].numel()
        if t != self.fusion.shape[1]:
            raise ValueError(
                f"input bottleneck has {t} tokens but the fusion tokens were "
                f"sized for patch_size={self.patch_size}; construct the model "
                f"with the matching patch_size")
        return self.fuse_path(feats, self.fusion, self.pos, lanes, generator,
                              heads)

    def encode(self, x: torch.Tensor, mask: torch.Tensor):
        """Five flat scales (B, 4*C_k, ...), masked in 'idt'
        (m2ftrans.py:325-332)."""
        if self.mask_type != "pdt":
            x = x * mask.to(x.dtype)[:, :, None, None, None]
            return tuple(mask_channels_lanes(f, mask[None])
                         for f in self.encoders(x))
        return self.encoders(x)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (B, 4, H, W, Z); mask: (B, 4) bool. Softmax (B, num_cls, ...)."""
        return torch.softmax(self._fuse(self.encode(x, mask), mask[None]),
                             dim=1)

    def features(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Mask-independent window features for the sweep: the encoder's
        five scales."""
        return self.encoders(x)

    def fuse_inference(self, fts, mask: torch.Tensor) -> torch.Tensor:
        """Bottleneck, Weight_Attention, fusion decode and softmax from
        `features`; mask (B, 4)."""
        if self.mask_type != "pdt":
            fts = tuple(mask_channels_lanes(f, mask[None]) for f in fts)
        return torch.softmax(self._fuse(fts, mask[None]), dim=1)

    def train_losses(self, x: torch.Tensor, mask: torch.Tensor,
                     target: torch.Tensor, temp: float = 1.0,
                     use_passion: bool = True,
                     generator: torch.Generator | None = None) -> dict:
        """Training forward with in-graph per-sample losses
        (m2ftrans.py:366-443). x (B, 4, H, W, Z); mask (B, 4) bool; target
        (B, num_cls, H, W, Z) one-hot. `generator` turns dropout on.
        Returns fuse_pred and the float32 loss columns prm_loss (B, 1),
        sep_loss, kl_loss, proto_loss, dist (B, 4)."""
        feats = self.encode(x, mask)
        masks = unimodal_mask_stack(mask) if use_passion else mask[None]
        fuse_logits, prms, de_x1 = self._fuse(feats, masks, generator,
                                              heads=True)
        sep = self.decoder_sep(*[split_modalities(f) for f in feats])
        return passion_outputs(
            fuse_logits, prms, de_x1, sep, mask, target,
            num_cls=self.num_cls, temp=temp, use_passion=use_passion,
            idt=self.mask_type != "pdt", weights=self.PRM_WEIGHTS,
            upscales=self.PRM_UPSCALES)
