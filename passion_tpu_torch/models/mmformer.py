"""mmFormer (counterpart of `passion_tpu/models/mmformer.py`): inference
and the PASSION training forward.

Five-stage pre-norm conv encoders for the four modalities, run as one
grouped encoder on modality-major channels; an IntraFormer per modality
over the (patch/16)^3 bottleneck tokens; an InterFormer over the four
modalities' tokens; and a fusion decoder with a FusionPreNorm block at
every scale. Tensors are (B, C, H, W, Z).

`features(x)` is the mask-independent part of a window's forward and
`fuse_inference(features(x), mask)` the per-mask part, so the 15-mask sweep
encodes each window once: `fuse_inference(features(x), m) == forward(x, m)`
for every mask m.

`train_losses` is the training forward with in-graph per-sample losses. JAX
runs its 5 fuse passes (the real mask and the 4 unimodal masks) as a vmap
over a (5, B, 4) mask stack with tied params, and the shared per-modality
decoder 4 times with tied params; every op on those paths is per-sample, so
here they are one pass over a batch of 5B (resp. 4B), lane-major. The
deep-supervision heads `seg_d1..seg_d4` run only in training, so the
inference paths launch exactly the convs and norms they did before.
The reference's T2 self-distillation bug (mmformer.py:24-26) is not
copied: lane 4 runs the T2-only mask.
"""

from __future__ import annotations

import torch
from torch import nn

from passion_tpu_torch.models.layers import (
    Conv3d,
    DecoderSep,
    FusionPreNorm,
    GeneralConv3dPreNorm,
    Transformer,
    mask_channels_lanes,
    mask_modalities,
    passion_outputs,
    split_modalities,
    unimodal_mask_stack,
)
from passion_tpu_torch.ops import fused_norm
from passion_tpu_torch.ops.resize import upsample_trilinear

NUM_MODALS = 4
TRANSFORMER_DIM = 512
MLP_DIM = 4096
NUM_HEADS = 8
DEPTH = 1


class GroupedEncoder(nn.Module):
    """5-stage pre-norm encoder of all 4 modalities at once, grouped per
    modality (mmformer.py:63-116, its non-space-to-depth branch).
    (B, 4, H, W, Z) -> five flat scales (B, 4*C_k, ...)."""

    def __init__(self, basic_dims: int = 8):
        super().__init__()
        c, g = basic_dims, NUM_MODALS

        def gc(cin, cout, **kw):
            return GeneralConv3dPreNorm(cin * g, cout * g, groups=g, **kw)

        self.e1_c1 = Conv3d(g, c * g, groups=g)  # bare conv (mmformer.py:28)
        self.e1_c2 = gc(c, c)
        self.e1_c3 = gc(c, c)
        self.e2_c1 = gc(c, 2 * c, stride=2)
        self.e2_c2 = gc(2 * c, 2 * c)
        self.e2_c3 = gc(2 * c, 2 * c)
        for i, mult in ((3, 4), (4, 8), (5, 16)):
            setattr(self, f"e{i}_c1", gc(c * mult // 2, c * mult, stride=2))
            setattr(self, f"e{i}_c2", gc(c * mult, c * mult))
            setattr(self, f"e{i}_c3", gc(c * mult, c * mult))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        x1 = self.e1_c1(x)
        outs = [x1 + self.e1_c3(self.e1_c2(x1))]
        for i in range(2, 6):
            xi = getattr(self, f"e{i}_c1")(outs[-1])
            xi = xi + getattr(self, f"e{i}_c3")(getattr(self, f"e{i}_c2")(xi))
            outs.append(xi)
        return tuple(outs)


class DecoderFuse(nn.Module):
    """Fusion decoder (mmformer.py:173-268, its non-space-to-depth branch).
    Inputs x1..x4 are flat modality stacks (B, 4*C_k, ...), x5 the decoded
    InterFormer volume (B, 4*16c, s, s, s). Returns the logits, or with
    `heads` (training) (logits, (pred1..pred4), (de_x1_f..de_x5_f)): the
    deep-supervision logits at 1/2..1/16 resolution and each scale's
    decoded feature."""

    def __init__(self, num_cls: int = 4, basic_dims: int = 8):
        super().__init__()
        c, g = basic_dims, NUM_MODALS
        self.RFM5 = FusionPreNorm(16 * c * g, 16 * c)
        self.d4_c1 = GeneralConv3dPreNorm(16 * c, 8 * c)
        self.seg_d4 = Conv3d(16 * c, num_cls, 1, padding=0)
        for k, ck in ((4, 8 * c), (3, 4 * c), (2, 2 * c), (1, c)):
            setattr(self, f"RFM{k}", FusionPreNorm(ck * g, ck))
            setattr(self, f"d{k}_c2", GeneralConv3dPreNorm(2 * ck, ck))
            setattr(self, f"d{k}_out",
                    GeneralConv3dPreNorm(ck, ck, 1, padding=0))
            if k > 1:
                setattr(self, f"d{k - 1}_c1", GeneralConv3dPreNorm(ck, ck // 2))
                setattr(self, f"seg_d{k - 1}", Conv3d(ck, num_cls, 1,
                                                      padding=0))
        self.seg_layer = Conv3d(c, num_cls, 1, padding=0)

    def forward(self, x1, x2, x3, x4, x5, pm_mask: torch.Tensor | None = None,
                heads: bool = False):
        """`pm_mask` ((4,), premasked sweep mode): x1..x4 arrive unmasked
        and prenormed (MMFormer.features) and the mask is folded into each
        scale's first RFM conv kernel instead."""
        pn = pm_mask is not None
        de_f = self.RFM5(x5)
        feats, preds = [de_f], []
        if heads:
            preds.append(self.seg_d4(de_f))
        up = self.d4_c1(upsample_trilinear(de_f, 2))
        for k, xk in ((4, x4), (3, x3), (2, x2), (1, x1)):
            de = getattr(self, f"RFM{k}")(xk, in_mask=pm_mask, prenormed=pn)
            de_f = getattr(self, f"d{k}_out")(
                getattr(self, f"d{k}_c2")(torch.cat([de, up], dim=1)))
            feats.append(de_f)
            if k > 1:
                if heads:
                    preds.append(getattr(self, f"seg_d{k - 1}")(de_f))
                up = getattr(self, f"d{k - 1}_c1")(upsample_trilinear(de_f, 2))
        logits = self.seg_layer(de_f)
        if not heads:
            return logits
        return logits, tuple(preds[::-1]), tuple(feats[::-1])


class FusePath(nn.Module):
    """InterFormer + fusion decoder for one modality mask
    (mmformer.py:283-331)."""

    def __init__(self, num_cls: int = 4, basic_dims: int = 8,
                 trans_dim: int = TRANSFORMER_DIM, heads: int = NUM_HEADS,
                 mlp_dim: int = MLP_DIM, depth: int = DEPTH):
        super().__init__()
        self.multimodal_transformer = Transformer(trans_dim, depth, heads,
                                                  mlp_dim)
        self.multimodal_decode_conv = nn.Conv3d(
            trans_dim * NUM_MODALS, basic_dims * 16 * NUM_MODALS, 1)
        self.decoder_fuse = DecoderFuse(num_cls, basic_dims)

    def forward(self, feats, intra: torch.Tensor, pos_all: torch.Tensor,
                mask: torch.Tensor, premasked: bool = False,
                generator: torch.Generator | None = None,
                heads: bool = False):
        """feats: 4 flat scales (B, 4*C_k, ...); intra: (B, 4, T, D);
        pos_all: (1, 4T, D); mask: (B, 4), or (L, B, 4) to run L masks over
        the same batch as one batch of L*B, lane-major (the JAX vmap over
        the mask stack). With `premasked` the feats are unmasked and
        prenormed and the mask (B, 4) must be the same for the whole batch.
        `generator` turns dropout on; `heads` returns the deep-supervision
        outputs too (DecoderFuse)."""
        b, _, t, d = intra.shape
        s = round(t ** (1 / 3))
        lanes = mask.reshape(-1, b, NUM_MODALS)
        n = lanes.shape[0] * b
        tokens = (intra.unsqueeze(0) * lanes.to(intra.dtype)[..., None, None])
        inter = self.multimodal_transformer(
            tokens.reshape(n, NUM_MODALS * t, d), pos_all, generator)
        # The reference's reshape scramble (mmformer.py:317-321): the
        # (N, 4T, D) tokens are read channels-last as (N, s, s, s, 4D).
        x5 = inter.reshape(n, s, s, s, d * NUM_MODALS).permute(
            0, 4, 1, 2, 3).contiguous()
        x5 = self.multimodal_decode_conv(x5)
        if premasked:
            return self.decoder_fuse(*feats, x5, pm_mask=mask[0], heads=heads)
        return self.decoder_fuse(*[mask_channels_lanes(f, lanes)
                                   for f in feats], x5, heads=heads)


class MMFormer(nn.Module):
    """mmFormer backbone with the PASSION training outputs
    (mmformer.py:334-554)."""

    # Deep-supervision schedule: preds at 1/2..1/16 resolution
    # (mmformer.py:354-357).
    PRM_WEIGHTS = (0.5, 0.25, 0.125, 0.0625)
    PRM_UPSCALES = (2, 4, 8, 16)

    def __init__(self, num_cls: int = 4, basic_dims: int = 8,
                 mask_type: str = "idt", patch_size: int = 80,
                 trans_dim: int = TRANSFORMER_DIM, mlp_dim: int = MLP_DIM,
                 heads: int = NUM_HEADS, depth: int = DEPTH):
        super().__init__()
        self.num_cls, self.mask_type = num_cls, mask_type
        self.patch_size, self.trans_dim = patch_size, trans_dim
        c = basic_dims
        self.encoders = GroupedEncoder(basic_dims)
        self.encode_convs = nn.Conv3d(16 * c * NUM_MODALS,
                                      trans_dim * NUM_MODALS, 1,
                                      groups=NUM_MODALS)
        self.intra_transformers = nn.ModuleList(
            Transformer(trans_dim, depth, heads, mlp_dim)
            for _ in range(NUM_MODALS))
        self.decoder_sep = DecoderSep(num_cls, basic_dims, 5,
                                      GeneralConv3dPreNorm)
        self.fuse_path = FusePath(num_cls, basic_dims, trans_dim, heads,
                                  mlp_dim, depth)
        t = (patch_size // 16) ** 3
        # learned per-modality positional embeddings, zero at init
        self.pos = nn.Parameter(torch.zeros(NUM_MODALS, 1, t, trans_dim))

    def _intra(self, x5: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Bottleneck (B, 4*16c, s, s, s) -> IntraFormer tokens (B, 4, T, D).
        Tokens are in (h, w, z) row-major order and modality-major on
        channels, as the JAX package's channels-last reshape gives them."""
        b, s = x5.shape[0], x5.shape[2]
        t = s ** 3
        if t != self.pos.shape[2]:
            raise ValueError(
                f"input bottleneck has {t} tokens but pos embedding was sized "
                f"for patch_size={self.patch_size}; construct the model with "
                f"the matching patch_size")
        tok = self.encode_convs(x5).permute(0, 2, 3, 4, 1).reshape(
            b, t, NUM_MODALS, self.trans_dim).transpose(1, 2)
        return torch.stack([tr(tok[:, m], self.pos[m], generator)
                            for m, tr in enumerate(self.intra_transformers)],
                           dim=1)

    def pos_all(self) -> torch.Tensor:
        t = self.pos.shape[2]
        return self.pos.transpose(0, 1).reshape(1, NUM_MODALS * t,
                                                self.trans_dim)

    def encode(self, x: torch.Tensor, mask: torch.Tensor,
               generator: torch.Generator | None = None):
        """(five flat scales (B, 4*C_k, ...), masked in 'idt'; IntraFormer
        tokens (B, 4, T, D), masked; pos_all) (mmformer.py:388-419)."""
        idt = self.mask_type != "pdt"
        if idt:
            x = x * mask.to(x.dtype)[:, :, None, None, None]
        feats = self.encoders(x)
        if idt:
            feats = tuple(mask_channels_lanes(f, mask[None]) for f in feats)
        intra = mask_modalities(self._intra(feats[4], generator), mask)
        return feats, intra, self.pos_all()

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (B, 4, H, W, Z); mask: (B, 4) bool. Softmax (B, num_cls, ...)."""
        feats, intra, pos_all = self.encode(x, mask)
        return torch.softmax(self.fuse_path(feats[:4], intra, pos_all, mask),
                             dim=1)

    def features(self, x: torch.Tensor) -> dict:
        """Mask-independent window features for the sweep. Each scale's
        first-RFM IN+LReLU is hoisted here: per-(window, channel) statistics
        do not depend on other channels' masking, and masked channels die in
        the zeroed kernel rows of the premasked decoder."""
        feats = self.encoders(x)
        intra = self._intra(feats[4])
        return {"x1": fused_norm.instance_norm_lrelu(feats[0]),
                "rest": tuple(fused_norm.instance_norm_lrelu(f)
                              for f in feats[1:4]),
                "intra": intra}

    def fuse_inference(self, fts: dict, mask: torch.Tensor) -> torch.Tensor:
        """InterFormer + fusion decode + softmax from `features`; the mask
        (B, 4) must be the same for every window of the batch."""
        feats = (fts["x1"],) + tuple(fts["rest"])
        logits = self.fuse_path(feats, fts["intra"], self.pos_all(), mask,
                                premasked=True)
        return torch.softmax(logits, dim=1)

    def train_losses(self, x: torch.Tensor, mask: torch.Tensor,
                     target: torch.Tensor, temp: float = 1.0,
                     use_passion: bool = True,
                     generator: torch.Generator | None = None) -> dict:
        """Training forward with in-graph per-sample losses
        (mmformer.py:479-554). x (B, 4, H, W, Z); mask (B, 4) bool; target
        (B, num_cls, H, W, Z) one-hot. `generator` turns dropout on.
        Returns fuse_pred (B, num_cls, ...) and the (B, 1) / (B, 4) float32
        loss columns prm_loss, sep_loss, kl_loss, proto_loss, dist."""
        feats, intra, pos_all = self.encode(x, mask, generator)
        masks = unimodal_mask_stack(mask) if use_passion else mask[None]
        fuse_logits, prms, de_feats = self.fuse_path(
            feats[:4], intra, pos_all, masks, generator=generator, heads=True)

        sep = self.decoder_sep(*[split_modalities(f) for f in feats])
        return passion_outputs(
            fuse_logits, prms, de_feats[0], sep, mask, target,
            num_cls=self.num_cls, temp=temp, use_passion=use_passion,
            idt=self.mask_type != "pdt", weights=self.PRM_WEIGHTS,
            upscales=self.PRM_UPSCALES)
