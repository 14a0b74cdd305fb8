"""RFNet (counterpart of `passion_tpu/models/rfnet.py`): inference and the
PASSION training forward.

Four-stage post-norm residual conv encoders for the four modalities, run
as one grouped encoder on modality-major channels; a shared per-modality
U-Net decoder (training only); and a region-aware fusion decoder that at
every scale predicts a probability region map (PRM) from the masked
modality stack and fuses the modalities region by region. Tensors are
(B, C, H, W, Z).

`features(x)` is the encoder alone: the grouped encoder computes each
modality's features from its own channel only and the fusion decoder masks
its inputs itself, so `fuse_inference(features(x), m) == forward(x, m)` for
every mask m and the sweep encodes each window once. The features keep the
plain (B, C, H, W, Z) layout; the JAX package's space-to-depth "x1s" is
TPU layout policy.

`train_losses`: the JAX package's vmap of the fusion decoder over the 5
masks (the real one and the 4 unimodal ones) and its 4 runs of the shared
decoder are one batch of 5B and one of 4B here, lane-major; every op on
those paths is per-sample. RFNet has no dropout.
"""

from __future__ import annotations

import torch
from torch import nn

from passion_tpu_torch.models.layers import (
    Conv3d,
    DecoderSep,
    GeneralConv3d,
    GroupedEncoder,
    PRMGenerator,
    RegionAwareModalFusion,
    mask_channels_lanes,
    passion_outputs,
    split_modalities,
    unimodal_mask_stack,
)
from passion_tpu_torch.ops.resize import upsample_trilinear

NUM_MODALS = 4


class DecoderFuse(nn.Module):
    """Region-aware fusion decoder (rfnet.py:159-212, its
    non-space-to-depth branch). Inputs are the flat modality stacks
    (B, 4*C_k, ...) of the 4 scales, unmasked; `lanes` (L, B, 4) are the
    masks, run as one batch of L*B, lane-major. Returns the logits, or with
    `heads` (logits, (prm1..prm4 logits), de_x1)."""

    def __init__(self, num_cls: int = 4, basic_dims: int = 8):
        super().__init__()
        c = basic_dims
        for k in (4, 3, 2, 1):
            ck = c * 2 ** (k - 1)
            setattr(self, f"prm_generator{k}",
                    PRMGenerator(ck, num_cls, decoded=k != 4))
            setattr(self, f"RFM{k}", RegionAwareModalFusion(ck, num_cls))
            if k < 4:  # the deepest scale goes straight up
                setattr(self, f"d{k}_c2", GeneralConv3d(2 * ck, ck))
                setattr(self, f"d{k}_out", GeneralConv3d(ck, ck, 1,
                                                         padding=0))
            if k > 1:
                setattr(self, f"d{k - 1}_c1", GeneralConv3d(ck, ck // 2))
        self.seg_layer = Conv3d(c, num_cls, 1, padding=0)

    def forward(self, x1, x2, x3, x4, lanes: torch.Tensor,
                heads: bool = False):
        prms, up = [], None
        for k, xk in ((4, x4), (3, x3), (2, x2), (1, x1)):
            ym = mask_channels_lanes(xk, lanes)
            prm = getattr(self, f"prm_generator{k}")(ym, up)
            prms.append(prm)
            de = getattr(self, f"RFM{k}")(ym, torch.softmax(prm, 1).detach())
            del ym
            if k < 4:
                de = getattr(self, f"d{k}_out")(getattr(self, f"d{k}_c2")(
                    torch.cat([de, up], dim=1)))
            if k > 1:
                up = getattr(self, f"d{k - 1}_c1")(upsample_trilinear(de, 2))
        logits = self.seg_layer(de)
        if not heads:
            return logits
        return logits, tuple(prms[::-1]), de


class RFNet(nn.Module):
    """RFNet backbone with the PASSION training outputs (rfnet.py:266-425)."""

    # PRM deep supervision: scale-k weight and upsampling factor
    # (rfnet.py:274-277).
    PRM_WEIGHTS = (0.5, 0.25, 0.125, 0.0625)
    PRM_UPSCALES = (1, 2, 4, 8)

    def __init__(self, num_cls: int = 4, basic_dims: int = 8,
                 mask_type: str = "idt"):
        super().__init__()
        if basic_dims < 4:
            raise ValueError(f"RFNet needs basic_dims >= 4 (its PRM "
                             f"embedding has basic_dims // 4 channels), got "
                             f"{basic_dims}")
        self.num_cls, self.mask_type = num_cls, mask_type
        self.encoders = GroupedEncoder(basic_dims, stages=4)
        self.decoder_sep = DecoderSep(num_cls, basic_dims, scales=4)
        self.decoder_fuse = DecoderFuse(num_cls, basic_dims)

    def encode(self, x: torch.Tensor, mask: torch.Tensor):
        """Four flat scales (B, 4*C_k, ...), masked in 'idt'
        (rfnet.py:293-307)."""
        if self.mask_type != "pdt":
            x = x * mask.to(x.dtype)[:, :, None, None, None]
            return tuple(mask_channels_lanes(f, mask[None])
                         for f in self.encoders(x))
        return self.encoders(x)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (B, 4, H, W, Z); mask: (B, 4) bool. Softmax (B, num_cls, ...)."""
        return torch.softmax(self.decoder_fuse(*self.encode(x, mask),
                                               mask[None]), dim=1)

    def features(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Mask-independent window features for the sweep: the encoder's
        four scales."""
        return self.encoders(x)

    def fuse_inference(self, fts, mask: torch.Tensor) -> torch.Tensor:
        """Fusion decode + softmax from `features`; mask (B, 4)."""
        return torch.softmax(self.decoder_fuse(*fts, mask[None]), dim=1)

    def train_losses(self, x: torch.Tensor, mask: torch.Tensor,
                     target: torch.Tensor, temp: float = 1.0,
                     use_passion: bool = True,
                     generator: torch.Generator | None = None) -> dict:
        """Training forward with in-graph per-sample losses
        (rfnet.py:339-425). x (B, 4, H, W, Z); mask (B, 4) bool; target
        (B, num_cls, H, W, Z) one-hot. `generator` is accepted for the
        train step's sake: RFNet has no dropout. Returns fuse_pred and the
        float32 loss columns prm_loss (B, 1), sep_loss, kl_loss,
        proto_loss, dist (B, 4)."""
        del generator
        feats = self.encode(x, mask)
        masks = unimodal_mask_stack(mask) if use_passion else mask[None]
        fuse_logits, prms, de_x1 = self.decoder_fuse(*feats, masks,
                                                     heads=True)
        sep = self.decoder_sep(*[split_modalities(f) for f in feats])
        return passion_outputs(
            fuse_logits, prms, de_x1, sep, mask, target,
            num_cls=self.num_cls, temp=temp, use_passion=use_passion,
            idt=self.mask_type != "pdt", weights=self.PRM_WEIGHTS,
            upscales=self.PRM_UPSCALES)
