"""Segmentation and distillation losses (copy of `passion_tpu/losses.py`,
channels-first).

Every `_bs` function returns per-sample (B, 1) losses so the train step
can re-weight them per modality. Inputs are (B, C, H, W, Z) and are upcast
to float32 at entry: the model may run in bf16, but sums over ~512k voxels
in bf16 lose the low bits that the preference signal (dist) is made of.
The batch-mean forms at the end return scalars, as the reference's.
`up_scale` upsamples probabilities trilinearly (align_corners=True) by that
integer factor before the loss, as the reference's `nn.Upsample` on softmax
outputs.
"""

from __future__ import annotations

import torch

from passion_tpu_torch.ops.resize import upsample_trilinear

CLAMP_MIN = 0.005  # probability clamp used throughout criterions.py
SPATIAL = (2, 3, 4)


def _maybe_upsample(p: torch.Tensor, up_scale: int) -> torch.Tensor:
    if up_scale and up_scale != 1:
        return upsample_trilinear(p, up_scale, align_corners=True)
    return p


def _f32(*tensors):
    return tuple(t.to(torch.float32) for t in tensors)


def dice_loss_bs(output: torch.Tensor, target: torch.Tensor,
                 num_cls: int = 4, eps: float = 1e-7,
                 up_scale: int = 1) -> torch.Tensor:
    """Soft multi-class dice loss, per sample. output: probabilities."""
    (output,) = _f32(output)
    output = _maybe_upsample(output, up_scale)
    target = target.to(output.dtype)
    num = (output * target).sum(dim=SPATIAL)  # (B, C)
    left = output.sum(dim=SPATIAL)
    right = target.sum(dim=SPATIAL)
    dice = (2.0 * num / (left + right + eps)).sum(dim=1)  # (B,)
    return (1.0 - dice / num_cls)[:, None]


def softmax_weighted_loss_bs(output: torch.Tensor, target: torch.Tensor,
                             num_cls: int = 4,
                             up_scale: int = 1) -> torch.Tensor:
    """Class-frequency-weighted cross entropy, per sample. output: probs."""
    (output,) = _f32(output)
    output = _maybe_upsample(output, up_scale)
    target = target.to(output.dtype)
    cls_sum = target.sum(dim=SPATIAL)  # (B, C)
    total = cls_sum.sum(dim=1, keepdim=True)  # (B, 1)
    weighted = 1.0 - cls_sum / total  # (B, C)
    logp = torch.log(output.clamp(CLAMP_MIN, 1.0))
    cross = -(weighted[:, :, None, None, None] * target * logp)
    # the reference sums over classes, then means over spatial dims only
    return cross.sum(dim=1).mean(dim=(1, 2, 3))[:, None]


def fuse_loss_bs(output: torch.Tensor, target: torch.Tensor,
                 num_cls: int = 4) -> torch.Tensor:
    """WCE + dice on the final fused softmax prediction (train.py:228)."""
    return (softmax_weighted_loss_bs(output, target, num_cls)
            + dice_loss_bs(output, target, num_cls))


def temp_kl_loss_bs(logit_s: torch.Tensor, logit_t: torch.Tensor,
                    target: torch.Tensor, num_cls: int = 4,
                    temp: float = 1.0, up_scale: int = 1) -> torch.Tensor:
    """Temperature-softmax KL(teacher || student) with T^2 scaling, per
    sample. `target` and `num_cls` are unused (reference API)."""
    del target, num_cls
    logit_s, logit_t = _f32(logit_s, logit_t)
    pred_s = torch.softmax(logit_s / temp, dim=1)
    pred_t = torch.softmax(logit_t / temp, dim=1)
    pred_s = _maybe_upsample(pred_s, up_scale).clamp(CLAMP_MIN, 1.0)
    pred_t = _maybe_upsample(pred_t, up_scale).clamp(CLAMP_MIN, 1.0)
    kl = (temp * temp) * pred_t * (torch.log(pred_t) - torch.log(pred_s))
    return kl.mean(dim=(1, 2, 3, 4))[:, None]


def _safe_norm(x: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    """max(||x||, eps) with a NaN-free gradient at x == 0: sqrt(max(sum x^2,
    eps^2)) never differentiates sqrt at 0, and zero vectors arise routinely
    from fully-masked modality paths."""
    return torch.sqrt(torch.clamp_min((x * x).sum(dim=dim), eps * eps))


def prototype_passion_loss_bs(feature_s: torch.Tensor,
                              feature_t: torch.Tensor, target: torch.Tensor,
                              logit_s: torch.Tensor, logit_t: torch.Tensor,
                              num_cls: int = 4, temp: float = 1.0):
    """Prototype similarity-map distillation loss and preference distance,
    per sample: (proto_loss (B, 1), dist (B, 1)).

    Class prototypes are masked averages of the (B, C, H, W, Z) features
    over each class's region of the one-hot (B, K, H, W, Z) target; the loss
    is the MSE between student and teacher cosine-similarity maps, `dist`
    the mean absolute gap. A class takes part only if every batch element
    contains it (criterions.py:155-157); the means divide by the number of
    included classes, and with none included both are zero. The logits and
    `temp` are unused (reference API)."""
    del logit_s, logit_t, temp
    eps = 1e-5
    target = target[:, :num_cls].to(torch.float32)
    feature_s, feature_t = _f32(feature_s, feature_t)

    cls_count = target.sum(dim=SPATIAL)  # (B, K)
    include = (cls_count > 0).all(dim=0)  # (K,)
    n_incl = include.to(torch.float32).sum()

    def sim_maps(feature):
        proto = torch.einsum("bchwz,bkhwz->bkc", feature, target) / (
            cls_count[:, :, None] + eps)
        fn = _safe_norm(feature, 1, eps)  # (B, H, W, Z)
        pn = _safe_norm(proto, -1, eps)  # (B, K)
        dots = torch.einsum("bchwz,bkc->bkhwz", feature, proto)
        return dots / (fn[:, None] * pn[:, :, None, None, None])

    diff = sim_maps(feature_s) - sim_maps(feature_t)  # (B, K, H, W, Z)
    incl = include.to(torch.float32)[None, :, None, None, None]
    denom = torch.clamp_min(n_incl, 1.0) * diff[0, 0].numel()
    proto_loss = (diff.square() * incl).sum(dim=(1, 2, 3, 4)) / denom
    dist = (diff.abs() * incl).sum(dim=(1, 2, 3, 4)) / denom
    return proto_loss[:, None], dist[:, None]


# Batch-mean forms, kept for API parity with criterions.py:11-23, 40-57,
# 79-90, 106-142 (`passion_tpu/losses.py:196-233`). The train step uses
# only the per-sample forms above. As in the JAX package, `dice_loss` and
# `softmax_weighted_loss` take their own sums over the batch and run in
# the input's dtype.

def dice_loss(output: torch.Tensor, target: torch.Tensor, num_cls: int = 4,
              eps: float = 1e-7, up_scale: int = 1) -> torch.Tensor:
    """Soft dice over the whole batch: each class's sums run over the
    batch and the voxels together. output: probabilities."""
    output = _maybe_upsample(output, up_scale)
    target = target.to(output.dtype)
    dims = (0,) + SPATIAL
    num = (output * target).sum(dim=dims)  # (C,)
    left = output.sum(dim=dims)
    right = target.sum(dim=dims)
    dice = (2.0 * num / (left + right + eps)).sum()
    return 1.0 - dice / num_cls


def softmax_weighted_loss(output: torch.Tensor, target: torch.Tensor,
                          num_cls: int = 4,
                          up_scale: int = 1) -> torch.Tensor:
    """Class-frequency-weighted cross entropy, the mean over the batch and
    the voxels of its per-voxel class sums. output: probabilities."""
    output = _maybe_upsample(output, up_scale)
    target = target.to(output.dtype)
    cls_sum = target.sum(dim=SPATIAL)  # (B, C)
    weighted = 1.0 - cls_sum / cls_sum.sum(dim=1, keepdim=True)
    logp = torch.log(output.clamp(CLAMP_MIN, 1.0))
    cross = -(weighted[:, :, None, None, None] * target * logp)
    return cross.sum(dim=1).mean()


def temp_kl_loss(logit_s: torch.Tensor, logit_t: torch.Tensor,
                 target: torch.Tensor, num_cls: int = 4, temp: float = 1.0,
                 up_scale: int = 1) -> torch.Tensor:
    """The batch mean of `temp_kl_loss_bs`."""
    return temp_kl_loss_bs(logit_s, logit_t, target, num_cls, temp,
                           up_scale).mean()


def prototype_passion_loss(feature_s: torch.Tensor, feature_t: torch.Tensor,
                           target: torch.Tensor, logit_s: torch.Tensor,
                           logit_t: torch.Tensor, num_cls: int = 4,
                           temp: float = 1.0):
    """The batch means of both outputs of `prototype_passion_loss_bs`:
    (proto_loss, dist) scalars."""
    proto, dist = prototype_passion_loss_bs(feature_s, feature_t, target,
                                            logit_s, logit_t, num_cls, temp)
    return proto.mean(), dist.mean()
