"""Legacy losses the reference ships but never wires (counterpart of
`passion_tpu/losses_legacy.py`; the tail of code/utils/criterions.py and
utils/lr_scheduler.py).

* `softmax_loss`       criterions.py:208-219: clamped cross-entropy summed
  over classes, then a global mean;
* `focal_loss`         criterions.py:221-240: the focal factor applies to
  the MEAN cross-entropy (`F.cross_entropy` reduces before `pt` is
  formed), so it is one scalar gate; `alpha` is accepted and ignored, as
  in the reference;
* `dice`               criterions.py:242-247: global soft dice, eps in the
  denominator only;
* `sigmoid_dice_loss`  criterions.py:249-257: three one-vs-rest channels
  against labels {1, 2, 4};
* `softmax_dice_loss`  criterions.py:260-267: channels 1..3 of a 4-class
  softmax against labels {1, 2, 4};
* `prototype_pmr_loss` criterions.py:183-206: the prototype-distribution
  loss over the classes present in every sample (a masked softmax);
* `js_div`, `mutual_learning_loss` lr_scheduler.py:71-88; the reference's
  `mutual_learning_loss` forgets its return statement, this one returns
  the per-sample vector it computes.

Dense inputs are (B, C, H, W, Z); integer label volumes (B, H, W, Z). Every
reduction runs in float32.
"""

from __future__ import annotations

import torch

CLAMP_MIN = 0.005  # the probability clamp of criterions.py


def softmax_loss(output: torch.Tensor, target: torch.Tensor,
                 num_cls: int = 5) -> torch.Tensor:
    """Mean over voxels of -sum_c t_c log(clamp(p_c)); output probabilities
    and one-hot target (B, C, H, W, Z)."""
    o = output.float()[:, :num_cls]
    t = target.float()[:, :num_cls]
    return (-t * torch.log(o.clamp(CLAMP_MIN, 1.0))).sum(dim=1).mean()


def focal_loss(output: torch.Tensor, target: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss of logits (B, C, H, W, Z) against integer labels
    (B, H, W, Z), 4 relabelled to 3, in the reference's reduction order:
    logpt = -mean cross-entropy, then -(1 - exp(logpt))^gamma logpt."""
    del alpha  # accepted and ignored, as in the reference
    t = torch.where(target == 4, 3, target).long()
    logp = torch.log_softmax(output.float(), dim=1)
    logpt = logp.gather(1, t[:, None])[:, 0].mean()
    return -((1.0 - torch.exp(logpt)) ** gamma) * logpt


def dice(output: torch.Tensor, target: torch.Tensor,
         eps: float = 1e-5) -> torch.Tensor:
    """1 - 2 sum(o t) / (sum(o) + sum(t) + eps) over all elements."""
    o, t = output.float(), target.float()
    return 1.0 - 2.0 * (o * t).sum() / (o.sum() + t.sum() + eps)


def sigmoid_dice_loss(output: torch.Tensor, target: torch.Tensor,
                      alpha: float = 1e-5) -> torch.Tensor:
    """Channels 0, 1, 2 of (B, 3, H, W, Z) against labels 1, 2, 4."""
    return sum(dice(output[:, c], target == lab, eps=alpha)
               for c, lab in enumerate((1, 2, 4)))


def softmax_dice_loss(output: torch.Tensor, target: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Channels 1, 2, 3 of a (B, 4, H, W, Z) softmax against labels 1, 2,
    4, each with `dice`'s own eps: the reference accepts `eps` and never
    forwards it."""
    del eps
    return sum(dice(output[:, c], target == lab)
               for c, lab in ((1, 1), (2, 2), (3, 4)))


def prototype_pmr_loss(feature_s, feature_t, target, logit_s=None,
                       logit_t=None, num_cls: int = 5, temp: float = 1.0,
                       up_op=None):
    """Prototype-distribution loss. feature_s (B, C, H, W, Z); target
    one-hot (B, K, H, W, Z); feature_t, the logits, temp and up_op are
    accepted and unused, as in the reference. Only classes present in
    every sample take part: the softmax of the negative L2 distances to
    the per-sample class prototypes runs over them, and each voxel reads
    its true class's probability. Returns (clamped NLL, mean true-class
    probability); NaN when no class is present in every sample."""
    eps = 1e-5
    f = feature_s.float()
    t = target.float()[:, :num_cls]
    tsum = t.sum(dim=(2, 3, 4))  # (B, K)
    keep = (tsum > 0).all(dim=0)  # (K,)
    proto = torch.einsum("bchwz,bkhwz->bkc", f, t) / (tsum[..., None] + eps)
    d2 = ((f * f).sum(dim=1)[:, None]
          - 2.0 * torch.einsum("bchwz,bkc->bkhwz", f, proto)
          + (proto * proto).sum(dim=-1)[:, :, None, None, None])
    dist_map = -torch.sqrt(d2.clamp_min(0.0))
    keep5 = keep[None, :, None, None, None]
    soft = torch.softmax(dist_map.masked_fill(~keep5, float("-inf")), dim=1)
    proto_distri = (torch.where(keep5, soft, 0.0) * t).sum(dim=1)
    proto_loss = -torch.log(proto_distri.clamp(CLAMP_MIN, 1.0)).mean()
    return proto_loss, proto_distri.mean()


def js_div(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence with `KLDivLoss('mean')`'s reduction: each
    KL term is a mean over all elements."""
    p, q = p.float(), q.float()
    logm = torch.log((p + q) / 2.0)
    return ((p * (torch.log(p) - logm)).mean()
            + (q * (torch.log(q) - logm)).mean()) / 2.0


def mutual_learning_loss(mutual_feats, mask) -> torch.Tensor:
    """Pairwise-modality JS mutual-learning loss. mutual_feats: sequence of
    (B, M, C, ...) per-modality stacks, softmaxed over C; mask (B, M) bool.
    Per sample, the JS divergences of its present-modality pairs summed
    over all scales, over 2 K (K - 1); 0 where K <= 1. Returns (B,)."""
    mutual_feats = [torch.as_tensor(f) for f in mutual_feats]
    mask = torch.as_tensor(mask, device=mutual_feats[0].device).float()
    b, m = mask.shape
    total = torch.zeros((b,), device=mask.device)
    for feats in mutual_feats:
        feats = torch.softmax(feats.float(), dim=2)
        red = tuple(range(1, feats.dim() - 1))
        for k in range(m):
            for k1 in range(k + 1, m):
                p, q = feats[:, k], feats[:, k1]
                logm = torch.log((p + q) / 2.0)
                js = ((p * (torch.log(p) - logm)).mean(dim=red)
                      + (q * (torch.log(q) - logm)).mean(dim=red)) / 2.0
                total = total + mask[:, k] * mask[:, k1] * js
    k_count = mask.sum(dim=1)
    denom = 2.0 * k_count * (k_count - 1.0)
    return torch.where(k_count > 1, total / denom.clamp_min(1.0), 0.0)
