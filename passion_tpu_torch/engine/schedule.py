"""Learning-rate schedules and the AdamW-AMSGrad optimizer (counterpart of
`passion_tpu/engine/schedule.py`, which imports optax; this is a copy).

`lr_at_epoch` gives the four epoch-indexed modes of the reference
`LR_Scheduler` (utils/lr_scheduler.py:8-43), including its `round(x, 8)`.
Training uses 'poly' (power 0.9). `get_temperature` is the reference's
unused temperature schedule.

`AdamWAMSGrad` is the JAX package's optimizer, `optax.scale_by_amsgrad ->
add_decayed_weights -> scale_by_learning_rate` (schedule.py:64-82), update
for update:

    mu = b1 mu + (1 - b1) g          nu = b2 nu + (1 - b2) g^2
    mu^ = mu / (1 - b1^t)            nu^ = nu / (1 - b2^t)
    nu_max = max(nu_max, nu^)        p -= lr (mu^ / (sqrt(nu_max) + eps) + wd p)

Departure from upstream PyTorch AdamW, recorded and kept: the running
maximum is taken over the bias-corrected second moment nu^, as optax does.
`torch.optim.AdamW(amsgrad=True)`, which the reference trains with
(train.py:96), keeps the maximum of the raw nu and bias-corrects it
afterwards; the two agree at step 1 and drift from step 2 on (with lr
2e-4, wd 1e-4 and gradients [1, .5] -> [0, .5] -> [.1, .5], the shrinking
coordinate moves by -2.948e-4 here against -3.339e-4 in torch at step 2).
The port follows the JAX package, its reference. The weight decay is added
to the update, not applied as a separate multiply, which is the same
arithmetic as torch's decoupled decay up to rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lr_at_epoch(epoch: int, base_lr: float, num_epochs: int,
                mode: str = "poly", warmup: int = 100) -> float:
    e = float(epoch)
    n = float(num_epochs)
    if mode == "poly":
        lr = base_lr * np.power(1 - e / n, 0.9)
    elif mode == "warmup":
        if epoch < warmup * 2:
            lr = 0.5 * base_lr * (1.0 + math.cos((e / warmup) * math.pi))
        else:
            lr = base_lr * np.power(1 - (e - warmup * 2) / (n - warmup * 2),
                                    0.9)
    elif mode == "cousinewarmup":
        if warmup == 0:
            if epoch < 100:
                lr = base_lr * math.sin((e / 200.0) * math.pi)
            else:
                lr = 0.5 * base_lr * (1.0 + math.cos(
                    ((e - 100.0) / (n - 100.0)) * math.pi))
        else:
            if epoch < warmup * 2:
                lr = 0.5 * base_lr * (1.0 + math.cos((e / warmup) * math.pi))
            else:
                lr = 0.5 * base_lr * (1.0 + math.cos(
                    ((e - warmup * 2) / (n - warmup * 2)) * math.pi))
    elif mode == "warmuppoly":
        if epoch < 100:
            lr = base_lr * (e / 100.0)
        else:
            lr = base_lr * np.power(1 - (e - 100.0) / (n - 100.0), 0.9)
    else:
        raise ValueError(f"unknown LR mode {mode!r}")
    return round(float(lr), 8)


def get_temperature(epoch: int) -> int:
    """Linear 30 -> 1 temperature decay over the first 30 epochs
    (utils/lr_scheduler.py:45-49; the reference's drivers pass the
    constant `--temp` instead)."""
    return 31 - (epoch + 1) if epoch <= 29 else 1


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.int32(count))


class AdamWAMSGrad(torch.optim.Optimizer):
    """AdamW with AMSGrad in optax's form (module docstring). The state of
    each parameter is `mu`, `nu`, `nu_max` (tensors like it) and `count`
    (the number of updates made). As in optax, every parameter is updated
    at every step: one without a gradient counts as a zero gradient (and
    still decays)."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = list(group["params"])
            for p in params:
                if not self.state[p]:
                    self.state[p] = dict(count=0,
                                         mu=torch.zeros_like(p),
                                         nu=torch.zeros_like(p),
                                         nu_max=torch.zeros_like(p))
            states = [self.state[p] for p in params]
            count = states[0]["count"] + 1
            if any(s["count"] + 1 != count for s in states):
                raise RuntimeError("parameters of one group at different "
                                   "update counts")
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            mus = [s["mu"] for s in states]
            nus = [s["nu"] for s in states]
            nu_maxs = [s["nu_max"] for s in states]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            mu_hat = torch._foreach_div(mus, _bias_correction(b1, count))
            nu_hat = torch._foreach_div(nus, _bias_correction(b2, count))
            torch._foreach_maximum_(nu_maxs, nu_hat)
            denom = torch._foreach_sqrt(nu_maxs)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(mu_hat, denom)
            torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, upd, alpha=-group["lr"])
            for s in states:
                s["count"] = count
        return loss


def make_optimizer(params, weight_decay: float = 1e-4, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> AdamWAMSGrad:
    """The optimizer of train.py:96 in the JAX package's form; the learning
    rate is set per epoch with `set_learning_rate`."""
    return AdamWAMSGrad(params, lr=0.0, betas=(b1, b2), eps=eps,
                        weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
