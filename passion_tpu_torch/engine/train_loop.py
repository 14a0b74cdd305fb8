"""PASSION training: the train step and the epoch loop (counterpart of
`passion_tpu/engine/train_loop.py`).

One call of the step does the whole iteration of the reference's
train.py:198-335:

  * the model's training forward (`train_losses`: 5 fuse lanes, the shared
    per-modality decoder, per-sample losses) in bf16 over float32 master
    params;
  * the fuse loss on the fused prediction (train.py:228-229);
  * per-modality loss sums gated by the batch's modality mask
    (train.py:260-263);
  * the task-wise preference gate rp_mask = rp_iter > 0 from the batch's
    prototype distances (train.py:265-268);
  * the PASSION loss with its warmup branch (train.py:274-280):
      warmup: loss = sum(beta * w * sep_m)
      else:   loss = fuse + sum(rp_mask * beta * w * sep_m) + prm
                    + 0.5 * sum(beta * w * kl_m)
                    + 0.1 * sum(rp_mask * w * proto_m)
  * backward and the AdamW-AMSGrad update (engine/schedule.py).

What changes per epoch stays on the host and is passed in, as in the
reference: the preference vector `imb_beta` (train.py:325-335), the IDT
inverse-frequency weights `modal_weight` (train.py:163-171) and the
learning rate.

NaN-faithfulness: an IDT sample whose mask is one modality has an all-zero
prototype distance row (`zero_unimodal_self_dist`), so the reference's
dist/dist_avg is 0/0 = NaN, which makes rp_mask all-False for the
iteration. The step writes that NaN explicitly with `torch.where`. Padded
rows (valid = 0) are dropped with `torch.where` too, never a multiply,
which would turn a padded row's NaN into a NaN sum.

Validation (`make_val_step`, `run_validation`, `fit` with `use_valid`)
scores every validation batch under all 15 masks and keeps `model_best.pt`.

Data parallelism (`world`, parallel/world.py) computes what the JAX
package's mesh computes: the gradient of the sum of per-sample losses over
one global batch. Each rank runs its rows of the global batch, padded to a
multiple of the world size with valid = 0 rows. The preference gate is a
property of the global batch, so rp_iter is summed over the ranks before
rp_mask = rp_iter > 0 (a NaN row on one rank closes the gate on all). The
gradients are summed over the ranks (not averaged), then every rank makes
the same update; the metrics are summed once per step, as one packed
tensor. Dropout draws from a generator per rank seeded with seed + rank,
so its masks cannot match the single-process run's.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from passion_tpu_torch import losses, resolve_device
from passion_tpu_torch.engine import checkpoint as ckpt
from passion_tpu_torch.engine.schedule import (lr_at_epoch, make_optimizer,
                                               set_learning_rate)
from passion_tpu_torch.masks import MASK_ARRAY, MASK_NAMES
from passion_tpu_torch.models import init_model
from passion_tpu_torch.parallel.world import GradBuffer

NUM_MODALS = 4
SCALARS = ("loss", "fuse_loss", "prm_loss", "sep_loss", "kl_loss",
           "proto_loss")
VECTORS = ("sep_m", "kl_m", "proto_m", "dist_m")


class _TrainForward(nn.Module):
    """`model.train_losses` as a module's forward, for `functional_call`."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.train_losses(*args, **kwargs)


def _train_forward(model: nn.Module, compute_dtype: torch.dtype | None):
    """`model.train_losses` on a `compute_dtype` copy of the float32 params
    made inside the graph (as the JAX package's `cast`), so gradients land
    in float32 on the master params; `None` runs float32."""
    wrapped = _TrainForward(model)

    def forward(x, *args, **kwargs):
        if compute_dtype is None:
            return model.train_losses(x, *args, **kwargs)
        cast = {f"model.{k}": v.to(compute_dtype)
                for k, v in model.named_parameters()}
        return functional_call(wrapped, cast,
                               (x.to(compute_dtype),) + args, kwargs)

    return forward


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    use_passion: bool, num_cls: int = 4,
                    with_dropout: bool = False,
                    compute_dtype: torch.dtype | None = torch.bfloat16,
                    world=None):
    """Build the train step (train_loop.py:58-180).

    Returns step(batch, imb_beta, modal_weight, temp, generator=None,
    warmup=False) -> metrics, which updates `model`'s params through
    `optimizer` in place. batch: x (B, 4, H, W, Z) float32, target
    (B, num_cls, H, W, Z) one-hot, mask (B, 4) bool, optional valid (B,)
    (0 marks a padded row), all on the model's device; imb_beta and
    modal_weight (4,) float32 tensors there too. `generator` draws the
    dropout masks when `with_dropout`.

    Mixed precision: the forward and backward run on a `compute_dtype`
    copy of the float32 params made inside the graph (as the JAX package's
    `cast`), so the gradients land in float32 on the master params; every
    loss upcasts to float32. `compute_dtype=None` gives a float32 step.

    `world` (parallel.world.World): the batch holds this rank's rows of the
    global batch; rp_iter, the gradients and the metrics are summed over
    the ranks (module docstring), so every rank returns the global metrics
    and makes the same update.
    """
    idt = model.mask_type != "pdt"
    train_forward = _train_forward(model, compute_dtype)
    grads = GradBuffer(model.parameters(), world) if world is not None \
        else None

    def forward(x, mask, target, temp, generator):
        return train_forward(x, mask, target, temp, use_passion,
                             generator=generator if with_dropout else None)

    def step(batch, imb_beta, modal_weight, temp, generator=None,
             warmup: bool = False) -> dict:
        x, target, mask = batch["x"], batch["target"], batch["mask"]
        mask_f = mask.to(torch.float32)
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones((x.shape[0],), device=x.device)
        vrow = valid[:, None] > 0

        def drop_padded(a):
            return torch.where(vrow, a.to(torch.float32), 0.0)

        optimizer.zero_grad(set_to_none=True)
        out = forward(x, mask, target, float(temp), generator)
        fuse_bs = losses.fuse_loss_bs(out["fuse_pred"], target, num_cls)
        fuse_loss = drop_padded(fuse_bs).sum()
        prm_loss = drop_padded(out["prm_loss"]).sum()

        gate = mask_f if idt else torch.ones_like(mask_f)
        sep_m = drop_padded(out["sep_loss"] * gate).sum(dim=0)
        kl_m = drop_padded(out["kl_loss"] * gate).sum(dim=0)
        proto_m = drop_padded(out["proto_loss"] * gate).sum(dim=0)
        dist_m = drop_padded(out["dist"] * gate).sum(dim=0)

        # task-wise preference (train.py:239-242 pdt / 265-268 idt); a row
        # with dist_avg == 0 is NaN (module docstring)
        dist_bs = out["dist"].detach().to(torch.float32)  # (B, 4)
        if idt:
            dist_avg = dist_bs.sum(dim=1) / mask_f.sum(dim=1)
            rp_rows = mask_f * (dist_bs / dist_avg[:, None] - 1.0)
        else:
            dist_avg = dist_bs.mean(dim=1)
            rp_rows = dist_bs / dist_avg[:, None] - 1.0
        rp_rows = torch.where((dist_avg == 0.0)[:, None], float("nan"),
                              rp_rows)
        rp_iter = drop_padded(rp_rows).sum(dim=0)
        if world is not None:  # the gate belongs to the global batch
            world.all_reduce_(rp_iter)
        rp_mask = (rp_iter > 0).to(torch.float32)

        w = modal_weight if idt else torch.ones_like(modal_weight)
        if use_passion:
            kl_loss = (imb_beta * w * kl_m).sum()
            proto_loss = (rp_mask * w * proto_m).sum()
            if warmup:
                sep_loss = (imb_beta * w * sep_m).sum()
                loss = sep_loss
            else:
                sep_loss = (rp_mask * imb_beta * w * sep_m).sum()
                loss = (fuse_loss + sep_loss + prm_loss + 0.5 * kl_loss
                        + 0.1 * proto_loss)
        else:
            kl_loss = torch.zeros((), device=x.device)
            proto_loss = torch.zeros((), device=x.device)
            sep_loss = sep_m.sum()
            loss = sep_loss if warmup else fuse_loss + sep_loss + prm_loss

        loss.backward()
        if grads is not None:
            grads.all_reduce_()
        optimizer.step()
        metrics = dict(loss=loss, fuse_loss=fuse_loss, prm_loss=prm_loss,
                       sep_loss=sep_loss, kl_loss=kl_loss,
                       proto_loss=proto_loss, sep_m=sep_m, kl_m=kl_m,
                       proto_m=proto_m, dist_m=dist_m)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if world is not None:  # each term is linear in the rows' losses
            metrics = _sum_metrics(metrics, world)
        metrics["rp_iter"] = rp_iter.detach()
        return metrics

    return step


def _sum_metrics(metrics: dict, world) -> dict:
    """Every metric summed over the ranks in one all-reduce."""
    names = list(metrics)
    packed = world.all_reduce_(torch.cat([metrics[k].reshape(-1).float()
                                          for k in names]))
    out, off = {}, 0
    for k in names:
        n = metrics[k].numel()
        out[k] = packed[off:off + n].reshape(metrics[k].shape)
        off += n
    return out


def make_val_step(model: nn.Module, num_cls: int = 4,
                  compute_dtype: torch.dtype | None = torch.bfloat16):
    """Validation scoring step (train_loop.py:183-219): the training
    forward without PASSION and without dropout, under `torch.no_grad`,
    on the same `compute_dtype` copy of the params as the train step.

    Returns val_step(x, mask, target, temp) -> the batch mean of the
    per-sample fuse_loss + sum_k sep[:, k] + prm, a float32 scalar tensor
    on the device (read back by `run_validation`). The JAX package's
    rebuild of the reference's disabled `--use_valid` loop: the score is a
    relative model-selection signal."""
    train_forward = _train_forward(model, compute_dtype)

    @torch.no_grad()
    def val_step(x, mask, target, temp):
        out = train_forward(x, mask, target, float(temp), False)
        fuse = losses.fuse_loss_bs(out["fuse_pred"], target, num_cls)
        loss_b = (fuse.float()[:, 0] + out["sep_loss"].float().sum(dim=1)
                  + out["prm_loss"].float()[:, 0])
        return loss_b.mean()

    return val_step


VAL_RING = 4  # validation batches in flight at most


def _losses_to_host(losses_dev: torch.Tensor) -> np.ndarray:
    """A batch's 15 validation losses, read back (waits for the card)."""
    return losses_dev.cpu().numpy().astype(np.float64)


def run_validation(val_step, model: nn.Module, val_loader, temp,
                   iters: int | None = None, world=None) -> np.ndarray:
    """One validation sweep (train_loop.py:222-265): every batch under each
    of the 15 masks of `MASK_ARRAY` (not the dataset's own mask). Returns
    scores (15,) float64 with scores[j] the accumulated negative loss of
    mask j (higher is better), the reference's
    `score_modality[j] -= loss.item()`.

    The 15 losses of a batch are queued without reading any back; they are
    read as one tensor before batch k + VAL_RING is staged, so the card
    never waits on the host between masks and at most VAL_RING batches
    are on the card. With `world`, rank r scores batches r, r + size, ...
    of the first `iters` and the scores are summed over the ranks, so every
    rank gets the same scores."""
    device = next(model.parameters()).device
    n = iters or len(val_loader)
    scores = np.zeros((len(MASK_ARRAY),), np.float64)
    masks = torch.as_tensor(MASK_ARRAY, device=device)
    ring: list[torch.Tensor] = []

    def drain_one():
        scores[:] -= _losses_to_host(ring.pop(0))

    for i, batch in enumerate(val_loader):
        if i >= n:
            break
        if world is not None and i % world.size != world.rank:
            continue
        x = torch.from_numpy(np.asarray(batch["x"], np.float32)).to(device)
        target = torch.from_numpy(np.asarray(batch["target"],
                                             np.float32)).to(device)
        b = x.shape[0]
        ring.append(torch.stack([val_step(x, m.expand(b, m.shape[0]),
                                          target, temp) for m in masks]))
        if len(ring) >= VAL_RING:
            drain_one()
    while ring:
        drain_one()
    if world is not None:
        total = torch.from_numpy(scores).to(world.device)
        scores = world.all_reduce_(total).cpu().numpy()
    return scores


def update_imb_beta(imb_beta, eta, epoch_dist_m, epoch, warmup_epochs):
    """Per-epoch gradient-wise preference update (train.py:325-335).

    Returns (new_beta (4,), new_eta, rp_epoch (4,))."""
    epoch_dist_avg = float(np.sum(epoch_dist_m) / 4.0)
    rp_epoch = (epoch_dist_avg - np.asarray(epoch_dist_m)) / epoch_dist_avg
    if epoch < warmup_epochs:
        return imb_beta, eta, rp_epoch
    if epoch % 100 == 0:
        eta = eta * 1.5
    beta = np.asarray(imb_beta) - eta * rp_epoch
    beta = np.clip(beta, 0.1, 4.0)
    beta = 2.0 * beta / np.sqrt(np.sum(beta ** 2))
    return beta, eta, rp_epoch


def _to_device(batch: dict, bp: int, device: torch.device,
               world=None) -> dict:
    """Host batch -> device tensors, ragged batches padded to `bp` rows by
    repeating sample 0 with valid = 0 (so the step keeps one shape and the
    padding counts in no loss). With `world`, `bp` is rounded up to a
    multiple of the world size and only this rank's block of rows goes to
    the device (train_loop.py:427-436)."""
    b = batch["x"].shape[0]
    if world is not None:
        bp = -(-bp // world.size) * world.size
    arrays = {"x": batch["x"].astype(np.float32),
              "target": batch["target"].astype(np.float32),
              "mask": np.asarray(batch["mask"], bool),
              "valid": np.ones((b,), np.float32)}
    if bp != b:
        idx = np.concatenate([np.arange(b), np.zeros((bp - b,), np.int64)])
        arrays = {k: v[idx] for k, v in arrays.items()}
        arrays["valid"][b:] = 0.0
    if world is not None:
        k = bp // world.size
        arrays = {n: v[world.rank * k:(world.rank + 1) * k]
                  for n, v in arrays.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def fit(model: nn.Module, train_loader, cfg, modal_num=None, writer=None,
        device="cuda", val_loader=None, world=None):
    """The PASSION epoch loop (train.py:177-373; JAX train_loop.py:285-505),
    bf16 over float32 master params, dropout on for mmFormer and M2FTrans
    (RFNet has none).

    model: backbone (mask_type set), initialised here with
      `models.init_model(model, cfg.seed)` and moved to `device`.
    train_loader: PrefetchLoader over a training dataset (channels-first
      x and one-hot target).
    cfg: TrainConfig-like (lr, weight_decay, num_epochs, temp,
      region_fusion_start_epoch, use_passion, mask_type, savepath, seed,
      resume, use_pretrain, batch_size, iters_per_epoch, use_valid).
    modal_num: (4,) per-modality present counts of the imb-MR CSV.
    val_loader: loader over `BratsVal`; with `cfg.use_valid` every epoch
      ends with the 15-mask validation sweep, and `model_best.pt` is written
      when an epoch beats the best score so far.
    world: parallel.world.World to train data-parallel (the model on
      `world.device`, which replaces `device`). Every rank iterates the
      same loader (same seed, so the global sample order is the
      single-process run's) and runs its block of rows; only rank 0 writes
      checkpoints (pass `writer` on rank 0 only). Every rank initialises
      the same params from the seed, or loads the same file on a resume.

    Returns (model, optimizer, history).
    """
    device = world.device if world is not None else resolve_device(device)
    main = world is None or world.is_main
    init_model(model, cfg.seed).to(device)
    if cfg.resume and cfg.use_pretrain:
        taken = ckpt.load_pretrained_params(cfg.resume, model)
        logging.info("loaded %d of %d tensors from %s", len(taken),
                     len(model.state_dict()), cfg.resume)

    optimizer = make_optimizer(model.parameters(), cfg.weight_decay)
    start_epoch = 0
    if cfg.resume and not cfg.use_pretrain and os.path.exists(cfg.resume):
        state = ckpt.load_checkpoint(cfg.resume)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        start_epoch = int(state["epoch"]) + 1
        logging.info("resumed from %s at epoch %d", cfg.resume, start_epoch)

    with_dropout = type(model).__name__ != "RFNet"
    step = make_train_step(model, optimizer, cfg.use_passion, model.num_cls,
                           with_dropout=with_dropout, world=world)
    # one dropout stream per rank (module docstring)
    generator = torch.Generator(device=device).manual_seed(
        cfg.seed + (world.rank if world is not None else 0))

    iter_per_epoch = getattr(cfg, "iters_per_epoch", None) or len(
        train_loader)
    if modal_num is None:
        modal_num = np.full((NUM_MODALS,), max(iter_per_epoch, 1),
                            np.float64)
    modal_num = np.asarray(modal_num, np.float64)
    modal_weight = (iter_per_epoch / modal_num).astype(np.float32)
    logging.info(
        "Training Imperfect Datasets with Mod.Flair-%d, Mod.T1c-%d, "
        "Mod.T1-%d, Mod.T2-%d", *[int(v) for v in modal_num])
    modal_weight_t = torch.from_numpy(modal_weight).to(device)

    imb_beta = np.ones((NUM_MODALS,), np.float32)
    eta = 0.01
    history = []
    use_valid = bool(getattr(cfg, "use_valid", False)) and \
        val_loader is not None
    if use_valid:
        val_step = make_val_step(model, model.num_cls)
        best_score, best_epoch = None, start_epoch
    tag = "PASSION" if cfg.use_passion else "NO-PASSION"
    logging.info("#############%s-%s-Training############", tag,
                 cfg.mask_type.upper())
    start = time.time()
    for epoch in range(start_epoch, cfg.num_epochs):
        step_lr = lr_at_epoch(epoch, cfg.lr, cfg.num_epochs)
        set_learning_rate(optimizer, step_lr)
        if writer:
            writer.add_scalar("lr", step_lr, epoch + 1)
        warmup = epoch < cfg.region_fusion_start_epoch
        acc = {k: 0.0 for k in SCALARS}
        acc_m = {k: np.zeros(NUM_MODALS) for k in VECTORS}
        # Per-modality epoch denominator: modal_num only for 'idt'; pdt and
        # idt_drop use iter_per_epoch (train.py:298-307).
        denom = modal_num if cfg.mask_type == "idt" else iter_per_epoch
        beta_t = torch.from_numpy(np.asarray(imb_beta, np.float32)).to(
            device)

        # Metrics are read two steps behind the launches, so the
        # per-iteration log line does not stall the card each step.
        pending: list[tuple[int, list, dict]] = []

        def drain(keep: int = 0):
            while len(pending) > keep:
                i_, names_, m_ = pending.pop(0)
                m_ = {k: v.cpu().numpy() for k, v in m_.items()}
                for k in acc:
                    acc[k] += float(m_[k]) / iter_per_epoch
                for k in acc_m:
                    acc_m[k] += m_[k] / denom
                msg = ("Epoch {}/{}, Iter {}/{}, Loss {:.4f}, "
                       "fuse_loss:{:.4f}, prm_loss:{:.4f}, sep_loss:{:.4f}, "
                       "kl_loss:{:.4f}, proto_loss:{:.4f},").format(
                    epoch + 1, cfg.num_epochs, i_ + 1, iter_per_epoch,
                    float(m_["loss"]), float(m_["fuse_loss"]),
                    float(m_["prm_loss"]), float(m_["sep_loss"]),
                    float(m_["kl_loss"]), float(m_["proto_loss"]))
                msg += "seplist:[{}] kllist:[{}] distlist:[{}] ".format(
                    ",".join(f"{v:.4f}" for v in m_["sep_m"]),
                    ",".join(f"{v:.4f}" for v in m_["kl_m"]),
                    ",".join(f"{v:.4f}" for v in m_["dist_m"]))
                msg += " ".join(f"{n:>20}," for n in names_)
                logging.info(msg)

        b0 = time.time()
        for i, batch in enumerate(train_loader):
            if i >= iter_per_epoch:
                break
            b = batch["x"].shape[0]
            bp = max(getattr(cfg, "batch_size", None) or b, b)
            m = step(_to_device(batch, bp, device, world), beta_t,
                     modal_weight_t, cfg.temp, generator, warmup)
            pending.append((i, list(batch["name"]), m))
            drain(keep=2)
        drain(keep=0)
        logging.info("train time per epoch: %s", time.time() - b0)

        if cfg.use_passion:
            imb_beta, eta, rp_epoch = update_imb_beta(
                imb_beta, eta, acc_m["dist_m"], epoch,
                cfg.region_fusion_start_epoch)
            logging.info("rp_epoch:[%s]",
                         ",".join(f"{v:.4f}" for v in rp_epoch))
            logging.info("imb_beta:[%s]",
                         ",".join(f"{v:.4f}" for v in imb_beta))
            if writer:
                for mm in range(NUM_MODALS):
                    writer.add_scalar(f"rp_m{mm}", rp_epoch[mm], epoch + 1)

        if writer:
            # the reference's TB tag set (train.py:342-354)
            for k, v in acc.items():
                writer.add_scalar(f"epoch_{k}es", v, epoch + 1)
            for mm in range(NUM_MODALS):
                for k in VECTORS:
                    writer.add_scalar(f"{k[:-2]}_m{mm}", acc_m[k][mm],
                                      epoch + 1)

        state = {"epoch": epoch, "model": model.state_dict(),
                 "optimizer": optimizer.state_dict()}
        if main:
            for path in ckpt.checkpoint_paths(cfg.savepath, epoch,
                                              cfg.num_epochs):
                ckpt.save_checkpoint(path, state)

        if use_valid:
            # 15-mask validation sweep -> model_best (train.py:468-544)
            b_val = time.time()
            logging.info("#############validation############")
            scores = run_validation(
                val_step, model, val_loader, cfg.temp,
                iters=getattr(cfg, "iters_per_epoch", None), world=world)
            score_avg = float(np.mean(scores))
            if best_score is None:
                # the reference's quirk, kept: the first validated epoch
                # sets best_score without writing model_best
                # (train.py:524-526)
                best_score, best_epoch = score_avg, epoch
            elif score_avg > best_score:
                best_score, best_epoch = score_avg, epoch
                if main:
                    ckpt.save_checkpoint(
                        os.path.join(cfg.savepath, "model_best.pt"), state)
            if writer:
                for z, name in enumerate(MASK_NAMES):
                    writer.add_scalar(name, scores[z], epoch + 1)
                writer.add_scalar("score_average", score_avg, epoch + 1)
            logging.info("epoch total score: %s", score_avg)
            logging.info("best score: %s", best_score)
            logging.info("best epoch: %d", best_epoch + 1)
            logging.info("validate time per epoch: %s", time.time() - b_val)

        history.append(dict(epoch=epoch, **acc,
                            imb_beta=np.asarray(imb_beta).tolist()))

    logging.info("total time: %.4f hours", (time.time() - start) / 3600)
    return model, optimizer, history
