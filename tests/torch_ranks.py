"""Rank programs for the data-parallel tests (tests/test_torch_parallel.py).

`parallel.world.launch` pickles the function each rank runs by its import
path, and a spawned rank imports that module again. The test modules import
JAX through tests/conftest.py, so the rank programs live here, in a module
that imports torch and the port only. Each rank writes what the test reads
to `out/rank{r}.pt`.
"""

import os

import numpy as np
import torch

from passion_tpu_torch.engine import schedule, train_loop
from passion_tpu_torch.engine.sliding_window import (SlidingWindowSweep,
                                                     coverage_weight)
from passion_tpu_torch.models import get_model, init_model

LR = 2e-4
BETA = (1.2, 0.8, 1.0, 0.9)  # imb_beta of the step
MODAL_W = (1.0, 1.5, 2.0, 3.0)  # modal_weight of the step


def build_model(spec: dict) -> torch.nn.Module:
    """The spec's backbone, with the weights of the state_dict file
    `spec["state"]` if it names one, else initialised from `spec["seed"]`."""
    model = get_model(spec["name"], mask_type="idt", patch_size=spec["patch"],
                      **spec["kw"])
    if spec.get("state"):
        model.load_state_dict(torch.load(spec["state"], weights_only=True),
                              strict=True)
        return model
    return init_model(model, seed=spec["seed"])


def run_step(model, batch: dict, world=None, warmup: bool = False) -> dict:
    """One float32 PASSION step at LR without dropout (the warmup branch if
    `warmup`): the metrics, the (summed) gradients before the update (zeros
    where a param has none, which `no_grad` names) and the params after
    it."""
    opt = schedule.make_optimizer(model.parameters(), 1e-4)
    schedule.set_learning_rate(opt, LR)
    step = train_loop.make_train_step(model, opt, True, compute_dtype=None,
                                      world=world)
    m = step(batch, torch.tensor(BETA), torch.tensor(MODAL_W), 4.0,
             warmup=warmup)
    named = list(model.named_parameters())
    return dict(metrics={k: v.clone() for k, v in m.items()},
                grads={n: torch.zeros_like(p) if p.grad is None
                       else p.grad.clone() for n, p in named},
                no_grad=[n for n, p in named if p.grad is None],
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})


def step_rank(world, out: str, jobs: dict) -> None:
    """For each job {tag: (spec, bp, warmup)}: this rank's rows of the saved global
    batch `{tag}_batch.pt` (padded to `bp` rows, then to a multiple of the
    world size, as `fit` does), one step of a fresh model."""
    results = {}
    for tag, (spec, bp, warmup) in jobs.items():
        host = torch.load(os.path.join(out, f"{tag}_batch.pt"),
                          weights_only=True)
        host = {k: v.numpy() for k, v in host.items()}
        batch = train_loop._to_device(host, bp, world.device, world)
        results[tag] = run_step(build_model(spec), batch, world, warmup)
        results[tag]["rows"] = int(batch["x"].shape[0])
    torch.save(results, os.path.join(out, f"rank{world.rank}.pt"))


def stall_rank(world, out: str, seconds: float) -> None:
    """A rank that does not finish in time."""
    import time

    time.sleep(seconds)


def sweep_rank(world, out: str, spec: dict, masks, window_batches) -> None:
    """The sharded float32 sweep of the saved volume at each window batch:
    this rank's chunks and every mask's labels and coverage-normalised
    probabilities, by window batch."""
    vol = np.load(os.path.join(out, "vol.npy"))
    model = build_model(spec)
    res = {}
    for wb in window_batches:
        engine = SlidingWindowSweep(model, 4, spec["patch"], window_batch=wb,
                                    compute_dtype=torch.float32, world=world)
        prepared = engine.prepare(vol)
        labels = engine.sweep_labels(prepared, masks)
        fts = engine.encode_case(prepared)
        wgt = torch.from_numpy(coverage_weight(prepared["eff"],
                                               prepared["eff"], engine.patch))
        res[wb] = dict(labels=labels, chunks=[
            len(c) for c in engine._rank_chunks(prepared)],
            probs=[engine.sum_masked(prepared, fts, m) / wgt for m in masks])
    torch.save(res, os.path.join(out, f"rank{world.rank}.pt"))
