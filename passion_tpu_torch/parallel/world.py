"""Process groups for data parallelism: the port's counterpart of
`passion_tpu/parallel/mesh.py`.

The JAX package shards the batch axis of one global batch over a 1-D mesh,
keeps the params replicated and lets XLA insert the gradient all-reduce.
Here each card runs in a process of its own (a rank), every rank holds the
whole model, and the train step and the sweep call the collectives
themselves (engine/train_loop.py, engine/sliding_window.py). NCCL carries
them on `cuda`, gloo on `cpu`.

`--data_parallel N` keeps the JAX meaning: 0 is one device and no process
group, -1 every visible card, N the first N cards (rank r on `cuda:r`).
Asking for more cards than are visible raises; nothing falls back to fewer
ranks or to the CPU. `launch` starts the ranks itself (spawned processes),
or, when `torchrun`'s environment is set, runs this process's own rank.

Every collective is bounded by the process group's timeout: a rank that
dies or hangs fails the others instead of leaving them waiting.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


@dataclass(frozen=True)
class World:
    """This process's rank among `size`, and the device it runs on."""

    rank: int
    size: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files and logs."""
        return self.rank == 0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t


def world_size_for(data_parallel: int, device: str = "cuda") -> int:
    """Ranks for `--data_parallel` on `device`: 0 -> 0 (one device, no
    process group), -1 -> every visible card, N -> N."""
    if data_parallel == 0:
        return 0
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        size = visible if data_parallel < 0 else data_parallel
        if visible == 0 or size > visible:
            raise RuntimeError(f"--data_parallel {data_parallel} asks for "
                               f"{size if size > 0 else 'every'} card(s), "
                               f"{visible} visible")
        return size
    if data_parallel < 0:
        raise ValueError("--data_parallel -1 means every visible card; give "
                         "the number of CPU ranks with --device cpu")
    return data_parallel


def free_tcp_address() -> str:
    """`tcp://127.0.0.1:<port>` on a port the system has just handed out."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def init(rank: int, size: int, device: str = "cuda",
         init_method: str | None = None, local_rank: int | None = None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> World:
    """Join the process group as `rank` of `size` (NCCL on `cuda`, with
    this rank on `cuda:local_rank`, gloo on `cpu`)."""
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", rank if local_rank is None else local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return World(rank, size, dev)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def under_torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_ENV)


def _rank_main(rank, fn, size, device, init_method, threads, args):
    if threads:
        torch.set_num_threads(threads)
    world = init(rank, size, device, init_method)
    try:
        fn(world, *args)
    finally:
        shutdown()


def launch(fn, size: int, device: str = "cuda", args: tuple = (),
           init_method: str | None = None, timeout_s: float | None = None,
           threads: int | None = None) -> None:
    """Run `fn(world, *args)` on `size` ranks and wait for all of them.

    Under `torchrun` (its environment set) this process is one rank: it
    joins the group from the environment and runs `fn` in place. Otherwise
    `size` processes are spawned (`fn` and `args` are pickled, so `fn` must
    be importable by name) on a fresh TCP port or `init_method`, with
    `threads` torch threads each. A rank that raises fails the launch;
    `timeout_s` bounds the whole launch (the ranks are killed past it)."""
    if under_torchrun():
        world = init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     device, "env://",
                     local_rank=int(os.environ["LOCAL_RANK"]))
        try:
            fn(world, *args)
        finally:
            shutdown()
        return
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main, args=(fn, size, device,
                          init_method or free_tcp_address(), threads, args),
        nprocs=size, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{size} ranks of {fn.__qualname__} did not "
                               f"finish within {timeout_s} s")


class GradBuffer:
    """Sums the gradients of `params` over the ranks through one flat
    buffer: SUM, not the mean that DistributedDataParallel takes, because
    the step's loss is a sum over the global batch.

    `all_reduce_()`, after the backward, copies every gradient into the
    buffer with one multi-tensor copy (a missing gradient is zeroed there:
    the warmup branch leaves the fuse path unused, and the optimizer treats
    a missing gradient as zeros), sums the buffer in one all-reduce and sets
    each param's `.grad` to its view of the buffer, so nothing is copied
    back. Every rank builds the buffer from the same params in the same
    order, so every rank calls the same collective."""

    def __init__(self, params, world: World):
        self.params = list(params)
        self.world = world
        self.flat = torch.empty(sum(p.numel() for p in self.params),
                                dtype=self.params[0].dtype,
                                device=self.params[0].device)
        self.views = [v.view_as(p) for v, p in zip(
            self.flat.split([p.numel() for p in self.params]), self.params)]

    def all_reduce_(self) -> None:
        grads = [p.grad for p in self.params]
        missing = [v for v, g in zip(self.views, grads) if g is None]
        if missing:
            torch._foreach_zero_(missing)
        torch._foreach_copy_(
            [v for v, g in zip(self.views, grads) if g is not None],
            [g for g in grads if g is not None])
        self.world.all_reduce_(self.flat)
        for p, v in zip(self.params, self.views):
            p.grad = v
