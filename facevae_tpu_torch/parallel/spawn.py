"""One process per rank on this host (the reference's mp.spawn of
train.py, without its launcher): ``spawn(fn, world, *args)`` starts
``world`` processes by the spawn method, joins them in one process group on
a free localhost port, runs fn(*args) in each and returns each rank's
result; ``start`` does the same without waiting (``Ranks.join`` waits).
``fn`` must be importable from this package: a child imports the module
that defines it and nothing of the caller's."""
from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from facevae_tpu_torch.parallel.mesh import free_port, init_distributed


def _entry(rank: int, fn: Callable, world: int, device: str, backend: Optional[str],
           cards: Sequence[int], address: str, out_dir: str, threads: Optional[int],
           args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    init_distributed(rank, world, device, address, local_rank=cards[rank], backend=backend)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """Started ranks: ``join`` waits for every one and returns their
    results in rank order (a rank that raised raises here)."""

    def __init__(self, context, out_dir: tempfile.TemporaryDirectory, world: int):
        self.context, self.out_dir, self.world = context, out_dir, world

    def join(self) -> List[Any]:
        try:
            while not self.context.join():
                pass
            return [torch.load(os.path.join(self.out_dir.name, f"{r}.pt"), weights_only=False)
                    for r in range(self.world)]
        finally:
            self.out_dir.cleanup()


def start(fn: Callable, world: int, *args, device: str = "cuda",
          backend: Optional[str] = None, cards: Optional[Sequence[int]] = None,
          threads: Optional[int] = None) -> Ranks:
    """Start fn(*args) on ranks 0..world-1 of a new group: NCCL on the card
    unless ``backend`` says otherwise (gloo also takes CUDA tensors, and
    runs two ranks on one card, which NCCL refuses), gloo with ``device``
    "cpu".  Rank r runs on card cards[r] (default r), with ``threads``
    intra-op threads when given."""
    cards = list(range(world)) if cards is None else list(cards)
    if len(cards) != world:
        raise ValueError(f"{world} ranks but cards {cards}")
    address = f"tcp://localhost:{free_port()}"
    out_dir = tempfile.TemporaryDirectory(prefix="facevae_spawn_")
    context = mp.start_processes(_entry, args=(fn, world, device, backend, cards, address,
                                               out_dir.name, threads, args),
                                 nprocs=world, join=False, start_method="spawn")
    return Ranks(context, out_dir, world)


def spawn(fn: Callable, world: int, *args, **kwargs) -> List[Any]:
    """start(...).join(): [rank 0's result, rank 1's, ...]."""
    return start(fn, world, *args, **kwargs).join()
