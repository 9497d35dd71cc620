"""Process-group data parallelism (port of facevae_tpu/parallel/mesh.py).

The JAX package trains on a 1-axis device mesh: one controller per host,
gradients and BatchNorm statistics averaged by lax.pmean over DATA_AXIS
inside shard_map.  Here each card is one process of a torch.distributed
group (NCCL on the card, gloo on the CPU): the step all-reduces its
gradients and loss scalars itself (train/step.py) and BatchNorm all-reduces
its statistics (nn/layers.py, set by ``sync_batchnorm``).

Reference parity map (SURVEY.md §2.5):
  init_dist (distributed.py:24)      -> init_distributed()
  get_rank/get_world_size (:34,:43)  -> rank() / world_size()
  master_only/is_master (:52,:66)    -> is_master() / master_only_print()
  DDP grad all-reduce                -> train/step.py:all_reduce_grads
  SyncBatchNorm stat all-reduce      -> BatchNorm.group (sync_batchnorm)

Nothing here touches a process group or a card when it is imported.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
# the trainable nets whose BatchNorm synchronizes (every block of the models
# and the contrastive head); the teachers stay in eval form
SYNC_NETS = ("efe", "afe", "ckd", "hpe_ede", "mfe", "generator", "discriminator",
             "contrastive")


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(rank: Optional[int] = None, world: Optional[int] = None,
                     device: str = "cuda", address: Optional[str] = None,
                     local_rank: Optional[int] = None, backend: Optional[str] = None):
    """Join (or start) the default process group and return it.

    The rank, world size and local rank come from the arguments, else from
    the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), as jax.distributed.initialize() reads its own.  NCCL on
    the card (each process on card LOCAL_RANK), gloo with ``device`` "cpu"
    (or where ``backend`` says gloo).  A group that is already up is
    returned as it is."""
    if initialized():
        return dist.group.WORLD
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = int(env.get("WORLD_SIZE", 1)) if world is None else world
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if address is None:
        address = (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                   f"{env.get('MASTER_PORT') or free_port()}")
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    kwargs = {}
    if cuda:
        torch.cuda.set_device(local_rank)
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=world,
                            **kwargs)
    return dist.group.WORLD


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def world_size(group=None) -> int:
    """The ranks of ``group`` (the default group; 1 without one)."""
    if group is None and not initialized():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    if group is None and not initialized():
        return 0
    return dist.get_rank(group)


def is_master() -> bool:
    """Rank 0 of the default process group, or no process group."""
    return rank() == 0


def master_only_print(*args, **kwargs) -> None:
    if is_master():
        print(*args, **kwargs)


def local_batch_size(global_batch: int, world: int) -> int:
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} ranks")
    return global_batch // world


def sync_batchnorm(nets, group) -> None:
    """Set ``group`` on the BatchNorm of every trainable net and of the
    contrastive head (SYNC_NETS): their training forms then average batch
    statistics over its ranks (None: each rank's own, as without a group).
    Hopenet's stays in eval form."""
    from facevae_tpu_torch.nn.layers import BatchNorm
    for name in SYNC_NETS:
        if name in nets:
            for m in nets[name].modules():
                if isinstance(m, BatchNorm):
                    m.group = group
