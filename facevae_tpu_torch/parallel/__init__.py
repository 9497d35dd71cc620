"""Parallelism layer (port of facevae_tpu/parallel): the process group,
rank gating, synchronized BatchNorm, and the spawn of one process per card
(parallel/spawn.py).

The JAX package replaces the reference's NCCL stack with a 1-axis device
mesh; the port goes back to one process per card in a torch.distributed
group, with explicit all-reduces in the step rather than
DistributedDataParallel (train/step.py says why)."""
from facevae_tpu_torch.parallel.mesh import (
    DATA_AXIS, free_port, init_distributed, initialized, is_master, local_batch_size,
    master_only_print, rank, sync_batchnorm, world_size,
)
