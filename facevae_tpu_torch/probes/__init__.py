"""The TPU probes of tools/, ported: four experiments, each an entry point
with its hand-written Hopper kernel.

    python -m facevae_tpu_torch.probes.microbench_gather       # kernel 9
    python -m facevae_tpu_torch.probes.microbench_lane_gather  # kernel 10
    python -m facevae_tpu_torch.probes.proto_warp              # kernel 7
    python -m facevae_tpu_torch.probes.proto_banded_warp       # kernel 8, [--mode M]

Each runs on the card unless ``--device cpu`` is given (then the kernels'
plain versions run, and the times are the host's).  Each module holds its
probe's input generator and oracle (copies: the port imports nothing of the
JAX package), the kernel's wrapper, its plain PyTorch version, a launch
counter (``launches``) and ``run()``, which ``main()`` prints and
``chip_smoke.py`` phase 9 checks.  The kernels live in csrc/probe_gather.cu
(9, 10) and csrc/probe_warp.cu (7, 8).

This package imports none of its modules, so ``python -m`` runs each one
only once.
"""
