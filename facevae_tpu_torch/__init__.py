"""facevae_tpu_torch — the PyTorch / CUDA port of facevae_tpu.

The JAX package ``facevae_tpu`` is the reference; this package ports it slice
by slice and keeps its module names so each counterpart is easy to find.  The
first slice is the serving path (``train/inference.py`` and ``serve.py``) in
fp32, with the trilinear-warp forward as a hand-written CUDA kernel for
Hopper (``csrc/warp_fwd.cu``).

Layer map:
  ops/       geometry, heatmaps, resampling, motion, the warp op + its kernel
  nn/        Conv/Dense/BatchNorm/InstanceNorm (eval), CNA conv blocks
  models/    AFE, CKD, HPE_EDE, EFE (conv5), MFE, Generator, build_models
  train/     InferencePipeline
  convert.py JAX variables (numpy) -> the port's state_dicts
  serve.py   the batched HTTP server (``python -m facevae_tpu_torch.serve``)

Rules: this package imports ``torch`` and never ``jax`` or ``flax``; the
configuration dataclasses are reused from ``facevae_tpu.config`` (which
imports nothing).  Every tensor-creating call takes an explicit ``device``.
"""

__version__ = "0.1.0"
