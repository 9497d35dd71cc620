"""facevae_tpu_torch — the PyTorch / CUDA port of facevae_tpu.

The JAX package ``facevae_tpu`` is the reference; this package ports it slice
by slice and keeps its module names so each counterpart is easy to find.
Ported so far, fp32: the serving path (``train/inference.py``, ``serve.py``)
and the single-device training step (``train/step.py``), with the
trilinear warp's forward and backward as hand-written CUDA kernels for
Hopper (``csrc/warp_fwd.cu``, ``csrc/warp_bwd.cu``).

Layer map:
  config.py  the configuration dataclasses (a copy of the JAX package's)
  ops/       geometry, heatmaps, resampling, motion, normalization, TPS,
             the warp op with its kernels' wrappers and plain versions
  nn/        Conv/Dense/BatchNorm/InstanceNorm (eval and training forms),
             CNA conv blocks, the equalized-learning-rate layers
  models/    AFE, CKD, HPE_EDE, the eight EFE variants with their VAEs, MFE,
             Generator, Discriminator, the Hopenet teacher, build_models
  losses/    perceptual (VGG19 / VGG-Face), GAN, keypoint, VAE, contrastive
  train/     InferencePipeline, the objective, TrainState, train_step
  remat.py   rematerialization of the objective's nets (ModelConfig.remat)
  convert.py JAX variables / train states (numpy) -> the port's modules
  serve.py   the batched HTTP server (``python -m facevae_tpu_torch.serve``)
  bench.py   training throughput (``python -m facevae_tpu_torch.bench``)

Rules: this package imports ``torch`` and nothing of ``jax``, ``flax`` or
the JAX package ``facevae_tpu`` (not even its modules that import no JAX):
it keeps its own copies of what it needs.  Every tensor-creating call takes
an explicit ``device``.
"""

__version__ = "0.2.0"
