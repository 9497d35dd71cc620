"""The benchmark's plain reference: a frozen copy of facevae_tpu_torch's
nets, losses, ops, objective, training step and inference graphs, taken
when the benchmark was written, in plain PyTorch.

It imports nothing of facevae_tpu_torch or of JAX.  What differs from the
program it judges: no rematerialization (remat.py is the identity), every
warp is plain trilinear sampling through F.grid_sample (warp.py), no data
parallelism, and a precision switch for the benchmark's controls
(precision.py).  Everything else is the copied code, so the same weights,
inputs and generator states give the same function; the comparison in
portbench/checks.py decides how close is close.
"""
