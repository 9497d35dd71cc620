#!/usr/bin/env python
"""Write the JAX golden of the conv6 EFE variant: tests/data/torch_conv6_golden.npz.

One forward of the JAX package's EFE_conv6 at 256x256 takes ~20 s and ~200
CPU-seconds on a CPU (its transposed convs run as input-dilated convs, 8x
their work), too much for the tier-1 run beside the JAX training tests.
So tests/test_torch_variants_256.py::test_conv6_matches_jax holds the port
to the JAX module's answer recorded here: the eval form of the JAX module
on the numpy-seeded weights and inputs of test_torch_variants.variant_case
(seed 13, batch 1, tiny_config(image_size=256) with depth 16), with a
SHA-256 digest of those weights and inputs, which the test recomputes from
its own draws and refuses to use the file if they differ.

Usage:  JAX_PLATFORMS=cpu python tests/make_torch_variant_golden.py
"""
from __future__ import annotations

import hashlib
import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
for path in (_TESTS, os.path.dirname(_TESTS)):
    if path not in sys.path:
        sys.path.insert(0, path)

import jax  # noqa: E402
import numpy as np  # noqa: E402

GOLDEN = os.path.join(_TESTS, "data", "torch_conv6_golden.npz")
SEED = 13
OUTPUTS = ("kp", "x_c", "x_a_c", "mu", "logstd", "x_vae", "x_hat")


def conv6_case():
    """(JAX EFE_conv6, its variables, the port's EFE over them, inputs)."""
    from facevae_tpu.config import tiny_config as jax_tiny_config
    from test_torch_variants import model_config, variant_case
    jcfg = model_config(jax_tiny_config(image_size=256), efe_variant="conv6", depth=16)
    return variant_case(jcfg, "conv6", 1, seed=SEED)


def digest(variables, inputs) -> str:
    """SHA-256 over the variables' leaves (in path order) and the inputs."""
    h = hashlib.sha256()
    for path, leaf in sorted(jax.tree_util.tree_flatten_with_path(variables)[0],
                             key=lambda kv: jax.tree_util.keystr(kv[0])):
        h.update(jax.tree_util.keystr(path).encode())
        h.update(np.ascontiguousarray(leaf, np.float32).tobytes())
    for a in inputs:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def main():
    jm, variables, _, inputs = conv6_case()
    x, x_a, kp, _ = inputs
    out = jax.jit(lambda v: jm.apply(v, x, x_a, kp, train=False))(variables)
    kp_, x_c, x_a_c, (mu, logstd), (x_vae, x_hat) = out
    arrays = dict(zip(OUTPUTS, (kp_, x_c, x_a_c, mu, logstd, x_vae, x_hat)))
    np.savez(GOLDEN, digest=np.asarray(digest(variables, inputs)),
             **{k: np.asarray(v) for k, v in arrays.items()})
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    main()
