"""The whole-name check of loaded modules."""
from __future__ import annotations

import pytest

from portbench import jaxcheck


@pytest.mark.parametrize("modules,found", [
    (["facevae_tpu_torch", "facevae_tpu_torch.ops.fast_warp", "torch"], []),
    (["facevae_tpu", "facevae_tpu.ops"], ["facevae_tpu", "facevae_tpu.ops"]),
    (["jax.numpy", "jaxlib"], ["jax.numpy", "jaxlib"]),
    (["flax.linen", "optax"], ["flax.linen", "optax"]),
    (["jaxtyping", "flaxen", "optaxx", "facevae_tpu_torchx"], []),
])
def test_whole_top_level_names(modules, found):
    assert jaxcheck.forbidden(modules) == found


def test_the_reference_imports_neither_the_program_nor_jax():
    import subprocess
    import sys
    code = ("import sys, portbench.reference.step, portbench.reference.inference, "
            "portbench.serve_reference, portbench.train_reference; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('facevae_tpu_torch', 'facevae_tpu', 'jax', 'jaxlib', 'flax', 'optax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    from portbench import run
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_load_generator_imports_no_torch():
    import subprocess
    import sys
    code = ("import sys, portbench.drivers.loadgen; "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    from portbench import run
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
