#!/usr/bin/env python
"""Write the goldens of the reference-checkpoint order-zip
(facevae_tpu_torch/utils_port.py):

  tests/data/torch_reference_order.json  the JAX package's eager creation
      order of the seven nets' modules (facevae_tpu.utils_port.
      group_flax_modules over init_all_variables' params and batch_stats,
      the tool's own init) with each leaf's shape and the spectral u / v
      shapes, at tiny_config() and at ModelConfig();
  tests/data/torch_reference_tiny.npz    at tiny_config(), a seeded
      reference-layout state dict of each net ("ref/<net>/<key>": weight or
      weight_orig / weight_u / weight_v, bias, BatchNorm's running_mean /
      running_var / num_batches_tracked, in torch's layouts) and what
      facevae_tpu.utils_port.port_torch_to_flax made of it over the eager
      variables ("jax/<net>/<collection>/<path>": params, batch_stats,
      spectral, flattened).

The JAX package's eager init is what its converter zips against
(tools/convert_reference_checkpoint.py): a jit round trip re-sorts the
variable dicts.  It takes minutes on a CPU, so the not-slow tests read its
order from here; tests/test_torch_utils_port.py::test_order_golden_is_the_eager_init
(slow) reruns it.  The reference state dicts come from
chip_smoke.reference_state_dict (phase reference writes its full-width
checkpoint with it): keys layers.<i>.<leaf>, names neither package uses, so
the zip goes by order alone.

Usage:  JAX_PLATFORMS=cpu python tests/make_torch_reference_golden.py
"""
from __future__ import annotations

import copy
import json
import os
import sys
import time
from collections.abc import Mapping

_TESTS = os.path.dirname(os.path.abspath(__file__))
for path in (_TESTS, os.path.dirname(_TESTS)):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402

from chip_smoke import reference_state_dict  # noqa: E402
from facevae_tpu_torch.convert_reference_checkpoint import MODELS  # noqa: E402

ORDER = os.path.join(_TESTS, "data", "torch_reference_order.json")
GOLDEN = os.path.join(_TESTS, "data", "torch_reference_tiny.npz")
CONFIGS = ("tiny_config", "ModelConfig")
SEED = 17


def jax_config(name):
    from facevae_tpu.config import Config, tiny_config
    return tiny_config() if name == "tiny_config" else Config()


def eager_variables(cfg):
    """The seven nets' variables from the JAX package's eager init (the
    JAX converter's template), as nested numpy in creation order."""
    from facevae_tpu.train.state import build_all_modules, init_all_variables
    variables = init_all_variables(build_all_modules(cfg), cfg, seed=0)
    return {n: as_numpy(variables[n]) for n in MODELS}


def as_numpy(tree):
    """Nested dicts of numpy, in the dicts' own order (jax.tree.map would
    sort the keys)."""
    if isinstance(tree, Mapping):
        return {k: as_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _node(tree, path):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def creation_order(variables):
    """[{"path", "leaves": {flax leaf: shape}, "spectral": {"u", "v": shape}}]
    of one net in group_flax_modules' order."""
    from facevae_tpu.utils_port import group_flax_modules
    out = []
    for path, leaves in group_flax_modules(variables["params"], variables.get("batch_stats")):
        row = {"path": "/".join(path),
               "leaves": {k: list(np.shape(v)) for k, v in leaves.items()}}
        sp = _node(variables.get("spectral", {}), path)
        if isinstance(sp, dict) and "u" in sp:
            row["spectral"] = {k: list(np.shape(v)) for k, v in sp.items()}
        out.append(row)
    return out


def port_with_jax(sd, variables):
    """facevae_tpu.utils_port.port_torch_to_flax over ``variables`` (the
    JAX converter's call): {"params", "batch_stats", "spectral"} as nested
    numpy, the collections the net has."""
    from facevae_tpu.utils_port import port_torch_to_flax
    spectral = copy.deepcopy(variables.get("spectral"))
    params, stats = port_torch_to_flax(sd, variables["params"], variables.get("batch_stats"),
                                       spectral=spectral)
    out = {"params": params}
    if stats is not None:
        out["batch_stats"] = stats
    if spectral is not None:
        out["spectral"] = spectral
    return out


def flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def main():
    t_all = time.perf_counter()
    orders, arrays = {}, {}
    for name in CONFIGS:
        t0 = time.perf_counter()
        variables = eager_variables(jax_config(name))
        orders[name] = {n: creation_order(variables[n]) for n in MODELS}
        print(f"{name}: eager init (the seven nets, the teachers, the head) "
              f"{time.perf_counter() - t0:.1f} s; modules "
              + ", ".join(f"{n} {len(o)}" for n, o in orders[name].items()))
        if name != "tiny_config":
            continue
        for i, n in enumerate(MODELS):
            sd = reference_state_dict(orders[name][n], SEED + i)
            arrays.update({f"ref/{n}/{k}": v for k, v in sd.items()})
            arrays.update(flatten(port_with_jax(sd, variables[n]), f"jax/{n}"))
    with open(ORDER, "w") as f:
        json.dump(orders, f, separators=(",", ":"))
        f.write("\n")
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {ORDER} ({os.path.getsize(ORDER)} bytes) and {GOLDEN} "
          f"({os.path.getsize(GOLDEN)} bytes, {len(arrays)} arrays) in "
          f"{time.perf_counter() - t_all:.1f} s")


if __name__ == "__main__":
    main()
