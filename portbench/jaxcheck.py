"""The whole-name check that no JAX module is loaded: a module counts by
its top-level name (the part before the first dot), compared whole, so
facevae_tpu_torch passes and facevae_tpu does not."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "facevae_tpu")


def forbidden(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
