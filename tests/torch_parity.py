"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX side (seeded G-net variables, the JAX InferencePipeline over them)
lives in tools/make_torch_golden.py, which also writes the committed golden;
it is loaded here by path.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden", ROOT / "tools" / "make_torch_golden.py")
golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden)


def to_np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(actual, ref, rel, what=""):
    """max|actual - ref| <= rel * max|ref| (a scale-aware fp32 tolerance)."""
    actual, ref = to_np(actual).astype(np.float64), to_np(ref).astype(np.float64)
    assert actual.shape == ref.shape, (what, actual.shape, ref.shape)
    err = float(np.abs(actual - ref).max())
    scale = float(np.abs(ref).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel:g} * max|ref| {scale:.3e}"
    return err / scale if scale else 0.0


SPREAD = 10.0


def assert_held(actual, ref, others, rel, what="", scale=None):
    """Hold ``actual`` (the port) to ``ref`` (the JAX package) where the
    reference itself is ill-conditioned: max|actual - ref| <= SPREAD *
    max_o max|o - ref| + rel * scale, over ``others``, the JAX package's
    answers under rounding-level changes (inputs nudged by a few fp32 ulps;
    its float64 mode); scale defaults to max|ref|."""
    actual, ref = (to_np(a).astype(np.float64) for a in (actual, ref))
    others = [to_np(o).astype(np.float64) for o in others]
    assert actual.shape == ref.shape, (what, actual.shape, ref.shape)
    err = float(np.abs(actual - ref).max())
    noise = max(float(np.abs(o - ref).max()) for o in others)
    scale = float(np.abs(ref).max()) if scale is None else scale
    limit = SPREAD * noise + rel * scale
    assert err <= limit, (f"{what}: max|err| {err:.3e} > {SPREAD:g} * JAX's own spread "
                          f"{noise:.3e} + {rel:g} * scale {scale:.3e}")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs with several xdist workers: keep torch to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
