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


def corner_contributions(shape, coords, g):
    """Every corner inside the volume of every sample, as the dx kernels walk
    them: yields (n, flat voxel index [m], contribution [m, C]) per source n
    and corner, the contribution w * g in fp32 with w = (wz * wy) * wx, the
    kernels' order of operations.  shape: x's [N,D,H,W,C]; coords [3][N,K,NV]
    fp32 pixel coordinates; g [N, K*NV, C] fp32, rows in (k, v) order."""
    N, D, H, W, C = shape
    p = [c.float().reshape(N, -1) for c in coords]
    f = [torch.floor(c) for c in p]
    t = [c - fl for c, fl in zip(p, f)]
    for dz in (0, 1):
        wz = t[2] if dz else 1 - t[2]
        for dy in (0, 1):
            wzy = wz * (t[1] if dy else 1 - t[1])
            for dx in (0, 1):
                w = wzy * (t[0] if dx else 1 - t[0])
                j = [f[a] + d for a, d in enumerate((dx, dy, dz))]
                ok = torch.ones_like(w, dtype=torch.bool)
                for ja, size in zip(j, (W, H, D)):
                    ok &= (ja >= 0) & (ja <= size - 1)
                jx, jy, jz = (torch.where(ok, ja, 0).long() for ja in j)
                flat = (jz * H + jy) * W + jx
                c = w[..., None] * g
                for n in range(N):
                    yield n, flat[n][ok[n]], c[n][ok[n]]


def fixed_point_dx(shape, coords, g, s):
    """The deterministic dx kernels' sum (csrc/warp_common.cuh, FixedSink),
    emulated on the CPU: each finite contribution of corner_contributions
    rounded once to round(c * 2^s) in int64 and summed with index_add_
    (integers: any order gives the same bits); non-finite ones flagged per
    element and summed by IEEE's rules; then acc * 2^-s in fp32."""
    N, D, H, W, C = shape
    acc = torch.zeros(N, D * H * W, C, dtype=torch.int64)
    flags = torch.zeros(3, N, D * H * W, C, dtype=torch.int64)   # NaN, +inf, -inf
    for n, idx, c in corner_contributions(shape, coords, g):
        q = torch.round(torch.where(torch.isfinite(c), c, 0).double() * 2.0 ** s).long()
        acc[n].index_add_(0, idx, q)
        for i, bad in enumerate((c.isnan(), c == float("inf"), c == float("-inf"))):
            flags[i, n].index_add_(0, idx, bad.long())
    out = (acc.to(torch.float32).double() * 2.0 ** -s).float()
    nan, pos, neg = flags > 0
    out = torch.where(pos, float("inf"), torch.where(neg, float("-inf"), out))
    return torch.where(nan | (pos & neg), float("nan"), out).reshape(shape)
