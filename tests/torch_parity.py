"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX side (seeded G-net variables, the JAX InferencePipeline over them)
lives in tools/make_torch_golden.py, which also writes the committed golden;
it is loaded here by path.
"""
from __future__ import annotations

import importlib.util
import types
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


def fixed_normal(eps):
    """A stand-in for facevae_tpu.models.vae's ``jax`` module whose
    random.normal returns ``eps`` (numpy) in the requested dtype: JAX's
    threefry draw has no torch equivalent, so a parity test patches the VAE
    module's ``jax`` with this and hands the port the same eps."""
    import jax.numpy as jnp

    def normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == eps.shape, (shape, eps.shape)
        return jnp.asarray(eps, dtype)
    return types.SimpleNamespace(random=types.SimpleNamespace(normal=normal))


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


def lane_pairs(lo, hi, distance):
    """The dx kernels' corner pairing (csrc/warp_bwd.cu kernel 3 at distance
    1, csrc/warp_grid.cu kernel 6 at distance cvs = C / CPT), for threads in
    launch order: lo, hi [R, T] the element (voxel) of each thread's lower
    and upper x corner at one (dz, dy), -1 outside the volume; T a multiple
    of 32, so each row's warps are its 32-thread runs (a row is one (n, k)
    or g: one blockIdx.y).  Lane l takes lane l - distance's upper corner
    where it is its own lower one; the giver skips that atomic.  Returns
    (take, given) [R, T] bool."""
    R, T = lo.shape
    lane = torch.arange(T) % 32
    prev_hi = torch.full_like(hi, -1)
    prev_hi[:, distance:] = hi[:, :T - distance]
    take = (lane >= distance) & (lo >= 0) & (prev_hi == lo)
    given = torch.zeros_like(take)
    given[:, :T - distance] = take[:, distance:]
    given &= lane + distance < 32
    return take, given


def _thread_corners(coords, spatial, cvs):
    """The dx kernels' threads in launch order: per (row, voxel v, channel
    vector cv), cvs vectors per voxel, each row padded with dead lanes to
    whole warps.  Yields per (dz, dy) the elements (voxels) of each thread's
    lower and upper x corner [R, T] (-1 outside the volume, and for dead
    lanes) and their weights [R, NV] (fp32, the kernels' order of
    operations), with the threads' voxels v [T]."""
    D, H, W = spatial
    NV = coords[0].shape[-1]
    R = coords[0].numel() // NV
    T = -(-NV * cvs // 32) * 32
    p = [c.float().reshape(R, NV) for c in coords]
    f = [torch.floor(c) for c in p]
    t = [c - fl for c, fl in zip(p, f)]
    live = torch.arange(T) < NV * cvs
    v = torch.where(live, torch.arange(T) // cvs, 0)
    x0in = (f[0] >= 0) & (f[0] <= W - 1)
    x1in = (f[0] + 1 >= 0) & (f[0] + 1 <= W - 1)
    fx = torch.where(x0in | x1in, f[0], 0).long()
    for dz in (0, 1):
        wz = t[2] if dz else 1 - t[2]
        for dy in (0, 1):
            wzy = wz * (t[1] if dy else 1 - t[1])
            jz, jy = f[2] + dz, f[1] + dy
            row_in = (jz >= 0) & (jz <= D - 1) & (jy >= 0) & (jy <= H - 1)
            row = torch.where(row_in, jz, 0).long() * H + torch.where(row_in, jy, 0).long()
            lo = torch.where(row_in & x0in, row * W + fx, -1)
            hi = torch.where(row_in & x1in, row * W + fx + 1, -1)
            lo, hi = (torch.where(live, a[:, v], -1) for a in (lo, hi))
            yield lo, hi, wzy * (1 - t[0]), wzy * t[0], v


def pairing_counts(coords, spatial, cvs=1):
    """(atomics the paired dx kernel issues, atomics without the pairing)
    per channel vector, for pixel coordinates [3][..., NV] over a volume
    ``spatial`` (D, H, W), at lane distance cvs."""
    issued = unpaired = 0
    for lo, hi, _, _, _ in _thread_corners(coords, spatial, cvs):
        _, given = lane_pairs(lo, hi, cvs)
        unpaired += int((lo >= 0).sum() + (hi >= 0).sum())
        issued += int((lo >= 0).sum() + ((hi >= 0) & ~given).sum())
    return issued, unpaired


def paired_dx(shape, coords, g, cvs=1, scale_exp=None):
    """The dx kernels' atomics with the corner pairing, emulated over
    _thread_corners' threads (cvs vectors of C / cvs channels per voxel:
    kernel 3 holds all C channels in one thread, cvs = 1; kernel 6 one
    vector of CPT channels, cvs = C / CPT).  Per (dz, dy) each live
    corner's contribution w * g (fp32, the kernels' order of operations) is
    summed with its giver's where lane_pairs pairs them, then added at its
    element: in float64 (scale_exp None), or as FixedSink's int64
    round(c * 2^s) with non-finite contributions flagged, as
    fixed_point_dx.  shape: x's [N,D,H,W,C]; coords [3][N,K,NV] pixel
    coordinates (K grids per source, rows n * K + k); g [N, K*NV, C] fp32.
    Returns dx [N,D,H,W,C]."""
    N, D, H, W, C = shape
    K, NV = coords[0].shape[1:]
    R, S = N * K, C // cvs
    T = -(-NV * cvs // 32) * 32
    cv = torch.arange(T) % cvs
    chan = cv[:, None] * S + torch.arange(S)                     # [T, S]
    src = (torch.arange(R) // K)[:, None, None]
    exact = scale_exp is None
    acc = torch.zeros(N, D * H * W * C, dtype=torch.float64 if exact else torch.int64)
    flags = torch.zeros(3, N, D * H * W * C, dtype=torch.int64)  # NaN, +inf, -inf
    for lo, hi, w0, w1, v in _thread_corners(coords, (D, H, W), cvs):
        gt = g.reshape(R, NV, cvs, S)[:, v, cv]                  # [R, T, S]
        take, given = lane_pairs(lo, hi, cvs)
        vals = []
        for a, w in ((lo, w0), (hi, w1)):
            c = w[:, v, None] * gt                               # [R, T, S] fp32
            e = a[..., None] * C + chan                          # its elements
            live = (a >= 0)[..., None].expand_as(c)
            for i, bad in enumerate((c.isnan(), c == float("inf"), c == float("-inf"))):
                m = live & bad
                flags[i].index_put_((src.expand_as(e)[m], e[m]), torch.ones((), dtype=torch.long),
                                    accumulate=True)
            vals.append(c.double() if exact else torch.round(
                torch.where(torch.isfinite(c), c, 0).double() * 2.0 ** scale_exp).long())
        prev = torch.zeros_like(vals[1])
        prev[:, cvs:] = vals[1][:, :T - cvs]
        vals[0] = vals[0] + torch.where(take[..., None], prev, 0)
        for a, val, send in ((lo, vals[0], lo >= 0), (hi, vals[1], (hi >= 0) & ~given)):
            e = a[..., None] * C + chan
            m = send[..., None].expand_as(e)
            acc.index_put_((src.expand_as(e)[m], e[m]), val[m], accumulate=True)
    if exact:
        return acc.reshape(shape)
    out = (acc.to(torch.float32).double() * 2.0 ** -scale_exp).float()
    nan, pos, neg = flags > 0
    out = torch.where(pos, float("inf"), torch.where(neg, float("-inf"), out))
    out = torch.where(nan | (pos & neg), float("nan"), out)
    return out.reshape(shape)
