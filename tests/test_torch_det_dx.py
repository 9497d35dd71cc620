"""PyTorch port: the deterministic dx of the two warps' backwards on the CPU.

With PyTorch's deterministic algorithms on, the CUDA dx kernels (TPU
kernels 3 and 6) sum in fixed point: each contribution w * gout rounded once
to an int64 at the scale 2^s that ops/fast_warp.py:dx_scale_exponent picks,
added with integer atomics, converted once (csrc/warp_common.cuh,
FixedSink).  The card runs the kernels (test_torch_cuda.py, chip_smoke.py
phase 3); here:

- the scale never lets a sum overflow: all the mass on one voxel, M at
  fp32's largest value, the counts of the MFE and Generator call sites;
- the sum emulated with index_add_ (tests/torch_parity.py:fixed_point_dx)
  gives the same bits for permuted samples, is within 1e-6 of max|ref| of
  the float64 sum of the same fp32 contributions, and puts NaN / +-inf where
  the plain backward does;
- autograd through both warps under torch.use_deterministic_algorithms(True)
  on the CPU (the plain versions) gives the same bits twice and matches
  jax.vjp at the plain-backward tests' 1e-5 of max|ref|;
- the port's avg_pool_3d, a reshape and a mean so that the training step's
  backward has no op without a deterministic implementation on the card
  (avg_pool3d_backward_cuda has none), gives F.avg_pool3d's values and
  gradient under the same mode.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from facevae_tpu.ops import fast_warp as jfw
from facevae_tpu_torch.ops import fast_warp as tfw
from facevae_tpu_torch.ops.interpolate import avg_pool_3d
from torch_parity import (assert_close, corner_contributions, fixed_point_dx,  # noqa: F401
                          one_torch_thread)

T = torch.from_numpy
MFE_COUNT = 15 * 16 * 64 * 64      # K1 * NV: the samples that reach one dx element at MFE
GEN_COUNT = 16 * 64 * 64           # gps * NV at the Generator
FP32_MAX = float(np.finfo(np.float32).max)


@pytest.mark.parametrize("count", [1, 3, GEN_COUNT, MFE_COUNT])
@pytest.mark.parametrize("m", [FP32_MAX, 3.0, 1.0, 2.0 ** -149, 0.0])
def test_scale_never_overflows(count, m):
    """All the mass on one voxel: count samples of weight 1 there, each
    contributing M (the largest |finite gout|, non-finite values beside it
    ignored): their int64 sum is exact and within 2^62; and the scale wastes
    at most a factor 4 of the range (count * M * 2^s > 2^60)."""
    gout = torch.tensor([m, -m, 0.5 * m, float("nan"), float("inf"), float("-inf")])
    s = int(tfw.dx_scale_exponent(gout, count))
    q = round(Fraction(m) * Fraction(2) ** s)         # one contribution, rounded once
    assert count * q <= 2 ** 62
    if m > 0 and count > 1:
        assert count * Fraction(m) * Fraction(2) ** s > 2 ** 60
    for sign in (1, -1):
        acc = torch.zeros(1, dtype=torch.int64)
        acc.index_add_(0, torch.zeros(count, dtype=torch.long),
                       torch.full((count,), sign * q, dtype=torch.int64))
        assert int(acc) == sign * count * q


def test_scale_reads_gout_on_its_device_in_its_dtype():
    g = torch.tensor([[1.5, -6.0], [float("inf"), 2.0]]).bfloat16()
    s = tfw.dx_scale_exponent(g, MFE_COUNT)
    assert s.dtype == torch.int32 and s.shape == () and s.device == g.device
    # M = 6 = 0.75 * 2^3, count <= 2^20: s = 62 - 20 - 3
    assert int(s) == 39


def _smooth_case(rng, N=2, K1=3, spatial=(3, 5, 8), C=4):
    """MFE-like pixel coordinates [3][N,K1,NV]: an affine map per (n, k)
    plus small noise, with 10% exact integers and 2% far out or the last
    index; a cotangent [N, *spatial, K1*C] (k-major) and its rows [N,
    K1*NV, C] in (k, v) order."""
    D, H, W = spatial
    NV = D * H * W
    z, y, x = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij")
    coords = []
    for base, size in zip((x, y, z), (W, H, D)):
        c = (base.reshape(1, 1, NV) * rng.uniform(0.8, 1.2, (N, K1, 1))
             + rng.uniform(-1, 1, (N, K1, 1)) + 0.3 * rng.randn(N, K1, NV))
        pick = rng.rand(N, K1, NV)
        c = np.where(pick < 0.1, np.round(c), c)
        c = np.where(pick > 0.99, size - 1.0, c)
        c = np.where((pick > 0.98) & (pick <= 0.99), rng.choice([-1e6, 1e30, -3.0], c.shape), c)
        coords.append(T(c.astype(np.float32)))
    gout = T(rng.randn(N, *spatial, K1 * C).astype(np.float32))
    return (N, *spatial, C), coords, gout


def _rows(gout, shape, K1):
    N, D, H, W, C = shape
    return tfw._gout_k_major(gout, torch.float32, N, K1, D * H * W, C)


def test_fixed_point_sum_has_the_same_bits_in_any_order(rng):
    shape, coords, gout = _smooth_case(rng)
    N, K1, NV, C = shape[0], 3, coords[0].shape[2], shape[-1]
    s = tfw.dx_scale_exponent(gout, K1 * NV)
    ref = fixed_point_dx(shape, coords, _rows(gout, shape, K1), int(s))
    perm_k, perm_v = torch.randperm(K1), torch.randperm(NV)
    pc = [c[:, perm_k][:, :, perm_v] for c in coords]
    g = _rows(gout, shape, K1).reshape(N, K1, NV, C)[:, perm_k][:, :, perm_v]
    out = fixed_point_dx(shape, pc, g.reshape(N, K1 * NV, C), int(s))
    assert torch.isfinite(ref).all() and torch.equal(out, ref)


def test_fixed_point_sum_is_close_to_the_float64_sum(rng):
    """Within 1e-6 of max|ref| of the float64 sum of the same fp32
    contributions (the fixed point adds ~count * 2^-s; the fp32 result
    rounds once)."""
    shape, coords, gout = _smooth_case(rng, K1=15)
    N, NV, C = shape[0], coords[0].shape[2], shape[-1]
    g = _rows(gout, shape, 15)
    out = fixed_point_dx(shape, coords, g, int(tfw.dx_scale_exponent(gout, 15 * NV)))
    ref = torch.zeros(N, NV, C, dtype=torch.float64)
    for n, idx, c in corner_contributions(shape, coords, g):
        ref[n].index_add_(0, idx, c.double())
    assert_close(out, ref.reshape(shape), 1e-6, "fixed point vs float64")


def test_fixed_point_non_finite_where_the_plain_backward_puts_them(rng):
    """NaN, +inf and -inf cotangents (and +inf with -inf on one voxel) at
    samples whose corners all lie inside the volume: the emulation's
    non-finite dx elements are those of warp_multi_pixel_bwd_plain, with the
    same values, and the rest within 1e-5 of max|ref| of it."""
    shape, coords, gout = _smooth_case(rng)
    N, D, H, W, C = shape
    K1, NV = 3, D * H * W
    inside = torch.ones(N, K1, NV, dtype=torch.bool)
    for c, size in zip(coords, (W, H, D)):
        inside &= (c > 0.5) & (c < size - 1.5)
    (n0, k0, v0), (n1, k1, v1) = inside.nonzero()[[0, -1]].tolist()
    per_k = gout.view(N, NV, K1, C)
    per_k[n0, v0, k0, 0], per_k[n1, v1, k1, 1] = float("nan"), float("inf")
    per_k[n1, v1, k1, 2] = float("-inf")
    # a +inf and a -inf meeting on one voxel: the same sample, channel 3, in two grids
    (nn, kk, vv) = inside[:, :2].nonzero()[0].tolist()
    for a in range(3):
        coords[a][nn, 1 - kk, vv] = coords[a][nn, kk, vv]
    per_k[nn, vv, kk, 3], per_k[nn, vv, 1 - kk, 3] = float("inf"), float("-inf")
    out = fixed_point_dx(shape, coords, _rows(gout, shape, K1),
                         int(tfw.dx_scale_exponent(gout, K1 * NV)))
    ref = tfw.warp_multi_pixel_bwd_plain(torch.zeros(shape), *coords, gout, (D, H, W),
                                         need_dgrid=False)[0]
    for what, kind in (("NaN", torch.isnan), ("+inf", torch.isposinf),
                       ("-inf", torch.isneginf)):
        assert kind(ref).any() and torch.equal(kind(out), kind(ref)), what
    bad = ~torch.isfinite(ref)
    assert_close(torch.where(bad, 0.0, out), torch.where(bad, 0.0, ref), 1e-5, "finite part")


def _pow2_case(rng, N=2, K1=2, spatial=(5, 9, 5), C=3):
    """Coordinates of sizes with size-1 a power of two (JAX's pixel ->
    normalized -> pixel round trip keeps integers exact), uniform over [-2,
    size+1] with 15% exact integers, 5% the last index and 3% far out."""
    NV = int(np.prod(spatial))
    coords = []
    for size in spatial[::-1]:
        c = rng.uniform(-2, size + 1, (N, K1, NV))
        pick = rng.rand(N, K1, NV)
        c = np.where(pick < 0.15, np.round(c), c)
        c = np.where((pick >= 0.15) & (pick < 0.2), size - 1.0, c)
        c = np.where(pick > 0.97, rng.choice([-1e30, -1e6, 1e6, 1e30], c.shape), c)
        coords.append(c.astype(np.float32))
    x = rng.randn(N, *spatial, C).astype(np.float32)
    return x, coords


def _twice(fn):
    """fn() under torch.use_deterministic_algorithms(True), twice."""
    torch.use_deterministic_algorithms(True)
    try:
        return fn(), fn()
    finally:
        torch.use_deterministic_algorithms(False)


def test_deterministic_autograd_multi_grid_on_the_cpu(rng):
    x, coords = _pow2_case(rng)
    spatial, K1, C = x.shape[1:4], coords[0].shape[1], x.shape[-1]
    gout = rng.randn(x.shape[0], *spatial, K1 * C).astype(np.float32)

    def grads():
        xt, *ct = (T(a).requires_grad_() for a in (x, *coords))
        (tfw.warp_multi_pixel(xt, *ct, spatial) * T(gout)).sum().backward()
        return [t.grad for t in (xt, *ct)]

    first, second = _twice(grads)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _, vjp = jax.vjp(lambda *a: jfw.warp_multi_pixel(*a, spatial), jnp.asarray(x),
                     *map(jnp.asarray, coords))
    for t, r, what in zip(first, vjp(jnp.asarray(gout)), ("dx", "dgx", "dgy", "dgz")):
        assert_close(t, r, 1e-5, what)


@pytest.mark.parametrize("gps", [1, 2])
def test_deterministic_autograd_single_grid_on_the_cpu(rng, gps):
    x, coords = _pow2_case(rng, K1=gps)
    N, D, H, W, C = x.shape
    grid = np.stack([c * (2.0 / (s - 1)) - 1.0 for c, s in zip(coords, (W, H, D))], -1)
    grid = grid.reshape(N * gps, D, H, W, 3).astype(np.float32)
    gout = rng.randn(N * gps, D, H, W, C).astype(np.float32)

    def grads():
        xt, gt = T(x).requires_grad_(), T(grid).requires_grad_()
        (tfw.grid_sample_3d_fast(xt, gt, gps) * T(gout)).sum().backward()
        return xt.grad, gt.grad

    first, second = _twice(grads)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _, vjp = jax.vjp(lambda a, b: jfw.grid_sample_3d_fast(a, b, gps), jnp.asarray(x),
                     jnp.asarray(grid))
    for t, r, what in zip(first, vjp(jnp.asarray(gout)), ("dx", "dgrid")):
        assert_close(t, r, 1e-5, f"{what} gps={gps}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, window", [((2, 3, 4, 8, 8), (1, 2, 2)),
                                           ((1, 2, 5, 7, 9), (2, 2, 3))])
def test_avg_pool_3d_matches_avg_pool3d(rng, shape, window, dtype):
    """avg_pool_3d against F.avg_pool3d (on the fp32 input: PyTorch's CPU
    avg_pool3d takes no bf16), trailing rows that fill no window dropped as
    there: values and gradient within 1e-6 of max|ref| in fp32, one bf16
    rounding in bf16, and the same bits twice under deterministic
    algorithms."""
    x = T(rng.randn(*shape).astype(np.float32))
    gout = T(rng.randn(*F.avg_pool3d(x, window).shape).astype(np.float32))

    def pooled():
        xt = x.to(dtype).requires_grad_()
        y = avg_pool_3d(xt, window)
        (y.float() * gout).sum().backward()
        return y, xt.grad

    (y, dx), again = _twice(pooled)
    assert all(torch.equal(a, b) for a, b in zip((y, dx), again))
    xf = x.to(dtype).float().requires_grad_()
    ref = F.avg_pool3d(xf, window)
    (ref * gout).sum().backward()
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert y.dtype == dx.dtype == dtype and y.shape == ref.shape
    assert_close(y.float(), ref, tol, "avg_pool_3d")
    assert_close(dx.float(), xf.grad, tol, "avg_pool_3d gradient")
