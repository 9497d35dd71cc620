"""PyTorch port: the single-grid trilinear warp (grid_sample_3d_fast, whose
CUDA kernels replace TPU kernels 4-6) and its callers against facevae_tpu's.

- the plain forward (the CUDA kernels' reference) against JAX
  grid_sample_3d_fast in fp32, gps 1 and 3 (JAX on the CPU takes its exact
  gather path): 1e-5 of max|ref|, both are fp32 sums of 8 products;
- the plain backward against jax.vjp of it in fp32, dx and dgrid in
  normalized units: 1e-5 of max|ref|, with exact integers, the last index,
  far-out and +-inf coordinates;
- the plain versions on bf16-rounded inputs against warp_mm_fwd_pallas /
  warp_mm_bwd_pallas run in interpret mode: 2% of max|ref| forward, 3% for dx
  and dgrid, the tolerances of tools/check_pallas_warp.py (the kernels round
  their one-hot weights and x-weighted products to bf16);
- torch.autograd.gradcheck of the plain version in fp64;
- the reference-form motion ops (create_heatmap_representations,
  create_sparse_motions, create_deformed_source_image / _fused) and
  grid_sample_3d_multi against JAX in fp32: 1e-5 of max|ref|;
- the dispatch rules, shown by the launch counters: warp_single takes the
  single-grid op at fp32 and the multi-grid op at bf16, and a CPU tensor
  only ever the plain versions (the kernels themselves: test_torch_cuda.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.ops import fast_warp as jfw
from facevae_tpu.ops import motion as jmotion
from facevae_tpu.ops.geometry import make_coordinate_grid_3d, pose_rotation
from facevae_tpu.ops.pallas import warp_mm
from facevae_tpu_torch import ops as tops
from facevae_tpu_torch.ops import fast_warp as tfw
from torch_parity import assert_close, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.fast
FAR = np.array([-1e30, -1e6, -3.0, 1e6, 1e30, np.inf, -np.inf], np.float32)
T = torch.from_numpy


def _case(rng, N=2, D=5, H=9, W=5, C=3, gps=1, spatial=(3, 4, 5)):
    """x, a normalized grid [N*gps,*spatial,3] and a cotangent.  Pixel
    coordinates uniform over [-2, size+1] with 15% exact integers, 5% the
    last index size-1 and 3% far out or +-inf; the sizes have size-1 a power
    of two, so p * 2 / (size-1) - 1 and back keeps integers exact (torch's
    floor subgradient then picks the same corners in both packages)."""
    x = rng.randn(N, D, H, W, C).astype(np.float32)
    shape = (N * gps, *spatial)
    axes = []
    for size in (W, H, D):
        p = rng.uniform(-2, size + 1, shape)
        pick = rng.rand(*shape)
        p = np.where(pick < 0.15, np.round(p), p)
        p = np.where((pick >= 0.15) & (pick < 0.2), size - 1.0, p)
        g = p * (2.0 / (size - 1)) - 1.0
        axes.append(np.where(pick > 0.97, rng.choice(FAR, shape), g))
    grid = np.stack(axes, -1).astype(np.float32)
    gout = rng.randn(*shape, C).astype(np.float32)
    return x, grid, gout


@pytest.mark.parametrize("gps", [1, 3])
def test_plain_forward_matches_jax_fp32(rng, gps):
    x, grid, _ = _case(rng, gps=gps)
    ref = jfw.grid_sample_3d_fast(jnp.asarray(x), jnp.asarray(grid), gps)
    assert_close(tfw.grid_sample_3d_plain(T(x), T(grid), gps), ref, 1e-5, f"gps={gps}")


@pytest.mark.parametrize("gps", [1, 3])
def test_plain_backward_matches_jax_vjp(rng, gps):
    x, grid, gout = _case(rng, gps=gps)
    _, vjp = jax.vjp(lambda a, b: jfw.grid_sample_3d_fast(a, b, gps), jnp.asarray(x),
                     jnp.asarray(grid))
    rdx, rdgrid = vjp(jnp.asarray(gout))
    dx, dgrid = tfw.grid_sample_3d_bwd_plain(T(x), T(grid), T(gout), gps)
    assert dx.dtype == dgrid.dtype == torch.float32
    assert_close(dx, rdx, 1e-5, f"dx gps={gps}")
    assert_close(dgrid, rdgrid, 1e-5, f"dgrid gps={gps}")


def _pallas_case(rng, gps):
    """A deformation-like grid (identity + noise) on a volume whose D*H and
    C*W are 128, as the Pallas kernels' TPU layout wants; bf16-rounded x and
    cotangent."""
    N, D, H, W, C = 1, 8, 16, 32, 4
    ident = np.asarray(make_coordinate_grid_3d((D, H, W)))
    grid = (ident[None] + rng.normal(0, 0.05, (N * gps, D, H, W, 3))).astype(np.float32)
    r = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    x = r(rng.randn(N, D, H, W, C))
    gout = r(rng.randn(N * gps, D, H, W, C))
    gx, gy, gz, _ = jfw._coords(x.shape, jnp.asarray(grid), gps)
    return x, grid, gout, jfw._rows3(jnp.asarray(x)), (gx, gy, gz)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(warp_mm.pl, "pallas_call",
                        functools.partial(warp_mm.pl.pallas_call, interpret=True))


@pytest.mark.parametrize("gps", [1, 2])
def test_plain_matches_pallas_interpret(interpret, rng, gps):
    """Kernels 4-6 themselves (interpret mode) against the plain versions."""
    x, grid, gout, rows3, coords = _pallas_case(rng, gps)
    N, D, H, W, C = x.shape
    ref = warp_mm.warp_mm_fwd_pallas(rows3, *coords, D=D, H=H, W=W, C=C, VB=512)
    port = tfw.grid_sample_3d_plain(T(x), T(grid), gps)
    assert_close(port, np.asarray(ref).T.reshape(port.shape), 2e-2, f"forward gps={gps}")
    P = grid.size // 3
    drows, *rdg = warp_mm.warp_mm_bwd_pallas(rows3, *coords, jnp.asarray(gout.reshape(P, C).T),
                                             D=D, H=H, W=W, C=C, VB_DGRID=512, VB_DROWS=512)
    rdx = np.asarray(drows).reshape(N, D, H, C, W).transpose(0, 1, 2, 4, 3)
    rdgrid = np.stack([np.asarray(d) * ((s - 1) * 0.5) for d, s in zip(rdg, (W, H, D))], -1)
    dx, dgrid = tfw.grid_sample_3d_bwd_plain(T(x), T(grid), T(gout), gps)
    assert_close(dx, rdx, 3e-2, f"dx gps={gps}")
    assert_close(dgrid, rdgrid.reshape(grid.shape), 3e-2, f"dgrid gps={gps}")


def test_plain_backward_gradcheck_fp64(rng):
    """The plain backward is the derivative of the plain forward, in fp64,
    away from integer pixel coordinates (where the subgradient jumps)."""
    x = T(rng.randn(1, 3, 4, 5, 2)).requires_grad_()
    p = np.round(rng.uniform(-1.5, 1.0, (2, 2, 2, 3, 3)) * np.array([5, 4, 3]), 1) + 0.05
    grid = T(p * (2.0 / (np.array([5, 4, 3]) - 1)) - 1.0).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: tfw.grid_sample_3d_fast(a, b, 2), (x, grid))


def test_autograd_runs_the_plain_versions_on_the_cpu(rng):
    """grid_sample_3d_fast under autograd: the plain versions only, each
    backward half only when autograd needs it."""
    x, grid, gout = _case(rng, gps=3)
    xt, gt = T(x).requires_grad_(), T(grid).requires_grad_()
    tfw.reset_launch_counts()
    (tfw.grid_sample_3d_fast(xt, gt, 3) * T(gout)).sum().backward()
    assert tfw.launches == {**dict.fromkeys(tfw.launches, 0), "grid_fwd_plain": 1,
                            "grid_bwd_dgrid_plain": 1, "grid_bwd_dx_plain": 1}
    tfw.grid_sample_3d_fast(xt, T(grid), 3).sum().backward()
    tfw.grid_sample_3d_fast(T(x), gt, 3).sum().backward()
    with torch.no_grad():
        tfw.grid_sample_3d_fast(xt, gt, 3)
    assert (tfw.launches["grid_fwd_plain"], tfw.launches["grid_bwd_dx_plain"],
            tfw.launches["grid_bwd_dgrid_plain"]) == (4, 2, 2)


def test_plain_version_keeps_bf16_and_masks_nan(rng):
    """NaN and +-inf coordinates weigh 0, as in the kernels (the JAX exact
    path returns NaN for a NaN coordinate); the result keeps x's dtype."""
    x, grid, _ = _case(rng, gps=2)
    grid[0, 0, 0, :4] = [[np.nan, 0, 0], [0, np.inf, 0], [0, 0, -np.inf], [np.nan] * 3]
    out = tfw.grid_sample_3d_plain(T(x).bfloat16(), T(grid), 2)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert (out[0, 0, 0, :4] == 0).all()


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    x, grid, gout = _case(rng)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfw.grid_sample_3d_cuda(T(x), T(grid))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfw.grid_sample_3d_bwd_cuda(T(x), T(grid), T(gout))
    with pytest.raises(ValueError, match="N\\*gps"):
        tfw.grid_sample_3d_plain(T(x), T(grid), 2)


@pytest.mark.parametrize("dtype,path", [(torch.float32, "grid"), (torch.bfloat16, "warp")])
def test_warp_single_dispatch(rng, dtype, path):
    """fp32 -> the single-grid op on the normalized grid; bf16 -> the
    multi-grid op at K1=1 (the JAX package's dispatch on its chip); on the
    CPU only plain versions run."""
    x = T(rng.randn(2, 4, 6, 5, 3).astype(np.float32)).to(dtype).requires_grad_()
    deformation = T(rng.uniform(-1.2, 1.2, (2, 4, 6, 5, 3)).astype(np.float32)).requires_grad_()
    tfw.reset_launch_counts()
    out = tfw.warp_single(x, deformation)
    out.float().sum().backward()
    assert out.dtype == dtype and out.shape == x.shape
    assert tfw.launches == {**dict.fromkeys(tfw.launches, 0), f"{path}_fwd_plain": 1,
                            f"{path}_bwd_dgrid_plain": 1, f"{path}_bwd_dx_plain": 1}


@pytest.fixture(scope="module")
def motion_inputs():
    rs = np.random.RandomState(11)
    N, K, D, H, W, C = 2, 4, 5, 6, 7, 3
    fs = rs.randn(N, D, H, W, C).astype(np.float32)
    kp_s, kp_d = (rs.uniform(-0.7, 0.7, (N, K, 3)).astype(np.float32) for _ in range(2))
    Rs, Rd = (np.array(pose_rotation(*[rs.uniform(-0.4, 0.4, N).astype(np.float32)
                                         for _ in range(3)])) for _ in range(2))
    return fs, kp_s, kp_d, Rs, Rd


def test_reference_form_motion_matches_jax(motion_inputs):
    """create_heatmap_representations, create_sparse_motions and the
    reference-form warp create_deformed_source_image (grid_sample_3d_fast
    with gps = K+1) and its fused form, on the port's exports."""
    fs, kp_s, kp_d, Rs, Rd = motion_inputs
    j = [jnp.asarray(a) for a in motion_inputs]
    t = [T(a) for a in motion_inputs]
    assert_close(tops.create_heatmap_representations(*t[:3]),
                 jmotion.create_heatmap_representations(*j[:3]), 1e-5, "heatmaps")
    ref_motions = jmotion.create_sparse_motions(*j)
    motions = tops.create_sparse_motions(*t)
    assert_close(motions, ref_motions, 1e-5, "sparse motions")
    tfw.reset_launch_counts()
    deformed = tops.create_deformed_source_image(t[0], motions)
    assert tfw.launches["grid_fwd_plain"] == 1
    assert_close(deformed, jmotion.create_deformed_source_image(j[0], ref_motions), 1e-5,
                 "deformed source")
    fused = tfw.grid_sample_3d_multi(t[0], motions, motions.shape[1])
    assert_close(fused, jmotion.create_deformed_source_fused(j[0], ref_motions), 1e-5,
                 "fused deformed source")
    N, K1 = motions.shape[:2]
    assert_close(fused.reshape(N, *fs.shape[1:4], K1, -1).permute(0, 4, 1, 2, 3, 5),
                 deformed, 1e-6, "fused vs reference form")
