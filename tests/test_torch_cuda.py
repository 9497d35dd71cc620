"""PyTorch port on the card: the CUDA warp kernels (the multi-grid forward
and its backward's dgrid and dx halves; the single-grid forward, dgrid and
dx) and the four probe kernels (facevae_tpu_torch/probes/) against their
plain versions, kernels 1 and 3 at the MFE and Generator shapes on the
coordinate sets of facevae_tpu_torch/warp_inputs.py, the deterministic dx
kernels (under torch.use_deterministic_algorithms, and against the
fixed-point emulation of tests/torch_parity.py bit for bit), the wrappers'
refusals, the tiny golden pipeline through
the forward kernels, tiny fp32 and bf16 training steps through all of
them (also with the fused augmentation), kernel 1 at the augmentation's
call, and an epoch checkpoint saved on the card, loaded on the CPU and
back.  Every test skips without a CUDA device.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import contextlib
import dataclasses
import functools

from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import load_jax_variables, nested_from_flat
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.probes import microbench_gather as p9
from facevae_tpu_torch.probes import microbench_lane_gather as p10
from facevae_tpu_torch.probes import proto_banded_warp as p8
from facevae_tpu_torch.probes import proto_warp as p7
from facevae_tpu_torch.train import InferencePipeline, create_train_state, train_step
from torch_parity import assert_close, golden

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")


def _case(seed, N, D, H, W, C, K1, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, D, H, W, C, generator=g, device="cuda").to(dtype)
    size = torch.tensor([W, H, D], device="cuda").reshape(3, 1, 1, 1)
    c = torch.rand(3, N, K1, D * H * W, generator=g, device="cuda") * (size + 3) - 2
    pick = torch.rand(c.shape, generator=g, device="cuda")
    c = torch.where(pick < 0.1, c.round(), c)
    probes = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e30, -1e6],
                          device="cuda")
    c = torch.where(pick > 0.98, probes[(pick * 1e4).long() % 5], c)
    return x, [c[a].contiguous() for a in range(3)], (D, H, W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 16, 16, 4, 15), (2, 4, 8, 8, 32, 1),
                                   (1, 3, 5, 7, 3, 2), (2, 2, 6, 6, 6, 3)])
def test_kernel_matches_plain(dtype, shape):
    """fp32: 1e-5 of max|ref| (the 8 products summed in another order);
    bf16: 1e-2 (each output rounded to bf16).  C=3/6/4/32 cover 1, 2, 4 and
    8 channels per thread; inf / NaN / far coordinates must weigh 0."""
    x, coords, spatial = _case(sum(shape), *shape, dtype)
    out = fast_warp.warp_multi_pixel_cuda(x, *coords, spatial)
    ref = fast_warp.warp_multi_pixel_plain(x, *coords, spatial)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert_close(out.float(), ref.float(), 1e-5 if dtype == torch.float32 else 1e-2,
                 f"{shape} {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 16, 16, 4, 15), (2, 4, 8, 8, 32, 1),
                                   (1, 3, 5, 7, 3, 2), (2, 2, 6, 6, 6, 3)])
def test_backward_kernels_match_plain(dtype, shape):
    """dgrid: 1e-5 of max|ref| in both dtypes (fp32 sums of the same bf16 or
    fp32 products, in another order); dx: 1e-5 in fp32 (atomics add in
    another order), 1e-2 in bf16 (each output rounded to bf16 once).
    Integer, last-index, inf / NaN and far coordinates are in the mix."""
    x, coords, spatial = _case(sum(shape) + 1, *shape, dtype)
    N, K1, C = shape[0], shape[5], shape[4]
    g = torch.Generator(device="cuda").manual_seed(7)
    gout = torch.randn(N, *spatial, K1 * C, generator=g, device="cuda").to(dtype)
    for a, size in enumerate((spatial[2], spatial[1], spatial[0])):
        coords[a][:, :, :3] = torch.tensor([0.0, size - 1.0, 1.0], device="cuda")
    dx, dgrid = fast_warp.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial)
    rdx, rdgrid = fast_warp.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dx.shape == x.shape
    assert_close(dx.float(), rdx.float(), 1e-5 if dtype == torch.float32 else 1e-2, "dx")
    for a, (d, r) in enumerate(zip(dgrid, rdgrid)):
        assert d.dtype == torch.float32 and torch.isfinite(d).all()
        assert_close(d, r, 1e-5, f"dgrid {'xyz'[a]}")


def _with_last_index(coords, spatial):
    """The first three samples of every (n, k) at 0, the last index and 1
    on each axis (the upper corner of the last index lies outside)."""
    for a, size in enumerate((spatial[2], spatial[1], spatial[0])):
        coords[a][:, :, :3] = torch.tensor([0.0, size - 1.0, 1.0], device="cuda")
    return coords


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("K1", [2, 15, 16])
def test_dgrid_kernel_matches_plain_at_several_grids(K1, C, dtype):
    """Kernel 2 at K1 > 1 against its plain version, 1e-5 of max|ref| in
    both dtypes, on 3 x 11 x 13 = 429 voxels (two blocks of 256 per grid,
    the last ragged) with exact-integer, last-index, far-out, +-inf and NaN
    coordinates; and bit for bit against the same kernel at K1 = 1 run on
    each grid alone (the same products in the same order)."""
    N, spatial = 2, (3, 11, 13)
    x, coords, _ = _case(K1 * 10 + C, N, *spatial, C, K1, dtype)
    coords = _with_last_index(coords, spatial)
    g = torch.Generator(device="cuda").manual_seed(C)
    gout = torch.randn(N, *spatial, K1 * C, generator=g, device="cuda").to(dtype)
    dgrid = fast_warp.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial, False)[1]
    ref = fast_warp.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial, False)[1]
    per_k = [fast_warp.warp_multi_pixel_bwd_cuda(
        x, *(c[:, k:k + 1].contiguous() for c in coords),
        gout[..., k * C:(k + 1) * C].contiguous(), spatial, False)[1] for k in range(K1)]
    torch.cuda.synchronize()
    for a, (d, r) in enumerate(zip(dgrid, ref)):
        assert d.dtype == torch.float32 and torch.isfinite(d).all()
        assert_close(d, r, 1e-5, f"dgrid {'xyz'[a]}")
        assert torch.equal(d, torch.cat([p[a] for p in per_k], 1)), f"dgrid {'xyz'[a]} bits"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 3, 5, 6, 32])
@pytest.mark.parametrize("spatial", [(1, 17, 19), (16, 9, 11)])
def test_single_grid_forward_kernel_matches_plain(spatial, C, dtype):
    """Kernel 1 at K1 = 1 (the pixel kernel at C = 3 and 5, the channel-vector
    kernel otherwise) against its plain version, 1e-5 of max|ref| in fp32,
    1e-2 in bf16, at D = 1 (z exactly 0, as the TPS frame) and D = 16, N = 3
    (the samples of n > 0 start off any 16-byte boundary), with the probes
    of _case and the last index; and bit for bit against kernel 4 on the
    same samples."""
    N = 3
    x, coords, _ = _case(sum(spatial) + C, N, *spatial, C, 1, dtype)
    coords = _with_last_index(coords, spatial)
    if spatial[0] == 1:               # a frame: z is 0 but for the far / non-finite probes
        coords[2] = torch.where(coords[2].abs() < 100, torch.zeros_like(coords[2]), coords[2])
    out = fast_warp.warp_multi_pixel_cuda(x, *coords, spatial)
    ref = fast_warp.warp_multi_pixel_plain(x, *coords, spatial)
    grid = torch.stack([c * (2.0 / (s - 1)) - 1.0 if s > 1 else c
                        for c, s in zip(coords, spatial[::-1])], -1)
    grid = grid.reshape(N, *spatial, 3).contiguous()
    single = fast_warp.grid_sample_3d_cuda(x, grid, 1)
    pix = [((grid[..., a] + 1.0) * 0.5 * (s - 1)).reshape(N, 1, -1).contiguous()
           for a, s in enumerate(spatial[::-1])]
    multi = fast_warp.warp_multi_pixel_cuda(x, *pix, spatial)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape and torch.isfinite(out).all()
    assert_close(out.float(), ref.float(), 1e-5 if dtype == torch.float32 else 1e-2,
                 f"{spatial} C={C} {dtype}")
    assert torch.equal(multi.reshape(single.shape), single)


@pytest.mark.parametrize("N, D, H, W, C, K1", [(1, 16, 64, 64, 4, 15), (2, 4, 8, 8, 32, 1),
                                                (1, 16, 64, 64, 32, 1), (3, 1, 17, 19, 3, 1)])
def test_forward_wrappers_report_the_grid_they_launched(N, D, H, W, C, K1):
    """fast_warp.launch_grids holds each forward wrapper's last launch as the
    launch code wrote it back: 256 threads a block, one grid row per batch
    entry (kernel 1) or per grid (kernel 4, here at gps = K1), and enough
    blocks along x that every voxel has a thread (kernel 1 at K1 > 1: a tile
    of at most 64 voxels a block), and no more blocks than one voxel a block
    (K1 > 1) or one channel a thread (kernel 1 at K1 = 1).  Kernel 4: its
    voxel kernel (C = 4) takes 4 voxels a thread, v + j * 256 * blocks, its
    table kernel (C = 32 and 3) 256 voxels a block: every voxel in a block,
    and no block without one; its grid is the one fast_warp._grid_fwd_plan
    mirrors."""
    x, coords, spatial = _case(N + C + K1, N, D, H, W, C, K1, torch.float32)
    NV = D * H * W
    fast_warp.launch_grids.clear()
    fast_warp.warp_multi_pixel_cuda(x, *coords, spatial)
    gx, gy, gz, threads = fast_warp.launch_grids["warp_fwd"]
    assert (gy, gz, threads) == (N, 1, 256)
    if K1 > 1:
        assert NV <= gx * 64 and gx <= NV
    else:
        assert NV <= gx * 256 and gx <= -(-NV * C // 256)
    grid = torch.rand(N * K1, D, H, W, 3, device="cuda") * 2 - 1
    out = fast_warp.grid_sample_3d_cuda(x, grid, K1)
    gx, gy, gz, threads = fast_warp.launch_grids["grid_fwd"]
    assert (gy, gz, threads) == (N * K1, 1, 256)
    per_block = 1024 if C == 4 else 256
    assert NV <= gx * per_block < NV + per_block and (gx - 1) * 256 < NV
    kernel, plan = fast_warp._grid_fwd_plan(C, fast_warp._cpt(C, 4, x, out), NV, N * K1)
    assert plan == (gx, gy, gz, threads)
    assert kernel == ("voxel" if C == 4 else "table")


@contextlib.contextmanager
def _deterministic(on=True):
    """PyTorch's deterministic algorithms ``on`` (the wrappers then launch
    the dx kernels' deterministic variants) for the block, off after."""
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _deterministic_grads(fn, x):
    """x.grad after fn().sum().backward() under deterministic algorithms,
    strict and warn-only, with the launch counts of the two runs."""
    fast_warp.reset_launch_counts()
    grads = []
    try:
        for warn_only in (False, True):
            torch.use_deterministic_algorithms(True, warn_only=warn_only)
            x.grad = None
            fn().sum().backward()
            grads.append(x.grad.clone())
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    return grads, dict(fast_warp.launches)


def test_backward_skips_what_autograd_does_not_need():
    """Only dx is asked for: the dx kernel alone.  Under deterministic
    algorithms (warn-only too) the deterministic dx kernel instead, the same
    bits in both runs, within 1e-5 of max|ref| of the plain version."""
    x, coords, spatial = _case(3, 2, 4, 8, 8, 4, 3, torch.float32)
    x.requires_grad_()
    fast_warp.reset_launch_counts()
    fast_warp.warp_multi_pixel(x, *coords, spatial).sum().backward()
    assert fast_warp.launches["warp_bwd_dx"] == 1 and fast_warp.launches["warp_bwd_dgrid"] == 0
    grads, launches = _deterministic_grads(
        lambda: fast_warp.warp_multi_pixel(x, *coords, spatial), x)
    assert (launches["warp_bwd_dx_det"], launches["warp_bwd_dx"]) == (2, 0)
    assert torch.equal(grads[0], grads[1])
    gout = torch.ones(2, *spatial, 3 * 4, device="cuda")
    ref = fast_warp.warp_multi_pixel_bwd_plain(x.detach(), *coords, gout, spatial,
                                               need_dgrid=False)[0]
    assert_close(grads[0], ref, 1e-5, "deterministic dx")


def test_kernel_wrapper_refuses_what_it_cannot_take():
    x, coords, spatial = _case(0, 1, 2, 4, 4, 4, 2, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fast_warp.warp_multi_pixel_cuda(x.transpose(1, 2), *coords, spatial)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fast_warp.warp_multi_pixel_cuda(x.half(), *coords, spatial)
    with pytest.raises(ValueError, match="cgy"):
        fast_warp.warp_multi_pixel_cuda(x, coords[0], coords[1].cpu(), coords[2], spatial)


def _grid_case(seed, N, D, H, W, C, gps, dtype):
    """x, a normalized grid [N*gps,D,H,W,3] with exact integers, the last
    index, far-out, +-inf and NaN coordinates, and a cotangent."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, D, H, W, C, generator=g, device="cuda").to(dtype)
    size = torch.tensor([W, H, D], device="cuda", dtype=torch.float32)
    px = torch.rand(N * gps, D, H, W, 3, generator=g, device="cuda") * (size + 3) - 2
    pick = torch.rand(px.shape, generator=g, device="cuda")
    px = torch.where(pick < 0.1, px.round(), px)
    px = torch.where((pick >= 0.1) & (pick < 0.15), size - 1, px)
    grid = px * (2.0 / (size - 1)) - 1.0
    probes = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e30, -1e6],
                          device="cuda")
    grid = torch.where(pick > 0.98, probes[(pick * 1e4).long() % 5], grid).contiguous()
    gout = torch.randn(N * gps, D, H, W, C, generator=g, device="cuda").to(dtype)
    return x, grid, gout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 8, 8, 32, 1), (2, 4, 16, 16, 4, 16),
                                   (1, 3, 5, 7, 3, 2), (2, 2, 6, 6, 6, 3)])
def test_grid_kernels_match_plain(dtype, shape):
    """The single-grid forward, dgrid and dx kernels against their plain
    versions, gps = shape[-1]: forward and dx 1e-5 of max|ref| in fp32
    (sums in another order, atomics) and 1e-2 in bf16 (one rounding to
    bf16); dgrid 1e-5 in both (fp32 sums of the same products)."""
    x, grid, gout = _grid_case(sum(shape), *shape, dtype)
    gps = shape[-1]
    out = fast_warp.grid_sample_3d_cuda(x, grid, gps)
    dx, dgrid = fast_warp.grid_sample_3d_bwd_cuda(x, grid, gout, gps)
    ref = fast_warp.grid_sample_3d_plain(x, grid, gps)
    rdx, rdgrid = fast_warp.grid_sample_3d_bwd_plain(x, grid, gout, gps)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert out.dtype == dx.dtype == dtype and dgrid.dtype == torch.float32
    for what, a, r, rel in (("forward", out, ref, tol), ("dx", dx, rdx, tol),
                            ("dgrid", dgrid, rdgrid, 1e-5)):
        assert a.shape == r.shape and torch.isfinite(a).all(), what
        assert_close(a.float(), r.float(), rel, f"{what} {shape} {dtype}")


@pytest.mark.parametrize("gps", [1, 16])
def test_grid_kernel_agrees_with_the_multi_kernel(gps):
    """Kernel 4 at gps grids and kernel 1 at K1 = gps on the same samples
    (the pixel coordinates unnormalized as the kernel does) agree bit for
    bit: the same corner walk and the same fp32 sums."""
    N, D, H, W, C = 2, 4, 16, 16, 4
    x, grid, _ = _grid_case(5, N, D, H, W, C, gps, torch.float32)
    out = fast_warp.grid_sample_3d_cuda(x, grid, gps)
    coords = [((grid[..., a] + 1.0) * 0.5 * (size - 1)).reshape(N, gps, -1).contiguous()
              for a, size in enumerate((W, H, D))]
    multi = fast_warp.warp_multi_pixel_cuda(x, *coords, (D, H, W))
    multi = multi.reshape(N, -1, gps, C).permute(0, 2, 1, 3).reshape(out.shape)
    torch.cuda.synchronize()
    assert torch.equal(multi, out)


def test_grid_wrappers_refuse_what_they_cannot_take():
    x, grid, gout = _grid_case(1, 1, 2, 4, 4, 4, 2, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fast_warp.grid_sample_3d_cuda(x.cpu(), grid.cpu(), 2)
    with pytest.raises(ValueError, match="fp32"):
        fast_warp.grid_sample_3d_cuda(x, grid.double(), 2)
    with pytest.raises(ValueError, match="fp32"):
        fast_warp.grid_sample_3d_bwd_cuda(x, grid.bfloat16(), gout, 2)
    with pytest.raises(ValueError, match="N\\*gps"):
        fast_warp.grid_sample_3d_cuda(x, grid, 3)
    fast_warp.reset_launch_counts()
    xg = x.clone().requires_grad_()
    fast_warp.grid_sample_3d_fast(xg, grid, 2).sum().backward()
    assert (fast_warp.launches["grid_bwd_dx"], fast_warp.launches["grid_bwd_dgrid"]) == (1, 0)
    # deterministic algorithms (warn-only too): the deterministic dx kernel,
    # the same bits twice, within 1e-5 of max|ref| of the plain version
    grads, launches = _deterministic_grads(lambda: fast_warp.grid_sample_3d_fast(xg, grid, 2), xg)
    assert (launches["grid_bwd_dx_det"], launches["grid_bwd_dx"]) == (2, 0)
    assert torch.equal(grads[0], grads[1])
    ref = fast_warp.grid_sample_3d_bwd_plain(x, grid, torch.ones_like(gout), 2,
                                             need_dgrid=False)[0]
    assert_close(grads[0], ref, 1e-5, "deterministic dx")
    with _deterministic():
        gg = grid.clone().requires_grad_()           # dgrid alone has no atomics
        fast_warp.grid_sample_3d_fast(x, gg, 2).sum().backward()


def _site(site, cset, dtype, seed):
    """Kernels 1 and 3 at a main-path shape, batch cut to 2: MFE x
    [2,16,64,64,4] K1=15 or the Generator's x [2,16,64,64,32] K1=1, on MFE's
    sparse-motion coordinates (clean, or with exact integer, last-index,
    far-out and +-inf probes) or the noisy affine ones with the probes
    (warp_inputs' sets)."""
    from facevae_tpu_torch.warp_inputs import noisy_coords, sparse_motion_coords
    C, K1 = {"MFE": (4, 15), "Generator": (32, 1)}[site]
    D, H, W = 16, 64, 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    coords = (sparse_motion_coords(2, K1, D, H, W, g, probes=cset == "sparse+probes")
              if cset.startswith("sparse") else noisy_coords(2, K1, D, H, W, g))
    x = torch.randn(2, D, H, W, C, generator=g, device="cuda").to(dtype)
    gout = torch.randn(2, D, H, W, K1 * C, generator=g, device="cuda").to(dtype)
    return x, coords, gout, (D, H, W)


SITE_CASES = [("MFE", "sparse"), ("MFE", "sparse+probes"), ("MFE", "noisy"),
              ("Generator", "noisy"), ("Generator", "sparse"), ("Generator", "sparse+probes")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site, cset", SITE_CASES)
def test_kernels_1_and_3_match_plain_at_call_sites(site, cset, dtype):
    """Kernel 1 (the tile kernel at K1=15) and kernel 3 against their plain
    versions: 1e-5 of max|ref| in fp32, 1e-2 in bf16."""
    x, coords, gout, spatial = _site(site, cset, dtype, 11)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    out = fast_warp.warp_multi_pixel_cuda(x, *coords, spatial)
    ref = fast_warp.warp_multi_pixel_plain(x, *coords, spatial)
    rdx = fast_warp.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial, need_dgrid=False)[0]
    dx = fast_warp.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial, need_dgrid=False)[0]
    torch.cuda.synchronize()
    assert dx.dtype == dtype and torch.isfinite(dx).all()
    assert_close(dx.float(), rdx.float(), tol, "dx")
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert_close(out.float(), ref.float(), tol, "forward")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cset", ["sparse", "sparse+probes"])
def test_kernels_2_and_6_match_plain_on_the_generator_sets(cset, dtype):
    """At the Generator's shape (batch cut to 2) on one keypoint's smooth
    motion, clean and with the probes, where the dx kernels' lanes pair:
    kernel 2 (4 lanes of 2 vectors a voxel fp32, 1 of 4 bf16) and kernel 6
    (lane distance C / CPT = 8 fp32, 4 bf16) against their plain versions, with
    kernels 4 and 5 on the same normalized grid: dgrid 1e-5 of max|ref| in
    both dtypes, forward and dx 1e-5 fp32, 1e-2 bf16."""
    from facevae_tpu_torch.warp_inputs import normalized
    x, coords, gout, spatial = _site("Generator", cset, dtype, 21)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    fast_warp.reset_launch_counts()
    dgrid = fast_warp.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial, need_dx=False)[1]
    rdgrid = fast_warp.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial, need_dx=False)[1]
    grid = normalized(coords, *spatial)
    out = fast_warp.grid_sample_3d_cuda(x, grid, 1)
    gdx, gdgrid = fast_warp.grid_sample_3d_bwd_cuda(x, grid, gout, 1)
    ref = fast_warp.grid_sample_3d_plain(x, grid, 1)
    rgdx, rgdgrid = fast_warp.grid_sample_3d_bwd_plain(x, grid, gout, 1)
    torch.cuda.synchronize()
    assert (fast_warp.launches["warp_bwd_dgrid"], fast_warp.launches["grid_bwd_dx"]) == (1, 1)
    for a, (d, r) in enumerate(zip(dgrid, rdgrid)):
        assert torch.isfinite(d).all()
        assert_close(d, r, 1e-5, f"kernel 2 {cset} {'xyz'[a]}")
    for what, a, r, rel in (("kernel 4", out, ref, tol), ("kernel 6", gdx, rgdx, tol),
                            ("kernel 5", gdgrid, rgdgrid, 1e-5)):
        assert a.shape == r.shape and torch.isfinite(a).all(), what
        assert_close(a.float(), r.float(), rel, f"{what} {cset} {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cset", ["sparse", "sparse+probes"])
def test_grid_dx_deterministic_matches_the_emulation_on_the_generator_sets(cset, dtype):
    """Kernel 6's deterministic variant pairs lanes at distance C / CPT (8
    fp32, 4 bf16) before its int64 atomics: the bits of the unpaired
    fixed-point emulation (and of the paired one, tests/torch_parity.py),
    twice, at the Generator's shape (batch cut to 2)."""
    from facevae_tpu_torch.warp_inputs import normalized
    from torch_parity import fixed_point_dx, paired_dx
    x, coords, gout, spatial = _site("Generator", cset, dtype, 22)
    grid = normalized(coords, *spatial)
    with _deterministic():
        runs = [fast_warp.grid_sample_3d_bwd_cuda(x, grid, gout, 1, need_dgrid=False)[0]
                for _ in range(2)]
    torch.cuda.synchronize()
    N, C = x.shape[0], x.shape[-1]
    pix = [c.contiguous() for c in fast_warp._grid_pixels(x.cpu(), grid.cpu(), 1)]
    s = int(fast_warp.dx_scale_exponent(gout, x[0, ..., 0].numel()))
    rows = gout.cpu().float().reshape(N, -1, C)
    emulated = fixed_point_dx(tuple(x.shape), pix, rows, s)
    assert torch.equal(paired_dx(tuple(x.shape), pix, rows, C // (16 // x.element_size()), s),
                       emulated)
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0].cpu(), emulated.to(dtype))


def test_dgrid_kernel_past_65535_voxel_blocks():
    """Kernel 2's grid puts voxel block * K1 + k on blockIdx.x: 65537 voxel
    blocks of 256 voxels (C = 4 fp32: one lane a voxel) at K1 = 2 run, and
    match the plain version at 1e-5 of max|ref|; N = 65536 sources are
    refused before any launch (blockIdx.y holds 65535)."""
    N, K1, spatial, C = 1, 2, (1, 257, 65537), 4
    g = torch.Generator(device="cuda").manual_seed(23)
    NV = spatial[1] * spatial[2]
    assert -(-NV // 256) > 65535
    x = torch.randn(N, *spatial, C, generator=g, device="cuda")
    size = torch.tensor([spatial[2], spatial[1], 1], device="cuda").reshape(3, 1, 1, 1)
    c = torch.rand(3, N, K1, NV, generator=g, device="cuda") * (size + 2) - 1
    coords = [c[a].contiguous() for a in range(3)]
    gout = torch.randn(N, *spatial, K1 * C, generator=g, device="cuda")
    fast_warp.reset_launch_counts()
    dgrid = fast_warp.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial, need_dx=False)[1]
    rdgrid = fast_warp.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial, need_dx=False)[1]
    torch.cuda.synchronize()
    assert fast_warp.launches["warp_bwd_dgrid"] == 1
    for a, (d, r) in enumerate(zip(dgrid, rdgrid)):
        assert_close(d, r, 1e-5, f"dgrid {'xyz'[a]}")
    del x, coords, gout, dgrid, rdgrid, c
    xs = torch.zeros(65536, 1, 1, 1, 4, device="cuda")
    cs = [torch.zeros(65536, 1, 1, device="cuda") for _ in range(3)]
    with pytest.raises(ValueError, match="N=65536"):
        fast_warp.warp_multi_pixel_bwd_cuda(xs, *cs, torch.zeros_like(xs), (1, 1, 1),
                                            need_dx=False)
    assert fast_warp.launches["warp_bwd_dgrid"] == 1
    dgrid = fast_warp.warp_multi_pixel_bwd_cuda(xs[:65535], *(c[:65535] for c in cs),
                                                xs[:65535], (1, 1, 1), need_dx=False)[1]
    torch.cuda.synchronize()
    assert all(torch.equal(d, torch.zeros_like(d)) for d in dgrid)


def test_pairing_share_at_the_generator_sets():
    """The share of kernel 6's float4 atomics the pairing saves at the fp32
    Generator call (lane distance 8), counted by the CPU model
    (tests/torch_parity.py:pairing_counts) on the sets the kernel is timed
    on: the Generator's own grid in the first full-width training step
    (bench_warp.generator_step_inputs), one keypoint's sparse motion, the
    noisy set.  Printed (``-s``); at most 3 of each 4 upper corners pair."""
    from facevae_tpu_torch import bench_warp
    from facevae_tpu_torch.warp_inputs import noisy_coords, sparse_motion_coords
    from torch_parity import pairing_counts
    spatial = (16, 64, 64)
    g = torch.Generator(device="cuda").manual_seed(0)
    x, grid = bench_warp.generator_step_inputs("float32")
    sets = {"step": fast_warp._grid_pixels(x, grid, 1),
            "sparse": sparse_motion_coords(8, 1, *spatial, g),
            "noisy": noisy_coords(8, 1, *spatial, g)}
    for name, coords in sets.items():
        issued, unpaired = pairing_counts([c.cpu() for c in coords], spatial, 8)
        saved = 1 - issued / unpaired
        print(f"[pairing] Generator {name}, lane distance 8: {unpaired} float4 atomics "
              f"unpaired, {issued} paired, {saved:.4f} saved")
        assert 0 <= saved <= 0.375


@pytest.mark.parametrize("deterministic", [False, True])
def test_dx_with_a_non_finite_cotangent(deterministic):
    """A cotangent holding an inf and a NaN: the dx voxels those samples
    touch are non-finite where the plain version's are, and every other
    voxel is within 1e-5 of it, from the default and the deterministic dx
    kernel (whose flags give NaN / inf by IEEE's sum rules)."""
    x, coords, gout, spatial = _site("MFE", "sparse", torch.float32, 16)
    # two samples of source 0 with all 8 corners inside the volume (the plain
    # version would also add 0 * nan at the index it clamps outer corners to)
    inside = functools.reduce(torch.logical_and, [(c[0] > 0.5) & (c[0] < size - 1.5)
                                                  for c, size in zip(coords, (64, 64, 16))])
    (k0, v0), (k1, v1) = inside.nonzero()[[0, -1]].tolist()
    gout = gout.clone()
    per_k = gout[0].view(-1, 15, 4)
    per_k[v0, k0, 0], per_k[v1, k1, 2] = float("nan"), float("inf")
    fast_warp.reset_launch_counts()
    with _deterministic(deterministic):
        dx = fast_warp.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial, need_dgrid=False)[0]
    ref = fast_warp.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial, need_dgrid=False)[0]
    torch.cuda.synchronize()
    assert fast_warp.launches["warp_bwd_dx_det" if deterministic else "warp_bwd_dx"] == 1
    bad = ~torch.isfinite(ref)
    assert bad.any() and torch.equal(~torch.isfinite(dx), bad)
    assert torch.equal(torch.isnan(dx), torch.isnan(ref))
    assert_close(torch.where(bad, 0.0, dx), torch.where(bad, 0.0, ref), 1e-5, "finite part")


def _stepped_coords(N, K1, spatial, step, g):
    """Pixel coordinates [3][N,K1,NV] whose x advances by exactly ``step``
    per voxel along W (so neighbouring lanes share corners), y and z the
    voxel's own, each (n, k) shifted by a random offset (0 for k = 0: exact
    integers there, the upper corners weighing 0)."""
    D, H, W = spatial
    z, y, x = torch.meshgrid(*(torch.arange(s, device="cuda", dtype=torch.float32)
                               for s in spatial), indexing="ij")
    shift = torch.rand(3, N, K1, 1, generator=g, device="cuda") * 2 - 1
    shift[:, :, 0] = 0
    return [(base.reshape(1, 1, -1) * scale + shift[a]).contiguous()
            for a, (base, scale) in enumerate(((x, step), (y, 1.0), (z, 1.0)))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step, C", [(1.0, 4), (0.5, 4), (1.0, 64), ("noisy", 4)])
def test_dx_lane_pairing_matches_plain(step, C, dtype):
    """Kernel 3 pairs lane i's upper x corner with lane i + 1's lower one:
    on maps whose x-step is exactly 1 (every pair meets) and 0.5 (every
    other), and on the noisy set (scattered), against the plain version
    (1e-5 of max|ref| fp32, 1e-2 bf16).  C = 64 holds no vectors in
    registers (16 fp32 vectors).  The deterministic kernel gives the bits of
    the fixed-point emulation (torch_parity.fixed_point_dx), which sums the
    same rounded contributions without pairing, and the same bits with the
    K1 grids permuted."""
    from facevae_tpu_torch.warp_inputs import noisy_coords
    from torch_parity import fixed_point_dx
    N, K1, spatial = 2, 15, (3, 8, 64)
    g = torch.Generator(device="cuda").manual_seed(C)
    coords = (noisy_coords(N, K1, *spatial, g) if step == "noisy"
              else _stepped_coords(N, K1, spatial, step, g))
    x = torch.randn(N, *spatial, C, generator=g, device="cuda").to(dtype)
    gout = torch.randn(N, *spatial, K1 * C, generator=g, device="cuda").to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    fast_warp.reset_launch_counts()
    dx = fast_warp.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial, need_dgrid=False)[0]
    perm = torch.randperm(K1, generator=torch.Generator().manual_seed(1)).cuda()
    pgout = gout.reshape(N, -1, K1, C)[:, :, perm].reshape(gout.shape).contiguous()
    with _deterministic():
        det = fast_warp.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial,
                                                  need_dgrid=False)[0]
        det_perm = fast_warp.warp_multi_pixel_bwd_cuda(
            x, *(c[:, perm].contiguous() for c in coords), pgout, spatial, need_dgrid=False)[0]
    ref = fast_warp.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial, need_dgrid=False)[0]
    torch.cuda.synchronize()
    assert (fast_warp.launches["warp_bwd_dx"], fast_warp.launches["warp_bwd_dx_det"]) == (1, 2)
    assert_close(dx.float(), ref.float(), tol, "dx")
    assert_close(det.float(), ref.float(), tol, "deterministic dx")
    assert torch.equal(det, det_perm)
    s = int(fast_warp.dx_scale_exponent(gout, K1 * spatial[0] * spatial[1] * spatial[2]))
    rows = fast_warp._gout_k_major(gout, torch.float32, N, K1, x[0, ..., 0].numel(), C)
    emulated = fixed_point_dx(tuple(x.shape), [c.cpu() for c in coords], rows.cpu(), s)
    assert torch.equal(det.cpu(), emulated.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [4, 5, 8, 32])
def test_grid_dgrid_kernel_matches_plain(C, dtype):
    """Kernel 5 runs LANES threads per voxel (C / CPT rounded up to a power
    of two: 1, 8, 2, 8 fp32; 1, 8, 1, 4 bf16) and reduces with shuffles:
    1e-5 of max|ref| of the plain version in both dtypes (fp32 sums of the
    same products in another order), on 3 x 11 x 13 voxels (the last block
    ragged) at gps = 2 with integer, last-index, far-out, +-inf and NaN
    coordinates."""
    x, grid, gout = _grid_case(C, 2, 3, 11, 13, C, 2, dtype)
    fast_warp.reset_launch_counts()
    dgrid = fast_warp.grid_sample_3d_bwd_cuda(x, grid, gout, 2, need_dx=False)[1]
    ref = fast_warp.grid_sample_3d_bwd_plain(x, grid, gout, 2, need_dx=False)[1]
    torch.cuda.synchronize()
    assert fast_warp.launches["grid_bwd_dgrid"] == 1
    assert dgrid.dtype == torch.float32 and torch.isfinite(dgrid).all()
    assert_close(dgrid, ref, 1e-5, f"dgrid C={C} {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_dx_deterministic_matches_the_emulation(dtype):
    """Kernel 6's deterministic variant gives the bits of the fixed-point
    emulation, twice, at gps = 3."""
    from torch_parity import fixed_point_dx
    x, grid, gout = _grid_case(9, 2, 3, 11, 13, 8, 3, dtype)
    with _deterministic():
        runs = [fast_warp.grid_sample_3d_bwd_cuda(x, grid, gout, 3, need_dgrid=False)[0]
                for _ in range(2)]
    torch.cuda.synchronize()
    N, D, H, W, C = x.shape
    coords = fast_warp._grid_pixels(x.cpu(), grid.cpu(), 3)
    s = int(fast_warp.dx_scale_exponent(gout, 3 * D * H * W))
    emulated = fixed_point_dx(tuple(x.shape), coords,
                              gout.cpu().float().reshape(N, -1, C), s)
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0].cpu(), emulated.to(dtype))


def test_tile_kernel_agrees_with_the_grid_kernel_at_mfe():
    """Kernel 1's tile kernel at K1 = 15 and kernel 4 at gps = 15 on the same
    samples (x [2,16,64,64,4]): bit for bit."""
    x, coords, _, spatial = _site("MFE", "sparse+probes", torch.float32, 14)
    N, K1, C = 2, 15, 4
    grid = torch.stack([c * (2.0 / (s - 1)) - 1.0 for c, s in zip(coords, (64, 64, 16))], -1)
    grid = grid.reshape(N * K1, *spatial, 3).contiguous()
    single = fast_warp.grid_sample_3d_cuda(x, grid, K1)
    pix = [((grid[..., a] + 1.0) * 0.5 * (s - 1)).reshape(N, K1, -1).contiguous()
           for a, s in enumerate((64, 64, 16))]
    multi = fast_warp.warp_multi_pixel_cuda(x, *pix, spatial)
    multi = multi.reshape(N, -1, K1, C).permute(0, 2, 1, 3).reshape(single.shape)
    torch.cuda.synchronize()
    assert torch.equal(multi, single)


def test_golden_pipeline_runs_through_the_kernel():
    z = np.load(golden.GOLDEN)
    variables = nested_from_flat({k[len("var/"):]: z[k] for k in z.files if k.startswith("var/")})
    cfg = tiny_config()
    models = build_models(cfg.model, device="cuda")
    for name, m in models.items():
        load_jax_variables(m, variables[name])
    pipe = InferencePipeline(cfg, models)
    enc = pipe.encode_source(torch.from_numpy(z["in/source"]).cuda())
    fast_warp.reset_launch_counts()
    out = pipe.drive_frame(*enc, torch.from_numpy(z["in/driving"]).cuda())
    assert fast_warp.launches == {**dict.fromkeys(fast_warp.launches, 0),
                                  "warp_fwd": 1, "grid_fwd": 1}
    assert_close(out, z["out/drive"], 1e-4, "drive_frame")


# per step: fp32 runs MFE through the multi-grid kernels and the Generator
# through the single-grid ones; bf16 runs MFE, the Generator and the TPS
# warp (forward only) through the multi-grid kernels
STEP_LAUNCHES = {"float32": {"warp_fwd": 1, "warp_bwd_dgrid": 1, "warp_bwd_dx": 1,
                             "grid_fwd": 1, "grid_bwd_dgrid": 1, "grid_bwd_dx": 1},
                 "bfloat16": {"warp_fwd": 3, "warp_bwd_dgrid": 2, "warp_bwd_dx": 2}}


@pytest.mark.parametrize("fused", [False, True], ids=["four_tuple", "fused_aug"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_training_step_runs_through_the_kernels(dtype, fused):
    """A tiny_config() step on the card: finite losses, the warp kernels
    launched as STEP_LAUNCHES says (with the fused augmentation, kernel 1
    twice more: one launch a batch of views), their plain versions never;
    parameters and Adam state stay fp32."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    state = create_train_state(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = tuple(torch.rand(2, 64, 64, 3, generator=g, device="cuda") for _ in range(4))
    if fused:
        batch = tuple((b * 255).to(torch.uint8) for b in batch[:2])
    fast_warp.reset_launch_counts()
    out = train_step(state, batch, generator=g, fused_aug=fused)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in {**out["losses_g"], **out["losses_d"]}.values())
    want = {**dict.fromkeys(fast_warp.launches, 0), **STEP_LAUNCHES[dtype]}
    want["warp_fwd"] += 2 * fused
    assert fast_warp.launches == want
    assert {p.dtype for m in state.nets.values() for p in m.parameters()} == {torch.float32}
    assert {v.dtype for opt in (state.g_opt, state.d_opt) for st in opt.state.values()
            for v in st.values()} == {torch.float32}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [48, 256])
def test_kernel_1_matches_plain_at_the_augmentation_site(size, dtype):
    """Kernel 1 at data/device_aug.py's call: frames [8,1,size,size,3] at
    K1 = 1 on the homography coordinates of frame_draws (clamped to the
    image): fp32 within 1e-5 of max|ref|; bf16 within one bf16 step at
    max|ref|, at most 2^-7 of it (the same fp32 sum, in another order,
    rounded to bf16).  On the card the augmentation sends bf16 rows through
    the kernel, one launch a batch, and its warp lies within 2^-7 of
    max|ref| of the fp32 warp on the CPU (the rows' and the output's
    roundings, half a bf16 step each)."""
    from facevae_tpu_torch.config import DataConfig
    from facevae_tpu_torch.data import device_aug
    g = torch.Generator(device="cuda").manual_seed(size)
    draws = device_aug.frame_draws(g, 8, size, DataConfig())
    gx, gy = device_aug._warp_coords(draws.homography, size, size)
    coords = [gx[:, None].contiguous(), gy[:, None].contiguous()]
    coords.append(torch.zeros_like(coords[0]))
    assert float(gx.min()) >= 0 and float(gx.max()) <= size - 1
    frames = torch.rand(8, size, size, 3, generator=g, device="cuda")
    x = frames.to(dtype)[:, None].contiguous()
    out = fast_warp.warp_multi_pixel_cuda(x, *coords, (1, size, size))
    ref = fast_warp.warp_multi_pixel_plain(x, *coords, (1, size, size))
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape and torch.isfinite(out).all()
    assert_close(out.float(), ref.float(), 1e-5 if dtype == torch.float32 else 2.0 ** -7,
                 f"aug site {size} {dtype}")
    fast_warp.reset_launch_counts()
    warped = device_aug._warp_batch(frames, gx, gy)
    torch.cuda.synchronize()
    assert fast_warp.launches["warp_fwd"] == 1 and fast_warp.launches["warp_fwd_plain"] == 0
    cpu = device_aug._warp_batch(frames.cpu(), gx.cpu(), gy.cpu())
    assert_close(warped.cpu(), cpu, 2.0 ** -7, f"aug warp card vs CPU {size}")


def _state_tensors(state):
    """Every tensor a checkpoint holds, by name, on the host."""
    out = {f"{n}.{k}": v.cpu() for n, net in state.nets.items()
           for k, v in net.state_dict().items()}
    for key in ("g_opt", "d_opt"):
        opt = getattr(state, key)
        for i, p in enumerate(p for g in opt.param_groups for p in g["params"]):
            out.update({f"{key}[{i}].{k}": v.cpu() for k, v in opt.state[p].items()})
    return out


def test_checkpoint_from_the_card_loads_on_the_cpu_and_back(tmp_path):
    """A tiny_config() state stepped on the card, saved, loaded into a CPU
    state, saved from there and loaded on the card again: every tensor
    (Adam state included), epoch and step bit for bit, and the two files
    byte for byte."""
    from facevae_tpu_torch.train import checkpoint
    cfg = tiny_config()
    state = create_train_state(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = tuple(torch.rand(2, 64, 64, 3, generator=g, device="cuda") for _ in range(4))
    train_step(state, batch, generator=g)
    state.epoch = 3
    a = checkpoint.save_checkpoint(str(tmp_path / "card"), state, 3)
    cpu = checkpoint.load_checkpoint(str(tmp_path / "card"), 3, create_train_state(cfg, "cpu"))
    b = checkpoint.save_checkpoint(str(tmp_path / "cpu"), cpu, 3)
    back = checkpoint.load_checkpoint(str(tmp_path / "cpu"), 3, create_train_state(cfg, "cuda"))
    want = _state_tensors(state)
    assert len(want) > 2 * sum(1 for m in state.nets.values() for _ in m.parameters())
    for other in (cpu, back):
        got = _state_tensors(other)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert (other.epoch, other.step) == (3, 1)
    assert all(p.is_cuda for m in back.nets.values() for p in m.parameters())
    with open(a, "rb") as f, open(b, "rb") as h:
        assert f.read() == h.read()


def test_build_models_defaults_to_the_card():
    models = build_models(tiny_config().model, names=("generator",))
    assert all(p.is_cuda for p in models["generator"].parameters())


def _probe_coords(g, shape, size):
    """Pixel coordinates [3][shape] over [-2, size + 1] with 10% integers and
    2% NaN / +-inf / far-out probes."""
    out = []
    for s in size:
        c = torch.rand(shape, generator=g, device="cuda") * (s + 3) - 2
        pick = torch.rand(shape, generator=g, device="cuda")
        c = torch.where(pick < 0.1, c.round(), c)
        probes = torch.tensor([float("nan"), float("inf"), float("-inf"), 1e30, -1e6],
                              device="cuda")
        out.append(torch.where(pick > 0.98, probes[(pick * 1e4).long() % 5], c).contiguous())
    return out


def test_probe_gather_kernels_equal_plain():
    """Probes 9 and 10: bit for bit, out-of-range indices read 0."""
    g = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randn(5, 300, generator=g, device="cuda")
    idx = torch.randint(-4, 304, (5, 77), generator=g, device="cuda", dtype=torch.int32)
    p9.reset_launch_counts()
    out = p9.gather(table, idx)
    assert torch.equal(out, p9.gather_plain(table, idx))
    data = torch.randn(24, 100, generator=g, device="cuda").bfloat16()
    lidx = torch.randint(-3, 103, (6, 1, 40), generator=g, device="cuda", dtype=torch.int32)
    p10.reset_launch_counts()
    out = p10.lane_gather(data, lidx)
    assert torch.equal(out, p10.lane_gather_plain(data, lidx))
    assert p9.launches == {"probe_gather": 1, "probe_gather_plain": 1}
    assert p10.launches == {"probe_lane_gather": 1, "probe_lane_gather_plain": 1}


@pytest.mark.parametrize("S, T, P, offset", [c + (0,) for c in p9.CASES]
                         + [(3, 100, 77, 0), (2, 50, 6, 0), (4, 64, 32, 1)])
def test_probe_gather_kernel_equals_plain_at_each_case(S, T, P, offset):
    """Kernel 9 bit for bit at the probe's seven cases (its 16-byte form),
    at a P that is not a multiple of 4 and at an idx 4 bytes past 16-byte
    alignment (its scalar form), with out-of-range indices in the mix; the
    launch floor's empty kernel takes the same arguments."""
    table_np, idx_np = p9.inputs(S, T, P, seed=S + P)
    idx_np[:, ::7] += T                                    # past the row: reads 0
    idx_np[:, 3::11] -= 2 * T                              # negative: reads 0
    table = torch.from_numpy(table_np).cuda()
    idx = torch.from_numpy(np.concatenate([np.zeros(offset, np.int32), idx_np.ravel()]))
    idx = idx.cuda()[offset:].view(S, P)
    assert (idx.data_ptr() % 16 == 0) == (offset == 0)
    p9.reset_launch_counts()
    out = p9.gather_cuda(table, idx)
    assert torch.equal(out, p9.gather_plain(table, idx))
    assert torch.equal(out.cpu(), torch.from_numpy(np.where(
        (idx_np >= 0) & (idx_np < T),
        np.take_along_axis(table_np, np.clip(idx_np, 0, T - 1), -1), 0).astype(np.float32)))
    assert p9.launches == {"probe_gather": 1, "probe_gather_plain": 1}
    p9.gather_floor_cuda(table, idx)
    torch.cuda.synchronize()


@pytest.mark.parametrize("C", [1, 2, 4])
def test_probe_warp_kernel_matches_plain(C):
    """Probe 7: 1e-5 of max|ref| (the same 8 products summed in another
    order); NaN / inf / far coordinates weigh 0."""
    g = torch.Generator(device="cuda").manual_seed(C)
    D, H, W, P = 3, 5, 7, 1000
    volT = torch.randn(C * W, D * H, generator=g, device="cuda")
    coords = [c[None] for c in _probe_coords(g, (P,), (W, H, D))]
    out = p7.proto_warp_cuda(volT, *coords, (D, H, W, C))
    ref = p7.proto_warp_plain(volT, *coords, (D, H, W, C))
    torch.cuda.synchronize()
    assert out.shape == (P, C) and torch.isfinite(out).all()
    assert_close(out, ref, 1e-5, f"probe_warp C={C}")


@pytest.mark.parametrize("mode", p8.MODES)
@pytest.mark.parametrize("shape", [(2, 4, 8, 8, 4, 3, 64), (1, 3, 6, 6, 1, 2, 27),
                                   (2, 5, 4, 9, 2, 1, 20)])
@pytest.mark.parametrize("budget", [1, 12, 1000])
def test_probe_banded_warp_kernel_matches_plain(mode, shape, budget):
    """Probe 8 in each mode: 1e-5 of max|ref| of the plain version and of
    kernel 1 on the same values (bandonly only where every box fits); the
    boxes it stages are those staged_flags reckons.  C*W = 6 and 18 take the
    2-byte staging copy; a budget of 1000 rows needs more than 48 KB."""
    N, D, H, W, C, K1, VB = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + budget)
    rows3 = torch.randn(N, D * H, C * W, generator=g, device="cuda").bfloat16()
    z, y, x = torch.meshgrid(*(torch.arange(s, device="cuda") for s in (D, H, W)), indexing="ij")
    coords = [(base.reshape(1, 1, -1).float() + torch.randn(N, K1, D * H * W, generator=g,
                                                              device="cuda")).contiguous()
              for base in (x, y, z)]
    wild = _probe_coords(g, (N, K1, D * H * W), (W, H, D))
    pick = torch.rand(N, K1, D * H * W, generator=g, device="cuda") < 0.05
    coords = [torch.where(pick, w, c).contiguous() for c, w in zip(coords, wild)]
    staged = torch.zeros(N, D * H * W // VB, K1, dtype=torch.uint8, device="cuda")
    out = p8.banded_warp_cuda(rows3, *coords, (D, H, W, C), mode, VB, budget, staged)
    ref = p8.banded_warp_plain(rows3, *coords, (D, H, W, C), mode, VB, budget)
    kernel1 = fast_warp.warp_multi_pixel_cuda(p8.rows3_to_x(rows3, (D, H, W, C)).float(),
                                              *coords, (D, H, W))
    torch.cuda.synchronize()
    host = p8.staged_flags(*(c.cpu().numpy() for c in coords[1:]), D, H, VB, budget, mode)
    np.testing.assert_array_equal(staged.bool().cpu().numpy(), host)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    if mode != "bandonly" or host.all():
        assert_close(out, ref, 1e-5, f"{mode} vs plain")
        assert_close(out, kernel1.reshape(out.shape), 1e-5, f"{mode} vs kernel 1")


def _edge_coords(g, shape, size):
    """_probe_coords plus 3% exact last indices (size - 1) and 3% a half
    step before them."""
    out = []
    for c, s in zip(_probe_coords(g, shape, size), size):
        pick = torch.rand(shape, generator=g, device="cuda")
        c = torch.where(pick < 0.03, torch.full_like(c, s - 1.0), c)
        out.append(torch.where((pick >= 0.03) & (pick < 0.06), torch.full_like(c, s - 1.5),
                               c).contiguous())
    return out


@pytest.mark.parametrize("shape", [(3, 5, 7), (4, 6, 10), (2, 33, 17), (16, 64, 64)])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_probe_warp_kernel_equals_kernel_1(shape, C):
    """Probe 7 (the relayout and the sampler) against kernel 1 at K1 = 1 on
    the same volume, bit for bit (the same products in the same order: the
    parent's bits, which bench_warp.py --probes holds through digests), and
    against its plain version at 1e-5 of max|ref|, at tile edges ((z, y) and
    x not multiples of the relayout tile) and the probe's own size, with
    integer, last-index, far-out, NaN and +-inf coordinates."""
    D, H, W = shape
    P = D * H * W
    g = torch.Generator(device="cuda").manual_seed(P + C)
    volT = torch.randn(C * W, D * H, generator=g, device="cuda")
    coords = [c[None] for c in _edge_coords(g, (P,), (W, H, D))]
    p7.reset_launch_counts()
    out = p7.proto_warp_cuda(volT, *coords, (D, H, W, C))
    x = volT.reshape(C, W, D, H).permute(2, 3, 1, 0)[None].contiguous()
    kernel1 = fast_warp.warp_multi_pixel_cuda(x, *(c[None] for c in coords), shape)
    ref = p7.proto_warp_plain(volT, *coords, (D, H, W, C))
    torch.cuda.synchronize()
    assert p7.launches == {"probe_warp": 1, "probe_warp_plain": 1}
    assert out.shape == (P, C) and torch.isfinite(out).all()
    assert torch.equal(out, kernel1.reshape(P, C))
    assert_close(out, ref, 1e-5, f"probe_warp {shape} C={C}")


def _theta_coords(theta):
    """The probe's inputs and its timed grids at theta (its RandomState(0)
    draws, in its order)."""
    _, rows3, coords = p8.inputs()
    coords(3.0)                                   # the numerics draw
    for t in p8.THETAS:
        cg = coords(t)
        if t == theta:
            return rows3, cg


@pytest.mark.parametrize("theta", p8.THETAS)
def test_probe_banded_warp_equals_kernel_1_at_the_probe(theta):
    """Probe 8 at its own call, every mode: bit for bit kernel 1 on the
    same values in fp32 (bandonly where every box fits), the staged flags
    as staged_flags reckons."""
    rows3_np, cg_np = _theta_coords(theta)
    rows3 = torch.from_numpy(rows3_np).cuda().bfloat16()
    cg = [torch.from_numpy(a).cuda() for a in cg_np]
    shape = (p8.D, p8.H, p8.W, p8.C)
    kernel1 = fast_warp.warp_multi_pixel_cuda(p8.rows3_to_x(rows3, shape).float(), *cg,
                                              shape[:3]).reshape(p8.N, -1, p8.K1 * p8.C)
    for mode in p8.MODES:
        host = p8.staged_flags(cg_np[1], cg_np[2], p8.D, p8.H, p8.VB, p8.BUDGET, mode)
        staged = torch.zeros(host.shape, dtype=torch.uint8, device="cuda")
        out = p8.banded_warp_cuda(rows3, *cg, shape, mode, staged=staged)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(staged.bool().cpu().numpy(), host)
        if mode != "bandonly" or host.all():
            assert torch.equal(out, kernel1), (theta, mode)


@pytest.mark.parametrize("W", [8, 7])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_probe_banded_warp_at_the_budget_and_edge_coordinates(W, C):
    """Probe 8 with one box exactly at the budget (staged) beside larger
    ones (not), at budget 1, with integer, last-index, far-out, NaN and
    +-inf coordinates; W = 7 takes the 2-byte staging copy and loads: every
    mode bit for bit kernel 1 (bandonly where every box fits), within 1e-5
    of the plain version, its flags those of staged_flags."""
    N, D, H, K1, VB = 2, 4, 16, 3, 32
    NV = D * H * W
    g = torch.Generator(device="cuda").manual_seed(W * 10 + C)
    rows3 = torch.randn(N, D * H, C * W, generator=g, device="cuda").bfloat16()
    z, y, x = torch.meshgrid(*(torch.arange(s, device="cuda") for s in (D, H, W)), indexing="ij")
    coords = [(base.reshape(1, 1, -1).float() + 0.5 * torch.randn(
        N, K1, NV, generator=g, device="cuda")).contiguous() for base in (x, y, z)]
    wild = _edge_coords(g, (N, K1, NV), (W, H, D))
    pick = torch.rand(N, K1, NV, generator=g, device="cuda") < 0.2
    pick[..., 2 * VB:] = False                    # the first two blocks: the wild ones
    coords = [torch.where(pick, w, c).contiguous() for c, w in zip(coords, wild)]
    cg_np = [c.cpu().numpy() for c in coords]
    shape = (D, H, W, C)
    kernel1 = fast_warp.warp_multi_pixel_cuda(p8.rows3_to_x(rows3, shape).float(), *coords,
                                              (D, H, W)).reshape(N, -1, K1 * C)
    rows = p8.box_rows(cg_np[1], cg_np[2], D, H, VB, "banded")
    sizes = np.unique(rows)
    at = int(sizes[len(sizes) // 2])
    assert at >= 1 and (rows > at).any()
    for budget in (at, 1):
        for mode in p8.MODES:
            host = p8.staged_flags(cg_np[1], cg_np[2], D, H, VB, budget, mode)
            staged = torch.zeros(host.shape, dtype=torch.uint8, device="cuda")
            out = p8.banded_warp_cuda(rows3, *coords, shape, mode, VB, budget, staged)
            ref = p8.banded_warp_plain(rows3, *coords, shape, mode, VB, budget)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(staged.bool().cpu().numpy(), host)
            if mode == "banded" and budget == at:
                assert host[rows == at].all() and not host[rows > at].any()
            if mode != "bandonly" or host.all():
                assert torch.equal(out, kernel1), (budget, mode)
                assert_close(out, ref, 1e-5, f"{mode} budget {budget}")


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    cuda = torch.device("cuda")
    table = torch.zeros(2, 8, device=cuda)
    with pytest.raises(TypeError):
        p9.gather_cuda(table.double(), torch.zeros(2, 3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="lies on"):
        p9.gather_cuda(table, torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="idx"):
        p9.gather_cuda(table, torch.zeros(3, 3, dtype=torch.int32, device=cuda))
    data = torch.zeros(4, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="VB % 8"):
        p10.lane_gather_cuda(data, torch.zeros(2, 1, 12, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        p10.lane_gather_cuda(data.float(), torch.zeros(2, 1, 8, dtype=torch.int32, device=cuda))
    c = [torch.zeros(1, 10, device=cuda) for _ in range(3)]
    with pytest.raises(ValueError, match="C in"):
        p7.proto_warp_cuda(torch.zeros(3 * 4, 6, device=cuda), *c, (2, 3, 4, 3))
    with pytest.raises(ValueError, match="contiguous"):
        p7.proto_warp_cuda(torch.zeros(6, 16, device=cuda).t(), *c, (2, 3, 4, 4))
    rows3 = torch.zeros(1, 16, 32, dtype=torch.bfloat16, device=cuda)
    cg = [torch.zeros(1, 2, 128, device=cuda) for _ in range(3)]
    with pytest.raises(ValueError, match="shared memory"):
        p8.banded_warp_cuda(rows3, *cg, (4, 4, 8, 4), vb=64, budget=10 ** 6)
    big = [torch.zeros(1, 4, 4096, device=cuda) for _ in range(3)]
    with pytest.raises(ValueError, match="shared memory"):       # the output tile
        p8.banded_warp_cuda(rows3, *big, (4, 4, 8, 4), vb=4096)
    with pytest.raises(ValueError, match="staged"):
        p8.banded_warp_cuda(rows3, *cg, (4, 4, 8, 4), vb=64,
                            staged=torch.zeros(1, 2, 3, dtype=torch.uint8, device=cuda))
    with pytest.raises(TypeError):
        p8.banded_warp_cuda(rows3.float(), *cg, (4, 4, 8, 4), vb=64)
    with pytest.raises(ValueError, match="mode"):
        p8.banded_warp_cuda(rows3, *cg, (4, 4, 8, 4), mode="full", vb=64)
