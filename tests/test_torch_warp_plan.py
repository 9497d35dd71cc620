"""The inputs the multi-grid warp kernels are checked and timed on, on the
CPU:

- the coordinate sets of facevae_tpu_torch/warp_inputs.py:
  sparse_motion_coords against the JAX package's motion_affine_params /
  sparse_motion_pixel_coords (facevae_tpu/ops/motion.py) on the same draws,
  within 1e-5 pixels, and the shares of the probes with_probes mixes in;
- the port's plain multi-grid warp, which the card holds kernels 1-3 to,
  against the JAX package's warp_multi_pixel and its vjp on each set at a
  small size (x [2,5,9,9,4], K1=3): 1e-5 of max|ref|, as
  tests/test_torch_warp.py holds it on its own coordinates;
- the single-grid forward's launch mirror (``_grid_fwd_plan``: its kernel
  and grid, against the launch code's source) and bench_warp.py's cases
  with their batch (the N = 1 forward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.ops import fast_warp as jfw
from facevae_tpu.ops import geometry as jgeom
from facevae_tpu.ops import motion as jmotion
from facevae_tpu_torch import warp_inputs
from facevae_tpu_torch.ops import fast_warp as tfw
from torch_parity import assert_close

pytestmark = pytest.mark.fast


@pytest.mark.parametrize("seed, N, K, spatial", [
    (0, 2, 3, (4, 16, 16)), (1, 1, 15, (5, 9, 9)), (2, 3, 2, (3, 8, 12))])
def test_sparse_motion_coords_match_jax(seed, N, K, spatial):
    """The set MFE warps by: the same keypoints and poses (drawn again
    from the seed in warp_inputs' order) through the JAX package."""
    D, H, W = spatial
    got = warp_inputs.sparse_motion_coords(N, K, D, H, W, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    kp_s, kp_d = ((torch.rand(N, K, 3, generator=g) * 1.2 - 0.6).numpy() for _ in range(2))
    angles = [[(torch.rand(N, generator=g) - 0.5).numpy() for _ in range(3)] for _ in range(2)]
    Rs, Rd = (jgeom.pose_rotation(*map(jnp.asarray, a)) for a in angles)
    jac, b = jmotion.motion_affine_params(jnp.asarray(kp_s), jnp.asarray(kp_d), Rs, Rd)
    ref = jmotion.sparse_motion_pixel_coords(spatial, jac, b, include_identity=False)
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32 and a.is_contiguous()
        assert a.shape == (N, K, D * H * W)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_with_probes_mixes_in_what_it_says():
    """On a large seeded draw (coordinates in [0, size - 3], so none rounds to
    the last index): 10% rounded to integers, 0.5% the last index, 0.5%
    probe values of which 6 in 10 are +-1e6, +-1e30 or +-inf and 6 in 10
    finite integers."""
    g = torch.Generator().manual_seed(0)
    shape = (3, 4, 15, 4096)
    size = torch.tensor([9.0, 7.0, 5.0]).reshape(3, 1, 1, 1)
    c = torch.rand(shape, generator=g) * (size - 3)
    out = torch.stack(warp_inputs.with_probes(c, size, g))
    assert out.shape == shape and all(a.is_contiguous() for a in out)
    n = out.numel()

    def share(mask):
        return mask.sum().item() / n

    # expected 0.1 + 0.005 + 0.003, 0.005, 0.001, 0.003; each bound ~10 sd
    assert 0.104 < share(torch.isfinite(out) & (out == torch.round(out))) < 0.112
    assert 0.0045 < share(out == size - 1) < 0.0055
    assert 0.0008 < share(torch.isinf(out)) < 0.0012
    assert 0.0027 < share(out.abs() >= 1e6) < 0.0033
    assert not torch.isnan(out).any()


def _set(cset, seed, N=2, K1=3, D=5, H=9, W=9, C=4):
    """x, coordinates and cotangent of one set, sides with size - 1 a power
    of two (so JAX's pixel -> normalized -> pixel round trip keeps exact
    integers exact, as tests/test_torch_warp.py explains)."""
    g = torch.Generator().manual_seed(seed)
    coords = (warp_inputs.noisy_coords(N, K1, D, H, W, g) if cset == "noisy" else
              warp_inputs.sparse_motion_coords(N, K1, D, H, W, g, probes=cset == "sparse+probes"))
    rs = np.random.RandomState(seed)
    x = rs.randn(N, D, H, W, C).astype(np.float32)
    gout = rs.randn(N, D, H, W, K1 * C).astype(np.float32)
    return x, [c.numpy() for c in coords], gout, (D, H, W)


SETS = ["noisy", "sparse", "sparse+probes"]


@pytest.mark.parametrize("cset", SETS)
def test_plain_warp_matches_jax_on_the_sets(cset):
    x, coords, _, spatial = _set(cset, 3)
    ref = jfw.warp_multi_pixel(jnp.asarray(x), *coords, spatial)
    port = tfw.warp_multi_pixel_plain(torch.from_numpy(x), *map(torch.from_numpy, coords),
                                      spatial)
    assert_close(port, ref, 1e-5, cset)


@pytest.mark.parametrize("cset", SETS)
def test_plain_warp_backward_matches_jax_on_the_sets(cset):
    x, coords, gout, spatial = _set(cset, 4)
    _, vjp = jax.vjp(lambda *a: jfw.warp_multi_pixel(*a, spatial), jnp.asarray(x),
                     *map(jnp.asarray, coords))
    rdx, *rdgrid = vjp(jnp.asarray(gout))
    dx, dgrid = tfw.warp_multi_pixel_bwd_plain(torch.from_numpy(x),
                                               *map(torch.from_numpy, coords),
                                               torch.from_numpy(gout), spatial)
    assert_close(dx, rdx, 1e-5, f"{cset} dx")
    for a, (d, r) in enumerate(zip(dgrid, rdgrid)):
        assert_close(d, r, 1e-5, f"{cset} dgrid {'xyz'[a]}")


@pytest.mark.parametrize("C, cpt, NV, G, kernel, blocks", [
    (4, 4, 65536, 128, "voxel", 64),       # the reference form: 4 voxels a thread
    (32, 4, 65536, 8, "table", 256),       # the Generator, fp32
    (32, 8, 65536, 1, "table", 256),       # bf16, and evaluation's N = 1
    (3, 1, 323, 3, "table", 2),            # a ragged last block
    (1, 1, 1, 1, "voxel", 1),
    (2, 2, 1025, 2, "voxel", 2)])
def test_grid_forward_plan(C, cpt, NV, G, kernel, blocks):
    """fast_warp._grid_fwd_plan, the mirror of kernel 4's launch: the voxel
    kernel where C is one vector (1024 voxels a block), else the table
    kernel (256); 256 threads a block, G grids on the grid's y."""
    assert tfw._grid_fwd_plan(C, cpt, NV, G) == (kernel, (blocks, G, 1, 256))


def test_grid_forward_plan_mirrors_the_launch_code():
    """The plan's threads are the kernels' kThreads, its voxels a thread the
    voxel kernel's, its kernel choice the launch code's, and it refuses a
    block's item index past 32 bits."""
    import re
    from pathlib import Path
    csrc = Path(tfw.__file__).resolve().parents[1] / "csrc"
    threads = re.search(r"constexpr int kThreads = (\d+);",
                        (csrc / "warp_common.cuh").read_text()).group(1)
    source = (csrc / "warp_grid.cu").read_text()
    per_thread = re.search(r"constexpr int kVoxelsPerThread = (\d+)", source).group(1)
    assert (int(threads), int(per_thread)) == (tfw._GRID_FWD_THREADS,
                                              tfw._GRID_FWD_VOXELS_PER_THREAD)
    assert "kThreads * (C == CPT ? kVoxelsPerThread : 1)" in source
    assert "C == CPT ? grid_fwd_voxel_kernel<T, CPT> : grid_fwd_table_kernel<T, CPT>" in source
    assert tfw._grid_fwd_plan(2 ** 23 - 1, 1, 1, 1)[0] == "table"
    with pytest.raises(ValueError, match="32-bit item index"):
        tfw._grid_fwd_plan(2 ** 23, 1, 1, 1)


def test_bench_cases_carry_their_batch():
    """bench_warp.py's cases name their batch: the Generator's single-grid
    forward at N = 1 (evaluation's gif modes) on the step and noisy sets,
    after every batch-8 case; a drawn case is sized by its batch."""
    from facevae_tpu_torch import bench_warp
    batches = [case[-1] for case in bench_warp.CASES]
    assert batches == sorted(batches, reverse=True) and set(batches) == {8, 1}
    n1 = [case[:-1] for case in bench_warp.CASES if case[-1] == 1]
    assert [(c[0], c[1], c[5], c[6], c[7]) for c in n1] == [
        ("Generator", "grid", "step", ("float32",), ("fwd",)),
        ("Generator", "grid", "noisy", ("float32",), ("fwd",))]
    grid = bench_warp.case_inputs("Generator", "grid", 32, 1, (2, 5, 9), "noisy",
                                  torch.Generator().manual_seed(0), batch=1)
    assert grid.shape == (1, 2, 5, 9, 3) and grid.dtype == torch.float32
