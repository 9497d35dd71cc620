"""PyTorch port: the dx kernels' corner pairing, modelled on the CPU.

Kernel 3 (csrc/warp_bwd.cu, a thread per (n, k, v)) and kernel 6
(csrc/warp_grid.cu, a thread per (g, v, channel vector)) add each voxel's
upper x corner into the next voxel's lower one by a warp shuffle when the
two are the same element, and the giver skips its atomic: lane l takes from
lane l - 1 (kernel 3; kernel 6 at cvs = C / CPT = 1) or lane l - cvs
(kernel 6).  The card runs the kernels (test_torch_cuda.py, chip_smoke.py
phase 3); here tests/torch_parity.py's model of which lanes give and take
(lane_pairs, paired_dx) is held:

- the rule itself on hand-made lanes (warp edges, distance 1 and 3);
- on smooth (one keypoint's sparse motion), identity (exact integers),
  last-index, NaN / +-inf and noisy coordinates, at lane distances 1, 3
  and 8: the paired float64 sums equal the plain backwards' dx (the
  multi-grid one and the single-grid one on the same samples) and JAX's
  vjp, and the paired fixed-point sums (FixedSink's) are bit-equal to the
  unpaired ones (fixed_point_dx), as the deterministic kernels must be;
- the share of atomics the pairing saves on each set, printed
  (``pytest -s``) beside bounds that the sets' geometry sets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.ops import fast_warp as jfw
from facevae_tpu_torch import warp_inputs
from facevae_tpu_torch.ops import fast_warp as tfw
from torch_parity import (assert_close, corner_contributions, fixed_point_dx,  # noqa: F401
                          lane_pairs, one_torch_thread, paired_dx, pairing_counts)

pytestmark = pytest.mark.fast

# sides with size - 1 a power of two (JAX's pixel -> normalized -> pixel
# round trip keeps exact integers exact, as tests/test_torch_warp.py says)
N, K, SPATIAL, C = 2, 2, (3, 5, 33), 24
SETS = ["smooth", "identity", "last index", "non-finite", "noisy"]


def _coords(cset, seed):
    """Pixel coordinates [3][N,K,NV] of one set."""
    D, H, W = SPATIAL
    g = torch.Generator().manual_seed(seed)
    if cset == "noisy":
        return warp_inputs.noisy_coords(N, K, D, H, W, g)
    if cset in ("smooth", "non-finite"):
        c = torch.stack(warp_inputs.sparse_motion_coords(N, K, D, H, W, g))
    else:
        z, y, x = torch.meshgrid(*(torch.arange(s, dtype=torch.float32) for s in SPATIAL),
                                 indexing="ij")
        c = torch.stack([x, y, z]).reshape(3, 1, 1, -1).expand(3, N, K, D * H * W).clone()
    pick = torch.rand(c.shape, generator=g)
    size = torch.tensor([W, H, D], dtype=torch.float32).reshape(3, 1, 1, 1)
    if cset == "last index":
        c = torch.where(pick < 0.3, size - 1, c)
    if cset == "non-finite":
        probes = torch.tensor([float("nan"), float("inf"), float("-inf"), 1e30])
        c = torch.where(pick < 0.1, probes[(pick * 1e3).long() % 4], c)
    return [a.contiguous() for a in c]


def _case(cset, seed):
    coords = _coords(cset, seed)
    rs = np.random.RandomState(seed)
    x = rs.randn(N, *SPATIAL, C).astype(np.float32)
    gout = rs.randn(N, *SPATIAL, K * C).astype(np.float32)
    return x, coords, gout


def test_lane_pairs_follow_the_kernels_rule():
    """Lane l takes where its lower corner is lane l - d's upper one (both
    inside the volume); lane l - d is then the giver.  Lane 0 (< d) never
    takes, the last d lanes of a warp never give, nothing crosses a warp."""
    T = 64
    hi = torch.arange(T) + 100
    lo = hi - 1                                  # each lower corner: the left lane's upper
    lo[5], hi[9] = -1, -1                        # outside the volume
    take, given = lane_pairs(lo[None], hi[None], 1)
    lane = torch.arange(T) % 32
    want = (lane >= 1) & (lo >= 0) & (torch.arange(T) != 10)
    assert torch.equal(take[0], want)
    assert torch.equal(given[0, :-1], want[1:]) and not given[0, -1]
    assert not given[0, 31] and not take[0, 32]
    lo3 = torch.full((T,), -1)
    lo3[3:] = hi[:-3]
    take, given = lane_pairs(lo3[None], hi[None], 3)
    want = (lane >= 3) & (lo3 >= 0) & (lo3 == torch.roll(hi, 3)) & (lo3 != -1)
    assert torch.equal(take[0], want)
    assert torch.equal(given[0, :-3], want[3:]) and not given[0, -3:].any()
    assert int(take.sum()) == int(given.sum())


def _float64_ref(x, coords, gout):
    """The multi-grid plain backward's dx in float64."""
    return tfw.warp_multi_pixel_bwd_plain(torch.from_numpy(x).double(),
                                          *(c.double() for c in coords),
                                          torch.from_numpy(gout).double(), SPATIAL,
                                          need_dgrid=False)[0]


@pytest.mark.parametrize("cvs", [1, 3, 8])
@pytest.mark.parametrize("cset", SETS)
def test_paired_sums_equal_the_plain_backward(cset, cvs):
    """The paired float64 sums: within 1e-12 of max|ref| of the unpaired
    float64 sum of the same fp32 contributions, and within 1e-6 of the
    plain backward in float64 (whose weights are float64)."""
    x, coords, gout = _case(cset, 1)
    rows = tfw._gout_k_major(torch.from_numpy(gout), torch.float32, N, K, x[0, ..., 0].size, C)
    paired = paired_dx(x.shape, coords, rows, cvs)
    unpaired = torch.zeros(N, x[0, ..., 0].size, C, dtype=torch.float64)
    for n, idx, c in corner_contributions(x.shape, coords, rows):
        unpaired[n].index_add_(0, idx, c.double())
    assert_close(paired, unpaired.reshape(x.shape), 1e-12, f"{cset} vs unpaired")
    assert_close(paired, _float64_ref(x, coords, gout), 1e-6, f"{cset} vs plain")


@pytest.mark.parametrize("cset", SETS)
def test_paired_sums_equal_jax_and_the_single_grid_backward(cset):
    """Kernel 3's distance (1) against JAX's warp_multi_pixel vjp; kernel
    6's (C / CPT = 24 / 4 = 6 fp32) against the single-grid plain backward on
    the normalized grid (the same samples, gps = K): 1e-5 of max|ref|.
    JAX's one-hot warp spreads a NaN coordinate over its whole row (0 *
    NaN), where the port's kernels and plain versions add nothing: its NaN
    coordinates go to JAX as +inf, whose corners all lie outside in both."""
    x, coords, gout = _case(cset, 2)
    rows = tfw._gout_k_major(torch.from_numpy(gout), torch.float32, N, K, x[0, ..., 0].size, C)
    _, vjp = jax.vjp(lambda *a: jfw.warp_multi_pixel(*a, SPATIAL), jnp.asarray(x),
                     *(jnp.asarray(np.nan_to_num(c.numpy(), nan=np.inf, posinf=np.inf,
                                                 neginf=-np.inf)) for c in coords))
    assert_close(paired_dx(x.shape, coords, rows, 1), vjp(jnp.asarray(gout))[0], 1e-5,
                 f"{cset} vs JAX")
    D, H, W = SPATIAL
    grid = warp_inputs.normalized(coords, D, H, W)
    g_grid = rows.reshape(N * K, *SPATIAL, C)
    ref = tfw.grid_sample_3d_bwd_plain(torch.from_numpy(x), grid, g_grid, K,
                                       need_dgrid=False)[0]
    pix = [c.contiguous() for c in tfw._grid_pixels(torch.from_numpy(x), grid, K)]
    assert_close(paired_dx(x.shape, pix, rows, 6), ref, 1e-5, f"{cset} vs single-grid plain")


@pytest.mark.parametrize("cvs", [1, 3, 8])
@pytest.mark.parametrize("cset", SETS)
def test_paired_fixed_point_sums_have_the_unpaired_bits(cset, cvs):
    """FixedSink adds int64 round(c * 2^s); a taker adds its giver's int64
    to its own before the atomic, so the sums, and the deterministic
    kernels' bits, are those without the pairing."""
    x, coords, gout = _case(cset, 3)
    rows = tfw._gout_k_major(torch.from_numpy(gout), torch.float32, N, K, x[0, ..., 0].size, C)
    s = int(tfw.dx_scale_exponent(torch.from_numpy(gout), K * x[0, ..., 0].size))
    paired = paired_dx(x.shape, coords, rows, cvs, s)
    assert torch.equal(paired, fixed_point_dx(x.shape, coords, rows, s))


def test_paired_fixed_point_keeps_non_finite_cotangents():
    """NaN and +inf in the cotangent: the flags are set by the giver, so the
    paired fixed-point sum puts them where the unpaired one does."""
    x, coords, gout = _case("identity", 4)
    gout[0, 1, 2, 3, 0], gout[1, 0, 4, 7, 3] = np.nan, np.inf
    rows = tfw._gout_k_major(torch.from_numpy(gout), torch.float32, N, K, x[0, ..., 0].size, C)
    s = int(tfw.dx_scale_exponent(torch.from_numpy(gout), K * x[0, ..., 0].size))
    for cvs in (1, 8):
        paired = paired_dx(x.shape, coords, rows, cvs, s)
        ref = fixed_point_dx(x.shape, coords, rows, s)
        assert (~torch.isfinite(ref)).any() and torch.equal(paired.isnan(), ref.isnan())
        assert torch.equal(torch.nan_to_num(paired), torch.nan_to_num(ref))


# the share of atomics saved: (lower bound, upper bound) per set at
# distance 1 and 8.  Identity rows pair all but the warp's first lane and
# the row's last voxel (its upper corner lies outside); distance 8 puts 4
# voxels in a warp, so at most 3 of 4 upper corners pair
SHARE = {"smooth": ((0.30, 0.50), (0.20, 0.38)), "identity": ((0.40, 0.50), (0.30, 0.38)),
         "last index": ((0.10, 0.45), (0.05, 0.38)), "non-finite": ((0.20, 0.50), (0.15, 0.38)),
         "noisy": ((0.0, 0.05), (0.0, 0.05))}


@pytest.mark.parametrize("cset", SETS)
def test_share_of_atomics_saved(cset):
    """The atomics the pairing saves, printed per set (kernel 3 and kernel
    6 at the reference form: distance 1; kernel 6 at the fp32 Generator,
    C = 32: distance 8), within the bounds the sets' geometry gives."""
    coords = _coords(cset, 5)
    for (lo, hi), cvs in zip(SHARE[cset], (1, 8)):
        issued, unpaired = pairing_counts(coords, SPATIAL, cvs)
        saved = 1 - issued / unpaired
        print(f"[pairing] {cset}, lane distance {cvs}: {unpaired} atomics unpaired, "
              f"{issued} paired, {saved:.3f} saved")
        assert lo <= saved <= hi, (cset, cvs, saved)
