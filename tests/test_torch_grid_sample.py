"""PyTorch port: the general grid_sample_2d / grid_sample_3d
(facevae_tpu_torch/ops/grid_sample.py) against facevae_tpu/ops/grid_sample.py
on the CPU, and the TPS warp's fp32 branch that now calls it.

Every mode: align_corners True / False x padding zeros / border /
reflection, 2-D and 3-D, on grids reaching +-2 (far outside, so the zeros
mask and the clamp before the integer cast are both exercised), and on a
source with a spatial axis of size 1 (the reflection's degenerate span).
Tolerances: forward 1e-6 of max|ref| (the same gathers summed in the same
order: equal in practice); gradients of sum(out * c) with respect to x and
the grid 1e-5 of max|ref| (the x gradient scatters in another order).
bf16 x: fp32 accumulation, one rounding at the end, 2^-8 of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.ops import grid_sample as jgs, tps as jt
from facevae_tpu.ops.geometry import make_coordinate_grid_2d
from facevae_tpu_torch.ops import grid_sample as tgs, tps as tt
from facevae_tpu_torch.ops.geometry import make_coordinate_grid_2d as t_grid_2d
from torch_parity import assert_close, one_torch_thread  # noqa: F401

FWD, GRAD = 1e-6, 1e-5
TPS = 1e-5                  # tests/test_torch_losses.py's: warp_coordinates sums in another order
MODES = [(a, p) for a in (True, False) for p in ("zeros", "border", "reflection")]
SHAPES = {2: ((2, 5, 7, 3), (2, 6, 4)), 3: ((2, 3, 5, 4, 3), (2, 4, 3, 5))}


def _case(rs, d, size_one=False):
    xs, gs = SHAPES[d]
    if size_one:
        xs = xs[:1] + (1,) + xs[2:]
    x = rs.randn(*xs).astype(np.float32)
    grid = rs.uniform(-2, 2, gs + (d,)).astype(np.float32)
    c = rs.randn(*gs, xs[-1]).astype(np.float32)
    return x, grid, c


def _jax(d, align, pad):
    fn = jgs.grid_sample_2d if d == 2 else jgs.grid_sample_3d

    def run(x, grid, c):
        def loss(x, grid):
            out = fn(x, grid, align_corners=align, padding_mode=pad)
            return jnp.sum(out * c), out
        (_, out), (dx, dgrid) = jax.value_and_grad(loss, (0, 1), has_aux=True)(x, grid)
        return out, dx, dgrid
    return run


def _port(d, align, pad, x, grid, c):
    fn = tgs.grid_sample_2d if d == 2 else tgs.grid_sample_3d
    tx, tg = (torch.from_numpy(a).requires_grad_() for a in (x, grid))
    out = fn(tx, tg, align_corners=align, padding_mode=pad)
    (out * torch.from_numpy(c)).sum().backward()
    return out, tx.grad, tg.grad


@pytest.mark.parametrize("align, pad", MODES)
def test_grid_sample_matches_jax(rng, align, pad):
    """2-D and 3-D, forward and both gradients, on a regular source and on
    one with a size-1 axis."""
    for d in (2, 3):
        run = _jax(d, align, pad)
        for size_one in (False, True):
            x, grid, c = _case(rng, d, size_one)
            ref = run(x, grid, c)
            port = _port(d, align, pad, x, grid, c)
            what = f"{d}-D align={align} {pad} size_one={size_one}"
            assert_close(port[0], ref[0], FWD, f"{what} forward")
            assert_close(port[1], ref[1], GRAD, f"{what} d x")
            assert_close(port[2], ref[2], GRAD, f"{what} d grid")


def test_grid_sample_bf16_and_refusal(rng):
    """A bf16 source: fp32 accumulation, the result in bf16, as JAX's; an
    unknown padding mode raises."""
    for d in (2, 3):
        x, grid, _ = _case(rng, d)
        xb = x.astype(jnp.bfloat16)
        fn_j = jgs.grid_sample_2d if d == 2 else jgs.grid_sample_3d
        fn_t = tgs.grid_sample_2d if d == 2 else tgs.grid_sample_3d
        ref = np.asarray(fn_j(jnp.asarray(xb), grid, align_corners=False,
                              padding_mode="reflection")).astype(np.float32)
        out = fn_t(torch.from_numpy(x).bfloat16(), torch.from_numpy(grid),
                   align_corners=False, padding_mode="reflection")
        assert out.dtype == torch.bfloat16
        assert_close(out.float(), ref, 2.0 ** -8, f"{d}-D bf16")
    with pytest.raises(ValueError, match="padding_mode"):
        tgs.grid_sample_2d(torch.zeros(1, 2, 2, 1), torch.zeros(1, 1, 1, 2), padding_mode="wrap")


def _reflect_copy(coord, lo, hi):
    """The TPS module's own reflection, as it stood before it called
    grid_sample_2d (kept here to hold the new path to it)."""
    span = max(hi - lo, 1e-12)
    coord = (coord - lo).abs()
    coord = torch.remainder(coord, 2.0 * span)
    coord = torch.where(coord > span, 2.0 * span - coord, coord)
    return coord + lo


def _tps_gather_copy(x, grid):
    """The TPS module's fp32 gather (grid_sample_2d_reflect) as it stood."""
    N, H, W, C = x.shape
    _, Ho, Wo, _ = grid.shape
    g = grid.float()

    def pixels(v, size):
        p = (v + 1.0) * 0.5 * (size - 1)
        return torch.clamp(_reflect_copy(p, 0.0, float(size - 1)), 0.0, float(size - 1))
    gx, gy = pixels(g[..., 0], W), pixels(g[..., 1], H)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    tx, ty = gx - x0, gy - y0
    flat = x.float().reshape(N, H * W, C)
    out = torch.zeros(N, Ho, Wo, C, dtype=torch.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            w = (tx if dx else 1.0 - tx) * (ty if dy else 1.0 - ty)
            ix = torch.clamp(x0 + dx, 0, W - 1).long()
            iy = torch.clamp(y0 + dy, 0, H - 1).long()
            idx = (iy * W + ix).reshape(N, Ho * Wo, 1).expand(N, Ho * Wo, C)
            out = out + torch.gather(flat, 1, idx).reshape(N, Ho, Wo, C) * w[..., None]
    return out


def test_tps_fp32_frame_is_unchanged(rng):
    """transform_frame's fp32 branch through grid_sample_2d gives the bits
    its own gather gave, on seeded frames and strong warps (reaching past
    the border), and the JAX package's transform_frame within TPS."""
    for N, H, W in ((3, 16, 12), (2, 33, 40)):
        theta = (np.eye(2, 3)[None] + 0.3 * rng.randn(N, 2, 3)).astype(np.float32)
        cp = np.asarray(make_coordinate_grid_2d((5, 5))).reshape(1, 25, 2)
        cparams = (0.05 * rng.randn(N, 1, 25)).astype(np.float32)
        frame = rng.rand(N, H, W, 3).astype(np.float32)
        ttp = tt.TransformParams(*(torch.tensor(a) for a in (theta, cp, cparams)))
        out = tt.transform_frame(ttp, torch.from_numpy(frame))
        grid = t_grid_2d((H, W)).reshape(1, H * W, 2)
        grid = tt.warp_coordinates(ttp, grid).reshape(N, H, W, 2)
        assert torch.equal(out, _tps_gather_copy(torch.from_numpy(frame), grid))
        jtp = jt.TransformParams(*(jnp.asarray(a) for a in (theta, cp, cparams)))
        ref = jax.jit(jt.transform_frame)(jtp, jnp.asarray(frame))
        assert_close(out, ref, TPS, f"TPS {H}x{W}")
