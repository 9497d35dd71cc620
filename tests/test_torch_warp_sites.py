"""PyTorch port: where the warp kernels are timed and what they launch, on
the CPU.

- facevae_tpu_torch/bench_warp.py's Generator-step recorder at tiny_config:
  the Generator's warp_single call in the first training step, its
  appearance volume with the normalized grid (fp32: the single-grid
  kernels 4-6) or the pixel coordinates at K1 = 1 (bf16: the multi-grid
  kernels 1-3); the patched warp_single restored after the step, also when
  the step raises; the recorded step the same as an unrecorded one; the
  share of kernel 6's atomics its lanes pair on that grid;
- the multi-grid dgrid wrapper's launch limits (ops/fast_warp.py), which
  mirror its kernel's grid (csrc/warp_bwd.cu: blockIdx.x = voxel block *
  K1 + k, blockIdx.y = n) and its lanes per voxel, and the dx wrappers'
  refusal of a source past the kernels' 32-bit voxel index.
"""
import dataclasses

import pytest
import torch

from facevae_tpu_torch import bench_warp
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.models import generator
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.train import create_train_state, train_step
from torch_parity import one_torch_thread, pairing_counts  # noqa: F401

BATCH = 2


def _tiny():
    """tiny_config() without remat: these tests record and hold the warp
    calls, which a recompute would not make again anyway."""
    cfg = tiny_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generator_step_recorder_records_the_warp_call(dtype):
    cfg = _tiny()
    D, S, C = cfg.model.depth, cfg.model.image_size // 4, cfg.model.app_channels
    x, inp = bench_warp.generator_step_inputs(dtype, device="cpu", cfg=cfg, batch=BATCH)
    assert generator.warp_single is fast_warp.warp_single
    assert x.shape == (BATCH, D, S, S, C) and x.dtype == getattr(torch, dtype)
    assert x.is_contiguous() and torch.isfinite(x.float()).all()
    if dtype == "float32":
        assert inp.shape == (BATCH, D, S, S, 3) and inp.dtype == torch.float32
        assert inp.is_contiguous() and torch.isfinite(inp).all()
        return
    assert len(inp) == 3
    for c, size in zip(inp, (S, S, D)):
        assert c.shape == (BATCH, 1, D * S * S) and c.dtype == torch.float32
        assert c.is_contiguous() and torch.isfinite(c).all()
        # pixel coordinates of a deformation near the identity: inside or
        # near the volume
        assert -size < float(c.min()) and float(c.max()) < 2 * size


def test_pairing_share_at_the_tiny_generator_step():
    """The share of kernel 6's vector atomics the lane pairing saves on the
    Generator's own grid in the first tiny_config step, printed (``-s``) at
    lane distance 8 (the fp32 Generator at full width, C = 32) and 2 (C = 8
    here): its deformation is near the identity, so most x corners pair, at
    most 3 of 4 upper ones at distance 8 (a warp holds 4 voxels)."""
    cfg = _tiny()
    x, grid = bench_warp.generator_step_inputs("float32", device="cpu", cfg=cfg, batch=BATCH)
    coords = [c.contiguous() for c in fast_warp._grid_pixels(x, grid, 1)]
    for cvs, most in ((8, 0.375), (2, 0.5)):
        issued, unpaired = pairing_counts(coords, tuple(x.shape[1:4]), cvs)
        saved = 1 - issued / unpaired
        print(f"[pairing] tiny Generator step, lane distance {cvs}: {unpaired} atomics "
              f"unpaired, {issued} paired, {saved:.3f} saved")
        assert 0.15 <= saved <= most


def test_recorded_step_is_the_unrecorded_step():
    """The recorder calls the real warp_single: the step's losses are the
    bits of the same step run without it."""
    cfg = _tiny()
    (x, grid), out = bench_warp.record_first_call(cfg, generator, "warp_single", "cpu", BATCH)
    state = create_train_state(cfg, device=torch.device("cpu"))
    g = torch.Generator(device="cpu").manual_seed(0)
    size = cfg.model.image_size
    images = tuple(torch.rand(BATCH, size, size, 3, generator=g) for _ in range(4))
    ref = train_step(state, images, generator=g)
    for part in ("losses_g", "losses_d"):
        assert out[part].keys() == ref[part].keys()
        for k in ref[part]:
            assert torch.equal(out[part][k], ref[part][k]), (part, k)
    assert torch.equal(out["aux"]["generated_d"], ref["aux"]["generated_d"])


def test_recorder_restores_warp_single_when_the_step_raises():
    """A step on a compute dtype the port refuses raises after the patch
    is in place; the patch is undone all the same."""
    cfg = _tiny()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        bench_warp.record_first_call(cfg, generator, "warp_single", "cpu", BATCH)
    assert generator.warp_single is fast_warp.warp_single


@pytest.mark.parametrize("C, cpt, item, lanes", [
    (4, 4, 4, 1), (32, 4, 4, 4), (32, 8, 2, 1), (8, 4, 4, 1), (3, 1, 4, 2), (5, 1, 4, 4),
    (64, 1, 4, 32), (128, 1, 4, 32), (256, 4, 4, 32), (64, 8, 2, 2), (24, 8, 2, 1),
    (3, 1, 2, 1), (0, 4, 4, 1)])
def test_dgrid_lanes_mirror_the_kernel(C, cpt, item, lanes):
    """The power of two >= C / cpt / vecs (2 vectors a lane of fp32, 4 of
    bf16), at least 1, at most 32 (csrc/warp_bwd.cu:dgrid_lanes)."""
    assert fast_warp._dgrid_lanes(C, cpt, item) == lanes


def test_dgrid_launch_limits_match_its_grid():
    """N on blockIdx.y (at most 65535); ceil(NV * lanes / 256) * K1 blocks
    on blockIdx.x (at most 2^31 - 1); NV within a 32-bit index.  N * K1 is
    no limit: the kernel's first grid put it on blockIdx.y."""
    check = fast_warp._check_dgrid_launch
    check(65535, 1, 1, 1)
    check(8, 15 * 65536, 256, 1)                  # N * K1 = 2^23 grids of one block each
    with pytest.raises(ValueError, match="N=65536"):
        check(65536, 1, 1, 1)
    NV = 2 ** 31 - 256                            # at 32 lanes: 2^28 - 32 blocks a grid
    k1 = (2 ** 31 - 1) // (2 ** 28 - 32)
    check(1, k1, NV, 32)
    with pytest.raises(ValueError, match="grid limit"):
        check(1, k1 + 1, NV, 32)
    check(1, 2 ** 31 - 1, 256, 1)                 # one block a grid: K1 at the limit
    with pytest.raises(ValueError, match="grid limit"):
        check(1, 2 ** 31, 256, 1)
    check(1, 1, 2 ** 31 - 1, 1)
    with pytest.raises(ValueError, match="32-bit"):
        check(1, 1, 2 ** 31, 1)


def test_dx_refuses_a_source_past_the_32_bit_voxel_index():
    """The dx kernels index the source's voxels with 32-bit ints: a source
    of 2^31 voxels is refused (shapes only: a meta tensor), one fewer is
    taken."""
    fast_warp._check_source_voxels(torch.empty(1, 2, 1024, 1024 * 1024 - 1, 1, device="meta"))
    with pytest.raises(ValueError, match="32-bit"):
        fast_warp._check_source_voxels(torch.empty(1, 2, 1024, 1024 * 1024, 1, device="meta"))
