"""PyTorch port: the four TPU probes of tools/ (kernels 7-10, ported as
facevae_tpu_torch/probes/) against the probes themselves, on the CPU.

The probes are loaded from their files, with facevae_tpu.utils'
enable_compilation_cache made a no-op first (proto_pallas_warp.py turns on
a persistent cache when imported), and their Pallas kernels run in interpret
mode (pl.pallas_call patched), on the inputs the port's generators make
with numpy:

- probes 9 and 10, gathers: the plain versions equal the Pallas kernels bit
  for bit (probe 10's kernel is a closure inside main(), so main() runs and
  its last pallas_call's output is recorded);
- probe 7, the transposed-table warp: the plain version within 1e-5 of
  max|ref| of pallas_warp and of the probe's ref_trilinear on the same
  bf16-rounded volume (fp32 sums of the same 8 products);
- probe 8, the banded warp, at N=1, D=H=W=8, C=4, K1=2, VB=128, ZB=4, in
  each MODE: the plain version within 1e-5 of the probe's host_reference,
  and within 2% of run_banded (the tolerance of tools/check_pallas_warp.py:
  the TPU kernels round their one-hot weights and S*wx to bf16), bandonly
  only on coordinates whose every block fits; the port's fit rate equals
  the probe's formula, and its staged-box criterion and box sizes equal a
  per-block loop;
- the host-side mirrors of the kernels' launch parameters: kernel 8's
  shared-memory plan (launch_plan, against the constants of
  csrc/probe_warp.cu) and kernel 7's relayout index map, emulated in numpy
  block by block;
- the wrappers' dispatch (CPU tensors take the plain versions, counted; the
  CUDA wrappers refuse CPU tensors) and each entry point's main() on the
  CPU at a tiny size.
The kernels themselves are held to their plain versions in
test_torch_cuda.py and chip_smoke.py phase 9.
"""
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import facevae_tpu.utils
from facevae_tpu_torch.probes import microbench_gather as p9
from facevae_tpu_torch.probes import microbench_lane_gather as p10
from facevae_tpu_torch.probes import proto_banded_warp as p8
from facevae_tpu_torch.probes import proto_warp as p7
from torch_parity import ROOT, assert_close, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module")
def tools():
    """The four probe files, loaded as modules with the compile cache off."""
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(facevae_tpu.utils, "enable_compilation_cache", lambda *a, **k: None)
        for name in ("microbench_pallas_gather", "microbench_lane_gather", "proto_pallas_warp",
                     "proto_banded_warp"):
            spec = importlib.util.spec_from_file_location(f"probe_{name}",
                                                          ROOT / "tools" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    return mods


@pytest.fixture
def interpret(monkeypatch):
    """pl.pallas_call in interpret mode; returns the list of the outputs of
    every call made through it."""
    outputs = []
    orig = pl.pallas_call

    def recording(*args, **kwargs):
        fn = orig(*args, interpret=True, **kwargs)

        def call(*a):
            out = fn(*a)
            outputs.append(out)
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", recording)
    monkeypatch.setattr(facevae_tpu.utils, "enable_compilation_cache", lambda *a, **k: None)
    return outputs


@pytest.mark.parametrize("case", p9.CASES)
def test_gather_plain_equals_the_pallas_probe(tools, interpret, case):
    S, T, P = case
    table, idx = p9.inputs(S, T, P)
    probe = pl.pallas_call(      # run_case's call of the probe's kernel
        tools["microbench_pallas_gather"].gather_kernel,
        out_shape=jax.ShapeDtypeStruct((S, P), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))
    want = np.asarray(probe(jnp.asarray(table), jnp.asarray(idx)))
    got = p9.gather_plain(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_lane_gather_plain_equals_the_pallas_probe(tools, interpret, capsys):
    tools["microbench_lane_gather"].main()
    assert "max err vs host gather: 0.0" in capsys.readouterr().out
    want = np.asarray(interpret[-1]).astype(np.float32)     # the last call: run(data, idx)
    data, idx = p10.inputs()
    got = p10.lane_gather_plain(torch.from_numpy(data).bfloat16(), torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16 and want.shape == tuple(got.shape)
    np.testing.assert_array_equal(got.float().numpy(), want)


SMALL_WARP = dict(D=2, H=64, W=8, C=4, DH=128, CW=32, P=1024, VB=512)


def test_proto_warp_plain_matches_the_pallas_probe(tools, interpret, monkeypatch):
    probe = tools["proto_pallas_warp"]
    for name, v in SMALL_WARP.items():
        monkeypatch.setattr(probe, name, v)
        if hasattr(p7, name):
            monkeypatch.setattr(p7, name, v)
    vol, rows, volT, gx, gy, gz = p7.inputs(seed=3)
    want = np.asarray(probe.pallas_warp(jnp.asarray(volT), gx[None], gy[None], gz[None]))
    oracle = probe.ref_trilinear(p7._bf16(vol), gx, gy, gz)
    got = p7.proto_warp_plain(torch.from_numpy(volT), *(torch.from_numpy(a)[None]
                                                         for a in (gx, gy, gz)),
                              (2, 64, 8, 4))
    assert_close(got, want, 1e-5, "vs pallas_warp")
    assert_close(got, oracle, 1e-5, "vs ref_trilinear")
    np.testing.assert_array_equal(p7.ref_trilinear(vol, gx, gy, gz),
                                  probe.ref_trilinear(vol, gx, gy, gz))


SMALL_BAND = dict(N=1, D=8, H=8, W=8, C=4, K1=2, VB=128, ZB=4)


@pytest.fixture
def small_band(monkeypatch):
    for name, v in SMALL_BAND.items():
        monkeypatch.setattr(p8, name, v)
    x, rows3, coords = p8.inputs()
    return x, rows3, coords


@pytest.mark.parametrize("mode", p8.MODES)
def test_banded_plain_matches_the_pallas_probe(tools, interpret, monkeypatch, small_band, mode):
    probe = tools["proto_banded_warp"]
    x, rows3, coords = small_band
    cg = coords(3.0)
    s = SMALL_BAND
    if mode == "bandonly":       # wrong where a block does not fit: only where all fit
        assert p8.probe_fit_rate(cg[2], s["D"], s["VB"], s["ZB"]) == 1.0
    monkeypatch.setenv("MODE", mode)
    want = np.asarray(probe.run_banded(jnp.asarray(rows3, jnp.bfloat16), *map(jnp.asarray, cg),
                                       **{k: s[k] for k in ("D", "H", "W", "C", "K1", "VB",
                                                            "ZB")}))
    got = p8.banded_warp_plain(torch.from_numpy(rows3).bfloat16(), *map(torch.from_numpy, cg),
                               (s["D"], s["H"], s["W"], s["C"]), mode, s["VB"])
    assert_close(got, probe.host_reference(x, *cg), 1e-5, "vs host_reference")
    assert_close(got, want, 2e-2, f"vs run_banded MODE={mode}")
    np.testing.assert_array_equal(p8.host_reference(x, *cg), probe.host_reference(x, *cg))


def _probe_formula(cgz, D, N, K1, NV, VB, ZB):
    """tools/proto_banded_warp.py:284-287, as the probe computes it."""
    zc = np.clip(np.asarray(cgz), 0, D - 1).reshape(N, K1, NV // VB, VB)
    lo = np.floor(zc.min(-1))
    hi = np.floor(zc.max(-1))
    return float(((hi - lo) <= ZB - 2).mean())


@pytest.mark.parametrize("theta", [3.0, 20.0, 40.0, 90.0])
def test_fit_rate_is_the_probes(small_band, theta):
    _, _, coords = small_band
    s = SMALL_BAND
    cgz = coords(theta)[2]
    assert p8.probe_fit_rate(cgz, s["D"], s["VB"], s["ZB"]) == _probe_formula(
        cgz, s["D"], s["N"], s["K1"], s["D"] * s["H"] * s["W"], s["VB"], s["ZB"])


def _rows_by_loop(cgy, cgz, D, H, VB, mode):
    """box_rows as the kernel finds the boxes, one block at a time."""
    n_, k1, nv = cgz.shape
    out = np.zeros((n_, nv // VB, k1), np.int64)
    for n in range(n_):
        for b in range(nv // VB):
            boxes = []
            for k in range(k1):
                rows = set()
                for v in range(b * VB, (b + 1) * VB):
                    fz, fy = np.floor(cgz[n, k, v]), np.floor(cgy[n, k, v])
                    if -1 <= fz <= D - 1 and -1 <= fy <= H - 1:
                        rows |= {(max(int(fz), 0), max(int(fy), 0)),
                                 (min(int(fz) + 1, D - 1), min(int(fy) + 1, H - 1))}
                boxes.append(rows)
            if mode == "blockwhen":
                boxes = [set().union(*boxes)] * k1
            for k, rows in enumerate(boxes):
                if rows:
                    zs, ys = [r[0] for r in rows], [r[1] for r in rows]
                    out[n, b, k] = (max(zs) - min(zs) + 1) * (max(ys) - min(ys) + 1)
    return out


@pytest.mark.parametrize("mode", p8.MODES)
def test_staged_flags_match_a_loop(rng, mode):
    """The host's account of the kernel's staging decision, with NaN, +-inf,
    far-out and border coordinates and one block with nothing inside."""
    N, K1, NV, D, H, VB = 2, 3, 64, 4, 6, 16
    cgy = rng.uniform(-3, H + 2, (N, K1, NV)).astype(np.float32)
    cgz = rng.uniform(-3, D + 2, (N, K1, NV)).astype(np.float32)
    cgz[0, 1, :5] = [np.nan, np.inf, -np.inf, 1e30, -1.0]
    cgy[1, 2, 3:6] = [np.nan, -1.0, H - 1.0]
    cgz[1, :, :VB] = -5.0                                    # block 0 of n=1: empty
    rows = _rows_by_loop(cgy, cgz, D, H, VB, mode)
    np.testing.assert_array_equal(p8.box_rows(cgy, cgz, D, H, VB, mode), rows)
    for budget in (1, 6, 12, 24):
        np.testing.assert_array_equal(p8.staged_flags(cgy, cgz, D, H, VB, budget, mode),
                                      rows <= budget)


def test_banded_launch_plan_mirrors_the_kernel():
    """launch_plan is csrc/probe_warp.cu's band_smem / ring_rows: at the
    probe's call one block holds the 120 KB output tile, 205 ring rows and
    the boxes within an H100's 227 KB; the tile's stride is an odd count of
    store vectors; what the kernel cannot hold is refused."""
    src = (ROOT / "facevae_tpu_torch" / "csrc" / "probe_warp.cu").read_text()
    assert "constexpr int kBandThreads = 512;" in src and p8.WARPS == 512 // 32
    assert "sizeof(Span) == 24" in src and p8.SPAN_BYTES == 24
    assert "kMaxShared = 227 * 1024" in src and p8.MAX_SHARED == 227 * 1024
    plan = p8.launch_plan((p8.D, p8.H, p8.W, p8.C), p8.K1, p8.VB, p8.BUDGET, "banded")
    assert plan == dict(stride=240, ring_rows=205, tile=122880, ring=104960, boxes=4200,
                        smem=232056)
    union = p8.launch_plan((p8.D, p8.H, p8.W, p8.C), p8.K1, p8.VB, p8.BUDGET, "blockwhen")
    assert union["boxes"] == 280 and union["ring_rows"] == 213
    for rowbytes, vec, stride in ((240, 16, 240), (48, 16, 48), (32, 16, 48), (8, 4, 12),
                                  (6, 2, 6)):
        assert p8.tile_stride(rowbytes, vec) == stride
    for shape, k1, vb, budget in (((2, 33, 17, 4), 3, 64, 1), ((5, 4, 9, 2), 1, 20, 1000),
                                  ((16, 64, 64, 4), 15, 512, 160)):
        for mode in p8.MODES:
            plan = p8.launch_plan(shape, k1, vb, budget, mode)
            row = shape[2] * shape[3] * 2
            assert plan["ring_rows"] >= budget and plan["smem"] <= p8.MAX_SHARED
            assert plan["smem"] + row > p8.MAX_SHARED - 15     # the ring takes what is left
            assert plan["tile"] >= vb * k1 * shape[3] * 4 and plan["tile"] % 16 == 0
    with pytest.raises(ValueError, match="shared memory"):    # the output tile
        p8.launch_plan((4, 4, 8, 4), 4, 4096, p8.BUDGET, "banded")
    with pytest.raises(ValueError, match="shared memory"):    # the budget's rows
        p8.launch_plan((4, 4, 8, 4), 2, 64, 10 ** 6, "bandonly")


def _relayout_by_tiles(volT, shape):
    """probe_relayout_kernel's index map in numpy: every block of the 1D
    grid (launch_plan's tiles, (z, y) tiles fastest) reads its tile of volT
    and writes its (x, c) runs of vol [D*H, W, C]; returns vol and how often
    each element was written."""
    d, h, w, c = shape
    dh, tzy, tx = d * h, p7.RELAYOUT_ZY, p7.RELAYOUT_X
    tiles = p7.launch_plan(shape, 1)["relayout_tiles"]
    vol = np.full(dh * w * c, np.nan, np.float32)
    writes = np.zeros(dh * w * c, np.int64)
    i = np.arange(tzy * tx * c)
    for block in range(tiles[0] * tiles[1]):
        zy0, x0 = (block % tiles[0]) * tzy, (block // tiles[0]) * tx
        tile = np.zeros((tzy, tx * c + 1), np.float32)
        zy, r = i % tzy, i // tzy                            # read: along (z, y)
        ch, x = r // tx, r % tx
        ok = (zy0 + zy < dh) & (x0 + x < w)
        tile[zy[ok], (x * c + ch)[ok]] = volT[(ch * w + x0 + x)[ok], (zy0 + zy)[ok]]
        run = min(tx, w - x0) * c
        zy, j = i // (tx * c), i % (tx * c)                  # write: along (x, c)
        ok = (zy0 + zy < dh) & (j < run)
        at = ((zy0 + zy) * w + x0) * c + j
        vol[at[ok]] = tile[zy[ok], j[ok]]
        np.add.at(writes, at[ok], 1)
    return vol.reshape(dh, w, c), writes


@pytest.mark.parametrize("shape", [(16, 64, 64, 4), (3, 5, 7, 2), (2, 33, 17, 1)])
def test_relayout_index_map_is_channel_last(rng, shape):
    """Kernel 7's relayout writes every element of the channel-last table
    once, with volT's value: vol[z*H + y, x, c] = volT[c*W + x, z*H + y]."""
    d, h, w, c = shape
    volT = rng.standard_normal((c * w, d * h)).astype(np.float32)
    vol, writes = _relayout_by_tiles(volT, shape)
    assert (writes == 1).all()
    np.testing.assert_array_equal(vol, volT.reshape(c, w, d * h).transpose(2, 1, 0))
    plan = p7.launch_plan(shape, 1000)
    assert plan["sample_blocks"] == -(-1000 // p7.THREADS)
    with pytest.raises(ValueError, match="32-bit"):
        p7.launch_plan(shape, 2 ** 31)


def test_cpu_tensors_take_the_plain_versions(small_band):
    x, rows3, coords = small_band
    for m in (p7, p8, p9, p10):
        m.reset_launch_counts()
    table, idx = p9.inputs(2, 16, 8)
    p9.gather(torch.from_numpy(table), torch.from_numpy(idx))
    data, lidx = p10.inputs()
    p10.lane_gather(torch.from_numpy(data).bfloat16(), torch.from_numpy(lidx))
    volT = torch.zeros(8 * 4, 2 * 3)
    p7.proto_warp(volT, *(torch.zeros(1, 5) for _ in range(3)), (2, 3, 8, 4))
    out = p8.banded_warp(torch.from_numpy(rows3).bfloat16(),
                         *map(torch.from_numpy, coords(3.0)), (8, 8, 8, 4))
    assert out.shape == (1, 512, 8) and out.dtype == torch.float32
    for m in (p7, p8, p9, p10):
        kernel = next(k for k in m.launches if not k.endswith("_plain"))
        assert m.launches == {kernel: 0, kernel + "_plain": 1}


def test_kernel_wrappers_refuse_cpu_tensors(small_band):
    _, rows3, coords = small_band
    with pytest.raises(ValueError, match="CUDA"):
        p9.gather_cuda(torch.zeros(2, 4), torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        p10.lane_gather_cuda(torch.zeros(4, 8, dtype=torch.bfloat16),
                             torch.zeros(2, 1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        p7.proto_warp_cuda(torch.zeros(32, 6), *(torch.zeros(1, 5) for _ in range(3)),
                           (2, 3, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        p8.banded_warp_cuda(torch.from_numpy(rows3).bfloat16(),
                            *map(torch.from_numpy, coords(3.0)), (8, 8, 8, 4))
    with pytest.raises(ValueError, match="multiple of the block"):
        p8.banded_warp(torch.from_numpy(rows3).bfloat16(),
                       *(torch.from_numpy(a[..., :100]) for a in coords(3.0)), (8, 8, 8, 4))


def test_entry_points_run_on_the_cpu(monkeypatch, capsys):
    """Each probe's main() with --device cpu, at a tiny size."""
    monkeypatch.setattr(p9, "CASES", ((2, 16, 8), (3, 128, 64)))
    for name, v in dict(D=2, H=8, W=8, C=4, P=256).items():
        monkeypatch.setattr(p7, name, v)
    for name, v in dict(SMALL_BAND, N=2).items():
        monkeypatch.setattr(p8, name, v)
    for name, v in dict(CW=16, DH=64, VB=16, NB=4).items():
        monkeypatch.setattr(p10, name, v)
    for main in (p9.main, p10.main, p7.main):
        assert main(["--device", "cpu"]) == 0
    assert p8.main(["--device", "cpu", "--mode", "blockwhen"]) == 0
    out = capsys.readouterr().out
    assert out.count("ok=True") == 2
    assert "max err vs host gather: 0.0 (bit for bit: yes)" in out
    assert "probe_warp err vs oracle" in out and "onehot err vs oracle" in out
    assert out.count("bit for bit yes") == 2 and "probe fit rate" in out
