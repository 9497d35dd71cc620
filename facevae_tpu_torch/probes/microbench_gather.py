"""Probe 9: a gather from a table (port of tools/microbench_pallas_gather.py).

    python -m facevae_tpu_torch.probes.microbench_gather [--device cpu]

out[s, p] = table[s, idx[s, p]] for the probe's seven (S, T, P) cases, table
fp32.  The TPU probe asked whether Mosaic lowers a lane-axis take_along_axis
at table widths 128 to 65536; on the card the gather is
csrc/probe_gather.cu (probe_gather_kernel).  Per case it prints whether the
result equals numpy's take_along_axis (the probe's oracle) bit for bit, the
time per call, GB/s gathered, the bound, torch.gather's time on the same
inputs and, on the card, the launch floor: an empty kernel in the same
grid.  An index outside [0, T) reads 0 in the kernel and in its plain
version.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from facevae_tpu_torch import kernels
from facevae_tpu_torch.probes import common

CASES = ((8, 128, 1024), (8, 1024, 1024), (8, 1024, 8192), (8, 8192, 8192),
         (8, 65536, 8192), (32, 1024, 8192), (16, 65536, 8192))
launches = {"probe_gather": 0, "probe_gather_plain": 0}
floor_launches = {"probe_gather_floor": 0}


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def inputs(S, T, P, seed=0):
    """numpy: table [S, T] fp32 standard normal, idx [S, P] int32 in [0, T)."""
    rs = np.random.RandomState(seed)
    return rs.randn(S, T).astype(np.float32), rs.randint(0, T, (S, P)).astype(np.int32)


def _check(table, idx):
    if table.dim() != 2 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"gather takes table [S,T] and idx [S,P], got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")


def gather_plain(table, idx):
    """The kernel's plain version: torch.gather with out-of-range reads 0."""
    _check(table, idx)
    launches["probe_gather_plain"] += 1
    i = idx.long()
    inside = (i >= 0) & (i < table.shape[1])
    got = torch.gather(table, 1, i.clamp(0, max(table.shape[1] - 1, 0)))
    return torch.where(inside, got, got.new_zeros(()))


def _launch_args(table, idx):
    """Check what the kernel takes; (out, S, T, P) for a launch."""
    _check(table, idx)
    if not table.is_cuda:
        raise ValueError(f"probe_gather kernel needs CUDA tensors, got {table.device}")
    common.check_tensor("probe_gather", "table", table, torch.float32, table.device)
    common.check_tensor("probe_gather", "idx", idx, torch.int32, table.device)
    S, T = table.shape
    P = idx.shape[1]
    if max(S, T, P) >= 2 ** 31 - 4:
        raise ValueError(f"[S,T,P]={[S, T, P]} exceeds the kernel's 32-bit sizes")
    return torch.empty((S, P), dtype=table.dtype, device=table.device), S, T, P


def gather_cuda(table, idx):
    """Launch probe_gather_kernel on CUDA tensors: table fp32 [S, T], idx
    int32 [S, P], both contiguous; raises on anything else.  Its 16-byte
    form where P % 4 == 0 and idx is 16-byte aligned, else its scalar one."""
    out, S, T, P = _launch_args(table, idx)
    if out.numel():
        vec = int(P % 4 == 0 and idx.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        fn = kernels.function("probe_gather", "facevae_probe_gather",
                              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        with torch.cuda.device(table.device):
            kernels.launch(launches, "probe_gather", fn, table.data_ptr(), idx.data_ptr(),
                           out.data_ptr(), S, T, P, vec, common.stream(table))
    return out


def gather_floor_cuda(table, idx):
    """Launch an empty kernel in probe_gather_kernel's grid and block on the
    same arguments (it writes nothing): the launch floor that kernel 9's
    time is read against.  Counted in floor_launches, not launches."""
    out, S, T, P = _launch_args(table, idx)
    if out.numel():
        fn = kernels.function("probe_gather", "facevae_probe_gather_floor",
                              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        with torch.cuda.device(table.device):
            kernels.launch(floor_launches, "probe_gather_floor", fn, table.data_ptr(),
                           idx.data_ptr(), out.data_ptr(), S, T, P, common.stream(table))
    return out


def gather(table, idx):
    """out[s, p] = table[s, idx[s, p]]: the kernel for CUDA tensors, the
    plain version for CPU ones."""
    return (gather_cuda if common.on_cuda("gather", table) else gather_plain)(table, idx)


def run(dev, cases=None, seed=0, runs=20):
    """The probe on ``dev``: per case a dict with the result's agreement with
    numpy's take_along_axis (``equal``, ``err``), ``ms`` per call, GB/s
    gathered, ``bound_ms`` and ``bound_by`` (the distinct table entries
    read, the indices and the output over 3.35 TB/s), torch.gather's
    ``library_ms``, on the card the launch floor ``floor_ms`` (an empty
    kernel in the same grid, gather_floor_cuda; None on the CPU) and the
    inputs (``args``); cases default to CASES."""
    timer = common.timer(dev)
    rows = []
    for S, T, P in CASES if cases is None else cases:
        table_np, idx_np = inputs(S, T, P, seed)
        table, idx = torch.from_numpy(table_np).to(dev), torch.from_numpy(idx_np).to(dev)
        got = gather(table, idx).cpu().numpy()
        want = np.take_along_axis(table_np, idx_np, axis=-1)
        ms = timer(lambda: gather(table, idx), runs)
        ilong = idx.long()
        library_ms = timer(lambda: torch.gather(table, 1, ilong), runs)
        floor_ms = (timer(lambda: gather_floor_cuda(table, idx), runs) if table.is_cuda
                    else None)
        touched = torch.unique(ilong + torch.arange(S, device=dev)[:, None] * T).numel()
        bound_ms, bound_by = common.bound_ms(4 * (touched + 2 * S * P))
        rows.append(dict(case=(S, T, P), equal=bool(np.array_equal(got, want)),
                         err=float(np.abs(got - want).max()), ms=ms,
                         gbps=S * P * 4 / (ms * 1e-3) / 1e9, library_ms=library_ms, floor_ms=floor_ms,
                         bound_ms=bound_ms, bound_by=bound_by, args=(table, idx)))
    return rows


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    print(common.card(dev))
    for r in run(dev):
        S, T, P = r["case"]
        print(f"S={S:3d} T={T:6d} P={P:6d} float32 ok={r['equal']}  "
              f"{r['ms'] * 1e3:9.1f} us ({common.time_label(dev)})  {r['gbps']:8.1f} GB/s "
              f"gathered; bound {r['bound_ms'] * 1e3:.2f} us, torch.gather "
              f"{r['library_ms'] * 1e3:.1f} us"
              + ("" if r["floor_ms"] is None else
                 f", an empty kernel in the same grid {r['floor_ms'] * 1e3:.1f} us"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
