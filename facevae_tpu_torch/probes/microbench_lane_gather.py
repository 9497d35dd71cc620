"""Probe 10: a column gather shared by every row of a table (port of
tools/microbench_lane_gather.py).

    python -m facevae_tpu_torch.probes.microbench_lane_gather [--device cpu]

out[b, r, v] = data[r, idx[b, 0, v]] with data [CW=256, DH=1024] bf16 and
idx [NB=128, 1, VB=512] int32: per block of VB voxels, the warp's (z, y)
corner lookup at the MFE shape, one column of the [C*W, D*H] row matrix per
voxel.  On the card the gather is csrc/probe_gather.cu
(probe_lane_gather_kernel).  It prints the time per call, the effective
GB/s and Gelem/s as the TPU probe does, the error against numpy's gather
(the probe's oracle, here over every block), the bound and the time of
torch.gather on the same inputs.  An index outside [0, DH) reads 0.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from facevae_tpu_torch import kernels
from facevae_tpu_torch.probes import common

CW, DH, VB, NB = 256, 1024, 512, 128
launches = {"probe_lane_gather": 0, "probe_lane_gather_plain": 0}


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def inputs(seed=0):
    """The probe's draws from RandomState(seed): data [CW, DH] uniform in
    [0, 1) as bf16 (numpy fp32 holding the bf16 values) and idx
    [NB, 1, VB] int32 in [0, DH)."""
    rs = np.random.RandomState(seed)
    data = torch.from_numpy(rs.rand(CW, DH).astype(np.float32)).bfloat16().float().numpy()
    return data, rs.randint(0, DH, (NB, 1, VB)).astype(np.int32)


def _check(data, idx):
    if data.dim() != 2 or idx.dim() != 3 or idx.shape[1] != 1:
        raise ValueError(f"lane_gather takes data [CW,DH] and idx [NB,1,VB], got "
                         f"{tuple(data.shape)} and {tuple(idx.shape)}")


def lane_gather_plain(data, idx):
    """The kernel's plain version: [NB, CW, VB], out-of-range reads 0."""
    _check(data, idx)
    launches["probe_lane_gather_plain"] += 1
    i = idx[:, 0].long()                                      # [NB, VB]
    inside = (i >= 0) & (i < data.shape[1])
    got = data[:, i.clamp(0, max(data.shape[1] - 1, 0))]     # [CW, NB, VB]
    return torch.where(inside[None], got, got.new_zeros(())).permute(1, 0, 2).contiguous()


def lane_gather_cuda(data, idx):
    """Launch probe_lane_gather_kernel on CUDA tensors: data bf16 [CW, DH],
    idx int32 [NB, 1, VB] with VB % 8 == 0, both contiguous and 16-byte
    aligned; raises on anything else."""
    _check(data, idx)
    if not data.is_cuda:
        raise ValueError(f"probe_lane_gather kernel needs CUDA tensors, got {data.device}")
    common.check_tensor("probe_lane_gather", "data", data, torch.bfloat16, data.device)
    common.check_tensor("probe_lane_gather", "idx", idx, torch.int32, data.device)
    cw, dh = data.shape
    nb, vb = idx.shape[0], idx.shape[2]
    if vb % 8 or idx.data_ptr() % 16:
        raise ValueError(f"probe_lane_gather kernel takes VB % 8 == 0 and a 16-byte aligned "
                         f"idx, got VB={vb}")
    if max(cw, dh, nb, vb) >= 2 ** 31 or nb * cw * vb // 8 >= 2 ** 31 * 256:
        raise ValueError(f"[CW,DH,NB,VB]={[cw, dh, nb, vb]} exceeds the kernel's sizes")
    out = torch.empty((nb, cw, vb), dtype=data.dtype, device=data.device)
    if out.numel():
        fn = kernels.function("probe_gather", "facevae_probe_lane_gather",
                              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        with torch.cuda.device(data.device):
            kernels.launch(launches, "probe_lane_gather", fn, data.data_ptr(), idx.data_ptr(),
                           out.data_ptr(), cw, dh, nb, vb, common.stream(data))
    return out


def lane_gather(data, idx):
    """out[b, r, v] = data[r, idx[b, 0, v]]: the kernel for CUDA tensors, the
    plain version for CPU ones."""
    return (lane_gather_cuda if common.on_cuda("lane_gather", data) else
            lane_gather_plain)(data, idx)


def run(dev, seed=0, runs=20):
    """The probe on ``dev``: a dict with the max error against numpy's
    gather (``err``, ``equal``), ``ms`` per call, ``gbps`` and ``gelems``
    effective, ``bound_ms`` (table, indices and output over 3.35 TB/s),
    ``library_ms`` (torch.gather on the table expanded to [NB, CW, DH]) and
    the inputs (``args``)."""
    timer = common.timer(dev)
    data_np, idx_np = inputs(seed)
    data = torch.from_numpy(data_np).bfloat16().to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    got = lane_gather(data, idx).float().cpu().numpy()
    want = np.stack([data_np[:, idx_np[b, 0]] for b in range(NB)])
    ms = timer(lambda: lane_gather(data, idx), runs)
    nb, vb = idx.shape[0], idx.shape[2]
    index = idx.long().expand(nb, data.shape[0], vb)
    table = data.expand(nb, *data.shape)
    library_ms = timer(lambda: torch.gather(table, 2, index), runs)
    elems = nb * data.shape[0] * vb
    bound_ms, bound_by = common.bound_ms(data.numel() * 2 + idx.numel() * 4 + elems * 2)
    return dict(err=float(np.abs(got - want).max()), equal=bool(np.array_equal(got, want)),
                ms=ms, gbps=elems * 2 / (ms * 1e-3) / 1e9, gelems=elems / (ms * 1e-3) / 1e9,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, args=(data, idx))


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    print(common.card(dev))
    r = run(dev)
    print(f"lane gather [CW={CW}, DH={DH}] x {NB} blocks of VB={VB}: {r['ms']:.4f} ms/iter "
          f"({common.time_label(dev)})  {r['gbps']:.1f} GB/s effective "
          f"({r['gelems']:.2f} Gelem/s); bound {r['bound_ms']:.4f} ms, torch.gather "
          f"{r['library_ms']:.4f} ms")
    print(f"max err vs host gather: {r['err']} (bit for bit: {'yes' if r['equal'] else 'no'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
