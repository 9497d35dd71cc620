"""Device times of the warp kernels (TPU kernels 1-3, the multi-grid warp:
csrc/warp_fwd.cu, csrc/warp_bwd.cu; kernels 4-6, the single-grid warp:
csrc/warp_grid.cu) at the main paths' call sites, batch 8, for comparing
two checkouts on one card.

    python facevae_tpu_torch/bench_warp.py              # this checkout
    python facevae_tpu_torch/bench_warp.py --root DIR   # the checkout at DIR

``--root`` times another checkout's kernels (say a ``git archive`` of the
parent commit) on the same inputs: they are drawn from a seeded
torch.Generator on the card in a fixed order, and only the wrappers'
shared arguments are used.  Run the two checkouts in turns in one call
(parent, change, change, parent) and compare within it.

Multi-grid sites: MFE (x [8,16,64,64,4], K1=15) on four coordinate sets,
Generator (x [8,16,64,64,32], K1=1) and the TPS frame (x [8,1,256,256,3],
K1=1, forward only, bf16), fp32 and bf16.  The sets: ``noisy``, ``sparse``
and ``sparse+probes`` (facevae_tpu_torch/warp_inputs.py), and ``step``: the
source features and coordinates of MFE's warp call in the first training
step of ModelConfig() at batch 8 in the case's dtype (seeded random weights
and images, as facevae_tpu_torch/bench.py builds the step), the call the
trained main path makes.  Single-grid sites: the Generator (gps=1, the
noisy set normalized) and the reference-form MFE call (x [8,16,64,64,4],
gps=16, warp_inputs.reference_form_grid), fp32 and bf16.  The inputs come
from this checkout's warp_inputs.py, so both checkouts get the same ones.
Per case one JSON line: the device time per call of the forward, dgrid and
dx kernels and, where the checkout has it, the dx kernels' deterministic
variant (``dx_det``; probes/common.py:graph_ms: 10 calls in one CUDA graph,
median of 20 replays), a digest of the inputs and of the forward's,
dgrid's and dx_det's outputs (equal digests on equal inputs: equal bits),
under the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import sys

if __name__ == "__main__":
    sys.path.pop(0)   # run by path: this directory's modules would shadow top-level names

import argparse
import hashlib
import importlib.util
import json
import subprocess
from pathlib import Path

N_BATCH, VOLUME = 8, (16, 64, 64)
ALL = ("fwd", "dgrid", "dx")
# (site, kernel family, C, K1 or gps, volume, coordinate set, dtypes, halves)
CASES = (("MFE", "warp", 4, 15, VOLUME, "noisy", ("float32", "bfloat16"), ALL),
         ("MFE", "warp", 4, 15, VOLUME, "sparse", ("float32", "bfloat16"), ALL),
         ("MFE", "warp", 4, 15, VOLUME, "sparse+probes", ("float32",), ALL),
         ("Generator", "warp", 32, 1, VOLUME, "noisy", ("float32", "bfloat16"), ALL),
         ("TPS", "warp", 3, 1, (1, 256, 256), "noisy", ("bfloat16",), ("fwd",)),
         ("MFE", "warp", 4, 15, VOLUME, "step", ("float32", "bfloat16"), ALL),
         ("Generator", "grid", 32, 1, VOLUME, "noisy", ("float32", "bfloat16"), ALL),
         ("MFE reference form", "grid", 4, 16, VOLUME, "reference form",
          ("float32", "bfloat16"), ALL))


def _inputs_module():
    """This checkout's warp_inputs.py, loaded by path: under --root the
    package name points at the other checkout, which may lack it."""
    path = Path(__file__).resolve().parent / "warp_inputs.py"
    spec = importlib.util.spec_from_file_location("_bench_warp_inputs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def step_inputs(dtype):
    """(x, [cgx, cgy, cgz]) of MFE's warp call in the first training step
    of ModelConfig(compute_dtype=dtype), batch 8, on the card: the call
    recorded as the step makes it (its backward runs too)."""
    import torch
    from facevae_tpu_torch.config import Config, ModelConfig
    from facevae_tpu_torch.models import mfe
    from facevae_tpu_torch.train import create_train_state, train_step
    cfg = Config(model=ModelConfig(compute_dtype=dtype))
    size = cfg.model.image_size
    state = create_train_state(cfg, device=torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = tuple(torch.rand(N_BATCH, size, size, 3, generator=g, device="cuda")
                  for _ in range(4))
    seen = []
    real = mfe.warp_multi_pixel

    def record(x, cgx, cgy, cgz, spatial):
        if not seen:
            seen.append((x.detach().clone(), [c.detach().contiguous().clone()
                                              for c in (cgx, cgy, cgz)]))
        return real(x, cgx, cgy, cgz, spatial)

    mfe.warp_multi_pixel = record
    try:
        train_step(state, batch, generator=g)
    finally:
        mfe.warp_multi_pixel = real
    del state
    torch.cuda.empty_cache()
    return seen[0]


def case_inputs(site, family, C, K1, volume, cset, g):
    """The coordinates (multi-grid) or normalized grid (single-grid) of one
    drawn case (drawn once for its dtypes)."""
    import torch
    inputs = _inputs_module()
    D, H, W = volume
    if cset == "reference form":
        return inputs.reference_form_grid(N_BATCH, K1 - 1, D, H, W, g)
    if cset.startswith("sparse"):
        return inputs.sparse_motion_coords(N_BATCH, K1, D, H, W, g,
                                           probes=cset == "sparse+probes")
    coords = inputs.noisy_coords(N_BATCH, K1, D, H, W, g)
    if site == "TPS":                              # a D=1 frame: z is exactly 0
        coords[2] = torch.zeros_like(coords[2])
    return inputs.normalized(coords, D, H, W) if family == "grid" else coords


def digest(*tensors):
    """A short hash of the tensors' bytes."""
    import torch
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _deterministic(fn):
    """fn() under torch.use_deterministic_algorithms(True) (the dx kernels'
    deterministic variants), the mode off after."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def _calls(fw, family, x, inp, gout, K1, volume):
    """half -> the kernel call of one case; "dx_det" (the dx kernels'
    deterministic variants) only where the checkout has them."""
    if family == "warp":
        calls = {"fwd": lambda: fw.warp_multi_pixel_cuda(x, *inp, volume),
                 "dgrid": lambda: fw.warp_multi_pixel_bwd_cuda(x, *inp, gout, volume, False)[1],
                 "dx": lambda: fw.warp_multi_pixel_bwd_cuda(x, *inp, gout, volume,
                                                            need_dgrid=False)[0],
                 "dx_det": lambda: _deterministic(lambda: fw.warp_multi_pixel_bwd_cuda(
                     x, *inp, gout, volume, need_dgrid=False)[0])}
    else:
        calls = {"fwd": lambda: fw.grid_sample_3d_cuda(x, inp, K1),
                 "dgrid": lambda: fw.grid_sample_3d_bwd_cuda(x, inp, gout, K1, False)[1],
                 "dx": lambda: fw.grid_sample_3d_bwd_cuda(x, inp, gout, K1,
                                                          need_dgrid=False)[0],
                 "dx_det": lambda: _deterministic(lambda: fw.grid_sample_3d_bwd_cuda(
                     x, inp, gout, K1, need_dgrid=False)[0])}
    if "warp_bwd_dx_det" not in fw.launches:
        del calls["dx_det"]
    return calls


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def run():
    """One dict per (case, dtype): the halves' device ms per call and the
    digests."""
    import torch
    from facevae_tpu_torch.ops import fast_warp as fw
    from facevae_tpu_torch.probes.common import graph_ms
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for site, family, C, K1, volume, cset, dtypes, halves in CASES:
        if cset != "step":
            inp = case_inputs(site, family, C, K1, volume, cset, g)
        for dname in dtypes:
            dtype = getattr(torch, dname)
            if cset == "step":
                x, inp = step_inputs(dname)
            else:
                x = torch.randn(N_BATCH, *volume, C, generator=g, device="cuda").to(dtype)
            gout = (torch.randn(N_BATCH, *volume, K1 * C, generator=g, device="cuda")
                    if family == "warp" else
                    torch.randn(N_BATCH * K1, *volume, C, generator=g, device="cuda")).to(dtype)
            calls = _calls(fw, family, x, inp, gout, K1, volume)
            halves_here = [*halves, *(["dx_det"] if "dx" in halves and "dx_det" in calls else [])]
            row = dict(site=site, family=family, set=cset, dtype=dname, C=C, K1=K1)
            row.update({f"{h}_ms": graph_ms(calls[h]) for h in halves_here})
            row["in_digest"] = digest(x, *(inp if family == "warp" else (inp,)), gout)
            for h in halves_here:
                if h != "dx":                      # dx adds with atomics: its bits vary
                    out = calls[h]()
                    row[f"{h}_digest"] = digest(*(out if isinstance(out, tuple) else (out,)))
            rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                   help="the checkout whose facevae_tpu_torch is timed (default: this one)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    import facevae_tpu_torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_warp times the CUDA kernels: no CUDA device")
    card = smi()
    for row in run():
        print(json.dumps({"root": str(Path(facevae_tpu_torch.__file__).parents[1]),
                          "card": card, **row}), flush=True)


if __name__ == "__main__":
    main()
