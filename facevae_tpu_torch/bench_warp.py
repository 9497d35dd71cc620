"""Device times of the warp kernels (TPU kernels 1-3, the multi-grid warp:
csrc/warp_fwd.cu, csrc/warp_bwd.cu; kernels 4-6, the single-grid warp:
csrc/warp_grid.cu) at the main paths' call sites, batch 8, for comparing
two checkouts on one card.

    python facevae_tpu_torch/bench_warp.py              # this checkout
    python facevae_tpu_torch/bench_warp.py --root DIR   # the checkout at DIR
    python facevae_tpu_torch/bench_warp.py --probes [--root DIR]   # kernels 7, 8 and 9

``--root`` times another checkout's kernels (say a ``git archive`` of the
parent commit) on the same inputs: they are drawn from a seeded
torch.Generator on the card in a fixed order, and only the wrappers'
shared arguments are used.  Run the two checkouts in turns in one call
(parent, change, change, parent) and compare within it.

Multi-grid sites: MFE (x [8,16,64,64,4], K1=15) on four coordinate sets,
Generator (x [8,16,64,64,32], K1=1) and the TPS frame (x [8,1,256,256,3],
K1=1, forward only, bf16), fp32 and bf16.  The sets: ``noisy``, ``sparse``
and ``sparse+probes`` (facevae_tpu_torch/warp_inputs.py; ``sparse`` at
K1=1 for the Generator, one keypoint's smooth motion), and ``step``: the
inputs of the warp call in the first training step of ModelConfig() at
batch 8 in the case's dtype (seeded random weights and images, as
facevae_tpu_torch/bench.py builds the step), the calls the trained main
path makes: MFE's source features and coordinates (fp32, bf16), and the
Generator's appearance volume and deformation (``generator_step_inputs``:
its normalized grid for the single-grid kernels at fp32, its pixel
coordinates at K1=1 for the multi-grid kernels at bf16, as warp_single
dispatches).  Single-grid sites: the Generator (gps=1, the noisy and
sparse sets normalized, and its step set) and the reference-form MFE call
(x [8,16,64,64,4], gps=16, warp_inputs.reference_form_grid), fp32 and
bf16, and the Generator's forward at N = 1 (x [1,16,64,64,32]: evaluation's
gif modes; its step set and the noisy set, fp32).  The inputs come from
this checkout's warp_inputs.py and this script's recorders, so both
checkouts get the same ones (a step set is
computed by the timed checkout's own step, whose forward kernels are the
same bits in both so far: the input digests say so).
Per case one JSON line: the device time per call of the forward, dgrid and
dx kernels and, where the checkout has it, the dx kernels' deterministic
variant (``dx_det``; probes/common.py:graph_ms: 10 calls in one CUDA graph,
median of 20 replays), a digest of the inputs and of the forward's,
dgrid's and dx_det's outputs (equal digests on equal inputs: equal bits),
under the card's name and power limit, and the device time of
F.grid_sample's forward and backward on the same samples
(``library_calls``: the yardstick chip_smoke.py phase 3 prints beside the
kernels, never called by the port).

``--probes`` times three probe kernels instead (``probe_rows``, at the
probes' own shapes and on their own inputs, drawn with numpy by this
checkout's probe modules): kernel 8 (probe_banded_warp) in each mode at
theta = 3 and 40 degrees, kernel 7 (probe_warp) and kernel 9
(probe_gather) at its seven cases, with digests of the inputs, of the
outputs and of kernel 8's staged flags, F.grid_sample's (torch.gather's)
time on the same samples, and kernel 9's launch floor.  Needs a CUDA card.
"""
from __future__ import annotations

import sys

if __name__ == "__main__":
    sys.path.pop(0)   # run by path: this directory's modules would shadow top-level names

import argparse
import contextlib
import hashlib
import importlib.util
import json
import subprocess
from pathlib import Path

N_BATCH, VOLUME = 8, (16, 64, 64)
ALL = ("fwd", "dgrid", "dx")
# (site, kernel family, C, K1 or gps, volume, coordinate set, dtypes, halves,
# batch); new cases go last, so the draws of the earlier ones stay as they were
CASES = (("MFE", "warp", 4, 15, VOLUME, "noisy", ("float32", "bfloat16"), ALL, N_BATCH),
         ("MFE", "warp", 4, 15, VOLUME, "sparse", ("float32", "bfloat16"), ALL, N_BATCH),
         ("MFE", "warp", 4, 15, VOLUME, "sparse+probes", ("float32",), ALL, N_BATCH),
         ("Generator", "warp", 32, 1, VOLUME, "noisy", ("float32", "bfloat16"), ALL, N_BATCH),
         ("TPS", "warp", 3, 1, (1, 256, 256), "noisy", ("bfloat16",), ("fwd",), N_BATCH),
         ("MFE", "warp", 4, 15, VOLUME, "step", ("float32", "bfloat16"), ALL, N_BATCH),
         ("Generator", "grid", 32, 1, VOLUME, "noisy", ("float32", "bfloat16"), ALL, N_BATCH),
         ("MFE reference form", "grid", 4, 16, VOLUME, "reference form",
          ("float32", "bfloat16"), ALL, N_BATCH),
         ("Generator", "warp", 32, 1, VOLUME, "step", ("bfloat16",), ALL, N_BATCH),
         ("Generator", "grid", 32, 1, VOLUME, "step", ("float32",), ALL, N_BATCH),
         ("Generator", "warp", 32, 1, VOLUME, "sparse", ("float32", "bfloat16"), ALL, N_BATCH),
         ("Generator", "grid", 32, 1, VOLUME, "sparse", ("float32", "bfloat16"), ALL, N_BATCH),
         # evaluation's gif modes: the Generator's single-grid forward at N = 1
         ("Generator", "grid", 32, 1, VOLUME, "step", ("float32",), ("fwd",), 1),
         ("Generator", "grid", 32, 1, VOLUME, "noisy", ("float32",), ("fwd",), 1))


def _module(relpath):
    """This checkout's facevae_tpu_torch/<relpath>, loaded by path: under
    --root the package name points at the other checkout, which may lack
    it or differ."""
    path = Path(__file__).resolve().parent / relpath
    spec = importlib.util.spec_from_file_location("_bench_warp_" + path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs_module():
    return _module("warp_inputs.py")


@contextlib.contextmanager
def recording(module, name):
    """``module.<name>`` patched to record the arguments of its first call
    (tensors detached, contiguous and cloned) into the list this yields;
    the patch calls the real function and is undone on exit, also when the
    body raises."""
    import torch
    seen = []
    real = getattr(module, name)

    def record(*args):
        if not seen:
            seen.append(tuple(a.detach().contiguous().clone() if torch.is_tensor(a) else a
                              for a in args))
        return real(*args)

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def record_first_call(cfg, module, name, device="cuda", batch=N_BATCH):
    """Run the first training step of ``cfg`` at ``batch`` on ``device``
    (seeded weights, as create_train_state builds them, and seeded random
    images, as facevae_tpu_torch/bench.py builds the step) with
    ``module.<name>`` patched to record the arguments of its first call;
    returns (those arguments, tensors detached, contiguous and cloned; the
    step's output).  The patch calls the real function, so the step is the
    one it would be, and is undone when the step returns or raises
    (``recording``)."""
    import torch
    from facevae_tpu_torch.train import create_train_state, train_step
    size = cfg.model.image_size
    state = create_train_state(cfg, device=torch.device(device))
    g = torch.Generator(device=device).manual_seed(0)
    images = tuple(torch.rand(batch, size, size, 3, generator=g, device=device)
                   for _ in range(4))
    with recording(module, name) as seen:
        out = train_step(state, images, generator=g)
    del state
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return seen[0], out


def step_inputs(dtype):
    """(x, [cgx, cgy, cgz]) of MFE's warp call in the first training step
    of ModelConfig(compute_dtype=dtype), batch 8, on the card."""
    from facevae_tpu_torch.config import Config, ModelConfig
    from facevae_tpu_torch.models import mfe
    (x, cgx, cgy, cgz, _), _ = record_first_call(
        Config(model=ModelConfig(compute_dtype=dtype)), mfe, "warp_multi_pixel")
    return x, [cgx, cgy, cgz]


def generator_step_inputs(dtype, device="cuda", cfg=None, batch=N_BATCH):
    """The Generator's warp_single call in the first training step of
    ``cfg`` (default Config(): ModelConfig()) at compute_dtype ``dtype``:
    the source volume x [N,D,H,W,C] and, at fp32 (the single-grid kernels
    4-6 at gps = 1), its normalized grid [N,D,H,W,3]; at bf16 (the
    multi-grid kernels 1-3 at K1 = 1) the pixel coordinates [cgx, cgy, cgz]
    [N,1,D*H*W] that warp_single hands the multi-grid warp."""
    import dataclasses
    from facevae_tpu_torch.config import Config
    from facevae_tpu_torch.models import generator
    from facevae_tpu_torch.ops.fast_warp import _grid_pixels
    cfg = cfg or Config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    (x, grid), _ = record_first_call(cfg, generator, "warp_single", device, batch)
    if dtype == "float32":
        return x, grid
    return x, [c.contiguous() for c in _grid_pixels(x, grid, 1)]


def case_inputs(site, family, C, K1, volume, cset, g, batch=N_BATCH):
    """The coordinates (multi-grid) or normalized grid (single-grid) of one
    drawn case at ``batch`` (drawn once for its dtypes)."""
    import torch
    inputs = _inputs_module()
    D, H, W = volume
    if cset == "reference form":
        return inputs.reference_form_grid(batch, K1 - 1, D, H, W, g)
    if cset.startswith("sparse"):
        coords = inputs.sparse_motion_coords(batch, K1, D, H, W, g,
                                             probes=cset == "sparse+probes")
        return inputs.normalized(coords, D, H, W) if family == "grid" else coords
    coords = inputs.noisy_coords(batch, K1, D, H, W, g)
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


def library_calls(x, grid, gout):
    """F.grid_sample (3D, bilinear, zeros, align_corners=True) on the same
    samples, in x's dtype: x [N,D,H,W,C] repeated per grid as NCDHW, the
    normalized grid [G,D,H,W,3] (rounded to bf16 for a bf16 x, as
    F.grid_sample takes one dtype: a yardstick of time, never compared), the
    cotangent [G,D,H,W,C]; half -> its forward ("fwd"), and its backward
    (the one aten call autograd makes, so a CUDA graph can hold it) for the
    grid alone ("bwd_dgrid") and for the source alone ("bwd_dx").  The port
    never calls it; chip_smoke.py phase 3 and run() time it."""
    import torch
    import torch.nn.functional as F
    N, D, H, W, C = x.shape
    G = grid.shape[0]
    src = (x.permute(0, 4, 1, 2, 3)[:, None].expand(N, G // N, C, D, H, W)
           .reshape(G, C, D, H, W).contiguous())
    grid = torch.nan_to_num(grid, posinf=1e6, neginf=-1e6).to(x.dtype)
    g = gout.to(x.dtype).permute(0, 4, 1, 2, 3).contiguous()

    def bwd(mask):
        # interpolation 0 = bilinear, padding 0 = zeros, align_corners
        return lambda: torch.ops.aten.grid_sampler_3d_backward(g, src, grid, 0, 0, True, mask)

    return {"fwd": lambda: F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                                         align_corners=True),
            "bwd_dgrid": bwd([False, True]), "bwd_dx": bwd([True, False])}


def _library_of(family, x, inp, gout, K1, volume):
    """half -> library_calls' call on one case's samples (the multi-grid
    coordinates normalized, the k-major cotangent made grid-major)."""
    if family == "grid":
        calls = library_calls(x, inp, gout)
    else:
        N, C = x.shape[0], x.shape[-1]
        grid = _inputs_module().normalized(inp, *volume)
        gm = gout.reshape(N, -1, K1, C).permute(0, 2, 1, 3).reshape(N * K1, *volume, C)
        calls = library_calls(x, grid, gm)
    return {"fwd": calls["fwd"], "dgrid": calls["bwd_dgrid"], "dx": calls["bwd_dx"]}


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def run():
    """One dict per (case, dtype): the halves' device ms per call, those of
    library_calls on the same samples (``library_<half>_ms``), and the
    digests; N is the case's batch."""
    import torch
    from facevae_tpu_torch.ops import fast_warp as fw
    from facevae_tpu_torch.probes.common import graph_ms
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for site, family, C, K1, volume, cset, dtypes, halves, batch in CASES:
        if cset != "step":
            inp = case_inputs(site, family, C, K1, volume, cset, g, batch)
        for dname in dtypes:
            dtype = getattr(torch, dname)
            if cset == "step":
                x, inp = (step_inputs(dname) if site == "MFE" else
                          generator_step_inputs(dname, batch=batch))
            else:
                x = torch.randn(batch, *volume, C, generator=g, device="cuda").to(dtype)
            gout = (torch.randn(batch, *volume, K1 * C, generator=g, device="cuda")
                    if family == "warp" else
                    torch.randn(batch * K1, *volume, C, generator=g, device="cuda")).to(dtype)
            calls = _calls(fw, family, x, inp, gout, K1, volume)
            halves_here = [*halves, *(["dx_det"] if "dx" in halves and "dx_det" in calls else [])]
            row = dict(site=site, family=family, set=cset, dtype=dname, C=C, K1=K1, N=batch)
            row.update({f"{h}_ms": graph_ms(calls[h]) for h in halves_here})
            row.update({f"library_{h}_ms": graph_ms(call) for h, call in
                        _library_of(family, x, inp, gout, K1, volume).items()
                        if h in halves})
            row["in_digest"] = digest(x, *(inp if family == "warp" else (inp,)), gout)
            for h in halves_here:
                if h != "dx":                      # dx adds with atomics: its bits vary
                    out = calls[h]()
                    row[f"{h}_digest"] = digest(*(out if isinstance(out, tuple) else (out,)))
            rows.append(row)
    return rows


def probe_rows():
    """--probes: one dict per kernel 8 (mode, theta), one for kernel 7 and
    one per kernel 9 case: device ms per call of the timed checkout's
    wrapper, kernel 9's launch floor where the checkout has it (an empty
    kernel in its grid, ``floor_ms``) and torch.gather's time, F.grid_sample's
    (kernel 8: on an fp32 source repeated per grid, made before the timed
    call, ``library_ms``, and inside it from rows3, ``library_relayout_ms``;
    kernel 7: on a contiguous copy of the table, ``library_ms``, and on
    volT's permuted view, ``library_view_ms``), and digests."""
    import torch
    import torch.nn.functional as F
    from facevae_tpu_torch.probes import proto_banded_warp as p8
    from facevae_tpu_torch.probes import proto_warp as p7
    from facevae_tpu_torch.probes.common import graph_ms
    g8, g7 = _module("probes/proto_banded_warp.py"), _module("probes/proto_warp.py")

    def library(src, grid):
        return lambda: F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                                     align_corners=True)

    def normalized(coords, sizes):
        return torch.stack([a * (2.0 / (s - 1)) - 1.0 for a, s in zip(coords, sizes)], -1)

    N, D, H, W, C, K1 = g8.N, g8.D, g8.H, g8.W, g8.C, g8.K1
    shape = (D, H, W, C)
    _, rows3_np, coords = g8.inputs()
    coords(3.0)                    # the probe's numerics draw: the timed grids come next
    rows3 = torch.from_numpy(rows3_np).bfloat16().cuda()

    def per_grid():
        return (g8.rows3_to_x(rows3, shape).float().permute(0, 4, 1, 2, 3)[:, None]
                .expand(N, K1, C, D, H, W).reshape(N * K1, C, D, H, W).contiguous())

    rows = []
    for theta in g8.THETAS:
        cg = [torch.from_numpy(a).cuda() for a in coords(theta)]
        grid = normalized(cg, (W, H, D)).reshape(N * K1, D, H, W, 3)
        src = per_grid()
        lib = dict(library_ms=graph_ms(library(src, grid)),
                   library_relayout_ms=graph_ms(lambda: library(per_grid(), grid)()))
        del src
        for mode in g8.MODES:
            staged = torch.zeros(N, cg[0].shape[2] // g8.VB, K1, dtype=torch.uint8,
                                 device="cuda")
            out = p8.banded_warp_cuda(rows3, *cg, shape, mode, g8.VB, g8.BUDGET, staged)
            rows.append(dict(kernel="probe_banded_warp", theta=theta, mode=mode,
                             ms=graph_ms(lambda: p8.banded_warp_cuda(rows3, *cg, shape, mode,
                                                                     g8.VB, g8.BUDGET)),
                             **lib, staged=staged.float().mean().item(),
                             in_digest=digest(rows3, *cg), digest=digest(out),
                             staged_digest=digest(staged)))
        del cg, grid
    _, _, volT_np, *c7 = g7.inputs()
    shape = (g7.D, g7.H, g7.W, g7.C)
    volT = torch.from_numpy(volT_np).cuda()
    g = [torch.from_numpy(a).reshape(1, -1).cuda() for a in c7]
    view = volT.reshape(g7.C, g7.W, g7.D, g7.H).permute(0, 2, 3, 1)[None]
    grid = normalized([a[0] for a in g], (g7.W, g7.H, g7.D)).reshape(1, 1, 1, -1, 3)
    rows.append(dict(kernel="probe_warp", P=g[0].shape[1],
                     ms=graph_ms(lambda: p7.proto_warp_cuda(volT, *g, shape)),
                     library_ms=graph_ms(library(view.contiguous(), grid)),
                     library_view_ms=graph_ms(library(view, grid)),
                     in_digest=digest(volT, *g),
                     digest=digest(p7.proto_warp_cuda(volT, *g, shape))))
    from facevae_tpu_torch.probes import microbench_gather as p9
    g9 = _module("probes/microbench_gather.py")
    floor = getattr(p9, "gather_floor_cuda", None)       # where the checkout has it
    for S, T, P in g9.CASES:
        table, idx = (torch.from_numpy(a).cuda() for a in g9.inputs(S, T, P))
        ilong = idx.long()
        rows.append(dict(kernel="probe_gather", case=(S, T, P),
                         ms=graph_ms(lambda: p9.gather_cuda(table, idx)),
                         floor_ms=None if floor is None else graph_ms(lambda: floor(table, idx)),
                         library_ms=graph_ms(lambda: torch.gather(table, 1, ilong)),
                         in_digest=digest(table, idx), digest=digest(p9.gather_cuda(table, idx))))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                   help="the checkout whose facevae_tpu_torch is timed (default: this one)")
    p.add_argument("--probes", action="store_true",
                   help="time probe kernels 7, 8 and 9 instead of kernels 1-6")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    import facevae_tpu_torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_warp times the CUDA kernels: no CUDA device")
    card = smi()
    for row in (probe_rows() if args.probes else run()):
        print(json.dumps({"root": str(Path(facevae_tpu_torch.__file__).parents[1]),
                          "card": card, **row}), flush=True)


if __name__ == "__main__":
    main()
