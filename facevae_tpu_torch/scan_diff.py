"""Where a replay of the multi-step dispatcher (train/scan.py) first computes
differently from the eager step from the same state, on one GPU:

    python -m facevae_tpu_torch.scan_diff
    python -m facevae_tpu_torch.scan_diff --alone MODULE

builds ModelConfig() (fp32, where replays part from eager; bf16 replays
are bit for bit) at batch 8 over seeded uint8 frames on the card, with
forward hooks that copy the input and output of every module of the
Generator (and a spectral-norm conv's u and v) into fixed buffers, so
that the graph and the eager step write the same buffers; runs the
dispatcher's eager warm-up, its capture and one replay; then restores the
state, runs the loop's eager step, restores it again, runs one replay,
and prints which losses differ, in call order the first buffers that
differ (elements, max |difference|), and the first module whose output
differs while its input does not.  --alone MODULE runs one eager step (no
dispatcher, so no graph pool beside it) and then that module alone on the
input the step gave it, from the same buffers, eagerly and captured in a
graph of its own.  There is no CPU fallback: CUDA graphs need the card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from facevae_tpu_torch.config import Config, ModelConfig
from facevae_tpu_torch.train import create_train_state, train_step
from facevae_tpu_torch.train.scan import ScanStep
from facevae_tpu_torch.train.step import step_seed

BATCH, FRAMES, SEED = 8, 32, 1
NET, SHOW = "generator", 8         # the net hooked; the differing buffers printed


class Buffers:
    """Forward hooks on every module of a net: each call's input and output
    (a spectral-norm conv's u and v too) copied into one fixed buffer per
    (module, what), in first-call order."""

    def __init__(self, net: torch.nn.Module):
        self.bufs, self.mods = {}, {}
        for name, mod in net.named_modules():
            self.mods[name or "."] = mod
            mod.register_forward_hook(self._hook(name or "."))

    def keep(self, key, t):
        if not torch.is_tensor(t):
            return
        if key not in self.bufs:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{key}: first seen inside the capture")
            self.bufs[key] = torch.empty_like(t, memory_format=torch.contiguous_format)
        self.bufs[key].copy_(t.detach())

    def _hook(self, name):
        def hook(mod, inp, out):
            self.keep((name, "in"), inp[0] if inp else None)
            self.keep((name, "out"), out[0] if isinstance(out, (tuple, list)) else out)
            if getattr(mod, "spectral_norm", False) and mod.training:
                self.keep((name, "u"), mod.weight_u)
                self.keep((name, "v"), mod.weight_v)
        return hook

    def snapshot(self):
        return {k: v.clone() for k, v in self.bufs.items()}


def _differs(a, b):
    if a.dtype.is_floating_point:
        a, b = a.double(), b.double()
    d = (a - b).abs()
    return int((d > 0).sum()), float(d.max()) if d.numel() else 0.0


def alone(mod, x, buffers):
    """``mod(x)`` eagerly and captured in a graph of its own, each from the
    same module buffers: (output elements that differ, of how many, max
    |difference|)."""
    saved = [b.clone() for b in buffers]

    def run():
        torch._foreach_copy_(buffers, saved)
        return mod(x)
    eager = run().detach().clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    return (*_differs(out, eager), out.numel())


def _setup(rows):
    if not torch.cuda.is_available():
        raise RuntimeError("scan_diff compares CUDA-graph replays; no CUDA device")
    dev = torch.device("cuda")
    rs = np.random.RandomState(12)
    frames = torch.from_numpy(rs.randint(0, 256, (FRAMES, 256, 256, 3)).astype(np.uint8)).to(dev)
    s_tab, d_tab = (torch.from_numpy(rs.randint(0, FRAMES, (rows, BATCH))).to(dev)
                    for _ in range(2))
    state = create_train_state(Config(model=ModelConfig(compute_dtype="float32")), dev)
    return frames, s_tab, d_tab, state, Buffers(state.nets[NET])


def _seed_of(step):
    return step_seed(SEED, step)


def run_alone(name):
    """One eager step, then module ``name`` of the net alone on the input
    that step gave it: (output elements that differ, of how many, max
    |difference|) between eager and captured."""
    frames, s_tab, d_tab, state, hooks = _setup(1)
    gen = torch.Generator(device=frames.device)
    gen.manual_seed(_seed_of(0))
    train_step(state, (frames.index_select(0, s_tab[0]), frames.index_select(0, d_tab[0])),
               generator=gen, fused_aug=True)
    mod = hooks.mods[name]
    count, top, total = alone(mod, hooks.bufs[(name, "in")], list(mod.buffers()))
    print(f"[scan_diff] float32 {NET}.{name} alone on an eager step's input, eager against "
          f"captured in a graph of its own: {count} of {total} output elements differ, max "
          f"{top:.3e}", flush=True)
    return count, total, top


def run():
    """Step 3 eagerly and as a replay from the same state: the name of the
    first module whose output differs while its input does not (or None)."""
    frames, s_tab, d_tab, state, hooks = _setup(4)
    scan = ScanStep(state, frames, torch.Generator(device=frames.device), _seed_of)
    scan(s_tab[:3], d_tab[:3])               # 2 eager warm-up steps, the capture, 1 replay
    tensors = ([t for n in state.nets.values() for t in n.state_dict().values()]
               + [v for opt in (state.g_opt, state.d_opt) for st in opt.state.values()
                  for v in st.values() if torch.is_tensor(v)])
    snap, step = [t.clone() for t in tensors], state.step
    scan.generator.manual_seed(_seed_of(step))
    out = train_step(state, (frames.index_select(0, s_tab[3]), frames.index_select(0, d_tab[3])),
                     generator=scan.generator, fused_aug=True)
    losses = torch.stack([v.float() for v in list(out["losses_g"].values())
                          + list(out["losses_d"].values())])
    eager = hooks.snapshot()
    torch._foreach_copy_(tensors, snap)
    state.step = step
    got = scan(s_tab[3:4], d_tab[3:4])
    replay = hooks.snapshot()
    g = torch.stack(list(got["losses_g"].values()) + list(got["losses_d"].values()), 1)[0]
    names = list(got["losses_g"]) + list(got["losses_d"])
    print(f"[scan_diff] float32 step 3: losses differ at "
          f"{[n for j, n in enumerate(names) if not torch.equal(g[j], losses[j])]}; "
          f"{len(eager)} buffers of {NET}", flush=True)
    n, first = 0, None
    for key, e in eager.items():
        count, top = _differs(replay[key], e)
        if count:
            n += 1
            if n <= SHOW:
                print(f"[scan_diff]   {key[0]} {key[1]} {tuple(e.shape)}: {count} of "
                      f"{e.numel()} elements differ, max {top:.3e}", flush=True)
            if first is None and key[1] == "out" and (key[0], "in") in eager and not \
                    _differs(replay[(key[0], "in")], eager[(key[0], "in")])[0]:
                first = key[0]
    print(f"[scan_diff]   {n} buffers differ; the first module whose output differs "
          f"while its input does not: {first}", flush=True)
    return first


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--alone", default=None, metavar="MODULE")
    a = p.parse_args(argv)
    if a.alone:
        run_alone(a.alone)
    else:
        run()


if __name__ == "__main__":
    main()
