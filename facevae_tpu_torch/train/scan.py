"""Multi-step dispatch (port of facevae_tpu/train/scan.py): K training steps
per call over the device frame cache, the host out of the step.

The JAX module runs K steps in one XLA program (lax.scan).  Here, on the
card, one step's body is captured once as a CUDA graph and the graph is
replayed K times per call:

    gather (s, d) from the cache by two static index buffers
    uint8 -> float, the fused augmentation, the G phase, the D phase
    (both Adam updates; with a process group, the all-reduces of the
    gradients, of BatchNorm's statistics and of the losses)
    the step's loss scalars into one static vector

Between two replays the host copies that step's indices into the index
buffers (on the card, from the call's [K, B] tables), reseeds the loop's
generator for the step (train/step.py:step_seed; the generator is
registered with the graph, so a replay draws what the eager step draws
after the same reseed), and copies the step's loss vector aside; the K
copies are stacked into one [K] table per loss, which the host fetches
once per call.  The aux is the last step's.

One step's graph, not a K-step graph: the per-step reseed keeps the draws
of every step equal to the eager loop's, the epoch's remainder chunk
replays the same graph, and the graph's private memory pool holds one
step.

The first call runs its first WARMUP steps eagerly on a side stream (real
steps of the stream: the kernels' nvcc builds, cuDNN's and cuBLAS's first
calls, Adam's state and the communicator are set up by then), then
captures.  A capture or a replay that fails raises; nothing falls back to
eager steps on the card.  On the CPU (where CUDA graphs do not exist)
every step runs eagerly, the same function.

A remat step (ModelConfig.remat) captures as a plain one does: its
recomputes run inside the captured backward, and the warps' kept outputs
live in the graph's pool.

Python state is kept by the host: state.step advances once per step run,
and the warp kernels' launch counts (ops/fast_warp.launches) count each
replay's captured launches.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.train.state import TrainState
from facevae_tpu_torch.train.step import train_step

WARMUP = 2            # eager steps before the capture


class ScanStep:
    """``scan(s_idx, d_idx)`` runs len(s_idx) steps of ``state`` on the
    frames of ``frames`` ([T, H, W, 3] uint8, this rank's) at the rows of
    s_idx / d_idx ([K, B] int, this rank's columns), reseeding
    ``generator`` with seed_of(state.step) before each step.  Returns
    {"losses_g": {name: [K]}, "losses_d": {name: [K]}, "aux": the last
    step's aux}, tensors on the state's device; the aux and the losses are
    the graph's own on the card (overwritten by the next call).  After a
    call, as after train_step, every trainable parameter's .grad holds the
    gradient the last step applied (on the card: the graph's own tensor)."""

    def __init__(self, state: TrainState, frames: torch.Tensor, generator: torch.Generator,
                 seed_of: Callable[[int], int]):
        self.state, self.frames, self.generator, self.seed_of = state, frames, generator, seed_of
        self.device = frames.device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.names = None                 # (G loss names, D loss names)
        self.captured_launches: Dict[str, int] = {}
        self.stats: Dict[str, float] = {}
        self.eager_steps = self.replays = 0
        cuda = self.device.type == "cuda"
        group = state.group
        if cuda and group is not None and dist.get_backend(group) != "nccl":
            raise ValueError(f"a CUDA graph captures NCCL collectives only; the group's backend "
                             f"is {dist.get_backend(group)}")

    def _step(self, s_idx: torch.Tensor, d_idx: torch.Tensor):
        """One step's body on index tensors [B] on the device: (the loss
        vector, the G / D loss names, the aux)."""
        s = self.frames.index_select(0, s_idx)
        d = self.frames.index_select(0, d_idx)
        out = train_step(self.state, (s, d), generator=self.generator, fused_aug=True)
        g, dd = out["losses_g"], out["losses_d"]
        vec = torch.stack([v.float() for v in list(g.values()) + list(dd.values())])
        return vec, (tuple(g), tuple(dd)), out["aux"]

    def _capture(self, s_buf, d_buf):
        """Capture one step on the index buffers (the state, the generator
        and the launch counts as they were before it)."""
        before = dict(fast_warp.launches)
        step = self.state.step
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()                       # the eager pool's cached blocks
        reserved = torch.cuda.memory_reserved(self.device)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            self.vec, self.names, self.aux = self._step(s_buf, d_buf)
        torch.cuda.synchronize(self.device)
        self.stats["capture_s"] = time.perf_counter() - t0
        self.stats["graph_pool_bytes"] = torch.cuda.memory_reserved(self.device) - reserved
        self.state.step = step                         # the capture ran no step
        self.captured_launches = {k: v - before[k] for k, v in fast_warp.launches.items()}
        fast_warp.launches.update(before)
        self.bufs = (s_buf, d_buf)
        # the gradient tensors the graph writes and its Adam steps read
        self.grads = [(p, p.grad) for opt in (self.state.g_opt, self.state.d_opt)
                      for group in opt.param_groups for p in group["params"]
                      if p.grad is not None]

    def _replay(self, s_idx, d_idx) -> torch.Tensor:
        s_buf, d_buf = self.bufs
        s_buf.copy_(s_idx, non_blocking=True)
        d_buf.copy_(d_idx, non_blocking=True)
        self.generator.manual_seed(self.seed_of(self.state.step))
        self.graph.replay()
        self.state.step += 1
        for name, n in self.captured_launches.items():
            fast_warp.launches[name] += n
        self.replays += 1
        return self.vec.clone()

    def __call__(self, s_idx, d_idx) -> Dict[str, object]:
        s_idx, d_idx = _on(self.device, s_idx), _on(self.device, d_idx)
        K = s_idx.shape[0]
        cuda = self.device.type == "cuda"
        n_eager = max(0, min(K, WARMUP - self.eager_steps)) if cuda else K
        vecs, aux = [], None
        if n_eager:
            # the CPU's steps, or the first call's warm-up on a side stream
            side = torch.cuda.Stream(self.device) if cuda else None
            if cuda:
                side.wait_stream(torch.cuda.current_stream(self.device))
                torch.cuda.reset_peak_memory_stats(self.device)
            with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                for k in range(n_eager):
                    self.generator.manual_seed(self.seed_of(self.state.step))
                    vec, self.names, aux = self._step(s_idx[k], d_idx[k])
                    vecs.append(vec)
                    self.eager_steps += 1
            if cuda:
                torch.cuda.current_stream(self.device).wait_stream(side)
                self.stats["eager_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        if n_eager < K:
            if self.graph is None:
                self._capture(torch.empty_like(s_idx[0]), torch.empty_like(d_idx[0]))
            vecs += [self._replay(s_idx[k], d_idx[k]) for k in range(n_eager, K)]
            aux = self.aux
            for p, g in self.grads:
                p.grad = g
        g_names, d_names = self.names
        rows = torch.stack(vecs).unbind(1)
        return {"losses_g": dict(zip(g_names, rows[:len(g_names)])),
                "losses_d": dict(zip(d_names, rows[len(g_names):])), "aux": aux}


def _on(device, idx) -> torch.Tensor:
    """An index table as int64 on ``device``, copied without a sync
    (through pinned memory) when it comes from the host."""
    t = torch.as_tensor(np.asarray(idx, np.int64)) if not torch.is_tensor(idx) else idx.long()
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
