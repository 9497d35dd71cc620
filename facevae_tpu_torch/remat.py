"""Rematerialization: the port's form of the JAX step's
jax.checkpoint(policy=save_only_these_names("warp_out")) at each net's call
(facevae_tpu/train/objective.py VarBank.apply(remat=True)).

``checkpoint(fn, *args, **kwargs)`` runs fn(*args, **kwargs) under
torch.utils.checkpoint (non-reentrant): the activations fn saves for its
backward are dropped and fn runs again in the backward pass to make them.
A second run must compute what the first computed, and must not advance
any state, so a region carries a tape:

* ``once(compute)`` calls compute() in the region's forward and keeps what
  it returns; in the region's recompute it returns the kept value and does
  not call compute.  The layers put through it what they must not redo: a
  spectral-norm Conv's power iteration (which updates weight_u / weight_v
  and returns the u, v its sigma uses), BatchNorm's update of its running
  statistics (returning the batch statistics), the warps' forward (the
  JAX package's "warp_out" outputs: kept, never recomputed, so a remat step
  launches the forward warp kernels as often as a plain step) and the
  VAE's eps draw from an explicit torch.Generator (which checkpoint's RNG
  stash does not cover).
* ``pin(x, kept)`` is x outside a recompute; in a recompute it has the
  kept value and x's gradient (BatchNorm's batch statistics: the forward's
  exact values, the recomputed graph).

The recompute runs the same Python code on the same inputs, so the layers
call ``once`` in the same order both times.  BatchNorm's differentiable
all-reduce runs again in the recompute, on every rank alike.  Outside a
region ``once`` is compute() and ``pin`` is x: a step without remat runs
exactly as before.  The tape lives in a thread-local: the autograd engine
runs a recompute on its own thread and enters the region's context there.
"""
from __future__ import annotations

import threading

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

_local = threading.local()


class _Tape:
    """The values ``once`` kept in one region's forward, in call order, and
    the name of the region's function."""

    def __init__(self, name: str):
        self.name = name
        self.values = []
        self.pos = -1                 # -1: recording (the forward)


class _Region:
    """Makes ``tape`` the current one: recording, or replaying from its
    start."""

    def __init__(self, tape: _Tape, replay: bool):
        self.tape, self.replay = tape, replay

    def __enter__(self):
        self.outer = getattr(_local, "tape", None)
        if self.replay:
            self.tape.pos = 0
        _local.tape = self.tape
        return self

    def __exit__(self, *exc):
        _local.tape = self.outer
        return False


def _detached(value):
    if isinstance(value, torch.Tensor):
        return value.detach()
    if isinstance(value, tuple):
        return tuple(_detached(v) for v in value)
    return value


def once(compute):
    """compute() outside a remat region and in a region's forward (which
    keeps the result, detached); the kept result in its recompute."""
    tape = getattr(_local, "tape", None)
    if tape is None:
        return compute()
    if tape.pos < 0:
        value = compute()
        tape.values.append(_detached(value))
        return value
    value = tape.values[tape.pos]
    tape.pos += 1
    return value


def replaying() -> bool:
    """True inside a region's recompute."""
    tape = getattr(_local, "tape", None)
    return tape is not None and tape.pos >= 0


def pin(x: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """x, or in a recompute the forward's value ``kept`` with x's gradient."""
    if not replaying():
        return x
    return kept + (x - x.detach())


def checkpoint(fn, *args, **kwargs):
    """fn(*args, **kwargs) with its activations recomputed in the backward
    pass (no RNG stash: nothing in a net draws from the global generator)."""
    tape = _Tape(getattr(fn, "__name__", type(fn).__name__))
    return _checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                       context_fn=lambda: (_Region(tape, False), _Region(tape, True)),
                       **kwargs)


def call(enabled: bool, fn, *args, **kwargs):
    """checkpoint(fn, ...) when ``enabled``, else fn(...)."""
    if enabled:
        return checkpoint(fn, *args, **kwargs)
    return fn(*args, **kwargs)
