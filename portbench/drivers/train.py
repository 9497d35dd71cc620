"""The training driver: the program's training step, one step after
another with no host sync between them, over a seeded uint8 frame cache
on the card, as `python -m facevae_tpu_torch.train --device_cache true
--steps_per_call 1` runs it without its logging.

Set-up builds one train state with the benchmark's weights and drives it
through the cell's first ``check_steps`` steps, through the window's own
call and feed (rows that all differ); the program's readings of those
steps are taken then.  The same state goes on into the window.  After the
window (and the profiled slice of a traced run) the program's state is
freed and the plain reference follows the same first steps
(train_reference.py); checks.py compares.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from portbench import checks, seeds, weights
from portbench import train_reference as tr
from portbench.reference import state as rs


def program_config(config: Dict):
    from facevae_tpu_torch.config import Config, LossConfig, ModelConfig
    return Config(model=ModelConfig(**config.get("model", {}),
                                    compute_dtype=config["compute_dtype"],
                                    remat=config["remat"]),
                  loss=LossConfig(**config.get("loss", {})))


def _adam_gradients(state, params):
    """The first step's gradient of each leaf as the optimizers hold it:
    exp_avg / (1 - beta1) after one step (zeros where a leaf has no state)."""
    out = []
    for p in params:
        st = state.g_opt.state.get(p) or state.d_opt.state.get(p)
        b1 = state.g_opt.defaults["betas"][0]
        out.append(st["exp_avg"] / (1 - b1) if st and "exp_avg" in st else torch.zeros_like(p))
    return out


def run(config: Dict, cell: Dict, seed: int, seconds: float, trace: bool, device,
        plant=None) -> Dict:
    """One run of a training cell; returns the cell driver's result (see run.py).
    ``plant`` (tests only) wraps the program's step function to break it."""
    from facevae_tpu_torch.train.state import build_all_modules, create_train_state
    from facevae_tpu_torch.train.step import train_step

    step_fn = plant(train_step) if plant else train_step
    traffic = cell["traffic"]
    batch = config["batch_per_chip"]
    cfg = program_config(config)
    is_cuda = torch.device(device).type == "cuda"

    nets = build_all_modules(cfg, device)
    initial = weights.make(rs.build_all_modules(tr.reference_config(config), "meta"), seed,
                           device)
    weights.load(nets, initial)
    state = create_train_state(cfg, device=device, nets=nets)
    data = tr.make_frames(traffic, cfg.model.image_size, seed, device)
    s_tab, d_tab = (torch.as_tensor(t, device=device)
                    for t in tr.pairs(traffic, seed, batch))
    g = torch.Generator(device=device)

    def step(k):
        g.manual_seed(seeds.step_seed(seed, k))
        return step_fn(state, (data.index_select(0, s_tab[k]), data.index_select(0, d_tab[k])),
                       generator=g, fused_aug=True)

    params, buffers = tr.param_leaves(nets), tr.buffer_leaves(nets)
    program = {"losses": []}
    for k in range(traffic["check_steps"]):
        out = step(k)
        program["losses"].append(tr.step_losses(out))
        if k == 0:
            program["grad"] = checks.leaf_norms(
                _adam_gradients(state, tr.leaf_tensors(nets, params, "param")))
            program["buffers"] = checks.change_norms(tr.leaf_tensors(nets, buffers, "buffer"),
                                                     [initial[n][b] for n, b in buffers])
    program["change"] = checks.change_norms(tr.leaf_tensors(nets, params, "param"),
                                            [initial[n][k] for n, k in params])
    del initial
    sync = torch.cuda.synchronize if is_cuda else (lambda: None)
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()

    # the window: all steps over all the time, no host sync inside
    bad = torch.zeros((), dtype=torch.int64, device=device)
    k = traffic["check_steps"]
    window_start = time.time()
    t0 = time.perf_counter()
    while True:
        out = step(k)
        bad += (~torch.isfinite(sum(out["losses_g"].values())
                                + sum(out["losses_d"].values()))).long()
        k += 1
        if time.perf_counter() - t0 >= seconds or k >= traffic["max_steps"]:
            break
    sync()
    window_s = time.perf_counter() - t0
    steps = k - traffic["check_steps"]
    window_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    slice_ = None
    if trace:
        # the slice, after the window: one step queued first, so the host
        # is ahead of the device as in the window, then n steps under the
        # light profiler, then one under the heavy one (trace.py)
        from portbench import trace as tracing
        n = traffic["trace_steps"]
        step(k)
        k += 1
        with tracing.light_profile(is_cuda) as light:
            for _ in range(n):
                step(k)
                k += 1
            sync()
        with tracing.heavy_profile(is_cuda) as heavy:
            step(k)
            k += 1
            sync()
        slice_ = tracing.Slice(light, heavy, n)
    result = {"window_start": window_start,
              "e2e": {"train_frames_per_s": steps * batch / window_s},
              "attempted": steps, "failed": int(bad.item()),
              "facts": {"window_units": steps, "window_s": window_s}}
    if is_cuda:
        result["e2e"]["train_peak_gib"] = window_peak / 2 ** 30
        result["memory_peak_bytes"] = max(setup_peak, window_peak)
    if slice_ is not None:
        result["slice"] = slice_


    del state, nets, data, out, step
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    reference = tr.run(config, traffic, seed, device, count_flops=trace)
    result["facts"]["flops_per_unit"] = reference.get("flops_per_step")
    result["numbers"] = checks.train_numbers(program, reference)
    result["readings"] = {"program": program, "reference": reference}
    return result
