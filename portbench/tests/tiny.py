"""Tiny cells for the harness's CPU tests: the port's tiny_config sizes,
the real cells' traffic kinds and limits."""
from __future__ import annotations

import dataclasses

from portbench import run as runmod


def tiny_config() -> dict:
    from portbench.reference.config import tiny_config as tc
    model = dataclasses.asdict(tc().model)
    for k in ("compute_dtype", "remat"):
        model.pop(k)
    model = {k: list(v) if isinstance(v, tuple) else v for k, v in model.items()}
    return {"name": "tiny", "model": model, "loss": {"n_scales": 1}, "compute_dtype": "float32",
            "tf32": False, "remat": True, "batch_per_chip": 2, "conv_peak": "float32",
            "lower_precision": "tf32"}


def tiny_train_cell() -> dict:
    cell, _ = runmod.cell_files("train-fp32")
    return dict(cell, traffic={"identities": 2, "clips_per_identity": 1, "frames_per_clip": 4,
                               "grain": 8, "check_steps": 3, "trace_steps": 1, "max_steps": 8})


def tiny_serve_cell() -> dict:
    cell, _ = runmod.cell_files("serve-fp32-c16")
    return dict(cell, traffic={"sessions": 2, "clients": 4, "frames_per_session": 4, "grain": 8,
                               "max_batch": 2, "window_ms": 10.0, "keep_from": 4,
                               "keep_batches": 2, "sample_answers": 3, "trace_timeout_s": 120,
                               "trace_batches": 2})
