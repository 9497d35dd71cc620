"""The plain reference's side of a serving cell's check: the frames of the
requests it judges, through the reference's encode_source and drive_frame
from the seed's weights, and the two numbers compared:

  frame_gap  the largest |program - reference| over the pixels of the
             engine's float frames of the kept drive batches
  byte_mismatch  the share of the bytes sampled clients received that no
             float within BYTE_SLACK of the reference frame rounds to, as
             the server rounds (clip to [0, 1], times 255, truncated).  A
             sound answer reads 0 whatever truncation boundary its float
             sits on; an answer further from the reference than
             BYTE_SLACK, or altered after the engine, reads above 0.

``precision`` "tf32" runs the reference at its control's precision.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import weights
from portbench.reference import config as rc
from portbench.reference.inference import InferencePipeline
from portbench.reference.models import G_MODEL_NAMES, build_models
from portbench.train_reference import set_precision


def reference_config(config: Dict) -> rc.Config:
    return rc.Config(model=rc.ModelConfig(**config.get("model", {}), compute_dtype="float32",
                                          remat=False),
                     loss=rc.LossConfig(**config.get("loss", {})))


def reference_nets(config: Dict, device):
    return build_models(reference_config(config).model, device=device, names=G_MODEL_NAMES)


# the float slack of byte_mismatch: the serving cells' frame_gap limit
BYTE_SLACK = 1e-6


def as_bytes(frame: np.ndarray) -> np.ndarray:
    """The server's rounding of a float frame to 8 bits."""
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


@torch.no_grad()
def frames_for(config: Dict, seed: int, device, sources, driving, pairs, batch: int = 8,
               precision: str = "fp32", count_flops: bool = False):
    """{(session, frame): float frame [H,W,3]} for ``pairs``; with
    ``count_flops`` also the operations of one drive batch, per frame."""
    set_precision(precision)
    nets = reference_nets(config, device)
    weights.load(nets, weights.make(nets, seed, device))
    pipe = InferencePipeline(reference_config(config), nets)

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32) / 255.0).to(device)

    by_session = defaultdict(list)
    for s, f in sorted(set(pairs)):
        by_session[s].append(f)
    out, flops = {}, None
    for s, fs in by_session.items():
        enc = pipe.encode_source(to(sources[s][None]))
        for i in range(0, len(fs), batch):
            chunk = fs[i:i + batch]
            imgs = to(driving[s][chunk])
            tiled = [e.expand(len(chunk), *e.shape[1:]).contiguous() for e in enc]
            if count_flops and flops is None:
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False) as counter:
                    res = pipe.drive_frame(*tiled, imgs)
                flops = float(counter.get_total_flops()) / len(chunk)
            else:
                res = pipe.drive_frame(*tiled, imgs)
            for f, frame in zip(chunk, res.float().cpu().numpy()):
                out[(s, f)] = frame
    del pipe, nets
    set_precision("fp32")
    return out, flops


def numbers(kept_rows, answers, ref: Dict) -> Dict[str, float]:
    frame_gap = max((float(np.abs(frame - ref[key]).max()) for key, frame in kept_rows),
                    default=float("inf"))
    total = sum(b.size for _, b in answers)
    differ = 0
    for key, b in answers:
        lo, hi = as_bytes(ref[key] - BYTE_SLACK), as_bytes(ref[key] + BYTE_SLACK)
        differ += int(np.count_nonzero((b < lo) | (b > hi)))
    return {"frame_gap": frame_gap,
            "byte_mismatch": differ / total if total else float("inf")}


def judge(config: Dict, seed: int, device, sources, driving,
          kept_rows: List[Tuple], answers: List[Tuple], count_flops: bool = False):
    """(numbers, {"frames": reference frames, "flops_per_frame": ...})."""
    pairs = [k for k, _ in kept_rows] + [k for k, _ in answers]
    ref, flops = frames_for(config, seed, device, sources, driving, pairs,
                            count_flops=count_flops)
    return numbers(kept_rows, answers, ref), {"frames": ref, "flops_per_frame": flops}
