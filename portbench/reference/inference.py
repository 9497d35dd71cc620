"""The serving graphs of the reference (a copy of the program's
train/inference.py: encode_source and drive_frame), fp32 in eval mode.
Copied docstring follows.  Batched inference graphs (port of facevae_tpu/train/inference.py):
encode_source, drive_frame, drive_batch and frontalize_frame (serving), and
sample_expression and interpolate_expression (the evaluation CLI's ``s``
and ``i`` modes), each the JAX graph's sequence of nets.

Images are [N,H,W,3] float32 in [0,1] on the models' device, in and out.
Every graph runs under torch.inference_mode() with the modules in eval mode.
Like the JAX pipeline it runs in fp32 whatever ``compute_dtype`` says: the
JAX InferencePipeline never casts to it (ROADMAP Queue 3).  Constructing a
pipeline sets the port's numerics (TF32 off, facevae_tpu_torch/numerics.py):
cuDNN's default TF32 convolutions miss the fp32 parity tolerance.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from portbench.reference.config import Config
from portbench.reference.ops.geometry import transform_kp, transform_kp_with_new_pose


class InferencePipeline:
    def __init__(self, cfg: Config, models: Dict[str, nn.Module], use_efe: bool = True):
        self.cfg = cfg
        self.models = {name: m.eval() for name, m in models.items()}
        self.use_efe = use_efe

    def _pose(self, img, kp_c):
        """HPE_EDE on img, keypoints posed (and refined by EFE): (kp_old, kp, R)."""
        yaw, pitch, roll, t, scale = self.models["hpe_ede"](img)
        kp_old, R = transform_kp(kp_c, yaw, pitch, roll, t, scale)
        kp = self.models["efe"](img, None, kp_old)[0] if self.use_efe else kp_old
        return kp_old, kp, R

    @torch.inference_mode()
    def encode_source(self, s):
        """source image -> (fs, kp_c, kp_s, Rs)"""
        fs = self.models["afe"](s)
        kp_c = self.models["ckd"](s)
        _, kp_s, Rs = self._pose(s, kp_c)
        return fs, kp_c, kp_s, Rs

    @torch.inference_mode()
    def drive_frame(self, fs, kp_c, kp_s, Rs, img):
        """(fs, kp_c, kp_s, Rs, driving frame) -> generated image"""
        _, kp_d, Rd = self._pose(img, kp_c)
        deformation, occlusion, _ = self.models["mfe"](fs, kp_s, kp_d, Rs, Rd)
        return self.models["generator"](fs, deformation, occlusion)
