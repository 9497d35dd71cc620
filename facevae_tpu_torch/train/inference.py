"""Batched inference graphs (port of facevae_tpu/train/inference.py):
encode_source, drive_frame, drive_batch and frontalize_frame (serving), and
sample_expression and interpolate_expression (the evaluation CLI's ``s``
and ``i`` modes), each the JAX graph's sequence of nets.

Images are [N,H,W,3] float32 in [0,1] on the models' device, in and out.
Every graph runs under torch.inference_mode() with the modules in eval mode.
Like the JAX pipeline it runs in fp32 whatever ``compute_dtype`` says: the
JAX InferencePipeline never casts to it (ROADMAP Queue 3).  Constructing a
pipeline sets the port's numerics (TF32 off, facevae_tpu_torch/numerics.py):
cuDNN's default TF32 convolutions miss the fp32 parity tolerance.
Each net's call is a ``net.<name>`` span (facevae_tpu_torch/tracing.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from facevae_tpu_torch.config import Config
from facevae_tpu_torch import numerics, tracing
from facevae_tpu_torch.ops.geometry import transform_kp, transform_kp_with_new_pose


class InferencePipeline:
    def __init__(self, cfg: Config, models: Dict[str, nn.Module], use_efe: bool = True):
        numerics.apply()
        self.cfg = cfg
        self.models = {name: m.eval() for name, m in models.items()}
        self.use_efe = use_efe

    def _net(self, name, *args, **kwargs):
        """models[name](*args, **kwargs) in a ``net.<name>`` span."""
        with tracing.span("net." + name):
            return self.models[name](*args, **kwargs)

    def _pose(self, img, kp_c):
        """HPE_EDE on img, keypoints posed (and refined by EFE): (kp_old, kp, R)."""
        yaw, pitch, roll, t, scale = self._net("hpe_ede", img)
        kp_old, R = transform_kp(kp_c, yaw, pitch, roll, t, scale)
        kp = self._net("efe", img, None, kp_old)[0] if self.use_efe else kp_old
        return kp_old, kp, R

    @torch.inference_mode()
    def encode_source(self, s):
        """source image -> (fs, kp_c, kp_s, Rs)"""
        fs = self._net("afe", s)
        kp_c = self._net("ckd", s)
        _, kp_s, Rs = self._pose(s, kp_c)
        return fs, kp_c, kp_s, Rs

    @torch.inference_mode()
    def drive_frame(self, fs, kp_c, kp_s, Rs, img):
        """(fs, kp_c, kp_s, Rs, driving frame) -> generated image"""
        _, kp_d, Rd = self._pose(img, kp_c)
        deformation, occlusion, _ = self._net("mfe", fs, kp_s, kp_d, Rs, Rd)
        return self._net("generator", fs, deformation, occlusion)

    @torch.inference_mode()
    def drive_batch(self, fs, kp_c, kp_s, Rs, imgs):
        """(fs, kp_c, kp_s, Rs from ONE source; [B] driving frames) -> [B]
        generated images; the source encodings are broadcast over the batch."""
        b = imgs.shape[0]

        def tile(x):
            return x.expand(b, *x.shape[1:]).contiguous()

        return self.drive_frame(tile(fs), tile(kp_c), tile(kp_s), tile(Rs), imgs)

    @torch.inference_mode()
    def frontalize_frame(self, img):
        """frame -> frontalized frame (zero yaw/pitch/roll)."""
        fs = self._net("afe", img)
        kp_c = self._net("ckd", img)
        yaw, pitch, roll, t, scale = self._net("hpe_ede", img)
        kp_s_old, Rs = transform_kp(kp_c, yaw, pitch, roll, t, scale)
        if self.use_efe:
            kp_s = self._net("efe", img, None, kp_s_old)[0]
            delta = kp_s - kp_s_old
        else:
            kp_s = kp_s_old
            delta = torch.zeros_like(kp_s)
        zero = torch.zeros_like(yaw)
        # scale is [N,1,1,1]; reduce to [N,1,1] so kp keeps rank [N,K,3]
        kp_d, Rd = transform_kp_with_new_pose(kp_c * scale.reshape(-1, 1, 1),
                                              yaw, pitch, roll, t, delta,
                                              zero, zero, zero)
        deformation, occlusion, _ = self._net("mfe", fs, kp_s, kp_d, Rs, Rd)
        return self._net("generator", fs, deformation, occlusion)

    @torch.inference_mode()
    def sample_expression(self, img, temperature=1.0, eps: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
        """(frame, temperature) -> the frame with a resampled EFE latent.
        EFE runs twice, deterministic (kp_s) and sampling its VAE (z = mu +
        exp(logstd) * eps; eps given [N, h*w*Cz], or drawn from
        ``generator``), kp_d = kp_s + temperature * (kp_d - kp_s), and MFE
        warps with the frame's own rotation on both sides."""
        fs = self._net("afe", img)
        kp_c = self._net("ckd", img)
        yaw, pitch, roll, t, scale = self._net("hpe_ede", img)
        kp_old, Rs = transform_kp(kp_c, yaw, pitch, roll, t, scale)
        kp_s = self._net("efe", img, None, kp_old)[0]
        kp_d = self._net("efe", img, None, kp_old, train_vae=True, eps=eps,
                         generator=generator)[0]
        kp_d = kp_s + temperature * (kp_d - kp_s)
        deformation, occlusion, _ = self._net("mfe", fs, kp_s, kp_d, Rs, Rs)
        return self._net("generator", fs, deformation, occlusion)

    @torch.inference_mode()
    def interpolate_expression(self, s, d, alpha):
        """(source frame, target frame, alpha) -> the source with keypoints
        (1 - alpha) * kp_s + alpha * kp_d: one HPE_EDE call on the batch
        [s; d], EFE on each, MFE from Rs to Rd."""
        fs = self._net("afe", s)
        kp_c = self._net("ckd", s)
        yaw, pitch, roll, t, scale = self._net("hpe_ede", torch.cat([s, d]))
        n = s.shape[0]
        kp_s_old, Rs = transform_kp(kp_c, yaw[:n], pitch[:n], roll[:n], t[:n], scale[:n])
        kp_d_old, Rd = transform_kp(kp_c, yaw[n:], pitch[n:], roll[n:], t[n:], scale[n:])
        kp_s = self._net("efe", s, None, kp_s_old)[0]
        kp_d = self._net("efe", d, None, kp_d_old)[0]
        kp_mix = (1 - alpha) * kp_s + alpha * kp_d
        deformation, occlusion, _ = self._net("mfe", fs, kp_s, kp_mix, Rs, Rd)
        return self._net("generator", fs, deformation, occlusion)
