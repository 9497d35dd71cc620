"""Configuration tree of the port: the same dataclasses, fields and defaults
as facevae_tpu/config.py, kept here so the port imports nothing of the JAX
package.  tests/test_torch_ops.py::test_config_copy_matches_the_jax_package
holds the two copies equal.

ModelConfig() is the reference's full 256x256 model (K=15 keypoints, D=16
depth planes, C=32 appearance channels); tiny_config() the small one the
tests use.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Shared model hyperparameters (reference: K=15, D=16, C=32 throughout)."""

    image_size: int = 256
    num_kp: int = 15                 # K keypoints
    depth: int = 16                  # D depth planes of 3D feature volumes
    app_channels: int = 32           # C appearance channels

    afe_down_seq: Sequence[int] = (64, 128, 256)
    afe_n_res: int = 6

    ckd_down_seq: Sequence[int] = (3, 64, 128, 256, 512, 1024)
    ckd_up_seq: Sequence[int] = (1024, 512, 256, 128, 64, 32)
    ckd_scale_factor: float = 0.25

    hpe_filters: Sequence[int] = (64, 256, 512, 1024, 2048)
    hpe_blocks: Sequence[int] = (3, 3, 5, 2)
    n_bins: int = 66

    efe_variant: str = "conv5"
    efe_down_seq: Sequence[int] = (3, 32, 64, 128, 256, 32)
    efe_up_seq: Sequence[int] = (256, 256, 128, 64, 32, 32)
    efe_n_res: int = 3
    efe_scale_factor: float = 0.25
    efe_use_vae: bool = True

    mfe_down_seq: Sequence[int] = (80, 64, 128, 256, 512, 1024)
    mfe_up_seq: Sequence[int] = (1024, 512, 256, 128, 64, 32)
    mfe_compress: int = 4            # C2: fs compressed channels

    gen_up_seq: Sequence[int] = (256, 128, 64)
    gen_n_res: int = 6
    gen_use_weight_norm: bool = True

    disc_down_seq: Sequence[int] = (64, 128, 256, 512)
    disc_use_weight_norm: bool = True

    use_weight_norm: bool = False    # spectral norm on the non-GAN nets

    # compute dtype of the conv stacks; params and BN statistics stay fp32.
    # The port's step runs "float32" and "bfloat16" (train/objective.py).
    compute_dtype: str = "float32"
    # rematerialization of the big nets in the training step (the port's
    # train/objective.py and remat.py)
    remat: bool = True

    @property
    def kp_spatial(self) -> Tuple[int, int, int]:
        """(D, H/4, W/4) heatmap/feature-volume spatial size."""
        return (self.depth, self.image_size // 4, self.image_size // 4)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference trainer.py:240-252)."""

    perceptual: float = 10.0         # P
    gan: float = 1.0                 # G
    feature_matching: float = 10.0   # F
    equivariance: float = 20.0       # E
    keypoint_prior: float = 10.0     # L
    headpose: float = 20.0           # H
    deformation_prior: float = 0.5   # D
    contrastive: float = 10.0        # C
    kl: float = 0.0                  # K (the reference runs the VAE deterministic, q8)
    recon: float = 0.0               # R

    kp_prior_dt: float = 0.1
    kp_prior_zt: float = 0.33
    # quirk q3: extra pyramid scales apply only relu_5_1 unless fixed
    fixed_pyramid: bool = False
    n_scales: int = 3
    # quirk q7: the SimSiam head is trainable but never stepped
    train_contrastive_head: bool = False
    pretrained_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8              # per device
    lr: float = 5e-5
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    num_epochs: int = 150
    num_repeats: int = 100
    train_vae: bool = False          # quirk q8
    ckp_dir: str = "ckp"
    vis_dir: str = "vis"
    log_file: str = "log.txt"
    checkpoint_freq: int = 1
    keep_checkpoints: int = 5
    seed: int = 1
    vis_every: int = 50
    sigma_affine: float = 0.05       # Transform / equivariance TPS
    sigma_tps: float = 0.005
    points_tps: int = 5
    steps_per_call: int = 1
    debug_nans: bool = False
    profile_dir: str = ""
    tensorboard: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    root_dir: str = ""
    frame_shape: Tuple[int, int, int] = (256, 256, 3)
    id_sampling: bool = True
    rotation_degrees: float = 30.0
    pers_num: int = 30
    enlarge_num: int = 40
    jitter: float = 0.1
    use_flip: bool = False
    num_workers: int = 8
    on_device_aug: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


def tiny_config(image_size: int = 64, num_kp: int = 5, depth: int = 4,
                app_channels: int = 8, compute_dtype: str = "float32") -> Config:
    """A small config for CPU tests: 64x64 images, D=4, K=5, narrow stacks."""
    model = ModelConfig(
        image_size=image_size,
        num_kp=num_kp,
        depth=depth,
        app_channels=app_channels,
        afe_down_seq=(16, 24, 32),
        afe_n_res=2,
        ckd_down_seq=(3, 16, 32, 64),
        ckd_up_seq=(64, 32, 16, 8),
        hpe_filters=(16, 32, 48, 64, 96),
        hpe_blocks=(1, 1, 1, 1),
        efe_down_seq=(3, 8, 16, 24, 32, 32),
        efe_up_seq=(32, 32, 24, 16, 8, 8),
        efe_n_res=1,
        mfe_down_seq=((num_kp + 1) * 5, 16, 32, 64),
        mfe_up_seq=(64, 32, 16, 8),
        gen_up_seq=(32, 16, 8),
        gen_n_res=2,
        compute_dtype=compute_dtype,
    )
    # 64px images carry one pyramid scale (VGG's deepest tap needs >= 16px)
    loss = LossConfig(n_scales=1)
    return Config(model=model, loss=loss)
