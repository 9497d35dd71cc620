"""Convert a reference torch checkpoint (%08d-checkpoint.pth.tar, written by
the reference Logger.save_cpk: logger.py:93-102) into an epoch file of the
port (counterpart of tools/convert_reference_checkpoint.py), so trained
reference weights run through the port's evaluate, serve and train.

  python -m facevae_tpu_torch.convert_reference_checkpoint \\
      --torch_ckp 00000044-checkpoint.pth.tar --out_dir ckp --epoch 44 \\
      [--image_size 256] [--device cuda]

Each of the seven nets is ported from ``ckp[name]`` by the structural
order-zip of facevae_tpu_torch/utils_port.py into a train state built on
``--device`` (BatchNorm buffers and spectral norm's u, v included); the file
is written by train/checkpoint.save_checkpoint, in the JAX package's format.
The optimizer state is not converted (torch Adam moments of another
parameter basis): resuming from a converted file restarts Adam's moments.
The contrastive head and the teachers keep their seeded weights, as in the
JAX tool; the teachers come from --pretrained_dir at training time
(facevae_tpu_torch/convert_torch_weights.py writes those files).
"""
from __future__ import annotations

import argparse

import torch

from facevae_tpu_torch.config import Config, ModelConfig
from facevae_tpu_torch.train import create_train_state, save_checkpoint
from facevae_tpu_torch.utils_port import port_reference_state_dict

# the JAX tool's order of the nets in the reference checkpoint
MODELS = ("efe", "afe", "ckd", "hpe_ede", "mfe", "generator", "discriminator")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--torch_ckp", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the train state is built (cuda, or cpu)")
    return p.parse_args(argv)


def build_config(args) -> Config:
    return Config(model=ModelConfig(image_size=args.image_size))


def main(argv=None) -> str:
    args = parse_args(argv)
    ckp = torch.load(args.torch_ckp, map_location="cpu")
    state = create_train_state(build_config(args), args.device)
    for name in MODELS:
        sd = {k: v.numpy() for k, v in ckp[name].items()}
        net = state.nets[name]
        net.load_state_dict(port_reference_state_dict(sd, net))
        print(f"ported {name}: {len(sd)} torch arrays")
    state.epoch = args.epoch
    path = save_checkpoint(args.out_dir, state, args.epoch)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
