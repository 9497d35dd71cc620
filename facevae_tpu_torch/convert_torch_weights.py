"""Convert the pretrained teachers' torch weights into the .npz files that
LossConfig.pretrained_dir reads (counterpart of tools/convert_torch_weights.py,
whose files these are, key for key and array for array).

The reference downloads the teachers at construction time (losses.py:55-56,
80-81; trainer.py:228): VGG19 (torchvision), VGG-Face-16 (Oxford
vgg_face_dag) and a Hopenet pickle.  With no network this is an offline
step over files the user supplies:

  python -m facevae_tpu_torch.convert_torch_weights --vgg19 vgg19-dcbb9e9d.pth \\
      --vggface vgg_face_dag.pth --hopenet hopenet_robust_alpha1.pkl --out artifacts/

The files are flat npz keyed by flax paths ('/'-joined) in flax's layouts
(conv HWIO, linear (in, out)), as the JAX package writes them, so either
package reads what the other wrote; facevae_tpu_torch/losses/pretrained.py
maps them onto the port's teachers (convert.state_dict_from_jax).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from facevae_tpu_torch.convert import _jax_kernel
from facevae_tpu_torch.losses.vgg import VGG16_BLOCKS, VGG19_BLOCKS


def convert_vgg(state_dict, blocks, out_path, key_for):
    """Generic VGG conv-stack converter.

    blocks: e.g. ((64,64),(128,128),...); key_for(bi,ci) -> torch key prefix.
    Our layer names: conv{bi+1}_{ci+1}/{kernel,bias}.
    """
    flat = {}
    for bi, widths in enumerate(blocks):
        for ci in range(len(widths)):
            prefix = key_for(bi, ci)
            if prefix is None:
                continue
            flat[f"conv{bi + 1}_{ci + 1}/kernel"] = _jax_kernel(
                np.asarray(state_dict[prefix + ".weight"]))
            flat[f"conv{bi + 1}_{ci + 1}/bias"] = np.asarray(state_dict[prefix + ".bias"])
    np.savez(out_path, **flat)
    print(f"wrote {out_path} ({len(flat)} arrays)")


# torchvision .features conv indices per (block, conv)
VGG19_IDX = {(0, 0): 0, (0, 1): 2, (1, 0): 5, (1, 1): 7,
             (2, 0): 10, (2, 1): 12, (2, 2): 14, (2, 3): 16,
             (3, 0): 19, (3, 1): 21, (3, 2): 23, (3, 3): 25,
             (4, 0): 28}
# vgg_face_dag ships layer-named keys directly (losses.py:83-97 remap source)
VGGFACE_NAMES = {(0, 0): "conv1_1", (0, 1): "conv1_2",
                 (1, 0): "conv2_1", (1, 1): "conv2_2",
                 (2, 0): "conv3_1", (2, 1): "conv3_2", (2, 2): "conv3_3",
                 (3, 0): "conv4_1", (3, 1): "conv4_2", (3, 2): "conv4_3",
                 (4, 0): "conv5_1"}


def convert_hopenet(state_dict, out_path):
    """torchvision-style ResNet50 Hopenet -> our Hopenet param/batch_stats paths."""
    flat = {}

    def bn(dst, src):
        flat[f"params/{dst}/scale"] = np.asarray(state_dict[src + ".weight"])
        flat[f"params/{dst}/bias"] = np.asarray(state_dict[src + ".bias"])
        flat[f"batch_stats/{dst}/mean"] = np.asarray(state_dict[src + ".running_mean"])
        flat[f"batch_stats/{dst}/var"] = np.asarray(state_dict[src + ".running_var"])

    flat["params/conv1/kernel"] = _jax_kernel(np.asarray(state_dict["conv1.weight"]))
    bn("bn1", "bn1")
    layers = (3, 4, 6, 3)
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            dst = f"layer{li + 1}_{bi}"
            src = f"layer{li + 1}.{bi}"
            for c in ("conv1", "conv2", "conv3"):
                flat[f"params/{dst}/{c}/kernel"] = _jax_kernel(
                    np.asarray(state_dict[f"{src}.{c}.weight"]))
            for b in ("bn1", "bn2", "bn3"):
                bn(f"{dst}/{b}", f"{src}.{b}")
            if f"{src}.downsample.0.weight" in state_dict:
                flat[f"params/{dst}/downsample_conv/kernel"] = _jax_kernel(
                    np.asarray(state_dict[f"{src}.downsample.0.weight"]))
                bn(f"{dst}/downsample_bn", f"{src}.downsample.1")
    for head in ("fc_yaw", "fc_pitch", "fc_roll"):
        flat[f"params/{head}/kernel"] = _jax_kernel(np.asarray(state_dict[f"{head}.weight"]))
        flat[f"params/{head}/bias"] = np.asarray(state_dict[f"{head}.bias"])
    np.savez(out_path, **flat)
    print(f"wrote {out_path} ({len(flat)} arrays)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--vgg19", type=str, default=None)
    p.add_argument("--vggface", type=str, default=None)
    p.add_argument("--hopenet", type=str, default=None)
    p.add_argument("--out", type=str, default="artifacts")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.vgg19:
        sd = torch.load(args.vgg19, map_location="cpu")
        convert_vgg({k: v.numpy() for k, v in sd.items()}, VGG19_BLOCKS,
                    os.path.join(args.out, "vgg19.npz"),
                    lambda bi, ci: f"features.{VGG19_IDX[(bi, ci)]}"
                    if (bi, ci) in VGG19_IDX else None)
    if args.vggface:
        sd = torch.load(args.vggface, map_location="cpu")
        convert_vgg({k: v.numpy() for k, v in sd.items()}, VGG16_BLOCKS,
                    os.path.join(args.out, "vggface.npz"),
                    lambda bi, ci: VGGFACE_NAMES.get((bi, ci)))
    if args.hopenet:
        sd = torch.load(args.hopenet, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        convert_hopenet({k: v.numpy() for k, v in sd.items()},
                        os.path.join(args.out, "hopenet.npz"))


if __name__ == "__main__":
    main()
