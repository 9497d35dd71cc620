"""The port's teacher converter (facevae_tpu_torch/convert_torch_weights.py)
against the JAX package's (tools/convert_torch_weights.py): on seeded torch
state dicts in the layouts the reference downloads (torchvision VGG19
``features.N.*``, the Oxford vgg_face_dag ``convX_Y.*``, a torchvision-style
ResNet50 Hopenet with its vestigial fc_finetune), both CLIs write the same
npz files, key for key and array for array; the port's teachers read them
back equal to their sources.  The state dicts are the ones phase reference
of chip_smoke.py converts (chip_smoke.teacher_state_dicts, from hand-written
shapes); a test holds their layout to torch modules of the downloads' nets.
"""
import importlib.util
import re
import sys

import numpy as np
import pytest
import torch
from torch import nn as tnn

from facevae_tpu_torch import convert_torch_weights
from facevae_tpu_torch.config import Config
from facevae_tpu_torch.losses import PerceptualLoss
from facevae_tpu_torch.losses.pretrained import load_pretrained
from facevae_tpu_torch.models import Hopenet
from chip_smoke import REF_SEED, teacher_state_dicts
from test_teacher_conversion import (VGG16_CFG, VGG19_CFG, TorchBottleneck,
                                     make_torch_vgg_features)

TEACHERS = ("vgg19", "vggface", "hopenet")
# the Oxford names of torchvision's VGG16 .features indices
OXFORD = {0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2", 10: "conv3_1",
          12: "conv3_2", 14: "conv3_3", 17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
          24: "conv5_1", 26: "conv5_2", 28: "conv5_3"}


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "convert_torch_weights_jax", "tools/convert_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TorchHopenet(tnn.Module):
    """The reference Hopenet's layout (trainer.py:16-88): a torchvision
    ResNet50 trunk, the three angle heads and the vestigial fc_finetune."""

    def __init__(self, layers=(3, 4, 6, 3), num_bins=66):
        super().__init__()
        self.inplanes = 64
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            setattr(self, f"layer{i + 1}", self._make_layer(planes, n, 1 if i == 0 else 2))
        for head in ("fc_yaw", "fc_pitch", "fc_roll"):
            setattr(self, head, tnn.Linear(512 * 4, num_bins))
        self.fc_finetune = tnn.Linear(512 * 4 + 3, 3)

    def _make_layer(self, planes, blocks, stride):
        down = None
        if stride != 1 or self.inplanes != planes * 4:
            down = tnn.Sequential(tnn.Conv2d(self.inplanes, planes * 4, 1, stride, bias=False),
                                  tnn.BatchNorm2d(planes * 4))
        out = [TorchBottleneck(self.inplanes, planes, stride, down)]
        self.inplanes = planes * 4
        out += [TorchBottleneck(self.inplanes, planes) for _ in range(1, blocks)]
        return tnn.Sequential(*out)


def test_smoke_teachers_have_the_downloads_layout():
    """chip_smoke.teacher_state_dicts: the keys, in order, and the shapes and
    dtypes of the torch modules whose state dicts the downloads are (the VGG
    conv stacks of torchvision's make_layers, without the classifiers no
    converter reads, and the reference's Hopenet)."""
    vgg16 = make_torch_vgg_features(VGG16_CFG).state_dict()
    want = {"vgg19": {f"features.{k}": v
                      for k, v in make_torch_vgg_features(VGG19_CFG).state_dict().items()},
            "vggface": {f"{OXFORD[int(k.split('.')[0])]}.{k.split('.')[1]}": v
                        for k, v in vgg16.items()},
            "hopenet": TorchHopenet().state_dict()}
    got = teacher_state_dicts(REF_SEED)
    for t in TEACHERS:
        assert [(k, tuple(v.shape), v.dtype) for k, v in got[t].items()] == [
            (k, tuple(v.shape), v.numpy().dtype) for k, v in want[t].items()], t


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Both CLIs over the same .pth files: (sources, JAX tool's dir, port's dir)."""
    root = tmp_path_factory.mktemp("teachers")
    sds = {t: {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
           for t, sd in teacher_state_dicts(REF_SEED).items()}
    argv = []
    for t, sd in sds.items():
        torch.save(sd, root / f"{t}.pth")
        argv += [f"--{t}", str(root / f"{t}.pth")]
    saved = sys.argv
    try:
        sys.argv = ["convert_torch_weights.py", *argv, "--out", str(root / "jax")]
        _load_tool().main()
    finally:
        sys.argv = saved
    convert_torch_weights.main([*argv, "--out", str(root / "port")])
    return sds, root / "jax", root / "port"


@pytest.mark.parametrize("teacher", TEACHERS)
def test_files_equal_the_jax_tools(converted, teacher):
    """Key for key (in the same order) and array for array: dtype, shape
    and bits."""
    _, jax_dir, port_dir = converted
    with np.load(jax_dir / f"{teacher}.npz") as want, np.load(port_dir / f"{teacher}.npz") as got:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), k


def test_port_teachers_read_their_sources(converted):
    """load_pretrained over the port's files: every leaf of the port's
    teachers the converter writes equals its source tensor (torch's layout
    on both sides), through the flax layout of the npz."""
    sds, _, port_dir = converted
    nets = {"perceptual": PerceptualLoss(Config().loss.n_scales, device="cpu"),
            "hopenet": Hopenet(device="cpu")}
    load_pretrained(nets, str(port_dir))
    own = {"vgg19": nets["perceptual"].vgg19.state_dict(),
           "vggface": nets["perceptual"].vggface.state_dict(),
           "hopenet": nets["hopenet"].state_dict()}
    names = {"vgg19": {f"features.{i}": f"conv{bi + 1}_{ci + 1}"
                       for (bi, ci), i in convert_torch_weights.VGG19_IDX.items()},
             "vggface": {n: n for n in convert_torch_weights.VGGFACE_NAMES.values()}}
    for t in ("vgg19", "vggface"):
        for src, dst in names[t].items():
            for leaf in ("weight", "bias"):
                assert torch.equal(own[t][f"{dst}.{leaf}"], sds[t][f"{src}.{leaf}"]), (t, src)
    assert len(names["vgg19"]) == 13 and len(names["vggface"]) == 11
    hop = {k: v for k, v in sds["hopenet"].items()
           if not k.startswith("fc_finetune") and not k.endswith("num_batches_tracked")}
    assert len(hop) == len(own["hopenet"])
    for k, v in hop.items():
        port_key = re.sub(r"^layer(\d)\.(\d+)\.", r"layer\1_\2.", k)
        port_key = port_key.replace(".downsample.0.", ".downsample_conv.").replace(
            ".downsample.1.", ".downsample_bn.")
        assert torch.equal(own["hopenet"][port_key], v), k
