"""PyTorch port: the train state's config fields against facevae_tpu's, on
the CPU.

- LossConfig.pretrained_dir: small teacher npz files (a handful of leaves of
  VGG19, VGG-Face and Hopenet, Hopenet's batch_stats included), written
  from seeded JAX teacher trees, load into the port through
  create_train_state exactly as facevae_tpu/losses/pretrained.py loads them
  into the JAX trees: every leaf equal bit for bit, loaded or untouched;
  the same printed line; the same KeyError / ValueError on a key with no
  leaf / a shape mismatch; the same warning when no file exists.
- TrainConfig.train_vae: a step on a config with it set raises the VAE's
  ValueError on an eps not laid out as [N, h*w*Cz]; given none, it samples
  the driving frame's VAE, as the JAX step does, and with LossConfig.kl = 1
  its K loss is the KL term, nonzero; the default config steps with K = 0
  (tests/test_torch_vae_step.py holds the sampling step to the JAX one).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.losses.pretrained import load_pretrained as jax_load_pretrained
from facevae_tpu.train.state import build_all_modules as jax_build_all_modules
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from facevae_tpu_torch.train import build_all_modules, create_train_state, train_step
from torch_parity import golden, one_torch_thread  # noqa: F401

TEACHERS = ("hopenet", "perceptual")
# the leaves each file holds (a subset: small ones of the first and last
# blocks; Hopenet's with a Dense kernel and BatchNorm scale, bias, mean, var)
FILE_LEAVES = {
    "vgg19.npz": ("conv1_1/kernel", "conv1_1/bias", "conv2_1/bias", "conv5_1/bias"),
    "vggface.npz": ("conv1_2/kernel", "conv4_3/bias"),
    "hopenet.npz": ("params/conv1/kernel", "params/bn1/scale", "params/bn1/bias",
                    "batch_stats/bn1/mean", "batch_stats/layer4_2/bn3/var",
                    "params/fc_yaw/kernel", "params/fc_roll/bias"),
}
FILE_TREE = {"vgg19.npz": ("perceptual", "params", "vgg19"),
             "vggface.npz": ("perceptual", "params", "vggface"),
             "hopenet.npz": ("hopenet",)}


@pytest.fixture(scope="module")
def teachers():
    """The JAX teacher trees {"hopenet": {params, batch_stats},
    "perceptual": {params}}, filled from a numpy seed (jax.eval_shape: no
    compile)."""
    cfg = jax_tiny_config()
    models = jax_build_all_modules(cfg)
    img = jax.numpy.zeros((1, cfg.model.image_size, cfg.model.image_size, 3))
    args = {"hopenet": (jax.numpy.zeros((1, 224, 224, 3)),), "perceptual": (img, img)}
    key = jax.random.PRNGKey(0)
    rs = np.random.RandomState(3)
    return {n: golden.fill_variables(jax.eval_shape(lambda: models[n].init(key, *args[n])), rs)
            for n in TEACHERS}


@pytest.fixture(scope="module")
def port_nets():
    """The port's modules at tiny_config on the CPU (built once; each test
    loads the JAX teacher trees into them afresh)."""
    return build_all_modules(tiny_config(), "cpu")


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _write(tmp_path, teachers, files, bad=None, bad_file=None):
    """Write ``files`` of FILE_LEAVES into tmp_path with values drawn from a
    numpy seed in each leaf's JAX shape; ``bad`` = "key" adds a key with no
    leaf to ``bad_file``, "shape" gives its first leaf a wrong shape."""
    rs = np.random.RandomState(4)
    for fname in files:
        tree = _leaf(teachers, FILE_TREE[fname])
        leaves = {k: rs.randn(*_leaf(tree, k.split("/")).shape).astype(np.float32)
                  for k in FILE_LEAVES[fname]}
        if fname == bad_file and bad == "key":
            leaves["conv9_9/kernel"] = np.zeros((3, 3, 3, 64), np.float32)
        if fname == bad_file and bad == "shape":
            first = FILE_LEAVES[fname][0]
            leaves[first] = leaves[first][..., :-1]
        np.savez(tmp_path / fname, **leaves)


def _port_state(port_nets, teachers, pretrained_dir):
    for n in TEACHERS:
        load_jax_variables(port_nets[n], teachers[n])
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss,
                                                            pretrained_dir=str(pretrained_dir)))
    return create_train_state(cfg, "cpu", port_nets)


@pytest.mark.parametrize("files", [tuple(FILE_LEAVES), ("hopenet.npz",), ("vggface.npz",), ()])
def test_pretrained_teachers_load_as_in_the_jax_package(files, teachers, port_nets, tmp_path,
                                                        capsys):
    """Every leaf of both teachers equals the JAX-loaded tree's bit for bit
    (the loaded ones differ from the seeded ones, the others keep theirs),
    and both packages print the same line (the warning when no file
    exists)."""
    _write(tmp_path, teachers, files)
    ref = jax.tree.map(np.asarray, jax_load_pretrained(teachers, str(tmp_path)))
    jax_out = capsys.readouterr().out
    state = _port_state(port_nets, teachers, tmp_path)
    assert capsys.readouterr().out == jax_out
    assert ("WARNING" in jax_out) == (not files)
    for n in TEACHERS:
        want = state_dict_from_jax(ref[n])
        seeded = state_dict_from_jax(teachers[n])
        got = {k: v.numpy() for k, v in state.nets[n].state_dict().items()}
        assert set(got) == set(want), n
        changed = {k for k in want if not np.array_equal(want[k], seeded[k])}
        assert len(changed) == sum(len(FILE_LEAVES[f]) for f in files if FILE_TREE[f][0] == n)
        for k in want:
            assert np.array_equal(got[k], want[k]), f"{n}.{k}"


@pytest.mark.parametrize("files", [("vgg19.npz",), ("vgg19.npz", "vggface.npz")])
@pytest.mark.parametrize("bad, error", [("key", KeyError), ("shape", ValueError)])
def test_pretrained_teachers_refuse_what_the_jax_package_refuses(bad, error, files, teachers,
                                                                 port_nets, tmp_path):
    """A key with no leaf / a shape mismatch in the last file raises in
    both packages, and the port's teachers keep every seeded value, also
    where a good vgg19.npz came before a bad vggface.npz."""
    _write(tmp_path, teachers, files, bad, files[-1])
    with pytest.raises(error):
        jax_load_pretrained(teachers, str(tmp_path))
    with pytest.raises(error, match="conv9_9" if bad == "key" else "shape mismatch"):
        _port_state(port_nets, teachers, tmp_path)
    for n in TEACHERS:
        seeded = state_dict_from_jax(teachers[n])
        for k, v in port_nets[n].state_dict().items():
            assert np.array_equal(v.numpy(), seeded[k]), f"{n}.{k}"


def test_train_vae_step_samples_k_refuses_a_channel_first_eps_and_default_k_is_zero(port_nets):
    cfg = tiny_config()
    vae = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, train_vae=True),
                              loss=dataclasses.replace(cfg.loss, kl=1.0))
    g = torch.Generator().manual_seed(0)
    size = cfg.model.image_size
    batch = tuple(torch.rand(2, size, size, 3, generator=g) for _ in range(4))
    with pytest.raises(ValueError, match="eps"):          # channel-first: not the JAX order
        train_step(create_train_state(vae, "cpu", port_nets), batch, generator=g,
                   vae_eps=torch.zeros(2, 16, 1, 1))
    out = train_step(create_train_state(vae, "cpu", port_nets), batch, generator=g)
    assert all(bool(torch.isfinite(v)) for v in {**out["losses_g"], **out["losses_d"]}.values())
    assert float(out["losses_g"]["K"]) > 0.0
    out = train_step(create_train_state(cfg, "cpu", port_nets), batch, generator=g)
    assert all(bool(torch.isfinite(v)) for v in {**out["losses_g"], **out["losses_d"]}.values())
    assert float(out["losses_g"]["K"]) == 0.0
