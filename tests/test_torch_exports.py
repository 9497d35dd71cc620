"""The port covers the JAX package's public surface.

For facevae_tpu and each of its subpackages (ops, nn, losses, models,
train, data, parallel), every public name (not a submodule) is public in
the port's counterpart too, or stands in STAND_INS with what takes its
place in the port or why it is not ported; every module file likewise, or
stands in MODULE_STAND_INS.  A table entry the port no longer needs fails
the test, so the tables stay the written record of what differs.
"""
import importlib
import importlib.util
import pkgutil
import types

import pytest

SUBPACKAGES = ("", ".ops", ".nn", ".losses", ".models", ".train", ".data", ".parallel")

# (JAX subpackage, public name) -> (what stands in its place, "module:attr", or
# None; why)
STAND_INS = {
    ("facevae_tpu.train", "make_train_step"): (
        "facevae_tpu_torch.train.step:train_step",
        "the step is a function of the train state, called eagerly or replayed "
        "through train/scan.py, not a jitted closure a factory builds"),
    ("facevae_tpu.parallel", "make_mesh"): (
        "facevae_tpu_torch.parallel.mesh:init_distributed",
        "one process per card in a torch.distributed group, not a device mesh"),
    ("facevae_tpu.nn", "torch_kernel_init"): (
        "facevae_tpu_torch.nn.init:init_parameters",
        "each layer's init_parameters(generator) draws torch's default "
        "distribution from a seeded torch.Generator"),
    ("facevae_tpu.nn", "torch_bias_init"): (
        "facevae_tpu_torch.nn.init:init_parameters", "as torch_kernel_init"),
    ("facevae_tpu.nn", "fold_depth"): (
        None, "the depth-folded convs' TPU layout; the port's 3-D convs are plain "
              "(ROADMAP.md, Not to port)"),
    ("facevae_tpu.data", "AllAugmentationTransform"): (
        "facevae_tpu_torch.data.augmentation:AllAugmentationTransform",
        "imported from its module (cv2 and PIL), as the port's data/__init__ says"),
}

# JAX module -> (the port's module standing in, or None; why)
MODULE_STAND_INS = {
    "facevae_tpu.utils": (
        None, "TRANSFER_LOCK, locked_device_get and the XLA compile cache: the TPU "
              "runtime's (ROADMAP.md, Not to port)"),
    "facevae_tpu.utils_port": (
        "facevae_tpu_torch.convert",
        "the order-based torch <-> flax zip for the reference's checkpoints; the port's "
        "bridge is keyed on names"),
    "facevae_tpu.ops.pallas": (
        "facevae_tpu_torch.ops.fast_warp",
        "the Pallas warp kernels, ported as CUDA in facevae_tpu_torch/csrc/ behind "
        "fast_warp's wrappers"),
}


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def _resolve(path):
    module, _, attr = path.partition(":")
    mod = importlib.import_module(module)
    return getattr(mod, attr) if attr else mod


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_public_names_are_ported(sub):
    jax_mod = importlib.import_module("facevae_tpu" + sub)
    port = importlib.import_module("facevae_tpu_torch" + sub)
    jax_names, port_names = _public(jax_mod), _public(port)
    table = {n: v for (m, n), v in STAND_INS.items() if m == jax_mod.__name__}
    missing = sorted(jax_names - port_names - set(table))
    assert not missing, f"{jax_mod.__name__}: not in the port and not in STAND_INS: {missing}"
    for name, (stand_in, why) in table.items():
        assert name in jax_names and name not in port_names, \
            f"STAND_INS entry {jax_mod.__name__}.{name} is stale"
        assert why
        if stand_in is not None:
            _resolve(stand_in)


def test_module_files_are_ported():
    """Every module of the JAX package has a module of the same name in the
    port, or an entry in MODULE_STAND_INS."""
    root = importlib.import_module("facevae_tpu")
    used = set()
    for info in pkgutil.walk_packages(root.__path__, "facevae_tpu."):
        if info.name.startswith(tuple(m + "." for m in MODULE_STAND_INS)):
            continue                       # inside a package that stands in as a whole
        port_name = "facevae_tpu_torch" + info.name[len("facevae_tpu"):]
        if importlib.util.find_spec(port_name) is not None:
            assert info.name not in MODULE_STAND_INS, f"{info.name}: stale MODULE_STAND_INS entry"
            continue
        assert info.name in MODULE_STAND_INS, f"{info.name}: no module {port_name}"
        used.add(info.name)
        stand_in, why = MODULE_STAND_INS[info.name]
        assert why
        if stand_in is not None:
            _resolve(stand_in)
    assert used == set(MODULE_STAND_INS)
