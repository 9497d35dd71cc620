"""PyTorch port: the training data path on the host, against the JAX
package, on the CPU, bit for bit.

- data/augmentation.py (a copy): every transform class, the ones off by
  default included, and the composed default and full pipelines, from the
  same seeds of Python's ``random`` and numpy's global RNG.
- FramesDataset(is_train=True) (data/dataset.py): every item of a tree of
  PNG frames PIL writes (with grain, so that they carry real row filters),
  with the on-device items (two uint8 frames) and with the CPU-augmented
  ones (two float frames and their augmented copies), from the same numpy
  and ``random`` seeds.
- PrefetchLoader (data/loader.py): lengths, each shard's epoch permutation,
  and the batches of an epoch (one worker thread, so that the items draw
  from numpy's global RNG in one order).
- DeviceFrameCache / CachedLoader (data/device_cache.py, on the CPU): the
  frame table and its layout, sample_indices, the gathers, an epoch of
  batches; the byte budget's error; a mesh and the scan feed refused.
"""
import random

import numpy as np
import pytest
import torch
from PIL import Image

from facevae_tpu.data import augmentation as jax_aug
from facevae_tpu.data import dataset as jax_dataset
from facevae_tpu.data import device_cache as jax_cache
from facevae_tpu.data import loader as jax_loader
from facevae_tpu_torch.data import augmentation, dataset, device_cache, loader
from facevae_tpu_torch.data.synthetic import write_training_tree
from torch_parity import one_torch_thread  # noqa: F401

SIZE = 32


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _clip(seed, size=SIZE, n=2):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:size, :size] / size
    base = np.stack([0.5 + 0.4 * np.sin(5 * x + c) * np.cos(4 * y - c) for c in range(3)], -1)
    return [np.clip(base + rs.uniform(-0.1, 0.1, base.shape), 0, 1).astype(np.float32)
            for _ in range(n)]


ALL_PARAMS = {"flip_param": {"time_flip": True, "horizontal_flip": True},
              "rotation_param": {"degrees": 30},
              "perspective_param": {"pers_num": 30, "enlarge_num": 40},
              "resize_param": {"ratio": (0.8, 1.2), "interpolation": "bilinear"},
              "crop_param": {"size": 24},
              "jitter_param": {"brightness": 0.3, "contrast": 0.3, "saturation": 0.3,
                               "hue": 0.2}}
CASES = {
    "geometry": [("RandomFlip", {"time_flip": True, "horizontal_flip": True}, SIZE),
                 ("RandomRotation", {"degrees": 30}, SIZE),
                 ("RandomRotation", {"degrees": (-5, 40)}, SIZE),
                 ("RandomPerspective", {"pers_num": 30, "enlarge_num": 40}, SIZE),
                 ("RandomPerspective", {"pers_num": 30, "enlarge_num": 40}, 256),
                 ("RandomResize", {"interpolation": "nearest"}, SIZE),
                 ("RandomResize", {"interpolation": "bilinear"}, SIZE),
                 ("RandomCrop", {"size": 20}, SIZE),
                 ("RandomCrop", {"size": (40, 36)}, SIZE)],
    "pixels": [("ColorJitter", {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1,
                                "hue": 0.1}, SIZE),
               ("ColorJitter", {"brightness": 0.5, "contrast": 0.0, "saturation": 0.7,
                                "hue": 0.4}, SIZE),
               ("GaussianBlur", {}, SIZE),
               ("RandomGrayscale", {"p": 0.5}, SIZE)],
    "composed": [("AllAugmentationTransform", dataset._DEFAULT_AUG, SIZE),
                 ("AllAugmentationTransform", ALL_PARAMS, SIZE),
                 ("AllAugmentationTransform", {}, SIZE)],
}


@pytest.mark.parametrize("group", sorted(CASES))
def test_augmentation_copy_matches_the_jax_package(group):
    """Each transform of the group on 2-frame clips, 6 seeds each."""
    for name, params, size in CASES[group]:
        for seed in range(6):
            clip = _clip(seed, size)
            _seed(seed)
            ref = getattr(jax_aug, name)(**params)(list(clip))
            _seed(seed)
            out = getattr(augmentation, name)(**params)(list(clip))
            assert len(out) == len(ref), (name, seed)
            for a, b in zip(out, ref):
                assert a.dtype == b.dtype and a.shape == b.shape, (name, seed)
                assert np.array_equal(a, b), (name, params, seed)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 identities x 2 clips x 4 frames (and a test video), written by PIL
    with +-8 levels of grain."""
    root = str(tmp_path_factory.mktemp("train_tree"))
    return write_training_tree(root, SIZE, 3, 2, 4,
                               write=lambda p, img: Image.fromarray(img).save(p), noise=8)


@pytest.mark.parametrize("on_device", [True, False], ids=["uint8_items", "cpu_aug_items"])
def test_training_items_match_the_jax_package(on_device, tree):
    """Every item of the repeated split, from the same seeds, bit for bit:
    the train CLI's two datasets (on-device: augmentation_params {})."""
    kw = dict(frame_shape=(SIZE, SIZE, 3), on_device_aug=on_device,
              augmentation_params={} if on_device else None)
    ref = jax_dataset.DatasetRepeater(jax_dataset.FramesDataset(tree, **kw), 2)
    port = dataset.DatasetRepeater(dataset.FramesDataset(tree, **kw), 2)
    assert port.dataset.videos == ref.dataset.videos == ["id0", "id1", "id2"]
    assert len(port) == len(ref) == 6
    for i in range(len(ref)):
        _seed(i)
        b = ref[i]
        _seed(i)
        a = port[i]
        assert len(a) == len(b) == (2 if on_device else 4)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == (np.uint8 if on_device else np.float32)
            assert x.shape == y.shape == (SIZE, SIZE, 3) and np.array_equal(x, y), i


def test_prefetch_loader_matches_the_jax_loader(tree):
    """Lengths, the shards' epoch permutations, and one epoch's batches."""
    kw = dict(frame_shape=(SIZE, SIZE, 3), on_device_aug=True, augmentation_params={})
    ref_ds = jax_dataset.DatasetRepeater(jax_dataset.FramesDataset(tree, **kw), 5)
    port_ds = dataset.DatasetRepeater(dataset.FramesDataset(tree, **kw), 5)
    for shard in ((0, 1), (0, 2), (1, 2)):
        for drop_last in (True, False):
            a = loader.PrefetchLoader(port_ds, 4, shard=shard, seed=3, drop_last=drop_last)
            b = jax_loader.PrefetchLoader(ref_ds, 4, shard=shard, seed=3, drop_last=drop_last)
            assert len(a) == len(b) > 0
            for epoch in (0, 2):
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                assert np.array_equal(a._indices(), b._indices())
    got = {}
    for name, ds, mod in (("port", port_ds, loader), ("jax", ref_ds, jax_loader)):
        ld = mod.PrefetchLoader(ds, 4, num_workers=1, seed=3, prefetch_batches=2)
        ld.set_epoch(1)
        _seed(7)
        got[name] = list(ld)
    assert len(got["port"]) == len(got["jax"]) == 3
    for a, b in zip(got["port"], got["jax"]):
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x.dtype == np.uint8 and x.shape == (4, SIZE, SIZE, 3)
            assert np.array_equal(x, y)


def test_device_cache_matches_the_jax_cache(tree):
    """The frame table, its layout, sample_indices, gathers and an epoch of
    CachedLoader batches, on the CPU; the budget error; more shards than
    identities refused; the scan feed's tables are the epoch's batches'.
    (The sharded cache: tests/test_torch_dp.py.)"""
    shape = (SIZE, SIZE, 3)
    port = device_cache.DeviceFrameCache(tree, frame_shape=shape, num_workers=2, device="cpu")
    ref = jax_cache.DeviceFrameCache(tree, frame_shape=shape, num_workers=2)
    assert port.frames.dtype == torch.uint8 and tuple(port.frames.shape) == (24, *shape)
    assert np.array_equal(port.frames.numpy(), np.asarray(ref.frames))
    assert port.num_identities == ref.num_identities == 3
    assert port.clips_per_id == ref.clips_per_id
    assert np.array_equal(port.clip_start, ref.clip_start)
    assert np.array_equal(port.clip_count, ref.clip_count)
    ra, rb = np.random.RandomState(5), np.random.RandomState(5)
    for batch in (1, 4, 8):
        (sa, da), (sb, db) = port.sample_indices(ra, batch), ref.sample_indices(rb, batch)
        assert sa.dtype == sb.dtype and np.array_equal(sa, sb) and np.array_equal(da, db)
        assert (sa <= da).all()
        assert np.array_equal(port.gather(sa).numpy(), np.asarray(ref.gather(sb)))
    la = device_cache.CachedLoader(port, 4, num_items=port.num_identities * 4, seed=2)
    lb = jax_cache.CachedLoader(ref, 4, num_items=ref.num_identities * 4, seed=2)
    la.set_epoch(3)
    lb.set_epoch(3)
    assert len(la) == len(lb) == 3
    for (s, d), (s2, d2) in zip(la, lb):
        assert s.dtype == d.dtype == torch.uint8
        assert np.array_equal(s.numpy(), np.asarray(s2)) and np.array_equal(d.numpy(),
                                                                             np.asarray(d2))
    for mod, kw in ((device_cache, {"device": "cpu"}), (jax_cache, {})):
        with pytest.raises(ValueError, match="device cache budget"):
            mod.DeviceFrameCache(tree, frame_shape=shape, max_bytes=1000, **kw)
    with pytest.raises(ValueError, match="4 shards > 3 identities"):
        device_cache.DeviceFrameCache(tree, frame_shape=shape, world=4, device="cpu")
    chunks = list(la.iter_index_chunks(2))
    assert [c[0].shape for c in chunks] == [(2, 4), (1, 4)]
    rows = [(s, d) for cs, cd in chunks for s, d in zip(cs, cd)]
    for (s, d), (si, di) in zip(la, rows, strict=True):
        assert torch.equal(s, port.gather(si)) and torch.equal(d, port.gather(di))
