"""Device-resident dataset cache (counterpart of
facevae_tpu/data/device_cache.py, one device): decode once, gather per step
on the device.

For datasets that fit device memory (256² uint8 is ~196 KB a frame, a
5k-frame subset ~1 GB), every frame of the train split is decoded once
(data/image_io.read_png, through FramesDataset's reader) into one
[total, H, W, 3] uint8 tensor on the device.  Each step then draws its
(source, driving) pair by an index_select on the device from host-chosen
indices: the per-step host-to-device traffic drops from megabytes of pixels
to a few bytes of indices.  Sampling matches FramesDataset (identity ->
random clip of it -> 2 random frames with replacement, sorted), and
``sample_indices`` is the JAX module's numpy code, so its indices equal
JAX's for a seed.

The JAX module also shards the cache over a data-parallel mesh and feeds
its multi-step scan dispatcher (``iter_index_chunks``); here both raise
NotImplementedError (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import concurrent.futures as cf
import glob
import os
from typing import List, Tuple

import numpy as np
import torch

from facevae_tpu_torch.data.dataset import FramesDataset, _imread_raw

_NOT_PORTED = ("the data-parallel mesh and the multi-step scan dispatcher are not ported "
               "(ROADMAP Queue 1 item 5)")


class DeviceFrameCache:
    """A FramesDataset's train split decoded into one uint8 tensor on
    ``device``; (s, d) batches sampled by gather on the device."""

    def __init__(self, root_dir: str, frame_shape=(256, 256, 3),
                 id_sampling: bool = True, num_workers: int = 8,
                 max_bytes: int = 4 << 30, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(f"DeviceFrameCache(mesh=...): {_NOT_PORTED}")
        ds = FramesDataset(root_dir, frame_shape=frame_shape, id_sampling=id_sampling,
                           is_train=True, on_device_aug=True)
        self.num_identities = len(ds)

        # every (identity, clip) PNG directory and its frame files, clips
        # laid out one after another in identity order
        clip_frames: List[List[str]] = []
        self.clips_per_id: List[List[int]] = []       # identity -> clip ids
        for name in ds.videos:
            paths = (sorted(glob.glob(os.path.join(ds.root_dir, name + "*")))
                     if ds.id_sampling else [os.path.join(ds.root_dir, name)])
            ids = []
            for p in paths:
                if not os.path.isdir(p):
                    raise ValueError(f"device cache supports PNG-frame dirs only; got {p}")
                ids.append(len(clip_frames))
                clip_frames.append([os.path.join(p, f) for f in sorted(os.listdir(p))])
            self.clips_per_id.append(ids)
        self.clip_count = np.asarray([len(f) for f in clip_frames], np.int64)
        self.clip_start = np.concatenate([[0], np.cumsum(self.clip_count)[:-1]]).astype(np.int64)

        H, W, C = frame_shape
        total = int(self.clip_count.sum())
        nbytes = total * H * W * C
        if nbytes > max_bytes:
            raise ValueError(
                f"dataset is {nbytes/2**30:.2f} GiB decoded ({total} frames at {H}x{W}); "
                f"device cache budget is {max_bytes/2**30:.2f} GiB — use the streaming loader")

        flat = np.zeros((total, H, W, C), np.uint8)
        jobs = [(int(self.clip_start[clip]) + j, p)
                for clip, frames in enumerate(clip_frames) for j, p in enumerate(frames)]

        def decode(job):
            i, path = job
            img = _imread_raw(path)
            if img.shape != (H, W, C):
                raise ValueError(f"{path}: {img.shape} != {tuple(frame_shape)}")
            flat[i] = img

        with cf.ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
            list(pool.map(decode, jobs))
        self.frames = torch.from_numpy(flat).to(device)      # ONE transfer

    def sample_indices(self, rng: np.random.RandomState, batch_size: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """FramesDataset semantics: per item a uniform identity, then a
        random clip of it, then 2 random frames with replacement, sorted
        (source = earlier frame, dataset.py:107); int32 [batch_size] each."""
        s_idx = np.empty(batch_size, np.int32)
        d_idx = np.empty(batch_size, np.int32)
        for i in range(batch_size):
            ident = rng.randint(self.num_identities)
            clips = self.clips_per_id[ident]
            clip = clips[rng.randint(len(clips))]
            a, b = np.sort(rng.randint(0, self.clip_count[clip], size=2))
            s_idx[i] = self.clip_start[clip] + a
            d_idx[i] = self.clip_start[clip] + b
        return s_idx, d_idx

    def gather(self, idx: np.ndarray) -> torch.Tensor:
        """The frames at ``idx``, [len(idx), H, W, 3] uint8 on the device."""
        index = torch.from_numpy(np.asarray(idx, np.int64)).to(self.frames.device)
        return self.frames.index_select(0, index)


class CachedLoader:
    """PrefetchLoader-compatible iterator over a DeviceFrameCache: yields
    (s, d) batches that already live on the device (uint8)."""

    def __init__(self, cache: DeviceFrameCache, batch_size: int,
                 num_items: int, seed: int = 0):
        self.cache = cache
        self.batch_size = batch_size
        self.num_items = num_items
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_items // self.batch_size

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        for _ in range(len(self)):
            s_idx, d_idx = self.cache.sample_indices(rng, self.batch_size)
            yield self.cache.gather(s_idx), self.cache.gather(d_idx)

    def iter_index_chunks(self, steps_per_chunk: int):
        raise NotImplementedError(f"CachedLoader.iter_index_chunks: {_NOT_PORTED}")
