"""Device-resident dataset cache (port of facevae_tpu/data/device_cache.py):
decode once, gather per step on the device.

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

Data parallelism (``world`` ranks): identities go round-robin to the ranks
(the reference's DistributedSampler stride), and rank r decodes and holds
only its shard's frames, as each device of the JAX module's mesh holds its
block of one sharded array.  Every rank draws the same global, shard-major
table of shard-local indices from the same RandomState (the JAX module's
``sample_indices``, index for index) and gathers its own columns
(``local``): the union over the ranks is the JAX global batch.
``CachedLoader.iter_index_chunks`` feeds the multi-step dispatcher
(train/scan.py) K steps of tables at a time.
"""
from __future__ import annotations

import concurrent.futures as cf
import glob
import os
from typing import List, Tuple

import numpy as np
import torch

from facevae_tpu_torch.data.dataset import FramesDataset, _imread_raw


class DeviceFrameCache:
    """A FramesDataset's train split (with ``world`` ranks: rank ``rank``'s
    shard of it) decoded into one uint8 tensor on ``device``; (s, d)
    batches sampled by gather on the device."""

    def __init__(self, root_dir: str, frame_shape=(256, 256, 3),
                 id_sampling: bool = True, num_workers: int = 8,
                 max_bytes: int = 4 << 30, world: int = 1, rank: int = 0, device="cuda"):
        ds = FramesDataset(root_dir, frame_shape=frame_shape, id_sampling=id_sampling,
                           is_train=True, on_device_aug=True)
        self.num_identities = len(ds)
        self.world, self.rank = world, rank
        if world > self.num_identities:
            raise ValueError(f"{world} shards > {self.num_identities} identities: every rank "
                             "needs at least one identity to sample")

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

        # identity -> shard, round-robin; within a shard the clips lie one
        # after another in identity order, at shard-local offsets clip_start
        self.shard_identities = [list(range(r, self.num_identities, world))
                                 for r in range(world)]
        self.clip_start = np.zeros(len(clip_frames), np.int64)
        shard_totals = []
        for idents in self.shard_identities:
            off = 0
            for ident in idents:
                for clip in self.clips_per_id[ident]:
                    self.clip_start[clip] = off
                    off += self.clip_count[clip]
            shard_totals.append(off)
        # the JAX module pads its shards to one size S; its budget counts
        # them all, as here
        self.shard_size = int(max(shard_totals))

        H, W, C = frame_shape
        nbytes = self.shard_size * world * H * W * C
        if nbytes > max_bytes:
            raise ValueError(
                f"dataset is {nbytes/2**30:.2f} GiB decoded ({self.shard_size * world} frames "
                f"incl. shard padding at {H}x{W}); device cache budget is "
                f"{max_bytes/2**30:.2f} GiB — use the streaming loader")

        flat = np.zeros((shard_totals[rank], H, W, C), np.uint8)
        jobs = [(int(self.clip_start[clip]) + j, p)
                for ident in self.shard_identities[rank] for clip in self.clips_per_id[ident]
                for j, p in enumerate(clip_frames[clip])]

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
        (source = earlier frame, dataset.py:107); int32 [batch_size] each.
        ``batch_size`` is the global batch: item i belongs to rank
        i // (batch_size / world), draws from that rank's identities, and
        its indices are shard-local (the JAX module's shard-major table)."""
        if batch_size % self.world:
            raise ValueError(f"batch {batch_size} not divisible by {self.world} shards")
        per_shard = batch_size // self.world
        s_idx = np.empty(batch_size, np.int32)
        d_idx = np.empty(batch_size, np.int32)
        for i in range(batch_size):
            idents = self.shard_identities[i // per_shard]
            ident = idents[rng.randint(len(idents))]
            clips = self.clips_per_id[ident]
            clip = clips[rng.randint(len(clips))]
            a, b = np.sort(rng.randint(0, self.clip_count[clip], size=2))
            s_idx[i] = self.clip_start[clip] + a
            d_idx[i] = self.clip_start[clip] + b
        return s_idx, d_idx

    def local(self, idx: np.ndarray) -> np.ndarray:
        """This rank's columns of a global table ([..., batch]): the
        indices into this rank's frames."""
        per_shard = idx.shape[-1] // self.world
        return idx[..., self.rank * per_shard:(self.rank + 1) * per_shard]

    def gather(self, idx: np.ndarray) -> torch.Tensor:
        """The frames at ``idx`` (indices into this rank's frames),
        [len(idx), H, W, 3] uint8 on the device."""
        index = torch.from_numpy(np.asarray(idx, np.int64)).to(self.frames.device)
        return self.frames.index_select(0, index)


class CachedLoader:
    """PrefetchLoader-compatible iterator over a DeviceFrameCache: yields
    this rank's (s, d) batches, which already live on the device (uint8).
    ``batch_size`` is the global batch (the ranks' together)."""

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
            yield (self.cache.gather(self.cache.local(s_idx)),
                   self.cache.gather(self.cache.local(d_idx)))

    def iter_index_chunks(self, steps_per_chunk: int):
        """Yield the global ([K, batch], [K, batch]) int32 index tables of
        the epoch, K = steps_per_chunk steps at a time, from the RandomState
        __iter__ draws from (the same tables).  The epoch's len(self) % K
        remainder steps come as one final smaller chunk: no step is
        dropped."""
        rng = np.random.RandomState(self.seed + self.epoch)
        remaining = len(self)
        while remaining > 0:
            k = min(steps_per_chunk, remaining)
            remaining -= k
            rows = [self.cache.sample_indices(rng, self.batch_size) for _ in range(k)]
            yield (np.stack([s for s, _ in rows]), np.stack([d for _, d in rows]))
