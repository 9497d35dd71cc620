"""Frame datasets (a copy of facevae_tpu/data/dataset.py, not an import of
it: the port imports nothing of the JAX package).

- FramesDataset: videos are PNG-frame directories (or .mp4 / .gif files);
  the train / test split is the root's train/ and test/ subdirectories, or
  else an 80/20 split shuffled by RandomState(random_seed).  With
  is_train=False an item is the whole video, [T,H,W,3] float32 in [0,1].
  With is_train=True, identity sampling picks a random clip of an identity
  (``name + "*"`` globbed) and an item is two random frames (sorted, with
  replacement): with on_device_aug, the two raw uint8 frames of a PNG
  directory (the step augments them on the device); otherwise the two
  float frames and their copies through the CPU augmentation
  (data/augmentation.py).  Every draw is from numpy's global RNG (and
  Python's ``random`` in the augmentation) in the JAX package's order, so
  seeded items are equal bit for bit.
- DatasetRepeater: the I/O amortization wrapper.
- PairedDataset: animation pairs from a random index grid
  (RandomState(seed)), or from the dataset's pairs CSV (columns ``source``,
  ``driving``), read with the csv module: rows whose two names are both
  videos of the split, in file order, as pandas' isin filter keeps them.

Frames and videos go through the port's own readers (data/image_io.py):
PNG frames through read_png, other frame files through read_image, .gif
videos through read_gif (PIL's decoders, as imageio reads them), .mp4
videos through read_mp4 (cv2's FFmpeg backend): the card's machine has no
imageio, which the JAX package reads them with.
"""
from __future__ import annotations

import csv
import glob
import os
from typing import Optional

import numpy as np

from facevae_tpu_torch.data.image_io import (PNG_SIGNATURE, read_gif, read_image, read_mp4,
                                             read_png, to_rgb)


def _imread_raw(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        png = fh.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    return to_rgb(read_png(path) if png else read_image(path))


def _imread_float(path: str) -> np.ndarray:
    img = _imread_raw(path)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def read_video(name: str, frame_shape=(256, 256, 3)) -> np.ndarray:
    """Read a video: PNG-frame dir, .mp4 or .gif (reference dataset.py:13-34)."""
    if os.path.isdir(name):
        frames = sorted(os.listdir(name))
        return np.stack([_imread_float(os.path.join(name, f)) for f in frames])
    if name.lower().endswith((".gif", ".mp4")):
        video = read_gif(name) if name.lower().endswith(".gif") else read_mp4(name)
        return video.astype(np.float32) / 255.0
    raise ValueError(f"Unknown file extension: {name}")


_DEFAULT_AUG = {
    "rotation_param": {"degrees": 30},
    "perspective_param": {"pers_num": 30, "enlarge_num": 40},
    "jitter_param": {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0.1},
}


class FramesDataset:
    def __init__(self, root_dir: str, frame_shape=(256, 256, 3), id_sampling: bool = True,
                 is_train: bool = True, random_seed: int = 0, pairs_list=None,
                 augmentation_params: Optional[dict] = None,
                 on_device_aug: bool = False):
        self.on_device_aug = on_device_aug
        self.root_dir = root_dir
        self.frame_shape = tuple(frame_shape)
        self.pairs_list = pairs_list
        self.id_sampling = id_sampling
        videos = sorted(os.listdir(root_dir))

        if os.path.exists(os.path.join(root_dir, "train")):
            assert os.path.exists(os.path.join(root_dir, "test")), "train/ without test/"
            if id_sampling:
                train_videos = sorted({os.path.basename(v).split("#")[0]
                                       for v in os.listdir(os.path.join(root_dir, "train"))})
            else:
                train_videos = sorted(os.listdir(os.path.join(root_dir, "train")))
            test_videos = sorted(os.listdir(os.path.join(root_dir, "test")))
            self.root_dir = os.path.join(root_dir, "train" if is_train else "test")
        else:
            rng = np.random.RandomState(random_seed)
            videos = list(videos)
            rng.shuffle(videos)
            n_test = max(1, int(0.2 * len(videos)))
            test_videos, train_videos = videos[:n_test], videos[n_test:]

        self.videos = train_videos if is_train else test_videos
        self.is_train = is_train
        if is_train:
            # imported here: evaluation needs neither cv2 nor PIL's jitter
            from facevae_tpu_torch.data.augmentation import AllAugmentationTransform
            params = _DEFAULT_AUG if augmentation_params is None else augmentation_params
            self.transform = AllAugmentationTransform(**params)
        else:
            self.transform = None

    def __len__(self):
        return len(self.videos)

    def _resolve_path(self, idx: int) -> str:
        name = self.videos[idx]
        if self.is_train and self.id_sampling:
            candidates = (glob.glob(os.path.join(self.root_dir, name + "*.mp4"))
                          or glob.glob(os.path.join(self.root_dir, name + "*")))
            return np.random.choice(candidates)
        return os.path.join(self.root_dir, name)

    def __getitem__(self, idx: int):
        path = self._resolve_path(idx)
        if self.is_train and self.on_device_aug and os.path.isdir(path):
            # two raw uint8 frames, no CPU transform, no float cast
            frames = sorted(os.listdir(path))
            frame_idx = np.sort(np.random.choice(len(frames), replace=True, size=2))
            a = _imread_raw(os.path.join(path, frames[frame_idx[0]]))
            b = _imread_raw(os.path.join(path, frames[frame_idx[1]]))
            return np.ascontiguousarray(a), np.ascontiguousarray(b)
        if self.is_train and os.path.isdir(path):
            frames = sorted(os.listdir(path))
            frame_idx = np.sort(np.random.choice(len(frames), replace=True, size=2))
            video = [_imread_float(os.path.join(path, frames[i])) for i in frame_idx]
        else:
            video = read_video(path, self.frame_shape)
            if self.is_train:
                frame_idx = np.sort(np.random.choice(len(video), replace=True, size=2))
                video = [video[i] for i in frame_idx]

        if self.is_train:
            source = np.asarray(video[0], np.float32)
            driving = np.asarray(video[1], np.float32)
            if self.on_device_aug:        # mp4/gif source: frames are float
                return source, driving    # already; aug still runs on device
            if self.transform is not None:
                source_aug = np.asarray(self.transform([video[0]])[0], np.float32)
                driving_aug = np.asarray(self.transform([video[1]])[0], np.float32)
            else:
                source_aug, driving_aug = source, driving
            return source, driving, source_aug, driving_aug
        return np.asarray(video, np.float32)         # [T,H,W,3] for eval


class DatasetRepeater:
    """I/O amortization (reference dataset.py:138-151)."""

    def __init__(self, dataset, num_repeats: int = 75):
        self.dataset = dataset
        self.num_repeats = num_repeats

    def __len__(self):
        return self.num_repeats * len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]


def _csv_names(rows, column):
    """A CSV column as pandas.read_csv reads it, for isin against names: a
    column of numbers only is numeric there and matches no name (None); an
    empty field is NaN and matches nothing (None)."""
    values = [r[column] or None for r in rows]

    def number(v):
        try:
            float(v)
        except (TypeError, ValueError):
            return False
        return True

    if all(v is None or number(v) for v in values):
        return [None] * len(values)
    return values


class PairedDataset:
    """Animation pairs from a CSV or a random index grid
    (reference dataset.py:154-193)."""

    def __init__(self, initial_dataset: FramesDataset, number_of_pairs: int, seed: int = 0):
        self.initial_dataset = initial_dataset
        pairs_list = initial_dataset.pairs_list
        rng = np.random.RandomState(seed)
        if pairs_list is None:
            max_idx = min(number_of_pairs, len(initial_dataset))
            xy = np.mgrid[:max_idx, :max_idx].reshape(2, -1).T
            number_of_pairs = min(xy.shape[0], number_of_pairs)
            self.pairs = xy[rng.choice(xy.shape[0], number_of_pairs, replace=False)]
        else:
            videos = initial_dataset.videos
            name_to_index = {name: i for i, name in enumerate(videos)}
            with open(pairs_list, newline="") as fh:
                reader = csv.DictReader(fh)
                rows = list(reader)
            missing = [c for c in ("source", "driving") if c not in (reader.fieldnames or ())]
            if missing:
                raise KeyError(f"{pairs_list} has no column {missing[0]!r}")
            kept = [(d, s) for s, d in zip(_csv_names(rows, "source"), _csv_names(rows, "driving"))
                    if s in name_to_index and d in name_to_index]
            self.pairs = [(name_to_index[d], name_to_index[s])
                          for d, s in kept[:number_of_pairs]]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        driving_idx, source_idx = self.pairs[idx]
        return {"driving_video": self.initial_dataset[driving_idx],
                "source_video": self.initial_dataset[source_idx]}
