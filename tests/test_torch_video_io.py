"""PyTorch port: its own readers of non-PNG frames and of .gif / .mp4 videos
(facevae_tpu_torch/data/image_io.py: read_image, read_gif, read_mp4) and
the frame dataset over them, against the JAX package's imageio readers
(facevae_tpu/data/dataset.py), on the CPU.

- read_image (through the dataset's _imread_raw) equals the JAX package's
  _imread_raw bit for bit: JPEG at 4:2:0 and 4:4:4, BMP, greyscale,
  palette and RGBA TIFF (imageio decodes JPEG and BMP through PIL, TIFF
  through its tifffile plugin, which keeps a palette's indices; read_image
  also keeps imageio.v2.imread's dtype and channels).
- read_gif (through read_video) equals the JAX package's read_video bit for
  bit: the port's write_gif, a PIL-quantized RGB GIF, a greyscale one, a
  single frame, and a hand-built GIF whose later frames are smaller than
  the canvas (disposal 1 and 2).  A GIF with transparency decodes to an
  RGB first frame and RGBA later ones: the JAX reader cannot stack them
  and raises; the port drops the alpha of each of imageio's frames.
- read_mp4 on an mp4v file that cv2 writes here: the frame count, the RGB
  order (a red frame reads red), a mean |difference| of at most
  MP4_LEVELS levels from the frames written (lossy MPEG-4).  There is no
  JAX reference: imageio reads .mp4 through imageio-ffmpeg, which is not
  installed.  Without cv2's FFmpeg backend, or on a file it cannot open,
  it raises and says so.
- FramesDataset items over a .gif tree, port and JAX package from the same
  numpy and random seeds, bit for bit: training with on_device_aug true
  (float frames) and false (with the CPU augmentation), and the test split;
  the device frame cache refuses the tree, as the JAX package's does.
"""
import os
import random
import struct

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import GifImagePlugin, Image

from facevae_tpu.data import dataset as jax_dataset
from facevae_tpu_torch.data import dataset
from facevae_tpu_torch.data.device_cache import DeviceFrameCache
from facevae_tpu_torch.data.image_io import (PALETTE, _lzw, palette_indices, read_gif,
                                             read_image, read_mp4, to_rgb, write_gif)
from facevae_tpu_torch.data.synthetic import smooth_frames

# mean |decoded - written| in levels of 255, mp4v at cv2's default quality
# (3.15 on the test's 64x64 frames)
MP4_LEVELS = 6.0


@pytest.fixture(autouse=True)
def default_gif_strategy(monkeypatch):
    """imageio.v2.imread of a GIF sets PIL's GIF loading strategy for the
    whole process; mimread (the JAX package's read_video) and the port read
    under whatever is set.  Hold both to PIL's default here."""
    monkeypatch.setattr(GifImagePlugin, "LOADING_STRATEGY",
                        GifImagePlugin.LoadingStrategy.RGB_AFTER_FIRST)


def _rgb(rs, h=24, w=32):
    return (rs.rand(h, w, 3) * 255).astype(np.uint8)


def _save_image(kind, path, rs):
    img = Image.fromarray(_rgb(rs))
    if kind == "jpeg-420":
        img.save(path, "JPEG", quality=90, subsampling=2)
    elif kind == "jpeg-444":
        img.save(path, "JPEG", quality=95, subsampling=0)
    elif kind == "bmp":
        img.save(path, "BMP")
    elif kind == "grey":
        img.convert("L").save(path, "JPEG", quality=90)
    elif kind == "palette-tiff":
        img.quantize(16).save(path, "TIFF")
    else:
        a = np.concatenate([_rgb(rs), (rs.rand(24, 32, 1) * 255).astype(np.uint8)], -1)
        Image.fromarray(a, "RGBA").save(path, "TIFF")


@pytest.mark.parametrize("kind", ["jpeg-420", "jpeg-444", "bmp", "grey", "palette-tiff",
                                  "rgba-tiff"])
def test_read_image_equals_the_jax_reader(tmp_path, kind):
    ext = "bmp" if kind == "bmp" else "tif" if kind.endswith("tiff") else "jpg"
    path = str(tmp_path / f"frame.{ext}")
    _save_image(kind, path, np.random.RandomState(len(kind)))
    ref = imageio.imread(path)
    got = read_image(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref)
    port, jax_raw = dataset._imread_raw(path), jax_dataset._imread_raw(path)
    assert port.shape == jax_raw.shape and port.shape[-1] == 3
    assert port.dtype == jax_raw.dtype and np.array_equal(port, jax_raw)
    assert np.array_equal(dataset._imread_float(path), jax_dataset._imread_float(path))


def _gce(disposal, transparent=None):
    """A graphic control extension: disposal method, no delay."""
    return b"\x21\xf9\x04" + struct.pack("<BHB", (disposal << 2) | (transparent is not None),
                                         0, transparent or 0) + b"\x00"


def _hand_gif(path, canvas, patches):
    """A GIF89a over the port's 3-3-2 palette: a full first frame ``canvas``,
    then (x, y, frame, disposal) frames smaller than the canvas."""
    h, w = canvas.shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), PALETTE.tobytes()]
    for x, y, frame, disposal in [(0, 0, canvas, 1)] + patches:
        fh, fw = frame.shape[:2]
        data = _lzw(palette_indices(frame).tobytes())
        out += [_gce(disposal), b"\x2c" + struct.pack("<HHHHB", x, y, fw, fh, 0) + b"\x08"]
        out += [bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)]
        out.append(b"\x00")
    with open(path, "wb") as fh:
        fh.write(b"".join(out + [b"\x3b"]))


def _gifs(tmp_path, rs):
    """name -> path of each GIF case (transparency last)."""
    paths = {k: str(tmp_path / f"{k}.gif") for k in
             ("port", "pil-rgb", "grey", "single", "smaller", "transparency")}
    write_gif(paths["port"], [_rgb(rs) for _ in range(3)])
    frames = [Image.fromarray(_rgb(rs)) for _ in range(3)]
    frames[0].save(paths["pil-rgb"], save_all=True, append_images=frames[1:])
    grey = [Image.fromarray(_rgb(rs)).convert("L") for _ in range(3)]
    grey[0].save(paths["grey"], save_all=True, append_images=grey[1:])
    Image.fromarray(_rgb(rs)).save(paths["single"])
    _hand_gif(paths["smaller"], _rgb(rs), [(5, 3, _rgb(rs, 6, 10), 2), (12, 9, _rgb(rs, 8, 7), 1),
                                           (0, 20, _rgb(rs, 4, 32), 1)])
    pal = [Image.fromarray((rs.rand(24, 32) * 200).astype(np.uint8)).convert("P")
           for _ in range(3)]
    for p in pal:
        p.putpalette(list((rs.rand(768) * 255).astype(np.uint8)))
    pal[0].save(paths["transparency"], save_all=True, append_images=pal[1:], transparency=0,
                disposal=2)
    return paths


def test_read_gif_equals_the_jax_reader(tmp_path):
    paths = _gifs(tmp_path, np.random.RandomState(5))
    for name, path in paths.items():
        got = dataset.read_video(path)
        assert got.dtype == np.float32 and got.ndim == 4 and got.shape[-1] == 3, name
        assert np.array_equal(read_gif(path).astype(np.float32) / 255.0, got), name
        frames = imageio.mimread(path, memtest=False)
        if name == "transparency":
            assert [f.shape[-1] for f in frames] == [3, 4, 4]
            with pytest.raises(ValueError):
                jax_dataset.read_video(path)
            ref = np.stack([to_rgb(f) for f in frames]).astype(np.float32) / 255.0
        else:
            ref = jax_dataset.read_video(path)
        assert got.shape == ref.shape and np.array_equal(got, ref), name
    assert len(read_gif(paths["smaller"])) == 4 and len(read_gif(paths["single"])) == 1


def _write_mp4(path, frames, fourcc="mp4v"):
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25, frames[0].shape[1::-1])
    assert out.isOpened(), f"cv2 cannot encode {fourcc} here"
    try:
        for f in frames:
            out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        out.release()


def test_read_mp4_frames_and_channel_order(tmp_path):
    frames = smooth_frames(5, 64, 3)
    red = np.zeros((64, 64, 3), np.uint8)
    red[..., 0] = 255
    path = str(tmp_path / "clip.mp4")
    _write_mp4(path, frames + [red])
    got = read_mp4(path)
    assert got.dtype == np.uint8 and got.shape == (6, 64, 64, 3)
    r, g, b = got[-1].reshape(-1, 3).mean(0)
    assert r > 200 and g < 50 and b < 50, (r, g, b)
    levels = np.abs(got[:-1].astype(np.float64) - np.stack(frames)).mean()
    assert levels <= MP4_LEVELS, levels
    video = dataset.read_video(path)
    assert video.dtype == np.float32 and np.array_equal(video, got.astype(np.float32) / 255.0)


def test_read_mp4_needs_cv2s_ffmpeg_backend(tmp_path, monkeypatch):
    path = str(tmp_path / "clip.mp4")
    _write_mp4(path, smooth_frames(2, 32, 4))
    broken = tmp_path / "broken.mp4"
    broken.write_bytes(b"\x00\x00\x00\x18ftypmp42" + bytes(64))
    with pytest.raises(RuntimeError, match="FFmpeg backend cannot open|decoded no frame"):
        read_mp4(str(broken))
    streams = [b for b in cv2.videoio_registry.getStreamBackends() if b != cv2.CAP_FFMPEG]
    monkeypatch.setattr(cv2.videoio_registry, "getStreamBackends", lambda: streams)
    with pytest.raises(RuntimeError, match="needs cv2's FFmpeg video backend"):
        read_mp4(path)
    with pytest.raises(RuntimeError, match="FFmpeg"):
        dataset.read_video(path)


def test_frames_dataset_items_over_a_gif_tree(tmp_path):
    """Training items (identity sampling over two clips an identity) with
    on_device_aug true and false, and the test split, from the same seeds."""
    rs = np.random.RandomState(8)
    for split, names, n in (("train", ["id0#a", "id0#b", "id1#a", "id1#b"], 4),
                            ("test", ["id2#a", "id3#a"], 5)):
        os.makedirs(tmp_path / split)
        for name in names:
            write_gif(str(tmp_path / split / f"{name}.gif"), [_rgb(rs, 32, 32) for _ in range(n)])
    root = str(tmp_path)
    for on_device in (True, False):
        port = dataset.FramesDataset(root, frame_shape=(32, 32, 3), on_device_aug=on_device)
        ref = jax_dataset.FramesDataset(root, frame_shape=(32, 32, 3), on_device_aug=on_device)
        assert port.videos == ref.videos == ["id0", "id1"]
        for idx in (0, 1, 1, 0):
            items = []
            for ds in (port, ref):
                random.seed(idx + 3)
                np.random.seed(idx + 3)
                items.append(ds[idx])
            assert len(items[0]) == len(items[1]) == (2 if on_device else 4)
            for a, b in zip(*items):
                assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    port = dataset.FramesDataset(root, is_train=False)
    ref = jax_dataset.FramesDataset(root, is_train=False)
    assert port.videos == ref.videos
    for i in range(len(ref)):
        assert np.array_equal(port[i], ref[i]) and port[i].shape == (5, 32, 32, 3)
    with pytest.raises(ValueError, match="PNG-frame dirs only"):
        DeviceFrameCache(root, frame_shape=(32, 32, 3), num_workers=1, device="cpu")
