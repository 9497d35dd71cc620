"""PyTorch port: its own image I/O (facevae_tpu_torch/data/image_io.py), its
copy of the frame datasets (data/dataset.py) and its server's flags and PNG
bodies, against imageio, facevae_tpu.data.dataset and the root serve.py, on
the CPU.

- read_png equals imageio.v2.imread byte for byte: on files PIL writes
  (colour types 0, 2, 3, 4, 6, with PIL's own choice of row filters, and
  palettes of 1, 2, 4 and 8 bits), and on hand-built files with each row
  filter 0-4 (and hypothesis-drawn sizes, colour types and per-row
  filters).  16-bit and interlaced files raise ValueError.
- write_png round-trips through imageio; write_gif's frames read back
  through imageio as exactly their nearest palette colours (so within half
  a palette step of the input: 255/14 in R and G, 255/6 in B), with the
  same frame delay and loop flags (none) as imageio.mimsave's gif, which the
  JAX package's CLI writes.
- The dataset copy: both split layouts give the JAX package's videos lists
  and [T,H,W,3] items, equal; PairedDataset's pairs with and without a CSV,
  equal; is_train=True raises; .gif videos read the same with imageio
  blocked (the port reads them through PIL).
- The server: every flag of the root server parses on the port's to the
  same value; flush_ms keeps the last FLUSH_MS_KEPT flushes; PNG bodies
  decode through read_png.
"""
import collections
import importlib.util
import os
import random
import struct
import sys
import types
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from PIL import Image

from facevae_tpu.data import dataset as jax_dataset
from facevae_tpu_torch import serve
from facevae_tpu_torch.data import dataset
from facevae_tpu_torch.data.image_io import (PALETTE, palette_indices, read_png, write_gif,
                                             write_png)
from torch_parity import ROOT

pytestmark = pytest.mark.fast
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _filter_row(raw, prior, kind, bpp):
    """PNG filter ``kind`` of one scanline (uint8) given the row above."""
    r, p = raw.astype(np.int32), prior.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) // 2
    else:
        q = a + p - c
        pa, pb, pc = abs(q - a), abs(q - p), abs(q - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) & 255).astype(np.uint8)


def build_png(samples, ctype, filters, depth=8, palette=None, interlace=0):
    """A PNG of ``samples`` [H,W,C] (palette indices for type 3), each row
    filtered with filters[y], packed at ``depth`` bits."""
    h, w = samples.shape[:2]
    if depth < 8:
        bits = np.unpackbits(samples.reshape(h, w, 1).astype(np.uint8), axis=2)[..., 8 - depth:]
        pad = (-w * depth) % 8
        rows = np.packbits(np.concatenate([bits.reshape(h, -1), np.zeros((h, pad), np.uint8)],
                                          axis=1), axis=1)
    else:
        rows = samples.reshape(h, -1).astype(np.uint8)
    bpp = max(1, _CHANNELS[ctype] * depth // 8)
    prior, out = np.zeros(rows.shape[1], np.uint8), []
    for y in range(h):
        out.append(bytes([filters[y]]) + _filter_row(rows[y], prior, filters[y], bpp).tobytes())
        prior = rows[y]
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return data + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b"")


def _same_as_imageio(path):
    ref = imageio.imread(path)
    got = read_png(path)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, np.asarray(ref))
    with open(path, "rb") as fh:
        assert np.array_equal(read_png(fh.read()), got)


def _pil_image(mode, rs, h=37, w=53):
    y, x = np.mgrid[:h, :w]
    smooth = ((x * 5 + y * 3) % 256).astype(np.uint8)
    noisy = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    base = np.where(rs.rand(h, w, 1) < 0.5, smooth[..., None], noisy)
    if mode == "L":
        return Image.fromarray(base[..., 0])
    if mode in ("RGB", "RGBA", "LA"):
        return Image.fromarray(base[..., :len(mode)], mode)
    return Image.fromarray(base[..., :3]).quantize(int(mode[1:]))     # "P<colours>"


@pytest.mark.parametrize("mode", ["L", "RGB", "LA", "RGBA", "P256", "P16", "P4", "P2"])
def test_read_png_matches_imageio_on_pil_files(mode, tmp_path):
    """PIL's files (its own filters, palette bit depths 8, 4, 2, 1)."""
    path = str(tmp_path / f"{mode}.png")
    _pil_image(mode, np.random.RandomState(len(mode))).save(path)
    _same_as_imageio(path)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_read_png_undoes_each_filter(kind, ctype, tmp_path):
    rs = np.random.RandomState(10 * kind + ctype)
    h, w = 9, 13
    palette = rs.randint(0, 256, (200, 3)) if ctype == 3 else None
    samples = (rs.randint(0, 200, (h, w, 1)) if ctype == 3
               else rs.randint(0, 256, (h, w, _CHANNELS[ctype])))
    path = tmp_path / "f.png"
    path.write_bytes(build_png(samples, ctype, [kind] * h, palette=palette))
    _same_as_imageio(str(path))


@settings(max_examples=40, deadline=None, database=None)   # no example files written
@given(h=st.integers(1, 7), w=st.integers(1, 9), ctype=st.sampled_from([0, 2, 3, 4, 6]),
       depth=st.sampled_from([1, 2, 4, 8]), data=st.data(), seed=st.integers(0, 2 ** 31 - 1))
def test_read_png_matches_imageio_on_drawn_files(h, w, ctype, depth, data, seed, tmp_path_factory):
    """Drawn sizes, colour types (sub-8-bit for palettes), per-row filters."""
    depth = depth if ctype == 3 else 8
    filters = data.draw(st.lists(st.integers(0, 4), min_size=h, max_size=h))
    rs = np.random.RandomState(seed)
    colours = min(256, 2 ** depth)
    palette = rs.randint(0, 256, (colours, 3)) if ctype == 3 else None
    samples = (rs.randint(0, colours, (h, w, 1)) if ctype == 3
               else rs.randint(0, 256, (h, w, _CHANNELS[ctype])))
    path = tmp_path_factory.mktemp("drawn") / "d.png"
    path.write_bytes(build_png(samples, ctype, filters, depth, palette))
    _same_as_imageio(str(path))


def test_read_png_refuses_16_bit_and_interlaced(tmp_path):
    rs = np.random.RandomState(5)
    path = str(tmp_path / "g16.png")
    Image.fromarray(rs.randint(0, 65536, (5, 7)).astype(np.uint16)).save(path)
    assert imageio.imread(path).dtype == np.uint16          # a real 16-bit file
    with pytest.raises(ValueError, match="16-bit"):
        read_png(path)
    rgb16 = build_png(rs.randint(0, 256, (3, 4, 6)), 2, [0] * 3)
    rgb16 = rgb16[:8] + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 3, 16, 2, 0, 0, 0)) + rgb16[33:]
    with pytest.raises(ValueError, match="16-bit"):
        read_png(rgb16)
    with pytest.raises(ValueError, match="interlaced"):
        read_png(build_png(rs.randint(0, 256, (4, 4, 3)), 2, [0] * 4, interlace=1))
    with pytest.raises(ValueError, match="CRC"):
        good = build_png(rs.randint(0, 256, (4, 4, 3)), 2, [0] * 4)
        read_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])


def test_write_png_round_trips_through_imageio(tmp_path):
    img = np.random.RandomState(6).randint(0, 256, (17, 29, 3)).astype(np.uint8)
    write_png(str(tmp_path / "w.png"), img)
    assert np.array_equal(imageio.imread(str(tmp_path / "w.png")), img)
    assert np.array_equal(read_png((tmp_path / "w.png").read_bytes()), img)


def test_write_gif_reads_back_through_imageio(tmp_path):
    """Three frames, one of them random at 150x200 (the LZW table fills and
    is cleared many times): each decodes to exactly its palette colours,
    within half a palette step of the input; no delay, no loop, as
    imageio.mimsave's gif."""
    rs = np.random.RandomState(7)
    y, x = np.mgrid[:150, :200]
    frames = [rs.randint(0, 256, (150, 200, 3)).astype(np.uint8),
              np.stack([x % 256, y, (x + y) % 256], -1).astype(np.uint8),
              np.full((150, 200, 3), 131, np.uint8)]
    path = str(tmp_path / "w.gif")
    write_gif(path, frames)
    assert open(path, "rb").read(6) == b"GIF89a"
    back = imageio.mimread(path)
    assert len(back) == len(frames)
    half = np.array([255 / 14, 255 / 14, 255 / 6])
    for f, b in zip(frames, back):
        b = np.asarray(b)[..., :3]
        assert np.array_equal(b, PALETTE[palette_indices(f)])
        assert (np.abs(b.astype(np.int16) - f).max(axis=(0, 1)) <= half).all()
    imageio.mimsave(str(tmp_path / "ref.gif"), frames)
    mine, ref = Image.open(path), Image.open(str(tmp_path / "ref.gif"))
    assert mine.n_frames == ref.n_frames == len(frames)
    assert ({k: v for k, v in mine.info.items() if k != "version"}
            == {k: v for k, v in ref.info.items() if k != "version"})
    assert "duration" not in mine.info and "loop" not in mine.info


# ------------------------------------------------------------ the datasets

def _frames(rs, n, size=24):
    return [rs.randint(0, 256, (size, size, 3)).astype(np.uint8) for _ in range(n)]


@pytest.fixture
def split_root(tmp_path):
    """train/ and test/ subdirectories, PNG frame directories."""
    rs = np.random.RandomState(8)
    for split, names in (("train", ["id1#a", "id1#b", "id2#a"]), ("test", ["id3#a", "id4#b"])):
        for name in names:
            os.makedirs(tmp_path / split / name)
            for t, f in enumerate(_frames(rs, 3)):
                write_png(str(tmp_path / split / name / f"{t:07d}.png"), f)
    return str(tmp_path)


@pytest.fixture
def flat_root(tmp_path):
    """Ten video directories in one root (the 80/20 split), frames written
    by PIL (its own filters), one of them grey."""
    rs = np.random.RandomState(9)
    for i in range(10):
        d = tmp_path / f"vid{i:02d}"
        os.makedirs(d)
        for t, f in enumerate(_frames(rs, 2 + i % 2)):
            Image.fromarray(f[..., 0] if (i, t) == (3, 1) else f).save(str(d / f"{t:03d}.png"))
    return str(tmp_path)


@pytest.mark.parametrize("layout", ["split", "flat"])
@pytest.mark.parametrize("seed", [0, 3])
def test_frames_dataset_matches_the_jax_package(layout, seed, split_root, flat_root):
    root = split_root if layout == "split" else flat_root
    ref = jax_dataset.FramesDataset(root, frame_shape=(24, 24, 3), is_train=False,
                                    random_seed=seed)
    port = dataset.FramesDataset(root, frame_shape=(24, 24, 3), is_train=False,
                                 random_seed=seed)
    assert port.videos == ref.videos and len(port) == len(ref) > 0
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a.dtype == b.dtype == np.float32 and a.ndim == 4 and a.shape[-1] == 3
        assert np.array_equal(a, b)
    rep, jrep = dataset.DatasetRepeater(port, 3), jax_dataset.DatasetRepeater(ref, 3)
    assert len(rep) == len(jrep) and np.array_equal(rep[len(rep) - 1], jrep[len(jrep) - 1])


@pytest.mark.parametrize("number", [1, 2, 4])
def test_paired_dataset_grid_matches_the_jax_package(number, flat_root):
    ref = jax_dataset.PairedDataset(jax_dataset.FramesDataset(flat_root, is_train=False,
                                                              random_seed=1), number)
    port = dataset.PairedDataset(dataset.FramesDataset(flat_root, is_train=False,
                                                       random_seed=1), number)
    assert np.array_equal(np.asarray(port.pairs), np.asarray(ref.pairs))
    a, b = port[len(port) - 1], ref[len(ref) - 1]
    assert all(np.array_equal(a[k], b[k]) for k in ("driving_video", "source_video"))


@pytest.mark.parametrize("rows, number", [
    ([("id3#a", "id4#b"), ("nope", "id3#a"), ("id4#b", "id4#b"), ("id4#b", "id3#a")], 2),
    ([("id3#a", "id4#b"), ("id4#b", ""), ("id4#b", "id3#a")], 5),
    ([("1", "2"), ("3", "4")], 3)])
def test_paired_dataset_csv_matches_the_jax_package(rows, number, split_root, tmp_path):
    """pandas' isin filter and row order: unknown names, an empty field, a
    numeric column (pandas reads numbers, which match no name)."""
    csv_path = tmp_path / "pairs.csv"
    csv_path.write_text("distance,source,driving\n"
                        + "".join(f"{i},{s},{d}\n" for i, (s, d) in enumerate(rows)))
    ref = jax_dataset.PairedDataset(jax_dataset.FramesDataset(
        split_root, is_train=False, pairs_list=str(csv_path)), number)
    port = dataset.PairedDataset(dataset.FramesDataset(
        split_root, is_train=False, pairs_list=str(csv_path)), number)
    assert [tuple(map(int, p)) for p in port.pairs] == [tuple(map(int, p)) for p in ref.pairs]


def test_training_items_and_gif_videos_say_what_they_need(tmp_path, monkeypatch):
    """A tree of .gif videos: the training items (two frames drawn from the
    video, and their CPU-augmented copies) equal the JAX package's from the
    same seeds; read_video matches; with imageio blocked the port reads
    the same frames and items (it needs only PIL)."""
    rs = np.random.RandomState(11)
    for split in ("train", "test"):
        os.makedirs(tmp_path / split)
        write_gif(str(tmp_path / split / "id0#a.gif"), _frames(rs, 3))
    root, gif = str(tmp_path), str(tmp_path / "test" / "id0#a.gif")
    video = jax_dataset.read_video(gif)
    assert np.array_equal(dataset.read_video(gif), video)
    for on_device in (True, False):
        items = []
        for ds in (dataset.FramesDataset(root, on_device_aug=on_device),
                   jax_dataset.FramesDataset(root, on_device_aug=on_device)):
            random.seed(3)
            np.random.seed(3)
            items.append(ds[0])
        assert len(items[0]) == len(items[1]) == (2 if on_device else 4)
        assert all(np.array_equal(a, b) for a, b in zip(*items))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    assert np.array_equal(dataset.read_video(gif), video)
    random.seed(3)
    np.random.seed(3)
    assert all(np.array_equal(a, b) for a, b in zip(dataset.FramesDataset(root)[0], items[1]))


# -------------------------------------------------------------- the server

def _root_serve():
    spec = importlib.util.spec_from_file_location("root_serve", ROOT / "serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_server_takes_every_flag_of_the_jax_server():
    """Each flag of the root server's parse_args, with a value of its
    type, parses on the port's to the same value (--bf16 included)."""
    root = _root_serve()
    values = {bool: "true", int: "3", float: "2.5", str: "somewhere"}
    defaults = vars(root.parse_args([]))
    assert "bf16" in defaults
    for dest, default in defaults.items():
        argv = [f"--{dest}", values[type(default)]]
        assert vars(serve.parse_args(argv))[dest] == vars(root.parse_args(argv))[dest], dest
    assert {k: v for k, v in vars(serve.parse_args([])).items() if k != "device"} == defaults


def test_flush_times_are_bounded(monkeypatch):
    monkeypatch.setattr(serve.BatchedEngine, "FLUSH_MS_KEPT", 4)
    pipe = types.SimpleNamespace(cfg=types.SimpleNamespace(
        model=types.SimpleNamespace(image_size=4)), frontalize_frame=lambda imgs: imgs)
    engine = serve.BatchedEngine(pipe, "cpu", max_batch=2, window_ms=1.0)
    try:
        assert isinstance(engine.flush_ms, collections.deque)
        for _ in range(7):
            assert engine.frontalize(np.zeros((4, 4, 3), np.float32), timeout=30).shape == (4, 4, 3)
        assert len(engine.flush_ms) == 4 and engine.stats["batches"] == 7
        engine.flush_ms.clear()
        assert len(engine.flush_ms) == 0
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P256"])
def test_server_decodes_png_bodies(mode, tmp_path):
    path = str(tmp_path / "b.png")
    _pil_image(mode, np.random.RandomState(12), 16, 16).save(path)
    body = open(path, "rb").read()
    ref = np.asarray(imageio.imread(path))
    ref = np.stack([ref] * 3, -1) if ref.ndim == 2 else ref[..., :3]
    out = serve._decode_image(body, 16)
    assert out.dtype == np.float32 and np.array_equal(out, ref.astype(np.float32) / 255.0)
    with pytest.raises(ValueError, match="expected 8x8"):
        serve._decode_image(body, 8)
    with pytest.raises(ValueError, match="raw RGB or a PNG"):
        serve._decode_image(b"GIF89a" + bytes(10), 16)
    assert torch.equal(torch.from_numpy(serve._decode_image(bytes(16 * 16 * 3), 16)),
                       torch.zeros(16, 16, 3))
