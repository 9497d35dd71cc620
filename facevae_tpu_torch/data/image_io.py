"""The port's image I/O: the card's machine has no imageio, through which
facevae_tpu/data/dataset.py reads frames and videos and the root
evaluate.py writes gifs (imageio.mimsave).  PIL and cv2 import there
(chip_smoke.py phase 1 prints them).  Each reader returns what imageio.v2,
through its pillow plugin, returns for the same file; imageio reads .mp4
through imageio-ffmpeg, which neither machine has, so read_mp4 decodes
through cv2's FFmpeg backend instead.

- read_png: PNG decoded by PIL's C decoder, as imageio.v2.imread (which
  reads PNG through PIL itself) returns it: uint8 [H,W] (grey) or [H,W,C],
  a palette converted to its palette's mode (RGB), tRNS ignored.  The
  chunks are walked first (CRC checked): 16-bit, grey below 8 bits and
  interlaced (Adam7) files raise ValueError naming the case.  PIL is
  needed: without it this module does not import.
- read_image: any other image file PIL decodes (JPEG, BMP, TIFF, ...), its
  first frame, as imageio.v2.imread returns it: PIL's array in the file's
  own mode (grey [H,W], RGBA [H,W,4], 16-bit grey uint16), no EXIF
  rotation; a palette converted to its palette's mode, as imageio's pillow
  plugin does, but in a TIFF kept as its indices [H,W], as imageio's
  tifffile plugin, which it prefers for TIFF, returns them.
- read_gif: every frame of a GIF through PIL's ImageSequence, as
  imageio.v2.mimread returns them (PIL composites each later frame onto
  the canvas, disposal and frames smaller than the canvas included), each
  through to_rgb: uint8 [T,H,W,3].  Under PIL's default loading strategy a
  GIF with transparency gives an RGB first frame and RGBA later ones,
  which the JAX package's read_video cannot stack; to_rgb per frame drops
  the alpha.
- read_mp4: every frame cv2's FFmpeg backend decodes, BGR converted to
  RGB: uint8 [T,H,W,3].  Without that backend, or with no frame decoded,
  it raises RuntimeError; there is no other decoder to fall back on.
- write_png / encode_png: 8-bit RGB, every row filter 0 (numpy and zlib).
- write_gif: GIF89a with one global 256-colour palette, 3-3-2 bits of
  R, G, B, each pixel mapped to its nearest colour (so every channel lands
  within half a palette step: 255/14 for R and G, 255/6 for B), LZW with
  the code table cleared when it is full (4096 codes).  Like the gif of
  imageio.mimsave that the JAX package's CLI writes, it carries no frame
  delay and no loop extension.
"""
from __future__ import annotations

import io
import struct
import zlib
from typing import Sequence, Union

import numpy as np
from PIL import Image, ImageSequence

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPES = (0, 2, 3, 4, 6)      # grey, RGB, palette, grey + alpha, RGBA


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC checked, up to IEND."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG: chunk {kind!r} of {length} bytes")
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG: no IEND chunk")


def read_png(source: Union[str, bytes, bytearray, memoryview]) -> np.ndarray:
    """A PNG file (a path, or its bytes) as imageio.v2.imread returns it."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
    else:
        with open(source, "rb") as fh:
            data = fh.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
    header = None
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind[0] < 97 and kind not in (b"PLTE", b"IDAT", b"IEND"):
            raise ValueError(f"unsupported critical PNG chunk {kind!r}")
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    _, _, depth, ctype, compression, filtering, interlace = header
    if ctype not in _COLOUR_TYPES or compression or filtering:
        raise ValueError(f"unsupported PNG: colour type {ctype}, compression {compression}, "
                         f"filter method {filtering}")
    if depth == 16:
        raise ValueError("16-bit PNG is not supported (8-bit only)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"{depth}-bit PNG of colour type {ctype} is not supported "
                         "(8-bit, or a 1/2/4-bit palette)")
    with Image.open(io.BytesIO(data)) as im:       # decoded before the file closes
        return _as_imageio(im)


def _as_imageio(im: Image.Image) -> np.ndarray:
    """A PIL frame as imageio's pillow plugin hands it out: a palette image
    converted to its palette's mode (RGB or RGBA), any other mode as it is."""
    if im.mode == "P":
        im = im.convert(im.palette.mode)
    return np.array(im)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded image with grey stacked to 3 channels and alpha dropped."""
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img


def read_image(path: str) -> np.ndarray:
    """An image file other than PNG (its first frame) as imageio.v2.imread
    returns it (the module's docstring says how)."""
    with Image.open(path) as im:
        return np.array(im) if im.format == "TIFF" else _as_imageio(im)


def read_gif(path: str) -> np.ndarray:
    """Every frame of a GIF, uint8 [T,H,W,3] (the module's docstring says
    how)."""
    with Image.open(path) as im:
        if im.format != "GIF":
            raise ValueError(f"{path} is not a GIF (PIL reads it as {im.format})")
        return np.stack([to_rgb(_as_imageio(frame)) for frame in ImageSequence.Iterator(im)])


def read_mp4(path: str) -> np.ndarray:
    """Every frame of an .mp4 through cv2's FFmpeg backend, uint8 [T,H,W,3]
    RGB (the module's docstring says how)."""
    import cv2
    if cv2.CAP_FFMPEG not in cv2.videoio_registry.getStreamBackends():
        raise RuntimeError(f"reading {path} needs cv2's FFmpeg video backend, which this cv2 "
                           f"{cv2.__version__} lacks")
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    frames = []
    try:
        if not cap.isOpened():
            raise RuntimeError(f"cv2's FFmpeg backend cannot open {path}")
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"cv2's FFmpeg backend decoded no frame of {path}")
    return np.stack(frames)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 RGB [H,W,3] as the bytes of an 8-bit RGB PNG (filter 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [H,W,3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 RGB [H,W,3] as an 8-bit RGB PNG (filter 0)."""
    data = encode_png(img)
    with open(path, "wb") as fh:
        fh.write(data)


# the 3-3-2 palette: index (r << 5) | (g << 2) | b, each level spread over 0..255
_LEVELS = (8, 8, 4)
PALETTE = np.stack(np.meshgrid(*[np.round(np.arange(n) * 255.0 / (n - 1)) for n in _LEVELS],
                               indexing="ij"), -1).reshape(256, 3).astype(np.uint8)


def palette_indices(frame: np.ndarray) -> np.ndarray:
    """uint8 RGB [H,W,3] -> the index of each pixel's nearest palette colour
    (the palette is a product of per-channel levels: nearest per channel)."""
    lv = [np.rint(frame[..., i].astype(np.float32) * ((n - 1) / 255.0)).astype(np.uint8)
          for i, n in enumerate(_LEVELS)]
    return (lv[0] << 5) | (lv[1] << 2) | lv[2]


def _lzw(indices: bytes) -> bytes:
    """GIF LZW of 8-bit indices: codes of 9-12 bits, LSB first; a clear code
    first and whenever the table is full; the end code last."""
    clear, end = 256, 257
    out = bytearray()
    acc = nbits = 0
    width, next_code, table = 9, 258, {}

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    emit(clear)
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear)
            width, next_code, table = 9, 258, {}
        prefix = b
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def write_gif(path: str, frames: Sequence[np.ndarray]) -> None:
    """Write uint8 RGB frames [H,W,3], all one shape, as an animated GIF89a
    (the module's docstring says how)."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"write_gif takes uint8 [{h},{w},3] frames, got {f.dtype} "
                             f"{f.shape}")
    # global colour table of 2^(7+1) entries, 8 bits a primary
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), PALETTE.tobytes()]
    for f in frames:
        data = _lzw(palette_indices(f).tobytes())
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
        out += [bytes([len(data[i:i + 255])]) + data[i:i + 255]
                for i in range(0, len(data), 255)]
        out.append(b"\x00")
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
