"""The port's image I/O, in numpy and zlib only: the card's machine has no
imageio, through which facevae_tpu/data/dataset.py reads frames and the
root evaluate.py writes gifs (imageio.mimsave).  PIL, cv2 and pandas do
import there (chip_smoke.py phase 1 prints them); nothing here uses them.

- read_png: non-interlaced PNG of colour types 0 (8-bit grey), 2 (8-bit
  RGB), 3 (palette, 1/2/4/8-bit), 4 (8-bit grey + alpha) and 6 (8-bit
  RGBA), every row filter (None, Sub, Up, Average, Paeth).  It returns what
  imageio.v2.imread returns for the same file: uint8 [H,W] (grey) or
  [H,W,C], the palette expanded to RGB, tRNS ignored.  16-bit, grey below
  8 bits and interlaced (Adam7) files raise ValueError naming the case.
- write_png: 8-bit RGB, every row filter 0.
- write_gif: GIF89a with one global 256-colour palette, 3-3-2 bits of
  R, G, B, each pixel mapped to its nearest colour (so every channel lands
  within half a palette step: 255/14 for R and G, 255/6 for B), LZW with
  the code table cleared when it is full (4096 codes).  Like the gif of
  imageio.mimsave that the JAX package's CLI writes, it carries no frame
  delay and no loop extension.
"""
from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}        # PNG colour type -> samples a pixel


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


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines [height, stride] uint8 with each row's filter undone.
    bpp: bytes a filter unit (a pixel at 8 bits, else 1 byte)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size < height * (stride + 1):
        raise ValueError(f"truncated PNG image data: {rows.size} bytes for {height} rows "
                         f"of {stride + 1}")
    rows = rows[:height * (stride + 1)].reshape(height, stride + 1)
    kinds, f = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    if not np.isin(kinds, (3, 4)).any():
        # None, Sub and Up only: a row at a time, uint8 arithmetic wrapping mod 256
        out = np.empty((height, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        for y in range(height):
            r = f[y]
            if kinds[y] == 1:
                r = np.cumsum(r.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif kinds[y] == 2:
                r = r + prev
            out[y] = r
            prev = out[y]
        return out
    # Average and Paeth read the unit to the left, above and above-left:
    # sweep the anti-diagonals x + y = t.  Skewed, S[y + 1, t + 2] holds row
    # y's unit x = t - y, so anti-diagonal t is a column and its left, up and
    # up-left neighbours are columns t + 1, t + 1 and t of the rows above
    # (zeros stand in for the units left of x = 0 and the row above y = 0).
    units = stride // bpp
    y_all = np.arange(height)[:, None]
    F = np.zeros((height, height + units, bpp), np.int32)
    F[y_all, y_all + np.arange(units)] = f.reshape(height, units, bpp)
    S = np.zeros((height + 1, height + units + 1, bpp), np.int32)
    kinds = kinds.astype(np.int32)[:, None]
    for t in range(height + units - 1):
        y0, y1 = max(0, t - units + 1), min(height - 1, t) + 1
        a, b, c = S[y0 + 1:y1 + 1, t + 1], S[y0:y1, t + 1], S[y0:y1, t]
        k = kinds[y0:y1]
        pred = np.where(k == 4, _paeth(a, b, c),
                        np.where(k == 3, (a + b) >> 1, np.where(k == 2, b, np.where(k == 1, a, 0))))
        S[y0 + 1:y1 + 1, t + 2] = (F[y0:y1, t] + pred) & 255
    return S[1 + y_all, 2 + y_all + np.arange(units)].astype(np.uint8).reshape(height, stride)


def read_png(source: Union[str, bytes, bytearray, memoryview]) -> np.ndarray:
    """A PNG file (a path, or its bytes) as imageio.v2.imread returns it."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
    else:
        with open(source, "rb") as fh:
            data = fh.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind[0] < 97 and kind != b"IEND":   # an unknown critical chunk
            raise ValueError(f"unsupported critical PNG chunk {kind!r}")
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype, compression, filtering, interlace = header
    if ctype not in _CHANNELS or compression or filtering:
        raise ValueError(f"unsupported PNG: colour type {ctype}, compression {compression}, "
                         f"filter method {filtering}")
    if depth == 16:
        raise ValueError("16-bit PNG is not supported (8-bit only)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"{depth}-bit PNG of colour type {ctype} is not supported "
                         "(8-bit, or a 1/2/4-bit palette)")
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride,
                     max(1, channels * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)[:, :width]
        rows = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)
    img = rows.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError(f"PNG palette index {int(img.max())} past its "
                             f"{len(palette)} entries")
        return palette[img[..., 0]]
    return img[..., 0] if channels == 1 else img


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 RGB [H,W,3] as an 8-bit RGB PNG (filter 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [H,W,3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    data = (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
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
