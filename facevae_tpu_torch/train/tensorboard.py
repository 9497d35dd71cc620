"""The port's TensorBoard event files: what tensorboardX's SummaryWriter
writes for the three calls the training loop makes (add_scalars,
add_image, add_text), with neither tensorboardX nor google.protobuf (the
card's machine has no tensorboardX; the encoding is a few fields, written
here by hand).

- Layout: SummaryWriter(logdir=None, comment="") writes into
  runs/<%b%d_%H-%M-%S>_<hostname><comment> (tensorboardX's default); that
  writer, and each add_scalars key's own writer in
  <logdir>/<main_tag>/<key> (tensorboardX 2.6's layout), opens one file,
  events.out.tfevents.<the first 10 characters of time.time()>.<hostname>,
  whose first record is an Event with file_version "brain.Event:2".
- Framing (TFRecord): the length as uint64 LE, the masked CRC-32C of those
  8 bytes, the data, the masked CRC-32C of the data.  CRC-32C (Castagnoli)
  is table-driven, over 1 KiB lanes at once with numpy (an image record is
  megabytes, too many for a loop over bytes in Python).
- Encoding: Event {wall_time 1 double, step 2 int64, file_version 3,
  summary 5}; Summary {value 1}; Summary.Value {tag 1, simple_value 2
  float, image 4, tensor 8, metadata 9}; Summary.Image {height 1, width 2,
  colorspace 3, encoded_image_string 4}; SummaryMetadata {plugin_data 1
  {plugin_name 1}}; TensorProto {dtype 1, tensor_shape 2 {dim 2 {size 1}},
  string_val 8}.  Fields in number order; proto3 defaults (0, "") left
  out, a oneof member always written, as protobuf's serializer does.
- add_scalars: the value under the tag main_tag in each key's writer.
- add_image: tensorboardX's scaling (a float image times 255, cast to
  uint8 by truncation; clipped to [0, 255] first here, where tensorboardX's
  cast leaves an out-of-range value to numpy), grey repeated to RGB, PNG
  by data/image_io.encode_png (other bytes than PIL's encoder, the same
  pixels), height, width and colorspace 3.
- add_text: the tag "<tag>/text_summary", a DT_STRING tensor of shape [1],
  the text plugin's metadata.
- Each record is flushed as it is written (tensorboardX flushes every
  120 s: the files' content is the same).

read_events(path) reads these records back, each CRC checked: a list of
dicts (the card's machine has no tensorboard to read them with).
"""
from __future__ import annotations

import functools
import os
import re
import socket
import struct
import time
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np

from facevae_tpu_torch.data.image_io import encode_png

FILE_VERSION = "brain.Event:2"
DT_STRING = 7
TEXT_PLUGIN = "text"

# ------------------------------------------------------------------ CRC-32C

_POLY = 0x82F63B78                 # Castagnoli, reflected
_LANE = 1024                       # bytes a lane of the vectorized pass


def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1).astype(np.uint32)
    return t


_TABLE = _crc_table()
_TABLE_INTS = tuple(int(v) for v in _TABLE)


def _registers(reg: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The CRC register of each lane after its bytes: reg [K], rows [L, K]
    (lane k's j-th byte at rows[j, k]); no initial or final inversion."""
    for row in rows:
        reg = _TABLE[(reg ^ row) & 0xFF] ^ (reg >> 8)
    return reg


@functools.lru_cache(maxsize=1)
def _lane_shift():
    """The register map of _LANE zero bytes, a linear map over GF(2),
    byte-sliced: four tables of 256 entries."""
    basis = np.arange(256, dtype=np.uint32)[None, :] << (8 * np.arange(4, dtype=np.uint32)[:, None])
    out = _registers(basis.reshape(-1), np.zeros((_LANE, 1024), np.uint8))
    return tuple(tuple(int(v) for v in out[256 * i:256 * (i + 1)]) for i in range(4))


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data``.  The register update is linear in (register,
    byte), so a run of bytes B after a register r gives Z_B(r) ^ R(0, B):
    whole lanes are run from 0 side by side, then folded in order through
    the shift Z of a lane."""
    buf = np.frombuffer(bytes(data), np.uint8)
    n = len(buf) // _LANE
    reg = 0xFFFFFFFF
    if n > 1:
        lanes = _registers(np.zeros(n, np.uint32),
                           np.ascontiguousarray(buf[:n * _LANE].reshape(n, _LANE).T))
        z0, z1, z2, z3 = _lane_shift()
        for r in lanes.tolist():
            reg = (z0[reg & 0xFF] ^ z1[(reg >> 8) & 0xFF] ^ z2[(reg >> 16) & 0xFF]
                   ^ z3[reg >> 24] ^ r)
        buf = buf[n * _LANE:]
    t = _TABLE_INTS
    for b in buf.tolist():
        reg = t[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    x = crc32c(data)
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# ------------------------------------------------------ protobuf, by hand

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1             # int64 as protobuf writes it: two's complement
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire) + payload


def _int(number: int, value: int) -> bytes:
    return _field(number, 0, _varint(value)) if value else b""


def _bytes(number: int, value: bytes) -> bytes:
    return _field(number, 2, _varint(len(value)) + value)


def _event(wall_time: float, step: Optional[int], body: bytes) -> bytes:
    """An Event: wall_time, step, then ``body`` (file_version or summary)."""
    out = _field(1, 1, struct.pack("<d", wall_time)) if wall_time else b""
    return out + _int(2, int(step or 0)) + body


def _summary(tag: str, body: bytes) -> bytes:
    """Event.summary holding one Summary.Value: tag, then ``body``."""
    return _bytes(5, _bytes(1, _bytes(1, tag.encode()) + body))


_INVALID_TAG = re.compile(r"[^-/\w\.]")


def _clean_tag(name: str) -> str:
    """tensorboardX's tag cleaning: characters outside [-/\\w.] become _, no
    leading slash."""
    return _INVALID_TAG.sub("_", name).lstrip("/")


def _hwc(img, dataformats: str) -> np.ndarray:
    img = np.asarray(img)
    fmt = dataformats.upper()
    if sorted(fmt) not in (sorted("HWC"), sorted("HW")) or img.ndim != len(fmt):
        raise ValueError(f"add_image takes an image of format HWC, CHW or HW matching its "
                         f"shape, got {dataformats!r} for {img.shape}")
    if fmt.find("C") < 0:
        img = np.stack([img.transpose([fmt.find(c) for c in "HW"])] * 3, -1)
    else:
        img = img.transpose([fmt.find(c) for c in "HWC"])
    if img.shape[2] == 1:
        img = np.concatenate([img] * 3, 2)
    if img.shape[2] != 3:
        raise ValueError(f"add_image writes grey or RGB images, got {img.shape[2]} channels")
    return img


class _EventFile:
    """One events.out.tfevents file in ``logdir``, opened with its
    file_version record; every record flushed as it is written."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"events.out.tfevents.{str(time.time())[:10]}."
                                         f"{socket.gethostname()}")
        self._fh = open(self.path, "wb")
        self.write(_event(time.time(), None, _bytes(3, FILE_VERSION.encode())))

    def write(self, event: bytes) -> None:
        self._fh.write(frame_record(event))
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class SummaryWriter:
    """tensorboardX's SummaryWriter for add_scalars, add_image and
    add_text (the module's docstring says what it writes)."""

    def __init__(self, logdir: Optional[str] = None, comment: str = ""):
        if not logdir:
            logdir = os.path.join("runs", datetime.now().strftime("%b%d_%H-%M-%S") + "_"
                                  + socket.gethostname() + comment)
        self.logdir = logdir
        self._main = _EventFile(logdir)
        self._scalars: Dict[str, _EventFile] = {}

    def add_scalars(self, main_tag: str, tag_scalar_dict: Dict[str, float],
                    global_step: Optional[int] = None, walltime: Optional[float] = None):
        walltime = time.time() if walltime is None else walltime
        for tag, value in tag_scalar_dict.items():
            path = os.path.join(self.logdir, main_tag, tag)
            if path not in self._scalars:
                self._scalars[path] = _EventFile(path)
            self._scalars[path].write(_event(walltime, global_step, _summary(
                _clean_tag(main_tag), _field(2, 5, struct.pack("<f", float(value))))))

    def add_image(self, tag: str, img_tensor, global_step: Optional[int] = None,
                  walltime: Optional[float] = None, dataformats: str = "CHW"):
        img = _hwc(img_tensor, dataformats)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        h, w, c = img.shape
        image = _int(1, h) + _int(2, w) + _int(3, c) + _bytes(4, encode_png(img))
        self._main.write(_event(time.time() if walltime is None else walltime, global_step,
                                _summary(_clean_tag(tag), _bytes(4, image))))

    def add_text(self, tag: str, text_string: str, global_step: Optional[int] = None,
                 walltime: Optional[float] = None):
        tensor = (_int(1, DT_STRING) + _bytes(2, _bytes(2, _int(1, 1)))
                  + _bytes(8, text_string.encode("utf-8")))
        metadata = _bytes(1, _bytes(1, TEXT_PLUGIN.encode()))
        self._main.write(_event(time.time() if walltime is None else walltime, global_step,
                                _summary(tag + "/text_summary",
                                         _bytes(8, tensor) + _bytes(9, metadata))))

    def flush(self) -> None:
        """Every record is on disk when its call returns; kept for
        tensorboardX's interface."""

    def close(self) -> None:
        for f in [self._main, *self._scalars.values()]:
            f.close()


# ----------------------------------------------------------------- reading

def _read_varint(data: bytes, pos: int):
    value = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def _fields(data: bytes) -> Dict[int, list]:
    """A message's fields: number -> [int (varint), or bytes (the rest)]."""
    out: Dict[int, list] = {}
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, pos = data[pos:pos + size], pos + size
        elif wire == 2:
            size, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + size], pos + size
        else:
            raise ValueError(f"wire type {wire} of field {number}")
        if pos > len(data):
            raise ValueError(f"field {number} runs past its message")
        out.setdefault(number, []).append(value)
    return out


def _one(fields, number, default=None):
    return fields[number][-1] if number in fields else default


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _value(data: bytes) -> dict:
    f = _fields(data)
    out = {"tag": _one(f, 1, b"").decode()}
    if 2 in f:
        out["simple_value"] = struct.unpack("<f", _one(f, 2))[0]
    if 4 in f:
        im = _fields(_one(f, 4))
        out["image"] = {"height": _one(im, 1, 0), "width": _one(im, 2, 0),
                        "colorspace": _one(im, 3, 0), "encoded_image_string": _one(im, 4, b"")}
    if 8 in f:
        t = _fields(_one(f, 8))
        shape = [_signed(_one(_fields(d), 1, 0)) for d in _fields(_one(t, 2, b"")).get(2, [])]
        out["tensor"] = {"dtype": _one(t, 1, 0), "shape": shape, "string_val": t.get(8, [])}
    if 9 in f:
        plugin = _fields(_one(_fields(_one(f, 9)), 1, b""))
        out["metadata"] = {"plugin_name": _one(plugin, 1, b"").decode(),
                           "content": _one(plugin, 2, b"")}
    return out


def read_events(path: str) -> List[dict]:
    """The records of an event file, each CRC checked: dicts with
    wall_time, step, and file_version or summary (a list of values: tag and
    simple_value, image or tensor, and metadata where present)."""
    with open(path, "rb") as fh:
        data = fh.read()
    events, pos = [], 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {pos}")
        header = data[pos:pos + 8]
        (length,), (crc,) = struct.unpack("<Q", header), struct.unpack("<I", data[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: the length's CRC fails at byte {pos}")
        body = data[pos + 12:pos + 12 + length]
        if len(body) != length or pos + 16 + length > len(data):
            raise ValueError(f"{path}: truncated record at byte {pos}")
        (crc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
        if crc != masked_crc32c(body):
            raise ValueError(f"{path}: the data's CRC fails at byte {pos}")
        pos += 16 + length
        f = _fields(body)
        event = {"wall_time": struct.unpack("<d", _one(f, 1, bytes(8)))[0],
                 "step": _signed(_one(f, 2, 0))}
        if 3 in f:
            event["file_version"] = _one(f, 3).decode()
        if 5 in f:
            event["summary"] = [_value(v) for v in _fields(_one(f, 5)).get(1, [])]
        events.append(event)
    return events
