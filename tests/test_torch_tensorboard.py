"""PyTorch port: its own TensorBoard writer (facevae_tpu_torch/train/
tensorboard.py) against tensorboardX's SummaryWriter, and the training CLI
with --tensorboard where neither imageio nor tensorboardX imports (as on
the card's machine), on the CPU.

- CRC-32C and the masked CRC equal tensorboardX's on lengths around the
  writer's 1 KiB lanes.
- The same add_scalars / add_image / add_text calls through tensorboardX
  and through the port, into two directories: the same directories
  relative to the log dir, one event file each, named alike; parsed with
  tensorboard's event_pb2, the same records: file_version first, then the
  tags and steps, the scalars' float32 bits (0.0 and nan included), the
  images' height, width, colorspace and decoded pixels (HWC, CHW, HW and
  a grey channel), the text and its plugin metadata.  The default log dir
  follows tensorboardX's pattern.
- read_events reads tensorboardX's files as it reads the port's, and
  tensorboard's EventAccumulator reads the port's; a flipped byte fails
  the CRC.
- train/cli.main at tiny_config on --device cpu with --tensorboard true
  over a .gif tree and an .mp4 tree, with sys.modules["imageio"] and
  sys.modules["tensorboardX"] set to None: the event files hold every loss
  key of the log at every step index, the image and the log line.
"""
import dataclasses
import io
import os
import re
import socket
import struct
import sys
import types

import cv2
import numpy as np
import pytest
import tensorboardX
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from tensorboard.compat.proto import event_pb2
from tensorboardX.crc32c import crc32c as tbx_crc32c
from tensorboardX.record_writer import masked_crc32c as tbx_masked

from facevae_tpu_torch.data.image_io import write_gif
from facevae_tpu_torch.data.synthetic import smooth_frames
from facevae_tpu_torch.train import cli
from facevae_tpu_torch.train import tensorboard as tb
from torch_parity import one_torch_thread  # noqa: F401


def test_crc32c_matches_tensorboardX():
    rs = np.random.RandomState(0)
    assert tb.crc32c(b"123456789") == 0xE3069283
    for n in (0, 1, 8, 1023, 1024, 2047, 2048, 2049, 5000, 70001):
        data = rs.bytes(n)
        assert tb.crc32c(data) == tbx_crc32c(data), n
        assert tb.masked_crc32c(data) == tbx_masked(data), n


def _calls(writer, rs):
    """The loop's calls (and the other image formats) on ``writer``."""
    losses = [{"P": float(rs.rand()), "K": 0.0, "R": float("nan"), "G1": float(rs.rand())}
              for _ in range(3)]
    for step, row in enumerate(losses):
        writer.add_scalars("loss_all", row, 7 * step)
    writer.add_image("image_show_0", rs.rand(20, 24, 3).astype(np.float32), 3,
                     dataformats="HWC")
    writer.add_image("image_show_1", rs.rand(3, 9, 11), 4)
    writer.add_image("grey", (rs.rand(10, 6) * 255).astype(np.uint8), 5, dataformats="HW")
    writer.add_image("grey_channel", rs.rand(10, 6, 1).astype(np.float32), 6,
                     dataformats="HWC")
    writer.add_text("log", "00000000) P - 0.50000; K - 0.00000 é", 14)
    writer.close()


def _files(root):
    """relative dir -> the event file names in it."""
    return {os.path.relpath(d, root): sorted(f) for d, _, f in os.walk(root) if f}


def _proto_records(path):
    """(what, step, tag, payload) of each record, parsed by tensorboard's
    protobuf classes."""
    with open(path, "rb") as fh:
        data = fh.read()
    out, pos = [], 0
    while pos < len(data):
        (n,) = struct.unpack("<Q", data[pos:pos + 8])
        ev = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
        pos += n + 16
        if ev.HasField("file_version"):
            out.append(("file_version", ev.step, ev.file_version, None))
            continue
        for v in ev.summary.value:
            kind = v.WhichOneof("value")
            if kind == "simple_value":
                payload = struct.pack("<f", v.simple_value)
            elif kind == "image":
                px = np.asarray(Image.open(io.BytesIO(v.image.encoded_image_string)))
                payload = (v.image.height, v.image.width, v.image.colorspace, px.tobytes())
            else:
                payload = (v.tensor.dtype, [d.size for d in v.tensor.tensor_shape.dim],
                           list(v.tensor.string_val), v.metadata.plugin_data.plugin_name,
                           v.metadata.plugin_data.content)
            out.append((kind, ev.step, v.tag, payload))
    return out


def test_event_files_agree_with_tensorboardX(tmp_path, monkeypatch):
    for name, cls in (("tbx", tensorboardX.SummaryWriter), ("port", tb.SummaryWriter)):
        _calls(cls(logdir=str(tmp_path / name)), np.random.RandomState(1))
    ref, port = _files(tmp_path / "tbx"), _files(tmp_path / "port")
    assert sorted(ref) == sorted(port) == [".", "loss_all/G1", "loss_all/K", "loss_all/P",
                                           "loss_all/R"]
    pattern = re.compile(r"events\.out\.tfevents\.\d{10}\." + re.escape(socket.gethostname()))
    for rel in ref:
        assert len(ref[rel]) == len(port[rel]) == 1 and pattern.fullmatch(port[rel][0])
        a = _proto_records(tmp_path / "tbx" / rel / ref[rel][0])
        b = _proto_records(tmp_path / "port" / rel / port[rel][0])
        assert a[0] == b[0] == ("file_version", 0, "brain.Event:2", None)
        assert a == b, rel
    monkeypatch.chdir(tmp_path)
    tb.SummaryWriter(comment="_x").close()
    (logdir,) = os.listdir(tmp_path / "runs")
    assert re.fullmatch(r"[A-Z][a-z]{2}\d{2}_\d{2}-\d{2}-\d{2}_" + re.escape(socket.gethostname())
                        + "_x", logdir)


def test_each_reader_reads_the_other_writers_files(tmp_path, monkeypatch):
    # tensorboard's own stub of the TF file API: importing tensorflow, where
    # it is installed, costs the accumulator ~15 s
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf", types.ModuleType("notf"))
    for name, cls in (("tbx", tensorboardX.SummaryWriter), ("port", tb.SummaryWriter)):
        _calls(cls(logdir=str(tmp_path / name)), np.random.RandomState(2))
    for rel in _files(tmp_path / "port"):
        (a,), (b,) = (_files(tmp_path / n)[rel] for n in ("tbx", "port"))
        ra, rb = (tb.read_events(str(tmp_path / n / rel / f))
                  for n, f in (("tbx", a), ("port", b)))
        drop = lambda evs: [{k: v for k, v in e.items() if k != "wall_time"} for e in evs]  # noqa
        for e in ra + rb:       # nan as its bits; the PNGs' bytes differ, not their pixels
            for v in e.get("summary", []):
                if "simple_value" in v:
                    v["simple_value"] = struct.pack("<f", v["simple_value"])
                if "image" in v:
                    v["image"]["encoded_image_string"] = np.asarray(Image.open(io.BytesIO(
                        v["image"]["encoded_image_string"]))).tobytes()
        assert drop(ra) == drop(rb) and ra[0]["file_version"] == "brain.Event:2"
    main = tb.read_events(str(tmp_path / "port" / _files(tmp_path / "port")["."][0]))
    text = [v for e in main for v in e.get("summary", []) if "tensor" in v]
    assert text == [{"tag": "log/text_summary",
                     "tensor": {"dtype": tb.DT_STRING, "shape": [1], "string_val": [
                         "00000000) P - 0.50000; K - 0.00000 é".encode()]},
                     "metadata": {"plugin_name": "text", "content": b""}}]
    acc = EventAccumulator(str(tmp_path / "port"))
    acc.Reload()
    assert sorted(acc.Tags()["images"]) == ["grey", "grey_channel", "image_show_0",
                                            "image_show_1"]
    assert acc.Images("image_show_0")[0].step == 3 and acc.Images("image_show_0")[0].width == 24
    assert [t.step for t in acc.Tensors("log/text_summary")] == [14]
    scalars = EventAccumulator(str(tmp_path / "port" / "loss_all" / "P"))
    scalars.Reload()
    assert [s.step for s in scalars.Scalars("loss_all")] == [0, 7, 14]


def test_read_events_refuses_a_bad_crc(tmp_path):
    writer = tb.SummaryWriter(logdir=str(tmp_path))
    writer.add_text("log", "x", 1)
    writer.close()
    (name,) = _files(tmp_path)["."]
    path = tmp_path / name
    good = path.read_bytes()
    assert [e["step"] for e in tb.read_events(str(path))] == [0, 1]
    for at, what in ((3, "length"), (len(good) - 6, "data")):
        bad = bytearray(good)
        bad[at] ^= 1
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=f"{what}'s CRC fails"):
            tb.read_events(str(path))
    path.write_bytes(good[:-2])
    with pytest.raises(ValueError, match="truncated"):
        tb.read_events(str(path))


def _video_tree(root, ext):
    """train/ with 2 identities of 1 clip of 3 frames, test/ with one video,
    as .gif (write_gif) or .mp4 (cv2, mp4v) files at 64x64."""
    for split, names in (("train", ["id0#a", "id1#a"]), ("test", ["id2#a"])):
        os.makedirs(os.path.join(root, split))
        for j, name in enumerate(names):
            frames = smooth_frames(3, 64, j + 10 * (split == "test"))
            path = os.path.join(root, split, f"{name}.{ext}")
            if ext == "gif":
                write_gif(path, frames)
                continue
            out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (64, 64))
            try:
                for f in frames:
                    out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            finally:
                out.release()
    return root


@pytest.mark.parametrize("ext", ["gif", "mp4"])
def test_cli_writes_event_files_without_tensorboardX(ext, tmp_path, monkeypatch):
    root = _video_tree(str(tmp_path / "data"), ext)
    monkeypatch.chdir(tmp_path)
    # neither CLI has a flag for it: a record every step
    build = cli.build_config
    monkeypatch.setattr(cli, "build_config", lambda args: dataclasses.replace(
        build(args), train=dataclasses.replace(build(args).train, vis_every=1)))
    for name in ("imageio", "imageio.v2", "tensorboardX"):
        monkeypatch.setitem(sys.modules, name, None)
    state, records = cli.main([
        "--root_dir", root, "--device", "cpu", "--tiny", "true", "--image_size", "64",
        "--batch_size", "2", "--num_repeats", "2", "--num_epochs", "1", "--tensorboard", "true",
        "--ckp_dir", f"{tmp_path}/ckp", "--vis_dir", f"{tmp_path}/vis",
        "--log_file", f"{tmp_path}/log.txt"])
    assert state.step == 2 and [r["frames"] for r in records] == [4]
    keys = sorted(c.split(" - ")[0] for line in (tmp_path / "log.txt").read_text().splitlines()
                  for c in line.split(") ", 1)[1].split("; "))
    (logdir,) = os.listdir(tmp_path / "runs")
    files = _files(tmp_path / "runs" / logdir)
    assert sorted(files) == ["."] + [f"loss_all/{k}" for k in keys]
    for k in keys:
        (name,) = files[f"loss_all/{k}"]
        events = tb.read_events(str(tmp_path / "runs" / logdir / "loss_all" / k / name))
        assert [(e["step"], e["summary"][0]["tag"]) for e in events[1:]] == [
            (0, "loss_all"), (1, "loss_all")], k
    main = tb.read_events(str(tmp_path / "runs" / logdir / files["."][0]))
    tags = [(e["step"], v["tag"]) for e in main[1:] for v in e["summary"]]
    assert tags == [(0, "image_show_0"), (0, "log/text_summary"),
                    (1, "image_show_0"), (1, "log/text_summary")]
    image = main[1]["summary"][0]["image"]
    assert (image["height"], image["width"], image["colorspace"]) == (
        np.asarray(Image.open(io.BytesIO(image["encoded_image_string"]))).shape)
    assert main[2]["summary"][0]["tensor"]["string_val"][0].startswith(b"00000000) ")
    assert sys.modules["tensorboardX"] is None and sys.modules["imageio"] is None
