"""A stand-in for the port's InferencePipeline whose batches a test
finishes: its graphs return at once, with an output whose ``.cpu()`` (the
serving engine's readback on the CPU) waits until the test releases that
batch.  So a CPU test holds batches in flight as the card would."""
import threading
import types


class Held:
    """A batch's output: ``.cpu()`` waits for the batch's gate, then gives
    the frames or raises the batch's readback error."""

    def __init__(self, value, gate, error):
        self.value, self.gate, self.error = value, gate, error

    def cpu(self):
        if not self.gate.wait(30):
            raise TimeoutError("the test never released this batch")
        if self.error is not None:
            raise RuntimeError(self.error)
        return self.value


class HeldPipeline:
    """frontalize_frame gives 2 x the frames, drive_frame the frames plus the
    session's source mean.  ``batches`` holds each dispatched batch's frames
    in order; ``release(i)`` lets batch i's readback finish (every batch's,
    with ``released``); batches whose index is in ``fail_dispatch`` or
    ``fail_readback`` raise there."""

    def __init__(self, size=4, released=False):
        self.cfg = types.SimpleNamespace(model=types.SimpleNamespace(image_size=size))
        self.released = released
        self.batches, self.gates = [], []
        self.fail_dispatch, self.fail_readback = set(), set()

    def encode_source(self, s):
        m = s.mean().reshape(1, 1)
        return m, m, m, m

    def drive_frame(self, fs, kp_c, kp_s, Rs, img):
        return self._held(img, img + fs.reshape(-1, 1, 1, 1))

    def frontalize_frame(self, img):
        return self._held(img, img * 2)

    def release(self, i):
        self.gates[i].set()

    def _held(self, imgs, value):
        i = len(self.batches)
        gate = threading.Event()
        if self.released:
            gate.set()
        self.batches.append(imgs.clone())
        self.gates.append(gate)
        if i in self.fail_dispatch:
            raise ValueError(f"batch {i} failed in dispatch")
        return Held(value, gate, f"batch {i} failed in readback" if i in self.fail_readback
                    else None)
