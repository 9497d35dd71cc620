"""The serving cells' load generator, a process of its own that imports no
torch: closed-loop clients posting raw RGB frames to /drive, all of them
coroutines on one thread (asyncio), so the load comes from one process
with one busy thread.

    python3 -m portbench.drivers.loadgen      (driven by drivers/serve.py)

Standard input: one JSON line (port, seconds, traced, seed, sessions: the
session id of each client, frames: frames per session, frame_bytes,
sample) and then sessions x frames raw frames.  Each client sends its
session's frames in turn from its own offset, one request at a time.  It
prints "ready", waits for a line "go" on standard input, and runs
``seconds`` (the window); a traced run's clients go on until a line "stop"
comes (the slice is taken from that traffic).  Then it prints one JSON
line: every request (session, frame, sent and received times from the
window's start, HTTP status) and, for a sample drawn from the seed of the
requests answered in the window, the answer's bytes in hex.
"""
from __future__ import annotations

import asyncio
import json
import sys
import threading
import time

import numpy as np


async def post(port, path, body):
    """One HTTP/1.0 POST on a connection of its own (the server closes
    each); returns (status, body), status -1 on a failed connection."""
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"POST {path} HTTP/1.0\r\nContent-Type: application/octet-stream\r\n"
                     f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        data = await reader.read(-1)
        writer.close()
        head, _, payload = data.partition(b"\r\n\r\n")
        return int(head.split(b" ", 2)[1]), payload
    except (OSError, ValueError, IndexError):
        return -1, b""


async def client(port, session, bodies, offset, seconds, stop, records, answers, t0):
    n = len(bodies)
    j = 0
    while True:
        sent = time.monotonic() - t0
        if sent >= seconds and stop.is_set():
            return
        k = (offset + j) % n
        j += 1
        status, body = await post(port, f"/drive?session={session}", bodies[k])
        records.append((session, k, sent, time.monotonic() - t0, status))
        answers.append(body if status == 200 else None)


async def run_clients(head, bodies, stop, records, answers):
    frames = head["frames"]
    per_session, tasks = {}, []
    t0 = time.monotonic()
    for s in head["sessions"]:
        offset = per_session.setdefault(s, 0) * frames // max(1, head["sessions"].count(s))
        per_session[s] += 1
        tasks.append(asyncio.ensure_future(client(
            head["port"], s, bodies[s], offset, head["seconds"], stop, records, answers, t0)))
    await asyncio.gather(*tasks)


def main():
    head = json.loads(sys.stdin.buffer.readline())
    n_sess, frames, size = len(set(head["sessions"])), head["frames"], head["frame_bytes"]
    raw = sys.stdin.buffer.read(n_sess * frames * size)
    bodies = {s: [raw[(s * frames + f) * size:(s * frames + f + 1) * size] for f in range(frames)]
              for s in range(n_sess)}
    print("ready", flush=True)
    if sys.stdin.buffer.readline().strip() != b"go":
        sys.exit("loadgen: no go")
    records, answers = [], []
    stop = threading.Event()
    if head["traced"]:
        threading.Thread(target=lambda: (sys.stdin.buffer.readline(), stop.set()),
                         daemon=True).start()
    else:
        stop.set()
    asyncio.run(run_clients(head, bodies, stop, records, answers))
    answered = [i for i, r in enumerate(records) if r[4] == 200 and r[3] <= head["seconds"]]
    rs = np.random.default_rng(head["seed"])
    pick = sorted(rs.choice(answered, size=min(head["sample"], len(answered)), replace=False)
                  .tolist()) if answered else []
    out = {"records": records,
           "sample": [[i, answers[i].hex()] for i in pick]}
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
