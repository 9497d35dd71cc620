"""Epoch training loop (port of facevae_tpu/train/loop.py).

Per iteration one train_step (G then D phases, both Adam updates and, by
default, the on-device augmentation inside it); in scan mode
(TrainConfig.steps_per_call K > 1 over the device frame cache, with the
on-device augmentation) one call of train/scan.py's K-step dispatcher per
K steps (a CUDA graph of the step replayed K times on the card).  With a
process group (state.group) every rank runs this loop on its shard of the
data; rank 0 alone prints, logs, visualizes (the whole global batch,
gathered from the ranks once an epoch) and writes epoch files.  The loop's
thread never waits on the card inside an epoch:

  - batches are decoded by the loader's thread pool, then pinned and copied
    to the card by a background thread on a side stream (the reference's
    pin_memory + .cuda(non_blocking), logger.py:142-148); the step's stream
    waits on the copy's event, so the step never reads a half-copied batch;
  - loss scalars stay on the card and are moved to the host by a background
    thread, a group of steps in one transfer (the reference moves every loss
    to the host each step, logger.py:173); its queue is bounded, which also
    bounds how far the host runs ahead of the card;
  - the log line, the visualization and the checkpoint are written at epoch
    boundaries only, the checkpoint by a background thread; with
    TrainConfig.tensorboard, the losses, the visualization and the log line
    every vis_every steps through train/tensorboard.py (tensorboardX's
    files, without tensorboardX), closed when the loop ends.

Each step's draws (augmentation, TPS, VAE eps) come from one
torch.Generator on the card reseeded with train/step.py:step_seed(seed,
step, rank) (seed * 2^32 + step on rank 0), so a resumed run draws what an
uninterrupted one would (the JAX loop folds the step into its key).  On
KeyboardInterrupt or any exception, wherever it is raised in an epoch (the
loader included), the state is saved as the epoch file of state.epoch
before the loop stops or re-raises (quirk q5); an exception raised inside
a step saves the state as that step left it.
"""
from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from facevae_tpu_torch.config import Config
from facevae_tpu_torch.parallel.mesh import is_master, master_only_print
from facevae_tpu_torch.train.checkpoint import AsyncCheckpointer, save_checkpoint
from facevae_tpu_torch.train.logger import ScalarLog, Visualizer, save_visualization
from facevae_tpu_torch.train.state import TrainState
from facevae_tpu_torch.train.step import step_seed, train_step
from facevae_tpu_torch.train.tensorboard import SummaryWriter

_PROFILE_START = 10      # --profile_dir traces steps 10-14 (scan mode: the second call)
_PROFILE_STEPS = 5
_SYNC_EVERY = 8          # steps between metric hand-overs to the fetch thread


def _device_prefetch(loader, device: torch.device, depth: int = 2):
    """Yield the loader's batches as tensors on ``device``.  A background
    thread pins each numpy batch and copies it on a side stream (a batch of
    tensors already on the card, as the frame cache's, is gathered there),
    then records an event; the consumer makes its current stream wait on
    the event and marks the tensors as used by that stream (record_stream),
    so the allocator keeps their memory until the step is done with it."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: List[BaseException] = []
    sentinel = object()
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    if cuda:                                  # e.g. the frame cache's upload
        side.wait_stream(torch.cuda.current_stream(device))

    def to_device(b):
        t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(b))
        if cuda and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                for batch in loader:
                    tensors = tuple(to_device(b) for b in batch)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(side)
                    if not put((tensors, event)):
                        return
        except BaseException as e:            # raised again on the consumer's side
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            tensors, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for x in tensors:
                    x.record_stream(stream)
            yield tensors
    finally:
        stop.set()


class _MetricBuffer:
    """Holds per-step loss dicts (tensors on the card); a worker thread moves
    them to the host and writes them to the ScalarLog.

    ``flush`` hands the pending steps to the worker over a bounded queue
    (blocking only when the worker is _DEPTH groups behind: the bound on
    how far the host runs ahead); the worker takes every group queued so
    far and moves all their losses to the host in ONE transfer; ``drain``
    waits until everything handed over is logged (epoch boundaries, the
    tensorboard writes).  The loop's thread never reads a loss itself."""

    _DEPTH = 4

    def __init__(self, scalar_log: ScalarLog):
        self.scalar_log = scalar_log
        self.pending: list = []
        self.last = None                      # last fetched (g, d) host dicts
        self._q: queue.Queue = queue.Queue(maxsize=self._DEPTH)
        self._err: List[Exception] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def push(self, losses_g: Dict[str, torch.Tensor], losses_d: Dict[str, torch.Tensor]):
        self.pending.append((losses_g, losses_d))

    def flush(self):
        if self._err:
            raise self._err[0]
        if not self.pending:
            return
        self._q.put(self.pending)
        self.pending = []

    def drain(self):
        self.flush()
        self._q.join()
        if self._err:
            raise self._err[0]

    def close(self):
        """End the worker (after what was handed over so far)."""
        self._q.put(None)
        self._worker.join()

    def _run(self):
        while True:
            groups = [self._q.get()]
            while groups[-1] is not None:
                try:
                    groups.append(self._q.get_nowait())
                except queue.Empty:
                    break
            try:
                self._process([p for g in groups if g is not None for p in g])
            except Exception as e:            # raised on the next flush / drain
                self._err.append(e)
            finally:
                for _ in groups:
                    self._q.task_done()
            if groups[-1] is None:            # close()
                return

    def _process(self, group):
        """group: [(losses_g, losses_d)], each loss a scalar or (scan
        mode) a [K] tensor of K steps'."""
        if not group:
            return
        g_names, d_names = list(group[0][0]), list(group[0][1])
        host = torch.cat([torch.stack([g[n].float().reshape(-1) for n in g_names]
                                      + [d[n].float().reshape(-1) for n in d_names], 1)
                          for g, d in group]).cpu().numpy()
        for row in host:
            g_row = {n: float(v) for n, v in zip(g_names, row)}
            d_row = {n: float(v) for n, v in zip(d_names, row[len(g_names):])}
            self.scalar_log.log_iter(g_row, d_row)
            self.last = (g_row, d_row)


def _host_aux(aux: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The vis aux on the host: moved as fp16 (display precision; half the
    transfer), then fp32."""
    return {k: (v.half() if v.is_floating_point() else v).cpu().float().numpy()
            for k, v in aux.items()}


def _visualize(visualizer, s, d, aux):
    s_np, d_np = s.cpu().numpy(), d.cpu().numpy()
    if s_np.dtype == np.uint8:
        s_np = s_np.astype(np.float32) / 255.0
        d_np = d_np.astype(np.float32) / 255.0
    return visualizer.visualize(s_np, d_np, aux["generated_d"], aux["transformed_d"],
                                aux["kp_s"], aux["kp_d"], aux["transformed_kp"],
                                aux["occlusion"], aux["mask"])


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof, device, time.time_ns()


def _union_ns(intervals, lo: int, hi: int) -> int:
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def _stop_profiler(profiler, profile_dir):
    """Stop the trace once the card has run the traced steps; write it (the
    program's spans in it as record_function ranges, tracing.py) and print
    the card's busy share of the window: the union of its operations'
    intervals over the wall time, overlapping kernels counted once."""
    prof, device, t0 = profiler
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.time_ns()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    busy_ms = _union_ns([(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                         if e.device_type() != torch.autograd.DeviceType.CPU
                         and not e.is_user_annotation()], t0, t1) / 1e6
    wall_ms = (t1 - t0) / 1e6
    master_only_print(f"profiler trace written to {path}; the device was busy "
                      f"{busy_ms:.1f} ms of the window's {wall_ms:.1f} ms "
                      f"({busy_ms / wall_ms:.1%})")


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0, in rank order (every rank
    calls; the JAX loop's global arrays)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _epoch_vis(state, cfg, visualizer, epoch, last_batch, last_metrics) -> str:
    """The epoch's visualization of the last step's whole batch (gathered
    from the ranks), drawn and written by rank 0; returns its timing."""
    t0 = time.time()
    batch, aux = last_batch, last_metrics["aux"]
    if state.group is not None:
        batch = tuple(_gather(b, state.group) for b in batch)
        aux = {k: _gather(v, state.group) for k, v in aux.items()}
    if not is_master():
        return ""
    aux = _host_aux(aux)
    t1 = time.time()
    s_np, d_np = (b.cpu() for b in batch)
    t2 = time.time()
    image = _visualize(visualizer, s_np, d_np, aux)
    t3 = time.time()
    save_visualization(cfg.train.vis_dir, epoch, image)
    t4 = time.time()
    return (f" [aux-get {t1 - t0:.1f} batch-get {t2 - t1:.1f}"
            f" draw {t3 - t2:.1f} write {t4 - t3:.1f}]")


def _scan_epoch(cfg, state, loader, scan, metrics_buf, profile):
    """One epoch in scan mode: K steps per call of ``scan`` over the
    loader's index tables (the remainder steps in one last, smaller call).
    Returns (global frames, the last step's local (s, d), its metrics)."""
    cache = loader.cache
    n_frames, last_idx, last_metrics, profiler = 0, None, None, None
    for cidx, (s_tab, d_tab) in enumerate(loader.iter_index_chunks(cfg.train.steps_per_call)):
        if profile and cidx == 1:
            profiler = _start_profiler(scan.device)
        s_loc, d_loc = cache.local(s_tab), cache.local(d_tab)
        last_metrics = scan(s_loc, d_loc)
        if profiler is not None:
            _stop_profiler(profiler, cfg.train.profile_dir)
            profiler = None
        n_frames += s_tab.size
        metrics_buf.push(last_metrics["losses_g"], last_metrics["losses_d"])
        metrics_buf.flush()
        last_idx = (s_loc[-1], d_loc[-1])
    if last_idx is None:
        return 0, None, None
    return n_frames, (cache.gather(last_idx[0]), cache.gather(last_idx[1])), last_metrics


def train_loop(cfg: Config, state: TrainState, loader, start_epoch: int = 0,
               writer=None) -> List[dict]:
    """Train ``state`` (in place) over ``loader`` from ``start_epoch`` to
    cfg.train.num_epochs.  Returns a record per epoch run: epoch, frames
    (the ranks' together), first_step, frames_per_s (the epoch line's),
    steps_s, wait_s (the loop's thread waiting on the prefetch queue),
    ckpt_s, vis_s; in scan mode the last record's "scan" holds the
    dispatcher's figures (capture seconds, memory pools, eager steps,
    replays, captured launches).  Scan mode (steps_per_call > 1) needs the on-device
    augmentation and a loader with iter_index_chunks (the frame cache's)."""
    K = cfg.train.steps_per_call
    fused_aug = cfg.data.on_device_aug
    scan_mode = K > 1
    if scan_mode and not (fused_aug and hasattr(loader, "iter_index_chunks")):
        raise ValueError("steps_per_call > 1 needs the device frame cache's loader and the "
                         "on-device augmentation")
    device = next(state.nets["afe"].parameters()).device
    rank = dist.get_rank(state.group) if state.group is not None else 0
    world = dist.get_world_size(state.group) if state.group is not None else 1
    if cfg.train.debug_nans:
        # reference parity: torch.autograd.set_detect_anomaly(True) (distributed.py:26)
        torch.autograd.set_detect_anomaly(True)
    own_writer = cfg.train.tensorboard and writer is None and is_master()
    if own_writer:
        writer = SummaryWriter(comment="facevae_tpu_torch")

    generator = torch.Generator(device=device)
    seed_of = lambda step: step_seed(cfg.train.seed, step, rank)  # noqa: E731
    scan = None
    if scan_mode:
        from facevae_tpu_torch.train.scan import ScanStep
        scan = ScanStep(state, loader.cache.frames, generator, seed_of)
    scalar_log = ScalarLog(cfg.train.log_file)
    visualizer = Visualizer()
    metrics_buf = _MetricBuffer(scalar_log)
    checkpointer = AsyncCheckpointer()
    records: List[dict] = []
    last_batch = last_metrics = profiler = None
    try:
        for epoch in range(start_epoch, cfg.train.num_epochs):
            master_only_print("Epoch", epoch)
            loader.set_epoch(epoch)
            t_epoch = time.time()
            n_frames, wait, first_step = 0, 0.0, state.step
            if scan_mode:
                if epoch == start_epoch and len(loader) % K:
                    master_only_print(
                        f"scan mode: {len(loader)} steps an epoch: {len(loader) // K} call(s) "
                        f"of {K} and one of {len(loader) % K}")
                n_frames, batch, metrics = _scan_epoch(cfg, state, loader, scan, metrics_buf,
                                                       bool(cfg.train.profile_dir)
                                                       and epoch == start_epoch)
                if batch is not None:
                    last_batch, last_metrics = batch, metrics
            batches = None if scan_mode else _device_prefetch(loader, device)
            try:
                for idx in range(0 if scan_mode else len(loader)):
                    t_wait = time.perf_counter()
                    batch = next(batches, None)
                    wait += time.perf_counter() - t_wait
                    if batch is None:
                        break
                    s, d = batch[0], batch[1]
                    if cfg.train.profile_dir and state.step == _PROFILE_START:
                        profiler = _start_profiler(device)
                    generator.manual_seed(seed_of(state.step))
                    metrics = train_step(state, (s, d) if fused_aug else batch,
                                         generator=generator, fused_aug=fused_aug)
                    if profiler is not None and state.step >= _PROFILE_START + _PROFILE_STEPS:
                        _stop_profiler(profiler, cfg.train.profile_dir)
                        profiler = None
                    n_frames += s.shape[0] * world
                    metrics_buf.push(metrics["losses_g"], metrics["losses_d"])
                    if len(metrics_buf.pending) >= _SYNC_EVERY:
                        metrics_buf.flush()
                    last_batch, last_metrics = (s, d), metrics

                    if writer is not None and idx % cfg.train.vis_every == 0 and is_master():
                        # reference logger.py:286-299: scalars + image grid + text line
                        # (rank 0's own batch)
                        metrics_buf.drain()
                        losses_g, losses_d = metrics_buf.last
                        index = epoch * len(loader) + idx
                        all_losses = {**losses_g, **losses_d}
                        writer.add_scalars("loss_all", all_losses, index)
                        image = _visualize(visualizer, s, d, _host_aux(metrics["aux"]))
                        writer.add_image(f"image_show_{epoch}", image, index,
                                         dataformats="HWC")
                        line = "; ".join(f"{k} - {v:.5f}" for k, v in all_losses.items())
                        writer.add_text("log", f"{str(epoch).zfill(8)}) {line}", index)
            finally:
                if batches is not None:
                    batches.close()
            if profiler is not None:          # epoch shorter than the trace window
                _stop_profiler(profiler, cfg.train.profile_dir)
                profiler = None
            metrics_buf.drain()
            dt = time.time() - t_epoch

            state.epoch = epoch
            scalar_log.log_epoch(epoch)
            # vis BEFORE the checkpoint snapshot: its aux fetch must not queue
            # behind the checkpointer's device-to-host copy of the state
            t_vis = time.time()
            vis_detail = ""
            if last_metrics is not None:
                vis_detail = _epoch_vis(state, cfg, visualizer, epoch, last_batch, last_metrics)
            t_vis = time.time() - t_vis
            t_ckpt = time.time()
            if (epoch + 1) % cfg.train.checkpoint_freq == 0:
                # async: a snapshot on the card now, the copy to the host and
                # the file write overlap the next epoch
                checkpointer.save(cfg.train.ckp_dir, state, epoch,
                                  keep=cfg.train.keep_checkpoints)
            t_ckpt = time.time() - t_ckpt
            total = dt + t_ckpt + t_vis
            fps = n_frames / max(total, 1e-9)
            master_only_print(
                f"epoch {epoch}: {fps:.2f} frames/s "
                f"(steps {dt:.1f}s, ckpt-snap {t_ckpt:.1f}s, vis {t_vis:.1f}s{vis_detail})")
            records.append(dict(epoch=epoch, frames=n_frames, first_step=first_step,
                                frames_per_s=fps, steps_s=dt, wait_s=wait, ckpt_s=t_ckpt,
                                vis_s=t_vis))
    except KeyboardInterrupt:
        _crash_save(cfg, state, checkpointer)
    except BaseException:
        _crash_save(cfg, state, checkpointer)
        raise
    finally:
        metrics_buf.close()
        scalar_log.close()
        if own_writer:
            writer.close()
    checkpointer.wait()
    if scan is not None and records:
        records[-1]["scan"] = dict(scan.stats, eager_steps=scan.eager_steps,
                                   replays=scan.replays,
                                   captured_launches=scan.captured_launches)
    return records


def _crash_save(cfg: Config, state: TrainState, checkpointer: AsyncCheckpointer) -> None:
    """Quirk q5 (logger.py:67-68): the state is saved when training stops
    early, as the epoch file of state.epoch (never pruned)."""
    try:
        checkpointer.wait()
    finally:
        save_checkpoint(cfg.train.ckp_dir, state, int(state.epoch))
        master_only_print(f"saved the state at step {state.step} as epoch {state.epoch}'s "
                          f"file in {cfg.train.ckp_dir}")
