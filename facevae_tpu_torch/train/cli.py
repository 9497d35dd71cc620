"""Training CLI of the port (counterpart of the root train.py), on the card
unless --device cpu:

    python -m facevae_tpu_torch.train --root_dir <png tree> --batch_size 8 ...

The root CLI's flags, defaults and --ext rule, plus --device (default cuda;
without a card the run stops with "no CUDA device", there is no CPU
fallback).  The root is a PNG-frame tree with train/ and test/ (identity
sampling over ``id#clip`` directories), read through FramesDataset's
training items.  By default the step augments on the device (kernel 1 at
D = 1, data/device_aug.py); --cpu_aug true takes the CPU augmentation
(data/augmentation.py, cv2 and PIL); --device_cache true decodes the train
split once into one uint8 tensor on the card.  Epoch files go to --ckp_dir
(train/checkpoint.py, the JAX package's format); --ckp N resumes from epoch
N's file, --ckp -1 from the newest.  FACEVAE_WATCHDOG=<secs> dumps every
thread's stack to stderr on that period.

Data parallelism: --gpu_ids a,b,... starts one process per listed card of
this host (spawn, NCCL; --device cpu: gloo processes on the CPU), each with
--batch_size frames a step (the global batch is batch x cards), joined in
one process group (parallel/); one listed card runs in this process
through the same group path.  Under a launcher's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) each process joins that
group instead.  Rank 0 alone prints, logs, visualizes and writes epoch
files; every rank loads on resume.  More cards than the machine has stop
the run.  --steps_per_call K > 1 runs K steps per call of the multi-step
dispatcher (train/scan.py: a CUDA graph of the step replayed K times);
it needs --device_cache true and the on-device augmentation.

--remat true (the default, as the root CLI's) rematerializes the nets the
JAX step wraps in jax.checkpoint (train/objective.py, remat.py): less
memory a step for about a third more of their forward work.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch


def str2bool(s):
    return s.lower().startswith("t")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="face-vid2vid (PyTorch port)")
    parser.add_argument("--batch_size", default=8, type=int, help="Batch size per device")
    parser.add_argument("--benchmark", type=str2bool, default=True,
                        help="(parity flag)")
    parser.add_argument("--gpu_ids", default=None, type=str,
                        help="comma list of this host's cards, one process each (with "
                             "--device cpu: that many gloo processes)")
    parser.add_argument("--lr", default=0.00005, type=float, help="Learning rate")
    parser.add_argument("--num_epochs", default=150, type=int)
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--ckp_dir", type=str, default="ckp")
    parser.add_argument("--vis_dir", type=str, default="vis")
    parser.add_argument("--ckp", type=int, default=0,
                        help="Checkpoint epoch to resume (-1 = newest in ckp_dir)")
    parser.add_argument("--log_file", type=str, default="log.txt")
    parser.add_argument("--ext", type=str, default="", help="suffix appended to dirs/log")
    parser.add_argument("--root_dir", type=str, required=True, help="dataset path")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--num_repeats", type=int, default=100)
    parser.add_argument("--train_vae", type=str2bool, default=False)
    parser.add_argument("--tiny", type=str2bool, default=False,
                        help="tiny 64px config")
    parser.add_argument("--bf16", type=str2bool, default=False)
    parser.add_argument("--remat", type=str2bool, default=True,
                        help="recompute the big nets' activations in the backward pass")
    parser.add_argument("--cpu_aug", type=str2bool, default=False,
                        help="use the CPU augmentation path (cv2 / PIL)")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--checkpoint_freq", type=int, default=1,
                        help="save a checkpoint every N epochs")
    parser.add_argument("--keep_checkpoints", type=int, default=5,
                        help="retain only the N newest epoch checkpoints (0 = keep all); "
                             "crash-saves are never pruned")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="K > 1: K steps per call of the multi-step dispatcher (a CUDA "
                             "graph of the step replayed K times); needs --device_cache")
    parser.add_argument("--device_cache", type=str2bool, default=False,
                        help="decode the whole train split ONCE into one uint8 tensor on "
                             "the card and sample batches by gather there")
    parser.add_argument("--debug_nans", type=str2bool, default=False,
                        help="torch.autograd.set_detect_anomaly(True)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of steps 10-14")
    parser.add_argument("--tensorboard", type=str2bool, default=False)
    parser.add_argument("--pretrained_dir", type=str, default="",
                        help="dir of the teacher npz files; empty = random-init teachers")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu (the warps' plain versions)")
    args = parser.parse_args(argv)
    if args.ext:
        args.ckp_dir = args.ckp_dir + args.ext
        args.vis_dir = args.vis_dir + args.ext
        root, ext = os.path.splitext(args.log_file)
        args.log_file = root + args.ext + (ext or ".txt")
    return args


def build_config(args):
    """The Config the root train.py builds for the same flags."""
    from facevae_tpu_torch.config import Config, ModelConfig, TrainConfig, tiny_config

    if args.tiny:
        cfg = tiny_config(image_size=args.image_size if args.image_size != 256 else 64)
    else:
        cfg = Config(model=ModelConfig(
            image_size=args.image_size,
            compute_dtype="bfloat16" if args.bf16 else "float32",
            remat=args.remat))
    train = TrainConfig(
        batch_size=args.batch_size, lr=args.lr, num_epochs=args.num_epochs,
        num_repeats=args.num_repeats, train_vae=args.train_vae,
        ckp_dir=args.ckp_dir, vis_dir=args.vis_dir, log_file=args.log_file,
        seed=args.seed, debug_nans=args.debug_nans,
        checkpoint_freq=args.checkpoint_freq,
        keep_checkpoints=args.keep_checkpoints,
        steps_per_call=args.steps_per_call,
        profile_dir=args.profile_dir, tensorboard=args.tensorboard)
    data = dataclasses.replace(cfg.data, root_dir=args.root_dir,
                               num_workers=args.num_workers,
                               on_device_aug=not args.cpu_aug,
                               frame_shape=(args.image_size, args.image_size, 3))
    loss = cfg.loss
    if args.pretrained_dir:
        loss = dataclasses.replace(loss, pretrained_dir=args.pretrained_dir)
    return dataclasses.replace(cfg, train=train, data=data, loss=loss)


def gpu_ids(args):
    """The cards --gpu_ids lists, as ints ([] when it is not given)."""
    text = str(args.gpu_ids or "").strip("[]").replace(" ", "")
    return [int(c) for c in text.split(",") if c]


def _refuse(args, device):
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the "
                         "plain versions)")
    cards = gpu_ids(args)
    if device.type == "cuda" and cards:
        have = torch.cuda.device_count()
        if len(cards) > have or max(cards) >= have or len(set(cards)) < len(cards):
            raise SystemExit(f"--gpu_ids {args.gpu_ids}: this machine has {have} card(s) "
                             f"(0..{have - 1}); list each card once, at most {have}")
    if args.steps_per_call > 1 and not args.device_cache:
        raise SystemExit("--steps_per_call > 1 requires --device_cache true (the multi-step "
                         "dispatcher samples from the device frame cache)")
    if args.device_cache and args.cpu_aug:
        raise SystemExit("--device_cache requires the on-device aug path")


def _worker(argv):
    """A spawned rank's run (its process group is up): its epoch records."""
    return main(argv)[1]


def main(argv=None):
    """Train; returns (state, the loop's per-epoch records).  With
    --gpu_ids of several cards this process spawns one process per card and
    returns (None, rank 0's records)."""
    from facevae_tpu_torch import parallel

    args = parse_args(argv)
    cfg = build_config(args)
    device = torch.device(args.device)
    _refuse(args, device)
    cards = gpu_ids(args)
    own_group = False
    if not parallel.initialized():
        if "WORLD_SIZE" in os.environ:                     # a launcher's process
            parallel.init_distributed(device=args.device)
            own_group = True
        elif len(cards) > 1:
            from facevae_tpu_torch.parallel.spawn import spawn
            records = spawn(_worker, len(cards), list(argv if argv is not None else sys.argv[1:]),
                            device=args.device, cards=cards,
                            threads=max(1, torch.get_num_threads() // len(cards)))
            return None, records[0]
        elif cards:
            parallel.init_distributed(0, 1, args.device, local_rank=cards[0])
            own_group = True
    try:
        return _train(args, cfg, device)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _train(args, cfg, device):
    from facevae_tpu_torch import parallel
    from facevae_tpu_torch.data import DatasetRepeater, FramesDataset, PrefetchLoader
    from facevae_tpu_torch.train.checkpoint import latest_checkpoint_epoch, load_checkpoint
    from facevae_tpu_torch.train.loop import train_loop
    from facevae_tpu_torch.train.state import create_train_state

    group = torch.distributed.group.WORLD if parallel.initialized() else None
    rank, world = parallel.rank(), parallel.world_size()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    say = parallel.master_only_print
    if group is not None:
        say(f"data parallel: {world} rank(s) ({torch.distributed.get_backend(group)}), "
            f"{cfg.train.batch_size} frames a rank a step, {cfg.train.batch_size * world} "
            f"a step")
    if args.device_cache:
        from facevae_tpu_torch.data.device_cache import CachedLoader, DeviceFrameCache
        cache = DeviceFrameCache(cfg.data.root_dir, frame_shape=cfg.data.frame_shape,
                                 num_workers=cfg.data.num_workers, world=world, rank=rank,
                                 device=device)
        loader = CachedLoader(cache, batch_size=cfg.train.batch_size * world,
                              num_items=cache.num_identities * cfg.train.num_repeats,
                              seed=cfg.train.seed)
        say(f"device cache: {cache.frames.shape[0]} frames "
            f"({cache.frames.nbytes / 2**20:.0f} MiB) on {device}"
            + (f" (rank 0's shard of {world})" if world > 1 else ""))
    else:
        # on-device aug (default): items are raw uint8 (source, driving)
        # pairs, augmented inside the step; --cpu_aug: the CPU transform
        dataset = DatasetRepeater(
            FramesDataset(cfg.data.root_dir, frame_shape=cfg.data.frame_shape,
                          augmentation_params=None if args.cpu_aug else {},
                          on_device_aug=not args.cpu_aug),
            num_repeats=cfg.train.num_repeats)
        loader = PrefetchLoader(dataset, batch_size=cfg.train.batch_size,
                                num_workers=cfg.data.num_workers, shard=(rank, world),
                                seed=cfg.train.seed)

    # hang diagnosis: FACEVAE_WATCHDOG=<secs> dumps every thread's stack to
    # stderr on that period (non-fatal)
    wd = int(os.environ.get("FACEVAE_WATCHDOG", "0"))
    if wd > 0:
        import faulthandler
        faulthandler.dump_traceback_later(wd, repeat=True, exit=False, file=sys.stderr)

    try:
        state = create_train_state(cfg, device, group=group)
        start_epoch = 0
        ckp = args.ckp
        if ckp == -1:
            latest = latest_checkpoint_epoch(cfg.train.ckp_dir)
            # resume even from epoch 0 (a run killed in epoch 1 leaves only 00000000-*)
            if latest is not None:
                load_checkpoint(cfg.train.ckp_dir, latest, state)
                start_epoch = state.epoch + 1
                say(f"resumed from epoch {latest} (latest), continuing at {start_epoch} "
                    f"(step {state.step})")
            ckp = 0
        if ckp > 0:
            load_checkpoint(cfg.train.ckp_dir, ckp, state)
            start_epoch = state.epoch + 1
            say(f"resumed from epoch {ckp}, continuing at {start_epoch} (step {state.step})")
        return state, train_loop(cfg, state, loader, start_epoch=start_epoch)
    finally:
        if wd > 0:
            faulthandler.cancel_dump_traceback_later()
