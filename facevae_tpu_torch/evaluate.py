"""Evaluation CLI of the port (counterpart of the root evaluate.py), on the
card unless --device cpu:

    python -m facevae_tpu_torch.evaluate --ckp_dir ckp --ckp 12 --source m \\
        --driving <dataset root>                      # recon L1 / MSE / PSNR
    python -m facevae_tpu_torch.evaluate --ckp_dir ckp --ckp 12 --source r \\
        --driving <frame dir> --output out.gif

The same flags and modes as the JAX CLI, plus --device:

  --source r      reconstruction: frame 0 drives the rest of --driving
  --source f      frontalization of every frame in --driving
  --source <img>  cross-identity reenactment from a source image
  --source s      expression sampling from the EFE latent: frame i's eps is
                  drawn by a CPU torch.Generator seeded 0 * 2^32 + i (the
                  key (0, i)), then moved to the device, so the card and the
                  CPU sample the same expressions.  They are not the JAX
                  CLI's draws: its threefry stream has no torch equivalent.
  --source i      expression interpolation between the first and last frame
  --source m      recon L1 / MSE / PSNR over the test split (--driving = the
                  dataset root), --eval_batch frames a dispatch (the last
                  chunk padded with its last frame); prints one JSON line,
                  --metrics_out writes the full record
  --source p      cross-identity reenactment over PairedDataset pairs
                  (--driving = the dataset root)

The six G nets come from the epoch file --ckp_dir/%08d-checkpoint.msgpack
of epoch --ckp, written by either package (train/checkpoint.py), as the
port's server reads it.  The config is ModelConfig(image_size) in fp32, or
tiny_config(image_size) with --tiny true.  Modes r/f/s/i/p/<img> write a
side-by-side gif to --output through the port's own GIF writer; PNG frames
are read by the port's own decoder (data/image_io.py).  There is no CPU
fallback: --device cuda without a card fails.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np
import torch

_SAMPLE_SEED = 0        # mode s: frame i's eps from seed _SAMPLE_SEED * 2^32 + i


def _flag(s):
    return s.lower().startswith("t")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="face-vid2vid (PyTorch port)")
    parser.add_argument("--ckp_dir", type=str, default="ckp")
    parser.add_argument("--output", type=str, default="output.gif")
    parser.add_argument("--ckp", type=int, default=0, help="Checkpoint epoch")
    parser.add_argument("--source", type=str, default="r",
                        help="r=reconstruction, f=frontalization, s=sampling, "
                             "i=interpolation, m=metrics, p=pairs, or a "
                             "source image path")
    parser.add_argument("--driving", type=str, required=True,
                        help="Driving frame dir (modes m/p: dataset root)")
    parser.add_argument("--num_frames", type=int, default=90)
    parser.add_argument("--num_videos", type=int, default=0,
                        help="mode m: test videos to evaluate (0 = full split)")
    parser.add_argument("--eval_batch", type=int, default=8,
                        help="mode m: driving frames per dispatch")
    parser.add_argument("--metrics_out", type=str, default="",
                        help="mode m: also write the JSON artifact here")
    parser.add_argument("--num_pairs", type=int, default=4,
                        help="mode p: PairedDataset pairs to animate")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--tiny", type=_flag, default=False)
    parser.add_argument("--use_efe", type=_flag, default=True,
                        help="False reproduces the reference's pre-EFE path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu (the warps' plain versions)")
    return parser.parse_args(argv)


def build_pipeline(args):
    """The InferencePipeline over epoch args.ckp's file on args.device."""
    from facevae_tpu_torch.config import Config, ModelConfig, tiny_config
    from facevae_tpu_torch.convert import load_jax_variables, net_variables
    from facevae_tpu_torch.models import build_models
    from facevae_tpu_torch.train.checkpoint import read_checkpoint
    from facevae_tpu_torch.train.inference import InferencePipeline
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu for the "
                         "plain versions)")
    cfg = (tiny_config(image_size=args.image_size) if args.tiny
           else Config(model=ModelConfig(image_size=args.image_size)))
    tree = read_checkpoint(args.ckp_dir, args.ckp)
    models = build_models(cfg.model, device=device)
    for name, m in models.items():
        load_jax_variables(m, net_variables(tree, name))
    return InferencePipeline(cfg, models, use_efe=args.use_efe)


def _device(pipe):
    return next(pipe.models["afe"].parameters()).device


def eval_metrics(pipe, root_dir, image_size, num_videos, num_frames, batch: int = 8):
    """Recon L1/MSE/PSNR over the test split: frame 0 of each test video is
    the source, every later frame is re-driven in fixed batches of
    ``batch`` (the last chunk padded with its last frame) and compared to
    the ground truth; the JAX CLI's record, keys and rounding."""
    from facevae_tpu_torch.data import FramesDataset
    device = _device(pipe)
    ds = FramesDataset(root_dir, frame_shape=(image_size, image_size, 3), is_train=False)
    n_videos = len(ds) if num_videos <= 0 else min(len(ds), num_videos)
    per_video, n_frames = [], 0
    for vid_idx in range(n_videos):
        video = np.asarray(ds[vid_idx], np.float32)[:num_frames]
        if video.shape[0] < 2:
            continue
        enc = pipe.encode_source(torch.from_numpy(video[:1]).to(device))
        gt_all = video[1:]
        gens = []
        for off in range(0, gt_all.shape[0], batch):
            chunk = gt_all[off:off + batch]
            pad = batch - chunk.shape[0]
            if pad:                          # fixed batch: one shape for every call
                chunk = np.concatenate([chunk, chunk[-1:].repeat(pad, 0)])
            out = pipe.drive_batch(*enc, torch.from_numpy(chunk).to(device)).cpu().numpy()
            gens.append(out[:batch - pad] if pad else out)
        gen = np.concatenate(gens).clip(0.0, 1.0)
        v_l1 = float(np.abs(gen - gt_all).mean())
        v_mse = float(((gen - gt_all) ** 2).mean())
        per_video.append({
            "video": ds.videos[vid_idx],
            "frames": int(gt_all.shape[0]),
            "l1": round(v_l1, 6),
            "mse": round(v_mse, 6),
            "psnr_db": round(float(10.0 * np.log10(1.0 / max(v_mse, 1e-12))), 3),
        })
        n_frames += int(gt_all.shape[0])

    weights = np.asarray([v["frames"] for v in per_video], np.float64)
    l1s = np.asarray([v["l1"] for v in per_video])
    mses = np.asarray([v["mse"] for v in per_video])
    psnrs = np.asarray([v["psnr_db"] for v in per_video])
    mse = float(np.average(mses, weights=weights))

    def dist(x):
        return {"p10": round(float(np.percentile(x, 10)), 6),
                "p50": round(float(np.percentile(x, 50)), 6),
                "p90": round(float(np.percentile(x, 90)), 6)}

    return {
        "metric": "recon_eval",
        "recon_l1": round(float(np.average(l1s, weights=weights)), 6),
        "recon_mse": round(mse, 6),
        "psnr_db": round(float(10.0 * np.log10(1.0 / max(mse, 1e-12))), 3),
        "frames": n_frames,
        "videos": len(per_video),
        "l1_dist": dist(l1s),
        "psnr_dist": dist(psnrs),
        "per_video": per_video,
    }


def _to_uint8(img):
    """[1,H,W,3] in [0,1] -> uint8 [H,W,3], as the JAX CLI casts."""
    return (255 * img[0].detach().cpu().numpy().clip(0, 1)).astype(np.uint8)


def pair_frames(pipe, args) -> List[np.ndarray]:
    """Mode p: per PairedDataset pair a strip (source frame 0 | driving
    frame | generated), the pairs' strips stacked, one gif frame a time."""
    from facevae_tpu_torch.data import FramesDataset, PairedDataset
    device = _device(pipe)
    ds = FramesDataset(args.driving, frame_shape=(args.image_size, args.image_size, 3),
                       is_train=False)
    paired = PairedDataset(ds, number_of_pairs=args.num_pairs)
    strips = []
    for i in range(len(paired)):
        item = paired[i]
        src = torch.from_numpy(np.asarray(item["source_video"][:1], np.float32)).to(device)
        drv = np.asarray(item["driving_video"], np.float32)[: args.num_frames]
        enc = pipe.encode_source(src)
        row = []
        for t in range(drv.shape[0]):
            img = torch.from_numpy(drv[t][None]).to(device)
            gen = pipe.drive_frame(*enc, img)
            row.append(torch.cat([src, img, gen], dim=2)[0].cpu().numpy())
        strips.append(np.stack(row))
    n_frames = min(s.shape[0] for s in strips)
    return [(255 * np.concatenate([s[t] for s in strips], axis=0).clip(0, 1)).astype(np.uint8)
            for t in range(n_frames)]


def gif_frames(pipe, args) -> List[np.ndarray]:
    """The uint8 gif frames of modes r, f, s, i, p and <img>."""
    from facevae_tpu_torch.data.dataset import _imread_float
    from facevae_tpu_torch.ops.interpolate import interpolate_nearest_2d
    if args.source == "p":
        return pair_frames(pipe, args)
    device = _device(pipe)
    frames = sorted(os.listdir(args.driving))[: args.num_frames]
    video = [torch.from_numpy(_imread_float(os.path.join(args.driving, f))[None]).to(device)
             for f in frames]
    out = []
    if args.source == "r":
        enc = pipe.encode_source(video[0])
        for img in video[1:]:
            out.append(_to_uint8(torch.cat([img, pipe.drive_frame(*enc, img)], dim=2)))
    elif args.source == "f":
        for img in video:
            out.append(_to_uint8(torch.cat([img, pipe.frontalize_frame(img)], dim=2)))
    elif args.source == "s":
        for i, img in enumerate(video):
            g = torch.Generator().manual_seed(_SAMPLE_SEED * 2 ** 32 + i)
            gen = pipe.sample_expression(img, 1.0, generator=g)
            out.append(_to_uint8(torch.cat([img, gen], dim=2)))
    elif args.source == "i":
        s_img, d_img = video[0], video[-1]
        n = max(2, len(video))
        for i in range(n):
            alpha = torch.tensor(i / (n - 1), dtype=torch.float32, device=device)
            gen = pipe.interpolate_expression(s_img, d_img, alpha)
            out.append(_to_uint8(torch.cat([s_img, gen, d_img], dim=2)))
    else:
        s = torch.from_numpy(_imread_float(args.source)[None]).to(device)
        # the port's resize is channel-first [N,C,H,W]
        s = interpolate_nearest_2d(s.permute(0, 3, 1, 2), (args.image_size, args.image_size))
        enc = pipe.encode_source(s.permute(0, 2, 3, 1).contiguous())
        for img in video:
            out.append(_to_uint8(torch.cat([img, pipe.drive_frame(*enc, img)], dim=2)))
    return out


def main(argv=None):
    from facevae_tpu_torch.data.image_io import write_gif
    args = parse_args(argv)
    pipe = build_pipeline(args)
    if args.source == "m":
        out = eval_metrics(pipe, args.driving, args.image_size, args.num_videos,
                           args.num_frames, batch=args.eval_batch)
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(out, f, indent=1)
        print(json.dumps({k: v for k, v in out.items() if k != "per_video"}))
        return out
    frames = gif_frames(pipe, args)
    write_gif(args.output, frames)
    print(f"wrote {len(frames)} frames to {args.output}")
    return None


if __name__ == "__main__":
    main()
