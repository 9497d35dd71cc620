#!/usr/bin/env python
"""Smoke test of the PyTorch port (facevae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each fatal on failure (exit code 1, no result line):
  1. device   nvidia-smi name and power limit, torch / CUDA versions, the
              numerics switches (TF32 off), the versions of PIL and cv2 (the
              port's readers) with cv2's video backends, and whether
              imageio, pandas, matplotlib and tensorboardX, which the port
              does not need, are installed (looked up, not imported).
  2. build    nvcc-builds every kernel library from csrc/ (warp_fwd,
              warp_bwd, warp_grid, probe_gather, probe_warp), one nvcc per
              source, all started together; names the entry points that
              spill or keep a stack frame, and prints the registers and
              shared memory of kernel 4's entry points.
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main paths' shapes (batch 8), fp32 and bf16, with
              far-out-of-volume, +-inf, last-index and exact-integer
              coordinates.  The multi-grid warp (forward, dgrid, dx) at MFE
              x[8,16,64,64,4] K1=15 on three coordinate sets (the noisy
              affine set, and MFE's own sparse-motion coordinates from
              seeded keypoints and head poses, clean and with the probes:
              facevae_tpu_torch/warp_inputs.py) and Generator
              x[8,16,64,64,32] K1=1, and its forward at the bf16 TPS warp
              x[8,1,256,256,3] K1=1; the
              single-grid warp (forward, dgrid, dx) at the Generator shape
              (gps=1, a deformation-like grid) and the reference-form MFE
              shape x[8,16,64,64,4] (gps=16 grids from create_sparse_motions
              on seeded keypoints).  Both warps also at the Generator shape
              on a smooth set, one keypoint's sparse motion (K1 = 1;
              normalized for the single-grid warp), clean and with the
              probes: the dx kernels pair neighbouring voxels' corners, and
              smooth coordinates are where the pairs form.  The device time per call of the kernel
              and of F.grid_sample's forward / backward in x's dtype (a
              yardstick the port never calls, the source repeated per grid):
              10 calls in one CUDA graph, median of 20 replays; the kernel's
              and its plain version's median CUDA-event time over 20 calls;
              each kernel's bound from its bytes, and the dx kernels'
              run-to-run max difference (their atomics add in varying
              order).  Per single-grid site and dtype, which of kernel 4's
              two kernels ran (voxel: C fits one vector; table: a block's
              corner table in shared memory) on how many of its blocks.
              The dx kernels' deterministic variants (fixed-point
              int64 sums) at every site and dtype where dx runs: within
              the dx tolerance of the plain version, the same bits on a
              second run and, at MFE, with the K1 grids permuted; their
              device time beside the default kernel's.  Per multi-grid site
              and dtype the bytes of kernel 1's stores (through a
              shared-memory tile at K1 > 1) and of the cotangent kernel 2
              reads.  Then the single-grid forward
              against the multi-grid forward on the same samples at both
              single-grid shapes (fp32) and at the TPS frame (bf16, where
              kernel 1 runs its pixel kernel): within 1e-5 of max|ref|, and
              whether they agree bit for bit.
  4. golden   the port's encode_source / drive_frame / frontalize_frame at
              tiny_config on the card, with the JAX weights and outputs of
              tests/data/torch_golden_tiny.npz (tools/make_torch_golden.py).
  5. serve    the full-width ModelConfig() in fp32 (seeded random weights)
              behind the port's HTTP server on 127.0.0.1: 2 sessions, rounds
              of 16 concurrent /drive requests in full batches of 8, one
              /frontalize; every answer 200 and 256*256*3 bytes; per batch
              the multi-grid forward kernel once (MFE) and the single-grid
              forward kernel once (Generator), the plain versions never.
              Prints p50/p95 latency and frames/s.
  6. train_tiny  one tiny_config() training step on the card against the
              same step of the port on the CPU (plain versions), from the
              same numpy-seeded weights, images and TPS parameters, in fp32
              (the CPU step run here, in a fresh process whose CPU math is
              pinned: CPU_REF_ENV's one instruction set for ATen, oneDNN
              and MKL, CPU_REF_THREADS threads) and in bf16 (the CPU step recorded in
              tests/data/torch_bf16_step_tiny.npz by
              tools/make_torch_step_golden.py): every loss and the gradient
              of every G and D parameter, held to the CPU step as
              tests/test_torch_train.py (fp32) and tests/test_torch_bf16.py
              (bf16) hold the port to JAX.  Each step again under
              torch.use_deterministic_algorithms(True) (strict: an op
              without a deterministic implementation raises, and the phase
              fails): held the same way, the dx kernels' deterministic
              variants launched in place of the default ones.  Then one
              fp32 step with VAE sampling (train_vae, LossConfig.kl = 1)
              on the card against the CPU's, with one eps on both: held as
              the fp32 step, K nonzero.
  7. train    the full-width ModelConfig() training step, fp32, batch 8,
              seeded weights and teachers, through facevae_tpu_torch.bench:
              2 warm-up and 5 timed steps; every loss finite; per step each
              multi-grid kernel once (MFE) and each single-grid kernel once
              (Generator), the plain versions never.  Prints the step time,
              frames/s and peak memory.
     checkpoint  the epoch files of facevae_tpu_torch/train/checkpoint.py:
              ModelConfig() fp32 after one training step at batch 8 (both
              Adam states at step 1) saved into a temporary directory and
              loaded into a freshly seeded state: every parameter, buffer,
              Adam exp_avg / exp_avg_sq / step, epoch and step bit for bit;
              the file's bytes, save and load seconds.  The server's engine
              built from the file (serve.build_engine --ckp_dir --ckp) drives
              a batch of 8: the frames of a pipeline over the state in memory
              (bit for bit, else within 1e-6 of max|ref|), the multi-grid and
              single-grid forward kernels once each, the plain versions
              never.  A tiny_config() state saved after one step and loaded
              into a fresh one: one step of each under
              torch.use_deterministic_algorithms(True), with the same TPS
              draw, gives the same losses and the same state bit for bit.
     reference  the reference's own PyTorch weights with no JAX: both
              converters (python -m facevae_tpu_torch.convert_reference_checkpoint,
              python -m facevae_tpu_torch.convert_torch_weights) run as a user
              runs them, each in a fresh process whose -X importtime list
              holds no jax, jaxlib, flax or facevae_tpu (nor does the
              smoke's own process).  (a) A reference checkpoint
              (.pth.tar) at ModelConfig(), fp32, in the JAX package's
              creation order of tests/data/torch_reference_order.json with
              the reference's leaf names (weight_orig / weight_u / weight_v,
              running statistics, num_batches_tracked) and seeded values
              (reference_state_dict), converted with --device cuda and
              --device cpu: seconds and bytes in and out; the seven nets
              of the two epoch files bit for bit; mode m at --eval_batch 8
              from the card's file (finite, kernels 1 and 4 once a drive
              batch, frames/s on a second run); a drive batch of 8 from that
              file on the card against the CPU within REF_TOL of max|ref|.
              (b) The tiny golden's reference state dicts
              (tests/data/torch_reference_tiny.npz) through a .pth.tar,
              ported on the card: every leaf of the seven nets bit for bit
              the JAX package's conversion stored beside them.  (c) Seeded
              torchvision VGG19 features.N, vgg_face_dag and Hopenet state
              dicts at their real shapes (teacher_state_dicts) converted,
              loaded by create_train_state(pretrained_dir=...): each
              teacher tensor equal to its source; one fp32 step at batch 8
              from that state (remat off): losses finite, the step's
              launches.
     eval     the evaluation CLI, facevae_tpu_torch.evaluate.main, on the
              card: a seeded ModelConfig() state saved as an epoch file, a
              PNG tree (the port's writer) of 2 test videos x 17 frames at
              256x256 and one train video; mode m at --eval_batch 8 (its
              keys, 32 frames, finite values, per drive batch the
              multi-grid and single-grid forward once, plain versions
              never), modes s, i and r on one video (GIF89a bytes and frame
              counts; one of each forward kernel per graph call); mode m's
              frames/s and the ms per gif frame of r, s and i (second runs);
              mode m's frames/s again over frames with a camera's grain
              that PIL writes, where it imports (its row filters, which a
              real dataset's frames carry, cost read_png more than the
              filter 0 of the port's writer); kernels 1 and 4 at their
              N = 1 calls (the inputs of one sample_expression call)
              against their plain versions, timed as phase 3 times them,
              with the launch grids their wrappers report.  Then
              tiny_config(image_size=128)'s modes m, s and i on the card
              against the same calls on the CPU (one epoch file, one tree,
              the CPU-drawn eps): EVAL_TOL.
  8. train_bf16  the same step with ModelConfig(compute_dtype="bfloat16"):
              every loss finite, parameters and Adam state fp32; per step the
              multi-grid forward 3 times (MFE, Generator, TPS), its dgrid
              and dx kernels twice, the single-grid kernels and the plain
              versions never.  Prints the step time, frames/s, peak memory.
     train_loop  the training CLI, facevae_tpu_torch.train's main, in-process
              at full width on a PNG tree that PIL writes with grain (4
              identities x 2 clips x 6 frames at 256x256, its row filters):
              fp32 for two epochs (3 steps each at batch 8, kernel 1 three
              times a step: MFE and the fused augmentation's two batches;
              kernels 2-6 once; plain versions never; two G / D log lines
              with the K column, two visualizations, one epoch file kept),
              resumed with --ckp -1 for a third (epoch 2 from step 6), bf16
              with --device_cache for one (kernel 1 five times a step,
              kernels 2-3 twice, 4-6 never), and --cpu_aug for one (cv2 /
              PIL on the host; kernel 1 once a step); each epoch's frames/s
              and the share of it the loop's thread waited on the prefetch
              queue; read_png's ms per frame.  Before them kernel 1 at the
              augmentation's own call, x[8,1,256,256,3] K1=1 on
              frame_draws' homography coordinates, fp32 and bf16, against
              its plain version (AUG_TOL), timed as phase 3 times it with
              F.grid_sample 2-D (border padding) beside it; and the
              augmentation on the card against the port's on the CPU with
              the same draws (the warp within 2^-7 of max|ref|: the bf16
              rows' and output's roundings; the colour jitter within 1e-5).
              Last, bf16 with --device_cache --steps_per_call 4 --gpu_ids 0
              (the multi-step dispatcher through a one-card NCCL group): 6
              steps, a call of 4 and the remainder's of 2, 2 eager warm-up
              steps and 4 replays, launches as the eager loop's; the same
              without --gpu_ids and with the CLI's default --remat true
              (every run before passes --remat false): a remat step
              captured and replayed; and --gpu_ids of more cards than the
              machine has: stopped with a message.
     video    the video datasets and --tensorboard: the same seeded frames
              (4 identities x 2 clips x 6 frames at 256x256) as .mp4 clips
              that cv2's VideoWriter encodes (avc1 where it can, else mp4v;
              printed, with cv2's backends), as .gif clips (write_gif) and
              as a PNG tree; the host's ms a frame of read_mp4, read_gif and
              read_png on them; the training CLI in-process over each tree
              (fp32, batch 8, the fused augmentation, 3 steps, remat off,
              --tensorboard with a record every step: TrainConfig.vis_every
              set to 1, which no flag sets): launches as train_loop's fp32
              runs, ms a step against the PNG tree's, the event files read
              back by train/tensorboard.read_events (CRCs; loss_all with
              every loss key at every step; image_show_0 decoding to the
              Visualizer's grid; the log line), host ms a record and the
              files' bytes; mode m at --eval_batch 8 over the .mp4 test
              split (2 videos x 17 frames) from the .mp4 run's epoch file,
              its launches and frames/s; no module of imageio or
              tensorboardX imported.
     dp       data parallelism on the one card (remat off, as before remat
              was ported, here and in scan): ModelConfig() fp32 at batch
              8, four steps under torch.use_deterministic_algorithms(True)
              through a one-rank NCCL group against the same steps with no
              group: losses, gradients, parameters, buffers and Adam states
              bit for bit, the last three steps' ms both ways; then tiny_config() in 2 gloo ranks on the card
              (CUDA tensors; NCCL refuses two ranks on one device), two
              deterministic steps, against one process on the whole batch
              within the JAX package's data-parallel bounds, the ranks alike
              bit for bit.
     scan     the multi-step dispatcher (train/scan.py) at ModelConfig(),
              batch 8, fp32 and bf16, over uint8 frames on the card: the
              dispatcher's calls of 2, 1, 4 and 2 (the warm-up, the
              capture and its replay, timed, profiled); after the capture
              two replays each from the state the loop's eager step (K =
              1) took, that step run from it twice and once on frames
              nudged by NUDGE (its spread, as phase 6 measures it; timed,
              and once profiled), losses, gradients and the state after
              (buffers, Adam states) within SPREAD x that spread +
              TRAIN_TOL; 4 eager steps back to back (the loop at
              K = 1); ms a step both ways, the host's ms a
              step, the device's busy share, peak memory of each pool, the
              capture's seconds, the graph path's launches (captured x
              replays, as the eager step's); tiny_config() under
              deterministic algorithms: the same bits both ways.
     remat    rematerialization at full width under deterministic
              algorithms: fp32 and bf16 at batch 8 and fp32 at batch 16,
              the step with ModelConfig.remat and without from the same
              seeded nets, images and TPS draw: peak memory allocated, ms
              a step (a second step), the warp launches a step by kernel
              (the same both ways); at batch 8 the remat step's losses,
              gradients and state after (buffers, Adam moments and steps)
              within SPREAD x the plain step's own spread (run again, and on
              images nudged by NUDGE) + TRAIN_TOL, and how many bit for
              bit; the fp32 batch-8 peak with remat below the one without.
     variants every EFE variant (conv, conv2, conv3, conv4, conv5, conv6,
              linear, lin_conv) at 256x256 with ModelConfig() widths (conv4
              with a last encoder width of 64): InferencePipeline's drive
              batch of 8 (ms, finite, kernels 1 and 4 once each); each
              variant's EFE at its CPU test's size on the card against the
              CPU, eval and training forms (VARIANT_TOL; above NEAR_LIMIT
              of it, the relative error of each module's output and of the
              EFE's own ops after its last module); one fp32 remat
              training step of linear at batch 8 (losses and both Adam
              states finite, its launches).
     library  the modules no model path runs (ops/grid_sample.py,
              ops/rotations.py, the channel-first heatmaps, nn/wn.py,
              losses/lpips.py, contrastive_loss and the conv contrastive
              heads): each on the card against the port on the CPU at its
              CPU test's sizes, from the same seeded inputs and weights,
              outputs and the gradients the tests hold (LIBRARY_TOL; the
              running statistics of ContrastiveHeadConv2's training form;
              fuse_wn's weights; LPIPS(x, x) = 0; each rotation function on
              the CPU test's draw, angles by randn(3) x U(0.05, 3) / sqrt(3)
              with a zero and a tiny vector, given the CPU's own inputs, a
              miss printed with its row's angle; above NEAR_LIMIT of their
              limit the heatmaps print each step's share, as phase
              variants prints each EFE module's); then timed with CUDA
              events at a size its users run it: grid_sample_2d at
              x[8,256,256,3] and grid_sample_3d at x[8,16,64,64,32] in all
              six modes (forward, forward + backward) beside F.grid_sample
              on the same tensors (its ms and the largest difference, a
              yardstick), LPIPS on two [8,256,256,3] batches (ms, peak
              memory), ContrastiveHeadConv on [8,64,64,32],
              ContrastiveHeadConv2 on [8,4,4,256] (training and eval forms),
              Conv2dWN 3x3 256->256 on [8,256,64,64], ConvTranspose2dWNUB
              64->32 to 128x128, downsample2d ("reflect") on
              [8,3,256,256], the rotations at N = 4096.
  9. probes   the probe path: the run() of each of the four probes of
              facevae_tpu_torch/probes/ (TPU kernels 7-10, csrc/probe_*.cu)
              at the probe's own shapes, as its entry point calls it, with
              the launch counts set to 0 before and read after (each kernel
              at least once, the plain versions never); then each kernel
              against its plain version on the same inputs: the gathers bit
              for bit (all seven cases of probe 9), the warps within 1e-5 of
              max|ref|, probe 8 at theta = 3 and 40 degrees in each mode
              (bandonly only where every box fits); probe 8 against kernel 1
              on the same samples (1e-5, and whether bit for bit), its boxes
              staged where the host says they fit, and the probe's fit rates
              1.00 / 0.08.  The device's time per call of kernel, plain
              version and library call (10 calls captured in one CUDA
              graph, the median CUDA-event time of 20 replays over 10: the
              host's Python would otherwise outlast these kernels), and
              the bounds; probe 9 beside its launch floor, an empty kernel in
              its grid timed the same way; F.grid_sample also on the probes' own layouts
              (probe 7: volT's permuted view; probe 8: its fp32 source made
              from rows3 inside the timed call).
Then a JSON line of kernel results (``launches_by_path`` per main path,
``reference``, ``eval``, ``train_loop``, ``video``, ``remat``, ``variants`` and the graph
path's ``scan_float32`` / ``scan_bfloat16`` included; kernels 1 and 4 also
``eval_n1``, kernel 1 also ``aug``), the reference phase's figures, the eval rates, the training loop's
rates, the video phase's, the dp, scan, remat, variants and library
figures, the card's name and power limit, and the last line
{"ok": true, "device": {...}}.  There is no CPU fallback: without a CUDA
device the script fails.  To debug one phase on the card, import this
module and call its phase function.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_tiny.npz"
BF16_STEP_GOLDEN = ROOT / "tests" / "data" / "torch_bf16_step_tiny.npz"
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "warp_fwd": ("facevae_tpu_torch/csrc/warp_fwd.cu",
                 "facevae_tpu/ops/pallas/warp_mm.py:132"),     # _fwd_multi_kernel
    "warp_bwd_dgrid": ("facevae_tpu_torch/csrc/warp_bwd.cu",
                       "facevae_tpu/ops/pallas/warp_mm.py:192"),  # _dgrid_multi_kernel
    "warp_bwd_dx": ("facevae_tpu_torch/csrc/warp_bwd.cu",
                    "facevae_tpu/ops/pallas/warp_mm.py:247"),     # _drows_multi_kernel
    "grid_fwd": ("facevae_tpu_torch/csrc/warp_grid.cu",
                 "facevae_tpu/ops/pallas/warp_mm.py:358"),     # _fwd_kernel
    "grid_bwd_dgrid": ("facevae_tpu_torch/csrc/warp_grid.cu",
                       "facevae_tpu/ops/pallas/warp_mm.py:415"),  # _dgrid_kernel
    "grid_bwd_dx": ("facevae_tpu_torch/csrc/warp_grid.cu",
                    "facevae_tpu/ops/pallas/warp_mm.py:435"),     # _drows_kernel
    # the dx kernels' deterministic variants (torch.use_deterministic_algorithms)
    "warp_bwd_dx_det": ("facevae_tpu_torch/csrc/warp_bwd.cu",
                        "facevae_tpu/ops/pallas/warp_mm.py:247"),
    "grid_bwd_dx_det": ("facevae_tpu_torch/csrc/warp_grid.cu",
                        "facevae_tpu/ops/pallas/warp_mm.py:435"),
}
# the probe path's kernels (phase 9): name -> (source, the TPU kernel it replaces)
PROBE_KERNELS = {
    "probe_warp": ("facevae_tpu_torch/csrc/probe_warp.cu",
                   "tools/proto_pallas_warp.py:43"),           # warp_kernel (pallas_warp)
    "probe_banded_warp": ("facevae_tpu_torch/csrc/probe_warp.cu",
                          "tools/proto_banded_warp.py:120"),   # banded_fwd_kernel (run_banded)
    "probe_gather": ("facevae_tpu_torch/csrc/probe_gather.cu",
                     "tools/microbench_pallas_gather.py:25"),  # gather_kernel (run_case)
    "probe_lane_gather": ("facevae_tpu_torch/csrc/probe_gather.cu",
                          "tools/microbench_lane_gather.py:31"),  # main's kernel
}
PROBE_TOL = 1e-5                  # the probe warps vs plain and vs kernel 1, of max|ref|
PROBE_FIT = {3.0: "1.00", 40.0: "0.08"}   # probe 8's ZB fit rates at its thetas
N_BATCH, VOLUME = 8, (16, 64, 64)     # batch 8, D x H x W of the appearance volume
ALL, BOTH = ("fwd", "bwd_dgrid", "bwd_dx"), ("float32", "bfloat16")
# call sites: (site, kernel family, C, K1 or gps, volume, dtypes, halves, in
# the JSON line).  The "kernels" JSON line sums the fp32 rows of the main
# paths' sites: MFE and the Generator for the multi-grid kernels (the
# Generator's runs at bf16), the Generator for the single-grid ones.
SITES = (("MFE", "warp", 4, 15, VOLUME, BOTH, ALL, True),
         ("MFE sparse motion", "warp", 4, 15, VOLUME, BOTH, ALL, False),
         ("MFE sparse motion + probes", "warp", 4, 15, VOLUME, BOTH, ALL, False),
         ("Generator", "warp", 32, 1, VOLUME, BOTH, ALL, True),
         ("TPS", "warp", 3, 1, (1, 256, 256), ("bfloat16",), ("fwd",), False),
         ("Generator", "grid", 32, 1, VOLUME, BOTH, ALL, True),
         ("MFE reference form", "grid", 4, 16, VOLUME, BOTH, ALL, False),
         ("Generator sparse motion", "warp", 32, 1, VOLUME, BOTH, ALL, False),
         ("Generator sparse motion + probes", "warp", 32, 1, VOLUME, BOTH, ALL, False),
         ("Generator sparse motion", "grid", 32, 1, VOLUME, BOTH, ALL, False),
         ("Generator sparse motion + probes", "grid", 32, 1, VOLUME, BOTH, ALL, False))
HBM_BYTES_PER_S = 3.35e12         # H100 SXM
FP32_FLOPS = 67e12                # H100 SXM, fp32 outside the tensor cores
# kernel vs plain limits, relative to max|plain|: the forward and dgrid
# differ only in the order of their fp32 sums (dgrid reads the same bf16
# values as fp32 in both); dx sums with atomics in varying order (fp32) and
# rounds each output to bf16 once (bf16)
KERNEL_TOL = {"fwd": {"float32": 1e-5, "bfloat16": 1e-2},
              "bwd_dgrid": {"float32": 1e-5, "bfloat16": 1e-5},
              "bwd_dx": {"float32": 1e-5, "bfloat16": 1e-2}}
CROSS_TOL = 1e-5                  # single-grid vs multi-grid forward, same samples
# card vs CPU training step: fp32 as tests/test_torch_train.py, within
# SPREAD x the CPU step's own change under inputs nudged by NUDGE, plus these;
# bf16 as tests/test_torch_bf16.py, within BF16_SPREAD x the bf16 noise the
# recorded step carries (the CPU's bf16-vs-fp32 difference and its bf16
# changes under inputs nudged by half a bf16 ulp), plus these
TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3, "grad_floor": 1e-2}
SPREAD, NUDGE = 10.0, 2.0 ** -20
BF16_TRAIN_TOL = {"loss": 1e-3, "grad": 1e-2, "grad_floor": 1e-2}
BF16_SPREAD, BF16_NUDGE = 3.0, 2.0 ** -9
# phase 6's CPU reference steps run in a fresh process with their CPU math
# pinned: one instruction set for ATen's kernels, oneDNN and MKL on every
# host (AVX-512 without its later extensions, which the card's host has;
# 4 and 8 threads give the same bits there), and a fixed thread count
CPU_REF_ENV = {"ATEN_CPU_CAPABILITY": "avx512", "ONEDNN_MAX_CPU_ISA": "AVX512_CORE",
               "MKL_CBWR": "AVX512"}
CPU_REF_THREADS = 4
TRAIN_STEPS, TRAIN_WARMUP = 5, 2
# port vs JAX golden, relative to max|ref| (the CPU test's tolerance): fp32
# through a few conv layers, amplified by the 0.1-temperature soft-argmax
GOLDEN_TOL = 1e-4
ROUNDS, CONCURRENCY, MAX_BATCH = 4, 16, 8
# the eval phase: full-width test videos and frames each; the tiny card-vs-CPU
# limits: mode m's L1 and MSE (absolute, plus their 1e-6 rounding) and PSNR (dB),
# and gif frames in levels of 255 (fp32 differences of ~1e-5 cross a truncation)
EVAL_VIDEOS, EVAL_FRAMES = 2, 17
EVAL_TOL = {"mean": 1e-4 + 1e-6, "psnr_db": 0.01, "levels": 1}
# the train_loop phase: the augmentation's frame size; kernel 1 vs plain there,
# of max|ref| (bf16: the same fp32 sum, in another order, rounded to bf16 on
# either side of a rounding boundary: one bf16 step, at most 2^-7 of
# max|ref|); the augmentation's warp on the card (bf16 rows and output) vs
# the CPU's (fp32): two roundings of half a bf16 step; the PNG tree
# (identities, clips, frames) and its repeats: 3 steps an epoch at batch 8
AUG_SIZE = 256
AUG_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
AUG_WARP_TOL = 2.0 ** -7
TRAIN_TREE, TRAIN_REPEATS = (4, 2, 6), 6
# the scan phase: steps a call of the dispatcher (the eager warm-up, the
# capture and its replay, the timed call, the profiled call), the replays
# held against the eager step, the seed of the draws
SCAN_CALLS, SCAN_HELD, SCAN_SEED = (2, 1, 4, 2), 2, 1
SCAN_PIPE = 4                     # the eager loop's steps timed back to back in phase scan
DP_SEEDS = (7, 8, 9, 10)          # phase dp's full-width steps, the last three timed
# the remat phase's full-width steps: (dtype, batch); batch 8 is held to the
# step without remat
REMAT_CASES = (("float32", 8), ("bfloat16", 8), ("float32", 16))
# the variants phase: full-width changes (conv4's latent of 256 must
# unflatten into its encoder map, 2 x 2 x 64); each variant's CPU test size
# (tests/test_torch_variants*.py): (image size, ModelConfig changes, batch);
# card vs CPU limits of max|cpu| (the fp32 tests' tolerances; conv6's
# keypoints: the CPU softmax's sequential fp32 sum over its (256, 64, 64)
# volume, 5e-4 of the heatmap off the float64 answer)
VARIANT_FULL = {"conv4": {"efe_down_seq": (3, 32, 64, 128, 256, 64)}}
VARIANT_CPU = {"conv": (128, {}, 2), "conv2": (128, {}, 2), "conv5": (128, {}, 2),
               "conv4": (128, {"efe_down_seq": (3, 8, 16, 24, 32, 256)}, 2),
               "conv3": (256, {"efe_up_seq": (32, 16, 8)}, 1), "conv6": (256, {"depth": 16}, 1),
               "linear": (256, {}, 1), "lin_conv": (256, {}, 1)}
VARIANT_TOL = {"eval": 1e-4, "train": 1e-3}
CONV6_KP_TOL = 3e-3
# the library phase (the modules no model path runs): card vs CPU at the CPU
# tests' sizes and tolerances (tests/test_torch_grid_sample.py,
# test_torch_rotations_heatmap.py, test_torch_wn.py, test_torch_lpips.py), of
# max|cpu|; at full size (N_BATCH, VOLUME, the AUG_SIZE frame) grid_sample
# vs F.grid_sample, of max|x|; the rotations' N there
LIBRARY_TOL = {"grid_fwd": 1e-6, "grid_grad": 1e-5, "rot": {"float32": 1e-6, "float64": 1e-12},
               "heat": {"float32": 1e-6, "bfloat16": 2.0 ** -6}, "layer": 1e-5, "fuse": 1e-6,
               "net": 1e-4, "grid_vs_library": 1e-5}
LIBRARY_ROTATIONS, LIBRARY_SEED = 4096, 15
# a card-vs-CPU hold above this share of its limit prints where its error
# comes from (phase variants: each module of the EFE; phase library: each
# step of the channel-first heatmaps)
NEAR_LIMIT = 0.8


# the reference phase: the JAX package's eager creation order of the seven
# nets and the tiny golden of its order-zip (tests/make_torch_reference_golden.py),
# the seeds and epoch of the files it writes, the card-vs-CPU limit on the frames of one
# converted file (of max|ref|: the serving golden's, GOLDEN_TOL) and the
# packages no process of the phase may import
REF_ORDER = ROOT / "tests" / "data" / "torch_reference_order.json"
REF_GOLDEN = ROOT / "tests" / "data" / "torch_reference_tiny.npz"
REF_SEED, REF_EPOCH = 23, 44
REF_TOL = GOLDEN_TOL
NO_JAX = ("jax", "jaxlib", "flax", "facevae_tpu")
# torchvision's VGG19 and the Oxford VGG-Face-16 conv stacks ("M": a max-pool)
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512, "M")


BENCH_MS = {}                     # phases 7-8's median step ms by dtype, for phase scan


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return out.splitlines()[0].strip()


def cuda_ms(fn, runs=20, warmup=3):
    """Median CUDA-event time of fn() in ms over ``runs`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_device():
    import torch
    from facevae_tpu_torch import numerics
    card = smi()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[device] numerics {numerics.apply()}")
    print(f"[device] packages the port's data path needs: {json.dumps(needed_packages())}; "
          f"not needed (the JAX package's: the port reads video and image files through PIL "
          f"and cv2 and writes TensorBoard files itself): "
          f"{json.dumps(optional_packages())}")
    return card


def needed_packages():
    """PIL and cv2, which the port's readers and the CPU augmentation
    import: name -> version, and cv2's video backends (what reads .mp4)
    and the FFmpeg lines of its build information; a missing one is
    reported, and fails where it is used."""
    import importlib
    out = {}
    for name in ("PIL", "cv2"):
        try:
            out[name] = importlib.import_module(name).__version__
        except ImportError as e:
            out[name] = f"no ({e})"
    if "cv2" in sys.modules:
        cv2 = sys.modules["cv2"]
        reg = cv2.videoio_registry
        out["cv2_backends"] = [reg.getBackendName(b) for b in reg.getBackends()]
        out["cv2_stream_backends"] = [reg.getBackendName(b) for b in reg.getStreamBackends()]
        out["cv2_ffmpeg"] = [ln.strip() for ln in cv2.getBuildInformation().splitlines()
                             if "FFMPEG" in ln or "avcodec" in ln]
    return out


def optional_packages():
    """Whether each package the JAX package's data path imports and the
    port does not (imageio, pandas, matplotlib, tensorboardX) is installed
    here, looked up without importing it (phase video checks that none
    was imported): name -> version, or "not installed"."""
    import importlib.metadata
    import importlib.util
    out = {}
    for name in ("imageio", "pandas", "matplotlib", "tensorboardX"):
        if importlib.util.find_spec(name) is None:
            out[name] = "not installed"
            continue
        try:
            out[name] = importlib.metadata.version(name)
        except importlib.metadata.PackageNotFoundError:
            out[name] = "installed"
    return out


def _ptxas_entries(report):
    """nvcc -Xptxas -v's report -> {entry point: {"frame": its stack-frame /
    spill line, "used": its registers / shared-memory line}}."""
    entries, name = {}, None
    for ln in report.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln or "Function properties for" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.rsplit(" ", 1)[-1]
            entries.setdefault(name, {})
        elif name and "stack frame" in ln:
            entries[name]["frame"] = ln
        elif name and ln.startswith("ptxas info    : Used"):
            entries[name]["used"] = ln.split(":", 1)[1].strip()
    return entries


def _demangled(names):
    """C++ names of mangled entry points without their parameter lists
    (c++filt -p where the toolkit's host has it, else as they are)."""
    import shutil
    names = list(names)
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt", "-p"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = [n.replace("(anonymous namespace)::", "") for n in out]
    return names


def phase_build():
    """Builds every library; per library its entry points, naming those that
    spill or keep a stack frame, and the registers and shared memory of the
    single-grid forward's (kernel 4's) entry points."""
    from facevae_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.load_all()
    for name in kernels.LIBRARIES:
        info = kernels.build_info[name]
        print(f"[build] {name} built in {info['seconds']:.2f} s")
        entries = _ptxas_entries(info["ptxas"])
        none = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
        framed = {e: v["frame"] for e, v in entries.items() if v.get("frame", none) != none}
        print(f"[build]   {len(entries)} entry points; {len(framed)} with spills or a stack "
              f"frame: " + ("; ".join(f"{d} ({framed[e]})" for d, e in
                                      zip(_demangled(framed), framed)) or "none"))
        fwd = [e for e in entries if "grid_fwd" in e]
        for d, e in zip(_demangled(fwd), fwd):
            print(f"[build]   kernel 4 {d}: {entries[e].get('used', '?')}")
    print(f"[build] all libraries in {time.perf_counter() - t0:.2f} s (in parallel)")


def _bound_ms(half, N, D, H, W, C, K1, item):
    """Least time for a kernel's work on an H100: each input read once and
    each output written once over 3.35 TB/s, against its fp32 operations
    (8 corners x (C multiply-adds + weights) per sample) over 67 TFLOP/s.
    Both warp families move the same bytes for the same samples."""
    NV = D * H * W
    vol, coords, samples = N * NV * C * item, 3 * N * K1 * NV * 4, N * NV * K1 * C * item
    nbytes = {"fwd": vol + coords + samples,
              "bwd_dgrid": vol + coords + samples + 3 * N * K1 * NV * 4,
              "bwd_dx": coords + samples + N * NV * C * 4}[half]
    flops = N * K1 * NV * 8 * (2 * C + 12)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _deterministic(fn):
    """fn() under torch.use_deterministic_algorithms(True), where the
    wrappers launch the dx kernels' deterministic variants; the mode off
    after."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def _site_calls(family, x, coords, grid, gout, gps, spatial):
    """name -> (kernel call, plain call) of one site's kernels."""
    from facevae_tpu_torch.ops import fast_warp as fw
    if family == "warp":
        return {
            "warp_fwd": (lambda: fw.warp_multi_pixel_cuda(x, *coords, spatial),
                         lambda: fw.warp_multi_pixel_plain(x, *coords, spatial)),
            "warp_bwd_dgrid": (
                lambda: fw.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial, False)[1],
                lambda: fw.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial, False)[1]),
            "warp_bwd_dx": (
                lambda: fw.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial,
                                                     need_dgrid=False)[0],
                lambda: fw.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial,
                                                      need_dgrid=False)[0]),
            "warp_bwd_dx_det": (
                lambda: _deterministic(lambda: fw.warp_multi_pixel_bwd_cuda(
                    x, *coords, gout, spatial, need_dgrid=False)[0]),
                lambda: fw.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial,
                                                      need_dgrid=False)[0])}
    return {
        "grid_fwd": (lambda: fw.grid_sample_3d_cuda(x, grid, gps),
                     lambda: fw.grid_sample_3d_plain(x, grid, gps)),
        "grid_bwd_dgrid": (lambda: fw.grid_sample_3d_bwd_cuda(x, grid, gout, gps, False)[1],
                           lambda: fw.grid_sample_3d_bwd_plain(x, grid, gout, gps, False)[1]),
        "grid_bwd_dx": (lambda: fw.grid_sample_3d_bwd_cuda(x, grid, gout, gps,
                                                           need_dgrid=False)[0],
                        lambda: fw.grid_sample_3d_bwd_plain(x, grid, gout, gps,
                                                            need_dgrid=False)[0]),
        "grid_bwd_dx_det": (lambda: _deterministic(lambda: fw.grid_sample_3d_bwd_cuda(
                                x, grid, gout, gps, need_dgrid=False)[0]),
                            lambda: fw.grid_sample_3d_bwd_plain(x, grid, gout, gps,
                                                                need_dgrid=False)[0])}


def _permuted_dx(x, coords, gout, spatial):
    """The deterministic multi-grid dx with the K1 grids and their gout
    columns permuted (a seeded permutation from a generator of its own, so
    phase 3's draws stay as they were)."""
    import torch
    from facevae_tpu_torch.ops import fast_warp as fw
    N, C, K1 = x.shape[0], x.shape[-1], coords[0].shape[1]
    perm = torch.randperm(K1, generator=torch.Generator().manual_seed(K1)).to(x.device)
    pgout = gout.reshape(N, -1, K1, C)[:, :, perm].reshape(gout.shape).contiguous()
    return _deterministic(lambda: fw.warp_multi_pixel_bwd_cuda(
        x, *(c[:, perm].contiguous() for c in coords), pgout, spatial, need_dgrid=False)[0])


def _grid_fwd_path(x, out, gps):
    """Which of kernel 4's kernels its last launch ran, and on how many of
    its blocks: the launch grid the wrapper reported, held to the plan
    fast_warp._grid_fwd_plan mirrors from the launch code (every block of a
    launch runs the one kernel: no branch is taken per block)."""
    from facevae_tpu_torch.ops import fast_warp as fw
    N, D, H, W, C = x.shape
    launched = fw.launch_grids["grid_fwd"]
    cpt = fw._cpt(C, x.element_size(), x, out)
    kernel, plan = fw._grid_fwd_plan(C, cpt, D * H * W, N * gps)
    check(tuple(launched) == plan, f"kernel 4 launched {launched}, its plan is {plan}")
    blocks = launched[0] * launched[1]
    other = "table" if kernel == "voxel" else "voxel"
    return (f"{kernel} kernel (C / cpt = {C // cpt}) on {blocks} of {blocks} blocks, "
            f"{other} kernel on 0")


def _cross_check(x, grid, gps):
    """The single-grid forward against the multi-grid forward on the same
    samples (the pixel coordinates unnormalized as the single-grid kernel
    does): (max|err|, max|ref|, bit-equal)."""
    import torch
    from facevae_tpu_torch.ops import fast_warp as fw
    N, D, H, W, C = x.shape
    single = fw.grid_sample_3d_cuda(x, grid, gps)
    coords = [((grid[..., a] + 1.0) * 0.5 * (s - 1)).reshape(N, gps, -1).contiguous()
              for a, s in enumerate((W, H, D))]
    multi = fw.warp_multi_pixel_cuda(x, *coords, tuple(grid.shape[1:4]))
    multi = multi.reshape(N, -1, gps, C).permute(0, 2, 1, 3).reshape(single.shape)
    torch.cuda.synchronize()
    return ((single - multi).abs().max().item(), multi.abs().max().item(),
            bool(torch.equal(single, multi)))


def phase_kernels():
    import torch
    from facevae_tpu_torch.warp_inputs import (noisy_coords, normalized, reference_form_grid,
                                               sparse_motion_coords)
    from facevae_tpu_torch.bench_warp import library_calls
    from facevae_tpu_torch.probes.common import graph_ms
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, cross = [], []
    N = N_BATCH
    for site, family, C, K1, (D, H, W), dtypes, halves, in_json in SITES:
        spatial = (D, H, W)
        coords = grid = None
        if site == "MFE reference form":
            grid = reference_form_grid(N, K1 - 1, D, H, W, g)
        else:
            coords = (sparse_motion_coords(N, K1, D, H, W, g, probes=site.endswith("probes"))
                      if "sparse motion" in site else noisy_coords(N, K1, D, H, W, g))
            if site == "TPS":                      # a D=1 frame: z is exactly 0
                coords[2] = torch.zeros_like(coords[2])
            grid = normalized(coords, D, H, W)     # the same samples, normalized
        for dname in dtypes:
            dtype = getattr(torch, dname)
            x = torch.randn(N, D, H, W, C, generator=g, device="cuda").to(dtype)
            gout_gm = torch.randn(N * K1, D, H, W, C, generator=g, device="cuda").to(dtype)
            # the multi-grid ops take the cotangent k-major [N,D,H,W,K1*C]
            gout = (gout_gm if family == "grid" else
                    gout_gm.reshape(N, K1, -1, C).permute(0, 2, 1, 3).reshape(N, D, H, W, K1 * C))
            calls = _site_calls(family, x, coords, grid, gout, K1, spatial)
            library = library_calls(x, grid, gout_gm)
            for name, (kernel, plain) in calls.items():
                half = name.split("_", 1)[1].removesuffix("_det")
                if half not in halves:
                    continue
                out, ref = kernel(), plain()
                torch.cuda.synchronize()
                out = out if isinstance(out, tuple) else (out,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                what = f"{name} {site} {dname}"
                check(all(bool(torch.isfinite(o).all()) for o in out), f"{what}: non-finite output")
                check(all(o.shape == r.shape for o, r in zip(out, ref)),
                      f"{what}: shapes {[tuple(o.shape) for o in out]}")
                err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
                scale = max(r.float().abs().max().item() for r in ref)
                row = dict(name=name, site=site, dtype=dname, C=C, K1=K1, shape=(N, D, H, W, C),
                           err=err, scale=scale, tol=KERNEL_TOL[half][dname] * scale,
                           ms=graph_ms(kernel), event_ms=cuda_ms(kernel),
                           plain_ms=cuda_ms(plain), in_json=in_json,
                           library_ms=graph_ms(library[half]))
                row["bound_ms"], row["bound_by"] = _bound_ms(half, N, D, H, W, C, K1,
                                                             x.element_size())
                if half == "bwd_dx":
                    again = kernel()
                    row["rerun_diff"] = (again.float() - out[0].float()).abs().max().item()
                    row["rerun_equal"] = bool(torch.equal(again, out[0]))
                if name == "warp_bwd_dx_det" and K1 > 1:
                    row["permuted_equal"] = bool(torch.equal(
                        _permuted_dx(x, coords, gout, spatial), out[0]))
                if name == "grid_fwd":
                    row["path"] = _grid_fwd_path(x, out[0], K1)
                rows.append(row)
                rerun = (f"; run-to-run max|diff| {row['rerun_diff']:.3e}"
                         if "rerun_diff" in row else "")
                if "permuted_equal" in row:
                    rerun += f"; K1 grids permuted: bit for bit {row['permuted_equal']}"
                k = "gps" if family == "grid" else "K1"
                print(f"[kernels] {name} {site} x[{N},{D},{H},{W},{C}] {k}={K1} {dname}: "
                      f"max|err| {err:.3e} (limit {row['tol']:.3e}, max|ref| {scale:.3f}); "
                      f"device {row['ms']:.4f} ms (event {row['event_ms']:.4f}), plain "
                      f"{row['plain_ms']:.4f}, F.grid_sample {row['library_ms']:.4f}, "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}){rerun}")
                if "path" in row:
                    print(f"[kernels]   kernel 4 {site} {dname}: {row['path']}")
            if family == "warp":
                nbytes = N * D * H * W * K1 * C * x.element_size()
                tiled = " through its shared-memory tile" if K1 > 1 else ""
                print(f"[kernels]   kernel 1 {site} {dname}: stores {nbytes} B{tiled}"
                      + (f"; kernel 2 reads a cotangent of {nbytes} B, k-major"
                         if "bwd_dgrid" in halves else ""))
            if (family == "grid" and dname == "float32") or site == "TPS":
                err, scale, same = _cross_check(x, grid, K1)
                cross.append((site, err, scale, same))
                print(f"[kernels] single-grid vs multi-grid forward, {site} gps=K1={K1} {dname}: "
                      f"max|err| {err:.3e} (limit {CROSS_TOL * scale:.3e}); "
                      f"bit for bit: {'yes' if same else 'no'}")
    for r in rows:
        check(r["err"] <= r["tol"], f"{r['name']} {r['site']} {r['dtype']}: "
                                    f"{r['err']:.3e} > {r['tol']:.3e}")
        if r["name"].endswith("_det"):
            check(r["rerun_equal"] and r.get("permuted_equal", True),
                  f"{r['name']} {r['site']} {r['dtype']}: not deterministic (run-to-run "
                  f"{r['rerun_diff']:.3e}, K1 permuted equal {r.get('permuted_equal')})")
    for r in rows:
        if r["name"].endswith("_det"):
            base = next(b for b in rows if b["name"] == r["name"][:-4]
                        and (b["site"], b["dtype"]) == (r["site"], r["dtype"]))
            print(f"[kernels] {r['name']} {r['site']} {r['dtype']}: {r['ms']:.4f} ms, "
                  f"{r['ms'] / base['ms']:.2f}x the default dx kernel's {base['ms']:.4f} ms")
    for site, err, scale, _ in cross:
        check(err <= CROSS_TOL * scale, f"single-grid vs multi-grid forward at {site}: "
                                        f"{err:.3e} > {CROSS_TOL * scale:.3e}")
    return rows


def _golden_pipeline(device, z):
    from facevae_tpu_torch.config import tiny_config
    from facevae_tpu_torch.convert import load_jax_variables, nested_from_flat
    from facevae_tpu_torch.models import build_models
    from facevae_tpu_torch.train.inference import InferencePipeline
    variables = nested_from_flat({k[len("var/"):]: z[k] for k in z.files
                                  if k.startswith("var/")})
    cfg = tiny_config()
    models = build_models(cfg.model, device=device)
    for name, m in models.items():
        load_jax_variables(m, variables[name])
    return InferencePipeline(cfg, models)


def phase_golden():
    import numpy as np
    import torch
    z = np.load(GOLDEN)
    pipe = _golden_pipeline(torch.device("cuda"), z)
    s = torch.from_numpy(z["in/source"]).cuda()
    d = torch.from_numpy(z["in/driving"]).cuda()
    enc = pipe.encode_source(s)
    outs = dict(zip(("fs", "kp_c", "kp_s", "Rs"), enc))
    outs["drive"] = pipe.drive_frame(*enc, d)
    outs["frontalize"] = pipe.frontalize_frame(d)
    bad = []
    for k, v in outs.items():
        ref = z["out/" + k]
        err = float(np.abs(v.cpu().numpy() - ref).max())
        lim = GOLDEN_TOL * float(np.abs(ref).max())
        print(f"[golden] {k}: max|err| {err:.3e} (limit {lim:.3e})")
        if not err <= lim:
            bad.append(k)
    check(not bad, f"port differs from the JAX golden in {bad}")


def _post(url, body, timeout=300):
    req = urllib.request.Request(url, data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        data = r.read()
        return r.status, data, time.perf_counter() - t0


def phase_serve(card):
    import numpy as np
    import torch
    from facevae_tpu_torch.config import Config
    from facevae_tpu_torch.models import build_models
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.serve import BatchedEngine, start_server
    from facevae_tpu_torch.train.inference import InferencePipeline

    device = torch.device("cuda")
    cfg = Config()
    size = cfg.model.image_size
    t0 = time.perf_counter()
    models = build_models(cfg.model, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
    pipe = InferencePipeline(cfg, models)
    # a window long enough that 16 concurrent requests always fill two batches
    engine = BatchedEngine(pipe, device, MAX_BATCH, window_ms=2000.0)
    engine.warmup()
    torch.cuda.synchronize()
    print(f"[serve] ModelConfig() {size}x{size} K={cfg.model.num_kp} D={cfg.model.depth} "
          f"C={cfg.model.app_channels} fp32: build + warm-up {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=device).manual_seed(1)
    batch = torch.rand(MAX_BATCH, size, size, 3, generator=g, device=device)
    enc = pipe.encode_source(batch)

    def drive():
        pipe.drive_frame(*enc, batch)
        torch.cuda.synchronize()

    direct_ms = cuda_ms(drive, runs=5, warmup=1)
    engine.flush_ms.clear()
    server = start_server(engine, "127.0.0.1", 0)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    rs = np.random.RandomState(0)
    n_bytes = size * size * 3
    try:
        fast_warp.reset_launch_counts()
        for s in ("a", "b"):
            code, body, _ = _post(f"{base}/source?session={s}",
                                  rs.randint(0, 256, n_bytes, dtype=np.uint8).tobytes())
            check(code == 200, f"/source {s}: HTTP {code} {body[:200]!r}")
        frames = [rs.randint(0, 256, n_bytes, dtype=np.uint8).tobytes()
                  for _ in range(CONCURRENCY)]
        lat, results, wall = [], [], 0.0
        for _ in range(ROUNDS):
            out = [None] * CONCURRENCY

            def go(i):
                try:
                    out[i] = _post(f"{base}/drive?session={'ab'[i % 2]}", frames[i])
                except Exception as e:                   # reported below
                    out[i] = (repr(e), b"", 0.0)

            threads = [threading.Thread(target=go, args=(i,)) for i in range(CONCURRENCY)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall += time.perf_counter() - t0
            results += out
            lat += [r[2] for r in out]
        for code, body, _ in results:
            check(code == 200 and len(body) == n_bytes,
                  f"/drive: HTTP {code}, {len(body)} bytes {body[:200]!r}")
        st = dict(engine.stats)
        n_drive = ROUNDS * CONCURRENCY
        check(st == {"batches": n_drive // MAX_BATCH, "frames": n_drive, "padded": 0},
              f"/drive batches not full: {st}")
        code, body, _ = _post(f"{base}/frontalize", frames[0])
        check(code == 200 and len(body) == n_bytes, f"/frontalize: HTTP {code}, {len(body)} bytes")
        counts = dict(fast_warp.launches)
        batches = engine.stats["batches"]
        print(f"[serve] engine {engine.stats}; warp launches {counts}")
        want = {**dict.fromkeys(counts, 0), "warp_fwd": batches, "grid_fwd": batches}
        check(counts == want, f"warp launches {counts} for {batches} batches: expected "
                              f"{want} (MFE's multi-grid and the Generator's single-grid "
                              "forward once per batch, no plain version)")
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()

    imgs = torch.from_numpy(np.stack([np.frombuffer(f, np.uint8).reshape(size, size, 3)
                                      for f in frames[:MAX_BATCH]]).astype(np.float32) / 255)
    enc = pipe.encode_source(imgs.to(device))
    gen = pipe.drive_frame(*enc, imgs.to(device))
    check(gen.shape == (MAX_BATCH, size, size, 3), f"drive_frame shape {tuple(gen.shape)}")
    check(bool(torch.isfinite(gen).all()) and 0 <= gen.min().item() and gen.max().item() <= 1,
          "drive_frame output not finite in [0, 1]")
    lat.sort()
    p50 = statistics.median(lat)
    p95 = lat[min(len(lat) - 1, int(round(0.95 * (len(lat) - 1))))]
    print(f"[serve] {card}: {n_drive} /drive requests in {ROUNDS} rounds of {CONCURRENCY} "
          f"concurrent, batch {MAX_BATCH}: p50 {p50 * 1e3:.1f} ms, p95 {p95 * 1e3:.1f} ms, "
          f"{n_drive / wall:.2f} frames/s; output std {gen.std().item():.4f}")
    print(f"[serve] drive batch of {MAX_BATCH}: {direct_ms:.1f} ms called directly, "
          f"median {statistics.median(engine.flush_ms):.1f} ms per engine flush "
          f"({len(engine.flush_ms)} flushes)")
    return counts


# per training step: fp32 runs MFE through the multi-grid kernels and the
# Generator through the single-grid ones; bf16 runs MFE, the Generator and
# the TPS warp (forward only) through the multi-grid kernels
STEP_LAUNCHES = {"float32": {"warp_fwd": 1, "warp_bwd_dgrid": 1, "warp_bwd_dx": 1,
                             "grid_fwd": 1, "grid_bwd_dgrid": 1, "grid_bwd_dx": 1},
                 "bfloat16": {"warp_fwd": 3, "warp_bwd_dgrid": 2, "warp_bwd_dx": 2}}


def _want(counts, dtype, steps, deterministic=False):
    """The launch counts of ``steps`` steps: STEP_LAUNCHES, the dx kernels'
    deterministic variants in their place under deterministic algorithms,
    every other count (the plain versions) 0."""
    per_step = {(k + "_det" if deterministic and k.endswith("_dx") else k): v
                for k, v in STEP_LAUNCHES[dtype].items()}
    return {**dict.fromkeys(counts, 0), **{k: steps * v for k, v in per_step.items()}}


def numpy_weights(nets, seed):
    """Fill every parameter and buffer of ``nets`` (dict order, then
    state_dict order) from numpy's RandomState(seed), which draws the same
    numbers on every machine and torch version: kernels and biases
    U(-1/sqrt(fan_in), +), norm scales U(0.8, 1.2), norm biases and running
    means U(-0.1, 0.1), running variances U(0.5, 1.5), spectral u, v by 20
    power iterations on the filled kernel."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    for net in nets.values():
        sd = net.state_dict()
        vals = {}
        for key, t in sd.items():
            stem, leaf = key.rpartition(".")[::2]
            kernel = sd.get(f"{stem}.weight" if stem else "weight")
            if leaf in ("weight_u", "weight_v"):
                continue
            if t.dim() >= 2 or (leaf == "bias" and kernel is not None and kernel.dim() >= 2):
                fan_in = kernel[0].numel()
                vals[key] = rs.uniform(-1, 1, tuple(t.shape)) / np.sqrt(fan_in)
            elif leaf == "weight":
                vals[key] = rs.uniform(0.8, 1.2, tuple(t.shape))
            elif leaf in ("bias", "running_mean"):
                vals[key] = rs.uniform(-0.1, 0.1, tuple(t.shape))
            elif leaf == "running_var":
                vals[key] = rs.uniform(0.5, 1.5, tuple(t.shape))
            else:
                raise ValueError(f"numpy_weights: no rule for {key}")
        for key in sd:
            stem, leaf = key.rpartition(".")[::2]
            if leaf == "weight_u":
                vals[key], vals[f"{stem}.weight_v"] = _power_iteration(
                    rs, vals[f"{stem}.weight"], steps=20)
        with torch.no_grad():
            for key, t in sd.items():
                t.copy_(torch.from_numpy(np.asarray(vals[key], np.float32)))
    return nets


def _draw(rs, leaf, shape):
    """Seeded values of one reference leaf, from numpy's RandomState, on a
    grid of 32 levels (the goldens compress): conv and linear weights in
    [-2 s, 2 s) for s the power of two nearest 1/sqrt(fan_in) / 1.155
    (a forward stays finite), norm scales and running variances 1 + [-1/8,
    1/8), biases and running means [-1/8, 1/8); num_batches_tracked a count."""
    import math
    import numpy as np

    def grid(scale):
        return (rs.randint(-16, 16, size=shape) * (scale / 8)).astype(np.float32)

    if leaf == "num_batches_tracked":
        return np.asarray(rs.randint(1, 10 ** 6), np.int64)
    if leaf in ("weight", "weight_orig") and len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        return grid(2.0 ** -round(math.log2(1.155 * math.sqrt(fan_in))))
    if leaf in ("weight", "running_var"):
        return 1 + grid(1 / 16)
    return grid(1 / 16)


def _power_iteration(rs, w, steps=10):
    """Spectral norm's u, v for weight ``w`` [O, ...] (torch's (I, K...)
    flattening of v): ``steps`` power iterations in float64 from a random
    u, rounded to fp32."""
    import numpy as np
    w = w.reshape(w.shape[0], -1).astype(np.float64)
    u = rs.randn(w.shape[0])
    for _ in range(steps):
        v = w.T @ u
        v /= np.linalg.norm(v)
        u = w @ v
        u /= np.linalg.norm(u)
    return u.astype(np.float32), v.astype(np.float32)


def reference_state_dict(order, seed):
    """A seeded state dict in the reference's layout for one net's creation
    order (a net of tests/data/torch_reference_order.json): torch's leaf
    names and layouts, keys layers.<i>.<leaf> (names neither package uses:
    the order-zip goes by order alone), spectral norm's weight_orig /
    weight_u / weight_v in torch.nn.utils.spectral_norm's order (u, v from
    power iterations on weight_orig), BatchNorm's running_mean / running_var
    / num_batches_tracked; values from _draw."""
    import numpy as np
    rs = np.random.RandomState(seed)
    sd = {}
    for i, row in enumerate(order):
        mod, leaves = f"layers.{i}", row["leaves"]
        if "kernel" in leaves:                  # flax HWIO / DHWIO / (in, out) -> torch
            k = leaves["kernel"]
            w = [k[1], k[0]] if len(k) == 2 else [k[-1], k[-2]] + k[:-2]
            if "spectral" in row:
                if "bias" in leaves:
                    sd[f"{mod}.bias"] = _draw(rs, "bias", leaves["bias"])
                sd[f"{mod}.weight_orig"] = _draw(rs, "weight_orig", w)
                sd[f"{mod}.weight_u"], sd[f"{mod}.weight_v"] = _power_iteration(
                    rs, sd[f"{mod}.weight_orig"])
                continue
            sd[f"{mod}.weight"] = _draw(rs, "weight", w)
        elif "weight" in leaves:                # the ELR layers: torch's layout already
            sd[f"{mod}.weight"] = _draw(rs, "weight", leaves["weight"])
        elif "scale" in leaves:
            sd[f"{mod}.weight"] = _draw(rs, "weight", leaves["scale"])
        if "bias" in leaves:
            sd[f"{mod}.bias"] = _draw(rs, "bias", leaves["bias"])
        if "bn_mean" in leaves:
            for leaf, flax in (("running_mean", "bn_mean"), ("running_var", "bn_var"),
                               ("num_batches_tracked", None)):
                sd[f"{mod}.{leaf}"] = _draw(rs, leaf, leaves[flax] if flax else ())
    return sd


def teacher_state_dicts(seed):
    """Seeded state dicts of the three teachers in their downloads' layouts
    and shapes: torchvision's VGG19 ``features.N`` (its 16 convs), the
    Oxford vgg_face_dag's 13 convs ``convX_Y``, and the reference's Hopenet
    (a torchvision ResNet50 trunk, fc_yaw / fc_pitch / fc_roll and the
    vestigial fc_finetune); the VGG classifiers (fc6-8), which no converter
    reads, left out.  Values from _draw."""
    import numpy as np
    rs = np.random.RandomState(seed)
    shapes = {"vgg19": [], "vggface": [], "hopenet": []}
    cin, idx = 3, 0
    for v in VGG19_CFG:
        if v != "M":
            shapes["vgg19"] += [(f"features.{idx}.weight", (v, cin, 3, 3)),
                                (f"features.{idx}.bias", (v,))]
            cin, idx = v, idx + 1
        idx += 1
    cin, block, conv = 3, 1, 1
    for v in VGG16_CFG:
        if v == "M":
            block, conv = block + 1, 1
            continue
        shapes["vggface"] += [(f"conv{block}_{conv}.weight", (v, cin, 3, 3)),
                              (f"conv{block}_{conv}.bias", (v,))]
        cin, conv = v, conv + 1

    def bn(name, c):
        return [(f"{name}.{leaf}", () if leaf == "num_batches_tracked" else (c,))
                for leaf in ("weight", "bias", "running_mean", "running_var",
                             "num_batches_tracked")]

    hop = [("conv1.weight", (64, 3, 7, 7))] + bn("bn1", 64)
    inplanes = 64
    for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for b in range(blocks):
            p = f"layer{li + 1}.{b}"
            for c, (cout, cin_, k) in enumerate(((planes, inplanes, 1), (planes, planes, 3),
                                                 (planes * 4, planes, 1)), 1):
                hop += [(f"{p}.conv{c}.weight", (cout, cin_, k, k))] + bn(f"{p}.bn{c}", cout)
            if b == 0:
                hop += ([(f"{p}.downsample.0.weight", (planes * 4, inplanes, 1, 1))]
                        + bn(f"{p}.downsample.1", planes * 4))
            inplanes = planes * 4
    for head, out in (("fc_yaw", 66), ("fc_pitch", 66), ("fc_roll", 66), ("fc_finetune", 3)):
        fan_in = 2048 + (3 if head == "fc_finetune" else 0)
        hop += [(f"{head}.weight", (out, fan_in)), (f"{head}.bias", (out,))]
    shapes["hopenet"] = hop
    return {t: {k: _draw(rs, k.rsplit(".", 1)[1], shape) for k, shape in rows}
            for t, rows in shapes.items()}


def tiny_step_inputs(seed=0):
    """The images [4][2,64,64,3] and TPS parameters of the tiny step, from
    numpy: (RandomState after the draws, images, (theta, control points,
    control params))."""
    import numpy as np
    rs = np.random.RandomState(seed)
    batch = [rs.rand(2, 64, 64, 3).astype(np.float32) for _ in range(4)]
    y, x = np.meshgrid(np.linspace(-1, 1, 5), np.linspace(-1, 1, 5), indexing="ij")
    tp = ((np.eye(2, 3)[None] + 0.05 * rs.randn(2, 2, 3)).astype(np.float32),
          np.stack([x, y], -1).reshape(1, 25, 2).astype(np.float32),
          (0.005 * rs.randn(2, 1, 25)).astype(np.float32))
    return rs, batch, tp


def tiny_step(device, images, dtype, tp, seed=0, vae_eps=None):
    """One tiny_config(compute_dtype=dtype) training step of the port on
    ``device`` from numpy_weights(seed): ({loss: value}, {net: {param:
    gradient}}), numpy.  With vae_eps (numpy [2, 16]) the step samples the
    driving frame's VAE with that eps (TrainConfig.train_vae, LossConfig.kl
    = 1)."""
    import dataclasses
    import torch
    from facevae_tpu_torch.config import tiny_config
    from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
    from facevae_tpu_torch.ops.tps import TransformParams
    from facevae_tpu_torch.train import build_all_modules, create_train_state, train_step
    cfg = tiny_config(compute_dtype=dtype)
    if vae_eps is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, train_vae=True),
                                  loss=dataclasses.replace(cfg.loss, kl=1.0))
        vae_eps = torch.from_numpy(vae_eps).to(device)
    nets = numpy_weights(build_all_modules(cfg, device), seed)
    state = create_train_state(cfg, device, nets)
    out = train_step(state, [torch.from_numpy(b).to(device) for b in images],
                     transform_params=TransformParams(*(torch.from_numpy(a).to(device)
                                                        for a in tp)), vae_eps=vae_eps)
    losses = {k: float(v) for k, v in {**out["losses_g"], **out["losses_d"]}.items()}
    grads = {n: {k: p.grad.detach().cpu().numpy() for k, p in state.nets[n].named_parameters()}
             for n in G_MODEL_NAMES + D_MODEL_NAMES}
    return losses, grads


def held_step(losses, grads, ref_losses, ref_grads, noise, factor, tol):
    """Hold a step's losses and gradients to a reference step's: each within
    factor x its rounding noise (noise(kind, name, key) -> a max distance)
    + tol's floor.  Returns (failures, worst err/limit and where)."""
    import numpy as np
    bad, worst = [], (0.0, "")

    def hold(what, a, r, n, rel, scale):
        nonlocal worst
        err = _distance(a, r)
        lim = factor * n + rel * scale
        ratio = err / lim if lim > 0 else (0.0 if err == 0 else float("inf"))
        worst = max(worst, (ratio, what))
        if not err <= lim:
            bad.append(f"{what}: {err:.3e} > {lim:.3e}")

    for k, v in losses.items():
        hold(f"loss {k}", v, ref_losses[k], noise("loss", k, None), tol["loss"],
             abs(ref_losses[k]))
    for n, gs in grads.items():
        top = max(float(np.abs(g).max()) for g in ref_grads[n].values())
        for k, g in gs.items():
            r = ref_grads[n][k]
            hold(f"{n}.{k} grad", g, r, noise("grad", n, k), tol["grad"],
                 max(float(np.abs(r).max()), tol["grad_floor"] * top))
    return bad, worst


def _distance(a, b):
    import numpy as np
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def cpu_references(path):
    """Phase 6's CPU steps, pickled to ``path``; run by ``chip_smoke.py
    --cpu-refs PATH`` in a fresh process whose CPU math is pinned
    (CPU_REF_ENV, CPU_REF_THREADS), so that no earlier phase, thread count
    or host CPU's instruction set changes their bits: the fp32 step on the
    images and on them nudged, and the train_vae step on both, with the
    host's CPU and torch's capability beside them."""
    import pickle
    import platform
    import numpy as np
    import torch
    torch.set_num_threads(CPU_REF_THREADS)
    rs, batch, tp = tiny_step_inputs()
    nudged = [(b * (1 + NUDGE * rs.randn(*b.shape))).astype(np.float32) for b in batch]
    eps = rs.randn(2, 16).astype(np.float32)
    cpu = [line.split(":", 1)[1].strip() for line in Path("/proc/cpuinfo").read_text().splitlines()
           if line.startswith("model name")][:1] if Path("/proc/cpuinfo").exists() else []
    out = {"cpu": tiny_step("cpu", batch, "float32", tp),
           "cpu_nudged": tiny_step("cpu", nudged, "float32", tp),
           "vae": tiny_step("cpu", batch, "float32", tp, vae_eps=eps),
           "vae_nudged": tiny_step("cpu", nudged, "float32", tp, vae_eps=eps), "eps": eps,
           "host": {"cpu": (cpu or [platform.processor()])[0],
                    "capability": torch.backends.cpu.get_cpu_capability(),
                    "threads": torch.get_num_threads(), "torch": torch.__version__}}
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return 0


def _cpu_references():
    """cpu_references' result, from a fresh process (the pinned CPU math)."""
    import os
    import pickle
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/refs.pkl"
        res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--cpu-refs", path],
                             env={**os.environ, **CPU_REF_ENV}, cwd=ROOT, capture_output=True,
                             text=True, timeout=900)
        check(res.returncode == 0, f"the CPU reference steps failed: {res.stderr[-2000:]}")
        with open(path, "rb") as f:
            return pickle.load(f)


def phase_train_tiny():
    """One tiny_config() step on the card against the port's step on the
    CPU, from the same numpy weights, images and TPS parameters: fp32
    against a CPU step run in a pinned process here (cpu_references); bf16
    against the CPU bf16 step recorded in tests/data/torch_bf16_step_tiny.npz
    (tools/make_torch_step_golden.py: run on the card's machine, two CPU
    bf16 steps did not finish in 20 minutes)."""
    import hashlib
    import numpy as np
    import torch
    from facevae_tpu_torch.ops import fast_warp
    _, batch, tp = tiny_step_inputs()
    cpu_refs = _cpu_references()
    cpu, cpu_nudged = cpu_refs["cpu"], cpu_refs["cpu_nudged"]
    digest = hashlib.sha256(json.dumps(cpu[0], sort_keys=True).encode()).hexdigest()[:12]
    print(f"[train_tiny] CPU reference steps in a fresh process ({json.dumps(CPU_REF_ENV)}, "
          f"{json.dumps(cpu_refs['host'])}; this host's own capability "
          f"{torch.backends.cpu.get_cpu_capability()}): fp32 losses digest {digest}, "
          f"E {cpu[0]['E']:.5f}")
    z = np.load(BF16_STEP_GOLDEN)
    gold = ({k[len("loss/"):]: float(z[k]) for k in z.files if k.startswith("loss/")},
            {})
    for k in z.files:
        if k.startswith("grad/"):
            _, n, key = k.split("/", 2)
            gold[1].setdefault(n, {})[key] = z[k]
    refs = {
        "float32": (cpu, lambda kind, n, k: (_distance(cpu_nudged[0][n], cpu[0][n]) if kind == "loss"
                                              else _distance(cpu_nudged[1][n][k], cpu[1][n][k])),
                    SPREAD, TRAIN_TOL),
        "bfloat16": (gold, lambda kind, n, k: float(z[f"noise/loss/{n}" if kind == "loss"
                                                       else f"noise/grad/{n}/{k}"]),
                     BF16_SPREAD, BF16_TRAIN_TOL)}
    det_paths = {}
    for dtype, ((ref_losses, ref_grads), noise, factor, tol) in refs.items():
        for det in (False, True):
            tag = f"{dtype}{' deterministic' if det else ''}"
            fast_warp.reset_launch_counts()
            # strict: an op of the step without a deterministic implementation raises
            torch.use_deterministic_algorithms(det)
            try:
                losses, grads = tiny_step("cuda", batch, dtype, tp)
                torch.cuda.synchronize()
            except RuntimeError as e:
                raise PhaseError(f"tiny {tag} step raised: {e}") from e
            finally:
                torch.use_deterministic_algorithms(False)
            launches = dict(fast_warp.launches)
            bad, worst = held_step(losses, grads, ref_losses, ref_grads, noise, factor, tol)
            print(f"[train_tiny] {tag}: card vs CPU step, tiny_config batch 2: losses "
                  + ", ".join(f"{k} {v:.5f}/{ref_losses[k]:.5f}" for k, v in losses.items()))
            print(f"[train_tiny] {tag}: {sum(len(g) for g in grads.values())} gradient leaves "
                  f"and {len(losses)} losses held; worst err/limit {worst[0]:.3f} ({worst[1]}); "
                  f"card launches {launches}")
            if det:
                det_paths[f"train_tiny_det_{dtype}"] = launches
            check(not bad, f"{tag} card step differs from the CPU step: {bad[:8]}")
            check(launches == _want(launches, dtype, 1, det), f"tiny {tag} step launches {launches}")
    # VAE sampling (train_vae, K = the KL term) with one eps on both devices
    eps, vae_cpu, vae_nudged = cpu_refs["eps"], cpu_refs["vae"], cpu_refs["vae_nudged"]
    fast_warp.reset_launch_counts()
    losses, grads = tiny_step("cuda", batch, "float32", tp, vae_eps=eps)
    torch.cuda.synchronize()
    launches = dict(fast_warp.launches)
    bad, worst = held_step(
        losses, grads, *vae_cpu,
        lambda kind, n, k: (_distance(vae_nudged[0][n], vae_cpu[0][n]) if kind == "loss"
                            else _distance(vae_nudged[1][n][k], vae_cpu[1][n][k])),
        SPREAD, TRAIN_TOL)
    print(f"[train_tiny] float32 train_vae: card vs CPU step, same eps: losses "
          + ", ".join(f"{k} {v:.5f}/{vae_cpu[0][k]:.5f}" for k, v in losses.items()))
    print(f"[train_tiny] float32 train_vae: {sum(len(g) for g in grads.values())} gradient "
          f"leaves and {len(losses)} losses held; worst err/limit {worst[0]:.3f} ({worst[1]}); "
          f"card launches "
          f"{launches}")
    check(not bad, f"train_vae card step differs from the CPU step: {bad[:8]}")
    check(losses["K"] > 0 and vae_cpu[0]["K"] > 0, f"train_vae K loss {losses['K']} is 0")
    check(launches == _want(launches, "float32", 1), f"tiny train_vae step launches {launches}")
    return det_paths


def _train(card, dtype):
    """The full-width training step through the bench's function."""
    from facevae_tpu_torch import bench
    tag = "train" if dtype == "float32" else "train_bf16"
    r = bench.run(batch_size=N_BATCH, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, dtype=dtype)
    bad = [k for k, v in r["losses"].items() if not abs(v) < float("inf")]
    check(not bad, f"non-finite losses {bad}: {r['losses']}")
    check(r["param_dtypes"] == r["adam_dtypes"] == ["torch.float32"],
          f"parameters {r['param_dtypes']}, Adam state {r['adam_dtypes']}: want fp32")
    want = _want(r["launches"], dtype, TRAIN_STEPS)
    check(r["launches"] == want,
          f"{TRAIN_STEPS} {dtype} training steps launched {r['launches']}, want {want}")
    print(f"[{tag}] {card}: {r['config']}: step {r['step_ms_median']:.1f} ms median "
          f"({', '.join(f'{t:.1f}' for t in r['step_ms'])}), {r['frames_per_s']:.3f} frames/s, "
          f"peak memory {r['peak_memory_bytes'] / 2 ** 30:.2f} GiB, "
          f"build + state {r['build_s']:.1f} s; parameters and Adam state fp32")
    print(f"[{tag}] losses {json.dumps({k: round(v, 5) for k, v in r['losses'].items()})}; "
          f"warp launches over {TRAIN_STEPS} steps {r['launches']}")
    BENCH_MS[dtype] = r["step_ms_median"]
    return r["launches"]


def _state_differences(a, b):
    """Where two train states differ: every parameter and buffer of every
    net, both optimizers' exp_avg / exp_avg_sq / step (in the optimizers'
    parameter order), epoch and step, compared bit for bit."""
    import torch
    bad = [k for k in ("epoch", "step") if getattr(a, k) != getattr(b, k)]
    for n, net in a.nets.items():
        other = b.nets[n].state_dict()
        bad += [f"{n}.{k}" for k, v in net.state_dict().items()
                if not torch.equal(v.cpu(), other[k].cpu())]
    for key in ("g_opt", "d_opt"):
        pa = [p for g in getattr(a, key).param_groups for p in g["params"]]
        pb = [p for g in getattr(b, key).param_groups for p in g["params"]]
        sa, sb = getattr(a, key).state, getattr(b, key).state
        for i, (x, y) in enumerate(zip(pa, pb)):
            if set(sa.get(x, {})) != set(sb.get(y, {})):
                bad.append(f"{key}[{i}] state keys")
                continue
            bad += [f"{key}[{i}].{k}" for k, v in sa.get(x, {}).items()
                    if not torch.equal(v.cpu(), sb[y][k].cpu())]
        if len(pa) != len(pb):
            bad.append(f"{key}: {len(pa)} vs {len(pb)} parameters")
    return bad


def phase_checkpoint(card):
    """The epoch checkpoint (facevae_tpu_torch/train/checkpoint.py) on the
    card: a full-width fp32 state after one step saved and loaded bit for
    bit; the server's engine built from the file against a pipeline over the
    state in memory; a deterministic tiny_config step resumed from a file
    against the same step of the state that was saved."""
    import tempfile
    import numpy as np
    import torch
    from facevae_tpu_torch import serve
    from facevae_tpu_torch.config import Config, tiny_config
    from facevae_tpu_torch.models import G_MODEL_NAMES
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.train import (InferencePipeline, build_all_modules, checkpoint,
                                         create_train_state, train_step)
    device = torch.device("cuda")
    cfg = Config()
    size = cfg.model.image_size
    g = torch.Generator(device=device).manual_seed(3)
    state = create_train_state(cfg, device)
    batch = tuple(torch.rand(N_BATCH, size, size, 3, generator=g, device=device)
                  for _ in range(4))
    train_step(state, batch, generator=g)
    state.epoch = 1
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = checkpoint.save_checkpoint(d, state, 1)
        save_s = time.perf_counter() - t0
        loaded = create_train_state(cfg, device)
        t0 = time.perf_counter()
        checkpoint.load_checkpoint(d, 1, loaded)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        nbytes = Path(path).stat().st_size
        n_params = sum(p.numel() for m in state.nets.values() for p in m.parameters())
        print(f"[checkpoint] {card}: ModelConfig() fp32 after one step at batch {N_BATCH}: "
              f"{nbytes} bytes ({n_params} parameters), save {save_s:.2f} s, load {load_s:.2f} s "
              f"(into a freshly seeded state on the card)")
        bad = _state_differences(state, loaded)
        check(not bad, f"full-width state after save and load differs at {bad[:8]}")
        check(all(float(st["step"]) == 1 for opt in (loaded.g_opt, loaded.d_opt)
                  for st in opt.state.values())
              and len(loaded.g_opt.state) + len(loaded.d_opt.state) > 0,
              "the loaded Adam states are not at step 1")
        del loaded
        engine = serve.build_engine(serve.parse_args(
            ["--ckp_dir", d, "--ckp", "1", "--device", "cuda", "--max_batch", str(N_BATCH)]))
    try:
        memory = InferencePipeline(cfg, {n: state.nets[n] for n in G_MODEL_NAMES})
        imgs = torch.rand(N_BATCH, size, size, 3, generator=g, device=device)
        ref = memory.drive_frame(*memory.encode_source(imgs), imgs)
        enc = engine.pipe.encode_source(imgs)
        fast_warp.reset_launch_counts()
        out = engine.pipe.drive_frame(*enc, imgs)
        torch.cuda.synchronize()
        counts = dict(fast_warp.launches)
    finally:
        engine.stop()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    same = bool(torch.equal(out, ref))
    print(f"[checkpoint] server from the file vs a pipeline over the state in memory, drive "
          f"batch of {N_BATCH}: bit for bit {'yes' if same else 'no'} (max|err| {err:.3e}, "
          f"max|ref| {scale:.3f}); warp launches {counts}")
    check(same or err <= 1e-6 * scale, f"served frames from the file differ: {err:.3e}")
    want = {**dict.fromkeys(counts, 0), "warp_fwd": 1, "grid_fwd": 1}
    check(counts == want, f"served batch launches {counts}, want {want}")
    del state, memory, engine
    torch.cuda.empty_cache()

    tiny = tiny_config()
    rs, images, _ = tiny_step_inputs(seed=4)
    images = [torch.from_numpy(b).to(device) for b in images]
    saved = create_train_state(tiny, device, numpy_weights(build_all_modules(tiny, device), 4))
    train_step(saved, images, generator=torch.Generator(device=device).manual_seed(1))
    saved.epoch = 1
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_checkpoint(d, saved, 1)
        resumed = checkpoint.load_checkpoint(d, 1, create_train_state(tiny, device))
    outs = []
    torch.use_deterministic_algorithms(True)
    try:
        for st in (saved, resumed):
            out = train_step(st, images, generator=torch.Generator(device=device).manual_seed(2))
            outs.append({k: v.clone() for k, v in {**out["losses_g"], **out["losses_d"]}.items()})
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    bad = _state_differences(saved, resumed)
    print(f"[checkpoint] tiny_config resumed from the file vs the state that was saved, one "
          f"deterministic step each (same TPS draw): {len(outs[0])} losses, "
          f"{len(diff)} differ; states after the step differ at {len(bad)} tensors")
    check(not diff and not bad, f"resumed step differs: losses {diff}, state {bad[:8]}")
    return {"bytes": nbytes, "save_s": save_s, "load_s": load_s}


def _imported(stderr):
    """The top-level packages a ``python -X importtime`` run imported, from
    its stderr."""
    return {line.rsplit("|", 1)[1].strip().split(".")[0] for line in stderr.splitlines()
            if line.startswith("import time:") and "|" in line}


def _run_module(module, args, what):
    """``python -m module args`` in a fresh process from the checkout, as a
    user runs it (with -X importtime, which lists every module the process
    imports, lazily imported ones included): its seconds; fails on an exit
    code other than 0 and on an import of JAX, flax or the JAX package."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-X", "importtime", "-m", module, *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    check(r.returncode == 0, f"{what}: exit code {r.returncode}: {r.stderr[-3000:]}")
    imported = _imported(r.stderr)
    check(len(imported) > 10 and "torch" in imported,
          f"{what}: -X importtime listed {sorted(imported)[:20]}")
    bad = sorted(imported & set(NO_JAX))
    check(not bad, f"{what} imported {bad}")
    for line in r.stdout.splitlines():
        print(f"[reference]   {what}: {line}")
    return seconds


def _same_nets(a, b, device=None):
    """The state-dict keys where two {net: state dict} differ (dtype or
    bits; with ``device``, also a tensor of ``a`` not on it)."""
    import torch
    bad = []
    for n in a:
        if list(a[n]) != list(b[n]):
            bad.append(f"{n}: keys")
            continue
        bad += [f"{n}.{k}" for k, v in a[n].items()
                if v.dtype != b[n][k].dtype or not torch.equal(v.cpu(), b[n][k].cpu())
                or (device is not None and v.device.type != device)]
    return bad


def phase_reference(card):
    """The reference's own PyTorch weights on the card with no JAX: the two
    converters run as a user runs them; (a) a reference checkpoint at
    ModelConfig() converted on the card and on the CPU (the same bits), mode
    m from the card's file, and the card's frames against the CPU's from the
    same file; (b) the tiny golden's reference state dicts ported on the
    card, leaf for leaf the JAX package's conversion; (c) the three
    teachers at their real shapes converted, loaded through pretrained_dir
    equal to their sources, and one fp32 training step from them.  No
    process of the phase imports JAX, flax or the JAX package."""
    import importlib.util
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        counts, rates = _reference_checkpoint(card, Path(d))
    with tempfile.TemporaryDirectory() as d:
        _reference_tiny(Path(d))
    with tempfile.TemporaryDirectory() as d:
        step_counts, rates["teachers_convert_s"] = _reference_teachers(Path(d))
    imported = sorted(m for m in sys.modules if m.split(".")[0] in NO_JAX)
    found = {}
    for name in NO_JAX:                 # looked up, not imported
        spec = importlib.util.find_spec(name)
        found[name] = "not installed" if spec is None else (
            spec.origin or f"namespace {list(spec.submodule_search_locations or [])}")
    print(f"[reference] JAX, flax and the JAX package here: {json.dumps(found)}; imported by "
          f"this process: {imported or 'none'}")
    check(not imported, f"the smoke's process imported {imported}")
    return {k: counts[k] + step_counts[k] for k in counts}, rates


def _reference_checkpoint(card, d):
    """Phase reference (a) in directory ``d``: (mode m's launches, figures)."""
    import math
    import numpy as np
    import torch
    from facevae_tpu_torch import convert, evaluate
    from facevae_tpu_torch.config import Config
    from facevae_tpu_torch.convert_reference_checkpoint import MODELS
    from facevae_tpu_torch.data import FramesDataset
    from facevae_tpu_torch.data.synthetic import write_dataset
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.train import checkpoint
    size = Config().model.image_size
    order = json.loads(REF_ORDER.read_text())["ModelConfig"]
    rates = {}
    t0 = time.perf_counter()
    ckp = {n: {k: torch.from_numpy(v) for k, v in
               reference_state_dict(order[n], REF_SEED + i).items()}
           for i, n in enumerate(MODELS)}
    n_arrays = sum(len(ckp[n]) for n in MODELS)
    n_values = sum(v.numel() for n in MODELS for v in ckp[n].values())
    src = d / f"{REF_EPOCH:08d}-checkpoint.pth.tar"
    torch.save({**ckp, "epoch": REF_EPOCH}, src)
    del ckp
    print(f"[reference] a reference checkpoint at ModelConfig() in the JAX creation order "
          f"(tests/data/torch_reference_order.json): {n_arrays} arrays, {n_values} values, "
          f"{src.stat().st_size} bytes, written in {time.perf_counter() - t0:.1f} s")
    for dev in ("cuda", "cpu"):
        rates[f"convert_s_{dev}"] = _run_module(
            "facevae_tpu_torch.convert_reference_checkpoint",
            ["--torch_ckp", str(src), "--out_dir", str(d / f"ckp_{dev}"),
             "--epoch", str(REF_EPOCH), "--device", dev],
            f"convert_reference_checkpoint --device {dev}")
    rates["bytes_in"] = src.stat().st_size
    rates["bytes_out"] = Path(checkpoint.checkpoint_path(str(d / "ckp_cuda"),
                                                         REF_EPOCH)).stat().st_size
    print(f"[reference] {card}: convert_reference_checkpoint at ModelConfig(), --device "
          f"cuda {rates['convert_s_cuda']:.1f} s, --device cpu "
          f"{rates['convert_s_cpu']:.1f} s (each a fresh process: torch's import, the train "
          f"state, the torch.load, the zip and the epoch file's write); {rates['bytes_in']} "
          f"bytes in, {rates['bytes_out']} bytes out (the whole train state: teachers, head "
          f"and fresh Adam states included)")
    nets = {}
    for dev in ("cuda", "cpu"):
        tree = checkpoint.read_checkpoint(str(d / f"ckp_{dev}"), REF_EPOCH)
        check(int(tree["epoch"]) == REF_EPOCH and int(tree["step"]) == 0,
              f"--device {dev}: epoch {tree['epoch']}, step {tree['step']}")
        nets[dev] = {n: {k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax(
            convert.net_variables(tree, n)).items()} for n in MODELS}
        del tree
    bad = _same_nets(nets["cuda"], nets["cpu"])
    print(f"[reference] the seven nets converted with --device cuda vs --device cpu: "
          f"{sum(len(v) for v in nets['cpu'].values())} leaves, {len(bad)} differ in bits "
          f"or dtype")
    check(not bad, f"the two conversions differ at {bad[:8]}")
    del nets

    root = write_dataset(str(d / "data"), size, EVAL_VIDEOS, EVAL_FRAMES)
    argv = ["--ckp_dir", str(d / "ckp_cuda"), "--ckp", str(REF_EPOCH), "--source", "m",
            "--driving", root, "--eval_batch", str(N_BATCH), "--device", "cuda"]
    fast_warp.reset_launch_counts()
    out = _eval_main(argv)
    torch.cuda.synchronize()
    counts = dict(fast_warp.launches)
    n_driven = EVAL_VIDEOS * (EVAL_FRAMES - 1)
    batches = EVAL_VIDEOS * math.ceil((EVAL_FRAMES - 1) / N_BATCH)
    check(out["frames"] == n_driven and out["videos"] == EVAL_VIDEOS
          and all(math.isfinite(out[k]) for k in ("recon_l1", "recon_mse", "psnr_db")),
          f"mode m from the converted file: {out}")
    want = {**dict.fromkeys(counts, 0), "warp_fwd": batches, "grid_fwd": batches}
    check(counts == want, f"mode m launches {counts}, want {want}")
    pipe = evaluate.build_pipeline(evaluate.parse_args(argv))
    evaluate.eval_metrics(pipe, root, size, 0, 90, batch=N_BATCH)        # warm
    t0 = time.perf_counter()
    evaluate.eval_metrics(pipe, root, size, 0, 90, batch=N_BATCH)
    rates["m_frames_per_s"] = n_driven / (time.perf_counter() - t0)
    print(f"[reference] {card}: mode m from the converted file, {out['frames']} frames in "
          f"{batches} drive batches of {N_BATCH}: recon_l1 {out['recon_l1']}, psnr "
          f"{out['psnr_db']} dB; {rates['m_frames_per_s']:.2f} frames/s (eval_metrics, second "
          f"run, PNG reads included); launches {counts}")
    video = np.asarray(FramesDataset(root, frame_shape=(size, size, 3),
                                     is_train=False)[0], np.float32)[:N_BATCH + 1]
    frames = {}
    for dev, p in (("cuda", pipe), ("cpu", evaluate.build_pipeline(
            evaluate.parse_args(argv[:-1] + ["cpu"])))):
        with torch.no_grad():
            enc = p.encode_source(torch.from_numpy(video[:1]).to(dev))
            frames[dev] = p.drive_batch(*enc, torch.from_numpy(video[1:]).to(dev)).cpu()
    err = (frames["cuda"] - frames["cpu"]).abs().max().item()
    scale = frames["cpu"].abs().max().item()
    finite = bool(torch.isfinite(frames["cuda"]).all())
    print(f"[reference] the frames from the file with --device cuda vs --device cpu (a "
          f"drive batch of {N_BATCH}, {tuple(frames['cpu'].shape)}): max|err| {err:.3e} "
          f"(limit {REF_TOL * scale:.3e}, max|ref| {scale:.3f}), finite {finite}")
    check(finite and frames["cuda"].shape == frames["cpu"].shape
          and err <= REF_TOL * scale, f"frames with --device cuda vs cpu: {err:.3e}")
    return counts, rates


def _reference_tiny(d):
    """Phase reference (b): the tiny golden's reference state dicts through a
    .pth.tar in ``d``, ported onto tiny_config nets on the card, leaf for
    leaf (bits, dtype, device) the JAX package's conversion stored beside
    them, bridged by convert.load_jax_variables."""
    import copy
    import numpy as np
    import torch
    from facevae_tpu_torch import convert
    from facevae_tpu_torch.config import tiny_config
    from facevae_tpu_torch.convert_reference_checkpoint import MODELS
    from facevae_tpu_torch.models import build_models
    from facevae_tpu_torch.utils_port import port_reference_state_dict
    with np.load(REF_GOLDEN) as data:
        flat = {k: data[k] for k in data.files}

    def part(kind, n):
        return {k[len(f"{kind}/{n}/"):]: v for k, v in flat.items()
                if k.startswith(f"{kind}/{n}/")}

    torch.save({n: {k: torch.from_numpy(v) for k, v in part("ref", n).items()}
                for n in MODELS}, d / "tiny.pth.tar")
    ckp = torch.load(d / "tiny.pth.tar", map_location="cpu")
    nets = build_models(tiny_config().model, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0),
                        names=MODELS)
    got, want = {}, {}
    for n in MODELS:
        got[n] = port_reference_state_dict({k: v.numpy() for k, v in ckp[n].items()}, nets[n])
        want[n] = convert.load_jax_variables(
            copy.deepcopy(nets[n]), convert.nested_from_flat(part("jax", n))).state_dict()
    bad = _same_nets(got, want, device="cuda")
    print(f"[reference] the tiny golden (tests/data/torch_reference_tiny.npz) ported on "
          f"cuda: {sum(len(v) for v in got.values())} leaves of the seven nets against the "
          f"JAX package's conversion, {len(bad)} differ")
    check(not bad, f"the tiny golden differs on cuda at {bad[:8]}")


def _reference_teachers(d):
    """Phase reference (c) in ``d``: the three teachers at their real shapes
    through convert_torch_weights, loaded with create_train_state(...,
    pretrained_dir=...) on the card and held to their sources, then one
    fp32 training step at batch N_BATCH (remat off, as phase 7): (its
    launches, the converter's seconds)."""
    import math
    import re
    import torch
    from facevae_tpu_torch.config import Config, LossConfig
    from facevae_tpu_torch.convert_torch_weights import VGG19_IDX, VGGFACE_NAMES
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.train import create_train_state, train_step
    sds = teacher_state_dicts(REF_SEED)
    args = []
    for t, sd in sds.items():
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / f"{t}.pth")
        args += [f"--{t}", str(d / f"{t}.pth")]
    seconds = _run_module("facevae_tpu_torch.convert_torch_weights",
                          args + ["--out", str(d / "teachers")], "convert_torch_weights")
    cfg = _no_remat(Config(loss=LossConfig(pretrained_dir=str(d / "teachers"))))
    state = create_train_state(cfg, "cuda")
    vgg = {"vgg19": {f"conv{bi + 1}_{ci + 1}": f"features.{i}" for (bi, ci), i in VGG19_IDX.items()},
           "vggface": {f"conv{bi + 1}_{ci + 1}": name for (bi, ci), name in VGGFACE_NAMES.items()}}
    own = {t: getattr(state.nets["perceptual"], t).state_dict() for t in vgg}
    own["hopenet"] = state.nets["hopenet"].state_dict()
    pairs = [(t, f"{dst}.{leaf}", f"{src}.{leaf}") for t, m in vgg.items()
             for dst, src in m.items() for leaf in ("weight", "bias")]
    pairs += [("hopenet", re.sub(r"^layer(\d)\.(\d+)\.", r"layer\1_\2.", k)
               .replace(".downsample.0.", ".downsample_conv.")
               .replace(".downsample.1.", ".downsample_bn."), k)
              for k in sds["hopenet"] if not k.startswith("fc_finetune")
              and not k.endswith("num_batches_tracked")]
    bad = [f"{t}.{k}" for t, k, src in pairs
           if not torch.equal(own[t][k].cpu(), torch.from_numpy(sds[t][src]))]
    covered = {t: sum(1 for p in pairs if p[0] == t) for t in own}
    print(f"[reference] teachers at their real shapes converted in {seconds:.1f} s and loaded "
          f"through pretrained_dir: {covered} tensors held to their sources, {len(bad)} differ")
    check(not bad and covered["hopenet"] == len(own["hopenet"]),
          f"teachers differ from their sources at {bad[:8]}")
    size = cfg.model.image_size
    g = torch.Generator(device="cuda").manual_seed(REF_SEED)
    batch = tuple(torch.rand(N_BATCH, size, size, 3, generator=g, device="cuda")
                  for _ in range(4))
    fast_warp.reset_launch_counts()
    out = train_step(state, batch, generator=g)
    losses = {k: float(v) for k, v in {**out["losses_g"], **out["losses_d"]}.items()}
    counts = dict(fast_warp.launches)
    print(f"[reference] one fp32 training step at batch {N_BATCH} from the converted teachers: "
          f"losses {json.dumps({k: round(v, 5) for k, v in losses.items()})}; launches {counts}")
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite losses {losses}")
    want = _want(counts, "float32", 1)
    check(counts == want, f"the step launched {counts}, want {want}")
    return counts, seconds


def gif_frame_count(data):
    """(the header, the number of image descriptors) of GIF bytes, walking
    its blocks."""
    check(data[:6] in (b"GIF87a", b"GIF89a"), f"not a GIF: {data[:6]!r}")
    pos, frames = 13, 0
    if data[10] & 0x80:
        pos += 3 << ((data[10] & 7) + 1)

    def skip_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x2C:
            packed = data[pos + 9]
            pos += 10 + ((3 << ((packed & 7) + 1)) if packed & 0x80 else 0)
            pos = skip_blocks(pos + 1)
            frames += 1
        elif data[pos] == 0x21:
            pos = skip_blocks(pos + 2)
        else:
            raise PhaseError(f"GIF block {data[pos]:#x} at {pos}")
    return data[:6], frames


def _eval_argv(ckp_dir, source, driving, *extra):
    return ["--ckp_dir", ckp_dir, "--ckp", "1", "--source", source, "--driving", driving,
            *extra]


def _eval_main(argv):
    """facevae_tpu_torch.evaluate.main(argv), its printed lines prefixed
    (mode m prints a JSON line of its own)."""
    import contextlib
    import io
    from facevae_tpu_torch import evaluate
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = evaluate.main(argv)
    for line in buf.getvalue().splitlines():
        print(f"[eval]   main: {line}")
    return out


def _hold_n1(pipe, img):
    """Kernels 1 and 4 at their N = 1 calls: the inputs MFE's and the
    Generator's warps get in one full-width sample_expression call (recorded
    with bench_warp.recording), each kernel against its plain version, timed
    as phase 3 times it, with F.grid_sample's time, the bound and the
    launch grid the wrapper's launch code reported (fast_warp.launch_grids)."""
    import torch
    from facevae_tpu_torch.bench_warp import library_calls, recording
    from facevae_tpu_torch.models import generator as gen_mod, mfe as mfe_mod
    from facevae_tpu_torch.ops import fast_warp as fw
    from facevae_tpu_torch.probes.common import graph_ms
    from facevae_tpu_torch.warp_inputs import normalized
    with recording(mfe_mod, "warp_multi_pixel") as m_seen, \
            recording(gen_mod, "warp_single") as g_seen:
        pipe.sample_expression(img, 1.0, generator=torch.Generator().manual_seed(0))
    # clones made outside inference mode: plain tensors the timed graphs may hold
    x, cgx, cgy, cgz, spatial = (a.clone() if torch.is_tensor(a) else a for a in m_seen[0])
    xg, grid = (a.clone() for a in g_seen[0])
    D, H, W = spatial
    K1 = cgx.shape[1]
    coords = [cgx, cgy, cgz]
    cases = {
        "warp_fwd": (x, K1, lambda: fw.warp_multi_pixel_cuda(x, cgx, cgy, cgz, spatial),
                     lambda: fw.warp_multi_pixel_plain(x, cgx, cgy, cgz, spatial),
                     normalized(coords, D, H, W)),
        "grid_fwd": (xg, 1, lambda: fw.grid_sample_3d_cuda(xg, grid, 1),
                     lambda: fw.grid_sample_3d_plain(xg, grid, 1), grid)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for name, (src, k1, kernel, plain, ngrid) in cases.items():
        N, C = src.shape[0], src.shape[-1]
        check(N == 1, f"{name}: the sample_expression call gave N={N}, not 1")
        fw.launch_grids.pop(name, None)
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        check(name in fw.launch_grids, f"{name} at N = 1: no launch grid reported")
        gx, gy, gz, threads = fw.launch_grids[name]
        blocks = gx * gy * gz
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        gout = torch.zeros(N * k1, D, H, W, C, device=src.device)
        bound, bound_by = _bound_ms("fwd", N, D, H, W, C, k1, src.element_size())
        rows[name] = dict(err=err, scale=scale, tol=KERNEL_TOL["fwd"]["float32"] * scale,
                          ms=graph_ms(kernel), plain_ms=cuda_ms(plain),
                          library_ms=graph_ms(library_calls(src, ngrid, gout)["fwd"]),
                          bound_ms=bound, bound_by=bound_by,
                          shape=tuple(src.shape), K1=k1)
        r = rows[name]
        print(f"[eval] {name} at N = 1 (x[{','.join(map(str, src.shape))}] K1={k1}, from "
              f"sample_expression): max|err| {err:.3e} (limit {r['tol']:.3e}, max|ref| "
              f"{scale:.3f}); device {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
              f"F.grid_sample {r['library_ms']:.4f}, bound {bound:.4f} ms ({bound_by}); "
              f"launch grid ({gx}, {gy}, {gz}) = {blocks} blocks of {threads} threads "
              f"on {sms} SMs")
        check(torch.isfinite(out).all().item() and out.shape == ref.shape,
              f"{name} at N = 1: shape {tuple(out.shape)} or non-finite")
        check(err <= r["tol"], f"{name} at N = 1: {err:.3e} > {r['tol']:.3e}")
        check(blocks >= sms, f"{name} at N = 1: {blocks} blocks leave SMs idle of {sms}")
    return rows


def _read_ms(root):
    """The host's ms a frame to read the test videos of a synthetic tree."""
    import os
    from facevae_tpu_torch.data.dataset import read_video
    t0 = time.perf_counter()
    names = sorted(os.listdir(f"{root}/test"))
    n = sum(len(read_video(f"{root}/test/{name}")) for name in names)
    return (time.perf_counter() - t0) * 1e3 / n


def phase_eval(card):
    """The evaluation CLI (facevae_tpu_torch.evaluate.main) on the card:
    ModelConfig() fp32 from an epoch file over a PNG dataset tree, modes m,
    s, i and r, their launches and gifs, mode m again over a tree of frames
    with a camera's grain that PIL writes (where it imports: its row filters
    are what a real dataset's frames carry, and cost read_png more than
    filter 0), kernels 1 and 4 at N = 1; then
    tiny_config(image_size=128)'s modes m, s and i on the card against the
    same calls on the CPU."""
    import math
    import tempfile
    import numpy as np
    import torch
    from facevae_tpu_torch import evaluate
    from facevae_tpu_torch.config import Config, tiny_config
    from facevae_tpu_torch.data.synthetic import smooth_frames, write_dataset
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.train import checkpoint, create_train_state
    device = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory()
    try:
        root, ckp = f"{tmp.name}/data", f"{tmp.name}/ckp"
        state = create_train_state(Config(), device)
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(ckp, state, 1)
        del state
        torch.cuda.empty_cache()
        size = Config().model.image_size
        write_dataset(root, size, EVAL_VIDEOS, EVAL_FRAMES)
        print(f"[eval] ModelConfig() fp32 epoch file and {EVAL_VIDEOS} test videos x "
              f"{EVAL_FRAMES} PNG frames at {size}x{size}: {time.perf_counter() - t0:.1f} s")
        video = f"{root}/test/id0#clip0"
        fast_warp.reset_launch_counts()
        t0 = time.perf_counter()
        out = _eval_main(_eval_argv(ckp, "m", root, "--eval_batch", str(N_BATCH)))
        torch.cuda.synchronize()
        m_s = time.perf_counter() - t0
        counts = dict(fast_warp.launches)
        n_driven = EVAL_VIDEOS * (EVAL_FRAMES - 1)
        batches = EVAL_VIDEOS * math.ceil((EVAL_FRAMES - 1) / N_BATCH)
        keys = {"metric", "recon_l1", "recon_mse", "psnr_db", "frames", "videos", "l1_dist",
                "psnr_dist", "per_video"}
        check(set(out) == keys, f"mode m keys {sorted(out)}")
        check(out["frames"] == n_driven and out["videos"] == EVAL_VIDEOS,
              f"mode m: {out['frames']} frames of {out['videos']} videos")
        check(all(math.isfinite(out[k]) for k in ("recon_l1", "recon_mse", "psnr_db")),
              f"mode m: non-finite {out}")
        want = {**dict.fromkeys(counts, 0), "warp_fwd": batches, "grid_fwd": batches}
        print(f"[eval] mode m: {out['frames']} frames of {out['videos']} videos in {batches} "
              f"drive batches of {N_BATCH}: recon_l1 {out['recon_l1']}, psnr {out['psnr_db']} "
              f"dB; main() {m_s:.2f} s (reading the epoch file and building the nets "
              f"included); launches {counts}")
        check(counts == want, f"mode m launches {counts}, want {want} (per drive batch "
                              "the multi-grid and single-grid forward once, no plain version)")
        gif_frames = {}
        for mode, n_frames in (("s", EVAL_FRAMES), ("i", EVAL_FRAMES), ("r", EVAL_FRAMES - 1)):
            path = f"{tmp.name}/{mode}.gif"
            _eval_main(_eval_argv(ckp, mode, video, "--output", path))
            header, n = gif_frame_count(Path(path).read_bytes())
            check(header == b"GIF89a" and n == n_frames,
                  f"mode {mode}: gif {header!r} of {n} frames, want {n_frames}")
            gif_frames[mode] = n
        torch.cuda.synchronize()
        counts = dict(fast_warp.launches)
        calls = batches + sum(gif_frames.values())
        want = {**dict.fromkeys(counts, 0), "warp_fwd": calls, "grid_fwd": calls}
        print(f"[eval] modes s, i, r: gifs (GIF89a) of {gif_frames} frames; eval path launches "
              f"{counts}")
        check(counts == want, f"eval path launches {counts}, want {want} (one multi-grid and "
                              "one single-grid forward per graph call)")

        args = evaluate.parse_args(_eval_argv(ckp, "m", root))
        pipe = evaluate.build_pipeline(args)
        evaluate.eval_metrics(pipe, root, size, 0, 90, batch=N_BATCH)       # warm
        t0 = time.perf_counter()
        evaluate.eval_metrics(pipe, root, size, 0, 90, batch=N_BATCH)
        m_fps = n_driven / (time.perf_counter() - t0)
        rates = {"m_frames_per_s": m_fps}
        for mode in ("r", "s", "i"):
            args = evaluate.parse_args(_eval_argv(ckp, mode, video))
            t0 = time.perf_counter()
            frames = evaluate.gif_frames(pipe, args)
            rates[f"{mode}_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / len(frames)
        rates["png_read_ms_per_frame"] = _read_ms(root)
        print(f"[eval] {card}: ModelConfig() fp32, mode m {m_fps:.2f} frames/s at batch "
              f"{N_BATCH} over write_png's frames (filter 0; eval_metrics, second run, PNG "
              f"reads included); ms per gif frame (gif_frames, second run, PNG reads "
              f"included, the gif encoding not): r {rates['r_ms_per_frame']:.1f}, s "
              f"{rates['s_ms_per_frame']:.1f}, i {rates['i_ms_per_frame']:.1f}; the host's "
              f"read_png of a {size}x{size} filter-0 frame "
              f"{rates['png_read_ms_per_frame']:.2f} ms")
        try:
            from PIL import Image
        except ImportError:
            print("[eval] PIL does not import: no mode m rate over PIL-written frames")
        else:
            pil_root = write_dataset(f"{tmp.name}/pil_data", size, EVAL_VIDEOS, EVAL_FRAMES,
                                     write=lambda path, img: Image.fromarray(img).save(path),
                                     noise=8)
            t0 = time.perf_counter()
            out = evaluate.eval_metrics(pipe, pil_root, size, 0, 90, batch=N_BATCH)
            rates["m_frames_per_s_pil"] = n_driven / (time.perf_counter() - t0)
            rates["pil_png_read_ms_per_frame"] = _read_ms(pil_root)
            check(out["frames"] == n_driven and math.isfinite(out["recon_l1"]),
                  f"mode m over PIL's frames: {out['frames']} frames, l1 {out['recon_l1']}")
            print(f"[eval] {card}: ModelConfig() fp32, mode m {rates['m_frames_per_s_pil']:.2f} "
                  f"frames/s at batch {N_BATCH} over frames with +-8 levels of grain that "
                  f"PIL {Image.__version__} writes (its own row filters; eval_metrics, the "
                  f"nets warm, PNG reads included); the host's read_png of one such frame "
                  f"{rates['pil_png_read_ms_per_frame']:.2f} ms")
        first = torch.from_numpy(np.asarray(smooth_frames(1, size, 0)[0], np.float32)[None]
                                 / 255).to(device)
        n1 = _hold_n1(pipe, first)
        del pipe
        torch.cuda.empty_cache()

        # tiny_config(image_size=128): the card against the CPU, same file, frames and eps
        tiny_root, tiny_ckp = f"{tmp.name}/tiny_data", f"{tmp.name}/tiny_ckp"
        checkpoint.save_checkpoint(tiny_ckp, create_train_state(tiny_config(image_size=128),
                                                                "cpu"), 1)
        write_dataset(tiny_root, 128, 2, 5)
        tiny = ["--tiny", "true", "--image_size", "128", "--eval_batch", "2"]
        got = {}
        for dev in ("cpu", "cuda"):
            m = _eval_main(_eval_argv(tiny_ckp, "m", tiny_root, "--device", dev, *tiny))
            got[dev] = {"m": m}
            for mode in ("s", "i"):
                args = evaluate.parse_args(_eval_argv(tiny_ckp, mode, f"{tiny_root}/test/"
                                                      "id0#clip0", "--device", dev, *tiny))
                got[dev][mode] = evaluate.gif_frames(evaluate.build_pipeline(args), args)
        a, b = got["cuda"]["m"], got["cpu"]["m"]
        diffs = {k: abs(a[k] - b[k]) for k in ("recon_l1", "recon_mse", "psnr_db")}
        levels = {mode: max(int(np.abs(x.astype(np.int16) - y).max())
                            for x, y in zip(got["cuda"][mode], got["cpu"][mode]))
                  for mode in ("s", "i")}
        print(f"[eval] tiny_config(image_size=128) card vs CPU: mode m {diffs} (limits "
              f"{EVAL_TOL}); modes s, i: gif frames within {levels} levels (limit "
              f"{EVAL_TOL['levels']})")
        check(a["frames"] == b["frames"] and a["videos"] == b["videos"], f"tiny m: {a} vs {b}")
        for k, d in diffs.items():
            check(d <= EVAL_TOL["psnr_db" if k == "psnr_db" else "mean"], f"tiny m {k}: {d}")
        for mode in ("s", "i"):
            check(len(got["cuda"][mode]) == len(got["cpu"][mode]) > 0
                  and levels[mode] <= EVAL_TOL["levels"],
                  f"tiny mode {mode}: {levels[mode]} levels apart")
    finally:
        tmp.cleanup()
    return counts, n1, rates


def _aug_site():
    """Kernel 1 at the on-device augmentation's call: seeded frames with
    grain, [8,1,256,256,3] at K1 = 1 on the homography coordinates of
    data/device_aug.frame_draws (a seeded generator on the card), fp32 and
    bf16, against its plain version; timed as phase 3 times it, with
    F.grid_sample (2-D, border padding, align_corners) on the same frames
    and samples as a yardstick.  Then the augmentation on the card (bf16
    rows into kernel 1) against the port's on the CPU (fp32 rows, the
    plain version) with the same draws: the warp within the bf16 rounding
    of its rows and output (AUG_WARP_TOL of max|ref|), the colour jitter
    and flip on the card's warped frames within 1e-5, and the whole (the
    jitter's gain carries the warp's rounding) printed."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from facevae_tpu_torch.config import DataConfig
    from facevae_tpu_torch.data import device_aug
    from facevae_tpu_torch.data.synthetic import smooth_frames
    from facevae_tpu_torch.ops import fast_warp as fw
    from facevae_tpu_torch.probes.common import graph_ms
    N, S = N_BATCH, AUG_SIZE
    cfg = DataConfig(use_flip=True)
    g = torch.Generator(device="cuda").manual_seed(12)
    draws = device_aug.frame_draws(g, N, S, cfg)
    gx, gy = device_aug._warp_coords(draws.homography, S, S)
    coords = [gx[:, None].contiguous(), gy[:, None].contiguous()]
    coords.append(torch.zeros_like(coords[0]))
    frames = torch.from_numpy(np.stack(smooth_frames(N, S, 12, noise=8))).cuda().float() / 255
    grid = torch.stack([gx / (S - 1) * 2 - 1, gy / (S - 1) * 2 - 1], -1).reshape(N, S, S, 2)
    rows = {}
    for dname in BOTH:
        dtype = getattr(torch, dname)
        x = frames.to(dtype)[:, None].contiguous()
        nchw = frames.to(dtype).permute(0, 3, 1, 2).contiguous()
        grid_d = grid.to(dtype)
        kernel = lambda: fw.warp_multi_pixel_cuda(x, *coords, (1, S, S))      # noqa: E731
        plain = lambda: fw.warp_multi_pixel_plain(x, *coords, (1, S, S))      # noqa: E731
        library = lambda: F.grid_sample(nchw, grid_d, mode="bilinear",        # noqa: E731
                                        padding_mode="border", align_corners=True)
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == ref.dtype and bool(torch.isfinite(out).all()),
              f"kernel 1 at the aug site {dname}: {tuple(out.shape)} {out.dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        r = dict(err=err, scale=scale, tol=AUG_TOL[dname] * scale,
                 differ=int((out != ref).sum()), ms=graph_ms(kernel), plain_ms=cuda_ms(plain),
                 library_ms=graph_ms(library), shape=(N, 1, S, S, 3), K1=1)
        r["bound_ms"], r["bound_by"] = _bound_ms("fwd", N, 1, S, S, 3, 1, x.element_size())
        rows[dname] = r
        print(f"[train_loop] warp_fwd aug x[{N},1,{S},{S},3] K1=1 {dname} (homography "
              f"coordinates from frame_draws): max|err| {err:.3e} (limit {r['tol']:.3e}, "
              f"max|ref| {scale:.3f}; {r['differ']} of {out.numel()} outputs differ); device "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, F.grid_sample 2-D border "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        check(err <= r["tol"], f"kernel 1 at the aug site {dname}: {err:.3e} > {r['tol']:.3e}")

    # the augmentation: card (bf16 rows into kernel 1) vs the port on the CPU (fp32)
    cpu_draws = device_aug.FrameDraws(*(t.cpu() for t in draws))
    fw.reset_launch_counts()
    warped = device_aug._warp_batch(frames, gx, gy)
    out = device_aug.apply_augmentation(frames, draws, cfg)
    torch.cuda.synchronize()
    counts = dict(fw.launches)
    cpu_gx, cpu_gy = device_aug._warp_coords(cpu_draws.homography, S, S)
    ref_warped = device_aug._warp_batch(frames.cpu(), cpu_gx, cpu_gy)
    ref = device_aug.apply_augmentation(frames.cpu(), cpu_draws, cfg)
    jitter = device_aug._color_jitter(warped, draws)
    jitter_ref = device_aug._color_jitter(warped.cpu(), cpu_draws)
    flips = cpu_draws.flip
    res = {}
    for name, a, b, tol in (("warp", warped, ref_warped, AUG_WARP_TOL),
                            ("jitter", jitter, jitter_ref, 1e-5), ("whole", out, ref, None)):
        err = (a.cpu() - b).abs().max().item()
        res[name] = (err, b.abs().max().item(), tol)
    print(f"[train_loop] augmentation on the card (bf16 rows) vs the port on the CPU (fp32), "
          f"same draws, {N} frames of {S}x{S}, {int(flips.sum())} flipped: warp max|err| "
          f"{res['warp'][0]:.3e} (limit 2^-7 of max|ref| {res['warp'][1]:.3f}); colour jitter "
          f"on the card's warped frames {res['jitter'][0]:.3e} (limit 1e-5 of "
          f"{res['jitter'][1]:.3f}); the whole augmentation {res['whole'][0]:.3e} (the "
          f"jitter's gain on the warp's rounding); launches {counts}")
    for name, (err, scale, tol) in res.items():
        if tol is not None:
            check(err <= tol * scale, f"augmentation {name} card vs CPU: {err:.3e} > "
                                      f"{tol * scale:.3e}")
    check(counts["warp_fwd"] == 2 and counts["warp_fwd_plain"] == 0,
          f"the card's augmentation launches {counts}: want kernel 1 once a batch")
    return rows


def _loop_counts(counts, dtype, steps, aug):
    """Per-step launches of the training loop: the step's (STEP_LAUNCHES)
    and kernel 1 ``aug`` more times (the fused augmentation's two batches)."""
    want = _want(counts, dtype, steps)
    want["warp_fwd"] += aug * steps
    return want


def _train_cli(argv):
    """facevae_tpu_torch.train's main(argv) with the launch counts set to 0
    before it and read after: (state, epoch records, counts)."""
    import torch
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.train import cli
    fast_warp.reset_launch_counts()
    state, records = cli.main(argv)
    torch.cuda.synchronize()
    return state, records, dict(fast_warp.launches)


def _log_pairs(path):
    """The add.txt lines of a log: [(G line, D line)] with every G / D
    column finite but K, which is nan when it never fired (quirk q4)."""
    import math
    lines = Path(path).read_text().splitlines()
    pairs = list(zip(lines[::2], lines[1::2]))
    for g_line, d_line in pairs:
        check(g_line[0] == "G" and d_line[0] == "D", f"log lines {g_line[:12]} / {d_line[:12]}")
        for line in (g_line, d_line):
            cols = dict(c.split(" - ") for c in line.split(") ", 1)[1].split("; "))
            check(all(math.isfinite(float(v)) for k, v in cols.items() if k != "K"),
                  f"non-finite loss in the log: {line}")
        check("; K - " in g_line, f"no K column: {g_line}")
    return pairs


def phase_train_loop(card):
    """python -m facevae_tpu_torch.train in-process (train/cli.main) at full
    width on a PNG tree that PIL writes, and kernel 1 at the augmentation's
    site (_aug_site)."""
    import math
    import os
    import tempfile
    import torch
    from PIL import Image
    from facevae_tpu_torch.data.image_io import read_png
    from facevae_tpu_torch.data.synthetic import write_training_tree
    aug_rows = _aug_site()
    ids, clips, frames = TRAIN_TREE
    tmp = tempfile.TemporaryDirectory()
    try:
        root = write_training_tree(f"{tmp.name}/data", AUG_SIZE, ids, clips, frames,
                                   write=lambda p, img: Image.fromarray(img).save(p), noise=8)
        paths = sorted(str(p) for p in Path(root, "train").rglob("*.png"))
        t0 = time.perf_counter()
        for p in paths:
            read_png(p)
        read_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
        steps = ids * TRAIN_REPEATS // N_BATCH
        print(f"[train_loop] PNG tree: {ids} identities x {clips} clips x {frames} frames at "
              f"{AUG_SIZE}x{AUG_SIZE} (+-8 levels of grain, PIL {Image.__version__}'s row "
              f"filters), {sum(os.path.getsize(p) for p in paths)} bytes in train/; read_png "
              f"{read_ms:.2f} ms a frame on the host; {steps} steps an epoch at batch {N_BATCH}")

        def argv(run, *extra, remat=False):
            # every run but the last measures the step without remat, as
            # before remat was ported; that one takes the CLI's default
            return (["--root_dir", root, "--batch_size", str(N_BATCH), "--num_repeats",
                     str(TRAIN_REPEATS), "--keep_checkpoints", "1"]
                    + ([] if remat else ["--remat", "false"])
                    + ["--ckp_dir", f"{tmp.name}/{run}/ckp", "--vis_dir", f"{tmp.name}/{run}/vis",
                       "--log_file", f"{tmp.name}/{run}/log.txt", *extra])

        total, runs = {}, {}

        def run(tag, args, dtype, aug, epochs, first, per_epoch=steps):
            state, records, counts = _train_cli(args)
            want = _loop_counts(counts, dtype, epochs * per_epoch, aug)
            for r in records:
                print(f"[train_loop] {tag}: {card}: epoch {r['epoch']}: {r['frames_per_s']:.3f} "
                      f"frames/s (steps {r['steps_s']:.2f} s, ckpt-snap {r['ckpt_s']:.2f} s, vis "
                      f"{r['vis_s']:.2f} s); the loop's thread waited {r['wait_s']:.3f} s on the "
                      f"prefetch queue ({r['wait_s'] / r['steps_s']:.1%} of the steps' time)")
            print(f"[train_loop] {tag}: launches {counts}")
            check([(r["epoch"], r["first_step"]) for r in records] == first,
                  f"{tag}: epochs / first steps {[(r['epoch'], r['first_step']) for r in records]}"
                  f", want {first}")
            check(counts == want, f"{tag}: launches {counts}, want {want}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            runs[tag] = records
            return state

        state = run("fp32", argv("a", "--num_epochs", "2"), "float32", 2, 2,
                    [(0, 0), (1, steps)])
        check(state.step == 2 * steps, f"fp32 run ends at step {state.step}")
        pairs = _log_pairs(f"{tmp.name}/a/log.txt")
        check([(g[:10], d[:10]) for g, d in pairs] == [("G00000000)", "D00000000)"),
                                                       ("G00000001)", "D00000001)")],
              f"log lines {pairs}")
        vis = sorted(os.listdir(f"{tmp.name}/a/vis"))
        ckps = sorted(os.listdir(f"{tmp.name}/a/ckp"))
        check(vis == ["00000000-rec.png", "00000001-rec.png"], f"visualizations {vis}")
        check(ckps == ["00000001-checkpoint.msgpack"], f"epoch files kept {ckps}")
        print(f"[train_loop] fp32: log {pairs[-1][0][:60]}...; {vis}; kept {ckps}")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        state = run("resume", argv("a", "--num_epochs", "3", "--ckp", "-1"), "float32", 2, 1,
                    [(2, 2 * steps)])
        check(state.step == 3 * steps, f"resumed run ends at step {state.step}")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        run("bf16 device_cache", argv("c", "--num_epochs", "1", "--bf16", "true",
                                      "--device_cache", "true"), "bfloat16", 2, 1, [(0, 0)])
        gc.collect()
        torch.cuda.empty_cache()
        run("cpu_aug", argv("d", "--num_epochs", "1", "--cpu_aug", "true"), "float32", 0, 1,
            [(0, 0)])
        gc.collect()
        torch.cuda.empty_cache()
        # the multi-step dispatcher through the group path (NCCL, one rank):
        # 2 x TRAIN_REPEATS steps an epoch, a call of 4 and the remainder's
        run("bf16 scan", argv("e", "--num_epochs", "1", "--bf16", "true", "--device_cache", "true",
                              "--steps_per_call", "4", "--gpu_ids", "0", "--num_repeats",
                              str(2 * TRAIN_REPEATS)),
            "bfloat16", 2, 1, [(0, 0)], per_epoch=2 * steps)
        scan = runs["bf16 scan"][-1]["scan"]
        print(f"[train_loop] bf16 scan: {scan['eager_steps']} eager steps, {scan['replays']} "
              f"replays, capture {scan['capture_s']:.2f} s, graph pool "
              f"{scan['graph_pool_bytes'] / 2 ** 30:.2f} GiB")
        check(scan["eager_steps"] == 2 and scan["replays"] == 2 * steps - 2,
              f"bf16 scan: {scan['eager_steps']} eager steps, {scan['replays']} replays")
        pairs = _log_pairs(f"{tmp.name}/e/log.txt")
        check(len(pairs) == 1, f"bf16 scan log {pairs}")
        gc.collect()
        torch.cuda.empty_cache()
        # the CLI's default --remat true through the dispatcher: a remat
        # step captured and replayed (no process group)
        state = run("bf16 scan remat", argv("g", "--num_epochs", "1", "--bf16", "true",
                                            "--device_cache", "true", "--steps_per_call", "4",
                                            "--num_repeats", str(2 * TRAIN_REPEATS), remat=True),
                    "bfloat16", 2, 1, [(0, 0)], per_epoch=2 * steps)
        check(state.cfg.model.remat, "the CLI's default did not rematerialize")
        del state
        scan = runs["bf16 scan remat"][-1]["scan"]
        print(f"[train_loop] bf16 scan remat (--remat true, the default): "
              f"{scan['eager_steps']} eager steps, {scan['replays']} replays, capture "
              f"{scan['capture_s']:.2f} s, graph pool {scan['graph_pool_bytes'] / 2 ** 30:.2f} GiB")
        check(scan["eager_steps"] == 2 and scan["replays"] == 2 * steps - 2,
              f"bf16 scan remat: {scan['eager_steps']} eager steps, {scan['replays']} replays")
        # more cards than the machine has stop the run before it starts
        have = torch.cuda.device_count()
        try:
            _train_cli(argv("f", "--gpu_ids", f"0,{have}"))
            check(False, f"--gpu_ids 0,{have} ran on a machine of {have} card(s)")
        except SystemExit as e:
            print(f"[train_loop] --gpu_ids 0,{have}: {e}")
            check(f"this machine has {have} card(s)" in str(e), f"--gpu_ids 0,{have}: {e}")
        check(all(math.isfinite(r["frames_per_s"]) for rs in runs.values() for r in rs),
              "non-finite frames/s")
    finally:
        tmp.cleanup()
    return total, aug_rows, {"read_png_ms_per_frame": read_ms, "epochs": runs}


def _write_mp4(path, frames, fourcc):
    """uint8 RGB frames as an .mp4 through cv2's VideoWriter (25 fps)."""
    import cv2
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    check(out.isOpened(), f"cv2's VideoWriter does not open {fourcc} at {w}x{h}")
    try:
        for f in frames:
            out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        out.release()


def _video_trees(root, fourcc):
    """The same seeded frames (TRAIN_TREE's identities x clips x frames at
    AUG_SIZE, +-8 levels of grain) as three training trees: png/ (frame
    directories, write_png), mp4/ (``fourcc`` clips), gif/ (write_gif
    clips); mp4/test/ holds EVAL_VIDEOS videos of EVAL_FRAMES frames, the
    other test/ splits are empty."""
    import os
    from facevae_tpu_torch.data.image_io import write_gif, write_png
    from facevae_tpu_torch.data.synthetic import smooth_frames
    ids, clips, n = TRAIN_TREE
    for fmt in ("png", "mp4", "gif"):
        os.makedirs(f"{root}/{fmt}/train")
        os.makedirs(f"{root}/{fmt}/test")
    names = [f"id{i}#clip{c}" for i in range(ids) for c in range(clips)]
    for j, name in enumerate(names):
        frames = smooth_frames(n, AUG_SIZE, 100 + j, noise=8)
        os.makedirs(f"{root}/png/train/{name}")
        for t, f in enumerate(frames):
            write_png(f"{root}/png/train/{name}/{t:07d}.png", f)
        _write_mp4(f"{root}/mp4/train/{name}.mp4", frames, fourcc)
        write_gif(f"{root}/gif/train/{name}.gif", frames)
    for v in range(EVAL_VIDEOS):
        _write_mp4(f"{root}/mp4/test/id{v}#clip0.mp4",
                   smooth_frames(EVAL_FRAMES, AUG_SIZE, 10 * v, noise=8), fourcc)


def _timed_writer(writers):
    """train/tensorboard.py's SummaryWriter with each call's host ms kept by
    kind and each image kept as the loop passed it (the Visualizer's grid);
    every writer made is appended to ``writers``."""
    import numpy as np
    from facevae_tpu_torch.train import tensorboard as tb

    class TimedWriter(tb.SummaryWriter):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ms = {"scalars": [], "image": [], "text": []}
            self.records = {"scalars": 0, "image": 0, "text": 0}
            self.images = {}
            writers.append(self)

        def _timed(self, kind, n, fn, *args, **kwargs):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            self.ms[kind].append((time.perf_counter() - t0) * 1e3)
            self.records[kind] += n

        def add_scalars(self, main_tag, values, *args, **kwargs):
            self._timed("scalars", len(values), super().add_scalars, main_tag, values, *args,
                        **kwargs)

        def add_image(self, tag, img, step=None, *args, **kwargs):
            self._timed("image", 1, super().add_image, tag, img, step, *args, **kwargs)
            self.images[(tag, step)] = np.array(img)

        def add_text(self, *args, **kwargs):
            self._timed("text", 1, super().add_text, *args, **kwargs)
    return TimedWriter


def _check_events(run_dir, writer, steps, keys):
    """The event files a run of the CLI wrote under run_dir/runs: every
    record's CRCs (read_events), the loss_all tag of every loss key at every
    step index in its own directory, image_show_0 at every step decoding to
    the grid the Visualizer drew (uint8, as the writer keeps it), the log
    line at every step.  Returns the files' bytes."""
    import io
    import os
    import numpy as np
    from PIL import Image
    from facevae_tpu_torch.train.tensorboard import read_events
    (logdir,) = os.listdir(f"{run_dir}/runs")
    base = f"{run_dir}/runs/{logdir}"
    files = {os.path.relpath(d, base): [os.path.join(d, f) for f in fs]
             for d, _, fs in os.walk(base) if fs}
    check(sorted(files) == sorted(["."] + [f"loss_all/{k}" for k in keys]),
          f"event directories {sorted(files)}, want the loss keys {keys}")
    for rel, paths in files.items():
        check(len(paths) == 1, f"{rel}: event files {paths}")
        events = read_events(paths[0])
        check(events[0].get("file_version") == "brain.Event:2", f"{rel}: first record {events[0]}")
        got = [(e["step"], v["tag"]) for e in events[1:] for v in e["summary"]]
        if rel != ".":
            check(got == [(i, "loss_all") for i in range(steps)], f"{rel}: records {got}")
            continue
        want = [(i, tag) for i in range(steps) for tag in ("image_show_0", "log/text_summary")]
        check(got == want, f"main event file: records {got}, want {want}")
        for e in events[1:]:
            v = e["summary"][0]
            if "image" in v:
                img = np.asarray(Image.open(io.BytesIO(v["image"]["encoded_image_string"])))
                drawn = writer.images[("image_show_0", e["step"])]
                ref = (drawn if drawn.dtype == np.uint8
                       else np.clip(drawn * 255.0, 0, 255).astype(np.uint8))
                check(img.shape == ref.shape == (v["image"]["height"], v["image"]["width"],
                                                  v["image"]["colorspace"])
                      and np.array_equal(img, ref),
                      f"image_show_0 at step {e['step']}: {img.shape} does not decode to the "
                      f"Visualizer's grid {drawn.shape}")
            else:
                line = v["tensor"]["string_val"][0].decode()
                check(line.startswith("00000000) ") and all(f"{k} - " in line for k in keys),
                      f"log text at step {e['step']}: {line[:80]}")
    return sum(os.path.getsize(p) for ps in files.values() for p in ps)


def phase_video(card):
    """The video datasets and --tensorboard on the card: the training CLI
    in-process at full width over the same frames as .mp4 clips (cv2's
    VideoWriter, avc1 where it encodes, else mp4v), as .gif clips and as a
    PNG tree, with --tensorboard and a record every step; then mode m over
    the .mp4 test split from the epoch file the .mp4 run wrote."""
    import dataclasses
    import math
    import os
    import tempfile
    import cv2
    import numpy as np
    import torch
    from facevae_tpu_torch import evaluate
    from facevae_tpu_torch.data import image_io
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.train import cli, loop
    reg = cv2.videoio_registry
    print(f"[video] cv2 {cv2.__version__}: backends "
          f"{[reg.getBackendName(b) for b in reg.getBackends()]}, for files "
          f"{[reg.getBackendName(b) for b in reg.getStreamBackends()]}; build: "
          f"{[ln.strip() for ln in cv2.getBuildInformation().splitlines() if 'FFMPEG' in ln]}")
    tmp = tempfile.TemporaryDirectory()
    cwd = os.getcwd()
    writers = []
    saved = loop.SummaryWriter, cli.build_config

    def every_step(args):          # neither CLI has a flag for vis_every
        cfg = saved[1](args)
        return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, vis_every=1))
    loop.SummaryWriter, cli.build_config = _timed_writer(writers), every_step
    try:
        fourcc = None
        for cc in ("avc1", "mp4v"):
            probe = cv2.VideoWriter(f"{tmp.name}/probe_{cc}.mp4", cv2.VideoWriter_fourcc(*cc), 25,
                                    (AUG_SIZE, AUG_SIZE))
            ok = probe.isOpened()
            probe.release()
            print(f"[video] cv2's VideoWriter {cc} at {AUG_SIZE}x{AUG_SIZE}: "
                  f"{'encodes' if ok else 'refused'}")
            if ok:
                fourcc = cc
                break
        check(fourcc is not None, "cv2 encodes neither avc1 nor mp4v")
        t0 = time.perf_counter()
        _video_trees(tmp.name, fourcc)
        ids, clips, n = TRAIN_TREE
        clip_names = [f"id{i}#clip{c}" for i in range(ids) for c in range(clips)]
        read_ms = {}
        for fmt, read in (("png", lambda p: np.stack([image_io.read_png(f"{p}/{f}")
                                                      for f in sorted(os.listdir(p))])),
                          ("mp4", image_io.read_mp4), ("gif", image_io.read_gif)):
            paths = [f"{tmp.name}/{fmt}/train/{c}{'' if fmt == 'png' else '.' + fmt}"
                     for c in clip_names]
            read(paths[0])                 # the decoder's first call outside the timing
            t1 = time.perf_counter()
            videos = [read(p) for p in paths]
            read_ms[fmt] = (time.perf_counter() - t1) * 1e3 / (len(clip_names) * n)
            check(all(v.shape == (n, AUG_SIZE, AUG_SIZE, 3) and v.dtype == np.uint8
                      for v in videos), f"{fmt}: read {[v.shape for v in videos]}")
        sizes = {fmt: sum(os.path.getsize(os.path.join(d, f)) for d, _, fs
                          in os.walk(f"{tmp.name}/{fmt}/train") for f in fs)
                 for fmt in ("png", "mp4", "gif")}
        print(f"[video] trees of {ids} identities x {clips} clips x {n} frames at "
              f"{AUG_SIZE}x{AUG_SIZE} ({fourcc} .mp4, .gif, PNG; train/ bytes {sizes}) written "
              f"in {time.perf_counter() - t0:.1f} s; the host's ms a frame to read them: "
              f"read_mp4 {read_ms['mp4']:.2f}, read_gif {read_ms['gif']:.2f}, read_png "
              f"{read_ms['png']:.2f}")
        steps = ids * TRAIN_REPEATS // N_BATCH
        total, runs = {}, {}
        for fmt in ("png", "mp4", "gif"):
            run_dir = f"{tmp.name}/run_{fmt}"
            os.makedirs(run_dir)
            os.chdir(run_dir)             # the CLI's writer makes ./runs
            try:
                state, records, counts = _train_cli([
                    "--root_dir", f"{tmp.name}/{fmt}", "--batch_size", str(N_BATCH),
                    "--num_repeats", str(TRAIN_REPEATS), "--num_epochs", "1", "--remat", "false",
                    "--tensorboard", "true", "--ckp_dir", f"{run_dir}/ckp", "--vis_dir",
                    f"{run_dir}/vis", "--log_file", f"{run_dir}/log.txt",
                    "--checkpoint_freq", "1" if fmt == "mp4" else "1000"])
            finally:
                os.chdir(cwd)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            want = _loop_counts(counts, "float32", steps, 2)
            check(counts == want, f"{fmt} run: launches {counts}, want {want}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            (g_line, d_line), = _log_pairs(f"{run_dir}/log.txt")
            keys = [c.split(" - ")[0] for line in (g_line, d_line)
                    for c in line.split(") ", 1)[1].split("; ")]
            writer = writers[-1]
            nbytes = _check_events(run_dir, writer, steps, keys)
            r = records[0]
            runs[fmt] = {"ms_per_step": r["steps_s"] * 1e3 / steps,
                         "frames_per_s": r["frames_per_s"], "wait_s": r["wait_s"],
                         "event_bytes": nbytes,
                         "tb_ms_per_record": {k: sum(v) / max(writer.records[k], 1)
                                              for k, v in writer.ms.items()},
                         "tb_records": dict(writer.records)}
            per_record = {k: round(v, 3) for k, v in runs[fmt]["tb_ms_per_record"].items()}
            print(f"[video] {fmt}: {card}: ModelConfig() fp32 batch {N_BATCH}, {steps} steps "
                  f"with --tensorboard (a record every step): "
                  f"{runs[fmt]['ms_per_step']:.1f} ms a step (the epoch's steps, the first's "
                  f"warm-up and the per-step visualization inside), "
                  f"{r['frames_per_s']:.3f} frames/s; waited {r['wait_s']:.3f} s on the "
                  f"prefetch queue; launches {counts}; event files {nbytes} bytes, host ms a "
                  f"record {json.dumps(per_record)} ({writer.records}); CRCs, tags, steps, "
                  f"images and log lines checked")
        for fmt in ("mp4", "gif"):
            runs[fmt]["vs_png"] = runs[fmt]["ms_per_step"] / runs["png"]["ms_per_step"]

        ckp, root = f"{tmp.name}/run_mp4/ckp", f"{tmp.name}/mp4"
        argv = ["--ckp_dir", ckp, "--ckp", "0", "--source", "m", "--driving", root,
                "--eval_batch", str(N_BATCH)]
        fast_warp.reset_launch_counts()
        out = _eval_main(argv)
        torch.cuda.synchronize()
        counts = dict(fast_warp.launches)
        n_driven = EVAL_VIDEOS * (EVAL_FRAMES - 1)
        batches = EVAL_VIDEOS * math.ceil((EVAL_FRAMES - 1) / N_BATCH)
        want = {**dict.fromkeys(counts, 0), "warp_fwd": batches, "grid_fwd": batches}
        check(out["frames"] == n_driven and out["videos"] == EVAL_VIDEOS
              and all(math.isfinite(out[k]) for k in ("recon_l1", "recon_mse", "psnr_db")),
              f"mode m over .mp4: {out}")
        check(counts == want, f"mode m over .mp4: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        pipe = evaluate.build_pipeline(evaluate.parse_args(argv))
        evaluate.eval_metrics(pipe, root, AUG_SIZE, 0, 90, batch=N_BATCH)         # warm
        t0 = time.perf_counter()
        evaluate.eval_metrics(pipe, root, AUG_SIZE, 0, 90, batch=N_BATCH)
        m_fps = n_driven / (time.perf_counter() - t0)
        del pipe
        print(f"[video] {card}: mode m over the .mp4 test split ({EVAL_VIDEOS} videos x "
              f"{EVAL_FRAMES} frames, the mp4 run's epoch file): recon_l1 {out['recon_l1']}, "
              f"psnr {out['psnr_db']} dB, launches {counts}; {m_fps:.2f} frames/s at batch "
              f"{N_BATCH} (eval_metrics, second run, read_mp4 included)")
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("imageio", "tensorboardX")
                        and sys.modules[m] is not None)
        check(not loaded, f"imported by the run: {loaded}")
    finally:
        os.chdir(cwd)
        loop.SummaryWriter, cli.build_config = saved
        tmp.cleanup()
    return total, {"fourcc": fourcc, "read_ms_per_frame": read_ms, "runs": runs,
                   "m_frames_per_s_mp4": m_fps}


def _dp_held(port, whole, world):
    """The JAX package's data-parallel invariant (tests/test_train_step.py:
    test_dp_vs_1dev_multistep): the ranks' steps against one process on the
    whole batch, F rescaled by the ranks: per step (loss deviation, its
    limit, parameter deviation, its limit)."""
    import numpy as np
    out = []
    for i, (lp, lw) in enumerate(zip(port["losses"], whole["losses"])):
        dp = dict(lp, F=lp["F"] * world)
        dev = max(abs(dp[k] - lw[k]) / max(1.0, abs(lw[k])) for k in lw)
        pdev = max(float(np.abs(v - whole["states"][i]["nets"][n][k]).max())
                   for n, sd in port["states"][i]["nets"].items() for k, v in sd.items()
                   if k.rsplit(".", 1)[-1] not in ("running_mean", "running_var",
                                                   "weight_u", "weight_v"))
        out.append((dev, 1e-2 * 25.0 ** i, pdev, 1e-3 * (i + 1)))
    return out


def phase_dp(card):
    """Data parallelism on the one card: (1) the group path at world size 1
    through NCCL, ModelConfig() fp32 at batch 8, four steps under
    torch.use_deterministic_algorithms(True), against the steps with no
    group from the same seeds: losses, gradients, every parameter and
    buffer and both Adam states bit for bit, the ms of each step after
    the first; (2)
    tiny_config() in 2 ranks on the card (gloo with CUDA tensors: NCCL
    refuses two ranks on one device), batch 1 each, two deterministic
    steps, against one process on the whole batch of 2 (run here while
    the ranks run) within the JAX package's data-parallel bounds, the ranks
    bit for bit alike."""
    import tempfile
    import numpy as np
    import torch
    from facevae_tpu_torch import parallel
    from facevae_tpu_torch.config import Config, ModelConfig, tiny_config
    from facevae_tpu_torch.parallel import dp_check
    from facevae_tpu_torch.parallel.spawn import start
    from facevae_tpu_torch.train import build_all_modules, create_train_state, train_step
    device = torch.device("cuda")
    cfg = Config(model=ModelConfig(remat=False))
    size = cfg.model.image_size
    g = torch.Generator(device=device).manual_seed(5)
    batch = tuple(torch.rand(N_BATCH, size, size, 3, generator=g, device=device)
                  for _ in range(4))
    group = parallel.init_distributed(0, 1, "cuda", local_rank=torch.cuda.current_device())
    backend = torch.distributed.get_backend(group)
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for grp in (group, None):
            state = create_train_state(cfg, device, group=grp)
            gen = torch.Generator(device=device)
            ms = []
            for seed in DP_SEEDS:                    # all but the first timed
                gen.manual_seed(seed)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = train_step(state, batch, generator=gen)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            ms = ms[1:]
            grads = {f"{n}.{k}": p.grad.clone() for n, net in state.nets.items()
                     for k, p in net.named_parameters() if p.grad is not None}
            runs.append((state, {k: v.clone() for k, v in {**out["losses_g"],
                                                            **out["losses_d"]}.items()},
                         grads, ms))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.distributed.destroy_process_group()
    (a, la, ga, ms_a), (b, lb, gb, ms_b) = runs
    bad = ([f"loss {k}" for k in la if not torch.equal(la[k], lb[k])]
           + [f"grad {k}" for k in ga if k not in gb or not torch.equal(ga[k], gb[k])]
           + _state_differences(a, b))
    print(f"[dp] {card}: ModelConfig() fp32 batch {N_BATCH}, {len(DP_SEEDS)} deterministic steps "
          f"through a {backend} group of 1 rank vs no group, ms a step after the first "
          f"{', '.join(f'{t:.1f}' for t in ms_a)} (median {statistics.median(ms_a):.1f}) vs "
          f"{', '.join(f'{t:.1f}' for t in ms_b)} (median {statistics.median(ms_b):.1f}): "
          f"{len(la)} losses, {len(ga)} gradients, every parameter, buffer and Adam state: "
          f"{'bit for bit' if not bad else f'{len(bad)} differ'}")
    check(backend == "nccl", f"the card's group runs {backend}, not NCCL")
    check(not bad, f"world size 1 through the group differs from no group at {bad[:8]}")
    del runs, a, b
    gc.collect()
    torch.cuda.empty_cache()

    tiny = _no_remat(tiny_config())
    steps = []
    for seed in (0, 1):
        _, images, tp = tiny_step_inputs(seed)
        steps.append((tuple(images), tp))
    with tempfile.TemporaryDirectory() as d:
        weights = f"{d}/weights.pt"
        torch.save(dp_check.state_weights(numpy_weights(build_all_modules(tiny, "cpu"), 6)),
                   weights)
        t0 = time.perf_counter()
        ranks = start(dp_check.rank_steps, 2, tiny, weights, steps, "cuda", False, True, True,
                      device="cuda", backend="gloo", cards=[0, 0])
        # the one-process reference on the whole batch, here while the ranks run
        torch.use_deterministic_algorithms(True)
        try:
            whole = dp_check.run_steps(tiny, weights, steps, device, snapshot_every=True)
        finally:
            torch.use_deterministic_algorithms(False)
        r0, r1 = ranks.join()
        spawn_s = time.perf_counter() - t0
    same = (r0["losses"] == r1["losses"]
            and not dp_check.bit_differences(r0["states"], r1["states"]))
    held = _dp_held(r0, whole, 2)
    print(f"[dp] tiny_config in 2 gloo ranks on the card (CUDA tensors), batch 1 each, two "
          f"deterministic steps ({spawn_s:.1f} s with the processes' start): losses "
          + "; ".join(", ".join(f"{k} {v:.5f}" for k, v in lp.items()) for lp in r0["losses"]))
    print(f"[dp] vs one process on the batch of 2, F x 2: "
          + "; ".join(f"step {i + 1}: losses {dev:.3e} (limit {dl:.0e}), parameters {pd:.3e} "
                      f"(limit {pl:.0e})" for i, (dev, dl, pd, pl) in enumerate(held))
          + f"; the two ranks bit for bit alike: {same}")
    check(same, "the two ranks' states differ")
    for i, (dev, dl, pd, pl) in enumerate(held):
        check(dev < dl and pd < pl, f"2 ranks vs one process, step {i + 1}: losses {dev:.3e}, "
                                    f"parameters {pd:.3e}")
    return {"world1_ms": ms_a, "plain_ms": ms_b,
            "world1_over_plain": statistics.median(ms_a) / statistics.median(ms_b) - 1}


def _seed_of(step):
    from facevae_tpu_torch.train.step import step_seed
    return step_seed(SCAN_SEED, step)


def _busy(fn):
    """fn() under torch.profiler: (the device's kernel ms, the window's
    wall ms)."""
    import torch
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU) / 1e3
    return busy, wall


def _timed(fn, n):
    """fn() (n steps): (host ms a step until fn returns, ms a step until the
    card is done)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host * 1e3 / n, (time.perf_counter() - t0) * 1e3 / n


def _scan_eager(cfg, frames, s_tab, d_tab, n):
    """n steps of the loop's own (reseed, train_step on the gathered
    frames) from a fresh state: (per-step loss vectors, the state)."""
    import torch
    from facevae_tpu_torch.train import create_train_state, train_step
    device = frames.device
    state = create_train_state(cfg, device)
    gen = torch.Generator(device=device)
    vecs = []
    for k in range(n):
        gen.manual_seed(_seed_of(state.step))
        vecs.append(_loss_vec(train_step(state, (frames.index_select(0, s_tab[k]),
                                                 frames.index_select(0, d_tab[k])),
                                         generator=gen, fused_aug=True)))
    torch.cuda.synchronize()
    return torch.stack(vecs).cpu(), state


def _loss_vec(out):
    import torch
    return torch.stack([v.float() for v in list(out["losses_g"].values())
                        + list(out["losses_d"].values())])


def _max_abs_diffs(a, b):
    """max|x - y| of each pair of tensors of a and b, on the host (fp64)."""
    import torch
    return torch.stack([(x.double() - y.double()).abs().max() for x, y in zip(a, b)]).cpu()


def _named_step_tensors(state):
    """([(name, parameter)] of every trained parameter that has a gradient,
    [(name, tensor)] of the state that is not a parameter: every buffer,
    both Adam moments and step counts, named "net.param:kind")."""
    import torch
    trained = {id(p) for opt in (state.g_opt, state.d_opt) for g in opt.param_groups
               for p in g["params"]}
    params = [(f"{n}.{k}", p) for n, net in state.nets.items()
              for k, p in net.named_parameters() if id(p) in trained and p.grad is not None]
    pname = {id(p): f"{n}.{k}" for n, net in state.nets.items() for k, p in net.named_parameters()}
    rest = ([(f"{n}.{k}:buffer", b) for n, net in state.nets.items()
             for k, b in net.named_buffers()]
            + [(f"{pname[id(p)]}:{k}", v) for opt in (state.g_opt, state.d_opt)
               for p, st in opt.state.items() for k, v in st.items() if torch.is_tensor(v)])
    return params, rest


def _held_replays(scan, frames, s_tab, d_tab, start, n):
    """Steps start..start+n-1 of the dispatcher, each from the state it
    left: the eager step three times from that state (restored in place
    between: the tensors the graph reads), the third on the frames as
    floats nudged by NUDGE (phase 6's measure of a step's own rounding
    noise), and one replay.  The eager steps are the loop's own (K = 1):
    the first two timed alone (a sync before and after), the last held
    step's second under torch.profiler instead.  Returns ([(eager, eager
    again, eager nudged, replay)] loss vectors on the host, [(names,
    replay's max|.-eager|, the larger of the other two's max|.-eager|,
    max|eager|)] over the gradients each step applied (the trainable
    parameters' .grad) and over the state after it that is not a parameter
    (every buffer, both Adam moments and step counts, named
    "net.param:kind"), {ms, host_ms: medians a step, busy_ms, wall_ms,
    peak: memory allocated over the eager steps})."""
    import torch
    from facevae_tpu_torch.train import train_step
    state = scan.state
    named = ([(f"{n}.{k}", t) for n, net in state.nets.items()
              for k, t in net.state_dict().items()]
             + [(f"{o}[{i}].{k}", v) for o, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt))
                for i, st in enumerate(opt.state.values()) for k, v in st.items()
                if torch.is_tensor(v)])
    names, tensors = [n for n, _ in named], [t for _, t in named]
    gnamed, snamed = _named_step_tensors(state)
    snames, stensors = [n for n, _ in snamed], [t for _, t in snamed]

    def grads():
        return [p.grad for _, p in gnamed]

    def held(names, now, ref, spread):
        return (names, _max_abs_diffs(now, ref), spread,
                torch.stack([r.double().abs().max() for r in ref]).cpu())
    out, states, grad_held, host, wall, info = [], [], [], [], [], {}
    torch.cuda.reset_peak_memory_stats()
    for k in range(start, start + n):
        snap, step = [t.clone() for t in tensors], state.step
        vecs, spread, g_spread = [], 0, 0
        for i in range(3):
            torch._foreach_copy_(tensors, snap)
            state.step = step
            scan.generator.manual_seed(_seed_of(step))
            batch = (frames.index_select(0, s_tab[k]), frames.index_select(0, d_tab[k]))
            if i == 2:
                g = torch.Generator(device=frames.device).manual_seed(k)
                batch = tuple(x.float() / 255.0 * (1 + NUDGE * torch.randn(
                    x.shape, generator=g, device=x.device)) for x in batch)

            def eager():
                vecs.append(_loss_vec(train_step(state, batch, generator=scan.generator,
                                                 fused_aug=True)))
            if k == start + n - 1 and i == 1:
                info["busy_ms"], info["wall_ms"] = _busy(eager)
            elif i < 2:
                h, w = _timed(eager, 1)
                host.append(h)
                wall.append(w)
            else:
                eager()
            if i == 0:
                after, g_after = [t.clone() for t in stensors], [g.clone() for g in grads()]
            else:
                spread = torch.maximum(torch.as_tensor(spread, dtype=torch.float64),
                                       _max_abs_diffs(stensors, after))
                g_spread = torch.maximum(torch.as_tensor(g_spread, dtype=torch.float64),
                                         _max_abs_diffs(grads(), g_after))
        info["peak"] = torch.cuda.max_memory_allocated()
        torch._foreach_copy_(tensors, snap)
        del snap
        state.step = step
        got = scan(s_tab[k:k + 1], d_tab[k:k + 1])
        vecs.append(torch.stack(list(got["losses_g"].values())
                                + list(got["losses_d"].values()), 1)[0])
        out.append(tuple(v.cpu() for v in vecs))
        states.append(held(snames, stensors, after, spread))
        grad_held.append(held([n for n, _ in gnamed], grads(), g_after, g_spread))
        del after, g_after
    info["ms"], info["host_ms"] = statistics.median(wall), statistics.median(host)
    return out, grad_held, states, info


def _scan_graph(cfg, frames, s_tab, d_tab, calls, held=0):
    """The dispatcher over ``calls`` (steps a call: the warm-up, the call
    that captures, the timed call, the profiled call), with ``held``
    steps of _held_replays after the capture: (per-step loss vectors, the
    state, the dispatcher, {ms, host_ms, busy_ms, wall_ms, replay_peak,
    launches of the timed call, held})."""
    import torch
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.train import create_train_state, train_step
    from facevae_tpu_torch.train.scan import ScanStep
    device = frames.device
    state = create_train_state(cfg, device)
    scan = ScanStep(state, frames, torch.Generator(device=device), _seed_of)
    rows, info, k = [], {}, 0
    for i, n in enumerate(calls):
        sl = slice(k, k + n)

        def call():
            out = scan(s_tab[sl], d_tab[sl])
            rows.append(torch.stack(list(out["losses_g"].values())
                                    + list(out["losses_d"].values()), 1))
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
            fast_warp.reset_launch_counts()
            info["host_ms"], info["ms"] = _timed(call, n)
            info["launches"] = dict(fast_warp.launches)
            info["replay_peak"] = torch.cuda.max_memory_allocated()
        elif i == 3:
            info["busy_ms"], info["wall_ms"] = _busy(call)
        else:
            call()
        k += n
        if i == 1 and held:
            info["held"], info["held_grads"], info["held_state"], info["eager"] = _held_replays(
                scan, frames, s_tab, d_tab, k, held)
            k += held
            gc.collect()
            torch.cuda.empty_cache()
    if held:
        # the eager loop (K = 1) as the training loop runs it: reseed and
        # step, SCAN_PIPE steps back to back, one sync at the end
        def eager_loop():
            for j in range(k, k + SCAN_PIPE):
                scan.generator.manual_seed(_seed_of(state.step))
                train_step(state, (frames.index_select(0, s_tab[j]),
                                   frames.index_select(0, d_tab[j])),
                           generator=scan.generator, fused_aug=True)
        info["eager"]["pipe_host_ms"], info["eager"]["pipe_ms"] = _timed(eager_loop, SCAN_PIPE)
    torch.cuda.synchronize()
    return torch.cat(rows).cpu(), state, scan, info


def _no_remat(cfg):
    """cfg with ModelConfig.remat off (the phases that measured the step
    before remat was ported keep measuring it without)."""
    import dataclasses
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=False))


def _hold_tensors(rows, tols, what, bad):
    """Hold rows [(names, max|x - ref|, spread, max|ref|)] of tensors
    (gradients, or buffers / Adam moments / steps named "net.param:kind")
    as phase 6 holds gradients: within SPREAD x spread + tols' grad share
    of max|ref|, floored at grad_floor x the largest of its kind in its
    net.  Appends what fails to ``bad``; returns ((worst err/limit, where),
    tensors bit for bit, tensors)."""
    import torch
    worst, same, count = (0.0, ""), 0, 0
    for k, (tnames, err, spread, scale) in enumerate(rows):
        kinds = [n.split(".")[0] + ":" + (n.rsplit(":", 1)[1] if ":" in n else "grad")
                 for n in tnames]
        top = {}
        for kind, v in zip(kinds, scale.tolist()):
            top[kind] = max(top.get(kind, 0.0), v)
        scale = torch.maximum(scale, tols["grad_floor"] * torch.tensor(
            [top[kind] for kind in kinds], dtype=scale.dtype))
        lim = SPREAD * spread + tols["grad"] * scale
        ratio = torch.where(lim > 0, err / lim, torch.where(err > 0, float("inf"), 0.0))
        j = int(ratio.argmax())
        worst = max(worst, (float(ratio[j]), f"step {k} {tnames[j]}"))
        same += int((err == 0).sum())
        count += err.numel()
        bad += [f"step {k} {what} {tnames[j]}: {float(err[j]):.3e} > {float(lim[j]):.3e}"
                for j in torch.nonzero(~(err <= lim)).flatten().tolist()]
    return worst, same, count


def phase_scan(card):
    """The multi-step dispatcher (train/scan.py) on the card over frames on
    the card (a [32,256,256,3] uint8 tensor, what the frame cache holds)
    and one index stream: ModelConfig() at batch 8, fp32 and bf16, the
    dispatcher's calls of 2 (its eager warm-up), 1 (the capture and its
    replay), 4 (timed) and 2 (profiled).  After the capture, two replays
    each from the state an eager step took: that eager step, the loop's
    own (K = 1), runs from the state twice and once on the frames nudged
    by NUDGE (restored in place between: its spread, run to run and as
    phase 6 measures a step's rounding noise; three of the four unnudged
    runs timed alone, one profiled), and each replay's losses are held
    within SPREAD x that spread + TRAIN_TOL of the eager step's, as phase
    6 holds the card's step; so are the
    gradients it applied and the state after it (every buffer, both Adam
    moments and step counts) as phase 6 holds gradients.
    Then SCAN_PIPE eager steps back to back, as the training loop runs
    them with K = 1.  Printed: ms a step both ways until the card is done
    (and phase 7 / 8's bench step), the host's ms a step, the
    device's busy share (torch.profiler), peak memory of the eager steps,
    of the warm-up, of the graph's pool and over the replays, the
    capture's seconds and the graph path's launches (captured x replays).
    Then tiny_config() under torch.use_deterministic_algorithms(True): four
    eager steps against calls of 2 and 2, the losses and the state after
    bit for bit."""
    import numpy as np
    import torch
    from facevae_tpu_torch.config import Config, ModelConfig, tiny_config
    device = torch.device("cuda")
    rs = np.random.RandomState(12)
    frames = torch.from_numpy(rs.randint(0, 256, (32, 256, 256, 3)).astype(np.uint8)).to(device)
    calls = SCAN_CALLS
    total = sum(calls) + SCAN_HELD + SCAN_PIPE
    s_tab, d_tab = (torch.from_numpy(rs.randint(0, 32, (total, N_BATCH))).to(device)
                    for _ in range(2))
    paths, rows = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = Config(model=ModelConfig(compute_dtype=dtype, remat=False))
        gl, st, scan, gi = _scan_graph(cfg, frames, s_tab, d_tab, calls, held=SCAN_HELD)
        names = list(scan.names[0]) + list(scan.names[1])
        tols = TRAIN_TOL if dtype == "float32" else BF16_TRAIN_TOL
        tol = tols["loss"]
        worst, bad, same, same_eager = (0.0, ""), [], 0, 0
        for k, (e1, e2, e3, g) in enumerate(gi["held"]):
            same += int(torch.equal(g, e1))
            same_eager += int(torch.equal(e2, e1))
            for j, n in enumerate(names):
                lim = (SPREAD * max(abs(float(e2[j] - e1[j])), abs(float(e3[j] - e1[j])))
                       + tol * abs(float(e1[j])))
                err = abs(float(g[j] - e1[j]))
                worst = max(worst, (err / lim if lim else (0.0 if err == 0 else float("inf")),
                                    f"step {k} {n}"))
                if not err <= lim:
                    bad.append(f"step {k} {n}: {err:.3e} > {lim:.3e}")
        # each replay's gradients and the state after it (every buffer, both
        # Adam moments and step counts) against the eager step's, as phase 6
        # holds gradients: within SPREAD x the eager step's own spread (run
        # to run and under nudged frames) + tol's grad share of max|.|,
        # floored at grad_floor x the largest of its kind in its net.  Parameters are not held one
        # by one: Adam turns the rounding noise of a gradient that is zero
        # but for noise (a conv bias before BatchNorm) into a step of +-lr.
        hold = {what: _hold_tensors(rows_, tols, what, bad)
                for what, rows_ in (("gradients", gi["held_grads"]), ("state", gi["held_state"]))}
        want = _loop_counts(gi["launches"], dtype, calls[2], 2)
        captured = {k: v for k, v in scan.captured_launches.items() if v}
        st_ = scan.stats
        ei = gi["eager"]
        bench = BENCH_MS.get(dtype)
        del st, scan
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[scan] {card}: ModelConfig() {dtype} batch {N_BATCH}: the eager loop (K = 1, "
              f"{SCAN_PIPE} steps back to back) {ei['pipe_ms']:.1f} ms a step "
              f"({N_BATCH * 1e3 / ei['pipe_ms']:.2f} frames/s), host {ei['pipe_host_ms']:.1f} ms "
              f"a step; one eager step timed alone {ei['ms']:.1f} ms, host {ei['host_ms']:.1f} "
              f"ms, device busy {ei['busy_ms'] / ei['wall_ms']:.1%}; graph (K = "
              f"{calls[2]}) {gi['ms']:.1f} ms a step ({N_BATCH * 1e3 / gi['ms']:.2f} frames/s), "
              f"host {gi['host_ms']:.1f} ms a step, device busy "
              f"{gi['busy_ms'] / gi['wall_ms']:.1%} (kernel time over wall time); the bench's "
              f"step of phase {7 if dtype == 'float32' else 8} (given augmented frames) "
              + (f"{bench:.1f} ms" if bench else "not run"))
        print(f"[scan] {dtype}: peak memory allocated over the held eager steps (beside the "
              f"graph's pool) {ei['peak'] / 2 ** 30:.2f} GiB, warm-up "
              f"{st_['eager_peak_bytes'] / 2 ** 30:.2f} GiB, graph pool "
              f"{st_['graph_pool_bytes'] / 2 ** 30:.2f} GiB, allocated over the replays "
              f"{gi['replay_peak'] / 2 ** 30:.2f} GiB; capture {st_['capture_s']:.2f} s; "
              f"launches captured a step {captured}, over the timed call's {calls[2]} replays "
              f"{gi['launches']}")
        print(f"[scan] {dtype}: {SCAN_HELD} replays each from the state an eager step took, "
              f"{len(names)} losses each: {same} of {SCAN_HELD} bit for bit (the eager step run "
              f"again: {same_eager} of {SCAN_HELD}); worst err/limit "
              f"{worst[0]:.3f} ({worst[1]}; limit {SPREAD:g} x the eager step's own spread, run "
              f"to run and on frames nudged by {NUDGE:g}, + {tol:g} x |ref|); last held step "
              f"graph/eager "
              + ", ".join(f"{n} {float(g[j]):.5f}/{float(e1[j]):.5f}"
                          for j, n in enumerate(names) for e1, _, _, g in gi["held"][-1:]))
        for what, (w_, same_, count_) in hold.items():
            print(f"[scan] {dtype}: the replays' {what} against the eager step's, "
                  f"{count_ // SCAN_HELD} tensors a step: {same_} of {count_} bit for bit; "
                  f"worst err/limit {w_[0]:.3f} ({w_[1]}; limit {SPREAD:g} x the eager step's "
                  f"own spread + {tols['grad']:g} x max|.|, floored at "
                  f"{tols['grad_floor']:g} x the largest of its kind in its net)")
        check(torch.isfinite(gl).all().item(), f"{dtype} graph losses not finite")
        check(not bad, f"{dtype} graph steps differ from the eager steps: {bad[:8]}")
        check(gi["launches"] == want, f"{dtype} graph launches {gi['launches']}, want {want}")
        paths[f"scan_{dtype}"] = gi["launches"]
        rows[dtype] = {"eager_loop_ms": ei["pipe_ms"], "eager_loop_host_ms": ei["pipe_host_ms"],
                       "eager_ms": ei["ms"], "graph_ms": gi["ms"], "bench_ms": bench,
                       "eager_host_ms": ei["host_ms"], "graph_host_ms": gi["host_ms"],
                       "eager_busy": ei["busy_ms"] / ei["wall_ms"],
                       "graph_busy": gi["busy_ms"] / gi["wall_ms"],
                       "eager_peak_gib": ei["peak"] / 2 ** 30,
                       "graph_pool_gib": st_["graph_pool_bytes"] / 2 ** 30,
                       "replay_peak_gib": gi["replay_peak"] / 2 ** 30,
                       "capture_s": st_["capture_s"], "held_bit_for_bit": same,
                       "eager_again_bit_for_bit": same_eager,
                       "held_worst": worst[0],
                       **{f"held_{w}_worst": v[0][0] for w, v in hold.items()},
                       **{f"held_{w}_bit_for_bit": v[1] / v[2] for w, v in hold.items()}}

    tiny = _no_remat(tiny_config())
    frames = torch.from_numpy(rs.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)).to(device)
    s_tab, d_tab = (torch.from_numpy(rs.randint(0, 8, (4, 2))).to(device) for _ in range(2))
    torch.use_deterministic_algorithms(True)
    try:
        e1, se = _scan_eager(tiny, frames, s_tab, d_tab, 4)
        from facevae_tpu_torch.ops import fast_warp
        fast_warp.reset_launch_counts()
        gl, sg, scan, _ = _scan_graph(tiny, frames, s_tab, d_tab, (2, 2))
        det_launches = dict(fast_warp.launches)
    finally:
        torch.use_deterministic_algorithms(False)
    diff = int((gl != e1).sum())
    bad = _state_differences(se, sg)
    print(f"[scan] tiny_config deterministic: four eager steps vs calls of 2 and 2 "
          f"({scan.replays} replays): {diff} of {gl.numel()} losses differ, the states after "
          f"differ at {len(bad)} tensors; launches {det_launches}")
    check(scan.replays == 2 and diff == 0 and not bad,
          f"deterministic graph steps differ: {diff} losses, state {bad[:8]}")
    paths["scan_tiny_det"] = det_launches
    return paths, rows


def _remat_run(base, dtype, remat, images, timed):
    """One step of ModelConfig(compute_dtype=dtype, remat=remat) from a copy
    of ``base`` (the seeded nets, on the host) on ``images``, the TPS draw
    from a generator seeded 3; with ``timed`` a second step after it, timed
    with the launches it made.  Returns {"losses", "grads", "state" (the
    first step's, on the host: names and tensors), "peak" (memory allocated
    over the steps), "ms", "launches"}."""
    import copy
    import torch
    from facevae_tpu_torch.config import Config, ModelConfig
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.train import create_train_state, train_step
    device = images[0].device
    cfg = Config(model=ModelConfig(compute_dtype=dtype, remat=remat))
    state = create_train_state(cfg, device, {n: copy.deepcopy(m).to(device)
                                             for n, m in base.items()})
    gen = torch.Generator(device=device).manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = train_step(state, images, generator=gen)
    params, rest = _named_step_tensors(state)
    r = {"losses": _loss_vec(out).cpu(), "names": list(out["losses_g"]) + list(out["losses_d"]),
         "grads": ([n for n, _ in params], [p.grad.cpu() for _, p in params]),
         "state": ([n for n, _ in rest], [t.detach().cpu() for _, t in rest])}
    if timed:
        fast_warp.reset_launch_counts()
        r["host_ms"], r["ms"] = _timed(lambda: train_step(state, images, generator=gen), 1)
        r["launches"] = dict(fast_warp.launches)
    r["peak"] = torch.cuda.max_memory_allocated()
    del state, out, params, rest
    gc.collect()
    torch.cuda.empty_cache()
    return r


def _remat_windows(base, images):
    """One fp32 remat step from a copy of ``base`` with the peak memory
    allocated in each window of it: from the step's start to the first
    recompute (the forward and the backward's first part), then from each
    region's recompute to the next one's (that region's recompute and
    backward, and the backward between): [(the region's net, peak bytes)],
    in the backward's order."""
    import copy
    import torch
    from facevae_tpu_torch import remat
    from facevae_tpu_torch.config import Config, ModelConfig
    from facevae_tpu_torch.train import create_train_state, train_step
    device = images[0].device
    state = create_train_state(Config(model=ModelConfig(remat=True)), device,
                               {n: copy.deepcopy(m).to(device) for n, m in base.items()})
    windows = [["forward", 0]]

    class Region(remat._Region):
        def __enter__(self):
            if self.replay:
                windows[-1][1] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                windows.append([self.tape.name, 0])
            return super().__enter__()
    plain_region, remat._Region = remat._Region, Region
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train_step(state, images, generator=torch.Generator(device=device).manual_seed(3))
        windows[-1][1] = torch.cuda.max_memory_allocated()
    finally:
        remat._Region = plain_region
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return [tuple(w) for w in windows]


def phase_remat(card):
    """Rematerialization at full width (ModelConfig(), 256x256), under
    torch.use_deterministic_algorithms(True) (phase 6's strict mode): for
    each of REMAT_CASES, the step with remat and without it from the same
    seeded nets (built once on the card, kept on the host, copied in for
    each run), on the same seeded images and TPS draw: peak memory
    allocated (over the step and a second, timed one), ms a step (the
    second), the warp launches of that step by kernel (the same with and
    without remat: kernels 1 and 4 launch as often).  At batch 8 the remat
    step is held to the plain one: the losses, the gradients it applied
    and the state after it (every buffer, both Adam moments and step
    counts), within SPREAD x the plain step's own spread (run again, and
    on images nudged by NUDGE) + TRAIN_TOL (bf16: BF16_TRAIN_TOL), as
    phase scan holds a replay; printed, how many are bit for bit.  The
    fp32 batch-8 peak with remat must be the lower."""
    import torch
    from facevae_tpu_torch.config import Config
    from facevae_tpu_torch.train import build_all_modules
    device = torch.device("cuda")
    base = {n: m.cpu() for n, m in build_all_modules(Config(), device).items()}
    size = Config().model.image_size
    paths, rows, bad = {}, {}, []
    torch.use_deterministic_algorithms(True)
    try:
        for dtype, batch in REMAT_CASES:
            g = torch.Generator(device=device).manual_seed(batch)
            images = tuple(torch.rand(batch, size, size, 3, generator=g, device=device)
                           for _ in range(4))
            plain = _remat_run(base, dtype, False, images, True)
            rem = _remat_run(base, dtype, True, images, True)
            tag = f"{dtype} batch {batch}"
            row = {"peak_gib": plain["peak"] / 2 ** 30, "remat_peak_gib": rem["peak"] / 2 ** 30,
                   "ms": plain["ms"], "remat_ms": rem["ms"], "launches": plain["launches"],
                   "remat_launches": rem["launches"]}
            want = _want(rem["launches"], dtype, 1, deterministic=True)
            check(rem["launches"] == plain["launches"] == want,
                  f"{tag}: launches with remat {rem['launches']}, without {plain['launches']}, "
                  f"want {want}")
            for k, v in rem["launches"].items():
                paths[k] = paths.get(k, 0) + v
            print(f"[remat] {card}: ModelConfig() {tag}, deterministic: peak memory allocated "
                  f"{row['peak_gib']:.2f} GiB without remat, {row['remat_peak_gib']:.2f} GiB "
                  f"with ({row['remat_peak_gib'] / row['peak_gib'] - 1:+.1%}); ms a step "
                  f"{plain['ms']:.1f} without, {rem['ms']:.1f} with "
                  f"({rem['ms'] / plain['ms'] - 1:+.1%}); launches a step, both "
                  f"{ {k: v for k, v in rem['launches'].items() if v} }")
            if batch == N_BATCH:
                again = _remat_run(base, dtype, False, images, False)
                gn = torch.Generator(device=device).manual_seed(batch + 1)
                nudged = tuple(x * (1 + NUDGE * torch.randn(x.shape, generator=gn, device=device))
                               for x in images)
                nud = _remat_run(base, dtype, False, nudged, False)
                tols = TRAIN_TOL if dtype == "float32" else BF16_TRAIN_TOL
                spread = torch.maximum((again["losses"] - plain["losses"]).abs(),
                                       (nud["losses"] - plain["losses"]).abs()).double()
                err = (rem["losses"] - plain["losses"]).abs().double()
                lim = SPREAD * spread + tols["loss"] * plain["losses"].abs().double()
                worst = float((err / lim.clamp_min(1e-30)).max())
                bad += [f"{tag} loss {n}: {float(e):.3e} > {float(m):.3e}"
                        for n, e, m in zip(plain["names"], err, lim) if not e <= m]
                hold = {}
                for what in ("grads", "state"):
                    names, ref = plain[what]
                    sp = torch.maximum(_max_abs_diffs(again[what][1], ref),
                                       _max_abs_diffs(nud[what][1], ref))
                    rows_ = [(names, _max_abs_diffs(rem[what][1], ref), sp,
                              torch.stack([t.double().abs().max() for t in ref]))]
                    hold[what] = _hold_tensors(rows_, tols, f"{tag} {what}", bad)
                same_losses = bool(torch.equal(rem["losses"], plain["losses"]))
                print(f"[remat] {tag}: the remat step against the plain one: losses "
                      f"{'bit for bit' if same_losses else f'worst err/limit {worst:.3f}'}; "
                      + "; ".join(f"{w} {s_} of {c_} tensors bit for bit, worst err/limit "
                                  f"{w_[0]:.3f} ({w_[1]})" for w, (w_, s_, c_) in hold.items())
                      + f" (limit {SPREAD:g} x the plain step's own spread, run again and on "
                        f"images nudged by {NUDGE:g}, + {tols['grad']:g} x max|.|)")
                if dtype == "float32":
                    # where the remat step's peak now is
                    row["windows"] = _remat_windows(base, images)
                    top = sorted(row["windows"], key=lambda w: -w[1])[:4]
                    print(f"[remat] {tag}: the remat step's peak memory by window of its "
                          f"backward (a region's recompute to the next one's; G phase, then "
                          f"D): " + ", ".join(f"{n} {b / 2 ** 30:.2f} GiB" for n, b in top)
                          + f" of {len(row['windows'])} windows")
                row.update(losses_bit_for_bit=same_losses, losses_worst=worst,
                           **{f"{w}_bit_for_bit": v[1] / v[2] for w, v in hold.items()},
                           **{f"{w}_worst": v[0][0] for w, v in hold.items()})
                del again, nud
            rows[tag] = row
            del plain, rem
            gc.collect()
    finally:
        torch.use_deterministic_algorithms(False)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    check(not bad, f"remat steps differ from the plain steps: {bad[:8]}")
    fp32 = rows[f"float32 batch {N_BATCH}"]
    check(fp32["remat_peak_gib"] < fp32["peak_gib"],
          f"fp32 batch {N_BATCH}: remat peaks at {fp32['remat_peak_gib']:.2f} GiB, not below "
          f"{fp32['peak_gib']:.2f}")
    return paths, rows


def _variant_cfg(variant, size=None, tiny=False):
    """The Config of ``variant``: ModelConfig() widths at 256x256 (conv4
    with VARIANT_FULL's last encoder width), or its CPU test's size and
    widths (VARIANT_CPU) with ``tiny``."""
    import dataclasses
    from facevae_tpu_torch.config import Config, ModelConfig, tiny_config
    if tiny:
        size, kw, _ = VARIANT_CPU[variant]
        cfg = tiny_config(image_size=size)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, efe_variant=variant, **kw))
    return Config(model=ModelConfig(efe_variant=variant, **VARIANT_FULL.get(variant, {})))


def _variant_parity(variant):
    """``variant``'s EFE at its CPU test's size: the same seeded weights and
    inputs on the card and on the CPU, the eval form and the training form
    (BatchNorm on batch statistics): (the largest err / (tol x max|cpu|)
    over the outputs, where)."""
    import copy
    import numpy as np
    import torch
    from facevae_tpu_torch.models import build_models
    cfg = _variant_cfg(variant, tiny=True)
    size, _, n = VARIANT_CPU[variant]
    cpu = build_models(cfg.model, "cpu", names=("efe",))["efe"]
    card = copy.deepcopy(cpu).cuda()
    rs = np.random.RandomState(13)
    x, x_a = (torch.from_numpy(rs.rand(n, size, size, 3).astype(np.float32)) for _ in range(2))
    kp = torch.from_numpy(rs.uniform(-0.6, 0.6, (n, cfg.model.num_kp, 3)).astype(np.float32))
    worst = (0.0, "")
    with torch.no_grad():
        for train in (False, True):
            outs = [net.train(train)(*(t.to(dev) for t in (x, x_a, kp)))
                    for net, dev in ((cpu, "cpu"), (card, "cuda"))]
            leaves = [[o for o in _flat_outputs(out)] for out in outs]
            check(len(leaves[0]) == len(leaves[1]) > 0, f"{variant}: outputs differ in number")
            for i, (a, b) in enumerate(zip(*leaves)):
                tol = VARIANT_TOL["train" if train else "eval"]
                if i == 0 and variant == "conv6":
                    tol = max(tol, CONV6_KP_TOL)
                scale = float(a.abs().max())
                err = float((b.cpu() - a).abs().max())
                check(err <= tol * scale, f"{variant} {'train' if train else 'eval'} output {i}: "
                                          f"card vs CPU {err:.3e} > {tol:g} x {scale:.3e}")
                worst = max(worst, (err / (tol * scale) if scale else 0.0,
                                    f"{'train' if train else 'eval'} output {i}, limit {tol:g}"))
    if worst[0] > NEAR_LIMIT:
        _layer_breakdown(variant, cpu, card, (x, x_a, kp), worst[1].startswith("train"))
    return worst


def _layer_breakdown(variant, cpu, card, args, train):
    """Where an EFE's card-vs-CPU error comes from: forward hooks on every
    module of both copies keep each call's output; per module call the
    relative error max|card - cpu| / max|cpu|.  Printed: the largest inside
    the modules, the last module's (what the forward's own ops after it
    read) and the output's (the forward's first output, the keypoints)."""
    import torch
    rec = {"cpu": [], "card": []}

    def hook(side, name):
        def keep(mod, inp, out):
            y = out[0] if isinstance(out, (tuple, list)) else out
            if torch.is_tensor(y):
                rec[side].append((name or ".", type(mod).__name__, y.detach().double().cpu()))
        return keep
    handles = [m.register_forward_hook(hook(side, n))
               for side, net in (("cpu", cpu), ("card", card)) for n, m in net.named_modules()]
    try:
        with torch.no_grad():
            for net in (cpu, card):
                dev = next(net.parameters()).device
                net.train(train)(*(t.to(dev) for t in args))
    finally:
        for h in handles:
            h.remove()
    rows = []
    for (name, kind, a), (_, _, b) in zip(rec["cpu"], rec["card"]):
        scale = float(a.abs().max())
        rows.append((name, kind, float((b - a).abs().max()) / scale if scale else 0.0))
    *inside, (_, root, out) = rows          # the root module's hook fires last
    top = max(inside, key=lambda r: r[2])
    last = inside[-1]
    print(f"[variants] {variant} {'train' if train else 'eval'} form, card vs CPU by module "
          f"(max|card - cpu| / max|cpu|, {len(rows)} module calls): the largest inside the "
          f"modules {top[0]} ({top[1]}) {top[2]:.2e}; the last module, {last[0]} ({last[1]}), "
          f"{last[2]:.2e}; {root}'s output {out:.2e}, {out / max(last[2], 1e-30):.1f}x the last "
          f"module's: its forward's own ops after that module")


def _flat_outputs(out):
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in _flat_outputs(x)]
    return [] if out is None else [out]


def phase_variants(card):
    """Every EFE variant (EFE_VARIANTS) at 256x256 with ModelConfig()
    widths (conv4: VARIANT_FULL): the seeded G nets behind
    InferencePipeline.drive_batch on a batch of 8 (one warm-up, one timed;
    the multi-grid and single-grid forward kernels once each, plain
    versions never; outputs finite); each variant's EFE on the card against
    the CPU at its CPU test's size (_variant_parity); then one fp32 remat
    training step of "linear" at batch 8 (losses and both Adam steps
    finite, the step's launches), the variant the JAX step trains besides
    conv5."""
    import math
    import numpy as np
    import torch
    from facevae_tpu_torch.models import EFE_VARIANTS, build_models
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.train import create_train_state, train_step
    from facevae_tpu_torch.train.inference import InferencePipeline
    device = torch.device("cuda")
    rs = np.random.RandomState(21)
    src = torch.from_numpy(rs.rand(1, 256, 256, 3).astype(np.float32)).to(device)
    drv = torch.from_numpy(rs.rand(N_BATCH, 256, 256, 3).astype(np.float32)).to(device)
    total, rows = {}, {}
    for variant in EFE_VARIANTS:
        cfg = _variant_cfg(variant)
        pipe = InferencePipeline(cfg, build_models(cfg.model, device))
        enc = pipe.encode_source(src)
        pipe.drive_batch(*enc, drv)
        res = {}

        def drive():
            res["out"] = pipe.drive_batch(*enc, drv)
        fast_warp.reset_launch_counts()
        _, ms = _timed(drive, 1)
        counts = dict(fast_warp.launches)
        out = res.pop("out")
        want = {**dict.fromkeys(counts, 0), "warp_fwd": 1, "grid_fwd": 1}
        check(counts == want, f"{variant}: drive batch launches {counts}, want {want}")
        check(tuple(out.shape) == tuple(drv.shape) and bool(torch.isfinite(out).all()),
              f"{variant}: drive batch output {tuple(out.shape)}, finite "
              f"{bool(torch.isfinite(out).all())}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        efe_params = sum(p.numel() for p in pipe.models["efe"].parameters())
        del pipe, enc, out
        gc.collect()
        torch.cuda.empty_cache()
        worst = _variant_parity(variant)
        rows[variant] = {"drive_batch_ms": ms, "efe_params": efe_params, "parity_worst": worst[0]}
        print(f"[variants] {card}: {variant} at 256x256 ({efe_params} EFE parameters): drive "
              f"batch of {N_BATCH} {ms:.1f} ms ({N_BATCH * 1e3 / ms:.2f} frames/s), launches "
              f"{ {k: v for k, v in counts.items() if v} }; its EFE at the CPU test's size "
              f"({VARIANT_CPU[variant][0]}x{VARIANT_CPU[variant][0]}), card vs CPU, eval and "
              f"training forms: worst err/limit {worst[0]:.3f} ({worst[1]})")
    cfg = _variant_cfg("linear")
    check(cfg.model.remat, "the linear step's config does not rematerialize")
    state = create_train_state(cfg, device)
    g = torch.Generator(device=device).manual_seed(4)
    batch = tuple(torch.rand(N_BATCH, 256, 256, 3, generator=g, device=device) for _ in range(4))
    res = {}

    def step():
        res["out"] = train_step(state, batch, generator=g)
    fast_warp.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    _, ms = _timed(step, 1)
    counts = dict(fast_warp.launches)
    out = res.pop("out")
    losses = {k: float(v) for k, v in {**out["losses_g"], **out["losses_d"]}.items()}
    adam = [v for opt in (state.g_opt, state.d_opt) for st in opt.state.values()
            for v in st.values()]
    steps = {float(st["step"]) for opt in (state.g_opt, state.d_opt) for st in opt.state.values()}
    check(all(math.isfinite(v) for v in losses.values()), f"linear step losses {losses}")
    check(all(bool(torch.isfinite(v).all()) for v in adam) and steps == {1.0},
          f"linear step: Adam state finite {all(bool(torch.isfinite(v).all()) for v in adam)}, "
          f"steps {steps}")
    check(losses["C"] == 0.0, f"linear has no contrastive branch (quirk q2): C = {losses['C']}")
    want = _want(counts, "float32", 1)
    check(counts == want, f"linear step launches {counts}, want {want}")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    rows["linear_step"] = {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                           "losses": losses}
    print(f"[variants] {card}: linear, ModelConfig() fp32 remat, one training step at batch "
          f"{N_BATCH}: {ms:.1f} ms (the first: cuDNN's choices included), peak "
          f"{rows['linear_step']['peak_gib']:.2f} GiB, losses "
          f"{json.dumps({k: round(v, 5) for k, v in losses.items()})}, both Adam states finite "
          f"at step 1; launches {counts}")
    del state, out, adam
    gc.collect()
    torch.cuda.empty_cache()
    return total, rows


def _cotangent(shape, seed):
    """A seeded N(0, 1) cotangent on the CPU (the same on every device)."""
    import torch
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _grads_on(device, build, args, seed, nudge=0.0):
    """build(device) -> (fn, params); fn(*args on device): its outputs, then
    the gradients of sum(out * c) (c from ``seed``) with respect to the
    floating args and params, all on the CPU.  ``nudge`` scales the first
    arg by 1 + nudge."""
    import torch
    fn, params = build(device)
    for p in params:
        p.grad = None
    xs = [a.to(device).clone() for a in args]
    if nudge:
        xs[0].mul_(1.0 + nudge)
    xs = [x.requires_grad_() if x.is_floating_point() else x for x in xs]
    outs = fn(*xs)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    loss = sum((o.float() * _cotangent(o.shape, seed + i).to(device)).sum()
               for i, o in enumerate(outs))
    loss.backward()
    grads = [x.grad for x in xs if x.requires_grad] + [p.grad for p in params]
    return [t.detach().float().cpu() for t in outs + grads]


def _held_card(what, card, refs, tols, rows_bad):
    """Hold each card tensor to the nearest of the CPU answers ``refs``
    (lists alike) within tol x max|ref[0]|: tols[0] for the first (the
    output), tols[1] for the rest; returns the worst err / limit."""
    worst = 0.0
    for i, t in enumerate(card):
        tol = tols[0] if i == 0 else tols[1]
        scale = float(refs[0][i].abs().max())
        err = min(float((t - r[i]).abs().max()) for r in refs)
        limit = tol * scale
        worst = max(worst, err / limit if limit else (0.0 if err == 0 else float("inf")))
        if err > limit:
            rows_bad.append(f"{what} tensor {i}: card vs CPU {err:.3e} > {tol:g} x {scale:.3e}")
    return worst


def _library_modules():
    """The port's library modules at the CPU tests' sizes, seeded, on the
    CPU."""
    import torch
    from facevae_tpu_torch.losses import LPIPS, ContrastiveHeadConv, ContrastiveHeadConv2
    from facevae_tpu_torch.nn import init_parameters, wn
    nets = torch.nn.ModuleDict({
        "LinearWN": wn.LinearWN(7, 5),
        "Conv2dWN": wn.Conv2dWN(3, 5, 3, stride=2, padding=1),
        "ConvTranspose2dWN": wn.ConvTranspose2dWN(4, 4, 3, stride=2, padding=1),
        "Conv2dUB": wn.Conv2dUB(3, 5, 8, 6, 3, padding=1),
        "Conv2dWNUB": wn.Conv2dWNUB(3, 5, 8, 6, 3, padding=1),
        "ConvTranspose2dUB": wn.ConvTranspose2dUB(3, 5, 10, 8, 4, stride=2, padding=1),
        "ConvTranspose2dWNUB": wn.ConvTranspose2dWNUB(3, 5, 10, 8, 4, stride=2, padding=1),
        "Conv3dUB": wn.Conv3dUB(2, 4, 3, 4, 5, 3, padding=1),
        "ConvTranspose3dUB": wn.ConvTranspose3dUB(2, 4, 6, 8, 10, 4, stride=2, padding=1),
        "LPIPS": LPIPS(),
        "ContrastiveHeadConv": ContrastiveHeadConv(8),
        "ContrastiveHeadConv2": ContrastiveHeadConv2(),
    })
    return init_parameters(nets, torch.Generator().manual_seed(LIBRARY_SEED))


def _library_parity(card, device="cuda"):
    """Each library module on the card against the port on the CPU at the
    CPU tests' sizes and tolerances (LIBRARY_TOL), from the same seeded
    inputs and weights: outputs and the gradients the tests hold.  Returns
    {module: worst err / limit}."""
    import copy
    import math
    import torch
    from facevae_tpu_torch.losses import contrastive_loss
    from facevae_tpu_torch.nn import fuse_wn, wn
    from facevae_tpu_torch.ops import grid_sample as gs, heatmap, rotations as rot
    T = LIBRARY_TOL
    g = torch.Generator().manual_seed(LIBRARY_SEED)
    nets = {"cpu": _library_modules()}
    nets[device] = copy.deepcopy(nets["cpu"]).to(device)
    bad, worst = [], {}

    def hold(what, build, args, tols, nudged=False):
        cpu = [_grads_on("cpu", build, args, 1)]
        if nudged:
            cpu += [_grads_on("cpu", build, args, 1, e) for e in (2.0 ** -22, -2.0 ** -22)]
        on_card = _grads_on(device, build, args, 1)
        worst[what] = max(worst.get(what, 0.0), _held_card(what, on_card, cpu, tols, bad))

    def fn_only(f):
        return lambda device: (f, [])

    shapes = {2: ((2, 5, 7, 3), (2, 6, 4)), 3: ((2, 3, 5, 4, 3), (2, 4, 3, 5))}
    for d, (xs, gshape) in shapes.items():
        f = gs.grid_sample_2d if d == 2 else gs.grid_sample_3d
        for one in (False, True):
            shape = xs[:1] + (1,) + xs[2:] if one else xs
            x = torch.randn(shape, generator=g)
            grid = torch.rand(gshape + (d,), generator=g) * 4 - 2
            for align in (True, False):
                for pad in gs.PADDING_MODES:
                    hold(f"grid_sample_{d}d", fn_only(
                        lambda x, grid, f=f, a=align, p=pad: f(x, grid, align_corners=a,
                                                                 padding_mode=p)),
                         (x, grid), (T["grid_fwd"], T["grid_grad"]))
    by_function, near_pi = {}, {}
    for dtype in (torch.float32, torch.float64):
        # the CPU test's draw (tests/test_torch_rotations_heatmap.py _rvecs):
        # randn(3) x U(0.05, 3) / sqrt(3) (angles mostly in (0, pi)), a zero
        # vector and a tiny one; each function on the card gets the CPU's own
        # inputs (its R, axis, angle and matrices), as the test hands JAX's
        # to both sides, so only that function's own rounding shows
        def rvecs():
            r = (torch.randn(64, 3, generator=g, dtype=dtype)
                 * (0.05 + 2.95 * torch.rand(64, 1, generator=g, dtype=dtype)) / math.sqrt(3.0))
            r[0], r[1] = 0.0, 1e-9
            return r
        r, r2 = rvecs(), rvecs()
        q = torch.randn(64, 4, generator=g, dtype=dtype)
        R, R2 = rot.rodrigues(r), rot.rodrigues(r2)
        axis, angle = rot.matrix_to_axisangle(R)
        alphas = (0.0, 0.3, 1.0, torch.linspace(0, 1, 64, dtype=dtype))
        cases = {"rodrigues": (rot.rodrigues, (r,)),
                 "quaternion_to_matrix": (rot.quaternion_to_matrix, (q,)),
                 "matrix_to_quaternion": (rot.matrix_to_quaternion, (R,)),
                 "matrix_to_axisangle": (rot.matrix_to_axisangle, (R,)),
                 "axisangle_to_matrix": (rot.axisangle_to_matrix, (axis, angle))}
        for i, a in enumerate(alphas):
            cases[f"rotation_interp alpha {i}"] = (rot.rotation_interp, (R, R2, a))
        tol = T["rot"][str(dtype).split(".")[-1]]
        for what, m in (("R", R), ("R2 R^T", R2 @ R.transpose(-1, -2))):
            theta = rot.matrix_to_axisangle(m.double())[1]
            near_pi[f"{what} {str(dtype).split('.')[-1]}"] = float(math.pi - theta.max())
        for what, (f, args) in cases.items():
            cpu = f(*args)
            on_card = f(*(a.to(device) if torch.is_tensor(a) else a for a in args))
            cpu, on_card = ([t] if torch.is_tensor(t) else list(t) for t in (cpu, on_card))
            ratio = _held_card(f"{what} {dtype}", [t.cpu() for t in on_card], [cpu], (tol, tol),
                               bad)
            worst["rotations"] = max(worst.get("rotations", 0.0), ratio)
            by_function[f"{what} {str(dtype).split('.')[-1]}"] = round(ratio, 4)
            if ratio > 1.0:
                # where the miss is: the row and its rotation angle (of the
                # matrix, or of the relative rotation R2 R^T for the interp)
                err = torch.stack([(c.cpu() - t).abs().reshape(t.shape[0], -1).amax(1)
                                   for c, t in zip(on_card, cpu)]).amax(0)
                row = int(err.argmax())
                src = R2 @ R.transpose(-1, -2) if what.startswith("rotation_interp") else R
                theta = float(rot.matrix_to_axisangle(src.double())[1][row])
                print(f"[library] {what} {dtype}: card vs CPU {ratio:.3f} x the limit at row "
                      f"{row} (rotation angle {theta:.6f} rad, pi - angle "
                      f"{math.pi - theta:.3e})")
    print(f"[library] rotations, card vs CPU on the CPU's inputs, err/limit by function: "
          f"{json.dumps(by_function)}; the draw's nearest approach to pi (pi - largest "
          f"angle, of R and of the interpolation's relative rotation): "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in near_pi.items()})}")
    heat_inputs = []
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        out = torch.randn(2, 5, 4, 6, 7, generator=g) * 3
        kp = torch.rand(2, 5, 2, generator=g) * 2 - 1

        def heat(o, k):
            return (heatmap.out2heatmap(o), heatmap.heatmap2kp(o),
                    heatmap.kp2gaussian_2d(k, (9, 7)))
        cpu = [t.float() for t in heat(out.to(dtype), kp.to(dtype))]
        on_card = [t.float().cpu() for t in heat(out.to(dtype).to(device), kp.to(dtype).to(device))]
        worst["heatmaps"] = max(worst.get("heatmaps", 0.0), _held_card(
            "heatmaps", on_card, [cpu], (T["heat"][name],) * 2, bad))
        heat_inputs.append((name, dtype, out, kp))
    if worst["heatmaps"] > NEAR_LIMIT:
        _heatmap_breakdown(heat_inputs, device)
    layer_inputs = {"LinearWN": (3, 7), "Conv2dWN": (2, 3, 9, 8), "ConvTranspose2dWN": (2, 4, 5, 4),
                    "Conv2dUB": (2, 3, 8, 6), "Conv2dWNUB": (2, 3, 8, 6),
                    "ConvTranspose2dUB": (2, 3, 5, 4), "ConvTranspose2dWNUB": (2, 3, 5, 4),
                    "Conv3dUB": (1, 2, 3, 4, 5), "ConvTranspose3dUB": (1, 2, 3, 4, 5)}
    for name, shape in layer_inputs.items():
        hold(name, lambda device, n=name: (nets[device][n], list(nets[device][n].parameters())),
             (torch.randn(shape, generator=g),), (T["layer"], T["layer"]))
    x = torch.rand(2, 3, 11, 10, generator=g)
    for what, f in (("downsample2d", lambda x: wn.downsample2d(x, 2, "reflect")),
                    ("dilate2d", lambda x: wn.dilate2d(3.0 * x, 3, 1, 1))):
        hold(what, fn_only(f), (x,), (T["layer"], T["layer"]))
    fused = {d: fuse_wn(copy.deepcopy(nets[d])) for d in nets}
    for k, p in fused["cpu"].state_dict().items():
        worst["fuse_wn"] = max(worst.get("fuse_wn", 0.0), _held_card(
            f"fuse_wn {k}", [fused[device].state_dict()[k].float().cpu()], [[p.float()]],
            (T["fuse"], T["fuse"]), bad))
    x, y = (torch.rand(2, 32, 32, 3, generator=g) * 2 - 1 for _ in range(2))
    hold("LPIPS", lambda device: (nets[device]["LPIPS"], []), (x, y), (T["net"], T["net"]))
    with torch.no_grad():
        same = nets[device]["LPIPS"](x.to(device), x.to(device))
    if not torch.equal(same, torch.zeros_like(same)):
        bad.append(f"LPIPS(x, x) on the card {same.tolist()}, not 0")
    f1, f2 = (torch.randn(3, 2, 4, 5, generator=g) for _ in range(2))
    hold("contrastive_loss", fn_only(contrastive_loss), (f1, f2), (T["layer"], T["layer"]))
    f1, f2 = (torch.randn(2, 32, 32, 8, generator=g) for _ in range(2))
    hold("ContrastiveHeadConv", lambda device: (
        lambda a, b: nets[device]["ContrastiveHeadConv"](a, b, nets[device]["LPIPS"]),
        list(nets[device]["ContrastiveHeadConv"].parameters())), (f1, f2),
        (T["net"], T["net"]), nudged=True)
    f1, f2 = (torch.randn(4, 4, 4, 256, generator=g) for _ in range(2))
    for train in (True, False):
        head = {d: copy.deepcopy(nets[d]["ContrastiveHeadConv2"]).train(train) for d in nets}
        params = {d: [p for k, p in head[d].named_parameters()
                      if not (train and k == "proj_conv.bias")] for d in head}
        hold(f"ContrastiveHeadConv2 {'train' if train else 'eval'}",
             lambda device: (head[device], params[device]), (f1, f2), (T["net"], T["net"]))
        if train:          # the running statistics after the two forwards (cpu, card)
            for k, b in head["cpu"].named_buffers():
                worst["ContrastiveHeadConv2 stats"] = max(
                    worst.get("ContrastiveHeadConv2 stats", 0.0),
                    _held_card(f"ContrastiveHeadConv2 {k}",
                               [dict(head[device].named_buffers())[k].cpu()],
                               [[b]], (T["net"], T["net"]), bad))
    check(not bad, "library card vs CPU: " + "; ".join(bad[:8]))
    return worst


def _heatmap_breakdown(inputs, device):
    """Where the channel-first heatmaps' card-vs-CPU error comes from: each
    step of out2heatmap, heatmap2kp and kp2gaussian_2d (ops/heatmap.py's
    steps, each from its own device's step before) on the card against
    the CPU, as err / (tol x max|cpu|); and heatmap2kp's contraction
    against float64: each side's error, and its sums' cancellation (the
    largest sum |terms| over the largest |sum|)."""
    import torch
    from facevae_tpu_torch.ops.geometry import make_coordinate_grid_2d, make_coordinate_grid_3d

    def steps(out, kp):
        temperature = torch.tensor(0.1, dtype=out.dtype).item()
        flat = out.reshape(out.shape[0], out.shape[1], -1) / temperature
        e = torch.exp(flat - flat.amax(dim=2, keepdim=True))
        total = e.sum(dim=2, keepdim=True)
        grid = make_coordinate_grid_3d(out.shape[2:], dtype=out.dtype, device=out.device)
        diff = (make_coordinate_grid_2d((9, 7), dtype=kp.dtype, device=kp.device)[None, None]
                - kp[:, :, None, None, :])
        sq = torch.sum(diff * diff, dim=-1)
        return {"out / T": flat, "exp": e, "sum": total, "out2heatmap": e / total,
                "heatmap2kp": torch.einsum("nkdhw,dhwc->nkc", out, grid),
                "sum of squares": sq, "kp2gaussian_2d": torch.exp(-0.5 * sq / 0.01)}
    for name, dtype, out, kp in inputs:
        tol = LIBRARY_TOL["heat"][name]
        cpu = steps(out.to(dtype), kp.to(dtype))
        on_card = steps(out.to(dtype).to(device), kp.to(dtype).to(device))
        ratios = {k: round(float((on_card[k].double().cpu() - a.double()).abs().max())
                           / (tol * float(a.double().abs().max())), 4) for k, a in cpu.items()}
        o = out.to(dtype).double()
        terms = (o.reshape(*o.shape[:2], -1, 1)
                 * make_coordinate_grid_3d(o.shape[2:], dtype=torch.float64).reshape(1, 1, -1, 3))
        ref = terms.sum(2)
        off = {side: float((d["heatmap2kp"].double().cpu() - ref).abs().max())
               for side, d in (("CPU", cpu), ("card", on_card))}
        print(f"[library] heatmaps {name}, each step card vs CPU, err / ({tol:g} x max|cpu|): "
              f"{json.dumps(ratios)}; heatmap2kp against float64: CPU off by "
              f"{off['CPU']:.3e}, card by {off['card']:.3e} (the limit {tol:g} x "
              f"{float(ref.abs().max()):.3e}); cancellation "
              f"{float(terms.abs().sum(2).max() / ref.abs().max()):.1f}")


def _library_timings(card, device="cuda"):
    """Each module at a size its users run it, timed with CUDA events
    (cuda_ms): forward, and forward + backward where it is differentiated in
    use; grid_sample beside F.grid_sample on the same tensors (contiguous
    NC(D)HW copies made before the call: a yardstick)."""
    import torch
    import torch.nn.functional as F
    from facevae_tpu_torch.losses import LPIPS, ContrastiveHeadConv, ContrastiveHeadConv2
    from facevae_tpu_torch.nn import init_parameters, wn
    from facevae_tpu_torch.ops import grid_sample as gs, rotations as rot
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(LIBRARY_SEED)
    B, (D, H, W), S = N_BATCH, VOLUME, AUG_SIZE
    rows = []

    def row(name, shape, fwd, bwd=None):
        with torch.no_grad():
            r = {"name": name, "shape": shape, "ms": cuda_ms(fwd)}
        if bwd is not None:
            r["fwd_bwd_ms"] = cuda_ms(bwd)
        rows.append(r)
        print(f"[library] {card}: {json.dumps(r)}")

    def fwd_bwd(f, *xs):
        def run():
            for x in xs:
                x.grad = None
            f().float().sum().backward()
        return run

    for d, (xshape, gshape) in {2: ((B, S, S, 3), (B, S, S)),
                                3: ((B, D, H, W, 32), (B, D, H, W))}.items():
        x = torch.randn(xshape, generator=g, device=dev).requires_grad_()
        grid = (torch.rand(gshape + (d,), generator=g, device=dev) * 2.2 - 1.1).requires_grad_()
        x_cf = x.detach().movedim(-1, 1).contiguous()
        f = gs.grid_sample_2d if d == 2 else gs.grid_sample_3d
        for align in (True, False):
            for pad in gs.PADDING_MODES:
                def ours(a=align, p=pad):
                    return f(x, grid, align_corners=a, padding_mode=p)

                def library(a=align, p=pad):
                    return F.grid_sample(x_cf, grid.detach(), mode="bilinear", padding_mode=p,
                                         align_corners=a)
                with torch.no_grad():
                    diff = float((ours().movedim(-1, 1) - library()).abs().max())
                    ms = cuda_ms(ours)
                    library_ms = cuda_ms(library)
                r = {"name": f"grid_sample_{d}d", "shape": list(xshape),
                     "align_corners": align, "padding_mode": pad, "ms": ms,
                     "fwd_bwd_ms": cuda_ms(fwd_bwd(ours, x, grid)),
                     "max_abs_diff_vs_F_grid_sample": diff, "F_grid_sample_ms": library_ms}
                rows.append(r)
                print(f"[library] {card}: {json.dumps(r)}")
                check(diff <= LIBRARY_TOL["grid_vs_library"] * float(x.detach().abs().max()),
                      f"grid_sample_{d}d {align} {pad}: F.grid_sample differs by {diff:.3e}")
    del x, grid, x_cf
    lpips = LPIPS(device=dev)
    init_parameters(lpips, torch.Generator(device=dev).manual_seed(LIBRARY_SEED))
    a, b = (torch.rand(B, S, S, 3, generator=g, device=dev) * 2 - 1 for _ in range(2))
    peaks = {}
    for key, f in (("fwd", lambda: lpips(a, b)), ("fwd_bwd", fwd_bwd(lambda: lpips(a, b), a))):
        if key == "fwd_bwd":
            a.requires_grad_()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.set_grad_enabled(key == "fwd_bwd"):
            f()
        torch.cuda.synchronize()
        peaks[key] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    with torch.no_grad():
        dist = lpips(a, b)
        check(bool(torch.isfinite(dist).all()) and tuple(dist.shape) == (B,), f"LPIPS {dist}")
        fwd_ms = cuda_ms(lambda: lpips(a, b))
    rows.append({"name": "LPIPS", "shape": [B, S, S, 3], "ms": fwd_ms,
                 "fwd_bwd_ms": cuda_ms(fwd_bwd(lambda: lpips(a, b), a)),
                 "peak_gib_fwd": peaks["fwd"], "peak_gib_fwd_bwd": peaks["fwd_bwd"]})
    print(f"[library] {card}: {json.dumps(rows[-1])}")
    del a, b
    head = ContrastiveHeadConv(32, device=dev)
    init_parameters(head, torch.Generator(device=dev).manual_seed(LIBRARY_SEED))
    f1, f2 = (torch.randn(B, H, W, 32, generator=g, device=dev) for _ in range(2))
    row("ContrastiveHeadConv", [B, H, W, 32], lambda: head(f1, f2, lpips),
        fwd_bwd(lambda: head(f1, f2, lpips)))
    head2 = ContrastiveHeadConv2(device=dev)
    init_parameters(head2, torch.Generator(device=dev).manual_seed(LIBRARY_SEED))
    f1, f2 = (torch.randn(B, 4, 4, 256, generator=g, device=dev) for _ in range(2))
    for train in (True, False):
        head2.train(train)
        row(f"ContrastiveHeadConv2 {'train' if train else 'eval'}", [B, 4, 4, 256],
            lambda: head2(f1, f2), fwd_bwd(lambda: head2(f1, f2)))
    layers = (("Conv2dWN 3x3 256->256", wn.Conv2dWN(256, 256, 3, padding=1, device=dev),
               (B, 256, H, W)),
              (f"ConvTranspose2dWNUB 64->32 stride 2 to {2 * H}x{2 * W}",
               wn.ConvTranspose2dWNUB(64, 32, 2 * H, 2 * W, 4, stride=2, padding=1, device=dev),
               (B, 64, H, W)))
    for name, layer, shape in layers:
        init_parameters(torch.nn.Sequential(layer), torch.Generator(device=dev).manual_seed(1))
        x = torch.randn(shape, generator=g, device=dev)
        row(name, list(shape), lambda: layer(x), fwd_bwd(lambda: layer(x)))
    x = torch.rand(B, 3, S, S, generator=g, device=dev)
    row("downsample2d reflect", [B, 3, S, S], lambda: wn.downsample2d(x, 1, "reflect"))
    r = torch.randn(LIBRARY_ROTATIONS, 3, generator=g, device=dev)
    R0, R1 = rot.rodrigues(r), rot.rodrigues(r.flip(0))
    row("rodrigues", [LIBRARY_ROTATIONS, 3], lambda: rot.rodrigues(r))
    row("matrix_to_quaternion", [LIBRARY_ROTATIONS, 3, 3], lambda: rot.matrix_to_quaternion(R0))
    row("rotation_interp", [LIBRARY_ROTATIONS, 3, 3], lambda: rot.rotation_interp(R0, R1, 0.3))
    return rows


def phase_library(card):
    """The library modules no model path runs (ops/grid_sample.py,
    ops/rotations.py, the channel-first heatmaps, nn/wn.py, losses/lpips.py,
    the conv contrastive heads): on the card against the CPU at the CPU
    tests' sizes, then timed at full size."""
    t0 = time.perf_counter()
    worst = _library_parity(card)
    print(f"[library] {card}: card vs CPU at the CPU tests' sizes, worst err/limit by module "
          f"{json.dumps({k: round(v, 4) for k, v in worst.items()})} "
          f"({time.perf_counter() - t0:.1f} s)")
    rows = _library_timings(card)
    return {"parity_worst": worst, "rows": rows}


def _probe_row(name, out, ref, r, plain_ms, site):
    """One kernel-vs-plain comparison of phase 9 (out, ref: the two results
    on the same inputs; r: the probe's run() figures)."""
    import torch
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"{name} {site}: {tuple(out.shape)} {out.dtype} vs plain {tuple(ref.shape)} {ref.dtype}")
    err = (out.float() - ref.float()).abs().max().item() if out.numel() else 0.0
    scale = ref.float().abs().max().item() if ref.numel() else 0.0
    return dict(name=name, site=site, err=err, scale=scale, equal=bool(torch.equal(out, ref)),
                ms=r["ms"], plain_ms=plain_ms, library_ms=r["library_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"])


def phase_probes():
    """The probe path (each probe's run(), as its entry point calls it),
    then each probe kernel against its plain version."""
    import torch
    from facevae_tpu_torch.probes import common as pc
    from facevae_tpu_torch.probes import microbench_gather as p9
    from facevae_tpu_torch.probes import microbench_lane_gather as p10
    from facevae_tpu_torch.probes import proto_banded_warp as p8
    from facevae_tpu_torch.probes import proto_warp as p7
    mods = {"probe_warp": p7, "probe_banded_warp": p8, "probe_gather": p9,
            "probe_lane_gather": p10}
    dev = torch.device("cuda")
    for m in mods.values():
        m.reset_launch_counts()
    r7, r8, r9, r10 = p7.run(dev), p8.run(dev), p9.run(dev), p10.run(dev)
    torch.cuda.synchronize()
    counts = {k: v for m in mods.values() for k, v in m.launches.items()}
    print(f"[probes] launches on the probe path {counts}")
    check(all(counts[k] > 0 for k in mods) and not any(counts[k + "_plain"] for k in mods),
          f"probe path launches {counts}: want every probe kernel, no plain version")

    volT, gx, gy, gz, shape = r7["args"]
    row = _probe_row("probe_warp", p7.proto_warp_cuda(volT, gx, gy, gz, shape),
                     p7.proto_warp_plain(volT, gx, gy, gz, shape), r7,
                     pc.graph_ms(lambda: p7.proto_warp_plain(volT, gx, gy, gz, shape)),
                     f"P={gx.shape[1]}")
    rows = [row]
    print(f"[probes] probe_warp: {r7['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"F.grid_sample {r7['library_ms']:.4f} ms (on a contiguous copy of the table made "
          f"before the call; {r7['library_view_ms']:.4f} ms on volT's own permuted view), "
          f"one-hot partner {r7['onehot_ms']:.4f} ms, "
          f"bound {r7['bound_ms'] * 1e3:.3f} us; vs plain max|err| {row['err']:.3e} (max|ref| "
          f"{row['scale']:.3f}); vs the probe's oracle {r7['err']:.4f} on the fp32 volume "
          f"(bf16 table), {r7['err_exact']:.3e} on the bf16 volume")
    check(row["err"] <= PROBE_TOL * row["scale"], f"probe_warp: {row['err']:.3e}")
    check(r7["err_exact"] <= PROBE_TOL * r7["scale"],
          f"probe_warp vs the oracle on the bf16 volume: {r7['err_exact']:.3e}")
    for mode, num in r8["numerics"].items():
        print(f"[probes] probe_banded_warp {mode} vs the probe's host oracle (n=0..1, theta=3): "
              + ("not checked (a box exceeds the budget)" if num is None else
                 f"max abs {num[0]:.3e}, rel {num[1]:.3e}"))
        check(num is None or num[1] <= PROBE_TOL, f"probe_banded_warp {mode} vs host: {num}")
    for t in r8["thetas"]:
        args = t["args"]
        plain = p8.banded_warp_plain(*args)
        plain_ms = pc.graph_ms(lambda: p8.banded_warp_plain(*args))
        fit = f"{t['probe_fit']:.2f}"
        print(f"[probes] probe_banded_warp theta={t['theta']}: probe fit rate {fit} "
              f"(ZB={p8.ZB}); kernel 1 {t['kernel1_ms']:.4f} ms on bf16 x, "
              f"{t['kernel1_fp32_ms']:.4f} ms on fp32 x; nothing staged (blockwhen, budget "
              f"1 row) {t['unstaged_ms']:.4f} ms; F.grid_sample "
              f"{t['library_ms']:.4f} ms (fp32 source per grid made before the call; "
              f"{t['library_relayout_ms']:.4f} ms with it made from rows3 inside); "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
              f"plain {plain_ms:.4f} ms")
        check(fit == PROBE_FIT[t["theta"]], f"probe fit rate at theta={t['theta']}: {fit}")
        for mode, m in t["modes"].items():
            out = p8.banded_warp_cuda(*args, mode=mode)
            exact = m["vs_kernel1"] is not None
            row = _probe_row("probe_banded_warp", out, plain, dict(t, ms=m["ms"]), plain_ms,
                             f"theta={t['theta']} {mode}")
            row.update(mode=mode, exact=exact, staged=m["staged"])
            rows.append(row)
            k1 = m["vs_kernel1"]
            print(f"[probes]   {mode}: {m['ms']:.4f} ms ({t['kernel1_ms'] / m['ms']:.2f}x kernel "
                  f"1); boxes staged {m['staged']:.4f} (budget {p8.BUDGET} rows; as the "
                  f"host reckons: {m['flags_match']}); vs plain "
                  + (f"max|err| {row['err']:.3e} (max|ref| {row['scale']:.3f})" if exact else
                     "not checked (bandonly, a box exceeds the budget)")
                  + ("" if k1 is None else f"; vs kernel 1 fp32 max|err| {k1[0]:.3e}, bit for "
                     f"bit {'yes' if k1[2] else 'no'}"))
            check(m["flags_match"], f"{mode} theta={t['theta']} staged other boxes than "
                                    "staged_flags reckons")
            check(not exact or row["err"] <= PROBE_TOL * row["scale"],
                  f"probe_banded_warp {mode} theta={t['theta']}: {row['err']:.3e}")
            check(k1 is None or k1[0] <= PROBE_TOL * k1[1],
                  f"probe_banded_warp {mode} vs kernel 1 theta={t['theta']}: {k1}")
    for r in r9:
        table, idx = r["args"]
        row = _probe_row("probe_gather", p9.gather_cuda(table, idx), p9.gather_plain(table, idx),
                         r, pc.graph_ms(lambda: p9.gather_plain(table, idx)), f"SxTxP={r['case']}")
        rows.append(row)
        row["floor_ms"] = r["floor_ms"]
        print(f"[probes] probe_gather S,T,P={r['case']}: bit for bit vs plain {row['equal']}, "
              f"vs numpy {r['equal']}; {r['ms'] * 1e3:.2f} us ({r['gbps']:.1f} GB/s), launch "
              f"floor (an empty kernel in its grid) {r['floor_ms'] * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us, torch.gather {r['library_ms'] * 1e3:.2f} us, "
              f"bound {r['bound_ms'] * 1e3:.3f} us")
        check(row["equal"] and r["equal"], f"probe_gather {r['case']} differs")
    data, idx = r10["args"]
    row = _probe_row("probe_lane_gather", p10.lane_gather_cuda(data, idx),
                     p10.lane_gather_plain(data, idx), r10,
                     pc.graph_ms(lambda: p10.lane_gather_plain(data, idx)), f"NB={idx.shape[0]}")
    rows.append(row)
    print(f"[probes] probe_lane_gather: bit for bit vs plain {row['equal']}, vs numpy "
          f"{r10['equal']}; {r10['ms']:.4f} ms ({r10['gbps']:.1f} GB/s), plain "
          f"{row['plain_ms']:.4f} ms, torch.gather {r10['library_ms']:.4f} ms, bound "
          f"{r10['bound_ms']:.4f} ms")
    check(row["equal"] and r10["equal"], "probe_lane_gather differs")
    return rows, counts


def main(argv=None) -> int:
    """Every phase in order, then the kernels line and the result line."""
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        print(f"FAIL: unknown arguments {argv}")
        return 1
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: {e}")
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test needs a CUDA GPU")
        return 1
    try:
        import facevae_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: run from the root of a checkout ({e})")
        return 1
    t_all = time.perf_counter()
    phase_s, paths, det_paths = {}, {}, {}
    try:
        card = phase_device()
        for name, fn in (("build", phase_build), ("kernels", phase_kernels),
                         ("golden", phase_golden), ("serve", lambda: phase_serve(card)),
                         ("train_tiny", phase_train_tiny),
                         ("train", lambda: _train(card, "float32")),
                         ("checkpoint", lambda: phase_checkpoint(card)),
                         ("reference", lambda: phase_reference(card)),
                         ("eval", lambda: phase_eval(card)),
                         ("train_bf16", lambda: _train(card, "bfloat16")),
                         ("train_loop", lambda: phase_train_loop(card)),
                         ("video", lambda: phase_video(card)),
                         ("dp", lambda: phase_dp(card)), ("scan", lambda: phase_scan(card)),
                         ("remat", lambda: phase_remat(card)),
                         ("variants", lambda: phase_variants(card)),
                         ("library", lambda: phase_library(card)),
                         ("probes", phase_probes)):
            # a train state lives in reference cycles, which only the
            # collector frees: collect them, so that a phase's peak memory
            # holds no tensor of the phase before
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out = fn()
            phase_s[name] = round(time.perf_counter() - t0, 1)
            if name == "kernels":
                rows = out
            elif name in ("serve", "train", "train_bf16"):
                paths[name] = out                  # each main path's launch counts
            elif name == "train_tiny":
                det_paths.update(out)              # the deterministic mode's steps
            elif name == "reference":
                paths["reference"], reference_rates = out
            elif name == "eval":
                paths["eval"], eval_n1, eval_rates = out
            elif name == "train_loop":
                paths["train_loop"], aug_rows, loop_rates = out
            elif name == "video":
                paths["video"], video_rates = out
            elif name == "dp":
                dp_rates = out
            elif name == "scan":
                scan_paths, scan_rates = out
                det_paths["scan_tiny_det"] = scan_paths.pop("scan_tiny_det")
                paths.update(scan_paths)           # the graph path: captured x replays
            elif name == "remat":
                # deterministic steps: the dx kernels' variants launch there
                paths["remat"], remat_rows = out
                det_paths["remat"] = paths["remat"]
            elif name == "variants":
                paths["variants"], variant_rows = out
            elif name == "library":
                library_rows = out
            elif name == "probes":
                probe_rows, probe_counts = out
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        # the kernel's fp32 calls at the main paths' sites (SITES); the
        # deterministic variants launch on the deterministic steps of phase 6
        fp32 = [r for r in rows if r["name"] == name and r["dtype"] == "float32" and r["in_json"]]
        counted = det_paths if name.endswith("_det") else paths
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(p[name] for p in counted.values()),
            "launches_by_path": {k: p[name] for k, p in counted.items()},
            "max_abs_err": max(r["err"] for r in fp32),
            "ms": sum(r["ms"] for r in fp32), "event_ms": sum(r["event_ms"] for r in fp32),
            "plain_ms": sum(r["plain_ms"] for r in fp32),
            "bound_ms": sum(r["bound_ms"] for r in fp32), "bound_by": fp32[0]["bound_by"],
            "library_ms": sum(r["library_ms"] for r in fp32),
            "sites": [r["site"] for r in fp32]})
        if name in eval_n1:            # kernels 1 and 4 at the eval path's N = 1 calls
            kernels[-1]["eval_n1"] = {k: eval_n1[name][k] for k in (
                "err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        if name == "warp_fwd":         # kernel 1 at the training augmentation's call
            kernels[-1]["aug"] = {d: {k: r[k] for k in (
                "err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for d, r in aug_rows.items()}
    for name, (source, replaces) in PROBE_KERNELS.items():
        # probe 8: its default mode (banded) at both thetas; probe 9: its seven cases
        mine = [r for r in probe_rows if r["name"] == name and r.get("mode", "banded") == "banded"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": probe_counts[name], "launches_by_path": {"probes": probe_counts[name]},
            "max_abs_err": max(r["err"] for r in mine),
            "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine), "bound_by": mine[0]["bound_by"],
            "library_ms": sum(r["library_ms"] for r in mine),
            "sites": [r["site"] for r in mine]})
        if name == "probe_gather":
            kernels[-1]["floor_ms"] = sum(r["floor_ms"] for r in mine)
    print(json.dumps({"kernels": kernels}))
    print(f"[reference] {json.dumps({'card': card, **reference_rates})}")
    print(f"[eval] {json.dumps({k: round(v, 3) for k, v in eval_rates.items()})}")
    print(f"[train_loop] {json.dumps(loop_rates)}")
    print(f"[video] {json.dumps(video_rates)}")
    print(f"[dp] {json.dumps(dp_rates)}")
    print(f"[scan] {json.dumps(scan_rates)}")
    print(f"[remat] {json.dumps(remat_rows)}")
    print(f"[variants] {json.dumps(variant_rows)}")
    print(f"[library] {json.dumps({'card': card, **library_rows})}")
    print(f"[done] {time.perf_counter() - t_all:.1f} s; phases {json.dumps(phase_s)}")
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-refs"]:
        sys.exit(cpu_references(sys.argv[2]))
    sys.exit(main())
