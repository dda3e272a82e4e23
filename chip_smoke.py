"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py [--seed N] [--out DIR]

Phases, in order; any error or tolerance breach fails the run (nonzero exit):
  1. device: a CUDA card is required; TF32 is switched off and printed.
  2. build: the WN-layer kernels are compiled from
     waveglow_tpu_torch/csrc/wn_layer.cu (forward), wn_layer_bwd.cu (the
     bf16 backward, the whole layer's and a model rank's) and
     wn_layer_shard.cu (a model rank's share), one nvcc per source,
     started together, every width instance (C = 128, 256, 512; the shard
     kernels at C' = C/2, C/4, C/8); build seconds and
     ptxas facts (when this run built it), and what the loaded build uses
     as the CUDA runtime reports it (registers, local bytes, shared
     memory). The library's SASS (cuobjdump -sass) must show
     tensor-core instructions (HMMA/HGMMA) in every bf16 kernel (the
     forward variants, the C = 512 gate kernel, the backwards' rows, dx
     and weights kernels, the bf16 shard kernels) and none in the f32
     ones; the backwards' reduce kernels, the whole layer's prep kernel
     and the C = 512 rounding of x do no products. The rows, dx and
     weights kernels of both backwards and the C = 512 bf16 forward's gate
     and res/skip kernels (the layer's, and each model rank's, which
     replace the mma.sync shard kernel there) must be wgmma (HGMMA), with
     no ptxas warning
     that their wgmmas are serialized (C7511/C7513), and no spill (their
     registers, spills and shared memory are printed). The f32 kernel's
     registers, shared memory, blocks an SM and grid at B=1 and B=8 are
     printed (at each width), and any spill of an f32 forward variant
     fails.
  3. kernel: the kernel against its plain PyTorch version on the card at
     C=256, T=26,432 groups (826 frames), B in {1, 8}, every dilation and
     the last-layer variant, f32 and bf16, per-row valid_t, skip_acc on;
     times of kernel, plain version and a library yardstick beside the
     bound, at d=1, d=128 and the last layer.
  4. slice: the full-width 12-flow x 256-channel model from random weights
     (seeded; the zero-initialised end convs randomised) saved and loaded as
     an npz checkpoint, served through Synthesizer.infer_serving and
     infer_serving_many in f32 and bf16 (two of the requests share a bucket,
     so one micro-batch has two rows of different true length); kernel
     launch counts, batched rows against solo calls, waveform against the
     plain path, bucket exactness, bf16 against f32, latency and
     throughput.
  5. trainable layer: wn_layer_trainable (the kernel forward; the bf16
     backward kernels, or the f32 torch-ops backward) at C=256, B=12,
     T=2,000 groups (the training segment), every dilation and the last
     layer, f32 and bf16: its forward (the kernel) against wn_layer_plain,
     its six gradients against autograd through wn_layer_plain, and in
     bf16 the backward kernels against wn_layer_backward at the same
     rounding points and against their own second launch bit for bit;
     times of the forward, the backward (and each of its five kernels,
     torch.profiler), the plain backward, plain autograd, the library and
     the library's backward alone, beside the bound.
  6. train: train() at full width (12 x 8 x 256, batch 12, segment 16,000)
     on wav files cut from tests/fixtures/audio.wav, in f32 and bf16: six
     steps with saves at steps 1, 3 and 6, every batch read through the
     native C++ loader (waveglow_tpu_torch/native/wavloader.cpp, built
     with g++; native.BATCHES equals the batches the run read), launch
     counts (each step's forward and its remat recompute; one
     backward-kernel call per layer a bf16 step, none in f32), resume from
     the step-3 checkpoint against the straight run; the loader's batches
     at epochs 0 and 1 bit for bit the Python decoder's, and one batch of
     12 crops decoded both ways over 100 PCM16 files of 1.5-10 s (host
     ms, median of 10); the model's bias capture from a normal mel (96
     launches a capture, a finite f32 bias unlike the zeros mel's, within
     phase 4's bound of wn_layer_plain's);
     one step's loss and each leaf's gradient (norm-wise) through the
     kernel against the plain route (and two wrong routes, which the grad
     bound and the loss bound must each flag: the plain route in the
     other dtype, and the kernel with the last rows of every sequence left
     at zero), the loss falling over 5 steps on one repeated batch, step
     time, audio-seconds per second, peak memory and a profiler breakdown
     of one step.
  7. stream: Synthesizer.stream at full width in f32 and bf16, the
     826-frame request in 256-frame chunks (4 windows) and the 200-frame
     request (one padded, masked window), raw and denoised: 96 kernel
     launches a window; the reassembled streams against one-call
     Synthesizer.infer with the same seed (raw, and denoised against
     wav_denoised); pcm16 pieces against the host conversion; peak memory
     of a streamed 3,304-frame mel against the streamed 826-frame one (and
     the one-call 3,304-frame peak); first-audio latency, raw and
     denoised, at chunks 256 and 128; per-window device time and streamed
     against one-call audio-s/s.
  8. serve: the HTTP daemon at full width in f32 and bf16,
     SynthesisService(max_batch=8, bucket_frames=64) behind make_server on
     127.0.0.1, driven only through SynthesisClient: /healthz and /stats;
     the four requests solo (npy) against Synthesizer.infer_serving bit for
     bit; a burst of 16 concurrent requests (4 each of 200, 230, 517 and
     826 frames, distinct seeds, arriving while the device lock is held)
     against their solo calls at phase 4's bound, with micro-batches
     formed; /stream raw and denoised against Synthesizer.stream at phase
     7's bounds; 413 for a mel over max_frames; one 503 from two concurrent
     requests at max_queue=1, then service again; /reload of other weights
     changes the output and serving goes on; 96 kernel launches a dispatch
     or a stream window; a closed loop of 1, 4 and 8 clients, 6 requests
     of 826 frames each (p50 and p99 from /stats, audio-s/s, rows a
     dispatch, the stage decomposition, peak memory; the 8-client loop
     once more under torch.profiler for the device's idle share); and the
     C9 check: a solo 200-frame request dispatched, then an 8-row batch of
     826-frame requests dispatched from another thread, and the solo one
     finalized before the batch's event completes and within 1.5x of its
     solo time (the median of 7 rounds against the median of 7 solo calls,
     each made just before its round).
  9. cli: the command line at full width in f32 and bf16. The reference
     `.pt` (export_torch_checkpoint) and NVIDIA's raw form (legacy
     weight_g/weight_v names in the "model" slot) are written with torch;
     `download` fetches the raw form from a server on 127.0.0.1 and
     converts it, bit for bit the params, 12 x 8 x 256 derived from its
     shapes; `synthesize` of phase 4's four requests from the .pt and from
     the npz, --batch 1 and 4, every file bit for bit normalize_wav + int16
     of Synthesizer.infer (infer_serving_many for --batch 4) in this
     process, the .pt's files equal the npz's, WN launches at the count the
     dispatch rule gives; `synthesize-wav` of two cuts of the speech
     fixture against MelSTFT.get_mel_from_file + infer; `serve` as a
     subprocess (`python -m waveglow_tpu_torch serve <pt>`): /healthz, one
     body against this process's infer_serving, /reload of the .pt
     refused and of the npz taken, SIGTERM drains and it exits 0 within
     30 s.
 10. cli train and validate: the training and validation commands at full
     width in f32 and bf16. `train` of phase 6's 24 cuts (batch 12, a
     checkpoint every step: steps and checkpoints 1 and 2) with
     --profile-dir, whose trace must name the WN kernel; the same command
     again refused (exit 1, the checkpoints untouched); `continue-train` to
     epoch 2 (steps 3 and 4, four train_step events in the metrics file);
     checkpoint 4 bit for bit a train(max_iterations=4) of the same
     settings in this process; `validate --full-run` of the newest
     checkpoint and `--select 2` over all of them on the whole fixture
     (826 frames), its first half and two cuts: the iteration folders
     filter_checkpoints gives, every inferred_denoised.wav bit for bit
     normalize_wav + int16 of Synthesizer.infer in this process, every
     total.csv row equal to the metric functions on the saved mels;
     `synthesize --include-stats` of phase 9's mels, its wavs bit for bit
     phase 9's and a stats.csv row a file; forward, backward and WN
     launches at the counts the code gives; the wall of each command and
     validate's split on the 826-frame entry (synthesis, mel, MCD with DTW
     and without, cosine, renders, SSIM, file writes).
 11. mesh: sharded serving on logical meshes that list cuda:0 once a
     shard, in f32 and bf16 at full width (the shards run one after
     another: the numbers are checked, no speedup is shown). The shard
     kernel (csrc/wn_layer_shard.cu: FFMA in f32, the tensor cores in
     bf16) against wn_layer_shard_plain at C' = 128, 64 and 32, d=1,
     d=128 and the last layer, and the ranks'
     partials summed against the unsharded kernel, timed at d=1 beside its
     bound, plain version and library yardstick; BatchSynthesizer on data
     = 2 and 4 (8 x 826 frames: each device's rows bit for bit an
     unsharded call on them, the batch within the slice bound of the
     8-row call; infer_many of 7 lengths padded and trimmed); infer_long
     on time = 2 and 4 at 3,304 and 3,301 frames, bit for bit the
     unsharded call, 96 WN launches a span; Synthesizer on model = 2, 4
     and (data 2, model 2): phase 4's 826-frame request and a 4-row
     micro-batch within the slice bound of the unsharded Synthesizer, 96 x
     model shard launches a dispatch and no WN-kernel launch, stream() on
     model = 2; the daemon on a (2, 2) mesh (/healthz, phase 8's solo
     bodies bit for bit the in-process mesh Synthesizer's, /reload
     re-shards) and on time = 2 (a 3,304-frame body bit for bit the
     unsharded call); each path's wall, device busy and host enqueue, and
     the reduce's device time in a model = 2 dispatch. Then `serve
     --mesh-data <cards + 1>` as a process must exit nonzero naming the
     cards it needs.
 12. widths: every built width beside 256 (128, and 512, the WaveGlow
     paper's). At each: the forward kernels (f32, bf16) and every shard
     pair against their plain versions at d=1, d=128 and the last layer
     (B=1, T=26,432), the bf16 backward against wn_layer_backward (B=12,
     T=2,000), bf16 kernels against their second launch bit for bit, each
     timed beside its bound, plain and library times (with each kernel's
     device time at d=1, d=128 and the last layer, and at C = 512 each bf16
     rank's round / gate / rs split, torch.profiler); a
     full-depth model (12 x
     8, random weights from the seed, ends randomised) served through
     Synthesizer.infer_serving in f32 and bf16 (96 launches; phase 4's
     826-frame request against the plain path at phase 4's bounds; wall,
     device busy, peak memory), on a model = 2 logical mesh (192 shard
     launches, against unsharded at phase 11's bounds), and one train()
     step a mode (192 WN launches with remat, 96 backward-kernel calls in
     bf16) with one step's gradients against the plain route at phase 5's
     bounds.
 13. mesh training: (a) the bf16 shard backward kernels
     (csrc/wn_layer_bwd.cu) against wn_layer_shard_backward at
     every (C, C') pair, B=12, T=2,000, d=1 and the last layer, every
     rank, the ranks' outputs summed and concatenated against the full
     layer's backward kernels, two launches bit for bit, timed at d=1
     beside the bound, the plain version and the library's (cuBLAS bf16
     products and torch elementwise), with each kernel's device time
     (torch.profiler over 10 calls), and the f32 route (torch ops)
     against autograd; (b) train() at full width (12 x 8 x 256, batch
     12, segment 16,000) on logical meshes of cuda:0, (data, model) =
     (1, 2), (2, 1) and (2, 2), in f32 and bf16: one step's loss and
     every leaf's gradient against the unsharded step at phase 6's
     bounds, launches at the code's counts (96 x model shard launches a
     forward, 96 x model shard-backward calls a bf16 step, no full-layer
     launch on a model > 1 mesh), three steps with saves at 1 and 2, the
     resume from 2 bit for bit the straight run, the checkpoint resumed
     unsharded at the mesh's step-3 loss, the step's wall, device busy,
     idle share and peak memory; one step at C = 512 on model = 2
     against the unsharded step; (c) the train command as two processes
     on the card over gloo (--num-processes 2 --process-id r
     --coordinator-address 127.0.0.1:<port>, global batch 12, 6 rows a
     process, two steps): equal losses and states on both ranks, process
     0's first checkpoint against one process at phase 6's bounds, the
     cross-process reduce's ms.
 14. a `kernels` JSON line, the card's name and power limit, and last the
     `{"ok": true, ...}` line.

Imports nothing of jax and nothing of the JAX package. Details go to
``<out>/chip_smoke.json`` (default ``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import csv
import dataclasses
import functools
import http.server
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from scipy.io import wavfile

from waveglow_tpu_torch import native
from waveglow_tpu_torch.checkpointing import download, load_checkpoint_any
from waveglow_tpu_torch.checkpointing.export_torch import (
    export_torch_checkpoint, params_to_state_dict)
from waveglow_tpu_torch.checkpointing.from_jax import (
    trainable_params_from_numpy, tree_leaves)
from waveglow_tpu_torch.checkpointing.import_torch import \
    derive_hparams_from_state_dict
from waveglow_tpu_torch.checkpointing.store import (
    CheckpointWaveglow, filter_checkpoints, flatten_tree,
    get_all_checkpoint_iterations)
from waveglow_tpu_torch.cli import main as cli_main
from waveglow_tpu_torch.cli.synthesis_cmd import InferenceEntry
from waveglow_tpu_torch.dsp.audio_io import (convert_wav, float_to_wav,
                                             normalize_wav)
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.eval import metrics as eval_metrics
from waveglow_tpu_torch.eval.plots import (make_same_width_by_filling_white,
                                           plot_melspec_np, save_image,
                                           stack_images_vertically)
from waveglow_tpu_torch.hparams import (HParams, overwrite_custom_hparams,
                                        parse_custom_hparams)
from waveglow_tpu_torch.inference.client import SynthesisClient
from waveglow_tpu_torch.inference.denoiser import (BIAS_MEL_LENGTH, Denoiser,
                                                   capture_bias)
from waveglow_tpu_torch.inference.server import SynthesisService, make_server
from waveglow_tpu_torch.inference.serving import BatchSynthesizer
from waveglow_tpu_torch.inference.streaming import receptive_halo_frames
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models.waveglow import (UPSAMPLE_STRIDE,
                                                WaveGlowConfig,
                                                fuse_for_inference, infer,
                                                infer_noise_shapes,
                                                init_params, params_to_torch)
from waveglow_tpu_torch.ops.conv import shift_time
from waveglow_tpu_torch.parallel.mesh import make_mesh, make_time_mesh
from waveglow_tpu_torch.parallel.sharding import (distinct_leaves,
                                                  gather_tree,
                                                  shard_trainable_params)
from waveglow_tpu_torch.parallel.time_shard import span_windows
from waveglow_tpu_torch.training import step as train_lib
from waveglow_tpu_torch.training.data import SegmentDataset, load_dataset
from waveglow_tpu_torch.training.loop import train

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 on
# the CUDA cores, bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}

C = 256
T_KERNEL = 26_432          # 826 mel frames x 32 groups per frame
N_LAYERS = 8
FRAMES = (200, 230, 517, 826)  # the slice's requests; 200 and 230 share
BUCKET = 64                    # the 256-frame bucket
# Tolerances, stated before the run. Kernel vs plain: f32 sums the K=768
# conv product in another order; in bf16 an f32 ulp of difference can flip
# the bf16 rounding of an act, so the bound scales with the output.
KERNEL_TOL_F32 = 1e-4
KERNEL_TOL_BF16_REL = 2e-2
# Full model, kernel path vs plain path (same weights and noise), relative
# to max|wav|: 12 flows of exp(-log_s) couplings amplify per-layer
# differences.
SLICE_TOL_REL = {"f32": 1e-3, "bf16": 5e-2}

# Training: batch 12 as in the train_config of NVIDIA's published WaveGlow
# config.json, HParams' segment of 16,000 samples (2,000 groups), 24 files
# so an epoch is 2 batches, saves every 3 steps and none at epoch ends.
ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "audio.wav"
B_TRAIN = 12
T_TRAIN = 2_000
N_WAVS = 24
TRAIN_STEPS = 6
RESUME_FROM = 3
# phase 6's host timing of the native loader against the Python decoder:
# LOADER_WAVS PCM16 mono files of 1.5-10 s (LJSpeech's range of lengths),
# one batch of B_TRAIN crops a rep, LOADER_REPS reps
LOADER_WAVS = 100
LOADER_SECONDS = (1.5, 10.0)
LOADER_REPS = 10
TRAIN_HPARAMS = {"batch_size": str(B_TRAIN), "iters_per_checkpoint": "3",
                 "epochs_per_checkpoint": "0"}
# Tolerances of the training phases, stated before the run.
# Trainable layer: its forward against the plain layer at the bounds of
# KERNEL_TOL_F32 / KERNEL_TOL_BF16_REL; each gradient against autograd
# through the plain layer, relative to that gradient's max |value|. The backward never reads the
# kernel's outputs, so f32 differs only by sums in other orders; in bf16 the
# plain layer differentiates through its own rounding points (bf16 acts),
# where the backward rounds drs, acts and dgates where they enter a product
# (2^-8 relative each).
GRAD_TOL_REL = {"f32": 1e-4, "bf16": 2e-2}
# One full train step, kernel route against plain route on the same params
# and batch: the loss (absolute) and each leaf's gradient, norm-wise
# (||grad - ref||_2 / ||ref||_2, the worst leaf; ``leaf_norm_rel_errors``).
# Each wrong route of WRONG_ROUTES must fall outside the grad bound alone,
# and outside the loss bound, in every run. Readings on an H100 (NVIDIA
# H100 80GB HBM3, 700 W): loss, the kernel route 3.7e-9 (f32) and 1.4e-7
# (bf16), the wrong routes 5.8e-5 or more; grads, the kernel route 4.3e-7
# (f32) and 1.31e-3 (bf16, a [256] bias leaf), the wrong routes 4.2e-3
# (f32 rows_off) to 5.4e-3. The max-elementwise-over-max-|ref| metric this
# one replaced read 6.3e-3 for the bf16 kernel route, above the wrong
# routes' norm-wise readings; a bf16 bound of 1e-2 passed both wrong
# routes, 3e-3 sits between.
STEP_LOSS_TOL = {"f32": 1e-7, "bf16": 1e-5}
STEP_GRAD_TOL_REL = {"f32": 1e-5, "bf16": 3e-3}
# Wrong routes for that check: the plain route in the other compute dtype,
# and the kernel leaving the last ROWS_OFF rows of every sequence at zero
# in every layer.
WRONG_ROUTES = ("other_dtype", "rows_off")
ROWS_OFF = 8
# Resumed run against the straight run, loss at step 6: the same program on
# the same exactly stored state and batches, so equal is expected.
RESUME_LOSS_TOL = 1e-5

# Streaming (phase 7): the 826-frame request in 256-frame chunks (4 windows
# of 456 frames: 256 + 2 x the 100-frame halo) and the 200-frame request
# (one window, padded and masked); a 3,304-frame mel (4 x 826, 13
# windows) for the memory check; first-audio latency at chunks 256 and
# 128 (bench.py's default), median of LATENCY_REPS.
STREAM_FRAMES = (826, 200)
STREAM_CHUNK = 256
LATENCY_CHUNKS = (256, 128)
LATENCY_REPS = 5
LONG_FRAMES = 4 * 826
STREAM_STRENGTH = 0.0005
# Streamed against one-call synthesis with the same seed, raw and denoised,
# relative to max|wav|, in both modes. The noise is the same at every
# position and every window masks as the one call does; the WN kernels sum
# each output in a fixed order. Readings at full width (NVIDIA H100 80GB
# HBM3, 700 W): raw 0.0 (the same bits) in f32 and bf16; denoised at most
# 6.2e-6 absolute at max|wav| about 7.4 (8.4e-7 relative), from the STFT
# matmuls over other frame counts. A window a frame off shows far above
# these bounds.
STREAM_TOL_REL = {"raw": 1e-6, "denoised": 1e-5}
# Activation peak (max_memory_allocated less the memory allocated just
# before the call: the weights, the denoiser, the mels) of the streamed
# 3,304-frame mel over the streamed 826-frame request's: the windows are
# the same size, so the same peak; whatever a window leaves behind adds up.
STREAM_MEMORY_RATIO = 1.1

# Serving daemon (phase 8). Micro-batches of up to 8 rows in 64-frame
# buckets; the burst is SERVE_BURST requests of each of FRAMES; the closed
# loop is SERVE_CLIENTS clients each sending SERVE_REQUESTS requests of
# 826 frames one after another. Its streams use the daemon's default chunk
# (128 frames: 328-frame windows). Every HTTP call and wait carries
# SERVE_TIMEOUT_S.
SERVE_MAX_BATCH = 8
SERVE_BURST = 4
SERVE_CLIENTS = (1, 4, 8)
SERVE_REQUESTS = 6
SERVE_STREAM_CHUNK = 128
SERVE_TIMEOUT_S = 120
# C9: a solo request's dispatch-to-result time, with an 8-row batch of
# 826-frame requests dispatched behind it from another thread (median of
# C9_ROUNDS rounds after a warm-up one), within this factor of its solo
# time (median of C9_ROUNDS solo calls, each made just before its round, so
# both medians see the same stretch of the host's clock: a bf16 solo
# request is the host's enqueue, whose pace drifts between stretches of a
# run); the batch's event still pending when the solo result is in, in
# every round.
C9_FRAMES = 200
C9_RATIO = 1.5
C9_ROUNDS = 7

# The CLI (phase 9): synthesize's --batch, and the (start, length) in samples
# of the two cuts of the speech fixture that synthesize-wav reads.
CLI_BATCH = 4
CLI_WAV_CUTS = ((22_050, 30_000), (120_000, 41_000))

# The training and validation commands (phase 10): `train` takes epoch 1
# of phase 6's 24 cuts at batch 12 (2 steps), `continue-train` epoch 2 (2
# more), a checkpoint every step; `validate` scores the whole speech
# fixture, its first half and phase 9's two cuts, on the newest checkpoint
# and then on every CLI_SELECT-th one
CLI_TRAIN_HPARAMS = (f"epochs={{epochs}},batch_size={B_TRAIN},"
                     "iters_per_checkpoint=1,epochs_per_checkpoint=0")
CLI_SELECT = 2
# Sharded serving on logical meshes of the one card (phase 11): a batch of
# MESH_BATCH rows of phase 4's longest request length, infer_many of
# MESH_MANY lengths on data = 4, infer_long of MESH_LONG frames (4 x 826,
# and 3 fewer, which no time size divides), a micro-batch of MESH_MICRO.
MESH_BATCH = 8
MESH_MANY = (826, 517, 230, 200, 826, 517, 300)
MESH_LONG = (LONG_FRAMES, LONG_FRAMES - 3)
MESH_MICRO = (826, 800, 780, 826)
MODES = {"f32": None, "bf16": torch.bfloat16}
DEVICE = "cuda"

# Phase 3 times these dilations (the narrowest and the widest halo) and the
# last layer, whose dilation is the widest.
TIMED_DILATIONS = (1, 128)
LAST_DILATION = 2 ** (N_LAYERS - 1)
# What each mode's kernel is.
DESIGN = {"f32": "f32 FFMA on the CUDA cores: one wave of 384-thread blocks, "
                 "each walking an equal share of the B*T rows in 48-row "
                 "tiles; 8 rows x (4 tanh + 4 sigmoid) channels a thread; "
                 "16-row K chunks through a 4-stage cp.async ring",
          "bf16": "wgmma m64n128k16 bf16 from swizzled shared memory, f32 "
                  "accumulators, 64-row tile, 4-stage cp.async weight ring"}
BACKWARD_DESIGN = (
    "5 launches, wgmma m64nNk16 bf16 from 128-byte-swizzled shared memory "
    "(the shard backward's design at C' = C): prep (x rounded to bf16 once, "
    "drs built, rounded and its per-tile column sums), rows (a block per "
    "batch row, 128-row tile and pass of 64 channels: the gate recompute "
    "and dacts on accumulators of the same (row, channel), the bf16 x taps "
    "and drs by cp.async beside the weights in a 4-stage ring), dx (128 "
    "rows x min(C, 256) channels, K = 6C, dx_next masked added), weights "
    "(dw_in and dw_rs^T tiles of 128 x 256 at most, a row split that fills "
    "the card's waves), reduce (fixed order, no atomics)")
SHARD_DESIGN = {
    "f32": "FFMA: one wave of 384-thread (C' >= 128) or 512-thread blocks, "
           "each walking an equal share of the B*T rows in tiles (48 rows at "
           "C' = 256 to 512 at C' = 16); both products as one sequence of "
           "16-row K chunks (taps and w_in_s, then w_rs_s) through a 4-stage "
           "cp.async ring; 8 rows (4 at C' <= 64) x (4 tanh + 4 sigmoid) "
           "channels a thread, the gate on the accumulators, acts in shared "
           "memory, the partial in passes of 2C' columns written from the "
           "accumulators",
    "bf16": "(C <= 256) mma.sync m16n8k16 bf16 (ldmatrix from padded "
            "shared memory, f32 accumulators): 256-thread blocks of 64 time "
            "rows, both products as one sequence of K chunks through a "
            "4-stage ring (w_in and "
            "w_rs by cp.async, x taps by registers rounded to bf16), the gate "
            "on the paired tanh/sigmoid accumulators, the partial written "
            "from the accumulators in 16-byte stores"}
# Shapes at which phase 2 reports the f32 kernel's grid: phase 3's two batch
# sizes and the training segment.
F32_GRID_SHAPES = ((1, T_KERNEL), (8, T_KERNEL), (B_TRAIN, T_TRAIN))
# The f32 shard kernel's times before its redesign (a full run of this
# script with the simple FFMA kernel on an NVIDIA H100 80GB HBM3, 700.00 W;
# B=1, T=26,432, d=1, ms; PERF.md keeps the run), by (C, C'): printed
# beside this run's times as a read-out, never a limit.
SHARD_F32_EARLIER_MS = {(256, 128): 0.6284, (256, 64): 0.4664,
                        (256, 32): 0.3597, (512, 256): 2.9262,
                        (512, 128): 1.8521, (512, 64): 1.2882,
                        (128, 64): 0.1776, (128, 32): 0.1136,
                        (128, 16): 0.0902}
# The route of each mode's trainable backward.
BACKWARD_ROUTE = {"f32": "torch ops", "bf16": "cuda"}


def log(msg: str) -> None:
  print(msg, flush=True)


def fail(msg: str) -> None:
  raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
  """Mean device milliseconds per call, by CUDA events over ``reps``."""
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


# -- phase 1 ---------------------------------------------------------------

def phase_device() -> dict:
  if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is False: a CUDA card is required")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  info = {"name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "nvidia_smi": nvidia_smi_line(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
  log("device " + json.dumps(info))
  return info


# -- phase 2 ---------------------------------------------------------------

def variant(mode: str, last: bool, width: int = C) -> str:
  return f"{mode},C={width},{'last' if last else 'layer'}"


# Every forward kernel variant, (mode, last, width) as variant takes them.
FORWARD_KERNELS = tuple((mode, last, width) for width in kl.kernel_widths()
                        for mode in MODES for last in (False, True))

# The whole layer's bf16 backward kernels, (name, last, width) as
# kl.bwd_kernel_info takes them: the rows and prep kernels have a
# last-layer variant.
BWD_KERNELS = tuple((k, last, width)
                    for width in kl.kernel_widths()
                    for k in kl.BWD_KERNELS
                    for last in ((False, True) if k in ("rows", "prep")
                                 else (False,)))


def bwd_variant(kernel: str, last: bool = False, width: int = C) -> str:
  """Variant name of a backward kernel. Those that do products start with
  "bf16" (check_tensor_cores demands HMMA/HGMMA of them); the reduce and
  prep kernels do none and start with their names."""
  if kernel == "reduce":
    return f"reduce,C={width},bwd"
  if kernel == "prep":
    return f"prep,C={width},bwd,{'last' if last else 'layer'}"
  if kernel == "rows":
    return f"bf16,C={width},bwd-rows,{'last' if last else 'layer'}"
  return f"bf16,C={width},bwd-{kernel}"


# The bf16 forward at C = 512 beside its res/skip kernels (which
# variant("bf16", last, 512) names for the layer and shard_variant(512, C',
# True, last) for a rank): the gate kernel at each gate width (the layer's
# 512, a rank's C') and the rounding of x, (kernel, gate width) as
# kl.wide_kernel_info takes them.
WIDE_KERNELS = (("gate", kl.WIDE_C), ("round", kl.WIDE_C)) + tuple(
    ("gate", cp) for c, cp in kl.shard_pairs() if c == kl.WIDE_C)


def wide_variant(kernel: str, cp: int = kl.WIDE_C) -> str:
  """Variant name of a C = 512 gate kernel ("bf16,C=512,gate" for the
  layer's, "shard-bf16,C=512,C'=M,gate" for a rank's: held to HGMMA) or of
  the rounding of x, which does no products."""
  if kernel == "round":
    return f"round,C={kl.WIDE_C},fwd"
  if cp == kl.WIDE_C:
    return f"bf16,C={kl.WIDE_C},gate"
  return f"shard-bf16,C={kl.WIDE_C},C'={cp},gate"


def f32_rest_variant(last: bool) -> str:
  """Variant name of the f32 forward's rest kernel at C = 512 (its tiles
  kernel is variant("f32", last, 512)): held to no tensor cores and no
  spill as every f32 kernel."""
  return f"f32,C={kl.WIDE_C},rest,{'last' if last else 'layer'}"


def shard_variant(width: int, channels: int, bf16: bool, last: bool) -> str:
  """Variant name of a shard kernel (width ``C``, ``C'`` gate channels a
  rank): "shard-f32,..." or "shard-bf16,...". ``check_tensor_cores``
  holds the f32 ones to no tensor-core instruction and the bf16 ones to
  some; ``check_no_spills`` holds the f32 ones to no spill."""
  return (f"shard-{'bf16' if bf16 else 'f32'},C={width},C'={channels},"
          f"{'last' if last else 'layer'}")


SHARD_KERNELS = tuple((c, cp, bf16, last) for c, cp in kl.shard_pairs()
                      for bf16 in (False, True) for last in (False, True))

# The bf16 shard backward's kernels, (name, C, C', last) as
# kl.shard_bwd_kernel_info takes them (the rows kernel has a last variant).
SHARD_BWD_KERNELS = tuple(
    (k, c, cp, last) for c, cp in kl.shard_pairs()
    for k in kl.SHARD_BWD_KERNELS
    for last in ((False, True) if k == "rows" else (False,)))


def shard_bwd_variant(kernel: str, width: int, channels: int,
                      last: bool = False) -> str:
  """Variant name of a shard-backward kernel: "bf16,C=N,C'=M,sbwd-..." for
  those that do products (check_tensor_cores demands HMMA/HGMMA of them),
  "reduce,C=N,C'=M,sbwd" for the reduce kernel, which does none."""
  pair = f"C={width},C'={channels}"
  if kernel == "reduce":
    return f"reduce,{pair},sbwd"
  if kernel == "rows":
    return f"bf16,{pair},sbwd-rows,{'last' if last else 'layer'}"
  return f"bf16,{pair},sbwd-{kernel}"


def kernel_variant(mangled: str) -> str:
  """The variant a kernel's mangled symbol instantiates: the f32 kernel
  ``wn_layer_kernel_f32<kC, kLast>`` (C <= 256) or, at C = 512,
  ``wn_layer_kernel_f32_{tiles,rest}<kLast>``, the bf16 tensor-core kernel
  ``wn_layer_kernel_mma<kC, kLast>`` (C <= 256), the C = 512 bf16 kernels
  ``wn_layer_kernel_{gate<kG>,rs<kG, kLast>,round}`` (kG = 512: the
  layer's; kG = C': a rank's, named as its shard kernel), a backward kernel
  ``wn_bwd_{prep<kC, kLast>,rows<kC, kLast>,dx,weights,reduce<kC>}_kernel``, a
  shard kernel ``wn_shard_kernel[_mma]<kC, kCP, kLast>`` (FFMA in f32, the
  tensor cores in bf16) or a shard-backward kernel
  ``wn_sbwd_{rows<kC, kCP, kLast>,dx,weights,reduce<kC, kCP>}_kernel``;
  other symbols are returned as they are."""
  inst = re.search(r"wn_layer_kernel_(f32|mma)ILi(\d+)ELb([01])E", mangled)
  if inst:
    return variant("f32" if inst.group(1) == "f32" else "bf16",
                   inst.group(3) == "1", int(inst.group(2)))
  inst = re.search(r"wn_layer_kernel_f32_(tiles|rest)ILb([01])E", mangled)
  if inst:
    last = inst.group(2) == "1"
    return (variant("f32", last, kl.WIDE_C) if inst.group(1) == "tiles"
            else f32_rest_variant(last))
  inst = re.search(r"wn_layer_kernel_rsILi(\d+)ELb([01])E", mangled)
  if inst:
    gates, last = int(inst.group(1)), inst.group(2) == "1"
    return (variant("bf16", last, kl.WIDE_C) if gates == kl.WIDE_C
            else shard_variant(kl.WIDE_C, gates, True, last))
  inst = re.search(r"wn_layer_kernel_gateILi(\d+)E", mangled)
  if inst:
    return wide_variant("gate", int(inst.group(1)))
  if re.search(r"wn_layer_kernel_round", mangled):
    return wide_variant("round")
  inst = re.search(r"wn_bwd_(prep|rows|dx|weights|reduce)_kernelILi(\d+)E"
                   r"(?:Lb([01])E)?", mangled)
  if inst:
    return bwd_variant(inst.group(1), inst.group(3) == "1",
                       int(inst.group(2)))
  inst = re.search(r"wn_sbwd_(rows|dx|weights|reduce)_kernelILi(\d+)ELi(\d+)E"
                   r"(?:Lb([01])E)?", mangled)
  if inst:
    return shard_bwd_variant(inst.group(1), int(inst.group(2)),
                             int(inst.group(3)), inst.group(4) == "1")
  inst = re.search(r"wn_shard_kernel(_mma)?ILi(\d+)ELi(\d+)ELb([01])E",
                   mangled)
  if inst:
    return shard_variant(int(inst.group(2)), int(inst.group(3)),
                         inst.group(1) is not None, inst.group(4) == "1")
  return mangled


def parse_ptxas(build_log: str) -> dict:
  """ptxas facts per kernel variant: registers, spills, static smem."""
  facts = {}
  name = None
  for line in build_log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      name = kernel_variant(m.group(1))
      facts[name] = {}
      continue
    if name is None:
      continue
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if m:
      facts[name]["spill_store_bytes"] = int(m.group(1))
      facts[name]["spill_load_bytes"] = int(m.group(2))
    m = re.search(r"Used (\d+) registers", line)
    if m:
      facts[name]["registers"] = int(m.group(1))
      m2 = re.search(r"(\d+) bytes smem", line)
      facts[name]["static_smem_bytes"] = int(m2.group(1)) if m2 else 0
  return facts


def find_cuobjdump() -> Path:
  """cuobjdump beside nvcc, else the copy Triton's package carries."""
  candidates = [Path(kl._nvcc()).resolve().parent / "cuobjdump"]
  try:
    import triton
    candidates.append(Path(triton.__file__).parent / "backends" / "nvidia"
                      / "bin" / "cuobjdump")
  except ImportError:
    pass
  for path in candidates:
    if path.is_file():
      return path
  fail(f"cuobjdump not found (looked at {[str(p) for p in candidates]}): "
       "the tensor-core check of the bf16 kernels cannot run")


def count_mma(sass: str, opcode: str = r"\bH(G)?MMA\.") -> dict:
  """Tensor-core instructions (HMMA and HGMMA; with ``opcode``
  r"\\bHGMMA\\.", wgmma alone) per kernel variant in the output of
  ``cuobjdump -sass``."""
  counts, name = {}, None
  for line in sass.splitlines():
    m = re.search(r"Function : (\S+)", line)
    if m:
      name = kernel_variant(m.group(1))
      counts[name] = 0
    elif name is not None and re.search(opcode, line):
      counts[name] += 1
  return counts


def wgmma_serialized(build_log: str) -> set:
  """Kernel variants whose wgmmas ptxas reports serialized (its C7511 and
  C7513 warnings; the kernel runs, but no faster than mma.sync). The
  function is the one the warning names, else the one ptxas was
  compiling."""
  found, name = set(), None
  for line in build_log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      name = kernel_variant(m.group(1))
    if re.search(r"C751[13]", line):
      named = re.search(r"'(_Z\w+)'", line)
      found.add(kernel_variant(named.group(1)) if named else name)
  return found


def held_to_wgmma(name: str) -> bool:
  """A product kernel of the bf16 backwards (rows, dx, weights; the whole
  layer's and a rank's) or of the bf16 forward at C = 512 (gate, res/skip;
  the layer's and a rank's): held to wgmma, to no serialization and to no
  spill."""
  return (name.startswith("bf16,") and (
      ",bwd-" in name or ",sbwd-" in name
      or name.startswith(f"bf16,C={kl.WIDE_C},") and ",bwd" not in name)
      or name.startswith(f"shard-bf16,C={kl.WIDE_C},"))


def check_wgmma(hgmma: dict, serialized, variants) -> None:
  """Fail unless every kernel ``held_to_wgmma`` has HGMMA and ptxas
  serialized none of its wgmmas."""
  for name in variants:
    if not held_to_wgmma(name):
      continue
    if hgmma.get(name, 0) == 0:
      fail(f"the {name} kernel has no wgmma (HGMMA) instruction")
    if name in serialized:
      fail(f"ptxas serialized the wgmmas of the {name} kernel (C7511/C7513)")


def check_tensor_cores(mma: dict, variants) -> None:
  """Fail unless every bf16 variant (each kernel that does bf16 products)
  runs on the tensor cores and no f32 variant does (parity mode must never
  slip into TF32); other variants (the reduce kernel) are not held to
  either."""
  for name in variants:
    if name not in mma:
      fail(f"no SASS found for the {name} kernel")
    if name.startswith(("bf16", "shard-bf16")) and mma[name] == 0:
      fail(f"the {name} kernel has no HMMA/HGMMA instruction")
    if name.startswith(("f32", "shard-f32")) and mma[name] != 0:
      fail(f"the {name} kernel has {mma[name]} tensor-core instructions")


def check_no_spills(ptxas, attributes) -> None:
  """Fail if an f32 kernel variant (the forward's or the shard's) or a
  kernel ``held_to_wgmma`` spills: local bytes in the loaded build, or
  spill stores or loads in ptxas's report (``ptxas`` is None when the
  library was built by an earlier process). The other bf16 variants are
  not held to it."""
  for name, attr in attributes.items():
    if not (name.startswith(("f32", "shard-f32")) or held_to_wgmma(name)):
      continue
    facts = (ptxas or {}).get(name, {})
    spills = (attr["local_bytes"], facts.get("spill_store_bytes", 0),
              facts.get("spill_load_bytes", 0))
    if any(spills):
      fail(f"the {name} kernel spills: {attr['local_bytes']} local bytes, "
           f"ptxas {facts}")


def f32_grid(attributes) -> dict:
  """The f32 kernel's registers, spills and shared memory (the loaded
  build), and at each of F32_GRID_SHAPES its grid: blocks an SM, blocks,
  waves, rows and tiles a block, and the rows of the busiest block against
  an equal share of B*T over the device's blocks (1.0: no tail)."""
  info = {"kernel": attributes[variant("f32", False)]}
  for batch, t in F32_GRID_SHAPES:
    for width in kl.kernel_widths():
      grid = kl.f32_schedule(batch, t, channels=width)
      slots = grid["sms"] * grid["blocks_per_sm"]
      grid["share_of_busiest"] = batch * t / slots / grid["rows_per_block"]
      key = f"B={batch},T={t}" + ("" if width == C else f",C={width}")
      info[key] = grid
  return info


def shard_f32_grid(attributes) -> dict:
  """Each f32 shard instance's registers, local bytes and dynamic shared
  bytes (the loaded build) and its grid at B=1, T=T_KERNEL: blocks an SM,
  tile rows, quantum, blocks, rows a block, waves."""
  info = {}
  for c, cp, bf16, last in SHARD_KERNELS:
    if bf16:
      continue
    name = shard_variant(c, cp, bf16, last)
    info[name] = {**attributes[name],
                  **kl.f32_schedule(1, T_KERNEL, last, channels=c, cp=cp)}
  return info


def phase_build() -> dict:
  start = time.perf_counter()
  lib = kl.build_library()
  kl._library()
  seconds = time.perf_counter() - start
  built = kl.BUILD_SECONDS is not None
  attributes = {variant(mode, last, width):
                kl.kernel_info(width, mode == "bf16", last)
                for mode, last, width in FORWARD_KERNELS}
  attributes.update({bwd_variant(k, last, width):
                     kl.bwd_kernel_info(k, last, width)
                     for k, last, width in BWD_KERNELS})
  attributes.update({shard_variant(*v): kl.shard_kernel_info(*v)
                     for v in SHARD_KERNELS})
  attributes.update({shard_bwd_variant(*v): kl.shard_bwd_kernel_info(*v)
                     for v in SHARD_BWD_KERNELS})
  attributes.update({wide_variant(k, cp): kl.wide_kernel_info(k, cp=cp)
                     for k, cp in WIDE_KERNELS})
  attributes.update({f32_rest_variant(last): kl.f32_rest_kernel_info(last)
                     for last in (False, True)})
  sass = subprocess.run([str(find_cuobjdump()), "-sass", str(lib)],
                        capture_output=True, text=True, check=False)
  if sass.returncode != 0:
    fail(f"cuobjdump -sass failed: {sass.stderr.strip()}")
  mma = count_mma(sass.stdout)
  hgmma = count_mma(sass.stdout, r"\bHGMMA\.")
  serialized = wgmma_serialized(kl.BUILD_LOG) if built else set()
  info = {"built_in_this_run": built,
          "build_s": kl.BUILD_SECONDS if built else "cached",
          "build_and_load_s": seconds,
          "ptxas": (parse_ptxas(kl.BUILD_LOG) if built
                    else "cached: built by an earlier process"),
          "attributes": attributes,
          "sass_tensor_core_instructions": mma,
          "sass_wgmma_instructions": hgmma,
          "wgmma_serialized": sorted(serialized),
          "f32_grid": f32_grid(attributes),
          "shard_f32_grid": shard_f32_grid(attributes)}
  log("build " + json.dumps(info))
  log("f32 kernel " + json.dumps(info["f32_grid"]))
  log("f32 shard kernel " + json.dumps(info["shard_f32_grid"]))
  log("wgmma kernels " + json.dumps(
      {name: {**attr, "hgmma": hgmma.get(name, 0),
              "ptxas": info["ptxas"].get(name) if built else "cached"}
       for name, attr in attributes.items()
       if held_to_wgmma(name) and ",sbwd-" not in name}))
  log("shard backward kernels " + json.dumps(
      {shard_bwd_variant(*v): {**attributes[shard_bwd_variant(*v)],
                               "hgmma": hgmma.get(shard_bwd_variant(*v), 0),
                               "ptxas": (info["ptxas"].get(
                                   shard_bwd_variant(*v)) if built
                                   else "cached")}
       for v in SHARD_BWD_KERNELS}))
  if built and set(info["ptxas"]) != set(attributes):
    fail(f"ptxas facts for {sorted(info['ptxas'])}, expected "
         f"{sorted(attributes)}")
  check_tensor_cores(mma, attributes)
  check_wgmma(hgmma, serialized, attributes)
  check_no_spills(info["ptxas"] if built else None, attributes)
  return info


# -- phase 3 ---------------------------------------------------------------

def layer_inputs(batch: int, t: int, last: bool, dtype, seed: int,
                 width: int = C):
  """Inputs at the scale the model feeds the layer (``width`` channels), on
  the card."""
  C = width
  g = torch.Generator(device="cuda").manual_seed(seed)

  def rand(*shape, scale):
    return torch.randn(*shape, generator=g, device="cuda") * scale

  rs = C if last else 2 * C
  valid = torch.tensor([t - 1000 * (i % 2) for i in range(batch)],
                       dtype=torch.int32, device="cuda")
  keep = torch.arange(t, device="cuda")[None, :, None] < valid[:, None, None]
  x = rand(batch, t, C, scale=0.5) * keep
  cond = rand(batch, t, 2, C, scale=0.5).to(dtype)
  w_in = rand(3, C, 2 * C, scale=(3 * C) ** -0.5).to(dtype)
  b_in = rand(2 * C, scale=0.1)
  w_rs = rand(C, rs, scale=C ** -0.5).to(dtype)
  b_rs = rand(rs, scale=0.1)
  acc = rand(batch, t, C, scale=1.0)
  return (x, cond, w_in, b_in, w_rs, b_rs), valid, acc


def layer_cost(batch: int, t: int, last: bool, mode: str, width: int):
  """(bytes, flops, bound_ms, bound_by) of one layer call at ``width``
  channels: every input read once, every output written once (and the bf16
  copy of x that the C = 512 bf16 layer makes, written and read once);
  flops of the two products."""
  C = width
  esize = 2 if mode == "bf16" else 4
  rs = C if last else 2 * C
  rows = batch * t
  nbytes = (rows * C * 4                       # x
            + rows * 2 * C * esize             # cond
            + (3 * C * 2 * C + C * rs) * esize  # w_in, w_rs
            + (2 * C + rs) * 4 + batch * 4     # biases, valid_t
            + rows * C * 4                     # skip_acc read
            + 2 * rows * C * 4)                # x' and skip written
  if mode == "bf16" and width == kl.WIDE_C:
    nbytes += 2 * rows * C * 2                 # bf16 x, written and read
  flops = 2 * rows * C * (3 * 2 * C + rs)
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[mode] * 1e3
  return nbytes, flops, max(t_bytes, t_ops), (
      "bytes" if t_bytes >= t_ops else "operations")


def library_layer(x, cond, w_in, b_in, w_rs, b_rs, dilation, dtype):
  """Yardstick the port never calls: cuDNN conv1d for the taps and a cuBLAS
  matmul for the res/skip (the layer's two products), with the gate between
  them. Inputs are given channels-first where conv1d wants them."""
  x_cf, w_conv = x, w_in
  pre = F.conv1d(x_cf, w_conv, b_in, padding=dilation, dilation=dilation)
  c = w_conv.shape[0] // 2   # the gate channels (C' for a rank's shard)
  gates = pre.transpose(1, 2) + cond
  acts = torch.tanh(gates[..., :c]) * torch.sigmoid(gates[..., c:])
  return torch.matmul(acts.to(dtype), w_rs)


def forward_kernels(mode: str, batch: int, width: int) -> int:
  """Kernels one forward call launches at B = ``batch``, T = T_KERNEL: at
  C = 512 in bf16 three (round, gate, res/skip), in f32 the tiles kernel
  and, where a block has a rest of 48 rows or fewer, the rest kernel; else
  one."""
  if width != kl.WIDE_C:
    return 1
  if mode == "bf16":
    return 3
  grid = kl.f32_schedule(batch, T_KERNEL, channels=width)
  return 1 + kl.f32_rest_launched(batch, T_KERNEL,
                                  grid["sms"] * grid["blocks_per_sm"])


def kernel_case(mode: str, batch: int, i: int, seed: int, width: int = C,
                time_it: bool = False) -> dict:
  """Layer ``i`` of a flow (``i == N_LAYERS``: the last layer) at
  ``width`` channels, B = ``batch``, T = T_KERNEL: the kernel against its
  plain version (per-row valid_t, skip_acc on); with ``time_it``, the
  kernel's, the plain version's and the library's times beside the bound."""
  cdt = MODES[mode]
  dtype = cdt or torch.float32
  last = i == N_LAYERS
  dilation = 2 ** min(i, N_LAYERS - 1)
  args, valid, acc = layer_inputs(batch, T_KERNEL, last, dtype, seed + i,
                                  width)
  xk, sk = kl.wn_layer_fused(*args, dilation, valid_t=valid,
                             skip_acc=acc.clone(), compute_dtype=cdt)
  torch.cuda.synchronize()
  xp, sp = kl.wn_layer_plain(*args, dilation, valid_t=valid,
                             skip_acc=acc.clone(), compute_dtype=cdt)
  err = max((xk - xp).abs().max().item(), (sk - sp).abs().max().item())
  scale = max(xp.abs().max().item(), sp.abs().max().item())
  bound = (KERNEL_TOL_F32 if mode == "f32"
           else KERNEL_TOL_BF16_REL * scale)
  if not (torch.isfinite(xk).all() and torch.isfinite(sk).all()):
    fail(f"kernel output not finite ({mode}, C={width}, B={batch}, "
         f"d={dilation})")
  for row, v in enumerate(valid.tolist()):
    if v < T_KERNEL and xk[row, v:].abs().max().item() != 0:
      fail(f"kernel left rows >= valid_t nonzero ({mode}, C={width}, "
           f"B={batch})")
  rec = {"mode": mode, "C": width, "B": batch, "dilation": dilation,
         "last": last, "max_abs_err": err, "bound": bound,
         "ref_max_abs": scale}
  if err > bound:
    fail(f"kernel disagrees with plain: {rec}")
  if mode == "bf16":
    again = kl.wn_layer_fused(*args, dilation, valid_t=valid,
                              skip_acc=acc.clone(), compute_dtype=cdt)
    if not (torch.equal(again[0], xk) and torch.equal(again[1], sk)):
      fail(f"two launches of the kernel differ ({mode}, C={width}, "
           f"B={batch}, d={dilation})")
    del again
  del xk, sk, xp, sp
  if time_it:
    nbytes, flops, bound_ms, bound_by = layer_cost(batch, T_KERNEL, last,
                                                   mode, width)
    skip = acc.clone()
    rec["kernel_ms"] = cuda_ms(lambda: kl.wn_layer_fused(
        *args, dilation, valid_t=valid, skip_acc=skip, compute_dtype=cdt))
    rec["plain_ms"] = cuda_ms(lambda: kl.wn_layer_plain(
        *args, dilation, valid_t=valid, skip_acc=skip, compute_dtype=cdt))
    x, cond, w_in, b_in, w_rs, b_rs = args
    x_cf = x.to(dtype).transpose(1, 2).contiguous()
    w_conv = w_in.permute(2, 1, 0).contiguous()   # [2C, C, 3]
    cond_flat = cond.reshape(batch, T_KERNEL, 2 * width)
    b_lib = b_in.to(dtype)
    rec["library_ms"] = cuda_ms(lambda: library_layer(
        x_cf, cond_flat, w_conv, b_lib, w_rs, b_rs, dilation, dtype))
    rec.update(bytes=nbytes, flops=flops, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / rec["kernel_ms"])
    rec["kernels_ms"] = kernel_split(lambda: kl.wn_layer_fused(
        *args, dilation, valid_t=valid, skip_acc=skip, compute_dtype=cdt),
        FWD_SPLIT, forward_kernels(mode, batch, width))
  log("kernel " + json.dumps(rec))
  return rec


def phase_kernel(seed: int) -> dict:
  results = []
  timed = {}
  for mode in MODES:
    for batch in (1, 8):
      for i in range(N_LAYERS + 1):
        last = i == N_LAYERS
        dilation = 2 ** min(i, N_LAYERS - 1)
        rec = kernel_case(mode, batch, i, seed,
                          time_it=dilation in TIMED_DILATIONS or last)
        if "kernel_ms" in rec:
          timed[(mode, batch, last, dilation)] = rec
        results.append(rec)
  torch.cuda.empty_cache()
  return {"cases": results, "timed": timed}


# -- phase 4 ---------------------------------------------------------------

def width_hparams(width: int = C) -> HParams:
  """The model's hparams (12 flows x 8 layers) at ``width`` channels."""
  return dataclasses.replace(HParams(), n_channels=width)


def full_width_params(seed: int, width: int = C) -> dict:
  """12 x ``width`` model from the seed, every ``end`` randomised small (a
  zero end conv makes each coupling the identity and hides the kernel)."""
  params = init_params(WaveGlowConfig.from_hparams(width_hparams(width)),
                       seed=seed)
  rng = np.random.default_rng(seed + 1)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.02).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.02).astype(np.float32)
  return params


def full_width_checkpoint(seed: int, path: Path,
                          width: int = C) -> CheckpointWaveglow:
  CheckpointWaveglow.from_params(full_width_params(seed, width),
                                 width_hparams(width), iteration=1).save(path)
  return CheckpointWaveglow.load(path)


def phase_slice(ckpt: CheckpointWaveglow, mode: str, seed: int):
  """Serve the requests in ``mode``; returns the record and the first
  request's samples."""
  torch.cuda.reset_peak_memory_stats()
  synth = Synthesizer(ckpt, compute_dtype="bfloat16" if mode == "bf16"
                      else "float32", device="cuda")
  rng = np.random.default_rng(seed)
  mels = [rng.uniform(-11.0, 1.0, (80, f)).astype(np.float32) for f in FRAMES]
  seeds = [seed + i for i in range(len(mels))]
  synth.infer_serving(mels[0], seed=seeds[0], bucket_frames=BUCKET)  # warm-up

  # -- the main path, with the launch count read around it
  kl.LAUNCHES = 0
  solo, per_call = [], []
  for mel, s in zip(mels, seeds):
    before = kl.LAUNCHES
    solo.append(synth.infer_serving(mel, seed=s, bucket_frames=BUCKET))
    per_call.append(kl.LAUNCHES - before)
  before = kl.LAUNCHES
  # infer_serving_many is dispatch + finalize; both halves are called here
  # so the batches it formed can be read
  dispatched = synth.serving_many_dispatch(mels, seeds=seeds,
                                           bucket_frames=BUCKET)
  many = synth.serving_many_finalize(dispatched)
  many_launches = kl.LAUNCHES - before
  launches = kl.LAUNCHES
  batch_rows = [len(rows) for rows, _, _ in dispatched.batches]
  per_synthesis = synth.config.n_flows * synth.config.n_layers
  if per_call != [per_synthesis] * len(mels):
    fail(f"{mode}: launches per infer_serving {per_call}, expected "
         f"{per_synthesis} each")
  if max(batch_rows) < 2:
    fail(f"{mode}: infer_serving_many formed no batch of 2 rows or more: "
         f"{batch_rows}")
  if many_launches != per_synthesis * len(batch_rows):
    fail(f"{mode}: infer_serving_many launched {many_launches}, expected "
         f"{per_synthesis * len(batch_rows)} for batches {batch_rows}")
  for res, mel in zip(solo + many, mels + mels):
    if res.samples.shape != (mel.shape[-1] * UPSAMPLE_STRIDE,):
      fail(f"{mode}: output shape {res.samples.shape}")
    if not np.isfinite(res.samples).all():
      fail(f"{mode}: output not finite")
  many_vs_solo_rows = [float(np.abs(a.samples - b.samples).max())
                       for a, b in zip(solo, many)]
  many_vs_solo = max(many_vs_solo_rows)
  wav_scale = max(float(np.abs(r.samples).max()) for r in solo)
  if many_vs_solo > SLICE_TOL_REL[mode] * wav_scale:
    fail(f"{mode}: infer_serving_many rows differ from solo calls by "
         f"{many_vs_solo}")

  # -- kernel path vs plain path, same weights and injected noise
  mel, mel_seed = mels[-2], seeds[-2]   # 517 frames
  n_groups = mel.shape[-1] * UPSAMPLE_STRIDE // synth.config.n_group
  noise = [rng.standard_normal(s).astype(np.float32)
           for s in infer_noise_shapes(synth.config, 1, n_groups)]
  wav_k = synth.infer(mel, noise=noise, denoiser_strength=0.0).wav
  with torch.inference_mode():
    wav_p = infer(synth.params, synth.config,
                  torch.from_numpy(mel[None]).cuda(), noise=noise,
                  compute_dtype=synth._cdt,
                  layer=kl.wn_layer_plain)[0].cpu().numpy()
  plain_err = float(np.abs(wav_k - wav_p).max())
  plain_bound = SLICE_TOL_REL[mode] * float(np.abs(wav_p).max())
  if not np.isfinite(wav_k).all() or plain_err > plain_bound:
    fail(f"{mode}: kernel path vs plain path {plain_err} > {plain_bound}")

  # -- bucket exactness: kept samples of a padded call vs the unpadded call
  padded = synth.infer(mel, seed=mel_seed, bucket_frames=BUCKET,
                       denoiser_strength=0.0).wav
  unpadded = synth.infer(mel, seed=mel_seed, denoiser_strength=0.0).wav
  bucket_err = float(np.abs(padded - unpadded).max())
  bucket_bound = SLICE_TOL_REL[mode] * float(np.abs(unpadded).max())
  if bucket_err > bucket_bound:
    fail(f"{mode}: bucket-padded kept samples differ by {bucket_err}")

  # -- latency and throughput of infer_serving (host clock, synchronised)
  lat, audio_s = [], 0.0
  wall = time.perf_counter()
  for _ in range(3):
    for mel_i, s in zip(mels, seeds):
      t0 = time.perf_counter()
      synth.infer_serving(mel_i, seed=s, bucket_frames=BUCKET)
      lat.append(time.perf_counter() - t0)
      audio_s += mel_i.shape[-1] * UPSAMPLE_STRIDE / synth.hparams.sampling_rate
  wall = time.perf_counter() - wall
  t0 = time.perf_counter()
  synth.infer_serving_many(mels, seeds=seeds, bucket_frames=BUCKET)
  many_s = time.perf_counter() - t0
  info = {"mode": mode, "launches": launches,
          "profile_826_frames": profile_call(lambda: synth.infer_serving(
              mels[-1], seed=seeds[-1], bucket_frames=BUCKET)),
          "launches_per_synthesis": per_call,
          "many_launches": many_launches,
          "many_batch_rows": batch_rows,
          "many_vs_solo_max_abs": many_vs_solo_rows,
          "kernel_vs_plain_max_abs": plain_err,
          "kernel_vs_plain_bound": plain_bound,
          "bucket_max_abs": bucket_err, "bucket_bound": bucket_bound,
          "p50_latency_s": float(np.median(lat)),
          "latencies_s": lat,
          "audio_sec_per_s": audio_s / wall,
          "serving_many_s": many_s,
          "serving_many_requests": len(mels),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
  log("slice " + json.dumps(info))
  del synth
  torch.cuda.empty_cache()
  return info, solo[0].samples


def kernel_family(name: str) -> str:
  if "wn_layer_kernel" in name:
    return "wn_layer kernel"
  if "wn_shard_kernel" in name:
    return "wn shard kernel"
  if re.search(r"gemm|xmma|nvjet|cutlass|cublas", name, re.I):
    return "cuBLAS matmul (cond, upsample, 1x1, STFT)"
  return "elementwise, copies and reductions"


def profile_call(fn) -> dict:
  """Device time of one call of ``fn`` by kernel family, and the device's
  idle share of the call's wall time (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  families, top, syncs = {}, [], {}
  for ev in prof.key_averages():
    if (ev.device_type == torch.autograd.DeviceType.CPU
        and ("Synchronize" in ev.key or ev.key == "cudaMemcpy")):
      syncs[ev.key] = ev.count
    # Host ops, and the device-timeline spans the profiler records for each
    # of them (named after the op), would count their kernels twice.
    if (ev.device_type != torch.autograd.DeviceType.CUDA
        or getattr(ev, "is_user_annotation", False)
        or ev.key.startswith("aten::")):
      continue
    dev_us = ev.self_device_time_total
    if dev_us <= 0:
      continue
    fam = kernel_family(ev.key)
    families[fam] = families.get(fam, 0.0) + dev_us / 1e3
    top.append((dev_us / 1e3, ev.count, ev.key[:90]))
  busy_ms = sum(families.values())
  top.sort(reverse=True)
  return {"wall_ms": wall_ms,
          "device_busy_ms": busy_ms if busy_ms else "not measured",
          "idle_share": 1 - busy_ms / wall_ms if busy_ms else "not measured",
          "by_family_ms": families,
          "host_sync_calls": syncs,
          "top_kernels": [{"ms": ms, "count": n, "name": k}
                          for ms, n, k in top[:8]]}


# -- phase 5 ---------------------------------------------------------------

GRAD_NAMES = ("x", "cond", "w_in", "b_in", "w_rs", "b_rs")


def trainable_inputs(last: bool, dtype, seed: int, width: int = C):
  """The six inputs (requiring grad) of one training layer (``width``
  channels) at the training segment's shape, as the model feeds it, and two
  output cotangents."""
  C = width
  g = torch.Generator(device="cuda").manual_seed(seed)

  def rand(*shape, scale):
    return torch.randn(*shape, generator=g, device="cuda") * scale

  rs = C if last else 2 * C
  args = (rand(B_TRAIN, T_TRAIN, C, scale=0.5),
          rand(B_TRAIN, T_TRAIN, 2, C, scale=0.5).to(dtype),
          rand(3, C, 2 * C, scale=(3 * C) ** -0.5).to(dtype),
          rand(2 * C, scale=0.1),
          rand(C, rs, scale=C ** -0.5).to(dtype),
          rand(rs, scale=0.1))
  cot = (rand(B_TRAIN, T_TRAIN, C, scale=1.0),
         rand(B_TRAIN, T_TRAIN, C, scale=1.0))
  return [a.requires_grad_() for a in args], cot


def trainable_cost(last: bool, mode: str, width: int) -> dict:
  """Least work of one training layer: the forward (the kernel's work) and
  the six gradients (without recomputing the forward), each input read
  once and each output written once. Every product takes its operands in
  the compute dtype and counts at that dtype's rate: in bf16 the backward's
  operands (drs, acts, dgates, the taps) are rounded to bf16 (the rounding
  points of wn_layer_backward), so its products count at the tensor cores'
  bf16 rate; in f32 they count at the f32 rate. ``width``: the channels."""
  C = width
  esize = 2 if mode == "bf16" else 4
  rs = C if last else 2 * C
  rows = B_TRAIN * T_TRAIN
  weights = (3 * C * 2 * C + C * rs) * esize
  biases = (2 * C + rs) * 4
  fwd_bytes = (rows * C * 4 + rows * 2 * C * esize + weights + biases
               + 2 * rows * C * 4)             # x, cond in; x', skip out
  grad_bytes = (2 * rows * C * 4                # the two cotangents in
                + rows * C * 4 + rows * 2 * C * esize + weights + biases)
  all_bytes = fwd_bytes + grad_bytes
  # the backward alone reads the saved inputs again
  bwd_bytes = (grad_bytes + rows * C * 4 + rows * 2 * C * esize + weights
               + biases)
  fwd_flops = 2 * rows * C * (3 * 2 * C + rs)
  # dacts and dw_rs, then dw_in and the taps' adjoint
  bwd_flops = 2 * rows * (2 * C * rs + 2 * 3 * C * 2 * C)
  t_ops = fwd_flops / PEAK_FLOPS[mode] + bwd_flops / PEAK_FLOPS[mode]
  t_bytes = all_bytes / HBM_BYTES_PER_S
  return {"bytes": all_bytes, "fwd_flops": fwd_flops, "bwd_flops": bwd_flops,
          "fwd_bound_ms": max(fwd_bytes / HBM_BYTES_PER_S,
                              fwd_flops / PEAK_FLOPS[mode]) * 1e3,
          "bwd_bound_ms": max(bwd_bytes / HBM_BYTES_PER_S,
                              bwd_flops / PEAK_FLOPS[mode]) * 1e3,
          "bwd_bound_by": ("bytes" if bwd_bytes / HBM_BYTES_PER_S
                           >= bwd_flops / PEAK_FLOPS[mode] else "operations"),
          "bound_ms": max(t_bytes, t_ops) * 1e3,
          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_split(fn, pattern: str, kernels: int, reps: int = 10,
                 tries: int = 6, key=None):
  """Device milliseconds of each of the ``kernels`` kernels whose names
  ``pattern`` matches in one call of ``fn``, by the match's first group
  (or ``key`` of it): the mean over the launches that torch.profiler holds
  of ``reps`` calls. Late in a long process a trace may hold fewer
  launches than were made, or none of a kernel: such a trace is taken
  again, up to ``tries`` times, then "not measured"."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  for _ in range(tries):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    total, seen = {}, {}
    for name, ms in device_kernels(prof):
      kernel = re.search(pattern, name)
      if kernel:
        k = key(kernel.group(1)) if key else kernel.group(1)
        total[k] = total.get(k, 0.0) + ms
        seen[k] = seen.get(k, 0) + 1
    if len(seen) == kernels:
      return {k: total[k] / seen[k] for k in total}
  return "not measured"


# The kernels of the whole layer's bf16 backward, and of the forward, by name.
BWD_SPLIT = r"wn_bwd_(prep|rows|dx|weights|reduce)_kernel"
FWD_SPLIT = r"wn_layer_kernel_(f32_tiles|f32_rest|f32|mma|gate|rs|round)"


def backward_kernel_ms(saved, cot, dilation: int, reps: int = 10) -> dict:
  """Device milliseconds of each bf16 backward kernel in one call, the mean
  over ``reps`` calls under torch.profiler."""
  return kernel_split(lambda: kl.wn_layer_backward_fused(saved, *cot,
                                                         dilation),
                      BWD_SPLIT, len(kl.BWD_KERNELS), reps)


def phase_trainable(seed: int) -> dict:
  results, timed = [], {}
  for mode, cdt in MODES.items():
    dtype = cdt or torch.float32
    for i in range(N_LAYERS + 1):
      last = i == N_LAYERS
      dilation = 2 ** min(i, N_LAYERS - 1)
      args, cot = trainable_inputs(last, dtype, seed + i)
      detached = [a.detach() for a in args]
      out = kl.wn_layer_trainable(*args, dilation, compute_dtype=cdt)
      plain_out = kl.wn_layer_plain(*args, dilation, compute_dtype=cdt)
      torch.cuda.synchronize()
      fwd_err = max((a - b).abs().max().item()
                    for a, b in zip(out, plain_out))
      fwd_scale = max(b.abs().max().item() for b in plain_out)
      fwd_bound = (KERNEL_TOL_F32 if mode == "f32"
                   else KERNEL_TOL_BF16_REL * fwd_scale)
      rec = {"mode": mode, "B": B_TRAIN, "T": T_TRAIN, "dilation": dilation,
             "last": last, "forward_max_abs_err": fwd_err,
             "forward_ref_max_abs": fwd_scale, "forward_bound": fwd_bound,
             "grads": {}}
      if not all(torch.isfinite(o).all() for o in out) or fwd_err > fwd_bound:
        fail(f"trainable forward (the kernel) disagrees with the plain "
             f"layer: {rec}")
      fused = kl.wn_layer_fused(*detached, dilation, compute_dtype=cdt)
      if not all(torch.equal(a, b) for a, b in zip(out, fused)):
        fail(f"trainable forward differs from wn_layer_fused ({mode}, "
             f"d={dilation}, last={last})")
      del fused
      grads = torch.autograd.grad(out, args, cot)
      plain = torch.autograd.grad(plain_out, args, cot)
      del plain_out
      for name, got, ref in zip(GRAD_NAMES, grads, plain):
        if got.dtype != ref.dtype or got.shape != ref.shape:
          fail(f"grad {name}: {got.dtype} {tuple(got.shape)}, plain "
               f"{ref.dtype} {tuple(ref.shape)}")
        if not torch.isfinite(got).all():
          fail(f"grad {name} not finite ({mode}, d={dilation})")
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rec["grads"][name] = {"max_abs_err": err, "ref_max_abs": scale,
                              "bound": GRAD_TOL_REL[mode] * scale}
        if err > GRAD_TOL_REL[mode] * scale:
          fail(f"trainable grad {name} disagrees with plain autograd: {rec}")
      saved = tuple(detached)
      if mode == "bf16":
        # the backward kernels against the plain backward at the same
        # rounding points; autograd handed back exactly the kernels' output
        kernel_grads = kl.wn_layer_backward_fused(saved, *cot, dilation)
        if not all(torch.equal(a, b) for a, b in zip(grads, kernel_grads)):
          fail(f"trainable backward differs from wn_layer_backward_fused "
               f"(d={dilation}, last={last})")
        plain_bwd = kl.wn_layer_backward(saved, *cot, dilation, None, cdt)
        rec["backward_vs_plain"] = {}
        for name, got, ref in zip(GRAD_NAMES, kernel_grads, plain_bwd):
          err = (got.float() - ref.float()).abs().max().item()
          scale = ref.float().abs().max().item()
          rec["backward_vs_plain"][name] = {
              "max_abs_err": err, "ref_max_abs": scale,
              "bound": KERNEL_TOL_BF16_REL * scale}
          if err > KERNEL_TOL_BF16_REL * scale:
            fail(f"backward kernel {name} disagrees with wn_layer_backward: "
                 f"{rec['backward_vs_plain']}")
        rec["backward_max_err_of_scale"] = max(
            g["max_abs_err"] / g["ref_max_abs"]
            for g in rec["backward_vs_plain"].values() if g["ref_max_abs"] > 0)
        rec["backward_max_abs_err"] = max(
            g["max_abs_err"] for g in rec["backward_vs_plain"].values())
        del kernel_grads, plain_bwd
      rec["grad_max_abs_err"] = max(g["max_abs_err"]
                                    for g in rec["grads"].values())
      rec["max_err_of_scale"] = max(g["max_abs_err"] / g["ref_max_abs"]
                                    for g in rec["grads"].values()
                                    if g["ref_max_abs"] > 0)
      if dilation == 1 or last:
        rec["forward_ms"] = cuda_ms(lambda: kl.wn_layer_fused(
            *detached, dilation, compute_dtype=cdt))
        # the backward as WNLayerTrainable runs it in this mode (the bf16
        # kernels, the f32 torch ops), and its plain version, which is the
        # torch-ops route the bf16 backward took before its kernels
        rec["torch_backward_ms"] = cuda_ms(lambda: kl.wn_layer_backward(
            saved, cot[0], cot[1], dilation, None, cdt))
        if mode == "bf16":
          rec["backward_ms"] = cuda_ms(lambda: kl.wn_layer_backward_fused(
              saved, cot[0], cot[1], dilation))
          rec["backward_kernels_ms"] = backward_kernel_ms(saved, cot, dilation)
        else:
          rec["backward_ms"] = rec["torch_backward_ms"]
        rec["ms"] = rec["forward_ms"] + rec["backward_ms"]
        rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
            kl.wn_layer_plain(*args, dilation, compute_dtype=cdt), args, cot))
        rec["plain_forward_ms"] = cuda_ms(lambda: kl.wn_layer_plain(
            *detached, dilation, compute_dtype=cdt))
        plain_out = kl.wn_layer_plain(*args, dilation, compute_dtype=cdt)
        rec["plain_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
            plain_out, args, cot, retain_graph=True))
        del plain_out
        x, cond, w_in, b_in, w_rs, _ = detached
        lib_in = (x.to(dtype).transpose(1, 2).contiguous().requires_grad_(),
                  cond.reshape(B_TRAIN, T_TRAIN, 2 * C).clone()
                  .requires_grad_(),
                  w_in.permute(2, 1, 0).contiguous().requires_grad_(),
                  b_in.to(dtype).clone().requires_grad_(),
                  w_rs.clone().requires_grad_())
        cot_rs = torch.cat(cot, dim=-1)[..., :w_rs.shape[1]].to(dtype)
        rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            library_layer(*lib_in, None, dilation, dtype), lib_in, cot_rs))
        # the library's backward alone: its forward built once, outside the
        # timed region
        lib_out = library_layer(*lib_in, None, dilation, dtype)
        rec["library_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
            lib_out, lib_in, cot_rs, retain_graph=True))
        del lib_out
        rec.update(trainable_cost(last, mode, C))
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["backward_share_of_bound"] = (rec["bwd_bound_ms"]
                                          / rec["backward_ms"])
        timed[(mode, last)] = rec
      log("trainable " + json.dumps(rec))
      results.append(rec)
      del args, detached, cot, out, grads, plain
  torch.cuda.empty_cache()
  return {"cases": results, "timed": timed}


# -- phase 6 ---------------------------------------------------------------

GEMM = re.compile(r"gemm|xmma|nvjet|cutlass|cublas", re.I)


def write_wavs(folder: Path, seed: int) -> list:
  """N_WAVS cuts of the speech fixture, 1.0-1.8 s each, at spread offsets."""
  sr, wav = wavfile.read(FIXTURE)
  rng = np.random.default_rng(seed)
  folder.mkdir(parents=True, exist_ok=True)
  for i in range(N_WAVS):
    length = int(rng.integers(22_050, 40_000))
    start = int(rng.integers(0, len(wav) - length))
    wavfile.write(folder / f"{i:02d}.wav", sr, wav[start:start + length])
  return load_dataset(folder)


def write_loader_wavs(folder: Path, seed: int) -> list:
  """LOADER_WAVS seeded PCM16 noise files of LOADER_SECONDS at 22,050 Hz
  (about 25 MB)."""
  rng = np.random.default_rng(seed)
  folder.mkdir(parents=True, exist_ok=True)
  sr = HParams().sampling_rate
  for i in range(LOADER_WAVS):
    n = int(rng.uniform(*LOADER_SECONDS) * sr)
    wavfile.write(folder / f"{i:03d}.wav", sr,
                  rng.integers(-12_000, 12_000, n).astype(np.int16))
  return load_dataset(folder)


def loader_check(entries: list, hp: HParams, seed: int, tmp: Path) -> dict:
  """The native loader against the Python decoder: phase 6's batches at
  epochs 0 and 1 bit for bit, then one batch of B_TRAIN crops of the
  LJSpeech-like folder decoded both ways LOADER_REPS times (each its own
  files, alternating which goes first; lengths probed and files in the page
  cache beforehand): host ms, median."""
  datasets = [SegmentDataset(entries, hp, use_native=n) for n in (True, False)]
  unequal = []
  for epoch in (0, 1):
    for lo in range(0, len(entries), B_TRAIN):
      rows = range(lo, min(lo + B_TRAIN, len(entries)))
      a, b = (ds.batch(rows, epoch) for ds in datasets)
      if a.tobytes() != b.tobytes():
        unequal.append((epoch, lo))
  if unequal:
    fail(f"the native loader's batches (epoch, first row) {unequal} differ "
         "from the Python decoder's")
  wavs = write_loader_wavs(tmp / "loader_wavs", seed)
  datasets = [SegmentDataset(wavs, hp, use_native=n) for n in (True, False)]
  for i in range(len(wavs)):
    datasets[0]._length(i)
    datasets[1]._load(i)
  times = {True: [], False: []}
  for rep in range(LOADER_REPS):
    start = rep * B_TRAIN % (len(wavs) - B_TRAIN)
    rows = range(start, start + B_TRAIN)
    out = {}
    for use_native in ((True, False) if rep % 2 == 0 else (False, True)):
      t0 = time.perf_counter()
      out[use_native] = datasets[0 if use_native else 1].batch(rows, rep)
      times[use_native].append((time.perf_counter() - t0) * 1e3)
    if out[True].tobytes() != out[False].tobytes():
      fail(f"native and Python batches of rows {list(rows)} differ")
  size = sum(e.wav_absolute_path.stat().st_size for e in wavs)
  seconds = [datasets[0]._length(i) / hp.sampling_rate
             for i in range(len(wavs))]
  shutil.rmtree(tmp / "loader_wavs")
  return {"batches_equal_epochs_0_1": True,
          "timing_folder": {"files": len(wavs), "bytes": size,
                            "seconds_min_max": [min(seconds), max(seconds)]},
          "native_ms": times[True], "python_ms": times[False],
          "native_median_ms": float(np.median(times[True])),
          "python_median_ms": float(np.median(times[False])),
          "host_cores": len(os.sched_getaffinity(0))}


def denoiser_check(mode: str, seed: int, hp: HParams) -> dict:
  """The denoiser's bias capture (``capture_bias``) of phase 6's model
  (``hp``, full width) in ``mode``, from a standard-normal mel drawn from
  ``seed``: 96 WN launches a capture, a finite f32 bias unlike the zeros
  mel's (the ``Denoiser``'s, in f32), within SLICE_TOL_REL of the same
  capture through wn_layer_plain."""
  config = WaveGlowConfig.from_hparams(hp)
  cdt = MODES[mode]
  tree = params_to_torch(fuse_for_inference(full_width_params(seed)),
                         torch.device(DEVICE))
  per_capture = config.n_flows * config.n_layers
  dn = Denoiser(tree, config, hp, DEVICE)
  mel = torch.randn((1, hp.n_mel_channels, BIAS_MEL_LENGTH),
                    generator=torch.Generator().manual_seed(seed)).to(DEVICE)
  torch.cuda.synchronize()
  before = kl.LAUNCHES
  t0 = time.perf_counter()
  bias = capture_bias(tree, config, dn.stft, mel, cdt)
  torch.cuda.synchronize()
  capture_ms = (time.perf_counter() - t0) * 1e3
  launches = kl.LAUNCHES - before
  if launches != per_capture:
    fail(f"{mode}: the normal-mel bias capture launched the WN kernel "
         f"{launches} times, expected {per_capture}")
  if bias.dtype != torch.float32 or not bool(torch.isfinite(bias).all()):
    fail(f"{mode}: normal-mel bias {bias.dtype}, finite "
         f"{bool(torch.isfinite(bias).all())}")
  zeros = dn.bias_spec if cdt is None else capture_bias(
      tree, config, dn.stft, torch.zeros_like(mel), cdt)
  if torch.equal(zeros, bias):
    fail(f"{mode}: the normal mel's bias equals the zeros mel's")
  plain = capture_bias(tree, config, dn.stft, mel, cdt,
                       layer=kl.wn_layer_plain)
  scale = plain.abs().max().item()
  err = (bias - plain).abs().max().item()
  if err > SLICE_TOL_REL[mode] * scale:
    fail(f"{mode}: the normal mel's bias through the kernel differs from "
         f"the plain capture by {err} (scale {scale})")
  return {"launches": launches, "capture_ms": capture_ms,
          "max_abs_err_vs_plain": err, "scale": scale,
          "bound": SLICE_TOL_REL[mode] * scale,
          "vs_zeros_max_abs": (zeros - bias).abs().max().item()}


def read_metrics(logdir: Path) -> list:
  return [json.loads(line) for line in
          (logdir / "metrics.jsonl").read_text().splitlines()]


def device_kernels(prof) -> list:
  """(name, ms) of every kernel and copy the device ran, without the per-op
  spans the profiler also records on the device's timeline."""
  out = []
  for ev in prof.events():
    if (ev.device_type != torch.autograd.DeviceType.CUDA
        or getattr(ev, "is_user_annotation", False)
        or ev.name.startswith("aten::")):
      continue
    out.append((ev.name, (ev.time_range.end - ev.time_range.start) / 1e3))
  return out


def profile_train_step(step_fn, params, batch, cond_width: int) -> dict:
  """One train step under torch.profiler: wall, device busy and idle share,
  the host's CUDA runtime calls and which ops made a synchronising one;
  then a second step, with input shapes recorded, whose kernels are
  attributed to the ops that launched them: the WN kernel by name, the WN
  layer's backward by its autograd node, the cond GEMMs by their
  ``cond_width``-wide operand."""
  from torch.profiler import ProfilerActivity, profile
  activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
  torch.cuda.synchronize()
  with profile(activities=activities) as prof:
    t0 = time.perf_counter()
    float(step_fn(params, batch))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  busy_ms = sum(ms for _, ms in device_kernels(prof))
  # the host's calls into the CUDA runtime: a synchronising call makes the
  # host wait for the device, and the op that made it is named
  runtime, syncs = {}, {}
  for ev in prof.events():
    if (ev.device_type != torch.autograd.DeviceType.CPU
        or not ev.name.startswith("cuda")):
      continue
    runtime[ev.name] = runtime.get(ev.name, 0) + 1
    if "Synchronize" in ev.name or ev.name == "cudaMemcpy":
      chain, e = [], ev.cpu_parent
      while e is not None and len(chain) < 3:
        chain.append(e.name)
        e = e.cpu_parent
      key = " < ".join(chain) or "(no op)"
      syncs[key] = syncs.get(key, 0) + 1

  with profile(activities=activities, record_shapes=True) as prof:
    float(step_fn(params, batch))
    torch.cuda.synchronize()
  wn_key = "WN kernel (forward and remat recompute)"
  bwd_key = "WN backward kernels (rows, dx, weights, reduce)"
  families = dict.fromkeys(
      (wn_key, bwd_key, "WN backward: GEMMs", "WN backward: elementwise",
       "cond GEMMs (forward, recompute, backward)",
       "other GEMMs (upsample, 1x1, STFT, mel)",
       "other elementwise, copies, reductions, Adam"), 0.0)
  kernels = device_kernels(prof)
  families[wn_key] = sum(ms for name, ms in kernels
                         if "wn_layer_kernel" in name)
  families[bwd_key] = sum(ms for name, ms in kernels if "wn_bwd_" in name)
  for ev in prof.events():
    if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
      continue
    chain, e = [], ev
    while e is not None:
      chain.append(e)
      e = e.cpu_parent
    in_bwd = any("WNLayerTrainableBackward" in e.name for e in chain)
    is_cond = any(isinstance(dims, (list, tuple)) and cond_width in dims
                  for e in chain for dims in (e.input_shapes or ()))
    for k in ev.kernels:
      if "wn_layer_kernel" in k.name or "wn_bwd_" in k.name:
        continue
      gemm = bool(GEMM.search(k.name))
      if in_bwd:
        key = "WN backward: GEMMs" if gemm else "WN backward: elementwise"
      elif gemm:
        key = ("cond GEMMs (forward, recompute, backward)" if is_cond
               else "other GEMMs (upsample, 1x1, STFT, mel)")
      else:
        key = "other elementwise, copies, reductions, Adam"
      families[key] += k.duration / 1e3
  attributed_busy = sum(ms for _, ms in kernels)
  families["not attributed"] = attributed_busy - sum(families.values())
  return {"wall_ms": wall_ms,
          "device_busy_ms": busy_ms if busy_ms else "not measured",
          "idle_share": 1 - busy_ms / wall_ms if busy_ms else "not measured",
          "attributed_step_busy_ms": attributed_busy,
          "by_family_ms": families,
          "cuda_runtime_calls": runtime, "host_syncs_by_op": syncs}


def leaf_norm_rel_errors(grads, refs) -> list:
  """Each leaf's ``||grad - ref||_2 / ||ref||_2`` (in float64; the
  absolute norm where the reference is zero)."""
  out = []
  for got, ref in zip(grads, refs):
    err = torch.linalg.vector_norm((got.double() - ref.double())).item()
    scale = torch.linalg.vector_norm(ref.double()).item()
    out.append(err / scale if scale else err)
  return out


def phase_train(mode: str, seed: int, tmp: Path) -> dict:
  custom = dict(TRAIN_HPARAMS, seed=str(seed),
                compute_dtype="bfloat16" if mode == "bf16" else "float32")
  hp = overwrite_custom_hparams(HParams(), custom)
  config = WaveGlowConfig.from_hparams(hp)
  entries = write_wavs(tmp / "wavs", seed)
  per_forward = config.n_flows * config.n_layers
  per_step = 2 * per_forward if hp.remat else per_forward
  # one call of the backward kernels per layer a bf16 step, none in f32
  bwd_per_step = per_forward if mode == "bf16" else 0
  audio_per_step = B_TRAIN * hp.segment_length / hp.sampling_rate

  # -- the main path: train() from the seed's initialisation, its batches
  # read through the native loader
  torch.cuda.reset_peak_memory_stats()
  kl.LAUNCHES = kl.BWD_LAUNCHES = native.BATCHES = 0
  t0 = time.perf_counter()
  train(custom, tmp / "logs", entries, entries, tmp / "ck",
        max_iterations=TRAIN_STEPS, device=DEVICE)
  train_s = time.perf_counter() - t0
  launches, bwd_launches = kl.LAUNCHES, kl.BWD_LAUNCHES
  loader_batches = native.BATCHES
  peak = torch.cuda.max_memory_allocated()
  records = read_metrics(tmp / "logs")
  steps = [r for r in records if r["event"] == "train_step"]
  saves = [r["iteration"] for r in records if r["event"] == "validation"]
  val_batches = -(-len(entries) // B_TRAIN)
  expected = per_step * len(steps) + per_forward * val_batches * len(saves)
  if len(steps) != TRAIN_STEPS or saves != [1, RESUME_FROM, TRAIN_STEPS]:
    fail(f"{mode}: train() ran {len(steps)} steps, validated at {saves}")
  if launches != expected:
    fail(f"{mode}: train() launched the kernel {launches} times, expected "
         f"{expected} ({per_step} per step, {per_forward} per validation "
         "batch)")
  if bwd_launches != bwd_per_step * len(steps):
    fail(f"{mode}: train() called the backward kernels {bwd_launches} "
         f"times, expected {bwd_per_step * len(steps)} ({bwd_per_step} per "
         "step)")
  read_batches = len(steps) + val_batches * len(saves)
  if loader_batches != read_batches:
    fail(f"{mode}: the native loader decoded {loader_batches} batches, "
         f"train() read {read_batches} ({len(steps)} steps, {val_batches} "
         f"a validation)")
  losses = [r["loss"] for r in steps]
  if not np.isfinite(losses).all():
    fail(f"{mode}: non-finite loss {losses}")
  step_s = [r["duration_s"] for r in steps[1:]]

  # -- resume from the step-3 checkpoint: the straight run's losses
  train(None, tmp / "logs_resumed", entries, entries, tmp / "ck_resumed",
        checkpoint=CheckpointWaveglow.load(tmp / "ck" / f"{RESUME_FROM}.npz"),
        max_iterations=TRAIN_STEPS, device=DEVICE)
  resumed = {r["iteration"]: r["loss"]
             for r in read_metrics(tmp / "logs_resumed")
             if r["event"] == "train_step"}
  if sorted(resumed) != list(range(RESUME_FROM + 1, TRAIN_STEPS + 1)):
    fail(f"{mode}: the resumed run took steps {sorted(resumed)}")
  resume_err = max(abs(resumed[it] - losses[it - 1]) for it in resumed)
  if resume_err > RESUME_LOSS_TOL:
    fail(f"{mode}: resumed losses {resumed} differ from the straight run "
         f"{losses} by {resume_err}")
  for ck in ("ck", "ck_resumed"):   # about 1 GB a checkpoint
    shutil.rmtree(tmp / ck)

  t0 = time.perf_counter()
  loader = loader_check(entries, hp, seed, tmp)
  denoiser = denoiser_check(mode, seed, hp)
  log(f"loader {mode} " + json.dumps({**loader, "denoiser": denoiser,
                                      "main_path_batches": loader_batches,
                                      "seconds": time.perf_counter() - t0}))

  # -- one step through the kernel against the plain route
  params_np = full_width_params(seed)
  mel_op = MelSTFT(hp, DEVICE)
  batch = torch.from_numpy(SegmentDataset(entries, hp).batch(
      range(B_TRAIN), 0)).to(DEVICE)
  other_hp = dataclasses.replace(
      hp, compute_dtype="float32" if mode == "bf16" else "bfloat16")
  cut = torch.full((batch.shape[0],),
                   hp.segment_length // config.n_group - ROWS_OFF,
                   dtype=torch.int32, device=DEVICE)

  def rows_off(*args, compute_dtype=None):
    return kl.wn_layer_trainable(*args, valid_t=cut,
                                 compute_dtype=compute_dtype)

  routes = {}
  for route, route_hp, layer in (
      ("kernel", hp, kl.wn_layer_trainable), ("plain", hp, kl.wn_layer_plain),
      ("other_dtype", other_hp, kl.wn_layer_plain),
      ("rows_off", hp, rows_off)):
    params = trainable_params_from_numpy(params_np, DEVICE)
    loss = train_lib.compute_grads(
        train_lib.make_loss_fn(config, route_hp, mel_op, layer), params,
        batch)
    routes[route] = (float(loss), [p.grad for p in tree_leaves(params)])
    del params
  loss_p, grads_p = routes.pop("plain")
  against_plain = {}
  for route, (loss_r, grads_r) in routes.items():
    rel = leaf_norm_rel_errors(grads_r, grads_p)
    worst = int(np.argmax(rel))
    against_plain[route] = {
        "loss": loss_r, "loss_err": abs(loss_r - loss_p),
        "grad_norm_rel": rel[worst], "worst_leaf": worst,
        "worst_leaf_shape": list(grads_p[worst].shape),
        "finite": all(bool(torch.isfinite(g).all()) for g in grads_r)}
  zero_leaves = sum(ref.abs().max().item() == 0 for ref in grads_p)
  del routes, grads_p
  log(f"train_step_check {mode} " + json.dumps(
      {"plain_loss": loss_p, "against_plain": against_plain,
       "loss_bound": STEP_LOSS_TOL[mode],
       "grad_bound_rel": STEP_GRAD_TOL_REL[mode]}))
  kernel_gap = against_plain["kernel"]
  if (not kernel_gap["finite"]
      or kernel_gap["grad_norm_rel"] > STEP_GRAD_TOL_REL[mode]):
    fail(f"{mode}: leaf {kernel_gap['worst_leaf']}'s grad through the "
         f"kernel differs from the plain route by "
         f"{kernel_gap['grad_norm_rel']} of its norm")
  if kernel_gap["loss_err"] > STEP_LOSS_TOL[mode]:
    fail(f"{mode}: loss through the kernel {kernel_gap['loss']}, plain route "
         f"{loss_p}")
  for route in WRONG_ROUTES:
    gap = against_plain[route]
    if (gap["grad_norm_rel"] <= STEP_GRAD_TOL_REL[mode]
        or gap["loss_err"] <= STEP_LOSS_TOL[mode]):
      fail(f"{mode}: the wrong route {route} passes the grad or the loss "
           f"bound of the kernel-vs-plain check ({gap}): that bound cannot "
           "tell a wrong kernel")

  # -- from the seed's initialisation (zero ends, as train() starts), the
  # loss falls over 5 steps on one repeated batch; then 5 more steps timed,
  # with the host's enqueue time (the step returns before the device ends)
  params = trainable_params_from_numpy(
      init_params(config, seed=seed), DEVICE)
  optimizer = train_lib.make_optimizer(params, hp.learning_rate)
  step_fn = train_lib.make_train_step(config, hp, mel_op, optimizer)
  repeated, per_call, step_times, enqueue_times = [], [], [], []
  bwd_per_call = []
  for i in range(10):
    before, bwd_before = kl.LAUNCHES, kl.BWD_LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step_fn(params, batch)
    t1 = time.perf_counter()
    repeated.append(float(loss))
    if i >= 5:
      step_times.append(time.perf_counter() - t0)
      enqueue_times.append(t1 - t0)
    per_call.append(kl.LAUNCHES - before)
    bwd_per_call.append(kl.BWD_LAUNCHES - bwd_before)
  if per_call != [per_step] * len(per_call):
    fail(f"{mode}: kernel launches per step {per_call}, expected {per_step}")
  if bwd_per_call != [bwd_per_step] * len(bwd_per_call):
    fail(f"{mode}: backward kernel calls per step {bwd_per_call}, expected "
         f"{bwd_per_step}")
  if not repeated[4] < repeated[0]:
    fail(f"{mode}: loss did not fall over 5 steps on one batch: {repeated}")
  profile = profile_train_step(step_fn, params, batch,
                               config.n_mel_channels * config.n_group)
  del params, optimizer, step_fn, batch, loss
  torch.cuda.empty_cache()

  median_s = float(np.median(step_s))
  steady_s = float(np.median(step_times))
  busy_ms = profile["device_busy_ms"]
  info = {"mode": mode, "launches": launches, "expected_launches": expected,
          "loader_batches": loader_batches, "loader": loader,
          "normal_mel_capture": denoiser,
          "launches_per_step": per_call[0],
          "backward_launches": bwd_launches,
          "backward_launches_per_step": bwd_per_call[0], "train_s": train_s,
          "losses": losses, "resumed_losses": resumed,
          "resume_max_abs_err": resume_err,
          "step_s": step_s, "median_step_s": median_s,
          "audio_s_per_step": audio_per_step,
          "audio_s_per_s": audio_per_step / median_s,
          "max_memory_allocated_bytes": peak,
          "kernel_vs_plain_loss": [kernel_gap["loss"], loss_p],
          "kernel_vs_plain_loss_err": kernel_gap["loss_err"],
          "kernel_vs_plain_grad_norm_rel": kernel_gap["grad_norm_rel"],
          "step_check_against_plain": against_plain,
          "zero_grad_leaves": zero_leaves,
          "repeated_batch_losses": repeated,
          "steady_step_s": step_times,
          "steady_median_step_s": steady_s,
          "steady_median_enqueue_s": float(np.median(enqueue_times)),
          "steady_audio_s_per_s": audio_per_step / steady_s,
          # the profiled step runs slower (the profiler's own host cost), so
          # its busy time is also set against the unprofiled median step
          "idle_share_vs_steady_step": (1 - busy_ms / 1e3 / steady_s
                                        if busy_ms != "not measured"
                                        else busy_ms),
          "profile_step": profile}
  log("train " + json.dumps(info))
  return info


# -- phase 7 ---------------------------------------------------------------

def stream_windows(frames: int, chunk: int, halo: int) -> int:
  """Windows a stream of ``frames`` runs at ``chunk``: one padded window
  when the mel fits in ``chunk + 2 * halo`` frames, else one a chunk."""
  return -(-frames // chunk) if frames > chunk + 2 * halo else 1


def first_audio_s(synth: Synthesizer, mel: np.ndarray, seed: int,
                  chunk: int, strength: float) -> float:
  """Host seconds from the call of stream() to its first piece (fetched to
  the host); the rest of the stream is not run."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  pieces = synth.stream(mel, seed=seed, chunk_frames=chunk,
                        denoiser_strength=strength)
  next(pieces)
  elapsed = time.perf_counter() - t0
  pieces.close()
  return elapsed


def phase_stream(ckpt: CheckpointWaveglow, mode: str, seed: int) -> dict:
  """Stream the requests in ``mode`` through Synthesizer.stream: launches
  per window, raw and denoised reassembly against one-call synthesis, PCM
  pieces, peak memory against length, first-audio latency, per-window
  device time and audio-s/s."""
  synth = Synthesizer(ckpt, compute_dtype="bfloat16" if mode == "bf16"
                      else "float32", device=DEVICE)
  config = synth.config
  rng = np.random.default_rng(seed + 7)
  mels = {f: rng.uniform(-11.0, 1.0, (80, f)).astype(np.float32)
          for f in STREAM_FRAMES}
  per_window = config.n_flows * config.n_layers
  halo = receptive_halo_frames(config)
  sr = synth.hparams.sampling_rate
  list(synth.stream(mels[200], seed=seed, chunk_frames=STREAM_CHUNK))

  # -- the main path, with the launch count read around it: each request
  # streamed raw and denoised; launches read between the pieces
  kl.LAUNCHES = 0
  raw, denoised, window_launches = {}, {}, {}
  for f, mel in mels.items():
    pieces, counts, before = [], [], kl.LAUNCHES
    for start, piece in synth.stream(mel, seed=seed,
                                     chunk_frames=STREAM_CHUNK):
      counts.append(kl.LAUNCHES - before)
      before = kl.LAUNCHES
      if start != sum(len(p) for p in pieces):
        fail(f"{mode}: stream piece at {start} after "
             f"{sum(len(p) for p in pieces)} samples")
      pieces.append(piece)
    raw[f], window_launches[f] = np.concatenate(pieces), counts
    denoised[f] = np.concatenate([p for _, p in synth.stream(
        mel, seed=seed, chunk_frames=STREAM_CHUNK,
        denoiser_strength=STREAM_STRENGTH)])
  launches = kl.LAUNCHES
  windows = {f: stream_windows(f, STREAM_CHUNK, halo) for f in mels}
  for f in mels:
    if window_launches[f] != [per_window] * windows[f]:
      fail(f"{mode}: launches per window of the {f}-frame stream "
           f"{window_launches[f]}, expected {windows[f]} x {per_window}")
  if launches != 2 * per_window * sum(windows.values()):
    fail(f"{mode}: streaming launched {launches}, expected "
         f"{2 * per_window * sum(windows.values())}")

  # -- streamed against one call with the same seed
  errs = {}
  for f, mel in mels.items():
    ref = synth.infer(mel, seed=seed, denoiser_strength=STREAM_STRENGTH)
    n_out = (len(ref.wav) // synth.hparams.hop_length) * (
        synth.hparams.hop_length)
    for kind, got, want in (("raw", raw[f], ref.wav),
                            ("denoised", denoised[f],
                             ref.wav_denoised[:n_out])):
      if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{mode}: {kind} stream of {f} frames: shape {got.shape}, "
             f"one call {want.shape}, finite {np.isfinite(got).all()}")
      err = float(np.abs(got - want).max())
      bound = STREAM_TOL_REL[kind] * float(np.abs(want).max())
      errs[f"{kind}_{f}"] = {"max_abs": err, "bound": bound}
      if err > bound:
        fail(f"{mode}: {kind} stream of {f} frames differs from the one "
             f"call by {err} > {bound}")
  pcm = np.concatenate([p for _, p in synth.stream(
      mels[826], seed=seed, chunk_frames=STREAM_CHUNK, pcm16=True)])
  host = np.round(np.clip(raw[826], -1.0, 1.0) * 32767.0).astype(np.int16)
  if pcm.dtype != np.int16 or not np.array_equal(pcm, host):
    fail(f"{mode}: pcm16 stream differs from the host conversion of the "
         "float stream")

  # -- activation peak memory: streamed 826 and 3,304 frames, one call of
  # 3,304, each over the memory allocated just before it
  long_mel = np.tile(mels[826], (1, LONG_FRAMES // 826))
  peaks, baselines = {}, {}
  for name, fn in (
      ("stream_826", lambda: list(synth.stream(
          mels[826], seed=seed, chunk_frames=STREAM_CHUNK))),
      ("stream_3304", lambda: list(synth.stream(
          long_mel, seed=seed, chunk_frames=STREAM_CHUNK))),
      ("one_call_3304", lambda: synth.infer(long_mel, seed=seed,
                                            denoiser_strength=0.0))):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    baselines[name] = torch.cuda.memory_allocated()
    fn()
    peaks[name] = torch.cuda.max_memory_allocated() - baselines[name]
  if peaks["stream_3304"] > STREAM_MEMORY_RATIO * peaks["stream_826"]:
    fail(f"{mode}: streaming 3,304 frames peaked at {peaks['stream_3304']} "
         f"B over its baseline, over {STREAM_MEMORY_RATIO} x the 826-frame "
         f"stream's {peaks['stream_826']} B")

  # -- first-audio latency, raw and denoised, at each chunk
  latency = {}
  for chunk in LATENCY_CHUNKS:
    for kind, strength in (("raw", 0.0), ("denoised", STREAM_STRENGTH)):
      first_audio_s(synth, mels[826], seed, chunk, strength)  # warm-up
      reps = [first_audio_s(synth, mels[826], seed, chunk, strength)
              for _ in range(LATENCY_REPS)]
      latency[f"{kind}_chunk{chunk}"] = {"median_s": float(np.median(reps)),
                                         "s": reps}

  # -- throughput: the 826-frame request streamed raw against one call
  audio_s = 826 * UPSAMPLE_STRIDE / sr
  walls = {"stream": [], "one_call": []}
  for _ in range(3):
    for name, fn in (("stream", lambda: list(synth.stream(
        mels[826], seed=seed, chunk_frames=STREAM_CHUNK))),
                     ("one_call", lambda: synth.infer(
                         mels[826], seed=seed, denoiser_strength=0.0))):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      fn()
      walls[name].append(time.perf_counter() - t0)
  profile = profile_call(lambda: list(synth.stream(
      mels[826], seed=seed, chunk_frames=STREAM_CHUNK)))
  busy = profile["device_busy_ms"]
  info = {"mode": mode, "launches": launches,
          "launches_per_window": window_launches,
          "windows": windows, "window_frames": STREAM_CHUNK + 2 * halo,
          "halo_frames": halo, "against_one_call": errs,
          "activation_peak_bytes": peaks,
          "baseline_bytes": baselines, "first_audio": latency,
          "stream_audio_s_per_s": audio_s / float(np.median(walls["stream"])),
          "one_call_audio_s_per_s": audio_s / float(
              np.median(walls["one_call"])),
          "walls_s": walls,
          "window_device_ms": (busy / windows[826]
                               if busy != "not measured" else busy),
          "profile_stream_826": profile}
  log("stream " + json.dumps(info))
  del synth
  torch.cuda.empty_cache()
  return info


# -- phase 8 ---------------------------------------------------------------

def latency_summary(seconds) -> dict:
  """Count, mean, p50 and p99 of latencies in seconds, by the quantile
  rule the daemon's /stats uses (``np.quantile``, linear)."""
  q = np.quantile(seconds, [0.5, 0.99])
  return {"n": len(seconds), "mean": float(np.mean(seconds)),
          "p50": float(q[0]), "p99": float(q[1])}


def expected_launches(dispatch_rows, others, per_synthesis: int) -> int:
  """WN launches of a run of serving dispatches (one entry of
  ``dispatch_rows`` each, whatever its rows) and ``others`` further
  syntheses (stream windows, a reload's denoiser bias capture): one
  synthesis, ``per_synthesis`` layers, each."""
  return per_synthesis * (len(dispatch_rows) + sum(others))


def c9_failures(result_s: float, solo_s: float, batch_done: bool) -> list:
  """What the C9 check found wrong, if anything: a solo request finalized
  with an 8-row batch dispatched behind it must have its result before the
  batch's event completes, within C9_RATIO of its solo time."""
  out = []
  if batch_done:
    out.append("the batch dispatched after the solo request had finished "
               "when the solo result came back: the fetch waited for it")
  if result_s > C9_RATIO * solo_s:
    out.append(f"the solo result took {result_s:.4f} s, over {C9_RATIO} x "
               f"its solo time {solo_s:.4f} s")
  return out


def count_dispatches(synth: Synthesizer) -> list:
  """Record the rows of every serving dispatch ``synth`` makes (one
  synthesis each, whatever its rows) into the returned list."""
  rows = []
  serve_rows = synth._serve_rows

  def counted(mel, *args, **kwargs):
    rows.append(mel.shape[0])
    return serve_rows(mel, *args, **kwargs)

  synth._serve_rows = counted
  return rows


def reset_windows(service: SynthesisService) -> None:
  """Empty the daemon's latency and stage windows, so /stats reads the
  next loop alone."""
  with service._stats_lock:
    service._latencies.clear()
    service._stages.clear()


def closed_loop(client: SynthesisClient, mel: np.ndarray, clients: int,
                requests: int, seed: int, sr: int) -> dict:
  """``clients`` threads, each sending ``requests`` requests one after
  another; wall, served audio-s/s and the clients' latencies."""
  def one_client(c):
    lat = []
    for r in range(requests):
      t0 = time.perf_counter()
      wav = client.synthesize(mel, seed=seed + 1000 * c + r)
      lat.append(time.perf_counter() - t0)
      if wav.shape != (mel.shape[-1] * UPSAMPLE_STRIDE,):
        fail(f"closed loop: response of shape {wav.shape}")
    return lat

  with concurrent.futures.ThreadPoolExecutor(clients) as pool:
    t0 = time.perf_counter()
    lats = [x for lat in pool.map(one_client, range(clients)) for x in lat]
    wall = time.perf_counter() - t0
  audio_s = clients * requests * mel.shape[-1] * UPSAMPLE_STRIDE / sr
  return {"clients": clients, "requests": len(lats), "wall_s": wall,
          "audio_s_per_s": audio_s / wall,
          "client_latency_s": latency_summary(lats)}


def wait_until(predicate, what: str) -> None:
  deadline = time.monotonic() + SERVE_TIMEOUT_S
  while not predicate():
    if time.monotonic() > deadline:
      fail(f"serve: timed out waiting for {what}")
    time.sleep(0.002)


def c9_check(synth: Synthesizer, solo_mel: np.ndarray, batch_mel: np.ndarray,
             seed: int) -> dict:
  """Dispatch a solo request, then, from one other thread (as the daemon's
  dispatcher does while its finisher fetches), an 8-row batch; finalize the
  solo one. Its result must not wait for the batch: one warm-up round,
  then the median of C9_ROUNDS rounds against the median of the solo calls
  made one just before each round."""
  def solo_call():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = synth.infer_serving(solo_mel, seed=seed, bucket_frames=BUCKET)
    return time.perf_counter() - t0, res

  def dispatch_batch(started):
    started.set()
    return synth.serving_many_dispatch(
        [batch_mel] * SERVE_MAX_BATCH, seeds=list(range(SERVE_MAX_BATCH)),
        bucket_frames=BUCKET, max_batch=SERVE_MAX_BATCH)

  def one_round(pool):
    started = threading.Event()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo = synth.serving_dispatch(solo_mel, seed=seed, bucket_frames=BUCKET)
    t_dispatched = time.perf_counter() - t0
    future = pool.submit(dispatch_batch, started)
    if not started.wait(SERVE_TIMEOUT_S):
      fail("C9: the batch thread did not start")
    res = synth.serving_finalize(solo)
    result_s = time.perf_counter() - t0
    batch = future.result(timeout=SERVE_TIMEOUT_S)
    batch_done = batch.event.query()
    t_batch = time.perf_counter()
    rows = synth.serving_many_finalize(batch)
    if len(rows) != SERVE_MAX_BATCH:
      fail(f"C9: the batch gave {len(rows)} results")
    if not np.array_equal(res.samples, ref.samples):
      fail("C9: the solo result differs from its solo call")
    return {"result_s": result_s, "solo_dispatch_s": t_dispatched,
            "batch_event_done_at_result": batch_done,
            "batch_finalize_wait_s": time.perf_counter() - t_batch}

  _, ref = solo_call()
  reps, rounds = [], []
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    warm = one_round(pool)
    for _ in range(C9_ROUNDS):
      reps.append(solo_call()[0])
      rounds.append(one_round(pool))
  solo_s = float(np.median(reps))
  result_s = float(np.median([r["result_s"] for r in rounds]))
  batch_done = any(r["batch_event_done_at_result"] for r in rounds)
  # the route C9 repaired, as it waited: a blocking fetch made at finalize
  # time is enqueued at the stream's tail and waits for the stream, so
  # after the batch's enqueue it waits for the batch; the check must say so
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  solo = synth.serving_dispatch(solo_mel, seed=seed, bucket_frames=BUCKET)
  behind = synth.serving_many_dispatch(
      [batch_mel] * SERVE_MAX_BATCH, seeds=list(range(SERVE_MAX_BATCH)),
      bucket_frames=BUCKET, max_batch=SERVE_MAX_BATCH)
  torch.cuda.current_stream().synchronize()
  synth.serving_finalize(solo)
  blocking_s = time.perf_counter() - t0
  blocking = c9_failures(blocking_s, solo_s, behind.event.query())
  synth.serving_many_finalize(behind)
  if not blocking:
    fail(f"C9: the check passed a blocking fetch ({blocking_s:.4f} s, solo "
         f"{solo_s:.4f} s)")
  info = {"solo_s": solo_s, "solo_reps_s": reps,
          "result_s": result_s, "ratio": result_s / solo_s,
          "bound_ratio": C9_RATIO, "batch_event_done_at_result": batch_done,
          "rounds": rounds, "warm_up_round": warm,
          "blocking_fetch_result_s": blocking_s,
          "blocking_fetch_flagged": blocking}
  problems = c9_failures(result_s, solo_s, batch_done)
  if problems:
    fail(f"C9: {'; '.join(problems)} ({info})")
  return info


def phase_serve(ckpt: CheckpointWaveglow, paths: dict, mode: str,
                seed: int) -> dict:
  """The HTTP daemon in ``mode``, driven through SynthesisClient."""
  service = SynthesisService(
      ckpt, custom_hparams={"compute_dtype": "bfloat16" if mode == "bf16"
                            else "float32"},
      max_batch=SERVE_MAX_BATCH, bucket_frames=BUCKET, device=DEVICE)
  synth = service.synth
  sr = synth.hparams.sampling_rate
  per_synthesis = synth.config.n_flows * synth.config.n_layers
  halo = receptive_halo_frames(synth.config)
  rng = np.random.default_rng(seed + 8)
  mels = {f: rng.uniform(-11.0, 1.0, (80, f)).astype(np.float32)
          for f in FRAMES}
  long_mel = mels[max(FRAMES)]
  solo_seeds = {f: seed + i for i, f in enumerate(FRAMES)}
  burst = [(f, seed + 100 + SERVE_BURST * i + k)
           for i, f in enumerate(FRAMES) for k in range(SERVE_BURST)]
  t_setup = time.perf_counter()
  warm = service.warmup([max(FRAMES)])

  # -- references, by the Synthesizer itself, before the counted run
  solo_ref = {f: synth.infer_serving(mels[f], seed=s, bucket_frames=BUCKET)
              for f, s in solo_seeds.items()}
  burst_ref = [synth.infer_serving(mels[f], seed=s, bucket_frames=BUCKET)
               for f, s in burst]
  stream_ref = {kind: np.concatenate([p for _, p in synth.stream(
      long_mel, seed=seed, chunk_frames=SERVE_STREAM_CHUNK, pcm16=True,
      denoiser_strength=strength)])
                for kind, strength in (("raw", 0.0),
                                       ("denoised", STREAM_STRENGTH))}
  dispatch_rows = count_dispatches(synth)
  httpd = make_server(service, "127.0.0.1", 0)
  server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  server_thread.start()
  url = f"http://127.0.0.1:{httpd.server_port}"
  client = SynthesisClient(url, timeout_s=SERVE_TIMEOUT_S)
  setup_s = time.perf_counter() - t_setup
  info = {"mode": mode, "card": nvidia_smi_line(), "warmup": warm,
          "setup_s": setup_s}
  try:
    # -- the main path: every request through the daemon, with the launch
    # count read around it
    kl.LAUNCHES = 0
    health = client.health()
    if health["status"] != "ok" or health["model"]["compute_dtype"] != (
        "bfloat16" if mode == "bf16" else "float32"):
      fail(f"serve {mode}: /healthz {health}")
    if "requests" not in client.stats():
      fail(f"serve {mode}: /stats has no request count")

    # solo requests, npy, against infer_serving
    solo_errs = {}
    for f, s in solo_seeds.items():
      got = client.synthesize(mels[f], seed=s)
      solo_errs[f] = float(np.abs(got - solo_ref[f].samples).max())
      if not np.array_equal(got, solo_ref[f].samples):
        fail(f"serve {mode}: the solo {f}-frame response differs from "
             f"infer_serving by {solo_errs[f]}")
    if dispatch_rows != [1] * len(FRAMES):
      fail(f"serve {mode}: solo requests dispatched as {dispatch_rows}")

    # a burst of concurrent requests, arriving while the device is busy
    before = client.stats()
    n_before, launches_before = len(dispatch_rows), kl.LAUNCHES
    with concurrent.futures.ThreadPoolExecutor(len(burst)) as pool:
      with service._device_lock:
        futs = [pool.submit(client.synthesize, mels[f], seed=s)
                for f, s in burst]
        wait_until(lambda: service.in_flight() == len(burst),
                   "the burst to arrive")
      outs = [fut.result(timeout=SERVE_TIMEOUT_S) for fut in futs]
    after = client.stats()
    burst_rows = dispatch_rows[n_before:]
    burst_launches = kl.LAUNCHES - launches_before
    scale = max(float(np.abs(r.samples).max()) for r in burst_ref)
    burst_errs = [float(np.abs(o - r.samples).max())
                  for o, r in zip(outs, burst_ref)]
    bound = SLICE_TOL_REL[mode] * scale
    if after["batches"] - before["batches"] < 1:
      fail(f"serve {mode}: the burst formed no micro-batch: {burst_rows}")
    if max(burst_errs) > bound:
      fail(f"serve {mode}: burst responses differ from their solo calls "
           f"by {max(burst_errs)} > {bound}")
    if burst_launches != expected_launches(burst_rows, [], per_synthesis):
      fail(f"serve {mode}: the burst launched {burst_launches}, expected "
           f"{per_synthesis} x {len(burst_rows)} dispatches")
    info["burst"] = {"dispatch_rows": burst_rows, "launches": burst_launches,
                     "max_abs_vs_solo": max(burst_errs), "bound": bound,
                     "batches": after["batches"] - before["batches"],
                     "batched_requests": (after["batched_requests"]
                                          - before["batched_requests"])}

    # streams, raw and denoised
    stream_errs = {}
    for kind, strength in (("raw", 0.0), ("denoised", STREAM_STRENGTH)):
      got = np.concatenate(list(client.stream(
          long_mel, seed=seed, denoiser_strength=strength)))
      want = stream_ref[kind].astype(np.float32) / 32768.0
      if got.shape != want.shape:
        fail(f"serve {mode}: {kind} stream of {got.shape}, expected "
             f"{want.shape}")
      err = float(np.abs(got - want).max())
      bound = STREAM_TOL_REL[kind] * float(np.abs(want).max())
      stream_errs[kind] = {"max_abs": err, "bound": bound}
      if err > bound:
        fail(f"serve {mode}: {kind} stream differs from Synthesizer.stream "
             f"by {err} > {bound}")
    windows = [stream_windows(max(FRAMES), SERVE_STREAM_CHUNK, halo)] * 2
    info["stream"] = {"against_synthesizer": stream_errs,
                      "windows": windows}

    # admission: a mel over max_frames, then max_queue=1
    try:
      client.synthesize(np.zeros((80, service.max_frames + 1), np.float32))
      fail(f"serve {mode}: a mel over max_frames was served")
    except urllib.error.HTTPError as e:
      e.close()
      if e.code != 413:
        fail(f"serve {mode}: an oversize mel got {e.code}, not 413")
    nowait = SynthesisClient(url, timeout_s=SERVE_TIMEOUT_S, retries_503=0)
    max_queue, service.max_queue = service.max_queue, 1
    shed = []
    try:
      with concurrent.futures.ThreadPoolExecutor(1) as pool:
        with service._device_lock:
          first = pool.submit(nowait.synthesize, mels[200], seed=seed)
          wait_until(lambda: service.in_flight() == 1, "the first request")
          try:
            nowait.synthesize(mels[200], seed=seed + 1)
          except urllib.error.HTTPError as e:
            e.close()
            shed.append(e.code)
        first_wav = first.result(timeout=SERVE_TIMEOUT_S)
      recovered = nowait.synthesize(mels[200], seed=seed + 2)
    finally:
      service.max_queue = max_queue
    if shed != [503] or first_wav.shape != recovered.shape:
      fail(f"serve {mode}: two requests at max_queue=1 gave {shed}")

    # reload other weights, then the first ones back
    before_reload = client.synthesize(mels[200], seed=seed)
    client.reload(paths["other"])
    swapped = client.synthesize(mels[200], seed=seed)
    client.reload(paths["first"])
    restored = client.synthesize(mels[200], seed=seed)
    reload_change = float(np.abs(swapped - before_reload).max())
    if not reload_change > 0 or not np.array_equal(restored, before_reload):
      fail(f"serve {mode}: reload changed the output by {reload_change}, "
           "or the first weights did not come back")
    info["reload"] = {"max_abs_change": reload_change,
                      "reloads": client.stats()["reloads"]}

    # the closed loops
    loops = {}
    for clients in SERVE_CLIENTS:
      reset_windows(service)
      n_before, launches_before = len(dispatch_rows), kl.LAUNCHES
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      baseline = torch.cuda.memory_allocated()
      rec = closed_loop(client, long_mel, clients, SERVE_REQUESTS, seed, sr)
      stats = client.stats()
      rows = dispatch_rows[n_before:]
      launches = kl.LAUNCHES - launches_before
      if launches != expected_launches(rows, [], per_synthesis):
        fail(f"serve {mode}: {clients} clients launched {launches} for "
             f"{len(rows)} dispatches")
      rec.update(p50_s=stats["latency_s"]["p50"],
                 p99_s=stats["latency_s"]["p99"],
                 stats_latency_s=stats["latency_s"],
                 stages_ms=stats["stages_ms"], dispatches=len(rows),
                 mean_rows_a_dispatch=float(np.mean(rows)),
                 dispatch_rows=rows, launches=launches,
                 peak_bytes=torch.cuda.max_memory_allocated(),
                 activation_peak_bytes=(torch.cuda.max_memory_allocated()
                                        - baseline))
      loops[clients] = rec
      log(f"serve {mode} closed loop "
          + json.dumps(dict(rec, card=info["card"])))
    clients = max(SERVE_CLIENTS)
    profile = profile_call(lambda: closed_loop(
        client, long_mel, clients, SERVE_REQUESTS, seed, sr))
    busy = profile["device_busy_ms"]
    profile["idle_share_vs_unprofiled_loop"] = (
        1 - busy / 1e3 / loops[clients]["wall_s"]
        if busy != "not measured" else busy)
    launches = kl.LAUNCHES
    # a reload captures the new weights' denoiser bias: one synthesis
    expected = expected_launches(dispatch_rows, windows + [1, 1],
                                 per_synthesis)
    if launches != expected or launches == 0:
      fail(f"serve {mode}: the daemon launched {launches}, expected "
           f"{expected} ({len(dispatch_rows)} dispatches, {windows} "
           "stream windows, 2 reloads)")
    info.update(launches=launches, dispatches=len(dispatch_rows),
                solo_max_abs=solo_errs, closed_loop=loops,
                profile_8_clients=profile, final_stats=client.stats())
  finally:
    httpd.shutdown()
    httpd.server_close()
    service._batcher.close()
    server_thread.join(SERVE_TIMEOUT_S)
  if server_thread.is_alive():
    fail(f"serve {mode}: the server thread did not stop")

  info["c9"] = c9_check(synth, mels[C9_FRAMES], long_mel, seed)
  log("serve " + json.dumps({k: v for k, v in info.items()
                             if k != "closed_loop"}))
  del service, synth
  torch.cuda.empty_cache()
  return info


# -- phase 9 ---------------------------------------------------------------

def cli_dispatch_rows(frames, bucket: int, batch: int) -> list:
  """Rows of each synthesis dispatch a ``synthesize`` run makes for files
  of these frame counts, in file order. ``--batch 1``: one a file. Else the
  files go in slices of 8 x batch, each slice grouped by padded length
  (``bucket``, 0 for none), each group split into power-of-two batches of
  at most ``batch`` rows, largest first (``serving_many_dispatch``)."""
  if batch == 1:
    return [1] * len(frames)
  rows = []
  for s in range(0, len(frames), 8 * batch):
    groups = {}
    for f in frames[s:s + 8 * batch]:
      padded = -(-f // bucket) * bucket if bucket else f
      groups[padded] = groups.get(padded, 0) + 1
    for padded in sorted(groups):
      left = groups[padded]
      while left:
        b = 1
        while b * 2 <= min(left, batch):
          b *= 2
        rows.append(b)
        left -= b
  return rows


def expected_cli_launches(frames, bucket: int, batch: int,
                          per_synthesis: int) -> int:
  """WN launches of one ``synthesize`` or ``synthesize-wav`` run: the
  Synthesizer's denoiser-bias capture (one synthesis) and one synthesis a
  dispatch."""
  return expected_launches(cli_dispatch_rows(frames, bucket, batch), [1],
                           per_synthesis)


def expected_pcm(wav: np.ndarray) -> np.ndarray:
  """What the synthesis commands write for a waveform: peak-normalized,
  int16."""
  return convert_wav(normalize_wav(np.asarray(wav)), np.int16)


def pcm_mismatch(path: Path, want: np.ndarray, sr: int):
  """None if the wav file at ``path`` holds exactly ``want`` (int16 at
  ``sr`` Hz), else what differs."""
  rate, got = wavfile.read(path)
  if rate != sr or got.dtype != want.dtype or got.shape != want.shape:
    return (f"{path.name}: {rate} Hz {got.dtype} {got.shape}, expected "
            f"{sr} Hz {want.dtype} {want.shape}")
  diff = np.flatnonzero(got != want)
  if diff.size:
    return (f"{path.name}: {diff.size} samples differ, first at {diff[0]}, "
            f"max |diff| {int(np.abs(got.astype(int) - want).max())}")
  return None


def legacy_state_dict(params: dict) -> dict:
  """The params as NVIDIA's state dicts name them (legacy
  ``weight_g``/``weight_v``)."""
  return {k.replace(".parametrizations.weight.original0", ".weight_g")
          .replace(".parametrizations.weight.original1", ".weight_v"): v
          for k, v in params_to_state_dict(params).items()}


def free_port() -> int:
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    return sock.getsockname()[1]


def run_cli(args, log_path: Path, expect_rc: int = 0) -> dict:
  """``waveglow-tpu-torch <args>`` in this process: its wall seconds and,
  where it builds a Synthesizer, the seconds after the first build (the
  file loop). An exit code other than ``expect_rc`` fails the run."""
  built = []
  init = Synthesizer.__init__

  def timed_init(self, *a, **k):
    init(self, *a, **k)
    built.append(time.perf_counter())

  Synthesizer.__init__ = timed_init
  t0 = time.perf_counter()
  try:
    rc = cli_main.run([*map(str, args), "--log", str(log_path)])
  finally:
    Synthesizer.__init__ = init
  t1 = time.perf_counter()
  if rc != expect_rc:
    fail(f"cli {args[0]} exited {rc}, expected {expect_rc}; log {log_path}:\n"
         + log_path.read_text()[-3000:])
  return {"wall_s": t1 - t0, "after_model_s": t1 - built[0] if built else None}


def cli_download(params: dict, hparams: HParams, tmp: Path) -> dict:
  """``download`` of NVIDIA's raw form from a server on 127.0.0.1, then
  the converted npz against the params, bit for bit."""
  srv = tmp / "srv"
  srv.mkdir()
  sd = legacy_state_dict(params)
  raw = srv / "waveglow_256channels_ljs_v3.pt"
  t0 = time.perf_counter()
  torch.save({"model": sd, "iteration": 580000}, str(raw))
  write_s = time.perf_counter() - t0
  hp = derive_hparams_from_state_dict(sd)
  arch = (hp.n_flows, hp.n_layers, hp.n_channels, hp.n_group,
          hp.n_early_every, hp.n_early_size)
  want_arch = (hparams.n_flows, hparams.n_layers, hparams.n_channels,
               hparams.n_group, hparams.n_early_every, hparams.n_early_size)
  if arch != want_arch:
    fail(f"cli: derived architecture {arch}, expected {want_arch}")
  handler = type("Quiet", (http.server.SimpleHTTPRequestHandler,),
                 {"log_message": lambda self, *a: None})
  httpd = http.server.ThreadingHTTPServer(
      ("127.0.0.1", 0), functools.partial(handler, directory=str(srv)))
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  real_download = download.download_pretrained_model
  timed = {}

  def timed_download(*args, **kwargs):
    t = time.perf_counter()
    real_download(*args, **kwargs)
    timed["download_s"] = time.perf_counter() - t

  url, download._NGC_URLS[3] = download._NGC_URLS[3], (
      f"http://127.0.0.1:{httpd.server_port}/{raw.name}")
  download.download_pretrained_model = timed_download
  dest = tmp / "downloaded" / "waveglow.pt"
  try:
    wall = run_cli(["download", dest, "--ver", 3],
                   tmp / "download.log")["wall_s"]
  finally:
    download._NGC_URLS[3] = url
    download.download_pretrained_model = real_download
    httpd.shutdown()
    httpd.server_close()
    thread.join(SERVE_TIMEOUT_S)
  converted = CheckpointWaveglow.load(dest)
  want, got = flatten_tree(params), flatten_tree(converted.state_dict)
  bad = sorted(k for k in want.keys() | got.keys()
               if k not in want or k not in got
               or got[k].dtype != want[k].dtype
               or not np.array_equal(got[k], want[k]))
  if bad or converted.iteration != 580000:
    fail(f"cli: the converted npz differs from the params at {bad[:5]} "
         f"(iteration {converted.iteration})")
  info = {"raw_pt_bytes": raw.stat().st_size, "npz_bytes": dest.stat().st_size,
          "raw_pt_write_s": write_s, "download_s": timed["download_s"],
          "convert_s": wall - timed["download_s"], "command_s": wall,
          "architecture": arch, "params_bit_exact": True, "path": dest}
  log("cli download " + json.dumps({k: v for k, v in info.items()
                                    if k != "path"}))
  return info


def serve_subprocess(pt: Path, npz: Path, mode: str, mel: np.ndarray,
                     seed: int, tmp: Path) -> dict:
  """``python -m waveglow_tpu_torch serve <pt>`` in its own process:
  /healthz, one /synthesize body against this process's infer_serving of
  the same checkpoint, /reload of the .pt refused and of the npz taken,
  then SIGTERM, which must drain and exit 0 within 30 s."""
  dtype = "bfloat16" if mode == "bf16" else "float32"
  port = free_port()
  log_path = tmp / f"serve_{mode}.log"
  ref_synth = Synthesizer(load_checkpoint_any(pt), compute_dtype=dtype,
                          device=DEVICE)
  want = ref_synth.infer_serving(mel, seed=seed, bucket_frames=BUCKET)
  del ref_synth
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  with open(log_path, "w") as out:
    proc = subprocess.Popen(
        [sys.executable, "-m", "waveglow_tpu_torch", "serve", str(pt),
         "--port", str(port), "--compute-dtype", dtype,
         "--log", str(tmp / f"serve_{mode}.cli.log")],
        cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
  info = {"mode": mode}
  try:
    client = SynthesisClient(f"http://127.0.0.1:{port}",
                             timeout_s=SERVE_TIMEOUT_S)
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    while True:
      if proc.poll() is not None:
        fail(f"cli serve {mode} exited {proc.returncode} before answering:\n"
             + log_path.read_text()[-3000:])
      try:
        health = client.health()
        break
      except OSError:
        if time.monotonic() > deadline:
          fail(f"cli serve {mode}: no /healthz within {SERVE_TIMEOUT_S} s")
        time.sleep(0.2)
    info["ready_s"] = time.perf_counter() - t0
    if health["status"] != "ok" or health["model"]["compute_dtype"] != dtype:
      fail(f"cli serve {mode}: /healthz {health}")
    got = client.synthesize(mel, seed=seed)
    if got.shape != want.samples.shape:
      fail(f"cli serve {mode}: body of {got.shape}, expected "
           f"{want.samples.shape}")
    err = float(np.abs(got - want.samples).max())
    bound = SLICE_TOL_REL[mode] * float(np.abs(want.samples).max())
    info.update(bitwise=bool(np.array_equal(got, want.samples)),
                max_abs_vs_in_process=err, bound=bound)
    if err > bound:
      fail(f"cli serve {mode}: the daemon's body differs from infer_serving "
           f"in this process by {err} > {bound}")
    try:
      client.reload(pt)
      fail(f"cli serve {mode}: /reload of a .pt was accepted without "
           "--allow-torch-reload")
    except urllib.error.HTTPError as e:
      refusal = json.loads(e.read()).get("error", "")
      e.close()
      if e.code != 400 or "refusing to hot-swap" not in refusal:
        fail(f"cli serve {mode}: /reload of a .pt got {e.code} {refusal}")
    reloaded = client.reload(npz)
    if reloaded.get("status") != "reloaded" or (
        reloaded.get("iteration") != 580000):
      fail(f"cli serve {mode}: /reload of the npz gave {reloaded}")
    info["reload"] = {"pt": "refused (400)", "npz": reloaded}
    t_term = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
      rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
      fail(f"cli serve {mode}: still running 30 s after SIGTERM")
    info.update(sigterm_exit_s=time.perf_counter() - t_term, exit_code=rc)
    if rc != 0:
      fail(f"cli serve {mode}: exited {rc} after SIGTERM:\n"
           + log_path.read_text()[-3000:])
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.wait()
  return info


def phase_cli(params: dict, hparams: HParams, seed: int, tmp: Path) -> dict:
  """The CLI on the card at full width: ``download`` of NVIDIA's raw form;
  ``synthesize`` from the reference ``.pt`` and the converted npz,
  ``--batch 1`` and ``4``; ``synthesize-wav``; ``serve`` as a subprocess;
  in f32 and bf16. Every file bit for bit against in-process synthesis,
  launches against the count derived from the code."""
  per_synthesis = hparams.n_flows * hparams.n_layers
  sr = hparams.sampling_rate
  pt = tmp / "reference.pt"
  t0 = time.perf_counter()
  export_torch_checkpoint(
      CheckpointWaveglow.from_params(params, hparams, iteration=1), pt)
  info = {"reference_pt_bytes": pt.stat().st_size,
          "reference_pt_write_s": time.perf_counter() - t0}
  dl = cli_download(params, hparams, tmp)
  npz = dl.pop("path")
  info["download"] = dl

  rng = np.random.default_rng(seed)   # phase 4's requests
  mels = [rng.uniform(-11.0, 1.0, (80, f)).astype(np.float32) for f in FRAMES]
  mel_dir = tmp / "mels"
  mel_dir.mkdir()
  names = [f"{i}_{f}" for i, f in enumerate(FRAMES)]
  for name, mel in zip(names, mels):
    np.save(mel_dir / f"{name}.npy", mel)
  audio_s = sum(FRAMES) * UPSAMPLE_STRIDE / sr
  sr_fixture, speech = wavfile.read(FIXTURE)
  cuts = [speech[a:a + n] for a, n in CLI_WAV_CUTS]
  cut_frames = [len(c) // UPSAMPLE_STRIDE + 1 for c in cuts]
  info["modes"] = {}
  for mode in MODES:
    dtype = "bfloat16" if mode == "bf16" else "float32"
    t0 = time.perf_counter()
    synth = Synthesizer(load_checkpoint_any(pt), compute_dtype=dtype,
                        device=DEVICE)
    load_s = time.perf_counter() - t0
    solo = [synth.infer(m, seed=seed, bucket_frames=BUCKET).wav_denoised
            for m in mels]
    many = [r.samples for r in synth.infer_serving_many(
        mels, seeds=[seed] * len(mels), bucket_frames=BUCKET,
        max_batch=CLI_BATCH)]
    rec = {"load_and_construct_s": load_s, "runs": {}}
    launches = 0
    for batch, refs in ((1, solo), (CLI_BATCH, many)):
      expected = expected_cli_launches(FRAMES, BUCKET, batch, per_synthesis)
      outs = {}
      for source, ckpt_path in (("pt", pt), ("npz", npz)):
        out = tmp / f"out_{mode}_{source}_b{batch}"
        kl.LAUNCHES = 0
        times = run_cli(["synthesize", ckpt_path, mel_dir, "--custom-seed",
                         seed, "--batch", batch, "--compute-dtype", dtype,
                         "-out", out], tmp / "synthesize.log")
        got = kl.LAUNCHES
        launches += got
        if got != expected:
          fail(f"cli synthesize {mode} --batch {batch} from the {source}: "
               f"{got} WN launches, expected {expected}")
        for name, ref in zip(names, refs):
          bad = pcm_mismatch(out / f"{name}.wav", expected_pcm(ref), sr)
          if bad:
            fail(f"cli synthesize {mode} --batch {batch} from the {source}: "
                 f"{bad}")
        outs[source] = out
        rec["runs"][f"{source}_batch{batch}"] = {
            **times, "audio_s_per_s": audio_s / times["wall_s"],
            "file_loop_audio_s_per_s": audio_s / times["after_model_s"],
            "launches": got, "expected_launches": expected,
            "dispatch_rows": cli_dispatch_rows(FRAMES, BUCKET, batch)}
      for name in names:
        if ((outs["pt"] / f"{name}.wav").read_bytes()
            != (outs["npz"] / f"{name}.wav").read_bytes()):
          fail(f"cli synthesize {mode} --batch {batch}: {name}.wav from the "
               ".pt and from the npz differ")
    # copy synthesis: two cuts of the speech fixture, outputs beside them
    wav_dir = tmp / f"wavs_{mode}"
    wav_dir.mkdir()
    for i, cut in enumerate(cuts):
      wavfile.write(wav_dir / f"cut{i}.wav", sr_fixture, cut)
    expected = expected_cli_launches(cut_frames, BUCKET, 1, per_synthesis)
    kl.LAUNCHES = 0
    times = run_cli(["synthesize-wav", npz, wav_dir, "--custom-seed", seed,
                     "--compute-dtype", dtype], tmp / "synthesize_wav.log")
    got = kl.LAUNCHES
    launches += got
    if got != expected:
      fail(f"cli synthesize-wav {mode}: {got} WN launches, expected "
           f"{expected}")
    mel_op = MelSTFT(synth.hparams, device=DEVICE)
    for i in range(len(cuts)):
      mel = mel_op.get_mel_from_file(wav_dir / f"cut{i}.wav").cpu().numpy()
      want = expected_pcm(synth.infer(mel, seed=seed,
                                      bucket_frames=BUCKET).wav_denoised)
      bad = pcm_mismatch(wav_dir / f"cut{i}.synthesized.wav", want, sr)
      if bad:
        fail(f"cli synthesize-wav {mode}: {bad}")
    rec["synthesize_wav"] = {**times, "launches": got,
                             "expected_launches": expected,
                             "frames": cut_frames}
    rec["launches"] = launches
    del synth, mel_op
    torch.cuda.empty_cache()
    rec["serve"] = serve_subprocess(pt, npz, mode, mels[-1], seed, tmp)
    log(f"cli {mode} " + json.dumps(dict(rec, card=nvidia_smi_line())))
    info["modes"][mode] = rec
  # phase 10's `synthesize --include-stats` reruns the npz --batch 1 run
  info["files"] = {"mels": str(mel_dir), "npz": str(npz),
                   "npz_batch1": {mode: str(tmp / f"out_{mode}_npz_b1")
                                  for mode in MODES}}
  return info


# -- phase 10 --------------------------------------------------------------

def expected_train_launches(per_forward: int, remat: bool, steps: int,
                            saves: int, val_batches: int,
                            backward_kernels: bool):
  """(forward kernel launches, backward kernel calls) of a training run:
  each step's forward and, with remat, its recompute; one forward a
  validation batch at every save; one backward-kernel call a layer a step
  where the backward runs on the kernels (bf16)."""
  forward = ((2 if remat else 1) * per_forward * steps
             + per_forward * val_batches * saves)
  return forward, per_forward * steps if backward_kernels else 0


def expected_validate_launches(per_synthesis: int, entries: int,
                               checkpoints: int) -> int:
  """WN launches of a ``validate`` run: each checkpoint's Synthesizer
  captures the denoiser bias (one synthesis), then synthesizes each
  entry once."""
  return per_synthesis * (1 + entries) * checkpoints


def validation_dirs_mismatch(out: Path, available, select=None, min_it=None,
                             max_it=None):
  """None if the iteration folders under a ``validate`` output are the
  ones ``filter_checkpoints`` gives for the available iterations (the
  newest alone without a filter), else what differs."""
  if select or min_it is not None or max_it is not None:
    want = filter_checkpoints(list(available), select=select, min_it=min_it,
                              max_it=max_it)
  else:
    want = [max(available)]
  got = sorted(int(p.name) for p in out.iterdir() if p.is_dir())
  return None if got == want else f"iteration folders {got}, expected {want}"


def read_tsv(path: Path) -> list:
  with open(path, newline="") as f:
    return list(csv.DictReader(f, delimiter="\t"))


def validation_metrics(orig: np.ndarray, inferred: np.ndarray):
  """The metric columns of a ``total.csv`` row, as written, computed by the
  port's metric functions from the two mels; the seconds each function
  took; and the two labeled renders."""
  seconds = {}

  def timed_as(name, fn, *args, **kwargs):
    out, seconds[name] = timed(fn, *args, **kwargs)
    return out

  mcd_dtw, pen_dtw, frames_dtw = timed_as(
      "mcd_dtw_s", eval_metrics.get_metrics_mels, orig, inferred)
  mcd, pen, frames = timed_as("mcd_s", eval_metrics.get_metrics_mels, orig,
                              inferred, use_dtw=False)
  cosine = timed_as("cosine_s", eval_metrics.cosine_dist_mels, orig,
                    inferred)
  renders = timed_as("render_s", lambda: (plot_melspec_np(orig),
                                          plot_melspec_np(inferred)))
  raw = make_same_width_by_filling_white([r[0] for r in renders])
  ssim, _ = timed_as("ssim_s",
                     eval_metrics.calculate_structural_similarity_np, *raw)
  row = {"# Difference frames": str(inferred.shape[1] - orig.shape[1]),
         "MFCC DTW MCD": repr(mcd_dtw), "MFCC DTW PEN": repr(pen_dtw),
         "# MFCC DTW frames": str(frames_dtw), "MCD": repr(mcd),
         "PEN": repr(pen), "# Frames": str(frames),
         "Cosine Similarity (Padded)": repr(cosine),
         "Structural Similarity (Padded)": repr(ssim)}
  return row, seconds, [r[1] for r in renders]


def state_mismatch(ckpt: CheckpointWaveglow, state: dict,
                   hparams: HParams) -> list:
  """What of a saved checkpoint differs from ``train()``'s returned state
  (params and Adam leaves in dtype, shape or any bit; the iteration) or
  from the settings ``hparams`` (as the checkpoint stores them)."""
  def leaves(tree):
    return (flatten_tree(tree) if isinstance(tree, dict)
            else dict(enumerate(tree)))

  bad = []
  for name, got, want in (("params", ckpt.state_dict, state["params"]),
                          ("optimizer", ckpt.optimizer or [],
                           state["opt_state"])):
    got, want = leaves(got), leaves(want)
    bad += [f"{name}/{k}" for k in sorted(set(got) | set(want), key=str)
            if k not in got or k not in want
            or np.asarray(got[k]).dtype != np.asarray(want[k]).dtype
            or np.shape(got[k]) != np.shape(want[k])
            or np.asarray(got[k]).tobytes() != np.asarray(want[k]).tobytes()]
  if ckpt.iteration != state["step"]:
    bad.append(f"iteration {ckpt.iteration} != {state['step']}")
  if ckpt.hparams != json.loads(json.dumps(dataclasses.asdict(hparams))):
    bad.append("hparams")
  return bad


def write_val_wavs(folder: Path) -> list:
  """The validation set: the whole speech fixture, its first half and
  phase 9's two cuts."""
  sr, speech = wavfile.read(FIXTURE)
  folder.mkdir(parents=True)
  wavfile.write(folder / "whole.wav", sr, speech)
  wavfile.write(folder / "half.wav", sr, speech[:len(speech) // 2])
  for i, (start, n) in enumerate(CLI_WAV_CUTS):
    wavfile.write(folder / f"cut{i}.wav", sr, speech[start:start + n])
  return load_dataset(folder)


def timed(fn, *args, **kwargs):
  t0 = time.perf_counter()
  out = fn(*args, **kwargs)
  return out, time.perf_counter() - t0


def time_entry_writes(mel_op: MelSTFT, wav_path: Path, wav: np.ndarray,
                      orig: np.ndarray, inferred: np.ndarray, labeled,
                      scratch: Path) -> float:
  """Seconds of one ``validate`` entry's file writes (two wavs, two mels,
  four PNGs), made again into ``scratch``."""
  t0 = time.perf_counter()
  scratch.mkdir(parents=True, exist_ok=True)
  float_to_wav(mel_op.get_wav_from_file(wav_path), scratch / "o.wav")
  float_to_wav(wav, scratch / "i.wav")
  np.save(scratch / "o.mel.npy", orig)
  np.save(scratch / "i.mel.npy", inferred)
  diff = eval_metrics.abs_diff_image(*make_same_width_by_filling_white(
      labeled))
  for name, img in (("o", labeled[0]), ("i", labeled[1]), ("d", diff)):
    save_image(scratch / f"{name}.png", img)
  save_image(scratch / "c.png", stack_images_vertically([*labeled, diff]))
  return time.perf_counter() - t0


def phase_cli_train(mode: str, seed: int, tmp: Path, files: dict) -> dict:
  """``train``, ``continue-train``, ``validate`` and ``synthesize
  --include-stats`` from the command line at full width. The checkpoints
  against an in-process ``train()`` bit for bit, the validation wavs
  against in-process synthesis bit for bit, every report row against the
  metric functions on the saved mels, launches against the counts the code
  gives."""
  t_start = time.perf_counter()
  dtype = "bfloat16" if mode == "bf16" else "float32"
  # what continue-train ends with, and one train() call takes at once
  custom = dict(parse_custom_hparams(CLI_TRAIN_HPARAMS.format(epochs=2)),
                compute_dtype=dtype)
  hp = overwrite_custom_hparams(HParams(), custom)
  config = WaveGlowConfig.from_hparams(hp)
  per_forward = config.n_flows * config.n_layers
  sr = hp.sampling_rate
  work = tmp / f"cli_train_{mode}"
  train_dir, val_dir, ckpts = work / "train", work / "val", work / "ckpts"
  logs = work / "logs"
  entries = write_wavs(train_dir, seed)
  val_entries = write_val_wavs(val_dir)
  steps = N_WAVS // hp.batch_size       # a step and a save each, an epoch
  val_batches = -(-len(val_entries) // hp.batch_size)
  want_train = expected_train_launches(per_forward, hp.remat, steps, steps,
                                       val_batches, mode == "bf16")
  info = {"mode": mode, "walls_s": {}, "launches": {}, "seconds": {}}
  last = [t_start]

  def lap(name):
    """Seconds since the previous lap, recorded under ``name``."""
    now = time.perf_counter()
    info["seconds"][name] = now - last[0]
    last[0] = now

  def train_cmd(command, epochs, *extra):
    return [command, train_dir, val_dir, ckpts, "--custom-hparams",
            CLI_TRAIN_HPARAMS.format(epochs=epochs), "--compute-dtype", dtype,
            "--tl-dir", logs, *extra]

  def command(name, args, expected, expect_rc=0):
    """Run a command with the counts at 0; its wall and its launches,
    (forward, backward) against ``expected``."""
    kl.LAUNCHES = kl.BWD_LAUNCHES = 0
    wall = run_cli(args, work / f"{name}.log", expect_rc)["wall_s"]
    got = (kl.LAUNCHES, kl.BWD_LAUNCHES)
    if got != expected:
      fail(f"cli {name} {mode}: (forward, backward) launches {got}, "
           f"expected {expected}")
    info["walls_s"][name] = wall
    info["launches"][name] = got
    return wall

  lap("data")
  # -- train: epoch 1, traced
  command("train", train_cmd("train", 1, "--profile-dir", work / "trace"),
          want_train)
  if get_all_checkpoint_iterations(ckpts) != [1, 2]:
    fail(f"cli train {mode}: checkpoints "
         f"{get_all_checkpoint_iterations(ckpts)}, expected [1, 2]")
  lap("train")
  trace_path = work / "trace" / "trace.json"
  trace = trace_path.read_bytes()
  wn_events = trace.count(b"wn_layer_kernel")
  info["trace"] = {"bytes": len(trace),
                   "wn_kernel_name_occurrences": wn_events}
  if not trace.lstrip().startswith(b"{") or not wn_events:
    fail(f"cli train {mode}: the --profile-dir trace names no WN kernel")
  del trace
  shutil.rmtree(work / "trace")
  lap("trace_check")
  # -- train again without --auto-resume: refused, checkpoints untouched
  before = {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in ckpts.iterdir()}
  command("train_refused", train_cmd("train", 1), (0, 0), expect_rc=1)
  if {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
      for p in ckpts.iterdir()} != before:
    fail(f"cli train {mode}: the refused run touched the checkpoints")
  lap("train_refused")
  # -- continue-train: epoch 2
  command("continue_train", train_cmd("continue-train", 2), want_train)
  lap("continue_train")
  available = get_all_checkpoint_iterations(ckpts)
  step_its = [r["iteration"] for r in read_metrics(logs)
              if r["event"] == "train_step"]
  if available != [1, 2, 3, 4] or step_its != [1, 2, 3, 4]:
    fail(f"cli continue-train {mode}: checkpoints {available}, train_step "
         f"events {step_its}, expected [1, 2, 3, 4] both")
  # -- the same settings in one train() call: checkpoint 4 bit for bit
  state = train(custom, None, entries, val_entries, work / "ref_ck",
                max_iterations=4, device=DEVICE)
  shutil.rmtree(work / "ref_ck")
  lap("reference_train")
  loaded = {4: CheckpointWaveglow.load(ckpts / "4.npz")}
  bad = state_mismatch(loaded[4], state, hp)
  if bad:
    fail(f"cli train {mode}: checkpoint 4 differs from train() in this "
         f"process at {bad[:5]} ({len(bad)} leaves)")
  info["checkpoint_4_bit_exact"] = True
  del state
  torch.cuda.empty_cache()
  lap("checkpoint_compare")

  # -- validate: the newest checkpoint, then every CLI_SELECT-th
  runs = {"validate": ([], 1), "validate_select": (
      ["--select", CLI_SELECT], len(filter_checkpoints(available,
                                                       select=CLI_SELECT)))}
  for name, (extra, n_ckpts) in runs.items():
    command(name, ["validate", ckpts, work / name, val_dir, "--full-run",
                   "--custom-seed", seed, "--compute-dtype", dtype, *extra],
            (expected_validate_launches(per_forward, len(val_entries),
                                        n_ckpts), 0))
    bad = validation_dirs_mismatch(work / name, available,
                                   select=CLI_SELECT if extra else None)
    if bad:
      fail(f"cli {name} {mode}: {bad}")
    lap(name)
  want_metrics, rows_checked, split = {}, 0, {}
  for it in sorted({int(p.name) for name in runs
                    for p in (work / name).iterdir() if p.is_dir()},
                   reverse=True):
    ckpt = loaded.pop(it, None) or load_checkpoint_any(ckpts / f"{it}.npz")
    synth = Synthesizer(ckpt, compute_dtype=dtype, device=DEVICE)
    del ckpt
    mel_op = MelSTFT(synth.hparams, device=DEVICE)
    pcm = {}
    for entry in val_entries:
      mel = mel_op.get_mel(mel_op.get_wav_from_file(
          entry.wav_absolute_path)).cpu().numpy()
      result, synth_s = timed(synth.infer, mel, seed=seed)
      wav = normalize_wav(result.wav_denoised)
      _, mel_s = timed(lambda: mel_op.get_mel(wav).cpu().numpy())
      pcm[entry.stem] = convert_wav(wav, np.int16)
      if it == max(available) and entry.stem == "whole":
        # validate's steps for this entry, timed one by one: synthesis
        # (infer waits for the card) and the wav's mel back on the host
        # here, the metrics on its saved mels below
        split.update(frames=mel.shape[1], synthesis_s=synth_s, mel_s=mel_s,
                     wav=wav)
    for name in runs:
      if not (work / name / str(it)).is_dir():
        continue
      rows = read_tsv(work / name / str(it) / "total.csv")
      if sorted(r["Subpath"] for r in rows) != sorted(pcm):
        fail(f"cli {name} {mode}: iteration {it} rows {rows}")
      for row in rows:
        dest = work / name / str(it) / row["Subpath"]
        bad = pcm_mismatch(dest / "inferred_denoised.wav", pcm[row["Subpath"]],
                           sr)
        if bad:
          fail(f"cli {name} {mode}: iteration {it}: {bad}")
        key = (it, row["Subpath"])
        if key not in want_metrics:
          orig = np.load(dest / "original.mel.npy")
          inferred = np.load(dest / "inferred_denoised.mel.npy")
          want_metrics[key], seconds, labeled = validation_metrics(orig,
                                                                   inferred)
          if "wav" in split and key == (max(available), "whole"):
            split.update(seconds, file_writes_s=time_entry_writes(
                mel_op, next(e.wav_absolute_path for e in val_entries
                             if e.stem == "whole"), split.pop("wav"), orig,
                inferred, labeled, work / "split"))
        got = {k: row[k] for k in want_metrics[key]}
        if got != want_metrics[key] or row["Iteration"] != str(it):
          fail(f"cli {name} {mode}: iteration {it} {row['Subpath']}: row "
               f"{got}, the metric functions give {want_metrics[key]}")
        rows_checked += 1
    del synth, mel_op
    torch.cuda.empty_cache()
  for name in runs:
    per_it = [r for p in sorted((p for p in (work / name).iterdir()
                                 if p.is_dir()), key=lambda p: int(p.name))
              for r in read_tsv(p / "total.csv")]
    if read_tsv(work / name / "total.csv") != per_it:
      fail(f"cli {name} {mode}: the top-level total.csv is not the "
           "iterations' rows in order")
  split["sum_s"] = sum(v for k, v in split.items() if k.endswith("_s"))
  info["validate_split_826"] = split
  info["rows_checked"] = rows_checked
  info["rows_recomputed"] = len(want_metrics)
  shutil.rmtree(ckpts)   # about 1 GB a checkpoint
  lap("validate_checks")   # the split on the 826-frame entry included

  # -- synthesize --include-stats: phase 9's npz --batch 1 run, with stats
  out = work / "stats"
  command("synthesize_stats",
          ["synthesize", files["npz"], files["mels"], "--custom-seed", seed,
           "--compute-dtype", dtype, "--include-stats", "-out", out],
          (expected_cli_launches(FRAMES, BUCKET, 1, per_forward), 0))
  ref = Path(files["npz_batch1"][mode])
  for wav in sorted(ref.glob("*.wav")):
    if (out / wav.name).read_bytes() != wav.read_bytes():
      fail(f"cli synthesize --include-stats {mode}: {wav.name} differs "
           "from phase 9's")
  rows = read_tsv(out / "stats.csv")
  want_cols = [f.name for f in dataclasses.fields(InferenceEntry)]
  if (len(rows) != len(FRAMES) or list(rows[0]) != want_cols
      or sorted(Path(r["mel_path"]).name for r in rows)
      != sorted(p.name for p in Path(files["mels"]).glob("*.npy"))):
    fail(f"cli synthesize --include-stats {mode}: stats.csv has "
         f"{len(rows)} rows, columns {list(rows[0]) if rows else None}")
  info["stats_rows"] = len(rows)
  lap("synthesize_stats")
  info["phase_s"] = time.perf_counter() - t_start
  info["forward_launches"] = sum(info["launches"][k][0] for k in
                                 ("train", "continue_train"))
  info["backward_launches"] = sum(info["launches"][k][1] for k in
                                  ("train", "continue_train"))
  info["synthesis_launches"] = sum(info["launches"][k][0] for k in
                                   ("validate", "validate_select",
                                    "synthesize_stats"))
  log(f"cli_train {mode} " + json.dumps(dict(info, card=nvidia_smi_line())))
  return info


# -- phase 11 --------------------------------------------------------------

def shard_cost(batch: int, t: int, cp: int, last: bool, mode: str,
               width: int):
  """(bytes, flops, bound_ms, bound_by) of one shard-kernel call holding
  ``cp`` of the C = ``width`` gate channels: x, cond_s and the weights read
  once, the partial written once; flops of its two products,
  2 * B * T * (3C * 2C' + C' * n_rs)."""
  C = width
  esize = 2 if mode == "bf16" else 4
  rs = C if last else 2 * C
  rows = batch * t
  nbytes = (rows * C * 4                          # x
            + rows * 2 * cp * esize               # cond_s
            + (3 * C * 2 * cp + cp * rs) * esize  # w_in_s, w_rs_s
            + 2 * cp * 4                          # b_in_s
            + rows * rs * 4)                      # the partial written
  flops = 2 * rows * (3 * C * 2 * cp + cp * rs)
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[mode] * 1e3
  return nbytes, flops, max(t_bytes, t_ops), (
      "bytes" if t_bytes >= t_ops else "operations")


def shard_slices(args, model: int, rank: int):
  """Rank ``rank``'s (cond_s, w_in_s, b_in_s, w_rs_s) of a full layer's
  inputs, cut as ``parallel.sharding.shard_params`` cuts the params."""
  _, cond, w_in, b_in, w_rs, _ = args
  C = args[0].shape[-1]
  cp = C // model
  cols = slice(rank * cp, (rank + 1) * cp)
  lead = cond.shape[:2]
  return (cond.reshape(*lead, 2, C)[..., cols].reshape(*lead, 2 * cp)
          .contiguous(),
          w_in.reshape(3, C, 2, C)[..., cols].reshape(3, C, 2 * cp)
          .contiguous(),
          b_in.reshape(2, C)[:, cols].reshape(-1).contiguous(),
          w_rs.reshape(C, -1)[cols].contiguous())


def expected_mesh_launches(axis: str, size: int, rows: int, frames: int,
                           per_synthesis: int) -> dict:
  """WN launches of one synthesis of ``rows`` rows and ``frames`` frames
  on a mesh axis of ``size``: "fused" (the WN kernel) and "shard" (the
  shard kernel). Data: one synthesis a row group (``size`` groups when the
  rows divide, else one); time: one a non-empty span; model: the shard
  kernel once a rank and layer, the WN kernel never."""
  if axis == "data":
    groups = size if rows % size == 0 else 1
    return {"fused": per_synthesis * groups, "shard": 0}
  if axis == "time":
    return {"fused": per_synthesis * min(size, frames), "shard": 0}
  if axis == "model":
    return {"fused": 0, "shard": per_synthesis * size}
  raise ValueError(f"unknown mesh axis {axis!r}")


def stitch_faults(windows, frames: int, halo: int) -> list:
  """What is wrong with a time split's ``(start, end, lo, hi)`` windows
  (``parallel.time_shard.span_windows``), if anything: the spans must
  cover [0, frames) in order without gap or overlap, each within one frame
  of the others, and each window must hold its span with ``halo`` frames a
  side, clipped to the utterance."""
  out, pos = [], 0
  lengths = []
  for start, end, lo, hi in windows:
    if start != pos:
      out.append(f"span at {start}, expected {pos}")
    if end <= start:
      out.append(f"empty span at {start}")
    if lo != max(0, start - halo) or hi != min(frames, end + halo):
      out.append(f"window [{lo}, {hi}) of span [{start}, {end})")
    lengths.append(end - start)
    pos = end
  if pos != frames:
    out.append(f"spans end at {pos}, expected {frames}")
  if lengths and max(lengths) - min(lengths) > 1:
    out.append(f"span lengths {lengths} differ by more than one")
  return out


def shard_kernel_check(mode: str, seed: int, width: int = C) -> dict:
  """The shard kernel against its plain version at every C' of ``width``
  (d=1, d=128, the last layer) and the ranks' partials summed against the
  unsharded kernel's res/skip, and a second launch of each rank against
  the first, bit for bit; times at d=1 beside the bound, the plain
  version, the library's sharded layer (cuDNN conv1d, the gate, cuBLAS
  matmul) and, in f32, the kernel's time before its redesign
  (``SHARD_F32_EARLIER_MS``, a read-out)."""
  cdt = MODES[mode]
  dtype = cdt or torch.float32
  cases, timed = [], {}
  for i, (dilation, last) in enumerate(((1, False), (128, False),
                                        (LAST_DILATION, True))):
    args, _, _ = layer_inputs(1, T_KERNEL, last, dtype, seed + 50 + i, width)
    xk, sk = kl.wn_layer_fused(*args, dilation, compute_dtype=cdt)
    full = sk if last else torch.cat([xk - args[0], sk], dim=-1)
    full_scale = full.abs().max().item()
    for c, cp in kl.shard_pairs():
      if c != width:
        continue
      model = width // cp
      total, err, scale, repeats = None, 0.0, 0.0, True
      for rank in range(model):
        sl = shard_slices(args, model, rank)
        got = kl.wn_layer_shard(args[0], *sl, dilation, compute_dtype=cdt)
        again = kl.wn_layer_shard(args[0], *sl, dilation, compute_dtype=cdt)
        torch.cuda.synchronize()
        repeats = repeats and torch.equal(got, again)
        del again
        ref = kl.wn_layer_shard_plain(args[0], *sl, dilation,
                                      compute_dtype=cdt)
        if not torch.isfinite(got).all():
          fail(f"mesh {mode}: shard kernel output not finite (C'={cp})")
        err = max(err, (got - ref).abs().max().item())
        scale = max(scale, ref.abs().max().item())
        total = got if total is None else total + got
      bound = KERNEL_TOL_F32 if mode == "f32" else KERNEL_TOL_BF16_REL * scale
      sum_err = (total + args[5] - full).abs().max().item()
      sum_bound = (KERNEL_TOL_F32 if mode == "f32"
                   else KERNEL_TOL_BF16_REL * full_scale)
      rec = {"mode": mode, "C": width, "C'": cp, "dilation": dilation,
             "last": last,
             "max_abs_err": err, "bound": bound, "ref_max_abs": scale,
             "summed_vs_fused_max_abs": sum_err,
             "summed_bound": sum_bound, "repeat_bitwise": repeats}
      if err > bound or sum_err > sum_bound:
        fail(f"mesh {mode}: shard kernel disagrees: {rec}")
      if not repeats:
        fail(f"mesh {mode}: two shard kernel launches differ: {rec}")
      if dilation == 1:
        sl = shard_slices(args, model, 0)
        nbytes, flops, bound_ms, bound_by = shard_cost(1, T_KERNEL, cp,
                                                       last, mode, width)
        rec["kernel_ms"] = cuda_ms(lambda: kl.wn_layer_shard(
            args[0], *sl, 1, compute_dtype=cdt))
        rec["plain_ms"] = cuda_ms(lambda: kl.wn_layer_shard_plain(
            args[0], *sl, 1, compute_dtype=cdt))
        x_cf = args[0].to(dtype).transpose(1, 2).contiguous()
        w_conv = sl[1].permute(2, 1, 0).contiguous()   # [2C', C, 3]
        b_lib = sl[2].to(dtype)
        rec["library_ms"] = cuda_ms(lambda: library_layer(
            x_cf, sl[0], w_conv, b_lib, sl[3], None, 1, dtype))
        rec.update(bytes=nbytes, flops=flops, bound_ms=bound_ms,
                   bound_by=bound_by,
                   share_of_bound=bound_ms / rec["kernel_ms"])
        if mode == "f32":
          rec["earlier_ms"] = SHARD_F32_EARLIER_MS[(width, cp)]
        elif width == kl.WIDE_C:
          # the layer's round, gate and res/skip kernels at gate width C'
          rec["kernels_ms"] = kernel_split(lambda: kl.wn_layer_shard(
              args[0], *sl, 1, compute_dtype=cdt), FWD_SPLIT, 3)
        timed[cp] = rec
      log("shard kernel " + json.dumps(rec))
      cases.append(rec)
    del args, xk, sk, full
  torch.cuda.empty_cache()
  return {"cases": cases, "timed": timed}


def shard_extra_keys(timed: dict, top: int) -> dict:
  """The ``kernels`` line's keys of a shard entry beside its ``top`` C':
  each other C''s times and bound (and its per-kernel split where it was
  taken), all of this run (never the earlier times of
  ``SHARD_F32_EARLIER_MS``, which only the shard check prints)."""
  return {f"{key}_C'{cp}": timed[cp][key]
          for cp in sorted(timed, reverse=True) if cp != top
          for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                      "kernels_ms") if key in timed[cp]}


def annotate_reduce():
  """Wrap the model axis's reduce in a profiler range named
  ``reduce_partials``, so a profile can read its device time; returns the
  undo."""
  from waveglow_tpu_torch.models import wn as wn_module
  original = wn_module.reduce_partials

  def annotated(partials):
    with torch.profiler.record_function("reduce_partials"):
      return original(partials)

  wn_module.reduce_partials = annotated

  def undo():
    wn_module.reduce_partials = original
  return undo


def range_device_ms(fn, name: str) -> dict:
  """:func:`profile_call` of ``fn``, plus the device time of the kernels
  launched inside the profiler ranges called ``name`` ("not measured" when
  the profiler reports none)."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  ms = sum(ev.device_time_total for ev in prof.key_averages()
           if ev.key == name
           and ev.device_type == torch.autograd.DeviceType.CPU) / 1e3
  return ms if ms > 0 else "not measured"


def host_enqueue_s(synth: Synthesizer, mel: np.ndarray, seed: int) -> dict:
  """Host seconds to enqueue one serving dispatch (the call returns
  without waiting), then to its result."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  dispatched = synth.serving_dispatch(mel, seed=seed, bucket_frames=BUCKET)
  enqueue = time.perf_counter() - t0
  synth.serving_finalize(dispatched)
  return {"enqueue_s": enqueue, "result_s": time.perf_counter() - t0}


def logical_devices(n: int) -> list:
  """``cuda:0`` listed ``n`` times: a mesh that runs every sharded path
  on the one card, its shards one after another."""
  return [torch.device("cuda", 0)] * n


def phase_mesh(ckpt: CheckpointWaveglow, paths: dict, mode: str,
               seed: int) -> dict:
  """Sharded serving on logical meshes of the one card (phase 11)."""
  dtype_name = "bfloat16" if mode == "bf16" else "float32"
  t_phase = time.perf_counter()
  kernel = shard_kernel_check(mode, seed)
  tol = SLICE_TOL_REL[mode]
  rng = np.random.default_rng(seed + 11)
  config = WaveGlowConfig.from_hparams(ckpt.get_hparams())
  per_synthesis = config.n_flows * config.n_layers
  frames = max(FRAMES)
  rng4 = np.random.default_rng(seed)   # phase 4's requests
  req = [rng4.uniform(-11.0, 1.0, (80, f)).astype(np.float32)
         for f in FRAMES][-1]
  info = {"mode": mode, "card": nvidia_smi_line(), "shard_kernel": kernel,
          "note": "logical meshes of one card: shards run one after "
                  "another, so these times check paths, not speedups"}
  counts = {"fused": 0, "shard": 0}

  def counted(fn):
    """Run ``fn`` with both launch counts set to 0 just before; add what
    it launched to the phase's counts and return them with its result."""
    kl.LAUNCHES = kl.SHARD_LAUNCHES = 0
    out = fn()
    got = {"fused": kl.LAUNCHES, "shard": kl.SHARD_LAUNCHES}
    for k in counts:
      counts[k] += got[k]
    return out, got

  # -- data: MESH_BATCH rows of the longest request over data = 2 and 4
  plain = BatchSynthesizer(ckpt, compute_dtype=dtype_name, device=DEVICE)
  mels8 = rng.uniform(-11.0, 1.0, (MESH_BATCH, 80, frames)).astype(
      np.float32)
  seeds8 = [seed + (b << 32) for b in range(MESH_BATCH)]
  ref8 = plain._infer(mels8, 1.0, seeds8)
  scale8 = float(np.abs(ref8).max())
  data = {}
  for d in (2, 4):
    synth = BatchSynthesizer(ckpt, compute_dtype=dtype_name,
                             mesh=make_mesh(data=d,
                                            devices=logical_devices(d)))
    if d == 4:
      data_synth = synth   # kept for infer_many
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav, got = counted(lambda: synth.infer_batch(mels8, seed=seed))
    wall = time.perf_counter() - t0
    want = expected_mesh_launches("data", d, MESH_BATCH, frames,
                                  per_synthesis)
    if got != want:
      fail(f"mesh {mode}: data={d} launched {got}, expected {want}")
    n = MESH_BATCH // d
    for g in range(d):
      rows = slice(g * n, (g + 1) * n)
      if not np.array_equal(wav[rows], plain._infer(mels8[rows], 1.0,
                                                     seeds8[rows])):
        fail(f"mesh {mode}: data={d} rows {rows} differ from an unsharded "
             "call on the same rows")
    err = float(np.abs(wav - ref8).max())
    if not np.isfinite(wav).all() or err > tol * scale8:
      fail(f"mesh {mode}: data={d} batch vs the 8-row call {err} > "
           f"{tol * scale8}")
    data[d] = {"launches": got, "wall_s": wall, "vs_8_row_max_abs": err,
               "bound": tol * scale8}
    del synth
  lengths = MESH_MANY
  many = [rng.uniform(-11.0, 1.0, (80, f)).astype(np.float32)
          for f in lengths]
  outs, _ = counted(lambda: data_synth.infer_many(many, seed=seed,
                                                  bucket_frames=BUCKET))
  refs = plain.infer_many(many, seed=seed, bucket_frames=BUCKET)
  # a bucket's rows run in groups of another size than unsharded: the same
  # numbers up to the rounding of differently shaped products
  many_scale = max(float(np.abs(r).max()) for r in refs)
  many_err = 0.0
  for f, out, ref in zip(lengths, outs, refs):
    if out.shape != (f * UPSAMPLE_STRIDE,) or not np.isfinite(out).all():
      fail(f"mesh {mode}: infer_many on data=4 gave the {f}-frame row "
           f"shape {out.shape}")
    many_err = max(many_err, float(np.abs(out - ref).max()))
  if many_err > tol * many_scale:
    fail(f"mesh {mode}: infer_many on data=4 vs unsharded {many_err} > "
         f"{tol * many_scale}")
  data["infer_many"] = {"lengths": list(lengths),
                        "vs_unsharded_max_abs": many_err,
                        "bound": tol * many_scale}
  del data_synth
  info["data"] = data

  # -- time: infer_long over time = 2 and 4, at MESH_LONG frames
  long = rng.uniform(-11.0, 1.0, (80, max(MESH_LONG))).astype(np.float32)
  halo = receptive_halo_frames(config)
  time_info = {}
  refs = {n_frames: plain.infer_batch(long[None, :, :n_frames], seed=seed)[0]
          for n_frames in MESH_LONG}
  for n in (2, 4):
    synth = BatchSynthesizer(ckpt, compute_dtype=dtype_name,
                             mesh=make_time_mesh(n,
                                                 devices=logical_devices(n)))
    for n_frames in MESH_LONG:
      mel, ref = long[:, :n_frames], refs[n_frames]
      faults = stitch_faults(span_windows(n_frames, n, halo), n_frames,
                             halo)
      if faults:
        fail(f"mesh {mode}: time split of {n_frames} over {n}: {faults}")
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      wav, got = counted(lambda: synth.infer_long(mel, seed=seed))
      wall = time.perf_counter() - t0
      want = expected_mesh_launches("time", n, 1, n_frames, per_synthesis)
      if got != want:
        fail(f"mesh {mode}: time={n} launched {got}, expected {want}")
      if not np.array_equal(wav, ref):
        fail(f"mesh {mode}: infer_long of {n_frames} frames over time={n} "
             f"differs from the unsharded call by "
             f"{float(np.abs(wav - ref).max())}")
      time_info[f"{n_frames}x{n}"] = {"launches": got, "wall_s": wall,
                                      "bit_for_bit": True}
    del synth
  info["time"] = time_info
  del plain
  torch.cuda.empty_cache()

  # -- model: Synthesizer over model = 2, 4 and (data 2, model 2)
  unsharded = Synthesizer(ckpt, compute_dtype=dtype_name, device=DEVICE)
  micro = [rng.uniform(-11.0, 1.0, (80, f)).astype(np.float32)
           for f in MESH_MICRO]
  micro_seeds = [seed + 20 + i for i in range(4)]
  ref_req = unsharded.infer_serving(req, seed=seed, bucket_frames=BUCKET)
  ref_micro = unsharded.infer_serving_many(micro, seeds=micro_seeds,
                                           bucket_frames=BUCKET)
  ref_stream = np.concatenate([p for _, p in unsharded.stream(
      req, seed=seed, chunk_frames=STREAM_CHUNK)])
  paths_info = {"unsharded": {
      "profile": profile_call(lambda: unsharded.infer_serving(
          req, seed=seed, bucket_frames=BUCKET)),
      "enqueue": host_enqueue_s(unsharded, req, seed)}}
  model_info = {}
  for d, m in ((1, 2), (1, 4), (2, 2)):
    synth = Synthesizer(ckpt, compute_dtype=dtype_name,
                        mesh=make_mesh(data=d, model=m,
                                       devices=logical_devices(d * m)))
    synth.infer_serving(req, seed=seed, bucket_frames=BUCKET)   # warm-up
    res, got = counted(lambda: synth.infer_serving(req, seed=seed,
                                                   bucket_frames=BUCKET))
    want = expected_mesh_launches("model", m, 1, frames, per_synthesis)
    if got != want:
      fail(f"mesh {mode}: model={m} dispatch launched {got}, expected {want}")
    scale = float(np.abs(ref_req.samples).max())
    err = float(np.abs(res.samples - ref_req.samples).max())
    if not np.isfinite(res.samples).all() or err > tol * scale:
      fail(f"mesh {mode}: ({d}, {m}) {frames}-frame request vs unsharded "
           f"{err} > {tol * scale}")
    rows = count_dispatches(synth)
    outs, got_micro = counted(lambda: synth.infer_serving_many(
        micro, seeds=micro_seeds, bucket_frames=BUCKET))
    rows = list(rows)
    want_micro = {"fused": 0, "shard": sum(
        expected_mesh_launches("data", d, r, frames, per_synthesis)["fused"]
        for r in rows) * m}
    if got_micro != want_micro:
      fail(f"mesh {mode}: ({d}, {m}) micro-batch launched {got_micro}, "
           f"expected {want_micro}")
    micro_err = max(float(np.abs(o.samples - r.samples).max())
                    for o, r in zip(outs, ref_micro))
    micro_scale = max(float(np.abs(r.samples).max()) for r in ref_micro)
    if micro_err > tol * micro_scale:
      fail(f"mesh {mode}: ({d}, {m}) micro-batch vs unsharded {micro_err}")
    rec = {"launches": got, "micro_launches": got_micro,
           "micro_dispatch_rows": list(rows),
           "vs_unsharded_max_abs": err, "bound": tol * scale,
           "micro_vs_unsharded_max_abs": micro_err}
    if (d, m) == (1, 2):
      stream, got_stream = counted(lambda: np.concatenate(
          [p for _, p in synth.stream(req, seed=seed,
                                      chunk_frames=STREAM_CHUNK)]))
      windows = stream_windows(frames, STREAM_CHUNK, halo)
      if got_stream != {"fused": 0, "shard": per_synthesis * m * windows}:
        fail(f"mesh {mode}: model=2 stream launched {got_stream}")
      stream_err = float(np.abs(stream - ref_stream).max())
      stream_scale = float(np.abs(ref_stream).max())
      if stream.shape != ref_stream.shape or stream_err > tol * stream_scale:
        fail(f"mesh {mode}: model=2 stream vs unsharded {stream_err}")
      rec.update(stream_launches=got_stream, stream_vs_unsharded=stream_err)
      undo = annotate_reduce()
      try:
        rec["reduce_device_ms"] = range_device_ms(
            lambda: synth.infer_serving(req, seed=seed,
                                        bucket_frames=BUCKET),
            "reduce_partials")
      finally:
        undo()
    rec["profile"] = profile_call(lambda: synth.infer_serving(
        req, seed=seed, bucket_frames=BUCKET))
    rec["enqueue"] = host_enqueue_s(synth, req, seed)
    busy = rec["profile"]["device_busy_ms"]
    if (d, m) == (1, 2) and busy != "not measured" and (
        rec["reduce_device_ms"] != "not measured"):
      rec["reduce_share_of_busy"] = rec["reduce_device_ms"] / busy
    model_info[f"{d}x{m}"] = rec
    log(f"mesh {mode} model {d}x{m} " + json.dumps(
        {k: v for k, v in rec.items() if k != "profile"}))
    del synth
  info["model"] = model_info
  torch.cuda.empty_cache()

  # -- the paths' wall, device busy and host enqueue, one dispatch each
  for name, mesh in (("data2", make_mesh(data=2,
                                          devices=logical_devices(2))),
                     ("time2", make_time_mesh(2,
                                              devices=logical_devices(2)))):
    synth = Synthesizer(ckpt, compute_dtype=dtype_name, mesh=mesh)
    synth.infer_serving(req, seed=seed, bucket_frames=BUCKET)   # warm-up
    paths_info[name] = {
        "profile": profile_call(lambda: synth.infer_serving(
            req, seed=seed, bucket_frames=BUCKET)),
        "enqueue": host_enqueue_s(synth, req, seed)}
    del synth
  paths_info["model2"] = {k: model_info["1x2"][k]
                          for k in ("profile", "enqueue")}
  info["paths"] = paths_info

  # -- the daemon over HTTP: (data 2, model 2), then time 2
  rng_serve = np.random.default_rng(seed + 8)   # phase 8's requests
  solo = {f: rng_serve.uniform(-11.0, 1.0, (80, f)).astype(np.float32)
          for f in FRAMES}
  service = SynthesisService(
      ckpt, custom_hparams={"compute_dtype": dtype_name},
      max_batch=SERVE_MAX_BATCH, bucket_frames=BUCKET,
      mesh=make_mesh(data=2, model=2, devices=logical_devices(4)))
  daemon = {}
  with serving(service) as client:
    health = client.health()
    if health["mesh"] != {"data": 2, "model": 2}:
      fail(f"mesh {mode}: /healthz mesh {health['mesh']}")
    for i, (f, mel) in enumerate(solo.items()):
      got = client.synthesize(mel, seed=seed + i)
      want = service.synth.infer_serving(mel, seed=seed + i,
                                         bucket_frames=BUCKET).samples
      if not np.array_equal(got, want):
        fail(f"mesh {mode}: the (2, 2) daemon's {f}-frame body differs from "
             "the in-process mesh Synthesizer's")
    before = client.synthesize(solo[frames], seed=seed)
    status = client.reload(str(paths["other"]))
    after = client.synthesize(solo[frames], seed=seed)
    other = Synthesizer(CheckpointWaveglow.load(paths["other"]),
                        compute_dtype=dtype_name, device=DEVICE)
    want = other.infer_serving(solo[frames], seed=seed,
                               bucket_frames=BUCKET).samples
    reload_err = float(np.abs(after - want).max())
    if (np.array_equal(after, before)
        or reload_err > tol * float(np.abs(want).max())
        or any(len(g) != 2 for g in service.synth._place.groups)):
      fail(f"mesh {mode}: /reload did not re-shard the new weights "
           f"({reload_err} from them)")
    del other
    daemon["data2_model2"] = {"health_mesh": health["mesh"],
                              "reload": status, "reload_vs_new": reload_err}
  service = SynthesisService(
      ckpt, custom_hparams={"compute_dtype": dtype_name}, max_batch=1,
      bucket_frames=BUCKET,
      mesh=make_time_mesh(2, devices=logical_devices(2)))
  with serving(service) as client:
    health = client.health()
    got = client.synthesize(long[:, :MESH_LONG[0]], seed=seed)
    want = unsharded.infer_serving(long[:, :MESH_LONG[0]], seed=seed,
                                   bucket_frames=BUCKET).samples
    if health["mesh"] != {"time": 2} or not np.array_equal(got, want):
      fail(f"mesh {mode}: the time-2 daemon's {MESH_LONG[0]}-frame body is "
           f"not the unsharded call's ({health['mesh']})")
    daemon["time2"] = {"health_mesh": health["mesh"], "bit_for_bit": True}
  info["daemon"] = daemon
  del unsharded
  torch.cuda.empty_cache()
  info["launches"] = counts
  info["phase_s"] = time.perf_counter() - t_phase
  log("mesh " + json.dumps({k: v for k, v in info.items()
                            if k not in ("shard_kernel", "model", "paths")}))
  return info


@contextlib.contextmanager
def serving(service: SynthesisService):
  """``service`` behind a daemon on 127.0.0.1 for the body of the block;
  yields a client and shuts every thread down after."""
  httpd = make_server(service, "127.0.0.1", 0)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  try:
    yield SynthesisClient(f"http://127.0.0.1:{httpd.server_port}",
                          timeout_s=SERVE_TIMEOUT_S)
  finally:
    httpd.shutdown()
    httpd.server_close()
    thread.join(SERVE_TIMEOUT_S)
    if service._batcher is not None:
      service._batcher.close(SERVE_TIMEOUT_S)


def serve_refuses_missing_cards(npz: Path, tmp: Path) -> dict:
  """``serve --mesh-data <cards + 1>`` as a process must exit nonzero
  with the message that names the cards it needs: a refusal, not a
  fallback."""
  need = torch.cuda.device_count() + 1
  log_path = tmp / "serve_mesh.log"
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, "-m", "waveglow_tpu_torch", "serve", str(npz),
       "--port", str(free_port()), "--mesh-data", str(need), "--log",
       str(log_path)], cwd=ROOT, capture_output=True, text=True,
      timeout=SERVE_TIMEOUT_S, check=False)
  wall = time.perf_counter() - t0
  text = proc.stdout + proc.stderr
  message = f"needs {need} CUDA devices (cards), have {need - 1}"
  if proc.returncode == 0 or message not in text:
    fail(f"serve --mesh-data {need} on {need - 1} card(s) exited "
         f"{proc.returncode} without '{message}':\n{text[-2000:]}")
  return {"mesh_data": need, "returncode": proc.returncode,
          "message": message, "wall_s": wall}


# -- phase 12 --------------------------------------------------------------

# Every built width beside the one phases 3-11 drive.
WIDE_WIDTHS = tuple(w for w in kl.kernel_widths() if w != C)
# The one train() step of phase 12 at each width: phase 6's data and
# segment, batch 4; resumed from an iteration-1 checkpoint of the served
# model with a fresh optimizer, so the step saves nothing (a 512-channel
# checkpoint with Adam state is over 3 GB).
WIDTH_TRAIN_BATCH = 4
WIDTH_TRAIN_HPARAMS = {"batch_size": str(WIDTH_TRAIN_BATCH),
                       "iters_per_checkpoint": "1000",
                       "epochs_per_checkpoint": "0"}
WIDTH_DESIGN = {
    128: {"bf16": "the C = 256 kernel with one warpgroup (wgmma)",
          "f32": "the C = 256 kernel with a 192-thread warp grid"},
    512: {"bf16": "x rounded once, then a gate kernel and a res/skip "
                  "kernel, each one wave of persistent blocks walking units "
                  "of 128 flat rows x a pass (128 channels; 256 of the n_rs "
                  "columns), wgmma m64n128k16 through a 4-stage ring of "
                  "64-deep K chunks, the acts through global memory in bf16",
          "f32": "two kernels of the C = 256 register tile (384 threads, 8 "
                 "rows x (4 + 4) channels a thread, 16-row K chunks through "
                 "a 4-stage cp.async ring): 96-row tiles in four passes of "
                 "128 channels, then a block's rest of 48 rows or fewer in "
                 "16-row tiles of one 512-channel pass (the rest kernel: 8 "
                 "warps, a 3-stage ring); the acts through a "
                 "global f32 scratch, read back through the ring as the "
                 "second product's rows"}}
# The bf16 shard at C = 512: the layer's kernels at gate width C'.
SHARD_WIDE_DESIGN = (
    "the C = 512 bf16 layer's three kernels at gate width C' "
    "(csrc/wn_layer.cu): x rounded once, a gate kernel (units of 128 flat "
    "rows x a pass of min(C', 128) channels, wgmma m64nNk16 with N = "
    "min(C', 128)) writing the acts [B*T, C'] in bf16, a res/skip kernel "
    "(units of 128 rows x 256 partial columns, K = C') storing the f32 "
    "partial; one wave of persistent blocks each, a 4-stage ring of "
    "64-deep K chunks")


def backward_kernel_case(i: int, seed: int, width: int,
                         time_it: bool) -> dict:
  """The bf16 backward kernels against ``wn_layer_backward`` at the same
  rounding points (layer ``i`` of a flow, B_TRAIN x T_TRAIN, ``width``
  channels), each gradient within KERNEL_TOL_BF16_REL of its max |value|;
  with ``time_it``, the kernels', the plain backward's and the library's
  backward times beside the bound."""
  cdt = torch.bfloat16
  last = i == N_LAYERS
  dilation = 2 ** min(i, N_LAYERS - 1)
  args, cot = trainable_inputs(last, cdt, seed + i, width)
  saved = tuple(a.detach() for a in args)
  got = kl.wn_layer_backward_fused(saved, *cot, dilation)
  torch.cuda.synchronize()
  again = kl.wn_layer_backward_fused(saved, *cot, dilation)
  if not all(torch.equal(a, b) for a, b in zip(got, again)):
    fail(f"two launches of the backward kernels at C={width} differ "
         f"(d={dilation}, last={last})")
  del again
  ref = kl.wn_layer_backward(saved, *cot, dilation, None, cdt)
  rec = {"C": width, "dilation": dilation, "last": last, "grads": {}}
  for name, g, r in zip(GRAD_NAMES, got, ref):
    err = (g.float() - r.float()).abs().max().item()
    scale = r.float().abs().max().item()
    rec["grads"][name] = {"max_abs_err": err, "ref_max_abs": scale}
    if not torch.isfinite(g).all() or err > KERNEL_TOL_BF16_REL * scale:
      fail(f"backward kernel {name} at C={width} disagrees with "
           f"wn_layer_backward: {rec}")
  rec["max_abs_err"] = max(v["max_abs_err"] for v in rec["grads"].values())
  rec["max_err_of_scale"] = max(v["max_abs_err"] / v["ref_max_abs"]
                                for v in rec["grads"].values()
                                if v["ref_max_abs"] > 0)
  del got, ref
  if time_it:
    rec["kernel_ms"] = cuda_ms(lambda: kl.wn_layer_backward_fused(
        saved, *cot, dilation))
    rec["plain_ms"] = cuda_ms(lambda: kl.wn_layer_backward(
        saved, *cot, dilation, None, cdt))
    x, cond, w_in, b_in, w_rs, _ = saved
    lib_in = (x.to(cdt).transpose(1, 2).contiguous().requires_grad_(),
              cond.reshape(B_TRAIN, T_TRAIN, 2 * width).clone()
              .requires_grad_(),
              w_in.permute(2, 1, 0).contiguous().requires_grad_(),
              b_in.to(cdt).clone().requires_grad_(),
              w_rs.clone().requires_grad_())
    cot_rs = torch.cat(cot, dim=-1)[..., :w_rs.shape[1]].to(cdt)
    lib_out = library_layer(*lib_in, None, dilation, cdt)
    rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, cot_rs, retain_graph=True))
    del lib_out
    cost = trainable_cost(last, "bf16", width)
    rec.update(bound_ms=cost["bwd_bound_ms"], bound_by=cost["bwd_bound_by"],
               share_of_bound=cost["bwd_bound_ms"] / rec["kernel_ms"],
               kernels_ms=backward_kernel_ms(saved, cot, dilation))
  log("width backward kernel " + json.dumps(rec))
  return rec


def width_kernels(width: int, seed: int) -> dict:
  """Phase 12's kernels at ``width``: the forward (f32, bf16) and each
  shard pair at d=1, d=128 and the last layer (B=1, T=T_KERNEL), the bf16
  backward at B_TRAIN x T_TRAIN, each against its plain version and timed
  beside its bound, plain and library times."""
  out = {"forward": {}, "shard": {}}
  for mode in MODES:
    out["forward"][mode] = [kernel_case(mode, 1, i, seed, width,
                                        time_it=True)
                            for i in (0, N_LAYERS - 1, N_LAYERS)]
    out["shard"][mode] = shard_kernel_check(mode, seed, width)
  out["backward"] = [backward_kernel_case(i, seed, width, time_it=i == 0)
                     for i in (0, N_LAYERS - 1, N_LAYERS)]
  torch.cuda.empty_cache()
  return out


def width_serving(ckpt: CheckpointWaveglow, mode: str, seed: int) -> dict:
  """Phase 4's 826-frame request through Synthesizer.infer_serving (96
  launches), the kernel path against the plain path on injected noise, wall,
  device busy and peak memory; then a model = 2 logical mesh dispatch (192
  shard launches, no WN-kernel launch) against the unsharded one."""
  dtype_name = "bfloat16" if mode == "bf16" else "float32"
  tol = SLICE_TOL_REL[mode]
  rng = np.random.default_rng(seed)   # phase 4's requests
  req = [rng.uniform(-11.0, 1.0, (80, f)).astype(np.float32)
         for f in FRAMES][-1]
  synth = Synthesizer(ckpt, compute_dtype=dtype_name, device=DEVICE)
  per_synthesis = synth.config.n_flows * synth.config.n_layers
  synth.infer_serving(req, seed=seed, bucket_frames=BUCKET)   # warm-up
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kl.LAUNCHES = kl.SHARD_LAUNCHES = 0
  t0 = time.perf_counter()
  res = synth.infer_serving(req, seed=seed, bucket_frames=BUCKET)
  wall = time.perf_counter() - t0
  launches = kl.LAUNCHES
  peak = torch.cuda.max_memory_allocated()
  if launches != per_synthesis or kl.SHARD_LAUNCHES:
    fail(f"C={synth.config.n_channels} {mode}: infer_serving launched "
         f"{launches} (shard {kl.SHARD_LAUNCHES}), expected {per_synthesis}")
  if (res.samples.shape != (req.shape[-1] * UPSAMPLE_STRIDE,)
      or not np.isfinite(res.samples).all()):
    fail(f"C={synth.config.n_channels} {mode}: output "
         f"{res.samples.shape}, finite {np.isfinite(res.samples).all()}")

  # -- the kernel path against the plain path, same weights and noise
  n_groups = req.shape[-1] * UPSAMPLE_STRIDE // synth.config.n_group
  noise = [rng.standard_normal(s).astype(np.float32)
           for s in infer_noise_shapes(synth.config, 1, n_groups)]
  wav_k = synth.infer(req, noise=noise, denoiser_strength=0.0).wav
  with torch.inference_mode():
    wav_p = infer(synth.params, synth.config,
                  torch.from_numpy(req[None]).to(DEVICE), noise=noise,
                  compute_dtype=synth._cdt, layer=kl.wn_layer_plain,
                  device=DEVICE)[0].cpu().numpy()
  plain_err = float(np.abs(wav_k - wav_p).max())
  plain_bound = tol * float(np.abs(wav_p).max())
  if not np.isfinite(wav_k).all() or plain_err > plain_bound:
    fail(f"C={synth.config.n_channels} {mode}: kernel path vs plain path "
         f"{plain_err} > {plain_bound}")
  info = {"mode": mode, "launches": launches, "wall_s": wall,
          "audio_s": req.shape[-1] * UPSAMPLE_STRIDE
                     / synth.hparams.sampling_rate,
          "max_memory_allocated_bytes": peak,
          "kernel_vs_plain_max_abs": plain_err,
          "kernel_vs_plain_bound": plain_bound,
          "profile": profile_call(lambda: synth.infer_serving(
              req, seed=seed, bucket_frames=BUCKET))}

  # -- model = 2 on a logical mesh of the card
  mesh = Synthesizer(ckpt, compute_dtype=dtype_name,
                     mesh=make_mesh(data=1, model=2,
                                    devices=logical_devices(2)))
  mesh.infer_serving(req, seed=seed, bucket_frames=BUCKET)   # warm-up
  kl.LAUNCHES = kl.SHARD_LAUNCHES = 0
  got = mesh.infer_serving(req, seed=seed, bucket_frames=BUCKET)
  mesh_launches = {"fused": kl.LAUNCHES, "shard": kl.SHARD_LAUNCHES}
  want = expected_mesh_launches("model", 2, 1, req.shape[-1], per_synthesis)
  if mesh_launches != want:
    fail(f"C={synth.config.n_channels} {mode}: model=2 dispatch launched "
         f"{mesh_launches}, expected {want}")
  scale = float(np.abs(res.samples).max())
  err = float(np.abs(got.samples - res.samples).max())
  if not np.isfinite(got.samples).all() or err > tol * scale:
    fail(f"C={synth.config.n_channels} {mode}: model=2 vs unsharded {err} "
         f"> {tol * scale}")
  info["mesh_model2"] = {
      "launches": mesh_launches, "vs_unsharded_max_abs": err,
      "bound": tol * scale,
      "profile": profile_call(lambda: mesh.infer_serving(
          req, seed=seed, bucket_frames=BUCKET))}
  del synth, mesh
  torch.cuda.empty_cache()
  return info


def width_train(ckpt: CheckpointWaveglow, mode: str, seed: int,
                tmp: Path) -> dict:
  """One train() step at the checkpoint's width (launch counts: 192 WN
  launches with remat, 96 backward-kernel calls in bf16), then one step's
  gradients through the kernels against the plain route on the same params
  and batch, each leaf within GRAD_TOL_REL of its max |value|."""
  width = ckpt.get_hparams().n_channels
  custom = dict(WIDTH_TRAIN_HPARAMS, seed=str(seed),
                compute_dtype="bfloat16" if mode == "bf16" else "float32")
  hp = overwrite_custom_hparams(ckpt.get_hparams(), custom)
  config = WaveGlowConfig.from_hparams(hp)
  entries = write_wavs(tmp / f"wavs{width}{mode}", seed)
  per_forward = config.n_flows * config.n_layers
  per_step = 2 * per_forward if hp.remat else per_forward
  bwd_per_step = per_forward if mode == "bf16" else 0
  kl.LAUNCHES = kl.BWD_LAUNCHES = 0
  t0 = time.perf_counter()
  train(custom, tmp / f"logs{width}{mode}", entries, entries,
        tmp / f"ck{width}{mode}", checkpoint=ckpt, max_iterations=2,
        device=DEVICE)
  train_s = time.perf_counter() - t0
  launches, bwd_launches = kl.LAUNCHES, kl.BWD_LAUNCHES
  steps = [r for r in read_metrics(tmp / f"logs{width}{mode}")
           if r["event"] == "train_step"]
  if (len(steps) != 1 or launches != per_step
      or bwd_launches != bwd_per_step or not np.isfinite(steps[0]["loss"])):
    fail(f"C={width} {mode}: train() ran {len(steps)} steps with "
         f"{launches} WN and {bwd_launches} backward launches, expected 1, "
         f"{per_step} and {bwd_per_step}: {steps}")

  mel_op = MelSTFT(hp, DEVICE)
  batch = torch.from_numpy(SegmentDataset(entries, hp).batch(
      range(WIDTH_TRAIN_BATCH), 0)).to(DEVICE)
  routes = {}
  for route, layer in (("kernel", kl.wn_layer_trainable),
                       ("plain", kl.wn_layer_plain)):
    params = trainable_params_from_numpy(ckpt.state_dict, DEVICE)
    loss = train_lib.compute_grads(
        train_lib.make_loss_fn(config, hp, mel_op, layer), params, batch)
    routes[route] = (float(loss), [p.grad for p in tree_leaves(params)])
    del params
  (loss_k, grads_k), (loss_p, grads_p) = routes["kernel"], routes["plain"]
  worst, worst_leaf = 0.0, None
  for n, (g, r) in enumerate(zip(grads_k, grads_p)):
    err = (g.float() - r.float()).abs().max().item()
    scale = r.float().abs().max().item()
    rel = err / scale if scale else err
    if not torch.isfinite(g).all() or rel > GRAD_TOL_REL[mode]:
      fail(f"C={width} {mode}: leaf {n} {tuple(g.shape)}'s grad through the "
           f"kernels differs from the plain route by {rel} of its max")
    if rel >= worst:
      worst, worst_leaf = rel, n
  del routes, grads_k, grads_p, batch
  torch.cuda.empty_cache()
  info = {"mode": mode, "train_s": train_s, "loss": steps[0]["loss"],
          "step_s": steps[0]["duration_s"], "launches": launches,
          "backward_launches": bwd_launches,
          "kernel_vs_plain_loss": [loss_k, loss_p],
          "grad_max_err_of_scale": worst, "worst_leaf": worst_leaf,
          "grad_bound_of_scale": GRAD_TOL_REL[mode]}
  log(f"width train C={width} " + json.dumps(info))
  return info


def phase_widths(seed: int, tmp: Path) -> dict:
  """Phase 12: every built width beside C, its kernels, a full-depth model
  served in f32 and bf16 (alone and on a model = 2 mesh) and one train()
  step in each mode."""
  out = {}
  for width in WIDE_WIDTHS:
    t0 = time.perf_counter()
    rec = {"card": nvidia_smi_line(),
           "kernels": width_kernels(width, seed)}
    ckpt = full_width_checkpoint(seed, tmp / f"w{width}.npz", width)
    rec["serving"] = {mode: width_serving(ckpt, mode, seed) for mode in MODES}
    for mode in MODES:
      log(f"width serving C={width} {mode} " + json.dumps(
          {k: v for k, v in rec["serving"][mode].items() if k != "profile"}))
    rec["train"] = {mode: width_train(ckpt, mode, seed, tmp)
                    for mode in MODES}
    rec["phase_s"] = time.perf_counter() - t0
    log(f"widths C={width}: {rec['phase_s']:.1f} s")
    out[width] = rec
    del ckpt
    torch.cuda.empty_cache()
  return out


# -- phase 13 ----------------------------------------------------------------

# Mesh training on logical meshes of the one card (the ranks run one after
# another: the numbers are checked, no speedup is shown): full width, batch
# 12 and segment 16,000 (phase 6's), three train() steps with saves at
# steps 1 (the first iteration's) and MESH_SAVE_AT and a resume from the
# latter; validation on MESH_VAL_WAVS cuts (one batch a save). Then one
# step at C = MESH_WIDE on a model = 2 mesh at WIDTH_TRAIN_BATCH rows, and
# the train command in two processes (gloo on the one card: NCCL will not
# put two ranks on one device), global batch 12, 6 rows a process, two
# steps. The bounds are phase 6's (STEP_LOSS_TOL, STEP_GRAD_TOL_REL): a
# mesh step against the unsharded step differs in summation order (the
# ranks' partials, the replicas' gradients) and in bf16 by the roundings
# that order moves.
MESH_TRAIN = ((1, 2), (2, 1), (2, 2))
MESH_TRAIN_STEPS = 3
MESH_SAVE_AT = 2
MESH_VAL_WAVS = 12
MESH_WIDE = 512
CLI_PROCS = 2
CLI_PROC_TIMEOUT_S = 300
SHARD_BWD_DESIGN = (
    "redesigned for Hopper: wgmma m64nNk16 from 128-byte-swizzled shared "
    "memory, two warpgroups of 64 rows, 64-deep K chunks with one chunk's "
    "wgmmas running under the next one's loads; rows (a block per batch row, "
    "128-row tile and pass of min(C', 64) channels: the gate recompute and "
    "dacts on accumulators of the same (row, channel), f32 x and g read and "
    "rounded to bf16 under the previous chunk's wgmmas, weights through a "
    "cp.async ring), dx (128 rows x min(C, 256) channels, K = 3 x 2C'), "
    "weights (dw_in and dw_rs^T tiles of 128 x the live N, both operands "
    "MN-major, a row split that fills the card's waves), reduce (fixed "
    "order, no atomics)")


def shard_bwd_cost(batch: int, t: int, width: int, cp: int, last: bool,
                   mode: str) -> dict:
  """Least work of one shard backward (a rank's C' of ``width`` channels):
  the saved inputs (x, cond_s, w_in_s, b_in_s, w_rs_s) and g read once,
  dx, dcond_s, dw_in_s, db_in_s and dw_rs_s written once; the products
  dacts, dw_rs, dw_in and the taps' adjoint at the compute dtype's rate,
  without the gate recompute (as ``trainable_cost`` counts the full
  layer's backward)."""
  C = width
  esize = 2 if mode == "bf16" else 4
  rs = C if last else 2 * C
  rows = batch * t
  weights = (3 * C * 2 * cp + cp * rs) * esize
  nbytes = (2 * rows * C * 4              # x in, dx out
            + 2 * rows * 2 * cp * esize   # cond_s in, dcond_s out
            + 2 * weights + 2 * 2 * cp * 4  # the weights and b_in_s, both ways
            + rows * rs * 4)              # g in
  flops = 2 * rows * (2 * rs * cp + 2 * 3 * C * 2 * cp)
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[mode] * 1e3
  return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_shard_backward(saved, g, dilation: int, dtype):
  """Yardstick the port never calls: the shard backward's function as
  cuBLAS matmuls on ``dtype`` operands (bf16 or f32) and torch elementwise
  ops."""
  x, cond_s, w_in_s, b_in_s, w_rs_s = saved
  batch, t, c = x.shape
  cp = b_in_s.numel() // 2
  rs = w_rs_s.numel() // cp
  xd = x.to(dtype)
  taps = torch.cat([shift_time(xd, (k - 1) * dilation) for k in range(3)],
                   dim=-1).reshape(-1, 3 * c)
  w_in = w_in_s.reshape(3 * c, 2 * cp).to(dtype)
  w_rs = w_rs_s.reshape(cp, rs).to(dtype)
  gates = (torch.matmul(taps, w_in).float() + b_in_s
           + cond_s.reshape(-1, 2 * cp).float())
  t_act, s_act = torch.tanh(gates[:, :cp]), torch.sigmoid(gates[:, cp:])
  gd = g.reshape(-1, rs).to(dtype)
  dacts = torch.matmul(gd, w_rs.T).float()
  dw_rs = torch.matmul((t_act * s_act).to(dtype).T, gd)
  dgates = torch.cat([dacts * s_act * (1 - t_act * t_act),
                      dacts * t_act * s_act * (1 - s_act)], dim=-1)
  db_in = dgates.sum(0)
  dg = dgates.to(dtype)
  dw_in = torch.matmul(taps.T, dg)
  g_w = torch.matmul(dg, w_in.T).float().reshape(batch, t, 3 * c)
  dx = sum(shift_time(g_w[..., k * c:(k + 1) * c], -(k - 1) * dilation)
           for k in range(3))
  return dx, dg, dw_in, db_in, dw_rs


def shard_backward_kernel_ms(saved, g, dilation: int, reps: int = 10,
                             tries: int = 3):
  """:func:`kernel_split` of one bf16 shard-backward call, by each kernel's
  variant name (``shard_bwd_variant``; a layer's saved inputs: its rows
  kernel is the "layer" variant)."""
  width = saved[0].shape[-1]
  cp = saved[3].numel() // 2
  return kernel_split(
      lambda: kl.wn_layer_shard_backward_fused(saved, g, dilation),
      r"wn_sbwd_(rows|dx|weights|reduce)_kernel", len(kl.SHARD_BWD_KERNELS),
      reps, tries, key=lambda k: shard_bwd_variant(k, width, cp))


def shard_bwd_check(seed: int) -> dict:
  """The bf16 shard backward kernels against wn_layer_shard_backward at
  every pair, B_TRAIN x T_TRAIN, d=1 and the last layer (rank 0): each
  gradient within KERNEL_TOL_BF16_REL of its scale; two launches of every
  rank the same bits; the ranks' outputs, dx summed (plus the residual's
  cotangent) and the rest concatenated, against the full layer's backward
  kernels at the same bound. Timed at d=1 (rank 0) beside the bound, the plain version
  and the library's; and the f32 route (torch ops) at (C, C/2)."""
  bf = torch.bfloat16
  cases, timed = [], {}
  for width in kl.kernel_widths():
    for i, (dilation, last) in enumerate(((1, False),
                                          (LAST_DILATION, True))):
      args, _, _ = layer_inputs(B_TRAIN, T_TRAIN, last, bf, seed + 130 + i,
                                width)
      rs = width if last else 2 * width
      gen = torch.Generator(device=DEVICE).manual_seed(seed + 140 + i)
      g = torch.randn(B_TRAIN, T_TRAIN, rs, generator=gen, device=DEVICE)
      dx_next = None if last else g[..., :width].contiguous()
      dskip = g if last else g[..., width:].contiguous()
      full = kl.wn_layer_backward_fused(args, dx_next, dskip, dilation)
      for c, cp in kl.shard_pairs():
        if c != width:
          continue
        model = width // cp
        outs, err, err_of_scale, repeats = [], 0.0, 0.0, True
        for rank in range(model):
          cond_s, w_in_s, b_in_s, w_rs_s = shard_slices(args, model, rank)
          saved = (args[0], cond_s, w_in_s.reshape(3 * width, 2 * cp),
                   b_in_s, w_rs_s)
          got = kl.wn_layer_shard_backward_fused(saved, g, dilation)
          again = kl.wn_layer_shard_backward_fused(saved, g, dilation)
          torch.cuda.synchronize()
          repeats = repeats and all(torch.equal(a, b)
                                    for a, b in zip(got, again))
          del again
          if not all(torch.isfinite(a).all() for a in got):
            fail(f"shard backward C={width} C'={cp}: not finite")
          if rank == 0:
            ref = kl.wn_layer_shard_backward(saved, g, dilation, bf)
            for a, b in zip(got, ref):
              e = (a.float() - b.float()).abs().max().item()
              err = max(err, e)
              err_of_scale = max(err_of_scale,
                                 e / max(b.float().abs().max().item(), 1e-30))
            del ref
          outs.append(got)
          if dilation == 1 and rank == 0:
            cost = shard_bwd_cost(B_TRAIN, T_TRAIN, width, cp, last, "bf16")
            rec = {"kernel_ms": cuda_ms(lambda: kl.wn_layer_shard_backward_fused(
                saved, g, 1), reps=10),
                   "plain_ms": cuda_ms(lambda: kl.wn_layer_shard_backward(
                       saved, g, 1, bf), reps=5),
                   "library_ms": cuda_ms(lambda: library_shard_backward(
                       saved, g, 1, bf), reps=5), **cost}
            rec["share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
            rec["kernels_ms"] = shard_backward_kernel_ms(saved, g, 1)
            timed[(width, cp)] = rec
        dx = sum(o[0] for o in outs) + (0 if last else g[..., :width])

        def cat(k, shape):
          return torch.cat([o[k].reshape(shape) for o in outs], dim=-1)

        summed = (dx, cat(1, (B_TRAIN, T_TRAIN, 2, -1)),
                  cat(2, (3 * width, 2, -1)), cat(3, (2, -1)),
                  torch.cat([o[4].reshape(cp, rs) for o in outs], 0))
        sum_err = max(
            (a.float().reshape(b.shape) - b.float()).abs().max().item()
            / max(b.float().abs().max().item(), 1e-30)
            for a, b in zip(summed, full[:5]))
        case = {"C": width, "C'": cp, "dilation": dilation, "last": last,
                "max_abs_err": err, "max_err_of_scale": err_of_scale,
                "ranks_vs_full_err_of_scale": sum_err,
                "repeat_bitwise": repeats,
                "tolerance_of_scale": KERNEL_TOL_BF16_REL}
        if (err_of_scale > KERNEL_TOL_BF16_REL
            or sum_err > KERNEL_TOL_BF16_REL or not repeats):
          fail(f"shard backward kernel disagrees: {case}")
        if (width, cp) in timed and dilation == 1:
          case.update(timed[(width, cp)])
        log("shard backward " + json.dumps(case))
        cases.append(case)
        del outs, summed, dx
      del args, g, full
    torch.cuda.empty_cache()
  # the f32 route: torch ops, at (C, C/2), d=1, rank 0
  args, _, _ = layer_inputs(B_TRAIN, T_TRAIN, False, torch.float32,
                            seed + 150, C)
  gen = torch.Generator(device=DEVICE).manual_seed(seed + 151)
  g = torch.randn(B_TRAIN, T_TRAIN, 2 * C, generator=gen, device=DEVICE)
  cond_s, w_in_s, b_in_s, w_rs_s = shard_slices(args, 2, 0)
  saved = (args[0], cond_s, w_in_s.reshape(3 * C, C), b_in_s, w_rs_s)
  leaves = [v.clone().requires_grad_() for v in saved]
  plain_out = kl.wn_layer_shard_plain(*leaves, 1)
  f32 = {"ms": cuda_ms(lambda: kl.wn_layer_shard_backward(saved, g, 1),
                       reps=5),
         "plain_ms": cuda_ms(lambda: torch.autograd.grad(
             plain_out, leaves, g, retain_graph=True), reps=5),
         "library_ms": cuda_ms(lambda: library_shard_backward(
             saved, g, 1, torch.float32), reps=5),
         **shard_bwd_cost(B_TRAIN, T_TRAIN, C, C // 2, False, "f32")}
  got = kl.wn_layer_shard_backward(saved, g, 1)
  want = torch.autograd.grad(plain_out, leaves, g)
  f32["max_abs_err"] = max((a - b).abs().max().item()
                           for a, b in zip(got, want))
  f32["max_err_of_scale"] = max((a - b).abs().max().item()
                                / b.abs().max().item()
                                for a, b in zip(got, want))
  if f32["max_err_of_scale"] > GRAD_TOL_REL["f32"]:
    fail(f"f32 shard backward against autograd: {f32}")
  log("shard backward f32 " + json.dumps(f32))
  del args, g, saved, leaves, plain_out, got, want
  torch.cuda.empty_cache()
  return {"cases": cases, "timed": timed, "f32": f32}


def expected_mesh_train_launches(data_: int, model: int, mode: str,
                                 per_forward: int, remat: bool = True,
                                 steps: int = 1, evals: int = 0) -> dict:
  """Launches of ``steps`` mesh train steps and ``evals`` validation
  batches: each data replica runs the forward once a step and, with remat,
  again in the backward; a model group runs the shard kernel once a rank
  and layer (no full-layer kernel), and in bf16 the shard backward once a
  rank and layer; a model = 1 replica runs the full layer's kernels."""
  fwd = data_ * per_forward * ((2 if remat else 1) * steps + evals)
  bwd = data_ * per_forward * steps if mode == "bf16" else 0
  if model > 1:
    return {"fused": 0, "backward": 0, "shard": fwd * model,
            "shard_backward": bwd * model}
  return {"fused": fwd, "backward": bwd, "shard": 0, "shard_backward": 0}


def launch_counts() -> dict:
  return {"fused": kl.LAUNCHES, "backward": kl.BWD_LAUNCHES,
          "shard": kl.SHARD_LAUNCHES, "shard_backward": kl.SHARD_BWD_LAUNCHES}


def reset_launches() -> None:
  kl.LAUNCHES = kl.BWD_LAUNCHES = kl.SHARD_LAUNCHES = 0
  kl.SHARD_BWD_LAUNCHES = 0


def mesh_grads(hp: HParams, config: WaveGlowConfig, params_np: dict,
               batch: torch.Tensor, data_: int, model: int) -> tuple:
  """One mesh step without the update, under torch.profiler: each data
  replica's loss and gradients on its rows, averaged over the replicas (the
  step's own sync). Returns the loss, replica 0's gradients gathered to the
  full tree's leaves on the host, and the step's device busy ms (its
  forward, remat recompute, backward and the replicas' sum; not Adam)."""
  from torch.profiler import ProfilerActivity, profile
  mesh = make_mesh(data_, model, devices=logical_devices(data_ * model))
  replicas = shard_trainable_params(params_np, mesh)
  loss_fn = train_lib.make_loss_fn(config, hp, MelSTFT(hp, DEVICE))
  rows = batch.shape[0] // data_
  torch.cuda.synchronize()
  # the device's activity alone: tracing every host op of a full-width
  # step cost 5-20 s of post-processing a mesh
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    losses = [train_lib.compute_grads(
        loss_fn, group if model > 1 else group[0],
        batch[i * rows:(i + 1) * rows]) for i, group in enumerate(replicas)]
    loss = float(train_lib.sync_replica_grads(replicas, losses))
    torch.cuda.synchronize()
  busy = sum(ms for _, ms in device_kernels(prof))
  grads = [torch.from_numpy(v) for v in gather_tree(
      replicas[0], lambda p: p.grad.detach().to("cpu").numpy())]
  return loss, grads, busy if busy else "not measured"


def states_equal(a: dict, b: dict) -> bool:
  return (all(np.array_equal(x, y) for x, y in
              zip(tree_leaves(a["params"]), tree_leaves(b["params"])))
          and all(np.array_equal(x, y)
                  for x, y in zip(a["opt_state"], b["opt_state"])))


def mesh_train_case(mode: str, custom: dict, hp: HParams,
                    config: WaveGlowConfig, params_np: dict,
                    batch: torch.Tensor, ref: tuple, data_: int, model: int,
                    entries, val_entries, tmp: Path) -> dict:
  """Phase 13(b) on one (data, model) mesh: a step's loss and gradients
  against the unsharded step (ref), launch counts, train() with saves and a
  resume bit for bit, the checkpoint resumed unsharded, the step's busy
  time and peak memory."""
  per_forward = config.n_flows * config.n_layers
  name = f"{mode} mesh ({data_}, {model})"
  reset_launches()
  t0 = time.perf_counter()
  loss, grads, busy = mesh_grads(hp, config, params_np, batch, data_, model)
  seconds = {"step_check": time.perf_counter() - t0}
  counts = launch_counts()
  want = expected_mesh_train_launches(data_, model, mode, per_forward,
                                      hp.remat)
  if counts != want:
    fail(f"{name}: one step launched {counts}, expected {want}")
  rel = leaf_norm_rel_errors(grads, ref[1])
  worst = int(np.argmax(rel))
  rec = {"mode": mode, "data": data_, "model": model, "loss": loss,
         "loss_err": abs(loss - ref[0]), "grad_norm_rel": rel[worst],
         "worst_leaf": worst, "step_launches": counts,
         "device_busy_ms": busy,
         "loss_bound": STEP_LOSS_TOL[mode],
         "grad_bound_rel": STEP_GRAD_TOL_REL[mode]}
  del grads
  if (rec["loss_err"] > STEP_LOSS_TOL[mode]
      or rec["grad_norm_rel"] > STEP_GRAD_TOL_REL[mode]):
    fail(f"{name}: the step differs from the unsharded step: {rec}")

  devices = logical_devices(data_ * model)
  mcustom = dict(custom, mesh_data=str(data_), mesh_model=str(model))
  reset_launches()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  straight = train(mcustom, tmp / "logs", entries, val_entries, tmp / "ck",
                   max_iterations=MESH_TRAIN_STEPS, device=DEVICE,
                   mesh_devices=devices)
  rec["train_s"] = seconds["train"] = time.perf_counter() - t0
  rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
  counts = launch_counts()
  records = read_metrics(tmp / "logs")
  steps = [r for r in records if r["event"] == "train_step"]
  saves = [r["iteration"] for r in records if r["event"] == "validation"]
  val_batches = len(val_entries) // B_TRAIN
  want = expected_mesh_train_launches(
      data_, model, mode, per_forward, hp.remat, steps=len(steps),
      evals=val_batches * len(saves))
  rec.update(train_launches=counts, losses=[r["loss"] for r in steps],
             step_s=[r["duration_s"] for r in steps])
  if len(steps) != MESH_TRAIN_STEPS or saves != [1, MESH_SAVE_AT]:
    fail(f"{name}: train() ran {len(steps)} steps, saved at {saves}")
  if counts != want:
    fail(f"{name}: train() launched {counts}, expected {want}")
  t0 = time.perf_counter()
  ckpt = CheckpointWaveglow.load(tmp / "ck" / f"{MESH_SAVE_AT}.npz")
  seconds["load"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  resumed = train(None, None, entries, val_entries, tmp / "ck_resumed",
                  checkpoint=ckpt, max_iterations=MESH_TRAIN_STEPS,
                  device=DEVICE, mesh_devices=devices)
  rec["resume_bitwise"] = states_equal(resumed, straight)
  if not rec["resume_bitwise"]:
    fail(f"{name}: the resumed run's state differs from the straight run's")
  del resumed
  seconds["resume"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  train({"mesh_data": "1", "mesh_model": "1"}, tmp / "logs_flat", entries,
        val_entries, tmp / "ck_flat", checkpoint=ckpt,
        max_iterations=MESH_TRAIN_STEPS, device=DEVICE)
  seconds["unsharded_resume"] = time.perf_counter() - t0
  flat = [r["loss"] for r in read_metrics(tmp / "logs_flat")
          if r["event"] == "train_step"]
  rec["unsharded_resume_loss"] = flat
  rec["unsharded_resume_loss_err"] = abs(flat[0] - rec["losses"][-1])
  if rec["unsharded_resume_loss_err"] > STEP_LOSS_TOL[mode]:
    fail(f"{name}: the checkpoint resumed unsharded took step "
         f"{MESH_TRAIN_STEPS} at loss {flat}, the mesh at "
         f"{rec['losses'][-1]}")
  del straight, ckpt
  for path in ("ck", "ck_resumed", "ck_flat", "logs", "logs_flat"):
    shutil.rmtree(tmp / path, ignore_errors=True)
  # the profiled step runs slower (the profiler's own host cost): its busy
  # time is set against train()'s median step after the first
  rec["median_step_s"] = float(np.median(rec["step_s"][1:]))
  rec["idle_share"] = (1 - busy / 1e3 / rec["median_step_s"]
                       if busy != "not measured" else busy)
  rec["seconds"] = seconds
  torch.cuda.empty_cache()
  log("mesh train " + json.dumps(rec))
  return rec


def mesh_wide_step(mode: str, seed: int, entries) -> dict:
  """One step at C = MESH_WIDE on a model = 2 mesh (C' = 256), at
  WIDTH_TRAIN_BATCH rows: the loss and gradients against the unsharded
  step at phase 6's bounds, and the launch counts."""
  custom = {"compute_dtype": "bfloat16" if mode == "bf16" else "float32",
            "seed": str(seed)}
  hp = overwrite_custom_hparams(width_hparams(MESH_WIDE), custom)
  config = WaveGlowConfig.from_hparams(hp)
  params_np = full_width_params(seed, MESH_WIDE)
  batch = torch.from_numpy(SegmentDataset(entries, hp).batch(
      range(WIDTH_TRAIN_BATCH), 0)).to(DEVICE)
  params = trainable_params_from_numpy(params_np, DEVICE)
  ref_loss = float(train_lib.compute_grads(
      train_lib.make_loss_fn(config, hp, MelSTFT(hp, DEVICE)), params, batch))
  ref_grads = [p.grad.detach().cpu() for p in tree_leaves(params)]
  del params
  reset_launches()
  loss, grads, _ = mesh_grads(hp, config, params_np, batch, 1, 2)
  counts = launch_counts()
  want = expected_mesh_train_launches(1, 2, mode,
                                      config.n_flows * config.n_layers,
                                      hp.remat)
  rel = leaf_norm_rel_errors(grads, ref_grads)
  rec = {"mode": mode, "C": MESH_WIDE, "model": 2, "loss": loss,
         "loss_err": abs(loss - ref_loss), "grad_norm_rel": max(rel),
         "launches": counts}
  del grads, ref_grads, batch
  torch.cuda.empty_cache()
  log("mesh train wide " + json.dumps(rec))
  if (counts != want or rec["loss_err"] > STEP_LOSS_TOL[mode]
      or rec["grad_norm_rel"] > STEP_GRAD_TOL_REL[mode]):
    fail(f"C={MESH_WIDE} {mode} model=2 step: {rec}, launches expected "
         f"{want}")
  return rec


# One process of the two-process train command: joins the group over gloo
# (two ranks on one card), runs the command, and prints its losses, a
# digest of its final state and what its cross-process reduces cost (one a
# step, one a validation batch).
MESH_CLI_WORKER = """
import hashlib, json, sys
sys.path.insert(0, {root!r})
import numpy as np
from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
from waveglow_tpu_torch.cli import main
from waveglow_tpu_torch.parallel import mesh
from waveglow_tpu_torch.training import loop
rank, port = int(sys.argv[1]), sys.argv[2]
mesh.initialize_multihost(f"127.0.0.1:{{port}}", {procs}, rank,
                          backend="gloo", timeout_s={timeout})
states, losses = [], []
train, make_step = loop.train, loop.make_mesh_train_step

def keep(*args, **kwargs):
  states.append(train(*args, **kwargs))
  return states[-1]

def recording(*args, **kwargs):
  step = make_step(*args, **kwargs)
  def run(audio):
    loss = step(audio)
    losses.append(float(loss))
    return loss
  return run

loop.train, loop.make_mesh_train_step = keep, recording
rc = main.run(sys.argv[3:])
digest = hashlib.sha256()
for leaf in tree_leaves(states[0]["params"]) + list(states[0]["opt_state"]):
  digest.update(np.ascontiguousarray(leaf).tobytes())
print("MESH_CLI " + json.dumps({{"rc": rc, "losses": losses,
                                 "digest": digest.hexdigest(),
                                 "reduce": mesh.REDUCE_STATS}}))
sys.exit(rc)
"""


def mesh_cli_train(mode: str, seed: int, tmp: Path, wav_dir: Path,
                   val_dir: Path, entries) -> dict:
  """Phase 13(c): `train --num-processes 2 --process-id r
  --coordinator-address 127.0.0.1:<port>` as two processes on the card;
  both ranks' losses equal and their final states the same bits; process
  0's first checkpoint (its Adam mu is 0.1 x the step-1 gradient) and the
  step-1 loss against one-process loss and gradients of the same global
  batch at phase 6's bounds; process 1 writes no checkpoint."""
  custom = dict(TRAIN_HPARAMS, seed=str(seed), epochs="1",
                iters_per_checkpoint=str(MESH_SAVE_AT),
                compute_dtype="bfloat16" if mode == "bf16" else "float32")
  hp = overwrite_custom_hparams(HParams(), custom)
  script = tmp / "mesh_cli_worker.py"
  script.write_text(MESH_CLI_WORKER.format(
      root=str(ROOT), procs=CLI_PROCS, timeout=CLI_PROC_TIMEOUT_S))
  port = free_port()
  hp_arg = ",".join(f"{k}={v}" for k, v in custom.items())
  t0 = time.perf_counter()
  procs = [subprocess.Popen(
      [sys.executable, str(script), str(rank), str(port), "train",
       str(wav_dir), str(val_dir), str(tmp / f"cli_ck{rank}"),
       "--custom-hparams", hp_arg, "--tl-dir", str(tmp / f"cli_logs{rank}"),
       "--coordinator-address", f"127.0.0.1:{port}", "--num-processes",
       str(CLI_PROCS), "--process-id", str(rank), "--device", DEVICE,
       "--log", str(tmp / f"cli{rank}.log")],
      cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
      for rank in range(CLI_PROCS)]
  outs = []
  try:
    for proc in procs:
      out, err = proc.communicate(timeout=CLI_PROC_TIMEOUT_S)
      outs.append((proc.returncode, out, err))
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.communicate()
  wall_s = time.perf_counter() - t0
  results = []
  for rank, (rc, out, err) in enumerate(outs):
    line = [ln for ln in out.splitlines() if ln.startswith("MESH_CLI ")]
    if rc != 0 or not line:
      fail(f"{mode}: train process {rank} exited {rc}:\n{out[-2000:]}\n"
           f"{err[-3000:]}")
    results.append(json.loads(line[-1][len("MESH_CLI "):]))
  rec = {"mode": mode, "wall_s": wall_s,
         "losses": [r["losses"] for r in results],
         "states_bitwise": len({r["digest"] for r in results}) == 1,
         "reduce": [r["reduce"] for r in results]}
  if rec["losses"][0] != rec["losses"][1] or len(rec["losses"][0]) != 2:
    fail(f"{mode}: the two processes' losses differ: {rec['losses']}")
  if not rec["states_bitwise"]:
    fail(f"{mode}: the two processes' final states differ")
  written = sorted(p.name for p in (tmp / "cli_ck0").iterdir())
  if written != ["1.npz", f"{MESH_SAVE_AT}.npz"] or (
      tmp / "cli_ck1").exists():
    fail(f"{mode}: process 0 wrote {written}; process 1 wrote "
         f"{(tmp / 'cli_ck1').exists()}")
  # one process, the same global batch (the union of the two processes'
  # rows) from the same initialisation
  config = WaveGlowConfig.from_hparams(hp)
  params = trainable_params_from_numpy(init_params(config, seed=seed), DEVICE)
  batch = torch.from_numpy(SegmentDataset(entries, hp).batch(
      range(B_TRAIN), 0)).to(DEVICE)
  ref_loss = float(train_lib.compute_grads(
      train_lib.make_loss_fn(config, hp, MelSTFT(hp, DEVICE)), params, batch))
  ref = [p.grad.detach().cpu() for p in tree_leaves(params)]
  del params, batch
  first = CheckpointWaveglow.load(tmp / "cli_ck0" / "1.npz")
  n = len(ref)
  mu = [torch.from_numpy(np.asarray(m) / 0.1)
        for m in first.optimizer[1:1 + n]]
  rel = leaf_norm_rel_errors(mu, ref)
  rec.update(one_process_loss=ref_loss,
             loss_err=abs(rec["losses"][0][0] - ref_loss),
             grad_norm_rel=max(rel))
  del first, mu, ref
  for rank in range(CLI_PROCS):
    shutil.rmtree(tmp / f"cli_ck{rank}", ignore_errors=True)
  torch.cuda.empty_cache()
  log("mesh cli train " + json.dumps(rec))
  if (rec["loss_err"] > STEP_LOSS_TOL[mode]
      or rec["grad_norm_rel"] > STEP_GRAD_TOL_REL[mode]):
    fail(f"{mode}: the two-process run's first step differs from one "
         f"process: {rec}")
  return rec


def phase_mesh_train(seed: int, tmp: Path) -> dict:
  """Phase 13: the shard backward kernels at every pair (a), train() on
  logical meshes in f32 and bf16 (b) with the C = 512 step, and the train
  command in two processes (c)."""
  t0 = time.perf_counter()
  out = {"shard_backward": shard_bwd_check(seed)}
  seconds = {"shard_backward": time.perf_counter() - t0}
  entries = write_wavs(tmp / "mesh_wavs", seed)
  val_dir = tmp / "mesh_val"
  val_dir.mkdir(parents=True, exist_ok=True)
  for e in entries[:MESH_VAL_WAVS]:
    shutil.copy(e.wav_absolute_path, val_dir / e.basename)
  val_entries = load_dataset(val_dir)
  params_np = full_width_params(seed)
  for mode in MODES:
    custom = dict(TRAIN_HPARAMS, seed=str(seed),
                  iters_per_checkpoint=str(MESH_SAVE_AT),
                  compute_dtype="bfloat16" if mode == "bf16" else "float32")
    hp = overwrite_custom_hparams(HParams(), custom)
    config = WaveGlowConfig.from_hparams(hp)
    batch = torch.from_numpy(SegmentDataset(entries, hp).batch(
        range(B_TRAIN), 0)).to(DEVICE)
    params = trainable_params_from_numpy(params_np, DEVICE)
    ref_loss = float(train_lib.compute_grads(
        train_lib.make_loss_fn(config, hp, MelSTFT(hp, DEVICE)), params,
        batch))
    ref = (ref_loss, [p.grad.detach().cpu() for p in tree_leaves(params)])
    del params
    out[mode] = {}
    for d, m in MESH_TRAIN:
      t0 = time.perf_counter()
      out[mode][f"{d}x{m}"] = mesh_train_case(
          mode, custom, hp, config, params_np, batch, ref, d, m, entries,
          val_entries, tmp)
      seconds[f"{mode} {d}x{m}"] = time.perf_counter() - t0
    del ref, batch
    t0 = time.perf_counter()
    out[mode]["wide"] = mesh_wide_step(mode, seed, entries)
    seconds[f"{mode} wide"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out[mode]["cli"] = mesh_cli_train(mode, seed, tmp, tmp / "mesh_wavs",
                                      val_dir, entries)
    seconds[f"{mode} cli"] = time.perf_counter() - t0
  out["seconds"] = seconds
  log("phase 13 seconds " + json.dumps(seconds))
  return out


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--seed", type=int, default=1234)
  parser.add_argument("--out", type=Path, default=Path("chiprun_out"))
  args = parser.parse_args()

  device = phase_device()
  build = phase_build()
  kernel = phase_kernel(args.seed)
  with tempfile.TemporaryDirectory() as tmp:
    # phase 8 reloads these two npz files; they are kept to the end
    paths = {"first": Path(tmp) / "1.npz", "other": Path(tmp) / "2.npz"}
    t0 = time.perf_counter()
    ckpt = full_width_checkpoint(args.seed, paths["first"])
    log(f"checkpoint 12x256 written and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    slices, first = {}, {}
    for mode in MODES:
      slices[mode], first[mode] = phase_slice(ckpt, mode, args.seed)
    # bf16 really ran: the same request (same seed) differs from f32
    bf16_vs_f32 = float(np.abs(first["bf16"] - first["f32"]).max())
    scale = float(np.abs(first["f32"]).max())
    log(f"bf16 vs f32, first request: max abs {bf16_vs_f32} (scale {scale})")
    if not bf16_vs_f32 > 0:
      fail("bf16 serving gave the f32 waveform: bf16 did not run")
    slices["bf16"]["vs_f32_max_abs"] = bf16_vs_f32
    trainable = phase_trainable(args.seed)
    trains = {}
    for mode in MODES:
      with tempfile.TemporaryDirectory() as train_tmp:
        trains[mode] = phase_train(mode, args.seed, Path(train_tmp))
    streams = {mode: phase_stream(ckpt, mode, args.seed) for mode in MODES}
    CheckpointWaveglow.from_params(full_width_params(args.seed + 1),
                                   HParams(), iteration=2).save(
                                       paths["other"])
    serves = {mode: phase_serve(ckpt, paths, mode, args.seed)
              for mode in MODES}
    clis = phase_cli(ckpt.state_dict, HParams(), args.seed, Path(tmp))
    cli_trains = {mode: phase_cli_train(mode, args.seed, Path(tmp),
                                        clis["files"])
                  for mode in MODES}
    meshes = {mode: phase_mesh(ckpt, paths, mode, args.seed)
              for mode in MODES}
    meshes["serve_refusal"] = serve_refuses_missing_cards(paths["first"],
                                                          Path(tmp))
    log("mesh serve refusal " + json.dumps(meshes["serve_refusal"]))
    t0 = time.perf_counter()
    widths = phase_widths(args.seed, Path(tmp))
    log(f"phase 12 (widths {list(WIDE_WIDTHS)}): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_train = phase_mesh_train(args.seed, Path(tmp))
    log(f"phase 13 (mesh training): {time.perf_counter() - t0:.1f} s")

  kernels = []
  for mode in MODES:
    rec = kernel["timed"][(mode, 1, False, 1)]
    wide = kernel["timed"][(mode, 1, False, 128)]
    errs = [c["max_abs_err"] for c in kernel["cases"] if c["mode"] == mode]
    kernels.append({
        "name": f"wn_layer_fused[{mode}]", "route": "cuda",
        "source": "waveglow_tpu_torch/csrc/wn_layer.cu",
        "replaces": "waveglow_tpu/kernels/wn_layer.py:259",
        "launches": (slices[mode]["launches"] + streams[mode]["launches"]
                     + serves[mode]["launches"]
                     + clis["modes"][mode]["launches"]
                     + cli_trains[mode]["synthesis_launches"]
                     + meshes[mode]["launches"]["fused"]),
        "max_abs_err": max(errs), "ms": rec["kernel_ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "design": DESIGN[mode],
        "shape": f"B=1,T={T_KERNEL},C={C},d=1",
        "ms_d128": wide["kernel_ms"], "plain_ms_d128": wide["plain_ms"],
        "library_ms_d128": wide["library_ms"],
        "launches_per_synthesis": slices[mode]["launches_per_synthesis"][0],
        "serving_launches": slices[mode]["launches"],
        "stream_launches": streams[mode]["launches"],
        "stream_launches_per_window": streams[mode]["launches_per_window"],
        "daemon_launches": serves[mode]["launches"],
        "daemon_dispatches": serves[mode]["dispatches"],
        "cli_launches": clis["modes"][mode]["launches"],
        "cli_validate_launches": cli_trains[mode]["synthesis_launches"],
        "mesh_launches": meshes[mode]["launches"]["fused"],
        # the last layer and B=8, each with its library yardstick
        **{f"{key}_{case}": kernel["timed"][shape][key]
           for case, shape in (("last", (mode, 1, True, LAST_DILATION)),
                               ("B8", (mode, 8, False, 1)))
           for key in ("kernel_ms", "library_ms", "bound_ms")},
        "ptxas": (build["ptxas"].get(variant(mode, False))
                  if build["built_in_this_run"] else build["ptxas"]),
        "loaded_build": build["attributes"][variant(mode, False)]})
  for mode in MODES:
    rec = trainable["timed"][(mode, False)]
    cases = [c for c in trainable["cases"] if c["mode"] == mode]
    # ms is the layer's forward (the kernel) plus its backward (the bf16
    # kernels, or the f32 torch ops), the work the autograd Function does;
    # the bound is that of both. max_abs_err is the forward's (the kernel's
    # outputs against the plain layer's), over every dilation and the last
    # layer
    backward = {"backward_route": BACKWARD_ROUTE[mode]}
    if mode == "bf16":
      # backward_earlier_ms: the torch-ops route the bf16 backward took
      # before its kernels, timed in this run (its plain version)
      backward.update(backward_design=BACKWARD_DESIGN,
                      backward_earlier_ms=rec["torch_backward_ms"],
                      library_backward_ms=rec["library_backward_ms"],
                      backward_launches_per_step=trains[mode][
                          "backward_launches_per_step"])
    kernels.append({
        "name": f"wn_layer_trainable[{mode}]", "route": "cuda",
        "source": "waveglow_tpu_torch/csrc/wn_layer.cu",
        "replaces": "waveglow_tpu/kernels/wn_layer.py:174",
        "launches": (trains[mode]["launches"]
                     + cli_trains[mode]["forward_launches"]),
        "train_launches": trains[mode]["launches"],
        "cli_train_launches": cli_trains[mode]["forward_launches"],
        "max_abs_err": max(c["forward_max_abs_err"] for c in cases),
        "forward_bound_max": max(c["forward_bound"] for c in cases),
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "forward_ms": rec["forward_ms"], "backward_ms": rec["backward_ms"],
        "forward_bound_ms": rec["fwd_bound_ms"],
        "backward_bound_ms": rec["bwd_bound_ms"],
        "plain_backward_ms": rec["plain_backward_ms"],
        # the six gradients against plain autograd: in gradient units
        # (dw_in reaches a few hundred), and over each gradient's max |value|
        "grad_max_abs_err": max(c["grad_max_abs_err"] for c in cases),
        "grad_max_err_of_scale": max(c["max_err_of_scale"] for c in cases),
        "grad_tolerance_of_scale": GRAD_TOL_REL[mode],
        "shape": f"B={B_TRAIN},T={T_TRAIN},C={C},d=1",
        "launches_per_step": trains[mode]["launches_per_step"], **backward})
  rec = trainable["timed"][("bf16", False)]
  last = trainable["timed"][("bf16", True)]
  cases = [c for c in trainable["cases"] if c["mode"] == "bf16"]
  # the bf16 backward kernels (one call: rows, dx, weights, reduce) against
  # wn_layer_backward at the same rounding points, every dilation and the
  # last layer; timed at d=1 and on the last layer
  kernels.append({
      "name": "wn_layer_backward_fused[bf16]", "route": "cuda",
      "source": "waveglow_tpu_torch/csrc/wn_layer_bwd.cu",
      "replaces": "waveglow_tpu/kernels/wn_layer.py:198",
      "launches": (trains["bf16"]["backward_launches"]
                   + cli_trains["bf16"]["backward_launches"]),
      "train_launches": trains["bf16"]["backward_launches"],
      "cli_train_launches": cli_trains["bf16"]["backward_launches"],
      "max_abs_err": max(c["backward_max_abs_err"] for c in cases),
      "max_err_of_scale": max(c["backward_max_err_of_scale"] for c in cases),
      "tolerance_of_scale": KERNEL_TOL_BF16_REL,
      "ms": rec["backward_ms"], "plain_ms": rec["torch_backward_ms"],
      "bound_ms": rec["bwd_bound_ms"], "bound_by": rec["bwd_bound_by"],
      "library_ms": rec["library_backward_ms"],
      "kernels_ms": rec["backward_kernels_ms"],
      "design": BACKWARD_DESIGN,
      "shape": f"B={B_TRAIN},T={T_TRAIN},C={C},d=1",
      "ms_last": last["backward_ms"],
      "plain_ms_last": last["torch_backward_ms"],
      "bound_ms_last": last["bwd_bound_ms"],
      "library_ms_last": last["library_backward_ms"],
      "launches_per_step": trains["bf16"]["backward_launches_per_step"],
      "ptxas": ({bwd_variant(k, l): build["ptxas"].get(bwd_variant(k, l))
                 for k, l, w in BWD_KERNELS if w == C}
                if build["built_in_this_run"] else build["ptxas"]),
      "loaded_build": {bwd_variant(k, l): build["attributes"][bwd_variant(k, l)]
                       for k, l, w in BWD_KERNELS if w == C}})

  for mode in MODES:
    shard = meshes[mode]["shard_kernel"]
    rec = shard["timed"][128]
    kernels.append({
        "name": f"wn_layer_shard[{mode}]", "route": "cuda",
        "source": "waveglow_tpu_torch/csrc/wn_layer_shard.cu",
        "replaces": "waveglow_tpu/kernels/wn_layer.py:259 (its Megatron "
                    "shard, waveglow_tpu/parallel/sharding.py:44)",
        "launches": meshes[mode]["launches"]["shard"],
        "max_abs_err": max(c["max_abs_err"] for c in shard["cases"]),
        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"], "design": SHARD_DESIGN[mode],
        "shape": f"B=1,T={T_KERNEL},C={C},C'=128,d=1",
        **shard_extra_keys(shard["timed"], 128),
        "loaded_build": {f"C'={cp}": kl.shard_kernel_info(
            c, cp, mode == "bf16", False)
            for c, cp in kl.shard_pairs() if c == C}})

  # phase 12: each kernel at the other widths, launched by that width's
  # serving, mesh and train() runs
  for width, rec in widths.items():
    for mode in MODES:
      fwd = rec["kernels"]["forward"][mode]
      served = rec["serving"][mode]
      trained = rec["train"][mode]
      kernels.append({
          "name": f"wn_layer_fused[{mode},C={width}]", "route": "cuda",
          "source": "waveglow_tpu_torch/csrc/wn_layer.cu",
          "replaces": "waveglow_tpu/kernels/wn_layer.py:259",
          "launches": served["launches"] + trained["launches"],
          "serving_launches": served["launches"],
          "train_launches": trained["launches"],
          "max_abs_err": max(c["max_abs_err"] for c in fwd),
          **{k: fwd[0][k] for k in ("bound_ms", "bound_by", "plain_ms",
                                    "library_ms")},
          "ms": fwd[0]["kernel_ms"], "design": WIDTH_DESIGN[width][mode],
          "kernels_ms": fwd[0]["kernels_ms"],
          **({"loaded_build_gate_round": {
                  wide_variant(k): build["attributes"][wide_variant(k)]
                  for k, cp in WIDE_KERNELS if cp == kl.WIDE_C}}
             if mode == "bf16" and width == kl.WIDE_C else {}),
          "shape": f"B=1,T={T_KERNEL},C={width},d=1",
          **{f"{key}_{case}": c[key]
             for case, c in (("d128", fwd[1]), ("last", fwd[2]))
             for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                         "kernels_ms")},
          "loaded_build": build["attributes"][variant(mode, False, width)]})
      shard = rec["kernels"]["shard"][mode]
      pairs = sorted(shard["timed"], reverse=True)
      top = shard["timed"][pairs[0]]
      wide = mode == "bf16" and width == kl.WIDE_C
      # the mesh step of phase 13 runs the shard forward at MESH_WIDE too
      step = (mesh_train[mode]["wide"]["launches"]["shard"]
              if width == MESH_WIDE else 0)
      kernels.append({
          "name": f"wn_layer_shard[{mode},C={width}]", "route": "cuda",
          "source": ("waveglow_tpu_torch/csrc/wn_layer.cu" if wide
                     else "waveglow_tpu_torch/csrc/wn_layer_shard.cu"),
          "replaces": "waveglow_tpu/kernels/wn_layer.py:259 (its Megatron "
                      "shard, waveglow_tpu/parallel/sharding.py:44)",
          "launches": served["mesh_model2"]["launches"]["shard"] + step,
          "serving_launches": served["mesh_model2"]["launches"]["shard"],
          "train_launches": step,
          "max_abs_err": max(c["max_abs_err"] for c in shard["cases"]),
          "ms": top["kernel_ms"], "plain_ms": top["plain_ms"],
          "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
          "library_ms": top["library_ms"],
          "design": SHARD_WIDE_DESIGN if wide else SHARD_DESIGN[mode],
          **({"kernels_ms": top["kernels_ms"],
              "loaded_build_gate": {
                  wide_variant("gate", cp): build["attributes"][
                      wide_variant("gate", cp)] for cp in pairs},
              "loaded_build": {
                  shard_variant(width, cp, True, False): build["attributes"][
                      shard_variant(width, cp, True, False)]
                  for cp in pairs}} if wide else {}),
          "shape": f"B=1,T={T_KERNEL},C={width},C'={pairs[0]},d=1",
          **shard_extra_keys(shard["timed"], pairs[0])})
    bwd = rec["kernels"]["backward"]
    kernels.append({
        "name": f"wn_layer_backward_fused[bf16,C={width}]", "route": "cuda",
        "source": "waveglow_tpu_torch/csrc/wn_layer_bwd.cu",
        "replaces": "waveglow_tpu/kernels/wn_layer.py:198",
        "launches": rec["train"]["bf16"]["backward_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in bwd),
        "max_err_of_scale": max(c["max_err_of_scale"] for c in bwd),
        **{k: bwd[0][k] for k in ("plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "kernels_ms",
                                  "share_of_bound")},
        "ms": bwd[0]["kernel_ms"], "design": BACKWARD_DESIGN,
        "shape": f"B={B_TRAIN},T={T_TRAIN},C={width},d=1"})

  # phase 13: the trainable shard, launched by the mesh train() runs
  sbwd = mesh_train["shard_backward"]
  for mode in MODES:
    runs = [mesh_train[mode][f"{d}x{m}"] for d, m in MESH_TRAIN]
    launched = {k: sum(r["train_launches"][k] for r in runs)
                for k in ("shard", "shard_backward")}
    rec = sbwd["timed"][(C, C // 2)] if mode == "bf16" else sbwd["f32"]
    entry = {
        "name": f"wn_layer_shard_trainable[{mode}]", "route": "cuda",
        "source": ("waveglow_tpu_torch/csrc/wn_layer_bwd.cu"
                   if mode == "bf16"
                   else "waveglow_tpu_torch/csrc/wn_layer_shard.cu"),
        "replaces": "waveglow_tpu/parallel/sharding.py:44 (the autodiff "
                    "of the WN layer under a model axis)",
        "ms": rec.get("kernel_ms", rec.get("ms")),
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "shape": f"B={B_TRAIN},T={T_TRAIN},C={C},C'={C // 2},d=1",
        "forward_launches": launched["shard"],
        "mesh_steps": {f"{d}x{m}": {k: mesh_train[mode][f"{d}x{m}"][k]
                                    for k in ("loss_err", "grad_norm_rel",
                                              "median_step_s",
                                              "device_busy_ms", "idle_share",
                                              "max_memory_allocated_bytes")}
                       for d, m in MESH_TRAIN},
        "cli_two_processes": {k: mesh_train[mode]["cli"][k]
                              for k in ("loss_err", "grad_norm_rel",
                                        "reduce", "wall_s")}}
    if mode == "bf16":
      entry.update(
          launches=launched["shard_backward"],
          max_abs_err=max(c["max_abs_err"] for c in sbwd["cases"]),
          max_err_of_scale=max(c["max_err_of_scale"] for c in sbwd["cases"]),
          tolerance_of_scale=KERNEL_TOL_BF16_REL, design=SHARD_BWD_DESIGN,
          pairs={f"C={c},C'={cp}": {k: r[k] for k in (
              "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "share_of_bound", "kernels_ms")}
              for (c, cp), r in sorted(sbwd["timed"].items())},
          loaded_build={shard_bwd_variant(*v): build["attributes"][
              shard_bwd_variant(*v)] for v in SHARD_BWD_KERNELS
              if v[1] == C and v[2] == C // 2})
    else:
      # the f32 backward is torch ops (the parity-mode route); ms is its
      # time, the forward kernel's is wn_layer_shard[f32]'s
      entry.update(launches=launched["shard"],
                   max_abs_err=rec["max_abs_err"],
                   max_err_of_scale=rec["max_err_of_scale"],
                   backward_route="torch ops")
    kernels.append(entry)

  args.out.mkdir(parents=True, exist_ok=True)
  detail = {"device": device, "build": build,
            "kernel_cases": kernel["cases"], "slices": slices,
            "streams": streams, "serves": serves, "cli": clis,
            "cli_train": cli_trains, "mesh": meshes,
            "trainable_cases": trainable["cases"], "train": trains,
            "widths": {str(w): r for w, r in widths.items()},
            "mesh_train": {**{k: v for k, v in mesh_train.items()
                              if k != "shard_backward"},
                           "shard_backward": {
                               "cases": sbwd["cases"], "f32": sbwd["f32"]}},
            "kernels": kernels}
  (args.out / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
  print(json.dumps({"kernels": kernels}))
  print(device["nvidia_smi"])
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
