#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`slide_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a card, `nvcc` and PyTorch
built for CUDA.  It builds the kernels itself into `build/`.  Phases, one
line each as soon as it ends:

  env      torch and CUDA versions; the card's name and power limit
  build    one nvcc per kernel source, all at once, then the link: seconds
           and the ptxas report
  k3       the FPS kernel against its plain PyTorch version at every shape
           the decode and the SAP net give it (batch 16, random and zero
           starts) and at training's (batch 32: 2049 -> 16, the encoder's
           and the SAP net's levels): indices must be equal; the
           threads per block (`threads_for`), kernel ms, plain ms and the
           bound per shape
  k1_plan  per net and per occupancy (1 and 2 blocks per SM, where a plan
           fits), the fused denoiser's plan: shared memory per block, the
           clusters the card holds at once, row buffers in device memory,
           whether it is the net's own plan; the kernel at batch 16 under
           that plan against the plain version (atol 1e-4), and its ms
  k1       the fused-denoiser kernel against its plain PyTorch version, kp
           and latent nets with the committed weights, batch 16, 5 and 64
           (the presets' eval batch):
           max abs error (atol 1e-4); kernel ms, plain ms, the eager module's
           ms (the unfused forward, the yardstick) and the bound (the weight
           dots as 3xTF32 on the tensor cores, which is what the kernel runs;
           beside it the same dots at the fp32 FFMA rate, fp32_operations_ms)
  slice    the main path: position DDPM -> feature DDPM -> AE decode -> SAP
           refine+upsample -> DPSR 128^3 -> marching tetrahedra and 2048
           surface samples, at full width, batch 16, T=1000, committed
           checkpoints, fused denoisers (the default): a warm-up pass, then
           the counted pass.  Seconds per stage; the cloud must be
           (16, 2048, 6), the grid (16, 128, 128, 128), the points
           (16, 2048, 3), all finite, the normals unit, every sample's mesh
           non-empty; the counted pass must launch the fused denoiser
           exactly 2000 times and FPS exactly 13 (the decode's 9, the SAP
           net's SA levels' 4)
  mesh     the counted pass's meshes (`mesh_to_host`) against the numpy
           oracle `marching_tetrahedra_numpy` on the same grids copied to the
           host, four samples (`tests/mesh_compare.py`): the same faces with
           the same winding, vertices within 1e-4 grid units, normals within
           1e-5; the card's dense counts
           (`count_cells_and_faces`) against the extraction's, active cells
           and faces per sample; then `sap_dpsr` again by parts, timed with
           CUDA events (the mirror and SAP net, the raster, the FFT solve,
           grid_interp's shift and scale) and the profiler's busiest kernels
           of a `sap` call, and DPSR on the card against DPSR on the CPU on
           the same points and normals (DPSR_ATOL)
  native_marching  `mc_from_psr` on the counted pass's grids: the native
           C++ pass (built with g++ at first use, timed apart) on a thread
           pool over all of them, native and numpy one at a time on
           MESH_SAMPLES of them, the same content (vertex and face order
           free); host seconds a shape
  fastdpm  the same stages with FastDPM, S=50 steps per chain: 100 fused
           launches, the 13 FPS launches, the slice's checks
  net      the kp and latent denoisers on the card (the module and the fused
           net) against the module on the CPU, same weights and input, atol
           1e-4 (fp32, TF32 off)
  unfused  the slice with fused=False (the modules), T cut to 100: a warm-up
           and a counted pass; no fused launch, the slice's other checks
  k2       the fused denoiser's backward against its plain version (autograd
           through the plain forward, run in float64 on the same inputs, relu
           ties resolved as the kernel resolved them: see K2_TOL), kp and
           latent nets with the committed weights, batch 32, 5 and 32 with
           duplicate points: every element of every gradient within 1e-4 *
           max(1, max |plain|), two launches equal; kernel ms, plain (fp32) ms
           and the bound (the three weight dots per forward one as 3xTF32 on
           the tensor cores, which is what the kernel runs; beside it the same
           work at the fp32 FFMA rate, fp32_operations_ms); the clusters held
           at once and the waves; the launch's parts from the profiler: the
           chain, the weight-gradient kernel, the parts' sum, the gather
  k64      K1 and K2 at 64 points: the kp and latent
           presets at num_keypoints=64 with the committed weights.  K1 at
           batch 16 against its plain version (atol 1e-4), kernel, plain and
           module ms, the bound, the plan, and K1 planned at 1 and 2 blocks
           per SM; K2 at batch 32: two launches equal, the batch's launch held
           to float64 in chunks of K64_CHECK clouds (`k2_gate_in_chunks`),
           ms, plain ms, the bound; beside each bound,
           `scratch_bytes_ms`: the rows the kernel's own design moves through
           device memory (K1's rows in scratch, K2's tape), not in the bound
  slice64  the main path at 64 keypoints, fused, T64 steps a chain,
           counted from zero: exactly 2 x T64 K1, 13 FPS and no K2 launches,
           the keypoints (16, 64, 3), the slice's checks, seconds per stage;
           each K1 and FPS shape it launched against its plain version
  k128     as k64 at 128 points, the kernels' limit, K2's float64 gate in
           chunks of K128_CHECK clouds; K2 at batch 32 runs in the tiles of its plan
           (`PackedNet.k2_tiles`: kp 2, latent 3), exactly one launch a tile;
           K2 in tiles of K2_TILE_CHECK clouds against one launch of
           K2_TILE_BATCH clouds: each cloud's rows equal, d flat within the
           K2 gate
  slice128 the main path at 128 keypoints, fused, with FastDPM at
           FASTDPM_STEPS steps a chain: exactly 100 K1, 13 FPS and no K2,
           the keypoints (16, 128, 3), the slice's checks, non-empty meshes;
           each K1 and FPS shape against its plain version
  train    position-DDPM training at the kp preset's full width and batch
           32 on a synthetic airplane tree written here: one step's card
           gradient against the module's in float64 on the CPU at the card's
           inputs, every element of every parameter within rtol 5e-3, atol
           1e-4 (the JAX package's fused-vs-module tolerance) once the relu
           ties that K2 resolved otherwise than float64 are taken off
           (`check_train_gradient`); then `train_position_ddpm`
           for a few warm-up steps (a checkpoint) and a counted run resumed
           from it: ms per step, the loss at the first and last logged
           iterations (finite), exactly one K2 and one K1 launch per step and
           at least one FPS launch per step; then a further run of
           `train_position_ddpm` under `torch.profiler`: the card's busy ms
           per step, the idle share of the counted run's step, the kernels
           and host operations that take the most time
  train64  the same at 64 keypoints (the kp preset at num_keypoints=64):
           the gradient gate, TRAIN64_WARMUP warm-up and TRAIN64_STEPS counted
           steps with exactly one K3, one K1 and one K2 a step, the profiled
           run, each K1 / K2 / FPS shape against its plain version
  train128 the same at 128 keypoints: the gradient gate on the batch's
           first TRAIN128_CHECK clouds, TRAIN128_WARMUP warm-up and
           TRAIN128_STEPS counted steps with exactly one K3 and one K1 a step
           and one K2 a tile of K2's plan (2 at batch 32), the profiled run,
           each shape against its plain version (K2's launch on the whole
           batch held to float64 in chunks of TRAIN128_CHECK clouds)
  train_ae the point autoencoder at the shipped preset's full width and batch
           32 on the same tree: `encode` on the card (the committed AE
           weights, the posterior sampled) against the CPU on the same
           batch's first ENCODE_CHECK clouds and the same noise, the card's
           kNN picks replayed into the CPU run (ENCODE_TOL); then
           `train_autoencoder` for a warm-up that writes a checkpoint and a
           counted run resumed from it: ms per step, finite losses, exactly
           AE_FPS_PER_STEP FPS launches a step and no fused launch; then a
           profiled run: busy ms per step and the idle share
  train_latent  the feature DDPM at the shipped preset's full width and
           batch 32 over the committed AE (frozen): one step's card gradient
           against the CPU module's on the same latent (the `train` phase's
           gate); `train_latent_ddpm` warm-up, counted run (exactly one K1,
           one K2 and LATENT_FPS_PER_STEP FPS launches a step) and profiled
           run as for the autoencoder
  train_sap the SAP upsampler at the shipped preset's full width and batch
           32 on a tree of 128^3 DPSR grids written on the card: the SAP
           net's parameter gradient through the whole loss (the net, the
           split, DPSR, the tanh-MSE) on the card and on the CPU, the card's
           FPS picks checked and its kNN searches replayed, each side within
           SAP_GRAD_TOL of a float64 run, the card within SAP_CARD_CPU_TOL
           of the CPU; the loader's ms a batch and the grids' copy to the
           card; `train_upsampler` warm-up, counted
           run (exactly len(SAP_FPS) FPS launches a step, no fused launch)
           and profiled run as above, the peak memory; then a few steps
           with the committed AE's round trip in front (exactly
           SAP_AE_FPS_PER_STEP FPS launches a step)
  train_x0 the x0 engine's position DDPM (the keypoint preset at full width,
           batch 32, X0_CONFIG: the loss block of the JAX package's e2e
           test): one step's gradient as `train` holds it (card, CPU,
           float64), the CPU and float64 runs on the card's chamfer picks
           (a pick may part only at a tie, counted); `train_position_ddpm`
           warm-up, counted run (exactly one K3, one K1 and one K2 a step)
           and profiled run; every K1 and FPS shape it launched against its
           plain version (`KernelInputs`); `train_x0_pair`: the eps and x0
           steps on one batch in one process, timed in turns
  train_generation, train_kp_cond  the tasks `generation` and
           `keypoint_conditional_generation` at batch 32 on the tree's
           2048-point clouds with normals (`tests/conditional_layout.py`:
           the keypoint preset's widths, the JAX package's conditional
           layout): the dual-tower net's forward on the card against the CPU
           on COND_CHECK clouds, the card's kNN and FPS picks replayed, each
           side against float64 (COND_NET_TOL); warm-up, counted run
           (exactly the FPS launches the config gives a step, no K1 or K2)
           and profiled run; every FPS shape against its plain version
  train_device_data_kp, train_device_data_sap  the kp and SAP presets with
           `device_data` (the corpus on the card, each batch assembled
           there): the corpus's bytes and the seconds to read and copy it;
           one batch assembled on the card against the CPU's on the same
           draws (gathers equal, points and normals within DD_RTOL); warm-up,
           counted and profiled runs with exactly the loader path's K1, K2
           and FPS launches a step; every FPS / K1 shape against its plain
           version
  train_pvd, train_pointwise  PVCNN2 (`network_type: "pvd"`, PVD's widths)
           on `generation` at 2048 points with normals, batch 16: its
           forward on the card against the float64 CPU module on the
           card's FPS, ball-query and 3-NN picks (PVD_TOL); PointwiseNet
           (`"pointwise_net"`, its defaults) on
           `keypoint_conditional_generation` without normals, batch 32;
           warm-up, counted (exactly 4 and 1 FPS a step, no K1 / K2) and
           profiled runs; every FPS shape against its plain version
  item18_forward  the kp preset's net with global attention after every
           level and the neighbour statistics on, radius neighbourhoods:
           card vs CPU (NET_ATOL), the card's kNN picks replayed; every
           module's statistics equal
  train_bf16  the autoencoder's step at the shipped preset and batch 32 in
           fp32 and under activation_dtype "bfloat16", same batch and draws:
           every FPS and kNN pick whose input equals the fp32 step's is the
           fp32 step's (the keypoints' and the encoder's all are), finite
           losses, fp32 parameters; ms a step and peak memory of each
  eval     the checkpoint-time evaluations through the training driver's
           hooks (`train/driver.py::make_*_eval_hook`), with the committed
           checkpoints (raw weights and every EMA shadow they hold): the
           position DDPM's at the shipped eval_batch_size 64 and
           num_samples_tested 128, T=1000, fused (exactly T x batches x
           weight sets K1 launches, no FPS), and the same for the x0
           engine's hook (`eval_x0`, x0_denoise chains) with the weights
           `train_x0` left; the feature DDPM's over the
           committed AE on the airplane tree's train split (16 shapes: the
           conditional evaluation subsamples that split), T=1000 (K1 and
           FPS exact); the autoencoder's (the visual and the three
           quantitative passes, exactly AE_FPS_PER_STEP FPS a batch); the
           SAP net's grid L2 on the SAP tree's val split (exactly
           len(SAP_FPS) FPS a batch); seconds per hook and the files each
           writes; `reconstruct_meshes` on RECON_SHAPES shapes (meshes,
           clouds, points sampled from the meshes; the first mesh against
           the numpy oracle on its grid); `compute_all_metrics` of the
           feature DDPM's clouds against the tree's 2048-point val clouds on
           the card, seconds; the EMD of EMD_CHECK pairs card vs CPU
           (EMD_CARD_RTOL) and the EMD's ms per pair at 2048 points.  The
           inputs of the first launch of each K1 and FPS shape of the
           phase are kept; after it (uncounted) each is held against its
           plain version: FPS indices equal, K1 within K1_ATOL
  cli      the README's Quick start through the port's command line
           (`slide_tpu_torch.cli.main([...])` in this process), the presets
           written as JSON with `write_json_file`: `train` of the kp preset
           on the tree, 5 steps; `generate` with the committed kp checkpoint,
           16 samples at batch 16, T=1000 (exactly 1000 K1, a (16, 16, 3)
           npz); `latent-generate` with the committed latent and AE
           checkpoints on those keypoints (`--external_keypoint_file`:
           exactly 1000 K1 and 9 FPS, points and normals (16, 2048, 3),
           finite; the normals' norms, which the decode does not make unit);
           `reconstruct` of those
           clouds with the committed SAP checkpoint (4 FPS a batch of 8,
           every mesh non-empty); `evaluate --all-metrics` of them against
           the tree's val clouds (finite); `encode` then `decode` of those
           val clouds with the AE checkpoint; seconds and launches per
           subcommand (exact, CLI_LAUNCHES), the outputs' shapes
  ddp      data-parallel training, two ranks as two processes of this
           script (`--ddp-worker`) on the one card over gloo (passed
           explicitly: NCCL refuses two ranks on one device), the kp
           preset at a global batch of 32, 16 rows a rank: the first
           step's all-reduced gradient against one process's step on the
           32 rows with the same draws, per element (GRAD_RTOL /
           GRAD_ATOL); `train_position_ddpm` warm-up and 20 counted steps
           resumed from rank 0's checkpoint: the ranks' parameters
           bit-equal, exactly 1 K1, 1 K2 and 1 FPS a step on each rank, each
           K1 / K2 / FPS shape a rank launched (the new batch-16 ones
           included) against its plain version; ms a step beside the
           one-process step's at batch 32 (`train`); with two cards also
           NCCL, one rank a card, else "not run: 1 card"

Then the nvidia-smi line, one JSON line of kernel figures, and the last
line {"ok": true, "device": {...}}.  Any failure raises and exits nonzero; a
hang ends in a stack trace when the watchdog fires.
"""

import contextlib
import ctypes
import faulthandler
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from slide_tpu_torch import _build
from slide_tpu_torch.models import fused_denoiser as fd
from slide_tpu_torch.ops import fps as fps_mod
from slide_tpu_torch.configs import (autoencoder_config, keypoint_ddpm_config,
                                     latent_ddpm_config, upsampler_config)
from slide_tpu_torch.data import (DeviceCorpus, draw_assembly, get_dataloader,
                                  make_assemble_fn, write_synthetic_shapenet_psr)
from slide_tpu_torch.diffusion import (X0Schedule, calc_diffusion_hyperparams,
                                       diffusion_training_loss, latent_config_weights,
                                       latent_train_loss, x0_training_loss)
from slide_tpu_torch.models import ConditionalPointNet2, build_autoencoder
from slide_tpu_torch.nn import modules as sa_modules
from slide_tpu_torch.nn import neighborhood
from slide_tpu_torch.nn.modules import collect_neighbor_stats
from slide_tpu_torch.nn.precision import activation_dtype_scope
from slide_tpu_torch.ops import chamfer, knn_points
from slide_tpu_torch.pipeline import DEFAULT_CKPTS, build_stages, generate, with_fastdpm
from slide_tpu_torch.sap import (DPSR, count_cells_and_faces, marching_tetrahedra_numpy,
                                 mc_from_psr, mesh_to_host, mirror_and_concat,
                                 network_output_to_dpsr_grid, point_rasterize)
from slide_tpu_torch.sap.marching import native_library
from slide_tpu_torch.train import driver as train_driver
from slide_tpu_torch.train.checkpoint import find_max_iter
from slide_tpu_torch.weights import load_flax_params, load_inference_params, read_checkpoint

# the mesh gate and the conditional tasks' layouts, shared with the tests
# (neither imports JAX)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from conditional_layout import conditional_task_config, fps_launches_per_step  # noqa: E402
from mesh_compare import (MESH_NORMAL_ATOL, MESH_VERT_ATOL, mesh_difference,  # noqa: E402
                          same_content)
from pick_replay import pvcnn2_picks_replayed  # noqa: E402

faulthandler.dump_traceback_later(1100, exit=True)

BATCH = 16
T_STEPS = 1000
T_UNFUSED = 100        # the unfused slice, cut so that the run stays short
FASTDPM_STEPS = 50
# the main path's batch, an odd one, and the presets' eval batch
K1_BATCHES = (16, 5, 64)
K1_ATOL = 1e-4
NET_ATOL = 1e-4
K2_BATCHES = (32, 5)   # the kp preset's training batch, and an odd one
# K2 against its plain version run in float64 on the same fp32 inputs (at
# exact duplicates the fp32 plain version's d(pc) sums terms of ~1e7 that
# cancel): every element of each gradient within 1e-4 x max(1, max |plain|).
# A relu whose input lies within fp32 rounding of 0 (a tie) passes its
# gradient in one fp32 backward and not in another; the reference resolves
# such ties as the kernel did (`fused_backward_reference`), and the ties so
# resolved are logged.
K2_TOL = 1e-4
TRAIN_BATCH = 32
TRAIN_WARMUP = 5
TRAIN_STEPS = 100
PROFILE_STEPS = 15
# one step's card gradient against the float64 module's on the CPU, per
# element (the JAX package's fused-vs-module tolerance), once K2's tie
# decisions are taken off
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
# how far the CPU's own net inputs (x_t, the timestep embedding t4) may lie
# from the card's before the card's values replace them in the gradient
# gate's CPU runs: rounding, on the scale of a relu tie (`tie` in
# `fused_backward_reference`), x max(1, max |input|)
INPUT_TOL = 1e-5
# (N, K) of the FPS calls of one decode, in call order: the keypoint level's
# trim, level 2's SA stack and trim, level 3's SA stack and trim
DECODE_FPS = [(512, 256), (256, 128), (128, 64), (64, 16), (2048, 1024),
              (1024, 256), (256, 64), (64, 16), (4096, 2048)]
# (N, K) of the FPS calls of the SAP net's four SA levels on the mirrored
# cloud of 2 x 2048 points
SAP_FPS = [(4096, 1024), (1024, 256), (256, 64), (64, 16)]
PASS_FPS = DECODE_FPS + SAP_FPS
# the samples of the counted pass whose meshes are held to the numpy oracle's
MESH_SAMPLES = 4
# DPSR on the card against DPSR on the CPU, same points and normals, on
# fields of magnitude ~1: the card's scatter adds in no fixed order and
# cuFFT rounds otherwise than the CPU's FFT (measured 5.4e-7 on a sphere's
# 2 x 20480 points at 128^3)
DPSR_ATOL = 1e-5
# (N, K, batch) of training's call (the keypoints of a 2048-point cloud and
# its centroid)
TRAIN_FPS = (2049, 16, 32)
# (N, K) of the FPS calls of the encoder's four SA levels at batch 32
ENCODER_FPS = [(2048, 1024), (1024, 256), (256, 64), (64, 32)]
# the autoencoder and latent training runs (steps of batch 32)
AE_WARMUP, AE_STEPS = 3, 20
LAT_WARMUP, LAT_STEPS = 3, 20
TASK_PROFILE_STEPS = 5
# FPS launches a step, from the code: an AE step runs the keypoints (1), the
# encoder's SA levels (4), the decode's (the keypoint level's trim, then
# three SA levels and a trim at each decoder level: 9) and the per-level
# targets (1); a latent step the keypoints and the frozen encoder's levels
AE_FPS_PER_STEP = 1 + len(ENCODER_FPS) + len(DECODE_FPS) + 1
LATENT_FPS_PER_STEP = 1 + len(ENCODER_FPS)
# the SAP upsampler's training (steps of batch 32) on a tree of 128^3 grids
# written on the card: SAP_MODELS models a split in each of four categories
SAP_CATEGORIES = ("02691156", "02933112", "02958343", "03001627")
SAP_MODELS = 8
SAP_WARMUP, SAP_STEPS = 3, 20
# K3 launches a step, from the code: the SAP net's four SA levels; with the
# AE round trip first the keypoints (1), the frozen encoder's levels (4) and
# the decode's nine calls
SAP_AE_FPS_PER_STEP = 1 + len(ENCODER_FPS) + len(DECODE_FPS) + len(SAP_FPS)
SAP_AE_STEPS = 3
SAP_AE_NOISE = 0.02
# the gradient gate on the batch's first clouds, of the largest gradient
# element: each fp32 side (card, CPU) within SAP_GRAD_TOL of the float64 run
# on the same picks and searches, and the card within SAP_CARD_CPU_TOL of
# the CPU; measured 1.97e-3 from float64 on both sides (in the same
# elements: the fp32 map into DPSR's cube decides a few points' cells
# alike on both), 8.7e-5 card vs CPU (H100 80GB HBM3, 700 W)
SAP_GRAD_CLOUDS = 2
SAP_GRAD_TOL, SAP_CARD_CPU_TOL = 5e-3, 5e-4
SAP_LOADER_BATCHES = 3
# encode on the card against the CPU: the CPU re-encodes this many clouds of
# the batch (the encoder at 2048 points runs ~1 s a cloud on the CPU)
ENCODE_CHECK = 4
# every element within ENCODE_TOL x max(1, max |cpu|), the card's kNN picks
# replayed into the CPU run: measured 1.05e-5 of 4.24 here (the committed
# AE, batch 32's first four clouds) and 5.2e-6 of 3.24 in
# tests/test_torch_cuda.py (batch 2), i.e. 2.5e-6 and 1.6e-6 of the
# features' size (H100 80GB HBM3), since GroupNorm sums its statistics in
# float64 (1.12e-3 and 1.59e-3 before: the CPU's fp32 sums)
ENCODE_TOL = 5e-5
# the checkpoint-time evaluations: the shipped presets' eval batch and test
# set (kp, latent, AE), the iteration tag of the files they write; the
# conditional (latent) evaluation subsamples the train split, which holds
# 16 shapes of the tree (cut from 128)
EVAL_BATCH, EVAL_SAMPLES = 64, 128
LATENT_EVAL_SAMPLES = 16
EVAL_ITER = 99
# the shapes `reconstruct_meshes` takes from the SAP tree's val split, in
# two batches
RECON_SHAPES = 8
# the EMD of the first EMD_CHECK pairs (generated cloud, reference), card
# against CPU: within EMD_CARD_RTOL of the CPU's, relative (fp32 sums in
# other orders, through weights exp(-16384 d) that multiply a rounding gap
# of d by 16384)
EMD_CHECK = 4
EMD_CARD_RTOL = 1e-4
# the x0 engine's position DDPM: the keypoint preset with the loss block of
# tests/test_train_e2e.py::test_x0_engine_position_training
X0_CONFIG = {"beta_schedule": "linear", "beta_start": 1e-4, "beta_end": 0.02,
             "num_diffusion_timesteps": 1000, "data_clamp_range": 1.0,
             "model_output_scale_factor": 1.0, "loss_type": "mixed_cd_t_epsilon_mse",
             "t_trunction": 100, "normal_loss_type": "mse"}
# a chamfer pick of a later run (CPU fp32, float64) may part from the
# card's only where the two candidates' float64 squared distances lie within
# CHAMFER_TIE_RTOL of the clouds' squared scale (fp32 rounding of the matmul
# form); such rows are counted as ties and take the card's pick
CHAMFER_TIE_RTOL = 1e-6
# the eps and x0 position steps timed in turns in one process
PAIR_STEPS = 50
# the conditional tasks (tests/conditional_layout.py) at batch 32 on the
# 2048-point clouds with normals; the dual-tower net's forward on the card
# against the CPU on COND_CHECK clouds, the card's kNN and FPS picks replayed,
# each side and card vs CPU within COND_NET_TOL x max(1, max |float64|)
COND_WARMUP, COND_STEPS = 3, 20
COND_CHECK = 2
COND_NET_TOL = 1e-4
# the autoencoder's step in bf16 (`activation_dtype`) against fp32, batch
# 32: a step's picks compared, then warm-up and timed steps of each
BF16_WARMUP, BF16_STEPS = 2, 5
# the corpus on the device (`device_data`): the kp preset on the airplane
# tree and the SAP preset on the tree of 128^3 grids, batch 32; the card's
# assembly against the CPU's on the same draws: gathers equal, the points
# and normals within DD_RTOL x max(1, max |cpu|) (a mean over the points, a
# few products)
DD_WARMUP, DD_STEPS = 3, 50
DD_SAP_WARMUP, DD_SAP_STEPS = 2, 20
# the step in steady state (`steady_steps`): steps a route, in turns
DD_PAIR_STEPS, DD_SAP_PAIR_STEPS, BACKBONE_STEADY_STEPS = 20, 5, 5
DD_RTOL = 1e-6
# PVCNN2 (`network_type: "pvd"`, PVD's widths) on the task `generation` at
# 2048 points with normals, batch 16: FPS at its four SA levels a step; its
# forward on the card against the float64 CPU module on PVD_CHECK clouds,
# the card's FPS, ball-query and 3-NN picks replayed (tests/pick_replay.py),
# within PVD_TOL x max(1, max |float64|)
PVD_BATCH = 16
PVD_FPS = [(2048, 1024), (1024, 256), (256, 64), (64, 16)]
PVD_WARMUP, PVD_STEPS, PVD_PROFILE_STEPS = 2, 5, 2
PVD_CHECK = 2
PVD_TOL = 1e-4
# PointwiseNet (`network_type: "pointwise_net"`, its defaults) on the task
# `keypoint_conditional_generation` without normals, batch 32: the keypoints'
# FPS a step
PW_WARMUP, PW_STEPS = 3, 20
# item 18's options on the kp preset (module path): global attention after
# both SA and FP levels, the neighbour statistics, ball queries of radius
# ITEM18_RADIUS over the batch's keypoints; card vs CPU within NET_ATOL x
# max(1, max |cpu|), the card's kNN picks replayed; the statistics equal
ITEM18_RADIUS = [0.4, 0.8]
# the host's marching tetrahedra on the counted pass's 128^3 grids: native
# (threads) on all of them, native serial and numpy on MESH_SAMPLES
MARCHING_THREADS = 8
# the command line's Quick start (`phase_cli`): the kp preset's training
# steps, the samples generated at one batch, and each subcommand's exact
# launches: T K1 per chain; the decode's FPS calls; the SAP net's four a
# batch of 8 (reconstruct's default batch); the keypoints (1), the encoder's
# levels and the decode's calls a batch of 32 (encode's default batch)
CLI_TRAIN_STEPS = 5
CLI_SAMPLES = 16
CLI_LAUNCHES = {
    "train": {"fps": CLI_TRAIN_STEPS, "fused_denoiser": CLI_TRAIN_STEPS,
              "fused_denoiser_bwd": CLI_TRAIN_STEPS},
    "generate": {"fps": 0, "fused_denoiser": T_STEPS},
    "latent-generate": {"fps": len(DECODE_FPS), "fused_denoiser": T_STEPS},
    "reconstruct": {"fps": len(SAP_FPS) * -(-CLI_SAMPLES // 8), "fused_denoiser": 0},
    "evaluate": {"fps": 0, "fused_denoiser": 0},
    "encode": {"fps": 1 + len(ENCODER_FPS) + len(DECODE_FPS), "fused_denoiser": 0},
    "decode": {"fps": len(DECODE_FPS), "fused_denoiser": 0},
}
# data-parallel training (`phase_ddp`): two ranks, the kp preset's global
# batch of 32, a warm-up that writes a checkpoint, then counted steps
DDP_WORLD = 2
DDP_BATCH = 32
DDP_WARMUP, DDP_STEPS = 3, 20
DDP_TIMEOUT = 300
# 64 points: the kp and latent presets at num_keypoints=64 with the
# committed checkpoints (a ConditionalPointNet2's weights do not depend on
# N).  `k64` holds K1 at batch 16 and K2 at batch 32 against their plain
# versions, K2's launch on the batch held to float64 in chunks of K64_CHECK
# clouds (`k2_gate_in_chunks`); `slice64` runs the chain at T64 steps;
# `train64` the kp preset's training
N64 = 64
T64 = T_STEPS
K64_CHECK = 4
TRAIN64_WARMUP, TRAIN64_STEPS = 3, 20
# the FPS shapes new at 64 keypoints: the decode's first trim (2048 -> 256
# at batch 16; 512 -> 256 at 16 keypoints) and training's keypoint draw
# (2049 -> 64 at batch 32)
K64_FPS = [(2048, 256, BATCH), (2049, N64, TRAIN_BATCH)]
# 128 points, the fused kernels' limit (`fused_denoiser.MAX_POINTS`), as at
# 64: `k128` (K1 at batch 16; K2 at batch 32 in the tiles of its plan, the
# float64 gate in chunks of K128_CHECK clouds; K2 in tiles of K2_TILE_CHECK clouds
# against one launch of K2_TILE_BATCH clouds); `slice128` the chain with
# FastDPM at FASTDPM_STEPS (at T=1000 it would take minutes); `train128`
# the kp preset's training, its gradient gate on the batch's first
# TRAIN128_CHECK clouds and K2's float64 gate in chunks of as many (the
# float64 references of the whole batch would not fit the card)
N128 = 128
K128_CHECK = 2
K2_TILE_BATCH, K2_TILE_CHECK = 8, 3
TRAIN128_CHECK = 8
TRAIN128_WARMUP, TRAIN128_STEPS = 3, 20
# the FPS shapes new at 128 keypoints: the decode's first trim (4096 -> 256
# at batch 16) and training's keypoint draw (2049 -> 128 at batch 32)
K128_FPS = [(4096, 256, BATCH), (2049, N128, TRAIN_BATCH)]
# published H100 SXM peaks (fp32 outside the tensor cores; dense TF32 on the
# tensor cores; HBM3)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


_START = time.perf_counter()


def log(phase, **kw):
    """One JSON line: the phase, its figures, and `t`, the seconds since the
    script started."""
    print(json.dumps({"phase": phase, **kw, "t": time.perf_counter() - _START}), flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fps_bound_parts(b: int, n: int, k: int, d: int = 3) -> tuple[float, float]:
    """(bytes ms, operations ms): each input read once and each output written
    once at the memory rate; (k-1) rounds x n points x 3d flops (d subs, d
    muls, d-1 adds, one min) at the fp32 rate."""
    bytes_ = b * n * d * 4 + b * 4 + b * k * 4
    flops = (k - 1) * b * n * 3 * d
    return 1e3 * bytes_ / PEAK_BYTES, 1e3 * flops / PEAK_FP32_FLOPS


def bound(parts) -> tuple[float, str]:
    t_bytes, t_ops = parts
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def phase_k3(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    per_shape, max_err = {}, 0
    shapes = ({(n, k, BATCH) for n, k in PASS_FPS} | {TRAIN_FPS} | set(K64_FPS) | set(K128_FPS)
              | {(n, k, TRAIN_BATCH) for n, k in ENCODER_FPS + SAP_FPS})
    for n, k, b in sorted(shapes):
        xyz = torch.randn((b, n, 3), generator=gen, device=dev)
        starts = {"random": torch.randint(0, n, (b,), generator=gen, device=dev,
                                          dtype=torch.int32),
                  "zero": torch.zeros((b,), dtype=torch.int32, device=dev)}
        for kind, start in starts.items():
            got = fps_mod.fps_cuda(xyz, k, start)
            want = fps_mod.fps_plain(xyz, k, start)
            torch.cuda.synchronize()
            max_err = max(max_err, int((got - want).abs().max()))
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"fps N={n} K={k} {kind} start: {bad} indices differ")
        start = starts["random"]
        ms = cuda_ms(lambda: fps_mod.fps_cuda(xyz, k, start), reps=20)
        plain_ms = cuda_ms(lambda: fps_mod.fps_plain(xyz, k, start), reps=2)
        parts = fps_bound_parts(b, n, k)
        per_shape[(n, k, b)] = (ms, plain_ms, parts)
        bound_ms, bound_by = bound(parts)
        log("k3", n=n, k=k, batch=b, equal=True, threads=fps_mod.threads_for(n), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by)
    return per_shape, max_err


def _table_work(lay: dict, b: int) -> tuple[int, int, list]:
    """(flops, weight floats, products) of one fused forward at batch b,
    from the packed net's layer table: the weight dots, 2 * rows * c_in *
    c_out each, and every weight once.  `products` lists each dot as (rows
    in, c_in, rows out, c_out, where K1 reads its input, where it writes its
    output) per cloud: 0 / 1 for K1's two row buffers (`buf`, `bglob`),
    None for shared memory always (the level features, the point buffer)
    or the kernel's own inputs and output."""
    n = lay["n"]
    tot = {"flops": 0, "weights": 0, "products": []}

    def dense(d, rows, src=None, dst=None, rows_out=None):
        tot["flops"] += 2 * b * rows * d["cin"] * d["cout"]
        tot["weights"] += d["cin"] * d["cout"] + (d["cout"] if d["b"] >= 0 else 0)
        tot["products"].append((rows, d["cin"], rows if rows_out is None else rows_out,
                                d["cout"], src, dst))

    def norm(nd):
        tot["weights"] += 2 * (nd["c"] - nd["c"] % nd["g"])

    def mlp(m, rows, src, dst):
        # the first layer reads src, the others work in place in dst
        for i in range(m["n_layers"]):
            dense(m["conv"][i], rows, src if i == 0 else dst, dst)
            norm(m["norm"][i])
        if m["inject_t"]:
            dense(m["fc_t"], 1)
        if m["inject_c"]:
            dense(m["fc_c"], 1)
        if m["res"] == 2:
            dense(m["res_conv"], rows, src, dst)

    def att(a, k):
        # the grouped rows and scores in buffer 0, the values in buffer 1;
        # the point-wise product written to each of a point's k slots
        dense(a["feat_conv"], n, None, 0, rows_out=n * k)
        for key in ("grouped_conv", "w_conv_1", "w_conv_2"):
            dense(a[key], n * k, 0, 0)
        dense(a["out_conv"], n * k, 1, 1)
        for key in ("w_norm_1", "w_norm_2", "out_norm"):
            norm(a[key])

    for s in lay["sa"][:lay["n_sa"]]:
        mlp(s["mlp"], n * s["k"], 0, 1)
        att(s["att"], s["k"])
    for f in lay["fp"][:lay["n_fp"]]:
        mlp(f["mlp1"], n * f["k"], 0, 1)
        att(f["att"], f["k"])
        mlp(f["mlp2"], n, None, 0)
    dense(lay["head1"], n, None, 0)
    norm(lay["head_norm"])
    dense(lay["head_out"], n, 0, None)
    return tot["flops"], tot["weights"], tot["products"]


def tc_ms(flops: float) -> float:
    """flops of fp32 dots run as 3xTF32 on the tensor cores (three TF32
    products per fp32 one) at the dense TF32 peak, in ms."""
    return 1e3 * 3 * flops / PEAK_TF32_FLOPS


def k1_row_floats(lay: dict, products: list) -> int:
    """Floats a cloud that K1's products move through its row buffers where
    the plan puts them in the block's device scratch (`bglob`): each
    product's input rows read there once, its output rows written there
    once.  0 when both buffers are in shared memory."""
    glob = lay["bglob"]
    return sum((rin * cin if src is not None and glob[src] else 0)
               + (rout * cout if dst is not None and glob[dst] else 0)
               for rin, cin, rout, cout, src, dst in products)


def k2_tape_floats(products: list) -> int:
    """Floats a cloud that K2's products move through its tape in device
    memory: each dot's input rows read and output rows written once by the
    recompute, its output gradient read and input gradient written once by
    the backward's d input = dY W^T, and both read once by the weight
    gradient's d W = X^T dY."""
    return 3 * sum(rin * cin + rout * cout for rin, cin, rout, cout, _, _ in products)


def k1_bound_parts(lay: dict, b: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of one fused forward at batch b: inputs,
    output and weights once at the memory rate; the weight dots as 3xTF32 on
    the tensor cores, which is how the kernel computes them."""
    flops, weights, _ = _table_work(lay, b)
    n = lay["n"]
    io = b * n * lay["din"] + b * lay["t4"] + b * lay["cls"] + b * n * lay["out_dim"]
    return 1e3 * 4 * (io + weights) / PEAK_BYTES, tc_ms(flops)


def k2_bound_parts(lay: dict, b: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of one fused backward at batch b: inputs
    (pc, t4, cls, the cotangent, the weights) read once and the gradients
    (of pc, t4, cls and the weights) written once at the memory rate; three
    weight dots per forward one (the recompute, d input, d weight) as 3xTF32
    on the tensor cores, which is how the kernel computes them."""
    flops, weights, _ = _table_work(lay, b)
    n = lay["n"]
    io = 2 * (b * n * lay["din"] + b * lay["t4"] + b * lay["cls"]) + b * n * lay["out_dim"]
    return 1e3 * 4 * (io + 2 * weights) / PEAK_BYTES, tc_ms(3 * flops)


def k1_scratch_ms(lay: dict, b: int) -> float:
    """The rows that K1's plan moves through the blocks' device scratch at
    batch b (`k1_row_floats`), in ms at the memory rate.  Traffic of the
    design, not of the function: logged as `scratch_bytes_ms` beside the
    bound, never counted in it."""
    return 1e3 * 4 * b * k1_row_floats(lay, _table_work(lay, b)[2]) / PEAK_BYTES


def k2_scratch_ms(lay: dict, b: int) -> float:
    """The rows that K2 moves through its tape at batch b
    (`k2_tape_floats`), in ms at the memory rate; as `k1_scratch_ms`, the
    design's traffic, beside the bound and not in it."""
    return 1e3 * 4 * b * k2_tape_floats(_table_work(lay, b)[2]) / PEAK_BYTES


def fp32_ms(flops: float) -> float:
    """flops at the fp32 FFMA rate, in ms."""
    return 1e3 * flops / PEAK_FP32_FLOPS


def k1_max_clusters(packed) -> int:
    """How many of K1's clusters the card holds at once with this net's
    shared memory per block."""
    lib = _build.load_kernels()
    n = ctypes.c_int(0)
    _build.check(lib, lib.slide_fused_max_clusters(packed.layout["smem_bytes"],
                                                   packed.layout["occupancy"],
                                                   torch.cuda.current_device(),
                                                   ctypes.byref(n)), "fused_denoiser")
    return n.value


def k2_max_clusters(packed) -> int:
    """How many of K2's chain clusters the card holds at once under this
    net's K2 plan."""
    lib = _build.load_kernels()
    lay2 = packed.layout2
    n = ctypes.c_int(0)
    _build.check(lib, lib.slide_fused_bwd_max_clusters(
        lay2["smem_bytes"], lay2["cluster"], lay2["occupancy"], torch.cuda.current_device(),
        ctypes.byref(n)), "fused_denoiser_bwd")
    return n.value


def k2_parts_ms(fn, reps: int = 5) -> dict:
    """Device ms per launch of K2's parts, from the profiler: the chain, the
    weight-gradient kernel, the parts' sum, and the rest (the gather of the
    transposed weights and the wrapper's other kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {"chain": 0.0, "weight_grad": 0.0, "parts_sum": 0.0, "rest": 0.0}
    for e in prof.key_averages():
        us = _device_us(e)
        if "fused_denoiser_bwd_kernel" in e.key:
            parts["chain"] += us
        elif "weight_grad_kernel" in e.key:
            parts["weight_grad"] += us
        elif "sum_parts_kernel" in e.key:
            parts["parts_sum"] += us
        else:
            parts["rest"] += us
    return {k: v / 1e3 / reps for k, v in parts.items()}


def k1_inputs(net, b: int, n: int, width: int, gen, dev):
    pc = torch.randn((b, n, width), generator=gen, device=dev)
    ts = torch.randint(0, T_STEPS, (b,), generator=gen, device=dev)
    label = torch.randint(0, 13, (b,), generator=gen, device=dev)
    with torch.no_grad():
        return pc, ts, label, net.t_embedder(ts), net.class_emb(label)


def k1_nets(stages):
    return [("kp", stages.kp_net, stages.kp_fused, 3),
            ("lat", stages.lat_net, stages.lat_fused, 3 + stages.latent_dim)]


def pack_at(net, spec, occupancy: int):
    """The net packed with K1 planned for `occupancy` blocks per SM: the plan
    tries only that occupancy's placements."""
    placements = fd.K1_PLACEMENTS
    fd.K1_PLACEMENTS = tuple(p for p in placements if p[0] == occupancy)
    try:
        return fd.pack_weights(net, spec)
    finally:
        fd.K1_PLACEMENTS = placements


def phase_k1_plans(stages, dev) -> None:
    """Per net, K1 planned for one and for two blocks per SM (where a plan
    fits) at the main path's batch: each checked against the plain version
    and timed, so that the plan the net takes can be seen to be the faster."""
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, net, fn, width in k1_nets(stages):
        pc, _, _, t4, cls = k1_inputs(net, BATCH, fn.spec["n"], width, gen, dev)
        with torch.no_grad():
            want = fd.fused_forward_plain(fn.spec, fn.packed, pc, t4, cls)
        for occupancy in (1, 2):
            try:
                packed = pack_at(net, fn.spec, occupancy)
            except ValueError as e:
                log("k1_plan", net=name, blocks_per_sm=occupancy, fits=False, why=str(e))
                continue
            lay = packed.layout
            with torch.no_grad():
                got = fd.fused_forward_cuda(packed, pc, t4, cls)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not (err <= K1_ATOL and bool(torch.isfinite(got).all())):
                    raise AssertionError(f"k1 {name} at {occupancy} blocks per SM: kernel "
                                         f"and plain differ by {err}")
                ms = cuda_ms(lambda: fd.fused_forward_cuda(packed, pc, t4, cls), 50)
            log("k1_plan", net=name, blocks_per_sm=occupancy, fits=True,
                own=lay["occupancy"] == fn.packed.layout["occupancy"],
                smem_bytes=lay["smem_bytes"], max_clusters=k1_max_clusters(packed),
                stage_floats=lay["stage"], rows_in_device_memory=lay["bglob"], batch=BATCH,
                max_abs_err=err, atol=K1_ATOL, ms=ms)
            del packed


def phase_k1(stages, dev) -> tuple[dict, float]:
    """K1 against its plain version; per (net, batch): kernel, plain and
    module ms and the bound parts."""
    gen = torch.Generator(device=dev).manual_seed(1)
    res, max_err = {}, 0.0
    for name, net, fn, width in k1_nets(stages):
        for b in K1_BATCHES:
            pc, ts, label, t4, cls = k1_inputs(net, b, fn.spec["n"], width, gen, dev)
            with torch.no_grad():
                got = fd.fused_forward_cuda(fn.packed, pc, t4, cls)
                want = fd.fused_forward_plain(fn.spec, fn.packed, pc, t4, cls)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                if not (err <= K1_ATOL and bool(torch.isfinite(got).all())):
                    raise AssertionError(f"k1 {name} batch {b}: kernel and plain "
                                         f"differ by {err}")
                ms = cuda_ms(lambda: fd.fused_forward_cuda(fn.packed, pc, t4, cls), 50)
                plain_ms = cuda_ms(
                    lambda: fd.fused_forward_plain(fn.spec, fn.packed, pc, t4, cls), 10)
                module_ms = cuda_ms(lambda: net(pc, ts=ts, label=label), 10)
            parts = k1_bound_parts(fn.packed.layout, b)
            scratch = k1_scratch_ms(fn.packed.layout, b)
            res[(name, b)] = (ms, plain_ms, module_ms, parts, scratch)
            bound_ms, bound_by = bound(parts)
            log("k1", net=name, batch=b, max_abs_err=err, atol=K1_ATOL, ms=ms,
                plain_ms=plain_ms, module_ms=module_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes_ms=parts[0], operations_ms=parts[1],
                scratch_bytes_ms=scratch,
                fp32_operations_ms=fp32_ms(_table_work(fn.packed.layout, b)[0]))
    return res, max_err


def run_slice(phase, stages, seed, want_fused):
    """One counted pass of `generate`: launch counts from zero, shape,
    finiteness and mesh checks, one log line."""
    _build.launch_counts.clear()
    out = generate(stages, seed=seed)
    launches = dict(_build.launch_counts)
    b = stages.batch
    res = stages.dpsr.res
    norms = torch.linalg.vector_norm(out["normals"], dim=-1)
    checks = {
        "cloud": tuple(out["cloud"].shape) == (b, 2048, 6)
        and bool(torch.isfinite(out["cloud"]).all()),
        "grid": tuple(out["grid"].shape) == (b, *res) and bool(torch.isfinite(out["grid"]).all()),
        "meshes": bool((out["n_faces"] > 0).all()),
        "points": tuple(out["points"].shape) == (b, 2048, 3)
        and bool(torch.isfinite(out["points"]).all()),
        "unit_normals": bool(((norms - 1).abs() < 1e-4).all()),
    }
    log(phase, batch=b, seconds=out["seconds"], shape=list(out["cloud"].shape),
        grid=list(out["grid"].shape), checks=checks, launches=launches,
        n_faces=out["n_faces"].tolist(), n_cells=out["n_cells"].tolist())
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{phase}: failed {bad}")
    if launches.get("fps", 0) != len(PASS_FPS):
        raise AssertionError(f"{phase}: {launches.get('fps', 0)} FPS launches, expected "
                             f"{len(PASS_FPS)} (the decode's {len(DECODE_FPS)}, the SAP "
                             f"net's {len(SAP_FPS)})")
    if launches.get("fused_denoiser", 0) != want_fused:
        raise AssertionError(f"{phase}: {launches.get('fused_denoiser', 0)} fused "
                             f"denoiser launches, expected {want_fused}")
    return out, launches


class Parts:
    """Device ms of named parts of a run, timed with CUDA events."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def __call__(self, name):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events[name] = (start, end)

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: start.elapsed_time(end) for k, (start, end) in self.events.items()}


def top_kernels(fn, n: int = 10) -> list:
    """The kernels of one call of `fn` that take the most time on the card,
    from the profiler: [name, ms, launches]."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
            if _device_us(e) > 0]
    return [list(r) for r in sorted(rows, key=lambda r: -r[1])[:n]]


def phase_mesh(stages, out, dev) -> dict:
    """The counted pass's meshes against the numpy oracle, the dense counts
    against the extraction's, `sap_dpsr` by parts, and DPSR card vs CPU."""
    grid = out["grid"]
    res = grid.shape[-1]
    faces = out["n_faces"].tolist()
    picks = sorted({0, 1, int(np.argmax(faces)), int(np.argmin(faces))})[:MESH_SAMPLES]
    per_sample = {}
    for i in picks:
        want = marching_tetrahedra_numpy(grid[i].cpu().numpy())
        err = mesh_difference(mesh_to_host(out["mesh"], i), want, float(res))
        per_sample[i] = err
        if not (err["same_sizes"] and err["same_faces"] and err["vert_err"] <= MESH_VERT_ATOL
                and err["normal_err"] <= MESH_NORMAL_ATOL):
            raise AssertionError(f"mesh: sample {i} differs from the numpy oracle: {err}")
    cells, dense_faces = count_cells_and_faces(grid)
    if not (torch.equal(cells, out["n_cells"]) and torch.equal(dense_faces, out["n_faces"])):
        raise AssertionError("mesh: the dense counts differ from the extraction's")

    # sap_dpsr again, by parts: the stages' code, with DPSR's steps timed
    parts = Parts()
    gen = torch.Generator(device=dev).manual_seed(5)
    dpsr = stages.dpsr

    def timed_dpsr(v, n):
        with parts("raster"):
            ras = point_rasterize(v, n, dpsr.res)
        with parts("fft_solve"):
            phi = dpsr.solve(ras)
        with parts("grid_interp"):
            return dpsr.shift_and_scale(phi, v)

    with torch.no_grad():
        torch.cuda.synchronize()
        with parts("sap_net"):
            xm = mirror_and_concat(out["cloud"], axis=2, attach_label=True, generator=gen)[0]
            disp = stages.sap_net(xm, ts=None, label=stages.label)
        phi, points, normals = network_output_to_dpsr_grid(
            xm, disp, timed_dpsr, 1, stages.sap_config, last_dim_as_indicator=True,
            explicit_normalize=True)
        sap_dpsr_ms = parts.ms()
        again = dpsr(points, normals)
        t0 = time.perf_counter()
        want = DPSR(dpsr.res, sig=dpsr.sig)(points.cpu(), normals.cpu())
        cpu_s = time.perf_counter() - t0
    dpsr_err = float((phi.cpu() - want).abs().max())
    repeat_err = float((again - phi).abs().max())
    log("mesh", samples=picks, per_sample=per_sample, n_cells=cells.tolist(),
        sap_dpsr_top_kernels=top_kernels(lambda: stages.sap(out["cloud"], gen)),
        n_faces=dense_faces.tolist(), vert_atol=MESH_VERT_ATOL, normal_atol=MESH_NORMAL_ATOL,
        sap_dpsr_ms=sap_dpsr_ms, points=list(points.shape),
        dpsr_card_vs_cpu=dpsr_err, dpsr_atol=DPSR_ATOL, dpsr_two_card_runs=repeat_err,
        dpsr_max_abs=float(want.abs().max()), dpsr_cpu_seconds=cpu_s)
    if not (dpsr_err <= DPSR_ATOL and bool(torch.isfinite(phi).all())):
        raise AssertionError(f"mesh: DPSR on the card and on the CPU differ by {dpsr_err}")
    return per_sample


def phase_net(stages, dev):
    rng = np.random.default_rng(0)
    for name, net, fn, width in [("kp", stages.kp_net, stages.kp_fused, 3),
                                 ("lat", stages.lat_net, stages.lat_fused,
                                  3 + stages.latent_dim)]:
        x = torch.as_tensor(rng.standard_normal((BATCH, 16, width)), dtype=torch.float32)
        ts = torch.as_tensor(rng.integers(0, T_STEPS, BATCH), dtype=torch.int32)
        label = torch.zeros(BATCH, dtype=torch.int64)
        with torch.no_grad():
            got = net(x.to(dev), ts=ts.to(dev), label=label.to(dev)).cpu()
            got_fused = fn(x.to(dev), ts.to(dev), label.to(dev)).cpu()
            cpu_net = net.to("cpu")
            want = cpu_net(x, ts=ts, label=label)
            net.to(dev)
        err = float((got - want).abs().max())
        err_fused = float((got_fused - want).abs().max())
        log("net", net=name, max_abs_err=err, fused_max_abs_err=err_fused, atol=NET_ATOL)
        if not (err <= NET_ATOL and err_fused <= NET_ATOL):
            raise AssertionError(f"{name} net: card and CPU differ by {err} (module), "
                                 f"{err_fused} (fused)")


def k2_errors(got, want) -> dict:
    """Per gradient (d pc, d t4, d cls, d flat): the largest element error,
    its share of the bound K2_TOL x max(1, max |plain|), and whether every
    element is finite and within the bound."""
    errs = {}
    for key, x, y in zip(("dpc", "dt4", "dcls", "dflat"), got, want):
        err = float((x.double() - y).abs().max())
        bound_ = K2_TOL * max(1.0, float(y.abs().max()))
        errs[key] = {"max_abs": err, "of_bound": err / bound_,
                     "ok": err <= bound_ and bool(torch.isfinite(x).all())}
    return errs


def k2_gate_in_chunks(where: str, packed, pc, t4, cls, g, got, chunk: int, flat=None):
    """K2's launch `got` on a batch held to float64 in chunks of at most
    `chunk` clouds (the float64 references of a large batch at once would
    not fit the card): each chunk in a launch of its own, whose rows of
    d pc, d t4 and d cls the batch's launch must equal, that launch within
    the K2 gate of `fused_backward_reference` (its relu ties resolved as the
    launch did); then the batch's d flat, summed over its own tiles, within
    the K2 gate of the chunks' float64 d flat summed (d flat is a sum over
    clouds), `dflat_batch`.  Returns (per gradient the chunks' worst
    `k2_errors` entry, and `dflat_batch`; the ties as [first cloud of the
    chunk, relu call, flat index, float64 input])."""
    b = pc.shape[0]
    errs, ties, total = {}, [], None
    for s in range(0, b, chunk):
        e = min(b, s + chunk)
        sub = [x[s:e].contiguous() for x in (pc, t4, cls, g)]
        mine = fd.fused_backward_cuda(packed, *sub, flat)
        for key, x, z in zip(("dpc", "dt4", "dcls"), got, mine):
            if not torch.equal(x[s:e], z):
                raise AssertionError(f"{where}: K2's {key} of clouds {s}-{e - 1} differs "
                                     f"between the batch's launch and their own")
        want, chunk_ties = fd.fused_backward_reference(packed, *sub, mine, flat, tol=K2_TOL)
        chunk_errs = k2_errors(mine, want)
        bad = [key for key, err in chunk_errs.items() if not err["ok"]]
        if bad:
            raise AssertionError(f"{where}: K2's {bad} of clouds {s}-{e - 1} differ from "
                                 f"float64: {chunk_errs}")
        for key, err in chunk_errs.items():
            if key not in errs or err["of_bound"] > errs[key]["of_bound"]:
                errs[key] = err
        ties += [[s, *tie] for tie in chunk_ties]
        total = want[3] if total is None else total + want[3]
        del mine, want
    err = float((got[3].double() - total).abs().max())
    bound_ = K2_TOL * max(1.0, float(total.abs().max()))
    errs["dflat_batch"] = {"max_abs": err, "of_bound": err / bound_,
                           "ok": err <= bound_ and bool(torch.isfinite(got[3]).all())}
    if not errs["dflat_batch"]["ok"]:
        raise AssertionError(f"{where}: the batch's K2 d flat differs from the float64 sum "
                             f"of its chunks': {errs['dflat_batch']}")
    return errs, ties


def k2_plain_in_tiles(packed, pc, t4, cls, g):
    """K2's plain version over the tiles K2 runs (`PackedNet.k2_tiles`), d
    flat summed over them: one autograd pass of a 128-point batch of 32
    would not fit the card."""
    parts = [fd.fused_backward_plain(packed, pc[s:e], t4[s:e], cls[s:e], g[s:e])
             for s, e in packed.k2_tiles(pc.shape[0])]
    dflat = parts[0][3]
    for part in parts[1:]:
        dflat = dflat + part[3]
    return [torch.cat([part[i] for part in parts]) for i in range(3)] + [dflat]


def k2_case(net, b: int, n: int, width: int, gen, dev, duplicates: bool = False):
    pc = torch.randn((b, n, width), generator=gen, device=dev)
    if duplicates:
        pc[:, 1] = pc[:, 0]
        pc[:, 2] = pc[:, 0]
    g = torch.randn((b, n, width), generator=gen, device=dev)
    ts = torch.randint(0, T_STEPS, (b,), generator=gen, device=dev)
    label = torch.randint(0, 13, (b,), generator=gen, device=dev)
    with torch.no_grad():
        t4, cls = net.t_embedder(ts), net.class_emb(label)
    return pc, t4, cls, g


def phase_k2(stages, dev) -> tuple[dict, float]:
    """K2 against its plain version (in float64, ties resolved as K2 did);
    per (net, batch): kernel and plain (fp32) ms and the bound parts."""
    gen = torch.Generator(device=dev).manual_seed(2)
    res, worst = {}, 0.0
    cases = [(b, False) for b in K2_BATCHES] + [(K2_BATCHES[0], True)]
    for name, net, fn, width in [("kp", stages.kp_net, stages.kp_fused, 3),
                                 ("lat", stages.lat_net, stages.lat_fused,
                                  3 + stages.latent_dim)]:
        for b, duplicates in cases:
            pc, t4, cls, g = k2_case(net, b, fn.spec["n"], width, gen, dev, duplicates)
            got = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
            again = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
            want, ties = fd.fused_backward_reference(fn.packed, pc, t4, cls, g, got,
                                                     tol=K2_TOL)
            torch.cuda.synchronize()
            errs = k2_errors(got, want)
            worst = max([worst] + [e["max_abs"] for e in errs.values()])
            bad = [key for key, e in errs.items() if not e["ok"]]
            if bad:
                raise AssertionError(f"k2 {name} batch {b}: {bad} differ from plain: {errs}")
            for key, x, z in zip(("dpc", "dt4", "dcls", "dflat"), got, again):
                if not torch.equal(x, z):
                    raise AssertionError(f"k2 {name} batch {b}: {key} differs between "
                                         f"two launches")
            if duplicates:
                log("k2", net=name, batch=b, duplicates=True, err=errs, ties=ties,
                    repeat_equal=True)
                continue
            ms = cuda_ms(lambda: fd.fused_backward_cuda(fn.packed, pc, t4, cls, g), 10)
            plain_ms = cuda_ms(lambda: fd.fused_backward_plain(fn.packed, pc, t4, cls, g), 3)
            launch = k2_parts_ms(lambda: fd.fused_backward_cuda(fn.packed, pc, t4, cls, g))
            parts = k2_bound_parts(fn.packed.layout, b)
            scratch = k2_scratch_ms(fn.packed.layout, b)
            res[(name, b)] = (ms, plain_ms, parts, scratch)
            bound_ms, bound_by = bound(parts)
            lay2 = fn.packed.layout2
            clusters = k2_max_clusters(fn.packed)
            log("k2", net=name, batch=b, err=errs, ties=ties, repeat_equal=True,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes_ms=parts[0], operations_ms=parts[1], scratch_bytes_ms=scratch,
                fp32_operations_ms=fp32_ms(3 * _table_work(fn.packed.layout, b)[0]),
                blocks_per_cloud=lay2["cluster"], blocks_per_sm=lay2["occupancy"],
                max_clusters=clusters, waves=-(-b // clusters), parts_ms=launch,
                weight_grad_ms=launch["weight_grad"], weight_grad_splits=fn.packed.splits)
    return res, worst


def stages_at(n: int, t_steps: int):
    """The main path's stages at n keypoints, fused, t_steps a chain."""
    return build_stages(BATCH, t_steps, configs={"kp": keypoint_ddpm_config(num_keypoints=n),
                                                 "lat": latent_ddpm_config(num_keypoints=n)})


def phase_large(stages, dev, n: int, check: int) -> dict:
    """K1 and K2 at n points (`k{n}`), the kp and latent nets of the n-point
    stages: K1 at batch 16 against its plain version (K1_ATOL), kernel,
    plain and module ms, the bound and its parts, its plan, and K1 planned
    for one and for two blocks per SM (`k1_plan`'s fields); K2 at batch 32
    in the tiles its plan states: two launches equal, the batch's launch
    held to float64 in chunks of `check` clouds (`k2_gate_in_chunks`), ms,
    plain (fp32, in the same tiles) ms, the bound, the profiler's parts.
    Where the batch takes more than one tile, also K2 in tiles of
    K2_TILE_CHECK clouds against one launch of a batch that fits one tile:
    rows equal, d flat within the K2 gate.  Returns per net the K1 (ms,
    plain ms, module ms, bound parts, scratch ms) and K2 (ms, plain ms,
    bound parts, scratch ms) figures and their errors."""
    phase = f"k{n}"
    gen = torch.Generator(device=dev).manual_seed(n)
    res = {}
    for name, net, fn, width in k1_nets(stages):
        lay = fn.packed.layout
        if lay["n"] != n:
            raise AssertionError(f"{phase} {name}: the packed net holds {lay['n']} points")
        pc, ts, label, t4, cls = k1_inputs(net, BATCH, n, width, gen, dev)
        with torch.no_grad():
            want = fd.fused_forward_plain(fn.spec, fn.packed, pc, t4, cls)
            for occupancy in (1, 2):
                try:
                    packed = pack_at(net, fn.spec, occupancy)
                except ValueError as e:
                    log(f"{phase}_k1_plan", net=name, blocks_per_sm=occupancy, fits=False,
                        why=str(e))
                    continue
                got = fd.fused_forward_cuda(packed, pc, t4, cls)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not (err <= K1_ATOL and bool(torch.isfinite(got).all())):
                    raise AssertionError(f"{phase} {name} at {occupancy} blocks per SM: "
                                         f"kernel and plain differ by {err}")
                log(f"{phase}_k1_plan", net=name, blocks_per_sm=occupancy, fits=True,
                    own=packed.layout["occupancy"] == lay["occupancy"],
                    smem_bytes=packed.layout["smem_bytes"],
                    max_clusters=k1_max_clusters(packed), stage_floats=packed.layout["stage"],
                    rows_in_device_memory=packed.layout["bglob"], batch=BATCH,
                    max_abs_err=err, atol=K1_ATOL,
                    ms=cuda_ms(lambda: fd.fused_forward_cuda(packed, pc, t4, cls), 10))
                del packed
            got = fd.fused_forward_cuda(fn.packed, pc, t4, cls)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not (err <= K1_ATOL and bool(torch.isfinite(got).all())):
                raise AssertionError(f"{phase} {name}: K1 and plain differ by {err}")
            ms = cuda_ms(lambda: fd.fused_forward_cuda(fn.packed, pc, t4, cls), 20)
            plain_ms = cuda_ms(lambda: fd.fused_forward_plain(fn.spec, fn.packed, pc, t4, cls),
                               5)
            module_ms = cuda_ms(lambda: net(pc, ts=ts, label=label), 5)
        k1_parts = k1_bound_parts(lay, BATCH)
        k1_scratch = k1_scratch_ms(lay, BATCH)
        flops, _, products = _table_work(lay, BATCH)
        log(f"{phase}_k1", net=name, n=n, batch=BATCH, shape=list(pc.shape), max_abs_err=err,
            atol=K1_ATOL, ms=ms, plain_ms=plain_ms, module_ms=module_ms,
            bound_ms=bound(k1_parts)[0], bound_by=bound(k1_parts)[1], bytes_ms=k1_parts[0],
            operations_ms=k1_parts[1], fp32_operations_ms=fp32_ms(flops),
            scratch_bytes_ms=k1_scratch, row_floats_per_cloud=k1_row_floats(lay, products),
            plan={"smem_bytes": lay["smem_bytes"], "blocks_per_sm": lay["occupancy"],
                  "rows_in_device_memory": lay["bglob"], "blk_floats": lay["blk_floats"],
                  "cloud_floats": lay["cloud_floats"], "stage_floats": lay["stage"],
                  "max_clusters": k1_max_clusters(fn.packed)})
        del want, got

        pc, t4, cls, g = k2_case(net, TRAIN_BATCH, n, width, gen, dev)
        tiles = fn.packed.k2_tiles(TRAIN_BATCH)
        _build.launch_counts.clear()
        got = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
        if _build.launch_counts["fused_denoiser_bwd"] != len(tiles):
            raise AssertionError(f"{phase} {name}: {_build.launch_counts['fused_denoiser_bwd']} "
                                 f"K2 launches for the {len(tiles)} tiles of its plan")
        again = fd.fused_backward_cuda(fn.packed, pc, t4, cls, g)
        torch.cuda.synchronize()
        for key, x, z in zip(("dpc", "dt4", "dcls", "dflat"), got, again):
            if not torch.equal(x, z):
                raise AssertionError(f"{phase} {name}: K2's {key} differs between two launches")
        del again
        errs, ties = k2_gate_in_chunks(f"{phase} {name}", fn.packed, pc, t4, cls, g, got, check)
        tiled = {}
        if len(tiles) > 1:
            # a batch that fits one tile, in one launch and in tiles of
            # K2_TILE_CHECK clouds (K2's tape budget lowered to theirs)
            one = [x[:K2_TILE_BATCH].contiguous() for x in (pc, t4, cls, g)]
            whole = fd.fused_backward_cuda(fn.packed, *one)
            budget = fd.K2_TAPE_FLOATS
            fd.K2_TAPE_FLOATS = K2_TILE_CHECK * fn.packed.layout2["bwd_floats"]
            try:
                split = fn.packed.k2_tiles(K2_TILE_BATCH)
                parts = fd.fused_backward_cuda(fn.packed, *one)
            finally:
                fd.K2_TAPE_FLOATS = budget
            torch.cuda.synchronize()
            rows_equal = all(torch.equal(x, z) for x, z in zip(whole[:3], parts[:3]))
            dflat_err = float((parts[3] - whole[3]).abs().max())
            dflat_bound = K2_TOL * max(1.0, float(whole[3].abs().max()))
            tiled = {"batch": K2_TILE_BATCH, "clouds": K2_TILE_CHECK, "rows_equal": rows_equal,
                     "tiles": len(split),
                     "dflat_max_abs": dflat_err, "dflat_bound": dflat_bound}
            if not (rows_equal and dflat_err <= dflat_bound):
                raise AssertionError(f"{phase} {name}: K2 in tiles differs from one launch: "
                                     f"{tiled}")
            del whole, parts
        ms2 = cuda_ms(lambda: fd.fused_backward_cuda(fn.packed, pc, t4, cls, g), 5)
        plain_ms2 = cuda_ms(lambda: k2_plain_in_tiles(fn.packed, pc, t4, cls, g), 2)
        launch = k2_parts_ms(lambda: fd.fused_backward_cuda(fn.packed, pc, t4, cls, g))
        k2_parts = k2_bound_parts(lay, TRAIN_BATCH)
        k2_scratch = k2_scratch_ms(lay, TRAIN_BATCH)
        lay2 = fn.packed.layout2
        clusters = k2_max_clusters(fn.packed)
        log(f"{phase}_k2", net=name, n=n, batch=TRAIN_BATCH, shape=list(pc.shape),
            tiles=tiles, checked_in_chunks_of=check, err=errs, ties=ties, repeat_equal=True,
            tiled_vs_one_launch=tiled, ms=ms2,
            plain_ms=plain_ms2, bound_ms=bound(k2_parts)[0], bound_by=bound(k2_parts)[1],
            bytes_ms=k2_parts[0], operations_ms=k2_parts[1],
            fp32_operations_ms=fp32_ms(3 * _table_work(lay, TRAIN_BATCH)[0]),
            scratch_bytes_ms=k2_scratch, tape_floats_per_cloud=k2_tape_floats(products),
            bwd_floats=lay2["bwd_floats"],
            blocks_per_cloud=lay2["cluster"], blocks_per_sm=lay2["occupancy"],
            smem_bytes=lay2["smem_bytes"], max_clusters=clusters,
            waves=sum(-(-(e - s) // clusters) for s, e in tiles), parts_ms=launch,
            weight_grad_splits=fn.packed.splits)
        res[name] = {"k1": (ms, plain_ms, module_ms, k1_parts, k1_scratch),
                     "k2": (ms2, plain_ms2, k2_parts, k2_scratch), "k2_err": max(
                         e["max_abs"] for e in errs.values()), "k1_err": err,
                     "k2_tiles": len(tiles)}
        del got, pc, t4, cls, g
        fn.packed.bwd_scratch = None
        torch.cuda.empty_cache()
    return res


def phase_slice_at(phase: str, stages, n: int, want_fused: int) -> dict:
    """The main path at n keypoints, counted from zero: exactly `want_fused`
    K1, len(PASS_FPS) K3 and no K2 launches, the keypoints (16, n, 3) and
    their features (16, n, latent_dim), the slice's checks (`run_slice`);
    every K1 and FPS shape it launched against its plain version."""
    inputs = KernelInputs()
    with inputs.recording():
        out, launches = run_slice(phase, stages, 0, want_fused=want_fused)
    shapes_ok = (tuple(out["keypoints"].shape) == (BATCH, n, 3)
                 and tuple(out["features"].shape) == (BATCH, n, stages.latent_dim))
    if not shapes_ok or launches.get("fused_denoiser_bwd", 0):
        raise AssertionError(f"{phase}: keypoints {list(out['keypoints'].shape)}, features "
                             f"{list(out['features'].shape)}, launches {launches}")
    k1_err = inputs.check(phase)
    return {"launches": launches, "seconds": out["seconds"], "k1_err": k1_err}


def _task_config(config: dict, root: str, exp: str) -> dict:
    """A shipped training preset at batch 32 on the synthetic tree, its
    experiment directory under `exp`, a loss logged every 5 steps."""
    cfg = config
    cfg["shapenet_psr_dataset_config"]["data_dir"] = root
    cfg["train_config"].update(root_directory=exp, iters_per_logging=5)
    return cfg


def check_train_gradient(phase: str, pointnet: dict, x, label, loss_fn, dev) -> float:
    """One step's gradients: the card's fused denoiser (K1 + K2) against the
    module run in float64 on the CPU, same weights, input `x` (the keypoints
    or the latent), labels, ts and z, `loss_fn(net_fn, x, ts, z)`, per
    element once the relu ties that K2 resolved otherwise than float64 are
    taken off.  Those are found at the core: K2 relaunched on the inputs and
    the cotangent the step gave it, against `fused_backward_reference` (K2's
    gate at K2_TOL; the ties taken off down to a tenth of it).  The float64
    module evaluates the net at the card's core inputs, x and the timestep
    embedding t4, since a relu tie moves with an input's last bit: each must
    lie within INPUT_TOL x max(1, max |input|) of the CPU's own value, and
    the gaps are logged.
    The CPU module in fp32, on the same inputs, is logged beside it."""
    net = train_driver.init_params(ConditionalPointNet2(pointnet),
                                   torch.Generator().manual_seed(0))
    cpu_net = ConditionalPointNet2(pointnet)
    cpu_net.load_state_dict(net.state_dict())
    net64 = ConditionalPointNet2(pointnet)
    net64.load_state_dict(net.state_dict())
    net64.double()
    net = net.to(dev)
    b = x.shape[0]
    label = label.cpu()
    gen = torch.Generator().manual_seed(1)
    ts = torch.randint(0, 1000, (b,), generator=gen)
    z = torch.randn(tuple(x.shape), generator=gen)
    apply = fd.make_fused_train_fn(pointnet, net, x.shape[1])
    core = {}

    def net_fn(xt, t):
        out = apply(xt, t, label.to(dev))
        core.update(x=xt.detach().contiguous(), ts=t)
        out.register_hook(lambda g: core.update(g=g.detach().contiguous()))
        return out

    loss = loss_fn(net_fn, x, ts.to(dev), z.to(dev))
    loss.backward()
    # the CPU runs evaluate the net at the card's core inputs: its x and its
    # t4 (the values; autograd's path to the embedder's weights stays the
    # module's own), once each is shown to be the CPU's own within rounding
    card_x = core["x"].cpu()
    t4 = net.t_embedder(core["ts"])
    card_t4 = t4.detach().cpu()
    gaps = {}

    def near(side, name, mine, card):
        # within INPUT_TOL of the input's scale: t4 comes from two fp32
        # products of depth 128 and 512, summed in another order on the card
        gap = float((mine.double() - card.double()).abs().max())
        gaps[f"{side}_{name}"] = gap
        if mine.shape != card.shape or not gap <= INPUT_TOL * max(1.0, float(card.abs().max())):
            raise AssertionError(f"{phase}: the {side} CPU net's {name} is not the card's: "
                                 f"{gaps}")

    def at_card_input(m, side):
        def swap_t4(mod, args, out):
            near(side, "t4", out.detach(), card_t4)
            return out + (card_t4.to(out.dtype) - out).detach()

        def f(xt, t):
            near(side, "x", xt.detach(), card_x)
            hook = m.t_embedder.register_forward_hook(swap_t4)
            try:
                return m(card_x.to(xt.dtype), ts=t, label=label)
            finally:
                hook.remove()
        return f

    cpu_loss = loss_fn(at_card_input(cpu_net, "fp32"), x.cpu(), ts, z)
    cpu_loss.backward()
    loss_fn(at_card_input(net64, "float64"), x.cpu().double(), ts, z.double()).backward()

    # the core's inputs again (under autograd, to carry a change of K2's
    # output back to the parameters), K2 on them, and its tie decisions
    cls = net.class_emb(label.to(dev))
    flat = apply.packed.live_flat()
    ins = [core["x"], t4.detach().contiguous(), cls.detach().contiguous(), flat.detach()]
    got = fd.fused_backward_cuda(apply.packed, ins[0], ins[1], ins[2], core["g"], ins[3])
    want, ties = fd.fused_backward_reference(apply.packed, ins[0], ins[1], ins[2],
                                             core["g"], got, ins[3], tol=K2_TOL)
    # what is taken off the card's gradient: the ties K2 resolved otherwise
    # than float64 down to a tenth of K2's bound (the search above stops at
    # the bound, which an element near 0 of the per-element gate still sees)
    fine, fine_ties = fd.fused_backward_reference(apply.packed, ins[0], ins[1], ins[2],
                                                  core["g"], got, ins[3], tol=K2_TOL / 10,
                                                  max_tries=64)
    plain64, _ = fd.fused_backward_reference(apply.packed, ins[0], ins[1], ins[2],
                                             core["g"], got, ins[3], max_tries=0)
    core_errs = k2_errors(got, want)
    params = dict(net.named_parameters())
    taken = torch.autograd.grad(
        [t4, cls, flat], list(params.values()),
        [(w - p).float() for w, p in zip(fine[1:], plain64[1:])], allow_unused=True)

    beyond, beyond_raw, worst, where = 0, 0, 0.0, {}
    cpu32 = {"max_abs_err": 0.0, "beyond": 0}
    size = 0.0
    for (name, p), q, r, tie in zip(params.items(), cpu_net.parameters(), net64.parameters(),
                                    taken):
        raw = p.grad.double().cpu()
        got_p = raw - (0 if tie is None else tie.double().cpu())
        ref = r.grad
        tol = GRAD_ATOL + GRAD_RTOL * ref.abs()
        size = max(size, float(ref.abs().max()))
        cpu_err = (q.grad.double() - ref).abs()
        cpu32["max_abs_err"] = max(cpu32["max_abs_err"], float(cpu_err.max()))
        cpu32["beyond"] += int((cpu_err > tol).sum())
        beyond_raw += int(((raw - ref).abs() > tol).sum())
        err = (got_p - ref).abs()
        worst = max(worst, float(err.max()))
        bad = int((err > tol).sum())
        if bad or not bool(torch.isfinite(raw).all()):
            where[name] = {"beyond": bad, "max_abs": float(err.max())}
        beyond += bad
    log(f"{phase}_gradient", loss=float(loss.detach()), cpu_loss=float(cpu_loss.detach()),
        max_abs_err=worst, beyond=beyond, beyond_before_ties=beyond_raw, ties=ties,
        ties_taken_off=fine_ties, max_abs_grad=size, input_gaps=gaps, core=core_errs,
        cpu_fp32=cpu32)
    if where or not all(e["ok"] for e in core_errs.values()):
        raise AssertionError(f"{phase}: gradient differs from the float64 module's: {where}; "
                             f"K2 at the core: {core_errs}")
    return worst


def _first_batch(cfg: dict, dev) -> dict:
    batch = next(iter(get_dataloader(cfg["shapenet_psr_dataset_config"], seed=0)))
    return {key: torch.as_tensor(batch[key], dtype=dtype, device=dev)
            for key, dtype in (("points", torch.float32), ("normals", torch.float32),
                               ("psr", torch.float32), ("label", torch.int64))
            if key in batch}


def _device_us(evt) -> float:
    """Time on the card of a profiled kernel (0 for host operations and for
    annotations such as `Optimizer.step`'s span, whose device time is that
    of its kernels and would count twice)."""
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA \
            or getattr(evt, "is_user_annotation", False):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_train(phase: str, train_fn, cfg: dict, done: int, steps: int,
                  ms_per_step: float) -> None:
    """`steps` more steps of `train_fn` (resumed at iteration `done`) under
    `torch.profiler`: the card's busy ms per step, the idle share of the
    counted run's step of `ms_per_step`, and the kernels and host operations
    that take the most time per step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_fn(cfg, max_iters=done + steps, verbose=False)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted(((e.key, _device_us(e) / 1e3 / steps, e.count / steps) for e in events
                      if _device_us(e) > 0), key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps, e.count / steps)
                   for e in events if _device_us(e) == 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    log(f"{phase}_profile", steps=steps, device_busy_ms=busy,
        idle_share=1.0 - busy / ms_per_step,
        kernel_launches_per_step=sum(r[2] for r in kernels),
        top_kernels=[list(r) for r in kernels[:10]], top_host_ops=[list(r) for r in host[:12]])
    if busy <= 0:
        raise AssertionError(f"{phase}_profile: the profiler saw no kernel on the card")


def run_task(phase: str, train_fn, cfg: dict, warmup: int, steps: int, per_step: dict,
             profile_steps: int) -> dict:
    """A training task through its entry point `train_fn(cfg, max_iters=)`:
    a warm-up run that writes a checkpoint, a counted run resumed from it
    (finite losses, the resume iteration, exactly `per_step` launches of
    each kernel a step), then a profiled run resumed from the counted run's
    last checkpoint."""
    ckpt_dir = train_driver.experiment_dirs(cfg)[1]
    t0 = time.perf_counter()
    _, warm = train_fn(cfg, max_iters=warmup, verbose=False)
    torch.cuda.synchronize()
    saved = find_max_iter(ckpt_dir)
    log(f"{phase}_warmup", steps=warmup, seconds=time.perf_counter() - t0, losses=warm,
        checkpoint_iter=saved)
    if saved != warmup - 1:
        raise AssertionError(f"{phase}: warm-up saved iteration {saved}, expected "
                             f"{warmup - 1}")

    _build.launch_counts.clear()
    t0 = time.perf_counter()
    state, losses = train_fn(cfg, max_iters=warmup + steps, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    final = find_max_iter(ckpt_dir)
    values = [l for _, l in losses]
    finite = bool(np.isfinite(values).all()) and len(values) > 0
    ms_per_step = 1e3 * seconds / steps
    log(phase, batch=cfg["shapenet_psr_dataset_config"]["batch_size"], steps=steps,
        resumed_from=saved, seconds=seconds,
        ms_per_step=ms_per_step, first_loss=losses[0] if losses else None,
        last_loss=losses[-1] if losses else None, warmup_first_loss=warm[0] if warm else None,
        finite=finite, launches=launches, launches_per_step_expected=per_step,
        final_checkpoint_iter=final)
    if not finite:
        raise AssertionError(f"{phase}: losses {losses}")
    if state.step != warmup + steps or final != warmup + steps - 1:
        raise AssertionError(f"{phase}: did not resume at iteration {warmup}: step "
                             f"{state.step}, last checkpoint {final}")
    for name, n in per_step.items():
        if launches.get(name, 0) != n * steps:
            raise AssertionError(f"{phase}: {launches.get(name, 0)} {name} launches in "
                                 f"{steps} steps, expected {n} a step")
    del state
    profile_train(phase, train_fn, cfg, warmup + steps, profile_steps, ms_per_step)
    return {"launches": launches, "seconds": seconds, "ms_per_step": ms_per_step}


def phase_train(dev, root: str, tmp: str) -> dict:
    """Position-DDPM training at full width through `train_position_ddpm`."""
    cfg = _task_config(keypoint_ddpm_config("airplane", batch_size=TRAIN_BATCH), root,
                       os.path.join(tmp, "exp_kp"))
    cfg["train_config"]["iters_per_logging"] = 50
    batch = _first_batch(cfg, dev)
    x = train_driver.sample_train_keypoints(batch["points"], cfg["shapenet_psr_dataset_config"])
    grad_err = check_train_gradient(
        "train", cfg["pointnet_config"], x, batch["label"],
        lambda net_fn, xx, ts, z: diffusion_training_loss(
            net_fn, xx, calc_diffusion_hyperparams(1000, 1e-4, 0.02, xx.device), ts=ts, z=z),
        dev)
    res = run_task("train", train_driver.train_position_ddpm, cfg, TRAIN_WARMUP, TRAIN_STEPS,
                   {"fps": 1, "fused_denoiser": 1, "fused_denoiser_bwd": 1}, PROFILE_STEPS)
    return {**res, "grad_err": grad_err}


def phase_train_at(dev, root: str, tmp: str, n: int, check: int, warmup: int,
                   steps: int) -> dict:
    """Position-DDPM training at n keypoints (`train{n}`: the kp preset at
    full width, batch 32) through `train_position_ddpm`: one step's gradient
    as `train` holds it, on the batch's first `check` clouds; then `warmup`
    warm-up and `steps` counted steps (exactly one K3 and one K1 a step, and
    one K2 a tile of K2's plan for the batch) and a profiled run; every K1,
    K2 and FPS shape it launched against its plain version (K2's float64
    gate on the first `check` clouds)."""
    phase = f"train{n}"
    cfg = _task_config(keypoint_ddpm_config("airplane", num_keypoints=n,
                                            batch_size=TRAIN_BATCH), root,
                       os.path.join(tmp, f"exp_kp{n}"))
    batch = _first_batch(cfg, dev)
    x = train_driver.sample_train_keypoints(batch["points"], cfg["shapenet_psr_dataset_config"])
    if tuple(x.shape) != (TRAIN_BATCH, n, 3):
        raise AssertionError(f"{phase}: keypoints {list(x.shape)}")
    grad_err = check_train_gradient(
        phase, cfg["pointnet_config"], x[:check], batch["label"][:check],
        lambda net_fn, xx, ts, z: diffusion_training_loss(
            net_fn, xx, calc_diffusion_hyperparams(1000, 1e-4, 0.02, xx.device), ts=ts, z=z),
        dev)
    # the tiles K2's plan states for the batch
    tiles = len(fd.make_fused_train_fn(cfg["pointnet_config"],
                                       ConditionalPointNet2(cfg["pointnet_config"]),
                                       n).packed.k2_tiles(TRAIN_BATCH))
    inputs = KernelInputs()
    with inputs.recording():
        res = run_task(phase, train_driver.train_position_ddpm, cfg, warmup, steps,
                       {"fps": 1, "fused_denoiser": 1, "fused_denoiser_bwd": tiles},
                       TASK_PROFILE_STEPS)
    k1_err = inputs.check(phase, k2_clouds=check)
    return {**res, "grad_err": grad_err, "k1_err": k1_err, "k2_err": inputs.k2_err,
            "k2_tiles": tiles}


def _record_knn():
    """Wrap the neighbourhood modules' kNN search so that it records each
    call's (query, points, sqdists, idx) on the host; returns the list."""
    calls, real = [], neighborhood.knn_points

    def recording(query, points, k):
        sqd, idx = real(query, points, k)
        calls.append([t.cpu() for t in (query, points, sqd, idx)])
        return sqd, idx

    neighborhood.knn_points = recording
    return calls


def _replay_knn(calls, n: int) -> dict:
    """Hand the first `n` clouds of the recorded searches to a CPU run.  Its
    own search on the same points must give the same neighbour sets, or
    sets that part at a tie (float64 distances of the points in one set and
    not the other within 1e-6 of the cloud's squared scale); counted."""
    it, seen = iter(calls), {"calls": 0, "ties": 0}

    def replaying(query, points, k):
        c_query, c_points, c_sqd, c_idx = (t[:n] for t in next(it))
        if not (torch.equal(query, c_query) and torch.equal(points, c_points)):
            raise AssertionError("encode: the CPU's kNN query differs from the card's")
        _, idx = knn_points(query, points, k)
        tol = 1e-6 * float(query.square().sum(-1).amax() + points.square().sum(-1).amax())
        differ = (torch.sort(idx, -1)[0] != torch.sort(c_idx, -1)[0]).any(-1)
        for b, m in differ.nonzero().tolist():
            d64 = ((query[b, m].double() - points[b].double()) ** 2).sum(-1)
            sym = list(set(idx[b, m].tolist()) ^ set(c_idx[b, m].tolist()))
            if float(d64[sym].max() - d64[sym].min()) > tol:
                raise AssertionError(f"encode: kNN sets part beyond a tie at ({b}, {m})")
            seen["ties"] += 1
        seen["calls"] += 1
        return c_sqd, c_idx

    neighborhood.knn_points = replaying
    return seen


def check_encode(cfg: dict, dev) -> float:
    """`encode` of the committed AE on the card (a batch of 32, the
    posterior sampled) against the CPU on the batch's first ENCODE_CHECK
    clouds, the same keypoints and noise, the card's kNN picks replayed."""
    ae = build_autoencoder(cfg["pointnet_config"])
    load_flax_params(ae, load_inference_params(str(DEFAULT_CKPTS["ae"]), -1))
    ae.eval()
    cpu_ae = build_autoencoder(cfg["pointnet_config"])
    cpu_ae.load_state_dict(ae.state_dict())
    ae = ae.to(dev)
    batch = _first_batch(cfg, dev)
    normals = batch["normals"] / torch.linalg.vector_norm(batch["normals"], dim=-1,
                                                          keepdim=True)
    x = torch.cat([batch["points"], normals], dim=-1)
    gen = torch.Generator(device=dev).manual_seed(3)
    kp = train_driver.sample_train_keypoints(batch["points"], cfg["shapenet_psr_dataset_config"],
                                             gen)
    noise_gen = torch.Generator().manual_seed(4)
    noises = []

    def noise_fn(shape):
        noises.append(torch.randn(shape, generator=noise_gen))
        return noises[-1].to(dev)

    real = neighborhood.knn_points
    try:
        calls = _record_knn()
        before = _build.launch_counts["fps"]
        with torch.no_grad():
            got = ae.encode(x, kp, label=batch["label"], noise_fn=noise_fn)
        torch.cuda.synchronize()
        fps_launches = _build.launch_counts["fps"] - before
        n = ENCODE_CHECK
        seen = _replay_knn(calls, n)
        drawn = iter(noises)
        t0 = time.perf_counter()
        with torch.no_grad():
            want = cpu_ae.encode(x[:n].cpu(), kp[:n].cpu(), label=batch["label"][:n].cpu(),
                                 noise_fn=lambda shape: next(drawn)[:n])
        cpu_s = time.perf_counter() - t0
    finally:
        neighborhood.knn_points = real
    err = float((got[:n].cpu() - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    log("train_ae_encode", batch=TRAIN_BATCH, shape=list(got.shape), checked=n,
        max_abs_err=err, max_abs=float(want.abs().max()), tol=ENCODE_TOL * scale,
        knn_calls=seen["calls"], knn_ties=seen["ties"], fps_launches=fps_launches,
        finite=bool(torch.isfinite(got).all()), cpu_seconds=cpu_s)
    if seen["calls"] != len(calls) or fps_launches != len(ENCODER_FPS):
        raise AssertionError(f"encode: {seen['calls']} of {len(calls)} kNN calls replayed, "
                             f"{fps_launches} FPS launches")
    if not (err <= ENCODE_TOL * scale and bool(torch.isfinite(got).all())):
        raise AssertionError(f"encode: card and CPU differ by {err} (max {scale})")
    return err


def phase_train_ae(dev, root: str, tmp: str) -> dict:
    """The point autoencoder at full width through `train_autoencoder`."""
    cfg = _task_config(autoencoder_config("airplane", batch_size=TRAIN_BATCH), root,
                       os.path.join(tmp, "exp_ae"))
    encode_err = check_encode(cfg, dev)
    res = run_task("train_ae", train_driver.train_autoencoder, cfg, AE_WARMUP, AE_STEPS,
                   {"fps": AE_FPS_PER_STEP, "fused_denoiser": 0, "fused_denoiser_bwd": 0},
                   TASK_PROFILE_STEPS)
    return {**res, "encode_err": encode_err}


def phase_train_latent(dev, root: str, tmp: str) -> dict:
    """The feature DDPM at full width through `train_latent_ddpm`, the
    committed AE frozen: the gradient check on a latent the frozen AE
    encoded on the card, then the counted run."""
    cfg = _task_config(latent_ddpm_config("airplane", batch_size=TRAIN_BATCH), root,
                       os.path.join(tmp, "exp_latent"))
    ae_params = load_inference_params(str(DEFAULT_CKPTS["ae"]), -1)
    ae = build_autoencoder(cfg["autoencoder_config"]["pointnet_config"])
    load_flax_params(ae, ae_params)
    ae = ae.to(dev).eval()
    batch = _first_batch(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    trainset = cfg["shapenet_psr_dataset_config"]
    kp = train_driver.sample_train_keypoints(batch["points"], trainset)
    x = torch.cat([batch["points"], batch["normals"]], dim=-1)
    with torch.no_grad():
        feat = ae.encode(x, kp, label=batch["label"],
                         noise_fn=lambda shape: torch.randn(shape, generator=gen, device=dev))
    latent = torch.cat([kp, feat], dim=-1)
    del ae
    sdc = cfg["standard_diffusion_config"]
    kp_w, feat_w = latent_config_weights(sdc)

    def loss_fn(net_fn, lat, ts, z):
        return latent_train_loss(
            net_fn, lambda *_: lat[..., 3:], None, lat[..., :3], None,
            X0Schedule.from_config(sdc, lat.device), keypoint_conditional=True,
            keypoint_position_loss_weight=kp_w, feature_loss_weight=feat_w,
            ts=ts, z=z).mean()

    grad_err = check_train_gradient("train_latent", cfg["pointnet_config"], latent,
                                    batch["label"], loss_fn, dev)

    def train_fn(c, **kw):
        return train_driver.train_latent_ddpm(c, ae_params, **kw)

    res = run_task("train_latent", train_fn, cfg, LAT_WARMUP, LAT_STEPS,
                   {"fps": LATENT_FPS_PER_STEP, "fused_denoiser": 1, "fused_denoiser_bwd": 1},
                   TASK_PROFILE_STEPS)
    return {**res, "grad_err": grad_err}


def _record_fps():
    """Wrap the SA levels' FPS so that it records each call's picks on the
    host; returns the list."""
    calls, real = [], sa_modules.furthest_point_sample

    def recording(xyz, k, *args, **kwargs):
        idx = real(xyz, k, *args, **kwargs)
        calls.append(idx.cpu())
        return idx

    sa_modules.furthest_point_sample = recording
    return calls


def _replay_fps(picks, check: bool):
    """Hand the recorded FPS picks to a run on the CPU; with `check`, its own
    FPS on the same cloud must give them exactly."""
    it, real = iter(picks), sa_modules.furthest_point_sample

    def replaying(xyz, k, *args, **kwargs):
        want = next(it)
        if check and not torch.equal(real(xyz, k, *args, **kwargs).cpu(), want):
            raise AssertionError("sap: the CPU's FPS picks differ from the card's")
        return want.to(xyz.device)

    sa_modules.furthest_point_sample = replaying


def _replay_knn_float64(calls):
    """Hand the recorded kNN searches to a float64 run: the card's neighbour
    sets and its fp32 squared distances, as float64."""
    it = iter(calls)

    def replaying(query, points, k):
        c_query, _, c_sqd, c_idx = next(it)
        if float((query - c_query.double()).abs().max()) > 1e-4:
            raise AssertionError("sap: the float64 run's kNN query left the card's")
        return c_sqd.double(), c_idx

    neighborhood.knn_points = replaying


def check_sap_gradient(cfg: dict, batch: dict, dev) -> dict:
    """The SAP net's parameter gradient through the full loss (the net, the
    split, DPSR at the preset's grid, the tanh-MSE) on the batch's first
    SAP_GRAD_CLOUDS clouds, the committed SAP weights: the card against the
    CPU module on the same mirrored cloud (made on the card), the card's FPS
    picks checked and its kNN searches replayed; each fp32 side against a
    float64 run on the same picks and searches."""
    import copy
    n = SAP_GRAD_CLOUDS
    dc = cfg["dpsr_config"]
    res = (dc["grid_res"],) * 3
    net = ConditionalPointNet2(cfg["pointnet_config"])
    load_flax_params(net, load_inference_params(str(DEFAULT_CKPTS["sap"]), -1))
    normals = batch["normals"][:n] / torch.linalg.vector_norm(batch["normals"][:n], dim=-1,
                                                               keepdim=True)
    xm = mirror_and_concat(torch.cat([batch["points"][:n], normals], dim=-1), axis=2,
                           attach_label=True,
                           generator=torch.Generator(device=dev).manual_seed(7))[0]
    label, psr = batch["label"][:n], batch["psr"][:n]
    runs = {}

    def run(key, d, dtype):
        net_ = copy.deepcopy(net).to(d, dtype)
        loss = train_driver.upsampler_loss(
            net_, DPSR(res, sig=dc["psr_sigma"]).to(d, dtype), xm.to(d, dtype), label.to(d),
            psr.to(d, dtype), cfg["shapenet_psr_dataset_config"], dc, cfg["pointnet_config"])
        loss.backward()
        runs[key] = (float(loss.detach()),
                     {name: p.grad.double().cpu() for name, p in net_.named_parameters()})

    real_knn, real_fps = neighborhood.knn_points, sa_modules.furthest_point_sample
    try:
        knn_calls, picks = _record_knn(), _record_fps()
        before = _build.launch_counts["fps"]
        run("card", dev, torch.float32)
        torch.cuda.synchronize()
        fps_launches = _build.launch_counts["fps"] - before
        neighborhood.knn_points, sa_modules.furthest_point_sample = real_knn, real_fps
        seen = _replay_knn(knn_calls, n)
        _replay_fps(picks, check=True)
        t0 = time.perf_counter()
        run("cpu", "cpu", torch.float32)
        cpu_s = time.perf_counter() - t0
        _replay_knn_float64(knn_calls)
        _replay_fps(picks, check=False)
        run("float64", "cpu", torch.float64)
    finally:
        neighborhood.knn_points, sa_modules.furthest_point_sample = real_knn, real_fps
    ref = runs["float64"][1]
    size = max(float(g.abs().max()) for g in ref.values())
    errs = {}
    for side in ("card", "cpu"):
        grads = runs[side][1]
        per = {name: float((grads[name] - g).abs().max()) for name, g in ref.items()}
        worst = sorted(per.items(), key=lambda kv: -kv[1])[:5]
        errs[side] = {"max_abs_err": max(per.values()), "of_size": max(per.values()) / size,
                      "worst": worst}
    card_cpu = max(float((runs["card"][1][k] - runs["cpu"][1][k]).abs().max()) for k in ref)
    finite = all(bool(torch.isfinite(g).all()) for g in runs["card"][1].values())
    log("train_sap_gradient", clouds=n, grid=list(res), losses={k: v[0] for k, v in runs.items()},
        max_abs_grad=size, card_vs_float64=errs["card"], cpu_vs_float64=errs["cpu"],
        card_vs_cpu=card_cpu, tol=SAP_GRAD_TOL * size,
        card_cpu_tol=SAP_CARD_CPU_TOL * size, knn_calls=seen["calls"],
        knn_ties=seen["ties"], fps_launches=fps_launches, finite=finite, cpu_seconds=cpu_s)
    if seen["calls"] != len(knn_calls) or fps_launches != len(SAP_FPS):
        raise AssertionError(f"sap: {seen['calls']} of {len(knn_calls)} kNN calls replayed, "
                             f"{fps_launches} FPS launches")
    bad = [side for side in ("card", "cpu") if errs[side]["max_abs_err"] > SAP_GRAD_TOL * size]
    if bad or card_cpu > SAP_CARD_CPU_TOL * size or not finite:
        raise AssertionError(f"sap: gradient of {bad} beyond {SAP_GRAD_TOL} of {size} from "
                             f"float64 ({errs}), card vs CPU {card_cpu}")
    return {"card_vs_float64": errs["card"]["max_abs_err"],
            "cpu_vs_float64": errs["cpu"]["max_abs_err"], "card_vs_cpu": card_cpu,
            "max_abs_grad": size}


def phase_train_sap(dev, tmp: str) -> dict:
    """The SAP upsampler at full width through `train_upsampler`, on a tree
    of 128^3 grids the port writes on the card: the gradient gate, the
    counted run, the peak memory; then a few steps with the committed AE's
    round trip."""
    root = os.path.join(tmp, "shapenet_psr_sap")
    t0 = time.perf_counter()
    write_synthetic_shapenet_psr(root, categories=SAP_CATEGORIES, models_per_split=SAP_MODELS,
                                 num_points=3000, psr_res=128, shape_variety=True,
                                 psr_from_points=True, device=dev)
    torch.cuda.synchronize()
    log("train_sap_setup", seconds=time.perf_counter() - t0, categories=len(SAP_CATEGORIES),
        models=len(SAP_CATEGORIES) * SAP_MODELS * 3, psr_res=128)
    cfg = _task_config(upsampler_config(batch_size=TRAIN_BATCH), root,
                       os.path.join(tmp, "exp_sap"))
    cfg["shapenet_psr_dataset_config"]["categories"] = list(SAP_CATEGORIES)
    grad = check_sap_gradient(cfg, _first_batch(cfg, dev), dev)
    # the host's part of a step: one batch off the loader (32 grids of
    # 128^3 read from the tree), then onto the card
    loader = get_dataloader(cfg["shapenet_psr_dataset_config"], seed=0)
    load_s, copy_s = [], []
    for _ in range(SAP_LOADER_BATCHES):
        t0 = time.perf_counter()
        batch = next(iter(loader))
        load_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        torch.as_tensor(batch["psr"], device=dev)
        torch.cuda.synchronize()
        copy_s.append(time.perf_counter() - t0)
    log("train_sap_loader", batches=SAP_LOADER_BATCHES, load_ms=1e3 * float(np.mean(load_s)),
        copy_ms=1e3 * float(np.mean(copy_s)), psr_bytes=int(batch["psr"].nbytes))
    torch.cuda.reset_peak_memory_stats()
    res = run_task("train_sap", train_driver.train_upsampler, cfg, SAP_WARMUP, SAP_STEPS,
                   {"fps": len(SAP_FPS), "fused_denoiser": 0, "fused_denoiser_bwd": 0},
                   TASK_PROFILE_STEPS)
    peak = torch.cuda.max_memory_allocated()

    # the round trip through the committed AE, from a fresh start
    cfg_ae = _task_config(upsampler_config(batch_size=TRAIN_BATCH), root,
                          os.path.join(tmp, "exp_sap_ae"))
    cfg_ae["shapenet_psr_dataset_config"]["categories"] = list(SAP_CATEGORIES)
    cfg_ae["autoencoder_config"] = autoencoder_config("airplane")
    cfg_ae["autoencoder_config"]["noise_magnitude"] = SAP_AE_NOISE
    ae_params = load_inference_params(str(DEFAULT_CKPTS["ae"]), -1)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    state, losses = train_driver.train_upsampler(cfg_ae, ae_params=ae_params,
                                                 max_iters=SAP_AE_STEPS, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ae_launches = dict(_build.launch_counts)
    values = [l for _, l in losses]
    finite = bool(np.isfinite(values).all()) and len(values) > 0
    log("train_sap_ae", steps=SAP_AE_STEPS, seconds=seconds, losses=losses, finite=finite,
        launches=ae_launches, fps_per_step_expected=SAP_AE_FPS_PER_STEP,
        noise_magnitude=SAP_AE_NOISE, peak_memory_bytes=peak)
    del state
    if not finite or ae_launches != {"fps": SAP_AE_FPS_PER_STEP * SAP_AE_STEPS}:
        raise AssertionError(f"train_sap_ae: losses {losses}, launches {ae_launches}, "
                             f"expected {SAP_AE_FPS_PER_STEP} FPS a step and nothing else")
    return {**res, "grad": grad, "peak_memory_bytes": peak, "ae_launches": ae_launches}


class ChamferPicks:
    """The chamfer distance matrices of a loss's first run (on the card),
    handed to its later runs (the CPU's fp32 and float64 runs) so that all
    score the same nearest neighbours.  A later run's own picks must be the
    card's, or part from them where the two candidates' float64 squared
    distances lie within CHAMFER_TIE_RTOL of the clouds' squared scale (a
    tie): counted."""

    def __init__(self):
        self.recorded, self.ties, self.replayed = [], 0, 0

    @contextlib.contextmanager
    def run(self):
        real, first = chamfer.pairwise_sqdist, not self.recorded
        it = iter(self.recorded)

        def recording(x, y):
            d = real(x, y)
            self.recorded.append((x.detach().cpu(), y.detach().cpu(), d.cpu()))
            return d

        def replaying(x, y):
            c_x, c_y, c_d = next(it)
            d = real(x, y)
            tol = CHAMFER_TIE_RTOL * float(c_x.square().sum(-1).max() + c_y.square().sum(-1).max())
            d64 = ((c_x.double()[:, :, None] - c_y.double()[:, None]) ** 2).sum(-1)
            for dim in (2, 1):
                own, card = d.argmin(dim).cpu(), c_d.argmin(dim)
                for row in (own != card).nonzero().tolist():
                    pair = [d64.select(dim, int(i))[tuple(row)] for i in
                            (own[tuple(row)], card[tuple(row)])]
                    if abs(float(pair[0] - pair[1])) > tol:
                        raise AssertionError(f"chamfer: a pick at {row} parts from the "
                                             f"card's beyond a tie")
                    self.ties += 1
            self.replayed += 1
            return c_d.to(device=x.device)

        chamfer.pairwise_sqdist = recording if first else replaying
        try:
            yield self
        finally:
            chamfer.pairwise_sqdist = real


def _last_checkpoint(cfg: dict) -> str:
    ckpt_dir = train_driver.experiment_dirs(cfg)[1]
    return os.path.join(ckpt_dir, f"pointnet_ckpt_{find_max_iter(ckpt_dir)}.pkl")


def phase_train_x0(dev, root: str, tmp: str) -> dict:
    """The x0 engine's position DDPM (the keypoint preset at full width,
    batch 32, with X0_CONFIG) through `train_position_ddpm`: one step's
    gradient, the card's fused denoiser against the CPU module and float64
    on the card's chamfer picks; the counted run (exactly one K3, one K1 and
    one K2 a step) and the profiled run; every K1 and FPS shape it launched
    against its plain version."""
    cfg = _task_config(keypoint_ddpm_config("airplane", batch_size=TRAIN_BATCH), root,
                       os.path.join(tmp, "exp_x0"))
    cfg["standard_diffusion_config"] = dict(X0_CONFIG)
    cfg["train_config"]["iters_per_logging"] = 50
    sdc = cfg["standard_diffusion_config"]
    batch = _first_batch(cfg, dev)
    x = train_driver.sample_train_keypoints(batch["points"], cfg["shapenet_psr_dataset_config"])
    picks = ChamferPicks()

    def loss_fn(net_fn, xx, ts, z):
        with picks.run():
            return x0_training_loss(net_fn, xx, X0Schedule.from_config(sdc, xx.device),
                                    loss_type=sdc["loss_type"],
                                    normal_loss_type=sdc["normal_loss_type"], ts=ts,
                                    z=z)["training_loss"]

    grad_err = check_train_gradient("train_x0", cfg["pointnet_config"], x, batch["label"],
                                    loss_fn, dev)
    log("train_x0_chamfer", runs=1 + picks.replayed, ties=picks.ties,
        tie_rtol=CHAMFER_TIE_RTOL)
    if picks.replayed != 2:
        raise AssertionError(f"train_x0: {picks.replayed} chamfer runs replayed, expected 2")
    inputs = KernelInputs()
    with inputs.recording():
        res = run_task("train_x0", train_driver.train_position_ddpm, cfg, TRAIN_WARMUP,
                       TRAIN_STEPS, {"fps": 1, "fused_denoiser": 1, "fused_denoiser_bwd": 1},
                       PROFILE_STEPS)
    k1_err = inputs.check("train_x0")
    pair_x0_eps(cfg, batch, dev)
    return {**res, "grad_err": grad_err, "k1_err": k1_err, "chamfer_ties": picks.ties,
            "cfg": cfg, "ckpt": _last_checkpoint(cfg)}


def pair_x0_eps(cfg: dict, batch: dict, dev) -> None:
    """The eps and x0 position steps in one process on one batch, timed in
    turns (eps, x0, x0, eps; PAIR_STEPS steps each, the host's clock around
    synchronised runs): ms a step of each."""
    eps_cfg = {k: v for k, v in cfg.items() if k != "standard_diffusion_config"}
    steps = {}
    for name, c in (("eps", eps_cfg), ("x0", cfg)):
        state, step = train_driver.build_position_ddpm(c, seed=0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        step(state, batch, gen)
        steps[name] = (state, step, gen)
    times = {"eps": [], "x0": []}
    for name in ("eps", "x0", "x0", "eps"):
        state, step, gen = steps[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAIR_STEPS):
            step(state, batch, gen)
        torch.cuda.synchronize()
        times[name].append(1e3 * (time.perf_counter() - t0) / PAIR_STEPS)
    log("train_x0_pair", steps=PAIR_STEPS, order=["eps", "x0", "x0", "eps"],
        eps_ms_per_step=times["eps"], x0_ms_per_step=times["x0"])


def check_cond_forward(cfg: dict, batch: dict, dev) -> dict:
    """The dual-tower net (its weights drawn from seed 0) on the card and on
    the CPU on the batch's first COND_CHECK clouds with normals, conditioned
    on their keypoints (FPS on the card): the card's FPS picks checked and
    its kNN searches replayed into the CPU run, both against a float64 run
    on the same picks and searches."""
    import copy
    n = COND_CHECK
    net = train_driver.init_params(ConditionalPointNet2(cfg["pointnet_config"]),
                                   torch.Generator().manual_seed(0)).eval()
    x = torch.cat([batch["points"][:n], batch["normals"][:n]], dim=-1)
    cond = train_driver.sample_train_keypoints(batch["points"][:n],
                                               cfg["shapenet_psr_dataset_config"])
    ts = torch.tensor([3, 700], device=dev)
    label = batch["label"][:n]
    outs = {}

    def run(key, d, dtype):
        net_ = copy.deepcopy(net).to(d, dtype)
        with torch.no_grad():
            outs[key] = net_(x.to(d, dtype), ts=ts.to(d), label=label.to(d),
                             condition=cond.to(d, dtype)).double().cpu()

    real_knn, real_fps = neighborhood.knn_points, sa_modules.furthest_point_sample
    try:
        knn_calls, fps_picks = _record_knn(), _record_fps()
        before = _build.launch_counts["fps"]
        run("card", dev, torch.float32)
        torch.cuda.synchronize()
        fps_launches = _build.launch_counts["fps"] - before
        neighborhood.knn_points, sa_modules.furthest_point_sample = real_knn, real_fps
        seen = _replay_knn(knn_calls, n)
        _replay_fps(fps_picks, check=True)
        run("cpu", "cpu", torch.float32)
        _replay_knn_float64(knn_calls)
        _replay_fps(fps_picks, check=False)
        run("float64", "cpu", torch.float64)
    finally:
        neighborhood.knn_points, sa_modules.furthest_point_sample = real_knn, real_fps
    ref = outs["float64"]
    scale = max(1.0, float(ref.abs().max()))
    errs = {"card_vs_float64": float((outs["card"] - ref).abs().max()),
            "cpu_vs_float64": float((outs["cpu"] - ref).abs().max()),
            "card_vs_cpu": float((outs["card"] - outs["cpu"]).abs().max())}
    want_fps = fps_launches_per_step(cfg) - 1      # the keypoints were taken above
    log("train_kp_cond_forward", clouds=n, shape=list(outs["card"].shape), max_abs=scale,
        tol=COND_NET_TOL * scale, knn_calls=seen["calls"], knn_ties=seen["ties"],
        fps_launches=fps_launches, fps_expected=want_fps, **errs)
    if seen["calls"] != len(knn_calls) or fps_launches != want_fps:
        raise AssertionError(f"kp_cond forward: {seen['calls']} of {len(knn_calls)} kNN calls "
                             f"replayed, {fps_launches} FPS launches, expected {want_fps}")
    if max(errs.values()) > COND_NET_TOL * scale:
        raise AssertionError(f"kp_cond forward: {errs} beyond {COND_NET_TOL} of {scale}")
    return errs


def phase_train_cond(dev, root: str, tmp: str) -> dict:
    """`generation` and `keypoint_conditional_generation` through
    `train_position_ddpm` at batch 32 on the 2048-point clouds with normals
    (tests/conditional_layout.py: the keypoint preset's widths), the
    module path: the dual-tower net's forward card vs CPU, then each task's
    counted run (exactly the FPS launches its config gives a step, no K1 or
    K2) and profiled run; every FPS shape launched against its plain
    version."""
    out = {}
    for name, task in (("generation", "generation"),
                       ("kp_cond", "keypoint_conditional_generation")):
        cfg = _task_config(conditional_task_config(task, batch_size=TRAIN_BATCH), root,
                           os.path.join(tmp, f"exp_{name}"))
        extra = {}
        if name == "kp_cond":
            extra = check_cond_forward(cfg, _first_batch(cfg, dev), dev)
        inputs = KernelInputs()
        with inputs.recording():
            res = run_task(f"train_{name}", train_driver.train_position_ddpm, cfg, COND_WARMUP,
                           COND_STEPS, {"fps": fps_launches_per_step(cfg), "fused_denoiser": 0,
                                        "fused_denoiser_bwd": 0}, TASK_PROFILE_STEPS)
        inputs.check(f"train_{name}")
        out[name] = {**res, **extra}
    return out


def _record_picks():
    """Record every FPS launch (the kernel's wrapper: the keypoints, the SA
    levels, the decoder's trims, the targets) and kNN search: (kind,
    inputs, picks) on the host.  Returns (the list, a function that
    restores the wrapped functions)."""
    calls = []
    real_fps, real_knn = fps_mod.fps_cuda, neighborhood.knn_points

    def fps(xyz, k, start, num_forced=0):
        idx = real_fps(xyz, k, start, num_forced)
        calls.append(("fps", (xyz.cpu(), start.cpu()), idx.cpu()))
        return idx

    def knn(query, points, k):
        sqd, idx = real_knn(query, points, k)
        calls.append(("knn", (query.cpu(), points.cpu()), idx.cpu()))
        return sqd, idx

    fps_mod.fps_cuda, neighborhood.knn_points = fps, knn

    def restore():
        fps_mod.fps_cuda, neighborhood.knn_points = real_fps, real_knn
    return calls, restore


def phase_train_bf16(dev, root: str, tmp: str) -> dict:
    """The autoencoder's step (`build_ae_training`'s, as
    tests/test_precision.py::test_ae_train_step_finite_bf16 runs it) at the
    shipped preset's full width and batch 32, under activation_dtype
    "bfloat16" and in fp32, on the same batch and draws: every FPS and kNN
    pick whose input equals the fp32 step's must be the fp32 step's (the
    keypoints' and the encoder's, on the input cloud, all are such picks);
    finite losses, fp32 parameters; ms a step and peak memory of each."""
    cfg = _task_config(autoencoder_config("airplane", batch_size=TRAIN_BATCH), root,
                       os.path.join(tmp, "exp_bf16"))
    batch = _first_batch(cfg, dev)
    n_enc = 1 + 2 * len(ENCODER_FPS)      # the keypoints, then FPS and kNN a level
    runs = {}
    for name, dtype in (("fp32", None), ("bf16", "bfloat16")):
        with activation_dtype_scope(dtype):
            state, step = train_driver.build_ae_training(cfg, seed=0, device=dev)
            calls, restore = _record_picks()
            try:
                loss = float(step(state, batch, torch.Generator(device=dev).manual_seed(11)))
            finally:
                restore()
            for _ in range(BF16_WARMUP):
                step(state, batch, torch.Generator(device=dev).manual_seed(12))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i in range(BF16_STEPS):
                last = step(state, batch, torch.Generator(device=dev).manual_seed(13 + i))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / BF16_STEPS
            runs[name] = {"loss": loss, "last_loss": float(last), "ms_per_step": ms,
                          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                          "calls": calls,
                          "fp32_params": all(p.dtype == torch.float32
                                             for p in state.net.parameters())}
            del state, step
    c32, c16 = runs["fp32"].pop("calls"), runs["bf16"].pop("calls")
    kinds_equal = [c[0] for c in c32] == [c[0] for c in c16]
    same = [i for i, (a, b) in enumerate(zip(c32, c16))
            if all(torch.equal(u, v) for u, v in zip(a[1], b[1]))]
    differ = [i for i in same if not torch.equal(c32[i][2], c16[i][2])]
    log("train_bf16", batch=TRAIN_BATCH, calls=len(c32), same_input_calls=len(same),
        encoder_calls=n_enc, picks_differ=differ, kinds_equal=kinds_equal, **runs)
    finite = all(np.isfinite([r["loss"], r["last_loss"]]).all() for r in runs.values())
    if not (kinds_equal and same[:n_enc] == list(range(n_enc)) and not differ and finite
            and runs["bf16"]["fp32_params"]):
        raise AssertionError(f"train_bf16: picks differ at {differ}, same-input calls "
                             f"{same[:n_enc]}, runs {runs}")
    return runs


def _endless(batches, batch_size: int):
    """Full batches of `batches(batch_size)`, epoch after epoch."""
    while True:
        for batch in batches(batch_size):
            if batch["label"].shape[0] == batch_size:
                yield batch


def steady_steps(phase: str, build, cfg: dict, routes, steps: int, profile_steps: int,
                 dev) -> dict:
    """A task's step in steady state, without the entry point's set-up (the
    net's init, the checkpoint, the corpus): one state and step built once,
    each route's batches (the loader's, copied to the card, or the corpus's,
    assembled on the card) fed to `steps` steps after two warm-up steps and
    timed between two synchronisations, the routes in turns (A B B A); then
    `profile_steps` more steps of each route under the profiler: busy ms and
    idle share a step."""
    from torch.profiler import ProfilerActivity, profile
    state, step = build(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    trainset = cfg["shapenet_psr_dataset_config"]
    loader = get_dataloader(trainset, seed=0)
    make = {"loader": lambda: train_driver._loader_batches(loader, dev),
            "device_data": lambda: train_driver._device_batches(loader.dataset, trainset, dev,
                                                                0, False)}
    feeds = {r: _endless(make[r](), trainset["batch_size"]) for r in routes}
    order = list(routes) + list(reversed(routes)) if len(routes) > 1 else list(routes)
    runs = {r: [] for r in routes}
    for route in order:
        for _ in range(2):
            step(state, next(feeds[route]), gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, next(feeds[route]), gen)
        torch.cuda.synchronize()
        runs[route].append(1e3 * (time.perf_counter() - t0) / steps)
    out = {}
    for route in routes:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profile_steps):
                step(state, next(feeds[route]), gen)
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(_device_us(e) for e in events) / 1e3 / profile_steps
        launches = sum(e.count for e in events if _device_us(e) > 0) / profile_steps
        ms = float(np.mean(runs[route]))
        out[route] = {"ms_per_step": runs[route], "device_busy_ms": busy,
                      "idle_share": 1.0 - busy / ms, "kernel_launches_per_step": launches}
    log(f"{phase}_steady", batch=trainset["batch_size"], steps=steps,
        profile_steps=profile_steps, order=order, **out)
    del state, feeds
    return out


def check_assembly(phase: str, cfg: dict, dev) -> dict:
    """The corpus of the config's train split (read once on the host, then
    copied to the card) and one batch assembled on the card against the
    same batch assembled on the CPU from the same draws."""
    trainset = cfg["shapenet_psr_dataset_config"]
    dataset = get_dataloader(trainset, seed=0).dataset
    t0 = time.perf_counter()
    corpus = DeviceCorpus.from_dataset(dataset)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = corpus.to(dev)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    assemble = make_assemble_fn(trainset)
    idx = torch.randperm(len(corpus), generator=torch.Generator().manual_seed(0))[:TRAIN_BATCH]
    idx = idx.to(torch.int32)
    draws = draw_assembly(trainset, TRAIN_BATCH, corpus.points.shape[1],
                          torch.Generator().manual_seed(0))
    got = assemble(card, idx.to(dev), draws={k: v.to(dev) for k, v in draws.items()})
    want = assemble(corpus, idx, draws=draws)
    equal = {k: torch.equal(got[k].cpu(), want[k]) for k in ("label", "psr") if k in want}
    errs = {k: float((got[k].cpu() - want[k]).abs().max()) / max(1.0, float(want[k].abs().max()))
            for k in ("points", "normals")}
    gen = torch.Generator(device=dev).manual_seed(0)
    idx_dev = idx.to(dev)
    ms = cuda_ms(lambda: assemble(card, idx_dev, gen), 10)
    log(f"{phase}_assemble", entries=len(corpus), models=int(corpus.points.shape[0]),
        points_per_model=int(corpus.points.shape[1]), corpus_bytes=corpus.nbytes,
        host_read_seconds=host_s, copy_seconds=copy_s, gathers_equal=equal,
        rel_err=errs, rtol=DD_RTOL, assemble_ms=ms)
    del card
    if not all(equal.values()) or max(errs.values()) > DD_RTOL:
        raise AssertionError(f"{phase}: the card's assembly differs from the CPU's: "
                             f"{equal}, {errs}")
    return {"corpus_bytes": corpus.nbytes, "assemble_ms": ms}


def phase_train_device_data(dev, root: str, sap_root: str, tmp: str) -> dict:
    """The kp and SAP presets with `device_data` through their entry points:
    the assembly card vs CPU, then warm-up, counted run (exactly the loader
    path's launches a step) and profiled run, every FPS / K1 shape held
    against its plain version."""
    out = {}
    runs = (("kp", keypoint_ddpm_config("airplane", batch_size=TRAIN_BATCH), root,
             train_driver.train_position_ddpm, train_driver.build_position_ddpm, DD_WARMUP,
             DD_STEPS, DD_PAIR_STEPS, {"fps": 1, "fused_denoiser": 1, "fused_denoiser_bwd": 1}),
            ("sap", upsampler_config(batch_size=TRAIN_BATCH), sap_root,
             train_driver.train_upsampler, train_driver.build_upsampler_training,
             DD_SAP_WARMUP, DD_SAP_STEPS, DD_SAP_PAIR_STEPS,
             {"fps": len(SAP_FPS), "fused_denoiser": 0, "fused_denoiser_bwd": 0}))
    for name, config, tree, train_fn, build_fn, warmup, steps, pair_steps, per_step in runs:
        phase = f"train_device_data_{name}"
        cfg = _task_config(config, tree, os.path.join(tmp, f"exp_dd_{name}"))
        if name == "sap":
            cfg["shapenet_psr_dataset_config"]["categories"] = list(SAP_CATEGORIES)
        cfg["train_config"]["device_data"] = True
        extra = check_assembly(phase, cfg, dev)
        inputs = KernelInputs()
        with inputs.recording():
            res = run_task(phase, train_fn, cfg, warmup, steps, per_step, TASK_PROFILE_STEPS)
        inputs.check(phase)
        steady = steady_steps(phase, build_fn, cfg, ("loader", "device_data"), pair_steps,
                              TASK_PROFILE_STEPS, dev)
        out[f"dd_{name}"] = {**res, **extra, "steady": steady}
    return out


def check_pvd_forward(cfg: dict, batch: dict, dev) -> dict:
    """PVCNN2 (its weights drawn from seed 0) on the card and in float64 on
    the CPU on the batch's first PVD_CHECK clouds, the card's picks
    replayed into the float64 run."""
    n = PVD_CHECK
    net = train_driver.init_params(train_driver.build_network(cfg["pointnet_config"]),
                                   torch.Generator().manual_seed(0)).to(dev).eval()
    x = torch.cat([batch["points"][:n], batch["normals"][:n]], dim=-1)
    ts = torch.tensor([3, 700][:n], device=dev)
    before = _build.launch_counts["fps"]
    card, ref, picks = pvcnn2_picks_replayed(net, (x, None, ts), (x.cpu().double(), None,
                                                                  ts.cpu()),
                                             "cpu", torch.float64)
    scale = max(1.0, float(ref.abs().max()))
    err = float((card - ref).abs().max())
    log("train_pvd_forward", clouds=n, shape=list(card.shape), picks_replayed=picks,
        fps_launches=_build.launch_counts["fps"] - before, max_abs=scale,
        card_vs_float64=err, tol=PVD_TOL * scale, finite=bool(torch.isfinite(card).all()))
    if not err <= PVD_TOL * scale:
        raise AssertionError(f"train_pvd: the card's forward lies {err} from float64 "
                             f"(tol {PVD_TOL * scale})")
    return {"card_vs_float64": err, "max_abs": scale}


def _backbone_config(network_type: str, root: str, tmp: str, batch: int) -> dict:
    """The kp preset's data and schedule with the `network_type` backbone at
    its defaults: PVCNN2 on `generation` (2048 points with normals, 6
    channels in and out), PointwiseNet on `keypoint_conditional_generation`
    (the clouds without normals, 3 channels)."""
    cfg = _task_config(keypoint_ddpm_config("airplane", batch_size=batch), root,
                       os.path.join(tmp, f"exp_{network_type}"))
    if network_type == "pvd":
        cfg["pointnet_config"] = {"network_type": "pvd", "in_fea_dim": 3,
                                  "model_name": "pvd_airplane",
                                  "network_args": {"out_dim": 6}}
        cfg["train_config"]["task"] = "generation"
    else:
        cfg["pointnet_config"] = {"network_type": "pointwise_net", "in_fea_dim": 0,
                                  "model_name": "pointwise_airplane", "network_args": {}}
        cfg["train_config"]["task"] = "keypoint_conditional_generation"
        cfg["shapenet_psr_dataset_config"]["include_normals"] = False
    return cfg


def phase_train_backbones(dev, root: str, tmp: str) -> dict:
    """PVCNN2 and PointwiseNet through `train_position_ddpm` (the module
    path): PVCNN2's forward card vs float64, then each one's warm-up,
    counted run (exactly its FPS launches a step, no K1 or K2) and profiled
    run, every FPS shape held against its plain version."""
    out = {}
    for name, network_type, batch, warmup, steps, profile, fps in (
            ("pvd", "pvd", PVD_BATCH, PVD_WARMUP, PVD_STEPS, PVD_PROFILE_STEPS, len(PVD_FPS)),
            ("pointwise", "pointwise_net", TRAIN_BATCH, PW_WARMUP, PW_STEPS,
             TASK_PROFILE_STEPS, 1)):
        cfg = _backbone_config(network_type, root, tmp, batch)
        extra = check_pvd_forward(cfg, _first_batch(cfg, dev), dev) if name == "pvd" else {}
        inputs = KernelInputs()
        with inputs.recording():
            res = run_task(f"train_{name}", train_driver.train_position_ddpm, cfg, warmup,
                           steps, {"fps": fps, "fused_denoiser": 0, "fused_denoiser_bwd": 0},
                           profile)
        inputs.check(f"train_{name}")
        steady = steady_steps(f"train_{name}", train_driver.build_position_ddpm, cfg,
                              ("loader",), BACKBONE_STEADY_STEPS, profile, dev)
        out[name] = {**res, **extra, "steady": steady}
    return out


def phase_item18_forward(dev, root: str) -> dict:
    """The kp preset's net (module path) with global attention after every
    level and the neighbour statistics on, radius neighbourhoods, on the
    first batch's keypoints: card vs CPU, the card's kNN picks (the KnnFP
    levels') replayed; each module's statistics equal."""
    import copy
    cfg = keypoint_ddpm_config("airplane", batch_size=TRAIN_BATCH)
    cfg["shapenet_psr_dataset_config"]["data_dir"] = root
    pc = copy.deepcopy(cfg["pointnet_config"])
    levels = len(pc["architecture"]["npoint"])
    pc["record_neighbor_stats"] = True
    pc["global_attention_setting"] = {"use_global_attention_module": True,
                                      "attention_bn": True, "last_activation": True,
                                      "global_attention_layer_index": list(range(levels))}
    pc["architecture"].update(neighbor_definition="radius", radius=ITEM18_RADIUS[:levels])
    batch = _first_batch(cfg, dev)
    kp = train_driver.sample_train_keypoints(batch["points"], cfg["shapenet_psr_dataset_config"])
    ts = torch.randint(0, 1000, (TRAIN_BATCH,), generator=torch.Generator().manual_seed(2))
    label = batch["label"]
    net = train_driver.init_params(ConditionalPointNet2(pc),
                                   torch.Generator().manual_seed(0)).eval()
    cpu_net = copy.deepcopy(net)
    net = net.to(dev)
    real_knn = neighborhood.knn_points
    try:
        knn_calls = _record_knn()
        with torch.no_grad():
            card = net(kp, ts=ts.to(dev), label=label).cpu()
        torch.cuda.synchronize()
        neighborhood.knn_points = real_knn
        seen = _replay_knn(knn_calls, TRAIN_BATCH)
        with torch.no_grad():
            cpu = cpu_net(kp.cpu(), ts=ts, label=label.cpu())
    finally:
        neighborhood.knn_points = real_knn
    card_stats = {k: {s: t.cpu() for s, t in v.items()}
                  for k, v in collect_neighbor_stats(net).items()}
    cpu_stats = collect_neighbor_stats(cpu_net)
    equal = sorted(card_stats) == sorted(cpu_stats) and all(
        torch.equal(card_stats[k][s], cpu_stats[k][s]) for k in cpu_stats for s in cpu_stats[k])
    gatt = sum(type(m).__name__ == "GlobalAttention" for m in net.modules())
    scale = max(1.0, float(cpu.abs().max()))
    err = float((card - cpu).abs().max())
    log("item18_forward", keypoints=list(kp.shape), global_attention_modules=gatt,
        knn_calls=seen["calls"], knn_ties=seen["ties"], max_abs=scale, card_vs_cpu=err,
        tol=NET_ATOL * scale, stats_equal=equal,
        stats={k: {s: t.tolist() for s, t in v.items()} for k, v in cpu_stats.items()})
    counts = [v["min_mean_max"] for v in cpu_stats.values()]
    if not equal or err > NET_ATOL * scale or gatt != 2 * levels or not counts:
        raise AssertionError(f"item18_forward: stats equal {equal}, card vs CPU {err}, "
                             f"{gatt} global attention modules")
    return {"card_vs_cpu": err}


def phase_native_marching(out) -> dict:
    """`mc_from_psr` on the counted pass's 128^3 grids: the native pass on a
    thread pool over all of them, then native and numpy one grid at a time
    on MESH_SAMPLES of them, whose content must be equal; host seconds a
    shape.  The native pass is built (or loaded) first, so that no time a
    shape holds its build."""
    grids = out["grid"].float().cpu().numpy()
    n = MESH_SAMPLES
    t0 = time.perf_counter()
    native_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    threaded = mc_from_psr(grids, num_threads=MARCHING_THREADS)
    threaded_s = (time.perf_counter() - t0) / len(grids)
    t0 = time.perf_counter()
    native = mc_from_psr(grids[:n])
    native_s = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    numpy_route = mc_from_psr(grids[:n], native=False)
    numpy_s = (time.perf_counter() - t0) / n
    same = [same_content(tuple(r[i] for r in native), tuple(r[i] for r in numpy_route))
            for i in range(n)]
    same_threaded = all(np.array_equal(a, b) for r, t in zip(native, threaded)
                        for a, b in zip(r, t[:n]))
    faces = [len(f) for f in threaded[1]]
    log("native_marching", grids=len(grids), res=int(grids.shape[-1]),
        threads=MARCHING_THREADS, build_or_load_seconds=build_s,
        threaded_seconds_per_shape=threaded_s,
        native_seconds_per_shape=native_s, numpy_seconds_per_shape=numpy_s,
        same_content=same, threaded_equals_serial=same_threaded, faces=faces)
    if not (all(same) and same_threaded and min(faces) > 0):
        raise AssertionError(f"native_marching: content equal {same}, threaded equal "
                             f"{same_threaded}, faces {faces}")
    return {"native_s": native_s, "numpy_s": numpy_s, "threaded_s": threaded_s}


def _committed_weights(net_fn, path: str, dev):
    """The committed checkpoint's net on the card (raw weights) and its EMA
    shadows as the training state holds them (lists of tensors parallel to
    the net's parameters)."""
    net = net_fn()
    load_flax_params(net, load_inference_params(path, -1))
    shadows = []
    for i in range(len(read_checkpoint(path).get("ema_state_list") or [])):
        m = net_fn()
        load_flax_params(m, load_inference_params(path, i))
        shadows.append([p.detach().to(dev) for p in m.parameters()])
    return net.to(dev).eval(), shadows


class KernelInputs:
    """The inputs of the first launch of each kernel shape while `recording`
    is on: the wrappers are wrapped for that time, call through to the
    kernels and count as they always do; `check` then holds the kernel at
    each shape, on those inputs, against its plain version."""

    def __init__(self):
        self.fps, self.k1, self.k2 = {}, {}, {}

    @contextlib.contextmanager
    def recording(self):
        real_fps, real_k1 = fps_mod.fps_cuda, fd.fused_forward_cuda
        real_k2 = fd.fused_backward_cuda

        def fps(xyz, k, start, num_forced=0):
            key = (*xyz.shape, k, num_forced)
            if key not in self.fps:
                self.fps[key] = (xyz.clone(), start.clone())
            return real_fps(xyz, k, start, num_forced)

        def k1(packed, pc, t4, cls, flat=None):
            key = tuple(pc.shape)
            if key not in self.k1:
                self.k1[key] = (packed, pc.clone(), t4.clone(), cls.clone(), flat)
            return real_k1(packed, pc, t4, cls, flat)

        def k2(packed, pc, t4, cls, g, flat=None):
            key = tuple(pc.shape)
            if key not in self.k2:
                self.k2[key] = (packed, pc.clone(), t4.clone(), cls.clone(), g.clone(),
                                None if flat is None else flat.clone())
            return real_k2(packed, pc, t4, cls, g, flat)

        fps_mod.fps_cuda, fd.fused_forward_cuda, fd.fused_backward_cuda = fps, k1, k2
        try:
            yield self
        finally:
            fps_mod.fps_cuda, fd.fused_forward_cuda = real_fps, real_k1
            fd.fused_backward_cuda = real_k2

    def check(self, phase: str, k2_clouds: Optional[int] = None) -> float:
        """Each kept shape's kernel against its plain version: FPS indices
        equal, K1 within K1_ATOL, K2 as `phase_k2` holds it (its plain
        version in float64, the relu ties resolved as K2 did, K2_TOL); with
        `k2_clouds`, the batch's launch held to float64 in chunks of as many
        clouds (`k2_gate_in_chunks`).  Returns K1's largest error (K2's:
        `k2_err`)."""
        for (b, n, d, k, forced), (xyz, start) in sorted(self.fps.items()):
            got = fps_mod.fps_cuda(xyz, k, start, forced)
            want = fps_mod.fps_plain(xyz, k, start, forced)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            log(f"{phase}_k3", n=n, k=k, batch=b, d=d, forced=forced, equal=equal)
            if not equal:
                raise AssertionError(f"{phase}: fps N={n} K={k} batch {b}: "
                                     f"{int((got != want).sum())} indices differ")
        max_err = 0.0
        for shape, (packed, pc, t4, cls, flat) in sorted(self.k1.items()):
            with torch.no_grad():
                got = fd.fused_forward_cuda(packed, pc, t4, cls, flat)
                want = fd.fused_forward_plain(None, packed, pc, t4, cls, flat)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            log(f"{phase}_k1", shape=list(shape), max_abs_err=err, atol=K1_ATOL)
            if not (err <= K1_ATOL and bool(torch.isfinite(got).all())):
                raise AssertionError(f"{phase}: K1 at {list(shape)}: kernel and plain "
                                     f"differ by {err}")
        self.k2_err = 0.0
        for shape, (packed, pc, t4, cls, g, flat) in sorted(self.k2.items()):
            got = fd.fused_backward_cuda(packed, pc, t4, cls, g, flat)
            if k2_clouds is not None and k2_clouds < pc.shape[0]:
                errs, ties = k2_gate_in_chunks(f"{phase}: K2 at {list(shape)}", packed, pc,
                                               t4, cls, g, got, k2_clouds, flat)
            else:
                want, ties = fd.fused_backward_reference(packed, pc, t4, cls, g, got, flat,
                                                         tol=K2_TOL)
                torch.cuda.synchronize()
                errs = k2_errors(got, want)
            self.k2_err = max([self.k2_err] + [e["max_abs"] for e in errs.values()])
            log(f"{phase}_k2", shape=list(shape), err=errs, ties=ties)
            if not all(e["ok"] for e in errs.values()):
                raise AssertionError(f"{phase}: K2 at {list(shape)} differs from plain: {errs}")
        return max_err


def run_hook(name: str, hook, net, shadows, expected: dict, files: list) -> dict:
    """One checkpoint's evaluation through a training hook: seconds, the
    kernel launches (exactly `expected`), the files it writes."""
    _build.launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hook(net, shadows, EVAL_ITER)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    missing = [f for f in files if not os.path.isfile(f)]
    log(f"eval_{name}", seconds=seconds, launches=launches, expected=expected,
        weight_sets=1 + len(shadows), files=len(files), missing=missing)
    if missing or any(launches.get(k, 0) != n for k, n in expected.items()):
        raise AssertionError(f"eval_{name}: launches {launches}, expected {expected}; "
                             f"missing {missing}")
    return {"launches": launches, "seconds": seconds}


def phase_eval(dev, root: str, sap_root: str, tmp: str, x0: dict) -> tuple[dict, float]:
    """The evaluations (`run_evals`), then every kernel shape they launched
    held against its plain version on the inputs it had there: (the
    evaluations' results, K1's largest error in that check)."""
    inputs = KernelInputs()
    with inputs.recording():
        res = run_evals(dev, root, sap_root, tmp, x0)
    return res, inputs.check("eval")


def run_evals(dev, root: str, sap_root: str, tmp: str, x0: dict) -> dict:
    """The four training tasks' checkpoint-time evaluations, the mesh
    reconstruction and the metrics, with the committed checkpoints; the x0
    engine's position evaluation with the weights `phase_train_x0` left
    (`x0`: its config and last checkpoint)."""
    from slide_tpu_torch.eval import compute_all_metrics, jsd_between_point_cloud_sets
    from slide_tpu_torch.eval import mesh_recon
    from slide_tpu_torch.eval.generation import generated_file
    from slide_tpu_torch.ops.emd import earth_mover_distance
    res = {}

    def files(cfg, name, weight_sets):
        base = os.path.join(train_driver.experiment_dirs(cfg)[0], "eval_result")
        rates = cfg["train_config"]["ema_rate"][:weight_sets - 1]
        return [os.path.join(base, name)] + [os.path.join(base, f"model_ema_{r:.5f}", name)
                                             for r in rates]

    # the position DDPM: 128 shapes in batches of 64, T=1000, every weight set
    cfg = _task_config(keypoint_ddpm_config("airplane"), root, os.path.join(tmp, "eval_kp"))
    trainset = cfg["shapenet_psr_dataset_config"]
    assert (trainset["eval_batch_size"], trainset["num_samples_tested"]) == \
        (EVAL_BATCH, EVAL_SAMPLES)
    net, shadows = _committed_weights(lambda: ConditionalPointNet2(cfg["pointnet_config"]),
                                      str(DEFAULT_CKPTS["kp"]), dev)
    batches = -(-EVAL_SAMPLES // EVAL_BATCH)
    name = os.path.basename(generated_file("", trainset["num_keypoints"], 0, 1,
                                           f"_iter_{EVAL_ITER}"))
    kp_files = files(cfg, name, 1 + len(shadows))
    res["kp"] = run_hook("kp", train_driver.make_generation_eval_hook(cfg), net, shadows,
                         {"fused_denoiser": T_STEPS * batches * (1 + len(shadows)), "fps": 0},
                         kp_files)
    with np.load(kp_files[0]) as d:
        kp_ok = d["points"].shape == (EVAL_SAMPLES, 16, 3) and bool(np.isfinite(d["points"]).all())
    if not kp_ok:
        raise AssertionError("eval_kp: the generated keypoints are not (128, 16, 3) finite")

    # the x0 engine's position DDPM: the same test set, each chain x0_denoise
    # over T steps of K1
    cfg = x0["cfg"]
    trainset = cfg["shapenet_psr_dataset_config"]
    net, shadows = _committed_weights(lambda: ConditionalPointNet2(cfg["pointnet_config"]),
                                      x0["ckpt"], dev)
    t_x0 = cfg["standard_diffusion_config"]["num_diffusion_timesteps"]
    x0_files = files(cfg, name, 1 + len(shadows))
    res["x0"] = run_hook("x0", train_driver.make_generation_eval_hook(cfg), net, shadows,
                         {"fused_denoiser": t_x0 * batches * (1 + len(shadows)), "fps": 0},
                         x0_files)
    with np.load(x0_files[0]) as d:
        x0_ok = d["points"].shape == (EVAL_SAMPLES, 16, 3) and bool(np.isfinite(d["points"]).all())
    if not x0_ok:
        raise AssertionError("eval_x0: the generated keypoints are not (128, 16, 3) finite")

    # the feature DDPM over the committed AE, keypoints from the train split
    cfg = _task_config(latent_ddpm_config("airplane"), root, os.path.join(tmp, "eval_lat"))
    trainset = cfg["shapenet_psr_dataset_config"]
    trainset["num_samples_tested"] = LATENT_EVAL_SAMPLES
    ae_params = load_inference_params(str(DEFAULT_CKPTS["ae"]), -1)
    net, shadows = _committed_weights(lambda: ConditionalPointNet2(cfg["pointnet_config"]),
                                      str(DEFAULT_CKPTS["lat"]), dev)
    name = os.path.basename(generated_file("", trainset["npoints"], 0, 1,
                                           f"_iter_{EVAL_ITER}"))
    lat_files = files(cfg, name, 1 + len(shadows))
    sets = 1 + len(shadows)
    res["latent"] = run_hook(
        "latent", train_driver.make_latent_eval_hook(cfg, ae_params), net, shadows,
        {"fused_denoiser": T_STEPS * sets, "fps": (1 + len(DECODE_FPS)) * sets}, lat_files)
    with np.load(lat_files[0]) as d:
        generated = d["points"][..., :3]
    if generated.shape != (LATENT_EVAL_SAMPLES, 2048, 3) or not np.isfinite(generated).all():
        raise AssertionError(f"eval_latent: generated clouds {generated.shape}, not finite")

    # the autoencoder: its visual and quantitative passes
    cfg = _task_config(autoencoder_config("airplane"), root, os.path.join(tmp, "eval_ae"))
    ae = build_autoencoder(cfg["pointnet_config"])
    load_flax_params(ae, ae_params)
    trainset = cfg["shapenet_psr_dataset_config"]
    # batches: the val split's at the eval batch size, three times; the train
    # split's (repeated) at the training batch size, as the loaders give them
    n_val = len(get_dataloader(dict(trainset, repeat_dataset=1), phase="val").dataset)
    n_train = len(get_dataloader(trainset, phase="train").dataset)
    passes = 3 * -(-n_val // EVAL_BATCH) + -(-n_train // trainset["batch_size"])
    base = os.path.join(train_driver.experiment_dirs(cfg)[0], "eval_result")
    quant = "shapenet_psr_autoencoder_quantitative_eval_result.pkl"
    ae_files = [os.path.join(base, "shapenet_psr_autoencoder_visualization_result_iteration_"
                             f"{EVAL_ITER:08d}_epoch_0000.pkl")] + \
        [os.path.join(base, sub, quant) for sub in ("trainset_eval", "valset_eval",
                                                    "valset_eval_keypoint_noise_0")]
    res["ae"] = run_hook("ae", train_driver.make_ae_eval_hook(cfg), ae.to(dev).eval(), [],
                         {"fps": AE_FPS_PER_STEP * passes, "fused_denoiser": 0}, ae_files)

    # the SAP net's grid L2 on the SAP tree's val split
    cfg = _task_config(upsampler_config(), sap_root, os.path.join(tmp, "eval_sap"))
    trainset = cfg["shapenet_psr_dataset_config"]
    trainset["categories"] = list(SAP_CATEGORIES)
    sap_net, _ = _committed_weights(lambda: ConditionalPointNet2(cfg["pointnet_config"]),
                                    str(DEFAULT_CKPTS["sap"]), dev)
    n_val = len(get_dataloader(trainset, phase="val").dataset)
    base = os.path.join(train_driver.experiment_dirs(cfg)[0], "eval_result")
    res["sap"] = run_hook("sap", train_driver.make_sap_eval_hook(cfg), sap_net, [],
                          {"fps": len(SAP_FPS) * -(-n_val // trainset["eval_batch_size"]),
                           "fused_denoiser": 0},
                          [os.path.join(base, "shapenet_psr_dpsr_eval_result.pkl")])
    with open(os.path.join(base, "shapenet_psr_dpsr_eval_result.pkl"), "rb") as f:
        sap_loss = pickle.load(f)["dpsr_grid_L2_loss"]

    # the mesh reconstruction of a few shapes, the first mesh against the
    # numpy oracle on its grid
    dc = cfg["dpsr_config"]
    dpsr = DPSR((dc["grid_res"],) * 3, sig=dc["psr_sigma"]).to(dev)
    recon_set = dict(trainset, categories=[SAP_CATEGORIES[0]], eval_batch_size=RECON_SHAPES // 2)
    grids, meshes = [], []
    real_march, real_host = mesh_recon.marching_tetrahedra_device, mesh_recon.mesh_to_host

    def marching(grid):
        grids.append(grid[:1].clone())
        return real_march(grid)

    def to_host(mesh, i):
        meshes.append(real_host(mesh, i))
        return meshes[-1]

    mesh_recon.marching_tetrahedra_device, mesh_recon.mesh_to_host = marching, to_host
    _build.launch_counts.clear()
    try:
        t0 = time.perf_counter()
        vis = mesh_recon.reconstruct_meshes(
            sap_net, dpsr, get_dataloader(recon_set, phase="val", seed=0),
            cfg["pointnet_config"], dc, recon_set, os.path.join(tmp, "recon"),
            iteration=EVAL_ITER, scale=trainset["scale"], do_sample_points_from_mesh=True,
            return_original_scale=True, device=dev)
        torch.cuda.synchronize()
        recon_s = time.perf_counter() - t0
    finally:
        mesh_recon.marching_tetrahedra_device, mesh_recon.mesh_to_host = real_march, real_host
    recon_launches = dict(_build.launch_counts)
    written = sorted(os.listdir(os.path.join(vis, "reconstructed_mesh")))
    # the first shape's mesh (in the grid's [0, 1) frame, before the move
    # back to its cloud's scale) against the numpy oracle on its grid
    vol = grids[0][0].cpu().numpy()
    diff = mesh_difference(meshes[0], marching_tetrahedra_numpy(vol), vol.shape[-1])
    with np.load(os.path.join(vis, "points_sampled_from_mesh.npz")) as d:
        sampled = d["points"].shape
    log("eval_reconstruct", shapes=RECON_SHAPES, seconds=recon_s, launches=recon_launches,
        meshes=len(written), sampled=list(sampled), first_mesh=diff)
    if len(written) != RECON_SHAPES or recon_launches.get("fps", 0) != 2 * len(SAP_FPS) \
            or not diff.get("same_faces") or diff["vert_err"] > MESH_VERT_ATOL \
            or diff["normal_err"] > MESH_NORMAL_ATOL:
        raise AssertionError(f"eval_reconstruct: {len(written)} meshes, {recon_launches}, "
                             f"first mesh {diff}")

    # the metrics: the feature DDPM's clouds against the tree's val clouds
    refs = next(iter(get_dataloader(dict(_task_config(
        latent_ddpm_config("airplane"), root, tmp)["shapenet_psr_dataset_config"],
        eval_batch_size=LATENT_EVAL_SAMPLES, repeat_dataset=1), phase="val", seed=0)))["points"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = compute_all_metrics(generated, refs, batch_size=32, device=dev)
    torch.cuda.synchronize()
    metrics_s = time.perf_counter() - t0
    jsd = jsd_between_point_cloud_sets(generated, refs)
    a = torch.as_tensor(generated, device=dev)
    b = torch.as_tensor(refs, dtype=torch.float32, device=dev)
    with torch.no_grad():
        card = earth_mover_distance(a[:EMD_CHECK], b[:EMD_CHECK]).cpu()
        cpu = earth_mover_distance(a[:EMD_CHECK].cpu(), b[:EMD_CHECK].cpu())
        emd_ms = cuda_ms(lambda: earth_mover_distance(a, b), 3) / len(a)
    emd_err = float(((card - cpu).abs() / cpu.abs()).max())
    log("eval_metrics", samples=len(generated), refs=len(refs), points=2048,
        seconds=metrics_s, metrics={k: float(v) for k, v in metrics.items()}, jsd=jsd,
        emd_card=card.tolist(), emd_cpu=cpu.tolist(), emd_card_vs_cpu=emd_err,
        emd_rtol=EMD_CARD_RTOL, emd_ms_per_pair=emd_ms, sap_grid_l2=sap_loss)
    if not (emd_err <= EMD_CARD_RTOL and all(np.isfinite(list(metrics.values())))):
        raise AssertionError(f"eval_metrics: EMD card vs CPU {emd_err}, metrics {metrics}")
    res["reconstruct"] = {"launches": recon_launches, "seconds": recon_s}
    return res


# ---------------------------------------------------------------------------
# The command line and data-parallel training


def _cli_npz_shapes(path: str) -> dict:
    with np.load(path) as d:
        return {k: list(d[k].shape) for k in d.files}


def phase_cli(dev, root: str, tmp: str) -> dict:
    """The README's Quick start through the port's command line
    (`slide_tpu_torch.cli.main`, in this process) at full width with the
    committed checkpoints: the presets written with `write_json_file`, then
    `train` (the kp preset, CLI_TRAIN_STEPS steps), `generate` (CLI_SAMPLES
    keypoint sets at batch CLI_SAMPLES, T=1000), `latent-generate` on those
    keypoints, `reconstruct` of its clouds, `evaluate --all-metrics` of them
    against the tree's val clouds, `encode` and `decode` of those.  Each
    subcommand's seconds, launches (exactly CLI_LAUNCHES), outputs' shapes."""
    from slide_tpu_torch.cli.main import main as cli
    from slide_tpu_torch.config import write_json_file
    base = os.path.join(tmp, "cli")
    os.makedirs(base)
    cfgs = {"kp": _task_config(keypoint_ddpm_config("airplane"), root, os.path.join(base, "exp")),
            "lat": _task_config(latent_ddpm_config("airplane"), root, base),
            "ae": _task_config(autoencoder_config("airplane"), root, base),
            "sap": upsampler_config()}
    paths = {}
    for name, cfg in cfgs.items():
        paths[name] = os.path.join(base, f"{name}_config.json")
        write_json_file(paths[name], cfg, reference_style=True)
    # the reference clouds: the tree's val split, points, normals and labels
    refs = next(iter(get_dataloader(dict(cfgs["lat"]["shapenet_psr_dataset_config"],
                                         eval_batch_size=CLI_SAMPLES, repeat_dataset=1),
                                    phase="val", seed=0)))
    ref_npz = os.path.join(base, "val_clouds.npz")
    np.savez(ref_npz, points=refs["points"], normals=refs["normals"],
             label=np.asarray(refs["label"]))
    kp_npz = os.path.join(base, "gen", "shapenet_psr_generated_data_16_pts.npz")
    lat_npz = os.path.join(base, "lat", "shapenet_psr_generated_data_2048_pts.npz")
    enc_npz = os.path.join(base, "enc", "autoencoder_reconstruction.npz")
    n = str(CLI_SAMPLES)
    runs = [
        ("train", ["train", "-c", paths["kp"], "--max_iters", str(CLI_TRAIN_STEPS)]),
        ("generate", ["generate", "-c", paths["kp"], "--ckpt", str(DEFAULT_CKPTS["kp"]),
                      "--num_samples", n, "--batch_size", n,
                      "--save_dir", os.path.dirname(kp_npz)]),
        ("latent-generate", ["latent-generate", "-c", paths["lat"],
                             "--ckpt", str(DEFAULT_CKPTS["lat"]),
                             "--ae_ckpt", str(DEFAULT_CKPTS["ae"]), "--num_samples", n,
                             "--batch_size", n, "--external_keypoint_file", kp_npz,
                             "--save_dir", os.path.dirname(lat_npz)]),
        ("reconstruct", ["reconstruct", "-c", paths["sap"], "--ckpt", str(DEFAULT_CKPTS["sap"]),
                         "--dataset_path", lat_npz, "--save_dir", os.path.join(base, "rec")]),
        ("evaluate", ["evaluate", "--gen", lat_npz, "--ref", ref_npz, "--all-metrics",
                      "--out", os.path.join(base, "metrics.json")]),
        ("encode", ["encode", "-c", paths["ae"], "--ckpt", str(DEFAULT_CKPTS["ae"]),
                    "--dataset_path", ref_npz, "--save_dir", os.path.dirname(enc_npz),
                    "--save_keypoint_feature"]),
        ("decode", ["decode", "-c", paths["ae"], "--ckpt", str(DEFAULT_CKPTS["ae"]),
                    "--dataset_path", enc_npz, "--save_dir", os.path.join(base, "dec")]),
    ]
    res, outs = {}, {}
    for name, argv in runs:
        _build.launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = cli(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: _build.launch_counts.get(k, 0) for k in CLI_LAUNCHES[name]}
        res[name] = {"seconds": seconds, "launches": launches}
        if launches != CLI_LAUNCHES[name]:
            raise AssertionError(f"cli {name}: launches {launches}, expected "
                                 f"{CLI_LAUNCHES[name]}")

    # the outputs
    state, losses = outs["train"]
    kp, lat = _cli_npz_shapes(kp_npz), _cli_npz_shapes(lat_npz)
    with np.load(lat_npz) as d:
        points, normals = d["points"], d["normals"]
    norms = np.linalg.norm(normals, axis=-1)
    meshes = sorted(os.listdir(os.path.join(outs["reconstruct"], "reconstructed_mesh")))
    metrics = outs["evaluate"]
    enc = _cli_npz_shapes(outs["encode"])
    dec = _cli_npz_shapes(outs["decode"])
    checks = {
        "train": state.step == CLI_TRAIN_STEPS and bool(np.isfinite([l for _, l in losses]).all()),
        "generate": kp["points"] == [CLI_SAMPLES, 16, 3],
        "latent": lat["points"] == lat["normals"] == [CLI_SAMPLES, 2048, 3]
        and bool(np.isfinite(points).all()),
        # the decode's normals as the AE gives them (not unit: `reconstruct`
        # normalises them, as the JAX package's does)
        "normals": bool(np.isfinite(normals).all() and (norms > 0).all()),
        "meshes": len(meshes) == CLI_SAMPLES,
        "metrics": bool(np.isfinite(list(metrics.values())).all()),
        "encode": enc["points"] == [CLI_SAMPLES, 2048, 6]
        and enc["keypoint_feature"][:2] == [CLI_SAMPLES, 16],
        "decode": dec["points"] == [CLI_SAMPLES, 2048, 6],
    }
    log("cli", subcommands=res, shapes={"generate": kp, "latent-generate": lat,
                                        "encode": enc, "decode": dec},
        normal_norms=[float(norms.min()), float(norms.max())], meshes=len(meshes),
        metrics=metrics, train_losses=losses, checks=checks)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"cli: failed {bad}")
    return {name: r["launches"] for name, r in res.items()}


def _ddp_config(root: str, exp: str) -> dict:
    return _task_config(keypoint_ddpm_config("airplane", batch_size=DDP_BATCH), root, exp)


def ddp_worker(rank: str, world: str, coord: str, backend: str, root: str, tmp: str) -> None:
    """One rank of the `ddp` phase, a process of its own: joins the group
    over `backend`; the first step's all-reduced gradient (16 rows here)
    against one process's step on all DDP_BATCH rows with the same draws,
    per element (rank 0); a warm-up of `train_position_ddpm` (rank 0 writes
    its checkpoint), then DDP_STEPS counted steps resumed from it: ms a
    step, launches, the parameters' digest; every K1, K2 and K3 shape the
    rank launched held against its plain version.  Writes
    <tmp>/ddp_<backend>_rank<r>.json."""
    from ddp_worker import digest, step_gap
    from slide_tpu_torch.parallel import maybe_initialize_distributed
    rank, world = int(rank), int(world)
    maybe_initialize_distributed(coord, world, rank, backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _ddp_config(root, os.path.join(tmp, f"exp_ddp_{backend}"))
    inputs = KernelInputs()
    out = {"rank": rank, "device": str(dev)}
    batch = _first_batch(cfg, dev)
    with inputs.recording():
        res = step_gap(lambda: train_driver.build_position_ddpm(cfg, seed=0, device=dev),
                       batch, rank, world)
    if rank == 0:
        beyond, worst = 0, 0.0
        for a, b in zip(res["grads"], res["ref_grads"]):
            beyond += int(((a - b).abs() > GRAD_ATOL + GRAD_RTOL * b.abs()).sum())
            worst = max(worst, float((a - b).abs().max()))
        out["gradient"] = {"beyond": beyond, "max_abs_err": worst,
                           "max_abs_grad": max(float(g.abs().max()) for g in res["ref_grads"]),
                           "loss": res["loss"], "one_process_loss": res["ref_loss"]}
    out["step_digest"] = res["digest"]
    del res
    train_driver.train_position_ddpm(cfg, max_iters=DDP_WARMUP, device=dev, verbose=False)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    with inputs.recording():
        t0 = time.perf_counter()
        state, losses = train_driver.train_position_ddpm(cfg, max_iters=DDP_WARMUP + DDP_STEPS,
                                                         device=dev, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    out.update(launches=dict(_build.launch_counts), ms_per_step=1e3 * seconds / DDP_STEPS,
               losses=losses, step=state.step, digest=digest(state.net))
    out["k1_err"] = inputs.check(f"ddp_{backend}_rank{rank}")
    out["k2_err"] = inputs.k2_err
    out["k1_shapes"] = sorted(list(s) for s in inputs.k1)
    out["k2_shapes"] = sorted(list(s) for s in inputs.k2)
    with open(os.path.join(tmp, f"ddp_{backend}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def run_ddp_ranks(backend: str, root: str, tmp: str) -> list:
    """DDP_WORLD processes of `ddp_worker` joined at a free local port; each
    rank's result.  Their output goes to <tmp>/ddp_<backend>_rank<r>.log,
    whose end is printed if a rank fails."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [os.path.join(tmp, f"ddp_{backend}_rank{r}.log") for r in range(DDP_WORLD)]
    procs = []
    for r in range(DDP_WORLD):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-worker", str(r),
                 str(DDP_WORLD), f"127.0.0.1:{port}", backend, root, tmp],
                stdout=f, stderr=subprocess.STDOUT))
    try:
        codes = [p.wait(timeout=DDP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, code in enumerate(codes):
        with open(logs[r]) as f:
            tail = f.read()[-3000:]
        if code != 0:
            raise AssertionError(f"ddp {backend} rank {r} exited {code}:\n{tail}")
    results = []
    for r in range(DDP_WORLD):
        with open(os.path.join(tmp, f"ddp_{backend}_rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def check_ddp(backend: str, ranks: list, one_process_ms: float) -> dict:
    grad = ranks[0]["gradient"]
    per_step = {"fps": 1, "fused_denoiser": 1, "fused_denoiser_bwd": 1}
    checks = {
        "gradient": grad["beyond"] == 0,
        "step_params_equal": len({r["step_digest"] for r in ranks}) == 1,
        "params_equal": len({r["digest"] for r in ranks}) == 1,
        "losses_equal": all(r["losses"] == ranks[0]["losses"] for r in ranks),
        "launches": all(r["launches"].get(k, 0) == n * DDP_STEPS
                        for r in ranks for k, n in per_step.items()),
        "batch16_shapes": all([DDP_BATCH // DDP_WORLD, 16, 3] in r["k1_shapes"]
                              and [DDP_BATCH // DDP_WORLD, 16, 3] in r["k2_shapes"]
                              for r in ranks),
        "steps": all(r["step"] == DDP_WARMUP + DDP_STEPS for r in ranks),
    }
    log(f"ddp_{backend}", world=DDP_WORLD, batch=DDP_BATCH, rows_per_rank=DDP_BATCH // DDP_WORLD,
        steps=DDP_STEPS, gradient=grad, grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL,
        devices=[r["device"] for r in ranks],
        ms_per_step=[r["ms_per_step"] for r in ranks], one_process_ms_per_step=one_process_ms,
        launches=[r["launches"] for r in ranks], launches_per_step_expected=per_step,
        k1_err=max(r["k1_err"] for r in ranks), k2_err=max(r["k2_err"] for r in ranks),
        k1_shapes=ranks[0]["k1_shapes"], k2_shapes=ranks[0]["k2_shapes"],
        first_loss=ranks[0]["losses"][0], last_loss=ranks[0]["losses"][-1], checks=checks)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"ddp_{backend}: failed {bad}")
    return {"launches_per_rank": ranks[0]["launches"], "ms_per_step": ranks[0]["ms_per_step"],
            "k1_err": max(r["k1_err"] for r in ranks), "k2_err": max(r["k2_err"] for r in ranks)}


def phase_ddp(root: str, tmp: str, one_process_ms: float) -> dict:
    """Data-parallel training on the card: DDP_WORLD ranks as processes on
    the one card over gloo (its all-reduce goes through the host), then,
    where the machine has as many cards, one rank a card over NCCL."""
    torch.cuda.empty_cache()
    res = {"gloo": check_ddp("gloo", run_ddp_ranks("gloo", root, tmp), one_process_ms)}
    if torch.cuda.device_count() >= DDP_WORLD:
        res["nccl"] = check_ddp("nccl", run_ddp_ranks("nccl", root, tmp), one_process_ms)
    else:
        log("ddp_nccl", nccl=f"not run: {torch.cuda.device_count()} card")
    return res


def main():
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(*sys.argv[2:])
        return
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    smi = smi_line()
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)

    t0 = time.perf_counter()
    path, nvcc_s, report = _build.build(("-Xptxas", "-v"))
    _build.load_kernels()
    log("build", seconds=time.perf_counter() - t0, nvcc_seconds=nvcc_s,
        library=path.name, ptxas=[l for l in report.splitlines() if "Used" in l])

    per_shape, max_err = phase_k3(dev)

    t0 = time.perf_counter()
    stages = build_stages(BATCH, T_STEPS)
    log("slice_setup", seconds=time.perf_counter() - t0, t_steps=T_STEPS, fused=True)
    phase_k1_plans(stages, dev)
    k1, k1_err = phase_k1(stages, dev)
    k2, k2_err = phase_k2(stages, dev)

    # the main path: a warm-up pass, then the counted pass
    warm = generate(stages, seed=1)
    log("slice_warmup", seconds=warm["seconds"])
    out, launches = run_slice("slice", stages, 0, want_fused=2 * T_STEPS)
    phase_mesh(stages, out, dev)
    phase_native_marching(out)
    del out
    run_slice("fastdpm", with_fastdpm(stages, FASTDPM_STEPS), 2,
              want_fused=2 * FASTDPM_STEPS)

    phase_net(stages, dev)

    del stages
    unfused = build_stages(BATCH, T_UNFUSED, fused=False)
    warm = generate(unfused, seed=1)
    log("unfused_slice_warmup", t_steps=T_UNFUSED, seconds=warm["seconds"])
    run_slice("unfused_slice", unfused, 0, want_fused=0)
    del unfused

    # 64 keypoints, the fused kernels' limit: K1 and K2 there, then the chain
    t0 = time.perf_counter()
    stages64 = stages_at(N64, T64)
    log("slice64_setup", seconds=time.perf_counter() - t0, t_steps=T64, n=N64, fused=True)
    k64 = phase_large(stages64, dev, N64, K64_CHECK)
    slice64 = phase_slice_at("slice64", stages64, N64, 2 * T64)
    del stages64
    # 128 keypoints, the kernels' limit: K1 and K2 there (K2 in tiles), then
    # the chain with FastDPM
    t0 = time.perf_counter()
    stages128 = stages_at(N128, T_STEPS)
    log("slice128_setup", seconds=time.perf_counter() - t0, t_steps=FASTDPM_STEPS, n=N128,
        fused=True, sampler="fastdpm")
    k128 = phase_large(stages128, dev, N128, K128_CHECK)
    slice128 = phase_slice_at("slice128", with_fastdpm(stages128, FASTDPM_STEPS), N128,
                              2 * FASTDPM_STEPS)
    del stages128
    large = {N64: k64, N128: k128}

    # the training tasks: the first three on one synthetic airplane tree with
    # normals, the SAP upsampler on a tree of DPSR grids
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "shapenet_psr")
        t0 = time.perf_counter()
        write_synthetic_shapenet_psr(root, categories=("02691156",), models_per_split=16,
                                     num_points=3000, shape_variety=True, with_psr=False)
        log("train_setup", seconds=time.perf_counter() - t0, batch=TRAIN_BATCH, models=16)
        sap_root = os.path.join(tmp, "shapenet_psr_sap")
        tasks = {"kp": phase_train(dev, root, tmp),
                 "kp64": phase_train_at(dev, root, tmp, N64, TRAIN_BATCH, TRAIN64_WARMUP,
                                        TRAIN64_STEPS),
                 "kp128": phase_train_at(dev, root, tmp, N128, TRAIN128_CHECK,
                                         TRAIN128_WARMUP, TRAIN128_STEPS),
                 "ae": phase_train_ae(dev, root, tmp),
                 "latent": phase_train_latent(dev, root, tmp), "sap": phase_train_sap(dev, tmp),
                 "x0": phase_train_x0(dev, root, tmp), **phase_train_cond(dev, root, tmp),
                 **phase_train_device_data(dev, root, sap_root, tmp),
                 **phase_train_backbones(dev, root, tmp)}
        phase_item18_forward(dev, root)
        phase_train_bf16(dev, root, tmp)
        evals, eval_k1_err = phase_eval(dev, root, sap_root, tmp, tasks["x0"])
        cli = phase_cli(dev, root, tmp)
        ddp = phase_ddp(root, tmp, tasks["kp"]["ms_per_step"])

    def per_cli(name):
        return {sub: launches.get(name, 0) for sub, launches in cli.items()}

    def per_rank_step(name):
        return {backend: res["launches_per_rank"].get(name, 0) / DDP_STEPS
                for backend, res in ddp.items()}

    def per_task(name):
        return {task: res["launches"].get(name, 0) for task, res in tasks.items()}

    def per_eval(name):
        return {hook: res["launches"].get(name, 0) for hook, res in evals.items()}

    def fps_sum(calls, b):
        """ms, plain ms and bound of the FPS calls `calls` at batch b, summed."""
        rows = [per_shape[(n, k, b)] for n, k in calls]
        return (sum(r[0] for r in rows), sum(r[1] for r in rows),
                bound([sum(r[2][i] for r in rows) for i in range(2)]))

    # FPS: one pass's worth of calls (the decode's and the SAP net's), summed
    ms, plain_ms, (bound_ms, bound_by) = fps_sum(PASS_FPS, BATCH)
    enc_ms, enc_plain_ms, (enc_bound_ms, enc_bound_by) = fps_sum(ENCODER_FPS, TRAIN_BATCH)
    sap_train = fps_sum(SAP_FPS, TRAIN_BATCH)
    # PVCNN2's four SA levels at its batch of 16 (the decode's shapes)
    pvd_fps = fps_sum(PVD_FPS, PVD_BATCH)
    # K1: per launch of the main path, which runs the kp and latent nets
    # 1000 times each at batch 16: the mean of the two
    nets = [k1[(name, BATCH)] for name in ("kp", "lat")]
    k1_parts = [sum(r[3][i] for r in nets) / 2 for i in range(2)]
    k1_bound, k1_by = bound(k1_parts)
    # K2: per launch of the training path, the kp net at its batch of 32
    k2_main = k2[("kp", TRAIN_BATCH)]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fps", "route": "cuda", "source": "slide_tpu_torch/csrc/fps.cu",
        "replaces": "slide_tpu/ops/pallas/fps.py:98",
        "launches": launches.get("fps", 0), "max_abs_err": float(max_err),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "launches_train": per_task("fps"),
        "launches_slice64": slice64["launches"].get("fps", 0),
        "launches_slice128": slice128["launches"].get("fps", 0),
        "launches_eval": per_eval("fps"), "launches_cli": per_cli("fps"),
        "launches_ddp_per_rank_step": per_rank_step("fps"),
        "decode_ms": fps_sum(DECODE_FPS, BATCH)[0],
        "sap_ms": fps_sum(SAP_FPS, BATCH)[0], "sap_plain_ms": fps_sum(SAP_FPS, BATCH)[1],
        "sap_bound_ms": fps_sum(SAP_FPS, BATCH)[2][0],
        "encoder_ms": enc_ms, "encoder_plain_ms": enc_plain_ms,
        "encoder_bound_ms": enc_bound_ms, "encoder_bound_by": enc_bound_by,
        "sap_train_ms": sap_train[0], "sap_train_plain_ms": sap_train[1],
        "sap_train_bound_ms": sap_train[2][0], "sap_train_bound_by": sap_train[2][1],
        "pvd_ms": pvd_fps[0], "pvd_plain_ms": pvd_fps[1], "pvd_bound_ms": pvd_fps[2][0],
        "pvd_bound_by": pvd_fps[2][1]}, {
        "name": "fused_denoiser", "route": "cuda",
        "source": "slide_tpu_torch/csrc/fused_denoiser.cu",
        "replaces": "slide_tpu/models/fused_denoiser.py:553",
        "launches": launches.get("fused_denoiser", 0),
        "max_abs_err": max(k1_err, eval_k1_err, tasks["x0"]["k1_err"], tasks["kp64"]["k1_err"],
                           tasks["kp128"]["k1_err"], slice64["k1_err"], slice128["k1_err"],
                           *(r["k1_err"] for k in large.values() for r in k.values()),
                           *(res["k1_err"] for res in ddp.values())),
        "ms": sum(r[0] for r in nets) / 2, "plain_ms": sum(r[1] for r in nets) / 2,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
        "module_ms": sum(r[2] for r in nets) / 2,
        "per_net": {name: {"ms": r[0], "plain_ms": r[1], "module_ms": r[2],
                           "bound_ms": bound(r[3])[0], "bound_by": bound(r[3])[1],
                           "scratch_bytes_ms": r[4]}
                    for name, r in [*zip(("kp", "lat"), nets),
                                    *((f"{name}_n{n}", k[name]["k1"]) for n, k in large.items()
                                      for name in ("kp", "lat"))]},
        "launches_train": per_task("fused_denoiser"),
        "launches_slice64": slice64["launches"].get("fused_denoiser", 0),
        "launches_slice128": slice128["launches"].get("fused_denoiser", 0),
        "launches_eval": per_eval("fused_denoiser"), "launches_cli": per_cli("fused_denoiser"),
        "launches_ddp_per_rank_step": per_rank_step("fused_denoiser")}, {
        "name": "fused_denoiser_bwd", "route": "cuda",
        "source": "slide_tpu_torch/csrc/fused_denoiser_bwd.cu",
        "replaces": "slide_tpu/models/fused_denoiser.py:621",
        "launches": tasks["kp"]["launches"].get("fused_denoiser_bwd", 0),
        "max_abs_err": max(k2_err, tasks["kp64"]["k2_err"], tasks["kp128"]["k2_err"],
                           *(r["k2_err"] for k in large.values() for r in k.values()),
                           *(res["k2_err"] for res in ddp.values())),
        "ms": k2_main[0], "plain_ms": k2_main[1],
        "bound_ms": bound(k2_main[2])[0], "bound_by": bound(k2_main[2])[1],
        "library_ms": None, "launches_train": per_task("fused_denoiser_bwd"),
        "launches_slice64": slice64["launches"].get("fused_denoiser_bwd", 0),
        "launches_slice128": slice128["launches"].get("fused_denoiser_bwd", 0),
        "tiles_train": {task: res.get("k2_tiles", 1) for task, res in tasks.items()
                        if res["launches"].get("fused_denoiser_bwd", 0)},
        "launches_cli": per_cli("fused_denoiser_bwd"),
        "launches_ddp_per_rank_step": per_rank_step("fused_denoiser_bwd"),
        "per_net": {key: {"ms": r[0], "plain_ms": r[1],
                          "bound_ms": bound(r[2])[0], "bound_by": bound(r[2])[1],
                          "scratch_bytes_ms": r[3]}
                    for key, r in [*((f"{name}_b{b}", r) for (name, b), r in k2.items()),
                                   *((f"{name}_n{n}", k[name]["k2"]) for n, k in large.items()
                                     for name in ("kp", "lat"))]}}]}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
