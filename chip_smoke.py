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
           starts) and at training's (batch 32, 2049 -> 16): indices must be
           equal; the
           threads per block (`threads_for`), kernel ms, plain ms and the
           bound per shape
  k1_plan  per net and per occupancy (1 and 2 blocks per SM, where a plan
           fits), the fused denoiser's plan: shared memory per block, the
           clusters the card holds at once, row buffers in device memory,
           whether it is the net's own plan; the kernel at batch 16 under
           that plan against the plain version (atol 1e-4), and its ms
  k1       the fused-denoiser kernel against its plain PyTorch version, kp
           and latent nets with the committed weights, batch 16 and 5:
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
  train    position-DDPM training at the kp preset's full width and batch
           32 on a synthetic airplane tree written here: one step's card
           gradient against the CPU module's, every element of every
           parameter within rtol 5e-3, atol 1e-4 (the JAX package's
           fused-vs-module tolerance) once the relu ties that K2 resolved
           otherwise than float64 are taken off; then `train_position_ddpm`
           for a few warm-up steps (a checkpoint) and a counted run resumed
           from it: ms per step, the loss at the first and last logged
           iterations (finite), exactly one K2 and one K1 launch per step and
           at least one FPS launch per step; then a further run of
           `train_position_ddpm` under `torch.profiler`: the card's busy ms
           per step, the idle share of the counted run's step, the kernels
           and host operations that take the most time

Then the nvidia-smi line, one JSON line of kernel figures, and the last
line {"ok": true, "device": {...}}.  Any failure raises and exits nonzero; a
hang ends in a stack trace when the watchdog fires.
"""

import contextlib
import ctypes
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from slide_tpu_torch import _build
from slide_tpu_torch.models import fused_denoiser as fd
from slide_tpu_torch.ops import fps as fps_mod
from slide_tpu_torch.configs import keypoint_ddpm_config
from slide_tpu_torch.data import get_dataloader, write_synthetic_shapenet_psr
from slide_tpu_torch.diffusion import calc_diffusion_hyperparams, diffusion_training_loss
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.pipeline import build_stages, generate, with_fastdpm
from slide_tpu_torch.sap import (DPSR, count_cells_and_faces, marching_tetrahedra_numpy,
                                 mesh_to_host, mirror_and_concat,
                                 network_output_to_dpsr_grid, point_rasterize)
from slide_tpu_torch.train import driver as train_driver
from slide_tpu_torch.train.checkpoint import find_max_iter

# the mesh gate, shared with the tests (numpy only)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from mesh_compare import MESH_NORMAL_ATOL, MESH_VERT_ATOL, mesh_difference  # noqa: E402

faulthandler.dump_traceback_later(600, exit=True)

BATCH = 16
T_STEPS = 1000
T_UNFUSED = 100        # the unfused slice, cut so that the run stays short
FASTDPM_STEPS = 50
K1_BATCHES = (16, 5)
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
TRAIN_STEPS = 200
PROFILE_STEPS = 30
# one step's card gradient against the CPU module's, per element (the JAX
# package's fused-vs-module tolerance), once K2's tie decisions are taken off
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
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
# published H100 SXM peaks (fp32 outside the tensor cores; dense TF32 on the
# tensor cores; HBM3)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    for n, k, b in sorted({(n, k, BATCH) for n, k in PASS_FPS} | {TRAIN_FPS}):
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
        per_shape[(n, k)] = (ms, plain_ms, parts)
        bound_ms, bound_by = bound(parts)
        log("k3", n=n, k=k, batch=b, equal=True, threads=fps_mod.threads_for(n), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by)
    return per_shape, max_err


def _table_work(lay: dict, b: int) -> tuple[int, int]:
    """(flops, weight floats) of one fused forward at batch b, from the packed
    net's layer table: the weight dots, 2 * rows * c_in * c_out each, and
    every weight once."""
    n = lay["n"]
    tot = {"flops": 0, "weights": 0}

    def dense(d, rows):
        tot["flops"] += 2 * b * rows * d["cin"] * d["cout"]
        tot["weights"] += d["cin"] * d["cout"] + (d["cout"] if d["b"] >= 0 else 0)

    def norm(nd):
        tot["weights"] += 2 * (nd["c"] - nd["c"] % nd["g"])

    def mlp(m, rows):
        for i in range(m["n_layers"]):
            dense(m["conv"][i], rows)
            norm(m["norm"][i])
        if m["inject_t"]:
            dense(m["fc_t"], 1)
        if m["inject_c"]:
            dense(m["fc_c"], 1)
        if m["res"] == 2:
            dense(m["res_conv"], rows)

    def att(a, k):
        dense(a["feat_conv"], n)
        for key in ("grouped_conv", "w_conv_1", "w_conv_2", "out_conv"):
            dense(a[key], n * k)
        for key in ("w_norm_1", "w_norm_2", "out_norm"):
            norm(a[key])

    for s in lay["sa"][:lay["n_sa"]]:
        mlp(s["mlp"], n * s["k"])
        att(s["att"], s["k"])
    for f in lay["fp"][:lay["n_fp"]]:
        mlp(f["mlp1"], n * f["k"])
        att(f["att"], f["k"])
        mlp(f["mlp2"], n)
    dense(lay["head1"], n)
    norm(lay["head_norm"])
    dense(lay["head_out"], n)
    return tot["flops"], tot["weights"]


def tc_ms(flops: float) -> float:
    """flops of fp32 dots run as 3xTF32 on the tensor cores (three TF32
    products per fp32 one) at the dense TF32 peak, in ms."""
    return 1e3 * 3 * flops / PEAK_TF32_FLOPS


def k1_bound_parts(lay: dict, b: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of one fused forward at batch b: inputs,
    output and weights once at the memory rate; the weight dots as 3xTF32 on
    the tensor cores, which is how the kernel computes them."""
    flops, weights = _table_work(lay, b)
    n = lay["n"]
    io = b * n * lay["din"] + b * lay["t4"] + b * lay["cls"] + b * n * lay["out_dim"]
    return 1e3 * 4 * (io + weights) / PEAK_BYTES, tc_ms(flops)


def k2_bound_parts(lay: dict, b: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of one fused backward at batch b: inputs
    (pc, t4, cls, the cotangent, the weights) read once and the gradients
    (of pc, t4, cls and the weights) written once at the memory rate; three
    weight dots per forward one (the recompute, d input, d weight) as 3xTF32
    on the tensor cores, which is how the kernel computes them."""
    flops, weights = _table_work(lay, b)
    n = lay["n"]
    io = 2 * (b * n * lay["din"] + b * lay["t4"] + b * lay["cls"]) + b * n * lay["out_dim"]
    return 1e3 * 4 * (io + 2 * weights) / PEAK_BYTES, tc_ms(3 * flops)


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


def k1_inputs(net, b: int, width: int, gen, dev):
    pc = torch.randn((b, 16, width), generator=gen, device=dev)
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
        pc, _, _, t4, cls = k1_inputs(net, BATCH, width, gen, dev)
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
            pc, ts, label, t4, cls = k1_inputs(net, b, width, gen, dev)
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
            res[(name, b)] = (ms, plain_ms, module_ms, parts)
            bound_ms, bound_by = bound(parts)
            log("k1", net=name, batch=b, max_abs_err=err, atol=K1_ATOL, ms=ms,
                plain_ms=plain_ms, module_ms=module_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes_ms=parts[0], operations_ms=parts[1],
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


def k2_case(net, b: int, width: int, gen, dev, duplicates: bool = False):
    pc = torch.randn((b, 16, width), generator=gen, device=dev)
    if duplicates:
        pc[:, 1] = pc[:, 0]
        pc[:, 2] = pc[:, 0]
    g = torch.randn((b, 16, width), generator=gen, device=dev)
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
            pc, t4, cls, g = k2_case(net, b, width, gen, dev, duplicates)
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
            res[(name, b)] = (ms, plain_ms, parts)
            bound_ms, bound_by = bound(parts)
            lay2 = fn.packed.layout2
            clusters = k2_max_clusters(fn.packed)
            log("k2", net=name, batch=b, err=errs, ties=ties, repeat_equal=True,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes_ms=parts[0], operations_ms=parts[1],
                fp32_operations_ms=fp32_ms(3 * _table_work(fn.packed.layout, b)[0]),
                blocks_per_cloud=lay2["cluster"], blocks_per_sm=lay2["occupancy"],
                max_clusters=clusters, waves=-(-b // clusters), parts_ms=launch,
                weight_grad_ms=launch["weight_grad"], weight_grad_splits=fn.packed.splits)
    return res, worst


def _train_config(root: str, exp: str) -> dict:
    cfg = keypoint_ddpm_config("airplane", batch_size=TRAIN_BATCH)
    cfg["shapenet_psr_dataset_config"]["data_dir"] = root
    cfg["train_config"].update(root_directory=exp, iters_per_logging=50)
    return cfg


def check_train_gradient(cfg: dict, dev) -> float:
    """One step's gradients: the card's fused denoiser (K1 + K2) against the
    module on the CPU, same weights, batch, keypoints, ts and z, per element
    once the relu ties that K2 resolved otherwise than float64 are taken
    off.  Those are found at the core: K2 relaunched on the inputs and the
    cotangent the step gave it, against `fused_backward_reference`."""
    pointnet = cfg["pointnet_config"]
    net = train_driver.init_params(ConditionalPointNet2(pointnet),
                                   torch.Generator().manual_seed(0))
    cpu_net = ConditionalPointNet2(pointnet)
    cpu_net.load_state_dict(net.state_dict())
    net = net.to(dev)
    batch = next(iter(get_dataloader(cfg["shapenet_psr_dataset_config"], seed=0)))
    points = torch.as_tensor(batch["points"], device=dev)
    label = torch.as_tensor(batch["label"], dtype=torch.int64)
    x = train_driver.sample_train_keypoints(points, cfg["shapenet_psr_dataset_config"])
    gen = torch.Generator().manual_seed(1)
    ts = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen)
    z = torch.randn(tuple(x.shape), generator=gen)
    sched = calc_diffusion_hyperparams(1000, 1e-4, 0.02)
    apply = fd.make_fused_train_fn(pointnet, net, x.shape[1])
    core = {}

    def net_fn(xt, t):
        out = apply(xt, t, label.to(dev))
        core.update(x=xt.detach().contiguous(), ts=t)
        out.register_hook(lambda g: core.update(g=g.detach().contiguous()))
        return out

    loss = diffusion_training_loss(net_fn, x, calc_diffusion_hyperparams(1000, 1e-4, 0.02, dev),
                                   ts=ts.to(dev), z=z.to(dev))
    loss.backward()
    cpu_loss = diffusion_training_loss(lambda xt, t: cpu_net(xt, ts=t, label=label),
                                       x.cpu(), sched, ts=ts, z=z)
    cpu_loss.backward()

    # the core's inputs again (under autograd, to carry a change of K2's
    # output back to the parameters), K2 on them, and its tie decisions
    t4 = net.t_embedder(core["ts"])
    cls = net.class_emb(label.to(dev))
    flat = apply.packed.live_flat()
    ins = [core["x"], t4.detach().contiguous(), cls.detach().contiguous(), flat.detach()]
    got = fd.fused_backward_cuda(apply.packed, ins[0], ins[1], ins[2], core["g"], ins[3])
    want, ties = fd.fused_backward_reference(apply.packed, ins[0], ins[1], ins[2],
                                             core["g"], got, ins[3], tol=K2_TOL)
    plain64, _ = fd.fused_backward_reference(apply.packed, ins[0], ins[1], ins[2],
                                             core["g"], got, ins[3], max_tries=0)
    core_errs = k2_errors(got, want)
    params = dict(net.named_parameters())
    taken = torch.autograd.grad(
        [t4, cls, flat], list(params.values()),
        [(w - p).float() for w, p in zip(want[1:], plain64[1:])], allow_unused=True)

    beyond, beyond_raw, worst, where = 0, 0, 0.0, {}
    for (name, p), q, tie in zip(params.items(), cpu_net.parameters(), taken):
        raw = p.grad.double().cpu()
        got_p = raw - (0 if tie is None else tie.double().cpu())
        want_p = q.grad.double()
        tol = GRAD_ATOL + GRAD_RTOL * want_p.abs()
        beyond_raw += int(((raw - want_p).abs() > tol).sum())
        err = (got_p - want_p).abs()
        worst = max(worst, float(err.max()))
        bad = int((err > tol).sum())
        if bad or not bool(torch.isfinite(raw).all()):
            where[name] = {"beyond": bad, "max_abs": float(err.max())}
        beyond += bad
    log("train_gradient", loss=float(loss.detach()), cpu_loss=float(cpu_loss.detach()),
        max_abs_err=worst, beyond=beyond, beyond_before_ties=beyond_raw, ties=ties,
        core=core_errs)
    if where or not all(e["ok"] for e in core_errs.values()):
        raise AssertionError(f"train: gradient differs from the CPU module's: {where}; "
                             f"K2 at the core: {core_errs}")
    return worst


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


def profile_train(cfg: dict, done: int, ms_per_step: float) -> None:
    """`PROFILE_STEPS` more steps of `train_position_ddpm` (resumed at
    iteration `done`) under `torch.profiler`: the card's busy ms per step,
    the idle share of the counted run's step of `ms_per_step`, and the
    kernels and host operations that take the most time per step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_driver.train_position_ddpm(cfg, max_iters=done + PROFILE_STEPS, verbose=False)
        torch.cuda.synchronize()
    n = PROFILE_STEPS
    events = prof.key_averages()
    kernels = sorted(((e.key, _device_us(e) / 1e3 / n, e.count / n) for e in events
                      if _device_us(e) > 0), key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / n, e.count / n) for e in events
                   if _device_us(e) == 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    log("train_profile", steps=n, device_busy_ms=busy, idle_share=1.0 - busy / ms_per_step,
        kernel_launches_per_step=sum(r[2] for r in kernels),
        top_kernels=[list(r) for r in kernels[:10]], top_host_ops=[list(r) for r in host[:12]])
    if busy <= 0:
        raise AssertionError("train_profile: the profiler saw no kernel on the card")


def phase_train(dev) -> dict:
    """Position-DDPM training at full width through `train_position_ddpm`:
    a warm-up run that writes a checkpoint, a counted run resumed from it,
    then a profiled run resumed from the counted run's last checkpoint."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "shapenet_psr")
        t0 = time.perf_counter()
        write_synthetic_shapenet_psr(root, categories=("02691156",), models_per_split=16,
                                     num_points=3000, shape_variety=True, with_psr=False)
        cfg = _train_config(root, os.path.join(tmp, "exp"))
        log("train_setup", seconds=time.perf_counter() - t0, batch=TRAIN_BATCH,
            models=16 * cfg["shapenet_psr_dataset_config"]["repeat_dataset"])
        grad_err = check_train_gradient(cfg, dev)

        ckpt_dir = train_driver.experiment_dirs(cfg)[1]
        t0 = time.perf_counter()
        _, warm = train_driver.train_position_ddpm(cfg, max_iters=TRAIN_WARMUP, verbose=False)
        torch.cuda.synchronize()
        saved = find_max_iter(ckpt_dir)
        log("train_warmup", steps=TRAIN_WARMUP, seconds=time.perf_counter() - t0,
            losses=warm, checkpoint_iter=saved)
        if saved != TRAIN_WARMUP - 1:
            raise AssertionError(f"train: warm-up saved iteration {saved}, expected "
                                 f"{TRAIN_WARMUP - 1}")

        _build.launch_counts.clear()
        t0 = time.perf_counter()
        state, losses = train_driver.train_position_ddpm(
            cfg, max_iters=TRAIN_WARMUP + TRAIN_STEPS, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        final = find_max_iter(ckpt_dir)
        values = [l for _, l in losses]
        finite = bool(np.isfinite(values).all()) and len(values) > 0
        log("train", batch=TRAIN_BATCH, steps=TRAIN_STEPS, resumed_from=saved,
            seconds=seconds, ms_per_step=1e3 * seconds / TRAIN_STEPS,
            first_loss=losses[0] if losses else None,
            last_loss=losses[-1] if losses else None, warmup_first_loss=warm[0],
            finite=finite, launches=launches, final_checkpoint_iter=final)
        if not finite:
            raise AssertionError(f"train: losses {losses}")
        if state.step != TRAIN_WARMUP + TRAIN_STEPS or final != TRAIN_WARMUP + TRAIN_STEPS - 1:
            raise AssertionError(f"train: did not resume at iteration {TRAIN_WARMUP}: step "
                                 f"{state.step}, last checkpoint {final}")
        for name, want in (("fused_denoiser_bwd", TRAIN_STEPS),
                           ("fused_denoiser", TRAIN_STEPS)):
            if launches.get(name, 0) != want:
                raise AssertionError(f"train: {launches.get(name, 0)} {name} launches in "
                                     f"{TRAIN_STEPS} steps, expected {want}")
        if launches.get("fps", 0) < TRAIN_STEPS:
            raise AssertionError(f"train: {launches.get('fps', 0)} FPS launches in "
                                 f"{TRAIN_STEPS} steps")
        del state
        profile_train(cfg, TRAIN_WARMUP + TRAIN_STEPS, 1e3 * seconds / TRAIN_STEPS)
    return {"launches": launches, "seconds": seconds, "grad_err": grad_err}


def main():
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

    train = phase_train(dev)

    # FPS: one pass's worth of calls (the decode's and the SAP net's), summed
    ms = sum(per_shape[s][0] for s in PASS_FPS)
    plain_ms = sum(per_shape[s][1] for s in PASS_FPS)
    bound_ms, bound_by = bound([sum(per_shape[s][2][i] for s in PASS_FPS)
                                for i in range(2)])
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
        "library_ms": None, "launches_train": train["launches"].get("fps", 0),
        "decode_ms": sum(per_shape[s][0] for s in DECODE_FPS),
        "sap_ms": sum(per_shape[s][0] for s in SAP_FPS),
        "sap_plain_ms": sum(per_shape[s][1] for s in SAP_FPS),
        "sap_bound_ms": bound([sum(per_shape[s][2][i] for s in SAP_FPS)
                               for i in range(2)])[0]}, {
        "name": "fused_denoiser", "route": "cuda",
        "source": "slide_tpu_torch/csrc/fused_denoiser.cu",
        "replaces": "slide_tpu/models/fused_denoiser.py:553",
        "launches": launches.get("fused_denoiser", 0), "max_abs_err": k1_err,
        "ms": sum(r[0] for r in nets) / 2, "plain_ms": sum(r[1] for r in nets) / 2,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
        "module_ms": sum(r[2] for r in nets) / 2,
        "per_net": {name: {"ms": r[0], "plain_ms": r[1], "module_ms": r[2],
                           "bound_ms": bound(r[3])[0], "bound_by": bound(r[3])[1]}
                    for name, r in zip(("kp", "lat"), nets)},
        "launches_train": train["launches"].get("fused_denoiser", 0)}, {
        "name": "fused_denoiser_bwd", "route": "cuda",
        "source": "slide_tpu_torch/csrc/fused_denoiser_bwd.cu",
        "replaces": "slide_tpu/models/fused_denoiser.py:621",
        "launches": train["launches"].get("fused_denoiser_bwd", 0),
        "max_abs_err": k2_err, "ms": k2_main[0], "plain_ms": k2_main[1],
        "bound_ms": bound(k2_main[2])[0], "bound_by": bound(k2_main[2])[1],
        "library_ms": None,
        "per_net": {f"{name}_b{b}": {"ms": r[0], "plain_ms": r[1],
                                     "bound_ms": bound(r[2])[0], "bound_by": bound(r[2])[1]}
                    for (name, b), r in k2.items()}}]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
