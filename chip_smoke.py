#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`slide_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a card, `nvcc` and PyTorch
built for CUDA.  It builds the kernels itself into `build/`.  Phases, one
line each as soon as it ends:

  env      torch and CUDA versions; the card's name and power limit
  build    one nvcc call for all kernel sources, its seconds and ptxas report
  k3       the FPS kernel against its plain PyTorch version at every shape
           the decode gives it (batch 16, random and zero starts): indices
           must be equal; kernel ms, plain ms and the bound per shape
  slice    position DDPM -> feature DDPM -> AE decode at full width, batch 16,
           T=1000, committed checkpoints: seconds per stage; the cloud must be
           (16, 2048, 6) and finite, and the FPS kernel must have been
           launched by the decode (launch counter)
  net      the kp and latent denoisers on the card against the CPU, same
           weights and input, atol 1e-4 (fp32, TF32 off)

Then the nvidia-smi line, one JSON line of kernel figures, and the last
line {"ok": true, "device": {...}}.  Any failure raises and exits nonzero; a
hang ends in a stack trace when the watchdog fires.
"""

import faulthandler
import json
import subprocess
import sys
import time

import numpy as np
import torch

from slide_tpu_torch import _build
from slide_tpu_torch.ops import fps as fps_mod
from slide_tpu_torch.pipeline import build_stages, generate

faulthandler.dump_traceback_later(600, exit=True)

BATCH = 16
T_STEPS = 1000
# (N, K) of the FPS calls of one decode, in call order: the keypoint level's
# trim, level 2's SA stack and trim, level 3's SA stack and trim
DECODE_FPS = [(512, 256), (256, 128), (128, 64), (64, 16), (2048, 1024),
              (1024, 256), (256, 64), (64, 16), (4096, 2048)]
# published H100 SXM peaks (fp32 outside the tensor cores; HBM3)
PEAK_FP32_FLOPS = 67e12
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
    for n, k in sorted(set(DECODE_FPS)):
        xyz = torch.randn((BATCH, n, 3), generator=gen, device=dev)
        starts = {"random": torch.randint(0, n, (BATCH,), generator=gen, device=dev,
                                          dtype=torch.int32),
                  "zero": torch.zeros((BATCH,), dtype=torch.int32, device=dev)}
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
        parts = fps_bound_parts(BATCH, n, k)
        per_shape[(n, k)] = (ms, plain_ms, parts)
        bound_ms, bound_by = bound(parts)
        log("k3", n=n, k=k, batch=BATCH, equal=True, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by)
    return per_shape, max_err


def phase_net(stages, dev):
    rng = np.random.default_rng(0)
    for name, net, width in [("kp", stages.kp_net, 3),
                             ("lat", stages.lat_net, 3 + stages.latent_dim)]:
        x = torch.as_tensor(rng.standard_normal((BATCH, 16, width)), dtype=torch.float32)
        ts = torch.as_tensor(rng.integers(0, T_STEPS, BATCH), dtype=torch.int32)
        label = torch.zeros(BATCH, dtype=torch.int64)
        with torch.no_grad():
            got = net(x.to(dev), ts=ts.to(dev), label=label.to(dev)).cpu()
            cpu_net = net.to("cpu")
            want = cpu_net(x, ts=ts, label=label)
            net.to(dev)
        err = float((got - want).abs().max())
        log("net", net=name, max_abs_err=err, atol=1e-4)
        if not err <= 1e-4:
            raise AssertionError(f"{name} net: card and CPU differ by {err}")


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
    log("slice_setup", seconds=time.perf_counter() - t0)
    warm = generate(stages, seed=1)
    log("slice_warmup", seconds=warm["seconds"])
    _build.launch_counts.clear()
    out = generate(stages, seed=0)
    launches = dict(_build.launch_counts)
    cloud = out["cloud"]
    finite = bool(torch.isfinite(cloud).all())
    log("slice", batch=BATCH, t_steps=T_STEPS, seconds=out["seconds"],
        shape=list(cloud.shape), finite=finite, launches=launches)
    if tuple(cloud.shape) != (BATCH, 2048, 6) or not finite:
        raise AssertionError(f"bad cloud: shape {tuple(cloud.shape)}, finite {finite}")
    if launches.get("fps", 0) < len(DECODE_FPS):
        raise AssertionError(f"decode launched the FPS kernel {launches.get('fps', 0)} "
                             f"times, expected {len(DECODE_FPS)}")

    phase_net(stages, dev)

    # one decode's worth of FPS calls, summed
    ms = sum(per_shape[s][0] for s in DECODE_FPS)
    plain_ms = sum(per_shape[s][1] for s in DECODE_FPS)
    bound_ms, bound_by = bound([sum(per_shape[s][2][i] for s in DECODE_FPS)
                                for i in range(2)])
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fps", "route": "cuda", "source": "slide_tpu_torch/csrc/fps.cu",
        "replaces": "slide_tpu/ops/pallas/fps.py:98",
        "launches": launches.get("fps", 0), "max_abs_err": float(max_err),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
