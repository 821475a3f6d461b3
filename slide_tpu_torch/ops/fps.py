"""Farthest-point sampling: the plain PyTorch version and the wrapper of the
CUDA kernel `csrc/fps.cu` (counterpart: `slide_tpu/ops/fps.py`, TPU kernel
`slide_tpu/ops/pallas/fps.py::fps_pallas`).

Semantics (those of `slide_tpu/ops/fps.py::_fps_scan`):
  - the first pick is `start_idx` (scalar or one per row),
  - each round updates the running minimum of the squared distance, over all
    D channels, to the last pick, and picks the first maximum (ties go to the
    lowest index),
  - the first `num_forced` picks are 0..num_forced-1 whatever the distances.

A tensor on the CPU goes to `fps_plain`; a CUDA tensor goes to the kernel
(bounded on the card by its serial chain of K rounds, each one block-wide
argmax behind one barrier, not by bytes or flops) or raises.  The kernel and the plain version
round each distance the same way, ((dx*dx + dy*dy) + dz*dz) with no fused
multiply-add, so their indices are equal.
"""

from __future__ import annotations

from typing import Optional

import torch

from slide_tpu_torch import _build
from slide_tpu_torch.parallel.sharded import batch_randint

# one block holds the cloud (D x N floats) in shared memory and at most
# 32 points per thread in registers (csrc/fps.cu)
_MAX_SMEM_FLOATS = (227 * 1024 - 1024) // 4
_MAX_POINTS = 16 * 1024


def threads_for(n: int) -> int:
    """The kernel's threads per block for N = `n`: about two points a thread,
    from 4 to 16 warps (at most 32 points a thread up to `_MAX_POINTS`).
    Chosen on an H100 over the decode's shapes and training's 2049 points,
    timing each block size from 64 to 1024 (PERF.md §6): at N >= 512,
    where a decode's time goes, this is the fastest size or within 1% of it;
    1024 threads lose 10-40% to the round's barrier, 128 threads at N = 4096
    lose 11x to the scan (32 points a thread)."""
    return min(512, max(128, -(-n // 64) * 32))


def _start_tensor(start_idx, b: int, n: int, device) -> torch.Tensor:
    if isinstance(start_idx, int):
        if not 0 <= start_idx < n:
            raise ValueError(f"start_idx {start_idx} outside [0, {n})")
        return torch.full((b,), start_idx, dtype=torch.int32, device=device)
    start = torch.as_tensor(start_idx, device=device).to(torch.int32)
    start = torch.broadcast_to(start, (b,)).contiguous()
    if start.device.type == "cpu" and bool(((start < 0) | (start >= n)).any()):
        raise ValueError(f"start_idx outside [0, {n})")
    return start


def fps_plain(xyz: torch.Tensor, k: int, start: torch.Tensor,
              num_forced: int = 0) -> torch.Tensor:
    """Plain PyTorch FPS with the kernel's arithmetic.  xyz (B, N, D) f32,
    start (B,) int -> (B, k) int32."""
    b, n, d = xyz.shape
    pts = xyz.float()
    out = torch.empty((b, k), dtype=torch.int32, device=xyz.device)
    last = start.long()
    out[:, 0] = last
    rows = torch.arange(b, device=xyz.device)
    min_d = torch.full((b, n), float("inf"), device=xyz.device)
    for i in range(1, k):
        diff = pts - pts[rows, last][:, None, :]
        dist = diff[..., 0] * diff[..., 0]
        for c in range(1, d):
            dist = dist + diff[..., c] * diff[..., c]
        min_d = torch.minimum(min_d, dist)
        if i < num_forced:
            last = torch.full((b,), i, dtype=torch.long, device=xyz.device)
        else:
            last = torch.argmax(min_d, dim=1)
        out[:, i] = last
    return out


def fps_cuda(xyz: torch.Tensor, k: int, start: torch.Tensor,
             num_forced: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel, `threads_for(N)` threads a block.  xyz (B, N,
    D) f32 contiguous on the card, start (B,) int32 on the same card -> (B,
    k) int32."""
    if xyz.device.type != "cuda" or start.device != xyz.device:
        raise ValueError("fps_cuda takes CUDA tensors on one device")
    if xyz.dtype != torch.float32 or start.dtype != torch.int32:
        raise TypeError(f"fps_cuda takes f32 points and int32 starts, got "
                        f"{xyz.dtype} and {start.dtype}")
    if not (xyz.is_contiguous() and start.is_contiguous()):
        raise ValueError("fps_cuda takes contiguous tensors")
    b, n, d = xyz.shape
    if start.shape != (b,):
        raise ValueError(f"start must be ({b},), got {tuple(start.shape)}")
    if n > _MAX_POINTS or n * d > _MAX_SMEM_FLOATS:
        raise ValueError(f"fps_cuda holds at most {_MAX_POINTS} points and "
                         f"{_MAX_SMEM_FLOATS} floats per cloud, got N={n}, D={d}")
    out = torch.empty((b, k), dtype=torch.int32, device=xyz.device)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    code = lib.slide_fps(xyz.data_ptr(), start.data_ptr(), out.data_ptr(),
                         b, n, d, k, num_forced, threads_for(n), xyz.device.index, stream)
    _build.check(lib, code, "fps")
    _build.launch_counts["fps"] += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, k: int, start_idx=0,
                          num_forced: int = 0) -> torch.Tensor:
    """Iterative max-min sampling of `k` points from (B, N, D) `xyz`.

    start_idx: int or (B,) ints, the first pick of each row.  Returns (B, k)
    int32 indices.  CPU tensors run `fps_plain`, CUDA tensors the kernel.
    """
    if xyz.ndim != 3:
        raise ValueError(f"xyz must be (B, N, D), got {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if not 1 <= k <= n:
        raise ValueError(f"cannot sample {k} points from {n}")
    start = _start_tensor(start_idx, b, n, xyz.device)
    if xyz.device.type == "cpu":
        return fps_plain(xyz, k, start, num_forced)
    if xyz.device.type == "cuda":
        return fps_cuda(xyz.float().contiguous(), k, start, num_forced)
    raise ValueError(f"no FPS for device {xyz.device}")


def _take(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, xyz.shape[-1]))


def sample_keypoints(xyz: torch.Tensor, k: int, *, add_centroid: bool = True,
                     generator: Optional[torch.Generator] = None,
                     random_subsample: bool = False):
    """Sample `k` keypoints from each cloud (counterpart:
    `slide_tpu/ops/fps.py::sample_keypoints`).

      - add_centroid: prepend the fp32 centroid and run FPS from index 0
        over the N+1 points, so the centroid is always keypoint 0;
      - add_centroid=False: FPS from a random start per cloud (`generator`);
      - random_subsample: one random permutation's first k points, shared by
        the whole batch (`generator`; excludes add_centroid).

    Returns (keypoints (B, k, D), idx (B, k) int32); with add_centroid the
    indices are into the centroid-prepended cloud (0 == centroid)."""
    if xyz.ndim != 3:
        raise ValueError(f"xyz must be (B, N, D), got {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if random_subsample:
        if add_centroid:
            raise ValueError("random_subsample excludes add_centroid")
        if generator is None:
            raise ValueError("random_subsample requires a generator")
        perm = torch.randperm(n, generator=generator, device=generator.device)
        idx = perm[:k].to(device=xyz.device, dtype=torch.int32).expand(b, k)
        return _take(xyz, idx), idx
    if add_centroid:
        full = torch.cat([xyz.float().mean(dim=1, keepdim=True), xyz.float()], dim=1)
        idx = furthest_point_sample(full, k, start_idx=0)
        return _take(full, idx), idx
    if generator is None:
        raise ValueError("add_centroid=False requires a generator for the random start")
    start = batch_randint(n, (b,), generator, dtype=torch.int32).to(xyz.device)
    idx = furthest_point_sample(xyz, k, start_idx=start)
    return _take(xyz, idx), idx


def append_points_to_keypoints(points: torch.Tensor, initial_points: torch.Tensor,
                               k: int, *, only_return_appended: bool = False):
    """Grow a keypoint set to at least `k` points by FPS over
    [initial | points] with the initial points forced as the first picks
    (counterpart: `slide_tpu/ops/fps.py::append_points_to_keypoints`).  If M
    >= k the initial points come back unchanged, with -1 indices."""
    b, m, _ = initial_points.shape
    if m >= k:
        return initial_points, torch.full((b, m), -1, dtype=torch.int32,
                                          device=initial_points.device)
    full = torch.cat([initial_points, points], dim=1)
    idx = furthest_point_sample(full, k, start_idx=0, num_forced=m)
    sampled = _take(full, idx)
    if only_return_appended:
        return sampled[:, m:], idx[:, m:]
    return sampled, idx


def fps_subsample(points: torch.Tensor, k: int, *, start_idx=0) -> torch.Tensor:
    """FPS-downsample (B, N, C) points on their first 3 channels to (B, k, C)
    (counterpart: `slide_tpu/ops/fps.py::fps_subsample`)."""
    idx = furthest_point_sample(points[..., :3], k, start_idx=start_idx)
    return _take(points, idx)
