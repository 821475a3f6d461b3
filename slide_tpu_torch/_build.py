"""Builds the port's CUDA kernels with plain `nvcc` and loads them with
`ctypes`.

All sources under `csrc/` (`*.cu`, with the headers `*.cuh` they include)
go into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds).  Each source is
compiled by its own `nvcc`, all started together, then one `nvcc` links:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <object> slide_tpu_torch/csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/slide_tpu_torch/libslide_kernels_<hash>.so <objects>

The library is built at first use into `build/` at the repository root,
named by a hash of the sources, so an edited source is rebuilt and an
unchanged one is loaded as it is.

`launch_counts` counts kernel launches by name: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "slide_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

launch_counts: collections.Counter = collections.Counter()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libslide_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "where the CUDA toolkit is installed")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their stderr, joined.  Raises with it
    when one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(errs)


def build(extra_flags: tuple[str, ...] = ()) -> tuple[Path, float, str]:
    """Compile every source into the hashed library; returns (path, seconds,
    nvcc's stderr).  Raises with nvcc's stderr when the build fails."""
    path = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{path.stem}.{os.getpid()}"
    tmp = path.with_name(f"{stem}.tmp.so")
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources()]
    t0 = time.perf_counter()
    try:
        report = _run_all([[_nvcc(), *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj),
                            str(src)] for src, obj in zip(sources(), objs)])
        report += _run_all([[_nvcc(), *ARCH, "-shared", "-o", str(tmp),
                             *map(str, objs)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)
    return path, seconds, report


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has no build."""
    path = library_path()
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.slide_fps.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.slide_fps.restype = i
    # pc, t4, cls, weights, table, scratch, out, B, device, stream
    lib.slide_fused_denoiser.argtypes = [p, p, p, p, p, p, p, i, i, p]
    lib.slide_fused_denoiser.restype = i
    # pc, t4, cls, g, weights, table, scratch, partial, dpc, dt4, dcls, dflat,
    # B, flat size, device, stream
    lib.slide_fused_denoiser_bwd.argtypes = [p] * 12 + [i, ctypes.c_longlong, i, p]
    lib.slide_fused_denoiser_bwd.restype = i
    lib.slide_fused_table_ints.argtypes = []
    lib.slide_fused_table_ints.restype = i
    lib.slide_error_string.argtypes = [i]
    lib.slide_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.slide_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
