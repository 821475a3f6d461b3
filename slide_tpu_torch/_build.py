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

The host's C++ (`native/*.cpp`, the marching tetrahedra) is built the same
way with `g++` at first use (`load_host_library`), into the same directory:

    g++ -O3 -shared -fPIC -std=c++17 -fopenmp -o \
        build/slide_tpu_torch/lib<name>_<hash>.so slide_tpu_torch/native/<name>.cpp

A failed build raises with the compiler's stderr.

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
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parent / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "slide_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

launch_counts: collections.Counter = collections.Counter()
# serialises the host libraries' first build and load across threads
_host_lock = threading.Lock()


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
    lib.slide_fps.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.slide_fps.restype = i
    # pc, t4, cls, weights, table, scratch, out, B, shared memory bytes,
    # device, stream
    lib.slide_fused_denoiser.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.slide_fused_denoiser.restype = i
    # pc, t4, cls, g, [weights, transposed weights], table, table2, scratch,
    # jobs, tiles, tiles' count, depth parts, parts' sums, dpc, dt4, dcls,
    # dflat, B, flat size, blocks per cloud, blocks per SM, shared memory
    # bytes, tape floats per cloud, t4 / cls / cotangent floats per cloud,
    # device, stream
    lib.slide_fused_denoiser_bwd.argtypes = ([p] * 10 + [i, i, p] + [p] * 4 + [i] * 5
                                             + [ctypes.c_longlong, i, i, i, i, p])
    lib.slide_fused_denoiser_bwd.restype = i
    # shared memory bytes, blocks per cloud, blocks per SM, device, out:
    # K2's clusters the card holds at once
    lib.slide_fused_bwd_max_clusters.argtypes = [i, i, i, i, p]
    lib.slide_fused_bwd_max_clusters.restype = i
    lib.slide_fused_table2_ints.argtypes = []
    lib.slide_fused_table2_ints.restype = i
    # shared memory bytes, blocks per SM, device, out: clusters the card
    # holds at once
    lib.slide_fused_max_clusters.argtypes = [i, i, i, p]
    lib.slide_fused_max_clusters.restype = i
    lib.slide_fused_table_ints.argtypes = []
    lib.slide_fused_table_ints.restype = i
    lib.slide_error_string.argtypes = [i]
    lib.slide_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.slide_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def host_library_path(name: str) -> Path:
    src = NATIVE / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@functools.cache
def load_host_library(name: str) -> ctypes.CDLL:
    """`native/<name>.cpp` built with g++ (at first use of this source) and
    loaded.  Raises with the compiler's stderr when the build fails.  Threads
    that ask at once wait for one build; processes each build into a file of
    their own and move it into place, so none loads a half-written one."""
    with _host_lock:
        path = host_library_path(name)
        if not path.exists():
            _build_host_library(name, path)
        return ctypes.CDLL(str(path))


def _build_host_library(name: str, path: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host's C++ cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{path.stem}.", suffix=".tmp.so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(NATIVE / f"{name}.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed with code {proc.returncode} building "
                           f"native/{name}.cpp:\n{proc.stderr}")
    os.replace(tmp, path)
