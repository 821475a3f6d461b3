"""Builds the port's CUDA kernels with one plain `nvcc` call and loads them
with `ctypes`.

All sources under `csrc/` go into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/slide_tpu_torch/libslide_kernels_<hash>.so \
         slide_tpu_torch/csrc/*.cu

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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


def build(extra_flags: tuple[str, ...] = ()) -> tuple[Path, float, str]:
    """Compile every source into the hashed library; returns (path, seconds,
    nvcc's stderr).  Raises with nvcc's stderr when the build fails."""
    path = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           *map(str, sources())]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {r.returncode}:\n"
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, path)
    return path, seconds, r.stderr


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
    lib.slide_error_string.argtypes = [i]
    lib.slide_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.slide_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
