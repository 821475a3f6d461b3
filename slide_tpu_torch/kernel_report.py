"""What the compiler made of the fused denoiser's kernels: per function, the
registers, stack and spills that `ptxas -v` reports, and the counts of the
SASS instructions that bear on the product loop (tensor-core products,
fp32 adds and fused multiply-adds, local-memory loads and stores, shared
loads) from `cuobjdump -sass`.  Needs `nvcc` and `cuobjdump` (the CUDA
toolkit); it builds objects only and launches nothing.

    python -m slide_tpu_torch.kernel_report [--csrc DIR ...] [--out FILE]

Each `--csrc` (default: this package's `csrc/`) is compiled with the
flags of `_build.NVCC_FLAGS`, every source of every tree at once, so two
trees (say a commit and its parent) can be set side by side in one run.
Prints one JSON line per (tree, source, function); `--out` also writes
them there.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from slide_tpu_torch import _build

SOURCES = ("fused_denoiser.cu", "fused_denoiser_bwd.cu")
OPCODES = ("HMMA", "FADD", "FFMA", "FMUL", "LDL", "STL", "LDS", "LDG", "BAR", "SYNCS")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _tool(name: str) -> str:
    found = shutil.which(name) or str(Path(_build._nvcc()).parent / name)
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found: the report needs the CUDA toolkit")
    return found


def _demangle(names: list[str]) -> dict:
    if not names:
        return {}
    proc = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True,
                          text=True, check=True)
    return dict(zip(names, proc.stdout.splitlines()))


def _ptxas(report: str) -> dict:
    """{mangled name: {regs, stack, spill_stores, spill_loads}} from -Xptxas -v."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Function properties for|Compiling entry function) '?([\w$]+)'?",
                      line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _STACK.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["regs"] = int(m.group(1))
    return out


def _sass(obj: Path) -> dict:
    return _count_sass(subprocess.run([_tool("cuobjdump"), "-sass", str(obj)],
                                      capture_output=True, text=True, check=True).stdout)


def _count_sass(text: str) -> dict:
    """{mangled name: Counter of OPCODES (and 'total')} from cuobjdump -sass."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : ([\w$]+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSTR.search(line) if cur is not None else None
        if m:
            cur["total"] += 1
            if m.group(1) in OPCODES:
                cur[m.group(1)] += 1
    return out


def _compile(csrc: Path, work: Path) -> dict:
    """Start nvcc -Xptxas -v on each source of SOURCES in `csrc`, objects
    into `work`: {source: (object, process)}."""
    return {src: (work / (src + ".o"), subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(work / (src + ".o")), str(csrc / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for src in SOURCES}


def _rows(csrc: Path, procs: dict) -> list[dict]:
    """The compiler's figures per function of each started compile."""
    rows = []
    for src, (obj, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {csrc / src}:\n{log}")
        stats, sass = _ptxas(log), _sass(obj)
        names = sorted(set(stats) | set(sass))
        readable = _demangle(names)
        for name in names:
            counts = sass.get(name, collections.Counter())
            rows.append({"tree": str(csrc), "source": src, "function": readable.get(name, name),
                         **stats.get(name, {}),
                         "sass": {k: counts[k] for k in ("total", *OPCODES)}})
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", type=Path,
                    help="a csrc/ directory to compile (repeatable)")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args()
    trees = args.csrc or [_build.CSRC]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        started = []
        for i, csrc in enumerate(trees):
            work = Path(tmp) / str(i)
            work.mkdir()
            started.append((csrc.resolve(), _compile(csrc.resolve(), work)))
        rows = [r for csrc, procs in started for r in _rows(csrc, procs)]
    lines = [json.dumps(r) for r in rows]
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
