"""Build the port's CUDA sources into shared libraries and load them.

Every ``kernels/*/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/`` at the repository root, on first use, with
a plain C interface that ``ctypes`` loads (no PyTorch headers, so a
build takes seconds).  ``--fmad=false`` keeps every multiply and add
separately rounded, which is what makes the stencil kernels bitwise
equal to their plain PyTorch versions; a kernel that wants a fused
multiply-add writes ``fmaf`` itself.  The library name carries a hash
of the source and flags, so an edited source is rebuilt and a stale
library never loads.  Source stems are unique across the kernels, so a
library is named by its stem alone.

nvcc's output (the ptxas register and shared-memory report) is kept
beside each library as ``<library>.log``.  ``MAX_SMEM_BYTES`` is the
shared memory one CTA may take on that architecture.  A failed build raises
``BuildError`` with that output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS = Path(__file__).resolve().parent
#: src/repro_torch/kernels/build.py -> repository root
BUILD_DIR = KERNELS.parents[2] / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
#: shared memory one CTA may use on the architecture the sources are
#: built for (sm_90: 227 KB, static and dynamic together, with the
#: opt-in attribute the launches set); every wrapper's check and the
#: stencil tuner's filter read this one value
MAX_SMEM_BYTES = 232448


class BuildError(RuntimeError):
    """nvcc failed or is missing; the message holds its output."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cuda.exists():
        return str(cuda)
    raise BuildError("nvcc not found on PATH or under CUDA_HOME")


def sources() -> dict[str, Path]:
    """``{stem: path}`` of every ``kernels/*/csrc/*.cu``."""
    out: dict[str, Path] = {}
    for src in sorted(KERNELS.glob("*/csrc/*.cu")):
        if src.stem in out:
            raise BuildError(f"two CUDA sources named {src.stem}: "
                             f"{out[src.stem]} and {src}")
        out[src.stem] = src
    return out


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all of them) that have no
    current library yet, one ``nvcc`` per source, all started together.
    Returns ``{name: library path}``."""
    srcs = sources()
    if names is not None:
        missing = sorted(set(names) - set(srcs))
        if missing:
            raise BuildError(f"no CUDA source named {missing}")
        srcs = {n: srcs[n] for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _target(s) for n, s in srcs.items()}
    todo = [n for n in srcs if not out[n].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = []
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {srcs[n].name} exited "
                          f"{proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise BuildError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The library built from ``kernels/*/csrc/<name>.cu`` (built first
    if needed), loaded."""
    return ctypes.CDLL(str(build_all([name])[name]))
