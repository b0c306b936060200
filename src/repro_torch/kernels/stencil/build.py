"""Build the stencil's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``build/`` at the repository root, on first use, with a plain C
interface that ``ctypes`` loads (no PyTorch headers, so a build takes
seconds).  ``--fmad=false`` keeps every multiply and add separately
rounded, which is what makes the kernels bitwise equal to their plain
PyTorch versions.  The library name carries a hash of the source and
flags, so an edited source is rebuilt and a stale library never loads.

nvcc's output (the ptxas register and shared-memory report) is kept
beside each library as ``<library>.log``.  A failed build raises
``BuildError`` with that output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: src/repro_torch/kernels/stencil/build.py -> repository root
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


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


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that have
    no current library yet, one ``nvcc`` per source, all started
    together.  Returns ``{name: library path}``."""
    srcs = sorted(CSRC.glob("*.cu"))
    if names is not None:
        srcs = [s for s in srcs if s.stem in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = []
    for s in todo:
        tmp = out[s.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for s, tmp, proc in procs:
        log, _ = proc.communicate()
        out[s.stem].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {s.name} exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[s.stem])
    if failed:
        raise BuildError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built first if
    needed), loaded."""
    return ctypes.CDLL(str(build_all([name])[name]))
