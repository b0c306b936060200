"""Checkpointing: async, atomic, integrity-checked — the JAX package's
``checkpoint/manager.py`` for tensors.

This is the paper's Fig.1 step 2 ("save current state") and steps 5-7
(move + assimilate + restart).  The on-disk layout is the JAX
package's, so a checkpoint written by either package restores in the
other:

Layout: <dir>/step_<n>/
          manifest.json        {step, leaf paths, shapes, dtypes, crcs,
                                extra}
          <leaf_key>.npy       one array per leaf
Leaves are the tensors or arrays of a nested dict / list / tuple, keyed
by their path as the JAX package keys pytree paths.  Writes go to
step_<n>.tmp and are atomically swapped in (the previous generation is
renamed aside to step_<n>.old for the instant of the swap); a torn
write is never visible, and a crash mid-save can never leave a
truncated latest checkpoint shadowing a good older one (DESIGN.md
§19).  Async mode pushes the host-side serialization to a daemon
thread (off the training critical path); save(wait=True) or close()
joins it.

Integrity (DESIGN.md §19): every leaf is stamped with a CRC-32 of its
serialized bytes at save time.  ``restore()`` verifies before trusting:
a generation whose bytes do not match its manifest is treated as
corrupt, and the default restore falls back to the newest *intact*
generation (``keep`` is floored to 2 so a fallback always has a
candidate).  When no generation verifies, ``NoIntactCheckpointError``
names every step tried.

A SIGTERM handler can be installed for preemption-triggered snapshots
(install_preemption_hook): save, then exit cleanly so the restart path
resumes bit-consistently from the snapshot.
"""
from __future__ import annotations

import io
import json
import os
import queue
import shutil
import signal
import threading
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

_SEP = "__"


class NoIntactCheckpointError(RuntimeError):
    """Every on-disk checkpoint generation failed integrity
    verification (or none exists) — there is nothing safe to restore
    (DESIGN.md §19)."""


def _flatten(tree, prefix: tuple = ()) -> dict[str, Any]:
    """Leaves of a nested dict / list / tuple keyed as the JAX package
    keys its pytree paths: dict keys in sorted order, sequence indices,
    joined by ``__`` (``root`` for a bare leaf); ``None`` holds no
    leaf."""
    out: dict[str, Any] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        out[_SEP.join(prefix) or "root"] = tree
        return out
    for key, sub in items:
        out.update(_flatten(sub, prefix + (key,)))
    return out


def _unflatten(target, values: dict[str, Any], prefix: tuple = ()):
    """Rebuild ``target``'s structure with the leaves from ``values``."""
    if target is None:
        return None
    if isinstance(target, dict):
        return {k: _unflatten(target[k], values, prefix + (str(k),))
                for k in target}
    if isinstance(target, (list, tuple)):
        seq = [_unflatten(v, values, prefix + (str(i),))
               for i, v in enumerate(target)]
        return type(target)(seq) if isinstance(target, tuple) else seq
    return values[_SEP.join(prefix) or "root"]


#: tensor dtypes numpy lacks, by the names the JAX package (ml_dtypes)
#: gives them; such a leaf is stored as its raw bytes, ``uint{8·itemsize}``,
#: with the true name in the manifest, as the JAX package stores it
_RAW_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_RAW_NAMES = {dt: name for name, dt in _RAW_DTYPES.items()}
#: signed views of the same widths: torch's unsigned types are partial
_INT_OF_SIZE = {1: torch.int8, 2: torch.int16}


def _to_host(leaf, copy: bool = False) -> tuple[np.ndarray, str]:
    """(array to store, true dtype name for the manifest); with ``copy``
    a leaf already on the host is copied too, so that a later in-place
    step (a donated train step) cannot reach what is stored."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if copy and t.data_ptr() == leaf.data_ptr():
            t = t.clone()
        name = _RAW_NAMES.get(t.dtype)
        if name is None:
            arr = t.numpy()
            return arr, str(arr.dtype)
        size = t.element_size()
        raw = t.view(_INT_OF_SIZE[size]).numpy()
        return raw.view(np.dtype(f"u{size}")), name
    arr = np.array(leaf) if copy else np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, key: str) -> torch.Tensor:
    """The tensor of a stored leaf whose manifest names ``dtype``."""
    if str(arr.dtype) == dtype:
        return torch.from_numpy(arr)
    tdt = _RAW_DTYPES.get(dtype)
    if tdt is None or arr.dtype.kind != "u" \
            or arr.dtype.itemsize != tdt.itemsize:
        raise TypeError(
            f"leaf {key} is stored as {dtype}, which "
            f"has no numpy dtype here")
    signed = arr.view(np.dtype(f"i{arr.dtype.itemsize}"))
    return torch.from_numpy(signed).view(tdt)


def _world_size() -> int:
    """The ranks of the running process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


#: threads that write or verify a generation's leaves side by side
_IO_THREADS = 8


class _CrcWriter:
    """A file that keeps the CRC-32 of the bytes written to it."""

    def __init__(self, f):
        self.f, self.crc = f, 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        return self.f.write(b)


def _save_leaf(path: Path, leaf) -> tuple[list, str, int]:
    """``np.save`` of a leaf (a tensor, an array, or ``_to_host``'s
    pair) at ``path``: its shape, true dtype name and the CRC-32 of the
    file's bytes, taken as they are written."""
    arr, dtype = leaf if isinstance(leaf, tuple) else _to_host(leaf)
    with open(path, "wb") as f:
        w = _CrcWriter(f)
        np.save(w, arr, allow_pickle=False)
    return list(arr.shape), dtype, w.crc


def _read_file(path: Path) -> bytearray:
    """A file's bytes, read into one writable buffer."""
    buf = bytearray(path.stat().st_size)
    view = memoryview(buf)
    with open(path, "rb", buffering=0) as f:
        n = 0
        while n < len(buf):
            got = f.readinto(view[n:])
            if not got:
                raise OSError(f"{path} ended after {n} of {len(buf)} bytes")
            n += got
    return buf


#: bytes that hold an ``.npy`` header (numpy writes ~128)
_NPY_HEAD = 1 << 16


def _npy_array(buf: bytearray) -> np.ndarray:
    """The array of an ``.npy`` file's bytes, a view of ``buf`` (no
    copy); no object arrays."""
    head = io.BytesIO(bytes(buf[:_NPY_HEAD]))
    version = np.lib.format.read_magic(head)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(head)
    if dtype.hasobject:
        raise ValueError("a leaf holds Python objects")
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(buf, dtype=dtype, count=count, offset=head.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, *, async_save: bool = True,
                 keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        # at least 2 generations: a corrupt latest must always leave an
        # older candidate for the integrity fallback (DESIGN.md §19)
        self.keep = max(keep, 2)
        self.async_save = async_save
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._pending = 0
        self._lock = threading.Lock()
        if async_save:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------ save

    def save(self, step: int, state, extra: dict | None = None,
             wait: bool = False):
        """Snapshot `state` (nested dict/list/tuple of tensors or
        arrays, whole: a DTensor state is gathered by the caller, on
        every rank) at `step`.

        In async mode every leaf is copied to the host here (cheap vs
        serialization; a leaf on the host is copied too, since a donated
        train step writes the state in place after ``save`` returns) and
        the file I/O happens on the worker thread;
        a synchronous save copies each leaf in the thread that writes
        it, side by side with the others.  Under a process group of more than one rank only rank 0
        writes, synchronously, and every rank leaves after a barrier, so
        the generation is complete wherever a rank restores it next.
        """
        ranks = _world_size()
        if ranks > 1 and dist.get_rank() != 0:
            dist.barrier()
            return
        leaves = _flatten(state)
        if self.async_save and not wait and ranks == 1:
            # copies, the host's leaves too: the caller may step (in
            # place) before the worker writes them
            host = {k: _to_host(v, copy=True) for k, v in leaves.items()}
            with self._lock:
                self._pending += 1
            self._q.put((step, host, dict(extra or {})))
        else:
            # a sync save may target the same step as a queued async one
            # (periodic + final save); drain the worker first so both
            # never race on the same step_*.tmp staging dir.  Each leaf
            # is copied to the host by the thread that writes it
            self.wait()
            self._write((step, leaves, dict(extra or {})))
        if ranks > 1:
            dist.barrier()

    def wait(self):
        if self.async_save:
            self._q.join()

    def close(self):
        self.wait()

    def _run(self):
        while True:
            job = self._q.get()
            try:
                self._write(job)
            finally:
                with self._lock:
                    self._pending -= 1
                self._q.task_done()

    def _write(self, job):
        step, leaves, extra = job
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        # one leaf a thread: copies, file writes and zlib let go of the GIL
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            saved = pool.map(lambda kv: _save_leaf(tmp / f"{kv[0]}.npy",
                                                   kv[1]), leaves.items())
            for key, (shape, dtype, crc) in zip(leaves, saved):
                manifest["leaves"][key] = {
                    "file": f"{key}.npy",
                    "shape": shape,
                    "dtype": dtype,
                    # content checksum of the serialized bytes — what
                    # restore() verifies before trusting this generation
                    "crc32": crc,
                }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        # atomic swap: never rmtree the live generation before the new
        # one is in place — a crash between those two operations would
        # otherwise lose BOTH (DESIGN.md §19).  Rename the old aside,
        # move the new in (os.replace is atomic on one filesystem),
        # then drop the old.
        old = self.dir / f"step_{step:08d}.old"
        if old.exists():
            shutil.rmtree(old)
        if final.exists():
            os.replace(final, old)
        os.replace(tmp, final)
        if old.exists():
            shutil.rmtree(old)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix in (".tmp", ".old") \
                    or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> bool:
        """True iff the generation at ``step`` passes integrity
        verification: readable manifest and every leaf's bytes matching
        its stamped CRC-32 (DESIGN.md §19).  Legacy manifests without
        checksums are trusted (there is nothing to verify against)."""
        return self._read_intact(step, keep=False) is not None

    def _read_intact(self, step: int, keep: bool = True):
        """``(manifest, {leaf key: file bytearray})`` of the generation at
        ``step``, each file read once (side by side; without ``keep``
        the bytes are dropped as they are checked), or ``None`` when the
        manifest is unreadable or a leaf's bytes miss their CRC-32."""
        d = self.dir / f"step_{step:08d}"

        def read(meta):
            b = _read_file(d / meta["file"])
            crc = meta.get("crc32")
            if crc is not None and zlib.crc32(b) != crc:
                return None
            return b if keep else True

        try:
            manifest = json.loads((d / "manifest.json").read_text())
            metas = manifest["leaves"]
            with ThreadPoolExecutor(_IO_THREADS) as pool:
                data = dict(zip(metas, pool.map(read, metas.values())))
        except (OSError, ValueError, KeyError):
            return None
        if any(b is None for b in data.values()):
            return None
        return manifest, data

    def restore(self, target_state, step: int | None = None,
                shardings=None) -> tuple[Any, dict]:
        """Load into the structure of `target_state` (nested dict/list/
        tuple; only its keys matter).  Without `shardings` the leaves
        come back as CPU tensors.  `shardings` (a tree of
        ``sharding/rules.py::Sharding`` of the same structure, as
        ``runtime/train_step.py::state_shardings`` gives it) puts each
        leaf onto the *current* mesh as a DTensor at its placements, on
        the mesh's device — restoring under a different mesh than the
        save is the supported path (that is the burst).  A leaf the tree
        has no sharding for (``None``, or absent) comes back as without
        `shardings`, a CPU tensor, as the JAX package's restore gives
        such a leaf as a plain array.  Every rank
        reads the files and ``distribute_tensor``s each leaf in turn, so
        the ranks agree whichever rank a torch version takes the data
        from.  The files are read once: their bytes are verified and
        loaded from memory.

        With ``step=None`` (the default), generations are verified
        newest-first and the newest *intact* one is restored — a
        corrupt latest falls back with a warning instead of silently
        resuming from garbage (DESIGN.md §19).  An explicit ``step``
        that fails verification raises instead: the caller asked for
        that generation specifically.
        """
        if step is None:
            steps = self.all_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            got = None
            for s in reversed(steps):
                got = self._read_intact(s)
                if got is not None:
                    step = s
                    break
                warnings.warn(
                    f"checkpoint step {s} failed integrity verification;"
                    f" falling back to an older generation",
                    stacklevel=2,
                )
            if got is None:
                raise NoIntactCheckpointError(
                    f"no intact checkpoint in {self.dir}: every "
                    f"generation failed integrity verification "
                    f"(steps tried: {steps})"
                )
        else:
            got = self._read_intact(step)
            if got is None:
                raise NoIntactCheckpointError(
                    f"checkpoint step {step} in {self.dir} failed "
                    f"integrity verification"
                )
        manifest, data = got
        flat_target = _flatten(target_state)
        flat_shardings = _flatten(shardings) if shardings is not None \
            else {}
        out = {}
        for key in [k for k in manifest["leaves"] if k in flat_target]:
            arr = _npy_array(data.pop(key))
            out[key] = _from_host(arr, manifest["leaves"][key]["dtype"], key)
            sh = flat_shardings.get(key)
            if sh is not None:
                out[key] = distribute_tensor(
                    out[key].to(sh.mesh.device_type), sh.mesh, sh.placements)
        missing = set(flat_target) - set(out)
        if missing:
            raise KeyError(f"checkpoint at step {step} missing leaves: "
                           f"{sorted(missing)[:5]}...")
        return _unflatten(target_state, out), manifest["extra"]


def install_preemption_hook(save_fn: Callable[[], None], *,
                            exit_code: int | None = 143):
    """SIGTERM -> snapshot -> clean exit (DESIGN.md §19).

    The platform is reclaiming us: ``save_fn`` persists the snapshot,
    then the process exits with ``exit_code`` (default 143 = 128 +
    SIGTERM, the conventional "terminated" status) so the supervisor's
    restart path restores from it and resumes bit-consistently.  Pass
    ``exit_code=None`` to chain to Python's default KeyboardInterrupt
    behavior instead of exiting.  Returns the previous SIGTERM handler
    so callers (and tests) can restore it.
    """

    def handler(signum, frame):
        try:
            save_fn()
        finally:
            if exit_code is None:
                signal.default_int_handler(signum, frame)
            else:
                raise SystemExit(exit_code)

    return signal.signal(signal.SIGTERM, handler)
