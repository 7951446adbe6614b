"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/kernels/<name>-<hash>.so`` at the repository root (a
directory git ignores), at first use.  The hash covers the source and the
flags, so an edited source is rebuilt.  :func:`build_all` starts one nvcc
per source, all at once, and waits for every one of them.

:func:`entry` binds one C function of a library; :func:`launch` calls it
on the current stream, raises on the CUDA error it returns and counts the
launch in ``repro_torch.kernels.LAUNCHES``: the one place every kernel
wrapper launches through.

Nothing here runs at import time: this module imports on a machine with
no CUDA toolkit, and only a call that needs a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import LAUNCHES

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[Tuple[str, ...], ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def _flags(defines: Sequence[str] = ()) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def target(name: str, defines: Sequence[str] = ()) -> Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(defines))
                            .encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None,
              defines: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every missing kernel library, one nvcc per source, all
    started together.  ``defines`` (``-D`` macros) build a source's
    variant into a library of its own: the package builds none; the
    step-by-step timings and card tests that hold one design step
    against the kernel without it do.  Returns {name: nvcc/ptxas
    report}; raises :class:`KernelBuildError` naming every source that
    failed."""
    names = list(sources()) if names is None else list(names)
    todo = {n: target(n, defines) for n in names
            if not target(n, defines).exists()}
    reports = {n: "(cached) " + str(target(n, defines)) for n in names
               if n not in todo}
    if not todo:
        return reports
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *_flags(defines), "-o", str(tmp), str(sources()[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])     # atomic: concurrent builders agree
    if failed:
        raise KernelBuildError("\n".join(failed))
    return reports


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (with ``defines``: that
    variant's), built first if needed."""
    key = (name, *defines)
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            build_all([name], defines)
            lib = _LIBS[key] = ctypes.CDLL(str(target(name, defines)))
        return lib


def entry(name: str, symbol: str, argtypes: Sequence,
          restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built and loaded
    at first use) with its argument and result types set; a launching
    function returns a CUDA error code, 0 when its kernels were
    launched."""
    key = (name, symbol)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _ENTRIES[key] = fn
    return fn


def launch(op: str, fn: ctypes._CFuncPtr, device: torch.device, *args
           ) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream, raise if
    it reports a CUDA error, and count one launch of ``op``.  The stream
    is read as its raw handle: a ``torch.cuda.Stream`` object costs the
    host microseconds a launch, which loops of short kernels pay."""
    index = device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc}")
    with _COUNT_LOCK:      # shard jobs launch from several threads
        LAUNCHES[op] += 1
