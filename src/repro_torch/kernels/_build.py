"""Build the port's CUDA kernels on first use and bind them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together), then the objects are linked into ONE shared library
with a plain C interface under ``build/repro_torch/`` at the repository
root. The library's name carries a hash of the sources and flags, so an
edited kernel never loads a stale build. Nothing here runs when a module is
imported: the first kernel launch builds.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu      (one process per source)
    nvcc -shared -o build/repro_torch/librepro_torch-<hash>.so *.o

Each exported function returns ``cudaGetLastError()`` after its launch;
``call`` raises when it is not 0. Never built with ``--use_fast_math``: the
kernels rely on IEEE division and round-half-to-even.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


class _Lib:
    """The loaded library plus what its build reported."""

    def __init__(self):
        self.handle: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.seconds = 0.0
        self.log = ""
        self._fns: Dict[str, ctypes._CFuncPtr] = {}


_LIB = _Lib()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels are built "
                           "from source on the machine with the card")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> _Lib:
    """Compile (if needed) and load the kernel library; idempotent."""
    if _LIB.handle is not None:
        return _LIB
    sources = _sources()
    tag = _digest()
    out = BUILD_DIR / f"librepro_torch-{tag}.so"
    t0 = time.monotonic()
    if not out.exists():
        nvcc = _nvcc()
        objdir = BUILD_DIR / f"obj-{tag}-{os.getpid()}"
        objdir.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in sources:
            obj = objdir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name} (exit {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        _LIB.log = "\n".join(logs)
        if failed:
            raise KernelBuildError(f"nvcc failed on {', '.join(failed)}:\n"
                                   f"{_LIB.log}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"linking {out.name} failed:\n"
                                   f"{link.stdout}")
        os.replace(tmp, out)
        shutil.rmtree(objdir, ignore_errors=True)
        (BUILD_DIR / f"build-{tag}.log").write_text(_LIB.log)
    else:
        log = BUILD_DIR / f"build-{tag}.log"
        _LIB.log = log.read_text() if log.exists() else ""
    _LIB.handle = ctypes.CDLL(str(out))
    _LIB.path = out
    _LIB.seconds = time.monotonic() - t0
    return _LIB


def function(name: str, argtypes: Sequence,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The library's C function ``name`` with explicit ``argtypes``
    (``c_void_p`` for every pointer and the stream, ``c_int`` for ints)."""
    lib = build()
    fn = lib._fns.get(name)
    if fn is None:
        fn = getattr(lib.handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        lib._fns[name] = fn
    return fn


def call(name: str, argtypes: Sequence, *args) -> None:
    """Launch through ``name`` and raise if it returned a CUDA error."""
    err = function(name, argtypes)(*args)
    if err != 0:
        raise KernelLaunchError(f"{name}: CUDA error {err} at launch")
