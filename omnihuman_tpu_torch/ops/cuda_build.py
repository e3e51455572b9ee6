"""Build the port's hand-written CUDA kernels and bind them through ctypes.

Every `*.cu` under `omnihuman_tpu_torch/csrc/` exposes a plain C interface
(device helpers they share live in `csrc/*.cuh`). It is compiled with nvcc
for Hopper (`sm_90a`) into a shared library at first use, under
`omnihuman_tpu_torch/_build/` (git-ignored), and loaded with ctypes.
Library names carry a hash of the source, the shared headers and the
flags, so an edited source is rebuilt and a stale build is never loaded.

Nothing here runs at import: a machine without nvcc or a GPU (the CPU test
suite) imports this module and never builds anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# one build, load and count at a time: the virtual ranks of
# parallel/spatial.py launch kernels from several threads
_LOCK = threading.RLock()


def find_nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def library_path(source: str) -> str:
    """The library's path: its name hashes the source, every shared header
    under csrc/ (`*.cuh`) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _start_build(source: str) -> Optional[subprocess.Popen]:
    so = library_path(source)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(sources: Iterable[str]) -> List[str]:
    """Compile every source not built yet, one nvcc each, all in parallel.
    Returns the library paths; the compiler's output (registers, spills,
    shared memory per kernel) is kept beside each library as `.log`."""
    sources = list(sources)
    procs = {s: _start_build(s) for s in sources}
    errors = []
    for s, p in procs.items():
        if p is None:
            continue
        out, _ = p.communicate()
        so = library_path(s)
        tmp = f"{so}.{os.getpid()}.tmp"
        if p.returncode != 0:
            errors.append(f"nvcc {s} failed ({p.returncode}):\n{out}")
            continue
        with open(so + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(s) for s in sources]


def load(source: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(build([source])[0])
            lib.omni_cuda_error_string.argtypes = [ctypes.c_int]
            lib.omni_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[source] = lib
    return lib


def build_log(source: str) -> str:
    with open(library_path(source) + ".log") as f:
        return f.read()


class CudaKernel:
    """One C entry point of a library in csrc/, with its launch count.

    `launches` goes up by one each time `launch` starts the kernel and
    nowhere else, so a run can show that a path went through the kernel.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _entry(self):
        with _LOCK:
            if self._fn is None:
                fn = getattr(load(self.source), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self._entry()(*args)
        if err != 0:
            msg = load(self.source).omni_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{err} ({msg})")
        with _LOCK:
            self.launches += 1
