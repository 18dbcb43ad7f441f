"""Build and bind the Hopper kernels under ``kernels/csrc``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain ``extern "C"`` interface, loaded with
``ctypes``. The build runs at the first CUDA use (never at import, so the
CPU tests import every module), one ``nvcc`` per source, all started
together. Libraries land in ``build/repro_torch_kernels/`` under the
checkout, named by a hash of their source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source or header is rebuilt
and an unchanged one is loaded as it is. A failed build raises
with nvcc's output; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda"
                       "/bin): the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of its text, of every header
    beside it (``*.cuh``, which a source may include) and of the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


@functools.cache
def build_kernels() -> Dict[str, dict]:
    """Compile every stale source in parallel and load every library.

    Returns ``{source stem: {"lib": CDLL, "seconds": build wall time or 0.0
    if it was already built, "ptxas": the compiler's resource report}}``.
    Cached for the process: a library is loaded once.
    """
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src.stem] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp, out)
    logs = {}
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        logs[stem] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"--- nvcc {stem}.cu (exit {proc.returncode}) ---\n"
                          f"{stdout}{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    seconds = time.perf_counter() - t0
    return {src.stem: {"lib": ctypes.CDLL(str(_lib_path(src))),
                       "seconds": seconds if src.stem in procs else 0.0,
                       "ptxas": logs.get(src.stem, "")}
            for src in sources}


@functools.cache
def entry(source: str, symbol: str, n_pointers: int, n_ints: int,
          n_floats: int = 0):
    """The C entry ``symbol`` of ``csrc/<source>.cu``, typed as
    ``int symbol(void* × n_pointers, int × n_ints, float × n_floats,
    void* stream)``. It returns the launch's ``cudaGetLastError()``."""
    fn = getattr(build_kernels()[source]["lib"], symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
