"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` into an object file, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/`` at the repository root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once. Nothing is built at import time: the first wrapper call
on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("memo_attention.cu", "nn_search.cu", "flash_attention.cu",
           "rwkv6.cu", "graph_cond.cu")
HEADERS = ("attention_tile.cuh", "attention_wgmma.cuh")   # included by sources: hashed too
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_P64 = ctypes.POINTER(ctypes.c_int64)
# C signatures: every pointer and the stream as c_void_p (a bare int
# would be cut to 32 bits), every entry point returns cudaGetLastError()
SIGNATURES = {
    "memo_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _P],
    "nn_search_f32": [_P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _P],
    "nn_search_resources": [_P],
    "memo_attention_resources": [_I, _I, _P],
    "flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P64,
                            _I, _I, _I, _F, _P],
    "flash_attention_resources": [_I, _P],
    "wkv6_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "wkv6_resources": [_I, _P],
    "graph_cond_build": [_P, _I, _I, _P, _P, _P],
    "graph_cond_launch": [_P, _P],
    "graph_cond_destroy": [_P, _P],
}


class _State:
    lib = None
    path = None
    log = ""
    seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ on the machine with the card")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if the sources changed) and return the library path."""
    digest = _digest()
    lib_path = BUILD_DIR / f"repro_torch_kernels_{digest}.so"
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{digest}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        obj = obj_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f".{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *[str(obj) for _, obj, _ in procs], "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    _State.log = "\n".join(logs)
    _State.seconds = time.perf_counter() - t0
    (BUILD_DIR / f"repro_torch_kernels_{digest}.log").write_text(_State.log)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    if _State.lib is None:
        path = build()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _State.lib, _State.path = lib, path
    return _State.lib


def build_info() -> dict:
    """Path, build seconds of this process (0 when the library was
    already built) and the compiler's resource report (``-Xptxas -v``,
    kept beside the library)."""
    library()
    log = _State.log or _State.path.with_suffix(".log").read_text()
    return {"path": str(_State.path), "seconds": _State.seconds,
            "log": log}


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        msg = library().kernels_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} {msg}")
