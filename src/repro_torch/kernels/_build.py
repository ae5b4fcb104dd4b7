"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled at first use by `nvcc` into a shared
library with a plain C interface and loaded with ctypes. Libraries are kept
in `kernels/build/` (listed in .gitignore), named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs at import time: the CPU tests import every module on a
machine that has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = {"binary_gemm": CSRC / "binary_gemm.cu", "pack": CSRC / "pack.cu",
           "attention": CSRC / "attention.cu"}
HEADERS = [CSRC / "common.cuh"]      # included by every source
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each exported function: pointers and the stream as c_void_p,
# so ctypes never cuts a 64-bit address to an int
SIGNATURES = {
    "binary_gemm": {
        "binary_gemm_packed": [_P, _P, _P, _I, _I, _I, _I, _P],
        "binary_gemm_packed_rhs": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
        "binary_gemm_fused": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "pack": {"pack_bits": [_P, _I, _P, _I, _I, _P]},
    "attention": {
        "decode_attention_packed": [_P, _I, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _F, _P],
        "prefill_attention_packed": [_P, _I, _P, _P, _P, _P, _I, _P, _I, _P,
                                     _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _F, _P],
    },
}


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    log: str          # nvcc's output (-Xptxas -v: registers, shared memory)


_loaded: dict[str, Built] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> tuple[Path, str]:
    out = _target(name)
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return out, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCES[name])], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, log


def _load(name: str, path: Path, log: str) -> Built:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _loaded[name] = Built(lib, path, log)
    return _loaded[name]


def build_all() -> dict[str, Built]:
    """Compile every source at once (one nvcc each, started together) and
    load them all."""
    todo = [n for n in SOURCES if n not in _loaded]
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        results = list(pool.map(_compile, todo))
    for name, (path, log) in zip(todo, results):
        _load(name, path, log)
    return dict(_loaded)


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if need be."""
    if name not in _loaded:
        _load(name, *_compile(name))
    return _loaded[name].lib


def check(name: str, code: int, fn: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError() != 0)."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{fn}: CUDA error {code} ({msg})")
