"""ctypes binding of the host box ops (boxops.cpp; counterpart of
diffmining_tpu/native/boxops.py).

The shared object is built at first use with the host C++ compiler (``CXX``,
else ``g++``) into ``build/native/`` beside the package, keyed by the hash of
the source and the flags, so importing this module needs no compiler. A
failed build raises and names the compiler; nothing falls back."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "boxops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler: boxops.cpp is built with g++ (or $CXX) at first use")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libboxops-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile boxops.cpp unless it is built; return the library's path."""
    out = library_path()
    if out.is_file():
        return out
    cxx = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p64, pf = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
            lib.non_overlap_suppress.restype = ctypes.c_int64
            lib.non_overlap_suppress.argtypes = [p64, pf, ctypes.c_int64, ctypes.c_int64, p64]
            _lib = lib
        return _lib


def non_overlap_suppress(boxes: np.ndarray, scores: np.ndarray, k: int) -> np.ndarray:
    """Greedy suppression in C++: boxes [M, 4] int64 (x_start, y_start,
    x_end, y_end), scores [M] (as float32, descending, ties in input order)
    -> int64 indices of at most k mutually non-overlapping boxes."""
    lib = _load()
    boxes = np.ascontiguousarray(boxes, dtype=np.int64)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    out = np.empty(max(int(k), 0), dtype=np.int64)
    n = lib.non_overlap_suppress(
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(boxes), max(int(k), 0), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out[:n]
