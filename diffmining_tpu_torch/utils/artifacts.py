"""Artifact-store helpers: atomic writes for the filesystem work queue
(counterpart of diffmining_tpu/utils/artifacts.py).

Every store write goes through temp file + rename, so `exists` implies a
complete file even if a worker is killed mid-write.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable

import numpy as np


def _atomic_write(path: str, write: Callable) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def atomic_save_npy(path: str, arr: np.ndarray) -> None:
    _atomic_write(path, lambda f: np.save(f, arr))


def atomic_save_pickle(path: str, obj: Any) -> None:
    _atomic_write(path, lambda f: pickle.dump(obj, f))


def atomic_save_npz(path: str, **arrays: np.ndarray) -> None:
    _atomic_write(path, lambda f: np.savez(f, **arrays))
