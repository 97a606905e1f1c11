"""ctypes bindings for the native data-loader core (`loader_core.cpp`).

The port's own copy of the JAX package's `native` module. The shared
library is built by g++ at first use, never at import, into
`build/omni_pq_torch/` of the checkout that holds the package (listed in
`.gitignore`), named by the hash of its source and flags, so an edited
source is rebuilt. A failed build raises with the compiler's message: there
is no silent numpy fallback. `compute_votes_plain` and `gather_rows_plain`
are the numpy versions with the same results, which the tests hold the
library against. ctypes calls release the GIL, which is what gives the
threaded PrefetchLoader real host parallelism.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "loader_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "omni_pq_torch"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int64)
_ARGTYPES = {
    "morton_argsort": [_F, ctypes.c_int64, ctypes.c_int64, _I],
    "compute_votes": [_F, _I, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                      _F, ctypes.c_int64, _F, _F, _I],
    "gather_rows": [_F, ctypes.c_int64, ctypes.c_int64, _I, ctypes.c_int64,
                    _F],
    "estimate_normals": [_F, ctypes.c_int64, ctypes.c_int64, _F, _F],
}
_lock = threading.Lock()
_lib = None


def _target() -> Path:
    digest = hashlib.sha1(SRC.read_bytes()
                          + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"loader_core-{digest[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if g++ fails."""
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(
                        f"native loader core build failed (g++ exit "
                        f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, target)  # atomic: concurrent builders agree
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _ARGTYPES.items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = None
            _lib = lib
        return _lib


def _fptr(a):
    return a.ctypes.data_as(_F)


def _iptr(a):
    return a.ctypes.data_as(_I)


def morton_argsort(points: np.ndarray) -> np.ndarray:
    """(N, >=3) float points -> Morton-order permutation (the stable order
    of data/spatial.py's codes, computed in float32)."""
    pts = np.ascontiguousarray(points[:, :3], dtype=np.float32)
    out = np.empty(len(pts), dtype=np.int64)
    get_lib().morton_argsort(_fptr(pts), len(pts), 3, _iptr(out))
    return out


def compute_votes(pc: np.ndarray, instance: np.ndarray,
                  sem_in_care: np.ndarray, gt_centers: np.ndarray):
    """Per-point votes from instance membership: (votes (N,3), mask (N,),
    point_instance (N,)). An instance whose first point's class is cared
    for votes to the centre of its points' box, labelled with the nearest
    of `gt_centers`."""
    n = len(pc)
    if len(instance) != n or len(sem_in_care) != n:
        raise ValueError(f"compute_votes: {n} points, {len(instance)} "
                         f"instance and {len(sem_in_care)} class labels")
    pcf = np.ascontiguousarray(pc[:, :3], dtype=np.float32)
    inst = np.ascontiguousarray(instance, dtype=np.int64)
    care = np.ascontiguousarray(sem_in_care, dtype=np.uint8)
    gtc = np.ascontiguousarray(gt_centers, dtype=np.float32)
    votes = np.empty((n, 3), np.float32)
    mask = np.empty(n, np.float32)
    pinst = np.empty(n, np.int64)
    get_lib().compute_votes(_fptr(pcf), _iptr(inst),
                            care.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            n, _fptr(gtc), len(gtc), _fptr(votes), _fptr(mask),
                            _iptr(pinst))
    return votes, mask, pinst


def compute_votes_plain(pc: np.ndarray, instance: np.ndarray,
                        sem_in_care: np.ndarray, gt_centers: np.ndarray):
    """compute_votes in numpy (the JAX package's fallback)."""
    n = len(pc)
    votes = np.zeros((n, 3), np.float32)
    mask = np.zeros(n, np.float32)
    pinst = np.zeros(n, np.int64) - 1
    for g in np.unique(instance):
        if g < 0:
            continue
        idx = np.where(instance == g)[0]
        if not sem_in_care[idx[0]]:
            continue
        x = pc[idx]
        center = 0.5 * (x.min(0) + x.max(0))
        ilabel = np.argmin(((center - gt_centers) ** 2).sum(-1))
        votes[idx] = center - x
        mask[idx] = 1.0
        pinst[idx] = ilabel
    return votes, mask, pinst


def gather_rows(src: np.ndarray, choices: np.ndarray) -> np.ndarray:
    """src[choices] for a (n, c) float32 table."""
    s = np.ascontiguousarray(src, dtype=np.float32)
    ch = np.ascontiguousarray(choices, dtype=np.int64)
    if len(ch) and (ch.min() < 0 or ch.max() >= len(s)):
        raise IndexError(f"gather_rows: choices outside [0, {len(s)})")
    out = np.empty((len(ch), s.shape[1]), np.float32)
    get_lib().gather_rows(_fptr(s), s.shape[0], s.shape[1], _iptr(ch),
                          len(ch), _fptr(out))
    return out


def gather_rows_plain(src: np.ndarray, choices: np.ndarray) -> np.ndarray:
    return src[choices]


def estimate_normals_native(points: np.ndarray, k: int,
                            viewpoint: np.ndarray) -> np.ndarray:
    """Exact k-NN PCA normals (grid hash + 3x3 Jacobi), flipped so that
    dot(p - viewpoint, n) >= 0."""
    if k < 1:
        raise ValueError(f"estimate_normals_native: k = {k}")
    pts = np.ascontiguousarray(points[:, :3], dtype=np.float32)
    vp = np.ascontiguousarray(viewpoint, dtype=np.float32)
    out = np.empty((len(pts), 3), np.float32)
    get_lib().estimate_normals(_fptr(pts), len(pts), int(k), _fptr(vp),
                               _fptr(out))
    return out
