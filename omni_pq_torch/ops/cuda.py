"""Build and load the hand-written CUDA kernels under `omni_pq_torch/csrc/`.

Each `.cu` file is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface and loaded with `ctypes` (no PyTorch headers,
so a build takes seconds). Builds happen at first use, never at import:
`build()` compiles every source that is not built yet, one `nvcc` process per
source, all started together. A library is named by the hash of its source
and flags, so an edited source is rebuilt and an unchanged one is reused.

The build directory is `build/omni_pq_torch/` in the checkout that holds the
package (listed in `.gitignore`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..utils.trace import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              # belt and braces: the distance code spells its rounding with
              # __f*_rn intrinsics, which nvcc never contracts anyway
              "--fmad=false"]

# (C function, argtypes) of each kernel library; every function returns the
# launch's cudaError_t
_SIGNATURES = {
    "fps": ("fps_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]),
    "ball_query": ("ball_query_launch",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p]),
    "fused_mlp": ("fused_mlp_launch",
                  [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]),
    "fused_mlp_bf16": ("fused_mlp_bf16_launch",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
    "radius_attention": ("radius_attention_launch",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p]),
}
# the other launchers of a library, {C function: argtypes}; each returns
# the launch's cudaError_t too
_MORE_SIGNATURES = {
    "fused_mlp": {
        "mlp_pass_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p],
        "mlp_stats_launch": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p],
        "mlp_stats_finish_launch": [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p],
        "mlp_pool_launch": [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    },
    "fused_mlp_bf16": {
        "mlp_pass_bf16_launch": [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p],
    },
}

# each library's span name (`launch`)
_SPAN_NAMES = {name: f"ops.{name}" for name in _SIGNATURES}

# dynamic shared memory one block may use on an H100 (227 KB)
MAX_SHARED_BYTES = 232448

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "omni_pq_torch"

_loaded: dict = {}
build_logs: dict = {}  # name -> nvcc's output (the -Xptxas -v report)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _target(name: str) -> Path:
    # the source and every header beside it, which it may include
    src = b"".join(path.read_bytes() for path in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=tuple(_SIGNATURES)) -> dict:
    """Compile the named kernel sources that are not built yet, in parallel.

    Returns {name: path of the shared library}. Raises with nvcc's output if
    a build fails."""
    out = BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            build_logs[name] = target.with_suffix(".log").read_text()
            continue
        nvcc = _nvcc()  # before the temporary file, which a raise would leak
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
        else:
            target.with_suffix(".log").write_text(log)
            os.replace(tmp, target)  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def library(name: str):
    """The loaded C entry point of kernel library `name`, built if needed."""
    if name not in _loaded:
        path = build((name,))[name]
        fn_name, argtypes = _SIGNATURES[name]
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        for more, more_argtypes in _MORE_SIGNATURES.get(name, {}).items():
            getattr(lib, more).argtypes = more_argtypes
            getattr(lib, more).restype = ctypes.c_int
        err = lib.error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = (fn, err, lib)
    return _loaded[name]


def launch(name: str, device: torch.device, *args,
           entry: str | None = None) -> None:
    """Call kernel library `name`'s launcher (or its launcher `entry`, one
    of `_MORE_SIGNATURES[name]`) on `device`'s current stream; raise if the
    launch was refused. While a profiler runs, the launch records the
    `utils.trace` span `ops.<name>`, which names the ctypes call that no
    torch op wraps."""
    with span(_SPAN_NAMES[name]):
        fn, err, lib = library(name)
        if entry is not None:
            fn = getattr(lib, entry)
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      ndim: int, last: int | None = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank
    `ndim` (and trailing size `last` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{name}: unexpected shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
