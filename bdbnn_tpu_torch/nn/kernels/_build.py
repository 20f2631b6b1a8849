"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source file exposes a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into a shared library under
``<repo>/build/kernels/``, named by a digest of the source text and the
flags, so an edited source rebuilds and an unchanged one is reused. The
library is loaded with ``ctypes``; every pointer and the stream are
``ctypes.c_void_p`` and every C entry returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

Nothing here runs at import time: a library is built on the first call
that needs it, so importing the package never needs ``nvcc`` (the CPU
tests import every module). :func:`build_all` starts one ``nvcc`` per
source, all at once, and waits for them — what ``chip_smoke.py`` calls
to build everything up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# C signature of every entry point: (name, argtypes). Every entry
# returns the cudaError_t of its launch as an int.
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "binary_conv": {
        # x, shift (or NULL), u (or NULL), wsign, alpha, sx scratch, wpad
        # scratch (or NULL), y, N, H, W, C, O, kh, kw, stride, pad, Ho, Wo,
        # CP, bf16, stream
        "bdbnn_binary_conv_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _P),
    },
    "binary_conv_dgrad": {
        # g, x, shift (or NULL), wsign, alpha, taps, gs scratch, wb
        # scratch, dx, N, H, W, C, O, kh, kw, stride, Ho, Wo, OP, CP,
        # estimator, p0, p1, bf16, stream
        "bdbnn_binary_conv_dgrad": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _F, _F, _I, _P),
    },
    "binary_conv_wgrad": {
        # g, x, shift (or NULL), u (or NULL), w, alpha, gs scratch, sx
        # scratch, partial scratch, dw, N, H, W, C, O, kh, kw, stride, pad,
        # Ho, Wo, OP, CP, splits, rows_per_split, bf16, stream
        "bdbnn_binary_conv_wgrad": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _P),
    },
    "kurtosis": {
        # table (host bytes, copied into the launches), mode, with_grad,
        # partial scratch, out, stream
        "bdbnn_kurtosis_grouped": (_P, _I, _I, _P, _P, _P),
    },
    "weight_binarize": {
        # w (K, O) f32, sign (O, K) int8, alpha (O,), part (2, splits, O)
        # f64 scratch (or NULL), K, O, rows, splits, lab, bf16, stream
        "bdbnn_weight_binarize": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "packed": {
        # packed uint8, alpha (O,), out (K*O,) f32, n = K*O, O, stream
        "bdbnn_unpack_sign": (_P, _P, _P, _I, _I, _P),
        # x, shift (or NULL), wsign, alpha, xbits, xcount, wbits, wcount
        # scratch, y, N, H, W, C, O, kh, kw, stride, pad, Ho, Wo, CPB,
        # stream
        "bdbnn_popcount_conv_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _P),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 = reused)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels are built from csrc/ at first use"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC_DIR)):
        # the library's own source plus every shared header
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def _start(name: str):
    """Start ``nvcc`` for one source; returns (popen, tmp, out) or None
    when the library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started, t0: float) -> None:
    import time

    if started is None:
        build_seconds.setdefault(name, 0.0)
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}.cu:\n{log}")
    # atomic publish: a concurrent builder of the same digest writes the
    # same bytes, so whichever rename lands last is fine
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0


def _bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path(name))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.bdbnn_error_string.argtypes = [ctypes.c_int]
    lib.bdbnn_error_string.restype = ctypes.c_char_p
    return lib


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Build every named library in parallel (one ``nvcc`` each, all
    started together) and bind them; returns per-library build seconds
    (0.0 for a library that was already built)."""
    import time

    names = [n for n in names if n not in _libs]
    with _lock:
        t0 = time.perf_counter()
        started: List = [(n, _start(n)) for n in names]
        errors = []
        for n, s in started:
            try:
                _finish(n, s, t0)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in names:
            _libs[n] = _bind(n)
    return {n: build_seconds[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize()`` would not report it)."""
    if err != 0:
        msg = lib.bdbnn_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")


def stream_ptr(device) -> int:
    """The current PyTorch stream of ``device`` as an int for ctypes."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
