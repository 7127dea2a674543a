"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and bind them with
``ctypes``.

Each source compiles, at first use, into a shared library with a plain C
interface under ``build/`` at the repository root.  The library's file name
carries a hash of its source, so an edited source is never served by a
stale build.  Nothing here runs at import time: the CPU tests import every
module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of every kernel entry point, by source stem.
SIGNATURES = {
    "temporal_edgemap": {
        # dst_local, cand, block_tile, tile_start, out, scratch, counter,
        # n_blocks, n_tiles, tile_v, block_e, n_windows, windows per CTA, stream
        "segment_min_tiles_launch": [_P] * 7 + [_I] * 6 + [_P],
        # dst_local, arr, ts, te, valid, block_tile, tile_start, out, scratch,
        # counter, n_blocks, n_tiles, tile_v, block_e, ta, tb, strict, stream
        "temporal_relax_min_tiles_launch": [_P] * 10 + [_I] * 7 + [_P],
    },
    "segment_spmm": {
        # dst_local, messages, valid, block_tile, out, scratch, counter,
        # n_blocks, n_tiles, tile_v, block_e, d, n_windows, stream
        "segment_spmm_tiles_launch": [_P] * 7 + [_I] * 6 + [_P],
    },
    "decode_attention": {
        # q, k_cache, v_cache, cache_len, part, counter, out, B, S, KH, G, Dh,
        # max_split, scale, dtype, vec, stream
        "decode_attention_launch": [_P] * 7 + [_I] * 6 + [ctypes.c_float] + [_I] * 2 + [_P],
    },
}

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOG: dict = {}  # stem -> nvcc's output (ptxas register/smem report)
_ZEROS: dict = {}     # (tag, device index, stream) -> buffer of stream_zeros


def stream_zeros(tag: str, n: int, dtype, device):
    """A zero-filled device buffer of at least ``n`` elements, one per
    (``tag``, device, current stream), for kernels that leave their scratch
    at zero when they finish: allocated (and zero-filled) again only to
    grow, and never shared by two streams' concurrent calls."""
    import torch

    key = (tag, device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _ZEROS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=dtype, device=device)
        _ZEROS[key] = buf
    return buf


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(stem: str) -> pathlib.Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def compile_source(stem: str) -> pathlib.Path:
    """Compile ``csrc/<stem>.cu`` unless its library is already built.
    The compile writes a temporary file and renames it into place, so
    concurrent processes never load a half-written library."""
    out = library_path(stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")],
            capture_output=True, text=True, check=False)
        BUILD_LOG[stem] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu:\n{BUILD_LOG[stem]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded, signature-bound library of ``csrc/<stem>.cu``."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(stem)))
            for name, argtypes in SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[stem] = lib
        return lib


__all__ = ["library", "compile_source", "library_path", "stream_zeros", "BUILD_DIR",
           "BUILD_LOG"]
