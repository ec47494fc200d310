"""Host C++ for the port's irregular host algorithms, built at first use.

Port of the max-flow half of `alicevision_tpu/native/__init__.py`: the
graph-cut surface mesher's s-t min cut (`maxflow`), in
`native/maxflow.cpp`; the port's JPEG codec (`native/jpeg.cpp`, the
library behind `image/jpeg.py`, which the JAX package reaches through
imageio and PIL); and the byte-stream loops of its TIFF and PNG readers
(`native/codecs.cpp`: `lzw_decode`, `packbits_decode`, `png_unfilter`,
whose plain versions live in `image/tiff.py` and `image/png.py`). Each
source is compiled with the system C++ compiler
(`g++`, which `nvcc` itself needs) into `alicevision_tpu_torch/_build/`
(listed in .gitignore) and loaded with ctypes. A library's file name
carries a hash of its source and flags, so an edited source rebuilds.
Unlike the reference there is no quiet fallback: without a compiler
`maxflow`, the JPEG codec and the TIFF and PNG readers raise. `maxflow_plain` is the reference's
fallback, scipy's integer `maximum_flow`, kept as the plain version the
tests hold the C++ against. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "maxflow.cpp"
JPEG_SRC = _SRC.with_name("jpeg.cpp")
CODECS_SRC = _SRC.with_name("codecs.cpp")
BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None


_USE = {"maxflow.cpp": "the graph-cut max-flow", "jpeg.cpp": "the JPEG codec",
        "codecs.cpp": "the TIFF and PNG readers"}
_JPEG = None
_CODECS = None


def library_path(src: Path = _SRC) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{src.stem}-{digest}.so"


def build(src: Path = _SRC) -> Path:
    """Compile `src` (maxflow.cpp by default) unless its library is already
    built; returns the library's path. Raises when no C++ compiler is found
    or it fails."""
    lib = library_path(src)
    if lib.exists():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++) found: {_USE[src.name]} needs one to build")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed for native/{src.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def jpeg_library() -> ctypes.CDLL:
    """The JPEG codec's library (native/jpeg.cpp), built at first use."""
    global _JPEG
    if _JPEG is None:
        lib = ctypes.CDLL(str(build(JPEG_SRC)))
        p = ctypes.c_void_p
        i64, i32 = ctypes.c_int64, ctypes.c_int
        lib.jpeg_decode_coefficients.restype = i32
        lib.jpeg_decode_coefficients.argtypes = [p, i64, i32, p, i64, i64, i32, p, i32, p, p]
        lib.jpeg_pixels.restype = i32
        lib.jpeg_pixels.argtypes = [i32, p, p, p, i64, i64, i64, i64, i32, p]
        lib.jpeg_encode_scan.restype = i64
        lib.jpeg_encode_scan.argtypes = [p, i64, i64, i32, p, p, p, i64]
        _JPEG = lib
    return _JPEG


def codecs_library() -> ctypes.CDLL:
    """The TIFF / PNG loops' library (native/codecs.cpp), built at first use."""
    global _CODECS
    if _CODECS is None:
        lib = ctypes.CDLL(str(build(CODECS_SRC)))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for name in ("tiff_lzw_decode", "tiff_packbits_decode"):
            getattr(lib, name).restype = i64
            getattr(lib, name).argtypes = [p, i64, p, i64]
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [p, i64, i64, ctypes.c_int, p]
        _CODECS = lib
    return _CODECS


def _stream(fn, data: bytes, size: int) -> np.ndarray:
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(size, np.uint8)
    n = fn(src.ctypes.data, len(src), dst.ctypes.data, size)
    if n == -1:
        raise ValueError("TIFF old-style (LSB-first) LZW is not taken")
    if n < 0:
        raise ValueError("TIFF LZW: a code past the table")
    return dst[:n]


def lzw_decode(data: bytes, size: int) -> np.ndarray:
    """A TIFF LZW strip or tile, at most `size` bytes of it, as uint8 (the
    C++ of `image/tiff.py::_lzw_decode_plain`)."""
    return _stream(codecs_library().tiff_lzw_decode, data, size)


def packbits_decode(data: bytes, size: int) -> np.ndarray:
    """A PackBits strip or tile, at most `size` bytes of it, as uint8 (the
    C++ of `image/tiff.py::_packbits_plain`)."""
    return _stream(codecs_library().tiff_packbits_decode, data, size)


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """h PNG rows of (filter type, `stride` bytes) -> (h, stride) uint8,
    the C++ of `image/png.py::_unfilter`."""
    src = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    if src.size != h * (stride + 1):
        raise ValueError(f"PNG: {src.size} bytes of image data, expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    err = codecs_library().png_unfilter(src.ctypes.data, h, stride, bpp, out.ctypes.data)
    if err:
        y = -err - 1
        raise ValueError(f"unknown PNG row filter {src[y * (stride + 1)]}")
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.bk_maxflow.restype = ctypes.c_double
        lib.bk_maxflow.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _LIB = lib
    return _LIB


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def maxflow(
    n_nodes: int,
    edges_u: np.ndarray,
    edges_v: np.ndarray,
    cap: np.ndarray,
    rev_cap: np.ndarray,
    terminal: np.ndarray,
):
    """Max-flow / min-cut with terminal capacities, in the C++ library.

    terminal[i] > 0: source->i capacity; < 0: i->sink capacity.
    Returns (flow, source_side (n_nodes,) bool)."""
    eu = np.ascontiguousarray(edges_u, np.int64).ravel()
    ev = np.ascontiguousarray(edges_v, np.int64).ravel()
    c = np.ascontiguousarray(cap, np.float64).ravel()
    r = np.ascontiguousarray(rev_cap, np.float64).ravel()
    t = np.ascontiguousarray(terminal, np.float64).ravel()
    if not len(eu) == len(ev) == len(c) == len(r) or len(t) != n_nodes:
        raise ValueError(f"{len(eu)}, {len(ev)} edge ends, {len(c)}, {len(r)} capacities, "
                         f"{len(t)} terminal capacities for {n_nodes} nodes")
    lib = _load()
    out = np.empty(n_nodes, np.uint8)
    flow = lib.bk_maxflow(
        n_nodes,
        _ptr(eu, ctypes.c_int64),
        _ptr(ev, ctypes.c_int64),
        _ptr(c, ctypes.c_double),
        _ptr(r, ctypes.c_double),
        len(eu),
        _ptr(t, ctypes.c_double),
        _ptr(out, ctypes.c_uint8),
    )
    return flow, out.astype(bool)


def maxflow_plain(
    n_nodes: int,
    edges_u: np.ndarray,
    edges_v: np.ndarray,
    cap: np.ndarray,
    rev_cap: np.ndarray,
    terminal: np.ndarray,
):
    """`maxflow` by scipy's integer `maximum_flow` on capacities times 1000
    (the reference's fallback): the plain version of the C++."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow

    eu = np.asarray(edges_u, np.int64)
    ev = np.asarray(edges_v, np.int64)
    t = np.asarray(terminal, np.float64)
    S, T = n_nodes, n_nodes + 1
    scale = 1000.0
    src = np.nonzero(t > 0)[0]
    snk = np.nonzero(t < 0)[0]
    rows = np.concatenate([eu, ev, np.full(len(src), S), snk])
    cols = np.concatenate([ev, eu, src, np.full(len(snk), T)])
    caps = np.concatenate([
        (np.asarray(cap, np.float64) * scale).astype(np.int64),
        (np.asarray(rev_cap, np.float64) * scale).astype(np.int64),
        (t[src] * scale).astype(np.int64),
        (-t[snk] * scale).astype(np.int64),
    ])
    g = coo_matrix((caps, (rows, cols)), shape=(n_nodes + 2, n_nodes + 2)).tocsr()
    res = maximum_flow(g, S, T)
    residual = g - res.flow
    residual.data = np.maximum(residual.data, 0)
    order = breadth_first_order(residual > 0, S, return_predecessors=False)
    side = np.zeros(n_nodes + 2, bool)
    side[order] = True
    return res.flow_value / scale, side[:n_nodes]
