"""Build the CUDA sources at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface and no PyTorch
headers, so ``nvcc`` builds it in seconds. The library goes to
``build/repro_torch/`` at the repository root; its name carries a hash of
the source, of every shared header ``csrc/*.cuh`` and of the flags, so an
edited source or header is rebuilt. A failed build raises with ``nvcc``'s
stderr.

``SIGNATURES`` declares every C entry point: pointers and the stream are
``c_void_p`` (a default ctypes int would cut a 64-bit pointer), and every
entry returns an int, the ``cudaError_t`` of its launches. The host side of a
kernel that uses TMA gets ``cuTensorMapEncodeTiled`` through the runtime's
driver entry points, so nothing links the driver library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# source file -> {C symbol: argtypes}; every restype is c_int
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "allin.cu": {
        # x, y, z, slot_id, fx, fy, fz, pot, visits, n_sys, nx, ny, nz, m_c,
        # bx, by, bz, threads, cutoff2, kind, p0, p1, p2, p3, n_extra, stream
        "allin_forces_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _I, _F, _F, _F, _F,
                             _I, _P),
    },
    "pack.cu": {
        # src, dst (arrays of n_fields pointers), fill (n_fields unsigned),
        # n_fields, slot_id, dense_slot, psid, pcell, cell_offsets,
        # row_counts, pslot, n_sys, nx, ny, nz, m_c, row_cap, n_particles,
        # stream
        "pack_rows_f32": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _I, _P),
    },
    "prefix_sum.cu": {
        # in, out, status, n, capacity, stream
        "paper_scan_i32": (_P, _P, _P, _LL, _LL, _P),
    },
    "sfc.cu": {
        # x, y, z, slot_id, codes, tgt_base, src_base, fx, fy, fz, pot,
        # visits, n_sys, n_codes, n_clusters, csize, m_c, total, cutoff2,
        # kind, p0, p1, p2, p3, n_extra, stream
        "cell_sfc_forces_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _I, _I, _I, _I, _I, _I, _F, _I, _F, _F,
                                _F, _F, _I, _P),
    },
    "xpencil.cu": {
        # x, y, z, slot_id, fx, fy, fz, pot, n_sys, nx, ny, nz, m_c,
        # cutoff2, kind, p0, p1, p2, p3, n_extra, stream
        "xpencil_forces_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _F, _I, _F, _F, _F, _F, _I, _P),
        # x, y, z, slot_id, active, fx, fy, fz, pot, n_sys, n_rows, nx, ny,
        # nz, m_c, cutoff2, kind, p0, p1, p2, p3, n_extra, stream
        "xpencil_sparse_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _F, _I, _F, _F, _F, _F, _I,
                               _P),
        # x, y, z, slot_id, active (or NULL), fx, fy, fz, pot, n_sys,
        # n_rows, nx, ny, nz, m_c, cx_cells, cutoff2, kind, p0, p1, p2, p3,
        # n_extra, stream
        "xpencil_chunked_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _F, _I, _F, _F, _F, _F,
                                _I, _P),
        # x, y, z, slot_id, slot_cell, cell_offsets, active, fx, fy, fz,
        # pot, n_sys, n_rows, nx, ny, nz, row_cap, tile_rows, cutoff2, kind,
        # p0, p1, p2, p3, n_extra, stream
        "xpencil_packed_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _F, _I, _F, _F,
                               _F, _F, _I, _P),
    },
    "window_attn.cu": {
        # q, k, v, o, B, H, KH, S, D, window, softcap, scale, bf16, stream
        "window_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                 _F, _I, _P),
    },
    "window_attn_bwd.cu": {
        # q, k, v, out, dout, dq, dk, dv, lse, delta, B, H, KH, S, D,
        # window, softcap, scale, bf16, stream
        "window_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _I, _I, _F, _F, _I, _P),
    },
    "window_attn_bwd_sm90.cu": {
        # q, k, v, out, dout, lse, dq, dk, dv, lse2, delta, B, H, KH, S, D,
        # window, softcap, scale, stream
        "window_attention_bwd_sm90": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _I, _I, _I, _I, _I, _I, _F, _F,
                                      _P),
    },
    "window_attn_sm90.cu": {
        # q, k, v, o, lse (or NULL), B, H, KH, S, D, window, softcap, scale,
        # stream
        "window_attention_sm90": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _F, _F, _P),
    },
}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> pathlib.Path:
    """Where the library of ``csrc/<source>`` goes: named by a hash of the
    source, every ``csrc/*.cuh`` header (any source may include any of
    them) and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{pathlib.Path(source).stem}_{h.hexdigest()[:16]}.so"


def _start_build(source: str):
    """Start nvcc for ``source`` unless its library exists; -> (process or
    None, tmp path, final path)."""
    lib = library_path(source)
    if lib.exists():
        return None, None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, lib


def _finish_build(source: str, proc, tmp: pathlib.Path,
                  lib: pathlib.Path) -> None:
    if proc is None:
        return
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{out}{err}")
    os.replace(tmp, lib)          # atomic publish


def build(sources: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Build the given sources, all ``nvcc`` processes started together."""
    started = [(s, *_start_build(s)) for s in sources]
    for source, proc, tmp, lib in started:
        _finish_build(source, proc, tmp, lib)


_LIBS: Dict[str, ctypes.CDLL] = {}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed, with
    ``argtypes``/``restype`` set for every declared entry point."""
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


def load_all(sources: Iterable[str]) -> None:
    """Load every library of ``sources``; those not loaded yet are built
    first, all their ``nvcc`` processes started together."""
    build([s for s in sources if s not in _LIBS])
    for source in sources:
        load(source)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {rc} (see "
                           "cuda_runtime_api.h's cudaError enum)")
