"""On-demand g++ build of the native entropy stage: the port's copy of
``tpujpeg/native/build.py``, building this package's own ``entropy.cc``.
The shared object goes into ``tpujpeg_torch/_build/`` (ignored by git),
keyed by a hash of the source + flags, so a source edit triggers exactly
one rebuild. The C ABI + ctypes is the binding layer."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "entropy.cc")
_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_CXX = os.environ.get("CXX", "g++")
_FLAGS = [
    "-O3",
    "-march=native",
    "-fPIC",
    "-shared",
    "-std=c++17",
    "-fno-exceptions",
    "-pthread",
    "-Wall",
]

_lock = threading.Lock()
_lib = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_DIR, f"_entropy_{h}.so")


def build() -> str:
    so = _so_path()
    if not os.path.exists(so):
        os.makedirs(_DIR, exist_ok=True)
        tmp = so + f".tmp{os.getpid()}"
        subprocess.run(
            [_CXX, *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True
        )
        os.replace(tmp, so)  # atomic: concurrent builds race safely
        # Garbage-collect stale builds of older source revisions.
        for f in os.listdir(_DIR):
            if f.startswith("_entropy_") and f.endswith(".so") and f != os.path.basename(so):
                try:
                    os.unlink(os.path.join(_DIR, f))
                except OSError:
                    pass
    return so


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library, with argtypes set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())

        lib.tj_decode_scan.restype = ctypes.c_int
        lib.tj_decode_scan.argtypes = [
            ctypes.c_void_p,                  # scan_data (ptr: zero-copy)
            ctypes.c_int64,                   # scan_len
            ctypes.POINTER(ctypes.c_int64),   # rst_offsets
            ctypes.c_int,                     # n_rst
            ctypes.POINTER(ctypes.c_int32),   # geom
            ctypes.POINTER(ctypes.c_int32),   # scan_params
            ctypes.c_char_p,                  # hspec
            ctypes.c_void_p,                  # coeff0
            ctypes.c_void_p,                  # coeff1
            ctypes.c_void_p,                  # coeff2
            ctypes.c_void_p,                  # coeff3
            ctypes.c_int,                     # is_progressive
            ctypes.c_int,                     # n_threads
            ctypes.c_char_p,                  # err_msg
            ctypes.c_int,                     # err_len
        ]

        lib.tj_destuff_rows.restype = ctypes.c_int
        lib.tj_destuff_rows.argtypes = [
            ctypes.c_void_p,                  # scan_data (ptr: zero-copy)
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
        ]

        lib.tj_scan_split.restype = ctypes.c_int
        lib.tj_scan_split.argtypes = [
            ctypes.c_void_p,                  # destuffed
            ctypes.c_int64,                   # dlen
            ctypes.POINTER(ctypes.c_int32),   # scan_params
            ctypes.c_char_p,                  # hspec
            ctypes.POINTER(ctypes.c_int32),   # blocks_sp
            ctypes.c_int,                     # n_blocks
            ctypes.c_int64,                   # total_mcus
            ctypes.c_int64,                   # every
            ctypes.POINTER(ctypes.c_int64),   # bit_offs
            ctypes.POINTER(ctypes.c_int32),   # dc_out (per-lane DC preds)
            ctypes.c_char_p,                  # err_msg
            ctypes.c_int,                     # err_len
        ]

        lib.tj_scan_split_spec.restype = ctypes.c_int
        lib.tj_scan_split_spec.argtypes = [
            ctypes.c_void_p,                  # destuffed
            ctypes.c_int64,                   # dlen
            ctypes.POINTER(ctypes.c_int32),   # scan_params
            ctypes.c_char_p,                  # hspec
            ctypes.POINTER(ctypes.c_int32),   # blocks_sp
            ctypes.c_int,                     # n_blocks
            ctypes.c_int64,                   # total_mcus
            ctypes.c_int64,                   # every
            ctypes.POINTER(ctypes.c_int64),   # bit_offs
            ctypes.POINTER(ctypes.c_int32),   # dc_out (per-lane DC preds)
            ctypes.c_int,                     # n_threads
            ctypes.c_char_p,                  # err_msg
            ctypes.c_int,                     # err_len
        ]

        lib.tj_find_scan_end.restype = ctypes.c_int64
        lib.tj_find_scan_end.argtypes = [
            ctypes.c_char_p,                  # data
            ctypes.c_int64,                   # n
            ctypes.c_int64,                   # start
            ctypes.POINTER(ctypes.c_int64),   # rst_out
            ctypes.c_int64,                   # rst_cap
            ctypes.POINTER(ctypes.c_int64),   # n_rst (true count)
        ]

        lib.tj_scan_walk.restype = ctypes.c_int64
        lib.tj_scan_walk.argtypes = [
            ctypes.c_char_p,                  # data
            ctypes.c_int64,                   # n
            ctypes.c_int64,                   # start
            ctypes.POINTER(ctypes.c_int64),   # rst_out
            ctypes.c_int64,                   # rst_cap
            ctypes.POINTER(ctypes.c_int64),   # n_rst (true count)
            ctypes.c_void_p,                  # out (destuffed bytes)
            ctypes.POINTER(ctypes.c_int64),   # seg_starts (cap+2)
        ]

        lib.tj_rows_from_dest.restype = ctypes.c_int
        lib.tj_rows_from_dest.argtypes = [
            ctypes.c_void_p,                  # dest (destuffed bytes)
            ctypes.POINTER(ctypes.c_int64),   # seg_starts
            ctypes.c_int,                     # n_seg
            ctypes.c_int,                     # row_words
            ctypes.c_void_p,                  # out_words
            ctypes.c_void_p,                  # out_bits
            ctypes.c_int,                     # n_threads
        ]

        lib.tj_destuff_segments.restype = ctypes.c_int64
        lib.tj_destuff_segments.argtypes = [
            ctypes.c_void_p,                  # scan_data (ptr: zero-copy)
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
        ]

        _lib = lib
        return _lib
