"""nvcc build and ctypes binding of the port's CUDA kernels.

``csrc/*.cu`` compile into one shared library with a plain C interface
(no PyTorch headers, so the build takes seconds), at first use, into
``tpujpeg_torch/_build/``: one nvcc per source, all started together,
then one link; the file name carries a hash of the sources
and flags, so an edit triggers exactly one rebuild (the scheme of
``tpujpeg/native/build.py``). Every C entry point launches on the stream
it is given and returns ``cudaGetLastError()``; ``raise_on_error`` turns
a non-zero code into an exception. Pointers and the stream go in as
``c_void_p``.

Every nvcc runs with ``-Xptxas -v`` (in ``FLAGS``); its report (registers, shared
memory, stack and spill bytes per kernel) is parsed and saved beside the library
(``ptxas_report``). Module state is the library handle and
``LAUNCHES``, the per-kernel launch counters the wrappers bump after
each launch through ``launched``, which also counts the launch in the
traced unit (``spans.count``), and the cache of kernel A/2 occupancies
per device and launch size (``wavefront_occupancy``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import spans

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: "collections.Counter[str]" = collections.Counter()


def launched(name: str) -> None:
    """Count one launch of kernel `name`: in ``LAUNCHES``, and as a
    ``launch`` of the traced unit, if any (``spans.count``)."""
    LAUNCHES[name] += 1
    spans.count(spans.LAUNCH)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# C signatures: name -> argument types (restype is int, a cudaError_t).
_SIGNATURES = {
    "tj_wavefront_pixels": [
        _P, _I, _I,              # bits, W, P
        _P, _P, _P, _P,          # seg_bits, lane_m, lane_qset, lane_meta
        _P, _P, _I,              # bit0, dc0 (null: restart lanes), L
        _P, _P, _P,              # tables, huffval, qsets (zigzag order)
        _P, _P, _P,              # blk, comp, table set per block (host)
        _I, _I, _I, _I,          # B, nq, n_planes, mcus_x
        _P, _I,                  # geometry table, images (null, 0: one geometry)
        _P, _P, _P, _P,          # planes 0..3
        _P, _P,                  # err, stream
    ],
    "tj_wavefront_coeff": [
        _P, _I, _I,              # bits, W, P
        _P, _P, _P,              # seg_bits, lane_m, lane_meta
        _P, _P, _I,              # bit0, dc0 (null: restart lanes), L
        _P, _P,                  # tables, huffval
        _P, _P, _P,              # blk, comp, table set per block (host)
        _I, _I, _I,              # B, n_planes, mcus_x
        _P, _P, _P, _P,          # coefficient arrays 0..3
        _P, _P,                  # err, stream
    ],
    "tj_prog_dc_first": [
        _P, _I, _I,              # bits, W, P
        _P, _P, _I,              # seg_bits, lane_meta, L
        _P, _P, _P,              # tables, huffval, luts
        _P, _I, _I,              # image_set, n_sets, n_sp
        _P, _I, _P, _I, _I,      # blk (host), B, comp (host), mcus_x, al
        _P, _P, _P, _P,          # DC columns 0..3
        _P, _P,                  # err, stream
    ],
    "tj_prog_ac_first": [
        _P, _I, _I,              # bits, W, P
        _P, _P, _I,              # seg_bits, lane_meta, L
        _P, _P, _P,              # tables, huffval, luts
        _P, _I,                  # image_set, n_sets
        _I, _I, _I,              # width_blocks, padded_wb, padded_blocks
        _I, _I, _I,              # ss, se, al
        _P, _P, _P,              # state, err, stream
    ],
    "tj_dequant_idct_islow": [
        _P, _P, _I, _P,          # coef, qtab, per_image_q, dc
        _I, _I, _I, _P, _P,      # N, padded_hb, padded_wb, out, stream
    ],
    "tj_upsample_color_h2v2": [
        _P, _L, _L, _P, _L, _L, _P, _L, _L,  # y, cb, cr: pointer, image stride, row stride
        _I, _I, _I, _I, _I, _P, _P,          # N, H, W, Hc, Wc, out, stream
    ],
    "tj_upsample_color_h2v1": [
        _P, _L, _L, _P, _L, _L, _P, _L, _L,
        _I, _I, _I, _I, _I, _P, _P,
    ],
    "tj_color_444": [
        _P, _L, _L, _P, _L, _L, _P, _L, _L,
        _I, _I, _I, _P, _P,                  # N, H, W, out, stream
    ],
}
_SIGNATURES["tj_wavefront_occupancy"] = [_I, _I, _I, _I, _I, _P, _P]  # pixels, B, nq, n_planes, n_lut, *ctas, *smem
_SIGNATURES["tj_wavefront_occupancy_mixed"] = [_I, _I, _I, _I, _I, _P, _P]  # B, nq, n_planes, n_lut, n_geom, *ctas, *smem
_SIGNATURES["tj_prog_ac_refine"] = _SIGNATURES["tj_prog_ac_first"]
_SIGNATURES["tj_upsample_color_h2v2_planar"] = _SIGNATURES["tj_upsample_color_h2v2"]
_SIGNATURES["tj_upsample_color_h2v1_planar"] = _SIGNATURES["tj_upsample_color_h2v1"]


def _sources() -> Sequence[str]:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")) + glob.glob(os.path.join(_SRC_DIR, "*.cuh")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libtpujpeg_torch_{h.hexdigest()[:16]}.so")


def _entry_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol (_Z23wavefront_pixels_kernel8...),
    with the values of its integer or bool template arguments
    (_Z16h2v2_tile_kernelILb1ELb0EEv... -> h2v2_tile_kernel<1,0>)."""
    m = re.match(r"_Z(\d+)", symbol)
    if not m:
        return symbol
    end = m.end() + int(m.group(1))
    args = re.match(r"I((?:L[a-z]+\d+E)+)E", symbol[end:])
    if args:
        return symbol[m.end():end] + "<" + ",".join(re.findall(r"L[a-z]+(\d+)E", args.group(1))) + ">"
    return symbol[m.end():end]


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """Per kernel, {registers, smem, stack, spill_stores, spill_loads}
    (bytes but for registers; smem is the static shared memory per
    block) from nvcc -Xptxas -v output. Device functions that were not
    inlined have properties but no entry; they are left out."""
    report: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = _entry_name(m.group(1))
            report[entry] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = _entry_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props in report:
            report[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in report:
            report[entry]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            report[entry]["smem"] = int(m.group(1)) if m else 0
    return report


def ptxas_report() -> Optional[Dict[str, Dict[str, int]]]:
    """The -Xptxas -v report of the library's build (parse_ptxas's form),
    saved beside it; None when the library was not built here."""
    path = library_path() + ".ptxas.json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the library if it is not built yet; returns
    its path. nvcc's -Xptxas -v report (registers, stack and spills per
    kernel) is parsed into ``ptxas_report()``; with verbose it is also
    printed."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.path.basename(so)[:-3]}.{os.getpid()}"
    objs, procs = [], []
    for src in [s for s in _sources() if s.endswith(".cu")]:
        obj = os.path.join(BUILD_DIR, f"{tag}.{os.path.basename(src)}.o")
        cmd = [_nvcc(), *FLAGS, "-c", "-o", obj, src]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    tmp = f"{so}.tmp{os.getpid()}"
    report: Dict[str, Dict[str, int]] = {}
    try:
        for cmd, proc in procs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
            report.update(parse_ptxas(out))
            if verbose:
                print(out)
        cmd = [_nvcc(), ARCH, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{res.stdout}\n{res.stderr}")
    finally:
        for _cmd, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    with open(so + ".ptxas.json", "w") as f:
        json.dump(report, f)
    os.replace(tmp, so)
    for old in glob.glob(os.path.join(BUILD_DIR, "libtpujpeg_torch_*.so*")):
        if not old.startswith(so):
            try:
                os.unlink(old)
            except OSError:
                pass
    return so


def get_lib() -> ctypes.CDLL:
    """Load (building first if needed) the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def call(device: torch.device, entry: str, *args) -> int:
    """The library's C entry `entry` on `args` and the current stream of
    `device`, with `device` made current for the call: a kernel launches
    into the current device's context, so a stream of another card would
    fail. Returns the entry's CUDA error code."""
    with torch.cuda.device(device):
        return getattr(get_lib(), entry)(*args, stream_of(device))


WF_THREADS = 128   # threads per CTA of kernels A and 2 (TJ_WF_THREADS)
GEOM_WORDS = 16    # int32 per image of kernel A's mixed geometry table (TJ_GEOM_WORDS)
MAX_GEOM = 256     # images per mixed launch of kernel A (TJ_MAX_GEOM)


@functools.lru_cache(maxsize=None)
def wavefront_occupancy(device: torch.device, pixels: bool, B: int, nq: int, n_planes: int,
                        n_lut: int) -> int:
    """Resident CTAs per SM of kernel A (`pixels`) or 2 on CUDA `device` at
    the dynamic shared memory a launch with B blocks per MCU, nq quantizer
    sets, n_planes planes and n_lut table sets asks for
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); cached per device
    and sizes."""
    ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = get_lib().tj_wavefront_occupancy(int(pixels), B, nq, n_planes, n_lut,
                                              ctypes.addressof(ctas), ctypes.addressof(smem))
    raise_on_error(rc, "tj_wavefront_occupancy")
    return ctas.value


def raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def check_aligned(name: str, tensors: Sequence[torch.Tensor], nbytes: int = 16) -> None:
    """Every tensor starts on an `nbytes` boundary, as a kernel that moves
    it in int4 words needs (a misaligned access would leave a sticky
    CUDA error in the context)."""
    for i, t in enumerate(tensors):
        if t.data_ptr() % nbytes:
            raise ValueError(f"{name}: argument {i} starts at {t.data_ptr():#x}, "
                             f"not on a {nbytes}-byte boundary")


def check_args(name: str, device: torch.device,
               specs: Sequence[Tuple[torch.Tensor, torch.dtype, int]]) -> None:
    """Every tensor on `device`, of its dtype and rank, and contiguous."""
    for i, (t, dtype, ndim) in enumerate(specs):
        if t.device != device or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"{name}: argument {i} is {t.dtype}{tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}); want contiguous {dtype} rank {ndim} on {device}"
            )
