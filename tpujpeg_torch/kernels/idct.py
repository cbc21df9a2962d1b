"""Dequant + un-zigzag + islow IDCT + level shift/clamp: the wrapper for
kernel 6 and its plain version, plus the float ``idct='matmul'`` variant.

Port of ``tpujpeg/kernels/idct.py``. The reference's Pallas kernel took
a coefficient-major [64, N] layout and the pipeline transposed into it
and back out of it (``_cm_to_planes``); those were TPU workarounds. Here
the public layout goes straight in: per component, zigzag int32
[N, padded_blocks, 64] coefficients, and u8 samples come out at their
raster positions in [N, padded_h, padded_w] planes. On CUDA tensors the
wrapper launches ``tj_dequant_idct_islow`` (``csrc/idct.cu``); on CPU
tensors it runs the plain version, built from ``transform.py``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import bitstream
from .. import transform as T
from . import build


def _check(coeffs: torch.Tensor, qtab: torch.Tensor, padded_hb: int, padded_wb: int,
           dc: Optional[torch.Tensor]) -> None:
    n = coeffs.shape[0]
    nb = padded_hb * padded_wb
    if coeffs.dtype != torch.int32 or tuple(coeffs.shape) != (n, nb, 64):
        raise ValueError(f"dequant_idct_islow: coefficients {coeffs.dtype}{tuple(coeffs.shape)}, "
                         f"want int32 [N, {nb}, 64]")
    if qtab.dtype != torch.int32 or tuple(qtab.shape) not in ((64,), (n, 64)):
        raise ValueError(f"dequant_idct_islow: quantizer {qtab.dtype}{tuple(qtab.shape)}, "
                         f"want int32 [64] or [{n}, 64]")
    if dc is not None and (dc.dtype != torch.int32 or tuple(dc.shape) != (n, nb)):
        raise ValueError(f"dequant_idct_islow: DC column {dc.dtype}{tuple(dc.shape)}, "
                         f"want int32 [{n}, {nb}]")
    for t in (qtab, dc):
        if t is not None and t.device != coeffs.device:
            raise ValueError(f"dequant_idct_islow: tensors on {coeffs.device} and {t.device}")


def merge_dc(coeffs: torch.Tensor, dc: Optional[torch.Tensor]) -> torch.Tensor:
    if dc is None:
        return coeffs
    return torch.cat([dc[..., None], coeffs[..., 1:]], dim=-1)


def per_block_qtab(qtab: torch.Tensor) -> torch.Tensor:
    """[64] as is, [N, 64] broadcast over each image's blocks."""
    return qtab if qtab.dim() == 1 else qtab[:, None, :]


def dequant_idct_islow_plain(coeffs: torch.Tensor, qtab: torch.Tensor, padded_hb: int,
                             padded_wb: int, dc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 6's plain version: coeffs int32 [N, padded_hb*padded_wb, 64]
    zigzag, qtab int32 [64] or [N, 64] zigzag, dc (optional) int32
    [N, padded_hb*padded_wb] merged into slot 0 before dequant. Returns
    uint8 [N, padded_hb*8, padded_wb*8]."""
    deq = T.dequantize(merge_dc(coeffs, dc), per_block_qtab(qtab))
    return T.blocks_to_plane(T.idct8x8_islow(deq), padded_hb, padded_wb)


def dequant_idct_islow(coeffs: torch.Tensor, qtab: torch.Tensor, padded_hb: int,
                       padded_wb: int, dc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 6: same contract as ``dequant_idct_islow_plain``. Launches
    the kernel for CUDA tensors, runs the plain version for CPU ones."""
    _check(coeffs, qtab, padded_hb, padded_wb, dc)
    dev = coeffs.device
    if dev.type == "cpu":
        return dequant_idct_islow_plain(coeffs, qtab, padded_hb, padded_wb, dc)
    if dev.type != "cuda":
        raise ValueError(f"dequant_idct_islow: no path for device {dev}")
    n = coeffs.shape[0]
    coeffs, qtab = coeffs.contiguous(), qtab.contiguous()
    dc = dc.contiguous() if dc is not None else None
    build.check_aligned("dequant_idct_islow", [coeffs])  # read as int4
    out = torch.empty((n, padded_hb * 8, padded_wb * 8), dtype=torch.uint8, device=dev)
    rc = build.call(
        dev, "tj_dequant_idct_islow", coeffs.data_ptr(), qtab.data_ptr(), int(qtab.dim() == 2),
        dc.data_ptr() if dc is not None else None, n, padded_hb, padded_wb, out.data_ptr(),
    )
    build.raise_on_error(rc, "dequant_idct_islow")
    build.launched("dequant_idct_islow")
    return out


# ---------------------------------------------------------------------------
# Float variant (config idct='matmul'): dequant + un-zigzag + IDCT as one
# [blocks, 64] @ [64, 64] product. The reference leaves it to an XLA dot
# outside any Pallas kernel, so here it is a float32 torch.matmul. It is
# libjpeg-conformant, not bit-exact, in the reference too.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _idct_matrix_zz() -> np.ndarray:
    """M[k, n]: contribution of zigzag coefficient k to natural pixel n
    (the 8x8 IDCT basis as a 64x64 Kronecker product, rows permuted to
    zigzag order); the reference's ``_idct_matrix_zz``."""
    c = np.zeros((8, 8), dtype=np.float64)
    for u in range(8):
        a = np.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            c[u, x] = a * np.cos((2 * x + 1) * u * np.pi / 16.0)
    m_nat = np.einsum("ux,vy->uvxy", c, c).reshape(64, 64)
    return m_nat[np.asarray(bitstream.ZIGZAG)].astype(np.float32)


def dequant_idct_matmul(coeffs_zz: torch.Tensor, qtab_zz: torch.Tensor) -> torch.Tensor:
    """int32 [..., 64] zigzag coefficients (qtab_zz broadcastable to them)
    -> uint8 [..., 8, 8]. The product runs in full float32: TF32 is
    switched off for it (allow_tf32=False), as XLA's float32 dot is exact
    float32 on the CPU."""
    m = torch.from_numpy(_idct_matrix_zz()).to(coeffs_zz.device)
    deq = (coeffs_zz * qtab_zz).to(torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pix = torch.matmul(deq, m)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = torch.round(pix) + 128
    return out.clamp(0, 255).to(torch.uint8).reshape(*coeffs_zz.shape[:-1], 8, 8)
