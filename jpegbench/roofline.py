"""The yardstick of the kernels' roofline shares: the card's published
peaks and the bytes and integer operations a kernel's work needs, counted
from the JPEG bytes with the reference parser.

Copied from ``chip_smoke.py`` (``bound``, ``prog_work`` and the counting
rules beside ``OPS_SYMBOL``) and ``PERF.md``'s bound column, so that a
later change to the port cannot move it. Each input byte is counted read
once and each output byte written once.

Peaks (NVIDIA H100 SXM data sheet, 700 W): HBM3 at 3.35 TB/s, and integer
work at the issue rate of 132 SMs x 128 lanes x 1.98 GHz with two
operations per lane-cycle, 66.9 T op/s (the counts take each multiply,
add and shift apart, which the hardware fuses in pairs).

Operations: one block's dequant, islow IDCT, level shift, clamp and
packing is 1,376; a Huffman symbol at least 8. A run counts one symbol
per block (its DC), a lower bound: the exact count (DC + nonzero AC + EOB)
needs the decoded coefficients, which ``symbols`` takes where a caller
has them. Kernel 9 (AC refinement) reads the scan's compressed segments
and the band of its component, and writes the 32-byte sectors whose
coefficients changed; a run counts the first two only (a lower bound),
``kernel_9_work`` the sectors too when it is given the state before and
after the scan. A lower bound on the work makes a share that is never too
high.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .reference import bitstream

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 2 * 1.98e9
OPS_IDCT_BLOCK = 1376
OPS_SYMBOL = 8
OPS_CORRECTION_BIT = 2


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes and operations times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def payload_bytes(scan) -> int:
    """The destuffed entropy-coded bytes of one scan, restart markers out."""
    return sum(len(seg) for seg in bitstream.split_restart_segments(scan))


def blocks(frame) -> int:
    return sum(c.padded_hb * c.padded_wb for c in frame.components)


def symbols(coeffs: Sequence[np.ndarray]) -> int:
    """Huffman symbols of a baseline image from its zigzag coefficients
    [blocks, 64] per component: DC + nonzero AC + EOB (ZRLs left out)."""
    return sum(int(c.shape[0] + (c[:, 1:] != 0).sum() + (c[:, 63] == 0).sum()) for c in coeffs)


def kernel_a_work(jpeg, n_symbols: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, operations) of kernel A on one baseline image: the payload
    read, the padded component planes written; the decode and the
    transform of every block."""
    frame = jpeg.frame
    planes = sum(c.padded_hb * 8 * c.padded_wb * 8 for c in frame.components)
    nb = blocks(frame)
    sym = nb if n_symbols is None else n_symbols
    return payload_bytes(jpeg.scans[0]) + planes, sym * OPS_SYMBOL + nb * OPS_IDCT_BLOCK


def is_ac_refine(scan) -> bool:
    return scan.ss > 0 and scan.ah > 0


def kernel_9_work(jpeg, k: int, before: Optional[np.ndarray] = None,
                  after: Optional[np.ndarray] = None) -> Tuple[int, int]:
    """(bytes, operations) of kernel 9 on scan k (an AC refinement) of one
    image. `before` and `after`, the scan component's zigzag coefficients
    [padded blocks, 64] around the scan, add the changed sectors written,
    one symbol per new nonzero and 2 operations per correction bit;
    without them the count is the lower bound of the module's docstring."""
    scan = jpeg.scans[k]
    c = jpeg.frame.components[scan.comp_indices[0]]
    band_bytes = c.height_blocks * c.width_blocks * (scan.se - scan.ss + 1) * 4
    nbytes, ops = payload_bytes(scan) + band_bytes, 0
    if before is not None and after is not None:
        grid = (c.padded_hb, c.padded_wb, 64)
        a = after.reshape(grid)[: c.height_blocks, : c.width_blocks, scan.ss: scan.se + 1]
        b = before.reshape(grid)[: c.height_blocks, : c.width_blocks, scan.ss: scan.se + 1]
        prior = int((b != 0).sum())
        new_nz = int((a != 0).sum()) - prior
        nbytes += int((after != before).reshape(-1, 8, 8).any(-1).sum()) * 32
        ops = new_nz * OPS_SYMBOL + prior * OPS_CORRECTION_BIT
    return nbytes, ops


def group_key(jpeg) -> Tuple:
    """Progressive images with equal keys share each scan kernel's launch
    in the port's batch ladder: the same geometry, scan script and bytes of
    every Huffman table a scan kernel reads."""
    frame = jpeg.frame
    parts: list = [frame.height, frame.width, tuple((c.h, c.v) for c in frame.components)]
    for scan in jpeg.scans:
        if scan.ss == 0 and scan.ah:
            ids: Tuple = ()
        elif scan.ss == 0:
            ids = tuple((0, scan.dc_ids[sp]) for sp in range(scan.n_comps))
        else:
            ids = ((1, scan.ac_ids[0]),)
        tabs = tuple(scan.huff[i].counts.tobytes() + scan.huff[i].values.tobytes() if i in scan.huff else None
                     for i in ids)
        parts.append((scan.interleaved, tuple(scan.comp_indices), scan.ss, scan.se, scan.ah, scan.al, tabs))
    return tuple(parts)
