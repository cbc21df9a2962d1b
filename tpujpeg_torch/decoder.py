"""Single-image decode: parse, then the fused batch-1 path on the device.

Port of ``tpujpeg.decoder.decode``'s fused path (``decoder.py``
``_decode_fused_single``): a baseline restart-segmented stream runs
``decode_batch_to_rgb([jpeg])``, and a data error in it (bad Huffman
code, AC overrun, truncation) raises. A stream outside this slice raises
``JpegUnsupportedError`` naming the slice that will take it; there is no
staged or CPU fallback.
"""

from __future__ import annotations

import time

from .host import DEFAULT_CONFIG, DecodeConfig, DecodeStats, bitstream
from .kernels import wavefront


def decode(data: bytes, config: DecodeConfig = DEFAULT_CONFIG, device="cuda",
           return_stats: bool = False):
    """Decode one JPEG byte string on `device` to uint8 [H, W, 3] RGB or
    [H, W] gray: a numpy array when ``config.to_numpy`` (the default,
    as in the reference), else a tensor on `device`."""
    stats = DecodeStats()
    t0 = time.perf_counter()
    jpeg = bitstream.parse(data)
    stats.t_parse = time.perf_counter() - t0
    frame = jpeg.frame
    stats.width, stats.height = frame.width, frame.height
    stats.n_components = frame.n_components
    stats.progressive = frame.progressive
    stats.n_scans = len(jpeg.scans)
    stats.n_segments = sum(len(s.rst_offsets) + 1 for s in jpeg.scans)
    stats.restart_interval = jpeg.restart_interval
    stats.bitstream_bytes = len(data)
    stats.total_blocks = sum(c.padded_hb * c.padded_wb for c in frame.components)

    t0 = time.perf_counter()
    rgb, failures = wavefront.decode_batch_to_rgb([jpeg], config, device)
    if 0 in failures:
        raise failures[0]
    out = rgb[0]
    stats.entropy_engine = "wavefront-fused"
    stats.transform_engine = "cuda" if out.device.type == "cuda" else "torch"
    if config.to_numpy:
        out = out.cpu().numpy()
    stats.t_transform = time.perf_counter() - t0
    if return_stats:
        return out, stats
    return out
