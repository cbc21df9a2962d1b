"""tpujpeg_torch: the tpujpeg JPEG decoder in PyTorch with hand-written
CUDA kernels for Hopper (sm_90a).

A port of the JAX/Pallas package ``tpujpeg``, which stays beside it as
the reference: the same bytes out for the same JPEG in. This package
imports torch and never JAX, and reads no file of ``tpujpeg/``: the
parser (``bitstream``), error taxonomy, config, stats, the python
entropy oracle (``huffman``) and the native C++ entropy library
(``native/``) are its own copies of the reference's JAX-free files.

Public API:
    decode(data, config, device)                  -> one image
    decode_file(path, config, device=...)         -> one image
    decode_batch_to_rgb(jpegs, config, device)    -> (uint8 [N, H, W, 3], failures)
    decode_batch_to_coeffs(jpegs, config, strict, device)
                                                  -> (per component int32
                                                      [N, blocks, 64], failures)
    decode_batch_to_device(jpegs, config, strict, device)
                                                  -> (per image, per component
                                                      int32 [blocks, 64], failures)
    decode_all_scans_to_rgb_batch(jpegs, config, device)
                                                  -> (uint8 [N, H, W, 3], failures)
                                                     for a progressive group
    decode_all_scans_batch(jpegs, device)         -> (per image, per component
                                                      AC int32 [blocks, 64] and
                                                      DC int32 [blocks], failures)
    DecodeConfig, DecodeStats, JpegError and its subclasses

A progressive group (images with one ``wavefront_prog.scan_group_key``:
same frame, scan script and Huffman tables) decodes through the
progressive scan kernels; ``decode()`` takes them with
``DecodeConfig(entropy_engine="wavefront")`` and native host entropy
otherwise, as the reference does.

The kernels build with nvcc at first use on a CUDA device; on the CPU
every kernel's plain torch version runs instead.
"""

from . import bitstream
from .config import DEFAULT_CONFIG, DecodeConfig
from .decoder import decode, decode_file
from .errors import (
    JpegError,
    JpegHuffmanError,
    JpegSyntaxError,
    JpegTruncatedError,
    JpegUnsupportedError,
)
from .kernels.wavefront import decode_batch_to_coeffs, decode_batch_to_device, decode_batch_to_rgb
from .kernels.wavefront_prog import decode_all_scans_batch, decode_all_scans_to_rgb_batch
from .stats import DecodeStats

__all__ = [
    "decode",
    "decode_file",
    "decode_batch_to_rgb",
    "decode_batch_to_coeffs",
    "decode_batch_to_device",
    "decode_all_scans_to_rgb_batch",
    "decode_all_scans_batch",
    "bitstream",
    "DecodeConfig",
    "DEFAULT_CONFIG",
    "DecodeStats",
    "JpegError",
    "JpegSyntaxError",
    "JpegUnsupportedError",
    "JpegTruncatedError",
    "JpegHuffmanError",
]
