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
    decode_batch_to_rgb(jpegs, config, defer_errors, device)
                                                  -> (uint8 [N, H, W, 3], failures)
    decode_batch_to_coeffs(jpegs, config, strict, device)
                                                  -> (per component int32
                                                      [N, blocks, 64], failures)
    decode_batch_to_device(jpegs, config, strict, device)
                                                  -> (per image, per component
                                                      int32 [blocks, 64], failures)
    decode_norst_to_rgb(jpeg, config, every, packed, device)
                                                  -> uint8 [H, W, 3] for one baseline scan
                                                     without restart markers (or with
                                                     segments over the lane row)
    decode_norst_to_device(jpeg, config, every, device)
                                                  -> per component int32 [blocks, 64]
                                                     for such a scan
    decode_all_scans_to_rgb_batch(jpegs, config, packed, defer_errors, device)
                                                  -> (uint8 [N, H, W, 3], layout, failures)
                                                     for a progressive group
    decode_all_scans_batch(jpegs, device)         -> (per image, per component
                                                      AC int32 [blocks, 64] and
                                                      DC int32 [blocks], failures)
    decode_batch_on_device(datas, config, device) -> BatchResult: mixed JPEG bytes,
                                                     bucketed, each image fault-isolated
    decode_batch(datas, config, device, mesh)     -> BatchResult: host entropy, device transform
                                                     (split over a mesh of devices)
    decode_stream(datas, config, chunk_size, depth, prep_workers, layout, device)
                                                  -> StreamChunk per chunk, in order: host prep
                                                     on threads overlapped with the device
    decode_batch_pipelined(datas, config, chunk_size, depth, prep_workers, layout, device)
                                                  -> BatchResult through the stream
    DecodeConfig, DecodeStats, JpegError and its subclasses

``layout="packed16"`` (and ``packed=True``) asks for the reference's
packed16 form where it applies (4:2:0 and 4:2:2 YCbCr, even width):
planar uint16 [3, H, W/2] per image whose little-endian bytes are the
planar uint8 raster.

Sharded over a mesh (a tuple of ``torch.device``, one per shard, driven
from one process; ``parallel/mesh.py``): ``parallel.halo.decode_sharded(
data, n_shards, config, mesh)`` decodes one giant image by MCU rows with
halo rows between shards; ``kernels.wavefront.decode_norst_sharded`` and
``decode_batch_to_rgb_sharded`` split a marker-free scan's lanes and a
uniform batch over the mesh. The command line is ``python -m
tpujpeg_torch.cli``; the graft entry points (``entry()``, the 512x512
transform step, and ``dryrun_multichip(n)``, the sharded paths checked
over n devices) are in ``graft_entry.py``.

A progressive group (images with one ``wavefront_prog.prog_launch_key``:
same frame and scan script, each image with its own Huffman tables)
decodes through the progressive scan kernels; ``decode()`` takes them with
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
from .kernels.wavefront import (
    decode_batch_to_coeffs,
    decode_batch_to_device,
    decode_batch_to_rgb,
    decode_norst_to_device,
    decode_norst_to_rgb,
)
from .kernels.wavefront_prog import decode_all_scans_batch, decode_all_scans_to_rgb_batch
from .parallel.batch import BatchResult, decode_batch, decode_batch_on_device
from .parallel.stream import StreamChunk, decode_batch_pipelined, decode_stream
from .stats import DecodeStats

__all__ = [
    "decode",
    "decode_file",
    "decode_batch_to_rgb",
    "decode_batch_to_coeffs",
    "decode_batch_to_device",
    "decode_norst_to_rgb",
    "decode_norst_to_device",
    "decode_all_scans_to_rgb_batch",
    "decode_all_scans_batch",
    "decode_batch",
    "decode_batch_on_device",
    "decode_stream",
    "decode_batch_pipelined",
    "BatchResult",
    "StreamChunk",
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
