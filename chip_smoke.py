#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpujpeg_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and this checkout (the committed fixtures
in tpujpeg_torch/fixtures/); it imports neither JAX nor PIL nor any file
of tpujpeg/. Phases, one JSON line each:

1. device: the card's name and power limit.
2. build: nvcc builds the eleven kernels into tpujpeg_torch/_build/ (one
   nvcc per source, all started together), and its -Xptxas -v report:
   registers, shared memory, stack and spill bytes per kernel. The
   redesigned kernels (A and its mixed form, 2, 7, 8, 9 and every
   instance of the color tile kernels: 4:2:0 behind B and its planar
   kernel, 4:2:2 behind C and its planar kernel, 4:4:4 behind D) must
   show no stack and no spill.
3. kernel_vs_plain: on every fused-path fixture at batch 2, kernel A's
   planes and error bits, kernel 2's coefficients and error bits,
   kernel 6's planes from those coefficients, and kernel B/C/D's RGB,
   equal their plain torch versions run on the same CUDA tensors
   (tolerance 0: integer arithmetic).
   Also the progressive scan kernels 7, 8 and 9 against their plain
   versions, scan by scan from the same state, on batch 2 of every
   progressive fixture (states, DC columns and error bits equal, RGB
   hashing to PIL's), and on a corrupted batch of 3. kernel_timing holds
   them to their plain versions again on the progressive phase's batch.
   And the planar 4:2:0 and 4:2:2 kernels (the packed16 layout) against
   their plain versions on the 4:2:0/4:2:2 fixtures at batch 2 (an odd
   width cropped to even, after the wrapper refused it) and on random
   planes with even widths and odd heights. Every color tile kernel
   (B, C, D and the planar kernels) also at the tile edges (TILE_EDGES:
   ragged widths and heights, H = 1 and 2, W = 2, padded rows, a crop one
   column in), on random planes and planes of 0 and 255. And kernels A
   and 2 with their start state (bit0, dc0) on the norst plans of the
   marker-free 2048x2048 fixture and of rst_rows_420 (restart segments
   over the row cap), batch 1: planes, coefficients and error bits equal
   the plain versions', kernel 6 on kernel 2's coefficients gives kernel
   A's planes, and the RGB hashes to PIL's.
4. main_path: decode_batch_to_rgb of 32 copies of the 2048x2048 q85
   4:2:0 fixture (restart every 4 MCUs), one warm-up and 3 timed runs;
   the launch counters, zeroed just before, show kernels A and B ran
   and no other. Then one batch of 32 each of the same image at 4:2:2
   and 4:4:4 (422_2048, 444_2048) and of the gray fixture through the
   same entry, each counted apart: A and C, A and D, A alone. Decoded
   images hash to PIL's (manifest).
5. staged: the same 32 images through the staged coefficient path,
   decode_batch_to_coeffs (kernel 2) then pipeline.transform_batch
   (kernel 6, then kernel B), one warm-up and 3 timed runs, counted
   apart: kernels 2, 6 and B ran, A did not. The RGB equals the main
   path's byte for byte and PIL's hash.
6. progressive: 32 copies of the same image written progressive with
   restart markers through decode_all_scans_to_rgb_batch, one warm-up
   and 3 timed runs, counted apart: per call kernel 7 once, 8 and 9
   four times each, kernel 6 three times and B once, and neither A nor
   2. The RGB equals the main path's byte for byte and PIL's hash. Then
   the three prog_tsets fixtures (one odd size, each with its own
   Huffman tables) as one group: each kernel scan one launch, scan by
   scan equal to the plain versions, each launch's prog_tsets count the
   number of distinct tables the files carry for that scan, and every
   image hashing to PIL's.
7. norst: the marker-free 2048x2048 fixture (2048 lanes of 8 MCUs at
   the default every) through decode_norst_to_rgb, nhwc and packed=True,
   one warm-up and 3 timed runs each, counted apart: A and B, A and the
   4:2:0 planar kernel; then decode_norst_to_device + transform_frame
   (kernels 2, 6 three times and B per call), and decode_norst_to_rgb
   with every=1 (16,384 lanes of one MCU). Every output hashes to PIL's.
   Also the host split (build_norst_plan) timed alone, and kernels A and
   2 on both norst plans timed with CUDA events beside their plain
   versions and their bounds.
8. stream: decode_batch_pipelined over 4 chunks of 32 copies of the
   2048x2048 fixture (chunk_size 32, depth 2, min(3, cpu count) prep
   threads), with layout="packed16" and "nhwc" (and packed16 on one
   prep thread), one warm-up and 3 timed runs each, counted apart:
   kernel A and the 4:2:0 planar kernel ran for packed16, A and B for
   nhwc. Every image equals the main path's RGB (packed16 as its planar
   bytes) and PIL's hash. Also the host-prep rate on one thread, the
   device-only rate (plans built and uploaded before the clock), and a
   packed16 chunk of 32 x 422_2048 (A and the 4:2:2 planar kernel),
   and the packed16 stream with pinned against pageable plans, 4 runs
   each alternated, the first of each a warm-up. Then one chunk of the
   imagenet_shard sizes (SHARD_CHUNK: 13 x 512^2, 10 x 768x512, 6 x
   1024^2, 3 x 2048^2, crops of the 2048x2048 fixture by
   fixtures/tile.py's crop_jpeg): its four geometry buckets, planned as
   one launch group (plan_launches, pinned), decode in one launch of kernel A's
   mixed form and no other launch, equal (planes and error bits) to the
   plain version of the combined plan and to each bucket's own launch;
   the same 32 images as one decode_stream chunk (packed16) launch the
   mixed form once and the 4:2:0 planar kernel once per bucket, every
   image equal to decode_batch_on_device's and the 2048^2 ones to PIL's
   hash.
9. batch: decode_batch_on_device and decode_batch on one list of every
   fixture (fused, staged, progressive, norst, multi-scan), one member
   with its scan payload zeroed and bytes that are no JPEG: each image
   hashes to PIL's or fails with the manifest's exception class, each
   takes its rung (stats.entropy_engine: the device ladder keeps every
   fixture on the card, the norst ones on kernel A as
   "wavefront-skeleton", but the marker-free progressive one, which
   takes host entropy as in the reference; decode_batch is host entropy
   throughout), and the kernels that ran are exactly the rungs' kernels
   (kernel A's mixed form for the fused fixtures of several sizes that
   share a launch group).
10. kernel_timing: each kernel and its plain version, timed with CUDA
   events on the main, staged and progressive paths' inputs (a kernel's
   window opens on a queue the card's sleep kept full, so it holds no
   host time of the wrapper; kernels 7-9 also with the window opened on
   an idle card, ms_with_wrapper, the figure of earlier runs; kernels
   7-9 and their plain versions: summed over the scans of their kind at
   batch 32, each scan run from its own input state, the kernel's output
   state and error bits equal to the plain version's), beside its
   bound (bytes over 3.35 TB/s or integer operations over the card's
   issue rate, whichever is larger); C, D and the 4:2:2 planar kernel on
   the 2048^2 batches, and again (small) on the 384x512 fixtures. The
   planar kernels beside kernel B also on random 32 x 2048^2 planes
   (tools/color_probe.py's and color_profile.py's A/B), C, the 4:2:2
   planar kernel and D on random 32 x 2048^2 planes, each equal to its
   plain version there, and the tail split of tools/tail_variants.py:
   kernel A alone, A + B and A + the planar kernel. Kernel A's mixed form
   on the shard chunk's combined plan beside its plain version, its
   bound (the chunk's symbols counted from kernel 2's coefficients) and
   the four bucket launches of the one-geometry form
   (bucket_launches_ms).
11. faults: one corrupted member of a batch fails with the manifest's
   exception class; the other members stay bit-exact. The marker-free
   2048x2048 fixture with its scan cut in half raises a JpegError from
   decode_norst_to_rgb.
12. decode: tpujpeg_torch.decode of fused fixtures, of the norst ones
   (the fused path on the norst plan, "wavefront-fused-norst"), and of
   the staged ones (progressive 2048^2 through native entropy, kernel 6
   and kernel B; multi-scan with entropy_engine="wavefront", kernel 2
   per component; the restart-segmented progressive 2048^2 with
   entropy_engine="wavefront", kernels 7-9), hashes to PIL's.

13. sharded: the 16384x16384 4:2:0 image (tile_jpeg(420_2048, 8, 8),
   about 86 MB, BASELINE.json config 5's shape) through
   parallel.halo.decode_sharded on SHARDS = 4 shards ((cuda:0,) * 4, or
   one shard per card with 4 or more cards), one warm-up and 3 timed
   runs, counted apart: per call kernel 2 once, kernel 6 three times per
   shard and B once per shard, A never. Its RGB equals
   decode_batch_to_rgb of the same bytes (kernel A + B, also one warm-up
   and 3 timed runs, the parse inside the clock as in decode_sharded)
   byte for byte on the card. One more call records every launch's
   inputs and result (kernel 2 on the whole image's 262,144 lanes, kernel
   6 on each shard's window of coefficient rows, B on each window's
   planes): each result equals its plain version on the same inputs, on
   the card, and the kernels line's max_abs_err takes these in. Prints
   walls, tiling, parse and host plan times, each step's device time
   (kernel 2, the 12 kernel 6 launches, the color stage on the windows
   with the crop into the image, and the 4 B launches alone) and the
   peak memory above what was allocated before, for both paths. Then the
   same image as one scan without restart markers (fixtures/tile.py's
   norst_jpeg codes kernel 2's coefficients again with the file's
   tables): decode_sharded takes decode_norst_sharded (kernel 2 once per
   shard, the DC fixup across shards), its RGB equals the
   restart-segmented image's and decode_norst_to_rgb's (the fused
   single-device decode of the same file), and decode_norst_sharded's
   coefficients equal decode_norst_to_device's and the restart-segmented
   image's; one more decode_norst_sharded call records each shard's
   kernel-2 launch, which equals its plain version on its own inputs.
   Prints the encode and host split times, walls and peak memory of the
   four entries.
14. The fixtures through decode_sharded on 4 shards: norst_2048,
   422_2048, 444_2048 and gray hash to PIL's; kernel 2 runs once per
   shard for the marker-free one (whose decode_norst_sharded
   coefficients equal decode_norst_to_device's) and once for the others;
   gray launches no color kernel.
15. data_parallel: decode_batch_to_rgb_sharded of the main 32 images
   over the 4 shards (A and B four times each, every image equal to the
   main path's; each A and B launch, recorded, equal to its plain version
   on the same inputs), and decode_batch(mesh=...) on the batch phase's list
   (each image hashes to PIL's or fails with the manifest's class).
16. cli: python -m tpujpeg_torch.cli in subprocesses: info on a
   fixture, decode to .npy (hashing to PIL's), bench --repeats 3, and
   batch --on-device into a temporary directory three times: every file
   completed, then every file skipped, then with a corrupt member added,
   exit code 2.
17. graft_entry: tpujpeg_torch.graft_entry.entry()'s step (the 512x512
   4:2:0 transform) on card 0, counted apart: kernel 6 three times and B
   once, its RGB equal to the plain transform's (tpujpeg_torch.transform)
   of the same tensors on the host, each launch of one more call equal to
   its plain version; its time with CUDA events (median of 3 means of 10
   calls from an idle card, and device_ms), the plain transform's on the
   card and the step's bound. Then dryrun_multichip(4) (one shard per
   card with 4 or more cards, else 4 shards of card 0): its shard and
   device counts and its launches per kernel (A, 6 and B, each count
   checked), every launch recorded and held to its plain version.

Then the check that no module was loaded from tpujpeg/ (and that the
new modules were loaded from tpujpeg_torch/) and nothing was
written there, the nvidia-smi line, the kernels JSON line and, last,
the ok line. Exits non-zero, printing no ok line, on any failure or
without a card.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tpujpeg_torch", "fixtures")
MAIN_BATCH = 32
AB_SIZE = 2048   # luma height and width of the random planes of kernel_timing_ab

# name -> (source, the TPU kernel it replaces); all are CUDA C++.
KERNELS = {
    "wavefront_pixels": ("tpujpeg_torch/csrc/wavefront.cu", "tpujpeg/kernels/wavefront_pallas.py:660"),
    "wavefront_coeff": ("tpujpeg_torch/csrc/wavefront.cu", "tpujpeg/kernels/wavefront_pallas.py:841"),
    "wavefront_pixels_mixed": (
        "tpujpeg_torch/csrc/wavefront.cu",
        "tpujpeg/kernels/wavefront_pallas.py:660 over several frame sizes per launch (the reference's stream "
        "falls back on mixed chunks)"),
    "dequant_idct_islow": ("tpujpeg_torch/csrc/idct.cu", "tpujpeg/kernels/idct.py:42"),
    "upsample_color_h2v2": ("tpujpeg_torch/csrc/sample_color.cu", "tpujpeg/kernels/sample_color.py:97"),
    "upsample_color_h2v1": ("tpujpeg_torch/csrc/sample_color.cu", "tpujpeg/kernels/sample_color.py:146"),
    "color_444": ("tpujpeg_torch/csrc/sample_color.cu", "tpujpeg/kernels/sample_color.py:160"),
    "prog_dc_first": ("tpujpeg_torch/csrc/prog.cu", "tpujpeg/kernels/wavefront_prog.py:236"),
    "prog_ac_first": ("tpujpeg_torch/csrc/prog.cu", "tpujpeg/kernels/wavefront_prog.py:382"),
    "prog_ac_refine": ("tpujpeg_torch/csrc/prog.cu", "tpujpeg/kernels/wavefront_prog.py:710"),
    "upsample_color_h2v2_planar": (
        "tpujpeg_torch/csrc/sample_color.cu",
        "tpujpeg/kernels/sample_color.py:97 (packed_words=True); P1-P6: tools/color_probe.py:79, "
        ":129, :193, :249, tools/tail_variants.py:111, tools/color_profile.py:79"),
    "upsample_color_h2v1_planar": (
        "tpujpeg_torch/csrc/sample_color.cu", "tpujpeg/kernels/sample_color.py:146 (packed_words=True)"),
}
STREAM_CHUNKS = 4   # the stream phase's chunks of MAIN_BATCH images
# One stream chunk of jpegbench/configs/imagenet_shard.json's sizes:
# (width, height, images) per geometry bucket, MAIN_BATCH images in all.
SHARD_CHUNK = ((512, 512, 13), (768, 512, 10), (1024, 1024, 6), (2048, 2048, 3))
SHARDS = 4          # the sharded phases' mesh: one shard per card, or SHARDS shards of card 0
GIANT_TILES = 8     # the giant image: 420_2048 tiled 8 x 8, 16384 x 16384
CLI_FILES = ("420_odd", "422", "444", "gray")   # the cli phase's batch job
# The batch phase's rung for each fixture: by its manifest path, but for
# the staged ones, where the marker-free progressive stream takes host
# entropy and the multi-scan file kernel 2 per scan.
PATH_RUNG = {"fused": "wavefront-fused", "progressive": "wavefront-prog", "norst": "wavefront-skeleton"}
BATCH_RUNG = {"prog_2048": "native", "multiscan": "wavefront-coeff"}
NORST_MAIN = "norst_2048"   # the norst phase's fixture
PROG_MAIN = "prog_rst_2048"   # the progressive phase's fixture
PROG_KERNEL = {"dc_first": "prog_dc_first", "ac_first": "prog_ac_first", "ac_refine": "prog_ac_refine"}
# The kernels redesigned to keep nothing in local memory (A and its mixed
# form, 2, 7, 8, 9, and every instance of the color tile kernels: 4:2:0
# behind B and its planar kernel, 4:2:2 behind C and its planar kernel,
# 4:4:4 behind D).
NO_LOCAL_MEMORY = ("wavefront_pixels_kernel", "wavefront_pixels_kernel_mixed", "wavefront_coeff_kernel",
                   "prog_dc_first_kernel",
                   "prog_ac_first_kernel", "prog_ac_refine_kernel",
                   *(f"{k}_tile_kernel<{v},{p}>" for k in ("h2v2", "h2v1") for v in (0, 1) for p in (0, 1)),
                   "color_444_tile_kernel<0>", "color_444_tile_kernel<1>")

# The card's roofs for bound_ms: HBM3 at 3.35 TB/s, and integer work at
# the issue rate of 132 SMs x 128 lanes x 1.98 GHz with two operations
# per lane-cycle: 66.9 T op/s, the data sheet's 67 TFLOP/s float32 figure.
# Integer code issues on both the ALU and the FMA pipe (IMAD), and the
# counts below take each multiply, add and shift apart, which the
# hardware fuses in pairs (IMAD, IADD3, LEA), so two per lane-cycle is
# the peak for these counts.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 2 * 1.98e9
# int32 operations each kernel needs, counted from the CUDA sources:
# one 8-point islow butterfly (tj_idct_1d) is 62, so one block's
# dequant (64) + 16 butterflies (992) + level shift, clamp and byte
# packing (320) is 1,376; the color kernels need per output pixel the
# YCbCr->RGB fixed point with clamps (22) plus, per chroma channel, the
# triangular taps (4:2:0: 5, 4:2:2: 4). A Huffman symbol costs at least
# 8 (window, one code compare, value fetch, extend, cursor); symbols
# are counted from this run's coefficients as DC + nonzero AC + EOB,
# leaving out ZRLs, so the decode count is a lower bound.
# The progressive kernels count symbols from the state before and after
# each scan: DC first one per block; AC first one per new nonzero of the
# band plus one EOB for each lane with a block whose coefficient Se stays
# 0 (runs reset at each restart); AC refine one per new nonzero, plus 2
# operations per correction bit (one for each nonzero the band held
# before), leaving out its EOBs and ZRLs. Bytes: the scan's compressed
# segments, plus the DC column written (DC first); for AC first the
# 32-byte sectors that hold a coefficient the scan changed, read and
# written (the kernel adds into a zeroed band); for AC refine the band
# read, plus those sectors written (a block goes back only if changed).
OPS_IDCT_BLOCK = 1376
OPS_COLOR_PIXEL = {"upsample_color_h2v2": 32, "upsample_color_h2v1": 30, "color_444": 22,
                   "upsample_color_h2v2_planar": 32, "upsample_color_h2v1_planar": 30}
OPS_SYMBOL = 8
OPS_CORRECTION_BIT = 2

# The color tile kernels' edges (tiles of 16 rows x 256 columns, 4 tiles
# down per block, 16 pixels per thread) as (H, W, luma row padding,
# chroma row padding, first column): widths one and two past a multiple
# of 16 and of 256, heights one past a tile and one past a block's 64
# rows, H = 1 and 2, W = 2, rows whose strides are no multiple of 16 or
# of 8 bytes, a crop one column in (odd base pointers: the byte
# instance), 16-byte luma with 8-byte aligned chroma rows, and aligned
# planes (the 16-byte path).
TILE_EDGES = [(17, 4097, 0, 0, 0), (17, 4098, 0, 0, 0), (33, 257, 3, 1, 0), (33, 258, 0, 0, 0),
              (9, 17, 0, 0, 0), (9, 18, 2, 2, 0), (17, 256, 0, 0, 0), (1, 512, 0, 0, 0),
              (2, 512, 0, 0, 0), (5, 2, 0, 0, 0), (33, 256, 0, 0, 1), (33, 512, 16, 8, 0),
              (33, 512, 5, 5, 0), (32, 512, 0, 0, 0), (65, 258, 0, 0, 0)]


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def sha(a) -> str:
    return hashlib.sha256(a.contiguous().cpu().numpy().tobytes()).hexdigest()


def zero_payload(data: bytes) -> bytes:
    """The stream with every entropy-coded byte of its first scan zeroed
    and its restart markers kept (the manifest's fill-0 fault, in bytes)."""
    d = bytearray(data)
    sos = d.index(b"\xff\xda")
    i = sos + 2 + int.from_bytes(d[sos + 2 : sos + 4], "big")
    while i < len(d) - 2:
        if d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7:
            i += 2
            continue
        d[i] = 0
        i += 1
    return bytes(d)


def shard_chunk(crop_jpeg, data: bytes):
    """(bytes, (width, height)) of SHARD_CHUNK's images, each a crop of the
    2048^2 fixture `data` (restart segments of 64 x 16 pixels) at its own
    place, in the configuration's cycle of sizes (4:3:2:1) while each size
    has images left; the 2048^2 ones are the fixture itself."""
    left = {(w, h): n for w, h, n in SHARD_CHUNK}
    cycle = [(w, h) for (w, h, _n), r in zip(SHARD_CHUNK, (4, 3, 2, 1)) for _ in range(r)]
    sizes = []
    while any(left.values()):
        for wh in cycle:
            if left[wh]:
                left[wh] -= 1
                sizes.append(wh)
    out = []
    for k, (w, h) in enumerate(sizes):
        x, y = 64 * ((7 * k) % ((2048 - w) // 64 + 1)), 16 * ((5 * k) % ((2048 - h) // 16 + 1))
        out.append(crop_jpeg(data, w, h, x, y))
    return out, sizes


def planar_bytes(torch, packed):
    """Planar uint16 [..., 3, H, W/2] -> its bytes as uint8 [..., H, W, 3]."""
    *lead, c, h, w2 = packed.shape
    return packed.view(torch.uint8).view(*lead, c, h, 2 * w2).movedim(-3, -1)


# Chroma plane shape for luma (H, W), by the NHWC color kernel.
CHROMA_SHAPE = {"upsample_color_h2v2": lambda h, w: ((h + 1) // 2, (w + 1) // 2),
                "upsample_color_h2v1": lambda h, w: (h, (w + 1) // 2),
                "color_444": lambda h, w: (h, w)}


def edge_planes(torch, gen, dev, kname, h, w, ypad, cpad, off, fill):
    """Luma [3, h, w] and the chroma planes of color kernel kname on dev,
    each cropped from column `off` of a plane `pad` bytes wider: random
    bytes, or ("0/255") bytes of 0 and 255 only."""
    def plane(rows, cols, pad):
        t = torch.randint(0, 256 if fill == "random" else 2, (3, rows + 1, cols + pad + off),
                          generator=gen, dtype=torch.uint8)
        return (t if fill == "random" else t * 255).to(dev)[:, :rows, off:off + cols]

    hc, wc = CHROMA_SHAPE[kname](h, w)
    return [plane(h, w, ypad), plane(hc, wc, cpad), plane(hc, wc, cpad)]


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean time of fn() over reps calls, after one warm-up, from an idle
    card: the plain versions' timer (they sync the host inside). A
    kernel's time is device_ms (tpujpeg_torch/tools/kernel_ab.py): the card
    sleeps before the start event until the launches are queued, so the
    window holds no host time of the wrapper."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes and operations times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def prog_work(torch, plan, frame, before, after):
    """(bytes, operations) the function of one progressive kernel scan
    needs on this run's data (counting rules beside OPS_SYMBOL); before
    and after are the scan component's AC state around the scan."""
    row_bytes = int(plan.seg_bits.to(torch.int64).sum()) // 8
    if plan.kind == "dc_first":
        blocks = int(plan.lane_meta[:, 2].to(torch.int64).sum()) * len(plan.blk)
        return row_bytes + blocks * 4, blocks * OPS_SYMBOL
    c = frame.components[plan.comp_indices[0]]
    n, hb, wb = after.shape[0], c.height_blocks, c.width_blocks
    a = after.view(n, c.padded_hb, c.padded_wb, 64)[:, :hb, :wb]
    b = before.view(n, c.padded_hb, c.padded_wb, 64)[:, :hb, :wb]
    band = slice(plan.ss, plan.se + 1)
    prior = int((b[..., band] != 0).sum())
    new_nz = int((a[..., band] != 0).sum()) - prior
    sector_bytes = int((after != before).view(n, -1, 8, 8).any(-1).sum()) * 32
    if plan.kind == "ac_first":
        z = (a[..., plan.se] == 0).reshape(-1).to(torch.int64)
        cum = torch.cat([z.new_zeros(1), z.cumsum(0)])
        meta = plan.lane_meta.to(torch.int64)
        start = meta[:, 0] * (hb * wb) + meta[:, 1]
        eob_lanes = int(((cum[start + meta[:, 2]] - cum[start]) > 0).sum())
        return row_bytes + 2 * sector_bytes, (new_nz + eob_lanes) * OPS_SYMBOL
    band_bytes = n * hb * wb * (plan.se - plan.ss + 1) * 4
    return row_bytes + band_bytes + sector_bytes, new_nz * OPS_SYMBOL + prior * OPS_CORRECTION_BIT


def ref_tree(root: str):
    """(path, size, mtime) of every file under the reference package."""
    out = []
    for dirpath, _dirs, files in os.walk(os.path.join(root, "tpujpeg")):
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            out.append((os.path.join(dirpath, f), st.st_size, st.st_mtime_ns))
    return sorted(out)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 1
    ref_before = ref_tree(HERE)
    sys.path.insert(0, HERE)
    try:
        import tpujpeg_torch
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repo: {e}", file=sys.stderr)
        return 1
    from tpujpeg_torch.kernels import build, idct, pipeline, sample_color as sc, wavefront as wf
    from tpujpeg_torch import spans
    from tpujpeg_torch.kernels import wavefront_prog as wp
    from tpujpeg_torch.tools.kernel_ab import device_ms

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    datas = {}
    for name, entry in manifest["fixtures"].items():
        with open(os.path.join(FIXTURES, entry["file"]), "rb") as f:
            datas[name] = f.read()
        check(hashlib.sha256(datas[name]).hexdigest() == entry["file_sha256"], f"{name}: file hash")
    fused = [n for n, e in manifest["fixtures"].items() if e["path"] == "fused"]
    progressive = [n for n, e in manifest["fixtures"].items() if e["path"] == "progressive"]
    norst = [n for n, e in manifest["fixtures"].items() if e["path"] == "norst"]
    dev = torch.device("cuda", 0)
    parse = tpujpeg_torch.bitstream.parse
    config = tpujpeg_torch.DEFAULT_CONFIG

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build
    t0 = time.perf_counter()
    build.build()
    build.get_lib()
    ptxas = build.ptxas_report()
    check(ptxas is not None, "no -Xptxas -v report beside the library")
    emit("build", seconds=time.perf_counter() - t0, library=os.path.relpath(build.library_path(), HERE),
         ptxas=ptxas)
    for k in NO_LOCAL_MEMORY:
        r = ptxas.get(k, {})
        check(r.get("stack") == 0 and r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"{k}: stack or spill in the ptxas report ({r})")

    color_fns = {
        "upsample_color_h2v2": (sc.upsample_color_h2v2, sc.upsample_color_h2v2_plain),
        "upsample_color_h2v1": (sc.upsample_color_h2v1, sc.upsample_color_h2v1_plain),
        "color_444": (sc.color_444, sc.color_444_plain),
    }
    color_of = {"420_2048": "upsample_color_h2v2", "420_odd": "upsample_color_h2v2",
                "422": "upsample_color_h2v1", "444": "color_444",
                "422_2048": "upsample_color_h2v1", "444_2048": "color_444"}
    planar_fns = {
        "upsample_color_h2v2": ("upsample_color_h2v2_planar", sc.upsample_color_h2v2_packed,
                                sc.upsample_color_h2v2_packed_plain),
        "upsample_color_h2v1": ("upsample_color_h2v1_planar", sc.upsample_color_h2v1_packed,
                                sc.upsample_color_h2v1_packed_plain),
    }
    planar_err = {"upsample_color_h2v2_planar": 0, "upsample_color_h2v1_planar": 0}

    def planar_vs_plain(cname, ins, nhwc=None):
        """A planar kernel, its plain version and (if given) the NHWC
        kernel's output on the same planes: equal bytes."""
        pname, kern, plain = planar_fns[cname]
        got = kern(*ins)
        torch.cuda.synchronize()
        err = max_abs(torch, got, plain(*ins))
        check(err == 0, f"{pname} != plain ({err}) on {tuple(ins[0].shape)}")
        if nhwc is not None:
            check(torch.equal(planar_bytes(torch, got), nhwc), f"{pname} bytes != the NHWC kernel's")
        planar_err[pname] = max(planar_err[pname], err)
        return err

    def lanes(plan, geoms, fn):
        """A lane kernel (decode_lanes_to_planes: A, _to_coeffs: 2) and its
        plain version on the same CUDA tensors."""
        out_k, err_k = fn(plan, geoms, dev)
        torch.cuda.synchronize()
        out_p, err_p = fn(plan, geoms, dev, plain=True)
        torch.cuda.synchronize()
        return out_k, err_k, out_p, err_p

    def cropped(frame, planes):
        return [p[:, : c.dheight, : c.dwidth] for p, c in zip(planes, frame.components)]

    def idct_planes(frame, coeffs, qtabs, plain=False):
        """Kernel 6 (or its plain version) on every component."""
        fn = idct.dequant_idct_islow_plain if plain else idct.dequant_idct_islow
        return [fn(c, q, fc.padded_hb, fc.padded_wb) for c, q, fc in zip(coeffs, qtabs, frame.components)]

    def qtabs_of(jpeg):
        return [torch.from_numpy(jpeg.qtables[c.tq].astype("int32")).to(dev) for c in jpeg.frame.components]

    # 3. kernel vs plain on every fused-path fixture at batch 2
    for name in fused:
        jpegs = [parse(datas[name]) for _ in range(2)]
        plan = wf.build_block_plan(jpegs)
        geoms = [wf.ImageGeom.of(j) for j in jpegs]
        planes_k, err_k, planes_p, err_p = lanes(plan, geoms, wf.decode_lanes_to_planes)
        err_a = max(max_abs(torch, a, b) for a, b in zip(planes_k, planes_p))
        check(err_a == 0 and torch.equal(err_k, err_p), f"{name}: kernel A != plain ({err_a})")
        check(not err_k.any(), f"{name}: decode errors {err_k.nonzero().flatten().tolist()}")
        coef_k, err2_k, coef_p, err2_p = lanes(plan, geoms, wf.decode_lanes_to_coeffs)
        err_2 = max(max_abs(torch, a, b) for a, b in zip(coef_k, coef_p))
        check(err_2 == 0 and torch.equal(err2_k, err2_p), f"{name}: kernel 2 != plain ({err_2})")
        check(torch.equal(err2_k, err_k), f"{name}: kernel 2 and kernel A error bits differ")
        qt = qtabs_of(jpegs[0])
        idct_k = idct_planes(jpegs[0].frame, coef_k, qt)
        torch.cuda.synchronize()
        idct_p = idct_planes(jpegs[0].frame, coef_k, qt, plain=True)
        err_6 = max(max_abs(torch, a, b) for a, b in zip(idct_k, idct_p))
        check(err_6 == 0, f"{name}: kernel 6 != plain ({err_6})")
        check(all(torch.equal(a, b) for a, b in zip(idct_k, planes_k)),
              f"{name}: kernel 2 + kernel 6 planes != kernel A planes")
        rec = dict(fixture=name, lanes=plan.n_lanes, words=plan.n_words, kernel_a_max_abs_err=err_a,
                   kernel_2_max_abs_err=err_2, kernel_6_max_abs_err=err_6)
        if name in color_of:
            kern, plain = color_fns[color_of[name]]
            ins = cropped(jpegs[0].frame, planes_k)
            out_k = kern(*ins)
            torch.cuda.synchronize()
            out_p = plain(*ins)
            rec["color_max_abs_err"] = max_abs(torch, out_k, out_p)
            check(rec["color_max_abs_err"] == 0, f"{name}: color kernel != plain")
            check(sha(out_k[0]) == manifest["fixtures"][name]["pil_sha256"], f"{name}: RGB != PIL")
            if color_of[name] in planar_fns:
                w = ins[0].shape[2]
                if w % 2:
                    try:
                        planar_fns[color_of[name]][1](*ins)
                    except ValueError:
                        pass
                    else:
                        raise SmokeError(f"{name}: the planar kernel took an odd width")
                    w -= 1
                    ins = [ins[0][:, :, :w]] + [c[:, :, : w // 2] for c in ins[1:]]
                    out_k = kern(*ins)
                rec["planar_max_abs_err"] = planar_vs_plain(color_of[name], ins, out_k)
        else:
            c = jpegs[0].frame.components[0]
            gray = planes_k[0][0, : c.dheight, : c.dwidth]
            check(sha(gray) == manifest["fixtures"][name]["pil_sha256"], f"{name}: gray != PIL")
        emit("kernel_vs_plain", **rec)

    # Kernels A and 2 with their start state: the norst plans (lanes cut at
    # skeleton-scan offsets, starting mid-word with primed predictors).
    norst_err = {"wavefront_pixels": 0, "wavefront_coeff": 0}
    for name in norst:
        jpeg = parse(datas[name])
        plan = wf.build_norst_plan(jpeg)
        geoms = [wf.ImageGeom.of(jpeg)]
        check(plan.bit0 is not None and bool((plan.bit0 % 32).any()), f"{name}: no lane starts mid-word")
        planes_k, err_k, planes_p, err_p = lanes(plan, geoms, wf.decode_lanes_to_planes)
        err_a = max(max_abs(torch, a, b) for a, b in zip(planes_k, planes_p))
        check(err_a == 0 and torch.equal(err_k, err_p), f"{name}: kernel A with bit0/dc0 != plain ({err_a})")
        check(not err_k.any(), f"{name}: decode errors {err_k.nonzero().flatten().tolist()}")
        coef_k, err2_k, coef_p, err2_p = lanes(plan, geoms, wf.decode_lanes_to_coeffs)
        err_2 = max(max_abs(torch, a, b) for a, b in zip(coef_k, coef_p))
        check(err_2 == 0 and torch.equal(err2_k, err2_p), f"{name}: kernel 2 with bit0/dc0 != plain ({err_2})")
        idct_k = idct_planes(jpeg.frame, coef_k, qtabs_of(jpeg))
        check(all(torch.equal(a, b) for a, b in zip(idct_k, planes_k)),
              f"{name}: kernel 2 + kernel 6 planes != kernel A planes")
        out_k = color_fns["upsample_color_h2v2"][0](*cropped(jpeg.frame, planes_k))
        check(sha(out_k[0]) == manifest["fixtures"][name]["pil_sha256"], f"{name}: RGB != PIL")
        norst_err["wavefront_pixels"] = max(norst_err["wavefront_pixels"], err_a)
        norst_err["wavefront_coeff"] = max(norst_err["wavefront_coeff"], err_2)
        emit("kernel_vs_plain", fixture=name, images=1, plan="norst", lanes=plan.n_lanes, words=plan.n_words,
             every=plan.norst_every, kernel_a_max_abs_err=err_a, kernel_2_max_abs_err=err_2)
        del planes_k, planes_p, coef_k, coef_p, idct_k, out_k

    # The planar kernels on random planes: even widths, odd heights, and
    # row strides that are odd (byte loads) or even (16-bit loads).
    gen = torch.Generator().manual_seed(3)
    for cname, (h, w, pad) in (("upsample_color_h2v2", (1023, 2048, 0)), ("upsample_color_h2v2", (37, 50, 5)),
                               ("upsample_color_h2v1", (511, 1024, 0)), ("upsample_color_h2v1", (9, 130, 3))):
        hc = (h + 1) // 2 if cname == "upsample_color_h2v2" else h
        y = torch.randint(0, 256, (2, h, w + pad), generator=gen, dtype=torch.uint8).to(dev)[:, :, :w]
        cb, cr = (torch.randint(0, 256, (2, hc, w // 2 + pad), generator=gen, dtype=torch.uint8).to(dev)[:, :, : w // 2]
                  for _ in range(2))
        err = planar_vs_plain(cname, (y, cb, cr), color_fns[cname][0](y, cb, cr))
        emit("kernel_vs_plain", random_planes=[2, h, w], row_stride=w + pad, kernel=planar_fns[cname][0],
             max_abs_err=err)

    # Every color tile kernel at the tile edges (planar kernels: even
    # widths only), 3 images each, on random planes and on planes of 0 and
    # 255 only (every clamp): TILE_EDGES' widths, heights, row paddings
    # and a crop one column in.
    edge_err = {k: 0 for k in color_fns}
    for kname, (kern, plain) in color_fns.items():
        for h, w, ypad, cpad, off in TILE_EDGES:
            for fill in ("random", "0/255"):
                ins = edge_planes(torch, gen, dev, kname, h, w, ypad, cpad, off, fill)
                out_k = kern(*ins)
                torch.cuda.synchronize()
                err = max_abs(torch, out_k, plain(*ins))
                check(err == 0, f"{kname} != plain ({err}) at {(h, w, ypad, cpad, off, fill)}")
                edge_err[kname] = max(edge_err[kname], err)
                perr = planar_vs_plain(kname, ins, out_k) if kname in planar_fns and w % 2 == 0 else None
                emit("kernel_vs_plain", kernel=kname, tile_edge=[3, h, w], luma_row_stride=ins[0].stride(1),
                     chroma_row_stride=ins[1].stride(1), luma_offset=ins[0].storage_offset(), fill=fill,
                     max_abs_err=err, planar_max_abs_err=perr)

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    prog_err = {k: 0 for k in PROG_KERNEL.values()}

    def prog_vs_plain(jpegs):
        """Every scan of a progressive group: kernels 7-9 and their plain
        versions from the same state. Returns the kernels' state and the
        count of lanes with error bits."""
        steps = [st.to(dev) if isinstance(st, wp.ScanPlan) else st for st in wp.plan_scans(jpegs)]
        acs, dcs = wp.new_state(jpegs[0].frame, len(jpegs), dev)
        bad_lanes = 0
        for k, step in enumerate(steps):
            if isinstance(step, wp.DcRefine):
                wp.apply_step(step, acs, dcs)
                continue
            kname = PROG_KERNEL[step.kind]
            acs_p, dcs_p = [a.clone() for a in acs], [d.clone() for d in dcs]
            err_k, _ = wp.apply_step(step, acs, dcs)
            torch.cuda.synchronize()
            err_p, _ = wp.apply_step(step, acs_p, dcs_p, plain=True)
            diff = max(max_abs(torch, a, b) for a, b in zip(acs + dcs, acs_p + dcs_p))
            check(diff == 0 and torch.equal(err_k, err_p),
                  f"scan {k}: {kname} != plain (state {diff}, error bits equal: {torch.equal(err_k, err_p)})")
            prog_err[kname] = max(prog_err[kname], diff)
            bad_lanes += int((err_k != 0).sum())
        return acs, dcs, bad_lanes

    for name in progressive:
        jpegs = [parse(datas[name]) for _ in range(2)]
        acs, dcs, bad_lanes = prog_vs_plain(jpegs)
        check(bad_lanes == 0, f"{name}: {bad_lanes} lanes with errors")
        fr = jpegs[0].frame
        out = pipeline.transform_batch(fr, acs, qtabs_of(jpegs[0]), config,
                                       color=tpujpeg_torch.bitstream.color_space(jpegs[0]), dcs=dcs)
        for i in range(2):
            check(sha(out[i]) == manifest["fixtures"][name]["pil_sha256"], f"{name}: image {i} != PIL")
        emit("kernel_vs_plain", fixture=name, images=2, scans=len(jpegs[0].scans),
             max_abs_err={k: prog_err[k] for k in PROG_KERNEL.values()})
        del acs, dcs, out

    # A corrupted batch of 3: member 1's first AC-first payload filled
    # with 0xFF bytes (no valid code), member 2's AC-refine payloads with
    # seeded byte flips; restart offsets stay, so the lanes do too.
    name = "prog_gray"
    jpegs = [parse(datas[name]) for _ in range(3)]
    rng = np.random.default_rng(5)
    for k, scan in enumerate(jpegs[1].scans):
        if wp.scan_kind(scan) == "ac_first":
            scan.data = bytes([0xFF]) * len(scan.data)
            break
    for scan in jpegs[2].scans:
        if wp.scan_kind(scan) == "ac_refine":
            buf = np.frombuffer(bytes(scan.data), np.uint8).copy()
            pos = rng.integers(0, len(buf), size=4)
            buf[pos] ^= rng.integers(1, 256, size=4).astype(np.uint8)
            scan.data = buf.tobytes()
    _acs, _dcs, bad_lanes = prog_vs_plain(jpegs)
    check(bad_lanes > 0, "corrupted progressive batch: no lane reported an error")
    emit("kernel_vs_plain", fixture=name, images=3, corrupted=[1, 2], lanes_with_errors=bad_lanes,
         max_abs_err={k: prog_err[k] for k in PROG_KERNEL.values()})
    del _acs, _dcs

    # 4. main path: the counters cover the 4:2:0 batch's four calls alone.
    data = datas["420_2048"]
    t0 = time.perf_counter()
    jpegs = [parse(data) for _ in range(MAIN_BATCH)]
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = wf.build_block_plan(jpegs)
    t_plan = time.perf_counter() - t0
    walls = []
    build.LAUNCHES.clear()
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, failures = tpujpeg_torch.decode_batch_to_rgb(jpegs, device=dev)
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t0)
        check(not failures, f"main path failures: {failures}")
    main_launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
    want = manifest["fixtures"]["420_2048"]
    check(list(rgb.shape) == [MAIN_BATCH] + want["shape"], f"main path shape {tuple(rgb.shape)}")
    for i in (0, MAIN_BATCH - 1):
        check(sha(rgb[i]) == want["pil_sha256"], f"main path image {i} != PIL")
    mp = MAIN_BATCH * rgb.shape[1] * rgb.shape[2] / 1e6
    wall = statistics.median(walls)
    check(set(k for k, n in main_launches.items() if n) == {"wavefront_pixels", "upsample_color_h2v2"},
          f"main path launches {main_launches}")
    emit("main_path", images=MAIN_BATCH, megapixels=mp, calls=4, wall_s=walls, wall_median_s=wall,
         mp_per_s=mp / wall, parse_s=t_parse, host_plan_s=t_plan, launches=main_launches,
         lanes=plan.n_lanes, words=plan.n_words, rgb_bytes=rgb.numel())
    fused_rgb = rgb
    del rgb

    # The same entry on the other subsamplings: kernels C and D each run
    # on their own batch, counted apart from the main path.
    launches = dict(main_launches)
    others = {}
    for name, kname in (("422_2048", "upsample_color_h2v1"), ("444_2048", "color_444"), ("gray", None)):
        js = [parse(datas[name]) for _ in range(MAIN_BATCH)]
        build.LAUNCHES.clear()
        out, failures = tpujpeg_torch.decode_batch_to_rgb(js, device=dev)
        torch.cuda.synchronize()
        got = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
        check(not failures, f"{name}: failures {failures}")
        for i in (0, MAIN_BATCH - 1):
            check(sha(out[i]) == manifest["fixtures"][name]["pil_sha256"], f"{name}: image {i} != PIL")
        want_k = {"wavefront_pixels"} | ({kname} if kname else set())
        check(set(k for k, n in got.items() if n) == want_k, f"{name}: launches {got}")
        if kname:
            launches[kname] = got[kname]
        others[name] = js
        emit("batch", fixture=name, images=MAIN_BATCH, launches=got)

    # 5. staged: the same 32 streams through kernels 2, 6 and B.
    frame = jpegs[0].frame
    qtabs = qtabs_of(jpegs[0])
    walls = []
    build.LAUNCHES.clear()
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coeffs, failures = tpujpeg_torch.decode_batch_to_coeffs(jpegs, config, strict=False, device=dev)
        rgb = pipeline.transform_batch(frame, coeffs, qtabs, config)
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t0)
        check(not failures, f"staged failures: {failures}")
    staged_launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
    check(set(k for k, n in staged_launches.items() if n)
          == {"wavefront_coeff", "dequant_idct_islow", "upsample_color_h2v2"},
          f"staged launches {staged_launches}")
    check(torch.equal(rgb, fused_rgb), "staged RGB != fused main path RGB")
    for i in (0, MAIN_BATCH - 1):
        check(sha(rgb[i]) == want["pil_sha256"], f"staged image {i} != PIL")
    for k in ("wavefront_coeff", "dequant_idct_islow"):
        launches[k] = staged_launches[k]
    coeff_bytes = sum(c.numel() * 4 for c in coeffs)
    blocks = sum(c.shape[0] * c.shape[1] for c in coeffs)
    symbols = sum(int(c.shape[0] * c.shape[1] + (c[..., 1:] != 0).sum() + (c[..., 63] == 0).sum())
                  for c in coeffs)
    wall = statistics.median(walls)
    emit("staged", images=MAIN_BATCH, megapixels=mp, calls=4, wall_s=walls, wall_median_s=wall,
         mp_per_s=mp / wall, host_plan_s=t_plan, launches=staged_launches, coeff_bytes=coeff_bytes,
         blocks=blocks, symbols_lower_bound=symbols)
    del rgb

    # 6. progressive: the same image, progressive with restarts, through
    # kernels 7-9, then 6 and B.
    pjpegs = [parse(datas[PROG_MAIN]) for _ in range(MAIN_BATCH)]
    pframe = pjpegs[0].frame
    t0 = time.perf_counter()
    psteps = wp.plan_scans(pjpegs)
    t_pplan = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k, scan in enumerate(pjpegs[0].scans):
        if wp.scan_kind(scan) == "dc_refine":
            wp.build_dc_refine(pjpegs, k)
    t_masks = time.perf_counter() - t0
    kernel_steps = [st for st in psteps if isinstance(st, wp.ScanPlan)]
    per_call = collections.Counter(PROG_KERNEL[st.kind] for st in kernel_steps)
    per_call["dequant_idct_islow"] = pframe.n_components
    color_kernel = {((1, 1), (2, 2), (2, 2)): "upsample_color_h2v2",
                    ((1, 1), (2, 1), (2, 1)): "upsample_color_h2v1",
                    ((1, 1), (1, 1), (1, 1)): "color_444"}.get(
        tuple((pframe.hmax // c.h, pframe.vmax // c.v) for c in pframe.components))
    if color_kernel:
        per_call[color_kernel] = 1
    walls = []
    build.LAUNCHES.clear()
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prgb, playout, failures = tpujpeg_torch.decode_all_scans_to_rgb_batch(pjpegs, config, device=dev)
        torch.cuda.synchronize()
        check(playout == "nhwc", f"progressive layout {playout}")
        if i:
            walls.append(time.perf_counter() - t0)
        check(not failures, f"progressive failures: {failures}")
    prog_launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
    check({k: n for k, n in prog_launches.items() if n} == {k: 4 * n for k, n in per_call.items()},
          f"progressive launches {prog_launches}, want 4 x {dict(per_call)}")
    check(torch.equal(prgb, fused_rgb), "progressive RGB != fused main path RGB")
    for i in (0, MAIN_BATCH - 1):
        check(sha(prgb[i]) == manifest["fixtures"][PROG_MAIN]["pil_sha256"], f"progressive image {i} != PIL")
    for k in PROG_KERNEL.values():
        launches[k] = prog_launches[k]
    wall = statistics.median(walls)
    state_bytes = sum(c.padded_hb * c.padded_wb * 65 * 4 for c in pframe.components) * MAIN_BATCH
    emit("progressive", fixture=PROG_MAIN, images=MAIN_BATCH, megapixels=mp, calls=4, wall_s=walls,
         wall_median_s=wall, mp_per_s=mp / wall, host_plan_s=t_pplan, dc_refine_masks_s=t_masks,
         launches=prog_launches,
         per_call=dict(per_call), scans=len(psteps),
         lanes_per_scan=[st.n_lanes if isinstance(st, wp.ScanPlan) else None for st in psteps],
         words_per_scan=[st.n_words if isinstance(st, wp.ScanPlan) else None for st in psteps],
         state_bytes=state_bytes,
         dc_refine_ors=sum(len(st.comp_indices) for st in psteps if isinstance(st, wp.DcRefine)))
    main_image = fused_rgb[0].clone()
    del prgb, fused_rgb

    # The table-set group: the distinct tables of each kernel scan, from
    # the files' own bytes (scan_group_key), against the plans' sets.
    tsets = [n for n in progressive if n.startswith("prog_tsets_")]
    tjpegs = [parse(datas[n]) for n in tsets]
    want_sets = [len({wp.scan_group_key(j)[3 + k][-1] for j in tjpegs})
                 for k, s in enumerate(tjpegs[0].scans) if wp.scan_kind(s) != "dc_refine"]
    spans.drain()
    with spans.adopt(0):
        _acs, _dcs, bad_lanes = prog_vs_plain(tjpegs)
        trgb, _layout, failures = tpujpeg_torch.decode_all_scans_to_rgb_batch(tjpegs, config, device=dev)
    counts = [r.n for r in spans.drain() if r.name == spans.PROG_TSETS]
    check(len(tsets) == 3 and max(want_sets) == 3, f"table-set fixtures {tsets}: sets {want_sets}")
    check(bad_lanes == 0 and not failures, f"table-set group: {bad_lanes} lanes with errors, {failures}")
    check(counts == want_sets * 2, f"prog_tsets counts {counts}, want {want_sets} for each of two runs")
    for i, n in enumerate(tsets):
        check(sha(trgb[i]) == manifest["fixtures"][n]["pil_sha256"], f"table-set group: {n} != PIL")
    emit("progressive_table_sets", fixtures=tsets, table_sets=want_sets, prog_tsets=counts,
         max_abs_err={k: prog_err[k] for k in PROG_KERNEL.values()})
    del _acs, _dcs, trgb

    # 7. norst: the marker-free fixture through the norst entries, each
    # path counted apart; every run parses anew outside the clock, so the
    # wall holds the host split (destuff, skeleton walk, rows) too.
    ndata = datas[NORST_MAIN]
    nwant = manifest["fixtures"][NORST_MAIN]["pil_sha256"]
    color_space = tpujpeg_torch.bitstream.color_space
    split_s = []
    for i in range(4):
        j = parse(ndata)
        t0 = time.perf_counter()
        nplan = wf.build_norst_plan(j)
        if i:
            split_s.append(time.perf_counter() - t0)
    norst_launches = collections.Counter()

    def norst_path(label, fn, per_call, raster=lambda out: out):
        walls = []
        build.LAUNCHES.clear()
        for i in range(4):
            j = parse(ndata)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(j)
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
            check(sha(raster(out)) == nwant, f"norst {label}: run {i} != PIL")
        got = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
        check({k: n for k, n in got.items() if n} == {k: 4 * n for k, n in per_call.items()},
              f"norst {label}: launches {got}, want 4 x {per_call}")
        norst_launches.update(got)
        emit("norst", fixture=NORST_MAIN, path=label, calls=4, wall_s=walls,
             wall_median_s=statistics.median(walls), mp_per_s=2048 * 2048 / 1e6 / statistics.median(walls),
             launches={k: n for k, n in got.items() if n}, out_dtype=str(out.dtype), out_shape=list(out.shape))

    norst_path("rgb_nhwc", lambda j: tpujpeg_torch.decode_norst_to_rgb(j, config, device=dev),
               {"wavefront_pixels": 1, "upsample_color_h2v2": 1})
    norst_path("rgb_packed16", lambda j: tpujpeg_torch.decode_norst_to_rgb(j, config, packed=True, device=dev),
               {"wavefront_pixels": 1, "upsample_color_h2v2_planar": 1}, lambda out: planar_bytes(torch, out))
    norst_path("coeff_transform",
               lambda j: pipeline.transform_frame(j.frame, tpujpeg_torch.decode_norst_to_device(j, config, device=dev),
                                                  qtabs_of(j), config, color=color_space(j)),
               {"wavefront_coeff": 1, "dequant_idct_islow": 3, "upsample_color_h2v2": 1})
    norst_path("rgb_every_1", lambda j: tpujpeg_torch.decode_norst_to_rgb(j, config, every=1, device=dev),
               {"wavefront_pixels": 1, "upsample_color_h2v2": 1})
    for k, n in norst_launches.items():
        launches[k] = launches.get(k, 0) + n

    # Kernels A and 2 alone on the norst plans (default every and every=1),
    # beside their plain versions and bounds (the rules beside OPS_SYMBOL:
    # the payload read once, the outputs written once, symbols counted
    # from the coefficients).
    njpeg = parse(ndata)
    ncoef = tpujpeg_torch.decode_norst_to_device(njpeg, config, device=dev)
    n_blocks = sum(c.shape[0] for c in ncoef)
    n_symbols = sum(int(c.shape[0] + (c[:, 1:] != 0).sum() + (c[:, 63] == 0).sum()) for c in ncoef)
    n_coeff_bytes = sum(c.numel() * 4 for c in ncoef)
    del ncoef
    nlayout = wf.PlaneLayout.of(wf.ImageGeom.of(njpeg))
    norst_timing = {"wavefront_pixels": {}, "wavefront_coeff": {}}
    for key, every in (("default", 0), ("every_1", 1)):
        pl = wf.build_norst_plan(parse(ndata), every)
        pd_n = pl.to(dev)
        err_n = torch.zeros(pl.n_lanes, dtype=torch.int32, device=dev)
        payload = int((pl.seg_bits.to(torch.int64) - pl.bit0).sum()) // 8
        for kname, emit_kind in (("wavefront_pixels", "pixels"), ("wavefront_coeff", "coeff")):
            outs = nlayout.alloc(1, dev, emit_kind)
            out_bytes = sum(o.numel() * o.element_size() for o in outs)
            ops = n_symbols * OPS_SYMBOL + (n_blocks * OPS_IDCT_BLOCK if emit_kind == "pixels" else 0)
            b_ms, b_by = bound(payload + out_bytes, ops)
            norst_timing[kname][key] = dict(
                ms=device_ms(torch, lambda: wf._launch_wavefront(pd_n, nlayout, outs, err_n, emit_kind), 10),
                plain_ms=cuda_ms(torch, lambda: wf.decode_lanes_plain(pd_n, nlayout, outs, err_n, emit_kind), 1),
                bound_ms=b_ms, bound_by=b_by, lanes=pl.n_lanes, words=pl.n_words, every=pl.norst_every,
                ctas=-(-pl.n_lanes // 128), payload_bytes=payload, out_bytes=out_bytes)
            check(not err_n.any(), f"norst {key}: {kname} error bits on the timing run")
            del outs
        del pd_n, err_n
    emit("norst_rates", fixture=NORST_MAIN, host_split_s=split_s, host_split_median_s=statistics.median(split_s),
         lanes=nplan.n_lanes, words=nplan.n_words, every=nplan.norst_every, symbols=n_symbols, blocks=n_blocks,
         coeff_bytes=n_coeff_bytes, kernels=norst_timing)
    del nplan

    # 8. stream: 4 chunks of 32 copies of the main fixture through
    # decode_batch_pipelined, each layout counted apart.
    from tpujpeg_torch.parallel import stream as stream_mod

    want_sha = manifest["fixtures"]["420_2048"]["pil_sha256"]
    sdatas = [datas["420_2048"]] * (STREAM_CHUNKS * MAIN_BATCH)
    smp = len(sdatas) * main_image.shape[0] * main_image.shape[1] / 1e6
    workers = min(3, os.cpu_count() or 1)
    scfg = tpujpeg_torch.DecodeConfig(to_numpy=False)
    main_planar = main_image.permute(2, 0, 1).contiguous().view(torch.uint16)
    stream_walls = {}
    stream_launches = {}
    for layout, nw in (("packed16", workers), ("nhwc", workers), ("packed16", 1)):
        color = "upsample_color_h2v2_planar" if layout == "packed16" else "upsample_color_h2v2"
        walls = []
        for i in range(4):
            if i == 1:
                build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = tpujpeg_torch.decode_batch_pipelined(sdatas, scfg, chunk_size=MAIN_BATCH, depth=2,
                                                       prep_workers=nw, layout=layout, device=dev)
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
            check(not res.errors, f"stream {layout}: failures {res.errors}")
            check({st.entropy_engine for st in res.stats} == {"wavefront-fused"}
                  and {st.transform_engine for st in res.stats} == {"cuda"},
                  f"stream {layout}: engines {set((st.entropy_engine, st.transform_engine) for st in res.stats)}")
        got = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
        check({k: n for k, n in got.items() if n} == {"wavefront_pixels": 3 * STREAM_CHUNKS, color: 3 * STREAM_CHUNKS},
              f"stream {layout}: launches {got}")
        want_img = main_planar if layout == "packed16" else main_image
        check(all(img.dtype == want_img.dtype and torch.equal(img, want_img) for img in res.images),
              f"stream {layout}: an image differs from the main path's RGB")
        last = res.images[-1] if layout == "nhwc" else planar_bytes(torch, res.images[-1])
        check(sha(last) == want_sha, f"stream {layout}: image != PIL")
        key = f"{layout}_{nw}_workers"
        stream_walls[key] = walls
        if nw == workers:
            stream_launches[layout] = got
        emit("stream", layout=layout, prep_workers=nw, images=len(sdatas), chunk_size=MAIN_BATCH, depth=2,
             megapixels=smp, wall_s=walls, wall_median_s=statistics.median(walls),
             mp_per_s=smp / statistics.median(walls), launches=got, cpu_count=os.cpu_count(),
             image_dtype=str(res.images[0].dtype), image_shape=list(res.images[0].shape))
        del res
    launches["upsample_color_h2v2_planar"] = (launches.get("upsample_color_h2v2_planar", 0)
                                              + stream_launches["packed16"]["upsample_color_h2v2_planar"])

    # Pinned against pageable plans: the same packed16 stream with the prep
    # threads' planner writing pageable rows, runs alternated after one
    # warm-up each.
    real_prep = stream_mod._prep
    pin_walls = {"pinned": [], "pageable": []}
    for i, plans_in in enumerate(["pinned", "pageable"] * 4):
        if plans_in == "pageable":
            stream_mod._prep = lambda datas_, members, _pin, *trace: real_prep(datas_, members, False, *trace)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = tpujpeg_torch.decode_batch_pipelined(sdatas, scfg, chunk_size=MAIN_BATCH, depth=2,
                                                       prep_workers=workers, layout="packed16", device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            stream_mod._prep = real_prep
        if i >= 2:
            pin_walls[plans_in].append(wall)
        check(not res.errors and all(torch.equal(img, main_planar) for img in res.images),
              f"stream {plans_in}: an image differs from the main path's RGB")
        del res
    emit("stream_pinning", layout="packed16", prep_workers=workers, wall_s=pin_walls,
         wall_median_s={k: statistics.median(v) for k, v in pin_walls.items()},
         mp_per_s={k: smp / statistics.median(v) for k, v in pin_walls.items()})

    # The host-prep stage alone on one thread (parse, pinned plan), and the
    # device-only rate: plans built and on the card before the clock.
    chunks = [list(range(c * MAIN_BATCH, (c + 1) * MAIN_BATCH)) for c in range(STREAM_CHUNKS)]
    t0 = time.perf_counter()
    units = [stream_mod._prep(sdatas, m, True) for m in chunks]
    t_prep = time.perf_counter() - t0
    dev_plans = [(g.plan.to(dev), g.jpegs) for u in units for g in u.groups]
    # The same stage split: parse, then the plan into pageable and into
    # pinned memory (one thread, 4 chunks).
    t0 = time.perf_counter()
    parsed = [[parse(sdatas[i]) for i in m] for m in chunks]
    t_parse4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    plans = [wf.build_block_plan(js) for js in parsed]
    t_plan4 = time.perf_counter() - t0
    del plans
    t0 = time.perf_counter()
    plans = [wf.build_block_plan(js, pin_memory=True) for js in parsed]
    t_plan_pinned4 = time.perf_counter() - t0
    del units, parsed, plans
    device_only = {}
    for layout in ("packed16", "nhwc"):
        runs = []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [wf.decode_group_to_rgb(pl, js, scfg, dev, packed=layout == "packed16") for pl, js in dev_plans]
            torch.cuda.synchronize()
            if i:
                runs.append(time.perf_counter() - t0)
            check(all(lay == layout and not err.any() for _rgb, lay, err in outs), f"device-only {layout}")
            del outs
        device_only[layout] = runs
    del dev_plans
    emit("stream_rates", host_prep_s_1_thread=t_prep, host_prep_mp_per_s_1_thread=smp / t_prep,
         split_1_thread_s=dict(parse=t_parse4, plan=t_plan4, plan_pinned=t_plan_pinned4),
         device_only_s=device_only,
         device_only_mp_per_s={k: smp / statistics.median(v) for k, v in device_only.items()},
         cpu_count=os.cpu_count(), megapixels=smp)

    # The 4:2:2 planar kernel on its own packed16 stream chunk.
    d422 = datas["422_2048"]
    build.LAUNCHES.clear()
    chunk = next(iter(tpujpeg_torch.decode_stream([d422] * MAIN_BATCH, scfg, chunk_size=MAIN_BATCH,
                                                  layout="packed16", device=dev)))
    torch.cuda.synchronize()
    got = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
    check({k: n for k, n in got.items() if n} == {"wavefront_pixels": 1, "upsample_color_h2v1_planar": 1},
          f"stream 4:2:2 packed16: launches {got}")
    check(chunk.layout == "packed16" and not chunk.failures, "stream 4:2:2: not packed16")
    for img in (chunk.images[0], chunk.images[-1]):
        check(sha(planar_bytes(torch, img)) == manifest["fixtures"]["422_2048"]["pil_sha256"],
              "stream 4:2:2 != PIL")
    launches["upsample_color_h2v1_planar"] = launches.get("upsample_color_h2v1_planar", 0) + got[
        "upsample_color_h2v1_planar"]
    emit("stream", fixture="422_2048", layout="packed16", images=MAIN_BATCH, launches=got)
    del chunk

    # One stream chunk of the imagenet_shard sizes (SHARD_CHUNK): crops of
    # the main fixture, q85 4:2:0 with a restart every 4 MCUs, in the
    # configuration's cycle of sizes. Its four geometry buckets combine
    # into one plan, which kernel A's mixed form decodes in one launch,
    # equal to the plain version of that plan and to each bucket's own
    # launch; then the same images through decode_stream as one chunk.
    from tpujpeg_torch.fixtures.tile import crop_jpeg

    mdatas, msizes = shard_chunk(crop_jpeg, datas["420_2048"])
    by_size = {}
    for md, mwh in zip(mdatas, msizes):
        by_size.setdefault(mwh, []).append(parse(md))
    mgroups, mrefused = wf.plan_launches([j for js in by_size.values() for j in js], pin_memory=True)
    check(len(mgroups) == 1 and not mrefused, f"shard chunk: {len(mgroups)} launch groups, refused {mrefused}")
    mbuckets, combined = mgroups[0].jpegs, mgroups[0].plan
    check([len(js) for js in mbuckets] == [len(js) for js in by_size.values()], "shard chunk: buckets differ")
    mplans = [wf.build_block_plan(js) for js in mbuckets]
    mlays = [part.layout for part in combined.parts]
    build.LAUNCHES.clear()
    mparts, merr = wf.decode_lanes_to_planes(combined.to(dev, non_blocking=True), None, dev)
    torch.cuda.synchronize()
    got = {k: n for k, n in build.LAUNCHES.items() if n}
    check(got == {"wavefront_pixels_mixed": 1}, f"shard chunk: launches {got}")
    check(not merr.any(), f"shard chunk: error bits on lanes {merr.nonzero().flatten().tolist()[:8]}")
    pparts, perr = wf.decode_lanes_to_planes(combined.to(dev), None, dev, plain=True)
    torch.cuda.synchronize()
    mixed_err = max(max_abs(torch, a, b) for ks, ps in zip(mparts, pparts) for a, b in zip(ks, ps))
    check(mixed_err == 0 and torch.equal(merr, perr), f"shard chunk: mixed kernel A != plain ({mixed_err})")
    del pparts
    lane0 = 0
    for mjs, mplan, mpart in zip(mbuckets, mplans, mparts):
        alone, aerr = wf.decode_lanes_to_planes(mplan, [wf.ImageGeom.of(j) for j in mjs], dev)
        check(all(torch.equal(a, b) for a, b in zip(mpart, alone))
              and torch.equal(aerr, merr[lane0:lane0 + mplan.n_lanes]),
              f"shard chunk: the mixed launch != the {tuple(alone[0].shape)} bucket's launch")
        lane0 += mplan.n_lanes
    launches["wavefront_pixels_mixed"] = got["wavefront_pixels_mixed"]
    del mparts, alone, aerr, mpart
    mref = tpujpeg_torch.decode_batch_on_device(mdatas, scfg, device=dev)
    check(not mref.errors, f"shard chunk: decode_batch_on_device failures {mref.errors}")
    build.LAUNCHES.clear()
    mchunks = list(tpujpeg_torch.decode_stream(mdatas, scfg, chunk_size=len(mdatas), layout="packed16",
                                               device=dev))
    torch.cuda.synchronize()
    got = {k: n for k, n in build.LAUNCHES.items() if n}
    check(got == {"wavefront_pixels_mixed": 1, "upsample_color_h2v2_planar": len(mbuckets)},
          f"shard stream chunk: launches {got}")
    check([(c.engine, c.layout, bool(c.failures)) for c in mchunks] == [("wavefront-fused", "packed16", False)],
          f"shard stream chunk: {[(c.engine, c.layout, c.failures) for c in mchunks]}")
    for mk, mi in enumerate(mchunks[0].members):
        check(torch.equal(planar_bytes(torch, mchunks[0].images[mk]), mref.images[mi]),
              f"shard stream chunk: image {mi} != decode_batch_on_device's")
        if msizes[mi] == (2048, 2048):
            check(sha(mref.images[mi]) == want_sha, f"shard stream chunk: image {mi} != PIL")
    launches["wavefront_pixels_mixed"] += got["wavefront_pixels_mixed"]
    launches["upsample_color_h2v2_planar"] += got["upsample_color_h2v2_planar"]
    emit("stream_mixed", images=len(mdatas), buckets={f"{w}x{h}": len(js) for (w, h), js in by_size.items()},
         lanes=combined.n_lanes, words=combined.n_words, lanes_per_bucket=[p.n_lanes for p in mplans],
         launches=got, max_abs_err_vs_plain=mixed_err)
    del mchunks, mref

    # 9. batch: every fixture, a zeroed payload and bytes that are no JPEG.
    names = list(manifest["fixtures"])
    bdatas = [datas[n] for n in names] + [zero_payload(datas["420_odd"]), b"not a jpeg"]
    fill0 = next(f["error"] for f in manifest["faults"] if f["fill"] == 0)
    want_err = {len(names): fill0, len(names) + 1: "JpegSyntaxError"}
    # The rung each fixture must take on the device ladder: its path's
    # kernels (kernel A on the norst plan for the norst ones), kernel 2 per
    # scan for the multi-scan file, host entropy only for the marker-free
    # progressive stream. The fused fixtures of several sizes that share a
    # launch group take kernel A's mixed form.
    ladder = {n: BATCH_RUNG.get(n, PATH_RUNG.get(manifest["fixtures"][n]["path"])) for n in names}
    for fn, want_engines, want_kernels in (
            (tpujpeg_torch.decode_batch_on_device, ladder,
             {"wavefront_pixels", "wavefront_pixels_mixed", "wavefront_coeff", "dequant_idct_islow",
              "prog_dc_first", "prog_ac_first",
              "prog_ac_refine", "upsample_color_h2v2", "upsample_color_h2v1", "color_444"}),
            (tpujpeg_torch.decode_batch, {n: "native" for n in names},
             {"dequant_idct_islow", "upsample_color_h2v2", "upsample_color_h2v1", "color_444"})):
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(bdatas, config, device=dev)
        seconds = time.perf_counter() - t0
        got_err = {i: type(e).__name__ for i, e in res.errors.items()}
        check(got_err == want_err, f"{fn.__name__}: failures {got_err}, want {want_err}")
        for i, n in enumerate(names):
            check(hashlib.sha256(res.images[i].tobytes()).hexdigest() == manifest["fixtures"][n]["pil_sha256"],
                  f"{fn.__name__}: {n} != PIL")
        engines = {n: res.stats[i].entropy_engine for i, n in enumerate(names)}
        check(engines == want_engines, f"{fn.__name__}: entropy engines {engines}, want {want_engines}")
        check({res.stats[i].transform_engine for i in range(len(names))} == {"cuda"},
              f"{fn.__name__}: transform engines")
        ran = {k for k, n in build.LAUNCHES.items() if n}
        check(ran == want_kernels, f"{fn.__name__}: kernels launched {sorted(ran)}, want {sorted(want_kernels)}")
        emit("batch", entry=fn.__name__, images=len(bdatas), seconds=seconds, failures=got_err,
             entropy_engines=engines, launches={k: n for k, n in build.LAUNCHES.items() if n})
    del res

    # 10. Each kernel against its plain version on the main path's inputs.
    results = {}
    geoms = [wf.ImageGeom.of(j) for j in jpegs]
    layout = wf.PlaneLayout.of(geoms[0])
    pd = plan.to(dev)
    row_bytes = int(plan.seg_bits.to(torch.int64).sum()) // 8
    err_s = torch.zeros(plan.n_lanes, dtype=torch.int32, device=dev)
    decode_ops = symbols * OPS_SYMBOL
    lane_shape = (f"{plan.n_lanes} lanes x {plan.n_words} words, {plan.blocks_per_mcu} blocks/MCU, "
                  f"{plan.n_mcus} MCUs/lane")

    planes_k, err_k, planes_p, err_p = lanes(plan, geoms, wf.decode_lanes_to_planes)
    err_a = max(max_abs(torch, a, b) for a, b in zip(planes_k, planes_p))
    check(err_a == 0 and torch.equal(err_k, err_p), f"main path: kernel A != plain ({err_a})")
    del planes_p
    scratch = layout.alloc(len(geoms), dev)
    results["wavefront_pixels"] = dict(
        max_abs_err=err_a,
        ms=device_ms(torch, lambda: wf._launch_wavefront(pd, layout, scratch, err_s), 5),
        plain_ms=cuda_ms(torch, lambda: wf.decode_lanes_plain(pd, layout, scratch, err_s), 1),
        shape=lane_shape,
        bound=bound(row_bytes + sum(p.numel() for p in planes_k), decode_ops + blocks * OPS_IDCT_BLOCK),
    )
    del scratch

    # Kernel A's mixed form on the shard chunk's combined plan, one launch,
    # beside the four bucket launches of the one-geometry form; its bound
    # counts the chunk's symbols from kernel 2's coefficients per bucket.
    mcoef = [wf.decode_lanes_to_coeffs(p, [wf.ImageGeom.of(j) for j in js], dev)[0]
             for js, p in zip(mbuckets, mplans)]
    m_blocks = sum(c.shape[0] * c.shape[1] for cs in mcoef for c in cs)
    m_symbols = sum(int(c.shape[0] * c.shape[1] + (c[..., 1:] != 0).sum() + (c[..., 63] == 0).sum())
                    for cs in mcoef for c in cs)
    del mcoef
    cd = combined.to(dev)
    m_flat = [torch.zeros(cd.parts[-1].end(sp), dtype=torch.uint8, device=dev) for sp in range(len(mlays[0].comp))]
    m_err = torch.zeros(cd.n_lanes, dtype=torch.int32, device=dev)
    b_dev = [(p.to(dev), lay, lay.alloc(p.n_images, dev), torch.zeros(p.n_lanes, dtype=torch.int32, device=dev))
             for p, lay in zip(mplans, mlays)]
    results["wavefront_pixels_mixed"] = dict(
        max_abs_err=mixed_err,
        ms=device_ms(torch, lambda: wf._launch_wavefront(cd, mlays[0], m_flat, m_err), 5),
        plain_ms=cuda_ms(torch, lambda: wf.decode_lanes_plain(cd, mlays[0], m_flat, m_err), 1),
        bucket_launches_ms=device_ms(torch, lambda: [wf._launch_wavefront(*b) for b in b_dev], 5),
        shape=(f"{cd.n_lanes} lanes x {cd.n_words} words, {cd.n_images} images in {len(mplans)} geometries "
               f"({', '.join(f'{w}x{h}' for w, h in by_size)}), {cd.blocks_per_mcu} blocks/MCU"),
        bound=bound(int(cd.seg_bits.to(torch.int64).sum()) // 8 + sum(t.numel() for t in m_flat),
                    m_symbols * OPS_SYMBOL + m_blocks * OPS_IDCT_BLOCK),
    )
    del cd, m_flat, m_err, b_dev, combined, mplans, mgroups

    coef_k, err2_k, coef_p, err2_p = lanes(plan, geoms, wf.decode_lanes_to_coeffs)
    err_2 = max(max_abs(torch, a, b) for a, b in zip(coef_k, coef_p))
    check(err_2 == 0 and torch.equal(err2_k, err2_p), f"main path: kernel 2 != plain ({err_2})")
    del coef_p
    scratch = layout.alloc(len(geoms), dev, "coeff")
    results["wavefront_coeff"] = dict(
        max_abs_err=err_2,
        ms=device_ms(torch, lambda: wf._launch_wavefront(pd, layout, scratch, err_s, "coeff"), 5),
        plain_ms=cuda_ms(torch, lambda: wf.decode_lanes_plain(pd, layout, scratch, err_s, "coeff"), 1),
        shape=lane_shape,
        bound=bound(row_bytes + coeff_bytes, decode_ops),
    )
    del scratch

    idct_k = idct_planes(frame, coef_k, qtabs)
    torch.cuda.synchronize()
    idct_p = idct_planes(frame, coef_k, qtabs, plain=True)
    err_6 = max(max_abs(torch, a, b) for a, b in zip(idct_k, idct_p))
    check(err_6 == 0 and all(torch.equal(a, b) for a, b in zip(idct_k, planes_k)),
          f"main path: kernel 6 != plain or != kernel A ({err_6})")
    del idct_p
    results["dequant_idct_islow"] = dict(
        max_abs_err=err_6,
        ms=device_ms(torch, lambda: idct_planes(frame, coef_k, qtabs), 10),
        plain_ms=cuda_ms(torch, lambda: idct_planes(frame, coef_k, qtabs, plain=True), 1),
        shape=" + ".join(f"{tuple(c.shape)}" for c in coef_k) + " int32, one launch per component",
        bound=bound(coeff_bytes + sum(p.numel() for p in idct_k), blocks * OPS_IDCT_BLOCK),
    )
    del coef_k, idct_k

    def color_timing(kname, fr, planes, label):
        """The color kernel kname (and its planar kernel, if any) on the
        cropped planes against its plain version: timing dicts keyed by
        kernel name."""
        kern, plain = color_fns[kname]
        ins = cropped(fr, planes)
        out_k = kern(*ins)
        out_p = plain(*ins)
        err = max_abs(torch, out_k, out_p)
        check(err == 0, f"{kname}: kernel != plain on {label}")
        b_ms, b_by = bound(sum(t.numel() for t in ins) + out_k.numel(),
                           (out_k.numel() // 3) * OPS_COLOR_PIXEL[kname])
        timed = {kname: dict(
            max_abs_err=err, ms=device_ms(torch, lambda: kern(*ins), 10),
            plain_ms=cuda_ms(torch, lambda: plain(*ins), 3), bound_ms=b_ms, bound_by=b_by,
            shape=f"{label}: {tuple(ins[0].shape)} luma, {tuple(ins[1].shape)} chroma -> {tuple(out_k.shape)}")}
        if kname in planar_fns:
            pname, pkern, pplain = planar_fns[kname]
            out_pk = pkern(*ins)
            torch.cuda.synchronize()
            err = max_abs(torch, out_pk, pplain(*ins))
            check(err == 0 and torch.equal(planar_bytes(torch, out_pk), out_k),
                  f"{pname}: kernel != plain or != {kname}'s bytes on {label}")
            timed[pname] = dict(
                max_abs_err=err, ms=device_ms(torch, lambda: pkern(*ins), 10),
                plain_ms=cuda_ms(torch, lambda: pplain(*ins), 3), bound_ms=b_ms, bound_by=b_by,
                shape=f"{label}: {tuple(ins[0].shape)} luma, {tuple(ins[1].shape)} chroma -> uint16 "
                      f"{tuple(out_pk.shape)}")
        return timed

    def a_planes(js):
        """Kernel A's planes of a parsed batch."""
        return js[0].frame, wf.decode_lanes_to_planes(wf.build_block_plan(js), [wf.ImageGeom.of(j) for j in js],
                                                      dev)[0]

    # Kernel B on the main path's planes; C, D and the 4:2:2 planar kernel
    # on kernel A's planes of the 2048^2 batches, and again ("small") on
    # 32 copies of the 384x512 fixtures.
    timed = color_timing("upsample_color_h2v2", frame, planes_k, "420_2048")
    for name, small, kname in (("422_2048", "422", "upsample_color_h2v1"), ("444_2048", "444", "color_444")):
        timed.update(color_timing(kname, *a_planes(others[name]), name))
        for k, r in color_timing(kname, *a_planes([parse(datas[small]) for _ in range(MAIN_BATCH)]),
                                 small).items():
            timed[k]["small"] = r
    for k, r in timed.items():
        r["max_abs_err"] = max(r["max_abs_err"], edge_err.get(k, 0), planar_err.get(k, 0),
                               r.get("small", {}).get("max_abs_err", 0))
        r["bound"] = (r.pop("bound_ms"), r.pop("bound_by"))
        results[k] = r
    del timed, others

    # tools/color_probe.py's and color_profile.py's A/B: kernel B and the
    # 4:2:0 planar kernel on random 32 x 2048^2 planes; C, the 4:2:2 planar
    # kernel and D on random planes of the same luma size, each held to
    # its plain version there.
    g = torch.Generator(device=dev).manual_seed(11)
    for kname, (kern, plain) in color_fns.items():
        shapes = [(AB_SIZE, AB_SIZE)] + [CHROMA_SHAPE[kname](AB_SIZE, AB_SIZE)] * 2
        ab_ins = [torch.randint(0, 256, (MAIN_BATCH, *hw), generator=g, dtype=torch.uint8, device=dev)
                  for hw in shapes]
        out_k = kern(*ab_ins)
        torch.cuda.synchronize()
        err = max_abs(torch, out_k, plain(*ab_ins))
        check(err == 0, f"{kname} != plain on random {AB_SIZE}^2 planes ({err})")
        rec = {f"{kname}_ms": device_ms(torch, lambda: kern(*ab_ins), 10)}
        if kname in planar_fns:
            err = max(err, planar_vs_plain(kname, ab_ins, out_k))
            pname, pkern, _pplain = planar_fns[kname]
            rec[f"{pname}_ms"] = device_ms(torch, lambda: pkern(*ab_ins), 10)
        del out_k
        results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"], err)
        ab_bound = bound(sum(t.numel() for t in ab_ins) + MAIN_BATCH * AB_SIZE * AB_SIZE * 3,
                         MAIN_BATCH * AB_SIZE * AB_SIZE * OPS_COLOR_PIXEL[kname])
        emit("kernel_timing_ab", planes=f"random {MAIN_BATCH} x {AB_SIZE}^2 luma, {MAIN_BATCH} x {shapes[1]} chroma",
             max_abs_err=err, bound_ms=ab_bound[0], bound_by=ab_bound[1], **rec)
        del ab_ins

    # tools/tail_variants.py's tail split on the main path's plan: kernel A
    # alone, A + B, and A + the planar kernel (bounds: the sums of theirs).
    scratch = layout.alloc(len(geoms), dev)
    tail_ins = cropped(frame, scratch)

    def kernel_a():
        wf._launch_wavefront(pd, layout, scratch, err_s)

    a_bound, c_bound = results["wavefront_pixels"]["bound"][0], results["upsample_color_h2v2"]["bound"][0]
    emit("tail_split", fixture="420_2048", images=MAIN_BATCH,
         a_ms=device_ms(torch, kernel_a, 5),
         a_b_ms=device_ms(torch, lambda: (kernel_a(), sc.upsample_color_h2v2(*tail_ins)), 5),
         a_planar_ms=device_ms(torch, lambda: (kernel_a(), sc.upsample_color_h2v2_packed(*tail_ins)), 5),
         a_bound_ms=a_bound, a_color_bound_ms=a_bound + c_bound)
    del scratch, tail_ins, planes_k

    # Kernels 7-9 at batch 32, scan by scan: the plain version runs once
    # on a copy of the scan's input state, each timed launch from that
    # input state (restored before every rep; device_ms, then with the
    # window opened on an idle card, the wrapper's host time included),
    # then the state, moved on to the kernel's output, and the error bits
    # must equal the plain version's.
    def run_scan(plan, target, err, plain=False):
        if plan.kind == "dc_first":
            wp.dc_first(plan, target, err, plain=plain)
        elif plan.kind == "ac_first":
            wp.ac_first(plan, target[0], err, plain=plain)
        else:
            wp.ac_refine(plan, target[0], err, plain=plain)

    acs, dcs = wp.new_state(pframe, MAIN_BATCH, dev)
    prog_ms = {k: 0.0 for k in PROG_KERNEL.values()}
    prog_plain_ms = {k: 0.0 for k in PROG_KERNEL.values()}
    prog_wrapper_ms = {k: 0.0 for k in PROG_KERNEL.values()}
    prog_err32 = {k: 0 for k in PROG_KERNEL.values()}
    prog_bytes = {k: 0 for k in PROG_KERNEL.values()}
    prog_ops = {k: 0 for k in PROG_KERNEL.values()}
    prog_scans = collections.Counter()
    for step in psteps:
        if isinstance(step, wp.DcRefine):
            wp.apply_step(step, acs, dcs)
            continue
        plan = step.to(dev)
        kname = PROG_KERNEL[plan.kind]
        err_s = torch.zeros(plan.n_lanes, dtype=torch.int32, device=dev)
        target = dcs if plan.kind == "dc_first" else [acs[plan.comp_indices[0]]]
        before = [t.clone() for t in target]
        want = [t.clone() for t in target]
        err_p = torch.zeros_like(err_s)
        torch.cuda.synchronize()
        start, end = events()
        start.record()
        run_scan(plan, want, err_p, plain=True)
        end.record()
        torch.cuda.synchronize()
        prog_plain_ms[kname] += start.elapsed_time(end)

        def restore():
            for t, b in zip(target, before):
                t.copy_(b)

        prog_ms[kname] += device_ms(torch, lambda: run_scan(plan, target, err_s), 3, restore)
        reps = []
        for _ in range(3):
            restore()
            torch.cuda.synchronize()
            start, end = events()
            start.record()
            run_scan(plan, target, err_s)
            end.record()
            torch.cuda.synchronize()
            reps.append(start.elapsed_time(end))
        diff = max(max_abs(torch, a, b) for a, b in zip(target, want))
        check(diff == 0 and torch.equal(err_s, err_p),
              f"batch {MAIN_BATCH}: {kname} != plain (state {diff}, "
              f"error bits equal: {torch.equal(err_s, err_p)})")
        check(not err_s.any(), f"{kname}: error bits on the timing run")
        prog_err32[kname] = max(prog_err32[kname], diff)
        prog_wrapper_ms[kname] += statistics.mean(reps)
        nbytes, ops = prog_work(torch, plan, pframe, before[0], target[0])
        prog_bytes[kname] += nbytes
        prog_ops[kname] += ops
        prog_scans[kname] += 1
        del before, want
    for scan_kind, kname in PROG_KERNEL.items():
        lanes_k = sum(st.n_lanes for st in kernel_steps if st.kind == scan_kind)
        results[kname] = dict(
            max_abs_err=prog_err32[kname], ms=prog_ms[kname], ms_with_wrapper=prog_wrapper_ms[kname],
            plain_ms=prog_plain_ms[kname], launches_timed=prog_scans[kname],
            shape=(f"{prog_scans[kname]} {scan_kind} scans of {MAIN_BATCH} x {PROG_MAIN}, {lanes_k} lanes in all, "
                   f"ms and plain_ms summed over the scans"),
            bound=bound(prog_bytes[kname], prog_ops[kname]),
        )
    del acs, dcs
    for k, r in results.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    for k, per_plan in norst_timing.items():
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"], norst_err[k])
        results[k]["norst"] = per_plan
    for k, r in results.items():
        emit("kernel_timing", kernel=k, **r)

    # 11. faults
    for fault in manifest["faults"]:
        data = datas[fault["fixture"]]
        js = [parse(data) for _ in range(fault["batch"])]
        scan = js[fault["member"]].scans[0]
        scan.data = bytes([fault["fill"]]) * len(scan.data)
        out, failures = tpujpeg_torch.decode_batch_to_rgb(js, device=dev)
        got = {i: type(e).__name__ for i, e in failures.items()}
        check(got == {fault["member"]: fault["error"]}, f"fault {fault}: got {got}")
        for i in range(fault["batch"]):
            if i != fault["member"]:
                check(sha(out[i]) == manifest["fixtures"][fault["fixture"]]["pil_sha256"],
                      f"fault {fault}: member {i} not bit-exact")
        emit("faults", fault=fault, failures=got)
    cut = parse(datas[NORST_MAIN])
    cut.scans[0].data = cut.scans[0].data[: len(cut.scans[0].data) // 2]
    try:
        tpujpeg_torch.decode_norst_to_rgb(cut, config, device=dev)
    except tpujpeg_torch.JpegError as e:
        emit("faults", fixture=NORST_MAIN, fault="scan cut in half", entry="decode_norst_to_rgb",
             raised=type(e).__name__)
    else:
        raise SmokeError(f"{NORST_MAIN} cut in half: decode_norst_to_rgb raised nothing")

    # 12. decode(): fused fixtures, the norst ones, then the staged ones.
    wavefront = tpujpeg_torch.DecodeConfig(entropy_engine="wavefront")
    for name, cfg, engines in (("420_odd", config, ("wavefront-fused", "cuda")),
                               ("gray", config, ("wavefront-fused", "cuda")),
                               ("norst_2048", config, ("wavefront-fused-norst", "cuda")),
                               ("rst_rows_420", config, ("wavefront-fused-norst", "cuda")),
                               ("prog_2048", config, ("native", "cuda")),
                               ("multiscan", wavefront, ("wavefront", "cuda")),
                               (PROG_MAIN, wavefront, ("wavefront", "cuda"))):
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = tpujpeg_torch.decode(datas[name], cfg, device=dev, return_stats=True)
        seconds = time.perf_counter() - t0
        check(hashlib.sha256(out.tobytes()).hexdigest() == manifest["fixtures"][name]["pil_sha256"],
              f"decode({name}) != PIL")
        check((st.entropy_engine, st.transform_engine) == engines,
              f"decode({name}) took {st.entropy_engine}/{st.transform_engine}")
        if name == PROG_MAIN:
            check(all(build.LAUNCHES[k] for k in PROG_KERNEL.values()),
                  f"decode({name}) launched {dict(build.LAUNCHES)}")
        if name in norst:
            check({k for k, n in build.LAUNCHES.items() if n} == {"wavefront_pixels", "upsample_color_h2v2"},
                  f"decode({name}) launched {dict(build.LAUNCHES)}")
        emit("decode", fixture=name, shape=list(out.shape), entropy_engine=st.entropy_engine,
             transform_engine=st.transform_engine, entropy_fallbacks=st.entropy_fallbacks,
             seconds=seconds, t_entropy=st.t_entropy, t_transform=st.t_transform,
             launches={k: n for k, n in build.LAUNCHES.items() if n})

    # 13. sharded: the giant image by MCU rows over SHARDS shards, against
    # the single-device fused decode of the same bytes.
    import importlib
    import tempfile
    from unittest import mock

    from tpujpeg_torch.fixtures.tile import norst_jpeg, tile_jpeg
    from tpujpeg_torch.parallel import halo

    shard_mesh = (tuple(torch.device("cuda", i) for i in range(SHARDS))
                  if torch.cuda.device_count() >= SHARDS else (dev,) * SHARDS)
    tensor_cfg = tpujpeg_torch.DecodeConfig(to_numpy=False)
    t0 = time.perf_counter()
    giant = tile_jpeg(datas["420_2048"], GIANT_TILES, GIANT_TILES)
    t_tile = time.perf_counter() - t0
    t0 = time.perf_counter()
    gjpeg = parse(giant)
    t_gparse = time.perf_counter() - t0
    t0 = time.perf_counter()
    gplan = wf.build_block_plan([gjpeg])
    t_gplan = time.perf_counter() - t0
    gframe = gjpeg.frame
    check((gframe.width, gframe.height) == (2048 * GIANT_TILES,) * 2, f"giant {gframe.width}x{gframe.height}")
    windows = halo.shard_windows(gframe, SHARDS)
    check(len(windows) == SHARDS, f"giant: {len(windows)} shards with rows")
    per_call = {"wavefront_coeff": 1, "dequant_idct_islow": 3 * SHARDS, "upsample_color_h2v2": SHARDS}
    gmp = gframe.width * gframe.height / 1e6

    def timed_peak(fn):
        """fn() once as a warm-up and 3 timed calls: (last result, walls,
        peak bytes allocated above what was allocated before)."""
        out, walls = None, []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for i in range(4):
            out = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
        return out, walls, torch.cuda.max_memory_allocated() - base

    def recorded(rec, key, fn):
        """fn, with each call's (args, kwargs, result) appended to rec[key]."""
        def call(*args, **kw):
            out = fn(*args, **kw)
            rec[key].append((args, kw, out))
            return out
        return call

    def a_recorded(rec):
        """wf._launch_wavefront, with each kernel-A launch's plan, layout
        and copies of its outputs and error bits appended to
        rec["wavefront_pixels"]."""
        def call(plan_a, layout_a, outs, err, emit="pixels"):
            real_launch(plan_a, layout_a, outs, err, emit)
            if emit == "pixels":
                rec["wavefront_pixels"].append((plan_a, layout_a, [o.clone() for o in outs], err.clone()))
        return call

    def a_vs_plain(rec, where):
        """The largest difference of the recorded kernel-A launches from
        their plain version on the same plans; their error bits must be
        equal."""
        worst = 0
        for plan_a, layout_a, outs_k, err_k in rec["wavefront_pixels"]:
            outs_p, err_p = [torch.zeros_like(o) for o in outs_k], torch.zeros_like(err_k)
            wf.decode_lanes_plain(plan_a, layout_a, outs_p, err_p)
            check(torch.equal(err_k, err_p), f"{where}: kernel A's error bits != plain")
            worst = max([worst] + [max_abs(torch, x, y) for x, y in zip(outs_k, outs_p)])
        return worst

    real_launch = wf._launch_wavefront
    h2v2 = pipeline._H2V2
    b_kern, b_plain = color_fns["upsample_color_h2v2"]

    build.LAUNCHES.clear()
    gout, walls, peak = timed_peak(lambda: halo.decode_sharded(giant, config=tensor_cfg, mesh=shard_mesh))
    sh_launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
    check({k: n for k, n in sh_launches.items() if n} == {k: 4 * n for k, n in per_call.items()},
          f"sharded giant launches {sh_launches}, want 4 x {per_call}")
    build.LAUNCHES.clear()
    grgb, fwalls, fpeak = timed_peak(lambda: tpujpeg_torch.decode_batch_to_rgb([parse(giant)], device=dev))
    check(not grgb[1], f"giant fused decode failures {grgb[1]}")
    check(tuple(gout.shape) == (gframe.height, gframe.width, 3) and gout.device == dev,
          f"sharded giant shape {tuple(gout.shape)} on {gout.device}")
    check(torch.equal(gout, grgb[0][0]), "sharded giant RGB != the fused decode's")
    del grgb
    # One more call with the wrappers of kernels 2, 6 and B recorded: each
    # launch's result against its plain version on the same inputs, on the
    # card (these launches are not counted).
    rec = collections.defaultdict(list)
    with mock.patch.object(wf, "decode_lanes_to_coeffs", recorded(rec, "wavefront_coeff", wf.decode_lanes_to_coeffs)), \
            mock.patch.object(idct, "dequant_idct_islow", recorded(rec, "dequant_idct_islow", idct.dequant_idct_islow)), \
            mock.patch.dict(pipeline._NHWC_KERNELS, {h2v2: recorded(rec, "upsample_color_h2v2", b_kern)}):
        check(torch.equal(halo.decode_sharded(giant, config=tensor_cfg, mesh=shard_mesh), gout),
              "sharded giant: a recorded call's RGB differs")
    check({k: len(v) for k, v in rec.items()} == per_call, f"sharded giant: recorded {list(map(len, rec.values()))}")
    ((args2, kw2, (coef_k, err_k)),) = rec["wavefront_coeff"]
    coef_p, err_p = wf.decode_lanes_to_coeffs(*args2, **{**kw2, "plain": True})
    sh_err = {"wavefront_coeff": max(max_abs(torch, a, b) for a, b in zip(coef_k, coef_p))}
    check(sh_err["wavefront_coeff"] == 0 and torch.equal(err_k, err_p) and not err_k.any(),
          f"sharded giant: kernel 2 != plain ({sh_err})")
    del coef_p, err_p
    sh_err["dequant_idct_islow"] = max(max_abs(torch, out, idct.dequant_idct_islow_plain(*a))
                                       for a, _kw, out in rec["dequant_idct_islow"])
    sh_err["upsample_color_h2v2"] = max(max_abs(torch, out, b_plain(*a)) for a, _kw, out in rec["upsample_color_h2v2"])
    check(not any(sh_err.values()), f"sharded giant: kernels != plain {sh_err}")
    for k, e in sh_err.items():
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"], e)
    # Device time of each step of the call, on the recorded inputs.
    gplan_dev = args2[0].to(dev)
    gcoeffs = [c[0] for c in coef_k]
    gcoef_host = [c.cpu().numpy() for c in gcoeffs]
    gqtabs = qtabs_of(gjpeg)
    gplanes = halo.shard_planes(gframe, gcoeffs, gqtabs, shard_mesh)
    sh_ms = {
        "wavefront_coeff": device_ms(torch, lambda: wf.decode_lanes_to_coeffs(gplan_dev, *args2[1:], **kw2), 3),
        "dequant_idct_islow": device_ms(torch, lambda: [idct.dequant_idct_islow(*a) for a, _kw, _o
                                                        in rec["dequant_idct_islow"]], 3),
        "color_and_crop": device_ms(torch, lambda: halo.color_shards(gframe, gplanes, config, shard_mesh,
                                                                             tpujpeg_torch.bitstream.color_space(gjpeg)), 3),
    }
    b_alone_ms = device_ms(torch, lambda: [b_kern(*a) for a, _kw, _o in rec["upsample_color_h2v2"]], 3)
    gplan_dev = gplan.to(dev)
    ggeoms = [wf.ImageGeom.of(gjpeg)]
    fplanes = wf.decode_lanes_to_planes(gplan_dev, ggeoms, dev)[0]
    fused_ms = {
        "wavefront_pixels": device_ms(torch, lambda: wf.decode_lanes_to_planes(gplan_dev, ggeoms, dev), 3),
        "upsample_color_h2v2": device_ms(torch, lambda: sc.upsample_color_h2v2(*cropped(gframe, fplanes)), 3),
    }
    del rec, coef_k, err_k, args2, kw2, gcoeffs, gplanes, fplanes, gplan_dev
    for k, n in sh_launches.items():
        launches[k] += n
    emit("sharded", image=[gframe.height, gframe.width], megapixels=gmp, jpeg_bytes=len(giant), shards=SHARDS,
         mesh=[str(d) for d in shard_mesh], calls=4, wall_s=walls, wall_median_s=statistics.median(walls),
         mp_per_s=gmp / statistics.median(walls), tile_s=t_tile, parse_s=t_gparse, host_plan_s=t_gplan,
         lanes=gplan.n_lanes, words=gplan.n_words, launches=sh_launches, per_call=per_call, kernel_ms=sh_ms,
         kernels_ms_total=sum(sh_ms.values()), upsample_color_h2v2_alone_ms=b_alone_ms, peak_bytes=peak,
         max_abs_err_vs_plain=sh_err,
         fused=dict(wall_s=fwalls, wall_median_s=statistics.median(fwalls), kernel_ms=fused_ms,
                    kernels_ms_total=sum(fused_ms.values()), peak_bytes=fpeak),
         equal_to_fused=True)

    # The same image as one marker-free scan (norst_jpeg: kernel 2's
    # coefficients coded again with the file's tables, no DRI, no RSTn).
    # decode_sharded takes decode_norst_sharded: kernel 2 per shard from
    # zero DC predictors, the DC fixup across shards, the whole grid on
    # mesh[0]. Against the single-device decodes of the same file:
    # decode_norst_to_device's coefficients (and the restart-segmented
    # image's), decode_norst_to_rgb's RGB (kernel A on the norst plan, B)
    # and the restart-segmented image's RGB.
    t0 = time.perf_counter()
    ngiant = norst_jpeg(giant, gcoef_host)
    t_encode = time.perf_counter() - t0
    nj = parse(ngiant)
    check(len(nj.scans) == 1 and len(nj.scans[0].rst_offsets) == 0, "norst giant: restart markers left")
    t0 = time.perf_counter()
    nplan = wf.build_norst_plan(nj)
    t_nplan = time.perf_counter() - t0
    n_per_call = {"wavefront_coeff": SHARDS, "dequant_idct_islow": 3 * SHARDS, "upsample_color_h2v2": SHARDS}
    build.LAUNCHES.clear()
    nout, nwalls, npeak = timed_peak(lambda: halo.decode_sharded(ngiant, config=tensor_cfg, mesh=shard_mesh))
    n_launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
    check({k: n for k, n in n_launches.items() if n} == {k: 4 * n for k, n in n_per_call.items()},
          f"norst giant launches {n_launches}, want 4 x {n_per_call}")
    for k, n in n_launches.items():
        launches[k] += n
    check(torch.equal(nout, gout), "norst giant: sharded RGB != the restart-segmented image's")
    del nout
    nrgb, nfwalls, nfpeak = timed_peak(lambda: wf.decode_norst_to_rgb(parse(ngiant), config, device=dev))
    check(torch.equal(nrgb, gout), "norst giant: decode_norst_to_rgb != the sharded RGB")
    del nrgb
    got_c, ncwalls, ncpeak = timed_peak(lambda: wf.decode_norst_sharded(parse(ngiant), config, mesh=shard_mesh))
    want_c, nswalls, nspeak = timed_peak(lambda: wf.decode_norst_to_device(parse(ngiant), config, device=dev))
    check(all(torch.equal(a, b) and torch.equal(a.cpu(), torch.from_numpy(h).reshape(a.shape))
              for a, b, h in zip(got_c, want_c, gcoef_host)),
          "norst giant: decode_norst_sharded != decode_norst_to_device or the restart image's coefficients")
    del got_c, want_c, gcoef_host
    # Each shard's kernel-2 launch of decode_norst_sharded against its
    # plain version on its own inputs (lanes from zero DC predictors into a
    # window of the rows they touch); the DC fixup then changes the
    # outputs in place, so they are copied at the launch (not counted).
    rec = collections.defaultdict(list)

    def copied(fn):
        def call(*args, **kw):
            coeffs, err = fn(*args, **kw)
            rec["wavefront_coeff"].append((args, kw, [c.clone() for c in coeffs], err.clone()))
            return coeffs, err
        return call

    with mock.patch.object(wf, "decode_lanes_to_coeffs", copied(wf.decode_lanes_to_coeffs)):
        wf.decode_norst_sharded(nj, config, mesh=shard_mesh)
    check(len(rec["wavefront_coeff"]) == SHARDS, f"norst giant: recorded {len(rec['wavefront_coeff'])} launches")
    nsh_err = 0
    for args, kw, coef_k, err_k in rec["wavefront_coeff"]:
        coef_p, err_p = wf.decode_lanes_to_coeffs(*args, **{**kw, "plain": True})
        e = max(max_abs(torch, a, b) for a, b in zip(coef_k, coef_p))
        check(e == 0 and torch.equal(err_k, err_p) and not err_k.any(),
              f"norst giant: kernel 2 != plain on a shard (max_abs_err {e})")
        nsh_err = max(nsh_err, e)
    results["wavefront_coeff"]["max_abs_err"] = max(results["wavefront_coeff"]["max_abs_err"], nsh_err)
    del rec, coef_k, err_k, coef_p, err_p
    emit("sharded", image=[gframe.height, gframe.width], entry="decode_sharded (marker-free)",
         jpeg_bytes=len(ngiant), shards=SHARDS, encode_s=t_encode, host_split_s=t_nplan,
         lanes=nplan.n_lanes, words=nplan.n_words, mcus_per_lane=nplan.n_mcus, calls=4, wall_s=nwalls,
         wall_median_s=statistics.median(nwalls), mp_per_s=gmp / statistics.median(nwalls), launches=n_launches,
         per_call=n_per_call, peak_bytes=npeak,
         fused=dict(entry="decode_norst_to_rgb", wall_s=nfwalls, wall_median_s=statistics.median(nfwalls),
                    peak_bytes=nfpeak),
         coeffs=dict(sharded_wall_s=ncwalls, sharded_peak_bytes=ncpeak, single_wall_s=nswalls,
                     single_peak_bytes=nspeak),
         equal_to_restart_image=True, equal_to_fused=True, coeffs_equal=True,
         kernel_2_max_abs_err_vs_plain=nsh_err)
    del gout, gplan, gjpeg, giant, ngiant, nj, nplan

    # 14. The fixtures through decode_sharded on SHARDS shards, each hashing
    # to PIL's: kernel 6 per component and shard, the sampling's color
    # kernel per shard (none for gray), kernel 2 once per restart-segmented
    # scan and once per shard for the marker-free one.
    color_kernel = {"420_2048": "upsample_color_h2v2", "norst_2048": "upsample_color_h2v2",
                    "422_2048": "upsample_color_h2v1", "444_2048": "color_444", "gray": None}
    for name in ("norst_2048", "422_2048", "444_2048", "gray"):
        fr = parse(datas[name]).frame
        live = sum(a < b for a, b in halo.shard_spans(fr, SHARDS))
        want_k = {"wavefront_coeff": SHARDS if name == NORST_MAIN else 1,
                  "dequant_idct_islow": live * fr.n_components}
        if color_kernel[name]:
            want_k[color_kernel[name]] = live
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = halo.decode_sharded(datas[name], config=config, mesh=shard_mesh)
        seconds = time.perf_counter() - t0
        got = {k: n for k, n in build.LAUNCHES.items() if n}
        check(hashlib.sha256(out.tobytes()).hexdigest() == manifest["fixtures"][name]["pil_sha256"],
              f"decode_sharded({name}) != PIL")
        check(got == want_k, f"decode_sharded({name}) launched {got}, want {want_k}")
        for k, n in got.items():
            launches[k] += n
        emit("sharded", fixture=name, shards=SHARDS, shards_with_rows=live, seconds=seconds, launches=got)
    nj = parse(datas[NORST_MAIN])
    build.LAUNCHES.clear()
    got_c = wf.decode_norst_sharded(nj, config, mesh=shard_mesh)
    check(build.LAUNCHES["wavefront_coeff"] == SHARDS, f"decode_norst_sharded launches {dict(build.LAUNCHES)}")
    launches["wavefront_coeff"] += SHARDS
    want_c = wf.decode_norst_to_device(nj, config, device=dev)
    check(all(torch.equal(a, b) for a, b in zip(got_c, want_c)),
          "decode_norst_sharded coefficients != decode_norst_to_device's")
    emit("sharded", entry="decode_norst_sharded", fixture=NORST_MAIN, shards=SHARDS,
         equal_to_decode_norst_to_device=True)
    del got_c, want_c

    # 15. Data parallel: the main batch over the mesh, and decode_batch's
    # transforms split over it on the batch phase's list.
    djpegs = [parse(datas["420_2048"]) for _ in range(MAIN_BATCH)]
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = collections.defaultdict(list)
    with mock.patch.object(wf, "_launch_wavefront", a_recorded(rec)), \
            mock.patch.dict(pipeline._NHWC_KERNELS, {h2v2: recorded(rec, "upsample_color_h2v2", b_kern)}):
        drgbs, failures = wf.decode_batch_to_rgb_sharded(djpegs, config, mesh=shard_mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = {k: n for k, n in build.LAUNCHES.items() if n}
    check(not failures, f"decode_batch_to_rgb_sharded failures {failures}")
    check(got == {"wavefront_pixels": SHARDS, "upsample_color_h2v2": SHARDS},
          f"decode_batch_to_rgb_sharded launched {got}")
    check(len(drgbs) == SHARDS and sum(r.shape[0] for r in drgbs) == MAIN_BATCH, "sharded batch shapes")
    check(all(torch.equal(r[i], main_image.to(r.device)) for r in drgbs for i in range(r.shape[0])),
          "decode_batch_to_rgb_sharded RGB != the main path's")
    for k, n in got.items():
        launches[k] += n
    # Each shard's A and B launch against its plain version on the same
    # inputs (the comparison's launches are not counted).
    check({k: len(v) for k, v in rec.items()} == {"wavefront_pixels": SHARDS, "upsample_color_h2v2": SHARDS},
          f"data parallel: recorded {list(map(len, rec.values()))}")
    dp_err = {"wavefront_pixels": a_vs_plain(rec, "data parallel")}
    dp_err["upsample_color_h2v2"] = max(max_abs(torch, out, b_plain(*a)) for a, _kw, out in rec["upsample_color_h2v2"])
    check(not any(dp_err.values()), f"data parallel: kernels != plain {dp_err}")
    for k, e in dp_err.items():
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"], e)
    emit("data_parallel", entry="decode_batch_to_rgb_sharded", images=MAIN_BATCH, shards=SHARDS,
         seconds=seconds, launches=got, max_abs_err_vs_plain=dp_err)
    del drgbs, djpegs, rec
    build.LAUNCHES.clear()
    res = tpujpeg_torch.decode_batch(bdatas, config, mesh=shard_mesh)
    got_err = {i: type(e).__name__ for i, e in res.errors.items()}
    check(got_err == want_err, f"decode_batch(mesh): failures {got_err}, want {want_err}")
    for i, n in enumerate(names):
        check(hashlib.sha256(res.images[i].tobytes()).hexdigest() == manifest["fixtures"][n]["pil_sha256"],
              f"decode_batch(mesh): {n} != PIL")
    got = {k: n for k, n in build.LAUNCHES.items() if n}
    for k, n in got.items():
        launches[k] += n
    emit("data_parallel", entry="decode_batch", images=len(bdatas), shards=SHARDS, failures=got_err, launches=got)
    del res

    # 16. cli: python -m tpujpeg_torch.cli in a subprocess.
    def run_cli(*args, rc=0):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "tpujpeg_torch.cli", *args], capture_output=True,
                             text=True, timeout=600, cwd=HERE)
        check(res.returncode == rc, f"cli {args[0]}: exit code {res.returncode}, want {rc}: {res.stderr[-2000:]}")
        return res.stdout, time.perf_counter() - t0

    fx = os.path.join(FIXTURES, manifest["fixtures"]["420_odd"]["file"])
    with tempfile.TemporaryDirectory() as tmp:
        out, s_info = run_cli("info", fx)
        info, fj = json.loads(out), parse(datas["420_odd"])
        check((info["width"], info["height"], info["segments"])
              == (fj.frame.width, fj.frame.height, sum(len(sc_.rst_offsets) + 1 for sc_ in fj.scans)),
              f"cli info {info}")
        npy = os.path.join(tmp, "out.npy")
        out, s_decode = run_cli("decode", fx, npy)
        check(hashlib.sha256(np.load(npy).tobytes()).hexdigest() == manifest["fixtures"]["420_odd"]["pil_sha256"],
              "cli decode .npy != PIL")
        out, s_bench = run_cli("bench", fx, "--repeats", "3")
        bench = json.loads(out.strip().splitlines()[-1])
        check(bench["entropy_engine"] == "wavefront-fused", f"cli bench {bench}")
        files = [os.path.join(FIXTURES, manifest["fixtures"][n]["file"]) for n in CLI_FILES]
        jobs = os.path.join(tmp, "batch")
        counts = []
        for extra, rc in (((), 0), ((), 0), ((b"not a jpeg",), 2)):
            paths = list(files)
            for k, payload in enumerate(extra):
                paths.append(os.path.join(tmp, f"bad{k}.jpg"))
                with open(paths[-1], "wb") as f:
                    f.write(payload)
            out, _s = run_cli("batch", *paths, "--out", jobs, "--on-device", rc=rc)
            counts.append(json.loads(out))
        n_files = len(files)
        check(counts == [{"completed": n_files, "skipped": 0, "failed": 0},
                         {"completed": 0, "skipped": n_files, "failed": 0},
                         {"completed": 0, "skipped": n_files, "failed": 1}], f"cli batch counters {counts}")
        for n in CLI_FILES:
            stem = os.path.splitext(manifest["fixtures"][n]["file"])[0]
            got = [f for f in os.listdir(jobs) if f.startswith(stem + ".") and f.endswith(".npy")]
            check(len(got) == 1 and hashlib.sha256(np.load(os.path.join(jobs, got[0])).tobytes()).hexdigest()
                  == manifest["fixtures"][n]["pil_sha256"], f"cli batch {n} != PIL")
    emit("cli", info_s=s_info, decode_s=s_decode, bench_s=s_bench, bench=bench, batch=counts)

    # 17. graft_entry: entry()'s step on card 0 against the plain transform,
    # then dryrun_multichip(SHARDS), each counted apart.
    from tpujpeg_torch import graft_entry
    from tpujpeg_torch import transform as plain_t

    efn, eargs = graft_entry.entry(dev)
    eframe = graft_entry.make_frame(*graft_entry.ENTRY_SIZE, graft_entry.H2V2)
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    eout = efn(*eargs)
    torch.cuda.synchronize()
    e_launches = {k: n for k, n in build.LAUNCHES.items() if n}
    check(e_launches == {"dequant_idct_islow": 3, "upsample_color_h2v2": 1}, f"entry() launched {e_launches}")
    for k, n in e_launches.items():
        launches[k] += n
    eplain = plain_t.transform_frame(eframe, [c.cpu() for c in eargs[0]], [q.cpu() for q in eargs[1]])
    e_err = max_abs(torch, eout.cpu(), eplain)
    check(tuple(eout.shape) == (*graft_entry.ENTRY_SIZE, 3) and eout.device == dev and e_err == 0,
          f"entry(): {tuple(eout.shape)} on {eout.device}, max_abs_err {e_err} against the plain transform")
    # Each launch of one more call (recorded, not counted) against its plain
    # version on its own inputs.
    rec = collections.defaultdict(list)
    with mock.patch.object(idct, "dequant_idct_islow", recorded(rec, "dequant_idct_islow", idct.dequant_idct_islow)), \
            mock.patch.dict(pipeline._NHWC_KERNELS, {h2v2: recorded(rec, "upsample_color_h2v2", b_kern)}):
        check(torch.equal(efn(*eargs), eout), "entry(): a recorded call's RGB differs")
    e_kerr = {"dequant_idct_islow": max(max_abs(torch, out, idct.dequant_idct_islow_plain(*a))
                                        for a, _kw, out in rec["dequant_idct_islow"]),
              "upsample_color_h2v2": max(max_abs(torch, out, b_plain(*a)) for a, _kw, out in rec["upsample_color_h2v2"])}
    check(not any(e_kerr.values()), f"entry(): kernels != plain {e_kerr}")
    e_ms = [cuda_ms(torch, lambda: efn(*eargs), 10) for _ in range(3)]
    e_dev_ms = device_ms(torch, lambda: efn(*eargs), 10)
    e_plain_ms = cuda_ms(torch, lambda: plain_t.transform_frame(eframe, list(eargs[0]), list(eargs[1])), 3)
    # The step reads the coefficients and quantizers once and writes the
    # RGB once; kernel 6's operations per block and B's per pixel.
    e_blocks = sum(c.numel() // 64 for c in eargs[0])
    e_bound = bound(sum(c.numel() * 4 for c in eargs[0]) + 3 * 64 * 4 + eout.numel(),
                    e_blocks * OPS_IDCT_BLOCK + eout.numel() // 3 * OPS_COLOR_PIXEL["upsample_color_h2v2"])
    emit("graft_entry", entry="entry()", shape=list(eout.shape), launches=e_launches, max_abs_err_vs_plain=e_err,
         kernel_max_abs_err_vs_plain=e_kerr, cuda_ms=e_ms, cuda_ms_median=statistics.median(e_ms),
         device_ms=e_dev_ms, plain_ms=e_plain_ms, bound_ms=e_bound[0], bound_by=e_bound[1], nvidia_smi=smi)
    del eout, eplain, rec

    # dryrun_multichip(SHARDS): paths 1, 1a, 1b, 2 and 3 over the mesh,
    # each launch of A, 6 and B recorded and held to its plain version.
    rec = collections.defaultdict(list)
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(wf, "_launch_wavefront", a_recorded(rec)), \
            mock.patch.object(idct, "dequant_idct_islow", recorded(rec, "dequant_idct_islow", idct.dequant_idct_islow)), \
            mock.patch.dict(pipeline._NHWC_KERNELS, {h2v2: recorded(rec, "upsample_color_h2v2", b_kern)}):
        dres = graft_entry.dryrun_multichip(SHARDS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    d_launches = {k: n for k, n in build.LAUNCHES.items() if n}
    # Paths 1 and 1a: kernel 6 per component and B once on each shard with
    # rows, and once more for the single-device transform; path 2: A and B
    # once per shard; path 3: kernel 6 per component and B once per piece
    # (one image each) and per single-device image.
    rows_1a = sum(a < b for a, b in halo.shard_spans(graft_entry.make_frame(16 * (2 * SHARDS + 1), 128,
                                                                             graft_entry.H2V2), SHARDS))
    transforms = (SHARDS + 1) + (rows_1a + 1) + 2 * SHARDS
    want_d = {"wavefront_pixels": SHARDS, "dequant_idct_islow": 3 * transforms,
              "upsample_color_h2v2": transforms + SHARDS}
    check(d_launches == want_d, f"dryrun_multichip({SHARDS}) launched {d_launches}, want {want_d}")
    check(dres["shards"] == SHARDS and dres["devices"] == len(set(shard_mesh)),
          f"dryrun_multichip: {dres['shards']} shards on {dres['devices']} devices")
    for k, n in d_launches.items():
        launches[k] += n
    d_err = {"wavefront_pixels": a_vs_plain(rec, "dryrun")}
    d_err["dequant_idct_islow"] = max(max_abs(torch, out, idct.dequant_idct_islow_plain(*a))
                                      for a, _kw, out in rec["dequant_idct_islow"])
    d_err["upsample_color_h2v2"] = max(max_abs(torch, out, b_plain(*a)) for a, _kw, out in rec["upsample_color_h2v2"])
    check(not any(d_err.values()), f"dryrun: kernels != plain {d_err}")
    for k in set(d_err) | set(e_kerr):
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"], d_err.get(k, 0), e_kerr.get(k, 0))
    emit("graft_entry", entry=f"dryrun_multichip({SHARDS})", shards=dres["shards"], devices=dres["devices"],
         mesh=dres["mesh"], seconds=seconds, launches=d_launches, max_abs_err_vs_plain=d_err)
    del dres, rec

    # The modules of the sharded paths and front ends (the cli and the
    # batch job ran in subprocesses) come from tpujpeg_torch/, and load
    # nothing of tpujpeg/ (the checks below).
    port_dir = os.path.join(HERE, "tpujpeg_torch") + os.sep
    for name in ("tpujpeg_torch.cli", "tpujpeg_torch.parallel.halo", "tpujpeg_torch.parallel.mesh",
                 "tpujpeg_torch.parallel.manifest", "tpujpeg_torch.fixtures.tile", "tpujpeg_torch.graft_entry"):
        check(os.path.abspath(importlib.import_module(name).__file__).startswith(port_dir),
              f"{name} not loaded from the port")
    loaded = sorted(m for m in ("jax", "jaxlib", "PIL", "tpujpeg") if m in sys.modules)
    check(not loaded, f"the port loaded {loaded}")
    ref_dir = os.path.join(HERE, "tpujpeg") + os.sep
    from_ref = sorted(m.__name__ for m in list(sys.modules.values())
                      if isinstance(getattr(m, "__file__", None), str)
                      and os.path.abspath(m.__file__).startswith(ref_dir))
    check(not from_ref, f"modules loaded from tpujpeg/: {from_ref}")
    check(ref_tree(HERE) == ref_before, "files under tpujpeg/ were added or changed")
    print(smi)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=KERNELS[k][0], replaces=KERNELS[k][1],
             launches=launches[k], max_abs_err=results[k]["max_abs_err"],
             ms=results[k]["ms"], plain_ms=results[k]["plain_ms"],
             bound_ms=results[k]["bound_ms"], bound_by=results[k]["bound_by"], library_ms=None,
             **{key: results[k][key] for key in ("norst", "small", "bucket_launches_ms") if key in results[k]})
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
