"""Pipelined stream: host prep on worker threads overlapped with the
device's decode of earlier chunks.

Port of ``tpujpeg/parallel/stream.py``. The stages per chunk of images:

  prep   (worker threads)  parse, then ``wavefront.plan_launches``: the
                           images in geometry buckets (in order of first
                           appearance, as ``decode_batch_on_device``
                           buckets them), one ``build_block_plan`` per
                           bucket (the native row packer releases the
                           interpreter lock; parsing does not), and the
                           buckets in launch groups, each with one pinned
                           plan on a CUDA device
  submit (main thread)     per launch group, copy its plan to the card
                           without blocking, launch kernel A once (its
                           mixed form over several buckets) and the color
                           kernel per bucket on the current stream; then
                           record one CUDA event; the in-flight record
                           keeps every pinned plan alive until that event
                           has passed
  sync   (main thread)     wait for the event and read back each group's
                           per-lane error vector, mapped to its images
                           (``resolve_rgb_errors``)

At most `depth` chunks are in flight, and up to `prep_workers + depth`
chunks are queued for prep. Everything runs on the one current stream, so
the copies, kernels and readbacks are ordered without further events.
A chunk of mixed geometry stays on the fused path, one kernel-A launch
per launch group; the reference's stream falls back on it (the output
bytes are equal). Chunks the fused path cannot take in any bucket (progressive,
mixed Huffman tables, oversize or marker-free segments, a plan-time data
error) fall back whole at sync time
to ``decode_batch_on_device``, then (where it raises a JpegError) to
``decode_batch``; a kernel or card failure raises. On a CPU device
nothing is pinned and the kernels' plain versions run.

Traced (``spans``: decided once, when the stream starts, on the thread
that consumes it), each chunk is a unit whose id is its index: the main
thread's ``stream.prep_wait``, ``stream.submit`` and ``stream.sync`` spans
(``stream.fallback`` and ``card_wait`` inside the last), and the prep
threads' ``parse`` and ``plan`` (one ``plan`` per geometry bucket), and
an ``a_buckets`` count of the buckets each kernel-A launch decodes.
"""

from __future__ import annotations

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from .. import bitstream, spans
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..errors import JpegError
from ..kernels import pipeline
from ..kernels import wavefront as wf
from ..stats import DecodeStats
from .batch import BatchResult, decode_batch, decode_batch_on_device

LAYOUTS = ("nhwc", "packed16")


@dataclasses.dataclass
class _Unit:
    """One prepped chunk: fused-path launch groups, or a fallback."""

    members: List[int]               # original indices of cleanly parsed images
    groups: Optional[List[wf.LaunchGroup]]  # None -> fallback; positions index members
    failures: Dict[int, Exception]   # original index -> parse error
    datas: Optional[List[bytes]] = None  # kept for the fallback only


@dataclasses.dataclass
class StreamChunk:
    """One decoded chunk, yielded in submission order. `images[k]` is the
    image of original index `members[k]` (a view of its geometry bucket's
    batch on the device on the fused path), or None when `failures` has
    that index.
    `layout` is "nhwc" (uint8 [H, W, 3]) or "packed16" (planar uint16
    [3, H, W/2] whose little-endian bytes are the planar uint8 raster)."""

    members: List[int]
    images: List[Optional[object]]
    failures: Dict[int, Exception]
    engine: str
    layout: str = "nhwc"


def _prep(datas: Sequence[bytes], members: List[int], pin: bool, unit: Optional[int] = None,
          parent: Optional[int] = None) -> _Unit:
    """Worker-thread stage: parse + plan, fault-isolated; traced as chunk
    `unit` (None: not traced) under the submitting thread's span `parent`."""
    with spans.adopt(unit, parent):
        return _prep_chunk(datas, members, pin)


def _prep_chunk(datas: Sequence[bytes], members: List[int], pin: bool) -> _Unit:
    jpegs: List = []
    ok: List[int] = []
    failures: Dict[int, Exception] = {}
    for i in members:
        try:
            jpegs.append(bitstream.parse(datas[i]))
            ok.append(i)
        except JpegError as e:
            failures[i] = e
        except Exception as e:  # never kill the stream
            failures[i] = JpegError(f"internal parse failure: {e!r}")
    if not ok:
        return _Unit(ok, None, failures)
    if not any(j.frame.progressive for j in jpegs):
        groups, refused = wf.plan_launches(jpegs, pin_memory=pin)
        if not refused:
            return _Unit(ok, groups, failures)
    # Progressive, outside the fused path in some bucket, or a plan-time
    # data error that would poison a shared plan: the fallback isolates
    # images.
    return _Unit(ok, None, failures, [datas[i] for i in ok])


@dataclasses.dataclass
class _InFlight:
    unit: _Unit
    outs: List = dataclasses.field(default_factory=list)  # (rgb per bucket, err) per group
    layout: str = "nhwc"
    done: Optional[torch.cuda.Event] = None  # passed once the unit's pinned plans are free


@spans.spanned(spans.SUBMIT)
def _submit(unit: _Unit, config: DecodeConfig, device: torch.device, packed: bool) -> _InFlight:
    """Main-thread stage: asynchronous copies and launches of the fused
    chain, launch group by launch group. The chunk has one layout: packed16
    only where it applies to every bucket."""
    if unit.groups is None:
        return _InFlight(unit)  # the fallback decodes at sync time
    packed = packed and all(
        pipeline.packed_layout_applies(js[0].frame, config, bitstream.color_space(js[0]))
        for g in unit.groups for js in g.jpegs)
    outs, layout = [], "nhwc"
    for g in unit.groups:
        rgbs, layout, err = wf.decode_group_to_rgb(g.plan, g.jpegs, config, device, packed=packed)
        spans.count(spans.A_BUCKETS, len(g.jpegs))
        outs.append((rgbs, err))
    done = None
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
    return _InFlight(unit, outs, layout, done)


def _sync(flight: _InFlight, config: DecodeConfig, device: torch.device) -> StreamChunk:
    """Main-thread stage: wait for the chunk, map failures, slice images."""
    unit = flight.unit
    failures = dict(unit.failures)
    members = list(unit.members) + list(unit.failures)
    images: List[Optional[object]] = [None] * len(unit.members)
    if unit.groups is None:
        if unit.datas:
            # The device ladder first; host entropy per image where it
            # refuses the chunk as a whole. A kernel or card failure
            # (RuntimeError) propagates: its work never moves to the host.
            with spans.span(spans.FALLBACK):
                try:
                    res = decode_batch_on_device(unit.datas, config, device)
                except JpegError:
                    res = decode_batch(unit.datas, config, device)
            for k, i in enumerate(unit.members):
                if k in res.errors:
                    failures[i] = res.errors[k]
                else:
                    images[k] = res.images[k]
        images += [None] * len(unit.failures)
        return StreamChunk(members, images, failures, "fallback")

    if flight.done is not None:
        with spans.span(spans.CARD_WAIT):
            flight.done.synchronize()
    for g, (rgbs, err) in zip(unit.groups, flight.outs):
        failed = wf.resolve_rgb_errors(err, g.plan)
        slots = ((rgb, li) for rgb in rgbs for li in range(rgb.shape[0]))
        for i, (k, (rgb, li)) in enumerate(zip(g.positions, slots)):
            if i in failed:
                failures[unit.members[k]] = failed[i]
            else:
                images[k] = rgb[li]
    images += [None] * len(unit.failures)
    return StreamChunk(members, images, failures, "wavefront-fused", flight.layout)


def decode_stream(datas: Sequence[bytes], config: DecodeConfig = DEFAULT_CONFIG,
                  chunk_size: int = 64, depth: int = 2, prep_workers: int = 3,
                  layout: str = "nhwc", device="cuda") -> Iterator[StreamChunk]:
    """Decode a long sequence of JPEGs as a pipelined stream of chunks on
    `device`.

    Yields one StreamChunk per `chunk_size` images, in order. Host prep of
    later chunks runs on `prep_workers` threads while the device decodes,
    with at most `depth` chunks in flight. Images stay on the device
    unless ``config.to_numpy`` (which reads each chunk back before it is
    yielded). layout="packed16" asks for the planar kernels' packed16 form
    (chunk.layout says whether it applied, to the whole chunk: where every
    geometry bucket is 4:2:0 or 4:2:2 YCbCr with an even width); the chain
    then ends at the color kernel."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: want one of {LAYOUTS}")
    device = torch.device(device)
    pin = device.type == "cuda"
    n = len(datas)
    starts = list(range(0, n, chunk_size))
    traced = spans.recording()
    with ThreadPoolExecutor(max_workers=prep_workers) as ex:
        prep_q: collections.deque = collections.deque()
        inflight: collections.deque = collections.deque()
        next_chunk = 0   # chunk index of the next prep
        submitted = 0    # of prep_q[0]
        synced = 0       # of inflight[0]

        def refill():
            nonlocal next_chunk
            while next_chunk < len(starts) and len(prep_q) < prep_workers + depth:
                s = starts[next_chunk]
                prep_q.append(ex.submit(_prep, datas, list(range(s, min(s + chunk_size, n))), pin,
                                        next_chunk if traced else None, spans.current()))
                next_chunk += 1

        refill()
        while prep_q or inflight:
            while prep_q and len(inflight) < depth:
                with spans.adopt(submitted if traced else None):
                    with spans.span(spans.PREP_WAIT):
                        unit = prep_q.popleft().result()
                    refill()
                    inflight.append(_submit(unit, config, device, layout == "packed16"))
                submitted += 1
            # The span also holds the release of the chunk's prep state (its
            # parsed streams and pinned plan), which follows _sync's return.
            with spans.adopt(synced if traced else None), spans.span(spans.SYNC):
                chunk = _sync(inflight.popleft(), config, device)
            synced += 1
            if config.to_numpy:
                chunk.images = [im.cpu().numpy() if isinstance(im, torch.Tensor) else im
                                for im in chunk.images]
            yield chunk


def decode_batch_pipelined(datas: Sequence[bytes], config: DecodeConfig = DEFAULT_CONFIG,
                           chunk_size: int = 64, depth: int = 2, prep_workers: int = 3,
                           layout: str = "nhwc", device="cuda") -> BatchResult:
    """``decode_batch_on_device``'s result through the pipelined stream,
    built by draining ``decode_stream``. `layout` as there (the reference's
    entry has no layout: it is always "nhwc")."""
    device = torch.device(device)
    n = len(datas)
    images: List[Optional[object]] = [None] * n
    errors: Dict[int, Exception] = {}
    stats: List[Optional[DecodeStats]] = [None] * n
    for chunk in decode_stream(datas, config, chunk_size=chunk_size, depth=depth,
                               prep_workers=prep_workers, layout=layout, device=device):
        errors.update(chunk.failures)
        for k, i in enumerate(chunk.members):
            if i in chunk.failures:
                continue
            images[i] = chunk.images[k]
            st = DecodeStats()
            st.entropy_engine = chunk.engine
            st.transform_engine = "cuda" if device.type == "cuda" else "torch"
            stats[i] = st
    return BatchResult(images=images, errors=errors, stats=stats)
