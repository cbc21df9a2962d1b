"""Batched decode of many mixed JPEGs on one device, each image
fault-isolated: a corrupt member marks its slot failed and never kills
the batch.

Port of ``tpujpeg/parallel/batch.py``. ``decode_batch_on_device`` keeps
the reference's two phases: it launches every progressive group and every
launch group with deferred errors (nothing read back), then resolves
them in order, popping each as it goes so that its RGB can be released.

- Progressive images group by ``prog_launch_key`` (geometry and scan
  script, whatever each image's Huffman tables) and color space and run
  kernels 7-9, 6 and the color stage once per group
  (``decode_all_scans_to_rgb_batch``). A group that raises goes image by
  image: the scan kernels first, then host entropy and the device
  transform where an image is outside their scope.
- Baseline images take ``wavefront.plan_launches``, as the stream's
  prep threads do: geometry buckets (``bucket_key``) in launch groups,
  kernel A once per group and the color stage per bucket
  (``wavefront.decode_group_to_rgb``). A bucket the planner refuses
  splits by ``wavefront.plan_key``: members that share Huffman tables go
  back through the planner together, and members the planner refuses
  even alone (multi-scan, marker-free, oversize segments) go image by
  image. A bucket with nothing to split (more quantizer sets than kernel
  A takes) runs kernel 2 (``decode_batch_to_device(strict=False)``) and
  ``transform_batch`` in sub-buckets by quantizer set. Image by image: a
  single scan takes the norst plan through kernel A and the color stage
  (``wavefront.decode_norst_to_rgb``, engine "wavefront-skeleton"), as
  the reference's does; then kernel 2 per scan
  (``wavefront.decode_all_scans``: multi-scan files), then host entropy
  (native C++) and the same transform. The reference's XLA wavefront has
  no counterpart.

``decode_batch`` runs host entropy per image, then ``transform_batch``
per (bucket, quantizer set), or the plain torch transform with
``transform_engine="torch"``, split over a mesh of devices
(``parallel/mesh.py``), the reference's ``n_devices``: each group's
images split into contiguous pieces, one per device (the pieces of the
reference's padded group, without its padding images). The default mesh
is the one `device`.

Images are numpy arrays when ``config.to_numpy`` (the default), else
tensors on `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import bitstream, spans
from .. import transform as T
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..decoder import _entropy_decode
from ..errors import JpegError, JpegUnsupportedError
from ..kernels import pipeline
from ..kernels import wavefront as wf
from ..kernels import wavefront_prog as wp
from ..stats import DecodeStats
from . import mesh as mesh_lib


@dataclasses.dataclass
class BatchResult:
    """Per-image outputs; `errors[i]` is set iff `images[i]` is None."""

    images: List[Optional[object]]
    errors: Dict[int, Exception]
    stats: List[Optional[DecodeStats]]


_bucket_key = wf.bucket_key   # its old name here, which jpegbench's plan_ms_per_mp.shard reads


def _as_error(e: Exception) -> JpegError:
    """A member's failure as a JpegError. Callers let RuntimeError through
    wherever a kernel or the card may raise it (a kernel that fails to
    build or launch, the card out of memory): that is no member's fault,
    and its work must not move to the host."""
    return e if isinstance(e, JpegError) else JpegError(f"internal decode failure: {e!r}")


def _qkey(jpeg) -> Tuple[bytes, ...]:
    return tuple(jpeg.qtables[c.tq].astype(np.int32).tobytes() for c in jpeg.frame.components)


def _host_config(config: DecodeConfig) -> DecodeConfig:
    """The host entropy engine of a fallback: the configured one when it
    names a host engine, else 'auto' (native C++, or the python oracle
    where the native library does not build)."""
    if config.entropy_engine in ("native", "python"):
        return config
    return dataclasses.replace(config, entropy_engine="auto")


def _pieces(items: Sequence, mesh: Sequence[torch.device]) -> List[Tuple[torch.device, Sequence]]:
    """`items` in contiguous pieces of ceil(len / devices), one per
    device of `mesh` in order; devices past the last item get none."""
    per = -(-len(items) // len(mesh))
    return [(dev, items[i * per : (i + 1) * per]) for i, dev in enumerate(mesh) if i * per < len(items)]


def transform_over_mesh(frame, coeffs: Sequence[Sequence], qtabs: Sequence, config: DecodeConfig,
                        mesh: Sequence[torch.device], emit: Callable[[int, torch.Tensor], None],
                        color: Optional[str] = None) -> None:
    """``transform_batch`` of images of one geometry and one quantizer set,
    split over `mesh` in contiguous pieces (``_pieces``): coeffs[k] holds
    image k's per-component int32 [padded_blocks, 64] (tensors on any
    device, or host arrays), qtabs[ci] the zigzag int32 [64] quantizer of
    component ci. Calls emit(k, rgb) for every image, rgb on its piece's
    device."""
    for device, piece in _pieces(range(len(coeffs)), mesh):
        stack = [torch.stack([torch.as_tensor(coeffs[k][ci]).to(device) for k in piece])
                 for ci in range(frame.n_components)]
        out = pipeline.transform_batch(frame, stack, qtabs, config, color=color)
        for slot, k in enumerate(piece):
            emit(k, out[slot])


def _transform_by_qset(jpegs: Sequence, coeffs: Sequence[Sequence], config: DecodeConfig,
                       mesh: Sequence[torch.device], emit: Callable[[int, torch.Tensor], None]) -> None:
    """``transform_over_mesh`` over images of one bucket in sub-buckets of
    one quantizer set each; coeffs[k] holds image k's per-component int32
    [padded_blocks, 64]. Calls emit(k, rgb) for every image, rgb on its
    piece's device."""
    by_q: Dict[Tuple, List[int]] = {}
    for k, j in enumerate(jpegs):
        by_q.setdefault(_qkey(j), []).append(k)
    frame = jpegs[0].frame
    for ks in by_q.values():
        j0 = jpegs[ks[0]]
        qtabs = [j0.qtables[c.tq].astype(np.int32) for c in frame.components]
        transform_over_mesh(frame, [coeffs[k] for k in ks], qtabs, config, mesh,
                            lambda slot, img, ks=ks: emit(ks[slot], img), color=bitstream.color_space(j0))


@spans.spanned(spans.LADDER)
def decode_batch_on_device(datas: Sequence[bytes], config: DecodeConfig = DEFAULT_CONFIG,
                           device="cuda") -> BatchResult:
    """Decode a batch of JPEG byte strings on `device`: the entropy decode
    runs there too (kernel A, 2 or 7-9) wherever the stream allows it, so
    coefficients reach the host only on the host-entropy fallback. A
    member's data error fails its slot; a kernel that fails to build or
    launch, or the card running out of memory, raises."""
    device = torch.device(device)
    kernel_engine = "cuda" if device.type == "cuda" else "torch"
    n = len(datas)
    images: List[Optional[object]] = [None] * n
    errors: Dict[int, Exception] = {}
    stats: List[Optional[DecodeStats]] = [None] * n

    # Host stage: parse only, fault-isolated.
    jpegs: List = [None] * n
    baseline: List[int] = []
    progressive: List[int] = []
    for i, data in enumerate(datas):
        try:
            j = bitstream.parse(data)
        except Exception as e:  # a batch boundary: no member may kill it
            errors[i] = _as_error(e)
            continue
        jpegs[i] = j
        (progressive if j.frame.progressive else baseline).append(i)

    def record(i: int, img: torch.Tensor, engine: str) -> None:
        frame = jpegs[i].frame
        images[i] = img.cpu().numpy() if config.to_numpy else img
        st = DecodeStats()
        st.width, st.height = frame.width, frame.height
        st.n_components = frame.n_components
        st.progressive = frame.progressive
        st.entropy_engine = engine
        st.entropy_fallbacks = 0 if engine in ("wavefront-fused", "wavefront-prog") else 1
        st.transform_engine = kernel_engine
        stats[i] = st

    # Images decoded to coefficients one by one: (index, coefficients,
    # engine), transformed together at the end by bucket and quantizer set.
    decoded: List[Tuple[int, List, str]] = []

    def host_entropy(i: int) -> None:
        """The last rung: host entropy."""
        st = DecodeStats()
        try:
            decoded.append((i, _entropy_decode(jpegs[i], _host_config(config), st, device),
                            st.entropy_engine))
        except RuntimeError:
            raise  # not the member's fault
        except Exception as e:  # per-image isolation
            errors[i] = _as_error(e)

    def prog_one(i: int) -> None:
        """One progressive image alone: the scan kernels, else (outside
        their scope) host entropy."""
        try:
            rgb, _layout, failures = wp.decode_all_scans_to_rgb_batch([jpegs[i]], config, device=device)
        except JpegUnsupportedError:
            host_entropy(i)
            return
        except JpegError as e:
            errors[i] = e
            return
        if 0 in failures:
            errors[i] = failures[0]
        else:
            record(i, rgb[0], "wavefront-prog")

    def coeff_one(i: int) -> None:
        """One baseline image outside the shared planner's scope: a single
        scan on the norst plan through kernel A and the color stage
        (``decode_norst_to_rgb``: marker-free or oversize segments, or
        tables of its own), else kernel 2 per scan (multi-scan files),
        else host entropy."""
        if len(jpegs[i].scans) == 1:
            try:
                record(i, wf.decode_norst_to_rgb(jpegs[i], config, device=device), "wavefront-skeleton")
                return
            except JpegUnsupportedError:
                pass
            except JpegError as e:
                errors[i] = e
                return
        try:
            decoded.append((i, wf.decode_all_scans(jpegs[i], config, device), "wavefront-coeff"))
        except JpegUnsupportedError:
            host_entropy(i)
        except JpegError as e:
            errors[i] = e

    # Phase 1: launch every progressive group and every launch group,
    # reading nothing back.
    groups: Dict[Tuple, List[int]] = {}
    for i in progressive:
        try:
            key = (wp.prog_launch_key(jpegs[i]), bitstream.color_space(jpegs[i]))
        except Exception:  # an unkeyable stream decodes alone
            key = ("solo", i)
        groups.setdefault(key, []).append(i)
    prog_pending = []
    for members in groups.values():
        try:
            rgb, _layout, deferred = wp.decode_all_scans_to_rgb_batch(
                [jpegs[i] for i in members], config, defer_errors=True, device=device)
        except JpegError:  # a plan-time error poisons the shared plan
            for i in members:
                prog_one(i)
            continue
        prog_pending.append((members, rgb, deferred))

    pending = []
    coeff_buckets: List[List[int]] = []  # kernel 2 by quantizer set
    solo: List[int] = []                 # per image: coeff_one

    def launch(members: List[int]) -> None:
        """Kernel A and the color stage for baseline images, launch group
        by launch group. A bucket the planner refuses splits: members that
        share Huffman tables and fit the planner alone go back through it
        together, the rest go image by image; a bucket with nothing to
        split takes kernel 2."""
        groups, refused = wf.plan_launches([jpegs[i] for i in members])
        for g in groups:
            rgbs, _layout, err = wf.decode_group_to_rgb(g.plan, g.jpegs, config, device)
            pending.append(([members[k] for k in g.positions], rgbs, err, g.plan))
        for at in refused:
            bucket = [members[k] for k in at]
            by_tables: Dict[Tuple, List[int]] = {}
            for i in bucket:
                try:
                    by_tables.setdefault(wf.plan_key(jpegs[i]), []).append(i)
                except JpegError:
                    solo.append(i)
            parts = list(by_tables.values())
            if parts == [bucket]:
                coeff_buckets.append(bucket)
            else:
                for part in parts:
                    launch(part)

    launch(baseline)

    # Phase 2: resolve in launch order.
    while prog_pending:
        members, rgb, (errs, plans) = prog_pending.pop(0)
        failures = wp.resolve_scan_errors(errs, plans)
        for li, i in enumerate(members):
            if li in failures:
                errors[i] = failures[li]
            else:
                record(i, rgb[li], "wavefront-prog")
    while pending:
        members, rgbs, err, plan = pending.pop(0)
        failures = wf.resolve_rgb_errors(err, plan)
        slots = ((rgb, k) for rgb in rgbs for k in range(rgb.shape[0]))
        for li, (i, (rgb, k)) in enumerate(zip(members, slots)):
            if li in failures:
                errors[i] = failures[li]
            else:
                record(i, rgb[k], "wavefront-fused")

    for members in coeff_buckets:
        sub = [jpegs[i] for i in members]
        try:
            coeffs, failures = wf.decode_batch_to_device(sub, config, strict=False, device=device)
        except JpegError:
            solo.extend(members)
            continue
        for li, exc in failures.items():
            errors[members[li]] = exc
        ok = [li for li in range(len(members)) if li not in failures]
        if ok:
            _transform_by_qset([sub[li] for li in ok], [coeffs[li] for li in ok], config, (device,),
                               lambda k, img: record(members[ok[k]], img, "wavefront-coeff"))
    for i in solo:
        coeff_one(i)

    by_bucket: Dict[Tuple, List[Tuple[int, List, str]]] = {}
    for entry in decoded:
        by_bucket.setdefault(_bucket_key(jpegs[entry[0]]), []).append(entry)
    for entries in by_bucket.values():
        _transform_by_qset([jpegs[i] for i, _c, _e in entries], [c for _i, c, _e in entries], config, (device,),
                           lambda k, img, entries=entries: record(entries[k][0], img, entries[k][2]))

    return BatchResult(images=images, errors=errors, stats=stats)


@spans.spanned(spans.LADDER)
def decode_batch(datas: Sequence[bytes], config: DecodeConfig = DEFAULT_CONFIG,
                 device=None, mesh=None) -> BatchResult:
    """Decode a batch of JPEG byte strings: parse and entropy decode on the
    host per image under try/except (``config.entropy_engine``; the
    wavefront engine runs on the mesh's first device), then one transform
    per (bucket, quantizer set), split over `mesh` (a sequence of
    devices; default: `device` alone, "cuda" if neither is given; both
    raise ValueError): kernel 6 and the color stage, or with
    ``transform_engine="torch"`` the plain torch transform per image.
    Images decoded as tensors lie on their piece's device."""
    if device is not None and mesh is not None:
        raise ValueError("decode_batch takes a device or a mesh, not both")
    mesh = mesh_lib.as_mesh(mesh if mesh is not None else (device or "cuda",))
    if config.transform_engine not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown transform engine {config.transform_engine!r}")
    plain = config.transform_engine == "torch"
    transform_engine = "cuda" if mesh[0].type == "cuda" and not plain else "torch"
    n = len(datas)
    images: List[Optional[object]] = [None] * n
    errors: Dict[int, Exception] = {}
    stats: List[Optional[DecodeStats]] = [None] * n

    buckets: Dict[Tuple, List[Tuple[int, object, List]]] = {}
    for i, data in enumerate(datas):
        st = DecodeStats()
        try:
            jpeg = bitstream.parse(data)
            coeffs = _entropy_decode(jpeg, config, st, mesh[0])
        except RuntimeError:
            raise  # not the member's fault
        except Exception as e:  # a batch boundary: no member may kill it
            errors[i] = _as_error(e)
            continue
        frame = jpeg.frame
        st.width, st.height = frame.width, frame.height
        st.n_components = frame.n_components
        st.progressive = frame.progressive
        st.transform_engine = transform_engine
        stats[i] = st
        buckets.setdefault(_bucket_key(jpeg), []).append((i, jpeg, coeffs))

    def emit(i: int, img: torch.Tensor) -> None:
        images[i] = img.cpu().numpy() if config.to_numpy else img

    for entries in buckets.values():
        if plain:
            for dev, piece in _pieces(entries, mesh):
                for i, jpeg, coeffs in piece:
                    frame = jpeg.frame
                    qtabs = [torch.from_numpy(jpeg.qtables[c.tq].astype(np.int32)).to(dev)
                             for c in frame.components]
                    emit(i, T.transform_frame(frame, [torch.as_tensor(c).to(dev) for c in coeffs], qtabs,
                                              config.fancy_upsampling, bitstream.color_space(jpeg)))
            continue
        _transform_by_qset([e[1] for e in entries], [e[2] for e in entries], config, mesh,
                           lambda k, img, entries=entries: emit(entries[k][0], img))
    return BatchResult(images=images, errors=errors, stats=stats)
