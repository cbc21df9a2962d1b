"""The port's pipelined stream (tpujpeg_torch.parallel.stream) on
device="cpu", where the kernels' plain versions run: the eight cases of
tests/test_stream.py with the same corpus calls, byte for byte against
PIL; identical outputs whatever the depth and the number of prep
workers; config.to_numpy; chunks of mixed geometry, one fused plan per
geometry bucket, against PIL and the benchmark's plain reference
(jpegbench.reference, plain torch and numpy); and the reference's return
forms of decode_all_scans_to_rgb_batch (packed, defer_errors, layout) and
decode_batch_to_rgb (defer_errors). Tolerance 0."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from corpus import make_jpeg, pil_decode
from test_torch_cuda import zero_payload

import tpujpeg
from tpujpeg import bitstream as ref_bitstream
from tpujpeg.kernels import wavefront_pallas as ref_wp
from tpujpeg.kernels import wavefront_prog as ref_prog

import tpujpeg_torch
from jpegbench.reference import decode as plain_ref
from tpujpeg_torch import DecodeConfig, bitstream
from tpujpeg_torch.kernels import wavefront as wf
from tpujpeg_torch.kernels import wavefront_prog as prog

CPU = dict(device="cpu")


def test_stream_bit_exact_and_in_order():
    datas = [make_jpeg(128, 96, seed=s, subsampling=2, quality=85, restart_blocks=8) for s in range(10)]
    seen = []
    for chunk in tpujpeg_torch.decode_stream(datas, chunk_size=4, depth=2, **CPU):
        assert not chunk.failures and chunk.engine == "wavefront-fused"
        for k, i in enumerate(chunk.members):
            np.testing.assert_array_equal(chunk.images[k], pil_decode(datas[i]))
        seen.extend(chunk.members)
    assert seen == list(range(10))


def test_stream_fault_isolation():
    good = make_jpeg(96, 96, seed=1, subsampling=2, restart_blocks=8)
    datas = [good, b"not a jpeg", good[:200], good]
    res = tpujpeg_torch.decode_batch_pipelined(datas, chunk_size=2, **CPU)
    assert set(res.errors) >= {1}
    np.testing.assert_array_equal(res.images[0], pil_decode(good))
    np.testing.assert_array_equal(res.images[3], pil_decode(good))
    for i in res.errors:
        assert res.images[i] is None
        assert isinstance(res.errors[i], tpujpeg_torch.JpegError)
    assert res.stats[0].transform_engine == "torch"


def test_stream_fallback_chunk():
    datas = [make_jpeg(96, 96, seed=s, subsampling=2, progressive=True) for s in range(3)]
    chunks = list(tpujpeg_torch.decode_stream(datas, chunk_size=3, **CPU))
    assert len(chunks) == 1
    ch = chunks[0]
    assert ch.engine == "fallback" and not ch.failures
    for k, i in enumerate(ch.members):
        np.testing.assert_array_equal(ch.images[k], pil_decode(datas[i]))


def test_stream_matches_batch_on_device():
    datas = [make_jpeg(160, 128, seed=s, subsampling=0, quality=90, restart_blocks=4) for s in range(6)]
    a = tpujpeg_torch.decode_batch_pipelined(datas, chunk_size=3, **CPU)
    b = tpujpeg_torch.decode_batch_on_device(datas, **CPU)
    assert not a.errors and not b.errors
    for x, y, d in zip(a.images, b.images, datas):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, pil_decode(d))


def test_stream_uneven_tail_chunk():
    datas = [make_jpeg(96, 64, seed=s, subsampling=2, restart_blocks=8) for s in range(5)]
    res = tpujpeg_torch.decode_batch_pipelined(datas, chunk_size=2, **CPU)
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(img, pil_decode(d))


def test_stream_packed16_layout_bytes_are_raster():
    """4:2:0 and 4:2:2 take the planar kernels: uint16 [3, H, W/2] whose
    bytes are the planar raster, equal to PIL's and, for the first image,
    to the reference's packed16 bytes."""
    datas = [make_jpeg(128, 96, seed=s, subsampling=2, restart_blocks=4) for s in range(2)] + [
        make_jpeg(128, 96, seed=9, subsampling=1, restart_blocks=4)
    ]
    for n, d in enumerate(datas):
        ch = next(iter(tpujpeg_torch.decode_stream([d], chunk_size=1, layout="packed16", **CPU)))
        assert ch.layout == "packed16"
        got = ch.images[0]
        assert got.dtype == np.uint16 and got.shape == (3, 96, 64)
        planar = got.view(np.uint8).reshape(3, 96, 128)
        np.testing.assert_array_equal(np.moveaxis(planar, 0, 2), pil_decode(d))
        if n == 0:
            ref = next(iter(tpujpeg.decode_stream([d], chunk_size=1, layout="packed16")))
            assert ref.layout == "packed16"
            np.testing.assert_array_equal(got, np.asarray(ref.images[0]))


def test_stream_packed16_falls_back_to_nhwc_when_inapplicable():
    d = make_jpeg(64, 64, seed=3, subsampling=0, restart_blocks=4)
    ch = next(iter(tpujpeg_torch.decode_stream([d], layout="packed16", **CPU)))
    assert ch.layout == "nhwc"
    np.testing.assert_array_equal(ch.images[0], pil_decode(d))


def test_stream_norst_chunk_uses_device_ladder(monkeypatch):
    """Marker-free streams reject the shared fused plan (oversize
    segment); the chunk falls back to the device ladder, which decodes
    each image on its norst plan (decode_norst_to_rgb: kernel A and the
    color stage), bit-exact. The chunk's engine is "fallback", as the
    reference's."""
    from tpujpeg_torch.kernels import wavefront as wf

    calls = []
    real = wf.decode_norst_to_rgb
    monkeypatch.setattr(wf, "decode_norst_to_rgb", lambda *a, **k: calls.append(1) or real(*a, **k))
    datas = [make_jpeg(256, 192, seed=s, subsampling=2) for s in range(2)]
    res = tpujpeg_torch.decode_batch_pipelined(datas, chunk_size=2, **CPU)
    assert not res.errors and len(calls) == 2
    assert {s.entropy_engine for s in res.stats} == {"fallback"}
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(res.images[i], pil_decode(d))


STREAM = [make_jpeg(64, 48, seed=s, subsampling=2, restart_blocks=4) for s in range(5)]


@pytest.mark.parametrize("depth,workers", [(1, 1), (2, 3), (3, 1)])
def test_depth_and_workers_give_identical_outputs(depth, workers):
    want = [pil_decode(d) for d in STREAM]
    for layout in ("nhwc", "packed16"):
        chunks = list(tpujpeg_torch.decode_stream(STREAM, chunk_size=2, depth=depth, prep_workers=workers,
                                                  layout=layout, **CPU))
        assert [i for ch in chunks for i in ch.members] == list(range(len(STREAM)))
        for ch in chunks:
            assert ch.layout == layout and not ch.failures
            for k, i in enumerate(ch.members):
                img = ch.images[k]
                if layout == "packed16":
                    img = np.moveaxis(img.view(np.uint8).reshape(3, 48, 64), 0, 2)
                np.testing.assert_array_equal(img, want[i])


def test_to_numpy_false_keeps_tensors():
    datas = STREAM[:3]
    cfg = DecodeConfig(to_numpy=False)
    chunks = list(tpujpeg_torch.decode_stream(datas, cfg, chunk_size=2, layout="packed16", **CPU))
    assert all(isinstance(im, torch.Tensor) and im.dtype == torch.uint16 for ch in chunks for im in ch.images)
    res = tpujpeg_torch.decode_batch_pipelined(datas, cfg, chunk_size=2, **CPU)
    for img, d in zip(res.images, datas):
        assert isinstance(img, torch.Tensor) and img.dtype == torch.uint8
        np.testing.assert_array_equal(img.numpy(), pil_decode(d))
    res = tpujpeg_torch.decode_batch_pipelined(datas, chunk_size=2, **CPU)
    assert all(isinstance(img, np.ndarray) for img in res.images)


def test_stream_rejects_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        list(tpujpeg_torch.decode_stream(STREAM[:1], layout="nchw", **CPU))


PROG = make_jpeg(64, 48, seed=6, progressive=True, subsampling=2, restart_blocks=4)


def test_decode_all_scans_to_rgb_batch_returns_what_the_reference_returns():
    """(rgb, layout, failures), and with defer_errors (rgb, layout, (error
    bits, kernel plans)) that resolve_scan_errors maps; with packed, the
    reference's packed16 bytes."""
    jpegs = [bitstream.parse(PROG) for _ in range(2)]
    rgb, layout, failures = prog.decode_all_scans_to_rgb_batch(jpegs, **CPU)
    assert layout == "nhwc" and failures == {} and rgb.shape == (2, 48, 64, 3)
    np.testing.assert_array_equal(rgb[1].numpy(), pil_decode(PROG))
    packed, layout, (errs, plans) = prog.decode_all_scans_to_rgb_batch(jpegs, packed=True, defer_errors=True,
                                                                       **CPU)
    assert layout == "packed16" and packed.dtype == torch.uint16 and packed.shape == (2, 3, 48, 32)
    assert len(errs) == len(plans) and prog.resolve_scan_errors(errs, plans) == {}
    ref_rgb, ref_layout, (ref_errs, ref_plans) = ref_prog.decode_all_scans_to_rgb_batch(
        [ref_bitstream.parse(PROG) for _ in range(2)], packed=True, defer_errors=True)
    assert ref_layout == layout and len(ref_errs) == len(errs)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref_rgb))
    for e, ref_e, ref_plan in zip(errs, ref_errs, ref_plans):
        np.testing.assert_array_equal(e.numpy(), np.asarray(ref_e).reshape(-1)[: ref_plan.n_lanes])
    gray = bitstream.parse(make_jpeg(32, 32, seed=2, mode="L", progressive=True))
    _rgb, layout, _f = prog.decode_all_scans_to_rgb_batch([gray], packed=True, **CPU)
    assert layout == "nhwc"


def test_decode_batch_to_rgb_defer_errors_returns_what_the_reference_returns():
    """With defer_errors: (rgb, (error bits, plan)), nothing read back; the
    pair resolves to the failures of the plain call."""
    datas = [make_jpeg(96, 64, seed=s, subsampling=2, restart_blocks=8) for s in (1, 2)]
    jpegs = [bitstream.parse(d) for d in datas]
    jpegs[1].scans[0].data = bytes(len(jpegs[1].scans[0].data))
    rgb, (err, plan) = wf.decode_batch_to_rgb(jpegs, defer_errors=True, **CPU)
    assert isinstance(plan, wf.LanePlan) and err.shape == (plan.n_lanes,)
    failures = wf.resolve_rgb_errors(err, plan)
    rgb2, failures2 = wf.decode_batch_to_rgb(jpegs, **CPU)
    assert torch.equal(rgb, rgb2)
    assert {i: type(e) for i, e in failures.items()} == {i: type(e) for i, e in failures2.items()}
    ref = [ref_bitstream.parse(d) for d in datas]
    ref[1].scans[0].data = bytes(len(ref[1].scans[0].data))
    _ref_rgb, (ref_err, ref_plan) = ref_wp.decode_batch_to_rgb(ref, defer_errors=True)
    np.testing.assert_array_equal(err.numpy(), np.asarray(ref_err).reshape(-1)[: ref_plan.n_lanes])
    assert {i: type(e).__name__ for i, e in failures.items()} == \
        {i: type(e).__name__ for i, e in ref_wp.resolve_rgb_errors(ref_err, ref_plan).items()}
    assert set(failures) == {1}


# --- chunks of mixed geometry: one fused plan per geometry bucket

# A seeded mixed pool: 4:2:0 restart files at several even sizes, an
# odd-size 4:2:0 file (no packed16) and a 4:2:2 file.
MIXED = [make_jpeg(w, h, seed=s, subsampling=2, quality=85, restart_blocks=4)
         for s, (w, h) in enumerate([(32, 24), (48, 32), (32, 24), (64, 48), (48, 32), (32, 24)])] + [
    make_jpeg(35, 27, seed=7, subsampling=2, quality=85, restart_blocks=4),
    make_jpeg(48, 32, seed=8, subsampling=1, quality=85, restart_blocks=4),
]
ODD = 6


@functools.lru_cache(maxsize=None)
def _mixed_want(i: int) -> np.ndarray:
    """PIL's decode of MIXED[i], held equal to the plain reference's."""
    want = pil_decode(MIXED[i])
    plain = plain_ref.rgb(MIXED[i], plain_ref.coefficients(MIXED[i]), "cpu")
    np.testing.assert_array_equal(plain.numpy(), want)
    return want


def _as_hwc(image, layout):
    if layout == "packed16":
        return np.moveaxis(image.view(np.uint8).reshape(image.shape[0], image.shape[1], -1), 0, 2)
    return image


@pytest.mark.parametrize("chunk_size", [3, 8])
@pytest.mark.parametrize("depth,workers", [(1, 1), (2, 3)])
def test_mixed_chunks_stay_fused_bit_exact_and_in_order(chunk_size, depth, workers):
    """Every chunk is planned as geometry buckets and stays on the fused
    path; members come back in order, each equal to PIL and to the plain
    reference; packed16 applies to a chunk whose buckets all take it (even
    4:2:0 and 4:2:2 sizes), and a chunk with the odd-width file is "nhwc"
    throughout."""
    chunks = list(tpujpeg_torch.decode_stream(MIXED, chunk_size=chunk_size, depth=depth, prep_workers=workers,
                                              layout="packed16", **CPU))
    assert [i for ch in chunks for i in ch.members] == list(range(len(MIXED)))
    for ch in chunks:
        assert ch.engine == "wavefront-fused" and not ch.failures
        assert ch.layout == ("nhwc" if ODD in ch.members else "packed16")
        for k, i in enumerate(ch.members):
            np.testing.assert_array_equal(_as_hwc(ch.images[k], ch.layout), _mixed_want(i))


def test_a_corrupt_member_of_a_bucket_fails_only_its_own_slot():
    datas = [MIXED[0], MIXED[1], zero_payload(MIXED[2]), MIXED[5], MIXED[4]]
    (ch,) = tpujpeg_torch.decode_stream(datas, chunk_size=5, **CPU)
    assert ch.engine == "wavefront-fused" and ch.members == [0, 1, 2, 3, 4]
    assert set(ch.failures) == {2} and isinstance(ch.failures[2], tpujpeg_torch.JpegError)
    assert ch.images[2] is None
    for k, m in ((0, 0), (1, 1), (3, 5), (4, 4)):
        np.testing.assert_array_equal(ch.images[k], _mixed_want(m))


@pytest.mark.parametrize("odd_one", ["progressive", "marker_free"])
def test_a_mixed_chunk_with_a_member_the_planner_refuses_falls_back_whole(odd_one):
    """A progressive member, or a marker-free one whose segment overruns
    the fused planner's cap, sends the whole mixed chunk to the fallback,
    bit-exact."""
    extra = (make_jpeg(48, 32, seed=9, subsampling=2, progressive=True) if odd_one == "progressive"
             else make_jpeg(128, 96, seed=1, subsampling=2))
    if odd_one == "marker_free":
        assert len(bitstream.parse(extra).scans[0].data) // 4 + 2 > wf.MAX_WORDS
    datas = [MIXED[0], MIXED[3], extra, MIXED[5]]
    (ch,) = tpujpeg_torch.decode_stream(datas, chunk_size=4, layout="packed16", **CPU)
    assert ch.engine == "fallback" and ch.layout == "nhwc" and not ch.failures
    for k, d in enumerate(datas):
        np.testing.assert_array_equal(ch.images[k], pil_decode(d))


# --- launch groups: a chunk's geometry buckets in one kernel-A launch

def _tiny(w, h, seed, subsampling=2, quality=85, optimize=False, restart=1, kind="photo"):
    from corpus import encode, make_image

    return encode(make_image(w, h, seed=seed, kind=kind), quality=quality, subsampling=subsampling,
                  restart_blocks=restart, optimize=optimize)


def _zero_segment(data: bytes, k: int) -> bytes:
    """The stream with restart segment k of its scan zeroed."""
    d = bytearray(data)
    sos = d.index(b"\xff\xda")
    i = sos + 2 + int.from_bytes(d[sos + 2 : sos + 4], "big")
    seg = 0
    while i < len(d) - 2:
        if d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7:
            seg += 1
            i += 2
            continue
        if d[i] == 0xFF and d[i + 1] == 0xD9:
            break
        if seg == k:
            d[i] = 0
        i += 1
    return bytes(d)


def _groups_of(monkeypatch):
    """Spy on the one RGB entry of restart plans: per call, the geometry
    buckets' sizes of its plan; kernel A's mixed form (a geometry table)
    exactly where the plan has several parts."""
    seen = []
    real = wf.decode_group_to_rgb

    def spy(plan, bucket_jpegs, *a, **k):
        seen.append([len(js) for js in bucket_jpegs])
        assert (plan.geom is None) == (len(bucket_jpegs) == 1)
        assert plan.parts is None or [p.n for p in plan.parts] == seen[-1]
        return real(plan, bucket_jpegs, *a, **k)

    monkeypatch.setattr(wf, "decode_group_to_rgb", spy)
    return seen


def test_combined_plan_through_the_plain_version_equals_bucket_decodes():
    """combine_plans over three 4:2:0 geometry buckets (one at another
    quality) decodes through the plain version, byte for byte and error bit
    for error bit, as each bucket's own plan does: the rows padded to the
    widest, images and quantizer sets renumbered, each image's geometry
    row placing its planes in the flat outputs; a zeroed segment fails its
    own image only."""
    datas = [[_tiny(16, 16, 1), _zero_segment(_tiny(16, 16, 2), 0)], [_tiny(32, 16, 3, quality=70)],
             [_tiny(16, 32, s, quality=90, restart=2) for s in (4, 5)]]
    buckets = [[bitstream.parse(d) for d in ds] for ds in datas]
    plans = [wf.build_block_plan(js) for js in buckets]
    layouts = [wf.PlaneLayout.of(wf.ImageGeom.of(js[0])) for js in buckets]
    assert plans[0].n_words < plans[2].n_words   # the first bucket's rows are padded
    combined = wf.combine_plans(plans, layouts)
    assert combined.n_images == 5 and int(combined.qsets.shape[0]) == 3
    assert [(p.first, p.n) for p in combined.parts] == [(0, 2), (2, 1), (3, 2)]
    assert combined.geom[:, 0].tolist() == [1, 1, 2, 1, 1]
    parts, err = wf.decode_lanes_to_planes(combined, None, "cpu")
    lane0 = 0
    for js, plan, got in zip(buckets, plans, parts):
        want, want_err = wf.decode_lanes_to_planes(plan, [wf.ImageGeom.of(j) for j in js], "cpu")
        np.testing.assert_array_equal(err[lane0:lane0 + plan.n_lanes].numpy(), want_err.numpy())
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        lane0 += plan.n_lanes
    failures = wf.resolve_rgb_errors(err, combined)
    assert sorted(failures) == [1]   # image 1 of the plan: bucket 0's second
    assert isinstance(failures[1], tpujpeg_torch.JpegError)
    (one,) = wf.combine_plans(plans[2:], layouts[2:]).parts
    assert (one.first, one.n, one.offsets) == (0, 2, (0, 0, 0))


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else
                np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y), f.name


def test_plan_launches_groups_and_refusals_on_a_mixed_chunk():
    """The stream's and the ladder's planner on a chunk of mixed geometry:
    buckets by geometry, sampling and color space in order of first
    appearance; the three 4:2:0 buckets in one launch group whose plan is
    combine_plans of their own, the 4:2:2 bucket in a group of its own
    that keeps its bucket's plan (nothing is pinned on the CPU); a bucket
    of mixed Huffman tables and a marker-free scan over the row cap come
    back refused, as their positions. A uniform chunk is one group whose
    plan is its bucket's."""
    datas = [_tiny(16, 16, 1), _tiny(32, 16, 2), _tiny(16, 16, 3), _tiny(32, 16, 4, subsampling=1),
             _tiny(48, 16, 5, optimize=True), _tiny(16, 32, 6), make_jpeg(128, 96, seed=1, subsampling=2),
             _tiny(48, 16, 7)]
    jpegs = [bitstream.parse(d) for d in datas]
    groups, refused = wf.plan_launches(jpegs)
    assert [g.at for g in groups] == [[[0, 2], [1], [5]], [[3]]] and refused == [[4, 7], [6]]
    assert [g.positions for g in groups] == [[0, 2, 1, 5], [3]]
    assert [[[id(j) for j in js] for js in g.jpegs] for g in groups] == \
        [[[id(jpegs[k]) for k in at] for at in g.at] for g in groups]
    plans = [wf.build_block_plan([jpegs[k] for k in at]) for at in ([0, 2], [1], [5], [3])]
    layouts = [wf.PlaneLayout.of(wf.ImageGeom.of(jpegs[k])) for k in (0, 1, 5, 3)]
    _fields_equal(groups[0].plan, wf.combine_plans(plans[:3], layouts[:3]))
    _fields_equal(groups[1].plan, plans[3])
    (uniform,), none = wf.plan_launches([jpegs[0], jpegs[2]])
    assert none == [] and uniform.at == [[0, 1]] and uniform.plan.parts is None
    _fields_equal(uniform.plan, plans[0])
    assert wf.plan_launches([]) == ([], [])


def test_a_corrupt_segment_in_a_launch_group_fails_only_its_image(monkeypatch):
    """One restart segment zeroed in an image of one geometry bucket: the
    chunk's three buckets still share one launch, that image alone fails,
    and its neighbours, in its bucket and the others, equal PIL."""
    seen = _groups_of(monkeypatch)
    datas = [_tiny(16, 16, 1), _tiny(32, 16, 2), _zero_segment(_tiny(32, 16, 3), 1), _tiny(16, 32, 4),
             _tiny(32, 16, 5)]
    (ch,) = tpujpeg_torch.decode_stream(datas, chunk_size=5, layout="packed16", **CPU)
    assert seen == [[1, 3, 1]]
    assert ch.engine == "wavefront-fused" and set(ch.failures) == {2} and ch.images[2] is None
    assert isinstance(ch.failures[2], tpujpeg_torch.JpegError)
    for k in (0, 1, 3, 4):
        np.testing.assert_array_equal(_as_hwc(ch.images[k], ch.layout), pil_decode(datas[k]))


@pytest.mark.parametrize("apart", ["qsets", "tables", "sampling"])
def test_buckets_that_cannot_share_a_launch_take_two_groups_and_stay_fused(monkeypatch, apart):
    """Two geometry buckets whose quantizer sets together pass MAX_QSETS
    (5 + 4 qualities), or whose Huffman tables (optimized tables in one)
    or sampling (4:2:2 in one) differ, take a launch group each, and the
    chunk stays fused, bit-exact."""
    seen = _groups_of(monkeypatch)
    if apart == "qsets":
        datas = ([_tiny(16, 16, s, quality=q) for s, q in enumerate((50, 55, 60, 65, 70))]
                 + [_tiny(32, 16, s, quality=q) for s, q in enumerate((75, 80, 85, 90))])
    elif apart == "tables":
        datas = [_tiny(16, 16, 1), _tiny(16, 16, 2), _tiny(32, 16, 3, optimize=True)]
    else:
        datas = [_tiny(16, 16, 1), _tiny(32, 16, 3, subsampling=1), _tiny(16, 16, 2)]
    (ch,) = tpujpeg_torch.decode_stream(datas, chunk_size=len(datas), **CPU)
    assert len(seen) == 2 and all(len(g) == 1 for g in seen)
    assert ch.engine == "wavefront-fused" and not ch.failures
    for k, d in enumerate(datas):
        np.testing.assert_array_equal(ch.images[k], pil_decode(d))


def test_a_buckets_and_launch_counts_per_chunk(monkeypatch):
    """Traced (a unit adopted on the consuming thread, as under a profile),
    each chunk counts one ``a_buckets`` record per kernel-A launch (the
    buckets it decodes) and one ``launch`` per kernel: a chunk of three
    4:2:0 buckets 1 + 3 (A once, the planar kernel per bucket), a uniform
    chunk 1 + 1, a chunk of 4:2:0 and 4:2:2 buckets 2 + 2; the benchmark's
    a_buckets_per_launch.shard reads (3 + 1 + 1 + 1) / 4."""
    import types

    from jpegbench import harness
    from tpujpeg_torch import spans
    from tpujpeg_torch.kernels import build, pipeline

    real_plain = wf.decode_lanes_plain

    def plain(plan, *a, **k):   # the launch kernel A makes on the card
        build.launched("wavefront_pixels_mixed" if plan.geom is not None else "wavefront_pixels")
        return real_plain(plan, *a, **k)

    monkeypatch.setattr(wf, "decode_lanes_plain", plain)
    for key, name in ((pipeline._H2V2, "upsample_color_h2v2_planar"), (pipeline._H2V1, "upsample_color_h2v1_planar")):
        def color(*planes, _real=pipeline._PACKED_KERNELS[key], _name=name):
            build.launched(_name)
            return _real(*planes)

        monkeypatch.setitem(pipeline._PACKED_KERNELS, key, color)
    datas = [_tiny(16, 16, 1), _tiny(32, 16, 2), _tiny(16, 32, 3),
             _tiny(16, 16, 4), _tiny(16, 16, 5), _tiny(16, 16, 6),
             _tiny(16, 16, 7), _tiny(32, 16, 8, subsampling=1), _tiny(16, 16, 9)]
    spans.drain()
    with spans.adopt(-1):
        chunks = list(tpujpeg_torch.decode_stream(datas, chunk_size=3, layout="packed16", **CPU))
    recs = spans.drain()
    assert [ch.engine for ch in chunks] == ["wavefront-fused"] * 3 and not any(ch.failures for ch in chunks)
    a_buckets = {u: [r.n for r in recs if r.name == spans.A_BUCKETS and r.unit == u] for u in range(3)}
    launches = {u: sum(r.n for r in recs if r.name == spans.LAUNCH and r.unit == u) for u in range(3)}
    assert a_buckets == {0: [3], 1: [1], 2: [1, 1]} and launches == {0: 4, 1: 2, 2: 4}
    run = types.SimpleNamespace(port=types.SimpleNamespace(spans=types.SimpleNamespace(drain=lambda: recs)),
                                trace=object(), records=[{"engine": ch.engine} for ch in chunks])
    assert harness.reader("a_buckets_per_launch.shard").read(run) == pytest.approx(6 / 4)
