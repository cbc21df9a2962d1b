"""The port's pipelined stream (tpujpeg_torch.parallel.stream) on
device="cpu", where the kernels' plain versions run: the eight cases of
tests/test_stream.py with the same corpus calls, byte for byte against
PIL; identical outputs whatever the depth and the number of prep
workers; config.to_numpy; chunks of mixed geometry, one fused plan per
geometry bucket, against PIL and the benchmark's plain reference
(jpegbench.reference, plain torch and numpy); and the reference's return
forms of decode_all_scans_to_rgb_batch (packed, defer_errors, layout) and
decode_batch_to_rgb (defer_errors). Tolerance 0."""

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
