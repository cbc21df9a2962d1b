"""The port's marker-free path on device="cpu" (kernels A and 2's plain
versions): the skeleton split, ``build_norst_plan``,
``decode_norst_to_device``, ``decode_norst_to_rgb`` and the routing that
reaches them, against the reference's planner (host numpy, no compile),
its pure-python entropy oracle (``tpujpeg.huffman.decode_all_scans``),
PIL, and once against the reference's own norst entries in interpret
mode. Tolerance 0 throughout: every output is integer."""

import numpy as np
import pytest
import torch

from corpus import make_jpeg, make_multiscan_jpeg, pil_decode

import tpujpeg
from tpujpeg import bitstream as ref_bitstream
from tpujpeg import huffman as ref_huffman
from tpujpeg.kernels import wavefront_pallas as rwp

import tpujpeg_torch
from tpujpeg_torch import DecodeConfig, bitstream
from tpujpeg_torch.kernels import wavefront as wf
from tpujpeg_torch.native import entropy as native_entropy

# The reference tests' norst corpus (tests/test_wavefront_pallas.py) and
# the oversize-restart shape of the fixture rst_rows_420, at (w, h, kw).
PLAN_CASES = {
    "420_512": (512, 512, dict(seed=5, subsampling=2)),
    "420_168": (168, 120, dict(seed=21, subsampling=2)),
    "422_168": (168, 120, dict(seed=21, subsampling=1)),
    "444_168": (168, 120, dict(seed=21, subsampling=0)),
    "gray_168": (168, 120, dict(seed=21, mode="L")),
    "gray_256": (256, 192, dict(seed=6, mode="L")),
    "444_256": (256, 192, dict(seed=6, subsampling=0)),
    "dri192_512": (512, 256, dict(seed=22, subsampling=2, restart_blocks=192)),
    "dri256_512": (512, 512, dict(seed=8, subsampling=2, restart_blocks=256)),
    "dri128_444": (320, 256, dict(seed=9, subsampling=0, restart_blocks=128)),
    "rows_420": (256, 192, dict(seed=14, quality=85, subsampling=2, restart_rows=1)),
    "420_128": (128, 96, dict(seed=23, subsampling=2)),
}


def _data(name):
    w, h, kw = PLAN_CASES[name]
    return make_jpeg(w, h, **kw)


def _flat_ref(plan):
    """The reference's [G, 8, K, ...] norst plan as flat [L, ...] numpy."""
    L = plan.n_lanes
    return dict(
        bits=np.asarray(plan.bits).reshape(-1, plan.n_words)[:L],
        seg_bits=np.asarray(plan.seg_bits).reshape(-1)[:L],
        lane_m=np.asarray(plan.lane_m).reshape(-1)[:L],
        bit0=np.asarray(plan.bit0).reshape(-1)[:L],
        dc0=np.asarray(plan.lane_dc0).transpose(0, 2, 3, 1).reshape(-1, 4)[:L],
        lane_meta=np.asarray(plan.lane_meta),
        qsets=np.asarray(plan.qsets, np.int32),
    )


PLAN_EVERY = [(n, 0) for n in PLAN_CASES] + [(n, e) for n in ("420_168", "dri192_512", "rows_420")
                                               for e in (1, 3)]


@pytest.mark.parametrize("name,every", PLAN_EVERY, ids=[f"{n}-every{e}" for n, e in PLAN_EVERY])
def test_build_norst_plan_matches_reference(name, every):
    """Field for field, including every's snapping and halving."""
    data = _data(name)
    want = rwp.build_norst_plan(ref_bitstream.parse(data), every)
    got = wf.build_norst_plan(bitstream.parse(data), every)
    flat = _flat_ref(want)
    assert got.n_lanes == want.n_lanes and got.n_words == want.n_words
    for field in ("bits", "seg_bits", "lane_m", "bit0", "dc0", "lane_meta", "qsets"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), flat[field], err_msg=field)
    assert not got.lane_qset.any() and got.img_qset == (0,) and got.n_images == 1
    assert got.norst_every == want.norst_every and got.n_mcus == want.n_mcus
    np.testing.assert_array_equal(got.seg_first, want.seg_first)
    np.testing.assert_array_equal(got.lane_seg, want.lane_seg)
    assert got.blk_tables == wf.plan_from_reference(want).blk_tables
    assert got.n_lanes > 1


def test_plan_from_reference_carries_the_start_state():
    data = _data("dri192_512")
    want = rwp.build_norst_plan(ref_bitstream.parse(data))
    got = wf.plan_from_reference(want)
    mine = wf.build_norst_plan(bitstream.parse(data))
    for field in ("bits", "seg_bits", "bit0", "dc0", "lane_meta"):
        assert getattr(got, field).equal(getattr(mine, field)), field
    assert got.norst_every == mine.norst_every
    np.testing.assert_array_equal(got.seg_first, mine.seg_first)
    assert wf.plan_from_reference(rwp.build_block_plan([ref_bitstream.parse(
        make_jpeg(64, 48, seed=1, restart_blocks=2))])).bit0 is None


@pytest.mark.parametrize("kw", [dict(), dict(restart_blocks=64)], ids=["norst", "rst64"])
def test_native_skeleton_walk_matches_python_walk(kw):
    """The native walk (scan_split_buf) against the port's plain walk and
    the reference's, segment by segment: bit offsets and DC predictors."""
    data = make_jpeg(160, 128, seed=17, subsampling=2, **kw)
    jpeg = bitstream.parse(data)
    scan = jpeg.scans[0]
    ref_jpeg = ref_bitstream.parse(data)
    dest, starts = native_entropy.destuff_segments(scan)
    total, _sp = native_entropy._blocks_sp(jpeg, scan)
    ri = scan.restart_interval or total
    mcu = si = 0
    while mcu < total:
        n_m = min(ri, total - mcu)
        sub = dest[int(starts[si]): int(starts[si + 1])]
        got, got_dc = native_entropy.scan_split_buf(sub, jpeg, scan, n_m, 7)
        want, want_dc = wf._skeleton_walk_py(bytes(sub), jpeg, scan, n_m, 7)
        ref, ref_dc = rwp._skeleton_walk_py(bytes(sub), ref_jpeg, ref_jpeg.scans[0], n_m, 7)
        for a, b in ((got, want), (got_dc, want_dc), (want, ref), (want_dc, ref_dc)):
            np.testing.assert_array_equal(a, b)
        mcu += n_m
        si += 1


def test_skeleton_walk_error_classes():
    """The plain walk raises what the native one raises: on a stream cut
    to a quarter and on one of all 1-bits (no valid code)."""
    data = make_jpeg(160, 128, seed=17, subsampling=2)
    jpeg = bitstream.parse(data)
    scan = jpeg.scans[0]
    dest, _ = native_entropy.destuff_segments(scan)
    total, _sp = native_entropy._blocks_sp(jpeg, scan)
    for bad in (dest[: len(dest) // 4], np.full(len(dest), 0xFF, np.uint8)):
        raised = []
        for walk in (lambda d: wf._skeleton_walk_py(bytes(d), jpeg, scan, total, 7),
                     lambda d: native_entropy.scan_split_buf(d, jpeg, scan, total, 7)):
            with pytest.raises(tpujpeg_torch.JpegError) as exc:
                walk(bad)
            raised.append(type(exc.value))
        assert raised[0] is raised[1] is tpujpeg_torch.JpegHuffmanError


@pytest.mark.parametrize("name", ["420_512", "gray_256", "444_256", "dri256_512", "422_168", "rows_420"])
def test_decode_norst_to_device_matches_oracle(name):
    data = _data(name)
    want = ref_huffman.decode_all_scans(ref_bitstream.parse(data))
    got = wf.decode_norst_to_device(bitstream.parse(data), device="cpu")
    assert len(got) == len(want)
    for ci, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.int32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"component {ci}")


@pytest.mark.parametrize("name", ["420_168", "422_168", "444_168", "gray_168", "dri192_512", "rows_420"])
def test_decode_norst_to_rgb_matches_pil(name):
    data = _data(name)
    jpeg = bitstream.parse(data)
    assert wf.build_norst_plan(jpeg).dc0 is not None
    rgb = wf.decode_norst_to_rgb(jpeg, device="cpu")
    np.testing.assert_array_equal(rgb.numpy(), pil_decode(data))


@pytest.mark.parametrize("name", ["420_128", "422_168"])
def test_decode_norst_to_rgb_packed_matches_pil(name):
    data = _data(name)
    out = wf.decode_norst_to_rgb(bitstream.parse(data), packed=True, device="cpu")
    want = pil_decode(data)
    assert out.dtype == torch.uint16
    got = out.numpy().view(np.uint8).reshape(3, want.shape[0], want.shape[1]).transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("every", [1, 2, 3])
def test_decode_norst_every_matches_pil(every):
    """The split's granularity changes the lanes, not the image: every=1
    (one lane per MCU) and others, through both entries."""
    data = _data("dri192_512")
    jpeg = bitstream.parse(data)
    plan = wf.build_norst_plan(jpeg, every)
    assert plan.norst_every == every
    np.testing.assert_array_equal(wf.decode_norst_to_rgb(jpeg, every=every, device="cpu").numpy(),
                                  pil_decode(data))
    want = ref_huffman.decode_all_scans(ref_bitstream.parse(data))
    for a, b in zip(wf.decode_norst_to_device(jpeg, every=every, device="cpu"), want):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.fixture(scope="module")
def reference_norst():
    """The reference's own norst entries (interpret mode) on one stream:
    the single reference compile of this file."""
    data = make_jpeg(128, 96, seed=23, subsampling=2)
    jpeg = ref_bitstream.parse(data)
    coeffs = [np.asarray(c) for c in rwp.decode_norst_to_device(jpeg)]
    rgb = np.asarray(rwp.decode_norst_to_rgb(ref_bitstream.parse(data)))
    return data, coeffs, rgb


def test_decode_norst_to_device_matches_reference_entry(reference_norst):
    data, coeffs, _rgb = reference_norst
    got = wf.decode_norst_to_device(bitstream.parse(data), device="cpu")
    for a, b in zip(got, coeffs):
        np.testing.assert_array_equal(a.numpy(), b)


def test_decode_norst_to_rgb_matches_reference_entry(reference_norst):
    data, _coeffs, rgb = reference_norst
    got = wf.decode_norst_to_rgb(bitstream.parse(data), device="cpu")
    np.testing.assert_array_equal(got.numpy(), rgb)
    np.testing.assert_array_equal(got.numpy(), pil_decode(data))


@pytest.mark.parametrize("entry", ["to_device", "to_rgb"])
def test_truncated_norst_scan_raises(entry):
    """The scan cut in half: the skeleton walk runs past the data
    (JpegTruncatedError), as in the reference's test."""
    data = make_jpeg(256, 256, seed=8, subsampling=2)
    jpeg = bitstream.parse(data)
    scan = jpeg.scans[0]
    scan.data = scan.data[: len(scan.data) // 2]
    fn = wf.decode_norst_to_device if entry == "to_device" else wf.decode_norst_to_rgb
    with pytest.raises(tpujpeg_torch.JpegError):
        fn(jpeg, device="cpu")


def test_lane_error_raises_the_lowest_failing_lane():
    """Lanes that fail in the decode (a row overwritten after planning):
    the entries raise the error of the lowest failing lane, as
    failures_from_err maps it."""
    data = _data("420_512")
    jpeg = bitstream.parse(data)
    plan = wf.build_norst_plan(jpeg)
    plan.bits[5:] = -1  # 0xFFFFFFFF: no valid code from lane 5 on
    layout = wf.PlaneLayout.of(wf.ImageGeom.of(jpeg))
    outs = layout.alloc(1, "cpu", "coeff")
    err = torch.zeros(plan.n_lanes, dtype=torch.int32)
    wf.decode_lanes_plain(plan, layout, outs, err, "coeff")
    assert not err[:5].any() and err[5:].all()
    failures = wf.resolve_rgb_errors(err, plan)
    assert list(failures) == [0] and "segment 5 " in str(failures[0])


FUZZ_BASE = make_jpeg(160, 128, seed=44, subsampling=2)  # tests/test_fuzz.py's NORST_BASE


def _fuzz_mutations():
    """tests/test_fuzz.py's _mutate(NORST_BASE, seed=10)."""
    rng = np.random.default_rng(10)
    out = [FUZZ_BASE[: int(len(FUZZ_BASE) * frac)] for frac in (0.2, 0.5, 0.8, 0.97)]
    for _ in range(20):
        pos = int(rng.integers(2, len(FUZZ_BASE) - 2))
        mut = bytearray(FUZZ_BASE)
        mut[pos] ^= int(rng.integers(1, 256))
        out.append(bytes(mut))
    return out


@pytest.mark.parametrize("i", range(24))
def test_fuzz_norst_device_engine(i):
    """A corrupt marker-free stream through decode() with the wavefront
    engine and with auto (the fused norst path): a JpegError or a sane
    image, never another exception."""
    mut = _fuzz_mutations()[i]
    for config in (DecodeConfig(entropy_engine="wavefront"), DecodeConfig()):
        try:
            out = tpujpeg_torch.decode(mut, config, device="cpu")
        except tpujpeg_torch.JpegError:
            continue
        assert out.ndim in (2, 3) and out.shape[0] > 0


FAULT_INPUTS = {
    "oversize_segment": make_jpeg(96, 64, seed=9, subsampling=0),
    "multi_scan": make_multiscan_jpeg(96, 80, seed=9, subsampling=2),
    "multi_scan_oversize_dri": make_multiscan_jpeg(96, 80, seed=9, subsampling=2, restart_blocks=200),
}


@pytest.mark.parametrize("name", list(FAULT_INPUTS))
def test_wavefront_engine_routes_to_the_norst_plan(name):
    """decode_all_scans falls back to decode_norst_to_device for a single
    scan the restart planner refuses, and decode_multiscan_to_device per
    sub-scan: the oracle's coefficients."""
    data = FAULT_INPUTS[name]
    want = ref_huffman.decode_all_scans(ref_bitstream.parse(data))
    got = wf.decode_all_scans(bitstream.parse(data), device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_decode_routes_marker_free_streams_like_the_reference():
    """decode(): "auto" takes the fused path on the norst plan, with no
    fallback counted, as the reference's _decode_fused_single; the
    wavefront engine the staged path through kernel 2 on the norst plan;
    both equal tpujpeg.decode and PIL."""
    data = make_jpeg(128, 96, seed=4, subsampling=1)
    want = pil_decode(data)
    np.testing.assert_array_equal(np.asarray(tpujpeg.decode(data)), want)
    for config, engine, fallbacks in ((DecodeConfig(), "wavefront-fused-norst", 0),
                                      (DecodeConfig(entropy_engine="wavefront"), "wavefront", 1),
                                      (DecodeConfig(transform_engine="torch"), "native", 0)):
        got, st = tpujpeg_torch.decode(data, config, device="cpu", return_stats=True)
        assert (st.entropy_engine, st.entropy_fallbacks) == (engine, fallbacks)
        np.testing.assert_array_equal(got, want)


def test_batch_ladder_takes_the_skeleton_rung():
    """decode_batch_on_device: marker-free and oversize-restart images
    take decode_norst_to_rgb ("wavefront-skeleton"), a corrupt one fails
    alone with the class decode() raises, and the restart image beside
    them stays on the shared fused launch."""
    norst = make_jpeg(160, 128, seed=31, subsampling=2)
    rows = make_jpeg(512, 64, seed=32, subsampling=2, restart_rows=1)
    good = make_jpeg(160, 128, seed=33, subsampling=2, restart_blocks=4)
    bad = bytearray(norst)
    sos = bad.index(b"\xff\xda")
    bad[sos + 40: sos + 400] = bytes(360)
    bad = bytes(bad)
    with pytest.raises(tpujpeg_torch.JpegError) as want_exc:
        tpujpeg_torch.decode(bad, device="cpu")
    res = tpujpeg_torch.decode_batch_on_device([norst, rows, good, bad], device="cpu")
    assert {i: type(e) for i, e in res.errors.items()} == {3: type(want_exc.value)}
    assert [s.entropy_engine for s in res.stats[:3]] == ["wavefront-skeleton"] * 2 + ["wavefront-fused"]
    for d, img in zip((norst, rows, good), res.images):
        np.testing.assert_array_equal(img, pil_decode(d))


# -- the card's split (card_every, card_norst_plan): kernel A's wave ------------

WAVE_H100 = 132 * 4 * 128   # SMs x resident CTAs of kernel A x threads per CTA


@pytest.mark.parametrize("total,wave,ri,default,want", [
    (129_600, WAVE_H100, 129_600, 18, 2), (64_800, WAVE_H100, 64_800, 12, 1),
    (16_384, WAVE_H100, 16_384, 8, 1), (129_600, 1024, 129_600, 18, 18),
    (129_600, 1024, 129_600, 10**6, 120), (1_049, 100, 10, 10**6, 10), (1_051, 100, 22, 10**6, 11)])
def test_card_every_fills_one_wave(total, wave, ri, default, want):
    """4K 4:4:4 (129,600 MCUs) takes two MCUs a lane on 132 SMs of 4 CTAs;
    4K 4:2:2 (64,800) and 2048² 4:2:0 (16,384) one; elsewhere the MCUs
    over the wave, to the nearest whole count, at most the scan's default,
    snapped to a divisor of the restart interval."""
    assert wf.card_every(total, wave, ri, default) == want


def test_card_every_divides_the_interval_and_keeps_under_the_default():
    for ri in (1, 2, 6, 7, 12, 48, 97, 192, 360):
        for default in range(1, 40):
            for total in (ri, 3 * ri, 1000 * ri):
                for wave in (1, 5, 64, 1000, WAVE_H100):
                    e = wf.card_every(total, wave, ri, wf._snap_divisor(default, ri))
                    assert 1 <= e <= default and ri % e == 0, (ri, default, total, wave)


@pytest.mark.parametrize("name", ["dri192_512", "rows_420", "420_512", "444_256"])
@pytest.mark.parametrize("wave", [16, 64, 10**6])
def test_card_plan_split_divides_the_interval(name, wave):
    """On restart intervals over the row cap (dri192_512, rows_420) and
    marker-free scans: the card split divides the interval, stays at or
    under the reference's default, and is that default's plan at its own
    `every`, rows cut to 4-word steps."""
    jpeg = bitstream.parse(_data(name))
    scan = jpeg.scans[0]
    total = wf._segment_mcus(jpeg.frame, scan)
    ri = scan.restart_interval or total
    default = wf.build_norst_plan(jpeg).norst_every
    card = wf.build_norst_plan(jpeg, wave=lambda blk: wave)
    assert ri % card.norst_every == 0 and card.norst_every <= default
    assert card.norst_every == wf.card_every(total, wave, ri, default)
    ref = wf.build_norst_plan(jpeg, card.norst_every)
    assert card.n_words % 4 == 0 and card.n_words <= ref.n_words
    assert torch.equal(card.bits, ref.bits[:, : card.n_words])


NARROW = [(n, e) for n in PLAN_CASES for e in (1, 3)]


def _no_wave(blk):
    raise AssertionError("an explicit every asks for no wave")


@pytest.mark.parametrize("name,every", NARROW, ids=[f"{n}-every{e}" for n, e in NARROW])
def test_narrow_rows_match_reference(name, every):
    """A card plan's rows (4-word steps) at an explicit `every`: every field
    the reference's plan's at that `every`, and each row the first W words
    of the reference's row."""
    data = _data(name)
    want = rwp.build_norst_plan(ref_bitstream.parse(data), every)
    got = wf.build_norst_plan(bitstream.parse(data), every, wave=_no_wave)
    flat = _flat_ref(want)
    W = got.n_words
    assert W % 4 == 0 and W <= want.n_words and got.n_lanes == want.n_lanes
    np.testing.assert_array_equal(got.bits.numpy(), flat["bits"][:, :W])
    for field in ("seg_bits", "lane_m", "bit0", "dc0", "lane_meta", "qsets"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), flat[field], err_msg=field)
    # W covers every lane's bits and the word after its last: the kernels
    # never read past a sound lane's row.
    assert int(((got.seg_bits + 31) // 32).max()) + 1 <= W
    assert got.norst_every == want.norst_every and got.n_mcus == want.n_mcus
    np.testing.assert_array_equal(got.seg_first, want.seg_first)
    np.testing.assert_array_equal(got.lane_seg, want.lane_seg)


@pytest.mark.parametrize("name", ["420_128", "422_168", "444_168", "gray_168", "dri128_444"])
def test_card_plan_decodes_like_pil(name):
    """A card plan (a small wave: many lanes, narrow rows) through kernel
    A's plain version and the color stage gives PIL's bytes."""
    data = _data(name)
    jpeg = bitstream.parse(data)
    plan = wf.build_norst_plan(jpeg, wave=lambda blk: 4096)
    assert plan.n_words < 32
    (rgb,), _layout, err = wf.decode_group_to_rgb(plan, [[jpeg]], device="cpu")
    assert not err.any() and wf.resolve_rgb_errors(err, plan) == {}
    np.testing.assert_array_equal(rgb[0].numpy(), pil_decode(data))


def test_card_plan_counts_its_lanes_and_wave_in_the_unit():
    """norst_lanes (the plan's lanes) and norst_wave (the wave it was cut
    for) once per card plan, in the traced unit, under its plan span; a
    plan of the reference's split counts nothing."""
    from tpujpeg_torch import spans

    jpeg = bitstream.parse(_data("420_512"))
    seen = []
    spans.drain()
    with spans.adopt(12):
        plan = wf.build_norst_plan(jpeg, wave=lambda blk: seen.append(blk) or 100)
        wf.build_norst_plan(jpeg)
        wf.build_norst_plan(jpeg, 3, wave=lambda blk: 100)
    recs = spans.drain()
    counts = {r.name: r for r in recs if r.id is None}
    assert set(counts) == {spans.NORST_LANES, spans.NORST_WAVE}
    assert (counts[spans.NORST_LANES].n, counts[spans.NORST_WAVE].n) == (plan.n_lanes, 100)
    (first_plan,) = [r for r in recs if r.name == spans.PLAN][:1]
    assert all(r.unit == 12 and r.parent == first_plan.id for r in counts.values())
    assert seen == [plan.blk_tables]


def test_cpu_entries_keep_the_reference_split(monkeypatch):
    """On the CPU, decode_norst_to_rgb and decode() never take the card's
    split; neither does an explicit `every`."""
    def refuse(*a, **k):
        raise AssertionError("card split on the CPU")

    monkeypatch.setattr(wf, "card_norst_plan", refuse)
    data = _data("422_168")
    np.testing.assert_array_equal(wf.decode_norst_to_rgb(bitstream.parse(data), device="cpu").numpy(),
                                  pil_decode(data))
    np.testing.assert_array_equal(tpujpeg_torch.decode(data, device="cpu"), pil_decode(data))
