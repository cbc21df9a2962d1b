"""Kernel A's module (tpujpeg_torch.kernels.wavefront) against the
reference Pallas wavefront, run in interpret mode: the planner, the
plain lane decoder's component planes and per-lane error codes, and the
planner's rejections. Inputs are the reference tests' own corpus calls.
Tolerance 0."""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from corpus import encode, make_image, make_jpeg, make_multiscan_jpeg
from test_fuzz import BASE as FUZZ_BASE
from test_fuzz import _mutations
from test_wavefront_pallas import FUSED_CASES

from tpujpeg import bitstream as ref_bitstream
from tpujpeg.errors import JpegError as RefJpegError
from tpujpeg.kernels import wavefront_pallas as wp

from tpujpeg_torch import JpegError, bitstream
from tpujpeg_torch.kernels import wavefront as pw


def _case(case, seed=9):
    kw = dict(case)
    w, h = kw.pop("w"), kw.pop("h")
    return make_jpeg(w, h, seed=seed, **kw)


def _parse_both(datas, mutate=None):
    ref = [ref_bitstream.parse(d) for d in datas]
    port = [bitstream.parse(d) for d in datas]
    if mutate:
        mutate(ref)
        mutate(port)
    return ref, port


def _reference(jpegs):
    """(plan, per-component planes, per-lane err) from the reference's
    run_wavefront(emit="pixels") + assemble_pixels_stacked."""
    plan = wp.build_block_plan(jpegs)
    out, err = wp.run_wavefront(
        jnp.asarray(plan.bits), jnp.asarray(plan.lane_m), jnp.asarray(plan.seg_bits),
        plan.static_key("pixels"), plan.n_groups, True, jnp.asarray(plan.lane_qset),
    )
    geoms = tuple(wp.ImageGeom.of(j) for j in jpegs)
    planes = wp.assemble_pixels_stacked((plan.blocks_per_mcu, plan.n_mcus, plan.n_groups), out, geoms)
    return plan, [np.asarray(p) for p in planes], np.asarray(err).reshape(-1)[: plan.n_lanes]


def _port(plan, jpegs):
    planes, err = pw.decode_lanes_to_planes(plan, [pw.ImageGeom.of(j) for j in jpegs], "cpu")
    return [p.numpy() for p in planes], err.numpy()


def _assert_same_decode(ref_jpegs, port_jpegs):
    ref_plan, ref_planes, ref_err = _reference(ref_jpegs)
    for plan in (pw.build_block_plan(port_jpegs), pw.plan_from_reference(ref_plan)):
        planes, err = _port(plan, port_jpegs)
        np.testing.assert_array_equal(err, ref_err)
        assert len(planes) == len(ref_planes)
        for ci, (a, b) in enumerate(zip(planes, ref_planes)):
            np.testing.assert_array_equal(a, b, err_msg=f"component {ci}")
    return ref_err


def _assert_same_plan(a: pw.LanePlan, b: pw.LanePlan):
    for name in ("bits", "seg_bits", "lane_m", "lane_qset", "lane_meta", "tables", "huffval", "qsets"):
        np.testing.assert_array_equal(getattr(a, name).numpy(), getattr(b, name).numpy(), err_msg=name)
    assert (a.n_words, a.n_mcus, a.n_images, a.img_qset) == (b.n_words, b.n_mcus, b.n_images, b.img_qset)
    assert a.blk_tables == b.blk_tables


MIXED_INTERVALS = [
    dict(w=120, h=88, seed=1, subsampling=2, restart_blocks=4),
    dict(w=120, h=88, seed=2, subsampling=2, restart_blocks=2),
    dict(w=120, h=88, seed=3, subsampling=2, restart_blocks=7),
]
MIXED_QUANTIZERS = [
    dict(w=120, h=88, seed=1, subsampling=2, quality=85, restart_blocks=4),
    dict(w=120, h=88, seed=2, subsampling=2, quality=92, restart_blocks=4),
    dict(w=120, h=88, seed=3, subsampling=2, quality=85, restart_blocks=4),
]
MIXED_QUANTIZERS_AND_INTERVALS = [
    dict(w=96, h=80, seed=1, subsampling=0, quality=70, restart_blocks=2),
    dict(w=96, h=80, seed=2, subsampling=0, quality=95, restart_blocks=3),
]


def _batch(cases):
    return [_case({k: v for k, v in c.items() if k != "seed"}, c["seed"]) for c in cases]


PLAN_BATCHES = {
    **{f"fused{i}": [_case(c)] for i, c in enumerate(FUSED_CASES)},
    "mixed_intervals": _batch(MIXED_INTERVALS),
    "mixed_quantizers": _batch(MIXED_QUANTIZERS),
    "mixed_quantizers_and_intervals": _batch(MIXED_QUANTIZERS_AND_INTERVALS),
}


@pytest.mark.parametrize("name", list(PLAN_BATCHES))
def test_planner_matches_reference(name):
    ref, port = _parse_both(PLAN_BATCHES[name])
    ref_plan = wp.build_block_plan(ref)
    plan = pw.build_block_plan(port)
    assert plan.n_words == ref_plan.n_words
    _assert_same_plan(plan, pw.plan_from_reference(ref_plan))


@pytest.mark.parametrize("case", FUSED_CASES, ids=[str(i) for i in range(len(FUSED_CASES))])
def test_lane_decoder_planes_match_reference(case):
    ref, port = _parse_both([_case(case)])
    err = _assert_same_decode(ref, port)
    assert not err.any()


def _zero_last_scan(jpegs):
    jpegs[-1].scans[0].data = bytes(len(jpegs[-1].scans[0].data))


def test_lane_decoder_errors_match_reference():
    """One launch holding the reference tests' mixed-interval and
    mixed-quantizer batches (test_fused_pixels_mixed_restart_intervals,
    ..._mixed_quantizers) and, last, the zeroed-scan member of
    test_fused_pixels_batch_and_fault_isolation."""
    cases = MIXED_INTERVALS + MIXED_QUANTIZERS[1:]
    datas = _batch(cases) + [make_jpeg(120, 88, seed=0, subsampling=2, restart_blocks=4)]
    ref, port = _parse_both(datas, _zero_last_scan)
    err = _assert_same_decode(ref, port)
    lanes = pw.build_block_plan(port).lane_meta.numpy()
    assert set(lanes[np.nonzero(err)[0], 0]) == {len(cases)}


def _fuzz_batch(limit=8):
    """The base stream plus the test_fuzz mutations that parse and plan
    in one batch with it (scan-data corruptions: same tables and
    geometry), in _mutations() order."""
    keep = [FUZZ_BASE]
    base = ref_bitstream.parse(FUZZ_BASE)
    for mut in _mutations():
        try:
            wp.build_block_plan([base, ref_bitstream.parse(mut)])
        except RefJpegError:
            continue
        if mut != FUZZ_BASE:
            keep.append(mut)
        if len(keep) > limit:
            break
    return keep


def test_lane_decoder_fuzz_errors_match_reference():
    datas = _fuzz_batch()
    assert len(datas) > 4
    ref, port = _parse_both(datas)
    err = _assert_same_decode(ref, port)
    assert err.any()


def _raises(fn):
    try:
        fn()
    except (JpegError, RefJpegError) as e:
        return type(e).__name__
    return None


REJECTED = {
    "progressive": [make_jpeg(64, 64, seed=1, subsampling=2, progressive=True)],
    "mixed_geometry": [make_jpeg(64, 48, seed=1, subsampling=2), make_jpeg(48, 64, seed=1, subsampling=2)],
    "oversize_segment": [make_jpeg(96, 64, seed=9, subsampling=0)],
    "multi_scan": [make_multiscan_jpeg(96, 80, seed=9, subsampling=2, restart_blocks=4)],
    "mixed_tables": [
        encode(make_image(64, 48, seed=s), subsampling=2, optimize=True, restart_blocks=2)
        for s in (1, 2)
    ],
    "too_many_qsets": [make_jpeg(32, 32, seed=1, quality=q, restart_blocks=2) for q in range(60, 69)],
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_planner_rejects_what_the_reference_rejects(name):
    ref, port = _parse_both(REJECTED[name])
    # The quantizer-set limit is the fused entry's, in both decoders; the
    # planners (and so the coefficient entries) take any number of sets.
    if name == "too_many_qsets":
        want = _raises(lambda: wp.decode_batch_to_rgb(ref))
        got = _raises(lambda: pw.decode_batch_to_rgb(port, device="cpu"))
        assert _raises(lambda: pw.build_block_plan(port)) is None
    else:
        want = _raises(lambda: wp.build_block_plan(ref))
        got = _raises(lambda: pw.build_block_plan(port))
    assert want == "JpegUnsupportedError"
    assert got == want


def test_failures_from_err_priority():
    meta = np.array([[0, 0, 1], [0, 1, 1], [1, 0, 1], [2, 0, 1], [2, 1, 1]], np.int32)
    errs = np.array([0, 4 | 2, 1 | 4, 0, 2], np.int32)
    got = {i: type(e).__name__ for i, e in pw.failures_from_err(errs, meta).items()}
    want = {i: type(e).__name__ for i, e in wp.failures_from_err(errs, meta).items()}
    assert got == want == {0: "JpegHuffmanError", 1: "JpegHuffmanError", 2: "JpegHuffmanError"}
    assert "segment 1" in str(pw.failures_from_err(errs, meta)[0])


def test_decode_lanes_rejects_unknown_device():
    jpeg = bitstream.parse(_case(FUSED_CASES[3]))
    plan = pw.build_block_plan([jpeg])
    with pytest.raises(ValueError):
        pw.decode_lanes_to_planes(plan, [pw.ImageGeom.of(jpeg)], torch.device("meta"))


# ---------------------------------------------------------------------------
# The kernels' 9-bit lookahead rule (tj_lookahead_entry, csrc/common.cuh)
# ---------------------------------------------------------------------------


def _synthetic_spec(counts_at):
    counts = np.zeros(16, np.int64)
    for length, n in counts_at.items():
        counts[length - 1] = n
    values = (np.arange(int(counts.sum())) * 7 % 256).astype(np.uint8)
    return types.SimpleNamespace(counts=counts, values=values)


def _lookahead_tables():
    """Every distinct Huffman table of the committed fixtures, and three
    synthetic ones: codes only up to 9 bits, codes only from 10 bits,
    and a table with unused lengths between its codes."""
    fixtures = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "tpujpeg_torch", "fixtures")
    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)
    tables, seen = {}, set()
    for name, entry in manifest["fixtures"].items():
        with open(os.path.join(fixtures, entry["file"]), "rb") as f:
            jpeg = bitstream.parse(f.read())
        for si, scan in enumerate(jpeg.scans):
            for (cls, tid), spec in sorted(scan.huff.items()):
                if pw._spec_key(spec) not in seen:
                    seen.add(pw._spec_key(spec))
                    tables[f"{name}-scan{si}-{'ac' if cls else 'dc'}{tid}"] = pw.CanonTable.from_spec(spec)
    for name, counts in (("only_short", {2: 1, 3: 5, 4: 1, 5: 1, 6: 1, 7: 1, 8: 1, 9: 1}),
                         ("only_long", {10: 200, 16: 56}),
                         ("unused_lengths", {2: 2, 5: 6, 12: 100, 16: 50})):
        tables[name] = pw.CanonTable.from_spec(_synthetic_spec(counts))
    return tables


LOOKAHEAD_TABLES = _lookahead_tables()


@pytest.mark.parametrize("name", list(LOOKAHEAD_TABLES))
def test_lookahead_table_and_walk_from_10_match_decode_symbol(name):
    """For every 16-bit window, the lookahead entry, or where it is 0 the
    maxcode walk from length 10, gives _decode_symbol's (symbol, length),
    invalid codes (length 17, huffval[0]) included."""
    t = LOOKAHEAD_TABLES[name]
    win = torch.arange(1 << 16, dtype=torch.int64) << 16
    hv = torch.tensor(t.huffval, dtype=torch.int64)
    want_sym, want_len = pw._decode_symbol(win, t.maxcode, t.valoffset, hv)
    entry = pw.lookahead_table(t).to(torch.int64)[win >> (32 - pw.LOOKAHEAD_BITS)]
    walk_sym, walk_len = pw._decode_symbol(win, (-1,) * 10 + t.maxcode[10:], t.valoffset, hv)
    hit = entry > 0
    assert torch.equal(torch.where(hit, entry & 255, walk_sym), want_sym)
    assert torch.equal(torch.where(hit, entry >> 8, walk_len), want_len)
    short = [l for l in range(1, 10) if t.maxcode[l] >= 0]
    assert bool(hit.any()) == bool(short)
    assert not bool((entry >> 8 > pw.LOOKAHEAD_BITS).any())


def test_table_sets_share_equal_tables():
    """Blocks of one component share one staged table set; equal table
    pairs on different components share it too."""
    jpeg = bitstream.parse(_case(FUSED_CASES[0]))
    plan = pw.build_block_plan([jpeg])
    sets = pw.table_sets(plan.blk_tables)
    assert len(sets) == plan.blocks_per_mcu
    pairs = [(d, a) for _ci, d, a in plan.blk_tables]
    for i in range(len(sets)):
        for j in range(len(sets)):
            assert (sets[i] == sets[j]) == (pairs[i] == pairs[j])
    assert sorted(set(sets)) == list(range(max(sets) + 1))
