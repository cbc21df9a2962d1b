"""Kernels A-D, 2, 6, 7-9 and the planar color kernels against their plain
torch versions on a CUDA card (A and 2 also with the norst plan's start
bits and primed DC predictors), and the decode, norst, stream and batch
entries there.

Every test here needs a card: each skips, with a reason, where
torch.cuda.is_available() is false. This file imports neither JAX nor PIL,
so it runs on a host that has neither:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX for the reference tests.)
The plain versions are held to the reference by the other
tests/test_torch_*.py files; here each kernel is held to its plain
version, on the committed fixtures and on corrupt streams, tolerance 0.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import tpujpeg_torch
from tpujpeg_torch.kernels import build
from tpujpeg_torch.kernels import idct
from tpujpeg_torch.kernels import pipeline
from tpujpeg_torch.kernels import sample_color as sc
from tpujpeg_torch.kernels import wavefront as wf
from tpujpeg_torch.kernels import wavefront_prog as wp

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tpujpeg_torch", "fixtures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
FUSED = sorted(n for n, e in MANIFEST["fixtures"].items() if e["path"] == "fused")
STAGED = sorted(n for n, e in MANIFEST["fixtures"].items() if e["path"] == "staged")
NORST = sorted(n for n, e in MANIFEST["fixtures"].items() if e["path"] == "norst")
PROGRESSIVE = sorted(n for n, e in MANIFEST["fixtures"].items() if e["path"] == "progressive")
PROG_KERNEL = {"dc_first": "prog_dc_first", "ac_first": "prog_ac_first", "ac_refine": "prog_ac_refine"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _read(name):
    with open(os.path.join(FIXTURES, MANIFEST["fixtures"][name]["file"]), "rb") as f:
        return f.read()


RANDOM_ROWS = "420_2048-random_rows"


def _fixture_plan(name, n=2):
    """n copies of fixture `name` and their plan; RANDOM_ROWS is
    420_2048's plan with its rows replaced by seeded random words, which
    reach the codes of 10-16 bits and the invalid codes that the
    lookahead table hands to the maxcode walk."""
    base = "420_2048" if name == RANDOM_ROWS else name
    jpegs = [tpujpeg_torch.bitstream.parse(_read(base)) for _ in range(n)]
    plan = wf.build_block_plan(jpegs)
    if name == RANDOM_ROWS:
        g = torch.Generator().manual_seed(17)
        plan.bits = torch.randint(-(2**31), 2**31 - 1, plan.bits.shape, generator=g, dtype=torch.int32)
    return jpegs, plan


def _kernel_and_plain(jpegs, dev, plan=None):
    plan = plan if plan is not None else wf.build_block_plan(jpegs)
    geoms = [wf.ImageGeom.of(j) for j in jpegs]
    before = build.LAUNCHES["wavefront_pixels"]
    planes, err = wf.decode_lanes_to_planes(plan, geoms, dev)
    torch.cuda.synchronize()
    assert build.LAUNCHES["wavefront_pixels"] == before + 1
    want, want_err = wf.decode_lanes_to_planes(plan, geoms, dev, plain=True)
    assert build.LAUNCHES["wavefront_pixels"] == before + 1
    assert torch.equal(err, want_err)
    for a, b in zip(planes, want):
        assert torch.equal(a, b)
    return err


@pytest.mark.parametrize("name", FUSED + [RANDOM_ROWS])
def test_kernel_a_matches_plain_on_fixtures(cuda, name):
    jpegs, plan = _fixture_plan(name)
    err = _kernel_and_plain(jpegs, cuda, plan)
    assert bool(err.any()) == (name == RANDOM_ROWS)


def _corrupt_batch():
    """420_odd and seeded byte flips in its scan data that parse and plan
    in one batch with it."""
    data = _read("420_odd")
    start = data.index(b"\xff\xda")
    rng = np.random.default_rng(7)
    datas = [data]
    for _ in range(24):
        mut = bytearray(data)
        pos = int(rng.integers(start + 14, len(data) - 2))
        mut[pos] ^= int(rng.integers(1, 256))
        datas.append(bytes(mut))
    jpegs = []
    for d in datas:
        try:
            j = tpujpeg_torch.bitstream.parse(d)
            wf.build_block_plan([jpegs[0] if jpegs else j, j])
        except tpujpeg_torch.JpegError:
            continue
        jpegs.append(j)
    assert len(jpegs) > 8
    return jpegs


def test_kernel_a_matches_plain_on_corrupt_streams(cuda):
    """The error bits and the garbage pixels of the failing lanes must
    match too."""
    err = _kernel_and_plain(_corrupt_batch(), cuda)
    assert err.any()


def _coeff_kernel_and_plain(jpegs, dev, plan=None, layout=None):
    """Kernel 2 against its plain version: error bits for every lane and
    coefficients for every image, a failing lane's blocks included."""
    plan = plan if plan is not None else wf.build_block_plan(jpegs)
    geoms = [wf.ImageGeom.of(j) for j in jpegs]
    before = build.LAUNCHES["wavefront_coeff"]
    coeffs, err = wf.decode_lanes_to_coeffs(plan, geoms, dev, layout=layout)
    torch.cuda.synchronize()
    assert build.LAUNCHES["wavefront_coeff"] == before + 1
    want, want_err = wf.decode_lanes_to_coeffs(plan, geoms, dev, plain=True, layout=layout)
    assert build.LAUNCHES["wavefront_coeff"] == before + 1
    assert torch.equal(err, want_err)
    for a, b in zip(coeffs, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    return err


# Kernel 2's warp store on ragged warps, beside the fixtures: lanes of 0
# to 9 MCUs (random) cut across a fixture's MCUs ("lanes_0_9-<fixture>-
# <rows>", on the fixture's rows, whose lanes run past their segment and
# fail at various points, or random rows; 1, 3, 4 and 6 blocks per MCU),
# the first 33 and 65 lanes of a plan (a warp of one live lane), corpus
# streams whose warps straddle images (3 x 77x61 4:2:0, one MCU a lane),
# four planes (CMYK, 7 blocks per MCU), 4:2:2 and gray, and each norst
# fixture's lanes in 3 windows as decode_norst_sharded cuts them (plane
# heights cut, MCU rows rebased).
UNEQUAL = [f"lanes_0_9-{f}-{rows}" for f in ("gray", "444", "422", "420_2048") for rows in ("fixture", "random")]
CORPUS = {  # name -> (tests/corpus.py make_jpeg arguments, copies)
    "straddle_77x61": (dict(w=77, h=61, restart_blocks=1), 3),
    "cmyk_64x48": (dict(w=64, h=48, seed=6, mode="CMYK"), 2),
    "422_77x61": (dict(w=77, h=61, subsampling=1, restart_blocks=2), 2),
    "gray_96x80": (dict(w=96, h=80, seed=5, mode="L", restart_blocks=3), 2),
}
COEFF_CASES = (UNEQUAL + ["first_33-444", "first_65-444"] + sorted(CORPUS)
               + [f"window_{i}-{n}" for n in NORST for i in range(3)])


def _lanes(plan, rows, meta):
    """`plan` with lanes (image, first MCU, MCUs) `meta` reading the rows
    `rows` of `plan`."""
    meta = torch.tensor(meta, dtype=torch.int32)
    return dataclasses.replace(
        plan, bits=plan.bits[rows].contiguous(), seg_bits=plan.seg_bits[rows].contiguous(),
        lane_m=meta[:, 2].contiguous(), lane_qset=plan.lane_qset[rows].contiguous(), lane_meta=meta,
        n_mcus=max(int(meta[:, 2].max()), 1))


def _coeff_case(name):
    """(jpegs, plan, layout or None) of a kernel-2 case: a fixture name,
    RANDOM_ROWS or one of COEFF_CASES."""
    kind, _, rest = name.partition("-")
    if kind == "lanes_0_9":
        fixture, rows_kind = rest.rsplit("-", 1)
        jpegs, base = _fixture_plan(fixture)
        total = int(base.lane_meta[base.lane_meta[:, 0] == 0, 2].sum())
        rng = np.random.default_rng(11)
        meta = []
        for img in range(len(jpegs)):
            first = 0
            while first < total:
                m = min(int(rng.integers(0, 10)), total - first)
                meta.append((img, first, m))
                first += m
        plan = _lanes(base, torch.from_numpy(rng.integers(0, base.n_lanes, size=len(meta))), meta)
        if rows_kind == "random":
            _random_rows(plan, torch.Generator().manual_seed(5))
        return jpegs, plan, None
    if kind in ("first_33", "first_65"):
        jpegs, base = _fixture_plan(rest)
        n = int(kind[6:])
        return jpegs, _lanes(base, torch.arange(n), base.lane_meta[:n].tolist()), None
    if name in CORPUS:
        pytest.importorskip("PIL", reason="tests/corpus.py encodes with PIL")
        from corpus import make_jpeg

        kw, n = CORPUS[name]
        jpegs = [tpujpeg_torch.bitstream.parse(make_jpeg(**kw)) for _ in range(n)]
        return jpegs, wf.build_block_plan(jpegs), None
    if kind.startswith("window_"):
        jpegs, plan = _norst_plan(rest)
        per = -(-plan.n_lanes // 3)
        i = int(kind[7:])
        sub, win, _r0 = wf._norst_window(plan, i * per, min(plan.n_lanes, (i + 1) * per),
                                         wf.PlaneLayout.of(wf.ImageGeom.of(jpegs[0])))
        return jpegs, sub, win
    jpegs, plan = _fixture_plan(name)
    return jpegs, plan, None


@pytest.mark.parametrize("name", FUSED + [RANDOM_ROWS] + COEFF_CASES)
def test_kernel_2_matches_plain_on_fixtures(cuda, name):
    jpegs, plan, layout = _coeff_case(name)
    err = _coeff_kernel_and_plain(jpegs, cuda, plan, layout)
    if name in UNEQUAL:
        assert bool(err.any()) and not bool(err.all())
    else:
        assert bool(err.any()) == (name == RANDOM_ROWS)


def test_kernel_a_and_2_launch_without_syncing_the_stream(cuda):
    """With the plan on the card, launching kernel A or 2 copies nothing
    to the card and never waits for the stream (sync debug mode raises
    on any synchronizing call)."""
    jpegs, plan = _fixture_plan("420_odd")
    plan = plan.to(cuda)
    geoms = [wf.ImageGeom.of(j) for j in jpegs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        planes, err = wf.decode_lanes_to_planes(plan, geoms, cuda)
        coeffs, err2 = wf.decode_lanes_to_coeffs(plan, geoms, cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert not err.any() and torch.equal(err, err2)


def test_kernel_2_matches_plain_on_corrupt_streams(cuda):
    """Failing lanes beside good ones in the same warps."""
    err = _coeff_kernel_and_plain(_corrupt_batch(), cuda)
    assert err.any() and not err.all()


RANDOM_START = "420_odd-random_start"


def _norst_plan(name):
    """A fixture's norst plan (lanes that start at bit0 with primed DC
    predictors); RANDOM_START is 420_odd's restart plan given seeded
    random start bits (0..31) and predictors, so that lanes start
    mid-word, decode from there and mostly fail."""
    if name == RANDOM_START:
        jpegs, plan = _fixture_plan("420_odd", n=1)
        g = torch.Generator().manual_seed(23)
        plan.bit0 = torch.randint(0, 32, (plan.n_lanes,), generator=g, dtype=torch.int32)
        plan.dc0 = torch.randint(-2048, 2048, (plan.n_lanes, 4), generator=g, dtype=torch.int32)
        return jpegs, plan
    jpeg = tpujpeg_torch.bitstream.parse(_read(name))
    return [jpeg], wf.build_norst_plan(jpeg)


@pytest.mark.parametrize("name", NORST + [RANDOM_START])
def test_kernel_a_and_2_with_start_state_match_plain(cuda, name):
    """Kernels A and 2 with bit0/dc0 against their plain versions:
    planes, coefficients and error bits; the norst fixtures decode
    without an error."""
    jpegs, plan = _norst_plan(name)
    assert plan.bit0 is not None and bool((plan.bit0 % 32).any())
    err_a = _kernel_and_plain(jpegs, cuda, plan)
    err_2 = _coeff_kernel_and_plain(jpegs, cuda, plan)
    assert torch.equal(err_a, err_2)
    assert bool(err_a.any()) == (name == RANDOM_START)


def test_restart_plans_unchanged_with_null_start_state(cuda):
    """A restart plan launched with null bit0/dc0 and with explicit zeros
    gives the same planes, coefficients and error bits."""
    jpegs, plan = _fixture_plan("420_odd")
    zeros = dataclasses.replace(plan, bit0=torch.zeros(plan.n_lanes, dtype=torch.int32),
                                   dc0=torch.zeros((plan.n_lanes, 4), dtype=torch.int32))
    geoms = [wf.ImageGeom.of(j) for j in jpegs]
    for fn in (wf.decode_lanes_to_planes, wf.decode_lanes_to_coeffs):
        (a, ea), (b, eb) = fn(plan, geoms, cuda), fn(zeros, geoms, cuda)
        torch.cuda.synchronize()
        assert torch.equal(ea, eb) and not ea.any()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_norst_launch_does_not_sync_the_stream(cuda):
    jpegs, plan = _norst_plan("rst_rows_420")
    plan = plan.to(cuda)
    geoms = [wf.ImageGeom.of(j) for j in jpegs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _planes, err = wf.decode_lanes_to_planes(plan, geoms, cuda)
        _coeffs, err2 = wf.decode_lanes_to_coeffs(plan, geoms, cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert not err.any() and torch.equal(err, err2)


@pytest.mark.parametrize("name", NORST)
def test_norst_entries_on_card_match_pil_hashes(cuda, name):
    """decode() takes the fused norst path under auto (kernel A and a
    color kernel) and kernel 2 on the norst plan under the wavefront
    engine; decode_norst_to_rgb(packed=True) gives PIL's bytes too."""
    import hashlib

    want = MANIFEST["fixtures"][name]["pil_sha256"]
    for entropy, engine, kernel in (("auto", "wavefront-fused-norst", "wavefront_pixels"),
                                    ("wavefront", "wavefront", "wavefront_coeff")):
        before = build.LAUNCHES[kernel]
        out, stats = tpujpeg_torch.decode(
            _read(name), tpujpeg_torch.DecodeConfig(entropy_engine=entropy), device=cuda, return_stats=True)
        assert hashlib.sha256(out.tobytes()).hexdigest() == want
        assert (stats.entropy_engine, stats.transform_engine) == (engine, "cuda")
        assert build.LAUNCHES[kernel] == before + 1
    packed = tpujpeg_torch.decode_norst_to_rgb(tpujpeg_torch.bitstream.parse(_read(name)), packed=True,
                                               device=cuda)
    h, w2 = packed.shape[1], packed.shape[2]
    raster = packed.view(torch.uint8).view(3, h, 2 * w2).permute(1, 2, 0).contiguous()
    assert hashlib.sha256(raster.cpu().numpy().tobytes()).hexdigest() == want


@pytest.mark.parametrize("subsampling", [1, 0], ids=["422", "444"])
def test_card_split_on_marker_free_4k_frames(cuda, subsampling):
    """A marker-free 3840x2160 q90 frame through decode() takes the card's
    split (one wave of kernel A's lanes, 4-word rows) and gives PIL's bytes
    and those of decode_norst_to_rgb at the reference's default split; a
    traced decode() counts the plan's lanes and the wave once."""
    pytest.importorskip("PIL", reason="tests/corpus.py encodes with PIL")
    from corpus import make_jpeg, pil_decode

    from tpujpeg_torch import spans

    data = make_jpeg(3840, 2160, seed=3, quality=90, subsampling=subsampling)
    jpeg = tpujpeg_torch.bitstream.parse(data)
    scan = jpeg.scans[0]
    total = wf._segment_mcus(jpeg.frame, scan)
    default = wf.build_norst_plan(jpeg)
    card = wf.card_norst_plan(jpeg, cuda)
    wave = wf.card_wave_lanes(cuda, card.blk_tables)
    props = torch.cuda.get_device_properties(cuda)
    assert wave % (props.multi_processor_count * build.WF_THREADS) == 0 and wave > 0
    assert card.norst_every == wf.card_every(total, wave, total, default.norst_every) < default.norst_every
    assert card.n_words % wf.CARD_ROW_WORDS == 0 and card.n_words < default.n_words

    want = pil_decode(data)
    spans.drain()
    before = build.LAUNCHES["wavefront_pixels"]
    with spans.adopt(0):
        out, stats = tpujpeg_torch.decode(data, device=cuda, return_stats=True)
    recs = spans.drain()
    assert stats.entropy_engine == "wavefront-fused-norst"
    assert build.LAUNCHES["wavefront_pixels"] == before + 1
    np.testing.assert_array_equal(out, want)
    (dec,) = [r for r in recs if r.name == spans.DECODE]
    lanes = [r.n for r in recs if r.name == spans.NORST_LANES]
    waves = [r.n for r in recs if r.name == spans.NORST_WAVE]
    assert (lanes, waves) == ([card.n_lanes], [wave])
    assert all(r.unit == dec.unit for r in recs)
    at_default = wf.decode_norst_to_rgb(jpeg, every=default.norst_every, device=cuda)
    np.testing.assert_array_equal(at_default.cpu().numpy(), want)


def test_card_split_on_norst_fixtures(cuda):
    """The norst fixtures' card plans through kernel A equal its plain
    version on the same plan, with no lane failing."""
    for name in NORST:
        jpeg = tpujpeg_torch.bitstream.parse(_read(name))
        plan = wf.card_norst_plan(jpeg, cuda)
        assert plan.n_words % wf.CARD_ROW_WORDS == 0
        err = _kernel_and_plain([jpeg], cuda, plan)
        assert not err.any(), name


@pytest.mark.parametrize("per_image_q", [False, True])
@pytest.mark.parametrize("with_dc", [False, True])
@pytest.mark.parametrize("n,hb,wb", [(1, 1, 1), (3, 5, 7), (130, 1, 2), (2, 40, 33)])
def test_kernel_6_matches_plain(cuda, n, hb, wb, per_image_q, with_dc):
    """Random coefficients, every 5th block over the whole int32 range so
    that the arithmetic wraps; one quantizer or one per image; with and
    without a DC column."""
    g = torch.Generator().manual_seed(n * 10000 + hb * 100 + wb)
    c = torch.randint(-1024, 1024, (n, hb * wb, 64), generator=g, dtype=torch.int32)
    c[:, ::5] = torch.randint(-(2**31), 2**31 - 1, c[:, ::5].shape, generator=g, dtype=torch.int32)
    q = torch.randint(1, 256, (n, 64) if per_image_q else (64,), generator=g, dtype=torch.int32)
    dc = torch.randint(-(2**31), 2**31 - 1, (n, hb * wb), generator=g, dtype=torch.int32) if with_dc else None
    before = build.LAUNCHES["dequant_idct_islow"]
    args = [t.to(cuda) if t is not None else None for t in (c, q, dc)]
    got = idct.dequant_idct_islow(args[0], args[1], hb, wb, args[2])
    torch.cuda.synchronize()
    assert build.LAUNCHES["dequant_idct_islow"] == before + 1
    assert torch.equal(got, idct.dequant_idct_islow_plain(args[0], args[1], hb, wb, args[2]))
    assert torch.equal(got.cpu(), idct.dequant_idct_islow_plain(c, q, hb, wb, dc))


def test_kernel_6_refuses_misaligned_coefficients(cuda):
    """Kernel 6 reads each block as 16 int4 words: a contiguous view that
    starts off a 16-byte boundary raises before launching, and the
    context stays usable."""
    flat = torch.zeros(1 + 6 * 64, dtype=torch.int32, device=cuda)
    before = build.LAUNCHES["dequant_idct_islow"]
    with pytest.raises(ValueError, match="16-byte"):
        idct.dequant_idct_islow(flat[1:].view(1, 6, 64), torch.ones(64, dtype=torch.int32, device=cuda), 2, 3)
    assert build.LAUNCHES["dequant_idct_islow"] == before
    got = idct.dequant_idct_islow(flat[:384].view(1, 6, 64), torch.ones(64, dtype=torch.int32, device=cuda), 2, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full_like(got, 128))


def test_staged_batch_on_card_matches_fused(cuda):
    """decode_batch_to_coeffs (kernel 2) then transform_batch (kernel 6,
    kernel B) gives the fused path's RGB; the per-image split is views."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read("420_odd")) for _ in range(3)]
    coeffs, failures = tpujpeg_torch.decode_batch_to_coeffs(jpegs, device=cuda)
    assert not failures
    qtabs = [torch.from_numpy(jpegs[0].qtables[c.tq]).to(cuda) for c in jpegs[0].frame.components]
    rgb = pipeline.transform_batch(jpegs[0].frame, coeffs, qtabs, tpujpeg_torch.DEFAULT_CONFIG)
    fused, _ = tpujpeg_torch.decode_batch_to_rgb(jpegs, device=cuda)
    assert torch.equal(rgb, fused)
    per_image, _ = tpujpeg_torch.decode_batch_to_device(jpegs, device=cuda)
    assert all(torch.equal(c, coeffs[ci][i]) for i, img in enumerate(per_image) for ci, c in enumerate(img))


COLOR = [
    (sc.upsample_color_h2v2, sc.upsample_color_h2v2_plain, lambda h, w: ((h + 1) // 2, (w + 1) // 2)),
    (sc.upsample_color_h2v1, sc.upsample_color_h2v1_plain, lambda h, w: (h, (w + 1) // 2)),
    (sc.color_444, sc.color_444_plain, lambda h, w: (h, w)),
]


@pytest.mark.parametrize("k", range(3), ids=["h2v2", "h2v1", "444"])
@pytest.mark.parametrize("h,w", [(1, 1), (37, 51), (64, 48), (257, 130)])
def test_color_kernels_match_plain(cuda, k, h, w):
    kern, plain, chroma = COLOR[k]
    g = torch.Generator().manual_seed(h * 1000 + w)
    hc, wc = chroma(h, w)
    y = torch.randint(0, 256, (3, h + 3, w + 5), generator=g, dtype=torch.uint8)[:, :h, :w]
    cb, cr = (torch.randint(0, 256, (3, hc + 2, wc + 4), generator=g, dtype=torch.uint8)[:, :hc, :wc]
              for _ in range(2))
    ins = [t.to(cuda) for t in (y, cb, cr)]
    got = kern(*ins)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(*ins))
    assert torch.equal(got.cpu(), plain(y, cb, cr))


def test_decode_batch_to_rgb_on_card_matches_pil_hashes(cuda):
    import hashlib

    for name in FUSED:
        entry = MANIFEST["fixtures"][name]
        if name == "420_2048":
            continue
        data = _read(name)
        rgb, failures = tpujpeg_torch.decode_batch_to_rgb(
            [tpujpeg_torch.bitstream.parse(data) for _ in range(3)], device=cuda)
        assert not failures and rgb.device.type == "cuda"
        for i in range(3):
            assert hashlib.sha256(rgb[i].cpu().numpy().tobytes()).hexdigest() == entry["pil_sha256"]


@pytest.mark.parametrize("name,entropy", [(n, e) for n in STAGED for e in ("auto", "native")]
                         + [("multiscan", "wavefront")])
def test_staged_decode_on_card_matches_pil_hashes(cuda, name, entropy):
    import hashlib

    before = dict(build.LAUNCHES)
    out, stats = tpujpeg_torch.decode(
        _read(name), tpujpeg_torch.DecodeConfig(entropy_engine=entropy), device=cuda, return_stats=True)
    assert hashlib.sha256(out.tobytes()).hexdigest() == MANIFEST["fixtures"][name]["pil_sha256"]
    assert stats.entropy_engine == ("native" if entropy == "auto" else entropy)
    assert stats.transform_engine == "cuda"
    assert build.LAUNCHES["dequant_idct_islow"] == before.get("dequant_idct_islow", 0) + 3
    if entropy == "wavefront":
        assert build.LAUNCHES["wavefront_coeff"] == before.get("wavefront_coeff", 0) + 3


def _prog_kernels_and_plain(jpegs, dev, steps=None):
    """Every scan of a progressive group through kernels 7-9 and, from the
    same state, their plain versions: error bits, AC states and DC
    columns equal after each scan. Returns (state, lanes with errors)."""
    steps = steps if steps is not None else wp.plan_scans(jpegs)
    acs, dcs = wp.new_state(jpegs[0].frame, len(jpegs), dev)
    bad = 0
    for k, step in enumerate(steps):
        if isinstance(step, wp.DcRefine):
            wp.apply_step(step, acs, dcs)
            continue
        name = PROG_KERNEL[step.kind]
        acs_p, dcs_p = [a.clone() for a in acs], [d.clone() for d in dcs]
        before = build.LAUNCHES[name]
        err, _ = wp.apply_step(step, acs, dcs)
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == before + 1
        err_p, _ = wp.apply_step(step, acs_p, dcs_p, plain=True)
        assert build.LAUNCHES[name] == before + 1
        assert torch.equal(err, err_p), f"scan {k} ({name}) error bits"
        for a, b in zip(acs + dcs, acs_p + dcs_p):
            assert torch.equal(a, b), f"scan {k} ({name}) state"
        bad += int(err.count_nonzero())
    return acs, dcs, bad


@pytest.mark.parametrize("name", PROGRESSIVE)
def test_prog_kernels_match_plain_on_fixtures(cuda, name):
    import hashlib

    jpegs = [tpujpeg_torch.bitstream.parse(_read(name)) for _ in range(2)]
    acs, dcs, bad = _prog_kernels_and_plain(jpegs, cuda)
    assert bad == 0
    frame = jpegs[0].frame
    qtabs = [torch.from_numpy(jpegs[0].qtables[c.tq]).to(cuda) for c in frame.components]
    rgb = pipeline.transform_batch(frame, acs, qtabs, tpujpeg_torch.DEFAULT_CONFIG,
                                   color=tpujpeg_torch.bitstream.color_space(jpegs[0]), dcs=dcs)
    for i in range(2):
        assert hashlib.sha256(rgb[i].cpu().numpy().tobytes()).hexdigest() == MANIFEST["fixtures"][name]["pil_sha256"]


def test_prog_kernels_match_plain_on_corrupt_streams(cuda):
    """prog_444 x 4: member 1's first AC-first payload all 0xFF, members 2
    and 3 with seeded byte flips in every AC-first and AC-refine payload."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read("prog_444")) for _ in range(4)]
    rng = np.random.default_rng(11)
    first = next(s for s in jpegs[1].scans if wp.scan_kind(s) == "ac_first")
    first.data = b"\xff" * len(first.data)
    for j in jpegs[2:]:
        for scan in j.scans:
            if wp.scan_kind(scan) in ("ac_first", "ac_refine"):
                buf = np.frombuffer(bytes(scan.data), np.uint8).copy()
                pos = rng.integers(0, len(buf), size=3)
                buf[pos] ^= rng.integers(1, 256, size=3).astype(np.uint8)
                scan.data = buf.tobytes()
    _acs, _dcs, bad = _prog_kernels_and_plain(jpegs, cuda)
    assert bad > 0


@pytest.mark.parametrize("density", [0.3, 0.95])
@pytest.mark.parametrize("seed", range(4))
def test_prog_kernels_match_plain_on_random_rows_and_state(cuda, seed, density):
    """The lane rows of prog_gray's scans replaced by random words, and
    each AC scan applied to a random state with `density` of its values
    nonzero: the band machine of kernel 9 meets nonzero patterns no
    encoder wrote, and at 95% bands with more than 32 nonzeros take two
    correction chunks."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read("prog_gray")) for _ in range(2)]
    g = torch.Generator().manual_seed(seed)
    steps = wp.plan_scans(jpegs)
    for st in steps:
        if isinstance(st, wp.ScanPlan):
            st.bits = torch.randint(-(2**31), 2**31 - 1, st.bits.shape, generator=g, dtype=torch.int32)
    acs, dcs = wp.new_state(jpegs[0].frame, 2, cuda)
    vals = torch.randint(-40, 40, acs[0].shape, generator=g, dtype=torch.int32)
    vals[torch.rand(acs[0].shape, generator=g) >= density] = 0
    for st in steps:
        if not isinstance(st, wp.ScanPlan) or st.kind == "dc_first":
            continue
        for plain in (False, True):
            state = vals.to(cuda, copy=True)
            err, _ = wp.apply_step(st, [state], dcs, plain=plain)
            if plain:
                assert torch.equal(err, err_k) and torch.equal(state, state_k)
            else:
                torch.cuda.synchronize()
                err_k, state_k = err, state


def test_prog_ac_refine_refuses_misaligned_state(cuda):
    """Kernel 9 moves each block as 16 int4 words: a contiguous state view
    that starts off a 16-byte boundary raises before launching, and the
    context stays usable."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read("prog_gray"))]
    plan = next(s for s in wp.plan_scans(jpegs) if isinstance(s, wp.ScanPlan) and s.kind == "ac_refine").to(cuda)
    nb = plan.comp[0][3]
    flat = torch.zeros(1 + nb * 64, dtype=torch.int32, device=cuda)
    err = torch.zeros(plan.n_lanes, dtype=torch.int32, device=cuda)
    before = build.LAUNCHES["prog_ac_refine"]
    with pytest.raises(ValueError, match="16-byte"):
        wp.ac_refine(plan, flat[1:].view(1, nb, 64), err)
    assert build.LAUNCHES["prog_ac_refine"] == before
    wp.ac_refine(plan, flat[: nb * 64].view(1, nb, 64), err)
    torch.cuda.synchronize()
    assert build.LAUNCHES["prog_ac_refine"] == before + 1


def _step_kernel_and_plain(step, acs, dcs):
    """One kernel scan through its kernel and, on clones of the same CUDA
    state, its plain version: error bits and every state tensor equal, one
    launch counted. Returns the kernel's error bits."""
    name = PROG_KERNEL[step.kind]
    acs_p, dcs_p = [a.clone() for a in acs], [d.clone() for d in dcs]
    before = build.LAUNCHES[name]
    err, _ = wp.apply_step(step, acs, dcs)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    err_p, _ = wp.apply_step(step, acs_p, dcs_p, plain=True)
    assert build.LAUNCHES[name] == before + 1
    assert torch.equal(err, err_p), f"{name} error bits"
    for a, b in zip(acs + dcs, acs_p + dcs_p):
        assert torch.equal(a, b), f"{name} state"
    return err


def _plan_luts(tables, huffval):
    """int16 [S, n_sp, 512] lookahead tables of a plan's table sets and
    symbols."""
    return torch.stack([torch.stack([
        wf.lookahead_table(wf.CanonTable(tuple(t[:17]), tuple(t[17:]), tuple(h))).to(torch.int16)
        for t, h in zip(ts, hs)]) for ts, hs in zip(tables.tolist(), huffval.tolist())])


def _random_rows(plan, g):
    plan.bits = torch.randint(-(2**31), 2**31 - 1, plan.bits.shape, generator=g, dtype=torch.int32)


def _first_plan(jpegs, kind):
    return next(s for s in wp.plan_scans(jpegs) if isinstance(s, wp.ScanPlan) and s.kind == kind)


@pytest.mark.parametrize("symbols", ["fixture", "random"])
@pytest.mark.parametrize("name", ["prog_gray", "prog_444"])
def test_prog_dc_first_matches_plain_on_random_rows(cuda, name, symbols):
    """Kernel 7 on its DC-first scan with the rows replaced by random
    words: codes of 10-16 bits (prog_444's chroma table) and invalid
    codes reach the maxcode walk after the lookahead, with one table
    (prog_gray) or three scan components (prog_444). With random symbol
    lists (lookahead tables rebuilt from them) sizes above 15 occur:
    BADCODE, decoded as size 0."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read(name)) for _ in range(3)]
    plan = _first_plan(jpegs, "dc_first")
    g = torch.Generator().manual_seed(23)
    _random_rows(plan, g)
    if symbols == "random":
        plan.huffval = torch.randint(0, 256, plan.huffval.shape, generator=g, dtype=torch.uint8)
        plan.luts = _plan_luts(plan.tables, plan.huffval)
    acs, dcs = wp.new_state(jpegs[0].frame, 3, cuda)
    for d in dcs:
        d.copy_(torch.randint(-(2**31), 2**31 - 1, d.shape, generator=g, dtype=torch.int32))
    err = _step_kernel_and_plain(plan, acs, dcs)
    assert bool((err & 1).any())  # BADCODE somewhere


@pytest.mark.parametrize("al", [0, 1, 13])
@pytest.mark.parametrize("band", [(1, 1), (1, 5), (3, 4), (6, 63), (1, 63)])
def test_prog_ac_first_matches_plain_on_random_bands(cuda, band, al):
    """Kernel 8 on random rows and a random state (half its values zero,
    the others any int32) with bands the encoder's script does not use:
    a band of one position, bands inside one 16-byte chunk of a block and
    across chunks, the full band, and shifts whose adds wrap."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read("prog_gray")) for _ in range(2)]
    plan = _first_plan(jpegs, "ac_first")
    plan.ss, plan.se, plan.al = band[0], band[1], al
    g = torch.Generator().manual_seed(100 * band[0] + band[1] + al)
    _random_rows(plan, g)
    acs, dcs = wp.new_state(jpegs[0].frame, 2, cuda)
    vals = torch.randint(-(2**31), 2**31 - 1, acs[0].shape, generator=g, dtype=torch.int32)
    vals[torch.rand(acs[0].shape, generator=g) < 0.5] = 0
    acs[0].copy_(vals)
    _step_kernel_and_plain(plan, acs, dcs)


@pytest.mark.parametrize("kind", ["dc_first", "ac_first"])
@pytest.mark.parametrize("name", ["prog_gray", "prog_444", "prog_rst_2048"])
def test_prog_kernels_7_8_on_lanes_of_unequal_length(cuda, name, kind):
    """Kernels 7 and 8 with each image's MCUs cut into lanes of 0 to 9
    MCUs (random), so lanes of one warp and of neighbouring CTAs end
    apart and lanes cross MCU rows, on the fixture's rows (lanes after
    the first of a segment start mid-stream: garbage symbols, errors at
    various points) and on random rows; one, three and (4:2:0) six
    blocks per MCU."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read(name)) for _ in range(2)]
    base = _first_plan(jpegs, kind)
    total = int(base.lane_meta[base.lane_meta[:, 0] == 0, 2].sum())
    rng = np.random.default_rng(7)
    meta = []
    for img in range(2):
        first = 0
        while first < total:
            m = min(int(rng.integers(0, 10)), total - first)
            meta.append((img, first, m))
            first += m
    L = len(meta)
    assert L > 3 * 128
    rows = rng.integers(0, base.n_lanes, size=L)
    for bits in ("fixture", "random"):
        plan = dataclasses.replace(
            base, bits=base.bits[rows].contiguous(), seg_bits=base.seg_bits[rows].contiguous(),
            lane_meta=torch.tensor(meta, dtype=torch.int32), n_mcus=max(m for _i, _f, m in meta))
        if bits == "random":
            _random_rows(plan, torch.Generator().manual_seed(5))
        acs, dcs = wp.new_state(jpegs[0].frame, 2, cuda)
        err = _step_kernel_and_plain(plan, acs, dcs)
        assert bool(err.any()) and not bool(err.all())


TSETS = sorted(n for n in PROGRESSIVE if n.startswith("prog_tsets_"))


def test_prog_kernels_match_plain_on_a_three_set_plan(cuda):
    """The three prog_tsets fixtures (one odd size, each with its own
    Huffman tables) in one group: each kernel scan is one launch over up to
    three table sets, with padding lanes between the images. Every scan
    through kernels 7-9 equals the plain versions, each launch records its
    table sets (``prog_tsets``), and every image equals PIL. Then each
    kernel scan again on a poisoned state of four images, the padding lanes
    moved to the fourth, which no real lane reaches: kernel and plain
    versions agree, the padding lanes raise nothing, and the fourth
    image's state keeps its poison."""
    import hashlib

    from tpujpeg_torch import spans

    jpegs = [tpujpeg_torch.bitstream.parse(_read(n)) for n in TSETS]
    steps = wp.plan_scans(jpegs)
    plans = [st for st in steps if isinstance(st, wp.ScanPlan)]
    assert len(TSETS) == 3 and max(p.n_sets for p in plans) == 3
    assert all(bool((p.lane_m == 0).any()) for p in plans if p.n_sets > 1)
    spans.drain()
    with spans.adopt(0):
        acs, dcs, bad = _prog_kernels_and_plain(jpegs, cuda, steps)
    counts = [r.n for r in spans.drain() if r.name == spans.PROG_TSETS]
    assert bad == 0 and counts == [p.n_sets for p in plans]
    frame = jpegs[0].frame
    qtabs = [torch.from_numpy(np.stack([j.qtables[c.tq] for j in jpegs]).astype(np.int32)).to(cuda)
             for c in frame.components]
    rgb = pipeline.transform_batch(frame, acs, qtabs, tpujpeg_torch.DEFAULT_CONFIG,
                                   color=tpujpeg_torch.bitstream.color_space(jpegs[0]), dcs=dcs)
    for i, name in enumerate(TSETS):
        assert hashlib.sha256(rgb[i].cpu().numpy().tobytes()).hexdigest() == MANIFEST["fixtures"][name]["pil_sha256"]

    g = torch.Generator().manual_seed(31)
    for plan in plans:
        pad = plan.lane_m == 0
        meta = plan.lane_meta.clone()
        meta[pad, 0] = 3
        plan = dataclasses.replace(plan, lane_meta=meta, n_images=4,
                                   image_set=torch.cat([plan.image_set, plan.image_set[:1]]))
        acs, dcs = wp.new_state(frame, 4, cuda)
        for t in acs + dcs:
            t.copy_(torch.randint(-(2**31), 2**31 - 1, t.shape, generator=g, dtype=torch.int32))
        poison = [t[3].clone() for t in acs + dcs]
        err = _step_kernel_and_plain(plan, acs, dcs)
        assert not bool(err[pad.to(cuda)].any())
        # A one-component DC first scan clears its column first.
        cleared = len(acs) + plan.comp_indices[0] if plan.kind == "dc_first" and len(plan.comp) == 1 else -1
        for k, (t, p) in enumerate(zip(acs + dcs, poison)):
            assert torch.equal(t[3], torch.zeros_like(p) if k == cleared else p), (plan.kind, k)


def test_prog_ac_first_refuses_misaligned_state(cuda):
    """Kernel 8 copies its lookahead table as int4 words and its C entry
    takes the state on a 16-byte boundary: a contiguous state view that
    starts off one raises before launching, and the context stays
    usable."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read("prog_gray"))]
    plan = _first_plan(jpegs, "ac_first").to(cuda)
    nb = plan.comp[0][3]
    flat = torch.zeros(1 + nb * 64, dtype=torch.int32, device=cuda)
    err = torch.zeros(plan.n_lanes, dtype=torch.int32, device=cuda)
    before = build.LAUNCHES["prog_ac_first"]
    with pytest.raises(ValueError, match="16-byte"):
        wp.ac_first(plan, flat[1:].view(1, nb, 64), err)
    assert build.LAUNCHES["prog_ac_first"] == before
    wp.ac_first(plan, flat[: nb * 64].view(1, nb, 64), err)
    torch.cuda.synchronize()
    assert build.LAUNCHES["prog_ac_first"] == before + 1


@pytest.mark.parametrize("name", PROGRESSIVE)
def test_prog_plan_luts_on_card_equal_lookahead_table(cuda, name):
    """Every kernel scan's lookahead tables, as the plan takes them to the
    card, equal wavefront.lookahead_table of the scan components'
    tables."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read(name))]
    n = 0
    for st in wp.plan_scans(jpegs):
        if isinstance(st, wp.ScanPlan):
            on_card = st.to(cuda).luts
            assert on_card.device == cuda and on_card.data_ptr() % 16 == 0
            assert torch.equal(on_card.cpu(), _plan_luts(st.tables, st.huffval))
            n += on_card.shape[0] * on_card.shape[1]
    assert n >= 5


def test_prog_decode_on_card_matches_pil_hashes(cuda):
    """decode_all_scans_to_rgb_batch and decode(entropy_engine="wavefront")
    on the small progressive fixtures."""
    import hashlib

    for name in ("prog_444", "prog_gray"):
        want = MANIFEST["fixtures"][name]["pil_sha256"]
        rgb, layout, failures = tpujpeg_torch.decode_all_scans_to_rgb_batch(
            [tpujpeg_torch.bitstream.parse(_read(name)) for _ in range(3)], device=cuda)
        assert not failures and layout == "nhwc" and rgb.device.type == "cuda"
        for i in range(3):
            assert hashlib.sha256(rgb[i].cpu().numpy().tobytes()).hexdigest() == want
        before = build.LAUNCHES["prog_ac_refine"]
        out, stats = tpujpeg_torch.decode(_read(name), tpujpeg_torch.DecodeConfig(entropy_engine="wavefront"),
                                          device=cuda, return_stats=True)
        assert stats.entropy_engine == "wavefront" and stats.transform_engine == "cuda"
        assert build.LAUNCHES["prog_ac_refine"] > before
        assert hashlib.sha256(out.tobytes()).hexdigest() == want


def zero_payload(data: bytes) -> bytes:
    """The stream with every entropy-coded byte of its first scan zeroed
    and its restart markers kept: its segments fail to decode."""
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


PLANAR = [
    ("upsample_color_h2v2_planar", sc.upsample_color_h2v2_packed, sc.upsample_color_h2v2_packed_plain,
     lambda h, w: ((h + 1) // 2, w // 2)),
    ("upsample_color_h2v1_planar", sc.upsample_color_h2v1_packed, sc.upsample_color_h2v1_packed_plain,
     lambda h, w: (h, w // 2)),
]


@pytest.mark.parametrize("k", range(2), ids=["h2v2", "h2v1"])
@pytest.mark.parametrize("h,w,pad", [(1, 2, 0), (37, 50, 5), (64, 48, 0), (257, 130, 3), (9, 1024, 2)])
def test_planar_kernels_match_plain(cuda, k, h, w, pad):
    """Random planes, cropped from wider ones (pad 5 and 3 make the luma
    row stride odd, so the kernel takes its byte loads), odd heights
    included; uint16 [N, 3, H, W/2] equal to the plain version and to the
    NHWC kernel's bytes."""
    name, kern, plain, chroma = PLANAR[k]
    g = torch.Generator().manual_seed(h * 1000 + w + pad)
    hc, wc = chroma(h, w)
    y = torch.randint(0, 256, (3, h + 3, w + pad), generator=g, dtype=torch.uint8)[:, :h, :w]
    cb, cr = (torch.randint(0, 256, (3, hc + 2, wc + pad), generator=g, dtype=torch.uint8)[:, :hc, :wc]
              for _ in range(2))
    ins = [t.to(cuda) for t in (y, cb, cr)]
    before = build.LAUNCHES[name]
    got = kern(*ins)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    assert got.dtype == torch.uint16 and got.shape == (3, 3, h, w // 2)
    assert torch.equal(got, plain(*ins))
    assert torch.equal(got.cpu(), plain(y, cb, cr))
    nhwc = (sc.upsample_color_h2v2 if k == 0 else sc.upsample_color_h2v1)(*ins)
    assert torch.equal(got.view(torch.uint8).view(3, 3, h, w), nhwc.permute(0, 3, 1, 2))


# The tile kernels' edges (tiles of 16 rows x 256 columns, 4 tiles down
# per block, 16 pixels per thread) as (H, W, luma row padding, chroma row
# padding, first column): widths one and two past a multiple of 16 and of
# 256, heights one past a tile and one past a block's 64 rows, H = 1 and
# 2, W = 2, row strides that are no multiple of 16 or of 8 bytes, a crop
# one column in (odd base pointers), 16-byte luma with 8-byte aligned
# chroma rows, and aligned planes (the 16-byte path).
TILE_EDGES = [(17, 4097, 0, 0, 0), (17, 4098, 0, 0, 0), (33, 257, 3, 1, 0), (33, 258, 0, 0, 0),
              (9, 17, 0, 0, 0), (9, 18, 2, 2, 0), (17, 256, 0, 0, 0), (1, 512, 0, 0, 0),
              (2, 512, 0, 0, 0), (5, 2, 0, 0, 0), (33, 256, 0, 0, 1), (33, 512, 16, 8, 0),
              (33, 512, 5, 5, 0), (32, 512, 0, 0, 0), (65, 258, 0, 0, 0)]
# Per sampling: the chroma shape for (H, W), the NHWC kernel and its plain
# version, and the planar kernel and its plain version (4:4:4 has none).
SAMPLING = {
    "h2v2": (lambda h, w: ((h + 1) // 2, (w + 1) // 2), "upsample_color_h2v2", sc.upsample_color_h2v2,
             sc.upsample_color_h2v2_plain, "upsample_color_h2v2_planar", sc.upsample_color_h2v2_packed,
             sc.upsample_color_h2v2_packed_plain),
    "h2v1": (lambda h, w: (h, (w + 1) // 2), "upsample_color_h2v1", sc.upsample_color_h2v1,
             sc.upsample_color_h2v1_plain, "upsample_color_h2v1_planar", sc.upsample_color_h2v1_packed,
             sc.upsample_color_h2v1_packed_plain),
    "444": (lambda h, w: (h, w), "color_444", sc.color_444, sc.color_444_plain, None, None, None),
}


def _check_tile_kernels(sampling, cpu, ins):
    """The sampling's NHWC kernel and (for even widths) its planar kernel
    on `ins` (CUDA) and `cpu` (the same planes on the CPU): each launches
    once and equals its plain version on the card and on the CPU, and the
    planar bytes equal the NHWC kernel's."""
    _chroma, name, kern, plain, pname, pkern, pplain = SAMPLING[sampling]
    n, h, w = ins[0].shape
    before = build.LAUNCHES[name]
    got = kern(*ins)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    want = plain(*cpu)
    assert torch.equal(got, plain(*ins))
    assert torch.equal(got.cpu(), want)
    if pname is None or w % 2:
        return
    before = build.LAUNCHES[pname]
    packed = pkern(*ins)
    torch.cuda.synchronize()
    assert build.LAUNCHES[pname] == before + 1
    assert packed.dtype == torch.uint16 and packed.shape == (n, 3, h, w // 2)
    assert torch.equal(packed, pplain(*ins))
    assert torch.equal(packed.view(torch.uint8).view(n, 3, h, w).cpu(), want.permute(0, 3, 1, 2))


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("fill", ["random", "0/255"])
@pytest.mark.parametrize("h,w,ypad,cpad,off", TILE_EDGES)
def test_h2v2_kernels_match_plain_at_tile_edges(cuda, h, w, ypad, cpad, off, fill, sampling):
    """Each sampling's tile kernels (4:2:0: kernel B and the 4:2:0 planar
    kernel; 4:2:2: kernel C and the 4:2:2 planar kernel; 4:4:4: kernel D),
    planar for even widths only, on 3 images cropped from wider planes,
    random or of bytes 0 and 255 only (every clamp of the color conversion
    and the chroma edges): each launches once and equals its plain version
    on the card and on the CPU."""
    g = torch.Generator().manual_seed(h * 100003 + w * 101 + ypad * 11 + cpad * 7 + off)
    hc, wc = SAMPLING[sampling][0](h, w)

    def plane(rows, cols, pad):
        t = torch.randint(0, 256 if fill == "random" else 2, (3, rows + 1, cols + pad + off),
                          generator=g, dtype=torch.uint8)
        return t if fill == "random" else t * 255

    full = [plane(h, w, ypad), plane(hc, wc, cpad), plane(hc, wc, cpad)]
    cpu = [t[:, :rows, off:off + cols] for t, (rows, cols) in zip(full, [(h, w), (hc, wc), (hc, wc)])]
    ins = [t.to(cuda)[:, :rows, off:off + cols] for t, (rows, cols) in zip(full, [(h, w), (hc, wc), (hc, wc)])]
    assert [t.stride(1) for t in ins] == [w + ypad + off, wc + cpad + off, wc + cpad + off]
    assert ins[0].storage_offset() == off
    _check_tile_kernels(sampling, cpu, ins)


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("w", [16, 18])
def test_h2v2_kernels_split_batches_over_the_grid_limit(cuda, w, sampling):
    """65,537 images (the grid's z dimension holds 65,535): each tile
    kernel's C entry launches twice, at the right image offsets, for the
    16-byte and the byte instance."""
    g = torch.Generator().manual_seed(w)
    n, h = 65537, 3
    hc, wc = SAMPLING[sampling][0](h, w)
    cpu = [torch.randint(0, 256, (n, rows, cols), generator=g, dtype=torch.uint8)
           for rows, cols in ((h, w), (hc, wc), (hc, wc))]
    _check_tile_kernels(sampling, cpu, [t.to(cuda) for t in cpu])


@pytest.mark.parametrize("k", range(2), ids=["h2v2", "h2v1"])
def test_planar_kernels_refuse_odd_width(cuda, k):
    name, kern, _plain, chroma = PLANAR[k]
    hc, wc = chroma(9, 17)
    y = torch.zeros((1, 9, 17), dtype=torch.uint8, device=cuda)
    c = torch.zeros((1, hc, wc + 1), dtype=torch.uint8, device=cuda)
    before = build.LAUNCHES[name]
    with pytest.raises(ValueError, match="even width"):
        kern(y, c, c)
    assert build.LAUNCHES[name] == before


@pytest.mark.parametrize("layout", ["nhwc", "packed16"])
def test_stream_on_card_equals_batch_on_device(cuda, layout):
    """decode_stream over the 4:2:0, 4:2:2 and odd-width fixtures (a chunk
    each) equals decode_batch_on_device; packed16 applies where the width
    is even, and its bytes are the NHWC image's planar raster."""
    names = ["420_odd", "422", "420_2048"]
    datas = [_read(n) for n in names]
    cfg = tpujpeg_torch.DecodeConfig(to_numpy=False)
    ref = tpujpeg_torch.decode_batch_on_device(datas, cfg, device=cuda)
    assert not ref.errors
    before = dict(build.LAUNCHES)
    chunks = list(tpujpeg_torch.decode_stream(datas, cfg, chunk_size=1, layout=layout, device=cuda))
    for name, _kern, _plain, _chroma in PLANAR:
        assert build.LAUNCHES[name] - before.get(name, 0) == (layout == "packed16")
    for ch in chunks:
        (i,) = ch.members
        img = ch.images[0]
        assert not ch.failures and img.device.type == "cuda"
        odd = MANIFEST["fixtures"][names[i]]["shape"][1] % 2
        assert ch.layout == ("packed16" if layout == "packed16" and not odd else "nhwc")
        if ch.layout == "packed16":
            h, w = img.shape[1], img.shape[2] * 2
            img = img.view(torch.uint8).view(3, h, w).permute(1, 2, 0)
        assert torch.equal(img, ref.images[i])


@pytest.mark.parametrize("layout", ["nhwc", "packed16"])
def test_mixed_chunks_on_card_launch_kernel_a_once_per_bucket(cuda, layout):
    """decode_stream over chunks of mixed geometry stays on the fused path:
    one kernel-A launch per geometry bucket, every image equal to
    decode_batch_on_device's. The first chunk (4:2:0 2048^2 twice and
    4:2:2) takes packed16 in both buckets; the second holds the odd-width
    fixture, so it is "nhwc" in both."""
    names = ["420_2048", "422", "420_2048", "420_odd", "422"]
    datas = [_read(n) for n in names]
    cfg = tpujpeg_torch.DecodeConfig(to_numpy=False)
    ref = tpujpeg_torch.decode_batch_on_device(datas, cfg, device=cuda)
    assert not ref.errors
    before = build.LAUNCHES["wavefront_pixels"]
    chunks = list(tpujpeg_torch.decode_stream(datas, cfg, chunk_size=3, layout=layout, device=cuda))
    assert build.LAUNCHES["wavefront_pixels"] - before == 4
    assert [(ch.engine, ch.layout, ch.members) for ch in chunks] == [
        ("wavefront-fused", layout, [0, 1, 2]), ("wavefront-fused", "nhwc", [3, 4])]
    for ch in chunks:
        assert not ch.failures
        for k, i in enumerate(ch.members):
            img = ch.images[k]
            if ch.layout == "packed16":
                h, w = img.shape[1], img.shape[2] * 2
                img = img.view(torch.uint8).view(3, h, w).permute(1, 2, 0)
            assert torch.equal(img, ref.images[i])


# One cycle of jpegbench/configs/imagenet_shard.json: (width, height, images),
# q85 4:2:0, a restart every 4 MCUs.
SHARD_CYCLE = ((512, 512, 4), (768, 512, 3), (1024, 1024, 2), (2048, 2048, 1))


def _shard_datas():
    pytest.importorskip("PIL", reason="tests/corpus.py encodes with PIL")
    from corpus import make_jpeg

    return [[make_jpeg(w, h, seed=10 * k + i, quality=85, subsampling=2, restart_blocks=4) for i in range(n)]
            for k, (w, h, n) in enumerate(SHARD_CYCLE)]


def test_mixed_kernel_a_equals_bucket_launches_and_plain(cuda):
    """Kernel A's mixed form, one launch over a shard-like chunk's four
    geometry buckets (combine_plans, pinned), equals byte for byte, error
    bits too, each bucket's own launch of the one-geometry form and the
    plain version of the combined plan; the image whose payload is zeroed
    fails alone."""
    buckets = []
    for k, datas in enumerate(_shard_datas()):
        jpegs = [tpujpeg_torch.bitstream.parse(d if (k, i) != (2, 1) else zero_payload(d))
                 for i, d in enumerate(datas)]
        buckets.append((jpegs, wf.build_block_plan(jpegs), wf.PlaneLayout.of(wf.ImageGeom.of(jpegs[0]))))
    combined = wf.combine_plans([p for _j, p, _l in buckets], [lay for _j, _p, lay in buckets],
                                pin_memory=True)
    fields = [getattr(combined, f.name) for f in dataclasses.fields(combined)]
    assert all(t.is_pinned() for t in fields if isinstance(t, torch.Tensor))
    assert [p.n for p in combined.parts] == [n for _w, _h, n in SHARD_CYCLE]
    before = dict(build.LAUNCHES)
    parts, err = wf.decode_lanes_to_planes(combined.to(cuda, non_blocking=True), None, cuda)
    torch.cuda.synchronize()
    assert build.LAUNCHES["wavefront_pixels_mixed"] - before.get("wavefront_pixels_mixed", 0) == 1
    assert build.LAUNCHES["wavefront_pixels"] == before.get("wavefront_pixels", 0)
    want_parts, want_err = wf.decode_lanes_to_planes(combined, None, cuda, plain=True)
    assert torch.equal(err, want_err)
    lane0 = 0
    for (jpegs, plan, _lay), got, want in zip(buckets, parts, want_parts):
        alone, alone_err = wf.decode_lanes_to_planes(plan, [wf.ImageGeom.of(j) for j in jpegs], cuda)
        assert torch.equal(err[lane0:lane0 + plan.n_lanes], alone_err)
        for a, b, c in zip(got, want, alone):
            assert torch.equal(a, b) and torch.equal(a, c)
        lane0 += plan.n_lanes
    zeroed = SHARD_CYCLE[0][2] + SHARD_CYCLE[1][2] + 1   # image (2, 1) in plan order
    assert sorted(wf.resolve_rgb_errors(err, combined)) == [zeroed]


def test_ladder_launches_kernel_a_once_per_launch_group(cuda):
    """decode_batch_on_device over a shard-like batch and a 4:2:2 image:
    the four 4:2:0 geometry buckets share one launch of kernel A's mixed
    form, the 4:2:2 bucket takes one of the one-geometry form, and the
    color kernel runs once per bucket; every image equals the one-geometry
    decode of its own bucket (decode_batch_to_rgb)."""
    buckets = _shard_datas() + [[_read("422_2048")]]
    datas = [d for bucket in buckets for d in bucket]
    cfg = tpujpeg_torch.DecodeConfig(to_numpy=False)
    before = dict(build.LAUNCHES)
    res = tpujpeg_torch.decode_batch_on_device(datas, cfg, device=cuda)
    torch.cuda.synchronize()
    launched = {k: build.LAUNCHES[k] - before.get(k, 0) for k in build.LAUNCHES}
    assert not res.errors and {s.entropy_engine for s in res.stats} == {"wavefront-fused"}
    assert launched["wavefront_pixels_mixed"] == 1 and launched["wavefront_pixels"] == 1
    assert launched["upsample_color_h2v2"] == len(SHARD_CYCLE) and launched["upsample_color_h2v1"] == 1
    i = 0
    for bucket in buckets:
        want, failures = wf.decode_batch_to_rgb([tpujpeg_torch.bitstream.parse(d) for d in bucket], device=cuda)
        assert not failures
        for k in range(len(bucket)):
            assert torch.equal(res.images[i], want[k])
            i += 1


def test_stream_launches_kernel_a_once_per_mixed_chunk(cuda):
    """decode_stream over a shard-like chunk launches kernel A's mixed form
    once and the 4:2:0 planar kernel once per bucket, and over a chunk of
    one geometry the one-geometry form; every image equals
    decode_batch_on_device's."""
    datas = [d for bucket in _shard_datas() for d in bucket]
    datas = datas[::2] + datas[1::2] + [_read("420_2048")] * 2
    cfg = tpujpeg_torch.DecodeConfig(to_numpy=False)
    ref = tpujpeg_torch.decode_batch_on_device(datas, cfg, device=cuda)
    assert not ref.errors
    before = dict(build.LAUNCHES)
    chunks = list(tpujpeg_torch.decode_stream(datas, cfg, chunk_size=len(datas) - 2, layout="packed16",
                                              device=cuda))
    launched = {k: build.LAUNCHES[k] - before.get(k, 0) for k in build.LAUNCHES}
    assert launched["wavefront_pixels_mixed"] == 1 and launched["wavefront_pixels"] == 1
    assert launched["upsample_color_h2v2_planar"] == len(SHARD_CYCLE) + 1
    assert [(ch.engine, ch.layout) for ch in chunks] == [("wavefront-fused", "packed16")] * 2
    for ch in chunks:
        assert not ch.failures
        for k, i in enumerate(ch.members):
            img = ch.images[k]
            h, w = img.shape[1], img.shape[2] * 2
            assert torch.equal(img.view(torch.uint8).view(3, h, w).permute(1, 2, 0), ref.images[i])


def test_batch_entries_on_card_match_pil_hashes(cuda):
    """decode_batch_on_device and decode_batch on every fixture but the
    2048^2 ones, a corrupted member and bytes that are no JPEG."""
    import hashlib

    names = [n for n in MANIFEST["fixtures"] if "2048" not in n]
    datas = [_read(n) for n in names] + [zero_payload(_read("420_odd")), b"not a jpeg"]
    for fn in (tpujpeg_torch.decode_batch_on_device, tpujpeg_torch.decode_batch):
        res = fn(datas, device=cuda)
        assert {i: type(e).__name__ for i, e in res.errors.items()} == {
            len(names): "JpegHuffmanError", len(names) + 1: "JpegSyntaxError"}
        for i, n in enumerate(names):
            assert hashlib.sha256(res.images[i].tobytes()).hexdigest() == MANIFEST["fixtures"][n]["pil_sha256"]
            assert res.stats[i].transform_engine == "cuda"
        engines = {n: res.stats[i].entropy_engine for i, n in enumerate(names)}
        if fn is tpujpeg_torch.decode_batch:
            assert set(engines.values()) == {"native"}
        else:
            assert engines == {n: {"progressive": "wavefront-prog", "fused": "wavefront-fused",
                                   "norst": "wavefront-skeleton"}.get(
                MANIFEST["fixtures"][n]["path"], "wavefront-coeff") for n in names}


def test_kernel_failure_raises_through_batch_and_stream(cuda, monkeypatch):
    """A kernel launch that fails (build.raise_on_error raising, as on a
    CUDA error) propagates out of every rung of the batch ladder and the
    stream: no image's work moves to host entropy and no slot reports it
    as a corrupt JPEG."""
    def fail(rc, name):
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error 700")

    monkeypatch.setattr(build, "raise_on_error", fail)
    for names in (["420_odd"], ["prog_444"], ["multiscan"], ["420_odd", "prog_444", "multiscan"]):
        datas = [_read(n) for n in names]
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            tpujpeg_torch.decode_batch_on_device(datas, device=cuda)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            list(tpujpeg_torch.decode_stream(datas, device=cuda))


def test_pinned_plan_equals_pageable_plan(cuda):
    """build_block_plan(pin_memory=True) packs the rows straight into
    page-locked memory; every tensor is pinned and equal to the pageable
    plan's, and the kernel decodes both alike."""
    jpegs = [tpujpeg_torch.bitstream.parse(_read("420_odd"))] * 2
    pinned, plain = wf.build_block_plan(jpegs, pin_memory=True), wf.build_block_plan(jpegs)
    geoms = [wf.ImageGeom.of(j) for j in jpegs]
    for f in ("bits", "seg_bits", "lane_m", "lane_qset", "lane_meta", "tables", "huffval", "qsets"):
        a, b = getattr(pinned, f), getattr(plain, f)
        assert a.is_pinned() and not b.is_pinned() and torch.equal(a, b), f
    got = wf.decode_lanes_to_planes(pinned.to(cuda, non_blocking=True), geoms, cuda)
    want = wf.decode_lanes_to_planes(plain, geoms, cuda)
    torch.cuda.synchronize()
    for x, y in zip(got[0] + [got[1]], want[0] + [want[1]]):
        assert torch.equal(x, y)


# --- the sharded paths on one card: a mesh of (cuda:0,) * shards


def _sha(t):
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name,n", [("420_2048", 4), ("420_odd", 3), ("norst_2048", 4), ("422_2048", 4),
                                    ("444_2048", 4), ("gray", 4), ("rst_rows_420", 4), ("multiscan", 2),
                                    ("prog_444", 4)])
def test_decode_sharded_on_card_matches_pil_hashes(cuda, name, n):
    """decode_sharded on n shards of one card: the RGB hashes to PIL's;
    kernel 6 runs once per component and shard; the color kernel of the
    sampling once per shard; kernel 2 once for a restart-segmented scan
    and once per shard for a marker-free one."""
    from tpujpeg_torch.parallel import halo

    build.LAUNCHES.clear()
    out = halo.decode_sharded(_read(name), config=tpujpeg_torch.DecodeConfig(to_numpy=False), mesh=(cuda,) * n)
    torch.cuda.synchronize()
    assert _sha(out) == MANIFEST["fixtures"][name]["pil_sha256"]
    frame = tpujpeg_torch.bitstream.parse(_read(name)).frame
    live = sum(a < b for a, b in halo.shard_spans(frame, n))
    assert build.LAUNCHES["dequant_idct_islow"] == live * frame.n_components
    color = {"420_2048": "upsample_color_h2v2", "420_odd": "upsample_color_h2v2", "norst_2048": "upsample_color_h2v2",
             "rst_rows_420": "upsample_color_h2v2", "422_2048": "upsample_color_h2v1", "444_2048": "color_444",
             "multiscan": "upsample_color_h2v2", "prog_444": "color_444"}.get(name)
    colors = ("upsample_color_h2v2", "upsample_color_h2v1", "color_444")
    assert {k: build.LAUNCHES[k] for k in colors if build.LAUNCHES[k]} == ({color: live} if color else {})
    kernel_2 = {"norst_2048": n, "420_2048": 1, "420_odd": 1, "422_2048": 1, "444_2048": 1, "gray": 1}
    if name in kernel_2:
        assert build.LAUNCHES["wavefront_coeff"] == kernel_2[name]
    assert build.LAUNCHES["wavefront_pixels"] == 0


def test_norst_sharded_on_card_equals_single_device(cuda):
    jpeg = tpujpeg_torch.bitstream.parse(_read("norst_2048"))
    for every in (0, 1):
        build.LAUNCHES.clear()
        got = wf.decode_norst_sharded(jpeg, every=every, mesh=(cuda,) * 4)
        assert build.LAUNCHES["wavefront_coeff"] == 4
        want = wf.decode_norst_to_device(jpeg, every=every, device=cuda)
        for a, b in zip(got, want):
            assert a.device == cuda and torch.equal(a, b)


def test_sharded_giant_tile_equals_fused_decode(cuda):
    """420_2048 tiled 2 x 2 (tile_jpeg) on 4 shards equals the fused
    single-device decode of the same bytes."""
    from tpujpeg_torch.fixtures.tile import tile_jpeg
    from tpujpeg_torch.parallel import halo

    data = tile_jpeg(_read("420_2048"), 2, 2)
    out = halo.decode_sharded(data, config=tpujpeg_torch.DecodeConfig(to_numpy=False), mesh=(cuda,) * 4)
    rgb, failures = tpujpeg_torch.decode_batch_to_rgb([tpujpeg_torch.bitstream.parse(data)], device=cuda)
    assert not failures and torch.equal(out, rgb[0])


def test_decode_batch_to_rgb_sharded_on_card(cuda):
    jpegs = [tpujpeg_torch.bitstream.parse(_read("420_odd")) for _ in range(4)]
    build.LAUNCHES.clear()
    rgbs, failures = wf.decode_batch_to_rgb_sharded(jpegs, mesh=(cuda,) * 2)
    assert not failures and build.LAUNCHES["wavefront_pixels"] == 2
    want, _ = tpujpeg_torch.decode_batch_to_rgb(jpegs, device=cuda)
    assert torch.equal(torch.cat(rgbs), want)


def test_decode_batch_over_a_card_mesh(cuda):
    names = ["420_odd", "422", "444", "gray", "420_odd"]
    res = tpujpeg_torch.decode_batch([_read(n) for n in names], mesh=(cuda,) * 2)
    assert not res.errors
    for n, img in zip(names, res.images):
        import hashlib

        assert hashlib.sha256(img.tobytes()).hexdigest() == MANIFEST["fixtures"][n]["pil_sha256"]


def test_sharded_paths_over_every_card(cuda):
    """One shard per card (skips with fewer than two): decode_sharded of a
    tiled image equals the fused decode on card 0, decode_norst_sharded's
    coefficients decode_norst_to_device's, decode_batch_to_rgb_sharded
    puts each chunk on its card, and decode_batch(mesh=...) hashes to PIL."""
    from tpujpeg_torch.fixtures.tile import tile_jpeg
    from tpujpeg_torch.parallel import halo

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards: one shard per card")
    mesh = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    data = tile_jpeg(_read("420_2048"), 4, 4)
    out = halo.decode_sharded(data, config=tpujpeg_torch.DecodeConfig(to_numpy=False), mesh=mesh)
    rgb, failures = tpujpeg_torch.decode_batch_to_rgb([tpujpeg_torch.bitstream.parse(data)], device=cuda)
    assert not failures and out.device == mesh[0] and torch.equal(out, rgb[0])
    jpeg = tpujpeg_torch.bitstream.parse(_read("norst_2048"))
    for a, b in zip(wf.decode_norst_sharded(jpeg, mesh=mesh), wf.decode_norst_to_device(jpeg, device=cuda)):
        assert torch.equal(a, b)
    jpegs = [tpujpeg_torch.bitstream.parse(_read("420_odd")) for _ in mesh]
    rgbs, failures = wf.decode_batch_to_rgb_sharded(jpegs, mesh=mesh)
    want, _ = tpujpeg_torch.decode_batch_to_rgb(jpegs, device=cuda)
    assert not failures and [r.device for r in rgbs] == list(mesh)
    assert all(torch.equal(r[0].to(cuda), want[i]) for i, r in enumerate(rgbs))
    names = ["420_odd", "422", "444", "gray"] * 2
    res = tpujpeg_torch.decode_batch([_read(n) for n in names], mesh=mesh)
    assert not res.errors
    for n, img in zip(names, res.images):
        assert _sha(torch.from_numpy(img)) == MANIFEST["fixtures"][n]["pil_sha256"]


# --- the graft entry points (tpujpeg_torch/graft_entry.py)


def test_graft_entry_on_the_card_equals_the_plain_transform(cuda):
    """entry()'s step runs kernel 6 three times and B once, and equals the
    plain transform of the same tensors copied to the host."""
    from tpujpeg_torch import graft_entry
    from tpujpeg_torch import transform as T

    fn, args = graft_entry.entry()
    assert all(t.device == cuda for part in args for t in part)
    build.LAUNCHES.clear()
    out = fn(*args)
    torch.cuda.synchronize()
    assert {k: n for k, n in build.LAUNCHES.items() if n} == {"dequant_idct_islow": 3, "upsample_color_h2v2": 1}
    assert out.device == cuda and tuple(out.shape) == (*graft_entry.ENTRY_SIZE, 3)
    frame = graft_entry.make_frame(*graft_entry.ENTRY_SIZE, graft_entry.H2V2)
    assert torch.equal(out.cpu(), T.transform_frame(frame, [c.cpu() for c in args[0]], [q.cpu() for q in args[1]]))


def test_dryrun_multichip_on_the_card(cuda):
    """Four shards: one per card with four or more cards, else card 0 four
    times; every path checks itself and raises on a wrong result."""
    from tpujpeg_torch import graft_entry

    build.LAUNCHES.clear()
    res = graft_entry.dryrun_multichip(4)
    cards = 4 if torch.cuda.device_count() >= 4 else 1
    assert (res["shards"], res["devices"]) == (4, cards)
    assert res["mesh"][0] == str(cuda) and res["outputs"]["1"].device == cuda
    assert all(build.LAUNCHES[k] for k in ("wavefront_pixels", "dequant_idct_islow", "upsample_color_h2v2"))


def test_dryrun_multichip_one_shard_per_card(cuda):
    """One shard per card (skips with fewer than two): the shards' rows,
    fixup totals and batch pieces cross cards."""
    from tpujpeg_torch import graft_entry

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards: one shard per card")
    res = graft_entry.dryrun_multichip(n)
    assert res["devices"] == n and res["mesh"] == [f"cuda:{i}" for i in range(n)]
    assert [t.device.index for t in res["outputs"]["1b"]] == list(range(n))


def test_spans_record_nothing_under_a_profile_of_the_card_alone(cuda):
    """A profile of the card alone (torch.profiler with ProfilerActivity.CUDA,
    as the benchmark's untraced runs take) leaves the port's span log empty;
    with the host's events too, each fused packed16 chunk counts its two
    launches (kernel A, the 4:2:0 planar kernel) under its own chunk id, and
    no device event carries a span's name (the benchmark counts every
    device event but user annotations as the card's work)."""
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpujpeg_torch import spans

    datas = [_read("420_2048")] * 4
    cfg = tpujpeg_torch.DecodeConfig(to_numpy=False)
    spans.drain()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert not spans.recording()
        list(tpujpeg_torch.decode_stream(datas, cfg, chunk_size=2, layout="packed16", device=cuda))
        tpujpeg_torch.decode(datas[0], cfg, device=cuda)
    assert spans.drain() == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert spans.recording()
        chunks = list(tpujpeg_torch.decode_stream(datas, cfg, chunk_size=2, layout="packed16", device=cuda))
    recs = spans.drain()
    assert [c.engine for c in chunks] == ["wavefront-fused"] * 2
    for k in (0, 1):
        assert sum(r.n for r in recs if r.name == spans.LAUNCH and r.unit == k) == 2
    assert {r.name for r in recs if r.thread != threading.get_ident()} == {spans.PARSE, spans.PLAN}
    assert any(e.name == spans.SYNC for e in prof.events())
    assert all(e.is_user_annotation for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name.startswith("tpujpeg_torch."))
