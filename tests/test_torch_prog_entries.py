"""The progressive path of the port on device="cpu" (kernels 7-9 through
their plain versions) against the reference on corrupt streams, and its
entries against the reference, the python oracle and PIL.

Corrupt streams: the truncated and zeroed scans of test_prog_device,
scan by scan; a group of 3 with one member's AC-first payload zeroed,
and seeded byte flips in AC-refine payloads, through both packages'
whole-sequence drivers (the reference's jitted chain), with the states
of every member, the per-lane error bits of every scan and the failure
classes equal. The groups share one stream shape and its tables, so the
reference compiles its chain once. Tolerance 0."""

import numpy as np
import pytest

import jax.numpy as jnp

from corpus import make_jpeg, pil_decode
from test_prog_device import _bump_dqt
from test_torch_prog import apply_both

import tpujpeg
from tpujpeg import bitstream as ref_bitstream
from tpujpeg import huffman as ref_huffman
from tpujpeg.config import DecodeConfig as RefDecodeConfig
from tpujpeg.errors import JpegError as RefJpegError
from tpujpeg.errors import JpegUnsupportedError as RefJpegUnsupportedError
from tpujpeg.kernels import wavefront_prog as ref_prog

import tpujpeg_torch
from tpujpeg_torch import DecodeConfig, bitstream, huffman
from tpujpeg_torch.kernels import wavefront as pw
from tpujpeg_torch.kernels import wavefront_prog as prog


def _names(failures):
    return {i: type(e).__name__ for i, e in failures.items()}


def test_truncated_scan_raises_like_reference():
    """test_prog_device's truncated scan: its restart segments go missing,
    which both planners refuse before any launch."""
    data = make_jpeg(128, 96, seed=22, progressive=True, subsampling=2, restart_blocks=8)

    def truncate(jpegs):
        s = jpegs[0].scans[1]
        s.data = s.data[: len(s.data) // 3]
        s.rst_offsets = [o for o in s.rst_offsets if o < len(s.data)]

    with pytest.raises(RefJpegError) as ref_exc:
        apply_both([data], truncate)
    assert type(ref_exc.value).__name__ == "JpegTruncatedError"
    port = bitstream.parse(data)
    truncate([port])
    with pytest.raises(tpujpeg_torch.JpegTruncatedError):
        prog.decode_all_scans(port, device="cpu")


def test_zeroed_scan_matches_reference():
    """test_prog_device's zeroed scan: every scan after it runs on the
    garbage it leaves, and both packages agree on all of it."""
    data = make_jpeg(96, 96, seed=23, progressive=True, subsampling=2, restart_blocks=8)

    def zero(jpegs):
        jpegs[0].scans[2].data = bytes(len(jpegs[0].scans[2].data))

    kinds, errs = apply_both([data], zero)
    assert kinds[2] == "ac_first"


GROUP = make_jpeg(96, 96, seed=51, progressive=True, subsampling=2, restart_blocks=8)


def _chain_both(datas, mutate=None):
    """Both whole-sequence drivers on a group; returns the port's failures
    after asserting equal states, error bits and failure classes."""
    ref = [ref_bitstream.parse(d) for d in datas]
    port = [bitstream.parse(d) for d in datas]
    if mutate:
        mutate(ref)
        mutate(port)
    fn, arrs, masks, ref_plans = ref_prog.build_chain_inputs(ref)
    ref_acs, ref_dcs, ref_errs = fn(arrs, masks)
    acs, dcs, errs, plans = prog.run_scans(port[0].frame, len(port), prog.plan_scans(port), "cpu")
    assert len(errs) == len(ref_errs)
    want_fail = {}
    for k, (a, b, ref_plan) in enumerate(zip(errs, ref_errs, ref_plans)):
        want = np.asarray(b).reshape(-1)[: ref_plan.n_lanes]
        np.testing.assert_array_equal(a.numpy(), want, err_msg=f"kernel scan {k} error bits")
        for img, exc in ref_prog.failures_from_err(want, ref_plan.lane_meta).items():
            want_fail.setdefault(img, exc)
    for i in range(len(datas)):
        for ci in range(len(acs)):
            np.testing.assert_array_equal(acs[ci][i].numpy(), np.asarray(ref_acs[i][ci]))
            np.testing.assert_array_equal(dcs[ci][i].numpy(), np.asarray(ref_dcs[i][ci]))
    failures = prog.resolve_scan_errors(errs, plans)
    assert _names(failures) == _names(want_fail)
    return failures


def _zero_ac_first(jpegs):
    """test_prog_device's bad member: the first 48 bytes of member 1's
    first AC-first payload zeroed, on the parsed stream (its restart
    offsets stay, so the group keeps its lanes)."""
    scan = next(s for s in jpegs[1].scans if s.ss and not s.ah and len(s.data) > 64)
    scan.data = bytes(48) + bytes(scan.data[48:])


def test_group_with_zeroed_ac_first_payload_matches_reference():
    """All-zero bytes may still decode (to wrong coefficients): the
    contract is the reference's behavior, lane for lane, and the good
    members bit-exact."""
    failures = _chain_both([GROUP] * 3, _zero_ac_first)
    assert set(failures) <= {1}
    jpegs = [bitstream.parse(GROUP) for _ in range(3)]
    _zero_ac_first(jpegs)
    rgb, layout, fail = prog.decode_all_scans_to_rgb_batch(jpegs, device="cpu")
    assert layout == "nhwc" and fail.keys() == failures.keys()
    _rgb, _layout, (errs, plans) = prog.decode_all_scans_to_rgb_batch(jpegs, defer_errors=True, device="cpu")
    assert _names(prog.resolve_scan_errors(errs, plans)) == _names(failures)
    for i in (0, 2):
        np.testing.assert_array_equal(rgb[i].numpy(), pil_decode(GROUP))


def test_ac_refine_byte_flips_match_reference():
    """Nine seeded byte flips, three in each member, each in an AC-refine
    payload, applied to the parsed streams (restart offsets, hence the
    row width and the reference's compiled chain, stay)."""
    rng = np.random.default_rng(7)
    scans = ref_bitstream.parse(GROUP).scans
    refine = [k for k, s in enumerate(scans) if s.ss and s.ah]
    flips = []
    for _ in range(9):
        k = int(rng.choice(refine))
        flips.append((k, int(rng.integers(0, len(scans[k].data))), int(rng.integers(1, 256))))

    def mutate(jpegs):
        for i, (k, pos, x) in enumerate(flips):
            scan = jpegs[i % 3].scans[k]
            data = bytearray(scan.data)
            data[pos] ^= x
            scan.data = bytes(data)

    failures = _chain_both([GROUP] * 3, mutate)
    assert failures


def test_decode_all_scans_batch_matches_reference_and_oracle():
    jpegs = [bitstream.parse(GROUP) for _ in range(3)]
    ref = [ref_bitstream.parse(GROUP) for _ in range(3)]
    assert len({prog.scan_group_key(j) for j in jpegs}) == 1
    states, dcs, failures = prog.decode_all_scans_batch(jpegs, device="cpu")
    ref_states, ref_dcs, ref_failures = ref_prog.decode_all_scans_batch(ref)
    assert not failures and not ref_failures
    oracle = huffman.decode_all_scans(jpegs[0])
    for a, b in zip(oracle, ref_huffman.decode_all_scans(ref[0])):
        np.testing.assert_array_equal(a, b)
    for i in range(3):
        for ci in range(3):
            np.testing.assert_array_equal(states[i][ci].numpy(), np.asarray(ref_states[i][ci]))
            np.testing.assert_array_equal(dcs[i][ci].numpy(), np.asarray(ref_dcs[i][ci]))
            merged = states[i][ci].clone()
            merged[:, 0] = dcs[i][ci]
            np.testing.assert_array_equal(merged.numpy(), oracle[ci])


def test_decode_all_scans_to_rgb_batch_matches_pil_with_mixed_quantizers():
    """test_prog_device's pair with bumped DQTs: one group (same tables),
    per-image quantizers, both bit-exact."""
    base = make_jpeg(96, 80, seed=77, progressive=True, subsampling=2, restart_blocks=8)
    variant = _bump_dqt(base)
    jpegs = [bitstream.parse(d) for d in (base, variant)]
    assert prog.scan_group_key(jpegs[0]) == prog.scan_group_key(jpegs[1])
    rgb, layout, failures = tpujpeg_torch.decode_all_scans_to_rgb_batch(jpegs, device="cpu")
    assert not failures and layout == "nhwc" and rgb.shape == (2, 80, 96, 3)
    for i, d in enumerate((base, variant)):
        np.testing.assert_array_equal(rgb[i].numpy(), pil_decode(d))


def test_gray_group_to_rgb_matches_pil():
    data = make_jpeg(96, 64, seed=13, mode="L", progressive=True, restart_blocks=8)
    rgb, layout, failures = tpujpeg_torch.decode_all_scans_to_rgb_batch([bitstream.parse(data)] * 2,
                                                                         packed=True, device="cpu")
    assert not failures and layout == "nhwc"
    for i in range(2):
        np.testing.assert_array_equal(rgb[i].numpy(), pil_decode(data))


def test_group_with_different_tables_raises():
    """Different Huffman tables no longer split a group: the pair (two
    ``scan_group_key``s, one ``prog_launch_key``) decodes together, each
    image equal to PIL. A baseline member still raises."""
    datas = [make_jpeg(64, 48, seed=s, progressive=True, subsampling=2, restart_blocks=4) for s in (31, 32)]
    jpegs = [bitstream.parse(d) for d in datas]
    assert prog.scan_group_key(jpegs[0]) != prog.scan_group_key(jpegs[1])
    assert prog.prog_launch_key(jpegs[0]) == prog.prog_launch_key(jpegs[1])
    rgb, layout, failures = prog.decode_all_scans_to_rgb_batch(jpegs, device="cpu")
    assert not failures and layout == "nhwc"
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(rgb[i].numpy(), pil_decode(d))
    with pytest.raises(tpujpeg_torch.JpegUnsupportedError, match="progressive"):
        prog.decode_all_scans_batch([bitstream.parse(make_jpeg(32, 32, seed=1))], device="cpu")


def test_group_with_different_geometries_raises():
    jpegs = [bitstream.parse(make_jpeg(w, 48, seed=31, progressive=True, subsampling=2, restart_blocks=4))
             for w in (64, 80)]
    assert prog.prog_launch_key(jpegs[0]) != prog.prog_launch_key(jpegs[1])
    with pytest.raises(tpujpeg_torch.JpegUnsupportedError, match="separate groups"):
        prog.decode_all_scans_to_rgb_batch(jpegs, device="cpu")


# Three 4:2:0 progressive files with restarts, each with its own optimized
# tables: one prog_launch_key, three scan_group_keys. Their lanes per scan
# (6 or 16 a file) are no multiple of 128, so a plan with several table
# sets pads between images.
TSETS = [make_jpeg(64, 48, seed=s, progressive=True, subsampling=2, restart_blocks=3) for s in (61, 62, 63)]


def _scan_table_sets(jpegs, k):
    """The distinct bytes of the tables scan k reads, over the group."""
    return len({prog.scan_group_key(j)[3 + k][-1] for j in jpegs})


def test_table_set_group_plans_one_launch_per_scan_with_a_set_per_image():
    jpegs = [bitstream.parse(d) for d in TSETS]
    assert len({prog.scan_group_key(j) for j in jpegs}) == 3
    assert len({prog.prog_launch_key(j) for j in jpegs}) == 1
    sets = []
    for k, step in enumerate(prog.plan_scans(jpegs)):
        if isinstance(step, prog.DcRefine):
            continue
        n = _scan_table_sets(jpegs, k)
        assert step.n_sets == n and tuple(step.tables.shape[:1]) == tuple(step.luts.shape[:1]) == (n,)
        assert sorted(set(step.image_set.tolist())) == list(range(n))
        meta = step.lane_meta.numpy()
        for i, j in enumerate(jpegs):
            mine = np.nonzero(meta[:, 0] == i)[0]
            real = mine[meta[mine, 2] > 0]
            assert real[0] == mine[0] and (mine[0] % prog.PROG_THREADS == 0 or n == 1)
            assert np.array_equal(real, np.arange(real[0], real[0] + len(real)))
            assert int(meta[real, 2].sum()) == prog._seg_geometry(j, j.scans[k])[0]
            assert not step.seg_bits[mine[meta[mine, 2] == 0]].any()
        sets.append(n)
    assert max(sets) == 3
    # One set (copies of one file): today's plan, lanes back to back.
    for k, step in enumerate(prog.plan_scans([jpegs[0]] * 2)):
        if isinstance(step, prog.ScanPlan):
            n_seg = prog._seg_geometry(jpegs[0], jpegs[0].scans[k])[2]
            assert step.n_sets == 1 and step.n_lanes == 2 * n_seg and not step.image_set.any()


def test_table_set_group_matches_pil_through_both_entries(monkeypatch):
    jpegs = [bitstream.parse(d) for d in TSETS]
    rgb, layout, failures = prog.decode_all_scans_to_rgb_batch(jpegs, device="cpu")
    assert not failures and layout == "nhwc"
    for i, d in enumerate(TSETS):
        np.testing.assert_array_equal(rgb[i].numpy(), pil_decode(d))
    groups = []
    real = prog.decode_all_scans_to_rgb_batch
    monkeypatch.setattr(prog, "decode_all_scans_to_rgb_batch",
                        lambda js, *a, **kw: groups.append(len(js)) or real(js, *a, **kw))
    res = tpujpeg_torch.decode_batch_on_device(TSETS, device="cpu")
    assert not res.errors and groups == [3]
    assert all(st.entropy_engine == "wavefront-prog" for st in res.stats)
    for i, d in enumerate(TSETS):
        np.testing.assert_array_equal(res.images[i], pil_decode(d))


def _ff_ac_first(jpeg):
    """Member 1's first AC-first payload all 0xFF: its lanes read invalid
    codes."""
    scan = next(s for s in jpeg.scans if s.ss and not s.ah)
    scan.data = b"\xff" * len(scan.data)


def test_table_set_group_isolates_a_corrupt_member(monkeypatch):
    jpegs = [bitstream.parse(d) for d in TSETS]
    _ff_ac_first(jpegs[1])
    rgb, _layout, failures = prog.decode_all_scans_to_rgb_batch(jpegs, device="cpu")
    assert set(failures) == {1} and isinstance(failures[1], tpujpeg_torch.JpegHuffmanError)
    for i in (0, 2):
        np.testing.assert_array_equal(rgb[i].numpy(), pil_decode(TSETS[i]))
    real = bitstream.parse

    def parse(data):
        j = real(data)
        if data is TSETS[1]:
            _ff_ac_first(j)
        return j

    monkeypatch.setattr(bitstream, "parse", parse)
    res = tpujpeg_torch.decode_batch_on_device(TSETS, device="cpu")
    assert set(res.errors) == {1} and isinstance(res.errors[1], tpujpeg_torch.JpegHuffmanError)
    for i in (0, 2):
        np.testing.assert_array_equal(res.images[i], pil_decode(TSETS[i]))


KEY_CORPUS = [
    dict(w=128, h=96, subsampling=2, restart_blocks=8),
    dict(w=96, h=96, subsampling=0, restart_blocks=4),
    dict(w=120, h=88, subsampling=1, restart_blocks=6),
    dict(w=96, h=64, mode="L", restart_blocks=8),
    dict(w=129, h=65, subsampling=2, restart_blocks=3),
    dict(w=64, h=48, subsampling=2),
]


@pytest.mark.parametrize("kw", KEY_CORPUS, ids=[str(i) for i in range(len(KEY_CORPUS))])
def test_scan_group_key_matches_reference(kw):
    kw = dict(kw)
    w, h = kw.pop("w"), kw.pop("h")
    data = make_jpeg(w, h, seed=13, progressive=True, **kw)
    assert prog.scan_group_key(bitstream.parse(data)) == ref_prog.scan_group_key(ref_bitstream.parse(data))


def test_decode_wavefront_engine_progressive_matches_reference_and_pil():
    data = make_jpeg(128, 96, seed=21, progressive=True, subsampling=2, restart_blocks=8)
    got, stats = tpujpeg_torch.decode(data, DecodeConfig(entropy_engine="wavefront"), device="cpu",
                                      return_stats=True)
    assert stats.entropy_engine == "wavefront" and stats.transform_engine == "torch"
    np.testing.assert_array_equal(got, pil_decode(data))
    np.testing.assert_array_equal(got, np.asarray(tpujpeg.decode(data)))
    coeffs = pw.decode_all_scans(bitstream.parse(data), device="cpu")
    for a, b in zip(coeffs, huffman.decode_all_scans(bitstream.parse(data))):
        np.testing.assert_array_equal(a.numpy(), b)


def test_oversize_scan_without_restarts_raises_in_both():
    """A scan over 2040 bytes without restart markers is outside both
    packages' device progressive path."""
    data = make_jpeg(256, 256, seed=5, progressive=True, subsampling=2)
    assert any(len(s.data) > 2040 for s in bitstream.parse(data).scans)
    with pytest.raises(tpujpeg_torch.JpegUnsupportedError,
                       match="progressive scan without restart segmentation"):
        tpujpeg_torch.decode(data, DecodeConfig(entropy_engine="wavefront"), device="cpu")
    with pytest.raises(RefJpegUnsupportedError):
        tpujpeg.decode(data, RefDecodeConfig(entropy_engine="wavefront"))
