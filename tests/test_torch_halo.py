"""The port's sharded paths on meshes of CPU devices (("cpu",) * n: one
process, n shards, the counterpart of tests/conftest.py's 8 virtual XLA
devices), where the kernels' plain versions run: halo.decode_sharded
against PIL on every input of tests/test_parallel.py at its shard count
and on the exotic samplings of tests/test_color.py, and against the
reference's tpujpeg.parallel.halo.decode_sharded; decode_norst_sharded's
coefficients and its DC fixup against the reference's; dc_prefix_fixup,
the shard windows, the meshes, decode_batch_to_rgb_sharded,
decode_batch(mesh=...) and tile_jpeg, which makes the giant image.
Tolerance 0."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import make_jpeg, make_synth_jpeg, pil_decode

import tpujpeg
from tpujpeg.kernels import wavefront_pallas as ref_wp
from tpujpeg.parallel import halo as ref_halo

import tpujpeg_torch
from tpujpeg_torch import DecodeConfig, JpegUnsupportedError, bitstream
from tpujpeg_torch.decoder import _entropy_decode
from tpujpeg_torch.fixtures.tile import crop_jpeg, norst_jpeg, tile_jpeg
from tpujpeg_torch.kernels import idct
from tpujpeg_torch.kernels import wavefront as wf
from tpujpeg_torch.parallel import halo
from tpujpeg_torch.parallel import mesh as mesh_lib
from tpujpeg_torch.stats import DecodeStats

EXOTIC = [((1, 2), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1)), ((2, 2), (2, 1), (1, 2)),
          ((1, 1), (1, 2), (2, 1))]

# name -> (corpus call, shards): tests/test_parallel.py's inputs and shard
# counts, one of them at 1 and 3 shards, a last shard of one row, and
# test_color.py's exotic samplings with and without restart markers on 4.
CASES = {
    "420_192x256": (lambda: make_jpeg(192, 256, seed=21, subsampling=2), 8),
    "422_128": (lambda: make_jpeg(128, 128, seed=22, subsampling=1), 8),
    "444_128": (lambda: make_jpeg(128, 128, seed=22, subsampling=0), 8),
    "pad_rows_96x144": (lambda: make_jpeg(96, 144, seed=23, subsampling=2), 8),
    "pad_rows_96x144_1": (lambda: make_jpeg(96, 144, seed=23, subsampling=2), 1),
    "pad_rows_96x144_3": (lambda: make_jpeg(96, 144, seed=23, subsampling=2), 3),
    **{f"bottom_edge_h{h}": (lambda h=h: make_jpeg(80, h, seed=h, subsampling=2), 4) for h in (81, 95, 103)},
    # The last shard holds one luma row of the image.
    "bottom_edge_one_row_h97": (lambda: make_jpeg(80, 97, seed=97, subsampling=2), 4),
    "restart_4": (lambda: make_jpeg(192, 256, seed=31, subsampling=2, restart_blocks=4), 8),
    "marker_free_160x128": (lambda: make_jpeg(160, 128, seed=37, subsampling=2), 8),
    "restart_200": (lambda: make_jpeg(160, 160, seed=41, subsampling=2, restart_blocks=200), 4),
    **{f"exotic_{''.join(f'{h}{v}' for h, v in hv)}_rb{rb}":
       (lambda hv=hv, rb=rb: make_synth_jpeg(72, 56, hv=hv, seed=3, restart_blocks=rb), 4)
       for hv in EXOTIC for rb in (4, 0)},
}


def _cpu(n):
    return ("cpu",) * n


@functools.lru_cache(maxsize=None)
def _case(name):
    """(bytes, shards, the port's sharded decode): computed once per case
    for the PIL and the reference comparisons."""
    make, n = CASES[name]
    data = make()
    return data, n, halo.decode_sharded(data, n_shards=n, mesh=_cpu(n))


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_sharded_matches_pil(name):
    data, _n, out = _case(name)
    np.testing.assert_array_equal(out, pil_decode(data))


def test_decode_sharded_equals_the_reference():
    data, n, out = _case("420_192x256")
    np.testing.assert_array_equal(out, np.asarray(ref_halo.decode_sharded(data, n_shards=n)))


def test_decode_sharded_returns_a_tensor_without_to_numpy():
    data = make_jpeg(64, 48, seed=5, subsampling=2, restart_blocks=2)
    out = halo.decode_sharded(data, config=DecodeConfig(to_numpy=False), mesh=_cpu(2))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), pil_decode(data))


# --- decode_norst_sharded: the reference's test_norst_sharded_entropy_with_dc_fixup call

NORST = make_jpeg(320, 256, seed=31, subsampling=2)  # no restart markers


@pytest.fixture(scope="module")
def norst_sharded():
    """The port's decode_norst_sharded on 8 CPU shards, with a spy on
    halo.dc_prefix_fixup recording its inputs and outputs."""
    calls = []
    orig = halo.dc_prefix_fixup

    def spy(totals):
        out = orig(totals)
        calls.append(([t.clone() for t in totals], [b.clone() for b in out]))
        return out

    halo.dc_prefix_fixup = spy
    try:
        comps = wf.decode_norst_sharded(bitstream.parse(NORST), mesh=_cpu(8))
    finally:
        halo.dc_prefix_fixup = orig
    return comps, calls


def test_norst_sharded_dc_base_goes_through_dc_prefix_fixup(norst_sharded):
    _comps, calls = norst_sharded
    assert len(calls) == 1
    totals, bases = calls[0]
    assert len(totals) == 8 and all(t.shape == (3,) for t in totals)
    allv = torch.stack(totals)
    assert torch.equal(torch.stack(bases), torch.cumsum(allv, 0) - allv)
    assert any(bool(b.any()) for b in bases)


def test_norst_sharded_coefficients_equal_reference_and_single_device(norst_sharded):
    comps, _calls = norst_sharded
    jpeg = tpujpeg.bitstream.parse(NORST)
    ref = ref_wp.decode_norst_sharded(jpeg)
    single = wf.decode_norst_to_device(bitstream.parse(NORST), device="cpu")
    for a, b, c in zip(comps, ref, single):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)


def test_norst_sharded_output_depends_on_the_fixup(monkeypatch):
    """With the cross-shard base dropped, the DCs after shard 0 go wrong:
    the base reaches the coefficients only through dc_prefix_fixup."""
    jpeg = bitstream.parse(make_jpeg(64, 64, seed=8, subsampling=2))
    good = wf.decode_norst_sharded(jpeg, every=1, mesh=_cpu(4))
    assert all(torch.equal(a, b) for a, b in zip(good, wf.decode_norst_to_device(jpeg, every=1, device="cpu")))
    monkeypatch.setattr(halo, "dc_prefix_fixup", lambda totals: [torch.zeros_like(t) for t in totals])
    bad = wf.decode_norst_sharded(jpeg, every=1, mesh=_cpu(4))
    assert not all(torch.equal(a, b) for a, b in zip(good, bad))


def test_norst_sharded_refuses_restart_segmented_scans():
    jpeg = bitstream.parse(make_jpeg(64, 48, seed=1, subsampling=2, restart_blocks=2))
    with pytest.raises(JpegUnsupportedError):
        wf.decode_norst_sharded(jpeg, mesh=_cpu(2))


def test_dc_prefix_fixup_contract_and_reference():
    n = 8
    totals = torch.arange(n * 3, dtype=torch.int32).reshape(n, 3)
    got = halo.dc_prefix_fixup([totals[i] for i in range(n)])
    assert all(g.dtype == torch.int32 for g in got)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    fx = jax.jit(shard_map(lambda local: ref_halo.dc_prefix_fixup(local[0], "rows")[None],
                           mesh=jax.make_mesh((n,), ("rows",)), in_specs=P("rows", None),
                           out_specs=P("rows", None), check_vma=False))
    want = np.asarray(fx(jnp.arange(n * 3, dtype=jnp.int32).reshape(n, 3)))
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    np.testing.assert_array_equal(want, np.cumsum(totals.numpy(), 0) - totals.numpy())


# --- shard windows


def test_shard_windows_add_one_mcu_row_either_side_clipped_at_the_edges():
    frame = bitstream.parse(make_jpeg(96, 144, seed=23, subsampling=2)).frame  # 9 MCU rows
    assert halo.shard_windows(frame, 8) == [(0, 2, 0, 3), (2, 4, 1, 5), (4, 6, 3, 7), (6, 8, 5, 9), (8, 9, 7, 9)]
    assert halo.shard_windows(frame, 1) == [(0, 9, 0, 9)]


def test_shard_planes_hold_each_window_cropped_to_the_image():
    """Kernel 6's planes per shard: the window's sample rows, the last
    one cut at the component's sample height (97 luma rows, 49 chroma)."""
    jpeg = bitstream.parse(make_jpeg(80, 97, seed=97, subsampling=2))
    coeffs = _entropy_decode(jpeg, DecodeConfig(), DecodeStats(), "cpu")
    qtabs = [jpeg.qtables[c.tq].astype(np.int32) for c in jpeg.frame.components]
    planes = halo.shard_planes(jpeg.frame, coeffs, qtabs, _cpu(4))
    assert [[p.shape[1] for p in per_c] for per_c in planes] == [[48, 24, 24], [64, 32, 32], [49, 25, 25],
                                                                 [17, 9, 9]]
    whole = [idct.dequant_idct_islow_plain(torch.as_tensor(cf).reshape(1, -1, 64),
                                           torch.from_numpy(jpeg.qtables[c.tq].astype(np.int32)),
                                           c.padded_hb, c.padded_wb)
             for c, cf in zip(jpeg.frame.components, coeffs)]
    for (_a, _b, wa, _wb), per_c in zip(halo.shard_windows(jpeg.frame, 4), planes):
        for c, p, w in zip(jpeg.frame.components, per_c, whole):
            assert torch.equal(p, w[:, wa * c.v * 8 : wa * c.v * 8 + p.shape[1]])


def test_shard_spans_pad_as_the_reference():
    frame = bitstream.parse(make_jpeg(96, 144, seed=23, subsampling=2)).frame  # 9 MCU rows
    assert halo.shard_spans(frame, 8) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 9), (9, 9), (9, 9), (9, 9)]
    assert halo.shard_spans(frame, 1) == [(0, 9)]


# --- meshes


def test_meshes_raise_without_a_card_and_take_explicit_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (mesh_lib.rows_mesh, mesh_lib.data_mesh):
        with pytest.raises(RuntimeError):
            fn()
    assert mesh_lib.rows_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        mesh_lib.data_mesh([])
    data = make_jpeg(64, 48, seed=1, subsampling=2, restart_blocks=2)
    with pytest.raises(RuntimeError):
        halo.decode_sharded(data)
    with pytest.raises(RuntimeError):
        wf.decode_norst_sharded(bitstream.parse(make_jpeg(64, 48, seed=1)))
    with pytest.raises(RuntimeError):
        wf.decode_batch_to_rgb_sharded([bitstream.parse(data)])
    with pytest.raises(ValueError):
        halo.decode_sharded(data, n_shards=3, mesh=_cpu(2))
    with pytest.raises(ValueError, match="not both"):
        tpujpeg_torch.decode_batch([data], device="cpu", mesh=_cpu(2))


def test_init_distributed_is_a_no_op_for_one_process():
    mesh_lib.init_distributed()
    mesh_lib.init_distributed("localhost:1", 1, 0)
    assert not torch.distributed.is_initialized()


# --- data parallel: decode_batch_to_rgb_sharded and decode_batch(mesh=...)


def test_decode_batch_to_rgb_sharded_matches_pil():
    # tests/test_wavefront_pallas.py::test_sharded_fused_decode_over_mesh's batch.
    datas = [make_jpeg(64, 48, seed=s, subsampling=2, restart_blocks=2) for s in range(8)]
    rgbs, failures = wf.decode_batch_to_rgb_sharded([bitstream.parse(d) for d in datas], mesh=_cpu(8))
    assert not failures and len(rgbs) == 8 and all(r.shape == (1, 48, 64, 3) for r in rgbs)
    for d, rgb in zip(datas, rgbs):
        np.testing.assert_array_equal(rgb[0].numpy(), pil_decode(d))


def test_decode_batch_to_rgb_sharded_failures_index_the_whole_batch():
    datas = [make_jpeg(64, 48, seed=s, subsampling=2, restart_blocks=2) for s in range(4)]
    jpegs = [bitstream.parse(d) for d in datas]
    jpegs[3].scans[0].data = bytes([0xFF]) * len(jpegs[3].scans[0].data)
    rgbs, failures = wf.decode_batch_to_rgb_sharded(jpegs, mesh=_cpu(2))
    assert set(failures) == {3}
    np.testing.assert_array_equal(rgbs[1][0].numpy(), pil_decode(datas[2]))


def _refusals():
    """(name, datas, devices): inputs both packages refuse."""
    same = [make_jpeg(64, 48, seed=s, subsampling=2, restart_blocks=2) for s in range(3)]
    mixed = [make_jpeg(64, 48, seed=0, subsampling=2, restart_blocks=2),
             make_jpeg(64, 48, seed=1, subsampling=2, restart_blocks=4)]  # MCUs per lane differ
    qsets = [make_jpeg(64, 48, seed=s, subsampling=2, restart_blocks=2, quality=50 + 5 * s) for s in range(9)]
    return [("length", same, 2), ("structure", mixed, 2), ("quantizer sets", qsets, 1)]


@pytest.mark.parametrize("name,datas,d", _refusals(), ids=[r[0] for r in _refusals()])
def test_decode_batch_to_rgb_sharded_refuses_where_the_reference_does(name, datas, d):
    with pytest.raises(JpegUnsupportedError):
        wf.decode_batch_to_rgb_sharded([bitstream.parse(x) for x in datas], mesh=_cpu(d))
    ref_mesh = jax.make_mesh((d,), ("data",), devices=jax.devices()[:d])
    with pytest.raises(tpujpeg.JpegUnsupportedError):
        ref_wp.decode_batch_to_rgb_sharded([tpujpeg.bitstream.parse(x) for x in datas], mesh=ref_mesh)


@pytest.mark.parametrize("engine", ["auto", "torch"])
def test_decode_batch_over_a_mesh_matches_pil(engine):
    # tests/test_parallel.py::test_decode_batch_sharded_matches_pil's batch.
    datas = [make_jpeg(96, 64, seed=s, subsampling=2) for s in range(8)]
    res = tpujpeg_torch.decode_batch(datas, DecodeConfig(transform_engine=engine), mesh=_cpu(8))
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(img, pil_decode(d))


# --- tile_jpeg: the giant image from a small one


def test_tile_jpeg_decodes_as_pil_and_sharded():
    data = make_jpeg(64, 48, seed=1, subsampling=2, restart_blocks=2)
    tiled = tile_jpeg(data, 3, 2)
    ref = pil_decode(tiled)
    assert ref.shape == (96, 192, 3)
    frame = bitstream.parse(tiled).frame
    assert (frame.width, frame.height) == (192, 96)
    np.testing.assert_array_equal(halo.decode_sharded(tiled, mesh=_cpu(4)), ref)
    # Away from the seams' chroma, the tiles are the source's pixels.
    src = pil_decode(data)
    np.testing.assert_array_equal(ref[:40, 66:120], src[:40, 2:56])


@pytest.mark.parametrize("kw", [dict(subsampling=2, restart_blocks=2), dict(subsampling=0, restart_blocks=3),
                                dict(mode="L", restart_blocks=5), dict(subsampling=2, quality=100, restart_blocks=4)],
                         ids=["420", "444", "gray", "420_q100"])
def test_norst_jpeg_drops_the_restarts_and_keeps_the_coefficients(kw):
    data = make_jpeg(197, 131, seed=3, **kw)
    jpeg = bitstream.parse(data)
    coeffs = _entropy_decode(jpeg, DecodeConfig(), DecodeStats(), "cpu")
    out = norst_jpeg(data, coeffs)
    again = bitstream.parse(out)
    assert again.restart_interval == 0 and len(again.scans[0].rst_offsets) == 0
    for a, b in zip(coeffs, _entropy_decode(again, DecodeConfig(), DecodeStats(), "cpu")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(pil_decode(out), pil_decode(data))


def test_norst_jpeg_of_a_tiled_image_shards_its_entropy_decode(monkeypatch):
    """The marker-free tiled image through decode_sharded: kernel 2 per
    shard and the DC fixup (decode_norst_sharded), equal to PIL; a file
    without restarts re-encodes to its own bytes."""
    tiled = tile_jpeg(make_jpeg(64, 48, seed=1, subsampling=2, restart_blocks=2), 3, 2)
    out = norst_jpeg(tiled, _entropy_decode(bitstream.parse(tiled), DecodeConfig(), DecodeStats(), "cpu"))
    calls = []
    real = wf.decode_norst_sharded
    monkeypatch.setattr(wf, "decode_norst_sharded", lambda *a, **k: calls.append(1) or real(*a, **k))
    np.testing.assert_array_equal(halo.decode_sharded(out, mesh=_cpu(4)), pil_decode(tiled))
    assert calls == [1]
    plain = make_jpeg(64, 48, seed=1, subsampling=2)
    assert norst_jpeg(plain, _entropy_decode(bitstream.parse(plain), DecodeConfig(), DecodeStats(), "cpu")) == plain


def test_crop_jpeg_keeps_the_source_blocks_of_its_rectangle():
    """A crop of whole restart segments decodes to the source's blocks in
    its rectangle, and to the source's pixels away from its edges, where
    the chroma upsampler reads outside it."""
    data = make_jpeg(128, 64, seed=2, subsampling=2, restart_blocks=2)   # segments of 32 x 16 pixels
    src, out = bitstream.parse(data), bitstream.parse(crop_jpeg(data, 64, 32, x=32, y=16))
    assert (out.frame.width, out.frame.height) == (64, 32)
    got, want = (_entropy_decode(j, DecodeConfig(), DecodeStats(), "cpu") for j in (out, src))
    for c, sc_, a, b in zip(out.frame.components, src.frame.components, got, want):
        by, bx = 1 * c.v, 2 * c.h   # (16, 32) pixels in 16 x 16 MCUs
        np.testing.assert_array_equal(
            np.asarray(a).reshape(c.padded_hb, c.padded_wb, 64),
            np.asarray(b).reshape(sc_.padded_hb, sc_.padded_wb, 64)[by:by + c.padded_hb, bx:bx + c.padded_wb])
    np.testing.assert_array_equal(pil_decode(crop_jpeg(data, 64, 32, x=32, y=16))[2:-2, 2:-2],
                                  pil_decode(data)[18:46, 34:94])
    assert crop_jpeg(data, 128, 64) == data
    for kw in (dict(width=48, height=32), dict(width=64, height=24), dict(width=64, height=32, x=16),
               dict(width=64, height=32, x=96), dict(width=64, height=48, y=32)):
        with pytest.raises(ValueError, match="whole"):
            crop_jpeg(data, **kw)


def test_tile_jpeg_refusals():
    with pytest.raises(ValueError, match="restart interval"):
        tile_jpeg(make_jpeg(64, 48, seed=1, subsampling=2, restart_blocks=3), 2, 2)
    with pytest.raises(ValueError, match="restart interval"):
        tile_jpeg(make_jpeg(64, 48, seed=1, subsampling=2), 2, 2)
    with pytest.raises(ValueError, match="baseline"):
        tile_jpeg(make_jpeg(64, 48, seed=1, subsampling=2, progressive=True, restart_blocks=2), 2, 2)
    with pytest.raises(ValueError, match="whole"):
        tile_jpeg(make_jpeg(60, 48, seed=1, subsampling=2, restart_blocks=2), 2, 2)
