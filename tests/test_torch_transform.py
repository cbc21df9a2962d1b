"""tpujpeg_torch.transform against tpujpeg.transform on seeded numpy
inputs. Tolerance 0: all of it is integer arithmetic."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpujpeg import bitstream as ref_bitstream
from tpujpeg import transform as R

from tpujpeg_torch import transform as T
from tpujpeg_torch import bitstream as port_bitstream


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _coeffs(rng, n, hi):
    return rng.integers(-hi, hi + 1, size=(n, 64)).astype(np.int32)


@pytest.mark.parametrize("n", [1, 12])
def test_descale_and_idct_1d(n):
    rng = np.random.default_rng(100 + n)
    s = [rng.integers(-(1 << 20), 1 << 20, size=(n, 8)).astype(np.int32) for _ in range(8)]
    for bits in (11, 18):
        want = R._idct_1d([jnp.asarray(x) for x in s], bits)
        got = T._idct_1d([torch.from_numpy(x) for x in s], bits)
        for g, w in zip(got, want):
            _same(g, w)
        _same(T._descale(torch.from_numpy(s[0]), bits), R._descale(jnp.asarray(s[0]), bits))


@pytest.mark.parametrize("qmax", [255, 65535], ids=["q8", "q16"])
def test_dequantize(qmax):
    rng = np.random.default_rng(qmax)
    c = _coeffs(rng, 40, 2047)
    q = rng.integers(1, qmax + 1, size=64).astype(np.int32)
    _same(T.dequantize(torch.from_numpy(c), torch.from_numpy(q)),
          R.dequantize(jnp.asarray(c), jnp.asarray(q)))


@pytest.mark.parametrize("qmax,hi", [(255, 1023), (65535, 32767)], ids=["q8", "q16-wrap"])
def test_idct8x8_islow(qmax, hi):
    """16-bit quantizers on large coefficients overflow int32: both sides
    must wrap the same way."""
    rng = np.random.default_rng(hi)
    c = _coeffs(rng, 64, hi)
    q = rng.integers(1, qmax + 1, size=64).astype(np.int32)
    deq_ref = R.dequantize(jnp.asarray(c), jnp.asarray(q))
    deq = T.dequantize(torch.from_numpy(c), torch.from_numpy(q))
    _same(T.idct8x8_islow(deq), R.idct8x8_islow(deq_ref))


def test_blocks_to_plane():
    rng = np.random.default_rng(5)
    s = rng.integers(0, 256, size=(3 * 5, 8, 8)).astype(np.uint8)
    _same(T.blocks_to_plane(torch.from_numpy(s), 3, 5), R.blocks_to_plane(jnp.asarray(s), 3, 5))


PLANE_SHAPES = [(1, 1), (7, 9), (8, 8), (13, 6), (16, 17)]


@pytest.mark.parametrize("shape", PLANE_SHAPES, ids=[f"{h}x{w}" for h, w in PLANE_SHAPES])
@pytest.mark.parametrize("fn", ["upsample_h2v1_fancy", "upsample_h2v2_fancy", "upsample_h1v2_fancy"])
def test_fancy_upsamplers(fn, shape):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    p = rng.integers(0, 256, size=shape).astype(np.uint8)
    _same(getattr(T, fn)(torch.from_numpy(p)), getattr(R, fn)(jnp.asarray(p)))


@pytest.mark.parametrize("he,ve", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (3, 2)])
@pytest.mark.parametrize("fancy", [True, False])
def test_upsample_component(he, ve, fancy):
    rng = np.random.default_rng(he * 10 + ve)
    p = rng.integers(0, 256, size=(9, 11)).astype(np.uint8)
    _same(T.upsample_component(torch.from_numpy(p), he, ve, fancy=fancy),
          R.upsample_component(jnp.asarray(p), he, ve, fancy=fancy))


def test_upsample_int():
    rng = np.random.default_rng(6)
    p = rng.integers(0, 256, size=(5, 7)).astype(np.uint8)
    _same(T.upsample_int(torch.from_numpy(p), 3, 2), R.upsample_int(jnp.asarray(p), 3, 2))


def test_ycc_to_rgb():
    rng = np.random.default_rng(7)
    y, cb, cr = (rng.integers(0, 256, size=(17, 23)).astype(np.uint8) for _ in range(3))
    _same(T.ycc_to_rgb(*map(torch.from_numpy, (y, cb, cr))),
          R.ycc_to_rgb(*map(jnp.asarray, (y, cb, cr))))


@pytest.mark.parametrize("color,n", [("gray", 1), ("ycbcr", 3), ("rgb", 3), ("cmyk", 4), ("ycck", 4)])
def test_finish_color(color, n):
    rng = np.random.default_rng(n + len(color))
    planes = [rng.integers(0, 256, size=(6, 9)).astype(np.uint8) for _ in range(n)]
    _same(T.finish_color([torch.from_numpy(p) for p in planes], color),
          R.finish_color([jnp.asarray(p) for p in planes], color))


def _frame(mod, h, w, hv):
    f = mod.Frame(
        progressive=False, precision=8, height=h, width=w,
        components=[mod.Component(index=i, cid=i + 1, h=a, v=b, tq=0) for i, (a, b) in enumerate(hv)],
    )
    f.finalize()
    return f


FRAMES = [
    (29, 37, ((2, 2), (1, 1), (1, 1)), None),
    (24, 17, ((2, 1), (1, 1), (1, 1)), None),
    (16, 16, ((1, 1), (1, 1), (1, 1)), "rgb"),
    (21, 19, ((1, 2), (1, 1), (1, 1)), None),
    (13, 15, ((1, 1),), None),
    (16, 24, ((1, 1), (1, 1), (1, 1), (1, 1)), "ycck"),
]


@pytest.mark.parametrize("h,w,hv,color", FRAMES, ids=[str(i) for i in range(len(FRAMES))])
@pytest.mark.parametrize("fancy", [True, False])
def test_transform_frame(h, w, hv, color, fancy):
    rng = np.random.default_rng(h * w)
    rf, pf = _frame(ref_bitstream, h, w, hv), _frame(port_bitstream, h, w, hv)
    coeffs = [_coeffs(rng, c.padded_hb * c.padded_wb, 60) for c in rf.components]
    qtabs = [rng.integers(1, 100, size=64).astype(np.int32) for _ in rf.components]
    want = R.transform_frame(rf, [jnp.asarray(c) for c in coeffs], [jnp.asarray(q) for q in qtabs],
                             fancy_upsampling=fancy, color=color)
    got = T.transform_frame(pf, [torch.from_numpy(c) for c in coeffs],
                            [torch.from_numpy(q) for q in qtabs], fancy_upsampling=fancy, color=color)
    _same(got, want)
