"""Kernel 6's module (tpujpeg_torch.kernels.idct) against the reference:
the plain version of dequant + islow IDCT against the Pallas kernel in
interpret mode and against the jnp transform, tolerance 0, including
coefficients that wrap int32; and the float matmul variant against the
reference's, within the tolerance stated there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpujpeg import bitstream as ref_bitstream
from tpujpeg import transform as ref_T
from tpujpeg.kernels import idct as ref_idct

from tpujpeg_torch.kernels import build, idct

HB, WB = 32, 32  # one reference lane tile: 1024 blocks


def _coeffs(seed, n=HB * WB):
    """Sparse realistic blocks, with every 7th block drawn from the whole
    int32 range so that dequant and both passes wrap."""
    r = np.random.default_rng(seed)
    c = r.integers(-1024, 1024, size=(n, 64)).astype(np.int32)
    c[r.random((n, 64)) < 0.7] = 0
    c[::7] = r.integers(-(2**31), 2**31, size=(len(c[::7]), 64), dtype=np.int64).astype(np.int32)
    c[3, :4] = [2**31 - 1, -(2**31), 2**31 - 1, -(2**31)]
    q = r.integers(1, 256, size=(64,)).astype(np.int32)
    return c, q


def _plane(blocks, hb, wb):
    """[hb*wb, 8, 8] -> [hb*8, wb*8] raster (numpy)."""
    return blocks.reshape(hb, wb, 8, 8).transpose(0, 2, 1, 3).reshape(hb * 8, wb * 8)


@pytest.fixture(scope="module")
def batch():
    c, q = _coeffs(77)
    want = np.asarray(ref_idct.dequant_idct_islow(jnp.asarray(c), jnp.asarray(q), interpret=True))
    return c, q, want


def test_plain_matches_pallas_kernel_interpret(batch):
    c, q, want = batch
    got = idct.dequant_idct_islow_plain(torch.from_numpy(c)[None], torch.from_numpy(q), HB, WB)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1, HB * 8, WB * 8)
    np.testing.assert_array_equal(got[0].numpy(), _plane(want, HB, WB))


def test_wrapper_on_cpu_is_the_plain_version(batch):
    c, q, want = batch
    got = idct.dequant_idct_islow(torch.from_numpy(c)[None], torch.from_numpy(q), HB, WB)
    np.testing.assert_array_equal(got[0].numpy(), _plane(want, HB, WB))


def test_plain_matches_jnp_transform(batch):
    c, q, _ = batch
    want = np.asarray(ref_T.idct8x8_islow(ref_T.dequantize(jnp.asarray(c), jnp.asarray(q))))
    got = idct.dequant_idct_islow_plain(torch.from_numpy(c)[None], torch.from_numpy(q), HB, WB)
    np.testing.assert_array_equal(got[0].numpy(), _plane(want, HB, WB))


def test_per_image_quantizers_and_dc_column():
    """[N, 64] quantizers and a DC column equal the one-table transform of
    each image with its DC merged into slot 0 (jnp reference)."""
    r = np.random.default_rng(5)
    hb, wb, n = 3, 5, 4
    c = np.stack([_coeffs(s, hb * wb)[0] for s in range(n)])
    q = r.integers(1, 256, size=(n, 64)).astype(np.int32)
    dc = r.integers(-(2**31), 2**31, size=(n, hb * wb), dtype=np.int64).astype(np.int32)
    for with_dc in (False, True):
        got = idct.dequant_idct_islow(torch.from_numpy(c), torch.from_numpy(q), hb, wb,
                                      torch.from_numpy(dc) if with_dc else None).numpy()
        for i in range(n):
            ci = c[i].copy()
            if with_dc:
                ci[:, 0] = dc[i]
            want = ref_T.idct8x8_islow(ref_T.dequantize(jnp.asarray(ci), jnp.asarray(q[i])))
            np.testing.assert_array_equal(got[i], _plane(np.asarray(want), hb, wb), err_msg=f"image {i}")


def test_wrapper_rejects_bad_shapes():
    c = torch.zeros((1, 6, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        idct.dequant_idct_islow(c, torch.ones(64, dtype=torch.int32), 2, 2)
    with pytest.raises(ValueError):
        idct.dequant_idct_islow(c, torch.ones(63, dtype=torch.int32), 2, 3)
    with pytest.raises(ValueError):
        idct.dequant_idct_islow(c.to(torch.int64), torch.ones(64, dtype=torch.int32), 2, 3)
    with pytest.raises(ValueError):
        idct.dequant_idct_islow(c, torch.ones(64, dtype=torch.int32), 2, 3, torch.zeros((1, 5), dtype=torch.int32))


def test_alignment_guard():
    """The CUDA branch reads coefficients as int4 words: a view that does
    not start on a 16-byte boundary is refused before any launch."""
    flat = torch.zeros(1 + 6 * 64, dtype=torch.int32)
    build.check_aligned("t", [flat[:64]])
    with pytest.raises(ValueError, match="16-byte"):
        build.check_aligned("t", [flat[1:].view(1, 6, 64)])


def test_matmul_variant_close_to_reference():
    """idct='matmul': both sides are float32 products over the same 64x64
    basis, summed in another order, so a sample may round the other way.
    Tolerance: |diff| <= 1 per sample, and at least 99.9% of samples
    equal. Inputs are forward-DCT'd pixel blocks, as in the reference's
    own conformance test, so magnitudes stay in the JPEG sample domain."""
    r = np.random.default_rng(78)
    pix = r.integers(0, 256, size=(2000, 8, 8)).astype(np.float64) - 128
    cb = np.zeros((8, 8))
    for u in range(8):
        a = np.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            cb[u, x] = a * np.cos((2 * x + 1) * u * np.pi / 16.0)
    freq = np.einsum("ux,vy,nxy->nuv", cb, cb, pix)
    q = r.integers(1, 64, size=(64,)).astype(np.int32)
    qnat = q[np.asarray(ref_bitstream.NATURAL_TO_ZIGZAG)].reshape(8, 8)
    coeffs = np.round(freq / qnat).astype(np.int32).reshape(-1, 64)[:, np.asarray(ref_bitstream.ZIGZAG)]
    want = np.asarray(ref_idct.dequant_idct_matmul(jnp.asarray(coeffs), jnp.asarray(q))).astype(np.int32)
    got = idct.dequant_idct_matmul(torch.from_numpy(coeffs), torch.from_numpy(q)).numpy().astype(np.int32)
    assert got.shape == want.shape == (2000, 8, 8)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
