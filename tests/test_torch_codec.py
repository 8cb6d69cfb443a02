"""The port's codec helpers (``repro_torch.codec.{transform, quant,
bitstream, psnr}``) against the JAX reference's, on the same numpy-seeded
inputs.

Block reshapes, dequantization and the PSNR copy agree exactly; the 8x8
transforms within ``atol=1e-3, rtol=1e-5`` on pixel-scale data (the two
packages sum the products in different orders); ``quantize`` on more than
99.9 % of the coefficients (a quotient within float error of .5 may round
the other way); the size model within ``rtol=1e-5`` of the numpy size of
record ``stream_bytes_np`` (float32 sums in another order)."""
import numpy as np
import pytest
import torch

from repro.codec import bitstream as jax_bitstream
from repro.codec import quant as jax_quant
from repro.codec import transform as jax_transform
from repro.codec.encode import EncoderConfig as JaxEncoderConfig
from repro.codec.encode import encode_tile as jax_encode_tile
from repro.codec.psnr import psnr as jax_psnr
from repro_torch.codec import (dct2_blocks, from_blocks, idct2_blocks, psnr,
                               to_blocks)
from repro_torch.codec.bitstream import block_bits, stream_bytes
from repro_torch.codec.quant import dequantize, quantize

ATOL, RTOL = 1e-3, 1e-5


def _frames(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255
            ).astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 8), (16, 24), (3, 40, 64)])
def test_to_and_from_blocks_match_reference(shape):
    x = _frames(1, shape)
    got = to_blocks(torch.from_numpy(x))
    want = np.asarray(jax_transform.to_blocks(x))
    assert np.array_equal(got.numpy(), want)
    back = from_blocks(got, *shape[-2:])
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(
        back.numpy(), np.asarray(jax_transform.from_blocks(want,
                                                           *shape[-2:])))


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_dct2_and_idct2_blocks_match_reference(lead):
    x = _frames(2, lead + (8, 8))
    c = dct2_blocks(torch.from_numpy(x))
    want = np.asarray(jax_transform.dct2_blocks(x))
    assert c.dtype == torch.float32
    np.testing.assert_allclose(c.numpy(), want, atol=ATOL, rtol=RTOL)
    y = idct2_blocks(c)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jax_transform.idct2_blocks(want)),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y.numpy(), x, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("qp,intra", [(1, True), (8, False), (16, True)])
def test_quantize_and_dequantize_match_reference(qp, intra):
    coeffs = np.array(jax_transform.dct2_blocks(_frames(qp, (200, 8, 8))))
    q = quantize(torch.from_numpy(coeffs), qp, intra)
    want = np.array(jax_quant.quantize(coeffs, qp, intra))
    assert q.dtype == torch.int16
    assert (q.numpy() == want).mean() > 0.999
    assert np.abs(q.numpy().astype(np.int32) - want).max() <= 1
    dq = dequantize(torch.from_numpy(want), qp, intra)
    assert dq.dtype == torch.float32
    assert np.array_equal(dq.numpy(),
                          np.asarray(jax_quant.dequantize(want, qp, intra)))


def test_quantize_rounds_half_to_even():
    m = jax_quant.quant_matrix(16, True)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], dtype=np.float32)
    coeffs = np.zeros((6, 8, 8), dtype=np.float32)
    coeffs[:, 0, 0] = halves * m[0, 0]
    got = quantize(torch.from_numpy(coeffs), 16, True)[:, 0, 0]
    assert got.tolist() == [0, 2, 2, 0, -2, -2]
    assert got.tolist() == np.round(halves).astype(int).tolist()


@pytest.mark.parametrize("gop", [1, 4, 16])
def test_block_bits_and_stream_bytes_match_reference(gop):
    frames = _frames(gop, (gop * 2, 32, 48))
    enc = jax_encode_tile(frames, JaxEncoderConfig(gop=gop, qp=8))
    for q in (enc["kq"], enc["pq"]):
        bits = block_bits(torch.from_numpy(q))
        want = np.asarray(jax_bitstream.block_bits(q))
        assert tuple(bits.shape) == want.shape
        np.testing.assert_allclose(bits.numpy(), want, rtol=RTOL)
        size = stream_bytes(torch.from_numpy(q))
        np.testing.assert_allclose(size, jax_bitstream.stream_bytes_np(q),
                                   rtol=RTOL)
        np.testing.assert_allclose(size, jax_bitstream.stream_bytes(q),
                                   rtol=RTOL)


def test_psnr_copy_matches_reference():
    ref = _frames(4, (4, 16, 16))
    for test in (ref, ref + 1.0, _frames(5, (4, 16, 16))):
        assert psnr(ref, test) == jax_psnr(ref, test)
    assert psnr(ref, ref) == 99.0
