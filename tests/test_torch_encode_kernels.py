"""The port's encode-side kernels (``repro_torch.kernels.dct`` and
``repro_torch.kernels.idct``) against the JAX reference's: the plain
PyTorch versions (the CPU path of ``dct_quant_op`` / ``idct_dequant_op``)
against the Pallas kernels run in interpret mode and against the jnp
references, on the sweeps of ``tests/test_kernels.py``.  Inputs are made
with numpy from a seed and handed to both packages.

Tolerances: ``dct_quant`` outputs agree on more than 99.9 % of the int16
coefficients (a quotient within float error of .5 may round the other
way when the two packages sum the 8x8 products in different orders);
``idct_dequant`` within ``atol=1e-3, rtol=1e-5`` on pixel-scale output.
The reference's sweep dequantizes coefficients of up to +-300 into
outputs of up to ~3e4, where one float32 ulp is ~2e-3: there the absolute
tolerance grows to 8 ulps of the largest output, and the port must stay as
close to the float64 result as the reference is."""
import numpy as np
import pytest
import torch

from repro.codec.encode import EncoderConfig as JaxEncoderConfig
from repro.codec.encode import encode_tile as jax_encode_tile
from repro.codec.quant import quant_matrix as jax_quant_matrix
from repro.codec.transform import dct_matrix as jax_dct_matrix
from repro.kernels.dct.ops import dct_quant_op as jax_dct_quant_op
from repro.kernels.dct.ref import dct_quant_ref as jax_dct_quant_ref
from repro.kernels.idct.ops import idct_dequant_op as jax_idct_dequant_op
from repro.kernels.idct.ref import idct_dequant_ref as jax_idct_dequant_ref
from repro_torch.kernels.dct import LAUNCHES as DCT_LAUNCHES
from repro_torch.kernels.dct import dct_quant, dct_quant_op, dct_quant_ref
from repro_torch.kernels.idct import LAUNCHES as IDCT_LAUNCHES
from repro_torch.kernels.idct import (idct_dequant, idct_dequant_op,
                                      idct_dequant_ref)

ATOL, RTOL = 1e-3, 1e-5
SHARE = 0.999
#: the largest |coefficient| a block of [0, 255] pixels (or of residuals in
#: [-255, 255]) can reach under the finest quant step (1): 64 * 255 / 8
INT16_REACH = 2040


@pytest.mark.parametrize("n", [8, 64, 100, 500])
@pytest.mark.parametrize("qp,intra", [(4, True), (8, False), (16, True)])
def test_dct_quant_matches_pallas_interpret_and_jnp_ref(n, qp, intra):
    x = (np.random.default_rng(n).standard_normal((n, 8, 8)) * 60
         ).astype(np.float32)
    got = dct_quant_op(torch.from_numpy(x), qp=qp, intra=intra)
    assert got.dtype == torch.int16 and tuple(got.shape) == x.shape
    got = got.numpy()
    pallas = np.asarray(jax_dct_quant_op(x, qp=qp, intra=intra,
                                         interpret=True))
    ref = np.asarray(jax_dct_quant_ref(x, qp, intra))
    assert (got == pallas).mean() > SHARE
    assert (got == ref).mean() > SHARE
    assert np.abs(got.astype(np.int32) - ref).max() <= 1


@pytest.mark.parametrize("n", [8, 77, 256])
@pytest.mark.parametrize("qp,intra", [(8, True), (12, False)])
def test_idct_dequant_matches_pallas_interpret_and_jnp_ref(n, qp, intra):
    q = np.random.default_rng(n).integers(-300, 300, size=(n, 8, 8)
                                          ).astype(np.int16)
    got = idct_dequant_op(torch.from_numpy(q), qp=qp, intra=intra)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    got = got.numpy()
    pallas = np.asarray(jax_idct_dequant_op(q, qp=qp, intra=intra,
                                            interpret=True))
    ref = np.asarray(jax_idct_dequant_ref(q, qp, intra))
    atol = max(ATOL, 8 * np.finfo(np.float32).eps * np.abs(ref).max())
    np.testing.assert_allclose(got, pallas, atol=atol, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=RTOL)
    d = jax_dct_matrix().astype(np.float64)
    exact = np.einsum("ji,njk,kl->nil", d,
                      q * jax_quant_matrix(qp, intra).astype(np.float64), d)
    assert np.abs(got - exact).max() <= 2 * np.abs(ref - exact).max()


@pytest.mark.parametrize("gop,qp", [(1, 4), (4, 8), (8, 16)])
def test_idct_dequant_pixel_scale_matches_jnp_ref(gop, qp):
    # coefficients of real encodes: keyframes and residuals of pixels
    frames = (np.random.default_rng(gop).random((gop, 32, 48)) * 255
              ).astype(np.float32)
    enc = jax_encode_tile(frames, JaxEncoderConfig(gop=gop, qp=qp))
    for q, intra in [(enc["kq"][0], True),
                     (enc["pq"][0].reshape(-1, 8, 8), False)]:
        if not len(q):
            continue
        got = idct_dequant_op(torch.from_numpy(q), qp=qp, intra=intra)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jax_idct_dequant_ref(q, qp, intra)),
            atol=ATOL, rtol=RTOL)


def test_dct_idct_roundtrip_matches_reference():
    x = (np.random.default_rng(0).standard_normal((64, 8, 8)) * 50
         ).astype(np.float32)
    q = dct_quant_op(torch.from_numpy(x), qp=2, intra=True)
    y = idct_dequant_op(q, qp=2, intra=True).numpy()
    # random gaussian blocks are worst-case for transform coding: bound the
    # mean error by half the largest quant step at qp=2
    assert float(np.abs(y - x).mean()) < 4.0
    jq = jax_dct_quant_op(x, qp=2, intra=True, interpret=True)
    jy = np.asarray(jax_idct_dequant_op(jq, qp=2, intra=True,
                                        interpret=True))
    assert (q.numpy() == np.asarray(jq)).mean() > SHARE
    assert float(np.abs(y - jy).mean()) < 1e-2


@pytest.mark.parametrize("op,make", [
    ("dct", lambda rng, n: (rng.random((n, 8, 8)) * 255).astype(np.float32)),
    ("idct", lambda rng, n: rng.integers(-300, 300, (n, 8, 8)
                                         ).astype(np.int16)),
])
def test_block_result_independent_of_batch(op, make):
    # the encoder batches every tile of a SOT into one stream: a block
    # must come out the same wherever it sits in whatever batch
    fn = ((lambda t: dct_quant_op(t, qp=8, intra=False)) if op == "dct"
          else (lambda t: idct_dequant_op(t, qp=8, intra=False)))
    x = torch.from_numpy(make(np.random.default_rng(7), 333))
    whole = fn(x)
    for lo, hi in [(0, 1), (5, 6), (17, 180), (300, 333)]:
        assert torch.equal(fn(x[lo:hi].contiguous()), whole[lo:hi])


@pytest.mark.parametrize("qp", [1, 8])
def test_plain_dct_quant_stays_in_int16_range(qp):
    # the extremes of keyframes ([0, 255] pixels) and residuals
    # ([-255, 255]): flat, checkerboard and stripes
    flat = np.full((8, 8), 255.0)
    checker = (np.indices((8, 8)).sum(0) % 2) * 255.0
    stripes = np.tile((np.arange(8) % 2) * 255.0, (8, 1))
    blocks = np.stack([flat, checker, stripes, flat - 255.0,
                       checker * 2 - 255.0, 255.0 - stripes * 2, -flat]
                      ).astype(np.float32)
    for intra in (True, False):
        q = dct_quant_ref(torch.from_numpy(blocks), qp, intra)
        want = np.asarray(jax_dct_quant_ref(blocks, qp, intra))
        # exact .5 ties (a stripe's DC at qp=8) may round either way
        assert np.abs(q.numpy().astype(np.int32) - want).max() <= 1
        reach = int(q.abs().max())
        assert reach <= INT16_REACH
        if qp == 1 and intra:
            assert reach == INT16_REACH   # the flat block's DC
    # beyond the pixel scale the plain version saturates, as the kernel does
    big = torch.full((1, 8, 8), 1e7)
    assert int(dct_quant_ref(big, 1, True)[0, 0, 0]) == 32767
    assert int(dct_quant_ref(-big, 1, True)[0, 0, 0]) == -32768


def test_ops_dispatch_cpu_to_plain_version_without_launching():
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.random((9, 8, 8)) * 255).astype(np.float32))
    before = DCT_LAUNCHES.count, IDCT_LAUNCHES.count
    q = dct_quant_op(x, qp=8, intra=True)
    assert torch.equal(q, dct_quant_ref(x, 8, True))
    y = idct_dequant_op(q, qp=8, intra=True)
    assert torch.equal(y, idct_dequant_ref(q, 8, True))
    assert (DCT_LAUNCHES.count, IDCT_LAUNCHES.count) == before


def test_kernel_wrappers_reject_cpu_tensors_without_launching():
    before = DCT_LAUNCHES.count, IDCT_LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA tensor"):
        dct_quant(torch.zeros((4, 8, 8)), 8, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        idct_dequant(torch.zeros((4, 8, 8), dtype=torch.int16), 8, True)
    assert (DCT_LAUNCHES.count, IDCT_LAUNCHES.count) == before
