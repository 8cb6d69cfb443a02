"""The port's batched tile decode (``repro_torch.codec.batch``) against the
JAX reference's ``decode_tile_batch`` and against the numpy oracle
``decode_tile``, on the CPU.  Tiles are encoded once with numpy from a seed
and handed to both packages.  Tolerance ``atol=1e-3, rtol=1e-5`` against
either; shapes, dtypes and the zeroed blocks outside an ROI are exact."""
import numpy as np
import pytest

from repro.codec.batch import decode_tile_batch as jax_decode_tile_batch
from repro.codec.encode import decode_tile as jax_decode_tile
from repro.codec.encode import encode_tile as jax_encode_tile
from repro_torch.codec.batch import decode_tile_batch
from repro_torch.codec.encode import EncoderConfig, decode_tile, encode_tile

ATOL, RTOL = 1e-3, 1e-5


def _rand_enc(rng, h, w, gop, qp, n_gops):
    frames = (rng.random((n_gops * gop, h, w), dtype=np.float32) * 255.0)
    return encode_tile(frames, EncoderConfig(gop=gop, qp=qp))


def _random_items(seed, n_items):
    """Random tiles, GOP subsets, tail depths and ROI masks, as in the
    reference's property test of ``decode_tile_batch``."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n_items):
        bh, bw = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        n_gops = int(rng.integers(1, 4))
        gop = int(rng.choice([4, 8]))
        qp = int(rng.choice([4, 8, 12]))
        enc = _rand_enc(rng, bh * 8, bw * 8, gop, qp, n_gops)
        gsel = sorted(rng.choice(n_gops, size=rng.integers(1, n_gops + 1),
                                 replace=False).tolist())
        fw = None if rng.random() < 0.5 else int(rng.integers(1, gop + 1))
        nb = bh * bw
        roll = rng.random()
        if roll < 0.4:
            blocks = None
        elif roll < 0.5:
            blocks = tuple(range(nb))
        else:
            k = int(rng.integers(1, nb + 1))
            blocks = tuple(sorted(
                rng.choice(nb, size=k, replace=False).tolist()))
        items.append((enc, gsel, fw, blocks))
    return items


def _zero_outside_roi(arr, enc, blocks):
    if blocks is None:
        return
    h, w = enc["h"], enc["w"]
    keep = np.zeros((h // 8) * (w // 8), dtype=bool)
    keep[list(blocks)] = True
    view = arr.reshape(-1, h // 8, 8, w // 8, 8)
    rs, cs = np.divmod(np.flatnonzero(~keep), w // 8)
    assert not view[:, rs, :, cs].any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_matches_reference_batch_and_oracle(seed):
    items = _random_items(seed, 6)
    got = decode_tile_batch(items, device="cpu")
    ref = jax_decode_tile_batch(items)
    for (enc, gsel, fw, blocks), arr, r in zip(items, got, ref):
        want = decode_tile(enc, gop_indices=gsel, frames_within=fw,
                           blocks=blocks)
        assert arr.dtype == want.dtype == np.float32
        assert arr.shape == want.shape == r.shape
        np.testing.assert_allclose(arr, want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(arr, r, atol=ATOL, rtol=RTOL)
        _zero_outside_roi(arr, enc, blocks)


def test_item_decodes_bit_identically_alone_or_batched():
    items = _random_items(11, 6)
    together = decode_tile_batch(items, device="cpu")
    for item, arr in zip(items, together):
        alone, = decode_tile_batch([item], device="cpu")
        np.testing.assert_array_equal(alone, arr)


def test_degenerate_items():
    rng = np.random.default_rng(3)
    enc = _rand_enc(rng, 16, 16, 4, 8, 2)
    items = [
        (enc, [], None, None),          # no GOPs selected
        (enc, [0], None, ()),           # empty ROI mask
        (enc, [0, 1], 1, None),         # single-frame prefix
    ]
    got = decode_tile_batch(items, device="cpu")
    ref = jax_decode_tile_batch(items)
    assert got[0].shape == ref[0].shape == (0, 16, 16)
    np.testing.assert_array_equal(
        got[1], decode_tile(enc, gop_indices=[0], blocks=()))
    assert got[1].shape == (4, 16, 16) and not got[1].any()
    np.testing.assert_allclose(
        got[2], decode_tile(enc, gop_indices=[0, 1], frames_within=1),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[2], ref[2], atol=ATOL, rtol=RTOL)


def test_numpy_codec_copy_is_bit_identical_to_reference():
    # the port's encoder and oracle are copies of the reference's numpy
    # codec: same streams, same pixels, same size model
    rng = np.random.default_rng(4)
    frames = (rng.random((8, 16, 24), dtype=np.float32) * 255.0)
    cfg = EncoderConfig(gop=4, qp=8)
    enc = encode_tile(frames, cfg)
    ref = jax_encode_tile(frames, cfg)
    np.testing.assert_array_equal(enc["kq"], ref["kq"])
    np.testing.assert_array_equal(enc["pq"], ref["pq"])
    assert enc["size_bytes"] == ref["size_bytes"]
    np.testing.assert_array_equal(decode_tile(enc, blocks=(1, 4)),
                                  jax_decode_tile(ref, blocks=(1, 4)))
