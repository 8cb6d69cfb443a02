"""The port's motion search (``repro_torch.kernels.sad``) against the JAX
reference's: the plain PyTorch version (the CPU path of ``sad_search_op``)
against the Pallas kernel run in interpret mode and against the jnp
reference, on the sweep and the planted-motion case of
``tests/test_kernels.py``.  Inputs are made with numpy from a seed and
handed to both packages.

Tolerances: ``sad`` within rtol 1e-5 on float input (the packages sum the
B x B differences in different orders), ``dy``/``dx`` exact.  On
integer-valued pixels every sum is exact in f32, so all three outputs are
equal, ties included: the first candidate in row-major ``(dy, dx)`` order
wins."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sad.ops import frame_motion_blocks as jax_frame_motion_blocks
from repro.kernels.sad.ops import sad_search_op as jax_sad_search_op
from repro.kernels.sad.ref import sad_search_ref as jax_sad_search_ref
from repro_torch.kernels import sad as port_sad
from repro_torch.kernels.sad import (frame_motion_blocks, sad_search,
                                     sad_search_op, sad_search_ref)

RTOL = 1e-5


def _inputs(seed, n, b, r, integer=False):
    rng = np.random.default_rng(seed)
    w = b + 2 * r
    if integer:
        # a narrow pixel range makes equal SADs (ties) common
        return (rng.integers(0, 4, (n, b, b)).astype(np.float32),
                rng.integers(0, 4, (n, w, w)).astype(np.float32))
    return ((rng.standard_normal((n, b, b)) * 25).astype(np.float32),
            (rng.standard_normal((n, w, w)) * 25).astype(np.float32))


def _reference(cur, win):
    """(Pallas interpret, jnp reference) outputs as numpy triples."""
    pallas = jax_sad_search_op(jnp.asarray(cur), jnp.asarray(win),
                               interpret=True)
    plain = jax_sad_search_ref(jnp.asarray(cur), jnp.asarray(win))
    return ([np.asarray(x) for x in pallas], [np.asarray(x) for x in plain])


def _port(cur, win):
    dy, dx, sad = sad_search_op(torch.from_numpy(cur), torch.from_numpy(win))
    assert (dy.dtype, dx.dtype, sad.dtype) == (torch.int32, torch.int32,
                                               torch.float32)
    assert dy.shape == dx.shape == sad.shape == (cur.shape[0],)
    return dy.numpy(), dx.numpy(), sad.numpy()


@pytest.mark.parametrize("n", [1, 32, 100])
@pytest.mark.parametrize("b,r", [(8, 4), (16, 8)])
def test_sweep_matches_pallas_and_jnp(b, r, n):
    cur, win = _inputs(b * 1000 + r * 10 + n, n, b, r)
    dy, dx, sad = _port(cur, win)
    for want in _reference(cur, win):
        np.testing.assert_allclose(sad, want[2], rtol=RTOL)
        np.testing.assert_array_equal(dy, want[0])
        np.testing.assert_array_equal(dx, want[1])


@pytest.mark.parametrize("b,r,n", [(8, 4, 64), (16, 8, 9), (4, 0, 5),
                                   (8, 8, 33)])
def test_integer_pixels_exact_with_ties(b, r, n):
    cur, win = _inputs(7 + b + r + n, n, b, r, integer=True)
    # block 0 against a constant window: every candidate ties -> (0, 0)
    win[0] = 3.0
    dy, dx, sad = _port(cur, win)
    assert (dy[0], dx[0]) == (0, 0)
    assert sad[0] == np.abs(cur[0] - 3.0).sum()
    for want in _reference(cur, win):
        np.testing.assert_array_equal(sad, want[2])
        np.testing.assert_array_equal(dy, want[0])
        np.testing.assert_array_equal(dx, want[1])


def test_finds_planted_motion():
    """The planted shift of the reference's test, recovered by the port."""
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 255, (64, 64)).astype(np.float32)
    cur = np.roll(ref, shift=(3, -2), axis=(0, 1))
    blocks, windows = frame_motion_blocks(cur, ref, b=16, r=8)
    dy, dx, sad = _port(blocks, windows)
    # cur[y, x] == ref[y-3, x+2]  =>  best match at displacement (r-3, r+2)
    inner = [5, 6, 9, 10]
    assert all(int(dy[i]) == 8 - 3 for i in inner)
    assert all(int(dx[i]) == 8 + 2 for i in inner)
    assert all(float(sad[i]) == 0.0 for i in inner)
    pallas, _ = _reference(blocks, windows)
    np.testing.assert_array_equal(dy, pallas[0])
    np.testing.assert_array_equal(dx, pallas[1])


@pytest.mark.parametrize("h,w,b,r", [(64, 64, 16, 8), (1080, 1920, 8, 8)])
def test_frame_motion_blocks_equal_reference(h, w, b, r):
    rng = np.random.default_rng(h)
    cur = rng.uniform(0, 255, (h, w)).astype(np.float32)
    ref = rng.uniform(0, 255, (h, w)).astype(np.float32)
    blocks, windows = frame_motion_blocks(cur, ref, b=b, r=r)
    want_blocks, want_windows = jax_frame_motion_blocks(cur, ref, b=b, r=r)
    assert blocks.shape == (h * w // (b * b), b, b)
    assert windows.shape == (h * w // (b * b), b + 2 * r, b + 2 * r)
    assert np.array_equal(blocks, want_blocks)
    assert np.array_equal(windows, want_windows)  # edge padding included


def test_1080p_default_block_refused():
    # 1080 is not a multiple of 16: the default b=16 fails its own assert
    frame = np.zeros((1080, 1920), np.float32)
    with pytest.raises(AssertionError):
        frame_motion_blocks(frame, frame)


@pytest.mark.parametrize("cur_shape,win_shape,match", [
    ((4, 8, 8), (4, 16, 12), "square"),
    ((4, 8, 8), (4, 6, 6), "B \\+ 2R"),
    ((4, 8, 8), (4, 15, 15), "B \\+ 2R"),
    ((8, 8), (16, 16), "\\[N, B, B\\]"),
    ((4, 8, 8, 1), (4, 16, 16), "\\[N, B, B\\]"),
    ((4, 8, 8), (3, 16, 16), "as many"),
    ((0, 8, 8), (0, 16, 16), "N >= 1"),
])
def test_bad_shapes_raise(cur_shape, win_shape, match):
    cur = torch.zeros(cur_shape)
    win = torch.zeros(win_shape)
    with pytest.raises(ValueError, match=match):
        sad_search_op(cur, win)
    with pytest.raises(ValueError, match=match):
        sad_search_ref(cur, win)


def test_cuda_wrapper_refuses_cpu_tensors():
    cur, win = _inputs(0, 4, 8, 4)
    before = port_sad.LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA"):
        sad_search(torch.from_numpy(cur), torch.from_numpy(win))
    assert port_sad.LAUNCHES.count == before


def test_other_devices_raise():
    cur = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sad_search_op(cur, torch.zeros((1, 8, 8), device="meta"))


def test_any_real_dtype_compared_in_f32():
    cur, win = _inputs(5, 16, 8, 4, integer=True)
    want = _port(cur, win)
    got = sad_search_op(torch.from_numpy(cur.astype(np.uint8)),
                        torch.from_numpy(win.astype(np.uint8)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[2].dtype == torch.float32
