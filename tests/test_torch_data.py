"""The port's training data pipeline (``repro_torch.train.data``, a verbatim
copy of the reference's ``train/data.py``) against the reference's: the
same synthetic token batches from the same seed, the reference's prefetch
and straggler cases on the copy, and ``tasm_region_batches`` over a port
``VideoStore(device="cpu")`` against the reference's over the same video,
within the decode oracle's tolerance."""
import pathlib
import time

import numpy as np
import pytest

from repro.codec.encode import EncoderConfig as JaxEncoderConfig
from repro.core import DecodeConfig as JaxDecodeConfig
from repro.core import VideoStore as JaxVideoStore
from repro.train import data as jax_data
from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import DecodeConfig, VideoStore
from repro_torch.train import data
from repro_torch.train.data import (PrefetchPipeline, synthetic_token_batches,
                                    tasm_region_batches)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-3, 1e-5


def test_copy_is_verbatim():
    ours = (ROOT / "src" / "repro_torch" / "train" / "data.py").read_text()
    ref = (ROOT / "src" / "repro" / "train" / "data.py").read_text()
    assert ours == ref


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("vocab,batch,seq,seed", [(100, 2, 8, 0),
                                                  (49152, 4, 64, 3)])
def test_synthetic_batches_equal_reference(vocab, batch, seq, seed,
                                           structured):
    ours = synthetic_token_batches(vocab, batch, seq, seed=seed, n_batches=3,
                                   structured=structured)
    ref = jax_data.synthetic_token_batches(vocab, batch, seq, seed=seed,
                                           n_batches=3,
                                           structured=structured)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_batches_shift():
    it = synthetic_token_batches(100, 2, 8, n_batches=3)
    b = next(it)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_prefetch_passthrough():
    src = iter(range(10))
    pipe = PrefetchPipeline(src, depth=2, deadline_s=5.0)
    got = list(pipe)
    assert got == list(range(10))
    assert pipe.stats.stall_substitutions == 0


def test_straggler_substitution():
    def slow_source():
        yield "a"
        yield "b"
        time.sleep(0.6)  # straggling shard
        yield "c"

    pipe = PrefetchPipeline(slow_source(), depth=2, deadline_s=0.15)
    got = [next(pipe) for _ in range(4)]
    # the stall was papered over with a repeat of the last ready batch
    assert got[0] == "a" and "b" in got
    assert pipe.stats.stall_substitutions >= 1


def _stores(frames, dets):
    ours = VideoStore(decode=DecodeConfig(device="cpu"))
    ours.add_video("v", encoder=EncoderConfig(gop=16, qp=8))
    ours.ingest("v", frames)
    ours.add_detections("v", {f: d for f, d in enumerate(dets)})
    ref = JaxVideoStore(decode=JaxDecodeConfig(backend="numpy"))
    ref.add_video("v", encoder=JaxEncoderConfig(gop=16, qp=8))
    ref.ingest("v", frames)
    ref.add_detections("v", {f: d for f, d in enumerate(dets)})
    return ours, ref


def test_tasm_region_batches_match_reference(small_video):
    frames, dets = small_video
    ours, ref = _stores(frames, dets)
    try:
        got = tasm_region_batches(ours, ["car", "person"], batch=4, crop=16,
                                  seed=2)
        want = jax_data.tasm_region_batches(ref, ["car", "person"], batch=4,
                                            crop=16, seed=2)
        for _ in range(3):
            a, b = next(got), next(want)
            assert a["pixels"].shape == b["pixels"].shape == (4, 16, 16)
            assert a["pixels"].dtype == np.float32
            np.testing.assert_array_equal(a["labels"], b["labels"])
            np.testing.assert_allclose(a["pixels"], b["pixels"], atol=ATOL,
                                       rtol=RTOL)
            assert np.isfinite(a["pixels"]).all()
    finally:
        ours.close()
        ref.close()


def test_module_imports_no_framework():
    assert "torch" not in data.__dict__ and "jax" not in data.__dict__
