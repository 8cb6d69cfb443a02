"""Test fixtures.  NOTE: no XLA_FLAGS here — smoke tests must see 1 device;
multi-device tests run in subprocesses (tests/test_distributed.py)."""
import numpy as np
import pytest

import _hypothesis_compat

# the container has no `hypothesis`; install the API-compatible shim so the
# property-test modules collect and run (no-op when the real package exists)
_hypothesis_compat.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture(scope="session")
def sparse_video():
    from repro.data.video_gen import generate, sparse_spec

    spec = sparse_spec(seed=3, n_frames=64, height=96, width=160)
    frames, dets = generate(spec)
    return frames, dets


@pytest.fixture(scope="session")
def small_video():
    from repro.data.video_gen import VideoSpec, ObjectSpec, generate

    spec = VideoSpec(height=96, width=160, n_frames=32, seed=5,
                     objects=[ObjectSpec("car", 2, (16, 24), 2.0),
                              ObjectSpec("person", 1, (18, 10), 1.0)])
    frames, dets = generate(spec)
    return frames, dets
