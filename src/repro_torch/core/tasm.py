"""DEPRECATED single-video facade over the :class:`VideoStore` engine.

The seed of this repo exposed TASM (paper §3, Fig. 2) as a per-video object
with a positional ``scan()``.  The storage manager is now an engine-level
catalog — ``repro_torch.core.engine.VideoStore`` — managing many named
videos, a persistent on-disk manifest, and a declarative query builder with
an explicit plan/execute split::

    # old (still works, emits DeprecationWarning)
    tasm = TASM("cam0", enc, policy=RegretPolicy())
    tasm.ingest(frames)
    res = tasm.scan("car", (0, 96))

    # new
    store = VideoStore(store_root=...)
    store.add_video("cam0", encoder=enc, policy=RegretPolicy())
    store.ingest("cam0", frames)
    res  = store.scan("cam0").labels("car").frames(0, 96).execute()
    plan = store.scan("cam0").labels("car").frames(0, 96).explain()

This module keeps the old constructor signature as a thin shim over a
one-video ``VideoStore`` so external callers migrate at their own pace.
``ScanStats``/``ScanResult`` now live in ``repro_torch.core.query`` and are
re-exported here.  Differences from the seed facade:

- ``ingest`` returns :class:`~repro_torch.core.engine.IngestStats` (one unified
  contract: ``encode_s`` = encoding seconds, always paid; ``pretile_s`` =
  extra policy-driven re-tiling seconds, 0.0 when layouts arrive with the
  video).  The seed returned retile-seconds on the policy path but
  encode-seconds on the ``initial_layouts`` path.
- tile decodes are batched across SOTs through the engine's thread pool;
  regions and pixels are bit-identical to the seed's serial loop.

In the port, ``decode=`` (a :class:`~repro_torch.core.config.DecodeConfig`)
names the device of the shim's codec, as for ``VideoStore``: ``None``
decodes and encodes on CUDA and raises without a card.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core.config import DecodeConfig, TuningConfig
from repro_torch.core.cost import CostModel
from repro_torch.core.engine import IngestStats, VideoStore
from repro_torch.core.layout import TileLayout
from repro_torch.core.policies import Policy
from repro_torch.core.query import (ScanResult,  # noqa: F401 (re-export)
                                    ScanStats)


class TASM:
    """Deprecated one-video shim over :class:`VideoStore`."""

    def __init__(self, video: str, encoder: Optional[EncoderConfig] = None, *,
                 policy: Optional[Policy] = None,
                 cost_model: Optional[CostModel] = None,
                 sot_len: Optional[int] = None,
                 store_root: Optional[str] = None,
                 decode: Optional[DecodeConfig] = None):
        warnings.warn(
            "TASM is deprecated; use repro_torch.core.engine.VideoStore "
            "(catalog + store.scan(video).labels(...).frames(...).execute())",
            DeprecationWarning, stacklevel=2)
        # autoload=False keeps the seed facade's semantics: a reused
        # store_root is re-encoded, not adopted from its manifest.
        # mode="inline" likewise: the seed retiled synchronously inside
        # scan(), and this shim stays bit-for-bit compatible with that
        self._engine = VideoStore(store_root=store_root, autoload=False,
                                  tuning=TuningConfig(mode="inline"),
                                  decode=decode)
        self._entry = self._engine.add_video(
            video, encoder=encoder, policy=policy, cost_model=cost_model,
            sot_len=sot_len)
        self.video = video

    # -- configuration passthrough ------------------------------------------
    @property
    def engine(self) -> VideoStore:
        return self._engine

    @property
    def encoder(self) -> EncoderConfig:
        return self._entry.encoder

    @property
    def policy(self) -> Policy:
        return self._entry.policy

    @policy.setter
    def policy(self, p: Policy) -> None:
        self._entry.policy = p

    @property
    def cost_model(self) -> CostModel:
        return self._entry.cost_model

    @property
    def index(self):
        return self._entry.index

    @property
    def store(self):
        return self._entry.store

    @property
    def frame_hw(self):
        return self._entry.frame_hw

    @property
    def history(self) -> list[ScanStats]:
        return self._entry.history

    # -- old API, delegating -------------------------------------------------
    def ingest(self, frames: np.ndarray, *, detections=None,
               initial_layouts: Optional[dict[int, TileLayout]] = None
               ) -> IngestStats:
        """Encode the video; see ``VideoStore.ingest`` for the contract."""
        return self._engine.ingest(self.video, frames, detections=detections,
                                   initial_layouts=initial_layouts)

    def add_metadata(self, video_id: str, frame: int, label: str,
                     x1: int, y1: int, x2: int, y2: int) -> None:
        """ADDMETADATA through the engine, so it is locked and durable."""
        self._engine.add_metadata(video_id, frame, label, x1, y1, x2, y2)

    def add_detections(self, detections_by_frame: dict[int, list]) -> float:
        """Bulk-add (label, bbox) detections; returns 0 (timed by caller)."""
        self._engine.add_detections(self.video, detections_by_frame)
        return 0.0

    def scan(self, labels, t_range: Optional[tuple[int, int]] = None,
             *, decode: bool = True) -> ScanResult:
        """SCAN(video, L, T).  labels: str | [str] | CNF."""
        q = self._engine.scan(self.video).labels(labels).decode(decode)
        if t_range is not None:
            q = q.frames(*t_range)
        return q.execute()

    def what_if(self, labels, layout_by_sot: dict[int, TileLayout],
                t_range=None) -> float:
        """§4.1 what-if interface (delegates to the engine)."""
        return self._engine.what_if(self.video, labels, layout_by_sot,
                                    t_range)

    def storage_bytes(self) -> float:
        return self._engine.storage_bytes(self.video)
