"""Unified runtime configuration for :class:`~repro_torch.core.engine.VideoStore`.

The engine's serving knobs used to be five ad-hoc keyword arguments
(``tile_cache_bytes``, ``tuning``, ``tuner_admission``, ``roi_decode``,
``decode_backend``).  They are now grouped into three small config objects::

    VideoStore(cache=CacheConfig(...),
               tuning=TuningConfig(...),
               decode=DecodeConfig(...))

Every config is a plain dataclass with ``to_doc``/``from_doc``, so the same
surface travels over the wire: ``RemoteVideoStore.config()`` and the router's
``config`` op return these documents, and ``scripts/tasm_serve.py`` builds
them from ``--cache-*`` / ``--tuning*`` / ``--decode-*`` flags.

Precedence (one rule for every knob, most-specific wins):

1. an **explicit** config field (``CacheConfig(eviction="lru")``),
2. a **deprecated keyword alias** (``VideoStore(tile_cache_bytes=...)``) —
   it maps 1:1 onto the config field; passing both the alias and a config
   that sets the same field is an error, not a silent pick,
3. an **environment override** — ``REPRO_CACHE_BYTES``,
   ``REPRO_CACHE_EVICTION``, ``REPRO_TORCH_DECODE_BACKEND`` (the port's
   own name, so this package and the reference never steer each other),
4. the built-in default.

Fields whose default is ``None`` mean "not set here — fall through to the
environment, then the default".  :meth:`resolve` applies steps 3–4 and
returns a fully-concrete config; ``VideoStore`` stores only resolved
configs, so ``store.cache_config`` etc. never contain ``None`` knobs.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

DEFAULT_CACHE_BYTES = 256 << 20  # 256 MiB

#: eviction policies: "reuse" = expected-reuse weight (observed re-access
#: frequency, LRU tiebreak), "lru" = the pre-predictive byte-budgeted LRU,
#: preserved bit-for-bit.
EVICTION_MODES = ("reuse", "lru")
TUNING_MODES = ("background", "inline", "off")
ADMISSION_MODES = ("policy", "gated")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None or v == "" else int(v)


@dataclass(frozen=True)
class CacheConfig:
    """Tile-cache knobs (see ``core/tile_cache.py``).

    - ``budget_bytes`` — byte budget; ``0`` disables the cache entirely;
      ``None`` falls through to ``$REPRO_CACHE_BYTES`` then the 256 MiB
      default.
    - ``eviction`` — ``"reuse"`` (expected-reuse weighting) or ``"lru"``
      (the legacy policy, bit-for-bit); ``None`` falls through to
      ``$REPRO_CACHE_EVICTION`` then ``"reuse"``.
    - ``prefetch`` — predictively decode the next SOTs of a detected
      sliding-window scan onto the scheduler's worker pool.
    - ``prefetch_depth`` — how many SOTs ahead to prefetch.
    - ``block_packed`` — store ROI entries as (mask, packed pixels) instead
      of a zero-padded full-tile canvas, so the same byte budget holds many
      more subframe entries (served pixels stay bit-identical).
    """
    budget_bytes: Optional[int] = None
    eviction: Optional[str] = None
    prefetch: bool = False
    prefetch_depth: int = 2
    block_packed: bool = True

    def resolve(self) -> "CacheConfig":
        budget = self.budget_bytes
        if budget is None:
            budget = _env_int("REPRO_CACHE_BYTES")
        if budget is None:
            budget = DEFAULT_CACHE_BYTES
        eviction = (self.eviction
                    or os.environ.get("REPRO_CACHE_EVICTION") or "reuse")
        if eviction not in EVICTION_MODES:
            raise ValueError(f"cache eviction must be one of "
                             f"{EVICTION_MODES}, got {eviction!r}")
        if self.prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        return CacheConfig(budget_bytes=int(budget), eviction=eviction,
                           prefetch=bool(self.prefetch),
                           prefetch_depth=int(self.prefetch_depth),
                           block_packed=bool(self.block_packed))

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "CacheConfig":
        return cls(**doc)


@dataclass(frozen=True)
class TuningConfig:
    """Physical-tuner knobs (see ``core/tuner.py``).

    - ``mode`` — ``"background"`` (async tuner thread), ``"inline"``
      (observe + retile inside the scan, the pre-tuner semantics), or
      ``"off"``.
    - ``admission`` — ``"policy"`` (apply every policy proposal) or
      ``"gated"`` (rank + gate proposals by their what-if net benefit).
    - ``max_log`` — workload-log bound (oldest observations drop first).
    """
    mode: str = "background"
    admission: str = "policy"
    max_log: int = 4096

    def resolve(self) -> "TuningConfig":
        if self.mode not in TUNING_MODES:
            raise ValueError(f"tuning mode must be one of {TUNING_MODES}, "
                             f"got {self.mode!r}")
        if self.admission not in ADMISSION_MODES:
            raise ValueError(f"tuner admission must be one of "
                             f"{ADMISSION_MODES}, got {self.admission!r}")
        return TuningConfig(mode=self.mode, admission=self.admission,
                            max_log=max(1, int(self.max_log)))

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "TuningConfig":
        return cls(**doc)


@dataclass(frozen=True)
class DecodeConfig:
    """Decode-path knobs (see ``core/storage.py``).

    - ``backend`` — ``"batched"`` (fused CUDA-kernel dispatches over the
      merged batch) or ``"numpy"`` (per-tile oracle loop); ``None`` falls
      through to ``$REPRO_TORCH_DECODE_BACKEND`` then ``"batched"``.
    - ``roi`` — lower per-tile 8x8-block masks into plans so subframe scans
      decode only the blocks their boxes intersect (results bit-identical
      either way).
    - ``max_workers`` — decode worker-pool size; ``None`` sizes from the
      CPU count.
    - ``device`` — where the batched decode runs; ``None`` means
      ``"cuda"``, and resolving raises if no CUDA device is available (no
      silent CPU fallback: pass ``"cpu"`` to decode on the CPU).
    """
    backend: Optional[str] = None
    roi: bool = True
    max_workers: Optional[int] = None
    device: Optional[str] = None

    def resolve(self) -> "DecodeConfig":
        # late import: storage has no dependency on this module
        from repro_torch.core.storage import DECODE_BACKENDS
        from repro_torch.kernels.decode.ops import resolve_device

        backend = (self.backend
                   or os.environ.get("REPRO_TORCH_DECODE_BACKEND")
                   or "batched")
        if backend not in DECODE_BACKENDS:
            raise ValueError(f"decode_backend must be one of "
                             f"{DECODE_BACKENDS}, got {backend!r}")
        workers = self.max_workers
        if workers is None:
            workers = min(8, os.cpu_count() or 4)
        device = str(resolve_device(self.device or "cuda"))
        return DecodeConfig(backend=backend, roi=bool(self.roi),
                            max_workers=int(workers), device=device)

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "DecodeConfig":
        return cls(**doc)
