"""TASM core on PyTorch — the scan path of the reference ``core`` package.

Tile layouts, cost model + what-if, B+-tree semantic index, incremental
tiling policies, the tile store, and the VideoStore engine with its
epoch-keyed tile cache, merging scan scheduler and background physical
tuner, copied from the reference.  Decodes run as fused dispatches of the
CUDA decode kernel on ``DecodeConfig(device=...)`` (``"cuda"`` by default).
"""
from repro_torch.core.config import (CacheConfig, DecodeConfig, TuningConfig,
                                     DEFAULT_CACHE_BYTES)
from repro_torch.core.cost import (CostModel, calibrate, calibrate_io,
                                   pixels_and_tiles, query_cost,
                                   roi_pixels_and_tiles)
from repro_torch.core.engine import IngestStats, VideoEntry, VideoStore
from repro_torch.core.layout import (
    TileLayout,
    block_coverage,
    coarse_grained_layout,
    fine_grained_layout,
    partition,
    single_tile_layout,
    uniform_layout,
)
from repro_torch.core.policies import (
    KQKOPolicy,
    LazyPolicy,
    MorePolicy,
    NoTilingPolicy,
    PretileAllPolicy,
    RegretPolicy,
)
from repro_torch.core.query import (PhysicalPlan, ScanPlan, ScanQuery,
                                    ScanResult, ScanStats, SOTScan,
                                    merge_results, split_plan)
from repro_torch.core.scheduler import ScanScheduler, ServingSession
from repro_torch.core.semantic_index import SemanticIndex
from repro_torch.core.storage import SOTRecord, TileStore
from repro_torch.core.tile_cache import CacheStats, TileCache, WorkloadPredictor
from repro_torch.core.tuner import PhysicalTuner, TunerStats
