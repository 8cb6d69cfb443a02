"""TASM core on PyTorch — the scan path of the reference ``core`` package.

Tile layouts, cost model + what-if, B+-tree semantic index, incremental
tiling policies, the tile store, and the VideoStore engine with its
epoch-keyed tile cache, merging scan scheduler and background physical
tuner, copied from the reference.  Decodes run as fused dispatches of the
CUDA decode kernel on ``DecodeConfig(device=...)`` (``"cuda"`` by default).

Cross-process serving, copied too: ``VideoStoreServer`` (``server.py``)
exposes one store over a Unix/TCP socket (``wire.py``), and
``RemoteVideoStore`` (``client.py``) mirrors the declarative surface, so
many client processes share one scheduler, tile cache, tuner and card;
same-host clients negotiate the shared-memory reply transport
(``shm.py``).  ``python -m repro_torch.tasm_serve`` is the entry point.

The cluster half, copied too: ``ClusterRouter`` (``cluster.py``) scales
that out across node processes with consistent-hash placement
(``PlacementMap``), K-way replication and epoch-checked failover, and
the repair worker (``repair.py``) streams encoded tiles node to node to
re-replicate after a node is lost.  The router does no device work;
``python -m repro_torch.tasm_router`` is its entry point.
The deprecated single-video ``TASM`` facade remains as a shim.
"""
from repro_torch.core import wire
from repro_torch.core.client import (RemoteError, RemoteScanQuery,
                                     RemoteServingSession, RemoteVideoStore)
from repro_torch.core.cluster import (ClusterClient, ClusterRouter,
                                      ClusterRouterServer, PlacementMap)
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
from repro_torch.core.repair import RepairJob, RepairStats, RepairWorker
from repro_torch.core.query import (PhysicalPlan, ScanPlan, ScanQuery,
                                    ScanResult, ScanStats, SOTScan,
                                    merge_results, split_plan)
from repro_torch.core.scheduler import ScanScheduler, ServingSession
from repro_torch.core.semantic_index import SemanticIndex
from repro_torch.core.server import VideoStoreServer
from repro_torch.core.shm import SegmentPool, shm_available
from repro_torch.core.storage import SOTRecord, TileStore
from repro_torch.core.tasm import TASM
from repro_torch.core.tile_cache import CacheStats, TileCache, WorkloadPredictor
from repro_torch.core.tuner import PhysicalTuner, TunerStats
