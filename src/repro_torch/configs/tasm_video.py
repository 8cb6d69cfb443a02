"""The paper's own workload configuration: TASM video-analytics settings.

Not an LM architecture — this is the storage-manager configuration used by
the benchmarks and examples (encoder, layout constraints, policy constants),
collected in one place as the `--arch tasm-video` selectable config.
Scaled-down analogue constants are documented against the paper's values.
"""
from dataclasses import dataclass, field

from repro_torch.codec.encode import EncoderConfig


@dataclass(frozen=True)
class TASMVideoConfig:
    # codec (paper: HEVC via NVENC/NVDEC; ours: GOP-structured DCT codec)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    # layout constraints (paper: HEVC min tile 256x64 at 2K-4K; scaled down
    # proportionally for the 320x192 synthetic corpus)
    align: int = 8
    min_tile: int = 32
    # policy constants (paper §4)
    alpha: float = 0.8   # not-tiling threshold (§3.4.4, Fig. 10)
    eta: float = 1.0     # regret multiplier (§4.4, online indexing [11])
    # evaluation corpus (Table 1 analogues)
    sparse_coverage_max: float = 0.20  # "sparse": <20% frame coverage
    default_height: int = 192
    default_width: int = 320
    default_fps_gop: int = 16  # 1 "second" per GOP


CONFIG = TASMVideoConfig()
