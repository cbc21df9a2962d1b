"""DecodeStats: structured per-decode counters (SURVEY.md §5
"Metrics / logging / observability" — replaces the reference's printf
timing with a returned metrics object)."""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class DecodeStats:
    width: int = 0
    height: int = 0
    n_components: int = 0
    progressive: bool = False
    n_scans: int = 0
    n_segments: int = 0
    restart_interval: int = 0
    bitstream_bytes: int = 0
    total_blocks: int = 0
    entropy_engine: str = ""
    transform_engine: str = ""
    # Times a requested fast path was unavailable and a slower engine
    # took the image (fallback-rate observability: a production corpus
    # that silently misses the fused path shows up here, not in MP/s).
    entropy_fallbacks: int = 0
    # Wall-clock seconds per stage, filled by the orchestrator.
    t_parse: float = 0.0
    t_entropy: float = 0.0
    t_transform: float = 0.0

    @property
    def megapixels(self) -> float:
        return self.width * self.height / 1e6

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["megapixels"] = self.megapixels
        return d
