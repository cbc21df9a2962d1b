"""DecodeConfig: the single knob surface, the port's copy of
``tpujpeg/config.py``. Everything is defaulted so
``tpujpeg_torch.decode(data)`` just works.

The fields are the reference's. Where a value names a TPU engine, the
port names its own counterpart: ``transform_engine`` takes 'torch'
(the plain int32 torch transform, the reference's 'jnp') and 'cuda'
(the hand-written kernels, the reference's 'pallas'). Fields that tune
TPU-only machinery (``wavefront_lanes``, ``wavefront_vmem_budget``,
``prog_tables``, ``mesh_axis``) are kept for a like-for-like surface
and read by no code of the port yet."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    # Entropy stage: 'auto' picks native C when available (and the Pallas
    # wavefront decoder on TPU when the stream is restart-segmented),
    # falling back to the pure-Python oracle.
    entropy_engine: str = "auto"  # 'auto' | 'python' | 'native' | 'wavefront'

    # Transform stage: 'torch' = plain int32 torch ops (semantic
    # reference; the reference's 'jnp'), 'cuda' = the hand-written
    # kernels (the reference's 'pallas'; their plain versions run for
    # CPU tensors). 'auto' is 'cuda'.
    transform_engine: str = "auto"  # 'auto' | 'torch' | 'cuda'

    # IDCT variant: 'islow' is bit-exact vs libjpeg; 'matmul' uses the
    # MXU with float32 (libjpeg-conformant tolerance, faster).
    idct: str = "islow"  # 'islow' | 'matmul'

    # libjpeg do_fancy_upsampling equivalent (default on, like libjpeg).
    fancy_upsampling: bool = True

    # Wavefront decoder lane count per kernel launch (SURVEY.md §7.2 #1).
    wavefront_lanes: int = 1024

    # Return numpy instead of a torch tensor from decode().
    to_numpy: bool = True

    # Mesh axis name used by batched / sharded decode paths.
    mesh_axis: str = "data"

    # Optional max VMEM bytes a wavefront launch may assume for the
    # bitstream slice (None = derive from platform).
    wavefront_vmem_budget: Optional[int] = None

    # Progressive scan-kernel Huffman tables: 'baked' compiles the
    # tables into the chain (fastest kernels, but every distinct
    # optimized-table set costs a fresh chain compile — libjpeg emits
    # per-image tables for progressive); 'dynamic' passes tables as
    # runtime operands (one compiled chain per scan-script shape,
    # kernels measured ~1.2x slower); 'auto' uses dynamic for
    # singleton-table groups and baked for groups that share tables.
    prog_tables: str = "auto"  # 'auto' | 'baked' | 'dynamic'


DEFAULT_CONFIG = DecodeConfig()
