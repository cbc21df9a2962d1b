"""DecodeConfig: the single knob surface of the port. Everything is
defaulted so ``tpujpeg_torch.decode(data)`` just works.

The fields are the reference's (``tpujpeg/config.py``) that some code of
the port reads. Where a value names a TPU engine, the port names its own
counterpart: ``transform_engine`` takes 'torch' (the plain int32 torch
transform, the reference's 'jnp') and 'cuda' (the hand-written kernels,
the reference's 'pallas'). The reference's fields that tune TPU-only
machinery (wavefront lanes, VMEM budget, progressive table baking, mesh
axis name) have no counterpart here."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    # Entropy stage: 'auto' and 'wavefront' first try kernel A's fused
    # path on a baseline stream (decoder.py); for what it refuses, 'auto'
    # picks native C on the host (the pure-Python oracle where it does not
    # build) and 'wavefront' kernel 2 or 7-9 on the device.
    entropy_engine: str = "auto"  # 'auto' | 'python' | 'native' | 'wavefront'

    # Transform stage: 'torch' = plain int32 torch ops (semantic
    # reference; the reference's 'jnp'), 'cuda' = the hand-written
    # kernels (the reference's 'pallas'; their plain versions run for
    # CPU tensors). 'auto' is 'cuda'.
    transform_engine: str = "auto"  # 'auto' | 'torch' | 'cuda'

    # IDCT variant: 'islow' is bit-exact vs libjpeg; 'matmul' is a float32
    # matrix product (libjpeg-conformant tolerance).
    idct: str = "islow"  # 'islow' | 'matmul'

    # libjpeg do_fancy_upsampling equivalent (default on, like libjpeg).
    fancy_upsampling: bool = True

    # Return numpy instead of a torch tensor from decode().
    to_numpy: bool = True


DEFAULT_CONFIG = DecodeConfig()
