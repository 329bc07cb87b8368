"""Matmul precision policy.

XLA may run a float32 contraction at reduced precision: on an NVIDIA GPU
with tensor cores it may take the TF32 path (10-bit mantissa inputs), and
other backends default to bfloat16 passes. Either is catastrophic for this
workload: every matmul in the framework is small-K geometry (3x3 pose
composition, Kx3 point transforms, K=3 distance cross terms), where a
~3-decimal-digit input corrupts rotations enough to stall ICP convergence
(observed with bfloat16: Kabsch rotations with diagonal 0.992) and shifts
nearest-neighbour distances by centimetres at 30 m range. Full float32
costs little at these shapes, so every contraction in the compute path
pins Precision.HIGHEST, which rules out TF32.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

# drop-in replacements used across the compute path
einsum = partial(jnp.einsum, precision=HIGHEST)
matmul = partial(jnp.matmul, precision=HIGHEST)
