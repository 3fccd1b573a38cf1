"""The port's copy of the ``jax.random`` functions that the reference's
serving engines sample with, bit for bit (threefry-2x32, jax's
partitionable layout; see :mod:`repro_torch.kernels.sample.ref`).

Keys are ``(..., 2)`` uint32 tensors, as the reference's raw keys are;
no function keeps state.  ``prng_key`` takes the device to make the key
on; the others work on the device of the key they are given.  The draw
that the engines run each decode step, the Gumbel-max over ``(R, V)``
logits, is :func:`repro_torch.kernels.sample.ops.sample` (a CUDA kernel on
the card).
"""

from ..kernels.sample.ref import (
    categorical,
    fold_in,
    gumbel,
    inv_temperature,
    prng_key,
    random_bits32,
    scale_logits,
    split,
    threefry2x32,
    top_k_mask,
    uniform,
)

__all__ = [
    "categorical", "fold_in", "gumbel", "inv_temperature", "prng_key",
    "random_bits32", "scale_logits", "split", "threefry2x32", "top_k_mask",
    "uniform",
]
