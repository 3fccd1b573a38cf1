"""Seeded nonzero QKV biases for the reference's params.

Both packages' inits draw ``bq``, ``bk`` and ``bv`` as zeros, so weights
drawn by either init only ever add zeros.  :func:`draw_biases` replaces
them in the reference's params, before the parameter bridge loads them
into the port, with numpy draws of std ``BIAS_STD``: the size of a
projection's output (a normalised input through ``1 / sqrt(fan_in)``
weights), so that a bias that is lost or misplaced moves logits, caches
and gradients far beyond the tolerances of the tests that use them.
"""

import jax.numpy as jnp
import numpy as np

BIASES = ("bq", "bk", "bv")
BIAS_STD = 1.0


def draw_biases(params, cfg, seed):
    """``params`` (the reference's, as its init returns them) with every
    layer's ``bq``, ``bk`` and ``bv`` drawn from ``seed`` where
    ``cfg.qkv_bias``, after checking that the init's are zeros; a config
    without biases is returned as it is."""
    if not cfg.qkv_bias:
        return params
    attn = params["blocks"]["attn"]
    rng = np.random.default_rng(seed)
    for n in BIASES:
        assert not np.asarray(attn[n]).any(), "the reference's init draws zeros"
        attn[n] = jnp.asarray(BIAS_STD * rng.standard_normal(attn[n].shape),
                              attn[n].dtype)
    return params
