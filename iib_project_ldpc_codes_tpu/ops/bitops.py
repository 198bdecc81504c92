"""Bit-packing utilities for the 32-trials-per-lane decoder fast path.

The bit-packed Monte Carlo layout stores one Bernoulli/binary value per bit:
``uint32[n, W]`` holds ``B = 32*W`` independent trials for each of ``n``
variable nodes.  Trial ``b`` lives in bit ``b % 32`` of word ``b // 32``.
Elementwise AND/OR/XOR on these words process 32 trials per element --
the batched replacement for the reference's per-trial C
loops (message_passing.c:15-79).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

WORD = 32
_WEIGHTS = None


def _weights() -> jax.Array:
    return (jnp.uint32(1) << jnp.arange(WORD, dtype=jnp.uint32))


def pack_bits(bits: jax.Array) -> jax.Array:
    """bool[..., B] -> uint32[..., B//32]; bit b of word w is trial 32*w+b."""
    b = bits.shape[-1]
    if b % WORD:
        raise ValueError(f"trailing dim {b} must be a multiple of {WORD}")
    words = bits.reshape(bits.shape[:-1] + (b // WORD, WORD))
    return jnp.sum(words.astype(jnp.uint32) * _weights(), axis=-1,
                   dtype=jnp.uint32)


def unpack_bits(words: jax.Array) -> jax.Array:
    """uint32[..., W] -> bool[..., 32*W] (inverse of :func:`pack_bits`)."""
    expanded = (words[..., None] >> jnp.arange(WORD, dtype=jnp.uint32)) & 1
    return expanded.reshape(words.shape[:-1] + (-1,)).astype(bool)


def popcount(words: jax.Array) -> jax.Array:
    """Per-word population count, uint32 -> int32."""
    return jax.lax.population_count(words).astype(jnp.int32)


def total_popcount(words: jax.Array) -> jax.Array:
    """Total set bits across the whole array (scalar int32)."""
    return jnp.sum(popcount(words))


def per_trial_counts(words: jax.Array, axis: int = 0) -> jax.Array:
    """Count set bits per *trial* along ``axis``.

    For ``uint32[n, W]`` with axis=0, returns int32[32*W]: for each trial,
    the number of the n rows whose bit is set.  Used once per decode (final
    per-trial erasure counts), not in the iteration loop.
    """
    moved = jnp.moveaxis(words, axis, 0)
    bits = ((moved[..., None] >> jnp.arange(WORD, dtype=jnp.uint32)) & 1)
    counts = jnp.sum(bits, axis=0, dtype=jnp.int32)  # [..., W, 32]
    return counts.reshape(counts.shape[:-2] + (-1,))


def bernoulli_packed(key: jax.Array, prob, shape) -> jax.Array:
    """uint32[*shape] with 32 independent Bernoulli(prob) bits per word.

    Uses one uint32 random draw per bit compared against a 32-bit fixed
    point threshold, so the bias is at most 2^-32.
    """
    thresh = jnp.asarray(
        jnp.clip(jnp.float64(prob) if jax.config.jax_enable_x64
                 else jnp.float32(prob), 0.0, 1.0) * (2.0 ** 32),
        jnp.float32)
    shape = tuple(shape)
    raw = jax.random.bits(key, shape[:-1] + (shape[-1] * WORD,), jnp.uint32)
    # Compare in float32: exact for thresholds representable in 24 bits;
    # Monte Carlo bias bounded by 2^-24 relative, far below CI widths.
    hit = raw.astype(jnp.float32) < thresh
    return pack_bits(hit)


def with_vma_of(x: jax.Array, ref: jax.Array) -> jax.Array:
    """Union ``ref``'s varying-manual-axes type into ``x``.

    jax 0.9.0's shard_map checker does not promote while_loop carries
    whose initial value is unvarying (e.g. a ``jnp.zeros`` decoder state)
    but whose body output is varying -- it hard-errors with a carry type
    mismatch.  Mixing in a ref-derived zero (folded away by XLA) gives the
    initial value the right vma.  No-op outside shard_map or when ``ref``
    is unvarying.
    """
    zero = (ref.reshape(-1)[:1] != ref.reshape(-1)[:1])[0]  # False, ref's vma
    if x.dtype == jnp.bool_:
        return x ^ zero
    return x + zero.astype(x.dtype)
