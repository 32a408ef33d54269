"""Random number generation: wang-hash lane streams + counter-based mode.

Two RNG families, selectable per render config:

``WangRng`` — an exact functional re-implementation of the reference's
per-lane wang-hash stream (mathutils.h:8-31): a mutable u32 state hashed
in place per draw. Here the state is threaded functionally (draw returns
(value, new_state)); under ``vmap`` each pixel carries one independent
u32 stream, exactly like one AVX lane. This is the parity RNG: the
JAX-CPU oracle and the Pallas kernel consume identical draw sequences, so
images match to float tolerance.

``CounterRng`` — a counter-based threefry2x32 generator keyed by
(pixel, frame, sample, draw-index). No sequential state: any draw is
addressable in O(1), which is what makes sample-axis sharding across
chips and path-replay backward passes deterministic (SURVEY.md
section 7 hard-part (c)). This is the recommended RNG for multi-chip
sharded-spp rendering.

Seed layout parity: ``pixel_seed`` reproduces
``demofox_path_tracing_optimization_v4.cpp:1096-1101``:
seed = (x*1973 + y*9277 + frame*26699) | 1, all in wrapping u32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

_U32 = jnp.uint32


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, _U32)


def wang_hash(seed: jnp.ndarray) -> jnp.ndarray:
    """One round of Thomas Wang's 32-bit integer hash (mathutils.h:8-16)."""
    seed = _u32(seed)
    seed = (seed ^ _u32(61)) ^ (seed >> 16)
    seed = seed * _u32(9)
    seed = seed ^ (seed >> 4)
    seed = seed * _u32(0x27D4EB2D)
    seed = seed ^ (seed >> 15)
    return seed


def rand01(state: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform float in [0, 1) and the advanced state.

    Matches Randomf3201_ps (mathutils.h:18-27): the sign bit is masked
    off and the remaining 31 bits are scaled by 2^-31, trading one bit of
    state for a branch-free unsigned conversion exactly as the reference
    does.
    """
    state = wang_hash(state)
    # route the cast through int32: the mask clears the sign bit so the
    # reinterpretation is value-preserving, and i32->f32 is the cast
    # every backend has
    value = (state & _u32(0x7FFFFFFF)).astype(jnp.int32).astype(
        jnp.float32
    ) * jnp.float32(1.0 / 2147483648.0)
    return value, state


def signed_rand01(state: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform float in [-1, 1): signed u32 reinterpretation / 2^31.

    Matches SignedRandomf3201_ps (mathutils.h:29-31).
    """
    state = wang_hash(state)
    value = state.astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        1.0 / 2147483648.0
    )
    return value, state


def pixel_seed(x, y, frame) -> jnp.ndarray:
    """Per-pixel, per-frame RNG seed.

    seed = (x*1973 + y*9277 + frame*26699) | 1, wrapping u32 arithmetic
    (demofox_path_tracing_optimization_v4.cpp:1096-1101). The |1 keeps the
    all-zero fixed point of wang_hash unreachable.
    """
    s = _u32(x) * _u32(1973) + _u32(y) * _u32(9277) + _u32(frame) * _u32(26699)
    return s | _u32(1)


class WangRng(NamedTuple):
    """Functional wrapper around the sequential wang-hash stream."""

    state: jnp.ndarray

    @staticmethod
    def from_pixel(x, y, frame) -> "WangRng":
        return WangRng(pixel_seed(x, y, frame))

    def next01(self) -> Tuple[jnp.ndarray, "WangRng"]:
        v, s = rand01(self.state)
        return v, WangRng(s)


# ----------------------------------------------------------------------------
# Counter-based RNG (threefry2x32), for sharded spp / path replay.
# ----------------------------------------------------------------------------

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
# python-int constant (not a jnp scalar): Pallas kernels reject captured
# concrete arrays, and int literals fold into the jaxpr
_PARITY = 0x1BD11BDA


def _rotl(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(key0, key1, ctr0, ctr1) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Threefry-2x32 with 20 rounds (the jax.random default construction).

    A standalone implementation (not jax.random) so kernels and the
    oracle can call it with raw u32s inside Pallas or vmapped code
    without PRNGKey plumbing.
    """
    k0, k1 = _u32(key0), _u32(key1)
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)

    # ctr0/ctr1 may be python ints (counter epoch 0): keep them as int
    # literals until they mix with a traced u32 so no concrete jnp scalar
    # is ever captured inside a Pallas kernel
    x0 = ctr0 + ks[0]
    x1 = ctr1 + ks[1]
    for block in range(5):
        for r in _ROTATIONS[(block % 2) * 4 : (block % 2) * 4 + 4]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + (block + 1)
    return x0, x1


def counter_rand01(key0, key1, ctr0, ctr1) -> jnp.ndarray:
    """One uniform [0,1) float addressed purely by (key, counter)."""
    bits, _ = threefry2x32(key0, key1, ctr0, ctr1)
    return (bits & _u32(0x7FFFFFFF)).astype(jnp.int32).astype(
        jnp.float32
    ) * jnp.float32(1.0 / 2147483648.0)


class CounterRng(NamedTuple):
    """Counter-based stream: same draw API as WangRng, O(1) addressable.

    key0/key1 identify (pixel, frame|sample); ``ctr`` increments per
    draw. Replaces sequential state with an addressable counter so spp
    sharding and backward-pass replay are deterministic.
    """

    key0: jnp.ndarray
    key1: jnp.ndarray
    ctr: jnp.ndarray

    @staticmethod
    def from_pixel(x, y, frame, sample=0) -> "CounterRng":
        key0 = _u32(x) * _u32(1973) + _u32(y) * _u32(9277)
        key1 = _u32(frame) * _u32(26699) + _u32(sample) * _u32(40503) + _u32(1)
        return CounterRng(key0, key1, _u32(0))

    def next01(self) -> Tuple[jnp.ndarray, "CounterRng"]:
        v = counter_rand01(self.key0, self.key1, self.ctr, 0)
        return v, CounterRng(self.key0, self.key1, self.ctr + 1)
