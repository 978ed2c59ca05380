"""Per-ray random number generation (device-side, vectorized).

Reimplements random.wgsl exactly, but functionally: the reference keeps one
mutable u32 per GPU thread (random.wgsl:1); here the state is an explicit
(N,) uint32 array threaded through the trace loop.

* seed = pixel.x + pixel.y * 1000 + frame * 100000 (random.wgsl:3-5) —
  note this collides for width > 1000 exactly as the reference does; the
  "hash" rng mode (cfg.rng) decorrelates it for production use.
* rand(): state = state * 747796405 + 2891336453;
  word = ((state >> ((state >> 28) + 4)) ^ state) * 277803737;
  word = (word >> 22) ^ word; return f32(word) / 4294967295.0
  (random.wgsl:7-12). Note f32(0xFFFFFFFF) rounds to 4294967296.0 so the
  divisor is effectively 2^32 and rand() can return exactly 1.0.
* rand_int(lo, hi) = lo + u32(rand() * f32(hi - lo + 1)) (random.wgsl:14-16).

Masked advancement: the reference draws a data-dependent NUMBER of randoms
per bounce (branches in sampleLight / sampleBSDF each call rand() a different
number of times). To reproduce the exact per-pixel stream in vectorized form,
every draw site takes a lane mask and only advances the state where the mask
is set — lanes outside the mask keep their state (and the returned value for
them is unspecified/unused).
"""

from __future__ import annotations

import jax.numpy as jnp

import numpy as np

_MUL = np.uint32(747796405)
_INC = np.uint32(2891336453)
_XSH = np.uint32(277803737)

# f32(4294967295u) rounds to 4294967296.0 — match WGSL's constant conversion.
_INV = np.float32(np.float32(1.0) / np.float32(4294967295.0))


def seed_pixel(x: jnp.ndarray, y: jnp.ndarray, frame: jnp.ndarray) -> jnp.ndarray:
    """initRNG (random.wgsl:3-5). x, y: int pixel coords; frame: frame index."""
    x = x.astype(jnp.uint32)
    y = y.astype(jnp.uint32)
    frame = jnp.asarray(frame).astype(jnp.uint32)
    return x + y * np.uint32(1000) + frame * np.uint32(100000)


def _pcg(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One PCG step; returns (new_state, u32 output word)."""
    state = state * _MUL + _INC
    shift = (state >> np.uint32(28)) + np.uint32(4)
    word = ((state >> shift) ^ state) * _XSH
    word = (word >> np.uint32(22)) ^ word
    return state, word


def _u32_to_f32(word: jnp.ndarray) -> jnp.ndarray:
    """Exact uint32 -> float32 (round-to-nearest) via 16-bit halves.

    hi·65536 and lo are both f32-exact, so the single rounding happens in
    the add — bit-identical to a direct conversion.
    """
    hi = (word >> np.uint32(16)).astype(jnp.int32).astype(jnp.float32)
    lo = (word & np.uint32(0xFFFF)).astype(jnp.int32).astype(jnp.float32)
    return hi * np.float32(65536.0) + lo


def rand(state: jnp.ndarray, mask: jnp.ndarray | None = None):
    """rand() (random.wgsl:7-12) with optional masked state advancement.

    Returns (value in [0, 1], new_state). Where ``mask`` is False the state
    is left untouched (the value there is still computed but meaningless).
    """
    new_state, word = _pcg(state)
    value = _u32_to_f32(word) * _INV
    if mask is not None:
        new_state = jnp.where(mask, new_state, state)
    return value, new_state


def rand_int(state: jnp.ndarray, lo: int, hi: int, mask: jnp.ndarray | None = None):
    """randInt(lo, hi) inclusive (random.wgsl:14-16).

    The result is clamped to ``hi`` to guard the 2^-32 edge where rand()
    returns exactly 1.0 (WGSL robust buffer access clamps the subsequent
    array index; we clamp the index itself).
    """
    value, new_state = rand(state, mask)
    span = np.float32(hi - lo + 1)
    # f32 -> i32 truncation (non-negative here) matches WGSL's u32() cast.
    idx = np.int32(lo) + (value * span).astype(jnp.int32)
    idx = jnp.minimum(idx, np.int32(hi))
    return idx, new_state


# R2 additive low-discrepancy sequence (the plastic constant's inverse
# powers): frame k's 2D point is frac(k * (R2_A1, R2_A2)) — consecutive
# samples are maximally spread in the unit square. Used by the opt-in
# "stratified" rng mode (RenderConfig.rng) for PRIMARY-ray decisions
# (pixel jitter, lens disc), where the estimator is a plain average over
# frames and low-discrepancy beats independent uniforms; path/bounce
# decisions keep the PCG stream. Not part of reference parity.
R2_A1 = 0.7548776662466927
R2_A2 = 0.5698402909980532
R2_CYCLE = 4096  # frames fold modulo this: f32 frac() precision degrades
# past ~2^12 * R2_A (24-bit mantissa); a 4096-frame stratification window
# is far beyond any practical spp-per-pixel-jitter benefit anyway.


def r2_point(x, y, frame, stream: int = 0):
    """Per-(pixel, frame) scrambled R2 point in [0,1)^2: the shared R2
    sequence rotated per pixel (Cranley-Patterson) by two hash_seed
    streams, so neighboring pixels decorrelate while each pixel's frame
    sequence stays low-discrepancy."""
    zero = jnp.zeros((), jnp.int32)
    inv = np.float32(1.0 / 4294967296.0)  # u32 word -> [0, 1)
    u0 = _u32_to_f32(hash_seed(x, y, zero, stream=stream)) * inv
    v0 = _u32_to_f32(hash_seed(x, y, zero, stream=stream + 1)) * inv
    f = (jnp.asarray(frame).astype(jnp.int32) & (R2_CYCLE - 1)).astype(
        jnp.float32
    )
    u = u0 + f * np.float32(R2_A1)
    v = v0 + f * np.float32(R2_A2)
    return u - jnp.floor(u), v - jnp.floor(v)


def hash_seed(x, y, frame, stream: int = 0) -> jnp.ndarray:
    """"hash" rng mode: a well-mixed seed (no y*1000 collisions).

    Uses two rounds of PCG output hashing over a 2^24-stride layout so every
    (pixel, frame, stream) gets a decorrelated stream. Not part of reference
    parity; selected by RenderConfig.rng == "hash".
    """
    v = (
        x.astype(jnp.uint32)
        + y.astype(jnp.uint32) * np.uint32(9781)
        + jnp.asarray(frame).astype(jnp.uint32) * np.uint32(6271)
        + np.uint32(np.uint32(stream) * np.uint32(26699))
    )
    for _ in range(2):
        _, v = _pcg(v)
    return v
