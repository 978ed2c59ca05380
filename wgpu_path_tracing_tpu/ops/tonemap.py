"""Display transform: exposure -> AGX -> look -> EOTF -> gamma.

Reimplements blit.wgsl's fragment tonemap chain (blit.wgsl:43-155) as one
fused elementwise pass over the HDR accumulation buffer (XLA fuses the whole
chain into one kernel, so no hand-written variant is needed):

* exposureAdjust: color × exp2(EXPOSURE), EXPOSURE = 1.0 (blit.wgsl:43-51),
* agx: inset matrix -> clamped log2 encode over [-12.47393, 4.026069] ->
  6th-order sigmoid approximation (blit.wgsl:54-86),
* agxLook: ASC CDL with identity slope/power/sat (blit.wgsl:102-114) —
  evaluated with the power==1 identity so negative epsilon values don't NaN
  (WGSL pow is equally undefined there; GPUs return x),
* agxEotf: outset matrix -> pow 2.2 (blit.wgsl:88-100),
* final gammaCorrect pow(1/2.2) (blit.wgsl:45-47).

WGSL mat3x3f constructors take COLUMN vectors; the matrices below are
transposed accordingly so ``v @ M.T`` equals the WGSL ``M * v``. Every
product runs at ``Precision.HIGHEST`` (``_mul``): a GPU may otherwise take
f32 matrix products in TF32, and the golden images pin this chain's output.

The unused ACES variant (blit.wgsl:116-131) is provided for completeness.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

EXPOSURE = 1.0  # blit.wgsl:43

# Columns as written in blit.wgsl:68-72.
_AGX_MAT = np.array(
    [
        [0.842479062253094, 0.0423282422610123, 0.0423756549057051],
        [0.0784335999999992, 0.878468636469772, 0.0784336],
        [0.0792237451477643, 0.0791661274605434, 0.879142973793104],
    ]
).T.astype(np.float32)

_AGX_MAT_INV = np.array(
    [
        [1.19687900512017, -0.0528968517574562, -0.0529716355144438],
        [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
        [-0.0990297440797205, -0.0989611768448433, 1.15107367264116],
    ]
).T.astype(np.float32)

_ACES_M1 = np.array(
    [
        [0.59719, 0.07600, 0.02840],
        [0.35458, 0.90834, 0.13383],
        [0.04823, 0.01566, 0.83777],
    ]
).T.astype(np.float32)

_ACES_M2 = np.array(
    [
        [1.60475, -0.10208, -0.00327],
        [-0.53108, 1.10813, -0.07276],
        [-0.07367, -0.00605, 1.07602],
    ]
).T.astype(np.float32)

_MIN_EV = -12.47393  # blit.wgsl:74
_MAX_EV = 4.026069  # blit.wgsl:75

_LUMA = np.array([0.2126, 0.7152, 0.0722], np.float32)  # blit.wgsl:103


def _mul(v, m):
    """``v @ m`` in full f32 (no TF32)."""
    return jnp.matmul(v, jnp.asarray(m), precision=jax.lax.Precision.HIGHEST)


def _agx_contrast(x):
    """6th-order sigmoid approximation (blit.wgsl:54-65)."""
    x2 = x * x
    x4 = x2 * x2
    return (
        15.5 * x4 * x2
        - 40.14 * x4 * x
        + 31.96 * x4
        - 6.868 * x2 * x
        + 0.4298 * x2
        + 0.1191 * x
        - 0.00232
    )


def agx(val):
    """blit.wgsl:67-86."""
    result = _mul(val, _AGX_MAT.T)
    result = jnp.clip(jnp.log2(result), _MIN_EV, _MAX_EV)
    result = (result - _MIN_EV) / (_MAX_EV - _MIN_EV)
    return _agx_contrast(result)


def agx_look(val):
    """blit.wgsl:102-114 — default look: slope/power 1, sat 1 (identity)."""
    luma = _mul(val, _LUMA)
    result = val  # pow(val * 1.0, 1.0)
    return luma[..., None] + 1.0 * (result - luma[..., None])


def agx_eotf(val):
    """blit.wgsl:88-100."""
    result = _mul(val, _AGX_MAT_INV.T)
    return jnp.power(result, 2.2)


def aces_tone_map(hdr):
    """blit.wgsl:116-131 (kept but unused by the default chain)."""
    v = _mul(hdr, _ACES_M1.T)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return jnp.clip(_mul(a / b, _ACES_M2.T), 0.0, 1.0)


def tone_mapping(color, exposure: float = EXPOSURE):
    """blit.wgsl:133-145."""
    mapped = color * jnp.exp2(jnp.float32(exposure))
    mapped = agx(mapped)
    mapped = agx_look(mapped)
    mapped = agx_eotf(mapped)
    return mapped


def gamma_correct(color):
    """blit.wgsl:45-47."""
    return jnp.power(color, 1.0 / 2.2)


def display_transform(color, exposure: float = EXPOSURE):
    """Full fragment chain (blit.wgsl:147-155): tonemap then gamma."""
    return gamma_correct(tone_mapping(color, exposure))
