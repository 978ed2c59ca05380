"""Next-event-estimation light sampling (device-side, SoA).

Reimplements sampleLight (pt.wgsl:374-489) over batched lanes:

* uniform light pick via randInt (pt.wgsl:375),
* DIRECTIONAL: direction stored in light.position (gpu.ts:212); any shadow
  hit occludes; pdf = 1/N · 1000 (pt.wgsl:385-406 — the magic ×1000 scale is
  a reference quirk kept for parity),
* POINT: ignored beyond distance 100 (pt.wgsl:413); inverse-square falloff;
  pdf = 1/N · 10000 (pt.wgsl:407-438),
* EMISSIVE: uniform triangle-area sample (u = 1-sqrt(r1), v = r2·sqrt(r1)),
  solid-angle pdf = (1/N)(1/area)(d²/max(|cosθ|, ε)), intensity carries NO
  distance falloff (pt.wgsl:439-486).

``sample_light_cols`` is generic over the light-row accessor (columns of
fetched rows). It does NOT trace the shadow ray itself — it returns the shadow ray
+ per-lane t_max; the caller traverses and applies occlusion (the reference's
early returns zero pdf and intensity; ``apply_occlusion`` reproduces that).
RNG draws use masked advancement matching the reference order: the light
pick advances every NEE lane; the two triangle-sample draws advance only
lanes that picked an emissive light.
"""

from __future__ import annotations

import typing

import jax.numpy as jnp

from wgpu_path_tracing_tpu.models import types as T
from wgpu_path_tracing_tpu.ops import rng as RNG
from wgpu_path_tracing_tpu.ops import vec
from wgpu_path_tracing_tpu.ops.vec import V3

EPSILON = 1e-6


class LightSample(typing.NamedTuple):
    intensity: V3
    wi: V3
    pdf: jnp.ndarray
    # Shadow query (resolved by the caller):
    shadow_origin: V3
    shadow_t_max: jnp.ndarray  # inf for directional lanes
    shadow_mask: jnp.ndarray  # lanes that need the shadow traversal


def sample_light_from_fetch(fetch, hit_position: V3, state, mask,
                            num_lights: int):
    """Core NEE sampling. ``fetch(idx)(col)`` returns light_full columns for
    per-lane light indices ``idx``."""
    count = max(num_lights, 1)

    idx, state = RNG.rand_int(state, 0, count - 1, mask)
    get = fetch(idx)

    ltype = get(T.LF_TYPE).astype(jnp.int32)
    lcolor = V3(get(T.LF_COLOR), get(T.LF_COLOR + 1), get(T.LF_COLOR + 2))
    lint = get(T.LF_INTENSITY)
    lpos = V3(get(T.LF_POSITION), get(T.LF_POSITION + 1), get(T.LF_POSITION + 2))

    is_dir = ltype == T.LIGHT_TYPE_DIRECTIONAL
    is_spot = ltype == T.LIGHT_TYPE_SPOT
    is_point = (ltype == T.LIGHT_TYPE_POINT) | is_spot
    is_emis = ltype == T.LIGHT_TYPE_EMISSIVE

    # Emissive triangle sample draws (masked to emissive lanes,
    # pt.wgsl:444-445)
    r1, state = RNG.rand(state, mask & is_emis)
    r2, state = RNG.rand(state, mask & is_emis)

    # --- Directional (pt.wgsl:385-406)
    wi_dir = vec.normalize(-lpos)

    # --- Point (pt.wgsl:407-438)
    to_light_p = lpos - hit_position
    dist_p = vec.length(to_light_p)
    point_far = is_point & (dist_p > 100.0)
    wi_point = to_light_p * (1.0 / jnp.maximum(dist_p, 1e-30))

    # --- Emissive (pt.wgsl:439-486) — triangle geometry rides in the row.
    v0 = V3(get(T.LF_V0), get(T.LF_V0 + 1), get(T.LF_V0 + 2))
    v1 = V3(get(T.LF_V1), get(T.LF_V1 + 1), get(T.LF_V1 + 2))
    v2 = V3(get(T.LF_V2), get(T.LF_V2 + 1), get(T.LF_V2 + 2))
    n0 = V3(get(T.LF_N0), get(T.LF_N0 + 1), get(T.LF_N0 + 2))
    n1 = V3(get(T.LF_N1), get(T.LF_N1 + 1), get(T.LF_N1 + 2))
    n2 = V3(get(T.LF_N2), get(T.LF_N2 + 1), get(T.LF_N2 + 2))
    su = 1.0 - jnp.sqrt(r1)
    sv = r2 * jnp.sqrt(r1)
    sw = 1.0 - su - sv
    light_pos = v0 * sw + v1 * su + v2 * sv
    lnormal = vec.normalize(n0 * sw + n1 * su + n2 * sv)
    to_light_e = light_pos - hit_position
    dist_e = vec.length(to_light_e)
    wi_emis = to_light_e * (1.0 / jnp.maximum(dist_e, 1e-30))

    wi = vec.where(is_dir, wi_dir, vec.where(is_point, wi_point, wi_emis))
    dist = jnp.where(is_point, dist_p, dist_e)

    inv_n = 1.0 / jnp.float32(count)

    pdf_dir = inv_n * 1000.0  # pt.wgsl:406
    pdf_point = inv_n * 10000.0  # pt.wgsl:438
    e1 = v1 - v0
    e2 = v2 - v0
    area = vec.length(vec.cross(e1, e2)) * 0.5
    cos_theta = jnp.abs(vec.dot(lnormal, -wi))
    # Degenerate (zero-area) rows — e.g. the all-zero padding row of a
    # lightless scene — must yield pdf 0, not inf (inf pdfs turn the MIS
    # power heuristic into inf/inf = NaN and poison the accumulator).
    inv_area = jnp.where(area > 0.0, 1.0 / jnp.maximum(area, 1e-30), 0.0)
    pdf_emis = inv_n * inv_area * (
        dist_e * dist_e / jnp.maximum(cos_theta, EPSILON)
    )

    int_dir = lcolor * lint
    att = 1.0 / (dist_p * dist_p)
    # Spot extension (no reference counterpart — spots are warned-and-
    # skipped at load there, gpu.ts:234-236): point-light behavior times the
    # KHR_lights_punctual angular attenuation, squared smooth falloff from
    # the inner to the outer cone via the precomputed scale/offset.
    spot_dir = V3(
        get(T.LF_SPOT_DIR), get(T.LF_SPOT_DIR + 1), get(T.LF_SPOT_DIR + 2)
    )
    cd = vec.dot(spot_dir, -wi_point)
    spot_t = jnp.clip(
        cd * get(T.LF_SPOT_SCALE) + get(T.LF_SPOT_OFFSET), 0.0, 1.0
    )
    att = att * jnp.where(is_spot, spot_t * spot_t, 1.0)
    int_point = lcolor * (lint * att)
    int_emis = lcolor * lint

    pdf = jnp.where(is_dir, pdf_dir, jnp.where(is_point, pdf_point, pdf_emis))
    intensity = vec.where(is_dir, int_dir, vec.where(is_point, int_point, int_emis))

    dead = point_far | ~mask
    pdf = jnp.where(dead, 0.0, pdf)
    zero = V3(*(jnp.zeros_like(pdf) for _ in range(3)))
    intensity = vec.where(dead, zero, intensity)

    shadow_mask = mask & ~point_far
    shadow_origin = hit_position + wi * EPSILON
    t_max = jnp.where(is_dir, jnp.inf, dist - EPSILON * 2.0)

    return (
        LightSample(
            intensity=intensity,
            wi=wi,
            pdf=pdf,
            shadow_origin=shadow_origin,
            shadow_t_max=t_max,
            shadow_mask=shadow_mask,
        ),
        state,
    )


def apply_occlusion(sample: LightSample, shadow_t) -> LightSample:
    """Zero pdf/intensity where the shadow traversal found a blocker
    (pt.wgsl:394-399, 423-429, 465-471): occluded iff hit t < t_max
    (misses report t = inf)."""
    occluded = shadow_t < sample.shadow_t_max
    pdf = jnp.where(occluded, 0.0, sample.pdf)
    zero = V3(*(jnp.zeros_like(pdf) for _ in range(3)))
    intensity = vec.where(occluded, zero, sample.intensity)
    return sample._replace(intensity=intensity, pdf=pdf)


def sample_light(scene, closest_hit, hit_position: V3, state, mask,
                 num_lights: int):
    """XLA-path wrapper: gathers light rows and resolves
    the shadow ray with the scene's intersection function. Returns
    ((intensity V3, wi V3, pdf), new state)."""

    def fetch(idx):
        row = scene["light_full"][idx]  # (N, LF_COLS)
        return lambda c: row[:, c]

    sample, state = sample_light_from_fetch(
        fetch, hit_position, state, mask, num_lights
    )
    sro = vec.stack_rows(sample.shadow_origin)
    srd = vec.stack_rows(sample.wi)
    shadow_t, _ = closest_hit(
        sro, srd, active=sample.shadow_mask, t_max=sample.shadow_t_max,
        any_hit=True,
    )
    return apply_occlusion(sample, shadow_t), state
