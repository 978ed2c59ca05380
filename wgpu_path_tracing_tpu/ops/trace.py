"""The wavefront bounce loop (device-side, SoA).

Reimplements trace() (pt.wgsl:638-709) as a fixed-length ``lax.scan`` over
bounces with masked lanes in place of the reference's divergent per-thread
loop with breaks:

* miss -> lane dies (background is black, pt.wgsl:646-649 — no environment
  map, kept for parity),
* emissive hit -> contribution × 1/(1+t²) distance attenuation, then the
  path TERMINATES (pt.wgsl:652-658; BSDF-sampled emissive hits land at full
  MIS weight — one-sided MIS, a reference quirk kept for parity),
* NEE only when DO_MIS and the hit is front-facing and non-transmissive
  (pt.wgsl:661), weighted by the power heuristic against the BSDF pdf
  (pt.wgsl:666-675),
* BSDF importance sampling + throughput update (pt.wgsl:680-696),
* Russian roulette from bounce 3 on the max throughput component
  (pt.wgsl:699-705).

``bounce_core`` carries the whole shading stage between the two traversals
(closest hit in, shadow query out) on (N,)-shaped SoA lanes.

RNG draws occur in the reference's exact order with masked state
advancement, so per-lane streams match random.wgsl's sequential semantics.
(The shadow traversal consumes no randomness, so resolving occlusion after
the BSDF draws is stream-identical to the reference's inline order.)
"""

from __future__ import annotations

import typing

import jax
import jax.numpy as jnp

from wgpu_path_tracing_tpu.ops import bsdf as BSDF
from wgpu_path_tracing_tpu.ops import lights as LIGHTS
from wgpu_path_tracing_tpu.ops import rng as RNG
from wgpu_path_tracing_tpu.ops import shade as SHADE
from wgpu_path_tracing_tpu.ops import vec
from wgpu_path_tracing_tpu.ops.vec import V3

EPSILON = 1e-6


class BounceState(typing.NamedTuple):
    ro: V3
    rd: V3
    throughput: V3
    result: V3
    alive: jnp.ndarray
    state: jnp.ndarray  # rng


class ShadowQuery(typing.NamedTuple):
    origin: V3
    direction: V3
    t_max: jnp.ndarray
    mask: jnp.ndarray
    direct: V3  # premultiplied contribution, pending occlusion
    pdf: jnp.ndarray


def bounce_core(
    st: BounceState,
    t,
    idx,
    bounce_idx,
    *,
    fetch_tri,
    fetch_light,
    atlas,
    do_mis: bool,
    num_lights: int,
    env=None,
    slots_used=(True, True, True, True),
    bsdf_override=None,
) -> tuple[BounceState, ShadowQuery]:
    """Shading stage of one bounce, between closest-hit and shadow resolve.

    fetch_tri(idx) / fetch_light(idx) return column accessors for the
    denormalized triangle / light rows. ``env`` (optional, ops/env.py) is
    an rd -> V3 radiance sampler added on MISS — an extension over the
    reference's miss -> black (pt.wgsl:646-649); None keeps exact parity.
    """
    found = st.alive & (idx >= 0)
    safe = jnp.maximum(idx, 0)
    hit = SHADE.hit_attributes_from_cols(
        fetch_tri(safe), st.ro, st.rd, t, found, atlas=atlas,
        slots_used=slots_used,
    )

    # Emissive termination with 1/(1+t²) attenuation (pt.wgsl:652-658)
    emissive = found & vec.any_positive(hit.emission)
    atten = hit.emissive_strength / (1.0 + t * t)
    zero = jnp.zeros_like(t)
    zero3 = V3(zero, zero, zero)
    result = st.result + vec.where(
        emissive, st.throughput * hit.emission * atten, zero3
    )
    if env is not None:
        missed = st.alive & (idx < 0)
        result = result + vec.where(
            missed, st.throughput * env(st.rd), zero3
        )

    cont = found & ~emissive

    # --- NEE + MIS (pt.wgsl:661-677)
    state = st.state
    if do_mis:
        nee = cont & (hit.transmission == 0.0) & hit.is_front
        ls, state = LIGHTS.sample_light_from_fetch(
            fetch_light, hit.position, state, nee, num_lights
        )
        v = -vec.normalize(st.rd)
        f_light, pdf_light_bsdf = BSDF.eval_bsdf(
            hit, hit.normal, v, ls.wi, hit.is_front
        )
        mis_w = BSDF.power_heuristic(1.0, ls.pdf, 1.0, pdf_light_bsdf)
        scale = mis_w / jnp.maximum(ls.pdf, EPSILON)
        direct = st.throughput * ls.intensity * f_light * scale
        direct = vec.where(nee & (ls.pdf > 0.0), direct, zero3)
        shadow = ShadowQuery(
            origin=ls.shadow_origin,
            direction=ls.wi,
            t_max=ls.shadow_t_max,
            mask=ls.shadow_mask,
            direct=direct,
            pdf=ls.pdf,
        )
    else:
        inf = jnp.full_like(t, jnp.inf)
        shadow = ShadowQuery(zero3, zero3, inf, jnp.zeros_like(found), zero3, zero)

    # --- BSDF sampling (pt.wgsl:680-696)
    new_dir, state = BSDF.sample_bsdf(hit, st.rd, hit.is_front, state, cont,
                                      override=bsdf_override)
    f_val, pdf = BSDF.eval_bsdf(
        hit, hit.normal, -vec.normalize(st.rd), new_dir, hit.is_front
    )
    ok = cont & (pdf > 0.0)

    ro = vec.where(ok, hit.position + new_dir * EPSILON, st.ro)
    rd = vec.where(ok, vec.normalize(new_dir), st.rd)
    inv_pdf = 1.0 / jnp.maximum(pdf, EPSILON)
    throughput = vec.where(
        ok, st.throughput * f_val * inv_pdf, st.throughput
    )
    alive = ok

    # --- Russian roulette from bounce 3 (pt.wgsl:699-705)
    rr = alive & (bounce_idx > 2)
    u, state = RNG.rand(state, rr)
    p = vec.maxcomp(throughput)
    die = rr & (u > p)
    throughput = vec.where(rr & ~die, throughput * (1.0 / p), throughput)
    alive = alive & ~die

    return (
        BounceState(ro=ro, rd=rd, throughput=throughput, result=result,
                    alive=alive, state=state),
        shadow,
    )


def resolve_shadow(st: BounceState, shadow: ShadowQuery, shadow_t) -> BounceState:
    """Fold the NEE contribution in, zeroed where occluded
    (pt.wgsl:663-676 via lights.apply_occlusion semantics)."""
    occluded = shadow_t < shadow.t_max
    take = shadow.mask & ~occluded & (shadow.pdf > 0.0)
    zero3 = V3(*(jnp.zeros_like(shadow_t) for _ in range(3)))
    return st._replace(
        result=st.result + vec.where(take, shadow.direct, zero3)
    )


def trace(
    scene,
    closest_hit,
    ro,
    rd,
    state,
    *,
    max_bounces: int = 8,
    do_mis: bool = True,
    num_lights: int = 0,
    textured: bool | None = None,
    slots_used=(True, True, True, True),
    lds0=None,
):
    """Trace a batch of rays (plain-XLA path). ro, rd: (N, 3) arrays.

    ``lds0`` (opt-in, rng="stratified"): (3, N) rows [lobe, r1, r2] of
    low-discrepancy values that replace the FIRST bounce's BSDF draw
    values (the PCG stream still advances — see bsdf.sample_bsdf
    override). None (default, all parity modes) changes nothing.

    Returns (radiance (N, 3), new rng state, stats with int32 ray counters).
    """
    n = ro.shape[0]
    if textured is None:
        textured = scene["atlas"].shape[0] > 1 or scene["atlas"].shape[1] > 1
    atlas = scene["atlas"] if textured else None
    if textured and "atlas_fat" in scene:
        # Big-atlas fat canvas (pack_device_scene): one native gather
        # covers all four texture slots — see shade.sample_atlas_fat.
        atlas = ("fat", scene["atlas_fat"], scene["atlas_fat_rects"])
    env = None
    if "env" in scene:
        from wgpu_path_tracing_tpu.ops.env import make_env_sampler

        env = make_env_sampler(scene["env"], scene["env_params"])

    def fetch_tri(idx):
        row = scene["tri_full"][idx]
        return lambda c: row[:, c]

    def fetch_light(idx):
        row = scene["light_full"][idx]
        return lambda c: row[:, c]

    zero = jnp.zeros((n,), jnp.float32)
    one = jnp.ones((n,), jnp.float32)
    st0 = BounceState(
        ro=vec.from_cols(ro),
        rd=vec.from_cols(rd),
        throughput=V3(one, one, one),
        result=V3(zero, zero, zero),
        alive=jnp.ones((n,), bool),
        state=state,
    )
    counters0 = jnp.zeros((2,), jnp.int32)

    def bounce(carry, bounce_idx):
        st, counters = carry
        t, idx = closest_hit(
            vec.stack_rows(st.ro), vec.stack_rows(st.rd), active=st.alive,
        )
        counters = counters.at[0].add(jnp.sum(st.alive.astype(jnp.int32)))
        override = None
        if lds0 is not None:
            # Traced gate: only bounce 0 takes the LDS values; the scan
            # structure is unchanged.
            override = ((bounce_idx == 0), lds0[0], lds0[1], lds0[2])
        st, shadow = bounce_core(
            st, t, idx, bounce_idx,
            fetch_tri=fetch_tri, fetch_light=fetch_light, atlas=atlas,
            do_mis=do_mis, num_lights=num_lights, env=env,
            slots_used=slots_used, bsdf_override=override,
        )
        if do_mis:
            counters = counters.at[1].add(jnp.sum(shadow.mask.astype(jnp.int32)))
            shadow_t, _ = closest_hit(
                vec.stack_rows(shadow.origin),
                vec.stack_rows(shadow.direction),
                active=shadow.mask,
                t_max=shadow.t_max,
                any_hit=True,
            )
            st = resolve_shadow(st, shadow, shadow_t)
        return (st, counters), None

    (st, counters), _ = jax.lax.scan(
        bounce, (st0, counters0), jnp.arange(max_bounces), unroll=1
    )
    stats = {"closest": counters[0], "shadow": counters[1]}
    return vec.stack_cols(st.result), st.state, stats
