"""BSDF evaluation and sampling (device-side, SoA).

Reimplements pt.wgsl's metallic/roughness BSDF with transmission over
lane-shaped SoA arrays (ops/vec.py):

* GGX distribution / Smith geometry / Fresnel-Schlick — pt.wgsl:316-345
* cosine-hemisphere sampling — pt.wgsl:299-307 (randomCosineDirection)
* GGX half-vector sampling — pt.wgsl:348-364 (sampleGGXNormal)
* deterministic tangent frame — pt.wgsl:624-634 (constructTBN)
* Schlick dielectric reflectance — pt.wgsl:616-620
* lobe-select sampling — pt.wgsl:498-546 (sampleBSDF): lobe probabilities
  diffuse (1-m)(1-tr) / specular m / transmission (1-m)·tr; the transmission
  lobe reflects on total internal reflection or with probability F (the
  WGSL ``cannotRefract || (rand() < F)`` short-circuits, so the Fresnel
  random is only drawn when refraction is possible — replicated via masked
  RNG advancement).
* evaluation — pt.wgsl:548-614 (evalBSDF), including the reference's quirks:
  transmission lanes return identical value front/back with the LOBE
  PROBABILITY as pdf, the combined pdf is floored at EPSILON on return, and
  roughness is used as stored on the hit (already floored at 0.04).

All branch lanes execute all lobes and select — the TPU has no divergence;
``where`` keeps the semantics.
"""

from __future__ import annotations

import jax.numpy as jnp

from wgpu_path_tracing_tpu.ops import rng as RNG
from wgpu_path_tracing_tpu.ops import vec
from wgpu_path_tracing_tpu.ops.vec import V3

PI = 3.14159265359  # pt.wgsl:3
EPSILON = 1e-6


def reflect(e: V3, n: V3) -> V3:
    """WGSL reflect(e, n) = e - 2*dot(e, n)*n."""
    return e - n * (2.0 * vec.dot(e, n))


def refract(e: V3, n: V3, eta) -> V3:
    """WGSL refract(e, n, eta); returns 0-vector when k < 0."""
    cos_i = vec.dot(n, e)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = e * eta - n * (eta * cos_i + jnp.sqrt(jnp.maximum(k, 0.0)))
    zero = V3(
        jnp.zeros_like(out.x), jnp.zeros_like(out.y), jnp.zeros_like(out.z)
    )
    return vec.where(k < 0.0, zero, out)


def construct_tbn(n: V3):
    """constructTBN (pt.wgsl:624-634): returns (T, B, N) basis vectors."""
    use_y = jnp.abs(n.x) > 0.9
    zeros = jnp.zeros_like(n.x)
    ones = jnp.ones_like(n.x)
    t0 = V3(
        jnp.where(use_y, zeros, ones),
        jnp.where(use_y, ones, zeros),
        zeros,
    )
    b = vec.normalize(vec.cross(n, t0))
    t = vec.normalize(vec.cross(b, n))
    return t, b, n


def distribution_ggx(n: V3, h: V3, roughness):
    """pt.wgsl:316-325."""
    a = roughness * roughness
    a2 = a * a
    ndoth = jnp.maximum(vec.dot(n, h), 0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return jnp.maximum(a2 / (PI * denom * denom), 0.0)


def geometry_schlick_ggx(ndotv, roughness):
    """pt.wgsl:328-332."""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return ndotv / (ndotv * (1.0 - k) + k)


def geometry_smith(n: V3, v: V3, l: V3, roughness):
    """pt.wgsl:334-340."""
    ndotv = jnp.maximum(vec.dot(n, v), 0.0)
    ndotl = jnp.maximum(vec.dot(n, l), 0.0)
    return geometry_schlick_ggx(ndotv, roughness) * geometry_schlick_ggx(
        ndotl, roughness
    )


def _pow5(x):
    """x**5 as a multiply chain (jnp.power may go through exp/log
    approximations)."""
    x2 = x * x
    return x2 * x2 * x


def fresnel_schlick(cos_theta, f0: V3) -> V3:
    """pt.wgsl:343-345."""
    p = _pow5(1.0 - cos_theta)
    return V3(
        f0.x + (1.0 - f0.x) * p,
        f0.y + (1.0 - f0.y) * p,
        f0.z + (1.0 - f0.z) * p,
    )


def reflectance(cos_theta, eta):
    """Schlick dielectric reflectance (pt.wgsl:616-620)."""
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * _pow5(1.0 - cos_theta)


def cosine_direction(normal: V3, r1, r2) -> V3:
    """randomCosineDirection rotated into the normal frame
    (pt.wgsl:299-307 + 513-514)."""
    z = jnp.sqrt(1.0 - r2)
    phi = 2.0 * PI * r1
    sq = jnp.sqrt(r2)
    x = jnp.cos(phi) * sq
    y = jnp.sin(phi) * sq
    t, b, n = construct_tbn(normal)
    return t * x + b * y + n * z


def sample_ggx_normal(normal: V3, roughness, r1, r2) -> V3:
    """sampleGGXNormal (pt.wgsl:348-364)."""
    a = roughness * roughness
    phi = 2.0 * PI * r1
    cos_t = jnp.sqrt((1.0 - r2) / (1.0 + (a * a - 1.0) * r2))
    sin_t = jnp.sqrt(1.0 - cos_t * cos_t)
    lx = sin_t * jnp.cos(phi)
    ly = sin_t * jnp.sin(phi)
    t, b, n = construct_tbn(normal)
    return vec.normalize(t * lx + b * ly + n * cos_t)


def eval_bsdf(hit, normal: V3, v: V3, l: V3, front):
    """evalBSDF (pt.wgsl:548-614). Returns (bsdf V3, pdf).

    ``hit`` needs .albedo (V3), .metallic, .roughness, .transmission, .ior.
    """
    h = vec.normalize(v + l)
    ndotl = jnp.maximum(vec.dot(normal, l), 0.0)
    ndotv = jnp.maximum(vec.dot(normal, v), 0.0)
    ndoth = jnp.maximum(vec.dot(normal, h), 0.0)
    vdoth = jnp.maximum(vec.dot(v, h), 0.0)

    m = hit.metallic
    f0 = V3(
        (1.0 - m) * 0.04 + hit.albedo.x * m,
        (1.0 - m) * 0.04 + hit.albedo.y * m,
        (1.0 - m) * 0.04 + hit.albedo.z * m,
    )
    f = fresnel_schlick(vdoth, f0)
    g = geometry_smith(normal, v, l, hit.roughness)
    d = distribution_ggx(normal, h, hit.roughness)

    kd_scale = 1.0 - hit.transmission
    spec_scale = (g * d) / jnp.maximum(4.0 * ndotv * ndotl, EPSILON)
    diffuse = V3(
        (1.0 - f.x) * kd_scale * hit.albedo.x / PI,
        (1.0 - f.y) * kd_scale * hit.albedo.y / PI,
        (1.0 - f.z) * kd_scale * hit.albedo.z / PI,
    )
    specular = f * spec_scale

    # Reflective combination (pt.wgsl:595-610)
    bsdf_r = (diffuse + specular) * ndotl
    diffuse_prob = (1.0 - m) * (1.0 - hit.transmission)
    specular_prob = m
    diffuse_pdf = ndotl / PI
    specular_pdf = d * ndoth / (4.0 * vdoth)
    pdf_r = diffuse_prob * diffuse_pdf + specular_prob * specular_pdf

    # Transmission branch (pt.wgsl:581-594): value identical front/back, pdf
    # = lobe probability.
    eta = jnp.where(front, 1.0 / hit.ior, hit.ior)
    cos_theta = vec.dot(normal, v)
    f_trans = reflectance(jnp.abs(cos_theta), eta)
    bsdf_t = hit.albedo * (1.0 - f_trans)
    pdf_t = (1.0 - m) * hit.transmission

    is_trans = hit.transmission > 0.0
    bsdf = vec.where(is_trans, bsdf_t, bsdf_r)
    pdf = jnp.where(is_trans, pdf_t, pdf_r)
    return bsdf, jnp.maximum(pdf, EPSILON)  # pt.wgsl:613


def sample_bsdf(hit, rd: V3, front, state, mask, override=None):
    """sampleBSDF (pt.wgsl:498-546). Returns (direction V3, new rng state).

    ``mask``: lanes that actually sample — RNG advances only there. Draw
    schedule per lane in mask: 1 lobe-select + 2 (every lobe draws exactly
    two) + 1 Fresnel draw only on transmission lanes that can refract.

    ``override`` (opt-in, rng="stratified" bounce-0 extension): a
    (gate, r, r1, r2) tuple — where ``gate`` holds, the three main draw
    VALUES are replaced by the given low-discrepancy values while the PCG
    state still advances exactly as before, so every downstream draw
    (Fresnel, Russian roulette, later bounces) keeps its stream. None
    (the default, and every parity mode) changes nothing.
    """
    v = -vec.normalize(rd)

    diffuse_prob = (1.0 - hit.metallic) * (1.0 - hit.transmission)
    specular_prob = hit.metallic

    r, state = RNG.rand(state, mask)
    r1, state = RNG.rand(state, mask)
    r2, state = RNG.rand(state, mask)
    if override is not None:
        gate, o_r, o_r1, o_r2 = override
        r = jnp.where(gate, o_r, r)
        r1 = jnp.where(gate, o_r1, r1)
        r2 = jnp.where(gate, o_r2, r2)

    lobe_d = r < diffuse_prob
    lobe_s = (~lobe_d) & (r < diffuse_prob + specular_prob)
    lobe_t = (~lobe_d) & (~lobe_s)

    # Diffuse
    dir_d = cosine_direction(hit.normal, r1, r2)

    # Specular (roughness floored again at 0.04 — pt.wgsl:518)
    rough = jnp.maximum(hit.roughness, 0.04)
    h_s = sample_ggx_normal(hit.normal, rough, r1, r2)
    dir_s = reflect(-v, h_s)

    # Transmission (pt.wgsl:522-545)
    eta = jnp.where(front, 1.0 / hit.ior, hit.ior)
    n_t = sample_ggx_normal(hit.normal, rough, r1, r2)
    n_t = vec.where(front, n_t, -n_t)
    cos_theta = vec.dot(n_t, v)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = eta * sin_theta > 1.0
    f = reflectance(jnp.abs(cos_theta), eta)
    # Fresnel draw only where the || short-circuit evaluates rand()
    r3, state = RNG.rand(state, mask & lobe_t & ~cannot_refract)
    do_reflect = cannot_refract | (r3 < f)
    dir_t = vec.where(do_reflect, reflect(-v, n_t), refract(-v, n_t, eta))

    direction = vec.where(lobe_d, dir_d, vec.where(lobe_s, dir_s, dir_t))
    return direction, state


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic (pt.wgsl:492-496)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / (f * f + g * g)
