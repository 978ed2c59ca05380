"""Hit attribute construction (device-side, SoA).

The reference computes the full HitInfo struct inside every ray-triangle test
(pt.wgsl:157-227) even though only the closest hit survives. Here traversal
returns only (t, triangle index); the winning triangle's denormalized row
(geometry + material, models/types.py TF_* layout) is fetched once and the
attributes rebuilt — barycentrics recomputed with the identical
Möller-Trumbore expressions so floats match the reference.

``hit_attributes_from_cols`` is generic over a column accessor (columns of
a fetched (N, 52) row).

Covers pt.wgsl:157-227: barycentric normal/uv interpolation, UV-derivative
tangent basis, texture-atlas fetches with per-slot fallbacks
(pt.wgsl:112-120 getTextureColor), PBR attribute assembly (roughness floored
at 0.04, pt.wgsl:208), and conditional normal mapping (applied only when the
sampled texel differs from the flat default (0.5, 0.5, 1) — pt.wgsl:216-226).
Untextured scenes pass ``atlas=None`` and take fallback values, exactly as
rects with w == 0 do in the reference.
"""

from __future__ import annotations

import typing

import jax.numpy as jnp

from wgpu_path_tracing_tpu.models import types as T
from wgpu_path_tracing_tpu.ops import vec
from wgpu_path_tracing_tpu.ops.vec import V3


class Hit(typing.NamedTuple):
    t: jnp.ndarray
    found: jnp.ndarray
    position: V3
    normal: V3
    albedo: V3
    alpha: jnp.ndarray
    roughness: jnp.ndarray
    metallic: jnp.ndarray
    transmission: jnp.ndarray
    ior: jnp.ndarray
    emission: V3
    emissive_strength: jnp.ndarray
    uv_u: jnp.ndarray
    uv_v: jnp.ndarray
    is_front: jnp.ndarray


def sample_atlas(atlas, rect, u, v, fallback):
    """getTextureColor (pt.wgsl:112-120) — XLA path only (texel gathers).

    atlas: (H, W, 4); rect: 4 lane-shaped cols [x, y, w, h] in pixels;
    u, v: lane-shaped UV. Nearest-neighbour mip-0 load; WGSL ``%`` is
    sign-preserving fmod so negative UVs index backwards; the f32->u32
    conversion saturates at 0.
    """
    h, w = atlas.shape[0], atlas.shape[1]
    rx, ry, rw, rh = rect
    ax = rx + jnp.fmod(u, 1.0) * rw
    ay = ry + jnp.fmod(v, 1.0) * rh
    ix = jnp.clip(ax, 0.0, w - 1).astype(jnp.int32)
    iy = jnp.clip(ay, 0.0, h - 1).astype(jnp.int32)
    texel = atlas[iy, ix]  # (..., 4)
    missing = (rw == 0.0) | (rh == 0.0)
    out = []
    for c in range(4):
        out.append(jnp.where(missing, fallback[c], texel[..., c]))
    return out


# Texture-slot order shared by every sampler path: (albedo, pbr, emissive,
# normal) — the call order of hit_attributes_from_cols and the channel
# order of the fat-atlas table (pack_device_scene "atlas_fat").
SLOT_RECT_COLS = (T.TF_ALBEDO_RECT, T.TF_PBR_RECT, T.TF_EMISSIVE_RECT,
                  T.TF_NORMAL_RECT)
SLOT_FALLBACKS = ((1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1.0),
                  (1.0, 1.0, 1.0, 1.0), (0.5, 0.5, 1.0, 1.0))


def sample_atlas_fat(fat, fat_rects, get, uv_u, uv_v):
    """All four texture slots in ONE native gather (big-atlas fast path).

    A row gather costs about the same whatever the row width, so four
    per-slot gathers cost about four times one: pack_device_scene pre-bakes a
    (FH, FW, 16) "fat" canvas — every distinct material MAP SET gets a
    virtual rect on the componentwise-LCM grid of its mapped slots, each
    texel row carrying the four slots' texels at the same uv (unmapped
    slots hold their SLOT_FALLBACKS constant; exact per-slot texel choice
    by the integer floor identity — models/types.py::_build_fat_atlas).

    Each lane's virtual rect is resolved by MATCHING its 16 atlas-rect
    values (already on hand from the fetched triangle row) against the
    static (S, 20) match table ``fat_rects`` — ~20 vector ops per set,
    negligible next to the gather it replaces, and no extra fetched row.
    Lanes matching no set (untextured materials) read canvas row 0 and
    are fully masked by the per-slot ``missing`` fallbacks.

    Texel choice matches the per-slot sample_atlas for every slot except
    the documented texel-boundary ulp class (floor(kx + f*kw) vs
    floor(fx + f*lw) // (lw//kw) can round across an integer on
    boundary-epsilon uvs).

    Returns the four [r, g, b, a] quads in SLOT order.
    """
    fh, fw = fat.shape[0], fat.shape[1]
    rects = [[get(c + i) for i in range(4)] for c in SLOT_RECT_COLS]
    missing = [(r[2] == 0.0) | (r[3] == 0.0) for r in rects]
    vals = [rects[k][i] for k in range(4) for i in range(4)]
    fx = fy = vw = vh = jnp.zeros_like(uv_u)
    for s in range(fat_rects.shape[0]):
        m = None
        for j in range(16):
            eq = vals[j] == fat_rects[s, j]
            m = eq if m is None else (m & eq)
        fx = jnp.where(m, fat_rects[s, 16], fx)
        fy = jnp.where(m, fat_rects[s, 17], fy)
        vw = jnp.where(m, fat_rects[s, 18], vw)
        vh = jnp.where(m, fat_rects[s, 19], vh)
    # Index math identical to sample_atlas (pt.wgsl:112-120) on the
    # virtual rect.
    ax = fx + jnp.fmod(uv_u, 1.0) * vw
    ay = fy + jnp.fmod(uv_v, 1.0) * vh
    ix = jnp.clip(ax, 0.0, fw - 1).astype(jnp.int32)
    iy = jnp.clip(ay, 0.0, fh - 1).astype(jnp.int32)
    row = fat.reshape(-1, 16)[iy * fw + ix]  # (N, 16) — the one gather
    quads = []
    for k in range(4):
        fb = SLOT_FALLBACKS[k]
        quads.append([
            jnp.where(missing[k], fb[c], row[..., 4 * k + c])
            for c in range(4)
        ])
    return quads


def barycentrics_from_cols(get, ro: V3, rd: V3):
    """Exact barycentric/uv expressions (pt.wgsl:128-156) for Hit
    construction. Returns (e1, e2, u, v, w, uv_u, uv_v)."""
    v0 = V3(get(T.TF_V0), get(T.TF_V0 + 1), get(T.TF_V0 + 2))
    v1 = V3(get(T.TF_V1), get(T.TF_V1 + 1), get(T.TF_V1 + 2))
    v2 = V3(get(T.TF_V2), get(T.TF_V2 + 1), get(T.TF_V2 + 2))
    e1 = v1 - v0
    e2 = v2 - v0
    hvec = vec.cross(rd, e2)
    a = vec.dot(e1, hvec)
    f = 1.0 / a
    s = ro - v0
    u = f * vec.dot(s, hvec)
    q = vec.cross(s, e1)
    v = f * vec.dot(rd, q)
    w = 1.0 - u - v
    uv_u = get(T.TF_UV0) * w + get(T.TF_UV1) * u + get(T.TF_UV2) * v
    uv_v = (get(T.TF_UV0 + 1) * w + get(T.TF_UV1 + 1) * u
            + get(T.TF_UV2 + 1) * v)
    return e1, e2, u, v, w, uv_u, uv_v


def hit_attributes_from_cols(get, ro: V3, rd: V3, t, found, atlas=None,
                             slots_used=(True, True, True, True)) -> Hit:
    """Build the Hit from a row-column accessor ``get(col) -> lane array``.

    ``atlas`` is the (H, W, 4) array (native texel gathers) or the
    ``("fat", canvas, rects)`` tuple of the fat-atlas mode.

    ``slots_used`` is the STATIC (albedo, pbr, emissive, normal) scene-wide
    slot mask from models/types.py::texture_slots_used: a slot no material
    maps takes its fallback value with ZERO fetch cost — bit-identical to
    sampling the all-empty rects (the reference fetches unconditionally,
    pt.wgsl:199-230, but its texture cache makes that nearly free; our
    one-hot selects are not)."""
    n0 = V3(get(T.TF_N0), get(T.TF_N0 + 1), get(T.TF_N0 + 2))
    n1 = V3(get(T.TF_N1), get(T.TF_N1 + 1), get(T.TF_N1 + 2))
    n2 = V3(get(T.TF_N2), get(T.TF_N2 + 1), get(T.TF_N2 + 2))

    # Barycentrics with the traversal's exact expressions
    # (pt.wgsl:128-156) so u/v/t match the reference bit-for-bit.
    e1, e2, u, v, w, uv_u, uv_v = barycentrics_from_cols(get, ro, rd)

    position = ro + rd * t

    geom_normal = vec.normalize(vec.cross(e1, e2))
    interp_normal = vec.normalize(n0 * w + n1 * u + n2 * v)
    is_front = vec.dot(geom_normal, rd) < 0.0  # pt.wgsl:196-197

    base_color = V3(
        get(T.TF_BASE_COLOR), get(T.TF_BASE_COLOR + 1), get(T.TF_BASE_COLOR + 2)
    )
    metallic_f = get(T.TF_METALLIC)
    roughness_f = get(T.TF_ROUGHNESS)
    emission_f = V3(
        get(T.TF_EMISSION), get(T.TF_EMISSION + 1), get(T.TF_EMISSION + 2)
    )

    if atlas is not None:
        fat_quads = None
        if isinstance(atlas, tuple) and atlas[0] == "fat":
            # Fat-atlas mode: ONE gather covers all four slots (see
            # sample_atlas_fat); quads arrive in SLOT order.
            _, fat_arr, fat_rects = atlas
            fat_quads = sample_atlas_fat(fat_arr, fat_rects, get, uv_u, uv_v)
            sample = None
        else:
            import functools

            sample = functools.partial(sample_atlas, atlas)

        def slot(k):
            if fat_quads is not None:
                return fat_quads[k]
            rect = [get(SLOT_RECT_COLS[k] + i) for i in range(4)]
            return sample(rect, uv_u, uv_v, SLOT_FALLBACKS[k])

        if slots_used[0]:
            av = slot(0)
            albedo = V3(av[0], av[1], av[2]) * base_color
            alpha = av[3]
        else:
            albedo = base_color
            alpha = jnp.ones_like(u)
        if slots_used[1]:
            pv = slot(1)
            metallic = pv[2] * metallic_f
            roughness = jnp.maximum(pv[1] * roughness_f, 0.04)
        else:
            metallic = metallic_f
            roughness = jnp.maximum(roughness_f, 0.04)
        if slots_used[2]:
            ev = slot(2)
            emission = V3(ev[0], ev[1], ev[2]) * emission_f
        else:
            emission = emission_f

        if slots_used[3]:
            # Tangent basis from UV derivatives (pt.wgsl:176-189). No
            # degenerate-UV guard, as in the reference — the NaN basis is
            # only consumed when a normal-map texel is actually sampled.
            duv1u = get(T.TF_UV1) - get(T.TF_UV0)
            duv1v = get(T.TF_UV1 + 1) - get(T.TF_UV0 + 1)
            duv2u = get(T.TF_UV2) - get(T.TF_UV0)
            duv2v = get(T.TF_UV2 + 1) - get(T.TF_UV0 + 1)
            r = 1.0 / (duv1u * duv2v - duv1v * duv2u)
            tangent = vec.normalize((e1 * duv2v - e2 * duv1v) * r)
            tn = interp_normal
            tvec = vec.normalize(tangent - tn * vec.dot(tn, tangent))
            bvec = vec.normalize(vec.cross(tn, tvec))

            nm = slot(3)
            use_nm = (nm[0] != 0.5) | (nm[1] != 0.5) | (nm[2] != 1.0)
            world_normal = vec.normalize(
                tvec * (nm[0] * 2.0 - 1.0)
                + bvec * (nm[1] * 2.0 - 1.0)
                + tn * (nm[2] * 2.0 - 1.0)
            )
            normal = vec.where(use_nm, world_normal, interp_normal)
        else:
            # The flat default texel (0.5, 0.5, 1) never engages the
            # normal map (pt.wgsl:216-226), so this is the exact value.
            normal = interp_normal
    else:
        # Untextured: every slot takes its fallback (w == 0 rects).
        albedo = base_color
        alpha = jnp.ones_like(u)
        metallic = metallic_f
        roughness = jnp.maximum(roughness_f, 0.04)
        emission = emission_f
        normal = interp_normal

    return Hit(
        t=t,
        found=found,
        position=position,
        normal=normal,
        albedo=albedo,
        alpha=alpha,
        roughness=roughness,
        metallic=metallic,
        transmission=get(T.TF_TRANSMISSION),
        ior=get(T.TF_IOR),
        emission=emission,
        emissive_strength=get(T.TF_EMISSIVE_STRENGTH),
        uv_u=uv_u,
        uv_v=uv_v,
        is_front=is_front,
    )


def hit_attributes(scene, ro, rd, t, idx, textured: bool | None = None,
                   slots_used=(True, True, True, True)) -> Hit:
    """XLA-path wrapper: ro/rd (N, 3) arrays; gathers the winner row."""
    found = idx >= 0
    safe = jnp.maximum(idx, 0)
    row = scene["tri_full"][safe]  # (N, TF_COLS)
    if textured is None:
        textured = scene["atlas"].shape[0] > 1 or scene["atlas"].shape[1] > 1
    atlas = scene["atlas"] if textured else None
    if textured and "atlas_fat" in scene:
        atlas = ("fat", scene["atlas_fat"], scene["atlas_fat_rects"])
    return hit_attributes_from_cols(
        lambda c: row[:, c],
        vec.from_cols(ro),
        vec.from_cols(rd),
        t,
        found,
        atlas=atlas,
        slots_used=slots_used,
    )
