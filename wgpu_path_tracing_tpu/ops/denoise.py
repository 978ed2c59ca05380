"""Edge-avoiding à-trous wavelet denoiser (opt-in extension).

The reference has no denoiser — this is an extension for reaching equal
quality with FEWER RAYS. An edge-avoiding
à-trous wavelet filter (Dammertz et al. 2010) with the SVGF-style
variance-normalized luminance weight (Schied et al. 2017) over the
linear HDR accumulation, guided by primary-hit AOVs (albedo, shading
normal, depth), buys a several-fold sample-count reduction at equal
perceptual quality on diffuse-dominated scenes.

Parity is sacred: the default output path (``Renderer.image()`` /
``save_png`` without arguments) never calls anything here — the filter
is reachable only through explicit ``denoise=True`` arguments or the
CLI ``--denoise`` flag, and it operates on a *copy* of the accumulation
buffer after rendering, so accumulation itself stays bit-identical.

Everything is plain jnp on (H, W) images: 25 static-offset taps per
level over edge-replicated pads — XLA fuses the whole level into a few
elementwise kernels, and at 512² the full 5-level filter is ~1 ms of
device time (measured: small next to one render chunk).

AOV guides come from UNJITTERED pinhole center rays (like the debug
views, pt_debug.wgsl:305-344 / debug/modes.py) — with a wide aperture
the guides are sharper than the defocused image, so heavily defocused
regions keep slightly more noise (the luminance weight still smooths
them); documented limitation, not a correctness issue.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from wgpu_path_tracing_tpu.ops import shade as SHADE
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit

# 1D B3-spline kernel of the à-trous construction (Dammertz et al. §3).
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

# Demodulation floor: illumination = color / max(albedo_guide, this).
# Low enough that real albedos (>= ~0.02 for visible surfaces) pass
# through exactly; high enough that near-black surfaces do not blow the
# illumination signal (and its noise) up by orders of magnitude.
DEMOD_EPS = 0.02


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "intersector", "brute_max_tris",
                     "leaf_size", "slots_used", "lens_samples", "rng_mode"),
)
def primary_aovs(
    scene,
    cam,
    width: int,
    height: int,
    *,
    intersector: str = "auto",
    brute_max_tris: int = 512,
    leaf_size: int = 4,
    slots_used: tuple = (True, True, True, True),
    lens_samples: int = 0,
    rng_mode: str = "reference",
):
    """Primary-hit guide buffers.

    ``lens_samples == 0`` (default): pinhole center rays — sharp guides,
    exactly the debug-view basis (pt_debug.wgsl:305-344).

    ``lens_samples = K > 0``: the guides are
    AVERAGED over K jittered thin-lens primary rays drawn with the SAME
    seed schedule the render used (frames 0..K-1 of ``rng_mode``), so
    under a wide aperture they carry the lens blur the accumulation
    itself has — pinhole guides are sharper than the defocused image and
    freeze bokeh noise in place (the measured config-8 limitation). The
    mean normal is renormalized to the average orientation (an
    unnormalized mean would shrink the n·n edge weight and BLOCK
    smoothing exactly where defocus wants it); depth averages over the
    samples that hit; ``found`` is the majority vote of lens coverage.

    Returns a dict of row-major (N = width*height) arrays:
      ``albedo`` (N, 3) — textured base color plus emission*strength (so
      emissive pixels demodulate to ~unit illumination like lit ones),
      ``normal`` (N, 3) — shading normal (normal-mapped, like the main
      path), zero on misses,
      ``depth`` (N,) — hit distance t, 0 on misses,
      ``found`` (N,) bool.
    Reuses the production intersector selection and hit-attribute stage
    (ops/intersect.py / ops/shade.py), so guides see exactly the
    geometry/materials the render saw.
    """
    closest_hit = make_closest_hit(scene, intersector, brute_max_tris,
                                   leaf_size)

    def attrs_of(ro, rd):
        t, idx = closest_hit(ro.T, rd.T)
        hit = SHADE.hit_attributes(scene, ro, rd, t, idx,
                                   slots_used=slots_used)
        f = hit.found
        alb = jnp.stack(
            [
                hit.albedo.x + hit.emission.x * hit.emissive_strength,
                hit.albedo.y + hit.emission.y * hit.emissive_strength,
                hit.albedo.z + hit.emission.z * hit.emissive_strength,
            ],
            axis=-1,
        )
        nrm = jnp.stack([hit.normal.x, hit.normal.y, hit.normal.z], axis=-1)
        return f, alb, nrm, hit.t

    if lens_samples <= 0:
        from wgpu_path_tracing_tpu.debug.modes import _center_rays

        ro, rd = _center_rays(cam, width, height)
        f, alb, nrm, t = attrs_of(ro, rd)
        return {
            "albedo": jnp.where(f[:, None], alb, 1.0),
            "normal": jnp.where(f[:, None], nrm, 0.0),
            "depth": jnp.where(f, t, 0.0),
            "found": f,
        }

    from wgpu_path_tracing_tpu.ops import camera_rays as CAM

    x, y = CAM.pixel_grid(width, height)
    n = x.shape[0]

    def step(carry, k):
        s_alb, s_nrm, s_dep, s_hits = carry
        ro, rd, _ = CAM.generate_rays(cam, x, y, k, use_dof=True,
                                      rng_mode=rng_mode)
        f, alb, nrm, t = attrs_of(ro, rd)
        fm = f[:, None]
        s_alb = s_alb + jnp.where(fm, alb, 1.0)  # misses: white (demod no-op)
        s_nrm = s_nrm + jnp.where(fm, nrm, 0.0)
        s_dep = s_dep + jnp.where(f, t, 0.0)
        s_hits = s_hits + f.astype(jnp.float32)
        return (s_alb, s_nrm, s_dep, s_hits), None

    init = (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n, 3), jnp.float32),
            jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32))
    (s_alb, s_nrm, s_dep, s_hits), _ = jax.lax.scan(
        step, init, jnp.arange(lens_samples, dtype=jnp.int32))
    ks = jnp.float32(lens_samples)
    hits = jnp.maximum(s_hits, 1.0)
    nrm_mean = s_nrm / hits[:, None]
    nlen = jnp.sqrt(jnp.sum(nrm_mean * nrm_mean, axis=-1, keepdims=True))
    nrm_unit = jnp.where(nlen > 1e-6, nrm_mean / jnp.maximum(nlen, 1e-6),
                         0.0)
    found = s_hits * 2.0 > ks  # majority lens coverage
    return {
        "albedo": s_alb / ks,
        "normal": jnp.where(found[:, None], nrm_unit, 0.0),
        "depth": jnp.where(found, s_dep / hits, 0.0),
        "found": found,
    }


def _pad2(img, p):
    """Edge-replicate pad of the two leading (H, W) axes."""
    cfg = [(p, p), (p, p)] + [(0, 0)] * (img.ndim - 2)
    return jnp.pad(img, cfg, mode="edge")


def _luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


@functools.partial(
    jax.jit, static_argnames=("levels", "sigma_normal", "sigma_depth",
                              "sigma_lum"))
def atrous_filter(
    color,
    normal,
    depth,
    found,
    *,
    levels: int = 5,
    sigma_normal: float = 128.0,
    sigma_depth: float = 1.0,
    sigma_lum: float = 4.0,
):
    """Edge-avoiding à-trous filter of a linear (H, W, 3) image.

    Per level ``i`` the 5×5 B3 stencil is dilated to spacing 2**i
    (Dammertz et al. 2010); tap weights stop at edges:

    * normal:   max(0, n_p · n_q) ** sigma_normal            (SVGF eq. 4)
    * depth:    exp(-(Δz / (sigma_depth · max(z_p, z_q)))²)  (relative —
                scale-free, no depth-gradient buffer needed)
    * luminance exp(-|l_p − l_q| / (sigma_lum · sqrt(var_p) + 1e-4))
                with var estimated spatially (3×3 moments, SVGF §4.2's
                no-history fallback) and propagated through levels with
                squared weights (SVGF eq. 5)
    * segment:  found_p == found_q (misses never mix with hits; the
                miss segment carries no normal/depth edges so it smooths
                freely — matters only with env maps, parity miss=black).

    Returns the filtered image, same shape/dtype discipline as input.
    """
    h_k = jnp.asarray(np.outer(_B3, _B3), jnp.float32)  # (5, 5)

    lum = _luminance(color)
    # Spatial variance estimate: 3×3 first/second moments of luminance.
    ones = jnp.ones((3, 3), jnp.float32) / 9.0
    lp = _pad2(lum, 1)
    m1 = jnp.zeros_like(lum)
    m2 = jnp.zeros_like(lum)
    H, W = lum.shape
    for dy in range(3):
        for dx in range(3):
            sl = lp[dy:dy + H, dx:dx + W]
            m1 = m1 + ones[dy, dx] * sl
            m2 = m2 + ones[dy, dx] * sl * sl
    var = jnp.maximum(m2 - m1 * m1, 0.0)

    out = color
    for i in range(levels):
        step = 1 << i
        p = 2 * step
        cp = _pad2(out, p)
        np_ = _pad2(normal, p)
        zp = _pad2(depth, p)
        fp = _pad2(found, p)
        vp = _pad2(var, p)
        lum_c = _luminance(out)
        sig_l = sigma_lum * jnp.sqrt(var) + 1e-4

        acc = jnp.zeros_like(out)
        acc_v = jnp.zeros_like(var)
        wsum = jnp.zeros_like(lum_c)
        for ty in range(5):
            for tx in range(5):
                oy = p + (ty - 2) * step
                ox = p + (tx - 2) * step
                cq = cp[oy:oy + H, ox:ox + W]
                nq = np_[oy:oy + H, ox:ox + W]
                zq = zp[oy:oy + H, ox:ox + W]
                fq = fp[oy:oy + H, ox:ox + W]
                vq = vp[oy:oy + H, ox:ox + W]

                ndot = jnp.maximum(jnp.sum(normal * nq, axis=-1), 0.0)
                w_n = ndot ** sigma_normal
                zmax = jnp.maximum(jnp.maximum(depth, zq), 1e-4)
                dz = (depth - zq) / (sigma_depth * zmax)
                w_z = jnp.exp(-dz * dz)
                dl = jnp.abs(lum_c - _luminance(cq))
                w_l = jnp.exp(-dl / sig_l)
                w_seg = (found == fq).astype(jnp.float32)
                # Within the miss segment normals are zero (w_n would be
                # 0**sigma = 0): let misses smooth freely among
                # themselves instead.
                both_miss = jnp.logical_and(~found, ~fq)
                w_edge = jnp.where(both_miss, 1.0, w_n * w_z)
                w = h_k[ty, tx] * w_seg * w_edge * w_l

                acc = acc + w[..., None] * cq
                acc_v = acc_v + w * w * vq
                wsum = wsum + w
        out = acc / jnp.maximum(wsum, 1e-8)[..., None]
        var = acc_v / jnp.maximum(wsum * wsum, 1e-12)
    return out


@jax.jit
def variance_blend(raw, filt, strength=1.0, k_cap=1.0):
    """Per-pixel raw/filtered blend weight.

    The filter carries a ~0.017-RMSE bias floor, so raw accumulation
    overtakes it past ~512 spp — a preview-only denoiser. The
    MSE-motivated fix: blend ``out = filt + k*(raw - filt)`` with
    k = bias^2 / (bias^2 + sigma^2) per pixel, estimating
      sigma^2 — the raw estimate's noise — by the 3x3 spatial luminance
        variance of the raw image (the same SVGF no-history estimator
        atrous_filter seeds from; it shrinks ~1/spp as accumulation
        converges),
      bias^2  — the filter's systematic error — by
        max(smoothed (lum(filt)-lum(raw))^2 - sigma^2, 0)
        (E[(filt-raw)^2] ~ bias^2 + sigma^2).
    So k = clip(1 - strength*sigma^2/d^2, 0, k_cap): low spp ->
    d^2 ~ sigma^2 -> k~0 (trust the filter); high spp -> sigma^2 -> 0,
    d^2 -> bias^2 -> k~1 (trust raw). ``k_cap`` (callers pass
    spp/(spp+128) when spp is known) bounds k where the 3x3 spatial
    sigma estimator is unreliable — at low spp the DoF noise is
    heavy-tailed and sigma^2 biases LOW, overtrusting raw. On-chip
    sweep (cornell ap25, vs 2048-spp golden, round 5):
      spp    raw     filter-only  blend(cap128)
      16     .0763   .0174        .0184
      64     .0436   .0125        .0129
      256    .0220   .0107        .0098
      1024   .0086   .0099 (LOSES to raw)  .0082 (wins)
    — the filter's bias floor no longer loses past ~512 spp, at ~6% RMSE
    cost at 16 spp. strength>1 variants REJECTED: c=2/4 lose to raw at
    1024 spp (.0087/.0091 vs .0086). Returns the blended image.
    """
    H, W = raw.shape[0], raw.shape[1]
    lr = _luminance(raw)
    lf = _luminance(filt)
    ones = jnp.ones((3, 3), jnp.float32) / 9.0
    lp = _pad2(lr, 1)
    dp = _pad2((lf - lr) * (lf - lr), 1)
    m1 = jnp.zeros_like(lr)
    m2 = jnp.zeros_like(lr)
    d2 = jnp.zeros_like(lr)
    for dy in range(3):
        for dx in range(3):
            sl = lp[dy:dy + H, dx:dx + W]
            m1 = m1 + ones[dy, dx] * sl
            m2 = m2 + ones[dy, dx] * sl * sl
            d2 = d2 + ones[dy, dx] * dp[dy:dy + H, dx:dx + W]
    var = jnp.maximum(m2 - m1 * m1, 0.0)
    k = jnp.clip(1.0 - strength * var / jnp.maximum(d2, 1e-12), 0.0, k_cap)
    return filt + k[..., None] * (raw - filt)


def denoise_image(
    color_hwc: np.ndarray,
    aovs: dict,
    *,
    levels: int = 5,
    sigma_normal: float = 128.0,
    sigma_depth: float = 1.0,
    sigma_lum: float = 4.0,
    blend: bool = True,
    spp: int | None = None,
) -> np.ndarray:
    """Denoise a linear HDR (H, W, 3) buffer using primary-hit guides.

    Albedo-demodulated filtering: illumination = color / max(albedo,
    DEMOD_EPS) is filtered (texture detail is in the guide, not the
    signal), then remodulated — so albedo/texture edges survive even
    where the other guides are flat. ``blend`` (default on, round 5)
    applies the per-pixel variance-guided raw/filtered mix
    (variance_blend) so converged regions fall back to raw and the
    filter's bias floor no longer loses to raw accumulation at high spp;
    pass ``spp`` (Renderer.denoise does) to cap the raw weight by
    spp/(spp+128) where the spatial noise estimator is unreliable.
    """
    H, W, _ = color_hwc.shape
    alb = np.asarray(aovs["albedo"], np.float32).reshape(H, W, 3)
    nrm = jnp.asarray(np.asarray(aovs["normal"],
                                 np.float32).reshape(H, W, 3))
    dep = jnp.asarray(np.asarray(aovs["depth"], np.float32).reshape(H, W))
    fnd = jnp.asarray(np.asarray(aovs["found"], bool).reshape(H, W))
    guide = np.maximum(alb, DEMOD_EPS)
    raw = jnp.asarray(color_hwc.astype(np.float32))
    illum = raw / guide
    filt = atrous_filter(
        illum, nrm, dep, fnd,
        levels=levels, sigma_normal=sigma_normal,
        sigma_depth=sigma_depth, sigma_lum=sigma_lum,
    ) * guide
    if blend:
        k_cap = 1.0 if not spp else spp / (spp + 128.0)
        filt = variance_blend(raw, filt, 1.0, k_cap)
    return np.asarray(filt)
