"""Statistical validation of the sampling machinery (SURVEY §7: PDF
chi-square class of tests). The oracle suite proves bit-parity with the
reference; these tests prove the sampling DISTRIBUTIONS are
self-consistent — the claimed pdf matches the empirical density and
Monte-Carlo estimators converge to the analytic answer, which bit-parity
alone cannot show (a wrong-but-faithfully-transcribed pdf would pass
parity). Deterministic RNG (fixed seeds), so thresholds are exact
reruns, not flaky bounds.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from wgpu_path_tracing_tpu.ops import bsdf as BSDF
from wgpu_path_tracing_tpu.ops import rng as RNG
from wgpu_path_tracing_tpu.ops import vec
from wgpu_path_tracing_tpu.ops.shade import Hit
from wgpu_path_tracing_tpu.ops.vec import V3

N = 1 << 16


def _const(v):
    return jnp.full((N,), v, jnp.float32)


def _v3(x, y, z):
    return V3(_const(x), _const(y), _const(z))


def _diffuse_hit(albedo=(0.6, 0.5, 0.4), roughness=0.5):
    z = _const(0.0)
    return Hit(
        t=_const(1.0), found=jnp.ones((N,), bool),
        position=_v3(0, 0, 0), normal=_v3(0, 0, 1),
        albedo=_v3(*albedo), alpha=_const(1.0),
        roughness=_const(roughness), metallic=z, transmission=z,
        ior=_const(1.5), emission=_v3(0, 0, 0),
        emissive_strength=_const(1.0), uv_u=z, uv_v=z,
        is_front=jnp.ones((N,), bool),
    )


def _states(seed=123):
    return RNG.seed_pixel(
        jnp.arange(N, dtype=jnp.uint32) % 1000,
        jnp.arange(N, dtype=jnp.uint32) // 1000,
        jnp.uint32(seed),
    )


def test_diffuse_sampling_is_cosine_weighted():
    """The diffuse lobe claims pdf = cos(theta)/pi (pt.wgsl:505-516 via
    eval_bsdf); the empirical cos(theta) histogram must match it."""
    hit = _diffuse_hit()
    state = _states()
    mask = jnp.ones((N,), bool)
    rd = _v3(0, 0, -1)  # looking straight down onto the +z surface
    d, _ = BSDF.sample_bsdf(hit, rd, hit.is_front, state, mask)
    ct = np.asarray(vec.dot(vec.normalize(d), V3(*_v3(0, 0, 1))))
    assert (ct > 0).all()  # never below the surface
    # P(cos_theta <= c) = c^2 for cosine-weighted sampling.
    for c in (0.25, 0.5, 0.75):
        emp = (ct <= c).mean()
        assert abs(emp - c * c) < 0.01, (c, emp)


def test_diffuse_pdf_normalization():
    """The claimed diffuse pdf must integrate to 1 over the hemisphere:
    with directions drawn FROM that pdf, E[1/pdf] = solid angle measure
    recovered = 2*pi only if pdf = cos/pi is both the sampler's true
    density and correctly reported by eval_bsdf. (A furnace on the full
    BSDF is not analytic here — the reference's dielectric keeps a 0.04
    Fresnel specular even at metallic 0.)"""
    hit = _diffuse_hit(albedo=(0.7, 0.7, 0.7))
    state = _states(7)
    mask = jnp.ones((N,), bool)
    rd = _v3(0.0, 0.0, -1.0)
    d, _ = BSDF.sample_bsdf(hit, rd, hit.is_front, state, mask)
    v = V3(*_v3(0, 0, 1))  # -normalize(rd)
    f, pdf = BSDF.eval_bsdf(hit, hit.normal, v, d, hit.is_front)
    got = float(np.asarray(1.0 / jnp.maximum(pdf, 1e-6)).mean())
    assert abs(got - 2.0 * np.pi) < 0.06, got
    # And the reference's bsdf/pdf throughput ratio (pt.wgsl:696) stays
    # close to the albedo: (1-F)*albedo + sampled dielectric specular.
    ratio = float(np.asarray(f.x / jnp.maximum(pdf, 1e-6)).mean())
    assert 0.6 < ratio < 0.85, ratio


def test_rng_uniformity():
    """rand() draws are uniform on [0, 1): mean 1/2, var 1/12, and no
    bin of a 16-bucket histogram deviates more than 3%."""
    state = _states(42)
    u1, state = RNG.rand(state)
    u2, _ = RNG.rand(state)
    u = np.concatenate([np.asarray(u1), np.asarray(u2)])
    assert abs(u.mean() - 0.5) < 0.005
    assert abs(u.var() - 1.0 / 12.0) < 0.002
    hist, _ = np.histogram(u, bins=16, range=(0.0, 1.0))
    assert (np.abs(hist / len(u) - 1 / 16) < 0.03 / 16 * 16).all()


def test_ggx_half_vector_concentration():
    """Lower roughness concentrates sampled metallic lobes around the
    reflection direction — sanity on the GGX alpha wiring (a swapped
    roughness would invert this ordering)."""
    state = _states(3)
    mask = jnp.ones((N,), bool)
    rd = _v3(0, 0, -1)
    means = []
    for rough in (0.1, 0.9):
        z = _const(0.0)
        hit = _diffuse_hit(roughness=rough)._replace(
            metallic=_const(1.0), transmission=z
        )
        d, _ = BSDF.sample_bsdf(hit, rd, hit.is_front, state, mask)
        ct = np.asarray(vec.dot(vec.normalize(d), V3(*_v3(0, 0, 1))))
        means.append(ct.mean())
    assert means[0] > means[1] + 0.2, means


def test_r2_stratified_sequence():
    """The "stratified" rng mode's R2 point set: values live in [0, 1),
    per-frame steps follow the R2 additive constants, per-pixel rotations
    decorrelate neighbors, and the frame-average of the jitter converges
    faster than the reference PCG stream (the property the mode exists
    for). Deterministic (hash rotations are fixed), so exact thresholds."""
    x = jnp.arange(8, dtype=jnp.int32)
    y = jnp.arange(8, dtype=jnp.int32) * 3
    pts = np.array(
        [np.stack(RNG.r2_point(x, y, jnp.int32(f), stream=1))
         for f in range(256)]
    )  # (frames, 2, pixels)
    assert (pts >= 0.0).all() and (pts < 1.0).all()
    # Consecutive-frame steps are the R2 constants (mod 1, to f32 ulps).
    du = (pts[1:, 0] - pts[:-1, 0]) % 1.0
    dv = (pts[1:, 1] - pts[:-1, 1]) % 1.0
    assert np.abs(du - RNG.R2_A1).max() < 1e-4
    assert np.abs(dv - RNG.R2_A2).max() < 1e-4
    # Rotations differ across pixels (no global sequence sharing).
    assert len(np.unique(pts[0, 0].round(6))) == 8
    # Faster convergence of the frame-mean than independent PCG draws.
    err_r2 = np.abs(pts.mean(axis=0) - 0.5).max()
    pcg = []
    for f in range(256):
        st = RNG.seed_pixel(x, y, jnp.int32(f))
        u, st = RNG.rand(st)
        v, _ = RNG.rand(st)
        pcg.append(np.stack([np.asarray(u), np.asarray(v)]))
    err_pcg = np.abs(np.mean(pcg, axis=0) - 0.5).max()
    assert err_r2 < err_pcg / 2.0, (err_r2, err_pcg)


def test_stratified_mode_renders():
    """rng="stratified" end-to-end: runs, NaN-free, actually changes the
    image vs reference parity mode (same scene/camera), and the DEFAULT
    mode's image is untouched by the feature (parity is sacred)."""
    from wgpu_path_tracing_tpu import Renderer, RenderConfig, cornell_box

    imgs = {}
    for mode in ("reference", "stratified"):
        r = Renderer(RenderConfig(width=16, height=16, frames_per_chunk=4,
                                  rng=mode))
        r.load_scene(cornell_box())
        imgs[mode] = r.render(spp=4)
        assert not np.isnan(imgs[mode]).any()
    assert np.abs(imgs["reference"] - imgs["stratified"]).max() > 0.0


def test_bounce0_lds_override():
    """The bounce-0 low-discrepancy extension (rng="stratified" +
    CAM.TRACE_BOUNCE0_LDS): draw values live in [0, 1), the override
    changes the stratified image (it engages), is deterministic, and the
    parity modes never build it (trace_fn.lds_active False)."""
    import jax

    from wgpu_path_tracing_tpu import Renderer, RenderConfig, cornell_box
    from wgpu_path_tracing_tpu.ops import camera_rays as CAM

    x = jnp.arange(64, dtype=jnp.int32)
    y = jnp.arange(64, dtype=jnp.int32) * 7
    for f in (0, 3, 1000):
        lds = np.asarray(CAM.bounce0_lds(x, y, jnp.int32(f)))
        assert lds.shape == (3, 64)
        assert (lds >= 0.0).all() and (lds < 1.0).all()
    # Consecutive frames step the lobe dimension by the golden ratio.
    l0 = np.asarray(CAM.bounce0_lds(x, y, jnp.int32(0)))[0]
    l1 = np.asarray(CAM.bounce0_lds(x, y, jnp.int32(1)))[0]
    assert np.abs((l1 - l0) % 1.0 - CAM._PHI1).max() < 1e-4

    def render(mode):
        r = Renderer(RenderConfig(width=16, height=16, frames_per_chunk=4,
                                  rng=mode))
        r.load_scene(cornell_box())
        return r.render(spp=4)

    on1 = render("stratified")
    on2 = render("stratified")
    np.testing.assert_array_equal(on1, on2)  # deterministic
    saved = CAM.TRACE_BOUNCE0_LDS
    try:
        CAM.TRACE_BOUNCE0_LDS = False
        jax.clear_caches()  # module-global knob: drop traced programs
        off = render("stratified")
    finally:
        CAM.TRACE_BOUNCE0_LDS = saved
        jax.clear_caches()
    assert np.abs(on1 - off).max() > 0.0  # the override engaged
