"""Multi-device sharding: the sharded renderer must equal the
single-device renderer (rows use global RNG seeds; sample-axis frames
partition exactly).

Buffers live in tile-coherent lane order on device (utils/tiling.py); both
sides are converted to row-major before comparison. The 64x64 image size
makes the tile permutation non-trivial for every mesh shape tested.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wgpu_path_tracing_tpu.models.procedural import cornell_box
from wgpu_path_tracing_tpu.models.types import pack_device_scene
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu.parallel import shard as SH
from wgpu_path_tracing_tpu.render import pipeline
from wgpu_path_tracing_tpu.render.camera import Camera
from wgpu_path_tracing_tpu.utils.tiling import inverse_permutation, tile_permutation

WIDTH = HEIGHT = 64
SPP = 4


def _row_major_single(buf):
    inv = inverse_permutation(tile_permutation(WIDTH, HEIGHT))
    return np.asarray(buf)[inv]


@pytest.fixture(scope="module")
def setup():
    scene = cornell_box()
    dev = pack_device_scene(scene)
    cam = pipeline.camera_device(
        Camera(width=WIDTH, height=HEIGHT).as_pytree(), WIDTH, HEIGHT
    )
    kwargs = dict(
        n_frames=SPP,
        width=WIDTH,
        height=HEIGHT,
        use_dof=True,
        rng_mode="reference",
        max_bounces=8,
        do_mis=True,
        num_lights=scene.num_lights,
        firefly_clamp=2.5,
        intersector="brute",
        brute_max_tris=512,
        leaf_size=4,
    )
    accum0 = jnp.zeros((WIDTH * HEIGHT, 3), jnp.float32)
    ref, ref_counters = pipeline.render_chunk(
        dev, cam, accum0, jnp.int32(0), **kwargs
    )
    return scene, dev, cam, kwargs, _row_major_single(ref), np.asarray(ref_counters)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (1, 1)])
def test_sharded_matches_single_chip(setup, mesh_shape):
    scene, dev, cam, kwargs, ref_rm, ref_counters = setup
    s, r = mesh_shape
    if s * r > len(jax.devices()):
        pytest.skip("not enough devices")
    mesh = SH.make_mesh(jax.devices()[: s * r], sample_shards=s)

    scene_rep = SH.replicate_scene(dev, mesh)
    accum = SH.shard_accum(jnp.zeros((WIDTH * HEIGHT, 3), jnp.float32), mesh)
    out, counters = SH.render_chunk_sharded(
        scene_rep, cam, accum, jnp.int32(0), mesh=mesh, **kwargs
    )
    out_rm = SH.untile_image(
        SH.gather_image(out), WIDTH, HEIGHT, mesh.shape["row"]
    )

    # Same frames, same seeds -> same image up to f32 summation order.
    np.testing.assert_allclose(out_rm, ref_rm, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(counters), ref_counters)


def test_sharded_frames_per_trace(setup):
    """frames_per_trace on the sharded path: batching F local frames into
    one trace call keeps the RNG schedule, so the image matches F=1 up to
    the documented FMA-placement ulps (traced shapes differ) and the ray
    counters match exactly (full-weight chunk)."""
    scene, dev, cam, kwargs, ref_rm, ref_counters = setup
    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    mesh = SH.make_mesh(jax.devices()[:4], sample_shards=2)
    scene_rep = SH.replicate_scene(dev, mesh)

    outs = {}
    for fpt in (1, 2):
        accum = SH.shard_accum(
            jnp.zeros((WIDTH * HEIGHT, 3), jnp.float32), mesh
        )
        out, counters = SH.render_chunk_sharded(
            scene_rep, cam, accum, jnp.int32(0), mesh=mesh,
            frames_per_trace=fpt, **kwargs
        )
        outs[fpt] = SH.untile_image(
            SH.gather_image(out), WIDTH, HEIGHT, mesh.shape["row"]
        )
        np.testing.assert_array_equal(np.asarray(counters), ref_counters)
    np.testing.assert_allclose(outs[2], outs[1], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def large_setup():
    """A scene past the dense gate (852 tris): "auto" takes the
    threaded-BVH walk, rendered single-device as the reference."""
    scene = cornell_box(tessellation=5)
    dev = pack_device_scene(scene)
    w, h = 32, 16
    cam = pipeline.camera_device(Camera(width=w, height=h).as_pytree(), w, h)
    kwargs = dict(
        n_frames=4, width=w, height=h, use_dof=True, rng_mode="reference",
        max_bounces=4, do_mis=True, num_lights=scene.num_lights,
        firefly_clamp=2.5, intersector="auto", brute_max_tris=512,
        leaf_size=4,
    )
    ch = make_closest_hit(dev, "auto", 512, 4)
    assert ch.strategy == "bvh_xla"
    ref, ref_counters = pipeline.render_chunk(
        dev, cam, jnp.zeros((w * h, 3), jnp.float32), jnp.int32(0), **kwargs)
    inv = inverse_permutation(tile_permutation(w, h))
    return dev, cam, kwargs, np.asarray(ref)[inv], np.asarray(ref_counters)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 4)])
def test_sharded_large_scene_matches_single(large_setup, mesh_shape):
    """The large-scene path (threaded-BVH walk) under shard_map equals the
    single-device render of the same frames and seeds."""
    dev, cam, kwargs, ref_rm, ref_counters = large_setup
    s, r = mesh_shape
    if s * r > len(jax.devices()):
        pytest.skip("not enough devices")
    mesh = SH.make_mesh(jax.devices()[: s * r], sample_shards=s)
    w, h = kwargs["width"], kwargs["height"]
    accum = SH.shard_accum(jnp.zeros((w * h, 3), jnp.float32), mesh)
    out, counters = SH.render_chunk_sharded(
        SH.replicate_scene(dev, mesh), cam, accum, jnp.int32(0), mesh=mesh,
        **kwargs)
    out_rm = SH.untile_image(SH.gather_image(out), w, h, mesh.shape["row"])
    np.testing.assert_allclose(out_rm, ref_rm, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(counters), ref_counters)


def test_renderer_multichip_surface():
    """Renderer(devices=...) end-to-end: multi-chip render equals
    single-chip render through the public API."""
    from wgpu_path_tracing_tpu import Renderer, RenderConfig

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    cfg = dict(width=WIDTH, height=HEIGHT, frames_per_chunk=4)
    r1 = Renderer(RenderConfig(**cfg))
    r1.load_scene(cornell_box())
    single = r1.render(spp=4)

    r8 = Renderer(RenderConfig(**cfg), devices=jax.devices())
    r8.load_scene(cornell_box())
    multi = r8.render(spp=4)

    np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)
    # image() and checkpoints work in sharded mode too
    img = r8.image()
    assert img.shape == (HEIGHT, WIDTH, 3)
    assert np.isfinite(img).all()
    # The denoiser extension works on a sharded renderer too (the AOV
    # pass runs single-device from the replicated scene copy) and
    # matches the single-chip denoise of the same accumulation.
    dn8 = r8.image(denoise=True)
    dn1 = r1.image(denoise=True)
    assert np.isfinite(dn8).all()
    np.testing.assert_allclose(dn8, dn1, rtol=1e-4, atol=1e-5)


def test_renderer_multichip_env():
    """The env-lighting extension replicates like any scene table: the
    sharded render with a map equals the single-chip render."""
    from wgpu_path_tracing_tpu import Renderer, RenderConfig
    from wgpu_path_tracing_tpu.models.procedural import material_test_box

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    env = np.zeros((4, 8, 3), np.float32)
    env[:2] = [0.3, 0.5, 0.9]
    env[2:] = [0.1, 0.08, 0.05]
    cfg = dict(width=WIDTH, height=HEIGHT, frames_per_chunk=4,
               max_bounces=3)
    r1 = Renderer(RenderConfig(**cfg))
    r1.load_scene(material_test_box())
    r1.set_environment(env)
    single = r1.render(spp=4)

    r8 = Renderer(RenderConfig(**cfg), devices=jax.devices())
    r8.load_scene(material_test_box())
    r8.set_environment(env)
    multi = r8.render(spp=4)
    np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)
    assert multi.sum() > 0


def test_renderer_multichip_checkpoint(tmp_path):
    from wgpu_path_tracing_tpu import Renderer, RenderConfig

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    cfg = dict(width=WIDTH, height=HEIGHT, frames_per_chunk=4)
    r8 = Renderer(RenderConfig(**cfg), devices=jax.devices())
    r8.load_scene(cornell_box())
    r8.render(spp=4)
    ck = str(tmp_path / "mc.npz")
    r8.save_checkpoint(ck)
    full = r8.render(spp=4)

    r2 = Renderer(RenderConfig(**cfg), devices=jax.devices())
    r2.load_scene(cornell_box())
    r2.load_checkpoint(ck)
    resumed = r2.render(spp=4)
    np.testing.assert_allclose(resumed, full, rtol=1e-5, atol=1e-6)


def test_sharded_accumulation_across_chunks(setup):
    scene, dev, cam, kwargs, _, _ = setup
    mesh = SH.make_mesh(jax.devices(), sample_shards=2)
    scene_rep = SH.replicate_scene(dev, mesh)
    accum = SH.shard_accum(jnp.zeros((WIDTH * HEIGHT, 3), jnp.float32), mesh)

    # Two chunks of SPP frames == one single-chip pass of 2*SPP frames.
    out, _ = SH.render_chunk_sharded(
        scene_rep, cam, accum, jnp.int32(0), mesh=mesh, **kwargs
    )
    out, _ = SH.render_chunk_sharded(
        scene_rep, cam, out, jnp.int32(SPP), mesh=mesh, **kwargs
    )
    out_rm = SH.untile_image(
        SH.gather_image(out), WIDTH, HEIGHT, mesh.shape["row"]
    )

    kwargs2 = dict(kwargs, n_frames=2 * SPP)
    ref2, _ = pipeline.render_chunk(
        dev, cam, jnp.zeros((WIDTH * HEIGHT, 3), jnp.float32), jnp.int32(0), **kwargs2
    )
    np.testing.assert_allclose(out_rm, _row_major_single(ref2), rtol=1e-4, atol=1e-5)


def test_renderer_multichip_exact_spp():
    """render(spp) must accumulate EXACTLY spp frames even when spp is not a
    multiple of the sample axis (the padded tail frames are zero-weighted),
    and match the single-chip render of the same spp."""
    from wgpu_path_tracing_tpu import Renderer, RenderConfig

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    cfg = dict(width=WIDTH, height=HEIGHT, frames_per_chunk=4)
    r1 = Renderer(RenderConfig(**cfg))
    r1.load_scene(cornell_box())
    single = r1.render(spp=3)
    assert r1.frame_index == 3

    r8 = Renderer(RenderConfig(**cfg), devices=jax.devices())  # sample=2
    r8.load_scene(cornell_box())
    multi = r8.render(spp=3)
    assert r8.mesh.shape["sample"] == 2
    assert r8.frame_index == 3
    np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)
    # Ray counters also count only the active frames.
    assert r8.stats()["rays_total"] == r1.stats()["rays_total"]
