"""Texture-atlas path tests.

None of the reference's surviving sample scenes carry textures (sponza.glb is
stripped), so the atlas sampling path needs synthetic coverage:

* device texture sampling (rect math, sign-preserving fmod wrap, fallbacks,
  normal-map conditional) against the scalar oracle with exact RNG parity,
* a synthetic GLB with an embedded PNG texture through the full
  load_model -> atlas build -> render pipeline.
"""

import base64
import io
import json
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wgpu_path_tracing_tpu.models.procedural import cornell_box
from wgpu_path_tracing_tpu.models.types import pack_device_scene
from wgpu_path_tracing_tpu.ops import camera_rays as CAM
from wgpu_path_tracing_tpu.ops import trace as TRACE
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu.render.camera import Camera
from wgpu_path_tracing_tpu.render.pipeline import camera_device

from tests.oracle import Oracle, trace_vs_oracle

WIDTH = HEIGHT = 16


from wgpu_path_tracing_tpu.models.procedural import textured_cornell as _textured_cornell  # noqa: E402


def test_textured_scene_matches_oracle():
    scene = _textured_cornell()
    camera = Camera(width=WIDTH, height=HEIGHT, aspect=1.0)
    cam_np = {
        "position": camera.position, "forward": camera.forward,
        "right": camera.right, "up": camera.up,
        "fov": np.float32(camera.fov), "aspect": np.float32(camera.aspect),
        "aperture": np.float32(camera.aperture),
        "focus_distance": np.float32(camera.focus_distance),
    }
    oracle = Oracle(scene, cam_np, WIDTH, HEIGHT)
    dev = jax.device_put(pack_device_scene(scene))
    cam_dev = camera_device(camera.as_pytree(), WIDTH, HEIGHT)

    x, y = CAM.pixel_grid(WIDTH, HEIGHT)
    ro, rd, state = CAM.generate_rays(cam_dev, x, y, jnp.int32(0), use_dof=True)
    ch = make_closest_hit(dev, "brute", 4096, 4)
    radiance, end_state, _ = TRACE.trace(
        dev, ch, ro, rd, state, max_bounces=8, do_mis=True,
        num_lights=scene.num_lights,
    )
    radiance = np.asarray(radiance)
    end_state = np.asarray(end_state)

    # Probe pixels avoid the known FMA-fusion razor edges: uv interpolation
    # fuses differently under XLA than the oracle's numpy (no-FMA) math, so
    # a checker-boundary texel can flip on ~1% of pixels (ulp class, same
    # as the documented RR/razor-tie divergences). Re-picked when the
    # rect-aliasing fix (models/assemble.py) changed which atlas regions
    # config-3 scenes actually sample.
    pixels = [(2, 2), (8, 8), (13, 4), (5, 12), (12, 12), (6, 10)]
    mismatched = 0
    for (px, py) in pixels:
        lane = py * WIDTH + px
        expected = oracle.render_pixel(px, py, 0)
        got = np.minimum(radiance[lane], 2.5)
        assert int(end_state[lane]) == int(oracle.rng.state), (px, py)
        if not np.allclose(got, expected, rtol=2e-3, atol=2e-3):
            mismatched += 1
    assert mismatched <= 1


def _png_bytes(rgb: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, "PNG")
    return buf.getvalue()


def _synthetic_textured_glb(path: str):
    """A single textured quad + emissive quad GLB with an embedded PNG."""
    tex = np.empty((8, 8, 3), np.uint8)
    tex[:] = (255, 64, 32)  # constant so the 0.5x bilinear downscale is exact
    png = _png_bytes(tex)

    pos = np.array(
        [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],  # floor quad
         [-0.5, 1.9, -0.5], [0.5, 1.9, -0.5], [0.5, 1.9, 0.5], [-0.5, 1.9, 0.5]],
        np.float32,
    )
    nrm = np.array([[0, 1, 0]] * 4 + [[0, -1, 0]] * 4, np.float32)
    uv = np.array(
        [[0, 0], [2, 0], [2, 2], [0, 2], [0, 0], [1, 0], [1, 1], [0, 1]],
        np.float32,
    )
    idx = np.array([0, 1, 2, 0, 2, 3, 4, 6, 5, 4, 7, 6], np.uint16)

    bin_parts = [pos.tobytes(), nrm.tobytes(), uv.tobytes(), idx.tobytes(), png]
    offsets, off = [], 0
    for p in bin_parts:
        offsets.append(off)
        off += len(p) + ((-len(p)) % 4)
    bin_data = b"".join(
        p + b"\x00" * ((-len(p)) % 4) for p in bin_parts
    )

    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{
            "primitives": [
                {"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                 "indices": 3, "material": 0},
                {"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                 "indices": 4, "material": 1},
            ]
        }],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 8, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 8, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 8, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"},
            {"bufferView": 3, "byteOffset": 12, "componentType": 5123,
             "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": offsets[0], "byteLength": len(bin_parts[0])},
            {"buffer": 0, "byteOffset": offsets[1], "byteLength": len(bin_parts[1])},
            {"buffer": 0, "byteOffset": offsets[2], "byteLength": len(bin_parts[2])},
            {"buffer": 0, "byteOffset": offsets[3], "byteLength": len(bin_parts[3])},
            {"buffer": 0, "byteOffset": offsets[4], "byteLength": len(bin_parts[4])},
        ],
        "images": [{"bufferView": 4, "mimeType": "image/png"}],
        "textures": [{"source": 0}],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicFactor": 0.0, "roughnessFactor": 1.0}},
            {"emissiveFactor": [1.0, 1.0, 1.0],
             "extensions": {"KHR_materials_emissive_strength":
                            {"emissiveStrength": 5.0}}},
        ],
        "buffers": [{"byteLength": len(bin_data)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_data)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(bin_data), 0x004E4942))
        f.write(bin_data)


def test_textured_glb_load_and_render(tmp_path):
    from wgpu_path_tracing_tpu import Renderer, RenderConfig
    from wgpu_path_tracing_tpu.models.gltf import load_model

    path = str(tmp_path / "textured.glb")
    _synthetic_textured_glb(path)
    scene = load_model(path, texture_pixel_ratio=0.5)
    assert scene.atlas is not None
    assert scene.num_triangles == 4
    # 8x8 texture at 0.5 ratio -> 4x4 rect in a pow2-square atlas
    assert tuple(scene.mat_albedo_rect[0][2:]) == (4, 4)
    assert scene.num_lights == 2  # emissive quad triangles
    # sRGB->linear happened on albedo (255 -> 1.0, 64 -> (64/255)^2.2-ish)
    rect = scene.mat_albedo_rect[0]
    texel = scene.atlas[rect[1], rect[0]]
    assert texel[0] > 0.9

    r = Renderer(RenderConfig(width=16, height=16, frames_per_chunk=2))
    r.load_scene(scene)
    buf = r.render(spp=2)
    assert np.isfinite(buf).all()
    assert buf.max() > 0


def test_slot_gating_hit_exact():
    """Scene-static texture-slot gating (models/types.py::texture_slots_used)
    is a semantic identity AT THE HIT LEVEL: a slot whose rects are all
    w == 0 samples its fallback exactly, so the gated Hit fields must be
    bit-equal to the ungated ones. (A full multi-bounce trace is NOT
    bit-stable under the rewrite — removing ops changes XLA fusion/FMA
    placement, the same documented class that reverted bounce-0 peeling —
    so the contract is checked where it is exact.)"""
    from wgpu_path_tracing_tpu.models.types import texture_slots_used
    from wgpu_path_tracing_tpu.ops import shade as SHADE
    from wgpu_path_tracing_tpu.ops import vec
    
    scene = pack_device_scene(_textured_cornell())
    slots = texture_slots_used(scene["tri_full"])
    # textured_cornell maps albedo + pbr + normal but NOT emissive — the
    # gate must actually engage for this test to mean anything.
    assert slots == (True, True, False, True)

    dev = jax.device_put(scene)
    n = 512
    rng = np.random.default_rng(2)
    nt = scene["tri_full"].shape[0]
    idx = jnp.asarray(rng.integers(0, nt, n).astype(np.int32))
    ro = jnp.asarray(rng.normal(size=(3, n)).astype(np.float32) * 0.3)
    rd3 = rng.normal(size=(3, n)).astype(np.float32)
    rd3 /= np.linalg.norm(rd3, axis=0, keepdims=True)
    rd = jnp.asarray(rd3)
    t = jnp.asarray(rng.uniform(0.5, 3.0, n).astype(np.float32))
    found = jnp.ones((n,), bool)

    def hit_fields(slots_used):
        @jax.jit
        def go():
            row = dev["tri_full"][idx]
            h = SHADE.hit_attributes_from_cols(
                lambda c: row[:, c], vec.from_cols(ro.T), vec.from_cols(rd.T),
                t, found, atlas=dev["atlas"], slots_used=slots_used,
            )
            return (h.albedo.x, h.albedo.y, h.albedo.z, h.alpha,
                    h.roughness, h.metallic, h.emission.x, h.emission.y,
                    h.emission.z, h.normal.x, h.normal.y, h.normal.z)

        return [np.asarray(a) for a in go()]

    all_on = hit_fields((True, True, True, True))
    gated = hit_fields(slots)
    for a, b in zip(all_on, gated):
        np.testing.assert_array_equal(a, b)


def test_fat_atlas_gates():
    """pack_device_scene bakes the fat-atlas canvas (models/types.py::
    _build_fat_atlas) for ARBITRARY map sets (LCM virtual rects) and
    refuses only on out-of-bounds rects and blown LCM / set-count budgets
    (per-slot path: keys absent)."""
    from wgpu_path_tracing_tpu.models.procedural import textured_cornell

    packed = pack_device_scene(
        textured_cornell(atlas_size=256, congruent=True))
    assert "atlas_fat" in packed and "atlas_fat_rects" in packed
    assert packed["atlas_fat"].ndim == 3
    assert packed["atlas_fat"].shape[2] == 16
    assert packed["atlas_fat_rects"].shape[1] == 20
    # mixed-resolution map set (albedo a/2, pbr a/4): LCM grid = a/2
    assert "atlas_fat" in pack_device_scene(
        textured_cornell(atlas_size=256))
    # NON-divisible map set (96 does not divide 128): LCM grid = 384 —
    # engages since the virtual-rect generalization
    sc_nd = textured_cornell(atlas_size=256)
    sc_nd.mat_pbr_rect[0] = [128, 0, 96, 96]
    assert "atlas_fat" in pack_device_scene(sc_nd)
    # coprime slot dims (255 vs 128) blow the LCM canvas budget
    # (lcm = 32640 per axis): per-slot fallback
    sc_big = textured_cornell(atlas_size=256, congruent=True)
    sc_big.mat_pbr_rect[0] = [0, 0, 255, 255]
    assert "atlas_fat" not in pack_device_scene(sc_big)
    # small atlases bake too, whatever their size
    assert "atlas_fat" in pack_device_scene(
        textured_cornell(atlas_size=32, congruent=True))
    assert "atlas_fat" in pack_device_scene(
        textured_cornell(atlas_size=128, congruent=True))
    # more distinct map sets than FAT_ATLAS_MAX_SETS: per-slot fallback
    import wgpu_path_tracing_tpu.models.types as MT
    saved = MT.FAT_ATLAS_MAX_SETS
    try:
        MT.FAT_ATLAS_MAX_SETS = 0
        assert "atlas_fat" not in pack_device_scene(
            textured_cornell(atlas_size=32, congruent=True))
    finally:
        MT.FAT_ATLAS_MAX_SETS = saved
    # NEGATIVE uvs bake since round 5: the set's grid doubles on the
    # negative axis and the backward band carries the texels the
    # sign-preserving %-wrap actually reads (neighboring rects/clamps) —
    # gate must BAKE, with the interior origin shifted into the box
    sc = textured_cornell(atlas_size=256, congruent=True)
    sc.tri_uv0[0] = [-0.25, 0.5]
    packed_neg = pack_device_scene(sc)
    assert "atlas_fat" in packed_neg
    rects = np.asarray(packed_neg["atlas_fat_rects"])
    # the extended set's interior origin sits >= its grid width into the
    # canvas (fx = box.x + lw), leaving room for the backward band
    assert (rects[:, 16] >= rects[:, 18]).any()
    # TILED (non-negative, past 1.0) uvs are fat-safe since round 4:
    # every sampler path reduces u to fmod(u, 1) before indexing, so the
    # per-slot and fat paths see the same wrapped fraction — gate bakes
    sc = textured_cornell(atlas_size=256, congruent=True)
    sc.tri_uv0[:] = np.asarray(sc.tri_uv0) * 3.0
    sc.tri_uv1[:] = np.asarray(sc.tri_uv1) * 3.0
    sc.tri_uv2[:] = np.asarray(sc.tri_uv2) * 3.0
    assert "atlas_fat" in pack_device_scene(sc)


def _assert_fat_matches_per_slot(packed, seed=7, tile=0, neg=False):
    """Shared check: on texel-center uvs (away from the fat path's
    documented texel-boundary ulp class) the fat row fetch must reproduce
    the per-slot sample_atlas values EXACTLY (same texels, same
    fallbacks) for all four slots. ``tile`` > 0 additionally offsets each
    uv by a random integer in [0, tile] — the wrapped fraction is exact
    (integer + pow2-denominator fraction subtracts exactly in f32), so
    tiled uvs must hit the identical texels."""
    from wgpu_path_tracing_tpu.ops import shade as SHADE
    
    assert "atlas_fat" in packed
    dev = jax.device_put(packed)
    n = 256
    rng = np.random.default_rng(seed)
    nt = packed["tri_full"].shape[0]
    idx = jnp.asarray(rng.integers(0, nt, n).astype(np.int32))
    # Texel-center uvs on a grid that is EXACT on every slot resolution
    # in play (multiples of all slot dims' common denominators is not
    # required — centers of a fine grid stay away from every boundary).
    uu = ((rng.integers(0, 128, n) + 0.5) / 128).astype(np.float32)
    vv = ((rng.integers(0, 128, n) + 0.5) / 128).astype(np.float32)
    if tile:
        lo = -tile if neg else 0
        uu = uu + rng.integers(lo, tile + 1, n).astype(np.float32)
        vv = vv + rng.integers(lo, tile + 1, n).astype(np.float32)
    uu = jnp.asarray(uu)
    vv = jnp.asarray(vv)

    @jax.jit
    def go():
        row = dev["tri_full"][idx]
        get = lambda c: row[:, c]
        quads_fat = SHADE.sample_atlas_fat(
            dev["atlas_fat"], dev["atlas_fat_rects"], get, uu, vv)
        quads_ref = []
        for k in range(4):
            rect = [get(SHADE.SLOT_RECT_COLS[k] + i) for i in range(4)]
            quads_ref.append(SHADE.sample_atlas(
                dev["atlas"], rect, uu, vv, SHADE.SLOT_FALLBACKS[k]))
        return quads_fat, quads_ref

    quads_fat, quads_ref = go()
    for k in range(4):
        for c in range(4):
            np.testing.assert_array_equal(
                np.asarray(quads_fat[k][c]), np.asarray(quads_ref[k][c]),
                err_msg=f"slot {k} channel {c}")


@pytest.mark.parametrize("congruent", [True, False],
                         ids=["congruent", "mixedres"])
def test_fat_atlas_values_match_per_slot(congruent):
    from wgpu_path_tracing_tpu.models.procedural import textured_cornell

    _assert_fat_matches_per_slot(pack_device_scene(
        textured_cornell(atlas_size=256, congruent=congruent)))


def test_fat_atlas_tiled_uvs_match_per_slot():
    """Tiled uvs (non-negative, past 1.0) ride the fat path since round 4:
    the %-wrap reduces every sampler's u to the same fraction, so the fat
    fetch must still pick the identical texels the per-slot path does."""
    from wgpu_path_tracing_tpu.models.procedural import textured_cornell

    sc = textured_cornell(atlas_size=256, congruent=True)
    for uv in (sc.tri_uv0, sc.tri_uv1, sc.tri_uv2):
        uv[:] = np.asarray(uv) * 3.0  # pure tiling, uvs in [0, 3]
    _assert_fat_matches_per_slot(pack_device_scene(sc), seed=13, tile=3)


def test_fat_atlas_negative_uvs_match_per_slot():
    """NEGATIVE uvs ride the fat path since round 5: the set's grid
    doubles on the negative axis and the backward band bakes the
    neighboring-rect/clamped texels the reference's sign-preserving
    %-wrap reads (pt.wgsl:115-116) — so on texel-center uvs offset by
    integers in [-3, 3] the fat fetch must reproduce the per-slot
    sample_atlas values EXACTLY, including reads that land in OTHER
    rects' texels and reads clamped at the atlas edge."""
    from wgpu_path_tracing_tpu.models.procedural import textured_cornell

    sc = textured_cornell(atlas_size=256, congruent=True)
    # Mark EVERY material negative-uv on both axes so every map set
    # extends (the test below pairs random uvs with random materials;
    # at runtime only extended sets can see negative fractions, by the
    # vertex-uv convexity argument in _build_fat_atlas's docstring).
    sc.tri_uv0[:] = np.asarray(sc.tri_uv0) - 1.0
    packed = pack_device_scene(sc)
    assert "atlas_fat" in packed
    _assert_fat_matches_per_slot(packed, seed=17, tile=3, neg=True)


def test_fat_atlas_negative_uv_one_axis():
    """Negative uvs on ONE axis extend only that axis of the grid."""
    from wgpu_path_tracing_tpu.models.procedural import textured_cornell

    sc = textured_cornell(atlas_size=256, congruent=True)
    # every material u-negative, v non-negative
    sc.tri_uv0[:] = np.asarray(sc.tri_uv0) - np.array([1.0, 0.0],
                                                      np.float32)
    packed = pack_device_scene(sc)
    assert "atlas_fat" in packed
    rng = np.random.default_rng(23)
    # negative offsets on u only (v must stay in the baked [0,1) band)
    from wgpu_path_tracing_tpu.ops import shade as SHADE
    
    dev = jax.device_put(packed)
    n = 256
    nt = packed["tri_full"].shape[0]
    idx = jnp.asarray(rng.integers(0, nt, n).astype(np.int32))
    uu = ((rng.integers(0, 128, n) + 0.5) / 128
          + rng.integers(-3, 1, n)).astype(np.float32)
    vv = ((rng.integers(0, 128, n) + 0.5) / 128
          + rng.integers(0, 4, n)).astype(np.float32)
    uu, vv = jnp.asarray(uu), jnp.asarray(vv)

    @jax.jit
    def go():
        row = dev["tri_full"][idx]
        get = lambda c: row[:, c]
        quads_fat = SHADE.sample_atlas_fat(
            dev["atlas_fat"], dev["atlas_fat_rects"], get, uu, vv)
        quads_ref = []
        for k in range(4):
            rect = [get(SHADE.SLOT_RECT_COLS[k] + i) for i in range(4)]
            quads_ref.append(SHADE.sample_atlas(
                dev["atlas"], rect, uu, vv, SHADE.SLOT_FALLBACKS[k]))
        return quads_fat, quads_ref

    quads_fat, quads_ref = go()
    for k in range(4):
        for c in range(4):
            np.testing.assert_array_equal(
                np.asarray(quads_fat[k][c]), np.asarray(quads_ref[k][c]),
                err_msg=f"slot {k} channel {c}")


def test_fat_atlas_nondivisible_lcm_grid():
    """A genuinely NON-divisible map set (96^2 pbr against 128^2 albedo)
    bakes onto the lcm(96,128)=384 virtual grid — values must still match
    the per-slot path exactly (the integer floor identity holds for every
    slot because each slot's dims divide the LCM's)."""
    from wgpu_path_tracing_tpu.models.procedural import textured_cornell

    sc = textured_cornell(atlas_size=256, congruent=True)
    sc.mat_pbr_rect[0] = [128, 0, 96, 96]
    _assert_fat_matches_per_slot(pack_device_scene(sc), seed=11)


def test_fat_atlas_larger_later_slot():
    """Heterogeneous slot sizes where a LATER slot is the largest (pbr
    128^2 over albedo 64^2) — the LCM grid covers both and values match
    the per-slot path exactly."""
    from wgpu_path_tracing_tpu.models.procedural import textured_cornell

    sc = textured_cornell(atlas_size=256, congruent=True)
    sc.mat_albedo_rect[0] = [0, 0, 64, 64]       # smaller FIRST slot
    sc.mat_pbr_rect[0] = [128, 0, 128, 128]      # larger later slot
    _assert_fat_matches_per_slot(pack_device_scene(sc), seed=9)


@pytest.mark.parametrize("variant",
                         ["congruent", "mixedres", "nondivisible",
                          "neguv"])
def test_fat_atlas_trace_parity(variant):
    """Full-trace parity on the fat path against the scalar oracle (which
    samples the atlas per slot): RNG streams equal on every probe pixel,
    radiance to f32 reassociation — on congruent, mixed-resolution,
    non-divisible (LCM virtual grid) and negative-uv (backward band) map
    sets."""
    from wgpu_path_tracing_tpu.models.procedural import textured_cornell

    sc = textured_cornell(
        atlas_size=256,
        congruent=variant in ("congruent", "neguv"),
    )
    if variant == "nondivisible":
        sc.mat_pbr_rect[0] = [128, 0, 96, 96]
    if variant == "neguv":
        # Real negative interpolated uvs at runtime: every material's
        # uv0 shifted below zero engages the backward band.
        sc.tri_uv0[:] = np.asarray(sc.tri_uv0) - 1.0
    scene = jax.device_put(pack_device_scene(sc))
    assert "atlas_fat" in scene
    flips, off = trace_vs_oracle(sc, scene, WIDTH, max_bounces=4)
    assert flips <= 1 and off <= 1, (flips, off)


def test_fat_atlas_overlapping_atlas_rects_ok():
    """Two materials whose ATLAS rects overlap are fine under the virtual
    -rect bake (each map set owns its own canvas region — the round-3
    rep-rect-conflict gate is gone): values must match per-slot exactly
    for both materials."""
    from wgpu_path_tracing_tpu.models.procedural import textured_cornell

    sc = textured_cornell(atlas_size=256, congruent=True)
    # mat1 currently maps only a normal rect at (0,128,128,128); give it
    # an albedo rect overlapping mat0's albedo rect (0,0,128,128).
    sc.mat_albedo_rect[1] = [64, 64, 128, 128]
    sc.mat_pbr_rect[1] = [128, 128, 128, 128]
    sc.mat_normal_rect[1] = [0, 0, 0, 0]
    _assert_fat_matches_per_slot(pack_device_scene(sc), seed=13)


def test_pull_counters_empty():
    """render(spp=0, sync=True) dispatches no chunks; the one-pull sync
    must treat the empty pending list as zero counters, not crash."""
    from wgpu_path_tracing_tpu.render.renderer import Renderer

    out = Renderer._pull_counters([])
    np.testing.assert_array_equal(out, np.zeros(2, np.int64))


def test_pack_asserts_bf16_exact_atlas():
    """pack_device_scene fails LOUDLY on an atlas that bypassed the
    finalize_scene quantization choke point (models/assemble.py::
    quantize_atlas) — a raw-f32 atlas would render differently from a
    finalized one."""
    import pytest

    from wgpu_path_tracing_tpu.models.procedural import textured_cornell
    from wgpu_path_tracing_tpu.models.types import pack_device_scene

    scene = _textured_cornell()
    raw = scene.atlas.copy()
    raw[0, 0, 0] = np.float32(0.1234567)  # not bf16-representable
    scene.atlas = raw
    with pytest.raises(ValueError, match="bf16-exact"):
        pack_device_scene(scene)
