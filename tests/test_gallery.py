"""Gallery scene (models/gallery.py) — the sponza-stand-in atrium."""

import numpy as np

from wgpu_path_tracing_tpu import Renderer, RenderConfig
from wgpu_path_tracing_tpu.models.gallery import gallery_atrium
from wgpu_path_tracing_tpu.models.types import pack_device_scene


def test_gallery_builds_and_packs():
    sc = gallery_atrium(detail=1)
    assert sc.num_triangles > 5000
    assert sc.num_lights >= 3  # skylight + two sconces
    packed = pack_device_scene(sc)
    # Production texture path: multiple map sets on one fat canvas.
    assert "atlas_fat" in packed
    assert packed["atlas_fat_rects"].shape[0] >= 5
    # Mixed resolutions present (LCM grids differ across sets).
    dims = np.asarray(packed["atlas_fat_rects"])[:, 18:20]
    assert len({tuple(d) for d in dims.tolist()}) > 1


def test_gallery_default_is_production_scale():
    # The default detail must cross the dense intersector's gate so the
    # bench/gallery render exercises the BVH traversal (sponza's role).
    sc = gallery_atrium()
    assert sc.num_triangles > 100_000


def test_gallery_renders():
    sc = gallery_atrium(detail=1)
    r = Renderer(RenderConfig(width=16, height=16, frames_per_chunk=1))
    r.load_scene(sc)
    r.camera.position = np.array([0.0, 2.4, 3.0], np.float32)
    img = r.render(spp=2)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert float(img.max()) > 0.0  # lights reach the film
