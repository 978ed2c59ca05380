"""Render the gallery scenes to docs/gallery/ (committed images).

Usage: python tools/render_gallery.py [--spp 256] [--size 512]
       python tools/render_gallery.py --scene lights [--spp 512]

Default scene: the sponza-stand-in atrium (models/gallery.py), raw and
denoised. ``--scene lights`` renders the lights.glb stand-in instead
(the reference's punctual-light demo is stripped from the mirror,
.MISSING_LARGE_BLOBS:1): material_test_box — every BSDF lobe (diffuse,
GGX metal, glass transmission) under every light type (emissive area,
point, directional) plus a spot (extension type 3). Run on the GPU."""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=["atrium", "lights"],
                    default="atrium")
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "docs", "gallery"))
    args = ap.parse_args()

    import numpy as np

    from wgpu_path_tracing_tpu import Renderer, RenderConfig
    from wgpu_path_tracing_tpu.models.gallery import gallery_atrium

    os.makedirs(args.out, exist_ok=True)
    if args.scene == "lights":
        return _render_lights(args)
    r = Renderer(RenderConfig(width=args.size, height=args.size,
                              frames_per_chunk=8, frames_per_trace=8))
    r.load_scene(gallery_atrium())
    r.camera.position = np.array([0.0, 2.4, 3.0], np.float32)
    print(f"atrium: {r.scene.num_triangles} tris, "
          f"{r.scene.num_lights} lights, "
          f"intersector={r.stats()['intersector']}", flush=True)
    r.render(spp=args.spp, fetch=False)
    raw = os.path.join(args.out, "atrium_raw.png")
    dn = os.path.join(args.out, "atrium_denoised.png")
    r.save_png(raw)
    r.save_png(dn, denoise=True)
    print(f"wrote {raw} and {dn} ({args.spp} spp); {r.stats()}", flush=True)
    return 0


def _render_lights(args) -> int:
    """lights.glb stand-in: material_test_box + a spot light."""
    import dataclasses

    import numpy as np

    from wgpu_path_tracing_tpu import Renderer, RenderConfig
    from wgpu_path_tracing_tpu.models.procedural import material_test_box

    sc = material_test_box()
    n = sc.num_lights
    aux = np.zeros((n + 1, 5), np.float32)
    # Down-facing cone aimed at the glass box (scale/offset encode the
    # inner/outer cone as in KHR_lights_punctual's angular attenuation).
    aux[-1] = [0.35, -0.9, 0.25, 9.75, -8.56]
    sc = dataclasses.replace(
        sc,
        light_position=np.concatenate(
            [sc.light_position, [[0.1, 1.9, 0.05]]]).astype(np.float32),
        light_type=np.concatenate([sc.light_type, [3]]).astype(np.int32),
        light_color=np.concatenate(
            [sc.light_color, [[0.4, 0.7, 1.0]]]).astype(np.float32),
        light_intensity=np.concatenate(
            [sc.light_intensity, [2000.0]]).astype(np.float32),
        light_tri=np.concatenate([sc.light_tri, [0]]).astype(np.int32),
        light_aux=aux,
    )
    r = Renderer(RenderConfig(width=args.size, height=args.size,
                              frames_per_chunk=8))
    r.load_scene(sc)
    print(f"lights demo: {sc.num_triangles} tris, {sc.num_lights} lights "
          "(area + point + directional + spot)", flush=True)
    r.render(spp=args.spp, fetch=False)
    out = os.path.join(args.out, "lights_demo.png")
    r.save_png(out)
    print(f"wrote {out} ({args.spp} spp); {r.stats()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
