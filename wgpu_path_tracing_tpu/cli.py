"""Command-line interface.

The reference's entry points are browser interactions (drag-drop a .glb,
fly camera, live tweakpane stats — App.tsx:12-34, controller.ts); headless,
the equivalents are subcommands:

    python -m wgpu_path_tracing_tpu.cli render scene.glb --spp 512 \\
        --width 512 --height 512 -o out.png
    python -m wgpu_path_tracing_tpu.cli render scene.glb --mode normal ...
    python -m wgpu_path_tracing_tpu.cli info scene.glb
    python -m wgpu_path_tracing_tpu.cli bench [--spp 64 ...]

``render`` supports progressive checkpointing (--checkpoint/--resume, the
spp-stamped upgrade of the reference's restartable accumulation) and camera
overrides matching the reference defaults (renderer.ts:136-150).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from wgpu_path_tracing_tpu.ops.intersect import INTERSECTORS
from wgpu_path_tracing_tpu.utils.cache import enable_compile_cache

enable_compile_cache()


def _add_camera_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cam-pos", type=float, nargs=3, default=[0.0, 1.0, 2.8],
                   metavar=("X", "Y", "Z"))
    p.add_argument("--cam-yaw", type=float, default=0.0,
                   help="yaw in degrees applied to the default forward (0,0,-1)")
    p.add_argument("--cam-pitch", type=float, default=0.0, help="pitch in degrees")
    p.add_argument("--fov", type=float, default=60.0, help="vertical fov, degrees")
    p.add_argument("--aperture", type=float, default=0.001)
    p.add_argument("--focus-distance", type=float, default=5.0)


def _build_renderer(args):
    from wgpu_path_tracing_tpu import Camera, Renderer, RenderConfig

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        max_bounces=args.bounces,
        do_mis=not args.no_mis,
        frames_per_chunk=args.chunk,
        frames_per_trace=getattr(args, "frames_per_trace", 1),
        mode=args.mode,
        rng=args.rng,
        intersector=args.intersector,
        spot_lights=getattr(args, "spot_lights", False),
        env_map=getattr(args, "env_map", None),
        env_intensity=getattr(args, "env_intensity", 1.0),
        env_rotation=math.radians(getattr(args, "env_rotation", 0.0)),
    )
    cam = Camera(
        width=args.width,
        height=args.height,
        aspect=args.width / args.height,
        fov=math.radians(args.fov),
        aperture=args.aperture,
        focus_distance=args.focus_distance,
    )
    import numpy as np

    cam.position = np.asarray(args.cam_pos, np.float32)
    r = Renderer(cfg, cam, devices=True if getattr(args, "multichip", False) else None)
    if args.cam_yaw or args.cam_pitch:
        r.camera.rotate(math.radians(args.cam_yaw), math.radians(args.cam_pitch))
    return r


def _load_scene_arg(r, args) -> None:
    """Shared scene selection for render/view: a .glb path or a named
    built-in. 'cornell-replica' also applies the camera fitted to the
    reference golden (models/replica.py) unless --cam-pos was overridden."""
    from wgpu_path_tracing_tpu import cornell_box

    if args.scene == "cornell":
        r.load_scene(cornell_box(tessellation=getattr(args, "tessellation", 1)))
    elif args.scene == "cornell-replica":
        from wgpu_path_tracing_tpu.models.replica import (
            REPLICA_CAMERA_POSITION,
            cornell_replica,
        )

        r.load_scene(cornell_replica())
        if list(args.cam_pos) == [0.0, 1.0, 2.8]:  # argparse default
            import numpy as np

            r.camera.position = np.asarray(
                REPLICA_CAMERA_POSITION, np.float32
            )
    elif args.scene == "atrium":
        # The sponza-stand-in gallery scene (models/gallery.py).
        from wgpu_path_tracing_tpu.models.gallery import gallery_atrium

        r.load_scene(gallery_atrium())
        if list(args.cam_pos) == [0.0, 1.0, 2.8]:  # argparse default
            import numpy as np

            r.camera.position = np.asarray([0.0, 2.4, 3.0], np.float32)
    else:
        r.load_model(args.scene)


def cmd_render(args) -> int:
    r = _build_renderer(args)
    _load_scene_arg(r, args)

    if args.resume and args.checkpoint:
        try:
            r.load_checkpoint(args.checkpoint)
            print(f"resumed at {r.frame_index} spp", file=sys.stderr)
        except FileNotFoundError:
            pass

    if args.mode != "pt":
        img = r.render_debug()
        from wgpu_path_tracing_tpu.utils.image import write_png
        import numpy as np

        write_png(args.output, np.clip(img, 0, 1)[::-1])
        print(f"wrote {args.output} ({args.mode} mode)")
        return 0

    t0 = time.perf_counter()

    def progress(frames):
        if args.verbose:
            dt = time.perf_counter() - t0
            print(f"  {frames}/{args.spp + (r.frame_index - frames)} spp "
                  f"({dt:.1f}s)", file=sys.stderr)

    preview_path = args.preview
    if preview_path == "":  # bare --preview: reuse the output path
        preview_path = args.output

    def on_chunk(frames):
        if args.verbose:
            progress(frames)
        if preview_path:
            # The reference blits the accumulation buffer to the canvas
            # every frame (renderer.ts:434-448); headless, the tonemapped
            # image is refreshed on disk every chunk so the user can watch
            # it converge. --denoise filters the preview copies too (the
            # converging-preview case is what the filter is for).
            r.save_png(preview_path, denoise=getattr(args, "denoise", False))

    remaining = args.spp - (r.frame_index if args.resume else 0)
    adaptive_hdr = None
    if getattr(args, "adaptive", False) and remaining > 0:
        adaptive_hdr = r.render_adaptive(remaining)
    elif remaining > 0:
        r.render(
            remaining,
            on_chunk=on_chunk if (args.verbose or preview_path) else None,
            fetch=False,  # save_png below pulls the buffer once
        )
    if adaptive_hdr is not None:
        from wgpu_path_tracing_tpu.utils.image import buffer_to_srgb, write_png

        if getattr(args, "denoise", False):
            adaptive_hdr = r.denoise(hdr=adaptive_hdr)
        write_png(args.output, buffer_to_srgb(
            adaptive_hdr.reshape(-1, 3), r.config.width, r.config.height,
            r.config.exposure))
    else:
        r.save_png(args.output, denoise=getattr(args, "denoise", False))
    if args.hdr:
        r.save_hdr(args.hdr)
    if args.exr:
        r.save_exr(args.exr)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
    s = r.stats()
    print(
        f"wrote {args.output}: {r.frame_index} spp, "
        f"{s['last_render_seconds']:.2f}s, {s['mrays_per_sec']:.1f} Mrays/s"
    )
    return 0


def cmd_view(args) -> int:
    from wgpu_path_tracing_tpu.viewer import ViewerServer

    r = _build_renderer(args)
    _load_scene_arg(r, args)
    server = ViewerServer(r, port=args.port, frames_per_update=args.chunk)
    print(f"viewer at http://localhost:{server.port}", file=sys.stderr)
    try:
        server.run_loop(max_seconds=args.seconds)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_info(args) -> int:
    from wgpu_path_tracing_tpu import cornell_box
    from wgpu_path_tracing_tpu.accel.bvh import BVH

    if args.scene == "cornell":
        s = cornell_box()
    else:
        from wgpu_path_tracing_tpu.models.gltf import load_model

        s = load_model(args.scene)
    import numpy as np

    bvh = BVH(s.bvh_aabb_min, s.bvh_aabb_max, s.bvh_meta, np.arange(s.num_triangles))
    leaf = s.bvh_meta[:, 3] > 0
    print(json.dumps({
        "triangles": s.num_triangles,
        "materials": s.num_materials,
        "lights": s.num_lights,
        "light_types": {
            "emissive": int((s.light_type == 0).sum()),
            "directional": int((s.light_type == 1).sum()),
            "point": int((s.light_type == 2).sum()),
            "spot": int((s.light_type == 3).sum()),
        },
        "bvh_nodes": int(s.bvh_meta.shape[0]),
        "bvh_leaves": int(leaf.sum()),
        "bvh_max_depth": bvh.max_depth(),
        "atlas": None if s.atlas is None else list(s.atlas.shape),
        "transmission_materials": int((s.mat_transmission > 0).sum()),
    }, indent=2))
    return 0


def cmd_export(args) -> int:
    """Write a named built-in scene as a binary .glb (models/export.py)."""
    from wgpu_path_tracing_tpu.models.export import scene_to_glb
    from wgpu_path_tracing_tpu.models.procedural import (
        cornell_box,
        material_test_box,
        textured_cornell,
    )

    if args.scene == "cornell":
        scene = cornell_box(tessellation=args.tessellation)
    elif args.scene == "cornell-replica":
        from wgpu_path_tracing_tpu.models.replica import cornell_replica

        scene = cornell_replica()
    elif args.scene == "textured":
        scene = textured_cornell()
    elif args.scene == "material-box":
        scene = material_test_box()
    elif args.scene == "atrium":
        from wgpu_path_tracing_tpu.models.gallery import gallery_atrium

        scene = gallery_atrium()
    else:
        print(f"unknown scene: {args.scene!r} (expected cornell | "
              "cornell-replica | textured | material-box | atrium)")
        return 2
    blob = scene_to_glb(scene)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"wrote {args.output}: {len(blob)} bytes, "
          f"{scene.num_triangles} tris, {scene.num_lights} lights")
    return 0


def cmd_bench(args) -> int:
    # The bench harness lives at the repo root (the driver runs it there);
    # make it importable regardless of the caller's cwd.
    import os
    import sys

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    try:
        import bench  # repo-root bench harness
    except ImportError as e:
        print(f"bench.py not found (repo checkout required): {e}",
              file=sys.stderr)
        return 1
    bench.main()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="wgpu_path_tracing_tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("render", help="path-trace a scene to a PNG")
    pr.add_argument("scene", help=".glb/.gltf path, 'cornell' for the built-in box, or 'cornell-replica' (models/replica.py)")
    pr.add_argument("--tessellation", type=int, default=1,
                    help="subdivide the built-in cornell quads NxN "
                         "(large-triangle-count benchmarks)")
    pr.add_argument("-o", "--output", default="out.png")
    pr.add_argument("--spp", type=int, default=64)
    pr.add_argument("--width", type=int, default=512)
    pr.add_argument("--height", type=int, default=512)
    pr.add_argument("--bounces", type=int, default=8)
    pr.add_argument("--no-mis", action="store_true",
                    help="disable NEE+MIS (pt.wgsl:636 DO_MIS)")
    pr.add_argument("--chunk", type=int, default=16,
                    help="samples per jit dispatch")
    pr.add_argument("--frames-per-trace", type=int, default=1,
                    dest="frames_per_trace",
                    help="samples batched into one trace call (see "
                         "RenderConfig)")
    pr.add_argument("--mode", choices=("pt", "normal", "bvh_depth"), default="pt")
    pr.add_argument("--rng", choices=("reference", "hash", "stratified"), default="reference")
    pr.add_argument("--intersector", choices=INTERSECTORS, default="auto")
    pr.add_argument("--preview", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="write the tonemapped PNG after every chunk "
                         "(default: the output path) so convergence is "
                         "watchable, like the reference's per-frame blit")
    pr.add_argument("--adaptive", action="store_true",
                    help="adaptive sampling (opt-in extension, "
                         "render/adaptive.py): uniform warmup, then the "
                         "ray budget concentrates on the noisiest pixels")
    pr.add_argument("--denoise", action="store_true",
                    help="edge-avoiding a-trous denoise of the final PNG "
                         "(opt-in extension, ops/denoise.py; --hdr/--exr "
                         "and checkpoints stay raw)")
    pr.add_argument("--hdr", metavar="PATH",
                    help="also write the linear radiance as Radiance RGBE .hdr")
    pr.add_argument("--exr", metavar="PATH",
                    help="also write the linear radiance as OpenEXR (f32)")
    pr.add_argument("--env-map", default=None, metavar="PATH",
                    help="equirect environment map (.hdr, uncompressed-FLOAT"
                         " .exr, or LDR) — an extension; default keeps "
                         "reference miss->black")
    pr.add_argument("--env-intensity", type=float, default=1.0)
    pr.add_argument("--env-rotation", type=float, default=0.0,
                    help="environment yaw in degrees")
    pr.add_argument("--spot-lights", action="store_true",
                    help="render KHR spot lights (extension; the reference "
                         "warns-and-skips them, gpu.ts:234-236)")
    pr.add_argument("--checkpoint", help="npz accumulation checkpoint path")
    pr.add_argument("--resume", action="store_true")
    pr.add_argument("--multichip", action="store_true",
                    help="shard the render over all visible devices "
                         "(sample x row mesh via shard_map)")
    pr.add_argument("-v", "--verbose", action="store_true")
    _add_camera_args(pr)
    pr.set_defaults(func=cmd_render)

    pv = sub.add_parser("view", help="live progressive viewer (HTTP) with fly camera")
    pv.add_argument("scene", help="like render's scene argument")
    pv.add_argument("--tessellation", type=int, default=1)
    pv.add_argument("--port", type=int, default=8080)
    pv.add_argument("--width", type=int, default=256)
    pv.add_argument("--height", type=int, default=256)
    pv.add_argument("--bounces", type=int, default=8)
    pv.add_argument("--no-mis", action="store_true")
    pv.add_argument("--chunk", type=int, default=4,
                    help="samples rendered per viewer tick")
    pv.add_argument("--frames-per-trace", type=int, default=1,
                    dest="frames_per_trace",
                    help="samples batched into one trace call")
    pv.add_argument("--mode", choices=("pt",), default="pt")
    pv.add_argument("--rng", choices=("reference", "hash", "stratified"), default="reference")
    pv.add_argument("--env-map", default=None, metavar="PATH")
    pv.add_argument("--env-intensity", type=float, default=1.0)
    pv.add_argument("--env-rotation", type=float, default=0.0)
    pv.add_argument("--intersector", choices=INTERSECTORS, default="auto")
    pv.add_argument("--spot-lights", action="store_true",
                    help="render KHR spot lights (extension; the reference "
                         "warns-and-skips them, gpu.ts:234-236)")
    pv.add_argument("--seconds", type=float, default=None,
                    help="stop after N seconds (default: run until Ctrl-C)")
    _add_camera_args(pv)
    pv.set_defaults(func=cmd_view)

    pi = sub.add_parser("info", help="scene statistics (triangles/BVH/lights)")
    pi.add_argument("scene")
    pi.set_defaults(func=cmd_info)

    pb = sub.add_parser("bench", help="run the headline benchmark")
    pb.set_defaults(func=cmd_bench)

    pe = sub.add_parser(
        "export",
        help="write a built-in scene as .glb (models/export.py; the "
        "reference has no exporter — round-trips through load_model)")
    pe.add_argument("scene", help="cornell | cornell-replica | textured | "
                    "material-box")
    pe.add_argument("-o", "--output", required=True)
    pe.add_argument("--tessellation", type=int, default=1,
                    help="subdivide cornell quads (tris scale ~t^2)")
    pe.set_defaults(func=cmd_export)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
