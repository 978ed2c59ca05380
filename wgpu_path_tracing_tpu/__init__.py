"""wgpu_path_tracing_tpu — a physically-based path-tracing framework in JAX.

A from-scratch rebuild of the capabilities of the WebGPU renderer
``re-ovo/wgpu-path-tracing``, designed in JAX/XLA/Pallas rather than
translated; it runs on an NVIDIA GPU (and on the CPU for tests):

* the reference's per-pixel WGSL megakernel (``src/shader/pt.wgsl``) becomes a
  **wavefront tracer over SoA ray batches** — every pixel's ray advances
  through a ``lax.scan`` bounce loop with masked lanes,
* BVH traversal (``pt.wgsl:248-296``) becomes a per-ray threaded-BVH walk
  (a Pallas kernel on the GPU, a batched ``lax.while_loop`` elsewhere),
  plus a dense all-rays x all-triangles path for small scenes,
* the RNG (``src/shader/random.wgsl``) is threaded functionally with masked
  state advancement so per-pixel streams can bit-match the reference,
* scene ingestion (``src/renderer/{gpu,loader,atlas}.ts``) is NumPy host
  preprocessing, BVH building (``src/renderer/bvh.ts``) is NumPy with an
  optional C++ fast path, and
* multi-device scaling uses ``jax.sharding.Mesh`` + ``shard_map`` row/sample
  sharding instead of any host-loop parallelism.

Public API mirrors the reference renderer's surface (``renderer.ts:18-134``):

    from wgpu_path_tracing_tpu import Renderer, RenderConfig
    r = Renderer(RenderConfig(width=512, height=512))
    r.load_model("scene.glb")        # or r.load_scene(cornell_box())
    img = r.render(spp=64)           # progressive; r.reset(), r.move_camera()
"""

from wgpu_path_tracing_tpu.render.config import RenderConfig
from wgpu_path_tracing_tpu.render.camera import Camera
from wgpu_path_tracing_tpu.render.renderer import Renderer
from wgpu_path_tracing_tpu.models.procedural import (
    cornell_box,
    material_test_box,
    textured_cornell,
)
from wgpu_path_tracing_tpu.render.controller import Controller

__version__ = "0.1.0"

__all__ = [
    "Renderer", "RenderConfig", "Camera", "Controller", "cornell_box",
    "material_test_box", "textured_cornell", "__version__",
]
