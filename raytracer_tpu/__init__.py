"""raytracer_tpu — a differentiable path tracer in JAX/Pallas for NVIDIA GPUs.

Built from scratch with the capability surface of the Go reference renderer
(TwFlem/raytracer-go, mounted at /root/reference): pinhole + thin-lens camera,
spheres/quads/boxes, BVH acceleration, Lambertian/metal/dielectric/emissive
materials, solid/checker/image/Perlin textures, and its six reference scenes —
re-designed for a data-parallel accelerator:

* SoA ray batches instead of per-pixel recursion (reference: ray.go:32-54).
* Ray-primitive intersection as dense masked reductions over per-primitive
  feature columns, or a Pallas-Triton closest-hit kernel on the GPU
  (reference: hittables.go:96-198 scalar loops).
* Bounce recursion unrolled into an iterative wavefront loop
  (`lax.while_loop` over bounce depth with alive masks).
* Branchless masked material dispatch (reference: materials.go interface
  dispatch).
* `jax.random` threaded keys (reference: hidden per-worker rand state,
  camera.go:167-175).
* Image tiles + sample budget sharded over a `jax.sharding.Mesh`
  (reference: goroutine pool, camera.go:199-230).
* End-to-end differentiable: pixel gradients w.r.t. scene + camera params.
"""

__version__ = "0.1.0"

from raytracer_tpu.core.camera import Camera, camera_rays, make_camera
from raytracer_tpu.geometry.scene import SceneBuilder, Scene
from raytracer_tpu.render.driver import render_image, render_scene

__all__ = [
    "Camera",
    "camera_rays",
    "make_camera",
    "SceneBuilder",
    "Scene",
    "render_image",
    "render_scene",
]
