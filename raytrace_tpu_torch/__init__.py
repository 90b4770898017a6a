"""raytrace_tpu_torch — the path tracer of ``raytrace_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The forward render path: the scene builder and compiler (triangle meshes
and the .obj parser included), the camera, the counter-hash RNG, and
``render`` / ``render_accumulate`` over the pixel-stationary and
work-queue wavefront drivers.  The bounce runs in kernel A
(``ops/bounce_kernel.py``, ``csrc/bounce_kernel.cu``) for tables of at
most 512 rows, and the fused iteration in kernel B (``ops/iter_kernel.py``,
``csrc/iter_kernel.cu``); every other scene (mesh-scale tables of any
size, image, noise, marble and custom textures, the BVH accelerator
mode) takes the split path: the nearest hit over a BVH (``ops/allpairs_kernel.py``,
``csrc/nearest_kernel.cu``) or by a flat scan of a small table
(``ops/intersect_kernel.py``, ``csrc/nearest_flat_kernel.cu``), the shade
kernel (``csrc/shade_kernel.cu``) and the rich-texture albedo
(``textures/``; marble stripes in ``csrc/texture_kernel.cu``), with the
boundary crossings of constant-density media
(``ops/volume_kernel.py``, ``csrc/volume_kernel.cu``) before the shade;
scenes with mesh-boundary media or tables of 8,192 rows and more render
through the ray-sorted work-queue driver.  The
differentiable path: ``diff.gradients``
(``partition``, ``loss_and_grads``, ``render_loss_wavefront``) over the
differentiable wavefront, whose forward is kernel B (its BVH variant
above 512 rows, up to 8192) and whose backward runs kernel K5
(``ops/bounce_bwd_gather_kernel.py``, ``csrc/bounce_bwd_kernel.cu``);
rich textures are multiplied in after each step in differentiable torch,
the image atlas's gradient through ``csrc/image_grad_kernel.cu``.
``utils`` holds ``engine_report`` (which kernels each route runs),
``RenderStats`` and the render checkpoints; ``scenes`` the reference's
scene drivers and the parity script; ``parallel`` the render and the
train step over several GPUs and processes (``torch.distributed``);
``entry`` the driver entry points.  On CPU tensors each kernel runs its
plain PyTorch version; the entry points put scenes on the card unless
given ``device="cpu"``.  The package imports torch and numpy, never
JAX.
"""
from .core.vecmath import degrees
from .materials.materials import (
    anisotropic, dielectric, isotropic, lambertian, light_source,
    lommel_seeliger, metal, mirror, pitch_black, transparent,
)
from .render.camera import CameraSettings, const_background, gray_fade, sky
from .render.image import read_image, write_image, write_image_sqrt
from .render.render import render, render_accumulate
from .scene.builder import (
    Mesh, bvh_tree, compose, constant_medium, cuboid, cuboids, group, moving,
    parallelogram, rotate_x, rotate_y, rotate_z, scale, sphere, spheres,
    transform, translate, triangle, triangle_mesh, with_material,
)
from .scene.compile import compile_scene
from .scene.obj import parse_obj, read_obj
from .textures.textures import (
    checker_texture, constant_texture, custom_texture, image_texture,
    marble_texture, noise_texture, solid_texture, uv_texture,
)

__version__ = "0.1.0"
