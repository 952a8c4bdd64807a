"""Differentiable progressive path tracer in JAX.

A from-scratch JAX/Pallas re-design of the feature set of
Mourtz/Photorealistic-Rendering-using-OpenCL (an interactive OpenCL
megakernel path tracer).  Nothing here is a port: the megakernel with
persistent per-pixel path state (reference ``kernels/main.cl``) becomes a
wavefront pipeline -- rays are SoA arrays, the bounce loop is a
``lax.scan``, intersection/shading are vectorized over the whole ray batch,
and multi-chip scaling is ``shard_map`` over a device mesh with the scene
replicated.

Layout:
    ops/       device math: sampling, RNG, BSDFs, microfacet, Fresnel,
               phase functions, media, intersection, BVH traversal, camera,
               tonemap, env maps
    scene/     host-side scene description: JSON loader, OBJ import,
               SAH BVH build, SoA scene arrays (jit-static config)
    models/    the renderer itself (integrator + progressive render loops)
    parallel/  device-mesh sharding of the render (tiles x samples)
    diff/      differentiable-rendering helpers + finite-difference checks
    utils/     image IO (PNG/HDR), config, profiling, checkpointing
    runtime/   native (C++) host runtime: BVH builder, OBJ parser
"""

__version__ = "0.1.0"

from photorealistic_rendering_using_opencl_tpu.utils import config as config  # noqa: F401
