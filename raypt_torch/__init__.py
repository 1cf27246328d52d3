"""raypt_torch: the raypt path tracer ported to PyTorch and CUDA.

It mirrors the JAX package `raypt` module by module and is held against
it in the tests. This package imports torch and numpy only. The
finders' thirteen kernels are CUDA C++ for Hopper under `csrc/`, built on
first use (`kernels/_build.py`); on CPU tensors each kernel's plain
torch version runs instead.

  raypt_torch.core     scene containers, math, camera, scene builder
  raypt_torch.rng      threefry sampling, bitwise equal to the JAX package
  raypt_torch.accel    host SAH tree, device LBVH build, packed table,
                       4-wide tree, clusters, top tree, finders
  raypt_torch.kernels  the CUDA kernels' wrappers and plain versions
  raypt_torch.render   integrator, shading, environment (with its mip
                       chain and LOD), tonemap, primary-hit AOVs
  raypt_torch.diff     inverse rendering: scene parameters, mesh
                       priors, the fit step (refit and pack on the
                       card every step), its view-sharded form and the
                       fit loop
  raypt_torch.dist     the row-sharded render and gradients and the
                       view-sharded fit over torch.distributed, and the
                       launcher (python -m raypt_torch.dist.launcher)
  raypt_torch.io       OBJ, PLY, glTF, DDS, Radiance .hdr, PNG / PPM /
                       NPY, checkpoints, the native SAH builder and OBJ
                       parser
  raypt_torch.app      the CLI (python -m raypt_torch.app.cli), metrics,
                       profiling, the checked debug render
  raypt_torch.scenes   the bench bunny, the Cornell box (with and without
                       the bunny), the triangle-on-ground scene, the
                       textured demo and the config-4 scene
"""
