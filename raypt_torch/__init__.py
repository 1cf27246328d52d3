"""raypt_torch: the raypt path tracer ported to PyTorch and CUDA.

It mirrors the JAX package `raypt` module by module and is held against
it in the tests. This package imports torch and numpy only. The render
path's four kernels are CUDA C++ for Hopper under `csrc/`, built on
first use (`kernels/_build.py`); on CPU tensors each kernel's plain
torch version runs instead.

  raypt_torch.core     scene containers, math, camera, scene builder
  raypt_torch.rng      threefry sampling, bitwise equal to the JAX package
  raypt_torch.accel    host SAH tree, clusters, top tree, finders
  raypt_torch.kernels  the CUDA kernels' wrappers and plain versions
  raypt_torch.render   integrator, shading, environment, tonemap
  raypt_torch.io       OBJ, PNG, native SAH builder
  raypt_torch.scenes   the bench bunny and the triangle-on-ground scene
"""
