"""genre_shapehd_tpu_torch: the GenRe inference path in PyTorch + CUDA.

A port of ``genre_shapehd_tpu`` (JAX/Pallas on TPU) to PyTorch on an
NVIDIA Hopper GPU.  The module layout mirrors the JAX package so each
piece has a named counterpart; public functions keep the JAX package's
array layouts (images (N,H,W,C), voxels (N,X,Y,Z), spherical maps
(N,R,R[,1])), while the nets run NCHW / NCDHW inside.

This package imports ``torch`` and never ``jax``, ``flax``, ``optax`` or
the JAX package.  The spherical renderer's two Pallas kernels are
hand-written CUDA (``csrc/render_kernel.cu``), built with ``nvcc`` on
first use; on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""
