"""genre_shapehd_tpu_torch: GenRe training, reconstruction and scoring in
PyTorch + CUDA.

A port of ``genre_shapehd_tpu`` (JAX/Pallas on TPU) to PyTorch on an
NVIDIA Hopper GPU.  The module layout mirrors the JAX package so each
piece has a named counterpart; public functions keep the JAX package's
array layouts (images (N,H,W,C), voxels (N,X,Y,Z), spherical maps
(N,R,R[,1])), while the nets run NCHW / NCDHW inside.

This package imports ``torch`` and never ``jax``, ``flax``, ``optax`` or
the JAX package.  Every Pallas kernel of the JAX package is hand-written
CUDA here (``csrc/``: the spherical renderer's three stages, the final
deconv of the 3D U-Net, the Chamfer distance), built with ``nvcc`` on
first use; on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""
