"""fissure_segmentation_tpu_torch — PyTorch/CUDA port of fissure_segmentation_tpu.

The JAX package beside this one is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

  kernels/      hand-written CUDA kernels for Hopper (sm_90a), built with
                nvcc at first use and bound through ctypes; each kernel has a
                plain PyTorch version beside it, used for CPU tensors
  data/         numpy-only synthetic CT cases
  utils/        separable filters and max-pool NMS on volumes
  ops/          top-k, kNN, edge features, normals, splatting, spectral PSR,
                marching tetrahedra
  keypoints/    Förstner detector, closed-form 3x3 eigenvalues
  models/       DGCNNSeg (eval mode), JAX-variable loader, subset ensemble
  postprocess/  batched per-class surface fit + host mesh filter/labelmap
  serving.py    segment_case: one CT case -> keypoints, labels, meshes

The package imports torch, numpy and scipy — never jax or its NN libraries. From the JAX
package it uses only the jax-free host modules `native` (C++ connected
components and voxelization) and `utils.coords`.
"""
