"""fissure_segmentation_tpu_torch — PyTorch/CUDA port of fissure_segmentation_tpu.

The JAX package beside this one is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

  kernels/      hand-written CUDA kernels for Hopper (sm_90a), built with
                nvcc at first use and bound through ctypes: K1 kNN
                (csrc/knn.cu), K2-K4 the EdgeConv scatters (csrc/scatter.cu);
                each kernel has a plain PyTorch version beside it, used for
                CPU tensors
  data/         numpy-only synthetic CT and keypoint-cloud cases, the point
                dataset and splits, the device store with batch sampling and
                augmentation
  utils/        separable filters and max-pool NMS on volumes
  ops/          top-k, kNN, edge gather (backward K2), fused EdgeConv
                (backward K3 + K4), normals, splatting, spectral PSR,
                marching tetrahedra
  keypoints/    Förstner detector, closed-form 3x3 eigenvalues
  models/       DGCNNSeg (train and eval), JAX-variable loader and exporter,
                model.pt save/load, subset ensemble
  losses/       CE, generalized Dice, nnU-Net and recall losses
  train/        ModelTrainer (Adam + L2, schedulers, resume), cross-val
  postprocess/  batched per-class surface fit + host mesh filter/labelmap
  serving.py    segment_case: one CT case -> keypoints, labels, meshes
  train_point_seg.py  the training entry point (python -m ...)

The package imports torch, numpy and scipy — never jax or its NN libraries. From the JAX
package it uses only the jax-free modules `native` (C++ connected
components and voxelization), `utils.coords` and `cli` (argparse flags).
"""
