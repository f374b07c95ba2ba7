"""fissure_segmentation_tpu_torch — PyTorch/CUDA port of fissure_segmentation_tpu.

The JAX package beside this one is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

  kernels/      hand-written CUDA kernels for Hopper (sm_90a), built with
                nvcc at first use and bound through ctypes: K1 kNN
                (csrc/knn.cu), K2-K4 the EdgeConv scatters (csrc/scatter.cu),
                K5 farthest-point sampling (csrc/fps.cu), K6 the depthwise
                convolution (csrc/depthwise.cu), the fused EdgeConv
                gather-reduce (csrc/gather_reduce.cu), the streaming
                column sums (csrc/stream.cu) and the approximate top-k's
                fused row selection and bin pass (csrc/approx_topk.cu);
                each kernel has a plain PyTorch version beside it, used
                for CPU tensors
  native/       the C++ host runtime (connected components, voxelization,
                dilation), a copy of the JAX package's source, built with g++
                at first use; no fallback
  cli/          the entry points' argparse flags (copy of the JAX package's)
  data/         numpy-only synthetic CT and keypoint-cloud cases, the point
                dataset and splits, the device store with batch sampling and
                augmentation
  utils/        coordinate conventions, separable filters, max-pool NMS
  ops/          top-k, kNN, FPS (K5), kNN query / grouping / interpolation,
                edge gather (backward K2), fused EdgeConv (forward the
                gather-reduce kernel, backward K3 + K4),
                normals, splatting, spectral PSR, marching tetrahedra
  keypoints/    Förstner detector, closed-form 3x3 eigenvalues
  models/       DGCNNSeg (f32 or the bf16 compute dtype) and
                PointTransformerSeg (train and eval), the PC-AE, the
                CNNs, DPSR-Net (v1, v2) and DG-SSM, the model
                registry, JAX-variable loader and exporter, model.pt
                save/load, subset ensemble
  shape_model/  the PCA and localized statistical shape models
  losses/       CE, generalized Dice, nnU-Net, recall, Chamfer, mesh,
                DPSR and DG-SSM losses
  train/        ModelTrainer (Adam + L2, schedulers, resume), cross-val, the
                train-step timing harness
  prof/         the streaming and gather probes (P1-P5's questions asked
                of the card: python -m fissure_segmentation_tpu_torch.prof.probes)
  postprocess/  batched per-class surface fit + host mesh filter/labelmap
  serving.py    segment_case: one CT case -> keypoints, labels, meshes
  train_point_seg.py  the training entry point (python -m ...;
                --model DGCNN or PointTransformer); train_pc_ae.py,
                dseg_ae_regularization.py, train_seg_cnn.py,
                train_dpsr_net.py and train_dgcnn_ssm.py the other
                families' entry points

Devices: the entry points, ModelTrainer and the test helpers run on a CUDA
card unless the caller passes device="cpu"; without a card they raise.

The package imports torch, numpy and scipy — never jax, its NN libraries or
anything of the JAX package: what it needs of a jax-free module there
(cli, utils/coords.py, native) it keeps as its own copy.
"""
