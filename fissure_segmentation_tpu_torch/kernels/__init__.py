"""Hand-written CUDA kernels for Hopper (counterpart of ops/pallas/ and of
the Pallas probes under scripts/prof/): K1 kNN (knn.py), K2-K4 the EdgeConv
scatters and the graph transpose K2/K3 walk (scatter.py), K5
farthest-point sampling (fps.py), K6 the 3x3x3 depthwise convolution
(depthwise.py), the fused EdgeConv gather-reduce
(gather_reduce.py, P5's function), the streaming column sums
(stream.py, P1-P4's) and the approximate top-k's bin pass (approx_topk.py,
XLA's ApproxTopK behind lax.approx_max_k / approx_min_k, no TPU kernel).

Sources live in csrc/ and are compiled by _build.py with nvcc for sm_90a at
first use. Each kernel module holds the ctypes wrapper (which launches the
kernel for CUDA tensors and counts its launches) and the plain PyTorch
version of the same function (used for CPU tensors, and as the oracle the
kernel is compared with on the card).
"""
