"""Hand-written CUDA kernels for Hopper (counterpart of ops/pallas/): K1 kNN
(knn.py), K2-K4 the EdgeConv scatters (scatter.py), K5 farthest-point
sampling (fps.py), K6 the 3x3x3 depthwise convolution (depthwise.py).

Sources live in csrc/ and are compiled by _build.py with nvcc for sm_90a at
first use. Each kernel module holds the ctypes wrapper (which launches the
kernel for CUDA tensors and counts its launches) and the plain PyTorch
version of the same function (used for CPU tensors, and as the oracle the
kernel is compared with on the card).
"""
