"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): the rates the rooflines and MFUs are shares
of."""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12      # tensor cores, bf16 and fp16
F32_FLOPS = 67e12        # float32 outside the tensor cores


def least_s(n_bytes: float, n_ops: float, ops_per_s: float = F32_FLOPS):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)
