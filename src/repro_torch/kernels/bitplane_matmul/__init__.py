"""CUDA plane-skipping bit-plane shift-add GEMM (K2; replaces the Pallas
bitplane_matmul)."""
