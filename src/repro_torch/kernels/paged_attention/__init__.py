"""CUDA paged-attention decode kernels: K3 (dense pool; replaces the
Pallas paged_attention_kernel) and K4 (log2-quantized pool; replaces
paged_attention_quant_kernel), split-KV online softmax over a page table."""
