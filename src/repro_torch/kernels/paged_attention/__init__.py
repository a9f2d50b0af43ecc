"""CUDA paged-attention decode kernel (K3; replaces the Pallas
paged_attention_kernel): split-KV online softmax over a page table."""
