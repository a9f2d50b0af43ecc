"""QeiHaN core in PyTorch: LOG2 activation quantization, int8 weights,
bit-planes and the shift-add GEMM (mirrors ``src/repro/core``)."""
