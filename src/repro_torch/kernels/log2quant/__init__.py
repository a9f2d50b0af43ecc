"""CUDA LOG2 activation quantizer (K1; replaces the Pallas log2quant)."""
