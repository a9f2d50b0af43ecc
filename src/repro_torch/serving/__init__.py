"""One-shot serving: prefill + greedy decode (mirrors ``src/repro/serving``)."""
