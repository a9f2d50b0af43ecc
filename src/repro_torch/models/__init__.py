"""Dense attention decoder in PyTorch (mirrors ``src/repro/models``)."""
