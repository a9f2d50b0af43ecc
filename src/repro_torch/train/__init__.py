"""Training (mirrors ``src/repro/train``; ``pipeline.py``, which works
across devices, is not ported yet)."""

from repro_torch.train.trainer import TrainConfig, make_train_step, train_loop

__all__ = ["TrainConfig", "make_train_step", "train_loop"]
