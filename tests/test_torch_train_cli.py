"""The training CLI of the port (``launch/train.py``) on the host, held
against itself: a run stopped and resumed from its checkpoint repeats an
uninterrupted run bit for bit, and without ``--device cpu`` the CLI needs
a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train as train_cli

REPO = Path(__file__).resolve().parents[1]


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])


def _cli(ckpt, steps, resume):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "smollm-135m", "--smoke", "--device", "cpu", "--global-batch",
           "4", "--seq-len", "32", "--micro-batches", "2", "--steps",
           str(steps), "--checkpoint-dir", str(ckpt), "--checkpoint-every",
           "1", "--resume", resume]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def _steps(lines):
    return {d["step"]: (d["loss"], d["grad_norm"]) for d in
            (json.loads(x) for x in lines if x.startswith("{"))}


def test_cli_resume_equals_an_uninterrupted_run(tmp_path):
    """Kill-and-restart through the CLI: 8 steps straight, against 5 then
    a ``--resume auto`` run to 8.  The resumed run says so, logs steps 5-7
    and not 4, with the straight run's losses and grad norms; the
    checkpoints both write at steps 6, 7 and 8 hold equal leaves, bit for
    bit."""
    straight = _cli(tmp_path / "a", 8, "none")
    first = _cli(tmp_path / "b", 5, "auto")
    resumed = _cli(tmp_path / "b", 8, "auto")
    assert "[train] resumed from step 5" in resumed
    assert straight[-1] == first[-1] == resumed[-1] == "[train] done"
    a, b1, b2 = _steps(straight), _steps(first), _steps(resumed)
    assert sorted(a) == list(range(8)) and sorted(b2) == [5, 6, 7]
    assert all(b1[s] == a[s] for s in range(5))
    assert all(b2[s] == a[s] for s in range(5, 8))
    ma, mb = (CheckpointManager(str(tmp_path / d)) for d in "ab")
    assert ma.all_steps() == mb.all_steps() == [6, 7, 8]
    for step in (6, 7, 8):
        with np.load(tmp_path / "a" / f"step_{step:08d}" / "arrays.npz") as za, \
                np.load(tmp_path / "b" / f"step_{step:08d}"
                        / "arrays.npz") as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].tobytes() == zb[k].tobytes(), (step, k)
