"""Fault-tolerant checkpointing over the port's trees of tensors (port of
``src/repro/checkpoint/manager.py``, the same on-disk format).

* **Atomic** — writes land in ``step_XXXXXXXX.tmp`` and are ``os.rename``d
  into place; a crash mid-write never corrupts the latest checkpoint.
* **Keep-k** — old steps garbage-collected after a successful save.
* **Async** — ``save_async`` copies the tree to host memory synchronously
  and writes on a background thread; a write's error is raised by the
  next ``wait``.
* **One format for both packages** — ``step_%08d/arrays.npz`` (one array
  per leaf, keyed by its path as ``jax.tree_util.keystr`` writes it,
  ``['params']['blocks'][0]['wq']``) and ``meta.json``; bf16 leaves are
  widened to f32 (npz has no bf16) and cast back to the template's dtype
  on restore.  A checkpoint written by either package restores in the
  other.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, unflatten

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _flatten(tree) -> Dict[str, np.ndarray]:
    """Each leaf as a host numpy array under its ``keystr`` path; a bf16
    (or other numpy-less float) leaf widened to f32 on its device first."""
    flat = {}
    for key, leaf in flatten_with_path(tree):
        t = torch.as_tensor(leaf).detach()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            t = t.float()
        flat[key] = t.to("cpu", copy=True).numpy()
    return flat


def _unflatten_like(template, data: Dict[str, np.ndarray], device=None):
    """``template``'s structure from ``data``: each leaf cast to its
    template leaf's dtype, on ``device`` (``None``: the template leaf's)."""
    out = []
    for key, leaf in flatten_with_path(template):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(leaf.shape)}")
        dev = leaf.device if device is None else torch.device(device)
        if dev.type == "meta":
            raise ValueError(f"{key}: a meta template leaf needs device=")
        out.append(torch.as_tensor(arr).to(device=dev, dtype=leaf.dtype))
    return unflatten(template, out)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- writing -----------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        flat = _flatten(tree)
        self._write(step, flat, metadata or {})

    def save_async(self, step: int, tree: Any, metadata: Optional[dict] = None):
        self.wait()                              # one outstanding write max
        flat = _flatten(tree)                    # snapshot now (synchronous)
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, flat, metadata or {}),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_guarded(self, step, flat, metadata):
        try:
            self._write(step, flat, metadata)
        except BaseException as e:               # surfaced on next wait()
            self._error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray], metadata: dict):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: v for k, v in flat.items()})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **metadata}, f)
        if os.path.exists(final):
            raise FileExistsError(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            path = os.path.join(self.dir, f"step_{s:08d}")
            for fn in os.listdir(path):
                os.remove(os.path.join(path, fn))
            os.rmdir(path)

    # -- reading -----------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.match(d)
            if m and os.path.isdir(os.path.join(self.dir, d)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, device=None) -> Any:
        """Restore into ``template``'s structure (a tree of tensors, meta
        ones included), each leaf in its template leaf's dtype, on
        ``device`` or, with ``None``, on its template leaf's device."""
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        return _unflatten_like(template, data, device)

    def metadata(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:08d}", "meta.json")) as f:
            return json.load(f)
