"""Meshes of ranks (port of ``src/repro/launch/mesh.py``).

A :class:`Mesh` names the axes ``("data", "model")`` over the ranks of a
group: a local group passed as ``group=`` (``--host-devices N``: N threads
on one device), the ``torch.distributed`` world (one process per card),
or none (one device).  :meth:`Mesh.run` runs a function on each rank of this process
inside the rank's :func:`models.sharding.mesh_axes` scope.  The builders
keep the reference's specs, warning and errors; the TPU pod meshes
(``pod``/``pod2``) have no counterpart.

Serving runs the model axis only: a mesh with ``data > 1`` is refused
there (:func:`check_serving`).
"""

from __future__ import annotations

import re
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.launch.host_devices import visible_ranks
from repro_torch.models import sharding as sh

AXES: Tuple[str, str] = ("data", "model")


class Mesh:
    """``data x model`` ranks over ``group`` (``LocalGroup``,
    ``DistGroup`` or None for one device).  ``shape`` maps axis name to
    size, as a jax mesh's does; ``device`` is where a local group's ranks
    run (``None``: the caller's)."""

    def __init__(self, shape: Tuple[int, int], group=None, device=None):
        d, m = (int(s) for s in shape)
        if d < 1 or m < 1:
            raise ValueError(f"mesh shape {shape}: axes must be >= 1")
        if group is not None and group.size != d * m:
            raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, the group "
                             f"has {group.size}")
        self.axis_names = AXES
        self.shape: Dict[str, int] = {"data": d, "model": m}
        self.group = group
        self.device = None if device is None else torch.device(device)

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def kind(self) -> str:
        return "single" if self.group is None else self.group.kind

    def __repr__(self) -> str:
        return (f"Mesh({self.shape['data']}x{self.shape['model']}, "
                f"{self.kind})")

    def run(self, fn: Callable[[int], object]) -> list:
        """``fn(rank)`` on each rank this process runs (every rank of a
        local group, each on its own thread; this process's rank of a
        distributed group; rank 0 of a one-device mesh), inside the rank's
        scope.  Returns their results in rank order."""
        def bound(rank: int):
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.set_device(self.device)   # threads start on 0
            with sh.mesh_axes(batch=batch_axes(self), model="model",
                              seq_shard=False, mesh=self):
                return fn(rank)
        if self.group is None:
            return [bound(0)]
        return self.group.run(bound)


def _group(n: int, group=None):
    """The group of ``n`` ranks: the caller's, else none for one rank,
    else the distributed world."""
    if group is not None or n == 1:
        return group
    return sh.DistGroup()


def make_host_mesh(model_parallel: int = 1, *, group=None, device=None):
    """``data x model`` mesh over the visible ranks.  One visible rank
    falls back to ``model_parallel=1`` with a warning, as in the
    reference; any other indivisibility raises ``ValueError``."""
    n = group.size if group is not None else visible_ranks()
    if model_parallel != 1 and n == 1:
        warnings.warn(f"make_host_mesh: only 1 device visible; falling back "
                      f"to model_parallel=1 (requested {model_parallel})",
                      stacklevel=2)
        model_parallel = 1
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"make_host_mesh: model_parallel={model_parallel} must be >= 1 "
            f"and divide the visible device count ({n} devices)")
    return Mesh((n // model_parallel, model_parallel), _group(n, group),
                device)


_MESH_SPEC_RE = re.compile(r"^(\d+)x(\d+)$")


def make_serve_mesh(spec: str, model_parallel: int = 1, *, group=None,
                    device=None):
    """Mesh from a CLI spec: ``host`` (every visible rank, ``model_parallel``
    of them on the model axis) or an explicit ``DxM`` grid.  ``pod`` and
    ``pod2``, the reference's TPU v5e pod meshes, raise."""
    if spec == "host":
        return make_host_mesh(model_parallel, group=group, device=device)
    if spec in ("pod", "pod2"):
        raise ValueError(f"mesh spec {spec!r} is the reference's TPU v5e pod "
                         f"mesh (256 or 512 chips); the port runs on cards: "
                         f"use 'host' or 'DxM'")
    m = _MESH_SPEC_RE.match(spec)
    if not m:
        raise ValueError(f"mesh spec {spec!r}: expected 'host', 'pod', "
                         f"'pod2', or 'DxM' (e.g. '2x2')")
    d, t = int(m.group(1)), int(m.group(2))
    n = group.size if group is not None else visible_ranks()
    if isinstance(group, sh.LocalGroup) and d * t < n:
        group = sh.LocalGroup(d * t, group.timeout)     # the first d*t
    if d * t > n:
        raise ValueError(f"mesh spec {spec!r} needs {d * t} devices but only "
                         f"{n} are visible (pass --host-devices {d * t} for "
                         f"{d * t} ranks on one device)")
    return Mesh((d, t), _group(d * t, group if d * t > 1 else None),
                device)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_fingerprint(mesh: Optional[Mesh]) -> Optional[tuple]:
    """Hashable identity of a mesh for program-cache keys: axis names,
    sizes, the group's kind and this process's rank (None: one device)."""
    if mesh is None:
        return None
    rank = sh.model_rank() if mesh.group is not None else 0
    return (tuple(mesh.axis_names), tuple(mesh.shape.values()), mesh.kind,
            id(mesh.group), rank)


DATA_AXIS_REASON = (
    "the port serves on the model axis only.  A data axis needs a page "
    "allocator that keeps each slot's pages on its own rank (the reference "
    "shards the page pool on 'data' while its page tables point anywhere, "
    "and GSPMD inserts the gathers), which changes page tables against the "
    "reference")


def spec_shape(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """``(D, M)`` of an explicit ``DxM`` spec (None for any other spec)."""
    m = _MESH_SPEC_RE.match(spec or "")
    return (int(m.group(1)), int(m.group(2))) if m else None


def check_serving(mesh: Optional[Mesh]) -> None:
    """Refuse what serving does not shard, and a call from outside the
    mesh's scope."""
    if mesh is None:
        return
    if mesh.shape["data"] > 1:
        raise NotImplementedError(f"{mesh!r}: {DATA_AXIS_REASON}")
    if mesh.group is not None:
        cur = sh.current()
        if cur is None or cur["mesh"] is not mesh:
            raise RuntimeError(f"{mesh!r}: call the serving entry points "
                               f"inside mesh.run(fn), on each rank's "
                               f"shard of the params")
