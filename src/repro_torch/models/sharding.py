"""The model axis of the port: rank groups, the scope that binds a rank to
a mesh, and the collectives the model code calls (port of
``src/repro/models/sharding.py``).

The reference is single-controller SPMD: models place ``shard(x, kind)``
hints, GSPMD reads them and inserts the collectives.  The port is
multi-controller and explicit: every rank runs the same Python on its own
shard of each weight (``launch.shardings.shard_params``) and calls a
collective where the reference's layout changes.  Outside a
:func:`mesh_axes` scope (one card, the tests' single-device runs) every
helper here is the identity, so the single-card path is unchanged.

Two groups carry the collectives:

* :class:`LocalGroup` — N ranks as N threads of one process on one
  device (the CPU or one card), the counterpart of the reference's
  ``--host-devices N``.  The ranks take turns, one running at a time and
  each collective handing the turn on; tensors meet in shared slot lists,
  and every rank sums the slots in rank order, so all ranks hold the same
  bits.  A rank that raises breaks the group, and every other rank fails
  at once; a rank whose turn does not come within ``timeout`` fails every
  rank.  All ranks share the device's current stream, so a rank reading
  another rank's tensor is ordered after the kernels that wrote it.
* :class:`DistGroup` — ``torch.distributed`` (NCCL on cards, one process
  per card; gloo on the CPU).  Its sum is an ``all_gather`` summed in
  rank order too, so both groups give the same bits.

``all_to_all`` is not here: the tokens-replicated expert-parallel branch
of ``models/moe.py`` needs none (the all_to_all branch belongs to
training's layouts).  ``shard`` and ``replicate`` are not ported: without
GSPMD they have nothing to hint.  :func:`spec_for` keeps the reference's
kind table and divisibility fallback for the rules.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

_state = threading.local()

_KIND_LAYOUT = {
    # kind -> role per dim: 'b' batch, 's' seq (SP), 'cs' cache seq,
    # 'm' model, None replicate (the reference's table)
    "btd": ("b", "s", None),
    "btf": ("b", None, "m"),
    "bthd": ("b", None, "m", None),
    "btv": ("b", None, "m"),
    "ecd": ("m", None, None),
    "bshp": ("b", None, "m", None),
    "bchll": ("b", None, "m", None, None),
    "bchpn": ("b", None, "m", None, None),
    "cache": ("b", "cs", None, None),
    "pool": ("b", None, None, None),
    "kvsplit": ("b", None, "m", None, None),
    "kvsplit_stat": ("b", None, "m", None),
    "btc": ("b", None, None),
}


# ---------------------------------------------------------------------------
# rank groups
# ---------------------------------------------------------------------------

class LocalGroup:
    """``size`` ranks as threads of this process on one device.

    :meth:`run` starts one thread per rank and returns every rank's
    result in rank order; the collectives are called from inside it.  The
    ranks take turns: one rank runs at a time and hands the turn to the
    next at each collective (round robin), so the threads do not contend
    for the interpreter lock, which every tensor op releases and takes
    back (four contending threads ran the CPU tests about twice as
    slowly).  A collective's tensors meet in one of two slot lists (by the
    parity of its index), which keeps a rank's next deposit from
    overwriting slots another rank has still to read.
    ``barrier_seconds[r]`` is the host time rank ``r`` spent waiting for
    its turn: the other ranks' host work."""

    kind = "local"

    def __init__(self, size: int, timeout: float = 300.0):
        if size < 1:
            raise ValueError(f"a group needs at least one rank, got {size}")
        self.size = int(size)
        self.timeout = float(timeout)
        self._tls = threading.local()
        self._reset()

    def _reset(self) -> None:
        self._slots: List[list] = [[None] * self.size, [None] * self.size]
        self._count = [0] * self.size
        self._turn = [threading.Event() for _ in range(self.size)]
        self._done = [False] * self.size
        self._broken = False
        self.barrier_seconds = [0.0] * self.size

    @property
    def rank(self) -> int:
        r = getattr(self._tls, "rank", None)
        if r is None:
            raise RuntimeError("a LocalGroup collective was called outside "
                               "LocalGroup.run")
        return r

    def _pass(self, r: int) -> None:
        """Hand the turn to the next rank that has not ended."""
        for i in range(1, self.size + 1):
            nxt = (r + i) % self.size
            if not self._done[nxt]:
                self._turn[nxt].set()
                return

    def _wait(self, r: int) -> None:
        t0 = time.perf_counter()
        if not self._turn[r].wait(self.timeout) or self._broken:
            self._break()
            raise RuntimeError(
                f"local group: rank {r} left a collective because another "
                f"rank failed or its turn did not come within "
                f"{self.timeout:g} s")
        self._turn[r].clear()
        self.barrier_seconds[r] += time.perf_counter() - t0

    def _break(self) -> None:
        self._broken = True
        for ev in self._turn:
            ev.set()

    def _exchange(self, x) -> list:
        r = self.rank
        slots = self._slots[self._count[r] % 2]
        self._count[r] += 1
        slots[r] = x
        self._pass(r)
        self._wait(r)
        behind = [i for i in range(self.size)
                  if self._count[i] < self._count[r]]
        if behind:
            self._break()
            raise RuntimeError(f"local group: rank {behind[0]} ended before "
                               f"collective {self._count[r] - 1} of rank {r}")
        return list(slots)

    def barrier(self) -> None:
        self._exchange(None)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._exchange(x), dim=dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def run(self, fn: Callable[[int], object]) -> list:
        """``[fn(0), ..., fn(size - 1)]``, each on its own thread, rank 0
        first.  The first rank that raises breaks the group (every waiting
        rank raises); its exception is re-raised here once every thread
        has ended."""
        results: list = [None] * self.size
        errors: list = [None] * self.size
        self._reset()

        def work(r: int) -> None:
            self._tls.rank = r
            try:
                self._wait(r)
                results[r] = fn(r)
            except BaseException as e:          # noqa: BLE001
                errors[r] = e
                self._break()
            finally:
                self._done[r] = True
                self._tls.rank = None
                self._pass(r)

        threads = [threading.Thread(target=work, args=(r,), daemon=True,
                                    name=f"rank{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        self._turn[0].set()
        for t in threads:
            t.join()
        self._slots = [[None] * self.size, [None] * self.size]
        failed = [e for e in errors if e is not None]
        if failed:
            # the rank that failed first, not the ranks its failure woke
            first = next((e for e in failed if not (
                isinstance(e, RuntimeError) and "local group:" in str(e))),
                failed[0])
            raise first
        return results


class DistGroup:
    """The ranks of a ``torch.distributed`` process group; this process is
    one of them.  :meth:`run` runs ``fn`` for this process's rank only."""

    kind = "dist"

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs torch.distributed."
                               "init_process_group first")
        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self._rank = dist.get_rank(group)
        self.barrier_seconds = [0.0] * self.size

    @property
    def rank(self) -> int:
        return self._rank

    def barrier(self) -> None:
        t0 = time.perf_counter()
        self._dist.barrier(group=self.group)
        self.barrier_seconds[self._rank] += time.perf_counter() - t0

    def _gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x, group=self.group)
        return parts

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._gather(x), dim=dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        parts = self._gather(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def run(self, fn: Callable[[int], object]) -> list:
        return [fn(self._rank)]


# ---------------------------------------------------------------------------
# the scope
# ---------------------------------------------------------------------------

def _axes():
    return getattr(_state, "axes", None)


@contextlib.contextmanager
def mesh_axes(batch: Sequence[str] | str | None = ("data",),
              model: Optional[str] = "model",
              seq_shard: bool = True,
              cache_seq_axis: Optional[str] = None,
              sizes: Optional[Dict[str, int]] = None,
              mesh=None,
              ep_axis: Optional[str] = None):
    """Bind this thread to ``mesh`` (``launch.mesh.Mesh``) for the scope:
    the collectives below reach its group, and the axis sizes drive the
    divisibility rules.  ``sizes`` defaults to ``dict(mesh.shape)``."""
    prev = _axes()
    batch_t = tuple(batch) if isinstance(batch, (tuple, list)) else (
        (batch,) if batch else ())
    if mesh is not None and sizes is None:
        sizes = dict(mesh.shape)
    _state.axes = dict(batch=batch_t, model=model, seq_shard=seq_shard,
                       cache_seq_axis=cache_seq_axis, sizes=sizes or {},
                       mesh=mesh, ep_axis=ep_axis if ep_axis else model,
                       group=getattr(mesh, "group", None))
    try:
        yield
    finally:
        _state.axes = prev


def current() -> Optional[dict]:
    """The active binding (None outside any :func:`mesh_axes` scope)."""
    return _axes()


def _fits(dim_size: int, axis, sizes: Dict[str, int]) -> bool:
    if axis is None:
        return False
    names = axis if isinstance(axis, tuple) else (axis,)
    total = 1
    for n in names:
        total *= sizes.get(n, 1)
    if total <= 1:
        return False
    return dim_size % total == 0


def spec_for(kind: str, shape, force: bool = False) -> Optional[tuple]:
    """The reference's hint spec for a tensor of ``kind``: a tuple of axis
    names (or None) per dim, with its divisibility fallback; None outside
    a scope, or when every dim stays replicated and not ``force``."""
    ax = _axes()
    if ax is None:
        return None
    layout = _KIND_LAYOUT.get(kind)
    if layout is None:
        raise ValueError(f"unknown sharding kind {kind!r}")
    if len(layout) != len(shape):
        return None
    sizes = ax["sizes"]
    b = ax["batch"] if ax["batch"] else None
    m = ax["model"]
    entries = []
    for role, dim in zip(layout, shape):
        target = None
        if role == "b":
            target = b
        elif role == "m":
            target = m
        elif role == "s":
            target = m if ax["seq_shard"] else None
        elif role == "cs":
            target = ax["cache_seq_axis"] or m
        if target is not None and (not sizes or _fits(dim, target, sizes)):
            # a one-name tuple is that name, as PartitionSpec normalizes it
            entries.append(target[0] if isinstance(target, tuple)
                           and len(target) == 1 else target)
        else:
            entries.append(None)
    if all(e is None for e in entries) and not force:
        return None
    return tuple(entries)


# ---------------------------------------------------------------------------
# what the model code calls (identities outside a scope)
# ---------------------------------------------------------------------------

def model_size() -> int:
    """Ranks on the model axis (1 outside a scope)."""
    ax = _axes()
    if ax is None or ax["model"] is None or ax["group"] is None:
        return 1
    return int(ax["sizes"].get(ax["model"], 1))


def model_rank() -> int:
    """This rank's index on the model axis (0 outside a scope)."""
    if model_size() == 1:
        return 0
    return _axes()["group"].rank


def parts(n: int) -> int:
    """How many ranks a dim of ``n`` is cut into: the model axis size when
    it divides ``n``, else 1 (the dim stays replicated)."""
    m = model_size()
    return m if m > 1 and n % m == 0 else 1


def local_kv_heads(cfg) -> int:
    """KV heads a rank holds: the port shards attention only at head
    granularity (``launch.shardings``), when the kv heads divide."""
    return cfg.n_kv_heads // parts(cfg.n_kv_heads)


def local_ssm_heads(cfg) -> int:
    """SSD heads a rank holds (the inner dim follows its heads)."""
    return cfg.ssm_heads // parts(cfg.ssm_heads)


def rank_slice(n_local: int) -> slice:
    """This rank's run ``[r * n_local, (r + 1) * n_local)`` of a dim cut
    into equal parts of ``n_local``."""
    r = model_rank()
    return slice(r * n_local, (r + 1) * n_local)


def cut_of(full: int, local: int, what: str) -> int:
    """How many ranks a dim of ``full`` is cut into, read from the width
    ``local`` this rank holds: 1 (whole) or the model axis size.  Any
    other width, a narrower dim outside a scope included, is a shard cut
    for another mesh and raises, rather than compute a part of the
    function."""
    m = model_size()
    if local == full:
        return 1
    if m > 1 and local * m == full:
        return m
    where = f"a rank of {m}" if m > 1 else "outside a mesh scope"
    raise ValueError(f"{what}: {local} of {full} held {where}, neither the "
                     f"whole dim nor 1/{m} of it")


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model axis, in rank order."""
    if model_size() == 1:
        return x
    return _axes()["group"].all_reduce(x)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if model_size() == 1:
        return x
    return _axes()["group"].all_gather(x, dim)


def barrier() -> None:
    if model_size() > 1:
        _axes()["group"].barrier()


def local_group_bound() -> bool:
    """True inside the scope of a :class:`LocalGroup` of several ranks."""
    ax = _axes()
    g = None if ax is None else ax["group"]
    return isinstance(g, LocalGroup) and g.size > 1
