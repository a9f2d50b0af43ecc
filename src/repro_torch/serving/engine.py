"""Serving layer: prefill and single-token decode steps, the
autoregressive generation loop, the slot-pool steps of continuous
batching, and the program type that runs each of them as one CUDA graph
(port of ``src/repro/serving/engine.py`` without its mesh plumbing).

Where the reference compiles a function into one XLA program with
``jax.jit``, the port captures it into a :class:`Program`: one
``torch.cuda.CUDAGraph`` per static input signature, captured at the
first call and replayed at every later one (the counterpart of the
reference's ``jit_sharded`` and ``compiled_size``).  On the CPU the same
body runs eagerly into the same static buffers; :func:`eager` makes every
program do that on the card too, as ``jax.disable_jit()`` does for the
reference.

:func:`greedy_generate` is one program per static configuration (prefill
plus every decode step), kept in an LRU that ``set_generate_cache_size``
bounds, like the reference's ``generate_fn``: the first token comes from
the prefill logits and ``max_new - 1`` decode forwards follow.  With
``eos_id`` the reference's ``lax.while_loop`` stops once every row is
done; a graph cannot, so the program runs every forward with finished
rows' tokens held at ``eos_id`` and zeroes the stats of each forward taken
after every row is done: tokens and stats equal the reference's.
:func:`reference_generate` keeps the per-token loop that runs a forward
after every token, as the reference does.

Quantized serving (``quant=True``) sends every projection of prefill and
decode through the CUDA kernels (the reference's prefill uses its plain
``"xla"`` form; both are exact, so tokens do not depend on it).

The slot-pool steps (:func:`make_slot_serve_step`, :func:`make_slot_prefill`,
:func:`make_slot_prefill_chunk`) are the bodies of
``serving/scheduler.py``'s programs: they take per-slot ``(B,)`` lengths
and, ``paged=True``, a page table.  ``quant`` may be the reference's
backend names (``"pallas"``, ``"xla"``): both select the CUDA kernels.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.shiftadd import QuantCtx, as_quant_ctx
from repro_torch.models.model import (ModelConfig, _leaves, forward,
                                      init_caches)

QuantFlag = Union[bool, str, QuantCtx]


def _quant_ctx(quant: QuantFlag):
    """bool | backend name | QuantCtx -> QuantCtx or None.  A backend name
    (the reference's ``"pallas"`` / ``"xla"``) means quantized: the port
    has one quantized path, its CUDA kernels."""
    if isinstance(quant, str):
        return as_quant_ctx(True)
    return as_quant_ctx(quant)


# ---------------------------------------------------------------------------
# programs: one CUDA graph per static input signature
# ---------------------------------------------------------------------------

_EAGER = False


@contextlib.contextmanager
def eager():
    """Run every :class:`Program` body eagerly, on the card too (no
    capture, no replay), through the same static buffers: the port's
    ``jax.disable_jit()``.  ``chip_smoke.py`` and the card tests hold the
    graphs against it."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


def launch_counts() -> Dict[str, int]:
    """Every CUDA kernel wrapper's ``.launches`` count, by name."""
    from repro_torch.kernels.bitplane_matmul import ops as bm_ops
    from repro_torch.kernels.log2quant import ops as l2_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    return {k.__name__: k.launches
            for k in (l2_ops.log2quant, bm_ops.bitplane_matmul,
                      pa_ops.paged_attention, pa_ops.paged_attention_quant)}


def fingerprint(tree) -> tuple:
    """Address, shape, stride and dtype of every tensor of ``tree``: what a
    captured graph bakes in."""
    return tuple((t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
                 for t in _leaves(tree))


def _as_input(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x))


class _Entry:
    """One static signature of a program: its input buffers, its outputs,
    and on the card its graph, launch census and replay count."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.outputs = None
        self.graph = None
        self.census: Optional[Dict[str, int]] = None
        self.capture_ms: Optional[float] = None
        self.calls = 0          # eager runs and replays
        self.replays = 0


class Program:
    """``body(*inputs) -> tuple of tensors`` captured as one CUDA graph per
    static input signature (shapes and dtypes), the port's ``jax.jit``.

    ``inputs`` are tensors (any device) or numpy arrays; each call copies
    them into the signature's static device buffers.  On the card the
    first call warms the body up on a side stream (lazy kernel builds,
    library loads, kernel attributes; host syncs raise there, under
    ``torch.cuda.set_sync_debug_mode("error")``), restores ``carry`` (the
    tensors the body advances) and ``generators`` (their seed and
    offset), collects Python's garbage (a dead program's graph destroyed
    mid-capture would invalidate the capture), captures the body into the
    graph with the cyclic collector paused, with ``generators``
    registered so that replays advance them, and replays it; every later
    call replays.  A capture that fails raises.  On the CPU, or under
    :func:`eager`, the body runs eagerly into the same buffers.  Returns
    the signature's static outputs, which the next call overwrites.

    The body reads everything else (weights, the slot pool) by address:
    ``bound()`` returns those tensors, and a call that finds any of them
    moved or reshaped since the signature was built raises instead of
    replaying into dead memory.  ``mem_pool`` (``torch.cuda.
    graph_pool_handle()``) shares one private memory pool among the
    graphs of programs that never run concurrently and whose outputs are
    read before another of them replays (a scheduler's programs).
    """

    def __init__(self, body: Callable, *, name: str, device,
                 carry: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = (),
                 bound: Optional[Callable[[], Any]] = None, mem_pool=None):
        self.body = body
        self.name = name
        self.device = torch.device(device)
        self.carry = tuple(carry)
        self.generators = tuple(generators)
        self.bound = bound
        self.mem_pool = mem_pool
        self._entries: "collections.OrderedDict[tuple, _Entry]" = \
            collections.OrderedDict()
        self._bound_fp = None

    def __call__(self, *inputs):
        xs = [_as_input(x) for x in inputs]
        sig = tuple((tuple(x.shape), x.dtype) for x in xs)
        e = self._entries.get(sig)
        if e is None:
            e = self._entries[sig] = _Entry(
                [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                 for x in xs])
        self._check_bound()
        for buf, x in zip(e.inputs, xs):
            buf.copy_(x)
        e.calls += 1
        if self.device.type != "cuda" or _EAGER:
            out = self.body(*e.inputs)
            if e.outputs is None:
                e.outputs = tuple(t.clone() for t in out)
            else:
                for buf, t in zip(e.outputs, out):
                    buf.copy_(t)
            return e.outputs
        if e.graph is None:
            self._capture(e)
        e.graph.replay()
        e.replays += 1
        return e.outputs

    def _check_bound(self) -> None:
        if self.bound is None:
            return
        fp = fingerprint(self.bound())
        if self._bound_fp is None:
            self._bound_fp = fp
        elif fp != self._bound_fp:
            raise RuntimeError(
                f"program {self.name!r}: a tensor its body reads by address "
                f"was rebound or reshaped; a replay would read dead memory")

    def _capture(self, e: _Entry) -> None:
        dev = self.device
        saved = [t.clone() for t in self.carry]
        rng = [(g.initial_seed(), g.get_offset()) for g in self.generators]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():     # "a prototype feature"
            warnings.simplefilter("ignore", UserWarning)
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                self.body(*e.inputs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, s in zip(self.carry, saved):
            t.copy_(s)
        for g, (seed, offset) in zip(self.generators, rng):
            g.manual_seed(seed)
            g.set_offset(offset)
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:       # a torch without keep_graph
            graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = launch_counts()
        t0 = time.perf_counter()
        pool = () if self.mem_pool is None else (self.mem_pool,)
        # a dead program's graphs left in a reference cycle must not be
        # destroyed by the cyclic collector in the middle of this capture:
        # destroying a graph while a stream captures invalidates the capture
        collect = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, *pool):
                out = self.body(*e.inputs)
        finally:
            if collect:
                gc.enable()
        if hasattr(graph, "instantiate"):
            graph.instantiate()
        torch.cuda.synchronize(dev)
        e.capture_ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        e.census = {k: after[k] - before[k] for k in after}
        e.graph, e.outputs = graph, out

    # ---------------------------------------------------------- inspection

    def entries(self):
        return list(self._entries.values())

    def static_inputs(self) -> Dict[tuple, torch.Tensor]:
        """``{(signature, i): buffer}`` over every signature built."""
        return {(sig, i): t for sig, e in self._entries.items()
                for i, t in enumerate(e.inputs)}

    @property
    def calls(self) -> int:
        return sum(e.calls for e in self._entries.values())

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches the replays ran: each graph's capture census
        times its replay count, summed."""
        out: Dict[str, int] = collections.Counter()
        for e in self._entries.values():
            for k, n in (e.census or {}).items():
                out[k] += n * e.replays
        return dict(out)


def compiled_size(program: Program) -> int:
    """Static signatures a program has built (on the card, captured
    graphs): the reference's compiled-program count."""
    return len(program._entries)


def graph_nodes(entry: _Entry) -> Optional[Tuple[int, int]]:
    """``(kernel nodes, all nodes)`` of a captured graph, read through the
    CUDA API's ``cuGraphGetNodes`` (libcuda); None where the graph was
    not kept."""
    if entry.graph is None:
        return None
    try:
        raw = entry.graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n)):
        return None
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(ctypes.c_void_p(raw), nodes, ctypes.byref(n)):
        return None
    kind = ctypes.c_int(0)
    kernels = 0
    for node in nodes:
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kernels += kind.value == 0          # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels, n.value


# ---------------------------------------------------------------------------
# steps and the one-shot loop
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, quant: QuantFlag = False):
    """(params, batch, caches) -> (last-token logits, caches).  ``batch``
    holds ``tokens``, or ``embeds`` (audio stub), and ``image_embeds``
    with a vision stub."""
    ctx = _quant_ctx(quant)

    def prefill_step(params, batch, caches):
        logits, caches = forward(cfg, params, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"),
                                 image_embeds=batch.get("image_embeds"),
                                 caches=caches, quant=ctx)
        return logits[:, -1], caches
    return prefill_step


def make_serve_step(cfg: ModelConfig, quant: QuantFlag = False,
                    with_stats: bool = False):
    """(params, caches, token (B, 1)) -> (logits, caches[, stats]): one new
    token against a pre-filled cache.  An audio-stub model decodes from a
    frame embedding (B, 1, d) in place of the token id."""
    ctx = _quant_ctx(quant)
    key = "embeds" if cfg.frontend == "audio_stub" else "tokens"

    def serve_step(params, caches, token):
        out = forward(cfg, params, caches=caches, quant=ctx,
                      return_stats=with_stats, **{key: token})
        if with_stats:
            logits, caches, stats = out
            return logits[:, -1], caches, stats
        logits, caches = out
        return logits[:, -1], caches
    return serve_step


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax, or one draw from ``softmax(logits / temperature)``
    by the exponential race that ``torch.multinomial`` runs for one sample
    (``argmax(p / E)``, ``E ~ Exp(1)``), without its host-side check of
    ``p``, which a graph cannot capture."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


def make_decode_loop(cfg: ModelConfig, max_new: int, *,
                     temperature: float = 0.0, quant: QuantFlag = False,
                     eos_id: Optional[int] = None, with_stats: bool = False):
    """Build ``decode(params, caches, logits, generator) -> (tokens,
    stats)``, the body of the one-shot program: no host synchronisation.

    ``caches`` are pre-filled and ``logits`` is the last prompt token's
    distribution.  Returns tokens ``(B, max_new)`` int32 and, with
    ``with_stats``, per-step ``(max_new,)`` ``plane_traffic_fraction`` and
    ``element_traffic_fraction`` (entry ``i`` is the forward that consumed
    token ``i``; the last slot, whose forward would be dead, reports 0),
    else ``None``.  With ``eos_id`` a row's tokens after its first
    ``eos_id`` are ``eos_id``, and a forward taken once every row is done
    reports 0, as the reference's early-exit loop does.
    """
    step = make_serve_step(cfg, quant, with_stats=with_stats)

    def decode(params, caches, logits, generator=None):
        b = logits.shape[0]
        dev = logits.device
        zero = torch.zeros((2,), dtype=torch.float32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        toks, fracs = [], []
        for i in range(max_new):
            tok = _sample(logits, temperature, generator)
            if eos_id is not None:
                tok = torch.where(done, eos_id, tok)
                done = done | (tok == eos_id)
            toks.append(tok)
            if i + 1 >= max_new:
                fracs.append(zero)     # the dead forward is skipped
                break
            out = step(params, caches, tok[:, None])
            if with_stats:
                logits, caches, stats = out
                frac = torch.stack([stats["plane_traffic_fraction"],
                                    stats["element_traffic_fraction"]])
                if eos_id is not None:
                    frac = torch.where(done.all(), 0.0, frac)
                fracs.append(frac)
            else:
                logits, caches = out
        toks = torch.stack(toks, dim=1)
        if not with_stats:
            return toks, None
        fracs = torch.stack(fracs)
        return toks, {"plane_traffic_fraction": fracs[:, 0],
                      "element_traffic_fraction": fracs[:, 1]}
    return decode


def _check_inputs(params, prompt: torch.Tensor, device):
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"not on {dev}")
    return dev, prompt.to(dev)


class _Generate:
    """Prefill plus the decode loop as one :class:`Program` (one graph
    per prompt shape) for one static configuration and one set of
    weights.  On the card, temperature sampling draws from a generator
    of the program's own, registered with its graphs: each call seeds it
    from the caller's generator and hands the advanced offset back."""

    def __init__(self, cfg: ModelConfig, max_new: int, temperature: float,
                 quant: bool, eos_id: Optional[int], with_stats: bool,
                 dev: torch.device):
        prefill = make_prefill_step(cfg, quant)
        decode = make_decode_loop(cfg, max_new, temperature=temperature,
                                  quant=quant, eos_id=eos_id,
                                  with_stats=with_stats)
        self.sampling = temperature > 0.0
        self.own = (torch.Generator(device=dev)
                    if self.sampling and dev.type == "cuda" else None)
        self._bind: Dict[str, Any] = {}

        def generate(prompt):
            params, gen = self._bind["params"], self._bind["generator"]
            b, s = prompt.shape
            caches = init_caches(cfg, b, max_len=s + max_new,
                                 dtype=cfg.dtype, device=prompt.device)
            logits, caches = prefill(params, {"tokens": prompt}, caches)
            toks, stats = decode(params, caches, logits, gen)
            if stats is None:
                return (toks,)
            return toks, torch.stack([stats["plane_traffic_fraction"],
                                      stats["element_traffic_fraction"]])

        self.program = Program(
            generate, name="generate", device=dev,
            generators=() if self.own is None else (self.own,))

    def __call__(self, params, prompt, generator):
        gen = generator
        if self.own is not None:
            self.own.manual_seed(generator.initial_seed())
            self.own.set_offset(generator.get_offset())
            gen = self.own
        self._bind.update(params=params, generator=gen)
        try:
            out = self.program(prompt)
        finally:
            self._bind.clear()
        if self.own is not None:
            generator.set_offset(self.own.get_offset())
        return out


class _GenerateFnCache:
    """LRU of one-shot generate programs, one per static configuration
    and set of weights (a graph bakes in their addresses): repeated
    generates of one configuration capture once per prompt shape.  The
    bound is adjustable; the serve scheduler sizes it from its
    ``ServeConfig`` through :func:`set_generate_cache_size`."""

    def __init__(self, maxsize: int = 64):
        self._data: "collections.OrderedDict[tuple, _Generate]" = \
            collections.OrderedDict()
        self._maxsize = maxsize

    def __call__(self, cfg: ModelConfig, params, max_new: int,
                 temperature: float, quant: bool, eos_id: Optional[int],
                 with_stats: bool, dev: torch.device) -> _Generate:
        key = (cfg, max_new, temperature, quant, eos_id, with_stats, str(dev),
               fingerprint(params))
        fn = self._data.get(key)
        if fn is None:
            fn = self._data[key] = _Generate(cfg, max_new, temperature,
                                             quant, eos_id, with_stats, dev)
        self._data.move_to_end(key)
        while len(self._data) > self._maxsize:
            self._data.popitem(last=False)
        return fn

    def __len__(self) -> int:
        return len(self._data)

    @property
    def maxsize(self) -> int:
        return self._maxsize

    def set_maxsize(self, maxsize: int) -> None:
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self._maxsize = maxsize
        while len(self._data) > self._maxsize:
            self._data.popitem(last=False)

    def cache_clear(self) -> None:
        self._data.clear()


generate_fn = _GenerateFnCache()


def clear_generate_cache() -> None:
    """Drop every cached generate program (and its graphs' memory); the
    next generate per configuration captures again."""
    generate_fn.cache_clear()


def set_generate_cache_size(maxsize: int) -> None:
    """Bound the generate-program LRU: callers that know their live
    configuration count (the serve scheduler) size it so that no program
    in rotation is evicted."""
    generate_fn.set_maxsize(maxsize)


def greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                    max_new: int, *, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    quant: bool = False, eos_id: Optional[int] = None,
                    with_stats: bool = False, device=None):
    """Batched generation, prefill then every decode step, as one program
    (on the card one CUDA-graph replay per call after the first).
    Returns tokens ``(B, max_new)``; with ``with_stats=True``, ``(tokens,
    stats)``.  ``generator`` drives temperature sampling (default: seed 0
    on the device) and is advanced by the draws."""
    if not isinstance(quant, bool):
        raise TypeError("greedy_generate takes quant as bool; build a "
                        "custom loop via make_decode_loop for a QuantCtx")
    dev, prompt = _check_inputs(params, prompt, device)
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    fn = generate_fn(cfg, params, int(max_new), float(temperature), quant,
                     None if eos_id is None else int(eos_id),
                     bool(with_stats), dev)
    out = fn(params, prompt.to(torch.int32), generator)
    toks = out[0].clone()
    if not with_stats:
        return toks
    fracs = out[1].clone()
    return toks, {"plane_traffic_fraction": fracs[0],
                  "element_traffic_fraction": fracs[1]}


def reference_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                       max_new: int, *, temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       quant: bool = False, device=None) -> torch.Tensor:
    """The per-token loop with a forward after every token, run eagerly
    on any device: the semantic oracle for :func:`greedy_generate`, not a
    serving path."""
    dev, prompt = _check_inputs(params, prompt, device)
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    b, s = prompt.shape
    caches = init_caches(cfg, b, max_len=s + max_new, dtype=cfg.dtype,
                         device=dev)
    prefill = make_prefill_step(cfg, quant)
    step = make_serve_step(cfg, quant)
    logits, caches = prefill(params, {"tokens": prompt}, caches)
    toks = []
    for _ in range(max_new):
        cur = _sample(logits, temperature, generator)
        toks.append(cur)
        logits, caches = step(params, caches, cur[:, None])
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# slot-pool steps (continuous batching)
# ---------------------------------------------------------------------------

def _mask_recurrent_rows(layers, rows: torch.Tensor) -> None:
    """In-place per-row select over the SSM/conv *recurrent* leaves of a
    stacked cache ``layers`` tuple (leaf layout ``(R, B, ...)``): rows
    where ``rows`` is False restart from zero state; attention K/V
    (offset writes, masked and overwritten, never carried) is left alone.

    A recurrence carries (junk tokens fed to a masked row would compound
    into its state), so every slot-pool step selects rows' state: the
    chunk step resets its ``fresh`` rows here, and the decode step's
    forward applies the same select to each layer's new state as it
    writes it (``forward(state_rows=active)``), which keeps an inactive
    slot's state without a copy of the pool's."""
    for c in layers:
        if "ssm" in c:
            for t in c.values():
                keep = rows.reshape((1, -1) + (1,) * (t.dim() - 2))
                t.copy_(torch.where(keep, t, 0))


def make_slot_serve_step(cfg: ModelConfig, quant: QuantFlag = False,
                         with_stats: bool = False, *, paged: bool = False):
    """``(params, caches, tokens (B, 1), active (B,)[, page_table]) ->
    (logits, caches[, stats])``: one decode step of every slot.

    Every row computes; ``active`` masks the bookkeeping: an inactive
    slot's ``length`` does not advance (its junk K/V row lands at the
    frozen length, where the next real write overwrites it) and its
    SSM/conv state is left as it was.
    ``caches["length"]`` is the per-slot ``(B,)`` form.  ``paged=True``
    takes a ``page_table (B, n_blocks)`` and page-pool caches
    (``init_paged_pool``); with ``cfg.paged_attn_kernel != "off"`` the read
    walks the table in the paged-attention kernel.  With
    ``with_stats=True`` the stats are the batch-aggregate plane traffic of
    the step."""
    ctx = _quant_ctx(quant)

    def slot_step(params, caches, tokens, active, page_table=None):
        if paged and page_table is None:
            raise ValueError("a paged slot step needs a page_table")
        out = forward(cfg, params, tokens=tokens, caches=caches, quant=ctx,
                      return_stats=with_stats,
                      page_table=page_table if paged else None,
                      state_rows=active)
        if with_stats:
            logits, new_caches, stats = out
        else:
            logits, new_caches = out
        new_caches = {"layers": new_caches["layers"],
                      "length": torch.where(active, new_caches["length"],
                                            caches["length"])}
        if with_stats:
            return logits[:, -1], new_caches, stats
        return logits[:, -1], new_caches
    return slot_step


def _last_real(logits: torch.Tensor, n_real: torch.Tensor) -> torch.Tensor:
    """``logits (B, S, V)`` at each row's position ``n_real - 1`` (0 for
    rows with none)."""
    b, _, v = logits.shape
    idx = torch.clamp(n_real.long() - 1, min=0)[:, None, None].expand(b, 1, v)
    return torch.gather(logits, 1, idx)[:, 0]


def make_slot_prefill(cfg: ModelConfig, quant: QuantFlag = False):
    """``(params, prompt (B, bucket), true_len (B,), caches) -> (last-real
    logits (B, V), caches)``: bucketed prefill for slot admission.  The
    prompt is right-padded to its bucket; pads sit causally after every
    real token, and their junk K/V rows lie past ``length``.  The cache's
    ``length`` becomes the per-row true length."""
    ctx = _quant_ctx(quant)

    def prefill(params, prompt, true_len, caches):
        logits, caches = forward(cfg, params, tokens=prompt, caches=caches,
                                 quant=ctx, valid_len=true_len)
        caches = {"layers": caches["layers"], "length": true_len}
        return _last_real(logits, true_len), caches
    return prefill


def make_slot_prefill_chunk(cfg: ModelConfig, quant: QuantFlag = False,
                            with_stats: bool = False, *,
                            paged: bool = False):
    """``(params, pool, pool_logits, tokens (B, chunk_len), chunk_valid
    (B,), fresh (B,), finishing (B,)[, page_table]) -> (logits (B, V),
    pool[, stats])``: one prompt chunk per prefilling slot, written
    straight into the slot pool.

    Each prefilling row feeds its next ``chunk_valid[b]`` prompt tokens
    (right-padded to the fixed slab) at its current ``length``; decoding
    or free rows ride along with ``chunk_valid == 0`` and keep their cache.
    ``fresh`` rows ingest their first chunk: their length restarts at 0
    and their SSM/conv state at zero.
    ``finishing`` rows hold the prompt's last token: their last-real
    logits replace their row of ``pool_logits``.  ``paged=True`` takes a
    ``page_table``; a prefix-hit admission enters with ``fresh`` False and
    its length pre-set to the hit, so the chunk ingests only the suffix.
    """
    ctx = _quant_ctx(quant)

    def chunk_step(params, pool, pool_logits, tokens, chunk_valid, fresh,
                   finishing, page_table=None):
        if paged and page_table is None:
            raise ValueError("a paged chunk step needs a page_table")
        _mask_recurrent_rows(pool["layers"], torch.logical_not(fresh))
        caches = {"layers": pool["layers"],
                  "length": torch.where(fresh, 0, pool["length"])}
        out = forward(cfg, params, tokens=tokens, caches=caches, quant=ctx,
                      chunk_valid=chunk_valid, return_stats=with_stats,
                      page_table=page_table if paged else None)
        if with_stats:
            logits, new_caches, stats = out
        else:
            logits, new_caches = out
        last = _last_real(logits, chunk_valid)
        new_logits = torch.where(finishing[:, None],
                                 last.to(pool_logits.dtype), pool_logits)
        if with_stats:
            return new_logits, new_caches, stats
        return new_logits, new_caches
    return chunk_step
