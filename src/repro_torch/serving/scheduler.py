"""Continuous-batching serve scheduler over a persistent slot pool (port of
``src/repro/serving/scheduler.py`` for attention, Mamba-2 and hybrid
decoders on one card).

The one-shot engine (``serving/engine.py``) drains its whole batch before
the next one starts.  This scheduler keeps the decode batch full under
sustained load — the bandwidth-bound regime in which QeiHaN's plane
skipping pays:

* **Slot pool** — one persistent allocation of ``max_slots`` cache rows
  (dense ``(max_len, ...)`` slabs, or pages of a shared pool), reset by
  overwriting, never re-allocated.
* **Bucketed prefill** — a prompt is right-padded to the smallest bucket
  that holds it, prefilled alone, and written into its slot.
* **Chunked prefill** (``chunked="auto"|"always"``) — a prompt is fed
  ``chunk_len`` tokens per tick straight into the pool, in the same tick
  as every other slot's decode steps.
* **Tick** — every decoding slot steps ``tick_steps`` greedy tokens; host
  logic between ticks retires finished requests and refills their slots.
* **Paged KV pool** (``paged=True``) — attention K/V in a shared pool of
  ``page_len``-token pages behind host page tables (``serving/kvpool.py``).
* **Radix prefix cache** (``prefix_cache=True``) — retired prompts donate
  their whole pages to a radix tree; a new request aliases its longest
  cached prefix (shared pages, the partial page copied on write) and
  ingests only its suffix.
* **Paged-attention kernel** (``attn_kernel="pallas"``) — decode reads
  walk the page tables in the CUDA kernel ``kernels/paged_attention``
  (on CPU tensors its plain version) instead of gathering each slot's
  pages into a dense view.
* **Log2-quantized KV pages** (``kv_quant=True``) — the pool stores each
  row as ``kv_bits``-bit log2 wire codes under a per-(page, head)
  power-of-two scale, each slot's two newest pages also dense in a tail
  ring; decode reads go through the quantized kernel (``attn_kernel``) or
  the dequantizing gather.
* **Recurrent state** (``mamba`` and ``mamba_moe`` blocks) — each slot's
  SSM/conv state is dense per slot, even in a paged pool.  A decode step
  leaves an inactive slot's state as it was, a fresh chunked admission
  starts from zero state, and a prefix hit needs the state at its
  boundary: a device snapshot of the donor slot's state, taken when its
  ingestion lands exactly on the page-aligned prompt boundary (a row
  whose last chunk lands there is held out of that tick's decode), kept
  on the radix node under the ``snapshot_limit`` LRU, and restored into
  the hitting slot.

Each device step is a :class:`~repro_torch.serving.engine.Program`, the
port's counterpart of the reference's jitted programs, which on the card
runs as one CUDA-graph replay per call: the tick (``tick_steps``
slot-masked greedy steps, the reference's ``lax.scan``), the chunk step,
the mixed chunk + tick, one prefill per bucket on a static 1-row cache,
and the slot write.  Their static inputs are the page table, the active
mask and the chunk slab, copied in from the host each tick; they write
the pool, its lengths and the logits in place, so those tensors keep
their addresses for the scheduler's life.  :meth:`ServeScheduler.
compile_stats` counts the programs' signatures as the reference counts
its compiled programs.  Tokens and per-step traffic fractions come to the
host once per tick.  The copy on write of a prefix hit's partial page,
its tail-ring restore, its snapshot restore and its length write, and the
snapshot itself, stay eager in-place writes and clones (the reference's
``cow_pages`` / ``admit_hit`` / ``snap_slot`` programs).  Host state
(slots, page tables, the queue) is numpy, as in the reference.  Not
ported: the deprecated keyword-argument constructor, ``audit_programs``
(it traces and lowers JAX programs for the reference's jaxpr/HLO
auditor, which has no counterpart for a CUDA graph), ``mesh=`` /
``mesh_spec``.

``_defer_decode`` is the disaggregation hook (``serving/workers.py``'s
``PrefillEngine`` sets it): every finishing chunk row is held out of the
same tick's decode steps, so a slot reaches phase ``"decode"`` with its
first-token logits and no token.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.logquant import dequantize_page_codes
from repro_torch.models.attention import _quant_paged_write, page_slots
from repro_torch.models.model import (ModelConfig, base_kind, init_caches,
                                      init_paged_pool)
from repro_torch.serving import engine
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.kvpool import (TRASH_PAGE, PagePool, RadixCache,
                                        blocks_for_tokens)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket that holds ``length`` real tokens."""
    for b in sorted(buckets):
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds the largest prefill "
                     f"bucket {max(buckets)}")


def round_pool_len(base: int, chunk_len: int) -> int:
    """Smallest multiple of ``chunk_len`` >= ``base`` — the ``max_len`` a
    chunked :class:`ServeScheduler` accepts."""
    return -(-int(base) // int(chunk_len)) * int(chunk_len)


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray                  # (L,) int32 token ids
    max_new: int
    eos_id: Optional[int] = None
    submit_time: float = float("nan")   # time.perf_counter() at submit()


@dataclasses.dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: List[int]
    finish_reason: str                  # "eos" | "length" | "rejected"
    admitted_tick: int                  # -1 for rejected requests
    finished_tick: int
    # per-request mean of the per-step batch-aggregate traffic fractions
    # over the steps this request was active (nan without stats)
    plane_traffic_fraction: float = float("nan")
    element_traffic_fraction: float = float("nan")
    error: Optional[str] = None         # why a "rejected" request never ran
    # wall-clock marks on one time.perf_counter() clock: TTFT =
    # first_token_time - submit_time, e2e = finish_time - submit_time
    submit_time: float = float("nan")
    first_token_time: float = float("nan")
    finish_time: float = float("nan")


@dataclasses.dataclass
class _Slot:
    req: Request
    admitted_tick: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str = ""
    frac_sums: List[float] = dataclasses.field(
        default_factory=lambda: [0.0, 0.0])
    frac_steps: int = 0
    # chunked admissions are "prefill" until their last chunk lands
    phase: str = "decode"               # "prefill" | "decode"
    prefill_pos: int = 0                # prompt tokens ingested so far
    first_token_time: float = float("nan")
    # paged mode: every page this slot holds a reference on, the
    # prefix-hit length it was admitted with, and the SSM/conv state
    # snapshot at the cacheable prompt boundary (models with mamba blocks)
    pages: List[int] = dataclasses.field(default_factory=list)
    hit_len: int = 0
    snapshot: Optional[tuple] = None


class ServeScheduler:
    """Continuous-batching scheduler: admit -> tick -> retire -> re-fill.

    Greedy decoding only.  Usage::

        sc = ServeConfig(max_slots=8, max_len=256, paged=True,
                         prefix_cache=True, attn_kernel="pallas")
        sched = ServeScheduler(cfg, params, sc)       # params on the card
        for p in prompts:
            sched.submit(p, max_new=32, eos_id=2)
        results = sched.run()          # List[RequestResult], rid order

    ``device=None`` means the card (and raises without one); ``params``
    must live on the same device type.  Every knob is a
    :class:`ServeConfig` field with the reference's meaning.
    """

    def __init__(self, cfg: ModelConfig, params,
                 config: Optional[ServeConfig] = None, *, device=None):
        if cfg.frontend != "none":
            raise ValueError("ServeScheduler serves token-id models only "
                             f"(frontend={cfg.frontend!r})")
        if config is None:
            config = ServeConfig()
        if not isinstance(config, ServeConfig):
            raise TypeError(f"ServeScheduler: config must be a ServeConfig,"
                            f" got {type(config).__name__}")
        if config.mesh_spec is not None:
            raise NotImplementedError(
                f"mesh_spec={config.mesh_spec!r}: the port serves one card; "
                f"multi-device serving is not ported yet")
        dev = resolve_device(device)
        if params["embed"].device.type != dev.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"not on {dev}")
        self.serve_config = config
        self.device = dev
        if config.attn_kernel != "off":
            # the flag rides the model config: every decode step below
            # dispatches through models.attention
            cfg = cfg.replace(paged_attn_kernel=config.attn_kernel,
                              paged_attn_splits=config.attn_splits)
        if config.kv_quant:
            # so does the quantized pool: init_paged_pool builds the codes,
            # scales and tail rings, models.attention quantizes on write
            cfg = cfg.replace(kv_quant=True, kv_bits=config.kv_bits)
        self.kv_quant = config.kv_quant
        self.kv_bits = config.kv_bits
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots = config.max_slots
        self.max_len = max_len = config.max_len
        self.buckets = config.buckets
        self.quant = config.quant
        self.with_stats = with_stats = config.with_stats
        self.tick_steps = config.tick_steps
        self.oversize = config.oversize
        self.chunked = config.chunked
        self.chunk_len = config.chunk_len
        self.paged = paged = config.paged
        self.page_len = config.page_len if paged else 0
        self.prefix_cache = config.prefix_cache
        self._has_ssm = any(base_kind(k) == "mamba" for k in cfg.pattern)
        self.min_prefix_hit = config.min_prefix_hit
        self.attn_kernel = config.attn_kernel
        self.attn_splits = config.attn_splits
        self._needs_chunk_programs = config.needs_chunk_programs
        # the disaggregation hook: hold every finishing chunk row out of the
        # same tick's decode, so prefill-only ingestion generates no token
        self._defer_decode = False

        # --- persistent pool (allocated exactly once) ----------------------
        if paged:
            self.max_blocks = config.max_blocks
            self.n_pages = config.resolved_n_pages()
            self._pool = init_paged_pool(cfg, max_slots, max_len,
                                         self.n_pages, self.page_len,
                                         dtype=cfg.dtype, device=dev)
            self._pages = PagePool(self.n_pages, self.page_len)
            # host-side page tables, one row per slot; entry 0 = trash page
            self._table = np.zeros((max_slots, self.max_blocks), np.int32)
            self._radix = (RadixCache(self._pages,
                                      snapshot_limit=config.snapshot_limit)
                           if self.prefix_cache else None)
            self.prefix_stats = {"prompt_tokens": 0, "cached_tokens": 0,
                                 "prefill_tokens": 0, "pages_held": 0,
                                 "admitted": 0}
        else:
            self._pool = init_caches(cfg, max_slots, max_len,
                                     dtype=cfg.dtype, device=dev,
                                     per_slot=True)
            self._pages = self._radix = None
        self._logits = torch.zeros((max_slots, cfg.vocab_size),
                                   dtype=cfg.dtype, device=dev)
        self._active = np.zeros((max_slots,), bool)
        self._slots: List[Optional[_Slot]] = [None] * max_slots

        self._queue: Deque[Request] = deque()
        self._results: Dict[int, RequestResult] = {}
        self._next_rid = 0
        self._tick_count = 0

        # the generate-program LRU serves the one-shot parity / baseline
        # path (greedy_generate): sized as the reference sizes it (the
        # default only ever grows the process-global bound)
        generate_cache_size = config.generate_cache_size
        if generate_cache_size is None:
            generate_cache_size = max(engine.generate_fn.maxsize,
                                      4 * len(self.buckets) + 16)
        engine.set_generate_cache_size(generate_cache_size)

        # the bucketed prefill's static 1-row cache and logits, which the
        # slot write reads
        self._cache1 = init_caches(cfg, 1, max_len, dtype=cfg.dtype,
                                   device=dev)
        self._logits1 = torch.zeros((1, cfg.vocab_size), dtype=cfg.dtype,
                                    device=dev)

        quant = config.quant
        self._slot_prefill = engine.make_slot_prefill(cfg, quant)
        self._step = engine.make_slot_serve_step(cfg, quant,
                                                 with_stats=with_stats,
                                                 paged=paged)
        self._chunk_step = (engine.make_slot_prefill_chunk(
            cfg, quant, with_stats=with_stats, paged=paged)
            if self._needs_chunk_programs else None)

        # --- programs: one CUDA graph per static signature on the card ----
        # they never run concurrently and the tick reads each one's outputs
        # before the next replays, so their graphs share one memory pool
        common = dict(device=dev, bound=self._bound, mem_pool=(
            torch.cuda.graph_pool_handle() if dev.type == "cuda" else None))
        # what a tick's warm-up changes that the same call reads before
        # writing it: the logits, the lengths, the trash page (a free
        # slot's all-trash table reads it as that slot's junk cache; the
        # junk rows enter the batch-aggregate stats) and every slot's
        # SSM/conv state, which each step advances from its own value
        carry = [self._logits, self._pool["length"]]
        for layer in self._pool["layers"]:
            if "ssm" in layer:
                carry += list(layer.values())
            elif paged:
                carry += [t[:, TRASH_PAGE] for k, t in layer.items()
                          if not k.endswith("_tail")]
        # prefill: one signature per bucket; the slot write: one
        self._prefill = engine.Program(self._prefill_body, name="prefill",
                                       **common)
        self._write = engine.Program(self._write_body, name="write_slot",
                                     **common)
        self._tick = engine.Program(self._tick_body, name="tick",
                                    carry=carry, **common)
        self._chunk = self._mixed = None
        if self._needs_chunk_programs:
            # ONE fixed (B, chunk_len) slab shape regardless of prompt
            # length; the mixed program is the chunk body, then the tick's
            self._chunk = engine.Program(self._chunk_body, name="chunk",
                                         carry=carry, **common)
            self._mixed = engine.Program(self._mixed_body, name="mixed",
                                         carry=carry, **common)

    # ----------------------------------------------------- program bodies

    def _bound(self):
        """What the programs read by address: it must never be rebound."""
        return (self.params, self._pool, self._logits, self._cache1,
                self._logits1)

    def _prefill_body(self, prompt, true_len):
        """Bucketed prefill of one padded prompt into the zeroed static
        1-row cache; its last-real logits into ``_logits1``."""
        for c in self._cache1["layers"]:
            for t in c.values():
                t.zero_()
        logits, _ = self._slot_prefill(self.params, prompt, true_len,
                                       self._cache1)
        self._logits1.copy_(logits)
        return ()

    def _write_body(self, slot, true_len, row=None):
        """Write the prefilled 1-row cache and its logits into slot
        ``slot`` (``(1,)`` int64).  Paged: positions ``< true_len`` land at
        (``row[p // page_len]``, ``p % page_len``), the rest at the trash
        page (the last of them wins it); SSM/conv state keeps the dense
        per-slot write."""
        layers = zip(self._pool["layers"], self._cache1["layers"])
        if self.paged:
            pos = torch.arange(self.max_len, device=self.device)[None]
            slots = page_slots(row[None], pos, pos < true_len, self.n_pages,
                               self.page_len)
            page, off = slots.page[0], slots.off[0]
            for c_pool, c_slot in layers:
                if "ssm" in c_pool:
                    for k, t in c_pool.items():
                        t.index_copy_(1, slot, c_slot[k].to(t.dtype))
                    continue
                if self.kv_quant:
                    self._quant_write(c_pool, c_slot, slot, true_len, row,
                                      slots)
                    continue
                for k in ("k", "v"):
                    c_pool[k][:, page, off] = c_slot[k][:, 0][
                        :, slots.src].to(c_pool[k].dtype)
        else:
            for c_pool, c_slot in layers:
                for k, t in c_pool.items():
                    t.index_copy_(1, slot, c_slot[k].to(t.dtype))
        self._pool["length"].index_copy_(0, slot, true_len)
        self._logits.index_copy_(0, slot,
                                 self._logits1.to(self._logits.dtype))
        return ()

    def _quant_write(self, c_pool, c_slot, slot, true_len, row,
                     slots) -> None:
        """Quantize a prefilled dense slab into slot ``slot``'s pages,
        their scales and its tail ring: per layer, the pool write of a
        ``true_len``-token chunk at position 0 (pad rows to the trash page
        and the junk bin)."""
        pos = torch.arange(self.max_len, device=self.device)[None]
        start = torch.zeros((1,), dtype=torch.int32, device=self.device)
        for r in range(self.cfg.repeats):
            for k in ("k", "v"):
                tail = c_pool[f"{k}_tail"][r]
                ring = tail.index_select(0, slot)
                _quant_paged_write(
                    c_pool[f"{k}_codes"][r], c_pool[f"{k}_scale"][r], ring,
                    row[None], c_slot[k][r], pos, pos < true_len, start,
                    true_len, self.kv_bits, slots)
                tail.index_copy_(0, slot, ring)

    def _restore_tail(self, i: int, hit_len: int) -> None:
        """Seed slot ``i``'s tail ring from the prefix hit's newest page
        (the table row already names it; the ring's rows are the previous
        occupant's): its dequantized rows are what every read of those
        positions would decode from the pool."""
        pl = self.page_len
        tb = max(hit_len - 1, 0) // pl
        page = int(self._table[i, tb])
        half = (tb % 2) * pl
        for c in self._pool["layers"]:
            if "k_codes" not in c:
                continue
            for k in ("k", "v"):
                tail = c[f"{k}_tail"]
                tail[:, i, half:half + pl] = dequantize_page_codes(
                    c[f"{k}_codes"][:, page],
                    c[f"{k}_scale"][:, page][:, None, :, None], self.kv_bits,
                    tail.dtype)

    def _tick_body(self, active, page_table=None):
        """``tick_steps`` slot-masked greedy steps: tokens ``(B,
        tick_steps)`` and fractions ``(tick_steps, 2)``; the logits and
        lengths land in place."""
        pt = (page_table,) if self.paged else ()
        caches, logits = self._pool, self._logits
        toks, fracs = [], []
        zero = torch.zeros((2,), dtype=torch.float32, device=self.device)
        for _ in range(self.tick_steps):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out = self._step(self.params, caches, tok[:, None], active, *pt)
            if self.with_stats:
                logits, caches, stats = out
                fracs.append(torch.stack(
                    [stats["plane_traffic_fraction"],
                     stats["element_traffic_fraction"]]))
            else:
                logits, caches = out
                fracs.append(zero)
            toks.append(tok)
        self._logits.copy_(logits)
        self._pool["length"].copy_(caches["length"])
        return torch.stack(toks, dim=1), torch.stack(fracs)

    def _chunk_body(self, tokens, valid, fresh, finishing, page_table=None):
        """One prompt chunk per prefilling slot: its fractions ``(2,)``;
        the logits and lengths land in place."""
        pt = (page_table,) if self.paged else ()
        out = self._chunk_step(self.params, self._pool, self._logits, tokens,
                               valid, fresh, finishing, *pt)
        if self.with_stats:
            logits, caches, stats = out
            cfrac = torch.stack([stats["plane_traffic_fraction"],
                                 stats["element_traffic_fraction"]])
        else:
            logits, caches = out
            cfrac = torch.zeros((2,), dtype=torch.float32,
                                device=self.device)
        self._logits.copy_(logits)
        self._pool["length"].copy_(caches["length"])
        return (cfrac,)

    def _mixed_body(self, active, tokens, valid, fresh, finishing,
                    page_table=None):
        (cfrac,) = self._chunk_body(tokens, valid, fresh, finishing,
                                    page_table)
        toks, fracs = self._tick_body(active, page_table)
        return toks, fracs, cfrac

    def _cow(self, src: int, dst: int) -> None:
        """Copy page ``src`` into page ``dst`` in every attention layer's K
        and V (a quantized page's codes and scale together: codes mean
        nothing under another page's scale; the per-slot tail rings and
        SSM/conv state are not paged)."""
        keys = (("k_codes", "v_codes", "k_scale", "v_scale")
                if self.kv_quant else ("k", "v"))
        for c in self._pool["layers"]:
            if "ssm" in c:
                continue
            for k in keys:
                c[k][:, dst] = c[k][:, src]

    def _snap_slot(self, i: int) -> tuple:
        """A device copy of slot ``i``'s SSM/conv state, one ``{"ssm",
        "conv"}`` dict of ``(R, 1, ...)`` leaves per mamba position."""
        return tuple({k: t[:, i:i + 1].clone() for k, t in c.items()}
                     for c in self._pool["layers"] if "ssm" in c)

    def _restore_snapshot(self, i: int, snapshot: tuple) -> None:
        """Write a :meth:`_snap_slot` snapshot into slot ``i``."""
        layers = [c for c in self._pool["layers"] if "ssm" in c]
        for c, sn in zip(layers, snapshot):
            for k, t in c.items():
                t[:, i:i + 1].copy_(sn[k])

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new: int, eos_id: Optional[int] = None) -> int:
        """Queue one request; returns its rid (results come back in rid
        order from :meth:`run`).

        A prompt over the admission bound (without chunking the largest
        bucket, with it the slot capacity), or whose prompt + ``max_new``
        overflows the slot, follows the ``oversize`` policy: ``"reject"``
        records a ``RequestResult(finish_reason="rejected", error=...)``,
        ``"truncate"`` keeps the most recent tokens that fit, ``"raise"``
        raises ``ValueError``.  Empty prompts and ``max_new < 1`` always
        raise."""
        now = time.perf_counter()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.chunked == "off":
            fit = min(self.buckets[-1], self.max_len - max_new)
        else:
            fit = self.max_len - max_new
        if prompt.size > fit:
            if self.chunked == "off" and prompt.size > self.buckets[-1]:
                why = (f"prompt length {prompt.size} exceeds the largest "
                       f"prefill bucket {self.buckets[-1]} (enable chunked "
                       f"prefill to lift the bucket ceiling)")
            else:
                why = (f"prompt ({prompt.size}) + max_new ({max_new}) "
                       f"exceeds the slot capacity max_len={self.max_len}")
            if self.oversize == "raise":
                raise ValueError(why)
            if self.oversize == "truncate" and fit >= 1:
                prompt = prompt[-fit:]           # keep the latest context
            else:
                rid = self._next_rid
                self._next_rid += 1
                self._results[rid] = RequestResult(
                    rid=rid, prompt_len=int(prompt.size), tokens=[],
                    finish_reason="rejected", admitted_tick=-1,
                    finished_tick=self._tick_count, error=why,
                    submit_time=now, finish_time=now)
                return rid
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid=rid, prompt=prompt, max_new=max_new,
                                   eos_id=eos_id, submit_time=now))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue) + int(self._active.sum())

    def programs(self) -> Dict[str, "engine.Program"]:
        """The scheduler's device programs by the reference's names."""
        progs = {"prefill": self._prefill, "tick": self._tick,
                 "write_slot": self._write}
        if self._needs_chunk_programs:
            progs.update(chunk=self._chunk, mixed=self._mixed)
        return progs

    def compile_stats(self) -> Dict[str, int]:
        """Program signatures built (on the card, CUDA graphs captured)
        per program, with the reference's keys and meaning: ``prefill``
        is bounded by the buckets, every other program by 1."""
        return {name: engine.compiled_size(p)
                for name, p in self.programs().items()}

    def prefix_cache_stats(self) -> Dict[str, float]:
        """Prefix-cache effectiveness over everything admitted so far:
        ``hit_rate`` is the fraction of prompt tokens served straight from
        shared pages (their prefill compute and cache writes skipped)."""
        if not self.paged:
            raise ValueError("prefix_cache_stats: not a paged scheduler")
        total = max(self.prefix_stats["prompt_tokens"], 1)
        cached = self.prefix_stats["cached_tokens"]
        out = {
            "prompt_tokens": float(self.prefix_stats["prompt_tokens"]),
            "cached_tokens": float(cached),
            "prefill_tokens": float(self.prefix_stats["prefill_tokens"]),
            "hit_rate": cached / total,
            "cache_write_saved_frac": cached / total,
            "pages_in_use": float(self._pages.in_use),
            "pages_free": float(self._pages.available),
        }
        if self._radix is not None:
            out["lookups"] = float(self._radix.lookups)
            out["lookup_hits"] = float(self._radix.hits)
        return out

    def reset_prefix_stats(self) -> None:
        """Zero the prefix-cache counters (cached pages stay resident)."""
        if not self.paged:
            raise ValueError("reset_prefix_stats: not a paged scheduler")
        self.prefix_stats = {k: 0 for k in self.prefix_stats}
        if self._radix is not None:
            self._radix.lookups = self._radix.hits = 0
            self._radix.tokens_hit = 0

    def step_tick(self) -> bool:
        """Admit into every free slot, feed one prompt chunk to every
        prefilling slot, run ``tick_steps`` decode steps for every decoding
        slot, then retire finished requests.  Returns False when there is
        nothing to do.  Paged admission can stall: a request the pool
        cannot cover (after evicting prefix-cache entries) waits at the
        queue head while others are in flight, and follows the
        ``oversize`` policy when none is."""
        stalled = False
        for i in range(self.max_slots):
            if stalled:
                break
            while not self._active[i] and self._queue:
                req = self._queue.popleft()
                st = self._admit(i, req)
                if st == "wait":
                    self._queue.appendleft(req)
                    stalled = True
                    break
        if not self._active.any():
            return False

        # ---- this tick's chunk slab (chunked admissions only) -------------
        chunk_rows = [i for i, s in enumerate(self._slots)
                      if s is not None and s.phase == "prefill"]
        valid = np.zeros((self.max_slots,), np.int32)
        finishing = np.zeros((self.max_slots,), bool)
        defer = np.zeros((self.max_slots,), bool)
        if chunk_rows:
            tokens = np.zeros((self.max_slots, self.chunk_len), np.int32)
            fresh = np.zeros((self.max_slots,), bool)
            for i in chunk_rows:
                s = self._slots[i]
                take = min(self.chunk_len,
                           s.req.prompt.size - s.prefill_pos)
                tokens[i, :take] = s.req.prompt[s.prefill_pos:
                                                s.prefill_pos + take]
                valid[i] = take
                fresh[i] = s.prefill_pos == 0 and s.hit_len == 0
                finishing[i] = s.prefill_pos + take >= s.req.prompt.size
                # a snapshot needs the post-prompt SSM state before any
                # decode step touches it: a last chunk that lands exactly
                # on the cacheable boundary holds its row out of this
                # tick's decode (it decodes next tick, with equal tokens)
                defer[i] = finishing[i] and (
                    self._defer_decode
                    or (self._wants_snapshot(s) and s.prefill_pos + take
                        == self._cacheable_len(s.req.prompt.size)))
        # a slot whose LAST chunk lands this tick decodes in the same tick:
        # the chunk writes its first-token logits before the decode steps
        decode_mask = np.array(
            [s is not None and not s.done
             and (s.phase == "decode"
                  or bool(finishing[i] and not defer[i]))
             for i, s in enumerate(self._slots)])

        # chunk + decode in ONE program when both kinds are live
        pt = (self._table,) if self.paged else ()
        toks_h = fracs_h = cfrac_h = None
        if chunk_rows and decode_mask.any():
            toks, fracs, cfrac = self._mixed(decode_mask, tokens, valid,
                                             fresh, finishing, *pt)
            toks_h, fracs_h = toks.cpu().numpy(), fracs.cpu().numpy()
            cfrac_h = cfrac.cpu().numpy()
        elif chunk_rows:
            (cfrac,) = self._chunk(tokens, valid, fresh, finishing, *pt)
            cfrac_h = cfrac.cpu().numpy()
        else:
            toks, fracs = self._tick(decode_mask, *pt)
            toks_h, fracs_h = toks.cpu().numpy(), fracs.cpu().numpy()

        now = time.perf_counter()

        # ---- chunk-phase bookkeeping --------------------------------------
        for i in chunk_rows:
            s = self._slots[i]
            s.prefill_pos += int(valid[i])
            if finishing[i]:
                s.phase = "decode"
            if (self._wants_snapshot(s) and s.prefill_pos
                    == self._cacheable_len(s.req.prompt.size)):
                # the post-tick state is the state at prefill_pos: the row
                # was held out of (or not yet in) the decode steps, and an
                # inactive row's recurrent state is left as it was
                s.snapshot = self._snap_slot(i)
            if self.with_stats:
                # the chunk forward's batch-aggregate traffic, attributed
                # to the requests that prefilled this tick
                s.frac_sums[0] += float(cfrac_h[0])
                s.frac_sums[1] += float(cfrac_h[1])
                s.frac_steps += 1

        # ---- decode-phase bookkeeping -------------------------------------
        if toks_h is not None:
            for t in range(self.tick_steps):
                for i, slot in enumerate(self._slots):
                    if slot is None or slot.done or not decode_mask[i]:
                        continue
                    tok = int(toks_h[i, t])
                    if not slot.tokens:
                        slot.first_token_time = now
                    slot.tokens.append(tok)
                    if self.with_stats:
                        slot.frac_sums[0] += float(fracs_h[t, 0])
                        slot.frac_sums[1] += float(fracs_h[t, 1])
                        slot.frac_steps += 1
                    if slot.req.eos_id is not None \
                            and tok == slot.req.eos_id:
                        slot.done, slot.finish_reason = True, "eos"
                    elif len(slot.tokens) >= slot.req.max_new:
                        slot.done, slot.finish_reason = True, "length"

        self._tick_count += 1
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.done:
                self._retire(i)
        return True

    def run(self, max_ticks: Optional[int] = None) -> List[RequestResult]:
        """Drive ticks until queue and slots drain (or ``max_ticks``);
        returns every finished result in rid order."""
        ticks = 0
        while self.pending and (max_ticks is None or ticks < max_ticks):
            if not self.step_tick():
                break
            ticks += 1
        return [self._results[rid] for rid in sorted(self._results)]

    # ------------------------------------------------------------ internals

    def _uses_chunks(self, prompt_len: int) -> bool:
        """``"always"`` chunks everything; ``"auto"`` only prompts no
        bucket can hold."""
        if self.chunked == "always":
            return True
        return self.chunked == "auto" and prompt_len > self.buckets[-1]

    def _wants_snapshot(self, slot: _Slot) -> bool:
        """A model with mamba blocks needs the recurrent state at the
        cacheable prompt boundary for a prefix hit to be usable; it is
        taken once, when ingestion lands exactly on that boundary."""
        return (self._radix is not None and self._has_ssm
                and slot.snapshot is None)

    def _cacheable_len(self, prompt_len: int) -> int:
        """Prompt tokens coverable by whole shared pages."""
        return (prompt_len // self.page_len) * self.page_len

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` fresh pages, evicting LRU prefix-cache entries
        if the free list runs short — all or nothing, and eviction only
        when it can satisfy the request."""
        got = self._pages.alloc(n)
        if (got is None and self._radix is not None
                and self._pages.available + self._radix.evictable_pages()
                >= n):
            self._radix.evict(n)
            got = self._pages.alloc(n)
        return got

    def _admit(self, slot_idx: int, req: Request) -> str:
        """Fill ``slot_idx`` with ``req``: ``"ok"`` (admitted), ``"wait"``
        (paged pool exhausted while others are in flight) or ``"drop"``
        (rejected with a per-request error result)."""
        if self.paged:
            return self._admit_paged(slot_idx, req)
        if self._uses_chunks(int(req.prompt.size)):
            self._active[slot_idx] = True
            self._slots[slot_idx] = _Slot(req=req,
                                          admitted_tick=self._tick_count,
                                          phase="prefill")
            return "ok"
        self._admit_bucketed(slot_idx, req)
        return "ok"

    def _admit_bucketed(self, slot_idx: int, req: Request) -> None:
        """Monolithic bucketed prefill + slot write (dense or paged)."""
        length = int(req.prompt.size)
        padded = np.zeros((1, bucket_for(length, self.buckets)), np.int32)
        padded[0, :length] = req.prompt
        true_len = np.array([length], np.int32)
        self._prefill(padded, true_len)
        self._write(np.array([slot_idx], np.int64), true_len,
                    *((self._table[slot_idx],) if self.paged else ()))
        self._active[slot_idx] = True
        self._slots[slot_idx] = _Slot(req=req,
                                      admitted_tick=self._tick_count)

    def _admit_paged(self, slot_idx: int, req: Request,
                     retrying: bool = False) -> str:
        prompt = req.prompt
        length = int(prompt.size)
        pl = self.page_len
        hit = None
        if self._radix is not None:
            # cap the hit at length-1: at least one suffix token must run
            # through prefill to produce the first decode logits
            hit = self._radix.lookup(prompt, max_hit=length - 1,
                                     need_snapshot=self._has_ssm,
                                     min_hit=self.min_prefix_hit,
                                     allow_partial=not self._has_ssm)
        shared = list(hit.pages) if hit is not None else []
        # hold every page the hit aliases (shared blocks and the COW
        # source) BEFORE allocating: allocation may evict radix entries
        # whose reference is the only thing keeping these pages alive
        hold = shared + ([hit.cow_src] if hit is not None
                         and hit.cow_src is not None else [])
        self._pages.ref(hold)
        # worst-case tokens the slot writes: prompt + generation + the junk
        # tail of the tick in which it finishes
        need_tokens = min(self.max_len,
                          length + req.max_new + self.tick_steps)
        n_blocks = blocks_for_tokens(need_tokens, pl)
        fresh = self._alloc_pages(n_blocks - len(shared))
        if fresh is None:
            self._pages.release(hold)
            if self._active.any():
                return "wait"
            why = (f"page pool exhausted: request needs {n_blocks} pages "
                   f"({need_tokens} tokens @ page_len={pl}), "
                   f"{self._pages.available} free of "
                   f"{self._pages.capacity}")
            if self.oversize == "raise":
                raise ValueError(why)
            if self.oversize == "truncate" and not retrying:
                usable = self._pages.available + (
                    self._radix.evictable_pages()
                    if self._radix is not None else 0)
                fit = min(usable * pl - req.max_new - self.tick_steps,
                          self.max_len - req.max_new)
                if fit >= 1:
                    cut = dataclasses.replace(req, prompt=prompt[-fit:])
                    return self._admit_paged(slot_idx, cut, retrying=True)
            now = time.perf_counter()
            self._results[req.rid] = RequestResult(
                rid=req.rid, prompt_len=length, tokens=[],
                finish_reason="rejected", admitted_tick=-1,
                finished_tick=self._tick_count, error=why,
                submit_time=req.submit_time, finish_time=now)
            return "drop"
        if hit is not None and hit.cow_src is not None:
            # the partially matching page is copied into the first fresh
            # page (block len(shared)), which the slot owns exclusively
            self._cow(hit.cow_src, fresh[0])
            self._pages.release([hit.cow_src])
        pages = shared + fresh
        self._table[slot_idx, :] = TRASH_PAGE
        self._table[slot_idx, :len(pages)] = pages
        self.prefix_stats["prompt_tokens"] += length
        if hit is not None:
            # the slot resumes at the hit boundary (its SSM state from the
            # hit's snapshot) and ingests only the suffix through the
            # chunk path
            self._pool["length"][slot_idx] = hit.length
            if hit.snapshot is not None:
                self._restore_snapshot(slot_idx, hit.snapshot)
            if self.kv_quant:
                self._restore_tail(slot_idx, hit.length)
            slot = _Slot(req=req, admitted_tick=self._tick_count,
                         phase="prefill", prefill_pos=hit.length,
                         hit_len=hit.length)
            self.prefix_stats["cached_tokens"] += hit.length
            self.prefix_stats["prefill_tokens"] += length - hit.length
        elif self._uses_chunks(length):
            slot = _Slot(req=req, admitted_tick=self._tick_count,
                         phase="prefill")
            self.prefix_stats["prefill_tokens"] += length
        else:
            self._admit_bucketed(slot_idx, req)
            slot = self._slots[slot_idx]
            self.prefix_stats["prefill_tokens"] += length
            if self._wants_snapshot(slot) and length % pl == 0:
                # a page-aligned prompt: the freshly written slot state is
                # the state at the cacheable boundary
                slot.snapshot = self._snap_slot(slot_idx)
        slot.pages = pages
        self.prefix_stats["pages_held"] += len(pages)
        self.prefix_stats["admitted"] += 1
        self._active[slot_idx] = True
        self._slots[slot_idx] = slot
        return "ok"

    def _free_slot(self, slot_idx: int) -> None:
        """Release ``slot_idx``: donate the prompt's pages to the prefix
        cache, drop the slot's page references, clear its table row and
        active bit."""
        slot = self._slots[slot_idx]
        if self.paged:
            if self._radix is not None:
                row = self._table[slot_idx]
                self._radix.insert(slot.req.prompt, lambda bi: int(row[bi]),
                                   snapshot=slot.snapshot)
            self._pages.release(slot.pages)
            self._table[slot_idx, :] = TRASH_PAGE
        self._active[slot_idx] = False
        self._slots[slot_idx] = None

    def _retire(self, slot_idx: int) -> None:
        slot = self._slots[slot_idx]
        self._free_slot(slot_idx)
        n = max(slot.frac_steps, 1)
        self._results[slot.req.rid] = RequestResult(
            rid=slot.req.rid,
            prompt_len=int(slot.req.prompt.size),
            tokens=list(slot.tokens),
            finish_reason=slot.finish_reason,
            admitted_tick=slot.admitted_tick,
            finished_tick=self._tick_count,
            plane_traffic_fraction=(slot.frac_sums[0] / n
                                    if self.with_stats else float("nan")),
            element_traffic_fraction=(slot.frac_sums[1] / n
                                      if self.with_stats else float("nan")),
            submit_time=slot.req.submit_time,
            first_token_time=slot.first_token_time,
            finish_time=time.perf_counter(),
        )
