"""Disaggregated serving workers: prefill and decode engines over one
serialized ``PageSpan`` hand-off (port of ``src/repro/serving/workers.py``).

The combined scheduler runs a long prompt's chunk ingestion in the same
program as every in-flight decode, so a prompt flood inflates decode
latency.  Disaggregation splits the roles:

* :class:`PrefillEngine` ingests ONE prompt at a time into its paged pool
  through the scheduler's chunked and bucketed admission paths (prefix
  hits included: the radix tree lives prefill-side), with decode held off
  (``ServeScheduler._defer_decode``): the cut is after the last chunk and
  before any decode step, i.e. the prompt's pages and the first-token
  logits, no generated token.  The filled slot is exported as a
  :class:`PageSpan` and released at once (its pages donated to the prefix
  cache as a retiring request's are).
* :class:`DecodeEngine` imports a span into its OWN pool (fresh pages from
  its allocator; the span's page contents, table row, length, logits row,
  SSM/conv state and kv_quant tail ring written in place, so that its
  captured CUDA graphs, which read the pool by address, stay valid) and
  ticks it with the unmodified decode program until EOS or length.

Both engines are built from the same :class:`~repro_torch.serving.config.
ServeConfig`, so they run the combined scheduler's programs at its shapes,
and per-slot decode is masked independently of the other rows: the
disaggregated tokens equal the combined scheduler's on the same trace.

``PageSpan.to_bytes()`` / ``from_bytes()`` is the wire format: magic
``RPSPAN``, version 1, a sorted-key JSON header, the raw array payload and
a CRC32, byte for byte the reference's, so a frame written by either
package is read by the other.  The arrays are host numpy.  numpy has no
bfloat16: the port holds a bf16 array as its raw 16-bit patterns in a
:class:`BF16Bits` array (a ``uint16`` view), which the wire names
``"bfloat16"`` as the reference does.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.config import ServeConfig
from repro_torch.serving.kvpool import TRASH_PAGE, blocks_for_tokens
from repro_torch.serving.scheduler import (Request, RequestResult,
                                           ServeScheduler, _Slot)

_MAGIC = b"RPSPAN"
_SPAN_VERSION = 1
_U32 = struct.Struct("<I")


class BF16Bits(np.ndarray):
    """A bfloat16 array held as its raw 16-bit patterns (dtype ``uint16``):
    on the wire its dtype is ``"bfloat16"``.  Make one with
    ``bits.view(BF16Bits)``."""


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor as a numpy array (bf16 as
    :class:`BF16Bits`), never a view of the pool."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(BF16Bits)
    return t.numpy()


def to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A span array as a tensor of ``like``'s dtype on its device."""
    if isinstance(a, BF16Bits):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=like.device, dtype=like.dtype)


def _contiguous(a: np.ndarray) -> np.ndarray:
    out = np.ascontiguousarray(a)
    return out.view(BF16Bits) if isinstance(a, BF16Bits) else out


def _wire_dtype(a: np.ndarray) -> str:
    return "bfloat16" if isinstance(a, BF16Bits) else a.dtype.name


@dataclasses.dataclass
class PageSpan:
    """One prefilled request, serialized: everything the decode engine
    needs to resume it in its own pool.

    ``layers`` mirrors the pool's layer groups: an attention group carries
    the slot's page contents gathered out of the prefill pool (``k``/``v``
    ``(R, n_blocks, page_len, G, D)``, or under ``kv_quant``
    ``k_codes``/``v_codes``, the per-page ``*_scale`` and the slot's
    dense ``*_tail`` ring), a mamba group the slot's recurrent state
    ``(R, 1, ...)`` at the full prompt boundary.  ``hit_len`` /
    ``shared_pages`` describe the prefill-side prefix hit (the pages
    themselves are in the span either way).
    """

    prompt: np.ndarray                      # (L,) int32 token ids
    length: int                             # tokens resident in the pages
    max_new: int
    eos_id: Optional[int]
    page_len: int
    kv_quant: bool
    kv_bits: int
    hit_len: int                            # prefix-cache hit at admission
    shared_pages: int                       # whole pages aliased at admission
    logits: np.ndarray                      # (V,) first-token logits row
    layers: Tuple[Dict[str, np.ndarray], ...]

    # ------------------------------------------------------------- wire
    def _arrays(self) -> List[Tuple[str, np.ndarray]]:
        out = [("prompt", _contiguous(self.prompt)),
               ("logits", _contiguous(self.logits))]
        for li, group in enumerate(self.layers):
            for key in sorted(group):
                out.append((f"layer{li}.{key}", _contiguous(group[key])))
        return out

    def to_bytes(self) -> bytes:
        arrays = self._arrays()
        header = {
            "version": _SPAN_VERSION,
            "length": int(self.length),
            "max_new": int(self.max_new),
            "eos_id": None if self.eos_id is None else int(self.eos_id),
            "page_len": int(self.page_len),
            "kv_quant": bool(self.kv_quant),
            "kv_bits": int(self.kv_bits),
            "hit_len": int(self.hit_len),
            "shared_pages": int(self.shared_pages),
            "n_groups": len(self.layers),
            "arrays": [{"name": name, "shape": list(a.shape),
                        "dtype": _wire_dtype(a), "nbytes": int(a.nbytes)}
                       for name, a in arrays],
        }
        hdr = json.dumps(header, sort_keys=True).encode("utf-8")
        payload = b"".join(a.tobytes() for _, a in arrays)
        body = _MAGIC + _U32.pack(_SPAN_VERSION) + _U32.pack(len(hdr)) + hdr
        return body + payload + _U32.pack(zlib.crc32(hdr + payload))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "PageSpan":
        fixed = len(_MAGIC) + 2 * _U32.size
        if len(blob) < fixed + _U32.size:
            raise ValueError(f"truncated PageSpan: {len(blob)} bytes is "
                             f"shorter than the fixed frame")
        if blob[:len(_MAGIC)] != _MAGIC:
            raise ValueError("not a PageSpan (bad magic)")
        version, = _U32.unpack_from(blob, len(_MAGIC))
        if version != _SPAN_VERSION:
            raise ValueError(f"PageSpan wire version {version} (this build "
                             f"reads version {_SPAN_VERSION})")
        hdr_len, = _U32.unpack_from(blob, len(_MAGIC) + _U32.size)
        if len(blob) < fixed + hdr_len + _U32.size:
            raise ValueError(f"truncated PageSpan: header claims "
                             f"{hdr_len} bytes, frame is short")
        hdr = blob[fixed:fixed + hdr_len]
        payload = blob[fixed + hdr_len:-_U32.size]
        crc, = _U32.unpack_from(blob, len(blob) - _U32.size)
        if zlib.crc32(hdr + payload) != crc:
            raise ValueError("PageSpan corrupt: CRC32 mismatch")
        header = json.loads(hdr.decode("utf-8"))
        want = sum(int(d["nbytes"]) for d in header["arrays"])
        if len(payload) != want:
            raise ValueError(f"truncated PageSpan: payload {len(payload)} "
                             f"bytes, manifest claims {want}")
        arrays: Dict[str, np.ndarray] = {}
        off = 0
        for d in header["arrays"]:
            bf16 = d["dtype"] == "bfloat16"
            dt = np.dtype(np.uint16 if bf16 else d["dtype"])
            n = int(d["nbytes"])
            a = np.frombuffer(payload, dtype=dt, count=n // dt.itemsize,
                              offset=off).reshape(d["shape"]).copy()
            arrays[d["name"]] = a.view(BF16Bits) if bf16 else a
            off += n
        layers: List[Dict[str, np.ndarray]] = [
            {} for _ in range(int(header["n_groups"]))]
        for name, a in arrays.items():
            if name.startswith("layer"):
                li, key = name.split(".", 1)
                layers[int(li[len("layer"):])][key] = a
        return cls(prompt=arrays["prompt"], length=int(header["length"]),
                   max_new=int(header["max_new"]), eos_id=header["eos_id"],
                   page_len=int(header["page_len"]),
                   kv_quant=bool(header["kv_quant"]),
                   kv_bits=int(header["kv_bits"]),
                   hit_len=int(header["hit_len"]),
                   shared_pages=int(header["shared_pages"]),
                   logits=arrays["logits"], layers=tuple(layers))

    @property
    def n_blocks(self) -> int:
        return blocks_for_tokens(self.length, self.page_len)


def _require_paged(config: ServeConfig, who: str) -> None:
    if not config.paged:
        raise ValueError(f"{who} requires a paged ServeConfig (the page "
                         f"pool is the prefill->decode transfer unit)")


class PrefillEngine:
    """Prompt-ingestion half of the disaggregated pair.

    Wraps a full :class:`ServeScheduler` (same config, same programs as
    the combined scheduler) with decode held off: :meth:`prefill` admits
    ONE request into slot 0, runs its chunk ticks, exports the filled slot
    as a :class:`PageSpan` and releases it, donating the prompt's pages to
    the prefill-side radix tree, so later prompts hit their shared
    prefixes as in the combined scheduler.  ``device=None`` is the card.
    """

    def __init__(self, cfg, params, config: ServeConfig, *, device=None):
        _require_paged(config, "PrefillEngine")
        self._sched = ServeScheduler(cfg, params, config, device=device)
        self._sched._defer_decode = True

    @property
    def scheduler(self) -> ServeScheduler:
        return self._sched

    def prefill(self, prompt, max_new: int, eos_id: Optional[int] = None):
        """Ingest one prompt; returns ``(span, None)``, or ``(None,
        RequestResult)`` when the oversize policy rejected it
        (``oversize="truncate"`` spans the truncated prompt, ``"raise"``
        raises, as scheduler submission does)."""
        s = self._sched
        rid = s.submit(prompt, max_new=max_new, eos_id=eos_id)
        if rid in s._results:              # rejected at submission
            return None, s._results.pop(rid)
        req = s._queue.popleft()           # possibly truncated
        status = s._admit(0, req)
        if status == "drop":
            return None, s._results.pop(req.rid)
        if status != "ok":                 # "wait" needs other live slots
            raise RuntimeError(f"prefill admission returned {status!r} "
                               f"with no other slot live")
        # chunk-only ticks until ingestion completes; _defer_decode holds
        # the finishing row out of the tick's decode, so the slot lands at
        # phase "decode" with first-token logits and no token (a bucketed
        # admission lands there with no tick at all)
        while s._slots[0] is not None and s._slots[0].phase == "prefill":
            s.step_tick()
        span = self._export(0, req)
        s._free_slot(0)                    # donate pages to the radix tree
        return span, None

    def _export(self, slot_idx: int, req: Request) -> PageSpan:
        """Gather slot ``slot_idx``'s pages (``index_select`` over the page
        axis), its state and logits row, and copy them to the host."""
        s = self._sched
        slot = s._slots[slot_idx]
        pl = s.page_len
        length = int(req.prompt.size)
        nb = blocks_for_tokens(length, pl)
        pages = torch.as_tensor(s._table[slot_idx, :nb].astype(np.int64),
                                device=s.device)
        layers: List[Dict[str, np.ndarray]] = []
        for c in s._pool["layers"]:
            if "ssm" in c:
                # the recurrent state at the full prompt boundary: no decode
                # step has advanced it (the _defer_decode cut)
                layers.append({k: to_host(t[:, slot_idx:slot_idx + 1])
                               for k, t in c.items()})
            elif s.kv_quant:
                group = {}
                for k in ("k", "v"):
                    for part in (f"{k}_codes", f"{k}_scale"):
                        group[part] = to_host(c[part].index_select(1, pages))
                    group[f"{k}_tail"] = to_host(c[f"{k}_tail"][:, slot_idx])
                layers.append(group)
            else:
                layers.append({k: to_host(c[k].index_select(1, pages))
                               for k in ("k", "v")})
        return PageSpan(
            prompt=np.asarray(req.prompt, np.int32),
            length=length, max_new=int(req.max_new), eos_id=req.eos_id,
            page_len=pl, kv_quant=s.kv_quant, kv_bits=s.kv_bits,
            hit_len=int(slot.hit_len), shared_pages=int(slot.hit_len) // pl,
            logits=to_host(s._logits[slot_idx]), layers=tuple(layers))


class DecodeEngine:
    """Token-generation half of the disaggregated pair.

    Imports :class:`PageSpan`\\ s into its own page pool (fresh pages from
    its allocator) and drives the unmodified decode tick.  Results come
    back as the scheduler's own :class:`RequestResult`\\ s through
    :meth:`drain_results`.  ``device=None`` is the card.
    """

    def __init__(self, cfg, params, config: ServeConfig, *, device=None):
        _require_paged(config, "DecodeEngine")
        self._sched = ServeScheduler(cfg, params, config, device=device)
        # never donate retired prompts to a decode-side radix tree: it
        # would pin transplanted pages and starve later imports; prefix
        # reuse is the prefill engine's job
        self._sched._radix = None

    @property
    def scheduler(self) -> ServeScheduler:
        return self._sched

    @property
    def active(self) -> int:
        return int(self._sched._active.sum())

    @property
    def has_free_slot(self) -> bool:
        return bool((~self._sched._active).any())

    def admit(self, span: PageSpan, rid: int,
              submit_time: float = float("nan")) -> str:
        """Import ``span`` into a free slot: ``"ok"`` (ticking now),
        ``"full"`` (no free slot: tick and retry), ``"wait"`` (a free slot,
        but the pool cannot cover the span while other imports are live:
        tick and retry) or ``"drop"`` (the pool can never cover it; a
        rejected result was recorded under ``rid``)."""
        s = self._sched
        if span.page_len != s.page_len or span.kv_quant != s.kv_quant or (
                span.kv_quant and span.kv_bits != s.kv_bits):
            raise ValueError(
                f"PageSpan/config mismatch: span has page_len="
                f"{span.page_len} kv_quant={span.kv_quant} kv_bits="
                f"{span.kv_bits}, decode pool has page_len={s.page_len} "
                f"kv_quant={s.kv_quant} kv_bits={s.kv_bits}")
        free = [i for i in range(s.max_slots) if not s._active[i]]
        if not free:
            return "full"
        slot_idx = free[0]
        # paged admission's worst case: prompt + generation + the junk
        # tail of the finishing tick
        need_tokens = min(s.max_len,
                          span.length + span.max_new + s.tick_steps)
        n_total = max(blocks_for_tokens(need_tokens, s.page_len),
                      span.n_blocks)
        pages = s._alloc_pages(n_total)
        if pages is None:
            if s._active.any():
                return "wait"
            why = (f"decode page pool exhausted: span needs {n_total} "
                   f"pages, {s._pages.available} free of "
                   f"{s._pages.capacity}")
            if s.oversize == "raise":
                raise ValueError(why)
            now = time.perf_counter()
            s._results[rid] = RequestResult(
                rid=rid, prompt_len=int(span.prompt.size), tokens=[],
                finish_reason="rejected", admitted_tick=-1,
                finished_tick=s._tick_count, error=why,
                submit_time=submit_time, finish_time=now)
            return "drop"
        self._import(slot_idx, span, pages)
        req = Request(rid=rid, prompt=np.asarray(span.prompt, np.int32),
                      max_new=span.max_new, eos_id=span.eos_id,
                      submit_time=submit_time)
        s._slots[slot_idx] = _Slot(req=req, admitted_tick=s._tick_count,
                                   phase="decode", pages=pages,
                                   hit_len=span.hit_len)
        s._active[slot_idx] = True
        return "ok"

    def _import(self, slot_idx: int, span: PageSpan,
                pages: List[int]) -> None:
        """Write the span into ``slot_idx``, every write in place (the
        programs' graphs read the pool, lengths and logits by address):
        page contents into the fresh pages (``index_copy_`` over the page
        axis), the SSM/conv state and (kv_quant) the tail ring into the
        slot's row, its length and logits row; then the host table row.
        The mirror of :meth:`PrefillEngine._export`."""
        s = self._sched
        idx = torch.as_tensor(pages[:span.n_blocks], dtype=torch.int64,
                              device=s.device)
        for c, grp in zip(s._pool["layers"], span.layers):
            if "ssm" in c:
                for k, t in c.items():
                    t[:, slot_idx:slot_idx + 1].copy_(to_tensor(grp[k], t))
                continue
            paged = (("k_codes", "k_scale", "v_codes", "v_scale")
                     if s.kv_quant else ("k", "v"))
            for k in paged:
                c[k].index_copy_(1, idx, to_tensor(grp[k], c[k]))
            if s.kv_quant:
                for k in ("k_tail", "v_tail"):
                    c[k][:, slot_idx].copy_(to_tensor(grp[k], c[k]))
        s._pool["length"][slot_idx] = span.length
        s._logits[slot_idx].copy_(to_tensor(span.logits, s._logits))
        s._table[slot_idx, :] = TRASH_PAGE
        s._table[slot_idx, :len(pages)] = pages

    def step(self) -> bool:
        """One decode tick over every live slot (EOS/length retirement
        included); False when nothing is live."""
        return self._sched.step_tick()

    def drain_results(self) -> Dict[int, RequestResult]:
        """Finished results accumulated since the last drain, by rid."""
        out = self._sched._results
        self._sched._results = {}
        return out
