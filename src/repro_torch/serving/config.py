"""``ServeConfig`` — every scheduler knob as ONE frozen, validated,
JSON-serializable value (port of ``src/repro/serving/config.py``).

Same fields, canonicalization, validation messages and ``schema`` version
as the reference, so a JSON written by either package loads in the other
(``tests/test_torch_serve_config.py``).  Differences:

* ``resolved_n_pages`` takes no mesh: the port serves one card, so the
  default pool is not rounded to a data-axis size.
* ``mesh_spec`` is kept in the schema, but the port's scheduler raises
  ``NotImplementedError`` on anything other than ``None``.
* ``kv_quant=True`` with ``attn_kernel="pallas"`` reads the quantized
  pool through the hand-written CUDA kernel
  (``kernels/paged_attention/csrc/paged_attention_quant.cu``).
* ``attn_kernel="pallas"`` keeps the reference's value name; in the port
  it selects the hand-written CUDA paged-attention decode kernel
  (``kernels/paged_attention/csrc/paged_attention.cu``), on CPU tensors
  its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

DEFAULT_BUCKETS: Tuple[int, ...] = (16, 32, 64, 128)

#: bump when a field is added/removed/renamed or its meaning changes;
#: ``from_json`` refuses other versions rather than guessing
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frozen, canonical serve-scheduler configuration.

    ``mesh_spec`` is a mesh spec *string* or ``None``; ``quant`` is
    ``bool | str`` (a backend name; the port runs its CUDA kernels for
    either name).
    """

    max_slots: int = 8
    max_len: int = 256
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    quant: Union[bool, str] = False
    with_stats: bool = False
    tick_steps: int = 8
    generate_cache_size: Optional[int] = None
    mesh_spec: Optional[str] = None
    oversize: str = "reject"
    chunked: Union[bool, str] = "off"
    chunk_len: Optional[int] = None
    paged: bool = False
    page_len: int = 16
    n_pages: Optional[int] = None
    prefix_cache: bool = False
    snapshot_limit: int = 8
    min_prefix_hit: Optional[int] = None
    attn_kernel: Union[bool, str] = "off"
    attn_splits: int = 1
    kv_quant: bool = False
    kv_bits: int = 4

    # ------------------------------------------------------- canonicalize
    def __post_init__(self):
        def put(k, v):
            object.__setattr__(self, k, v)

        put("max_slots", int(self.max_slots))
        put("max_len", int(self.max_len))
        put("tick_steps", int(self.tick_steps))
        if self.max_slots < 1 or self.tick_steps < 1:
            raise ValueError("max_slots and tick_steps must be >= 1")
        if self.oversize not in ("reject", "truncate", "raise"):
            raise ValueError(f"oversize={self.oversize!r}: expected "
                             f"'reject', 'truncate', or 'raise'")
        if not isinstance(self.quant, (bool, str)):
            raise ValueError(f"quant={self.quant!r}: ServeConfig takes a "
                             f"bool or backend-name string (a live quant "
                             f"context does not serialize)")
        put("with_stats", bool(self.with_stats))
        if self.generate_cache_size is not None:
            put("generate_cache_size", int(self.generate_cache_size))
        if self.mesh_spec is not None and not isinstance(self.mesh_spec,
                                                         str):
            raise ValueError(f"mesh_spec={self.mesh_spec!r}: expected a "
                             f"make_serve_mesh spec STRING ('2x2', 'host', "
                             f"...) — a live Mesh is process-local; pass "
                             f"it to the scheduler's mesh= instead")
        buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        put("buckets", buckets)
        if not buckets or buckets[-1] > self.max_len:
            raise ValueError(f"buckets {buckets} must be non-empty and fit "
                             f"max_len={self.max_len}")
        chunked = self.chunked
        if isinstance(chunked, bool):
            chunked = "auto" if chunked else "off"
        put("chunked", chunked)
        if chunked not in ("off", "auto", "always"):
            raise ValueError(f"chunked={chunked!r}: expected 'off', 'auto', "
                             f"or 'always'")
        put("chunk_len", int(buckets[0] if self.chunk_len is None
                             else self.chunk_len))
        put("paged", bool(self.paged))
        put("page_len", int(self.page_len))
        put("prefix_cache", bool(self.prefix_cache))
        put("snapshot_limit", int(self.snapshot_limit))
        if self.prefix_cache and not self.paged:
            raise ValueError("prefix_cache=True requires paged=True (prefix "
                             "hits alias shared pages)")
        # prefix-hit admissions ingest the prompt SUFFIX through the chunked
        # path, so the chunk-program invariants hold whenever either is on
        if self.needs_chunk_programs:
            if not 1 <= self.chunk_len <= self.max_len:
                raise ValueError(f"chunk_len={self.chunk_len} must be in "
                                 f"[1, max_len={self.max_len}]")
            if self.max_len % self.chunk_len:
                raise ValueError(f"max_len={self.max_len} must be a "
                                 f"multiple of chunk_len={self.chunk_len}")
        if self.paged:
            if self.page_len < 1:
                raise ValueError(f"page_len={self.page_len} must be >= 1")
            if self.max_len % self.page_len:
                raise ValueError(f"max_len={self.max_len} must be a "
                                 f"multiple of page_len={self.page_len}")
            if self.n_pages is not None:
                put("n_pages", int(self.n_pages))
                if self.n_pages < 2:
                    raise ValueError(f"n_pages={self.n_pages}: need >= 2 "
                                     f"(page 0 is the reserved trash page)")
            put("min_prefix_hit", int(self.page_len
                                      if self.min_prefix_hit is None
                                      else self.min_prefix_hit))
        else:
            # page-pool knobs are meaningless dense — canonicalize so equal
            # dense configs compare equal regardless of leftover values
            put("min_prefix_hit", 0)
        attn_kernel = self.attn_kernel
        if isinstance(attn_kernel, bool):
            attn_kernel = "pallas" if attn_kernel else "off"
        put("attn_kernel", attn_kernel)
        if attn_kernel not in ("off", "pallas"):
            raise ValueError(f"attn_kernel={attn_kernel!r}: expected 'off' "
                             f"or 'pallas'")
        put("attn_splits", int(self.attn_splits))
        if self.attn_splits < 1:
            raise ValueError(f"attn_splits={self.attn_splits} must be >= 1")
        if attn_kernel != "off" and not self.paged:
            raise ValueError("attn_kernel requires paged=True (the kernel "
                             "walks the page tables)")
        put("kv_quant", bool(self.kv_quant))
        put("kv_bits", int(self.kv_bits))
        if self.kv_quant:
            if not self.paged:
                raise ValueError("kv_quant=True requires paged=True (the "
                                 "compressed page format lives in the pool)")
            if not 2 <= self.kv_bits <= 8:
                raise ValueError(f"kv_bits={self.kv_bits} must be in [2, 8]")

    # ----------------------------------------------------------- derived
    @property
    def needs_chunk_programs(self) -> bool:
        return self.chunked != "off" or self.prefix_cache

    @property
    def max_blocks(self) -> int:
        """Page-table width: pages one fully-resident slot spans."""
        if not self.paged:
            raise ValueError("max_blocks: not a paged config")
        return self.max_len // self.page_len

    def resolved_n_pages(self) -> int:
        """Concrete pool size: the explicit ``n_pages``, or the default —
        every slot fully resident, plus prefix-cache retention headroom
        for one max-size prompt, plus the trash page."""
        if not self.paged:
            return 0
        if self.n_pages is not None:
            return self.n_pages
        return (self.max_slots * self.max_blocks + 1
                + (self.max_blocks if self.prefix_cache else 0))

    # -------------------------------------------------------------- JSON
    def to_json(self, *, indent: Optional[int] = None) -> str:
        doc = {"schema": SCHEMA_VERSION}
        doc.update(dataclasses.asdict(self))
        doc["buckets"] = list(self.buckets)
        return json.dumps(doc, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ServeConfig":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"ServeConfig.from_json: not valid JSON "
                             f"({e})") from None
        if not isinstance(doc, dict):
            raise ValueError(f"ServeConfig.from_json: expected a JSON "
                             f"object, got {type(doc).__name__}")
        doc = dict(doc)
        version = doc.pop("schema", None)
        if version != SCHEMA_VERSION:
            raise ValueError(f"ServeConfig.from_json: schema version "
                             f"{version!r} (this build reads version "
                             f"{SCHEMA_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(doc) - known)
        if unknown:
            raise ValueError(f"ServeConfig.from_json: unknown fields "
                             f"{unknown} (schema version {SCHEMA_VERSION} "
                             f"knows {sorted(known)})")
        if "buckets" in doc:
            doc["buckets"] = tuple(doc["buckets"])
        return cls(**doc)
