"""Serving: one-shot generation, the continuous-batching slot scheduler
over a dense or paged KV pool, its config, the program type that runs
their steps as CUDA graphs, and disaggregated serving (prefill and decode
engines passing ``PageSpan`` frames, in one process or two; mirrors
``src/repro/serving``)."""

from repro_torch.serving.config import SCHEMA_VERSION, ServeConfig
from repro_torch.serving.engine import (Program, clear_generate_cache,
                                        compiled_size, eager, generate_fn,
                                        greedy_generate, make_decode_loop,
                                        make_prefill_step, make_serve_step,
                                        make_slot_prefill,
                                        make_slot_prefill_chunk,
                                        make_slot_serve_step,
                                        reference_generate,
                                        set_generate_cache_size)
from repro_torch.serving.kvpool import (PagePool, PrefixHit, RadixCache,
                                        blocks_for_tokens)
from repro_torch.serving.router import Router, run_disaggregated
from repro_torch.serving.scheduler import (Request, RequestResult,
                                           ServeScheduler, bucket_for,
                                           round_pool_len)
from repro_torch.serving.workers import DecodeEngine, PageSpan, PrefillEngine

__all__ = ["SCHEMA_VERSION", "ServeConfig", "Program",
           "clear_generate_cache", "compiled_size", "eager", "generate_fn",
           "set_generate_cache_size", "greedy_generate",
           "make_decode_loop", "make_prefill_step", "make_serve_step",
           "make_slot_prefill", "make_slot_prefill_chunk",
           "make_slot_serve_step", "reference_generate", "PagePool",
           "PrefixHit", "RadixCache", "blocks_for_tokens", "Request",
           "RequestResult", "ServeScheduler", "bucket_for",
           "round_pool_len", "PageSpan", "PrefillEngine", "DecodeEngine",
           "Router", "run_disaggregated"]
