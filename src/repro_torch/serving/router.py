"""Request router for disaggregated serving: one front door over a prefill
engine and a decode engine (port of ``src/repro/serving/router.py``).

Two transports, one protocol:

* :class:`Router`: both engines in THIS process.  A deterministic round:
  import ready spans into free decode slots, prefill the next queued
  request, tick the decode fleet.  The decode ticks' host-clock time is
  kept apart from prefill work (``decode_tick_times``): a prompt flood
  lands on the prefill engine, never inside the decode fleet's tick.
* :func:`run_disaggregated`: the same protocol over TWO processes (stdlib
  ``multiprocessing`` with the ``spawn`` context, pipes, and
  ``PageSpan.to_bytes`` frames).  Each worker rebuilds its model from the
  arch name and the seed and its engine from the ``ServeConfig`` JSON, on
  the device ``spec["device"]`` names (the card unless it says
  ``"cpu"``).  ``fork`` is never used: it breaks a process that has
  initialised CUDA.

Per-request semantics are the combined scheduler's: the oversize policy
runs prefill-side at submission, a rejected request comes back as
``RequestResult(finish_reason="rejected")`` under the ROUTER's rid and
submit time, and a finished one as the decode scheduler's own result.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.config import ServeConfig
from repro_torch.serving.scheduler import RequestResult
from repro_torch.serving.workers import DecodeEngine, PageSpan, PrefillEngine


class Router:
    """In-process disaggregated router: submit as to the scheduler, run to
    completion, get per-request results in rid order.  ``device=None`` is
    the card."""

    def __init__(self, cfg, params, config: ServeConfig, *, device=None,
                 span_backlog: int = 4):
        self.config = config
        self.prefill = PrefillEngine(cfg, params, config, device=device)
        self.decode = DecodeEngine(cfg, params, config, device=device)
        # prefilled spans waiting for a decode slot; the bound keeps the
        # prefill engine from running far ahead of the decode fleet (each
        # span holds a host copy of its pages)
        self.span_backlog = max(1, int(span_backlog))
        self._queue: deque = deque()
        self._spans: deque = deque()
        self._results: Dict[int, RequestResult] = {}
        self._next_rid = 0
        #: the decode fleet's tick times (host clock, seconds), prefill
        #: work excluded
        self.decode_tick_times: List[float] = []

    def submit(self, prompt, max_new: int,
               eos_id: Optional[int] = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, np.asarray(prompt, np.int32), int(max_new),
                            eos_id, time.perf_counter()))
        return rid

    # ------------------------------------------------------------ drive
    def _admit_ready_spans(self) -> bool:
        progressed = False
        while self._spans:
            rid, span, t = self._spans[0]
            status = self.decode.admit(span, rid, t)
            if status in ("full", "wait"):
                break
            self._spans.popleft()
            progressed = True            # "ok", or "drop" (result recorded)
        return progressed

    def _prefill_next(self) -> bool:
        if not self._queue or len(self._spans) >= self.span_backlog:
            return False
        rid, prompt, max_new, eos_id, t = self._queue.popleft()
        span, rejected = self.prefill.prefill(prompt, max_new, eos_id)
        if rejected is not None:
            # the router's identity: the prefill scheduler assigned its own
            # rid and submit time
            self._results[rid] = dataclasses.replace(
                rejected, rid=rid, submit_time=t)
        else:
            self._spans.append((rid, span, t))
        return True

    def _tick_decode(self) -> bool:
        if not self.decode.active:
            return False
        t0 = time.perf_counter()
        self.decode.step()               # ends in the tick's host copy
        self.decode_tick_times.append(time.perf_counter() - t0)
        self._results.update(self.decode.drain_results())
        return True

    def step(self) -> bool:
        """One router round; False when no sub-step made progress."""
        progressed = self._admit_ready_spans()
        progressed |= self._prefill_next()
        progressed |= self._tick_decode()
        return progressed

    def run(self) -> List[RequestResult]:
        """Drive everything submitted so far to completion; results in rid
        order (as ``ServeScheduler.run`` gives them)."""
        want = self._next_rid
        while self._queue or self._spans or self.decode.active:
            if not self.step():
                stuck = [rid for rid, _, _ in self._spans]
                raise RuntimeError(
                    f"router wedged: spans for rids {stuck} cannot be "
                    f"imported (decode pool too small for the span?) and "
                    f"no decode work is in flight")
        self._results.update(self.decode.drain_results())
        return [self._results.pop(rid) for rid in range(want)
                if rid in self._results]


# ---------------------------------------------------------------------------
# two-process transport
# ---------------------------------------------------------------------------

def _worker_main(conn, role: str, spec: dict) -> None:
    """Worker process entry (the spawn target): rebuild the model from the
    arch name (``smoke``: its smoke config; ``f32``: at float32) and
    random weights from ``torch.Generator(device).manual_seed(seed)``,
    quantized when ``quant`` (on packed planes with ``pack``, the floats
    dropped with ``drop_float``), on ``spec["device"]`` (None: the card);
    the engine from the ServeConfig JSON; then serve the parent's requests
    over the pipe."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params

    dev = resolve_device(spec["device"])
    cfg = (get_smoke(spec["arch"]) if spec["smoke"]
           else get_config(spec["arch"]))
    if spec["f32"]:
        cfg = cfg.replace(dtype=torch.float32)
    params = init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(spec["seed"]), device=dev)
    if spec["quant"]:
        params = quantize_model_params(cfg, params, pack=spec["pack"],
                                       drop_float=spec["drop_float"])
    config = ServeConfig.from_json(spec["config_json"])

    if role == "prefill":
        eng = PrefillEngine(cfg, params, config, device=dev)
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            _, rid, prompt, max_new, eos_id = msg
            span, rejected = eng.prefill(np.asarray(prompt, np.int32),
                                         max_new, eos_id)
            if rejected is not None:
                conn.send(("rejected", rid, rejected.error,
                           rejected.prompt_len))
            else:
                conn.send(("span", rid, span.to_bytes()))
    else:
        eng = DecodeEngine(cfg, params, config, device=dev)
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            if msg[0] == "admit":
                _, rid, blob, t = msg
                status = eng.admit(PageSpan.from_bytes(blob), rid, t)
                conn.send(("admitted", rid, status))
            elif msg[0] == "tick":
                t0 = time.perf_counter()
                eng.step()
                dt = time.perf_counter() - t0
                done = [(r.rid, list(r.tokens), r.finish_reason,
                         r.prompt_len, r.error)
                        for r in eng.drain_results().values()]
                conn.send(("results", done, eng.active, dt))
    conn.close()


def _died(proc, what: str) -> RuntimeError:
    proc.join(timeout=30)
    return RuntimeError(f"disaggregated worker died during {what} "
                        f"(exitcode={proc.exitcode})")


def _send(conn, proc, what: str, msg) -> None:
    try:
        conn.send(msg)
    except OSError:                      # the worker's end is closed
        raise _died(proc, what) from None


def _recv(conn, proc, what: str, timeout: float):
    if not conn.poll(timeout):
        alive = proc.is_alive()
        raise RuntimeError(f"disaggregated worker timed out waiting for "
                           f"{what} (alive={alive}, "
                           f"exitcode={proc.exitcode})")
    try:
        return conn.recv()
    except (EOFError, OSError):          # closed, or reset by its death
        raise _died(proc, what) from None


def run_disaggregated(trace, *, arch: str, config: ServeConfig,
                      smoke: bool = True, f32: bool = True, seed: int = 0,
                      quant: bool = False, pack: bool = False,
                      drop_float: bool = False, device=None,
                      timeout: float = 600.0, frames: Optional[list] = None):
    """Serve ``trace`` (a list of ``(prompt, max_new, eos_id)``) across TWO
    spawned worker processes, prefill and decode, on ``device`` (None: the
    card); returns ``([(rid, tokens, finish_reason, error), ...]`` in rid
    order, the decode worker's per-tick seconds)``.

    The parent builds no model: it sends prompts to the prefill worker,
    ``PageSpan`` frames to the decode worker, and ticks the decode worker
    until every admitted request retires.  On the card it builds the
    kernel libraries first, so the workers load them instead of racing
    to build them.  ``frames``, when given, collects each frame's size
    in bytes.  A worker that dies or stalls past ``timeout`` raises."""
    import multiprocessing as mp

    spec = {"arch": arch, "smoke": smoke, "f32": f32, "seed": seed,
            "quant": quant, "pack": pack, "drop_float": drop_float,
            "device": None if device is None else str(device),
            "config_json": config.to_json()}
    from repro_torch import resolve_device
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    ctx = mp.get_context("spawn")
    p_parent, p_child = ctx.Pipe()
    d_parent, d_child = ctx.Pipe()
    prefill = ctx.Process(target=_worker_main,
                          args=(p_child, "prefill", spec), daemon=True)
    decode = ctx.Process(target=_worker_main,
                         args=(d_child, "decode", spec), daemon=True)
    prefill.start()
    decode.start()
    # the parent keeps only its own ends: a dead worker's pipe then reads
    # as closed instead of waiting for the timeout
    p_child.close()
    d_child.close()
    results: Dict[int, tuple] = {}
    tick_times: List[float] = []
    in_flight = 0

    def tick_once():
        nonlocal in_flight
        _send(d_parent, decode, "tick", ("tick",))
        _, done, active, dt = _recv(d_parent, decode, "tick", timeout)
        tick_times.append(dt)
        for rid, tokens, reason, plen, err in done:
            results[rid] = (rid, tokens, reason, err)
            in_flight -= 1
        return active

    try:
        for rid, (prompt, max_new, eos_id) in enumerate(trace):
            _send(p_parent, prefill, "prefill", (
                "prefill", rid, np.asarray(prompt, np.int32), int(max_new),
                eos_id))
            kind, _, *payload = _recv(p_parent, prefill, "prefill", timeout)
            if kind == "rejected":
                results[rid] = (rid, [], "rejected", payload[0])
                continue
            blob = payload[0]
            if frames is not None:
                frames.append(len(blob))
            while True:
                _send(d_parent, decode, "admit",
                      ("admit", rid, blob, time.perf_counter()))
                _, _, status = _recv(d_parent, decode, "admit", timeout)
                if status in ("ok", "drop"):
                    # a drop's rejected result comes with the next tick's
                    # drain, like any retirement
                    in_flight += 1
                    break
                tick_once()     # "full"/"wait": free a slot by ticking
        while in_flight:
            tick_once()
    finally:
        for conn, proc in ((p_parent, prefill), (d_parent, decode)):
            try:
                conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
            conn.close()
    for name, proc in (("prefill", prefill), ("decode", decode)):
        if proc.exitcode != 0:
            raise RuntimeError(f"disaggregated {name} worker exited with "
                               f"code {proc.exitcode}")
    ordered = [results[rid] for rid in sorted(results)]
    return ordered, tick_times
