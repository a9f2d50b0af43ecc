"""The port's disaggregated serving (``serving/workers.py``,
``serving/router.py``) held against the JAX package's on the smoke
configs at f32, with the reference test's ``CONFIG`` and prompts and the
same weights (``models.convert``).

Frames: a ``PageSpan`` frame written by either package is read by the
other and written again to the same bytes (float, kv_quant and bf16, the
last from a frame the reference wrote); the port's spans equal the
reference's (prompt, codes and scales equal; float pages, tails and
logits within ``rtol = atol = 1e-5``, ``test_torch_model.py``'s bar:
XLA and ATen sum a projection's products in other orders, and a K entry
near 0 of a smoke prefill moves by 2.1e-6); corrupt frames raise the
reference's messages.  Engines: reference spans decoded by the port's
``DecodeEngine`` and the port's spans decoded by the reference's give the
reference combined scheduler's tokens; a transplant keeps ``PagePool`` and
``RadixCache`` consistent on both sides, with the reference's page
tables, refcounts and admission statuses; an import writes in place.
The two-process transport on the CPU equals the port's combined
scheduler, and a dying worker fails the run.  The CLI's
``--disaggregate`` serves ``--continuous``'s tokens.  The ``Router``
cases are in ``test_torch_disagg_router.py``.
"""

import dataclasses
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro.serving.config import ServeConfig as JaxServeConfig
from repro.serving.scheduler import ServeScheduler as JaxScheduler
from repro.serving.workers import DecodeEngine as JaxDecodeEngine
from repro.serving.workers import PageSpan as JaxPageSpan
from repro.serving.workers import PrefillEngine as JaxPrefillEngine
from repro_torch.configs import get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import init_params
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import (DecodeEngine, PageSpan, PrefillEngine,
                                 Router, ServeConfig, ServeScheduler,
                                 run_disaggregated)
from repro_torch.serving.engine import fingerprint
from repro_torch.serving.workers import BF16Bits

CONFIG = dict(max_slots=2, max_len=48, buckets=(8, 16), tick_steps=2,
              paged=True, page_len=8, chunked="auto", chunk_len=8)
KVQ = dict(CONFIG, kv_quant=True, kv_bits=4)
RTOL = ATOL = 1e-5
# the engine-crossing cases: (config, prompt sizes), max_new 6
CROSS = {"float": (CONFIG, (5, 13, 9, 30, 7, 16)),
         "kv_quant": (KVQ, (9, 13, 21, 11))}


def _pair(arch, dtype):
    jcfg = jax_get_smoke(arch.replace("-", "_")).replace(
        dtype=getattr(jnp, dtype))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke(arch).replace(dtype=getattr(torch, dtype))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def smollm():
    return _pair("smollm-135m", "float32")


def _prompts(vocab, sizes, seed=0):
    """The reference test's prompts."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in sizes]


@pytest.fixture(scope="module")
def ref_combined(smollm):
    """The reference combined scheduler's tokens per ``CROSS`` case."""
    jcfg, jparams, cfg, _ = smollm
    out = {}
    for name, (kw, sizes) in CROSS.items():
        sched = JaxScheduler(jcfg, jparams, JaxServeConfig(**kw))
        for p in _prompts(cfg.vocab_size, sizes):
            sched.submit(p, max_new=6)
        out[name] = [r.tokens for r in sched.run()]
    return out


def _decode_all(dec, spans):
    """Admit ``spans`` in order into ``dec`` (either package's
    ``DecodeEngine``), ticking while it answers "full" or "wait", then
    drain; the tokens in rid order."""
    results = {}
    for rid, span in enumerate(spans):
        while (status := dec.admit(span, rid, 0.0)) in ("full", "wait"):
            dec.step()
            results.update(dec.drain_results())
        assert status == "ok"
    while dec.active:
        dec.step()
    results.update(dec.drain_results())
    return [results[rid].tokens for rid in sorted(results)]


def _bits(a):
    """A span array's bytes as compared: bf16 by its bit patterns."""
    if isinstance(a, BF16Bits) or a.dtype.name == "bfloat16":
        return np.asarray(a).view(np.uint16)
    return np.asarray(a)


def _assert_spans_close(ref, ours):
    """The port's span against the reference's: fields, prompt, codes and
    scales equal; float pages, tails and logits within RTOL/ATOL."""
    for field in ("length", "max_new", "eos_id", "page_len", "kv_quant",
                  "kv_bits", "hit_len", "shared_pages"):
        assert getattr(ours, field) == getattr(ref, field), field
    np.testing.assert_array_equal(ours.prompt, ref.prompt)
    np.testing.assert_allclose(ours.logits, ref.logits, rtol=RTOL, atol=ATOL)
    assert len(ours.layers) == len(ref.layers)
    for a, b in zip(ref.layers, ours.layers):
        assert sorted(a) == sorted(b)
        for k in a:
            assert b[k].shape == a[k].shape and b[k].dtype == a[k].dtype, k
            if np.issubdtype(a[k].dtype, np.floating):
                np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# --------------------------------------------------------------------------
# frames
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["float", "kv_quant", "bf16"])
def test_frames_cross_between_the_frameworks(smollm, mode):
    """A reference frame read by the port and written again is the same
    bytes, and a port frame read by the reference and written again is
    too; at f32 the two packages' spans of one prompt agree."""
    kw = KVQ if mode == "kv_quant" else CONFIG
    jcfg, jparams, cfg, params = (_pair("smollm-135m", "bfloat16")
                                  if mode == "bf16" else smollm)
    prompt = _prompts(cfg.vocab_size, (13,))[0]
    ref, _ = JaxPrefillEngine(jcfg, jparams, JaxServeConfig(**kw)).prefill(
        prompt, max_new=6)
    ours, _ = PrefillEngine(cfg, params, ServeConfig(**kw),
                            device="cpu").prefill(prompt, max_new=6)
    ref_blob, our_blob = ref.to_bytes(), ours.to_bytes()
    back = PageSpan.from_bytes(ref_blob)
    assert back.to_bytes() == ref_blob
    assert JaxPageSpan.from_bytes(our_blob).to_bytes() == our_blob
    # the port reads the reference's arrays bit for bit
    np.testing.assert_array_equal(_bits(back.logits), _bits(ref.logits))
    for a, b in zip(ref.layers, back.layers):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(_bits(b[k]), _bits(a[k]),
                                          err_msg=k)
    if mode == "bf16":
        assert isinstance(back.logits, BF16Bits)
        assert isinstance(back.layers[0]["k"], BF16Bits)
        assert ref.logits.dtype.name == "bfloat16"
    else:
        _assert_spans_close(ref, ours)


def _corrupt(blob, how):
    magic = len(b"RPSPAN")
    if how == "short":
        return blob[:8]
    if how == "magic":
        return b"XX" + blob[2:]
    if how == "version":
        return blob[:6] + b"\x63\x00\x00\x00" + blob[10:]
    if how == "header":
        return blob[:40]
    if how == "crc":
        flipped = bytearray(blob)
        flipped[len(blob) // 2] ^= 0xFF
        return bytes(flipped)
    # whole payload bytes cut, the CRC recomputed: the manifest check
    fixed = magic + 8
    hdr_len, = struct.unpack_from("<I", blob, magic + 4)
    hdr = blob[fixed:fixed + hdr_len]
    payload = blob[fixed + hdr_len:-4][:-16]
    return (blob[:fixed + hdr_len] + payload
            + struct.pack("<I", zlib.crc32(hdr + payload)))


@pytest.mark.parametrize("how,match", [
    ("short", "shorter than the fixed frame"), ("magic", "bad magic"),
    ("version", "wire version 99"), ("header", "frame is short"),
    ("crc", "CRC32 mismatch"), ("manifest", "manifest claims")])
def test_corrupt_frames_raise_the_reference_messages(smollm, how, match):
    _, _, cfg, params = smollm
    span, _ = PrefillEngine(cfg, params, ServeConfig(**CONFIG),
                            device="cpu").prefill(
        _prompts(cfg.vocab_size, (9,))[0], max_new=2)
    bad = _corrupt(span.to_bytes(), how)
    with pytest.raises(ValueError, match=match) as ours:
        PageSpan.from_bytes(bad)
    with pytest.raises(ValueError) as ref:
        JaxPageSpan.from_bytes(bad)
    assert str(ours.value) == str(ref.value)


# --------------------------------------------------------------------------
# spans across the two packages' engines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CROSS))
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_spans_cross_between_the_engines(smollm, ref_combined, case,
                                         direction):
    """Spans prefilled by one package and decoded by the other give the
    reference combined scheduler's tokens."""
    jcfg, jparams, cfg, params = smollm
    kw, sizes = CROSS[case]
    prompts = _prompts(cfg.vocab_size, sizes)
    if direction == "reference_to_port":
        pre = JaxPrefillEngine(jcfg, jparams, JaxServeConfig(**kw))
        dec = DecodeEngine(cfg, params, ServeConfig(**kw), device="cpu")
        read = PageSpan.from_bytes
    else:
        pre = PrefillEngine(cfg, params, ServeConfig(**kw), device="cpu")
        dec = JaxDecodeEngine(jcfg, jparams, JaxServeConfig(**kw))
        read = JaxPageSpan.from_bytes
    spans = [read(pre.prefill(p, max_new=6)[0].to_bytes()) for p in prompts]
    assert _decode_all(dec, spans) == ref_combined[case]


# --------------------------------------------------------------------------
# transplant integrity, admission, config checks, in-place import
# --------------------------------------------------------------------------

def _meta(sched):
    return (sched._table.tolist(), sched._pages.refcount.tolist(),
            sorted(sched._pages._free),
            None if sched._radix is None else sched._radix.n_pages)


def test_transplant_pool_and_radix_integrity(smollm):
    """Exports (prefill side, pages donated to the radix tree, a hit on
    the second prompt) and imports (decode side, fresh pages) keep every
    refcount and tree invariant, with the reference's tables, refcounts,
    free lists and radix size after every step; freeing the decode slots
    returns the decode pool to all but the trash page."""
    jcfg, jparams, cfg, params = smollm
    kw = dict(CONFIG, prefix_cache=True)
    sides = [(PrefillEngine(cfg, params, ServeConfig(**kw), device="cpu"),
              DecodeEngine(cfg, params, ServeConfig(**kw), device="cpu"),
              PageSpan),
             (JaxPrefillEngine(jcfg, jparams, JaxServeConfig(**kw)),
              JaxDecodeEngine(jcfg, jparams, JaxServeConfig(**kw)),
              JaxPageSpan)]
    assert sides[0][1].scheduler._radix is None
    base = _prompts(cfg.vocab_size, (13,))[0]
    prompts = [base, np.concatenate([base[:8], base[:5]])]
    for rid, p in enumerate(prompts):
        metas = []
        for pre, dec, span_type in sides:
            span, rejected = pre.prefill(p, max_new=4)
            assert rejected is None
            pre.scheduler._pages.verify()
            pre.scheduler._radix.verify()
            assert dec.admit(span_type.from_bytes(span.to_bytes()), rid=rid,
                             submit_time=0.0) == "ok"
            dec.scheduler._pages.verify()
            metas.append((_meta(pre.scheduler), _meta(dec.scheduler),
                          span.hit_len, span.shared_pages))
        assert metas[0] == metas[1], f"request {rid}"
    assert sides[0][0].scheduler._radix.n_pages > 0
    assert sides[0][0].scheduler._radix.hits == 1
    dec = sides[0][1]
    while dec.active:
        dec.step()
        dec.scheduler._pages.verify()
    assert sorted(dec.drain_results()) == [0, 1]
    assert dec.scheduler._pages.available == dec.scheduler._pages.n_pages - 1


def _statuses(pre, dec):
    """The reference test's admission sequence on a 4-page decode pool."""
    spans = [pre.prefill(p, max_new=2)[0]
             for p in _prompts(pre.scheduler.cfg.vocab_size, (9, 11, 20, 30))]
    got = [dec.admit(spans[0], 0, 0.0), dec.admit(spans[1], 1, 0.0),
           dec.admit(spans[2], 2, 0.0)]
    while dec.active:
        dec.step()
    got += [dec.admit(spans[0], 3, 0.0), dec.admit(spans[2], 4, 0.0)]
    while dec.active:
        dec.step()
    got.append(dec.admit(spans[2], 4, 0.0))
    while dec.active:
        dec.step()
    got.append(dec.admit(spans[3], 5, 0.0))
    results = dec.drain_results()
    return got, {rid: (r.tokens, r.finish_reason, r.error)
                 for rid, r in sorted(results.items())}


def test_decode_admission_statuses_match_the_reference(smollm):
    """'ok', 'full' (no free slot), 'wait' (a free slot, not enough pages
    while an import is live), 'drop' (never enough pages: a rejected
    result under its rid): the reference's sequence, tokens and errors."""
    jcfg, jparams, cfg, params = smollm
    tiny = dict(CONFIG, n_pages=1 + 4)
    ours = _statuses(
        PrefillEngine(cfg, params, ServeConfig(**CONFIG), device="cpu"),
        DecodeEngine(cfg, params, ServeConfig(**tiny), device="cpu"))
    ref = _statuses(JaxPrefillEngine(jcfg, jparams, JaxServeConfig(**CONFIG)),
                    JaxDecodeEngine(jcfg, jparams, JaxServeConfig(**tiny)))
    assert ours[0] == ["ok", "ok", "full", "ok", "wait", "ok", "drop"]
    assert ours == ref
    assert ours[1][5][1] == "rejected" and ours[1][5][2]


@pytest.mark.parametrize("span_kw,dec_kw", [
    (CONFIG, dict(CONFIG, page_len=4, chunk_len=4)),
    (CONFIG, KVQ),
    (KVQ, dict(KVQ, kv_bits=3))])
def test_span_config_mismatch_raises(smollm, span_kw, dec_kw):
    _, _, cfg, params = smollm
    span, _ = PrefillEngine(cfg, params, ServeConfig(**span_kw),
                            device="cpu").prefill(
        _prompts(cfg.vocab_size, (9,))[0], max_new=2)
    dec = DecodeEngine(cfg, params, ServeConfig(**dec_kw), device="cpu")
    with pytest.raises(ValueError, match="PageSpan/config mismatch"):
        dec.admit(span, rid=0, submit_time=0.0)


@pytest.mark.parametrize("who", [Router, PrefillEngine, DecodeEngine])
def test_disaggregation_requires_a_paged_config(smollm, who):
    _, _, cfg, params = smollm
    with pytest.raises(ValueError, match="requires a paged ServeConfig"):
        who(cfg, params, ServeConfig(max_len=48, buckets=(8, 16)),
            device="cpu")


@pytest.mark.parametrize("arch,kw", [("smollm-135m", CONFIG),
                                     ("smollm-135m", KVQ),
                                     ("mamba2-780m", CONFIG)])
def test_import_writes_in_place(arch, kw):
    """After a decode tick (its program bound), an import leaves every
    tensor the programs read at its address and shape, and the slot's
    pages, state, tail ring, length, logits and table row hold the span
    exactly; the next tick runs (a rebound tensor would raise)."""
    cfg = get_smoke(arch).replace(dtype=torch.float32)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    pre = PrefillEngine(cfg, params, ServeConfig(**kw), device="cpu")
    dec = DecodeEngine(cfg, params, ServeConfig(**kw), device="cpu")
    first, second = (pre.prefill(p, max_new=6)[0]
                     for p in _prompts(cfg.vocab_size, (13, 21)))
    s = dec.scheduler
    assert dec.admit(first, 0) == "ok"
    dec.step()
    before = fingerprint(s._bound())
    assert dec.admit(second, 1) == "ok"
    assert fingerprint(s._bound()) == before
    slot = 1
    pages = torch.as_tensor(s._table[slot, :second.n_blocks].astype(np.int64))
    for c, grp in zip(s._pool["layers"], second.layers):
        for k, t in c.items():
            if "ssm" in c:
                got = t[:, slot:slot + 1]
            elif k.endswith("_tail"):
                got = t[:, slot]
            else:
                got = t.index_select(1, pages)
            np.testing.assert_array_equal(got.numpy(), grp[k], err_msg=k)
    assert int(s._pool["length"][slot]) == second.length
    np.testing.assert_array_equal(s._logits[slot].numpy(), second.logits)
    assert dec.step()


# --------------------------------------------------------------------------
# two processes, the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_two_process_run_equals_the_combined_scheduler(quant):
    """Prefill and decode in two spawned CPU processes, frames between
    them: the port's combined scheduler's tokens from the same seed,
    the reject included; quantized, the workers serve packed planes with
    the floats dropped (the combined run keeps them: the quantized path
    never reads them)."""
    cfg = get_smoke("smollm-135m").replace(dtype=torch.float32)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    kw = dict(CONFIG, quant="pallas", with_stats=True) if quant else CONFIG
    if quant:
        params = quantize_model_params(cfg, params, pack=True)
    prompts = _prompts(cfg.vocab_size, (5, 13, 60, 9, 16))
    combined = ServeScheduler(cfg, params, ServeConfig(**kw), device="cpu")
    for p in prompts:
        combined.submit(p, max_new=4)
    want = combined.run()
    frames = []
    got, tick_times = run_disaggregated(
        [(p, 4, None) for p in prompts], arch="smollm-135m",
        config=ServeConfig(**kw), quant=quant, pack=quant, drop_float=quant,
        device="cpu", timeout=240.0, frames=frames)
    assert [rid for rid, *_ in got] == [r.rid for r in want]
    for (rid, tokens, reason, error), w in zip(got, want):
        assert tokens == w.tokens, f"rid {rid}"
        assert reason == w.finish_reason
        assert error == w.error
    assert want[2].finish_reason == "rejected"
    assert tick_times and len(frames) == 4 and min(frames) > 0


def test_two_process_run_fails_when_a_worker_dies():
    with pytest.raises(RuntimeError, match="worker"):
        run_disaggregated([(np.arange(5, dtype=np.int32), 2, None)],
                          arch="no-such-arch", config=ServeConfig(**CONFIG),
                          device="cpu", timeout=120.0)


CLI = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
       "--continuous", "--requests", "6", "--max-slots", "2",
       "--chunked", "--page-len", "4", "--prompt-len", "16",
       "--new-tokens", "6"]


def test_cli_disaggregate_serves_the_continuous_tokens(capsys):
    from repro_torch.launch import serve

    want = serve.main(CLI + ["--paged"])
    sample = capsys.readouterr().out.splitlines()[-1]
    got = serve.main(CLI + ["--paged", "--disaggregate"])
    out = capsys.readouterr().out
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert out.splitlines()[-1] == sample
    assert ": disaggregated, chunked=auto/8, paged/4" in out
    assert "[serve] decode fleet:" in out


def test_cli_disaggregate_needs_a_paged_config():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="requires a paged config"):
        serve.main(CLI + ["--disaggregate"])
