"""The port held bit-equal to the JAX package at bf16, the dtype the card
serves in, on the smoke config with the reference's weights carried across
by ``models.convert``.

At XLA's default flags the jitted reference does not round as its source
is written: it fuses the residual add ``x = x + out`` into the next
``rms_norm`` and keeps the sum in f32 (``--xla_allow_excess_precision``
is on by default), so about a quarter of that norm's bf16 outputs move by
one ulp and the LOG2 codes of the next projection amplify it.  With the
flag off, the reference rounds every op to bf16 as written, and the port,
which follows the written op order, is bit-equal to it.

The flag is read when XLA's CPU backend starts, and an xdist worker has
usually started JAX already.  So every comparison runs in ONE child
process whose environment alone carries the flag (this process's
``os.environ`` is never touched); the child returns its verdicts as JSON
on its last line of stdout, and each test below reads one verdict.  If
the child exits non-zero, times out or prints no verdicts, every test
here fails.

What is held equal, at bf16:

* one-shot cached forward (prefill 2x8 tokens, then one decode step),
  float and quantized: logits **bit-equal**, and the plane-traffic stats
  (``plane_fetched``, ``plane_total`` and both fractions) equal;
* the continuous-batching scheduler, tick by tick, in the modes of
  ``tests/test_torch_scheduler.py`` and ``tests/test_torch_kv_quant.py``
  that match the card's two serving paths (``quant_paged_k3_stats``:
  quantized projections with stats over the dense pool through K3 with
  split-KV 2; ``quant_stats``: quantized projections with stats over the
  log2-quantized pool through K4 with split-KV 2, chunked prefill), by
  those files' own comparisons: every ``step_tick`` return,
  per-slot lengths, page tables, refcounts, free list, prefix stats,
  tokens and finish records and, with ``kv_quant``, every non-trash
  page's codes and scales.  The K3 and K4 modes run the kernels' plain
  versions here, as on any CPU.  The other 15 modes are left out to keep
  the child near a minute and a half (all 17 took about 290 s; all but
  ``cow_hit`` below are bit-equal too).

Bit-equality here is what these inputs give, not a property of the two
programs: XLA and ATen sum the f32 products of an einsum and a softmax in
other orders, so their f32 intermediates differ by an ulp routinely, and
the final bf16 rounding hides it except where a value sits on a rounding
boundary (one attention output in about 300 random 8x64 chunk-attention
cases).  The kv_quant ``cow_hit`` mode meets one: a third 8-token chunk's
attention output moves by one bf16 ulp, and one of its 6144 K/V codes
differs (tokens and tables stay equal).

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_bf16.py``
(one child process of about 90 s).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FLAG = "--xla_allow_excess_precision=false"
CHILD_TIMEOUT_S = 600

ONESHOT = ("float", "quant")
# modes of tests/test_torch_scheduler.py's and tests/test_torch_kv_quant.py's
# MODES (the child checks that they are still there)
SCHED_MODES = ("quant_paged_k3_stats",)
KVQ_MODES = ("quant_stats",)


def _child_env() -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS", ""), FLAG)
                                if f)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         str(ROOT / "tests")])
    return env


@pytest.fixture(scope="module")
def verdicts():
    """Runs the child once for the module: ``{name: [ok, detail]}``, or
    ``{"__error__": message}`` when the child failed."""
    cmd = [sys.executable, "-c",
           "import test_torch_bf16 as t; t.child_main()"]
    try:
        proc = subprocess.run(cmd, env=_child_env(), cwd=ROOT,
                              capture_output=True, text=True,
                              timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"__error__": f"the bf16 child timed out after "
                             f"{CHILD_TIMEOUT_S} s"}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return {"__error__": f"the bf16 child exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}"}
    try:
        return json.loads(lines[-1])
    except json.JSONDecodeError:
        return {"__error__": f"the bf16 child printed no verdicts:\n"
                             f"{proc.stdout[-2000:]}"}


def _held(verdicts, name):
    if "__error__" in verdicts:
        pytest.fail(verdicts["__error__"])
    if name not in verdicts:
        pytest.fail(f"the bf16 child gave no verdict for {name}")
    ok, detail = verdicts[name]
    assert ok, f"{name}: {detail}"


@pytest.mark.parametrize("quant", ONESHOT)
def test_oneshot_logits_and_stats_bit_equal(verdicts, quant):
    _held(verdicts, f"oneshot/{quant}")


@pytest.mark.parametrize("mode", SCHED_MODES)
def test_scheduler_bit_equal(verdicts, mode):
    _held(verdicts, f"sched/{mode}")


@pytest.mark.parametrize("mode", KVQ_MODES)
def test_kv_quant_scheduler_bit_equal(verdicts, mode):
    _held(verdicts, f"kvq/{mode}")


def test_child_saw_only_its_own_flag(verdicts):
    """The flag reached the child, and this process's environment never
    carried it."""
    _held(verdicts, "env")
    assert FLAG not in os.environ.get("XLA_FLAGS", "")


# ---------------------------------------------------------------------------
# the child process
# ---------------------------------------------------------------------------

def _oneshot(jcfg, jparams, cfg, params, quant):
    """Prefill 2x8 tokens then decode one, in both frameworks, at bf16."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models import model as jax_model
    from repro.models.quantize import quantize_model_params as jax_quantize
    from repro_torch.models import model
    from repro_torch.models.quantize import quantize_model_params

    if quant:
        jparams = jax_quantize(jcfg, jparams)
        params = quantize_model_params(cfg, params)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                         jcfg.vocab_size))
    jq = "xla" if quant else False
    jc = jax_model.init_caches(jcfg, 2, 9, dtype=jcfg.dtype)
    jl, jc, js = jax_model.forward(jcfg, jparams, tokens=jnp.asarray(tokens),
                                   caches=jc, quant=jq, return_stats=True)
    nxt = np.array(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, _, js2 = jax_model.forward(jcfg, jparams, tokens=jnp.asarray(nxt),
                                    caches=jc, quant=jq, return_stats=True)
    c = model.init_caches(cfg, 2, 9, dtype=cfg.dtype, device="cpu")
    l, c, st = model.forward(cfg, params, tokens=torch.from_numpy(tokens),
                             caches=c, quant=quant, return_stats=True)
    l2, _, st2 = model.forward(cfg, params, tokens=torch.from_numpy(nxt),
                               caches=c, quant=quant, return_stats=True)
    for name, mine, ref in (("prefill", l, jl), ("decode", l2, jl2)):
        a = mine.float().numpy()
        b = np.asarray(ref).astype(np.float32)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        diff = np.abs(a - b)
        assert np.array_equal(a, b), \
            f"{name} logits differ: max |diff| {diff.max()}, " \
            f"{int((diff > 0).sum())} of {diff.size} elements"
    for a, b in ((st, js), (st2, js2)):
        for key in ("plane_fetched", "plane_total", "plane_traffic_fraction",
                    "element_traffic_fraction"):
            assert float(a[key]) == float(b[key]), \
                (key, float(a[key]), float(b[key]))
    return f"logits {tuple(l.shape)} and {tuple(l2.shape)} bit-equal"


def child_main():
    """Runs every comparison and prints ``{name: [ok, detail]}`` as JSON
    on the last line of stdout.  Needs the flag in its environment."""
    assert FLAG in os.environ.get("XLA_FLAGS", "").split(), \
        f"the child needs {FLAG} in XLA_FLAGS before JAX starts"
    assert "jax" not in sys.modules
    import time
    import traceback

    import jax
    import numpy as np
    import torch

    import test_torch_kv_quant as tkq
    import test_torch_scheduler as tsc
    from repro.configs import get_smoke as jax_get_smoke
    from repro.models import init_params as jax_init_params
    from repro.models.quantize import quantize_model_params as jax_quantize
    from repro_torch.configs import get_smoke
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.quantize import quantize_model_params

    out = {"env": [FLAG in os.environ["XLA_FLAGS"].split(),
                   os.environ["XLA_FLAGS"]]}

    def held(name, fn, *args):
        t0 = time.perf_counter()
        try:
            detail = fn(*args) or "equal"
            out[name] = [True, f"{detail} ({time.perf_counter() - t0:.1f} s)"]
        except Exception as e:      # any failure is this verdict's, not the run's
            out[name] = [False, f"{type(e).__name__}: {e}\n"
                                f"{traceback.format_exc()[-1500:]}"]

    jcfg = jax_get_smoke("smollm_135m")
    cfg = get_smoke("smollm-135m")
    assert np.dtype(jcfg.dtype).name == "bfloat16"
    assert cfg.dtype == torch.bfloat16
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    for quant in ONESHOT:
        held(f"oneshot/{quant}", _oneshot, jcfg, jparams, cfg, params,
             quant == "quant")

    jq, tq = jax_quantize(jcfg, jparams), quantize_model_params(cfg, params)
    model = {False: (jcfg, jparams, cfg, params), True: (jcfg, jq, cfg, tq)}
    assert set(SCHED_MODES) <= set(tsc.MODES), tuple(tsc.MODES)
    for mode in SCHED_MODES:
        held(f"sched/{mode}", tsc.test_scheduler_matches_reference, model,
             mode)
    assert set(KVQ_MODES) <= set(tkq.MODES), tuple(tkq.MODES)
    for mode in KVQ_MODES:
        held(f"kvq/{mode}", tkq.test_scheduler_matches_reference,
             (jcfg, jparams, cfg, params), (jq, tq), mode)
    print(json.dumps(out))
