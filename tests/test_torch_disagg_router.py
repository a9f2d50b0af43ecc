"""The port's disaggregated ``Router`` held against the JAX package's
``Router`` and combined ``ServeScheduler`` on the reference test's cases
(``tests/test_disagg.py``): float, kv_quant, the prefix cache (hits taken
prefill-side), mamba (recurrent state in the span) and the reject
policy, at f32 on the smoke configs with the same weights.  Every
request's rid, tokens, finish reason and error equal both.  The helpers
and ``CONFIG`` are ``test_torch_disagg.py``'s.
"""

import numpy as np
import pytest

from repro.serving.config import ServeConfig as JaxServeConfig
from repro.serving.router import Router as JaxRouter
from repro.serving.scheduler import ServeScheduler as JaxScheduler
from repro_torch.serving import Router, ServeConfig
from test_torch_disagg import CONFIG, KVQ, _pair, _prompts


def _prefix_prompts(vocab):
    base = _prompts(vocab, (16,))[0]
    return [base, np.concatenate([base[:8], base[:7]]), base[:12]]


# case: (arch, config, prompts from the vocab size)
CASES = {
    "float": ("smollm-135m", CONFIG,
              lambda v: _prompts(v, (5, 13, 9, 30, 7, 16))),
    "kv_quant": ("smollm-135m", KVQ, lambda v: _prompts(v, (9, 13, 21, 11))),
    "prefix_cache": ("smollm-135m", dict(CONFIG, prefix_cache=True),
                     _prefix_prompts),
    "mamba": ("mamba2-780m", CONFIG, lambda v: _prompts(v, (5, 13, 30, 9))),
    "reject": ("smollm-135m", CONFIG, lambda v: _prompts(v, (9, 60, 11))),
}


@pytest.fixture(scope="module")
def models():
    return {arch: _pair(arch, "float32")
            for arch in ("smollm-135m", "mamba2-780m")}


def _results(sched, prompts):
    for p in prompts:
        sched.submit(p, max_new=6)
    return [(r.rid, r.tokens, r.finish_reason, r.error) for r in sched.run()]


@pytest.mark.parametrize("case", list(CASES))
def test_router_equals_the_reference_router_and_scheduler(models, case):
    arch, kw, make = CASES[case]
    jcfg, jparams, cfg, params = models[arch]
    prompts = make(cfg.vocab_size)
    want = _results(JaxScheduler(jcfg, jparams, JaxServeConfig(**kw)),
                    prompts)
    ref = _results(JaxRouter(jcfg, jparams, JaxServeConfig(**kw)), prompts)
    router = Router(cfg, params, ServeConfig(**kw), device="cpu")
    got = _results(router, prompts)
    assert got == want
    assert got == ref
    assert router.decode_tick_times
    if case == "reject":
        assert got[1][2] == "rejected" and got[1][3]
        assert got[0][1] and got[2][1]
    if case == "prefix_cache":
        assert router.prefill.scheduler.prefix_cache_stats()["cached_tokens"]
