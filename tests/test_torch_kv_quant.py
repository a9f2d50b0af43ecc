"""The port's log2-quantized KV page pool held against the JAX package's,
layer by layer: page codes, the pool writes and the dequantizing gather,
the quantized paged-attention decode (K4's plain version against the
Pallas kernel in interpret mode), and the continuous-batching scheduler
with ``kv_quant=True``.

Bars:

* **Integers are bit-equal**: codes, scale exponents, ``pack_codes`` /
  ``unpack_codes``, pool codes, scales and tail rings after a write
  sequence, page tables, lengths, prefix stats, tokens.  Inputs keep the
  scale exponents within ``[-12, 12]``, where XLA's ``exp2`` on the CPU is
  exact; the reference quantizes ``x * exp2(-se)``, the port by exact
  powers of two.
* **Dequantized values** are bit-equal where ``exp + se`` lies in
  ``[-12, 12]`` and within ``rtol=1e-5`` elsewhere: XLA's ``exp2`` is off
  by up to about 4e-6 relative outside that range, and gives 0 at -126
  (pinned below); the port decodes exact powers of two.
* **K4 against the Pallas kernel**: f32 ``rtol=2e-5, atol=2e-6`` (the
  reference's ``F32_TOL``): both sum the same f32 products in another
  order.  Partials are compared on splits that hold a valid token; both
  keep ``m = NEG_INF, l = 0, acc = 0`` on the others.  Trash-page garbage
  is a bitwise check.
* **Scheduler**: everything the reference exposes compares equal after
  every tick, and the pool's codes and scales on every page but the trash
  page after the run (the trash page takes colliding junk writes).

Inputs come from seeded numpy; the one property test runs derandomized.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core import logquant as jlq
from repro.kernels.paged_attention import kernel as jax_kernel
from repro.kernels.paged_attention import ops as jax_ops
from repro.models import attention as jax_attn
from repro.models import init_params as jax_init_params
from repro.models.model import init_paged_pool as jax_init_pool
from repro.models.quantize import quantize_model_params as jax_quantize
from repro.serving.config import ServeConfig as JaxServeConfig
from repro.serving.scheduler import ServeScheduler as JaxScheduler
from repro_torch.configs import get_smoke
from repro_torch.core import logquant as lq
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_quant_reference, paged_attention_reference)
from repro_torch.models import attention
from repro_torch.models.convert import params_from_numpy, pool_from_numpy
from repro_torch.models.model import init_paged_pool
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import ServeConfig, ServeScheduler

F32_TOL = dict(rtol=2e-5, atol=2e-6)
N_BITS_SWEEP = (2, 3, 4, 5, 8)
FLT_MIN = np.float32(1.1754943508222875e-38)


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


# ---------------------------------------------------------------------------
# page codes
# ---------------------------------------------------------------------------

def _seeded_rows(n_rows=12, width=32, seed=77):
    """Rows of mixed magnitudes (scale exponents within [-12, 12]), exact
    zeros, all-negative rows and one all-zero row."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_rows):
        mag = rng.choice([1e-3, 1e-2, 0.5, 1.0, 64.0, 1e3], width)
        x = (rng.normal(0, 1.0, width) * mag).astype(np.float32)
        x[rng.random(width) < 0.15] = 0.0
        if i % 3 == 0:
            x = -np.abs(x)
        rows.append(x)
    rows.append(np.zeros(width, np.float32))
    return np.stack(rows)


@pytest.mark.parametrize("n_bits", N_BITS_SWEEP)
def test_page_codes_bit_equal_to_reference(n_bits):
    x = _seeded_rows()
    jse = jlq.scale_exponent(jnp.asarray(x), axis=-1, keepdims=True)
    se = lq.scale_exponent(torch.from_numpy(x), dim=-1, keepdim=True)
    np.testing.assert_array_equal(_np(se), np.asarray(jse))
    assert np.abs(_np(se)).max() <= 12
    jc = jlq.quantize_page_codes(jnp.asarray(x), jse, n_bits)
    c = lq.quantize_page_codes(torch.from_numpy(x), se, n_bits)
    assert c.dtype == lq.code_dtype(n_bits)
    assert str(jc.dtype) == str(c.dtype).split(".")[1]
    np.testing.assert_array_equal(_np(c), np.asarray(jc))

    q = lq.unpack_codes(c, n_bits)
    jq = jlq.unpack_codes(jc, n_bits)
    np.testing.assert_array_equal(_np(q.exp), np.asarray(jq.exp))
    np.testing.assert_array_equal(_np(q.sign), np.asarray(jq.sign))
    np.testing.assert_array_equal(_np(lq.pack_codes(q, n_bits)),
                                  np.asarray(jlq.pack_codes(jq, n_bits)))

    deq = _np(lq.dequantize_page_codes(c, se, n_bits))
    jdeq = np.asarray(jlq.dequantize_page_codes(jc, jse, n_bits))
    e = _np(q.exp).astype(np.int64) + _np(se)
    exact = np.abs(e) <= 12
    np.testing.assert_array_equal(deq[exact], jdeq[exact])
    np.testing.assert_allclose(deq, jdeq, rtol=1e-5, atol=0)
    assert not np.signbit(deq[deq == 0]).any()


def test_dequantize_decodes_exact_powers_of_two():
    """Every exponent sum in [-126, 127] decodes to the exact power of two
    (and clamps outside it); the reference's XLA ``exp2`` gives 0 at -126
    on the CPU, the deviation that makes its hypothesis requant test flaky
    at FLT_MIN (ROADMAP queue 3)."""
    se = torch.arange(-140, 141, dtype=torch.int32)
    codes = torch.full(se.shape, 2, dtype=torch.int16)      # exp 1, sign +
    out = _np(lq.dequantize_page_codes(codes, se, 8))
    want = np.ldexp(np.float32(1), np.clip(_np(se) + 1, -126, 127))
    np.testing.assert_array_equal(out, want.astype(np.float32))
    jout = np.asarray(jlq.dequantize_page_codes(
        jnp.asarray(_np(codes)), jnp.asarray(_np(se)), 8))
    bottom = _np(se) + 1 <= -126
    assert bottom.sum() == 14 and (jout[bottom] == 0).all()
    assert (out[bottom] == FLT_MIN).all()


@pytest.mark.parametrize("n_bits", N_BITS_SWEEP)
def test_requant_fixed_point_seeded(n_bits):
    """quantize -> dequantize -> requantize under the same scale gives the
    same codes, on the seeded rows and on wider magnitudes."""
    rng = np.random.default_rng(5)
    wide = (rng.standard_normal((16, 64)) * np.exp2(
        rng.integers(-120, 120, (16, 1)))).astype(np.float32)
    for x in (_seeded_rows(), wide):
        x = torch.from_numpy(x)
        se = lq.scale_exponent(x, dim=-1, keepdim=True)
        c1 = lq.quantize_page_codes(x, se, n_bits)
        c2 = lq.quantize_page_codes(lq.dequantize_page_codes(c1, se, n_bits),
                                    se, n_bits)
        assert torch.equal(c1, c2)


@pytest.mark.parametrize("n_bits", N_BITS_SWEEP)
def test_requant_fixed_point_at_flt_min(n_bits):
    """At FLT_MIN the scale exponent is -126; the port decodes 2^-126
    exactly, so requantizing reproduces the code (the reference decodes 0
    there on the CPU and requantizes to the sentinel).  A subnormal beside
    FLT_MIN quantizes as zero, as on the reference's platforms."""
    x = torch.tensor([[FLT_MIN, FLT_MIN / 2], [-FLT_MIN, 0.0],
                      [FLT_MIN * 3, FLT_MIN]])
    se = lq.scale_exponent(x, dim=-1, keepdim=True)
    assert _np(se)[:2].tolist() == [[-126], [-126]]
    c1 = lq.quantize_page_codes(x, se, n_bits)
    back = lq.dequantize_page_codes(c1, se, n_bits)
    assert _np(back)[:2, 0].tolist() == [FLT_MIN, -FLT_MIN]
    assert _np(back)[0, 1] == 0.0
    assert torch.equal(lq.quantize_page_codes(back, se, n_bits), c1)
    jc = jlq.quantize_page_codes(jnp.asarray(_np(x)), jnp.asarray(_np(se)),
                                 n_bits)
    np.testing.assert_array_equal(_np(c1), np.asarray(jc))


def test_requant_fixed_point_property():
    """The reference's property (float32 rows in [-1e4, 1e4], subnormals
    included), derandomized and without an example database, so every run
    draws the same examples."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=200, deadline=None, derandomize=True,
                  database=None)
    @hyp.given(n_bits=st.sampled_from(N_BITS_SWEEP),
               xs=st.lists(st.floats(min_value=-1e4, max_value=1e4,
                                     width=32, allow_nan=False,
                                     allow_infinity=False),
                           min_size=1, max_size=64))
    def run(n_bits, xs):
        x = torch.tensor([xs], dtype=torch.float32)
        se = lq.scale_exponent(x, dim=-1, keepdim=True)
        c1 = lq.quantize_page_codes(x, se, n_bits)
        c2 = lq.quantize_page_codes(lq.dequantize_page_codes(c1, se, n_bits),
                                    se, n_bits)
        assert torch.equal(c1, c2)
    run()


# ---------------------------------------------------------------------------
# pool writes and the dequantizing gather
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_smoke("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_smoke("smollm-135m").replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_init_paged_pool_leaves_match_reference(smoke, n_bits):
    jcfg, _, cfg, _ = smoke
    jpool = jax_init_pool(jcfg.replace(kv_quant=True, kv_bits=n_bits), 3, 32,
                          9, 4)
    pool = init_paged_pool(cfg.replace(kv_quant=True, kv_bits=n_bits), 3, 32,
                           9, 4, device="cpu")
    (jl,), (tl,) = jpool["layers"], pool["layers"]
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert tuple(tl[k].shape) == jl[k].shape, k
        assert str(tl[k].dtype).split(".")[1] == str(jl[k].dtype), k
        assert not tl[k].any()


def _write_sequence(n_bits, page_len=4, nb=6, g=2, d=8, seed=0):
    """A prefill chunk, decode steps with one inactive row (its frozen
    length writes junk), then a retired row (all-trash table) writing
    junk: each step through both packages' write, then both gathers."""
    rng = np.random.default_rng(seed)
    b = 3
    n_pages = 1 + b * nb
    jpool = jax_init_pool(jax_get_smoke("smollm_135m").replace(
        dtype=jnp.float32, n_kv_heads=g, head_dim=d, kv_quant=True,
        kv_bits=n_bits), b, nb * page_len, n_pages, page_len)
    jl = {k: v[0] for k, v in jpool["layers"][0].items()}
    tl = pool_from_numpy(jax.tree.map(np.asarray, jl), device="cpu")
    table = np.zeros((b, nb), np.int32)
    table[0, :5] = [3, 9, 4, 1, 2]
    table[1, :4] = [5, 6, 7, 8]
    table[2, :3] = [10, 11, 12]
    length = np.asarray([0, 2, 5], np.int32)

    def new_rows(s):
        mag = rng.choice([0.25, 1.0, 4.0], (b, 1, g, 1))
        return (rng.standard_normal((b, s, g, d)) * mag).astype(np.float32)

    steps = [(new_rows(8), np.asarray([8, 5, 0], np.int32), None)]
    for _ in range(5):
        steps.append((new_rows(1), None, np.asarray([1, 1, 0], bool)))
    steps.append(("retire", None, None))
    for _ in range(3):
        steps.append((new_rows(1), None, np.asarray([1, 1, 1], bool)))

    for new, valid, active in steps:
        if isinstance(new, str):
            table[2] = 0
            continue
        s = new.shape[1]
        ar = np.arange(s, dtype=np.int32)
        pos = length[:, None] + ar[None]
        if valid is not None:
            keep, adv = ar[None] < valid[:, None], valid
        else:
            keep, adv = np.ones((b, s), bool), np.int32(1)
        for kind in ("k", "v"):
            codes, scale, tail = (jl[f"{kind}_{x}"]
                                  for x in ("codes", "scale", "tail"))
            codes, scale, tail = jax_attn._quant_paged_write(
                codes, scale, tail, jnp.asarray(table), jnp.asarray(new),
                jnp.asarray(pos), jnp.asarray(keep), jnp.asarray(length),
                jnp.asarray(adv), n_bits)
            jl.update({f"{kind}_codes": codes, f"{kind}_scale": scale,
                       f"{kind}_tail": tail})
            attention._quant_paged_write(
                tl[f"{kind}_codes"], tl[f"{kind}_scale"], tl[f"{kind}_tail"],
                torch.from_numpy(table), torch.from_numpy(new),
                torch.from_numpy(pos), torch.from_numpy(keep),
                torch.from_numpy(length), torch.as_tensor(adv), n_bits)
        new_len = length + adv
        if active is not None:
            new_len = np.where(active, new_len, length)
        yield jl, tl, table.copy(), length + adv, page_len
        length = new_len.astype(np.int32)


@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_quant_write_and_gather_bit_equal(n_bits):
    """After every write: codes and scales on every page but the trash
    page, and every tail ring row but the junk bin, bit-equal; the gathered
    views bit-equal on every valid position (where XLA's exp2 is exact)."""
    n = 0
    for jl, tl, table, lens, page_len in _write_sequence(n_bits):
        for kind in ("k", "v"):
            for leaf in ("codes", "scale"):
                np.testing.assert_array_equal(
                    _np(tl[f"{kind}_{leaf}"])[1:],
                    np.asarray(jl[f"{kind}_{leaf}"])[1:])
            np.testing.assert_array_equal(
                _np(tl[f"{kind}_tail"])[:, :2 * page_len],
                np.asarray(jl[f"{kind}_tail"])[:, :2 * page_len])
            jg = np.asarray(jax_attn._quant_paged_gather(
                jl[f"{kind}_codes"], jl[f"{kind}_scale"], jl[f"{kind}_tail"],
                jnp.asarray(table), jnp.asarray(lens), n_bits, jnp.float32))
            tg = _np(attention._quant_paged_gather(
                tl[f"{kind}_codes"], tl[f"{kind}_scale"], tl[f"{kind}_tail"],
                torch.from_numpy(table), torch.from_numpy(lens), n_bits,
                torch.float32))
            for i, ln in enumerate(lens):
                if table[i, 0]:
                    np.testing.assert_array_equal(tg[i, :ln], jg[i, :ln])
        n += 1
    assert n == 9


# ---------------------------------------------------------------------------
# K4: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _lengths_lattice(page_len, nb):
    mx = page_len * nb
    cand = [0, 1, page_len - 1, page_len, page_len + 1, 2 * page_len, mx]
    return [ln for ln in dict.fromkeys(cand) if 0 <= ln <= mx]


def _quant_case(rng, *, page_len, nb, g, r, d, lengths, n_bits=4,
                garbage=0):
    """The scheduler's layout: fresh pages per row plus the trash page,
    codes under each page's first-row scale, a tail ring whose active half
    holds the newest page's exact rows.  The trash page's codes and
    scales, the ring's other half and its junk bin are garbage, drawn from
    ``garbage``'s seed."""
    b = len(lengths)
    n_pages = 1 + b * nb
    k = rng.standard_normal((n_pages, page_len, g, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, page_len, g, d)).astype(np.float32)
    table = ops.make_page_table(lengths, nb, page_len)
    q = rng.standard_normal((b, 1, g * r, d)).astype(np.float32)

    def quantize(pool):
        x = torch.from_numpy(pool)
        se = lq.scale_exponent(x[:, 0], dim=-1)                  # (P, G)
        return (_np(lq.quantize_page_codes(x, se[:, None, :, None],
                                           n_bits)).copy(), _np(se).copy())

    kc, ks = quantize(k)
    vc, vs = quantize(v)
    grng = np.random.default_rng(1000 + garbage)
    lo, hi = (-(1 << 8), 1 << 8) if n_bits >= 8 else (-128, 128)
    for c, s in ((kc, ks), (vc, vs)):
        c[0] = grng.integers(lo, hi, c[0].shape)
        s[0] = grng.integers(-10 ** 9, 10 ** 9, s[0].shape)
    ring = 2 * page_len
    k_tail = (grng.standard_normal((b, ring + 1, g, d)) * 1e3).astype(
        np.float32)
    v_tail = (grng.standard_normal((b, ring + 1, g, d)) * 1e3).astype(
        np.float32)
    for i, ln in enumerate(lengths):
        tb = max(int(ln) - 1, 0) // page_len
        if table[i, tb]:
            half = (tb % 2) * page_len
            k_tail[i, half:half + page_len] = k[table[i, tb]]
            v_tail[i, half:half + page_len] = v[table[i, tb]]
    return dict(q=q, kc=kc, ks=ks, vc=vc, vs=vs, k_tail=k_tail,
                v_tail=v_tail, table=table,
                lens=np.asarray(lengths, np.int32))


def _torch_case(c, q_dtype=torch.float32):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()}
    out["q"] = out["q"].to(q_dtype)
    return out


def _jax_case(c, n_bits, q_dtype=jnp.float32):
    ct = jlq.code_dtype(n_bits)
    out = {k: jnp.asarray(v) for k, v in c.items()}
    out["q"] = out["q"].astype(q_dtype)
    out["kc"], out["vc"] = out["kc"].astype(ct), out["vc"].astype(ct)
    return out


def _check_partials(c, n_bits, splits, q_dtype=torch.float32):
    """The plain K4's partials and merged output against the Pallas K4's
    (interpret mode) on the same inputs, lengths as given."""
    t, j = _torch_case(c, q_dtype), _jax_case(
        c, n_bits, jnp.bfloat16 if q_dtype == torch.bfloat16 else jnp.float32)
    b, _, h, d = t["q"].shape
    g = t["kc"].shape[2]
    pad = (-t["table"].shape[1]) % splits
    table = torch.nn.functional.pad(t["table"], (0, pad))
    o, m, l = ops.paged_attention_quant(
        t["q"].reshape(b, g, h // g, d), t["kc"], t["ks"], t["vc"], t["vs"],
        table, t["lens"], n_bits, splits)
    jo, jm, jlv = jax_kernel.paged_attention_quant_kernel(
        j["q"].reshape(b, g, h // g, d), j["kc"], j["ks"], j["vc"], j["vs"],
        jnp.asarray(_np(table)), j["lens"], n_bits=n_bits, splits=splits,
        interpret=True)
    jm = np.asarray(jm)
    real = jm > ops.NEG_INF / 2
    np.testing.assert_array_equal(_np(m) > ops.NEG_INF / 2, real)
    np.testing.assert_array_equal(_np(l)[~real], 0.0)
    np.testing.assert_allclose(_np(m)[real], jm[real], **F32_TOL)
    np.testing.assert_allclose(_np(l)[real], np.asarray(jlv)[real],
                               **F32_TOL)
    np.testing.assert_allclose(_np(o)[real], np.asarray(jo)[real], **F32_TOL)
    out = ops.merge_split_softmax(m, l, o, axis=2)
    live = c["lens"] > 0
    ref = paged_attention_quant_reference(
        t["q"].float(), t["kc"], t["ks"], t["vc"], t["vs"], t["table"],
        t["lens"], n_bits).reshape(b, g, h // g, d)
    np.testing.assert_allclose(_np(out)[live], _np(ref)[live], **F32_TOL)
    assert np.isfinite(_np(o)).all() and np.isfinite(_np(out)).all()


@pytest.mark.parametrize("page_len,nb", [(1, 4), (4, 4), (8, 3)])
@pytest.mark.parametrize("g,r", [(1, 1), (2, 2), (1, 3)])
def test_k4_plain_matches_pallas_lattice(page_len, nb, g, r):
    rng = np.random.default_rng(page_len * 100 + g * 10 + r)
    c = _quant_case(rng, page_len=page_len, nb=nb, g=g, r=r, d=8,
                    lengths=_lengths_lattice(page_len, nb))
    for splits in (1, 2, 3):
        _check_partials(c, 4, splits)


@pytest.mark.parametrize("n_bits", N_BITS_SWEEP)
def test_k4_plain_matches_pallas_n_bits(n_bits):
    rng = np.random.default_rng(300 + n_bits)
    c = _quant_case(rng, page_len=4, nb=4, g=2, r=2, d=8,
                    lengths=[0, 1, 3, 4, 5, 9, 16], n_bits=n_bits)
    for splits in (2, 4):
        _check_partials(c, n_bits, splits)


def test_k4_plain_matches_pallas_smollm_geometry_bf16_q():
    """smollm-135m's G = R = 3, D = 64 at page_len 16, q in bf16 (widened
    to f32 by both kernels)."""
    rng = np.random.default_rng(11)
    c = _quant_case(rng, page_len=16, nb=3, g=3, r=3, d=64,
                    lengths=[0, 1, 15, 16, 17, 48])
    _check_partials(c, 4, 2, torch.bfloat16)


def _decode(c, n_bits, splits):
    t = _torch_case(c)
    return ops.paged_decode_attention_quant(
        t["q"], t["kc"], t["ks"], t["vc"], t["vs"], t["k_tail"],
        t["v_tail"], t["table"], t["lens"], n_bits=n_bits, splits=splits)


@pytest.mark.parametrize("n_bits", [2, 4, 8])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_decode_attention_quant_matches_reference(n_bits, splits):
    """``paged_decode_attention_quant`` (floored lengths through K4's plain
    version, the tail page from the ring) against the reference's wrapper
    (Pallas interpret), and against the dense oracle over the dequantized
    pool with the tail pages' exact rows."""
    rng = np.random.default_rng(40 + n_bits)
    c = _quant_case(rng, page_len=4, nb=4, g=2, r=2, d=8,
                    lengths=[0, 1, 3, 4, 5, 8, 9, 16], n_bits=n_bits)
    out = _np(_decode(c, n_bits, splits))
    j = _jax_case(c, n_bits)
    jout = np.asarray(jax_ops.paged_decode_attention_quant(
        j["q"], j["kc"], j["ks"], j["vc"], j["vs"], j["k_tail"], j["v_tail"],
        j["table"], j["lens"], n_bits=n_bits, splits=splits, interpret=True))
    live = c["lens"] > 0
    np.testing.assert_allclose(out[live], jout[live], **F32_TOL)
    assert np.isfinite(out).all()

    t = _torch_case(c)
    sc = lambda s: s[:, None, :, None]               # noqa: E731
    k = lq.dequantize_page_codes(t["kc"], sc(t["ks"]), n_bits)
    v = lq.dequantize_page_codes(t["vc"], sc(t["vs"]), n_bits)
    for i, ln in enumerate(c["lens"]):
        tb = max(int(ln) - 1, 0) // 4
        pg, half = c["table"][i, tb], (tb % 2) * 4
        if pg:
            k[pg] = t["k_tail"][i, half:half + 4]
            v[pg] = t["v_tail"][i, half:half + 4]
    ref = _np(paged_attention_reference(t["q"], k, v, t["table"], t["lens"]))
    np.testing.assert_allclose(out[live], ref[live], **F32_TOL)


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_garbage_bitwise_invisible(splits):
    """Trash-page codes and scales, the ring's dead half and its junk bin
    vary; live rows are bitwise the same, and nothing is NaN."""
    lengths = [0, 1, 3, 4, 5, 9, 16]
    live = np.asarray(lengths) > 0
    outs = [_np(_decode(_quant_case(np.random.default_rng(31), page_len=4,
                                    nb=4, g=2, r=2, d=8, lengths=lengths,
                                    garbage=gb), 4, splits))
            for gb in (0, 1, 2)]
    for out in outs:
        assert not np.isnan(out).any()
        np.testing.assert_array_equal(out[live], outs[0][live])


def test_wrapper_validates_inputs():
    c = _torch_case(_quant_case(np.random.default_rng(0), page_len=4, nb=2,
                                g=1, r=1, d=8, lengths=[3]))
    qg = c["q"].reshape(1, 1, 1, 8)
    args = (qg, c["kc"], c["ks"], c["vc"], c["vs"], c["table"], c["lens"])
    with pytest.raises(TypeError, match="codes must be"):
        ops.paged_attention_quant(*args, n_bits=8)
    with pytest.raises(ValueError, match="n_bits"):
        ops.paged_attention_quant(*args, n_bits=9)
    with pytest.raises(ValueError, match="multiple of splits"):
        ops.paged_attention_quant(*args, n_bits=4, splits=3)
    with pytest.raises(TypeError, match="int32"):
        ops.paged_attention_quant(*args[:2], args[2].long(), *args[3:],
                                  n_bits=4)
    before = ops.paged_attention_quant.launches
    ops.paged_attention_quant(*args, n_bits=4)
    assert ops.paged_attention_quant.launches == before   # plain on the CPU


# ---------------------------------------------------------------------------
# the scheduler with kv_quant against the reference's
# ---------------------------------------------------------------------------

# the reference's kv_quant smoke setup (tests/test_kv_quant.py)
BASE = dict(max_slots=2, max_len=64, buckets=(8, 16), tick_steps=4,
            paged=True, page_len=8, prefix_cache=True, kv_quant=True)


def _prompts(kind):
    rng = np.random.default_rng({"smoke": 0, "repeat": 1, "cow": 4}[kind])
    if kind == "smoke":
        return [rng.integers(0, 256, size=n).astype(np.int32)
                for n in (5, 8, 3, 12, 7, 9)]
    if kind == "repeat":
        base = rng.integers(0, 256, size=12).astype(np.int32)
        return [base, np.concatenate([base, [5, 7]]).astype(np.int32),
                base.copy(), np.concatenate([base, [9]]).astype(np.int32)]
    prefix = rng.integers(0, 256, size=28).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 256, size=t)]).astype(
        np.int32) for t in (6, 5, 4)]


KERNEL = dict(attn_kernel="pallas", attn_splits=2)
MODES = {
    "gather": (dict(), "smoke", 7, False),
    "k4_s1": (dict(attn_kernel="pallas", attn_splits=1), "smoke", 7, False),
    "k4_s2": (dict(KERNEL), "smoke", 7, False),
    "bits2": (dict(kv_bits=2, page_len=4), "smoke", 4, False),
    "bits8": (dict(kv_bits=8, page_len=4, **KERNEL), "smoke", 4, False),
    "page_len1": (dict(page_len=1), "smoke", 5, False),
    "page_len4": (dict(page_len=4, **KERNEL), "smoke", 5, False),
    "repeat_hit": (dict(page_len=4, **KERNEL), "repeat", 6, False),
    "cow_hit": (dict(max_slots=1, buckets=(8, 16, 32), chunked="auto",
                     **KERNEL), "cow", 7, False),
    "chunked": (dict(chunked="always", chunk_len=8, **KERNEL), "smoke", 6,
                False),
    "quant_stats": (dict(page_len=4, quant="xla", with_stats=True,
                         chunked="auto", **KERNEL), "smoke", 5, True),
}


def _snapshot(sched):
    return {"length": _np(sched._pool["length"]).tolist(),
            "active": sched._active.tolist(),
            "table": sched._table.tolist(),
            "refcount": sched._pages.refcount.tolist(),
            "free": list(sched._pages._free),
            "stats": sched.prefix_cache_stats()}


def _drive(sched, prompts, max_new):
    for p in prompts:
        sched.submit(p, max_new=max_new)
    log = []
    while sched.pending:
        log.append((sched.step_tick(), _snapshot(sched)))
    return log, sched.run()


@pytest.fixture(scope="module")
def quantized(smoke):
    jcfg, jparams, cfg, params = smoke
    return jax_quantize(jcfg, jparams), quantize_model_params(cfg, params)


@pytest.mark.parametrize("mode", list(MODES))
def test_scheduler_matches_reference(smoke, quantized, mode):
    kw, kind, max_new, quant = MODES[mode]
    kw = dict(BASE, **kw)
    jcfg, jparams, cfg, params = smoke
    if quant:
        jparams, params = quantized
    prompts = _prompts(kind)
    jsched = JaxScheduler(jcfg, jparams, JaxServeConfig(**kw))
    sched = ServeScheduler(cfg, params, ServeConfig(**kw), device="cpu")
    jlog, jres = _drive(jsched, prompts, max_new)
    log, res = _drive(sched, prompts, max_new)
    assert len(log) == len(jlog)
    for t, (a, b) in enumerate(zip(jlog, log)):
        assert a == b, f"tick {t}"
    assert [(r.rid, r.tokens, r.finish_reason, r.admitted_tick,
             r.finished_tick) for r in res] == [
        (r.rid, r.tokens, r.finish_reason, r.admitted_tick, r.finished_tick)
        for r in jres]
    assert all(len(r.tokens) == max_new for r in res)
    for a, b in zip(jres, res):
        for key in ("plane_traffic_fraction", "element_traffic_fraction"):
            x, y = getattr(a, key), getattr(b, key)
            assert (np.isnan(x) and np.isnan(y)) or abs(x - y) <= 1e-6, key
    (jl,), (tl,) = jsched._pool["layers"], sched._pool["layers"]
    for k in ("k_codes", "v_codes", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_np(tl[k])[:, 1:],
                                      np.asarray(jl[k])[:, 1:])
    stats = sched.prefix_cache_stats()
    if kind == "repeat":
        assert res[0].tokens == res[2].tokens and stats["lookup_hits"] >= 2
    if kind == "cow":
        assert stats["cached_tokens"] == 2 * 28      # 24 whole-page + 4 COW


@pytest.mark.parametrize("kw,match", [
    (dict(paged=True, page_len=8, kv_quant=True, kv_bits=1), "kv_bits"),
    (dict(paged=True, page_len=8, kv_quant=True, kv_bits=9), "kv_bits"),
    (dict(kv_quant=True), "requires paged"),
])
def test_constructor_validation(smoke, kw, match):
    _, _, cfg, params = smoke
    with pytest.raises(ValueError, match=match):
        ServeScheduler(cfg, params, ServeConfig(max_slots=2, max_len=64,
                                                buckets=(8,), **kw),
                       device="cpu")


FLAGS = ["--continuous", "--paged", "--kv-quant", "4", "--attn-kernel"]


def test_kv_quant_cli_serves_and_dumps_reference_config(capsys):
    """``launch.serve --continuous --paged --kv-quant 4 --attn-kernel`` on
    the host serves every request, and ``--dump-config`` prints the
    reference's JSON for the same flags."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    dump = ["--arch", "smollm-135m", "--dump-config"] + FLAGS
    jax_serve.main(dump)
    theirs = capsys.readouterr().out
    serve.main(dump)
    assert capsys.readouterr().out == theirs
    assert '"kv_quant": true' in theirs and '"kv_bits": 4' in theirs
    results = serve.main(["--arch", "smollm-135m", "--smoke", "--device",
                          "cpu", "--requests", "4", "--max-slots", "2",
                          "--new-tokens", "4", "--prompt-len", "8",
                          "--page-len", "4"] + FLAGS)
    out = capsys.readouterr().out
    assert "+kvq/4b" in out and len(results) == 4
    assert all(r.finish_reason == "length" and len(r.tokens) == 4
               for r in results)
