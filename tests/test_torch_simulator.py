"""The port's simulator (``repro_torch.simulator``) held against the JAX
package's (``repro.simulator``).

Every field of ``simulate``'s results equals the reference's with ``==``
over the five paper workloads x the three accelerators, with the paper
presets, with Gaussian statistics (one per layer) and with ``measure`` on
the same LOG2 codes; the workload builders, the accelerator configs and
the kernel cost table equal the reference's; and the invariants and paper
bands of ``tests/test_simulator.py`` hold for the port's results too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import simulator as jsim
from repro.core import logquant as jax_lq
from repro_torch import simulator as sim
from repro_torch.core import logquant

WORKLOADS = sorted(sim.PAPER_WORKLOADS)


def _layers_equal(mine, ref):
    assert [dataclasses.astuple(l) for l in mine] == \
        [dataclasses.astuple(l) for l in ref]
    assert [l.macs for l in mine] == [l.macs for l in ref]
    assert [l.weights for l in mine] == [l.weights for l in ref]


@pytest.mark.parametrize("name", WORKLOADS)
def test_builders_equal_reference_defaults(name):
    _layers_equal(sim.PAPER_WORKLOADS[name](), jsim.PAPER_WORKLOADS[name]())


@pytest.mark.parametrize("call", [
    ("ptblm", dict(seq=7, hidden=64, vocab=100)),
    ("transformer_base", dict(seq=16)),
    ("bert_base", dict(seq=128)),
    ("bert_large", dict(seq=32)),
    ("bert", dict(layers_n=2, d=64, ff=128, seq=8)),
    ("conv", dict(name="c", ih=31, iw=17, ic=5, oc=7, kh=3, kw=5, stride=2,
                  pad=1)),
    ("fc", dict(name="f", k=33, n=9, tokens=3))])
def test_builders_equal_reference_with_arguments(call):
    fn, kw = call
    mine = getattr(sim.workload, fn)(**kw)
    ref = getattr(jsim.workload, fn)(**kw)
    if fn in ("conv", "fc"):
        mine, ref = [mine], [ref]
    _layers_equal(mine, ref)


def test_accelerators_and_cost_table_equal_reference():
    assert len(sim.ALL_ACCELERATORS) == len(jsim.ALL_ACCELERATORS) == 3
    for a, b in zip(sim.ALL_ACCELERATORS, jsim.ALL_ACCELERATORS):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.total_bw_bytes == b.total_bw_bytes
        assert a.total_units == b.total_units
    assert dataclasses.asdict(sim.EnergyModel()) == \
        dataclasses.asdict(jsim.EnergyModel())
    assert sim.load_kernel_cost_table() == jsim.load_kernel_cost_table()
    assert sim.config.KERNEL_COST_TABLE_PATH == \
        jsim.config.KERNEL_COST_TABLE_PATH
    with pytest.raises(FileNotFoundError):
        sim.load_kernel_cost_table("no/such/kernel_audit.json")


def _stats_equal(mine, ref):
    np.testing.assert_array_equal(mine.hist, ref.hist)
    assert mine.hist.dtype == ref.hist.dtype == np.float64
    assert mine.zero_frac == ref.zero_frac
    assert mine.negative_fraction == ref.negative_fraction
    assert mine.mean_needed_bits() == ref.mean_needed_bits()
    assert mine.estimated_memory_savings(6) == \
        ref.estimated_memory_savings(6)


def _codes(name):
    """Per-workload LOG2 codes of seeded activations at several scales,
    quantized by both packages (bit-equal inputs to ``measure``)."""
    rng = np.random.default_rng(WORKLOADS.index(name))
    x = (rng.normal(0, 1, 20000) * 2.0 ** rng.integers(-6, 3, 20000)
         ).astype(np.float32)
    x[rng.random(20000) < 0.2] = 0.0
    q = logquant.log2_quantize(torch.from_numpy(x))
    qj = jax_lq.log2_quantize(jnp.asarray(x))
    return q, qj


def _sources(name, n_layers):
    """(port stats, reference stats) per source: the paper preset, one
    Gaussian per layer, and ``measure`` on the same codes."""
    yield "preset", sim.paper_preset(name), jsim.paper_preset(name)
    rng = np.random.default_rng(n_layers)
    args = [(float(c), float(s), float(z)) for c, s, z in zip(
        rng.uniform(-5, 3, n_layers), rng.uniform(0.8, 3, n_layers),
        rng.uniform(0, 0.6, n_layers))]
    yield ("gaussian", [sim.gaussian_stats(*a) for a in args],
           [jsim.gaussian_stats(*a) for a in args])
    q, qj = _codes(name)
    yield "measure", sim.measure(q), jsim.measure(qj)


def _results_equal(mine, ref):
    assert mine.accel == ref.accel
    assert len(mine.layers) == len(ref.layers)
    for a, b in zip(mine.layers, ref.layers):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.dram_bits_total == b.dram_bits_total
    assert mine.dram_bits == ref.dram_bits
    assert mine.time_s == ref.time_s
    assert mine.energy_j == ref.energy_j
    assert mine.energy_by() == ref.energy_by()


@pytest.mark.parametrize("name", WORKLOADS)
def test_simulate_equals_reference(name):
    layers = sim.PAPER_WORKLOADS[name]()
    ref_layers = jsim.PAPER_WORKLOADS[name]()
    for source, st, st_ref in _sources(name, len(layers)):
        for s, r in zip(st if isinstance(st, list) else [st],
                        st_ref if isinstance(st_ref, list) else [st_ref]):
            _stats_equal(s, r)
        for cfg, cfg_ref in zip(sim.ALL_ACCELERATORS,
                                jsim.ALL_ACCELERATORS):
            _results_equal(sim.simulate(cfg, layers, st),
                           jsim.simulate(cfg_ref, ref_layers, st_ref))


def test_measure_equals_reference_at_other_widths():
    rng = np.random.default_rng(9)
    x = (rng.normal(0, 1, (40, 50)) * 2.0 ** rng.integers(-9, 9, (40, 50))
         ).astype(np.float32)
    for n_bits in (3, 4):
        q = logquant.log2_quantize(torch.from_numpy(x), n_bits)
        qj = jax_lq.log2_quantize(jnp.asarray(x), n_bits)
        _stats_equal(sim.measure(q, n_bits), jsim.measure(qj, n_bits))
    empty = logquant.LogQuantized(torch.zeros(0, dtype=torch.int8),
                                  torch.ones(0, dtype=torch.int8))
    empty_j = jax_lq.LogQuantized(jnp.zeros(0, jnp.int8),
                                  jnp.ones(0, jnp.int8))
    _stats_equal(sim.measure(empty), jsim.measure(empty_j))


# ---------------------------------------------------------------------------
# tests/test_simulator.py's invariants and paper bands, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def results():
    return {name: {c.name: sim.simulate(c, builder(), sim.paper_preset(name))
                   for c in sim.ALL_ACCELERATORS}
            for name, builder in sim.PAPER_WORKLOADS.items()}


def _each(results, pred):
    return all(pred(r) for r in results.values())


def _mean(results, f):
    return float(np.mean([f(r) for r in results.values()]))


def _spd(r):
    return r["nahid"].time_s / r["qeihan"].time_s


INVARIANTS = {
    "qeihan_never_more_accesses_than_nahid": lambda res: _each(
        res, lambda r: r["qeihan"].dram_bits <= r["nahid"].dram_bits + 1e-6),
    "qeihan_faster_and_greener_than_nahid": lambda res: _each(
        res, lambda r: r["qeihan"].time_s <= r["nahid"].time_s * 1.001
        and r["qeihan"].energy_j <= r["nahid"].energy_j * 1.001),
    "speedup_positive_vs_neurocube": lambda res: _each(
        res, lambda r: r["neurocube"].time_s / r["qeihan"].time_s > 1.0),
    "energy_breakdown_sums": lambda res: _each(
        res, lambda r: all(abs(s.energy_j - sum(s.energy_by().values()))
                           / s.energy_j < 1e-9 for s in r.values())),
    "dram_dominates_energy": lambda res: _each(
        res, lambda r: r["qeihan"].energy_by()["dram"]
        == max(r["qeihan"].energy_by().values())),
    # paper §VI bands
    "access_ratio_vs_nahid": lambda res: 0.6 < _mean(
        res, lambda r: r["qeihan"].dram_bits / r["nahid"].dram_bits) < 0.85,
    "speedup_vs_nahid": lambda res: 1.2 < _mean(res, _spd) < 1.6,
    "ptblm_best_alexnet_worst_vs_nahid": lambda res: (
        max(res, key=lambda n: _spd(res[n])) == "ptblm"
        and min(res, key=lambda n: _spd(res[n])) == "alexnet"),
    "energy_vs_nahid": lambda res: 1.1 < _mean(
        res, lambda r: r["nahid"].energy_j / r["qeihan"].energy_j) < 1.6,
}


@pytest.mark.parametrize("invariant", sorted(INVARIANTS))
def test_simulator_invariants(results, invariant):
    assert INVARIANTS[invariant](results)


def _fig3_avg():
    savs = [sim.paper_preset(m).estimated_memory_savings()
            for m in sim.PAPER_WORKLOADS]
    return 0.15 < float(np.mean(savs)) < 0.40          # paper: 0.25


def _negativity():
    return all(abs(sim.paper_preset(name).negative_fraction - target) < 0.02
               for name, target in [("ptblm", 0.98), ("bert-base", 0.82),
                                    ("bert-large", 0.85),
                                    ("transformer", 0.57),
                                    ("alexnet", 0.36)])


STATS_CHECKS = {
    "fig3_avg_memory_savings": _fig3_avg,
    "gaussian_negative_fraction_monotone": lambda: all(
        a > b for a, b in zip(*[[sim.gaussian_stats(c, 2.0, 0.1)
                                 .negative_fraction for c in cs]
                                for cs in ((-4, -2, 0), (-2, 0, 2))])),
    "presets_match_paper_negativity": _negativity,
    "needed_bits_range": lambda: all(
        1.0 <= sim.paper_preset(m).mean_needed_bits() <= 8.0
        for m in sim.PAPER_WORKLOADS),
}


@pytest.mark.parametrize("check", sorted(STATS_CHECKS))
def test_stats_checks(check):
    assert STATS_CHECKS[check]()
