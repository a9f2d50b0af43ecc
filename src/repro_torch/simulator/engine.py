"""Cycle/energy/access simulation of the three accelerators (paper §V-§VI).

Port of ``src/repro/simulator/engine.py``: host float64 arithmetic in the
reference's order, so every field equals the reference's with ``==``.

Modeling assumptions (documented deviations in DESIGN.md):

* **IS weight traffic** — the 64 B weight buffer holds only the M-weight
  vector for the current activation, so weights are re-fetched per token
  (per output row).  Per live activation the vault streams ``N`` weights of
  ``weight_bits`` (NaHiD) or ``mean_needed_bits`` (QeiHaN, Fig. 7 layout).
* **OS traffic** — outputs stationary; per token the accelerator makes
  ``ceil(N / 256)`` passes (16 PEs x 16 MACs concurrent outputs); every pass
  re-streams the K inputs; weights stream once per (token, weight).
* **Pipeline** — per layer, time = max(compute, memory) (paper: "all the
  main steps are carried out in parallel in a deep pipeline").
* **Pruning** — IS designs skip all weight fetches and ADDs of pruned
  activations; Neurocube computes everything (paper §VI-A).
* **Output/NoC** — partial-output reduction crosses the 2D mesh once per
  output (IS); final outputs written back at ``out_bits_dram``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

from repro_torch.simulator.config import AcceleratorConfig
from repro_torch.simulator.stats import ActStats
from repro_torch.simulator.workload import LayerWork


@dataclass
class LayerResult:
    name: str
    dram_bits_weights: float
    dram_bits_acts: float
    dram_bits_out: float
    compute_s: float
    memory_s: float
    time_s: float
    energy_j: float
    energy_breakdown: Dict[str, float]

    @property
    def dram_bits_total(self) -> float:
        return self.dram_bits_weights + self.dram_bits_acts + self.dram_bits_out


@dataclass
class SimResult:
    accel: str
    layers: List[LayerResult]

    def total(self, field: str) -> float:
        return sum(getattr(l, field) for l in self.layers)

    @property
    def dram_bits(self) -> float:
        return sum(l.dram_bits_total for l in self.layers)

    @property
    def time_s(self) -> float:
        return self.total("time_s")

    @property
    def energy_j(self) -> float:
        return self.total("energy_j")

    def energy_by(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for l in self.layers:
            for k, v in l.energy_breakdown.items():
                out[k] = out.get(k, 0.0) + v
        return out


def simulate_layer(cfg: AcceleratorConfig, layer: LayerWork,
                   stats: ActStats) -> LayerResult:
    e = cfg.energy
    live_frac = (1.0 - stats.zero_frac) if cfg.prune_activations else 1.0

    if cfg.dataflow == "IS":
        k_live = layer.k * live_frac
        if cfg.bitplane_weights:
            wbits_per_act = stats.mean_needed_bits(cfg.weight_bits)
        else:
            wbits_per_act = float(cfg.weight_bits)
        dram_w = layer.m * k_live * wbits_per_act * layer.n / 1.0
        # IS reads each *distinct* activation exactly once.
        dram_a = layer.unique_acts * cfg.act_bits_dram
        ops = layer.m * k_live * layer.n              # shifted ADDs
        shifts = ops
        quants = layer.m * k_live
    else:  # OS (Neurocube)
        passes = math.ceil(layer.n / cfg.os_concurrent_outputs)
        dram_w = layer.m * layer.k * layer.n * cfg.weight_bits
        dram_a = layer.m * passes * layer.k * cfg.act_bits_dram
        ops = layer.m * layer.k * layer.n             # MACs
        shifts = 0.0
        quants = 0.0

    dram_o = layer.m * layer.n * cfg.out_bits_dram

    total_bits = dram_w + dram_a + dram_o
    # Closed-page DRAM: time is transaction-bound (bus_bits per tRC per bank),
    # floored by the raw TSV bandwidth.
    transactions = total_bits / cfg.bus_bits
    latency_s = transactions * cfg.t_rc_s / (cfg.vaults * cfg.banks_per_vault)
    bw_s = (total_bits / 8.0) / cfg.total_bw_bytes
    memory_s = max(latency_s, bw_s)
    compute_s = ops / (cfg.total_units * cfg.freq_hz)
    time_s = max(memory_s, compute_s) if cfg.pipelined \
        else memory_s + compute_s

    # --- energy -----------------------------------------------------------
    br: Dict[str, float] = {}
    br["dram"] = total_bits * e.dram_pj_per_bit
    # every DRAM bit traverses an SRAM buffer (write+read) + accumulator I/O.
    br["sram"] = 2.0 * total_bits * e.sram_pj_per_bit + ops * 32 * e.sram_pj_per_bit
    if cfg.dataflow == "IS":
        br["pe"] = (ops * e.add16_pj + shifts * e.shift_pj
                    + quants * e.log2_quant_pj)
    else:
        br["pe"] = ops * e.mac16_pj
    # cross-vault partial-output reduction (IS) / local accumulate (OS).
    noc_bits = (cfg.vaults * layer.m * layer.n * 16.0
                if cfg.dataflow == "IS" else layer.m * layer.n * 16.0)
    br["noc"] = noc_bits * e.noc_pj_per_bit
    br["static"] = (cfg.vaults * e.static_mw_per_pe + e.dram_static_mw) \
        * 1e-3 * time_s * 1e12                       # mW * s -> pJ
    energy_pj = sum(br.values())

    return LayerResult(
        name=layer.name,
        dram_bits_weights=dram_w, dram_bits_acts=dram_a, dram_bits_out=dram_o,
        compute_s=compute_s, memory_s=memory_s, time_s=time_s,
        energy_j=energy_pj * 1e-12,
        energy_breakdown={k: v * 1e-12 for k, v in br.items()},
    )


def simulate(cfg: AcceleratorConfig, layers: Sequence[LayerWork],
             stats_per_layer: Sequence[ActStats] | ActStats) -> SimResult:
    if isinstance(stats_per_layer, ActStats):
        stats_per_layer = [stats_per_layer] * len(layers)
    results = [simulate_layer(cfg, l, s)
               for l, s in zip(layers, stats_per_layer, strict=True)]
    return SimResult(accel=cfg.name, layers=results)
