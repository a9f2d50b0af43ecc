"""Accelerator configurations — paper Table II.

Port of ``src/repro/simulator/config.py`` (pure Python; the kernel cost
table is the same framework-neutral JSON file).

Three modeled systems:

* ``NEUROCUBE`` — OS dataflow, uniform 8b acts / 8b weights, 16 MACs/PE,
  no activation pruning (paper: "the efficiency of the activation pruning is
  limited in Neurocube due to its OS dataflow, so it is not implemented").
* ``NAHID``     — IS dataflow, LOG2 4b acts / 8b weights, 16 ADDs/PE,
  zero+small-activation pruning, **standard** weight layout (all 8 bits
  fetched for every live activation).
* ``QEIHAN``    — NaHiD plus the bit-plane weight layout: only the
  ``8-|e|`` MSB planes fetched for negative exponents.

Energy constants are 32 nm-class numbers with sources noted inline; the
paper's own evaluation is relative (normalized to Neurocube), so the model's
job is to get the *ratios* right, which are dominated by DRAM traffic.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class EnergyModel:
    """Per-event energies in picojoules."""

    dram_pj_per_bit: float = 3.7        # HMC internal access [Jeddeloh&Keeth'12]
    sram_pj_per_bit: float = 0.08       # ~2KB low-power SRAM @0.78V (CACTI-P class)
    noc_pj_per_bit: float = 0.35        # 2D-mesh hop, logic die
    mac16_pj: float = 1.3               # 16-bit MAC, 32nm (DesignWare class)
    add16_pj: float = 0.12              # 16-bit adder
    shift_pj: float = 0.03              # D&S barrel shift (append zeros)
    log2_quant_pj: float = 0.06         # comparator + int adder + mux (Fig. 5)
    static_mw_per_pe: float = 1.9       # leakage, logic die per tile
    dram_static_mw: float = 320.0       # HMC background/refresh


@dataclass(frozen=True)
class AcceleratorConfig:
    name: str
    dataflow: str                        # 'OS' | 'IS'
    vaults: int = 16                     # = PEs (Table II)
    units_per_pe: int = 16               # MACs (Neurocube) or ADDs (IS designs)
    freq_hz: float = 300e6               # logic die
    vault_bw_bytes: float = 10e9         # per-vault 3D memory bandwidth
    act_bits_dram: int = 8               # activation precision read from DRAM
    weight_bits: int = 8
    log2_activations: bool = False       # LOG2 4-bit exponent + sign datapath
    bitplane_weights: bool = False       # QeiHaN weight layout
    prune_activations: bool = False      # zero + clipped-small pruning
    out_bits_dram: int = 16              # partial/final output precision
    sram_bytes_per_pe: int = 2560
    energy: EnergyModel = field(default_factory=EnergyModel)
    # OS only: output neurons computed concurrently across the accelerator.
    # 16 PEs x 16 MACs; inputs are re-streamed once per output pass.
    os_concurrent_outputs: int = 256
    # Closed-page DRAM (paper §IV-B): each transaction moves `bus_bits` and
    # occupies a bank for tRC; bank-level parallelism overlaps transactions.
    # Effective per-vault bandwidth = bus_bits * banks / tRC (~1.4 GB/s),
    # far below the 10 GB/s TSV peak — this is why the paper's designs are
    # access-count-bound and speedup tracks Fig. 9.
    bus_bits: int = 32
    t_rc_s: float = 47e-9
    banks_per_vault: int = 16            # 4 banks/die x 4 dies (Table II)
    # QeiHaN/NaHiD overlap all dataflow stages in a deep pipeline (§IV-C);
    # the Neurocube baseline serializes compute and memory per §VI-B.
    pipelined: bool = True

    @property
    def total_bw_bytes(self) -> float:
        return self.vault_bw_bytes * self.vaults

    @property
    def total_units(self) -> int:
        return self.units_per_pe * self.vaults


NEUROCUBE = AcceleratorConfig(
    name="neurocube", dataflow="OS",
    act_bits_dram=8, log2_activations=False, bitplane_weights=False,
    prune_activations=False, pipelined=False,
)

NAHID = AcceleratorConfig(
    name="nahid", dataflow="IS",
    act_bits_dram=16,                    # paper: IB holds FP16 activations
    log2_activations=True, bitplane_weights=False, prune_activations=True,
    sram_bytes_per_pe=2112,              # 2KB OB + 64B IB + 64B WB
)

QEIHAN = AcceleratorConfig(
    name="qeihan", dataflow="IS",
    act_bits_dram=16,
    log2_activations=True, bitplane_weights=True, prune_activations=True,
    sram_bytes_per_pe=2112,
)

ALL_ACCELERATORS = (NEUROCUBE, NAHID, QEIHAN)


# ---------------------------------------------------------------------------
# serving-side cost table (static kernel audit -> simulator input)
# ---------------------------------------------------------------------------

KERNEL_COST_TABLE_PATH = "benchmarks/baselines/kernel_audit.json"


def load_kernel_cost_table(path: str = KERNEL_COST_TABLE_PATH):
    """Per-tick kernel cost table from the static kernel audit
    (``tools/audit.py --kernels``): ``{variant: {"tick_bytes_total",
    "kernels": {family: {"calls", "operand_bytes"}}}}``.

    The counts are compile-time facts (pallas_call census over the traced
    tick, scan trip counts multiplied through) and the bytes are the dense
    streaming upper bound per launch — what the energy model charges DRAM
    for before the paper's savings fractions (plane skip, page walk) are
    applied.  Raises ``FileNotFoundError`` if the audit baseline has not
    been generated (``tools/audit.py --kernels --update-baselines``).
    """
    import json

    with open(path) as f:
        doc = json.load(f)
    out = {}
    for name, rec in doc.get("per_tick", {}).items():
        out[name] = {
            "tick_bytes_total": int(rec["tick_bytes_total"]),
            "kernels": {k: {"calls": int(v["calls"]),
                            "operand_bytes": int(v["operand_bytes"])}
                        for k, v in rec["kernels"].items()},
        }
    return out
