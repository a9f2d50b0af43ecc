"""NDP accelerator simulator: Neurocube / NaHiD / QeiHaN (paper §V-§VI).

Port of ``src/repro/simulator``: the workloads, the accelerator configs and
the cycle/energy/access model are host-side float64 Python, equal to the
reference's with ``==``; :func:`measure` reads exponent statistics from the
port's LOG2 codes on whatever device they live.
"""

from repro_torch.simulator.config import (ALL_ACCELERATORS, NAHID,
                                          NEUROCUBE, QEIHAN,
                                          AcceleratorConfig, EnergyModel,
                                          load_kernel_cost_table)
from repro_torch.simulator.engine import (LayerResult, SimResult, simulate,
                                          simulate_layer)
from repro_torch.simulator.stats import (ActStats, gaussian_stats, measure,
                                         paper_preset)
from repro_torch.simulator.workload import (PAPER_WORKLOADS, LayerWork,
                                            alexnet, bert_base, bert_large,
                                            conv, fc, ptblm, transformer_base)

__all__ = [n for n in dir() if not n.startswith("_")]
