"""The continuous-batching scheduler on the model axis held against the
JAX package's single-device scheduler for the deepseek-moe smoke config
(four kv heads: each rank's pool holds its heads; the 8 routed experts
run expert-parallel, the shared experts tensor-parallel), as M = 2 and
M = 4 ranks of a local group, through the paged pool with the plain K3
(the log2-quantized pool with the plain K4: ``test_torch_tp_sched_moe_kvq.py``).
The modes, the trace and the bars are ``test_torch_tp_sched.py``'s.
"""

import pytest

from test_torch_tp_sched import MODES, check_scheduler_on_ranks, reference

__all__ = ["reference"]


@pytest.mark.parametrize("m", [2, 4])
def test_scheduler_on_ranks_matches_reference(reference, m):
    check_scheduler_on_ranks(reference, "deepseek-moe-16b", "k3", m)
