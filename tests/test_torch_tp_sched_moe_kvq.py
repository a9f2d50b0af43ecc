"""The continuous-batching scheduler on the model axis held against the
JAX package's single-device scheduler for the deepseek-moe smoke config
through the log2-quantized pool with the plain K4 and quantized
projections with stats, as M = 2 and M = 4 ranks of a local group.  The
trace and the bars are ``test_torch_tp_sched.py``'s.
"""

import pytest

from test_torch_tp_sched import check_scheduler_on_ranks, reference

__all__ = ["reference"]


@pytest.mark.parametrize("m", [2, 4])
def test_scheduler_on_ranks_matches_reference(reference, m):
    check_scheduler_on_ranks(reference, "deepseek-moe-16b", "k4", m)
