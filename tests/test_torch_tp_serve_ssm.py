"""One-shot serving on the model axis held against the single device for
the mamba2 smoke config (the 4 SSD heads sharded, the gated
norm's sum of squares summed over the ranks), as M = 2 and M = 4 ranks of a local group, float and
quantized with packed planes and stats.  The bars are
``test_torch_tp_serve.py``'s.
"""

import pytest

from test_torch_tp_serve import check_one_shot, setups

__all__ = ["setups"]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "quant"])
def test_one_shot_tokens_equal_reference(setups, quant, m):
    check_one_shot(setups, "mamba2-780m", quant, m)
