"""``next_token_loss`` and its gradients against the reference's on the
MoE and SSM smoke configs (phi3.5-moe, deepseek-moe, jamba, mamba2), as
``test_torch_train_grads.py`` holds the others: its helpers and
tolerances.  The MoE gates' gradient reaches the f32 router; the SSD
scan's ``-inf`` mask stays out of the gradients (every leaf finite)."""

import pytest

from test_torch_train_grads import check_config

ARCHS = ["phi35_moe_42b", "deepseek_moe_16b", "jamba_v01_52b",
         "mamba2_780m"]


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name):
    check_config(name)
