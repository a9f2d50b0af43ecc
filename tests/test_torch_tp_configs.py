"""The six configs the serving tests leave out, forward on the model axis
against the single device, on the CPU at f32: ``qkv_bias`` (qwen2.5),
the audio stub's frame embeddings (musicgen), the vision stub's
column-parallel ``img_proj`` (internvl2), expert parallelism over 4
experts (phi3.5-moe) and jamba's mamba + MoE + attention period, as
M = 2 and M = 4 ranks of a local group; the ranks' logits within
``rtol = atol = 1e-5`` of the single device's, every rank's the same.
"""

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as sh
from repro_torch.models.model import forward, init_params


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "phi4-mini-3.8b",
                                  "musicgen-medium", "phi3.5-moe-42b",
                                  "jamba-v0.1-52b", "internvl2-26b"])
def test_forward_on_ranks_every_other_config(arch, m):
    cfg = get_smoke(arch).replace(dtype=torch.float32)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    g = torch.Generator().manual_seed(1)
    if cfg.frontend == "audio_stub":
        kw = {"embeds": torch.randn((2, 8, cfg.d_model), generator=g)}
    else:
        kw = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8), generator=g,
                                      dtype=torch.int32)}
    if cfg.frontend == "vision_stub":
        kw["image_embeds"] = torch.randn((2, cfg.n_image_tokens,
                                          cfg.d_model), generator=g)
    want, _ = forward(cfg, params, **kw)
    mesh = Mesh((1, m), sh.LocalGroup(m, timeout=120))
    specs = shardings.params_shardings(mesh, params, fsdp=False,
                                       kv_heads=cfg.n_kv_heads)
    outs = mesh.run(lambda r: forward(
        cfg, shardings.shard_params(params, specs, mesh, r), **kw)[0])
    for out in outs:
        assert torch.equal(out, outs[0])
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
