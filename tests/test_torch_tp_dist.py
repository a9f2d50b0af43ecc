"""The model axis over ``torch.distributed``: two spawned processes on the
CPU, each a rank of one gloo group (``models.sharding.DistGroup``), serve
the smollm smoke config quantized with packed planes one-shot, and give
the tokens, stats and logits of the same two ranks as threads of one
process (``LocalGroup``) bit for bit: both groups sum in rank order, and
every sum across ranks on this path is exact.  Each process gets a
``timeout`` on ``init_process_group`` and the parent joins them with a
limit, so a hung rank fails the test.  NCCL, one process per card, runs
the same code on a machine with two or more cards (``chip_smoke.py``).
"""

import datetime
import multiprocessing as mp
import socket

import torch

from repro_torch.configs import get_smoke
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh, make_serve_mesh
from repro_torch.models import sharding as sh
from repro_torch.models.model import forward, init_params
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import engine

JOIN_SECONDS = 120


def _model():
    cfg = get_smoke("smollm-135m").replace(dtype=torch.float32)
    params = quantize_model_params(
        cfg, init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu"), pack=True)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    return cfg, params, prompt


def _serve_rank(cfg, params, prompt, mesh, r):
    specs = shardings.params_shardings(mesh, params, fsdp=False,
                                       kv_heads=cfg.n_kv_heads)
    local = shardings.shard_params(params, specs, mesh, r)
    toks, stats = engine.greedy_generate(cfg, local, prompt, 6, quant=True,
                                         with_stats=True, device="cpu",
                                         mesh=mesh)
    logits, _ = forward(cfg, local, tokens=prompt, quant=True)
    return toks, stats["element_traffic_fraction"], logits


def _child(rank, port, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg, params, prompt = _model()
        mesh = make_serve_mesh("1x2")
        assert mesh.kind == "dist" and mesh.group.rank == rank
        (res,) = mesh.run(lambda r: _serve_rank(cfg, params, prompt, mesh,
                                                r))
        # numpy copies travel by value: a tensor would travel as a handle
        # to this process's shared memory, gone once it exits
        out.put((rank, [t.numpy() for t in res]))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gloo_ranks_equal_local_group():
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(r, port, out), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(out.get(timeout=JOIN_SECONDS) for _ in procs)
        for p in procs:
            p.join(timeout=JOIN_SECONDS)
            assert p.exitcode == 0, p.exitcode
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    cfg, params, prompt = _model()
    mesh = Mesh((1, 2), sh.LocalGroup(2, timeout=60))
    local = mesh.run(lambda r: _serve_rank(cfg, params, prompt, mesh, r))
    for r in range(2):
        for a, b in zip(got[r], local[r]):
            assert a.dtype == b.numpy().dtype and a.tobytes() \
                == b.numpy().tobytes(), r
    single = engine.greedy_generate(cfg, params, prompt, 6, quant=True,
                                    device="cpu")
    assert got[0][0].tolist() == single.tolist()
