"""The port's ``ServeConfig`` held against the JAX package's: a JSON
written by either package loads in the other to an equal config, over the
reference's shipping-config matrix; invalid configs fail with the same
message in both; defaults, canonical forms and derived sizes agree.  The
port's scheduler refuses the knobs of later slices (``mesh_spec``,
``kv_quant``) with ``NotImplementedError``."""

import dataclasses
import json

import pytest
import torch

from repro.serving.config import ServeConfig as JaxServeConfig
from repro_torch.configs import get_smoke
from repro_torch.models.model import init_params
from repro_torch.serving.config import SCHEMA_VERSION, ServeConfig
from repro_torch.serving.scheduler import ServeScheduler

MATRIX = [
    dict(),
    dict(max_slots=2, max_len=32, buckets=(8, 16), tick_steps=2),
    dict(max_slots=4, max_len=32, buckets=(8, 16), quant="pallas",
         with_stats=True),
    dict(max_slots=4, max_len=32, buckets=(8, 16), chunked="always",
         chunk_len=8),
    dict(max_slots=4, max_len=32, buckets=(8, 16), chunked=True,
         chunk_len=8, oversize="truncate"),
    dict(max_slots=4, max_len=32, buckets=(16, 8, 8), paged=True,
         page_len=4, n_pages=34, prefix_cache=True, chunked="auto",
         chunk_len=8),
    dict(max_slots=4, max_len=32, buckets=(8, 16), paged=True, page_len=4,
         attn_kernel=True, attn_splits=2),
    dict(max_slots=2, max_len=64, buckets=(8, 16), paged=True, page_len=8,
         kv_quant=True, kv_bits=4, chunked="auto"),
    dict(max_slots=4, max_len=32, buckets=(8, 16), mesh_spec="2x2",
         generate_cache_size=8, snapshot_limit=4),
    dict(max_slots=4, max_len=48, buckets=(8, 16), paged=True, page_len=8,
         prefix_cache=True, min_prefix_hit=8, chunked="auto", chunk_len=8,
         oversize="raise"),
]


def _ids(kw):
    """Test ids that every pytest-xdist worker computes alike (an object's
    repr carries its address)."""
    def show(v):
        return v if isinstance(v, (bool, int, str, tuple, type(None))) \
            else type(v).__name__
    return "-".join(f"{k}={show(v)}" for k, v in sorted(kw.items())) \
        or "default"


@pytest.mark.parametrize("kw", MATRIX, ids=_ids)
def test_json_crosses_packages_both_ways(kw):
    ours, theirs = ServeConfig(**kw), JaxServeConfig(**kw)
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert ServeConfig.from_json(theirs.to_json()) == ours
    assert JaxServeConfig.from_json(ours.to_json()) == theirs
    assert ServeConfig.from_json(ours.to_json()) == ours


def test_schema_fields_and_defaults_equal():
    assert SCHEMA_VERSION == json.loads(JaxServeConfig().to_json())["schema"]
    ours = [(f.name, f.default) for f in dataclasses.fields(ServeConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(JaxServeConfig)]
    assert ours == theirs


@pytest.mark.parametrize("kw", MATRIX, ids=_ids)
def test_derived_sizes_equal(kw):
    ours, theirs = ServeConfig(**kw), JaxServeConfig(**kw)
    assert ours.needs_chunk_programs == theirs.needs_chunk_programs
    assert ours.resolved_n_pages() == theirs.resolved_n_pages()
    if ours.paged:
        assert ours.max_blocks == theirs.max_blocks


INVALID = [
    dict(max_slots=0), dict(tick_steps=0), dict(oversize="drop"),
    dict(buckets=()), dict(max_len=16, buckets=(8, 32)),
    dict(chunked="sometimes"),
    dict(max_len=30, buckets=(8,), chunked="auto", chunk_len=8),
    dict(max_len=32, buckets=(8,), chunked="auto", chunk_len=64),
    dict(max_len=30, buckets=(8,), paged=True, page_len=4),
    dict(paged=True, page_len=0), dict(paged=True, n_pages=1),
    dict(prefix_cache=True), dict(attn_kernel="pallas"),
    dict(attn_kernel="vulkan", paged=True), dict(paged=True, attn_splits=0),
    dict(kv_quant=True), dict(kv_quant=True, paged=True, kv_bits=1),
    dict(mesh_spec=object()), dict(quant=object()),
]


@pytest.mark.parametrize("kw", INVALID, ids=_ids)
def test_validation_messages_equal(kw):
    with pytest.raises(ValueError) as theirs:
        JaxServeConfig(**kw)
    with pytest.raises(ValueError) as ours:
        ServeConfig(**kw)
    if "mesh_spec" in kw or "quant" in kw:
        # the messages print the offending object's repr, whose address
        # differs between the two calls
        assert str(ours.value).split(":")[1:] == \
            str(theirs.value).split(":")[1:]
    else:
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("text", [
    "{nope", "[1, 2]", json.dumps({"schema": 99}),
    json.dumps({"max_slots": 4}),
    json.dumps(dict(json.loads(ServeConfig().to_json()), n_slots=4)),
])
def test_from_json_rejections_equal(text):
    with pytest.raises(ValueError) as theirs:
        JaxServeConfig.from_json(text)
    with pytest.raises(ValueError) as ours:
        ServeConfig.from_json(text)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(mesh_spec="2x2"), "mesh_spec", id="kw0-mesh_spec"),
    # served since the port's third slice: built, no longer refused
    pytest.param(dict(paged=True, max_len=64, buckets=(8,), page_len=8,
                      kv_quant=True), None, id="kw1-kv_quant"),
])
def test_scheduler_refuses_later_slices(kw, match):
    """The scheduler refuses what a later slice of the port brings (a
    mesh) and builds what an earlier one brought (the quantized pool)."""
    cfg = get_smoke("smollm-135m").replace(dtype=torch.float32)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    if match is None:
        sched = ServeScheduler(cfg, params, ServeConfig(**kw), device="cpu")
        assert "k_codes" in sched._pool["layers"][0]
        return
    with pytest.raises(NotImplementedError, match=match):
        ServeScheduler(cfg, params, ServeConfig(**kw), device="cpu")


@pytest.mark.parametrize("flags", [
    [],
    ["--chunked", "--chunk-len", "12", "--page-len", "16", "--paged"],
    ["--prefix-cache", "--attn-kernel", "--attn-splits", "2", "--quant",
     "--max-slots", "8", "--tick-steps", "4", "--prompt-len", "64"],
    ["--chunked", "always", "--new-tokens", "32"],
])
def test_cli_dump_config_equals_reference(flags, capsys):
    """The continuous CLI's flags map to the same ServeConfig JSON in both
    packages, and each package's dump loads in the other."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    argv = ["--arch", "smollm-135m", "--dump-config"] + flags
    jax_serve.main(argv)
    theirs = capsys.readouterr().out
    serve.main(argv)
    ours = capsys.readouterr().out
    assert json.loads(ours) == json.loads(theirs)
    assert ServeConfig.from_json(theirs) == ServeConfig.from_json(ours)
    assert JaxServeConfig.from_json(ours) == JaxServeConfig.from_json(theirs)
