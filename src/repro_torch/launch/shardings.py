"""Parameter, cache and split-KV partition rules, and the cut of each
rank's shard (port of ``src/repro/launch/shardings.py``).

A spec is a tuple with one entry per dim: an axis name, a tuple of axis
names, or None (replicated), the reference's ``PartitionSpec`` entries.
The TP rule per leaf goes by its path (``tree.flatten_with_path``, the
reference's ``keystr``), an FSDP rule can shard the largest remaining dim
on the data axes, and every rule checks divisibility against the mesh:
a dim that does not divide stays replicated.

**The one intended difference from the reference.**  The reference shards
``wq/wk/wv/bq/bk/bv`` (and ``wo``'s input dim, and their bit-planes) on the
flat ``H*hd`` dim whenever it divides the model axis, which can split a
head: smollm-135m's 576 = 9 x 64 at M = 2, or the qwen3 smoke config's two
kv heads at M = 4.  The port shards attention only at head granularity,
when ``n_kv_heads % M == 0``, so that each rank holds whole kv heads and
their whole groups of q heads (``models.attention._grouped`` lays q heads
as (G, R)); otherwise attention is replicated.  :func:`param_spec` applies
it when given ``kv_heads``; ``tests/test_torch_shardings.py`` lists the
leaves where it differs from the reference.

The executing KV pool also differs from :func:`cache_shardings`, which
keeps the reference's placement (dense KV sequence-sharded on the model
axis, paged pools pages-on-data): the port's pool holds each rank's local
kv heads ``(R, P, page_len, G/M, D)``, and its SSM/conv state the rank's
local SSD heads (``models.model.init_paged_pool``).
"""

from __future__ import annotations

import re
from typing import Any, Optional

import torch

from repro_torch import tree as tree_util

# leaf-name -> index of the dim to shard on the model axis (negative = from
# the right; None = replicate).  Stacked layer leaves carry a leading repeat
# dim, hence counting from the right.
_TP_RULES = [
    # QeiHaN bit-plane weights (R, 8, K[, /8], N): same relative dims as
    # their float counterparts (packing only shrinks K)
    (r"\['(wq_q|wk_q|wv_q|gate_q|up_q|in_proj_q)'\]\.planes$", -1),
    (r"\['(wo_q|down_q|out_proj_q)'\]\.planes$", -2),
    (r"\.(w_scale|act_scale)$", None),
    (r"\['embed'\]$", 0),              # (V, d): vocab
    (r"\['lm_head'\]$", -1),           # (d, V): vocab
    (r"\['img_proj'\]$", -1),
    (r"\['(wq|wk|wv)'\]$", -1),        # (R, d, H*hd): heads
    (r"\['(bq|bk|bv)'\]$", -1),
    (r"\['wo'\]$", -2),                # (R, H*hd, d): input/head dim
    (r"\['experts'\]\['(gate|up|down)'\]$", -3),   # (R, E, ..): experts (EP)
    (r"\['(gate|up)'\]$", -1),         # (R, d, ff): ff
    (r"\['down'\]$", -2),              # (R, ff, d): ff
    (r"\['router'\]$", None),
    (r"\['in_proj'\]$", -1),           # (R, d, Z): inner (legacy fused)
    (r"\['(wz|wx)'\]$", -1),           # (R, d, d_inner)
    (r"\['(wb|wc|wdt)'\]$", None),     # small B/C/dt heads: replicate
    (r"\['out_proj'\]$", -2),          # (R, d_inner, d)
    (r"\['conv_w(x)?'\]$", -1),
    (r"\['conv_b(x)?'\]$", -1),
    (r"\['conv_[wb][bc]'\]$", None),
    (r"\['(dt_bias|a_log|d_skip)'\]$", -1),
    (r"\['norm'\]$", -1),              # (R, d_inner): gated-norm weight
    (r"\['(ln1|ln2|q_norm|k_norm|final_norm)'\]$", None),
]

# the attention leaves the port cuts at head granularity only
_ATTN_RE = re.compile(r"\['(wq|wk|wv|wo|bq|bk|bv)(_q'\]\.planes|'\])$")
_EXPERT_RE = re.compile(r"\['experts'\]\['(gate|up|down)'\]$")


def _axis_size(mesh, axis: Optional[str]) -> int:
    if axis is None:
        return 1
    return mesh.shape[axis]


def _tp_dim(path: str, ndim: int) -> Optional[int]:
    if ndim == 0:                       # scalar placeholder (dropped weight)
        return None
    for pat, dim in _TP_RULES:
        if re.search(pat, path):
            if dim is None:
                return None
            return dim % ndim
    return None


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def param_spec(path: str, shape: tuple, mesh, *,
               model_axis: Optional[str] = "model",
               fsdp_axes: tuple = (),
               fsdp_threshold: int = 1 << 20,
               tp_scope: str = "all",
               kv_heads: Optional[int] = None) -> tuple:
    """The spec of the leaf at ``path``.  With ``kv_heads`` (the model's
    ``n_kv_heads``) the attention leaves shard only when the kv heads
    divide the model axis (the module docstring's one difference)."""
    ndim = len(shape)
    entries: list = [None] * ndim
    is_expert = bool(_EXPERT_RE.search(path))
    use_tp = model_axis is not None and (tp_scope == "all" or is_expert)
    msize = _axis_size(mesh, model_axis) if use_tp else 1
    if use_tp and msize > 1:
        tp = _tp_dim(path, ndim)
        heads_ok = (kv_heads is None or not _ATTN_RE.search(path)
                    or kv_heads % msize == 0)
        if tp is not None and shape[tp] % msize == 0 and heads_ok:
            entries[tp] = model_axis
    # FSDP: shard the largest remaining divisible dim on the given axes.
    # Expert weights under EP stay resident (shard_map owns them 1:1).
    if fsdp_axes and not (is_expert and tp_scope == "experts") \
            and _prod(shape) >= fsdp_threshold:
        fsize = _prod(_axis_size(mesh, a) for a in fsdp_axes)
        cands = sorted(range(ndim), key=lambda d: -shape[d])
        for d in cands:
            if entries[d] is None and shape[d] % fsize == 0:
                entries[d] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
                break
    return tuple(entries)


def params_shardings(mesh, params_tree: Any, *, fsdp: bool = True,
                     model_axis: Optional[str] = "model",
                     fsdp_axes: Optional[tuple] = None,
                     fsdp_threshold: int = 1 << 20,
                     tp_scope: str = "all",
                     ep_axis: Optional[str] = None,
                     kv_heads: Optional[int] = None) -> Any:
    """A tree of specs shaped like ``params_tree`` (``kv_heads``: see
    :func:`param_spec`)."""
    from repro_torch.launch.mesh import batch_axes

    if fsdp_axes is None:
        fax = batch_axes(mesh) if fsdp else ()
    else:
        fax = fsdp_axes if fsdp else ()
    eff_model = model_axis if model_axis is not None else ep_axis
    flat = tree_util.flatten_with_path(params_tree)
    specs = [param_spec(path, tuple(leaf.shape), mesh, model_axis=eff_model,
                        fsdp_axes=fax, fsdp_threshold=fsdp_threshold,
                        tp_scope=tp_scope, kv_heads=kv_heads)
             for path, leaf in flat]
    return tree_util.unflatten(params_tree, specs)


def _entry(bax: tuple):
    return bax if len(bax) > 1 else bax[0]


def cache_shardings(mesh, caches_tree: Any, *, batch: int,
                    long_context: bool = False,
                    axes: Optional[tuple] = None,
                    model_axis: Optional[str] = "model",
                    ssm_model: bool = True,
                    paged: bool = False) -> Any:
    """The reference's placement of KV caches ``(R, B, S, Hkv, D)``, page
    pools ``(R, P, page_len, Hkv, D)`` (codes, scales and tail rings
    too), SSM states ``(R, B, H, P, N)`` and conv windows: batch (or
    pages) on the data axes, the dense KV sequence dim on the model axis,
    SSM/conv state on it with ``ssm_model``; the per-slot ``length``
    follows the batch axes.  See the module docstring for the port's
    executing pool, which holds local kv heads instead."""
    from repro_torch.launch.mesh import batch_axes

    bax = tuple(axes) if axes is not None else batch_axes(mesh)
    nb = _prod(mesh.shape[a] for a in bax)
    msz = (mesh.shape[model_axis]
           if model_axis and model_axis in mesh.axis_names else 1)

    def one_path(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if name.endswith("['length']"):
            if len(shape) == 1 and nb > 1 and shape[0] % nb == 0:
                return (_entry(bax),)
            return ()
        entries = [None] * len(shape)
        if paged and (re.search(r"'[kv]_(codes|scale)'", name)
                      or re.search(r"'[kv]_tail'", name)
                      or "'k'" in name or "'v'" in name):
            if shape[1] % nb == 0 and nb > 1:
                entries[1] = _entry(bax)
            return tuple(entries)
        if "'k'" in name or "'v'" in name:          # (R, B, S, Hkv, D)
            if long_context:
                if shape[2] % nb == 0 and nb > 1:
                    entries[2] = _entry(bax)
            else:
                if shape[1] % nb == 0 and nb > 1:
                    entries[1] = _entry(bax)
                if msz > 1 and shape[2] % msz == 0:
                    entries[2] = model_axis
        elif "'ssm'" in name:                       # (R, B, H, P, N)
            if shape[1] % nb == 0 and nb > 1:
                entries[1] = _entry(bax)
            if ssm_model and msz > 1 and shape[2] % msz == 0:
                entries[2] = model_axis
        elif "'conv'" in name:                      # (R, B, W-1, C)
            if shape[1] % nb == 0 and nb > 1:
                entries[1] = _entry(bax)
            if ssm_model and msz > 1 and shape[3] % msz == 0:
                entries[3] = model_axis
        return tuple(entries)

    flat = tree_util.flatten_with_path(caches_tree)
    return tree_util.unflatten(caches_tree,
                               [one_path(p, leaf) for p, leaf in flat])


def split_kv_specs(mesh, *, splits: int, batch: int,
                   model_axis: Optional[str] = "model",
                   axes: Optional[tuple] = None) -> dict:
    """The split-KV partials' placement (``kernels/paged_attention``):
    ``acc`` (B, G, split, R, D) and the (m, l) statistics (B, G, split,
    R), the split axis on the model axis when it divides, the batch on the
    data axes.  Returns ``{"partial": spec, "stat": spec}``.  In the port
    this is case B of ``paged_decode_attention``: rank r walks splits
    ``[r*S/M, (r+1)*S/M)`` and the partials are gathered along the split
    axis before the merge."""
    from repro_torch.launch.mesh import batch_axes

    bax = tuple(axes) if axes is not None else batch_axes(mesh)
    nb = _prod(mesh.shape[a] for a in bax)
    msz = (mesh.shape[model_axis]
           if model_axis and model_axis in mesh.axis_names else 1)
    b_entry = _entry(bax) if nb > 1 and batch % nb == 0 else None
    s_entry = model_axis if msz > 1 and splits % msz == 0 else None
    return {"partial": (b_entry, None, s_entry, None, None),
            "stat": (b_entry, None, s_entry, None)}


def serve_shardings(mesh, params_tree: Any, caches_tree: Any, *,
                    batch: int,
                    model_axis: Optional[str] = "model",
                    axes: Optional[tuple] = None,
                    paged: bool = False,
                    kv_heads: Optional[int] = None) -> dict:
    """Everything the reference's serving stack pins, as specs: the TP
    rules on params (floats and bit-planes alike, no FSDP), the caches
    (SSM/conv state batch-only), per-slot logits, tokens and flags on the
    data axes, and the replicated catch-all."""
    from repro_torch.launch.mesh import batch_axes

    bax = tuple(axes) if axes is not None else batch_axes(mesh)
    nb = _prod(mesh.shape[a] for a in bax)
    row = (_entry(bax),) if nb > 1 and batch % nb == 0 else ()
    return {
        "params": params_shardings(mesh, params_tree, fsdp=False,
                                   model_axis=model_axis, kv_heads=kv_heads),
        "caches": cache_shardings(mesh, caches_tree, batch=batch, axes=bax,
                                  model_axis=model_axis, ssm_model=False,
                                  paged=paged),
        "logits": (*row, None),
        "tokens": (*row, None),
        "active": row,
        "replicated": (),
    }


def spec_leaves(template: Any, specs: Any) -> list:
    """The specs of ``template``'s leaves in tree order.  A spec is a
    tuple, so a spec tree is walked by its template's structure."""
    if template is None:
        return []
    if isinstance(template, dict):
        return [s for k in sorted(template)
                for s in spec_leaves(template[k], specs[k])]
    if tree_util._is_namedtuple(template):
        return [s for f in template._fields
                for s in spec_leaves(getattr(template, f), getattr(specs, f))]
    if isinstance(template, (tuple, list)):
        return [s for t, sp in zip(template, specs)
                for s in spec_leaves(t, sp)]
    return [specs]


def _cut(leaf, spec, path: str, mesh, rank: int):
    dims = [i for i, e in enumerate(spec) if e is not None]
    for i in dims:
        names = spec[i] if isinstance(spec[i], tuple) else (spec[i],)
        if any(n != "model" for n in names):
            raise NotImplementedError(
                f"{path}: spec {spec} shards on {names}; serving runs the "
                f"model axis only")
    m = mesh.shape["model"]
    if not dims or m == 1:
        return leaf
    (i,) = dims
    n = leaf.shape[i] // m
    return leaf.narrow(i, rank * n, n).clone(
        memory_format=torch.contiguous_format)


def cut_shards(params: Any, specs: Any, mesh, ranks, *,
               consume: bool = False) -> list:
    """The shards of ``ranks`` (``shard_params`` of each), cut leaf by
    leaf.  With ``consume=True`` each dict of the full ``params`` tree
    gives up an entry as soon as every rank's piece of it is cut, so the
    full tree's bytes are freed as the shards appear (nothing else may
    hold them): the peak is the shards plus one leaf, where cutting from
    a tree kept whole peaks at twice the model."""
    ranks = list(ranks)

    def walk(node, spec, path):
        if node is None:
            return [None] * len(ranks)
        if isinstance(node, dict):
            outs = [{} for _ in ranks]
            for k in list(node):
                for o, v in zip(outs, walk(node[k], spec[k],
                                           f"{path}[{k!r}]")):
                    o[k] = v
                if consume:
                    node[k] = None
            return outs
        if tree_util._is_namedtuple(node):
            cols = [walk(getattr(node, f), getattr(spec, f), f"{path}.{f}")
                    for f in node._fields]
            return [type(node)(*(c[j] for c in cols))
                    for j in range(len(ranks))]
        if isinstance(node, (tuple, list)):
            cols = [walk(n, sp, f"{path}[{i}]")
                    for i, (n, sp) in enumerate(zip(node, spec))]
            return [type(node)(c[j] for c in cols)
                    for j in range(len(ranks))]
        return [_cut(node, spec, path, mesh, r) for r in ranks]

    return walk(params, specs, "")


def shard_params(params: Any, specs: Any, mesh, rank: int) -> Any:
    """Rank ``rank``'s shard of the full ``params`` tree: each leaf whose
    spec names the model axis is cut into ``mesh.shape["model"]`` equal
    runs along that dim and the rank's run copied out, contiguous (the
    kernels need contiguous operands; a copy made once here is not made
    per call) and apart from the full tree, which the caller can then
    free.  Replicated leaves are the full tree's own tensors, shared by
    the ranks of a local group.  Data-axis entries are refused: serving
    runs the model axis only."""
    return cut_shards(params, specs, mesh, [rank])[0]
