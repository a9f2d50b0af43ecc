"""The paper's five workloads (Table I) as PyTorch forwards that record the
input activations of every FC/CONV GEMM: the tensors QeiHaN LOG2-quantizes.

Port of ``src/repro/models/paper_nets.py``, split into an init and a
forward.  :func:`init_paper_params` draws a net's weights and its synthetic
input into a flat dict of tensors (random, with the reference's
initializers and sizes: no pretrained weights are used); the forwards in
:data:`PAPER_ACTIVATIONS` take that dict and return ``[(name, tensor)]``
under the reference's names, in its order and in its layouts (AlexNet's
activations NHWC, its weights HWIO, its FC input flattened in NHWC order).
``models/convert.py::paper_params_from_numpy`` carries numpy arrays of the
same dict across, so the tests feed both frameworks the same weights.

The nets' own products (convolutions, LSTM gates, attention and FFN
projections) are plain ``F.conv2d`` and ``torch.matmul``, as the reference
computes them outside any Pallas kernel; LOG2 coding of the recorded
tensors is the caller's (``kernels/log2quant`` on the card).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device

__all__ = ["Acts", "init_paper_params", "alexnet_activations",
           "ptblm_activations", "transformer_activations",
           "bert_base_activations", "bert_large_activations",
           "PAPER_ACTIVATIONS"]

Acts = List[Tuple[str, torch.Tensor]]
Params = Dict[str, torch.Tensor]

# AlexNet: (name, out channels, kernel, stride, pad, max-pool after)
_ALEXNET_CONV = [("conv1", 96, 11, 4, 0, True), ("conv2", 256, 5, 1, 2, True),
                 ("conv3", 384, 3, 1, 1, False),
                 ("conv4", 384, 3, 1, 1, False),
                 ("conv5", 256, 3, 1, 1, True)]
_ALEXNET_FC = [("fc6", 4096), ("fc7", 4096), ("fc8", 1000)]
_ACT_FNS = {"relu": torch.relu,
            # jax.nn.gelu's default is the tanh approximation
            "gelu": lambda x: F.gelu(x, approximate="tanh")}


def _normal(shape, generator, device, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32) * scale


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(v + 1e-5)


# ---------------------------------------------------------------------------
# AlexNet (5 CONV + 3 FC), batch 1, 227x227 ImageNet-style input
# ---------------------------------------------------------------------------

def _alexnet_params(generator, device) -> Params:
    p = {"x": _normal((1, 227, 227, 3), generator, device)}
    ic, hw = 3, 227
    for name, oc, kh, stride, pad, pool in _ALEXNET_CONV:
        p[name] = _normal((kh, kh, ic, oc), generator, device,
                          math.sqrt(2.0 / (kh * kh * ic)))
        hw = (hw + 2 * pad - kh) // stride + 1
        hw = (hw - 3) // 2 + 1 if pool else hw
        ic = oc
    k = hw * hw * ic
    for name, n in _ALEXNET_FC:
        p[name] = _normal((k, n), generator, device, math.sqrt(2.0 / k))
        k = n
    return p


def alexnet_activations(params: Params) -> Acts:
    """Each conv's NHWC input, then each FC's (1, K) input."""
    x = params["x"]                                   # (1, H, W, C)
    acts: Acts = []
    for name, _, _, stride, pad, pool in _ALEXNET_CONV:
        acts.append((name, x.contiguous()))
        # NCHW views of the NHWC activation and the HWIO weight
        y = torch.relu(F.conv2d(x.permute(0, 3, 1, 2),
                                params[name].permute(3, 2, 0, 1),
                                stride=stride, padding=pad))
        if pool:
            y = F.max_pool2d(y, 3, 2)
        x = y.permute(0, 2, 3, 1)
    x = x.reshape(1, -1)                              # NHWC order
    for name, _ in _ALEXNET_FC:
        acts.append((name, x))
        x = torch.relu(x @ params[name])
    return acts


# ---------------------------------------------------------------------------
# PTBLM: 2-layer LSTM, hidden 1500 (Zaremba'14 "large")
# ---------------------------------------------------------------------------

def _ptblm_params(generator, device, seq: int = 35,
                  hidden: int = 1500) -> Params:
    p = {"emb": _normal((seq, hidden), generator, device, 0.1)}
    for l in range(2):
        p[f"w{l}"] = _normal((2 * hidden, 4 * hidden), generator, device,
                             1.0 / math.sqrt(2 * hidden))
    return p


def _lstm_layer(inputs: torch.Tensor, w: torch.Tensor):
    """One layer over ``inputs (seq, hidden)``: the stacked ``[x_t;
    h_{t-1}]`` gate inputs it records and its outputs ``h_t``.  Gates
    split i, f, o, u; the forget gate's bias is +1; h and c start at 0."""
    seq, hidden = inputs.shape
    gate_in = torch.zeros((seq, 2 * hidden), dtype=inputs.dtype,
                          device=inputs.device)
    gate_in[:, :hidden] = inputs
    c = torch.zeros((hidden,), dtype=inputs.dtype, device=inputs.device)
    outs = []
    for t in range(seq):
        if t:
            gate_in[t, hidden:] = outs[-1]
        i, f, o, u = torch.chunk(gate_in[t] @ w, 4)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(u)
        outs.append(torch.sigmoid(o) * torch.tanh(c))
    return gate_in, torch.stack(outs)


def ptblm_activations(params: Params) -> Acts:
    """Each LSTM layer's stacked gate inputs, then the softmax input."""
    g0, x = _lstm_layer(params["emb"], params["w0"])
    g1, x = _lstm_layer(x, params["w1"])
    return [("lstm0", g0), ("lstm1", g1), ("softmax_in", x)]


# ---------------------------------------------------------------------------
# Transformer / BERT encoders
# ---------------------------------------------------------------------------

_BLOCK = ("q", "k", "v", "o", "ff1", "ff2")


def _encoder_params(generator, device, n_layers: int, d: int, ff: int,
                    seq: int, prefix: str = "") -> Params:
    """The input ``x (seq, d)`` and each layer's q, k, v, o, ff1, ff2
    weights (``N(0, 1/fan_in)``), drawn in the reference's order."""
    p = {prefix + "x": _normal((seq, d), generator, device)}
    for l in range(n_layers):
        for w, (k, n) in zip(_BLOCK, [(d, d)] * 4 + [(d, ff), (ff, d)]):
            p[f"{prefix}l{l}.{w}"] = _normal((k, n), generator, device,
                                             1.0 / math.sqrt(k))
    return p


def _encoder_activations(params: Params, act: str = "gelu",
                         prefix: str = "") -> Acts:
    """Pre-norm encoder blocks of ``max(d // 64, 1)`` heads; records each
    layer's ``qkv_in``, ``o_in``, ``ff1_in`` and ``ff2_in``."""
    act_fn = _ACT_FNS[act]
    x = _layer_norm(params[prefix + "x"])
    seq, d = x.shape
    nh = max(d // 64, 1)
    n_layers = sum(1 for k in params
                   if k.startswith(prefix + "l") and k.endswith(".q"))
    acts: Acts = []
    for l in range(n_layers):
        w = {n: params[f"{prefix}l{l}.{n}"] for n in _BLOCK}
        h = _layer_norm(x)
        acts.append((f"l{l}.qkv_in", h))
        qh, kh, vh = ((h @ w[n]).reshape(seq, nh, -1).transpose(0, 1)
                      for n in "qkv")
        a = torch.softmax(qh @ kh.transpose(1, 2) / math.sqrt(d / nh), -1)
        o = (a @ vh).transpose(0, 1).reshape(seq, d)
        acts.append((f"l{l}.o_in", o))
        x = x + o @ w["o"]
        h2 = _layer_norm(x)
        acts.append((f"l{l}.ff1_in", h2))
        u = act_fn(h2 @ w["ff1"])
        acts.append((f"l{l}.ff2_in", u))
        x = x + u @ w["ff2"]
    return acts


def transformer_activations(params: Params) -> Acts:
    """6 encoder + 6 decoder blocks, d 512, ff 2048, ReLU (Vaswani'17); the
    decoder's records are named ``dec_<name>``."""
    enc = _encoder_activations(params, "relu")
    dec = _encoder_activations(params, "relu", prefix="dec_")
    return enc + [(f"dec_{n}", a) for n, a in dec]


def bert_base_activations(params: Params) -> Acts:
    return _encoder_activations(params, "gelu")


def bert_large_activations(params: Params) -> Acts:
    return _encoder_activations(params, "gelu")


PAPER_ACTIVATIONS: Dict[str, Callable[[Params], Acts]] = {
    "alexnet": alexnet_activations,
    "ptblm": ptblm_activations,
    "transformer": transformer_activations,
    "bert-base": bert_base_activations,
    "bert-large": bert_large_activations,
}


def init_paper_params(name: str, generator: Optional[torch.Generator] = None,
                      device=None, **sizes) -> Params:
    """Weights and synthetic input of net ``name`` (a key of
    :data:`PAPER_ACTIVATIONS`) on ``device`` (``None``: the card).

    ``sizes``: PTBLM ``seq`` (35) and ``hidden`` (1500); the transformer
    and BERT nets ``seq`` (128).  AlexNet has none (227x227, batch 1).
    """
    dev = resolve_device(device)
    if name == "alexnet":
        return _alexnet_params(generator, dev, **sizes)
    if name == "ptblm":
        return _ptblm_params(generator, dev, **sizes)
    seq = sizes.pop("seq", 128)
    if sizes:
        raise TypeError(f"{name} takes only seq, got {sorted(sizes)}")
    if name == "transformer":
        return {**_encoder_params(generator, dev, 6, 512, 2048, seq),
                **_encoder_params(generator, dev, 6, 512, 2048, seq,
                                  prefix="dec_")}
    if name == "bert-base":
        return _encoder_params(generator, dev, 12, 768, 3072, seq)
    if name == "bert-large":
        return _encoder_params(generator, dev, 24, 1024, 4096, seq)
    raise KeyError(f"unknown paper net {name!r}; "
                   f"known: {sorted(PAPER_ACTIVATIONS)}")
