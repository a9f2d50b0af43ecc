"""Workload descriptors: every FC/CONV-class layer as a GEMM.

Port of ``src/repro/simulator/workload.py`` (pure Python, the same
defaults: the nets of ``models/paper_nets.py`` run seq 128, while the BERT
workloads here keep SQuAD's 384).

A layer is ``(M, K, N)`` — M output rows (tokens / output pixels), K the
reduction (fan-in), N output features — plus ``unique_acts``, the number of
*distinct* input activations (for CONV, ``IH*IW*IC`` is smaller than ``M*K``
because of kernel overlap; the IS dataflow reads each distinct activation
from DRAM exactly once).

Workload builders for the paper's five DNNs (Table I) use the standard
published dimensions; per-model notes inline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class LayerWork:
    name: str
    m: int              # output rows (spatial x batch for conv, tokens for FC)
    k: int              # fan-in (IC*KH*KW for conv)
    n: int              # output features
    unique_acts: int    # distinct input activations feeding this layer
    kind: str = "fc"    # 'fc' | 'conv' | 'lstm' | 'attn_proj'

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n

    @property
    def weights(self) -> int:
        return self.k * self.n


def conv(name: str, ih: int, iw: int, ic: int, oc: int, kh: int, kw: int,
         stride: int = 1, pad: int = 0) -> LayerWork:
    oh = (ih + 2 * pad - kh) // stride + 1
    ow = (iw + 2 * pad - kw) // stride + 1
    return LayerWork(name=name, m=oh * ow, k=ic * kh * kw, n=oc,
                     unique_acts=ih * iw * ic, kind="conv")


def fc(name: str, k: int, n: int, tokens: int = 1) -> LayerWork:
    return LayerWork(name=name, m=tokens, k=k, n=n,
                     unique_acts=tokens * k, kind="fc")


# ---------------------------------------------------------------------------
# Paper workloads (Table I)
# ---------------------------------------------------------------------------

def alexnet() -> List[LayerWork]:
    """AlexNet [Krizhevsky'12]: 5 CONV + 3 FC, ImageNet 227x227, batch 1."""
    return [
        conv("conv1", 227, 227, 3, 96, 11, 11, stride=4),
        conv("conv2", 27, 27, 96, 256, 5, 5, pad=2),
        conv("conv3", 13, 13, 256, 384, 3, 3, pad=1),
        conv("conv4", 13, 13, 384, 384, 3, 3, pad=1),
        conv("conv5", 13, 13, 384, 256, 3, 3, pad=1),
        fc("fc6", 9216, 4096),
        fc("fc7", 4096, 4096),
        fc("fc8", 4096, 1000),
    ]


def ptblm(seq: int = 35, hidden: int = 1500, vocab: int = 10000) -> List[LayerWork]:
    """PTBLM [Zaremba'14] 'large': 2 LSTM layers, h=1500, PTB vocab 10k.

    Each LSTM step runs 4 gate GEMMs over [x_t; h_{t-1}]; we fold the 4 gates
    into one (K = 2h, N = 4h) GEMM per layer per timestep, which is how the
    accelerator would schedule it.  Embedding lookup is not a GEMM; the
    softmax projection is.
    """
    layers: List[LayerWork] = []
    for t in range(seq):
        for l in range(2):
            layers.append(LayerWork(
                name=f"lstm{l}_t{t}", m=1, k=2 * hidden, n=4 * hidden,
                unique_acts=2 * hidden, kind="lstm"))
    layers.append(fc("softmax", hidden, vocab))
    return layers


def _encoder_block(name: str, d: int, ff: int, seq: int) -> List[LayerWork]:
    """Attention QKV/O projections + 2 FFN GEMMs for `seq` tokens.

    The paper quantizes only layers with *weights* — the QK^T / AV
    activation-activation products are excluded (see DESIGN.md
    §Arch-applicability) and are also excluded from its access counts.
    """
    return [
        fc(f"{name}.q", d, d, seq), fc(f"{name}.k", d, d, seq),
        fc(f"{name}.v", d, d, seq), fc(f"{name}.o", d, d, seq),
        fc(f"{name}.ff1", d, ff, seq), fc(f"{name}.ff2", ff, d, seq),
    ]


def transformer_base(seq: int = 128) -> List[LayerWork]:
    """Transformer [Vaswani'17] base: 6 enc + 6 dec, d=512, ff=2048.

    Decoder blocks carry an extra cross-attention projection set.
    """
    layers: List[LayerWork] = []
    for i in range(6):
        layers += _encoder_block(f"enc{i}", 512, 2048, seq)
    for i in range(6):
        layers += _encoder_block(f"dec{i}", 512, 2048, seq)
        layers += [fc(f"dec{i}.xq", 512, 512, seq),
                   fc(f"dec{i}.xk", 512, 512, seq),
                   fc(f"dec{i}.xv", 512, 512, seq),
                   fc(f"dec{i}.xo", 512, 512, seq)]
    layers.append(fc("generator", 512, 37000, seq))
    return layers


def bert(layers_n: int = 12, d: int = 768, ff: int = 3072,
         seq: int = 384) -> List[LayerWork]:
    """BERT-Base/Large [Devlin'18]; SQuAD uses seq 384."""
    layers: List[LayerWork] = []
    for i in range(layers_n):
        layers += _encoder_block(f"l{i}", d, ff, seq)
    layers.append(fc("qa_head", d, 2, seq))
    return layers


def bert_base(seq: int = 384) -> List[LayerWork]:
    return bert(12, 768, 3072, seq)


def bert_large(seq: int = 384) -> List[LayerWork]:
    return bert(24, 1024, 4096, seq)


PAPER_WORKLOADS = {
    "alexnet": alexnet,
    "ptblm": ptblm,
    "transformer": transformer_base,
    "bert-base": bert_base,
    "bert-large": bert_large,
}
