"""Mamba-2 SSD (state-space duality) block: chunked dual form and decode
step (port of ``src/repro/models/ssd.py``).

Follows the SSD algorithm of Mamba-2 [arXiv:2405.21060]: the sequence is
split into chunks of ``L``; within-chunk terms use the quadratic
(attention-like) form, cross-chunk information flows through the recurrent
state ``(B, H, P, N)``, here a Python loop over the chunks where the
reference scans.  A step of at most ``conv_width`` tokens (decode) runs the
recurrence unrolled.  n_groups = 1 (B/C shared across heads).

Plain PyTorch: the reference computes SSD in ``jnp`` outside any Pallas
kernel.  :func:`mamba2_block` is functional, like the reference's: it
returns the new state; ``models.model`` writes it into the cache leaves in
place (:func:`write_rows_`).  On a model axis (``models.sharding``) a rank
holds its run of the SSD heads, where the reference's hints put them; the
reference's legacy fused ``in_proj`` layout is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.layers import dense, rms_norm


class SSMState(NamedTuple):
    ssm: torch.Tensor        # (B, H, P, N) f32
    conv: torch.Tensor       # (B, W-1, conv_dim) rolling conv window


def _window_conv(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 s: int) -> torch.Tensor:
    """Depthwise conv of a ``(B, W-1+s, C)`` f32 window, ``w`` (W, C):
    ``sum_i window[:, i:i+s] * w[i] + b`` in f32, summed in the
    reference's order (its stateful branch starts from zeros; 0 + x is
    x)."""
    wf = w.float()
    out = window[:, :s] * wf[0]
    for i in range(1, wf.shape[0]):
        out = out + window[:, i:i + s] * wf[i]
    return out + b.float()


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in f32; x: (B, S, C), w: (W, C).  The
    reference's ``lax.conv`` as W shifted products, which no library
    convolution (cuDNN's f32 convolutions round through TF32 by default)
    stands between."""
    window = F.pad(x.float(), (0, 0, w.shape[0] - 1, 0))
    return _window_conv(window, w, b, x.shape[1]).to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L) -> (..., L, L) lower-triangular pairwise cumulative sums
    (``-inf`` above the diagonal)."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]      # sum_{j<k<=i} a_k
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, -torch.inf)


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD scan.  x: (B, S, H, P); a: (B, S, H) log-decay (dt*A); b/c:
    (B, S, N).  The sequence is zero-padded to a multiple of ``chunk``.
    Returns ``(y (B, S, H, P), final_state (B, H, P, N) f32)``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    ac = a.reshape(bsz, nc, chunk, h).permute(0, 1, 3, 2)      # (B,nc,H,L)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)

    a_cs = torch.cumsum(ac, dim=-1)                            # (B,nc,H,L)
    # intra-chunk (quadratic) term
    lmat = torch.exp(_segsum(ac))                              # (B,nc,H,L,L)
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)           # (B,nc,L,L)
    y_diag = torch.einsum("bcls,bchls,bcshp->bclhp", scores, lmat, xc)

    # per-chunk input -> state
    decay_to_end = torch.exp(a_cs[..., -1:] - a_cs)            # (B,nc,H,L)
    states = torch.einsum("bcsn,bchs,bcshp->bchpn", bc, decay_to_end, xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(a_cs[..., -1])                     # (B,nc,H)
    st = (init_state if init_state is not None else
          torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    prev = []
    for i in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                     # (B,nc,H,P,N)

    # state -> output term
    in_decay = torch.exp(a_cs)                                 # (B,nc,H,L)
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", cc, prev_states, in_decay)

    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), st


def mamba2_init_state(batch: int, cfg, dtype=torch.float32,
                      device=None) -> SSMState:
    """Zero SSM state (f32) and conv window (``dtype``) for ``batch`` rows;
    on a model axis, of the rank's local SSD heads (its conv window holds
    its run of the inner channels, then the replicated B and C ones)."""
    heads = sharding.local_ssm_heads(cfg)
    conv_dim = heads * cfg.ssm_head_dim + 2 * cfg.ssm_state
    return SSMState(
        ssm=torch.zeros((batch, heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=dtype,
                         device=device))


def _window_at(window: torch.Tensor, valid_len: torch.Tensor,
               width: int) -> torch.Tensor:
    """Per-row rolling conv state from a ``(B, W-1+S, C)`` window whose
    first W-1 rows are the incoming state and the rest the raw projections
    of a right-padded step: row ``b`` keeps rows ``valid_len[b] ..
    valid_len[b] + W-2``, the last W-1 real inputs.  The start is clamped
    into range as ``dynamic_slice`` clamps it."""
    bsz, rows, c = window.shape
    start = torch.clamp(valid_len.long(), 0, rows - (width - 1))
    idx = start[:, None] + torch.arange(width - 1, device=window.device)
    return torch.gather(window, 1, idx[:, :, None].expand(bsz, width - 1, c))


def write_rows_(dst: torch.Tensor, src: torch.Tensor,
                rows: Optional[torch.Tensor] = None) -> None:
    """``dst[b] = src[b]`` in place where ``rows[b]`` (every row when
    ``rows`` is None); the other rows of ``dst`` keep their values.
    ``dst``/``src``: ``(B, ...)``; ``rows``: ``(B,)`` bool."""
    src = src.to(dst.dtype)
    if rows is None:
        dst.copy_(src)
    else:
        dst.copy_(torch.where(rows.reshape((-1,) + (1,) * (dst.dim() - 1)),
                              src, dst))


def _inner_run(y: torch.Tensor, width: int) -> torch.Tensor:
    """This rank's run of ``width`` inner channels of a projection that
    may have been computed whole."""
    if sharding.cut_of(y.shape[-1], width, "SSD inner channels") == 1:
        return y
    return y[..., sharding.rank_slice(width)]


def _split_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
                    width: int) -> torch.Tensor:
    """``rms_norm`` over a dim of ``width`` cut over the model axis: each
    rank's sum of squares, summed over the ranks in one step, then the
    ``rsqrt`` of their mean."""
    dt = x.dtype
    xf = x.float()
    var = sharding.all_reduce((xf * xf).sum(dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def mamba2_block(p, x: torch.Tensor, cfg,
                 state: Optional[SSMState] = None, quant=False,
                 valid_len: Optional[torch.Tensor] = None):
    """x: (B, S, d_model) -> ``(y, new_state)``; decode/prefill into a
    state when ``state`` is given, else ``(y, None)``.

    ``valid_len`` (B,) masks right-padding: pad tokens get ``dt = 0``
    (decay ``exp(0) = 1``, input ``x * dt = 0``), so the recurrent state
    passes through them untouched, and the rolling conv window is taken
    per row at the real-token boundary (:func:`_window_at`).  A row with
    ``valid_len[b] == 0`` keeps its state and window bit-identical: the
    chunked prefill's decode and free rows ride along that way.

    On a model axis a rank may hold a run of the heads: ``wz/wx``, the
    x conv, ``dt_bias/a_log/d_skip`` and the gated norm's weight are its
    run, ``wb/wc/wdt`` and the B/C convs are whole (``wdt``'s output is cut
    to the run), ``out_proj`` and its planes are row-parallel, and the
    gated norm sums its squares over every rank before the ``rsqrt``.
    The reference's rules keep the ``wz``/``wx`` planes whole, so a
    quantized rank computes their whole output and keeps its run."""
    bsz, s, _ = x.shape
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    io = x.dtype

    cut = sharding.cut_of(h, p["dt_bias"].shape[-1], "SSD heads")
    h_full, h = h, h // cut
    d_inner = h * pdim
    z = _inner_run(dense(p["wz"], x, quant=p.get("wz_q") if quant else None,
                         ctx=quant), d_inner)
    xs_r = _inner_run(dense(p["wx"], x,
                            quant=p.get("wx_q") if quant else None,
                            ctx=quant), d_inner)
    b = dense(p["wb"], x)
    c = dense(p["wc"], x)
    dt = dense(p["wdt"], x)
    if cut > 1:
        dt = dt[..., sharding.rank_slice(h)]
    dt = torch.logaddexp(dt.float() + p["dt_bias"],
                         torch.zeros((), device=x.device))   # softplus
    if valid_len is not None:
        ar = torch.arange(s, dtype=torch.int32, device=x.device)
        pad = ar[None, :] >= valid_len[:, None]
        dt = torch.where(pad[..., None], 0.0, dt)
    a_log = -torch.exp(p["a_log"].float())                   # (H,) negative

    if state is None:
        xs_r = _causal_conv(xs_r, p["conv_wx"], p["conv_bx"])
        b = _causal_conv(b, p["conv_wb"], p["conv_bb"])
        c = _causal_conv(c, p["conv_wc"], p["conv_bc"])
        new_conv = None
    else:
        conv_in = state.conv
        window = torch.cat([conv_in, torch.cat([xs_r, b, c], -1).to(
            conv_in.dtype)], dim=1)                          # (B, W-1+s, C)
        w = torch.cat([p["conv_wx"], p["conv_wb"], p["conv_wc"]], -1)
        bias = torch.cat([p["conv_bx"], p["conv_bb"], p["conv_bc"]], -1)
        xbc = _window_conv(window.float(), w, bias, s).to(io)
        if valid_len is None:
            new_conv = window[:, s:s + cfg.conv_width - 1]
        else:
            new_conv = _window_at(window, valid_len, cfg.conv_width)
        xs_r, b, c = torch.split(xbc, [d_inner, n, n], dim=-1)

    xs = F.silu(xs_r.float()).to(io)
    b = F.silu(b.float()).to(io)
    c = F.silu(c.float()).to(io)
    xs = xs.reshape(bsz, s, h, pdim)

    a = dt * a_log                                           # (B,S,H)
    dx = xs.float() * dt[..., None]                          # dt folded into x

    if state is None:
        y, _ = ssd_chunked(dx, a, b.float(), c.float(), cfg.ssd_chunk)
        new_state = None
    elif s > cfg.conv_width:
        # prefill with state: the chunked dual form seeded with it
        y, final = ssd_chunked(dx, a, b.float(), c.float(), cfg.ssd_chunk,
                               init_state=state.ssm)
        new_state = SSMState(ssm=final, conv=new_conv)
    else:
        # short step (decode): the recurrence, unrolled over s <= W tokens
        bf, cf = b.float(), c.float()
        st = state.ssm
        ys = []
        for t in range(s):
            st = (st * torch.exp(a[:, t])[..., None, None]
                  + dx[:, t, :, :, None] * bf[:, t, None, None, :])
            ys.append(torch.einsum("bhpn,bn->bhp", st, cf[:, t]))
        y = torch.stack(ys, dim=1)                           # (B,S,H,P)
        new_state = SSMState(ssm=st, conv=new_conv)

    y = y + xs.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(io)
    z = z.to(io)
    y = y * F.silu(z.float()).to(io)
    if cut > 1:
        y = _split_rms_norm(y, p["norm"], cfg.norm_eps, h_full * pdim)
    else:
        y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = dense(p["out_proj"], y,
                quant=p.get("out_proj_q") if quant else None, ctx=quant,
                reduce=cut > 1)
    return out, new_state
