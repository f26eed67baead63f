"""Mamba-2 SSD (state-space duality) layer: chunked, quadratic within a
chunk and linear across chunks (arXiv:2405.21060), plus the O(1)-state
decode (the JAX package's ``models/ssm.py``).

Shapes: d_inner = expand * d_model, nh = d_inner / headdim heads, state N,
g groups for B/C (expanded to heads).  The intra-chunk part is dense
einsums; the inter-chunk recurrence, a ``lax.scan`` in the JAX package, is
a loop over the chunks that keeps the state entering each chunk.  Plain
PyTorch: no Pallas kernel lies on this path.

Every exponent kept is of a cumulative sum of dt * A with A < 0, so it is
at most 0: the exps underflow to 0 over a long chunk and never overflow.
The decay matrix's upper triangle (``_segsum``) would be the other sign:
the JAX package exponentiates it and then zeroes it, which leaves the
forward finite but makes the gradient 0 * inf = NaN once a chunk's decay
passes e^88 (mamba2-2.7b's chunks of 256 at TRAIN_4K).  The port masks it
to -inf before the exp: the same forward, bit for bit, and a finite
gradient (ROADMAP §3).

Over a 'model' axis that divides the heads (the JAX package's
``ssm.py:132-159, 202-205``): ``wz``, ``wx``, ``conv_x`` and ``out_proj``
hold this rank's slice of the inner dim, ``wdt``, ``dt_bias``, ``A_log``
and ``D`` its heads; ``wB``/``wC`` (the groups' B and C) stay whole and
each rank keeps the heads it runs.  The gated RMSNorm normalises over the
whole inner dim, so its sum of squares is all-reduced; ``out_proj``'s
partial sums meet in one all-reduce.  The decode state is split the same
way: ``ssd`` by heads, ``conv_x`` by channels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel import collectives as coll
from ..parallel import sharding as shd
from .common import ParamSpec, rmsnorm


def ssm_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    di, n, g, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    w = cfg.conv_width
    return {
        "wz": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wx": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wB": ParamSpec((d, g, n), ("embed", None, "ssm_state")),
        "wC": ParamSpec((d, g, n), ("embed", None, "ssm_state")),
        "wdt": ParamSpec((d, nh), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((w, di), (None, "conv_chan")),
        "conv_B": ParamSpec((w, g, n), (None, None, "ssm_state")),
        "conv_C": ParamSpec((w, g, n), (None, None, "ssm_state")),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "gate_norm": ParamSpec((di,), ("norm",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _proj_groups(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('...d,dgn->...gn', x, w)."""
    d, g, n = w.shape
    return (x @ w.reshape(d, g * n)).unflatten(-1, (g, n))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along axis 1.  x (B,S,C...), w (W,C...)."""
    width, s = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, width):
        shifted = torch.cat([x.new_zeros((x.shape[0], i) + x.shape[2:]), x],
                            dim=1)[:, :s]
        out = out + shifted * w[width - 1 - i]
    return out


def _conv_step(state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor):
    """Single-token causal conv.  state (B,W-1,C...), xt (B,C...)."""
    hist = torch.cat([state, xt[:, None]], dim=1)                 # (B,W,C..)
    y = torch.einsum("bw...,w...->b...", hist, w)
    return hist[:, 1:], y


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (..., Q, nh) -> decay matrix (..., nh, Q, Q): exp(sum_{j<i<=q} dA)."""
    q = dA.shape[-2]
    cs = torch.cumsum(dA, dim=-2)                                 # (..., Q, nh)
    diff = cs[..., :, None, :] - cs[..., None, :, :]              # (..., Q, Q, nh)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    diff = torch.movedim(diff, -1, -3)                            # (..., nh, Q, Q)
    # mask before the exp: exp(-inf) = 0 with a zero gradient, where the
    # upper triangle's exp would overflow and its gradient be 0 * inf
    return torch.exp(torch.where(mask, diff, float("-inf")))


def ssd_scan(x, dt, A, B, C, chunk: int):
    """Chunked SSD.  x (B,L,nh,P); dt (B,L,nh); A (nh,); B/C (B,L,nh,N)
    (already head-expanded).  Returns y (B,L,nh,P) and the final state
    (B,nh,N,P)."""
    b, l, nh, p = x.shape
    n = B.shape[-1]
    q = min(chunk, l)
    if l % q != 0:
        q = l
    nc = l // q

    xr = x.reshape(b, nc, q, nh, p)
    dtr = dt.reshape(b, nc, q, nh)
    Br = B.reshape(b, nc, q, nh, n)
    Cr = C.reshape(b, nc, q, nh, n)
    dA = dtr * A[None, None, None, :]                             # (b,nc,q,nh)

    xdt = xr * dtr[..., None]
    Lmat = _segsum(dA.float()).to(x.dtype)                        # (b,nc,nh,q,q)
    cb = torch.einsum("bcqhn,bckhn->bchqk", Cr, Br)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", cb * Lmat, xdt)

    cs = torch.cumsum(dA.float(), dim=2)                          # (b,nc,q,nh)
    decay_out = torch.exp(cs[:, :, -1:, :] - cs).to(x.dtype)      # (b,nc,q,nh)
    states = torch.einsum("bcqhn,bcqhp->bchnp", Br * decay_out[..., None], xdt)
    chunk_decay = torch.exp(cs[:, :, -1, :]).to(x.dtype)          # (b,nc,nh)

    # the inter-chunk recurrence: keep the state ENTERING each chunk
    s = x.new_zeros((b, nh, n, p))
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)                               # (b,nc,nh,n,p)

    decay_in = torch.exp(cs).to(x.dtype)                          # (b,nc,q,nh)
    y_off = torch.einsum("bcqhn,bchnp->bcqhp", Cr * decay_in[..., None], s_in)
    y = (y_diag + y_off).reshape(b, l, nh, p)
    return y, s


def _dt_and_A(p, dt: torch.Tensor, dtype: torch.dtype):
    dt = F.softplus(dt.float() + p.dt_bias.float()).to(dtype)
    A = (-torch.exp(p.A_log.float())).to(dtype)
    return dt, A


def split(p, cfg) -> bool:
    """Whether this rank holds a slice of the heads and the inner dim."""
    heads, inner = p.shard_dim("wdt") is not None, p.shard_dim("wx") is not None
    if heads != inner:
        raise ValueError(f"{cfg.name}: a model axis that splits the inner "
                         f"dim ({cfg.d_inner}) but not the {cfg.ssm_heads} "
                         "heads leaves no head whole on a rank")
    return heads


def projections(p, xin: torch.Tensor, cfg):
    """z, x (this rank's inner slice), B, C (every group) and dt (this
    rank's heads) of ``xin`` (..., D), before the convolutions."""
    xl = coll.copy_to_model(xin) if split(p, cfg) else xin
    return (xl @ p.wz, xl @ p.wx, _proj_groups(xin, p.wB),
            _proj_groups(xin, p.wC), xl @ p.wdt)


def local_heads(t: torch.Tensor, nh: int, dim: int) -> torch.Tensor:
    """A group tensor expanded to every head along ``dim``, then the heads
    this rank runs."""
    t = torch.repeat_interleave(t, nh // t.shape[dim], dim=dim)
    logical = [None] * t.dim()
    logical[dim] = "act_ssm_heads"
    return shd.constrain(t, *logical)


def _gated_norm(p, y: torch.Tensor, z: torch.Tensor, cfg) -> torch.Tensor:
    """RMSNorm of y * silu(z) over the whole inner dim: over a split inner
    dim the sum of squares is all-reduced."""
    y = y * F.silu(z)
    if not split(p, cfg):
        return rmsnorm(y, p.gate_norm, cfg.norm_eps)
    # the whole sum feeds this rank's slice again: its gradient is partial
    ss = coll.copy_to_model(coll.reduce_from_model(
        torch.sum(torch.square(y.float()), dim=-1, keepdim=True)))
    inv = torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps).to(y.dtype)
    return y * inv * shd.constrain(p.gate_norm, "act_ffn")


def ssm_forward(p, xin: torch.Tensor, cfg,
                state: Optional[Dict[str, torch.Tensor]] = None,
                pos: Optional[int] = None):
    """Full-sequence SSD (train/prefill).  xin (B,S,D) -> (B,S,D).
    If ``state`` is given, behaves as a single-step decode (S == 1) and
    returns (out, new state)."""
    if state is not None:
        return _ssm_decode(p, xin, cfg, state, pos)
    b, s, d = xin.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_headdim
    sp = split(p, cfg)

    xin = shd.constrain(xin, "act_batch", None, "act_embed")
    z, x, Bm, Cm, dt = projections(p, xin, cfg)

    x = F.silu(_causal_conv(x, p.conv_x))
    Bm = F.silu(_causal_conv(Bm, p.conv_B))
    Cm = F.silu(_causal_conv(Cm, p.conv_C))
    x = shd.constrain(x, "act_batch", None, "act_ffn",
                      shard=2 if sp else None)
    dt, A = _dt_and_A(p, dt, xin.dtype)

    xh = x.reshape(b, s, -1, hd)
    xh = shd.constrain(xh, "act_batch", None, "act_ssm_heads", None,
                       shard=2 if sp else None)
    y, _ = ssd_scan(xh, dt, A, local_heads(Bm, nh, 2),
                    local_heads(Cm, nh, 2), cfg.ssm_chunk)
    y = y + p.D[None, None, :, None] * xh
    y = _gated_norm(p, y.reshape(b, s, -1), z, cfg)
    out = (y.reshape(b * s, -1) @ p.out_proj).reshape(b, s, d)
    return shd.constrain(out, "act_batch", "act_seq", "act_embed",
                         partial=sp)


def init_state(cfg, batch: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """One SSM layer's zeroed decode state; over a 'model' axis that
    divides the heads, this rank's heads and inner channels."""
    nh, hd, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    g, w, di = cfg.ssm_groups, cfg.conv_width, cfg.d_inner
    if coll.shard_range(nh) is not None:
        m = coll.model_rank_and_size()[1]
        nh, di = nh // m, di // m
    shapes = {"ssd": (batch, nh, n, hd), "conv_x": (batch, w - 1, di),
              "conv_B": (batch, w - 1, g, n), "conv_C": (batch, w - 1, g, n)}
    return {k: torch.zeros(v, dtype=dtype, device=device)
            for k, v in shapes.items()}


def _ssm_decode(p, xin, cfg, state, pos):
    """Single-token SSD decode.  xin (B,1,D)."""
    b = xin.shape[0]
    nh, hd = cfg.ssm_heads, cfg.ssm_headdim
    xt = xin[:, 0]
    z, x, Bm, Cm, dt = projections(p, xt, cfg)

    cx, x = _conv_step(state["conv_x"], x, p.conv_x)
    cB, Bm = _conv_step(state["conv_B"], Bm, p.conv_B)
    cC, Cm = _conv_step(state["conv_C"], Cm, p.conv_C)
    x, Bm, Cm = F.silu(x), F.silu(Bm), F.silu(Cm)
    dt, A = _dt_and_A(p, dt, xin.dtype)

    xh = x.reshape(b, -1, hd)
    Bh = local_heads(Bm, nh, 1)                                    # (B,nh,N)
    Ch = local_heads(Cm, nh, 1)
    decay = torch.exp(dt * A[None, :])                             # (B,nh)
    s_new = (state["ssd"] * decay[..., None, None] +
             torch.einsum("bhn,bhp->bhnp", Bh, xh * dt[..., None]))
    y = torch.einsum("bhn,bhnp->bhp", Ch, s_new) + p.D[None, :, None] * xh
    y = _gated_norm(p, y.reshape(b, -1), z, cfg)
    out = shd.constrain((y @ p.out_proj)[:, None, :], "act_batch", None,
                        "act_embed", partial=split(p, cfg))
    return out, {"ssd": s_new, "conv_x": cx, "conv_B": cB, "conv_C": cC}
