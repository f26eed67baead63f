"""GQA attention: qk-norm, RoPE, q-blocked softmax, a preallocated KV cache
for decode, and cross-attention for the encoder-decoder arch (the JAX
package's ``models/attention.py``).

Plain PyTorch, as the JAX package's is plain ``jnp``: no Pallas kernel lies
on this path.  The q axis is cut into blocks of ``cfg.attn_block_q`` (one
block when the length does not divide), so the score tile is
(B, KV, G, q_block, S_kv) and never S x S.  Scores and softmax are float32;
masked scores are -1e30.

Under an active sharding context (``parallel.sharding.sharding_ctx``)
whose 'model' axis divides ``n_heads``, and unless ``force_kv_seq_attn``,
``attn_forward`` takes the JAX package's 'heads' strategy
(``repeated_heads_attention``: K/V repeated to all H heads) exactly where
that package does; everywhere else the grouped one.  On a 1 x 1 mesh that
is arctic-480b, llama4-maverick-400b-a17b and starcoder2-7b.  The two
compute the same function.

Over a 'model' axis above 1 (tensor parallelism): ``wq`` and ``wo`` hold
this rank's q heads wherever the axis divides ``n_heads``; ``wk`` and
``wv`` (``kv_heads``: None) stay whole, so every rank projects every K/V
head and keeps the ones its q heads read.  The output projection's partial
sums meet in one all-reduce.  Decode splits the KV cache's sequence over
'model' wherever the axis divides ``max_len`` (split-KV, flash-decoding
style, the JAX package's ``kv_cache_logical``): each rank holds
``max_len / M`` positions, the q heads are gathered, and the softmax's
max, its sum and the weighted values are all-reduced.  Train and prefill
attend by heads for every arch, where the JAX package lets GSPMD split
the KV sequence for the ``force_kv_seq_attn`` archs: the same function,
and the residual stream stays replicated (ROADMAP §3).  The encoder-decoder's
cross-attention cache stays whole.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..parallel import collectives as coll
from ..parallel import sharding as shd
from .common import ParamSpec, apply_rope, rmsnorm


def attn_specs(cfg, cross: bool = False) -> Dict[str, ParamSpec]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    specs = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm and not cross:
        specs["q_norm"] = ParamSpec((dh,), ("norm",), init="ones")
        specs["k_norm"] = ParamSpec((dh,), ("norm",), init="ones")
    return specs


def _heads_shardable(cfg) -> bool:
    if not shd.active() or cfg.force_kv_seq_attn:
        return False
    return cfg.n_heads % shd.active_mesh_shape().get("model", 1) == 0


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dnk->bsnk', x, w)."""
    d, n, k = w.shape
    return (x @ w.reshape(d, n * k)).unflatten(-1, (n, k))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd', out, wo)."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * k, d)


def _split(p) -> bool:
    """Whether this rank holds a slice of the q heads (``wq``/``wo``)."""
    return p.shard_dim("wq") is not None


def _project_qkv(p, xq, xkv, cfg, q_positions, kv_positions,
                 rope: bool = True):
    """q of this rank's heads; k and v of every KV head."""
    split = _split(p)
    q = _proj_heads(coll.copy_to_model(xq) if split else xq, p.wq)
    k = _proj_heads(xkv, p.wk)
    v = _proj_heads(xkv, p.wv)
    if p.has("q_norm"):
        q_norm = coll.copy_to_model(p.q_norm) if split else p.q_norm
        q = rmsnorm(q, q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _sdpa_block(qb, k, v, q_pos_b, kv_pos, causal: bool, scale: float):
    """One q-block of grouped attention.  qb (B,Q,KV,G,dh); k/v (B,S,KV,dh)."""
    scores = (torch.einsum("bqkgd,bskd->bkgqs", qb, k) * scale).float()
    if causal:
        mask = q_pos_b[:, None] >= kv_pos[None, :]              # (Q, S)
    else:
        mask = (kv_pos >= 0)[None, :]                           # padding mask
    scores = scores.masked_fill_(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def grouped_attention(q, k, v, *, q_positions, kv_positions, causal: bool,
                      cfg) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Skv,KV,dh) -> (B,Sq,H,dh); loops over q blocks
    where the JAX package scans them."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = dh ** -0.5
    qg = q.reshape(b, sq, kvh, g, dh)

    blk = min(cfg.attn_block_q, sq)
    if sq % blk != 0:
        blk = sq  # tiny/ragged: single block
    nblk = sq // blk

    if nblk == 1:
        qp = q_positions[0] if q_positions.dim() > 1 else q_positions
        out = _sdpa_block(qg, k, v, qp, kv_positions, causal, scale)
        return out.reshape(b, sq, h, dh)

    qpos = q_positions.reshape(nblk, blk)
    outs = [_sdpa_block(qg[:, j * blk:(j + 1) * blk], k, v, qpos[j],
                        kv_positions, causal, scale) for j in range(nblk)]
    return torch.cat(outs, dim=1).reshape(b, sq, h, dh)


def repeated_heads_attention(q, k, v, *, q_positions, kv_positions,
                             causal: bool, cfg) -> torch.Tensor:
    """The 'heads' strategy: K/V repeated to H heads (the JAX package
    shards those heads over 'model'); q blocks as in
    ``grouped_attention``.  Causal masking only, as there."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    k = shd.constrain(k, "act_batch", None, None, None)
    v = shd.constrain(v, "act_batch", None, None, None)
    q = shd.constrain(q, "act_batch", None, "act_heads", None, shard=2)
    # to every head of the model (q may hold this rank's heads only)
    k = torch.repeat_interleave(k, cfg.n_heads // kvh, dim=2)
    v = torch.repeat_interleave(v, cfg.n_heads // kvh, dim=2)
    k = shd.constrain(k, "act_batch", None, "act_heads", None)
    v = shd.constrain(v, "act_batch", None, "act_heads", None)
    scale = dh ** -0.5

    blk = min(cfg.attn_block_q, sq)
    if sq % blk != 0:
        blk = sq
    nblk = sq // blk

    def block(qb, qp):
        scores = (torch.einsum("bqhd,bshd->bhqs", qb, k) * scale).float()
        if causal:
            mask = qp[:, None] >= kv_positions[None, :]
            scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhqs,bshd->bqhd", probs, v)

    if nblk == 1:
        return block(q, q_positions)
    qpos = q_positions.reshape(nblk, blk)
    return torch.cat([block(q[:, j * blk:(j + 1) * blk], qpos[j])
                      for j in range(nblk)], dim=1)


def _local_kv(p, cfg, k: torch.Tensor, v: torch.Tensor):
    """The K/V heads (dim 2) this rank's q heads read, where it holds a
    slice of them; k and v as they are elsewhere."""
    if not _split(p):
        return k, v
    _, start, n = p.slices["wq"]
    g = cfg.n_heads // k.shape[2]
    if n % g and g % n:
        raise ValueError(f"{cfg.name}: {n} q heads a rank straddle KV groups "
                         f"of {g}")
    lo, hi = start // g, (start + n - 1) // g + 1
    return (coll.narrow_from_model(k, 2, lo, hi - lo),
            coll.narrow_from_model(v, 2, lo, hi - lo))


def _attn_out(p, out: torch.Tensor) -> torch.Tensor:
    """The output projection; one all-reduce where the heads are split."""
    y = _out_proj(out, p.wo)
    return shd.constrain(y, "act_batch", "act_seq", "act_embed",
                         partial=_split(p))


def attn_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (train / prefill)."""
    heads = _heads_shardable(cfg)
    if heads:
        x = shd.constrain(x, "act_batch", None, "act_embed")
    q, k, v = _project_qkv(p, x, x, cfg, positions, positions)
    if heads:
        out = repeated_heads_attention(
            q, k, v, q_positions=positions, kv_positions=positions,
            causal=causal, cfg=cfg)
    else:
        k, v = _local_kv(p, cfg, k, v)
        out = grouped_attention(q, k, v, q_positions=positions,
                                kv_positions=positions, causal=causal,
                                cfg=cfg)
    return _attn_out(p, out)


def cross_attn_forward(p, x: torch.Tensor,
                       enc_kv: Tuple[torch.Tensor, torch.Tensor], cfg,
                       enc_positions: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (no RoPE)."""
    sq = x.shape[1]
    q = _proj_heads(coll.copy_to_model(x) if _split(p) else x, p.wq)
    k, v = _local_kv(p, cfg, *enc_kv)
    out = grouped_attention(
        q, k, v, q_positions=torch.arange(sq, device=x.device),
        kv_positions=enc_positions, causal=False, cfg=cfg)
    return _attn_out(p, out)


def cross_kv(p, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _proj_heads(enc_out, p.wk), _proj_heads(enc_out, p.wv)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def kv_split(max_len: int) -> bool:
    """Whether a cache of ``max_len`` positions splits its sequence over
    the active 'model' axis (``act_kv_seq``: where the axis divides it)."""
    return coll.shard_range(max_len) is not None


def init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """One layer's zeroed KV cache, k and v each (B, Smax, KV, dh); over a
    'model' axis that divides Smax, this rank's Smax / M positions."""
    m = coll.model_rank_and_size()[1] if kv_split(max_len) else 1
    shape = (batch, max_len // m, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_kv(cache: Dict[str, torch.Tensor], k: torch.Tensor,
             v: torch.Tensor, pos: int, split: bool) -> None:
    """Write K/V (B, S, KV, dh) for positions [pos, pos + S) into the
    cache, in place; a split cache takes the positions it holds."""
    s, n = k.shape[1], cache["k"].shape[1]
    start = coll.model_rank_and_size()[0] * n if split else 0
    lo, hi = max(pos, start), min(pos + s, start + n)
    if lo < hi:
        cache["k"][:, lo - start:hi - start] = \
            k[:, lo - pos:hi - pos].to(cache["k"].dtype)
        cache["v"][:, lo - start:hi - start] = \
            v[:, lo - pos:hi - pos].to(cache["v"].dtype)


def _split_kv_attention(q, k, v, kv_positions, cfg) -> torch.Tensor:
    """One query position over a cache whose sequence is split over
    'model' (no autograd: decode).  q (B,1,H,dh) every head; k/v this
    rank's (B,L,KV,dh); kv_positions (L,) global, -1 where masked.  The
    softmax of the whole sequence: its max and its sum are all-reduced,
    then the weighted values."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    scores = (torch.einsum("bqkgd,bskd->bkgqs", qg, k) * dh ** -0.5).float()
    scores = scores.masked_fill_((kv_positions < 0)[None, None, None, None],
                                 -1e30)
    mx = coll.all_reduce(scores.amax(dim=-1, keepdim=True),
                         op=torch.distributed.ReduceOp.MAX)
    e = torch.exp(scores - mx)
    probs = (e / coll.all_reduce(e.sum(dim=-1, keepdim=True))).to(v.dtype)
    out = coll.all_reduce(torch.einsum("bkgqs,bskd->bqkgd", probs, v))
    return out.reshape(b, sq, h, dh)


def attn_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg,
                pos: int, split: bool = False):
    """One-token decode.  x (B,1,D); cache k/v (B,Smax,KV,dh); pos an int.
    Writes K/V at ``pos`` into the cache IN PLACE (the JAX package returns a
    new cache; the port saves the copy) and returns (y, cache).  ``split``:
    the cache holds this rank's slice of the sequence (``kv_split``)."""
    n = cache["k"].shape[1]
    r, m = coll.model_rank_and_size()
    smax = n * m if split else n
    if not 0 <= pos < smax:
        raise IndexError(f"attn_decode: pos {pos} outside the cache's "
                         f"{smax} positions")
    qpos = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, cfg, qpos, qpos)
    write_kv(cache, k_new, v_new, pos, split)
    idx = torch.arange(n, device=x.device) + (r * n if split else 0)
    kv_positions = torch.where(idx <= pos, idx, -1)
    if split:
        q = shd.constrain(q, "act_batch", None, None, None,
                          shard=2 if _split(p) else None)
        out = _split_kv_attention(q, cache["k"], cache["v"], kv_positions,
                                  cfg)
        out = shd.constrain(out, "act_batch", None, "act_heads", None)
    else:
        k, v = _local_kv(p, cfg, cache["k"], cache["v"])
        out = grouped_attention(q, k, v, q_positions=qpos,
                                kv_positions=kv_positions, causal=False,
                                cfg=cfg)
    return _attn_out(p, out), cache
