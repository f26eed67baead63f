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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

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


def _project_qkv(p, xq, xkv, cfg, q_positions, kv_positions,
                 rope: bool = True):
    q = _proj_heads(xq, p.wq)
    k = _proj_heads(xkv, p.wk)
    v = _proj_heads(xkv, p.wv)
    if p.has("q_norm"):
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
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
    q = shd.constrain(q, "act_batch", None, "act_heads", None)
    k = torch.repeat_interleave(k, h // kvh, dim=2)
    v = torch.repeat_interleave(v, h // kvh, dim=2)
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


def attn_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (train / prefill)."""
    heads = _heads_shardable(cfg)
    if heads:
        x = shd.constrain(x, "act_batch", None, "act_embed")
    q, k, v = _project_qkv(p, x, x, cfg, positions, positions)
    attend = repeated_heads_attention if heads else grouped_attention
    out = attend(q, k, v, q_positions=positions, kv_positions=positions,
                 causal=causal, cfg=cfg)
    return _out_proj(out, p.wo)


def cross_attn_forward(p, x: torch.Tensor,
                       enc_kv: Tuple[torch.Tensor, torch.Tensor], cfg,
                       enc_positions: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (no RoPE)."""
    sq = x.shape[1]
    q = _proj_heads(x, p.wq)
    k, v = enc_kv
    out = grouped_attention(
        q, k, v, q_positions=torch.arange(sq, device=x.device),
        kv_positions=enc_positions, causal=False, cfg=cfg)
    return _out_proj(out, p.wo)


def cross_kv(p, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _proj_heads(enc_out, p.wk), _proj_heads(enc_out, p.wv)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """One layer's zeroed KV cache, k and v each (B, Smax, KV, dh)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg,
                pos: int):
    """One-token decode.  x (B,1,D); cache k/v (B,Smax,KV,dh); pos an int.
    Writes K/V at ``pos`` into the cache IN PLACE (the JAX package returns a
    new cache; the port saves the copy) and returns (y, cache)."""
    smax = cache["k"].shape[1]
    if not 0 <= pos < smax:
        raise IndexError(f"attn_decode: pos {pos} outside the cache's "
                         f"{smax} positions")
    qpos = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, cfg, qpos, qpos)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    idx = torch.arange(smax, device=x.device)
    kv_positions = torch.where(idx <= pos, idx, -1)
    out = grouped_attention(q, cache["k"], cache["v"], q_positions=qpos,
                            kv_positions=kv_positions, causal=False, cfg=cfg)
    return _out_proj(out, p.wo), cache
