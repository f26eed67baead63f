"""Model assembly: decoder-only LMs (dense / MoE / SSM / hybrid) and the
encoder-decoder (audio) variant; forward, the training loss, prefill and
decode (the JAX package's ``models/transformer.py``).

The layer stack is a Python loop over ``p.decoder``, an ``nn.ModuleList``
with one module per layer.  ``cfg.remat`` checkpoints every layer when
autograd records (``torch.utils.checkpoint``, non-reentrant): the JAX
package checkpoints each one-layer scan unit, and each layer inside a
superblock (``blocks.py``), so per layer is what both do.  A checkpointed
layer keeps only its input; backward runs it again.  No layer draws
random numbers, so the RNG state is not saved; the MoE router's ``topk``
sees the same logits twice and drops the same tokens.  The JAX package's
``unroll_stack`` shapes XLA's program, not the function, and has no
counterpart here.

Decode state (``init_cache``) is a dict: ``"layers"``, one dict per decoder
layer (``k``/``v`` of (B, max_len, KV, dh) for attention, ``ssd`` /
``conv_x`` / ``conv_B`` / ``conv_C`` for SSD); for the encoder-decoder also
``"enc_k"`` / ``"enc_v"`` (one (B, max_len, KV, dh) tensor per layer, the
encoder's K/V zero-padded to max_len) and ``"enc_len"`` (an int).
``decode_step`` updates it in place and returns it.  Where the active
'model' axis divides ``max_len`` the attention layers hold this rank's
slice of the sequence and the cache says so (``"kv_split": True``;
``attention.py``).

Over a 'model' axis the residual stream between blocks stays replicated
(the JAX package shards its sequence: ``transformer.py:82``,
``blocks.py:63``; ROADMAP §3); every block joins its partial sums before
the residual add.  ``forward`` returns the whole vocab (an all-gather of
the head's slices); ``train_loss`` takes the cross-entropy on this rank's
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import sharding as shd
from .attention import _project_qkv, cross_kv, kv_split, write_kv
from .blocks import layer_cache, layer_decode, layer_forward, layer_kinds
from .blocks import stack_specs
from .common import (ParamSpec, embed_specs, embed_tokens, lm_logits, rmsnorm,
                     softmax_xent, vocab_start)
from .config import ModelConfig
from .ssm import _causal_conv, _dt_and_A, local_heads, ssd_scan
from .ssm import projections as ssm_projections


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = dict(embed_specs(cfg))
    specs["decoder"] = stack_specs(cfg, cross=cfg.encdec)
    if cfg.encdec:
        specs["enc_in_proj"] = ParamSpec((cfg.frontend_dim, cfg.d_model),
                                         (None, "embed"))
        specs["encoder"] = stack_specs(_enc_cfg(cfg))
        specs["enc_norm"] = ParamSpec((cfg.d_model,), ("norm",), init="ones")
    return specs


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers, encdec=False,
                               superblock=0, attn_every=0, n_experts=0)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _encode(p, frames: torch.Tensor, cfg) -> torch.Tensor:
    """Stubbed modality frontend: precomputed frame embeddings in, encoder
    hidden states out."""
    enc_cfg = _enc_cfg(cfg)
    x = frames.to(p.enc_in_proj.dtype) @ p.enc_in_proj
    x = shd.constrain(x, "act_batch", "act_seq", "act_embed")
    positions = torch.arange(frames.shape[1], device=x.device)
    for layer, (kind, mlp_kind) in zip(p.encoder, layer_kinds(enc_cfg)):
        x = _remat(cfg, layer_forward, layer, x, enc_cfg, kind, mlp_kind,
                   positions, causal=False)
    return rmsnorm(x, p.enc_norm, cfg.norm_eps)


def _remat(cfg, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, checkpointed when ``cfg.remat`` and autograd
    records (see the module docstring)."""
    if cfg.remat and torch.is_grad_enabled():
        # the recompute runs in backward: inside this forward's context
        return checkpoint(shd.bound(fn), *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn(*args, **kwargs)


def _decoder_layer(layer, x, cfg, kind, mlp_kind, positions, enc_out,
                   enc_positions):
    """One decoder layer; the cross-attention K/V from ``enc_out`` inside
    it, so that a checkpoint keeps ``enc_out`` and not every layer's K/V."""
    enc_kv = None if enc_out is None else cross_kv(layer.cross, enc_out)
    return layer_forward(layer, x, cfg, kind, mlp_kind, positions,
                         causal=True, enc_kv=enc_kv,
                         enc_positions=enc_positions)


def _encoder_out(p, frames, cfg):
    if not cfg.encdec:
        return None, None
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass frames")
    enc_out = _encode(p, frames, cfg)
    return enc_out, torch.arange(enc_out.shape[1], device=enc_out.device)


def forward(p, tokens: torch.Tensor, cfg,
            frames: Optional[torch.Tensor] = None,
            gather: bool = True) -> torch.Tensor:
    """tokens (B,S) -> logits (B,S,Vpad).  ``frames`` feeds the encoder of
    the enc-dec arch (stub frontend).  ``gather=False`` leaves the logits
    as this rank's vocab slice where the head is split."""
    x = embed_tokens(p, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    enc_out, enc_positions = _encoder_out(p, frames, cfg)
    for layer, (kind, mlp_kind) in zip(p.decoder, layer_kinds(cfg)):
        x = _remat(cfg, _decoder_layer, layer, x, cfg, kind, mlp_kind,
                   positions, enc_out, enc_positions)
    return lm_logits(p, x, cfg, gather=gather)


def train_loss(p, batch: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
    logits = forward(p, batch["tokens"], cfg, frames=batch.get("frames"),
                     gather=False)
    return softmax_xent(logits, batch["labels"], cfg.vocab_size,
                        vocab_start=vocab_start(p))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
               device) -> Dict[str, Any]:
    cache: Dict[str, Any] = {"layers": [
        layer_cache(cfg, kind, batch, max_len, dtype, device)
        for kind, _ in layer_kinds(cfg)]}
    if kv_split(max_len):
        cache["kv_split"] = True
    if cfg.encdec:
        shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
        for key in ("enc_k", "enc_v"):
            cache[key] = [torch.zeros(shape, dtype=dtype, device=device)
                          for _ in range(cfg.n_layers)]
        cache["enc_len"] = 0
    return cache


def prefill(p, tokens: torch.Tensor, cfg, max_len: int,
            frames: Optional[torch.Tensor] = None):
    """Run the full prompt; return (last-token logits (B,1,Vpad), the
    populated cache).  Each layer's K/V (or SSD state) is captured from its
    ln1-normed input, then the layer runs as in ``forward``."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prefill: prompt of {s} tokens > max_len {max_len}")
    x = embed_tokens(p, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, x.dtype, x.device)
    enc_out, enc_positions = _encoder_out(p, frames, cfg)
    if enc_out is not None and enc_out.shape[1] > max_len:
        raise ValueError(f"prefill: {enc_out.shape[1]} encoder frames > "
                         f"max_len {max_len}")

    for i, (layer, (kind, mlp_kind)) in enumerate(
            zip(p.decoder, layer_kinds(cfg))):
        hn = rmsnorm(x, layer.ln1, cfg.norm_eps)
        lc = cache["layers"][i]
        if kind == "attn":
            _, k, v = _project_qkv(layer.attn, hn, hn, cfg, positions,
                                   positions)
            write_kv(lc, k, v, 0, cache.get("kv_split", False))
        else:
            cache["layers"][i] = _capture_ssm_state(layer.ssm, hn, cfg, lc)
        enc_kv = None
        if enc_out is not None:
            enc_kv = cross_kv(layer.cross, enc_out)
            pad = max_len - enc_out.shape[1]
            cache["enc_k"][i] = F.pad(enc_kv[0], (0, 0, 0, 0, 0, pad))
            cache["enc_v"][i] = F.pad(enc_kv[1], (0, 0, 0, 0, 0, pad))
        x = layer_forward(layer, x, cfg, kind, mlp_kind, positions,
                          causal=True, enc_kv=enc_kv,
                          enc_positions=enc_positions)
    if enc_out is not None:
        cache["enc_len"] = enc_out.shape[1]
    return lm_logits(p, x[:, -1:, :], cfg), cache


def _capture_ssm_state(p, xin, cfg, lcache):
    """Recompute the SSD state at end-of-prompt for the decode cache.
    ``xin`` is the ln1-normed layer input (identical to ssm_forward's)."""
    b, s, _ = xin.shape
    _, x, Bm, Cm, dt = ssm_projections(p, xin, cfg)

    def conv_tail(t):  # last (W-1) raw inputs, left-padded for short prompts
        w1 = cfg.conv_width - 1
        padded = torch.cat([t.new_zeros((b, w1) + t.shape[2:]), t], dim=1)
        return padded[:, t.shape[1]:]

    cx, cB, cC = conv_tail(x), conv_tail(Bm), conv_tail(Cm)
    x = F.silu(_causal_conv(x, p.conv_x))
    Bm = F.silu(_causal_conv(Bm, p.conv_B))
    Cm = F.silu(_causal_conv(Cm, p.conv_C))
    dt, A = _dt_and_A(p, dt, xin.dtype)
    nh, hd = cfg.ssm_heads, cfg.ssm_headdim
    xh = x.reshape(b, s, -1, hd)
    _, s_final = ssd_scan(xh, dt, A, local_heads(Bm, nh, 2),
                          local_heads(Cm, nh, 2), cfg.ssm_chunk)
    return {"ssd": s_final.to(lcache["ssd"].dtype),
            "conv_x": cx.to(lcache["conv_x"].dtype),
            "conv_B": cB.to(lcache["conv_B"].dtype),
            "conv_C": cC.to(lcache["conv_C"].dtype)}


def decode_step(p, cache: Dict[str, Any], token: torch.Tensor, pos: int, cfg):
    """One decode step.  token (B,1) integer; pos an int.  Returns
    (logits (B,1,Vpad), the cache, updated in place)."""
    x = embed_tokens(p, token, cfg)
    enc_positions = None
    if cfg.encdec:
        idx = torch.arange(cache["enc_k"][0].shape[1], device=x.device)
        enc_positions = torch.where(idx < cache["enc_len"], idx, -1)
    for i, (layer, (kind, mlp_kind)) in enumerate(
            zip(p.decoder, layer_kinds(cfg))):
        enc_kv = None
        if cfg.encdec:
            enc_kv = (cache["enc_k"][i], cache["enc_v"][i])
        x, cache["layers"][i] = layer_decode(
            layer, x, cfg, kind, mlp_kind, cache["layers"][i], pos,
            enc_kv=enc_kv, enc_positions=enc_positions,
            split=cache.get("kv_split", False))
    return lm_logits(p, x, cfg), cache
