"""Encoder-decoder backbone: seamless-m4t-large-v2, family "audio"
(counterpart of ``repro/models/encdec.py``).

The audio frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (B, S_src, d) (``frontends.fake_frontend``).
The encoder is a non-causal stack, roped at ``arange(S_src)``, with no
padding mask, so all requests of one batch share S_src.  The decoder is
a causal stack with cross attention into the encoder's states; its
prompts of one batch share a length too (``arange(S_tgt)``, no left-pad
handling, as in the reference).  Serving keeps the self-attention K/V
and the cross K/V, projected once by :func:`prefill`, in an
:class:`EncDecCache`.

Cross attention ropes neither its q nor the encoder's k; under every
policy but the forced library it runs the flash kernel, non-causally:
over S_tgt queries in :func:`forward_train` and :func:`prefill`, over
one query a decoder layer at every :func:`decode` step (Sq = 1 against
Sk = S_src), as the reference's ``_dec_block(precomputed_cross=True)``
does.  Parameters live in :class:`EncDec`, built from a
``torch.Generator`` (:func:`init_encdec`) or from the JAX package's tree
(:func:`params_from_numpy`; back by :func:`params_to_numpy`), with matmul
weights in the compute dtype (cast once; or a master copy's ``dtype``)
and norm weights in the parameter dtype, as ``lm.DenseLM``.
The layer stacks are Python loops; the caches are updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.api import Policy
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.common import mm, remat, rmsnorm, stack_specs

#: the families this module serves
FAMILIES = ("encdec", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not an "
                         f"enc-dec family ({', '.join(FAMILIES)})")


class EncBlock(nn.Module):
    """[non-causal attn + mlp] with optional parametric pre-norms."""

    def __init__(self, attn: lm.Attention, mlp: lm.MLP, ln1=None, ln2=None):
        super().__init__()
        self.attn, self.mlp = attn, mlp
        self.ln1, self.ln2 = lm._frozen(ln1), lm._frozen(ln2)


class DecBlock(nn.Module):
    """[causal self attn + cross attn + mlp]."""

    def __init__(self, self_attn: lm.Attention, cross_attn: lm.Attention,
                 mlp: lm.MLP, ln1=None, ln_x=None, ln2=None):
        super().__init__()
        self.self_attn, self.cross_attn, self.mlp = self_attn, cross_attn, mlp
        self.ln1, self.ln_x, self.ln2 = map(lm._frozen, (ln1, ln_x, ln2))


class EncDec(nn.Module):
    def __init__(self, embed, enc_blocks, enc_norm, dec_blocks, final_norm,
                 unembed):
        super().__init__()
        self.embed = lm._frozen(embed)              # (Vp, d)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = lm._frozen(enc_norm)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.final_norm = lm._frozen(final_norm)
        self.unembed = lm._frozen(unembed)          # (d, Vp), untied


def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype: Optional[torch.dtype] = None
                ) -> EncDec:
    """Random weights from ``generator`` (on ``device``), with the
    reference's shapes and scales (``lm._initializers``; the scales of
    wo and of the MLP's down projection count the decoder's layers, as
    the reference's do); matmul weights and the embedding in ``dtype``
    (default: the compute dtype)."""
    _check_family(cfg)
    ninit, norm, attention, mlp = lm._initializers(cfg, generator, device,
                                                   dtype)
    d, Vp = cfg.d_model, cfg.vocab_padded
    embed = ninit((Vp, d), d ** -0.5)
    enc = [EncBlock(attention(), mlp(), norm(), norm())
           for _ in range(cfg.n_encoder_layers)]
    dec = [DecBlock(attention(), attention(), mlp(), norm(), norm(), norm())
           for _ in range(cfg.n_layers)]
    return EncDec(embed, enc, norm(), dec, norm(),
                  ninit((d, Vp), 1.0 / math.sqrt(d)))


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda", dtype: Optional[torch.dtype] = None
                      ) -> EncDec:
    """The JAX package's parameters (nested dict of numpy arrays, each
    stack's layers on axis 0, ``None`` for absent norms) as the port's
    module; matmul weights and the embedding cast to ``dtype`` (default:
    the compute dtype) once, here, norm weights kept in the parameter
    dtype (``lm.params_from_numpy``)."""
    _check_family(cfg)
    t, norm = lm._loaders(cfg, device, dtype or cfg.compute_dtype)

    def attn(a, i):
        return lm.Attention(*(t(a[k][i]) for k in lm.ATTN))

    def mlp(m, i):
        return lm.MLP(*(t(m[k][i]) for k in lm.MLP_W))

    def ln(b, k, i):
        return None if b.get(k) is None else norm(b[k][i])

    e, dc = tree["enc_blocks"], tree["dec_blocks"]
    enc = [EncBlock(attn(e["attn"], i), mlp(e["mlp"], i), ln(e, "ln1", i),
                    ln(e, "ln2", i)) for i in range(cfg.n_encoder_layers)]
    dec = [DecBlock(attn(dc["self_attn"], i), attn(dc["cross_attn"], i),
                    mlp(dc["mlp"], i), ln(dc, "ln1", i), ln(dc, "ln_x", i),
                    ln(dc, "ln2", i)) for i in range(cfg.n_layers)]
    return EncDec(t(tree["embed"]), enc, norm(tree.get("enc_norm")), dec,
                  norm(tree.get("final_norm")), t(tree["unembed"]))


def params_to_numpy(params: EncDec, cfg: ModelConfig,
                    form=lm.NUMPY) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the JAX package's tree,
    each stack's layers on axis 0, its leaves drawn by ``form``
    (``lm.params_to_numpy``)."""
    _check_family(cfg)
    draw = form[0]
    e = lm._stacked(params.enc_blocks, form)
    d = lm._stacked(params.dec_blocks, form)
    return {
        "embed": draw(params.embed),
        "enc_blocks": {"attn": lm._fields(e, "attn", lm.ATTN),
                       "mlp": lm._fields(e, "mlp", lm.MLP_W),
                       "ln1": e(lambda m: m.ln1), "ln2": e(lambda m: m.ln2)},
        "enc_norm": draw(params.enc_norm),
        "dec_blocks": {"self_attn": lm._fields(d, "self_attn", lm.ATTN),
                       "cross_attn": lm._fields(d, "cross_attn", lm.ATTN),
                       "mlp": lm._fields(d, "mlp", lm.MLP_W),
                       "ln1": d(lambda m: m.ln1),
                       "ln_x": d(lambda m: m.ln_x),
                       "ln2": d(lambda m: m.ln2)},
        "final_norm": draw(params.final_norm),
        "unembed": draw(params.unembed)}


def encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every parameter, in :func:`params_to_numpy`'s
    tree (the reference's ``encdec_specs``)."""
    n = ("embed",) if cfg.parametric_norm else None
    a, m = L.attention_specs(cfg), L.mlp_specs(cfg)
    return {
        "embed": ("vocab", None),
        "enc_blocks": stack_specs({"ln1": n, "attn": a, "ln2": n, "mlp": m}),
        "enc_norm": n,
        "dec_blocks": stack_specs({"ln1": n, "self_attn": a, "ln_x": n,
                                   "cross_attn": a, "ln2": n, "mlp": m}),
        "final_norm": n,
        "unembed": (None, "vocab"),
    }


# --------------------------------------------------------------------------
# The two stacks.
# --------------------------------------------------------------------------

def encode(params: EncDec, cfg: ModelConfig, be: Policy, src_embeds):
    """src_embeds (B, S_src, d), the frontend's output -> the encoder's
    states (B, S_src, d) in the compute dtype: non-causal self-attention,
    q and k roped at ``arange(S_src)``."""
    x = src_embeds.to(cfg.compute_dtype)

    def body(x, blk):
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        x = x + L.attention(blk.attn, h, be, cfg, causal=False)[0]
        h = rmsnorm(x, blk.ln2, cfg.norm_eps)
        return x + L.mlp(blk.mlp, h, be)
    for blk in params.enc_blocks:
        x = remat(cfg, body, x, blk)
    return rmsnorm(x, params.enc_norm, cfg.norm_eps)


def _cross_kv(blk: DecBlock, enc, cfg: ModelConfig, be: Policy):
    """The cross attention's k and v (B, Hkv, S_src, hd), projected from
    the encoder's states and not roped."""
    Hkv, hd = cfg.n_kv_heads_padded, cfg.head_dim_
    return (L._split_heads(mm(enc, blk.cross_attn.wk, be), Hkv, hd),
            L._split_heads(mm(enc, blk.cross_attn.wv, be), Hkv, hd))


def _dec_block(blk: DecBlock, x, cross, cfg: ModelConfig, be: Policy, *,
               kv=None, pos: Optional[int] = None):
    """Causal self attention (over the whole prompt, or one token against
    the cache ``kv`` at ``pos``), cross attention over ``cross`` = (k, v),
    mlp.  Returns (y, the prompt's roped (k, v) without ``kv``, else
    None)."""
    h = rmsnorm(x, blk.ln1, cfg.norm_eps)
    out = L.attention(blk.self_attn, h, be, cfg, kv_cache=kv, pos=pos)
    sa, kv_out = (out, None) if kv is not None else out
    x = x + sa
    h = rmsnorm(x, blk.ln_x, cfg.norm_eps)
    x = x + L.attention(blk.cross_attn, h, be, cfg, cross_kv=cross)
    h = rmsnorm(x, blk.ln2, cfg.norm_eps)
    return x + L.mlp(blk.mlp, h, be), kv_out


def _decode_prompt(params: EncDec, cfg: ModelConfig, be: Policy, tokens,
                   src_embeds, cache: Optional["EncDecCache"] = None):
    """Encoder, then the decoder over the whole prompt tokens (B, S_tgt)
    (teacher-forced); with ``cache``, each layer's roped self K/V and its
    cross K/V are written there (self K/V into the first S_tgt slots).
    Returns the decoder's last hidden states (B, S_tgt, d)."""
    enc = encode(params, cfg, be, src_embeds)
    x = params.embed[tokens].to(cfg.compute_dtype)
    S = x.shape[1]

    def body(x, blk):
        ck, cv = _cross_kv(blk, enc, cfg, be)
        x, (k, v) = _dec_block(blk, x, (ck, cv), cfg, be)
        return x, k, v, ck, cv
    for i, blk in enumerate(params.dec_blocks):
        x, k, v, ck, cv = remat(cfg, body, x, blk)
        if cache is not None:
            cache.self_k[i, :, :, :S] = k
            cache.self_v[i, :, :, :S] = v
            cache.cross_k[i] = ck
            cache.cross_v[i] = cv
    return x


def _unembed(params: EncDec, cfg: ModelConfig, x, be: Policy):
    return mm(rmsnorm(x, params.final_norm, cfg.norm_eps), params.unembed,
              be)


def forward_train(params: EncDec, cfg: ModelConfig, be: Policy, tokens,
                  src_embeds):
    """Teacher-forced forward: tokens (B, S_tgt) after src_embeds
    (B, S_src, d) -> (logits (B, S_tgt, Vp), aux loss (a f32 scalar,
    0))."""
    x = _decode_prompt(params, cfg, be, tokens, src_embeds)
    return _unembed(params, cfg, x, be), torch.zeros(
        (), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# Serving: prefill / decode over an EncDecCache.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class EncDecCache:
    """``pos`` is the next position, a host integer (as in
    ``lm.LMCache``); the self-attention K/V buffers are linear (no
    window), zero past the positions written; the cross K/V are written
    once, by :func:`prefill`.  :func:`decode` updates the self K/V in
    place."""
    pos: int
    self_k: torch.Tensor          # (L, B, Hkv, W, hd)
    self_v: torch.Tensor
    cross_k: torch.Tensor         # (L, B, Hkv, S_src, hd)
    cross_v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, src_len: int,
               dtype=torch.bfloat16, prefill_len: int = 0,
               device="cuda") -> EncDecCache:
    """Zero cache for ``batch`` sequences of up to ``seq_len`` decoder
    positions (``prefill_len`` of them already filled) over ``src_len``
    encoder frames."""
    _check_family(cfg)
    Hkv, hd, Ld = cfg.n_kv_heads_padded, cfg.head_dim_, cfg.n_layers

    def zeros(n):
        return torch.zeros((Ld, batch, Hkv, n, hd), dtype=dtype,
                           device=device)
    return EncDecCache(prefill_len, zeros(seq_len), zeros(seq_len),
                       zeros(src_len), zeros(src_len))


def prefill(params: EncDec, cfg: ModelConfig, be: Policy, tokens,
            src_embeds, cache_len: Optional[int] = None):
    """Encode src_embeds (B, S_src, d) and run the decoder prompts tokens
    (B, S_tgt); returns (last-token logits (B, Vp), the primed cache:
    the cross K/V of every layer, projected once here, and the self K/V
    zero-padded to ``cache_len`` positions, default S_tgt)."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len or S, src_embeds.shape[1],
                       cfg.compute_dtype, prefill_len=S,
                       device=tokens.device)
    x = _decode_prompt(params, cfg, be, tokens, src_embeds, cache)
    return _unembed(params, cfg, x[:, -1:], be)[:, 0], cache


def decode(params: EncDec, cfg: ModelConfig, be: Policy, tokens,
           cache: EncDecCache):
    """One-token step, tokens (B, 1): each decoder layer writes its self
    K/V into the cache in place and attends the cached cross K/V (the
    flash kernel at Sq = 1 under every policy but the forced library);
    returns (logits (B, Vp), the cache at pos + 1)."""
    x = params.embed[tokens].to(cfg.compute_dtype)
    for i, blk in enumerate(params.dec_blocks):
        x, _ = _dec_block(blk, x, (cache.cross_k[i], cache.cross_v[i]), cfg,
                          be, kv=(cache.self_k[i], cache.self_v[i]),
                          pos=cache.pos)
    return _unembed(params, cfg, x, be)[:, 0], dataclasses.replace(
        cache, pos=cache.pos + 1)
