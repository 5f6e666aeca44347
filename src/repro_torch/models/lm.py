"""Decoder-only LM, every decoder-only family of the reference: the wave
serving path (:func:`prefill`, :func:`decode` over an :class:`LMCache`),
the paged serving path (:func:`paged_prefill`, :func:`paged_decode` over
a :class:`PagedState`) and :func:`forward_train` over whole sequences
(counterpart of ``repro/models/lm.py``).

Family wiring, as the reference's:
  dense / vlm   [attn + mlp] blocks; attention full, swa or local:global.
  moe           [attn + moe] blocks.
  ssm           [mamba] blocks.
  hybrid        [mamba] blocks plus ONE shared [attn + mlp] block
                (zamba2) applied before layer ``i`` wherever
                ``i % shared_attn_every == 0``; its weights are shared,
                its K/V are kept per application.
A VLM (internvl2) takes its stub frontend's output as ``prefix_embeds``,
concatenated before the tokens.  Attention heads padded for sharding
(``head_pad_multiple``) are dead heads with zero weights: they add
exactly 0, and a dead q head reads a dead KV head.

Parameters live in :class:`DenseLM`, an ``nn.Module`` built either from a
``torch.Generator`` (:func:`init_lm`) or from the JAX package's parameter
tree (:func:`params_from_numpy`), and carried back to that tree by
:func:`params_to_numpy`.  Matmul weights are stored in the compute dtype,
cast once at load (see ``common.mm``), or in another ``dtype`` given at
construction (the trainer's f32 master copy); norm weights keep the
parameter dtype, as the reference's ``rmsnorm`` widens them to f32, and
the MoE router stays f32, as the reference's does.

The layer stack is a Python loop over layers in place of ``lax.scan``,
so the reference's per-layer ``lax.cond`` between a local and a global
layer becomes a Python choice (:func:`_window_for_layer`).  The KV caches
and pools are one stacked tensor per K and V, updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.api import Policy
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.common import mm, remat, rmsnorm, stack_specs
from repro_torch.parallel import rules as R
from repro_torch.parallel import spmd
from repro_torch.parallel.ctx import constrain


def _frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_frozen, (wq, wk, wv, wo))


class MLP(nn.Module):
    def __init__(self, wg, wu, wd):
        super().__init__()
        self.wg, self.wu, self.wd = map(_frozen, (wg, wu, wd))


class MoE(nn.Module):
    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = map(
            _frozen, (router, w_gate, w_up, w_down))


class Block(nn.Module):
    """[attn + mlp] or [attn + moe] with optional parametric pre-norms."""

    def __init__(self, attn: Attention, mlp: Optional[MLP], ln1=None,
                 ln2=None, moe: Optional[MoE] = None):
        super().__init__()
        self.attn, self.mlp, self.moe = attn, mlp, moe
        self.ln1, self.ln2 = _frozen(ln1), _frozen(ln2)


class MambaBlock(nn.Module):
    """[mamba] with its parametric pre-norm (the ssm family)."""

    def __init__(self, mixer: SSM.Mamba, ln1=None):
        super().__init__()
        self.mixer = mixer
        self.ln1 = _frozen(ln1)


class DenseLM(nn.Module):
    def __init__(self, embed, blocks, final_norm=None, unembed=None,
                 shared: Optional[Block] = None):
        super().__init__()
        self.embed = _frozen(embed)                # (Vp, d)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _frozen(final_norm)
        self.unembed = _frozen(unembed)            # (d, Vp) when untied
        self.shared = shared                       # hybrid: [attn + mlp]


# --------------------------------------------------------------------------
# Construction.
# --------------------------------------------------------------------------

#: the families this module serves (the reference's decoder-only ones)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(decoder-only families only: {', '.join(FAMILIES)})")


def _recurrent(cfg: ModelConfig) -> bool:
    """Mamba blocks (the ssm and hybrid families)."""
    return cfg.family in ("ssm", "hybrid")


def _n_shared_apps(cfg: ModelConfig) -> int:
    """How often the hybrid's shared block is applied: ceil(L / every)."""
    return -(cfg.n_layers // -cfg.shared_attn_every) \
        if cfg.shared_attn_every else 0


def _shared_app(cfg: ModelConfig, i: int) -> Optional[int]:
    """The shared block's application index before layer ``i``, or None
    where it is not applied."""
    e = cfg.shared_attn_every
    return i // e if e and i % e == 0 else None


def _initializers(cfg: ModelConfig, generator: torch.Generator, device,
                  dtype: Optional[torch.dtype] = None):
    """(ninit, norm, attention, mlp): draw a weight, a norm weight (None
    for a non-parametric norm), an :class:`Attention` or an :class:`MLP`
    from ``generator`` on ``device``, with the reference's shapes and
    scales (``ninit``: f32 normal times a scale, then the cast to
    ``dtype``, default the compute dtype); shared with
    ``encdec.init_encdec``."""
    cdt, pdt = dtype or cfg.compute_dtype, cfg.param_torch_dtype

    def ninit(shape, scale, dtype=cdt):
        # drawn in f32 one tensor at a time, then cast: the largest
        # temporary is one f32 weight
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    d, H, Hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim_, cfg.d_ff)
    Hp, Hkvp = cfg.n_heads_padded, cfg.n_kv_heads_padded
    s = 1.0 / math.sqrt(d)
    # the ssm family has no attention or MLP (H = ff = 0): no such scales;
    # wo's scale counts the live heads only, as the reference's
    so = 1.0 / math.sqrt(H * hd or 1) / math.sqrt(2.0 * cfg.n_layers)
    sd = 1.0 / math.sqrt(ff or 1) / math.sqrt(2.0 * cfg.n_layers)

    def norm():
        return torch.ones(d, dtype=pdt, device=device) \
            if cfg.parametric_norm else None

    def attention():
        # dead (padding) heads: zero columns of wq, wk, wv past the live
        # heads and zero rows of wo (``init_attention``)
        def cols(w, n):
            return F.pad(w, (0, n - w.shape[1]))
        return Attention(cols(ninit((d, H * hd), s), Hp * hd),
                         cols(ninit((d, Hkv * hd), s), Hkvp * hd),
                         cols(ninit((d, Hkv * hd), s), Hkvp * hd),
                         F.pad(ninit((H * hd, d), so),
                               (0, 0, 0, (Hp - H) * hd)))

    def mlp():
        return MLP(ninit((d, ff), s), ninit((d, ff), s), ninit((ff, d), sd))

    return ninit, norm, attention, mlp


def init_lm(cfg: ModelConfig, generator: torch.Generator, device="cuda",
            dtype: Optional[torch.dtype] = None) -> DenseLM:
    """Random weights from ``generator`` (on ``device``), with the
    reference's shapes and scales (:func:`_initializers`); matmul, expert
    and embedding weights in ``dtype`` (default: the compute dtype; the
    same draws whatever it is)."""
    _check_family(cfg)
    ninit, norm, attention, mlp = _initializers(cfg, generator, device,
                                                dtype)
    d = cfg.d_model
    blocks = []
    for _ in range(cfg.n_layers):
        if _recurrent(cfg):
            blocks.append(MambaBlock(SSM.init_mamba(cfg, ninit, generator,
                                                    device), norm()))
        elif cfg.family == "moe":
            blocks.append(Block(attention(), None, norm(), norm(),
                                MoE(*L.init_moe(cfg, ninit))))
        else:
            blocks.append(Block(attention(), mlp(), norm(), norm()))
    shared = Block(attention(), mlp(), norm(), norm()) \
        if cfg.shared_attn_every else None
    unembed = None if cfg.tie_embeddings else \
        ninit((d, cfg.vocab_padded), 1.0 / math.sqrt(d))
    return DenseLM(ninit((cfg.vocab_padded, d), d ** -0.5), blocks, norm(),
                   unembed, shared)


def _loaders(cfg: ModelConfig, device, dtype: torch.dtype):
    """(t, norm): a numpy array (or None) as a tensor on ``device`` in
    ``dtype`` (``t(a, dt)`` in another), and a norm weight (or None) in
    the parameter dtype; shared with ``encdec.params_from_numpy``."""
    def t(a, dt=dtype):
        if a is None:
            return None
        if spmd.is_dtensor(a):           # a sharded restore's leaf
            return a.to(dtype=dt)
        a = torch.from_numpy(np.array(a, dtype=np.float32))   # a copy
        return a.to(device=device, dtype=dt)

    def norm(a):
        return None if a is None else t(a, cfg.param_torch_dtype)
    return t, norm


#: a layer's weights by kind, in the reference's tree
ATTN = ("wq", "wk", "wv", "wo")
MLP_W = ("wg", "wu", "wd")
MOE_W = ("router", "w_gate", "w_up", "w_down")


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda", dtype: Optional[torch.dtype] = None
                      ) -> DenseLM:
    """The JAX package's parameters (nested dict of numpy arrays, layers
    stacked on axis 0, ``None`` for absent norms; attention weights in
    their padded shapes, the hybrid's ``shared`` block unstacked) as the
    port's module.
    Matmul weights, expert weights and the embedding are cast to
    ``dtype`` (default: the compute dtype) once, here, as ``_expert_ffn``
    casts the experts at use in the reference; norm weights keep their
    dtype and the MoE router stays f32.  A mamba mixer's ``conv_w``,
    ``conv_b`` and ``norm_w`` keep the parameter dtype and its
    ``A_log``, ``D``, ``dt_bias`` stay f32 (``ssm.MATMUL``, ``ssm.F32``)."""
    _check_family(cfg)
    dtype = dtype or cfg.compute_dtype
    t, norm = _loaders(cfg, device, dtype)

    def block(b, at=lambda a: a):
        """One [attn + mlp/moe] block of tree ``b``, its arrays cut by
        ``at`` (layer ``i`` of the stack; the shared block is unstacked)."""
        def get(*keys):
            a = b
            for k in keys:
                a = a.get(k) if a is not None else None
            return None if a is None else at(a)
        attn = Attention(*(t(get("attn", k)) for k in ATTN))
        mlp = moe = None
        if "moe" in b:
            moe = MoE(t(get("moe", "router"), torch.float32),
                      *(t(get("moe", k)) for k in MOE_W[1:]))
        else:
            mlp = MLP(*(t(get("mlp", k)) for k in MLP_W))
        return Block(attn, mlp, norm(get("ln1")), norm(get("ln2")), moe)

    b = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        if _recurrent(cfg):
            ln1 = b["ln1"][i] if b.get("ln1") is not None else None
            mx = b["mixer"]
            mixer = SSM.Mamba(**{
                k: t(mx[k][i], dtype if k in SSM.MATMUL else torch.float32
                     if k in SSM.F32 else cfg.param_torch_dtype)
                for k in SSM.PARAMS})
            blocks.append(MambaBlock(mixer, norm(ln1)))
        else:
            blocks.append(block(b, lambda a, i=i: a[i]))
    shared = block(tree["shared"]) if cfg.shared_attn_every else None
    return DenseLM(t(tree["embed"]), blocks, norm(tree.get("final_norm")),
                   t(tree.get("unembed")), shared)


def to_host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """A tensor (or None) as a numpy copy on the host; bf16 and f16 come
    back widened to f32 (numpy has no bf16).  A DTensor is gathered whole
    first (a collective: every rank calls it)."""
    if t is None:
        return None
    t = t.detach()
    if spmd.is_dtensor(t):
        t = t.full_tensor()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.to("cpu", copy=True).numpy()


#: how :func:`params_to_numpy` draws a leaf and stacks a layer stack
NUMPY = (to_host, np.stack)


def _stacked(mods, form=NUMPY):
    """``leaf(get)``: ``get(m)`` of every module ``m`` of ``mods``, drawn
    and stacked on axis 0 by ``form`` = (draw, stack) (the reference's
    layer stack), None where absent; shared with ``encdec``."""
    draw, stack = form

    def leaf(get):
        vals = [get(m) for m in mods]
        return None if vals[0] is None else stack([draw(v) for v in vals])
    return leaf


def _fields(leaf, part: str, keys):
    return {k: leaf(lambda m, k=k: getattr(getattr(m, part), k))
            for k in keys}


def _block_tree(leaf, blk: Block) -> Dict[str, Any]:
    """An [attn + mlp/moe] block's tree, each leaf drawn by ``leaf``."""
    t = {"ln1": leaf(lambda m: m.ln1), "attn": _fields(leaf, "attn", ATTN),
         "ln2": leaf(lambda m: m.ln2)}
    if blk.moe is not None:
        t["moe"] = _fields(leaf, "moe", MOE_W)
    else:
        t["mlp"] = _fields(leaf, "mlp", MLP_W)
    return t


def params_to_numpy(params: DenseLM, cfg: ModelConfig,
                    form=NUMPY) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the module as the JAX
    package's tree (nested dict of numpy arrays, layers stacked on axis 0,
    ``None`` for absent norms, attention weights in their padded shapes,
    the hybrid's ``shared`` block unstacked); bf16 leaves widen to f32.
    ``form`` = (draw, stack) draws the leaves otherwise
    (``common.STRUCTS``: shapes and dtypes, no storage)."""
    _check_family(cfg)
    draw = form[0]
    leaf = _stacked(params.blocks, form)
    if _recurrent(cfg):
        blocks = {"ln1": leaf(lambda m: m.ln1),
                  "mixer": _fields(leaf, "mixer", SSM.PARAMS)}
    else:
        blocks = _block_tree(leaf, params.blocks[0])
    tree = {"embed": draw(params.embed), "blocks": blocks,
            "final_norm": draw(params.final_norm)}
    if not cfg.tie_embeddings:
        tree["unembed"] = draw(params.unembed)
    if cfg.shared_attn_every:
        tree["shared"] = _block_tree(lambda get: draw(get(params.shared)),
                                     params.shared)
    return tree


def _block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    n = ("embed",) if cfg.parametric_norm else None
    if _recurrent(cfg):
        return {"ln1": n, "mixer": SSM.mamba_specs(cfg)}
    sp = {"ln1": n, "attn": L.attention_specs(cfg), "ln2": n}
    if cfg.family == "moe":
        sp["moe"] = L.moe_specs(cfg)
    else:
        sp["mlp"] = L.mlp_specs(cfg)
    return sp


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every parameter, in :func:`params_to_numpy`'s
    tree (the reference's ``lm_specs``): a leading "layers" on stacked
    leaves, None for an absent norm.  embed and unembed shard only their
    vocab dim, as the reference's do."""
    n = ("embed",) if cfg.parametric_norm else None
    specs: Dict[str, Any] = {"embed": ("vocab", None),
                             "blocks": stack_specs(_block_specs(cfg)),
                             "final_norm": n}
    if not cfg.tie_embeddings:
        specs["unembed"] = (None, "vocab")
    if cfg.shared_attn_every:
        specs["shared"] = {"ln1": n, "attn": L.attention_specs(cfg),
                           "ln2": n, "mlp": L.mlp_specs(cfg)}
    return specs


# --------------------------------------------------------------------------
# Block application (shared by every serving mode).
# --------------------------------------------------------------------------

def _embed_tokens(params: DenseLM, cfg: ModelConfig, tokens,
                  prefix_embeds=None):
    """Token embeddings (B, S, d) in the compute dtype, after the
    frontend's ``prefix_embeds`` (B, P, d) when given."""
    if spmd.any_dtensor(tokens, params.embed):
        x = _sharded_embed(params.embed, tokens).to(cfg.compute_dtype)
    else:
        x = params.embed[tokens].to(cfg.compute_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.compute_dtype), x], dim=1)
    return constrain(x, "batch", None, None)


def _sharded_embed(embed, tokens):
    """The embedding lookup on DTensors: on a mesh dim that splits the
    vocabulary (the table's rows) each rank gathers the rows it holds and
    zeros for the rest, so the output is ``Partial`` there (one nonzero
    term a row: the sum is exact); on a dim that splits the batch the
    rows follow the tokens."""
    from torch.distributed.tensor import Partial
    embed = spmd.gather_fsdp(embed)
    mesh = embed.device_mesh
    tokens = spmd.as_dtensor(tokens, mesh)
    out = tuple(Partial() if e.is_shard() else t
                for t, e in zip(tokens.placements, embed.placements))
    split = any(e.is_shard() for e in embed.placements)
    lo = spmd.local_offset(embed.shape, mesh, embed.placements)[0]

    def lookup(tok, tab):
        if not split:
            return tab[tok]
        idx = tok - lo
        ok = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(ok[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
    return spmd.local(lookup, out, tokens, embed)


def _unembed(params: DenseLM, cfg: ModelConfig, x, be: Policy):
    """The final norm and the vocabulary head (span ``model.head``)."""
    with obs.span("model.head"):
        x = rmsnorm(x, params.final_norm, cfg.norm_eps)
        # the tied embed.T is a strided view (strides (1, d)): the GEMM
        # kernel reads it uncopied, along its unit-stride K dim
        w = params.embed.T if cfg.tie_embeddings else params.unembed
        return mm(x, w, be)


def _window_for_layer(cfg: ModelConfig, i: int) -> Optional[int]:
    """Layer ``i``'s attention window: every layer under ``swa``, the
    local layers under ``local_global`` (the reference's ``lax.cond``
    taken here in Python), none under ``full``."""
    a = cfg.attn
    if a.kind == "swa":
        return a.window
    if a.kind == "local_global" and not a.layer_is_global(i):
        return a.window
    return None


def _apply_attn_block(blk: Block, x, be: Policy, cfg: ModelConfig, i: int,
                      *, kv=None, pos=None, paged_kv=None):
    """attention (with layer ``i``'s window, in the mode ``L.attention``
    picks from ``kv``/``paged_kv``) + mlp/moe.  An MoE block takes the
    MLP's place (span ``model.moe``); in a serving call (``kv`` or
    ``paged_kv``) a dropless one takes its row tiles.  Returns (y, the
    block's aux loss (the MoE layer's f32 scalar, a Python 0.0 for an
    MLP block or a dropless layer's row tiles; a training term, which
    the serving paths drop as the reference's do), the prompt's (k, v)
    in prefill mode, else None)."""
    with obs.span("model.attention", ranged=False, layer=i):
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        out = L.attention(blk.attn, h, be, cfg,
                          window=_window_for_layer(cfg, i), kv_cache=kv,
                          pos=pos, paged_kv=paged_kv)
        prefill = kv is None and paged_kv is None
        attn_out, kv_out = out if prefill else (out, None)
        x = x + attn_out
    with obs.span("model.mlp", ranged=False, layer=i):
        h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
        aux = 0.0
        if blk.moe is not None:
            with obs.span("model.moe", ranged=False, layer=i):
                y, aux = L.moe(blk.moe, h2, be, cfg,
                               serving=kv is not None or paged_kv is not None)
        else:
            y = L.mlp(blk.mlp, h2, be)
        return x + y, aux, kv_out


def _apply_mamba_block(blk: MambaBlock, x, be: Policy, cfg: ModelConfig, *,
                       state=None):
    """pre-norm + mamba; with ``state`` (one-token decode) also returns the
    new (conv, ssm) carry."""
    h = rmsnorm(x, blk.ln1, cfg.norm_eps)
    if state is not None:
        y, new_state = SSM.mamba(blk.mixer, h, be, cfg, state=state)
        return x + y, new_state
    return x + SSM.mamba(blk.mixer, h, be, cfg), None


# --------------------------------------------------------------------------
# Forward over whole sequences (scoring).
# --------------------------------------------------------------------------

def forward_train(params: DenseLM, cfg: ModelConfig, be: Policy, tokens,
                  prefix_embeds=None):
    """tokens (B, S_text) -> (logits (B, S_total, Vp), aux loss (a f32
    scalar: the MoE layers' mean over the layers, 0 for the other
    families)).  Every attention layer attends the whole sequence
    causally with its own window (through the flash kernel under every
    policy but the forced library), and every mamba layer runs the SSD
    kernel once over it.  Where autograd records, each layer (a hybrid's
    with the shared block applied before it) is checkpointed as
    ``cfg.remat`` says (``common.remat``): under ``"full"`` its forward
    runs again in the backward pass, kernels included."""
    x = _embed_tokens(params, cfg, tokens, prefix_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spmd.is_dtensor(x):
        aux = spmd.from_local(aux, x.device_mesh,
                              spmd.replicate(x.device_mesh), ())
    if _recurrent(cfg):
        def body(x, blk, i):
            if _shared_app(cfg, i) is not None:
                x, _, _ = _apply_attn_block(params.shared, x, be, cfg, i)
            return _apply_mamba_block(blk, x, be, cfg)[0]
        for i, blk in enumerate(params.blocks):
            x = remat(cfg, body, x, blk, i)
    else:
        def body(x, blk, i):
            return _apply_attn_block(blk, x, be, cfg, i)[:2]
        for i, blk in enumerate(params.blocks):
            x, a = remat(cfg, body, x, blk, i)
            aux = aux + a
        aux = aux / cfg.n_layers
    return _unembed(params, cfg, x, be), aux


# --------------------------------------------------------------------------
# Wave serving: prefill / decode over a ring KV cache (the ssm family: a
# per-sequence recurrent carry).
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LMCache:
    """Cache of the wave path.  ``pos`` is the next position, a host
    integer (the reference keeps a device scalar: a host int costs no
    device read per step).  Attention families keep K/V buffers, the ssm
    and hybrid families their recurrent carries, the hybrid also one K/V
    buffer per application of its shared block; :func:`decode` updates
    them in place."""
    pos: int
    attn_k: Optional[torch.Tensor] = None     # (L, B, Hkv, W, hd)
    attn_v: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None       # (L, B, K-1, ch)
    ssm: Optional[torch.Tensor] = None        # (L, B, nh, P, N) f32
    shared_k: Optional[torch.Tensor] = None   # (napps, B, Hkv, W, hd)
    shared_v: Optional[torch.Tensor] = None


def cache_buffer_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer length: window-sized iff NO layer needs full context."""
    a = cfg.attn
    if cfg.family == "ssm":
        return 0
    if a.kind == "swa" and not cfg.shared_attn_every:
        return min(a.window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, prefill_len: int = 0,
               device="cuda", mesh=None) -> LMCache:
    """Zero cache for ``batch`` sequences of up to ``seq_len`` positions,
    ``prefill_len`` of them already filled.  On a ``DeviceMesh`` ``mesh``
    every tensor is a DTensor laid out as the rules lay out a cache
    (``rules.cache_placements``: the reference's ``cache_shardings``),
    each rank allocating its own shard."""
    _check_family(cfg)
    pl = R.cache_placements(cfg, mesh, batch) if mesh is not None else {}

    def zeros(name, shape, dt=dtype):
        if mesh is None:
            return torch.zeros(shape, dtype=dt, device=device)
        return spmd.zeros(shape, dt, device, mesh, pl[name])

    kv = (batch, cfg.n_kv_heads_padded, cache_buffer_len(cfg, seq_len),
          cfg.head_dim_)
    cache = LMCache(prefill_len)
    L_ = cfg.n_layers
    if _recurrent(cfg):
        s = cfg.ssm
        cache.conv = zeros("conv", (L_, batch, s.d_conv - 1,
                                    cfg.d_inner + 2 * s.d_state))
        cache.ssm = zeros("ssm", (L_, batch, cfg.ssm_heads, s.head_dim,
                                  s.d_state), torch.float32)
    else:
        cache.attn_k = zeros("attn_k", (L_,) + kv)
        cache.attn_v = zeros("attn_v", (L_,) + kv)
    if cfg.shared_attn_every:
        napps = _n_shared_apps(cfg)
        cache.shared_k = zeros("shared_k", (napps,) + kv)
        cache.shared_v = zeros("shared_v", (napps,) + kv)
    return cache


def _zeros_kv(shape, dtype, device):
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _ring_layout(k, W: int):
    """Reorder the last W positions of k (B, H, S, hd) into ring-slot
    order."""
    S = k.shape[2]
    if W >= S:
        return k, S
    slots = (S - W) + torch.remainder(
        torch.arange(W, device=k.device) - S, W)
    return k.index_select(2, slots), W


def _ring_pad(k, W: int, dtype):
    """Ring layout, zero-padded to exactly W slots, in ``dtype``.  On a
    DTensor it runs on each rank's rows and heads, the positions made
    whole first where they are split (a redistribution, counted)."""
    if spmd.is_dtensor(k):
        from torch.distributed.tensor import Replicate
        k = spmd.settle(k)
        pl = tuple(Replicate() if p.is_shard(2) else p for p in k.placements)
        if pl != tuple(k.placements):
            k = k.redistribute(k.device_mesh, pl)
        return spmd.local(lambda t: _ring_pad(t, W, dtype), pl, k)
    kr, have = _ring_layout(k, W)
    if have < W:
        kr = torch.nn.functional.pad(kr, (0, 0, 0, W - have))
    return kr.to(dtype)


def prefill(params: DenseLM, cfg: ModelConfig, be: Policy, tokens,
            cache_len: Optional[int] = None, prefix_embeds=None):
    """Run the prompts tokens (B, S), after ``prefix_embeds`` (B, P, d)
    when given; returns (last-token logits (B, Vp), the primed cache of
    ``cache_len`` positions, default P + S).  On DTensors the cache comes
    back in the rules' cache layout (the reference's ``out_shardings``),
    each layer's K/V written into the local shards."""
    x = _embed_tokens(params, cfg, tokens, prefix_embeds)
    B, S, _ = x.shape
    cache_len = cache_len or S
    cache = init_cache(cfg, B, cache_len, cfg.compute_dtype, prefill_len=S,
                       device=x.device, mesh=x.device_mesh
                       if spmd.is_dtensor(x) else None)
    W = cache_buffer_len(cfg, cache_len)
    if _recurrent(cfg):
        # the prompt as ONE chunk of the serving recurrence from the
        # cache's zero carry: the carry it leaves is bit-identical to any
        # other chunking of the same tokens (the paged engine's)
        for i, blk in enumerate(params.blocks):
            app = _shared_app(cfg, i)
            if app is not None:
                x, _, (k, v) = _apply_attn_block(params.shared, x, be,
                                                 cfg, i)
                spmd.write(cache.shared_k, (app,),
                           _ring_pad(k, W, cfg.compute_dtype))
                spmd.write(cache.shared_v, (app,),
                           _ring_pad(v, W, cfg.compute_dtype))
            h = rmsnorm(x, blk.ln1, cfg.norm_eps)
            y, (conv, ssm) = SSM.paged_step(blk.mixer, h, be, cfg,
                                            (cache.conv[i], cache.ssm[i]))
            spmd.write(cache.conv, (i,), conv)
            spmd.write(cache.ssm, (i,), ssm)
            x = x + y
        return _unembed(params, cfg, x[:, -1:], be)[:, 0], cache
    for i, blk in enumerate(params.blocks):
        x, _, (k, v) = _apply_attn_block(blk, x, be, cfg, i)
        spmd.write(cache.attn_k, (i,), _ring_pad(k, W, cfg.compute_dtype))
        spmd.write(cache.attn_v, (i,), _ring_pad(v, W, cfg.compute_dtype))
    return _unembed(params, cfg, x[:, -1:], be)[:, 0], cache


def decode(params: DenseLM, cfg: ModelConfig, be: Policy, tokens,
           cache: LMCache):
    """One-token step, tokens (B, 1): writes each layer's K/V (or carry)
    into the cache in place (on DTensors into the local shards: a ring
    slot on the rank that owns it); returns (logits (B, Vp), the cache at
    pos + 1)."""
    x = _embed_tokens(params, cfg, tokens)
    for i, blk in enumerate(params.blocks):
        if _recurrent(cfg):
            app = _shared_app(cfg, i)
            if app is not None:
                x, _, _ = _apply_attn_block(
                    params.shared, x, be, cfg, i,
                    kv=(cache.shared_k[app], cache.shared_v[app]),
                    pos=cache.pos)
            x, (conv, ssm) = _apply_mamba_block(
                blk, x, be, cfg, state=(cache.conv[i], cache.ssm[i]))
            spmd.write(cache.conv, (i,), conv)
            spmd.write(cache.ssm, (i,), ssm)
            continue
        x, _, _ = _apply_attn_block(blk, x, be, cfg, i,
                                    kv=(cache.attn_k[i], cache.attn_v[i]),
                                    pos=cache.pos)
    return _unembed(params, cfg, x, be)[:, 0], dataclasses.replace(
        cache, pos=cache.pos + 1)


# --------------------------------------------------------------------------
# Paged serving.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PagedState:
    """Device-side serving state: attention K/V block pools, indexed
    through block tables (see ``repro_torch.serve.paged``), and the ssm
    and hybrid families' recurrent carries in per-SLOT rows, fixed-size
    for the slot's lifetime.  The hybrid's shared block has a pool per
    application, read through the same block tables.  Which request owns
    which slot row is host-side state (``serve.paged.SlotStateStore``)."""
    attn_k: Optional[torch.Tensor] = None     # (L, P, Hkv, BS, hd)
    attn_v: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None       # (L, slots, K-1, ch)
    ssm: Optional[torch.Tensor] = None        # (L, slots, nh, Phd, N) f32
    shared_k: Optional[torch.Tensor] = None   # (napps, P, Hkv, BS, hd)
    shared_v: Optional[torch.Tensor] = None


def init_paged_state(cfg: ModelConfig, num_blocks: int, block_size: int,
                     slots: int, dtype=torch.bfloat16,
                     device="cuda") -> PagedState:
    """Zero serving state; block 0 of every pool is the null sink, and
    zero-init keeps it finite for the masked reads inactive slots discard.
    ``slots`` sizes the recurrent families' per-slot carry rows; they are
    re-zeroed by :func:`paged_prefill` whenever a chunk starts at
    position 0 (fresh admission or recompute-resume)."""
    _check_family(cfg)
    pool = (num_blocks, cfg.n_kv_heads_padded, block_size, cfg.head_dim_)
    ps = PagedState()
    if _recurrent(cfg):
        conv, h = SSM.init_paged_state(cfg, slots, dtype, device)
        L_ = cfg.n_layers
        ps.conv = conv[None].repeat(L_, 1, 1, 1)
        ps.ssm = h[None].repeat(L_, 1, 1, 1, 1)
    else:
        ps.attn_k, ps.attn_v = _zeros_kv((cfg.n_layers,) + pool, dtype,
                                         device)
    if cfg.shared_attn_every:
        ps.shared_k, ps.shared_v = _zeros_kv((_n_shared_apps(cfg),) + pool,
                                             dtype, device)
    return ps


def _paged_core(params: DenseLM, cfg: ModelConfig, be: Policy, x,
                ps: PagedState, block_tables, qpos, decode_from=None, *,
                rows=slice(None), seg_len=None, active=None):
    """Layer stack shared by paged prefill chunks and slot decode; K/V go
    through ``block_tables`` into the pools (in place), each layer with
    its own window.  The recurrent families' carries are the slot
    ``rows`` of ``ps.conv``/``ps.ssm`` (aligned with x's batch), advanced
    in place; the hybrid's shared block writes its application's pool.
    Returns logits."""
    if _recurrent(cfg):
        for i, blk in enumerate(params.blocks):
            app = _shared_app(cfg, i)
            if app is not None:
                x, _, _ = _apply_attn_block(params.shared, x, be, cfg, i,
                                            paged_kv=(
                    ps.shared_k[app], ps.shared_v[app], block_tables, qpos,
                    decode_from))
            h = rmsnorm(x, blk.ln1, cfg.norm_eps)
            y, (ps.conv[i, rows], ps.ssm[i, rows]) = SSM.paged_step(
                blk.mixer, h, be, cfg, (ps.conv[i, rows], ps.ssm[i, rows]),
                seg_len=seg_len, active=active)
            x = x + y
        return _unembed(params, cfg, x, be)
    for i, blk in enumerate(params.blocks):
        x, _, _ = _apply_attn_block(blk, x, be, cfg, i, paged_kv=(
            ps.attn_k[i], ps.attn_v[i], block_tables, qpos, decode_from))
    return _unembed(params, cfg, x, be)


def paged_prefill(params: DenseLM, cfg: ModelConfig, be: Policy, tokens,
                  ps: PagedState, block_tables, pos_start, slot: int,
                  seg_len: int, n_prompt: int):
    """One prefill chunk for ONE request occupying ``slot``: tokens (1, C)
    at absolute positions ``pos_start[0] + [0..C)`` (the tail past
    ``seg_len`` is padding and advances no carry); block_tables
    (1, nmax).  Rows at positions >= ``n_prompt`` exist only on
    recompute-resume and take the decode numerics.  When ``pos_start`` is
    0 (fresh admission or recompute-resume) the slot's carry rows are
    zeroed first, on the device, in lockstep with the scheduler rewinding
    the position.  Returns logits (1, C, Vp); ``ps`` is updated in
    place.  The call is the span ``model.call`` (``which="prefill"``)."""
    with obs.span("model.call", which="prefill"):
        x = _embed_tokens(params, cfg, tokens)
        B, C, _ = x.shape
        qpos = pos_start[:, None] + torch.arange(C, device=x.device)[None, :]
        dfrom = torch.full((B,), int(n_prompt), dtype=qpos.dtype,
                           device=x.device)
        if not _recurrent(cfg):
            return _paged_core(params, cfg, be, x, ps, block_tables, qpos,
                               dfrom)
        rows = slice(slot, slot + 1)
        fresh = pos_start[0] == 0
        zero = torch.zeros((), device=x.device)
        for pool in (ps.conv, ps.ssm):
            pool[:, rows] = torch.where(fresh, zero.to(pool.dtype),
                                        pool[:, rows])
        seg = torch.full((B,), int(seg_len), dtype=torch.long,
                         device=x.device)
        return _paged_core(params, cfg, be, x, ps, block_tables, qpos, dfrom,
                           rows=rows, seg_len=seg)


def paged_decode(params: DenseLM, cfg: ModelConfig, be: Policy, tokens,
                 ps: PagedState, block_tables, pos, active=None):
    """One slot-level decode step over ALL slots: tokens (slots, 1), pos
    (slots,), active (slots,) bool (None: every slot).  Inactive rows
    read/write the null block through their all-zero table row and keep
    their recurrent carries bitwise unchanged.  Returns logits
    (slots, 1, Vp).  The call is the span ``model.call``
    (``which="decode"``)."""
    with obs.span("model.call", which="decode"):
        x = _embed_tokens(params, cfg, tokens)
        qpos = pos[:, None] + torch.arange(x.shape[1],
                                           device=x.device)[None, :]
        return _paged_core(params, cfg, be, x, ps, block_tables, qpos,
                           active=active)
