"""Model registry: one uniform interface over every family of the
reference (counterpart of ``repro/models/registry.py``): the
decoder-only dense, moe, ssm, hybrid and vlm families (``models/lm.py``)
and the enc-dec and audio families (``models/encdec.py``).  An enc-dec
model has no paged serving path, as in the reference: its
``paged_prefill``, ``paged_decode`` and ``init_paged_state`` are None."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable                    # (generator, device, dtype) -> params
    specs: Callable
    # ^ () -> the logical axes of every parameter, in params_to_numpy's
    #   tree (parallel/rules.py reads it)
    forward_train: Callable
    # ^ (params, tokens, be, prefix_embeds=None) -> (logits, aux);
    #   enc-dec: (params, tokens, be, src_embeds)
    prefill: Callable
    # ^ (params, tokens, be, cache_len=None, prefix_embeds=None)
    #   -> (logits, lm.LMCache); enc-dec: (params, tokens, be,
    #   cache_len=None, *, src_embeds) -> (logits, encdec.EncDecCache)
    decode: Callable
    # ^ (params, tokens, cache, be) -> (logits, cache)
    init_cache: Callable
    # ^ (batch, seq_len, dtype, prefill_len, device) -> lm.LMCache;
    #   enc-dec: (batch, seq_len, dtype, src_len, device), filled to
    #   seq_len as the reference's
    paged_prefill: Optional[Callable] = None
    # ^ (params, tokens, ps, tables, pos0, slot, seg_len, n_prompt, be)
    #   -> logits
    paged_decode: Optional[Callable] = None
    # ^ (params, tokens, ps, tables, pos, active, be) -> logits
    init_paged_state: Optional[Callable] = None
    # ^ (num_blocks, block_size, slots, dtype, device) -> lm.PagedState


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(generator, device="cuda", dtype=None):
        return encdec.init_encdec(cfg, generator, device, dtype)

    def fwd(params, tokens, be, src_embeds):
        return encdec.forward_train(params, cfg, be, tokens, src_embeds)

    def pf(params, tokens, be, cache_len=None, *, src_embeds):
        return encdec.prefill(params, cfg, be, tokens, src_embeds,
                              cache_len=cache_len)

    def dec(params, tokens, cache, be):
        return encdec.decode(params, cfg, be, tokens, cache)

    def mk_cache(batch, seq_len, dtype, src_len=None, device="cuda"):
        return encdec.init_cache(cfg, batch, seq_len, src_len or seq_len,
                                 dtype, prefill_len=seq_len, device=device)

    return Model(cfg, init, lambda: encdec.encdec_specs(cfg), fwd, pf,
                 dec, mk_cache)


def build(cfg: ModelConfig) -> Model:
    if cfg.family in encdec.FAMILIES:
        return _build_encdec(cfg)
    lm._check_family(cfg)

    def init(generator, device="cuda", dtype=None):
        return lm.init_lm(cfg, generator, device, dtype)

    def fwd(params, tokens, be, prefix_embeds=None):
        return lm.forward_train(params, cfg, be, tokens, prefix_embeds)

    def pf(params, tokens, be, cache_len=None, prefix_embeds=None):
        return lm.prefill(params, cfg, be, tokens, cache_len=cache_len,
                          prefix_embeds=prefix_embeds)

    def dec(params, tokens, cache, be):
        return lm.decode(params, cfg, be, tokens, cache)

    def mk_cache(batch, seq_len, dtype, prefill_len=None, device="cuda"):
        return lm.init_cache(cfg, batch, seq_len, dtype,
                             seq_len if prefill_len is None else prefill_len,
                             device)

    def ppf(params, tokens, ps, tables, pos0, slot, seg_len, n_prompt, be):
        return lm.paged_prefill(params, cfg, be, tokens, ps, tables, pos0,
                                slot, seg_len, n_prompt)

    def pdec(params, tokens, ps, tables, pos, active, be):
        return lm.paged_decode(params, cfg, be, tokens, ps, tables, pos,
                               active)

    def mk_ps(num_blocks, block_size, slots, dtype, device="cuda"):
        return lm.init_paged_state(cfg, num_blocks, block_size, slots,
                                   dtype, device)

    return Model(cfg, init, lambda: lm.lm_specs(cfg), fwd, pf, dec,
                 mk_cache, ppf, pdec, mk_ps)
