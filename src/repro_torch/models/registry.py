"""Model registry: one uniform interface over the ported families
(counterpart of ``repro/models/registry.py``): every decoder-only family,
dense, moe, ssm, hybrid and vlm.  The enc-dec and audio families are
refused until ``encdec.py`` is ported."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable                    # (generator, device) -> params
    forward_train: Callable
    # ^ (params, tokens, be, prefix_embeds=None) -> (logits, aux); the
    #   ssm and hybrid families only so far
    prefill: Callable
    # ^ (params, tokens, be, cache_len=None, prefix_embeds=None)
    #   -> (logits, lm.LMCache)
    decode: Callable
    # ^ (params, tokens, cache, be) -> (logits, lm.LMCache)
    init_cache: Callable
    # ^ (batch, seq_len, dtype, prefill_len, device) -> lm.LMCache
    paged_prefill: Callable
    # ^ (params, tokens, ps, tables, pos0, slot, seg_len, n_prompt, be)
    #   -> logits
    paged_decode: Callable
    # ^ (params, tokens, ps, tables, pos, active, be) -> logits
    init_paged_state: Callable
    # ^ (num_blocks, block_size, slots, dtype, device) -> lm.PagedState


def build(cfg: ModelConfig) -> Model:
    if cfg.family in ("encdec", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (models/encdec.py) is not "
            "ported yet")
    lm._check_family(cfg)

    def init(generator, device="cuda"):
        return lm.init_lm(cfg, generator, device)

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

    return Model(cfg, init, fwd, pf, dec, mk_cache, ppf, pdec, mk_ps)
