"""Model registry: one uniform interface over the ported families
(counterpart of ``repro/models/registry.py``; dense and moe so far)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable                    # (generator, device) -> params
    paged_prefill: Callable
    # ^ (params, tokens, ps, tables, pos0, n_prompt, be) -> logits
    paged_decode: Callable
    # ^ (params, tokens, ps, tables, pos, be) -> logits
    init_paged_state: Callable
    # ^ (num_blocks, block_size, slots, dtype, device) -> lm.PagedState


def build(cfg: ModelConfig) -> Model:
    lm._check_family(cfg)

    def init(generator, device="cuda"):
        return lm.init_lm(cfg, generator, device)

    def ppf(params, tokens, ps, tables, pos0, n_prompt, be):
        return lm.paged_prefill(params, cfg, be, tokens, ps, tables, pos0,
                                n_prompt)

    def pdec(params, tokens, ps, tables, pos, be):
        return lm.paged_decode(params, cfg, be, tokens, ps, tables, pos)

    def mk_ps(num_blocks, block_size, slots, dtype, device="cuda"):
        return lm.init_paged_state(cfg, num_blocks, block_size, slots,
                                   dtype, device)

    return Model(cfg, init, ppf, pdec, mk_ps)
