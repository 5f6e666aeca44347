"""The program under test, ``repro_torch``, reached through its public
entry points: ``registry.build`` on a ``ModelConfig`` made from the
configuration file, the seeded weights placed into its parameter tree.
Both are the configuration's family's (``perfbench/families/<family>.py``).
Nothing the reference compares against comes from here."""
from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench import spec


def port_config(doc: Dict[str, Any]):
    """The configuration file as the port's ``ModelConfig``."""
    return spec.family(doc["family"]).port_config(doc)


def port_params(doc: Dict[str, Any], seed: int, dtype, device):
    """The seeded weights (``weights.layer``/``weights.outer``) as the
    port's parameter tree: matrices in ``dtype`` (the compute dtype to
    serve, f32 for a trainer's master copy), the rest as the family
    keeps them."""
    return spec.family(doc["family"]).port_params(doc, seed, dtype, device)


def free_cuda():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
