"""Shared fixtures of the benchmark's CPU tests: each configuration at a
smoke size (every width cut, the file's structure kept) and small mixes."""
import copy
import json
import pathlib

import pytest
import torch

# several test processes share the machine's cores
torch.set_num_threads(2)

BENCH = pathlib.Path(__file__).resolve().parents[1]


def load(kind, name):
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def smoke(name, **kw):
    d = load("configs", name)
    d.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=128, vocab=256, vocab_rows=256)
    d.update(kw)
    return d


def wider(name, **kw):
    """A size at which the fp8 control's served-token gaps read as far
    past a bf16 run's as at the cell's widths: 4 layers of d 512."""
    return smoke(name, n_layers=4, d_model=512, head_dim=128, d_ff=1024,
                 vocab=2048, vocab_rows=2048, **kw)


def small_chat(**kw):
    m = load("traffic", "chat-32")
    m.update(slots=4, max_len=64, pool=64, trace_steps=4, clients=4,
             # prompts past one 32-token prefill chunk: the second chunk
             # reads the first one's cache
             prompt_len=dict(m["prompt_len"], lo=33, hi=48),
             output_len=dict(m["output_len"], lo=2, hi=16),
             check={"min_served_tokens": 240, "max_requests": 16})
    m.update(kw)
    return m


def small_train(**kw):
    m = load("traffic", "train-8x2048")
    m.update(batch=2, seq=32)
    m.update(kw)
    return m


@pytest.fixture
def cfgs():
    return {"smoke": smoke, "chat": small_chat, "train": small_train,
            "load": load, "copy": copy.deepcopy}
