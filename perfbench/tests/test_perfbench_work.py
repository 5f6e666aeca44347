"""Work counts held to hand-worked figures, and to the figures they gave
before the dense counts moved into ``families/dense.py``."""
import json
import pathlib

import numpy as np
import pytest

from perfbench import spec
from perfbench.work import counts

BENCH = pathlib.Path(__file__).resolve().parents[1]


def doc(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_olmo_pass_at_m32():
    """16 layers of q, k, v, o (2048 x 2048) and gate, up, down (2048 x
    8192): 1.074e9 weights, so 2 x 32 x 1.074e9 FLOP and 2.15 GB of bf16
    weights a pass; the head adds 2048 x 50432."""
    d = doc("olmo-1b")
    per_layer = 4 * 2048 * 2048 + 3 * 2048 * 8192
    assert per_layer * 16 == 1_073_741_824
    g = counts.pass_gemms(d, 32, head=False)
    assert len(g) == 16 * 7
    assert counts.gemms_flops(g) == 2 * 32 * 1_073_741_824
    assert counts.gemms_weight_bytes(g, counts.elt(d)) == \
        pytest.approx(2.147e9, rel=1e-3)
    head = counts.pass_gemms(d, 32)[-1]
    assert head == (32, 2048, 50432)


def test_olmo_pass_is_bound_by_bytes():
    d = doc("olmo-1b")
    g = counts.pass_gemms(d, 32, head=False)
    e = counts.elt(d)
    moved = sum(counts.gemm_bytes(*x, e) for x in g)
    assert counts.gemms_bound_s(g, e) == pytest.approx(moved / 3.35e12)
    # 2.1475e9 bytes of weights and 48.2e6 of rows in and out
    assert counts.gemms_bound_s(g, e) == pytest.approx(
        (2.1475e9 + 48.2e6) / 3.35e12, rel=1e-3)


def test_token_flops_and_window():
    d = doc("olmo-1b")
    assert counts.matmul_params(d) == 1_073_741_824 + 2048 * 50432
    two = 2 * 2.0 * counts.matmul_params(d)
    assert counts.tokens_flops(d, [0, 9]) == two + 4.0 * 16 * 16 * 128 * 11
    # a window caps the keys a token sees
    w = dict(d, attn={"kind": "swa", "window": 4096})
    assert counts.tokens_flops(w, [10_000]) == counts.tokens_flops(w, [4095])
    assert counts.tokens_flops(d, [10_000]) > counts.tokens_flops(d, [4095])


def test_train_step():
    d = doc("olmo-1b")
    B, S = 8, 2048
    f = counts.train_step_flops(d, B, S)
    six_n_d = 6 * counts.matmul_params(d) * B * S
    attn = 3 * B * 4.0 * 16 * 16 * 128 * S * (S + 1) / 2
    assert f == pytest.approx(six_n_d + attn)
    g = counts.train_step_gemms(d, B, S)
    # 112 projections: forward, recompute, two backward; head: three
    assert len(g) == 112 * 4 + 3
    assert counts.gemms_flops(g) == pytest.approx(
        2 * 16384 * (1_073_741_824 * 4 + 2048 * 50432 * 3))


def _summed(gemms):
    """Length, the sums of M, K and N, and the operations of a GEMM list."""
    return (len(gemms), [sum(g[i] for g in gemms) for i in range(3)],
            counts.gemms_flops(gemms))


# olmo-1b's counts as the harness gave them while they lived in
# work/counts.py
PINNED = {"pass_gemms": (113, [3616, 329728, 476416], 75329699840.0),
          "pass_gemms_no_head": (112, [3584, 327680, 425984],
                                 68719476736.0),
          "train_step_gemms": (451, [5867520, 2985216, 1708544],
                               150890791043072.0),
          "matmul_params": 1177026560.0}


@pytest.mark.parametrize("via", ["counts", "family"])
def test_olmo_counts_are_pinned(via):
    """Through the names the readers call and through the family file,
    the counts are those of before the move, to the bit."""
    d = doc("olmo-1b")
    src = counts if via == "counts" else spec.family("dense")
    assert _summed(src.pass_gemms(d, 32)) == PINNED["pass_gemms"]
    assert _summed(src.pass_gemms(d, 32, head=False)) == \
        PINNED["pass_gemms_no_head"]
    assert _summed(src.train_step_gemms(d, 8, 2048)) == \
        PINNED["train_step_gemms"]
    assert src.matmul_params(d) == PINNED["matmul_params"]
    # every position of the chat cell's longest request
    assert counts.tokens_flops(d, np.arange(1152)) == 2798917779456.0
