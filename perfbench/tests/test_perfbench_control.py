"""The correctness check fails what it must fail.  At a size a test run
holds, on the CPU (the check for a chip skipped, the port's plain
versions under every kernel), each run drives the whole of a cell's
run with the timed path broken underneath and sees ``correct`` come out
false, once for each fault the cell can have; so does the control (the
plain reference in fp8, the precision below the configuration's bf16,
in the program's place); and a sound run passes."""
import pytest

from perfbench import faults, serve, spec, train
from conftest import small_chat, small_train, smoke, wider

SEED = 2 ** 31 + 4321


CELL = "olmo-1b.chat-32"


def _serve(**kw):
    return serve.run(wider("olmo-1b"), small_chat(), spec.limits(CELL), SEED,
                     6.0, False, device="cpu", **kw)


SERVE_FAULTS = faults.SERVE


def test_sound_serve_run_is_correct():
    res = _serve()
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serve_fault_is_not_correct(fault, monkeypatch):
    SERVE_FAULTS[fault](monkeypatch.setattr)
    res = _serve()
    assert not res["correct"], res["checks"]


def test_serve_control_is_not_correct():
    """The fp8 reference's tokens are judged in the program's place."""
    res = _serve(control=True)
    assert not res["correct"], res["checks"]
    lim = spec.limits(CELL)
    assert dict((k, v) for k, v, _ in res["checks"]) == dict(
        {k: res["gaps"]["control_" + k] for k in lim}, failed=0.0)


# -- training ---------------------------------------------------------------

def _train(control=False):
    # f32 compute: at this width bf16's rounding alone reads past the
    # limits set for the cell's widths; the faults read far past them
    return train.run(smoke("olmo-1b", dtype="float32"), small_train(),
                     spec.limits("olmo-1b.train-8x2048"), SEED, 0.5, False,
                     device="cpu", control=control)


TRAIN_FAULTS = faults.TRAIN


def test_sound_train_run_is_correct():
    res = _train()
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch.setattr)
    res = _train()
    assert not res["correct"], res["checks"]


def test_train_control_is_not_correct():
    """The fp8 reference's steps are judged in the program's place."""
    res = _train(control=True)
    assert not res["correct"], res["checks"]
    assert {k: v for k, v, _ in res["checks"] if k != "failed"} == \
        res["control"]
