"""repro_torch.tune against repro.tune: bucketing identical to the
reference's, profile persistence and its device/mode gate, tuned-mode
routing, and one-class sweeps and the CLI on the CPU (plain versions,
host-clock timings: a ``cpu`` profile)."""
import json

import numpy as np
import pytest
import torch

from repro.tune import classes as jclasses
from repro_torch import api
from repro_torch.core import plan as plan_mod
from repro_torch.core.kernelgen import KernelSig
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.tune import classes, profile as profile_mod, search, timer
from repro_torch.tune.classes import SizeClass
from repro_torch.tune.profile import DeviceProfile, ProfileEntry
from repro_torch.tune.timer import Measurement, measure, try_measure

TUNED = api.Policy(backend="tuned")
AUTO = api.Policy(backend="auto")


@pytest.fixture(autouse=True)
def _isolated_profile_state(tmp_path, monkeypatch):
    """Each test gets an empty cache dir and no active profile."""
    monkeypatch.setenv(profile_mod.CACHE_ENV, str(tmp_path / "cache"))
    profile_mod.clear_active_profile()
    yield
    profile_mod.clear_active_profile()


def _here(**kw) -> DeviceProfile:
    """An empty profile of this process's device and mode."""
    return DeviceProfile(profile_mod.current_device_kind(),
                         mode=profile_mod.current_mode(), **kw)


def _entry(kernel_us, library_us, sig=KernelSig("S", "NN", 32, 128, 64)):
    m = lambda us: Measurement(us, us * 0.9, us * 1.1, 3)  # noqa: E731
    return ProfileEntry(sig, m(kernel_us), m(library_us))


# -- size classes: identical to the reference's -----------------------------

def test_buckets_identical_to_reference():
    for x in list(range(1, 600)) + [1023, 1024, 2047, 2048, 1 << 20]:
        assert classes.bucket_index(x) == jclasses.bucket_index(x)
    for i in range(40):
        assert classes.bucket_bounds(i) == jclasses.bucket_bounds(i)
        assert classes.bucket_representative(i) == \
            jclasses.bucket_representative(i)


def test_bucket_boundaries_exact():
    for i in range(1, 12):
        lo, hi = classes.bucket_bounds(i)
        assert lo == 2 ** i
        assert classes.bucket_index(2 ** i) == i
        assert classes.bucket_index(2 ** i - 1) == i - 1
        assert classes.bucket_index(2 ** (i + 1) - 1) == i
        assert lo <= classes.bucket_representative(i) < hi
    with pytest.raises(ValueError):
        classes.bucket_index(0)


@pytest.mark.parametrize("dims,letter,trans", [
    ((45, 129, 7), "S", "NT"), ((80, 80, 80), "C", "TN"),
    ((3, 2048, 1408), "Z", "TT"), ((8, 1408, 2048), "H", "NN")])
def test_size_class_keys_identical_to_reference(dims, letter, trans):
    sc = classes.size_class(*dims, letter, trans)
    jsc = jclasses.size_class(*dims, letter, trans)
    assert sc.key == jsc.key
    assert SizeClass.from_key(sc.key) == sc
    assert classes.representative(sc) == jclasses.representative(jsc)
    assert classes.size_class(*classes.representative(sc), letter,
                              trans) == sc


def test_classes_up_to_identical_to_reference():
    for cube in (True, False):
        got = classes.classes_up_to(["S", "C"], ["NN", "TN"], 2048,
                                    min_dim=8, cube_only=cube)
        want = jclasses.classes_up_to(["S", "C"], ["NN", "TN"], 2048,
                                      min_dim=8, cube_only=cube)
        assert [s.key for s in got] == [s.key for s in want]
    cs = classes.classes_up_to(["S"], ["NN"], 128, min_dim=8,
                               cube_only=True)
    assert [classes.representative(s)[0] for s in cs] == [11, 23, 45, 91]


# -- profile persistence and its gates ---------------------------------------

def test_profile_save_load_roundtrip(tmp_path):
    prof = DeviceProfile("cpu", mode="cpu")
    sc = classes.size_class(45, 45, 45, "C", "NN")
    sig = KernelSig("C", "NN", 16, 64, 64)
    prof.record(sc, _entry(10.0, 20.0, sig))
    prof.record_grouped(classes.size_class(8, 1408, 2048, "H", "NN"),
                        _entry(1.0, 2.0, KernelSig("H", "NN", 16, 256, 64)))
    back = DeviceProfile.load(prof.save(tmp_path / "p.json"))
    assert back.to_json() == prof.to_json()
    e = back.lookup(sc)
    assert e.prefer_kernel and e.sig == sig and e.kernel.median_us == 10.0
    assert back.lookup_grouped_dims(8, 1408, 2048, "H").sig.bn == 256


def test_profile_default_path_uses_the_ports_own_env_cache(tmp_path):
    p = profile_mod.default_profile_path("cpu", "cpu")
    assert str(p).startswith(str(tmp_path / "cache"))
    assert p.name == "profile_v1_cpu_cpu.json"
    assert profile_mod.CACHE_ENV == "REPRO_TORCH_TUNE_CACHE"


def test_profile_version_and_mode_gates(tmp_path):
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"version": 0, "device_kind": "cpu",
                                "mode": "cpu", "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        DeviceProfile.load(path)
    with pytest.raises(ValueError):
        DeviceProfile("cpu", mode="interpret")


def test_profile_merge_keeps_better_entry():
    sc1 = classes.size_class(45, 45, 45, "S", "NN")
    sc2 = classes.size_class(90, 90, 90, "S", "NN")
    a = DeviceProfile("cpu", mode="cpu")
    a.record(sc1, _entry(10.0, 20.0))
    b = DeviceProfile("cpu", mode="cpu")
    b.record(sc1, _entry(5.0, 20.0))      # faster winner: replaces
    b.record(sc2, _entry(30.0, 8.0))      # new class: unions in
    merged = a.merge(b)
    assert len(merged) == 2
    assert merged.lookup(sc1).kernel.median_us == 5.0
    assert not merged.lookup(sc2).prefer_kernel


def test_profile_merge_rejects_device_and_mode_mismatch():
    with pytest.raises(ValueError, match="different devices"):
        DeviceProfile("cpu", mode="cpu").merge(
            DeviceProfile("NVIDIA H100 80GB HBM3", mode="cpu"))
    with pytest.raises(ValueError, match="not comparable"):
        DeviceProfile("cpu", mode="cpu").merge(
            DeviceProfile("cpu", mode="cuda"))


def test_profile_of_another_device_or_mode_never_applies():
    """A profile applies only on the device and mode that timed it: a
    CPU-timed profile is never applied on the card, and a card's profile
    not on a CPU (here, where there is no card, the latter)."""
    other = "cuda" if profile_mod.current_mode() == "cpu" else "cpu"
    with pytest.raises(ValueError, match="does not apply"):
        profile_mod.set_active_profile(
            DeviceProfile(profile_mod.current_device_kind(), mode=other))
    with pytest.raises(ValueError, match="does not apply"):
        profile_mod.set_active_profile(
            DeviceProfile("some other card", mode=profile_mod.current_mode()))
    # a foreign profile at this device's default path is not loaded
    sc = classes.size_class(45, 45, 45, "S", "NN")
    foreign = DeviceProfile("some other card", mode=profile_mod.current_mode())
    foreign.record(sc, _entry(100.0, 1.0))
    foreign.save(profile_mod.default_profile_path())
    profile_mod.clear_active_profile()
    assert profile_mod.active_profile() is None
    assert api.route("gemm", (45, 45, 45), "S", policy=TUNED).source == \
        "analytical"


def test_unmeasured_entry_falls_back_analytical():
    sc = classes.size_class(45, 45, 45, "S", "NN")
    prof = _here()
    prof.record(sc, ProfileEntry(None, None, None))   # sweep all-failed
    profile_mod.set_active_profile(prof)
    d = api.route("gemm", (45, 45, 45), "S", "NN", policy=TUNED)
    assert d.source == "analytical"


# -- timer -------------------------------------------------------------------

def test_measure_median_of_k_and_failures_pruned():
    m = measure(lambda: torch.zeros(4, 4), warmup=1, reps=3)
    assert m.reps == 3 and 0 < m.best_us <= m.median_us <= m.worst_us
    n0 = len(timer.FAILURES)

    def boom():
        raise RuntimeError("no such instance")
    assert try_measure(boom, what="a candidate", warmup=0, reps=1) is None
    assert timer.FAILURES[n0:] == [("a candidate",
                                    "RuntimeError: no such instance")]


# -- tuned-mode routing --------------------------------------------------------

def _operands(M, N, K, dt=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    a, b = rng.randn(M, K), rng.randn(K, N)
    if dt.is_complex:
        a, b = a + 1j * rng.randn(M, K), b + 1j * rng.randn(K, N)
    return torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt)


def test_named_tuned_policy_falls_back_analytical_without_profile():
    pol = api.named_policy("tuned")
    assert pol.backend == "tuned"
    assert profile_mod.active_profile() is None
    for letter in ("S", "C", "Z"):
        d = api.route("gemm", (10, 10, 10), letter, policy=pol)
        auto = api.route("gemm", (10, 10, 10), letter, policy=AUTO)
        assert d.source == "analytical" and d.use_kernel == auto.use_kernel
    a, b = _operands(10, 10, 10, torch.complex64)
    np.testing.assert_allclose(api.gemm(a, b, policy=pol).numpy(),
                               (a @ b).numpy(), rtol=2e-4, atol=2e-3)


def test_tuned_mode_reads_profile_from_disk():
    """A profile on disk changes routing: the analytical criterion sends
    45^3 to the kernel, the measured entry sends it to the library."""
    M = N = K = 45
    assert api.route("gemm", (M, N, K), "S", policy=AUTO).use_kernel
    prof = _here()
    prof.record(classes.size_class(M, N, K, "S", "NN"), _entry(100.0, 1.0))
    prof.save()                            # the default (env-cache) path
    profile_mod.clear_active_profile()     # force the lazy disk load
    d = api.route("gemm", (M, N, K), "S", policy=TUNED)
    assert (d.source, d.use_kernel) == ("profile", False)
    a, b = _operands(M, N, K)
    np.testing.assert_allclose(api.gemm(a, b, policy=TUNED).numpy(),
                               (a.double() @ b.double()).numpy(),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("letter,dt,sig", [
    ("S", torch.float32, KernelSig("S", "NN", 32, 128, 64)),
    ("C", torch.complex64, KernelSig("C", "NN", 16, 64, 32))])
def test_tuned_mode_kernel_override_used(letter, dt, sig):
    M = N = K = 45
    prof = _here()
    prof.record(classes.size_class(M, N, K, letter, "NN"),
                _entry(1.0, 100.0, sig=sig))
    profile_mod.set_active_profile(prof)
    d = api.route("gemm", (M, N, K), letter, policy=TUNED)
    assert d.source == "profile" and d.use_kernel and d.sig == sig
    p = plan_mod.build_plan(M, N, K, letter, "NN", override=d.sig)
    assert p.num_kernel_calls == 1 and p.regions[0].sig == sig
    p.tiling.validate_cover()
    a, b = _operands(M, N, K, dt)
    np.testing.assert_allclose(api.gemm(a, b, policy=TUNED).numpy(),
                               (a.to(torch.complex128 if dt.is_complex else
                                     torch.float64)
                                @ b.to(torch.complex128 if dt.is_complex
                                       else torch.float64)).numpy(),
                               rtol=2e-4, atol=2e-3)


def test_analytical_paths_unchanged_by_profile():
    """auto and the forced backends never consult the profile."""
    prof = _here()
    prof.record(classes.size_class(10, 10, 10, "S", "NN"),
                _entry(100.0, 1.0))             # profile says library
    profile_mod.set_active_profile(prof)
    assert api.route("gemm", (10, 10, 10), "S", policy=AUTO).source == \
        "analytical"
    assert api.route("gemm", (10, 10, 10), "S", policy=AUTO).use_kernel
    assert api.route("gemm", (10, 10, 10), "S",
                     policy=api.Policy(backend="kernel")).source == "forced"
    assert api.route("gemm", (10, 10, 10), "S", policy=TUNED).source == \
        "profile"


def test_tuned_grouped_routing_reads_the_grouped_entry():
    """A grouped entry (timed on batched_gemm) decides the grouped ops and
    its winner becomes Decision.blocks; without one, the 2-D entry of the
    per-group shape decides; without either, the analytical blocks."""
    G, C, K, N = 64, 8, 2048, 1408
    analytical = gg.pick_blocks(C, K, N, torch.bfloat16)
    assert api.route("batched_gemm", (G, C, K, N), "H",
                     policy=TUNED).blocks == analytical
    prof = _here()
    sc = classes.size_class(C, N, K, "H", "NN")
    prof.record(sc, _entry(1.0, 2.0, KernelSig("H", "NN", 16, 128, 32)))
    profile_mod.set_active_profile(prof)
    d = api.route("batched_gemm", (G, C, K, N), "H", policy=TUNED)
    assert (d.source, d.use_kernel, d.blocks) == ("profile", True,
                                                  (16, 128, 32))
    prof.record_grouped(sc, _entry(3.0, 1.0,
                                   KernelSig("H", "NN", 16, 256, 64)))
    profile_mod.set_active_profile(prof)
    for op in ("batched_gemm", "ragged_gemm"):
        d = api.route(op, (G, C, K, N), "H", policy=TUNED)
        assert (d.source, d.use_kernel, d.blocks) == ("profile", False,
                                                      (16, 256, 64))


# -- sweeps and the CLI, on the CPU --------------------------------------------

@pytest.mark.parametrize("letter,trans", [("S", "NN"), ("C", "TN"),
                                          ("Z", "NT")])
def test_sweep_single_class(letter, trans):
    prof = search.sweep([letter], [trans], min_dim=8, max_dim=16,
                        cube_only=True, top=2, reps=1, device="cpu")
    assert (prof.device_kind, prof.mode, len(prof)) == ("cpu", "cpu", 1)
    (key, entry), = prof.entries.items()
    assert key == f"{letter}/{trans}/3-3-3"
    assert entry.kernel is not None and entry.library is not None
    assert entry.sig.letter == letter and entry.sig.trans == trans
    assert entry.sig in search.candidates(letter, trans, 11, 11, 11, top=2)


def test_tune_grouped_class_on_the_cpu():
    sc = classes.size_class(8, 64, 64, "S", "NN")
    e = search.tune_grouped_class(sc, G=2, top=2, reps=1, device="cpu")
    assert e.measured and e.sig is not None
    with pytest.raises(ValueError, match="no grouped kernel"):
        search.tune_grouped_class(classes.size_class(8, 64, 64, "C", "NN"),
                                  device="cpu")


def test_budgeted_sweep_respects_budget():
    targets = [search.TuneTarget("gemm", classes.size_class(n, n, n, "S",
                                                            "NN"))
               for n in (11, 23, 45)]
    prof, tuned, spent = search.budgeted_sweep(targets, budget=5, top=1,
                                               device="cpu")
    assert (len(tuned), spent, len(prof)) == (2, 4, 2)
    assert all(e.origin == "online" for e in prof.entries.values())


def test_cli_sdcz_quick_on_the_cpu_then_tuned_reads_it(tmp_path, capsys):
    """``python -m repro_torch.tune --letters SDCZ --trans NN,NT,TN,TT
    --quick --device cpu --out <tmp>``: the profile it writes is what
    ``named_policy("tuned")`` then routes by."""
    from repro_torch.tune.__main__ import main
    out = tmp_path / "cli.json"
    rc = main(["--letters", "SDCZ", "--trans", "NN,NT,TN,TT", "--quick",
               "--device", "cpu", "--out", str(out)])
    assert rc == 0
    written = DeviceProfile.load(out)
    assert (written.mode, len(written)) == ("cpu", 4 * 4 * 4)
    profile_mod.set_active_profile(written)
    pol = api.named_policy("tuned")
    for key, entry in written.entries.items():
        sc = SizeClass.from_key(key)
        M, N, K = classes.representative(sc)
        d = api.route("gemm", (M, N, K), sc.letter, sc.trans, policy=pol)
        assert d.source == "profile"
        assert d.use_kernel == entry.prefer_kernel
        assert d.sig == (entry.sig if entry.prefer_kernel else None)
    assert main(["--show", "--device", "cpu", "--out", str(out)]) == 0
    assert '"entries"' in capsys.readouterr().out


def test_cli_refuses_the_card_without_one(capsys, monkeypatch):
    """The default device is the card; with none, the CLI refuses rather
    than timing the CPU under the card's name."""
    from repro_torch.tune.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--letters", "S", "--quick"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
