"""Persistent per-device tuning profiles (port).

Counterpart of ``repro/tune/profile.py``.  A :class:`DeviceProfile` is the
durable artefact of the empirical install-time stage: for each measured
:class:`SizeClass` it stores the best kernel signature and the measured
kernel and library times, from which the Router derives both decisions
the analytical model guesses — *which path* (the crossover) and *which
kernel* (the per-class override).

Storage is versioned JSON keyed by device kind and mode under the port's
own cache dir, ``$REPRO_TORCH_TUNE_CACHE`` (default ``build/repro_torch/
tune/`` in the checkout, beside the built kernels), so it never reads a
profile of the JAX package.  The device kind is
``torch.cuda.get_device_name(0)``, or ``"cpu"``.  The *mode* says what
timed the profile: ``"cuda"`` (the CUDA kernels and cuBLAS on the card)
or ``"cpu"`` (the plain versions on the host).  A profile applies only
where its device kind and mode are the process's own: a CPU-timed
profile is never applied on the card.  ``merge`` unions two profiles of
one device and mode entry-wise, keeping the better-measured entry.

The *active* profile is process-global state that the Router consults
under ``Policy(backend="tuned")``; it is loaded lazily from the default
path on first use and can be pinned or cleared by tests and the CLI.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import threading
from typing import Dict, Optional

import torch

from repro_torch import obs
from repro_torch.core.kernelgen import KernelSig
from repro_torch.tune.classes import SizeClass, size_class
from repro_torch.tune.timer import Measurement

PROFILE_VERSION = 1
CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
_DEFAULT_CACHE = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch" / "tune"
MODES = ("cuda", "cpu")

#: Entry-key namespace for classes measured on the grouped kernel
#: (``batched_gemm`` streams G problems through one launch, so it times
#: differently from a lone 2-D gemm of the per-group shape).
GROUPED_PREFIX = "grouped:"


def _sig_to_json(sig: KernelSig) -> dict:
    return {"letter": sig.letter, "trans": sig.trans,
            "bm": sig.bm, "bn": sig.bn, "bk": sig.bk}


def _sig_from_json(d: dict) -> KernelSig:
    return KernelSig(d["letter"], d["trans"], int(d["bm"]), int(d["bn"]),
                     int(d["bk"]))


@dataclasses.dataclass(frozen=True)
class ProfileEntry:
    """Measured outcome for one size class."""
    sig: Optional[KernelSig]          # best kernel (None: none ran)
    kernel: Optional[Measurement]
    library: Optional[Measurement]
    origin: str = "sweep"             # "sweep" (offline) | "online"

    @property
    def measured(self) -> bool:
        """At least one side was timed: an all-failed entry carries no
        information and must not override the analytical fallback."""
        return self.kernel is not None or self.library is not None

    @property
    def prefer_kernel(self) -> bool:
        """The measured crossover: the kernel wins this class."""
        if self.sig is None or self.kernel is None:
            return False
        if self.library is None:
            return True
        return self.kernel.median_us <= self.library.median_us

    def to_json(self) -> dict:
        return {
            "sig": _sig_to_json(self.sig) if self.sig else None,
            "kernel": self.kernel.to_json() if self.kernel else None,
            "library": self.library.to_json() if self.library else None,
            "origin": self.origin,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ProfileEntry":
        return cls(
            _sig_from_json(d["sig"]) if d.get("sig") else None,
            Measurement.from_json(d["kernel"]) if d.get("kernel") else None,
            Measurement.from_json(d["library"]) if d.get("library") else None,
            d.get("origin", "sweep"),
        )

    def better_than(self, other: "ProfileEntry") -> bool:
        """Merge preference: the entry with the faster measured winner."""
        def best(e: "ProfileEntry") -> float:
            ts = [m.median_us for m in (e.kernel, e.library) if m is not None]
            return min(ts) if ts else float("inf")
        return best(self) < best(other)


@dataclasses.dataclass
class DeviceProfile:
    device_kind: str
    entries: Dict[str, ProfileEntry] = dataclasses.field(default_factory=dict)
    version: int = PROFILE_VERSION
    mode: str = "cuda"               # "cuda" | "cpu": what timed it

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"profile mode {self.mode!r}; expected one of "
                             f"{MODES}")

    # -- lookup ------------------------------------------------------------

    def lookup(self, sc: SizeClass) -> Optional[ProfileEntry]:
        return self.entries.get(sc.key)

    def lookup_dims(self, M: int, N: int, K: int, letter: str,
                    trans: str) -> Optional[ProfileEntry]:
        return self.lookup(size_class(M, N, K, letter, trans))

    def record(self, sc: SizeClass, entry: ProfileEntry) -> None:
        self.entries[sc.key] = entry

    # -- grouped-kernel namespace (see GROUPED_PREFIX) ---------------------

    def lookup_grouped(self, sc: SizeClass) -> Optional[ProfileEntry]:
        return self.entries.get(GROUPED_PREFIX + sc.key)

    def lookup_grouped_dims(self, C: int, N: int, K: int,
                            letter: str) -> Optional[ProfileEntry]:
        """Grouped per-group problem (C, K, N) keyed as the (M=C, N, K)
        class; the grouped kernels take operands as stored (trans NN)."""
        return self.lookup_grouped(size_class(C, N, K, letter, "NN"))

    def record_grouped(self, sc: SizeClass, entry: ProfileEntry) -> None:
        self.entries[GROUPED_PREFIX + sc.key] = entry

    def __len__(self) -> int:
        return len(self.entries)

    # -- persistence -------------------------------------------------------

    def to_json(self) -> dict:
        return {"version": self.version, "device_kind": self.device_kind,
                "mode": self.mode,
                "entries": {k: e.to_json() for k, e in
                            sorted(self.entries.items())}}

    @classmethod
    def from_json(cls, d: dict) -> "DeviceProfile":
        ver = int(d.get("version", -1))
        if ver != PROFILE_VERSION:
            raise ValueError(
                f"profile version {ver} != supported {PROFILE_VERSION}; "
                "re-run `python -m repro_torch.tune`")
        return cls(d["device_kind"],
                   {k: ProfileEntry.from_json(e)
                    for k, e in d.get("entries", {}).items()},
                   ver, d["mode"])

    def save(self, path: Optional[os.PathLike] = None) -> pathlib.Path:
        p = pathlib.Path(path) if path else default_profile_path(
            self.device_kind, self.mode)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True))
        tmp.replace(p)      # atomic: a concurrent reader never sees a torn file
        return p

    @classmethod
    def load(cls, path: os.PathLike) -> "DeviceProfile":
        return cls.from_json(json.loads(pathlib.Path(path).read_text()))

    def merge(self, other: "DeviceProfile") -> "DeviceProfile":
        """Entry-wise union; on conflict keep the better-measured entry."""
        if other.device_kind != self.device_kind:
            raise ValueError(f"cannot merge profiles for different devices: "
                             f"{self.device_kind!r} vs {other.device_kind!r}")
        if other.mode != self.mode:
            raise ValueError(f"cannot merge {other.mode!r} timings into a "
                             f"{self.mode!r} profile: not comparable")
        merged = dict(self.entries)
        for k, e in other.entries.items():
            if k not in merged or e.better_than(merged[k]):
                merged[k] = e
        return DeviceProfile(self.device_kind, merged, self.version,
                             self.mode)


# --------------------------------------------------------------------------
# Device, mode and the cache-dir layout.
# --------------------------------------------------------------------------

def cache_dir() -> pathlib.Path:
    env = os.environ.get(CACHE_ENV, "")
    return pathlib.Path(env).expanduser() if env else _DEFAULT_CACHE


def _sanitize(kind: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in kind.strip()) or "unknown"


def device_kind_of(device) -> str:
    """The profile's device kind for ``device``: the card's name, or
    ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def current_mode() -> str:
    """The mode this process routes in: ``"cuda"`` where a card is
    present, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def current_device_kind() -> str:
    return device_kind_of("cuda" if current_mode() == "cuda" else "cpu")


def default_profile_path(device_kind: Optional[str] = None,
                         mode: Optional[str] = None) -> pathlib.Path:
    kind = _sanitize(device_kind or current_device_kind())
    return cache_dir() / \
        f"profile_v{PROFILE_VERSION}_{kind}_{mode or current_mode()}.json"


def _check_applies(p: DeviceProfile) -> None:
    kind, mode = current_device_kind(), current_mode()
    if p.mode != mode or _sanitize(p.device_kind) != _sanitize(kind):
        raise ValueError(
            f"a profile timed on {p.device_kind!r} ({p.mode}) does not "
            f"apply to this process's {kind!r} ({mode}); re-run `python -m "
            "repro_torch.tune` here")


# --------------------------------------------------------------------------
# The active profile (what tuned-mode routing reads).
# --------------------------------------------------------------------------

_UNSET = object()
_active = _UNSET                  # _UNSET: not yet loaded; None: known-absent
_active_lock = threading.Lock()


def _profile_tag(p: Optional[DeviceProfile]) -> Optional[str]:
    return f"{p.device_kind}/{p.mode}:{len(p)}" if p is not None else None


def set_active_profile(p: Optional[DeviceProfile]) -> None:
    """Pin ``p`` (None: no profile) as what tuned routing reads; raises if
    ``p`` was timed on another device or mode than this process's."""
    global _active
    if p is not None:
        _check_applies(p)
    with _active_lock:
        _active = p
    # decisions memoized by the route log may have read the old profile
    obs.ROUTES.invalidate()
    obs.TRACE.emit("PROFILE_SWAP", arg=_profile_tag(p))


def clear_active_profile() -> None:
    """Forget the active profile AND the load attempt (the next tuned
    routing re-reads the disk: call after changing the cache dir or
    re-tuning)."""
    global _active
    with _active_lock:
        _active = _UNSET
    obs.ROUTES.invalidate()
    obs.TRACE.emit("PROFILE_SWAP", arg=None)


def active_profile() -> Optional[DeviceProfile]:
    """The profile tuned routing consults; lazily loaded from this
    device's and mode's default path on first call, None (the analytical
    fallback) if absent, unreadable or of another device."""
    global _active
    with _active_lock:
        if _active is _UNSET:
            path = default_profile_path()
            try:
                _active = DeviceProfile.load(path) if path.exists() else None
                if _active is not None:
                    _check_applies(_active)
            except (OSError, ValueError, KeyError, json.JSONDecodeError):
                _active = None
            obs.ROUTES.invalidate()
            obs.TRACE.emit("PROFILE_SWAP", arg=_profile_tag(_active))
        return _active
