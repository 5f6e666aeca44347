"""repro_torch.tune — the empirical install-time stage, on the card.

Counterpart of ``repro/tune``.  The analytical pipeline (``cost.py``'s
prior, the ``HOPPER_CROSSOVER`` threshold, ``_choose_bk``) predicts; this
package *measures*.  It buckets the (M, N, K, dtype, trans) input space
into geometric size classes (``classes.py``), times the analytically
promising kernels of each class's letter against the library on the card
(``timer.py`` + ``search.py``: CUDA events; on the CPU the plain
versions, a host-clock profile that never applies on the card), and
persists the winners as a versioned per-device :class:`DeviceProfile`
(``profile.py``) that the ``repro_torch.api`` Router reads under
``Policy(backend="tuned")``, for the 2-D entry, ND matmul and the grouped
paths alike, falling back to the analytical criterion for unmeasured
classes.

``python -m repro_torch.tune`` runs the sweep and writes the profile;
``online.py``'s :class:`OnlineTuner` re-times the classes that serving
routes, in the background, and publishes the merged profile.
"""
from repro_torch.tune.classes import SizeClass, representative, size_class
from repro_torch.tune.profile import (DeviceProfile, ProfileEntry,
                                      active_profile, clear_active_profile,
                                      default_profile_path,
                                      set_active_profile)
from repro_torch.tune.search import (TuneTarget, budgeted_sweep, sweep,
                                     tune_class, tune_grouped_class)
from repro_torch.tune.timer import Measurement, measure
from repro_torch.tune.online import CycleReport, OnlineTuner, \
    weighted_targets

__all__ = [
    "SizeClass", "size_class", "representative",
    "DeviceProfile", "ProfileEntry", "active_profile",
    "clear_active_profile", "default_profile_path", "set_active_profile",
    "sweep", "tune_class", "tune_grouped_class", "budgeted_sweep",
    "TuneTarget", "Measurement", "measure",
    "OnlineTuner", "CycleReport", "weighted_targets",
]
