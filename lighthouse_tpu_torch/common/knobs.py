"""The port's copy of the one environment knob its path reads.

Same name, default and truthiness convention as the JAX package's
registry: true ∈ {1, true, yes, on}, false ∈ {0, false, no, off}, an
empty value means unset (the default), anything else raises.
"""

from __future__ import annotations

import os

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")

# name → (default, doc)
KNOBS = {
    "LIGHTHOUSE_TPU_DEVICE_STATE": (
        True, "Device-resident BeaconState: device memory is the hashing "
              "source of truth (0 = host incremental oracle)."),
}


class KnobError(ValueError):
    """A malformed or undeclared knob."""


def knob_bool(name: str) -> bool:
    if name not in KNOBS:
        raise KnobError(f"undeclared knob {name!r}")
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return bool(KNOBS[name][0])
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise KnobError(f"{name}={raw!r}: expected a boolean — one of "
                    f"{_TRUE + _FALSE} (or unset for the default)")
