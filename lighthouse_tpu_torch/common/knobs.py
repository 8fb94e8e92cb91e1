"""The port's copy of the environment knobs its paths read.

Same names, defaults and conventions as the JAX package's registry:
booleans are true ∈ {1, true, yes, on}, false ∈ {0, false, no, off};
integers parse as int and are clamped to the knob's minimum; an empty
value means unset (the default); anything else raises.
"""

from __future__ import annotations

import os

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")

# name → (default, doc[, minimum for int knobs])
KNOBS = {
    "LIGHTHOUSE_TPU_DEVICE_STATE": (
        True, "Device-resident BeaconState: device memory is the hashing "
              "source of truth (0 = host incremental oracle)."),
    "LIGHTHOUSE_TPU_PIPELINE_SETS": (
        1024, "Sub-batch size of the staged BLS executor; 0 disables "
              "pipelining.", 0),
    "LIGHTHOUSE_TPU_SHARED_MIN": (
        8, "Batch size from which the collapsed shared-key verify path "
           "wins over the general path.", 1),
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


def knob_int(name: str) -> int:
    if name not in KNOBS:
        raise KnobError(f"undeclared knob {name!r}")
    default, _doc, minimum = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return int(default)
    try:
        value = int(raw.strip())
    except ValueError:
        raise KnobError(f"{name}={raw!r}: expected an integer (default "
                        f"{default}); unset the variable to use the "
                        f"default") from None
    return max(value, minimum)
