"""The port's copy of the environment knobs its paths read.

Same names, defaults and conventions as the JAX package's registry:
booleans are true ∈ {1, true, yes, on}, false ∈ {0, false, no, off};
integers and floats parse as such and are clamped to the knob's minimum;
an empty value means unset (the default); anything else raises.
"""

from __future__ import annotations

import os

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")

# name → (default, doc[, minimum for int and float knobs])
KNOBS = {
    "LIGHTHOUSE_TPU_NO_NATIVE": (
        False, "Disable the native C++ BLS library; verify via device/python "
               "fallbacks."),
    "LIGHTHOUSE_TPU_HOST_FASTPATH_MAX": (
        4, "Batches up to this many sets verify on the host native "
           "pairing; 0 keeps everything on-device.", 0),
    "LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS": (
        1 << 18, "H2D streaming chunk rows for big column pushes (leaf "
                 "builds default 2^18, registry builds 2^17); <= 0 disables "
                 "chunking.", None),
    "LIGHTHOUSE_TPU_PROOF_DEVICE": (
        True, "Serve Merkle proofs by device gather from the resident field "
              "tree (0 = host-walk oracle path)."),
    "LIGHTHOUSE_TPU_PROOF_WINDOW_MS": (
        2.0, "Proof-server micro-batching window: concurrent requests "
             "arriving within it coalesce into one device gather.", 0.0),
    "LIGHTHOUSE_TPU_PROOF_MAX_BATCH": (
        1024, "Distinct gindices that dispatch a proof batch early, before "
              "the window closes.", 1),
    "LIGHTHOUSE_TPU_DEVICE_STATE": (
        True, "Device-resident BeaconState: device memory is the hashing "
              "source of truth (0 = host incremental oracle)."),
    "LIGHTHOUSE_TPU_PIPELINE_SETS": (
        1024, "Sub-batch size of the staged BLS executor; 0 disables "
              "pipelining.", 0),
    "LIGHTHOUSE_TPU_SHARED_MIN": (
        8, "Batch size from which the collapsed shared-key verify path "
           "wins over the general path.", 1),
    "LIGHTHOUSE_TPU_OVERLAP_BLOCK_SIGS": (
        True, "Overlapped block import: dispatch the block's signature "
              "batch asynchronously before the participation/rewards phase "
              "(0 = trailing synchronous verify, the oracle)."),
    "LIGHTHOUSE_TPU_EPOCH_DEVICE": (
        False, "Run the fused epoch rewards/inactivity sweep as torch ops "
               "on the device of the state's columns."),
    "LIGHTHOUSE_TPU_FORKCHOICE_JIT_MAX_DEPTH": (
        512, "Tree depth past which the torch engine's per-level loop "
             "yields to the host walk.", 1),
    "LIGHTHOUSE_TPU_BATCH_REPLAY": (
        "auto", "Epoch-batched replay for recovery: one window-wide "
                "signature batch, known state roots, one boundary root "
                "(auto: batch windows of >= 4 blocks; 0 = serial "
                "BlockReplayer oracle)."),
    "LIGHTHOUSE_TPU_STORE_SYNC": (
        "normal", "SQLite PRAGMA synchronous level for the on-disk store."),
}

# Choice knobs: name → the accepted lower-cased values.
_CHOICES = {
    "LIGHTHOUSE_TPU_STORE_SYNC": ("off", "normal", "full", "extra"),
}


class KnobError(ValueError):
    """A malformed or undeclared knob."""


def knob_bool(name: str) -> bool:
    raw = _raw(name)
    if raw is None:
        return bool(KNOBS[name][0])
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise KnobError(f"{name}={raw!r}: expected a boolean — one of "
                    f"{_TRUE + _FALSE} (or unset for the default)")


def knob_tribool(name: str):
    """Three-state knob: None when unset or ``auto`` (the caller
    decides), else the forced boolean."""
    raw = _raw(name)
    if raw is None:
        return None
    v = raw.strip().lower()
    if v == "auto":
        return None
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise KnobError(f"{name}={raw!r}: expected 'auto' or a boolean — one "
                    f"of {_TRUE + _FALSE}")


def knob_choice(name: str, default: str | None = None) -> str:
    """One of the knob's accepted values (an explicit ``default`` is
    checked against them too)."""
    raw = _raw(name)
    if raw is None:
        raw = str(KNOBS[name][0] if default is None else default)
    v = raw.strip().lower()
    if v not in _CHOICES[name]:
        raise KnobError(f"{name}={raw!r}: expected one of "
                        f"{sorted(_CHOICES[name])}")
    return v


def _raw(name: str):
    if name not in KNOBS:
        raise KnobError(f"undeclared knob {name!r}")
    raw = os.environ.get(name)
    return None if raw is None or raw.strip() == "" else raw


def _clamp(name: str, value):
    minimum = KNOBS[name][2]
    return value if minimum is None else max(value, minimum)


def knob_int(name: str, default: int | None = None) -> int:
    """Integer knob, clamped to its minimum.  ``default`` overrides the
    registry default for sites with their own (the two
    ``PUSH_CHUNK_ROWS`` builders)."""
    raw = _raw(name)
    if default is None:
        default = KNOBS[name][0]
    if raw is None:
        return int(default)
    try:
        value = int(raw.strip())
    except ValueError:
        raise KnobError(f"{name}={raw!r}: expected an integer (default "
                        f"{default}); unset the variable to use the "
                        f"default") from None
    return int(_clamp(name, value))


def knob_float(name: str, default: float | None = None) -> float:
    raw = _raw(name)
    if default is None:
        default = KNOBS[name][0]
    if raw is None:
        return float(default)
    try:
        value = float(raw.strip())
    except ValueError:
        raise KnobError(f"{name}={raw!r}: expected a number (default "
                        f"{default}); unset the variable to use the "
                        f"default") from None
    return float(_clamp(name, value))
