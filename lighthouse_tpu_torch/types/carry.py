"""Carry a BeaconState across from the JAX package into the port.

This system has no weights: its state is the BeaconState.  Two seams move
it over without importing anything of the JAX package:

- :func:`state_from_ssz` decodes the SSZ bytes of a state, which both
  packages serialise identically (:func:`signed_block_from_ssz` does the
  same for a signed block);
- :func:`registry_from_columns` builds the SoA validator registry from its
  columns as numpy arrays (``{name: column}`` for every name in
  ``ValidatorRegistry._COLUMNS``).
"""

from __future__ import annotations

import numpy as np

from .chain_spec import ForkName
from .factory import spec_types
from .presets import MAINNET, MINIMAL, Preset
from .validators import ValidatorRegistry

_PRESETS = {p.name: p for p in (MAINNET, MINIMAL)}


def _preset(preset) -> Preset:
    """The port's preset of the same name (accepts the JAX package's
    preset object, the port's, or a name)."""
    name = preset if isinstance(preset, str) else preset.name
    return _PRESETS[name]


def state_from_ssz(data: bytes, preset, fork):
    """Decode ``data`` as the port's ``BeaconState`` of ``fork`` (a
    ``ForkName`` of either package, or its value such as ``"capella"``)."""
    fork = ForkName(getattr(fork, "value", fork))
    return spec_types(_preset(preset)).state_cls(fork).deserialize(data)


def signed_block_from_ssz(data: bytes, preset, fork):
    """Decode ``data`` as the port's ``SignedBeaconBlock`` of ``fork``."""
    fork = ForkName(getattr(fork, "value", fork))
    return spec_types(_preset(preset)).signed_block_cls(fork).deserialize(
        data)


def registry_from_columns(cols: dict) -> ValidatorRegistry:
    """A fresh registry holding ``cols`` (copied; every column is
    required, all of one length)."""
    missing = set(ValidatorRegistry._COLUMNS) - set(cols)
    if missing:
        raise KeyError(f"missing registry columns {sorted(missing)}")
    n = int(np.asarray(cols["pubkey"]).shape[0])
    reg = ValidatorRegistry(n)
    reg.init_columns(**{name: np.asarray(cols[name])
                        for name in ValidatorRegistry._COLUMNS})
    return reg
