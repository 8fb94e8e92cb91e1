"""Consensus type system.

Counterpart of ``consensus/types`` (16.2k LoC of Rust):
compile-time size presets (``EthSpec`` typenum presets,
``types/src/eth_spec.rs:51,254,298``) become :class:`Preset` instances;
runtime parameters (``types/src/chain_spec.rs``) become :class:`ChainSpec`;
the per-fork ``superstruct`` enums become per-fork container classes sharing
annotated bases (field order = base-first, so the common prefix matches).

All SSZ bounds come from the preset, so the full set of container classes is
built per preset by :func:`spec_types` and cached — mirroring how the
reference monomorphizes ``BeaconState<E: EthSpec>`` per preset.
"""

from .presets import Preset, MAINNET, MINIMAL
from .chain_spec import ChainSpec, Domain, ForkName
from .factory import spec_types, SpecTypes

__all__ = [
    "Preset", "MAINNET", "MINIMAL", "ChainSpec", "Domain", "ForkName",
    "spec_types", "SpecTypes",
]
