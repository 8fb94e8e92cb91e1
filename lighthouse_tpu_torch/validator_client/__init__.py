"""Validator client — counterpart of ``validator_client``
(``validator_client/src/lib.rs:88-520``; port of
``lighthouse_tpu/validator_client``): duties, block
proposal, attestation production, doppelganger protection, multi-BN
fallback, all over a beacon-node handle seam (in-process here, HTTP in a
wire deployment) with EIP-3076 slashing protection enforced in the
validator store before every signature."""

from .slashing_protection import SlashingDatabase, SlashingProtectionError
from .store import ValidatorStore
from .beacon_node import BeaconNodeFallback, InProcessBeaconNode
from .services import (
    AttestationService,
    BlockService,
    DoppelgangerService,
    DutiesService,
    ValidatorClient,
)

__all__ = [
    "SlashingDatabase", "SlashingProtectionError", "ValidatorStore",
    "BeaconNodeFallback", "InProcessBeaconNode", "DutiesService",
    "BlockService", "AttestationService", "DoppelgangerService",
    "ValidatorClient",
]
