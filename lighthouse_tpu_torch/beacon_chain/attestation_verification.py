"""Batched gossip-attestation verification —
``beacon_node/beacon_chain/src/attestation_verification.rs``
and its batch module (``attestation_verification/batch.rs:31-120``).

The batching window (≤64 per worker batch,
``beacon_processor/mod.rs:200``) is the natural device batch: every
attestation passes the cheap checks individually (slot window, known head,
committee resolution, first-seen dedup), then ALL signatures verify in ONE
``verify_signature_sets`` call — on the card one batched verify.  If the
batch fails, each attestation re-verifies individually so one bad item
cannot censor the rest (``batch.rs:203``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..crypto import bls
from ..state_transition import signature_sets as sigs
from ..state_transition.committees import get_beacon_committee
from .errors import (
    AttestationError,
    AttestationSlotOutOfWindow,
    AttestationSignatureInvalid,
    PriorAttestationKnown,
    UnknownHeadBlock,
)

ATTESTATION_PROPAGATION_SLOT_RANGE = 32


@dataclass
class VerifiedAttestation:
    """Attestation + resolved committee/indices, post-verification."""
    attestation: object
    indexed_indices: np.ndarray
    committee: np.ndarray


def attesting_indices(state, att, preset) -> Tuple[np.ndarray, np.ndarray]:
    """(attesting indices, committee) for an attestation — the committee
    lookup + aggregation-bit select shared by gossip verification and
    block-import fork-choice feeding."""
    committee = np.asarray(get_beacon_committee(
        state, int(att.data.slot), int(att.data.index), preset))
    bits = np.asarray(att.aggregation_bits, dtype=bool)[:len(committee)]
    return committee[bits], committee


def _cheap_checks(chain, att) -> Tuple[np.ndarray, np.ndarray, object]:
    """Slot window, known head, committee resolution, first-seen PEEK.
    Attesters are only RECORDED after the batch signature verifies —
    otherwise junk signatures naming honest validators would censor their
    real attestations (same two-phase as observed_block_producers).
    Returns (attesting indices, committee, resolved state)."""
    slot = int(att.data.slot)
    cur = chain.current_slot()
    if not (slot <= cur <= slot + ATTESTATION_PROPAGATION_SLOT_RANGE):
        raise AttestationSlotOutOfWindow(f"slot {slot}, current {cur}")
    head_root = bytes(att.data.beacon_block_root)
    if not chain.fork_choice.contains_block(head_root):
        raise UnknownHeadBlock(head_root.hex())
    try:
        state = chain.state_for_attestation(att)
    except AttestationError:
        raise
    except Exception as e:
        # Fork-choice may know the block while its state is already pruned
        # (hot→cold migration); that is a per-attestation failure, not a
        # batch abort — BlockError escaping here would drop the whole
        # 64-item gossip batch on one unverified message.
        raise UnknownHeadBlock(f"state unavailable: {e}") from e
    indices, committee = attesting_indices(state, att, chain.preset)
    epoch = int(att.data.target.epoch)
    fresh = [i for i in indices
             if not chain.observed_attesters.has_attested(epoch, int(i))]
    if not fresh:
        raise PriorAttestationKnown(
            f"all {len(indices)} attesters already seen for epoch {epoch}")
    return indices, committee, state


def _signature_set(chain, att, indices, state) -> bls.SignatureSet:
    return sigs.indexed_attestation_signature_set(
        state, [int(i) for i in indices], bytes(att.signature), att.data,
        chain.pubkey_cache, chain.preset)


def _accept(chain, att, idx, committee) -> VerifiedAttestation:
    """Record attesters (two-phase: only AFTER the signature verified)
    and build the verified wrapper — the synchronous batch path.  The
    streaming completion callback does NOT use this: it needs the
    atomic observe-if-fresh form (register only when some attester is
    new) to dedup concurrent duplicate copies."""
    epoch = int(att.data.target.epoch)
    for v in idx:
        chain.observed_attesters.observe(epoch, int(v))
    return VerifiedAttestation(att, idx, committee)


def batch_verify_attestations(chain, attestations: List
                              ) -> List[Tuple[object, Optional[Exception]]]:
    """One batched signature verify for the window; individual fallback on
    batch failure.  Returns per-attestation (VerifiedAttestation | None,
    error | None) preserving order."""
    staged = []
    results: List = [None] * len(attestations)
    for i, att in enumerate(attestations):
        try:
            indices, committee, state = _cheap_checks(chain, att)
            staged.append((i, att, indices, committee, state))
        except AttestationError as e:
            results[i] = (None, e)

    def accept(i, att, idx, committee):
        results[i] = (_accept(chain, att, idx, committee), None)

    if staged:
        sets = [_signature_set(chain, att, idx, state)
                for (_, att, idx, _, state) in staged]
        if bls.verify_signature_sets(sets):
            for (i, att, idx, committee, _state) in staged:
                accept(i, att, idx, committee)
        else:
            # Fallback: verify one-by-one (`batch.rs:203`).
            for (i, att, idx, committee, _state), sset in zip(staged, sets):
                if bls.verify_signature_sets([sset]):
                    accept(i, att, idx, committee)
                else:
                    results[i] = (None, AttestationSignatureInvalid(
                        f"attestation {i} signature invalid"))
    return results
