"""Staged block verification — the import pipeline of
``beacon_node/beacon_chain/src/block_verification.rs`` (port of
``lighthouse_tpu/beacon_chain/block_verification.py``).

Stages (each a type, holding everything the next stage needs):

1. :class:`GossipVerifiedBlock` (``block_verification.rs:594``) — cheap
   structural checks (slot window, dedup, parent seen, expected proposer)
   plus ONE pairing: the proposer signature.
2. :class:`SignatureVerifiedBlock` (``:988``) — every other signature in
   the block accumulated and bulk-verified in one batched call (the
   ``BlockSignatureVerifier`` funnel: one batched device verify).
3. :class:`ExecutionPendingBlock` (``:1104``) — full state transition with
   signatures off (already proven), post-state root check, payload
   verification through the execution-layer seam.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..common.tracing import TRACER
from ..crypto import bls
from ..state_transition import SignatureStrategy, state_transition
from ..state_transition.committees import get_beacon_proposer_index
from ..state_transition.per_block import SigAccumulator, process_block
from ..state_transition.per_slot import process_slots
from ..state_transition import signature_sets as sigs
from .errors import (
    BlockIsAlreadyKnown,
    FutureSlot,
    IncorrectProposer,
    InvalidBlock,
    InvalidSignatures,
    ParentUnknown,
    ProposalSignatureInvalid,
    RepeatProposal,
    StateRootMismatch,
)


@dataclass
class GossipVerifiedBlock:
    signed_block: object
    block_root: bytes
    parent_state: object  # parent post-state advanced to the block slot

    @classmethod
    def new(cls, chain, signed_block) -> "GossipVerifiedBlock":
        with TRACER.span("gossip_verify", cat="block_import",
                         slot=int(signed_block.message.slot)):
            return cls._new(chain, signed_block)

    @classmethod
    def _new(cls, chain, signed_block) -> "GossipVerifiedBlock":
        block = signed_block.message
        slot = int(block.slot)
        if slot > chain.current_slot():
            raise FutureSlot(f"block slot {slot} > current {chain.current_slot()}")
        block_root = block.tree_hash_root()
        if chain.fork_choice.contains_block(block_root):
            raise BlockIsAlreadyKnown(block_root.hex())
        parent_root = bytes(block.parent_root)
        if not chain.fork_choice.contains_block(parent_root):
            raise ParentUnknown(parent_root.hex())
        # Proposer-equivocation guard, peek only — recorded after the
        # signature check (`observed_block_producers.rs` two-phase).
        proposer = int(block.proposer_index)
        if chain.observed_block_producers.has_been_observed(slot, proposer,
                                                            block_root):
            raise RepeatProposal(f"proposer {proposer} already proposed at "
                                 f"slot {slot}")
        # Advance the parent state to the block slot for committee checks
        # (`cheap_state_advance_to_obtain_committees`) — preferring the
        # state the per-slot timer pre-advanced (`state_advance_timer.rs`)
        # so the gossip path skips the epoch transition.
        adv = chain._advanced_states.get((parent_root, slot))
        if adv is not None:
            state = adv.copy()
        else:
            state = chain.state_at_block_root(parent_root)
            if int(state.slot) < slot:
                state = process_slots(state, slot, chain.preset, chain.spec,
                                      chain.T)
        expected = get_beacon_proposer_index(state, chain.preset, slot=slot)
        if proposer != expected:
            raise IncorrectProposer(f"got {proposer}, expected {expected}")
        # One pairing: the proposal signature
        # (`block_verification.rs:594` signature_verify only proposal).
        cache = chain.pubkey_cache
        pset = sigs.block_proposal_signature_set(
            state, signed_block, cache, chain.preset,
            block_root=block_root)
        if not bls.verify_signature_sets([pset]):
            raise ProposalSignatureInvalid(block_root.hex())
        chain.observed_block_producers.observe(slot, proposer, block_root)
        return cls(signed_block=signed_block, block_root=block_root,
                   parent_state=state)


@dataclass
class SignatureVerifiedBlock:
    signed_block: object
    block_root: bytes
    parent_state: object

    @classmethod
    def from_gossip_verified(cls, chain,
                             g: GossipVerifiedBlock) -> "SignatureVerifiedBlock":
        """Stage marker: the remaining signatures are accumulated DURING
        execution and bulk-verified in one batched call
        (`block_signature_verifier.rs:160-405` — the execution stage runs
        with ``VERIFY_BULK`` so the transition is performed exactly once)."""
        return cls(signed_block=g.signed_block, block_root=g.block_root,
                   parent_state=g.parent_state)


@dataclass
class ExecutedBlock:
    signed_block: object
    block_root: bytes
    post_state: object

    @classmethod
    def from_signature_verified(cls, chain,
                                sv: SignatureVerifiedBlock) -> "ExecutedBlock":
        """`ExecutionPendingBlock::from_signature_verified_components`
        (`block_verification.rs:1104`): one transition with ``VERIFY_BULK``
        (non-proposal signatures batched into one device verify during
        execution), then the post-state root check (`:1423`).

        The transition runs with ``defer_sig_join=True``: under the
        overlapped pipeline the signature batch dispatched to the device
        before the participation/rewards phase, and its verdict JOINS
        here — after the post-state-root hash, right before the root
        check — so device pairing time hides behind host transition +
        hashing compute."""
        from ..state_transition.per_block import (
            BlockProcessingError, InvalidSignaturesError)
        from ..ssz.core import SszError

        block = sv.signed_block.message
        state = sv.parent_state
        try:
            fork = chain.spec.fork_name_at_epoch(
                int(state.slot) // chain.preset.SLOTS_PER_EPOCH)
            # The transition span carries the per-phase children (the
            # stage adapter converts per_block.LAST_BLOCK_TIMINGS inside
            # process_block) and the device residency deltas — the
            # device-stage attribution of this block's import.
            with TRACER.span("state_transition", cat="state_transition",
                             slot=int(block.slot)) as _sp:
                _mark = TRACER.residency_mark()
                pending = process_block(
                    state, sv.signed_block, fork, chain.preset,
                    chain.spec, chain.T,
                    strategy=SignatureStrategy.VERIFY_BULK,
                    pubkey_cache=chain.pubkey_cache,
                    payload_verifier=chain.payload_verifier,
                    defer_sig_join=True)
                TRACER.record_residency(_sp, _mark)
        except InvalidSignaturesError as e:
            # TYPED classification: only an actual cryptographic verdict
            # (or a signature/key codec failure below) is
            # InvalidSignatures — a non-signature rejection whose
            # message mentions "signature" stays InvalidBlock (the old
            # string matcher got this wrong in both directions).
            raise InvalidSignatures(str(e)) from e
        except bls.BlsError as e:
            # Malformed / out-of-subgroup signature or pubkey encodings
            # in the block body fail at deserialization — signature
            # rejections too.
            raise InvalidSignatures(str(e)) from e
        except (BlockProcessingError, SszError, ValueError) as e:
            # Every other transition rejection keeps its own label.
            # Programming errors (TypeError/AttributeError/...)
            # propagate unwrapped.
            raise InvalidBlock(str(e)) from e
        with TRACER.span("post_state_root", cat="state_transition"):
            root = state.tree_hash_root()
        # JOIN the overlapped signature batch before the root CHECK —
        # the signature verdict outranks the root comparison.
        try:
            pending.finish()
        except InvalidSignaturesError as e:
            raise InvalidSignatures(str(e)) from e
        if root != bytes(block.state_root):
            raise StateRootMismatch(
                f"{root.hex()} != {bytes(block.state_root).hex()}")
        return cls(signed_block=sv.signed_block, block_root=sv.block_root,
                   post_state=state)
