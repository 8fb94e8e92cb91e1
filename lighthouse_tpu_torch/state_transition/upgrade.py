"""Fork upgrades: phase0→altair→bellatrix→capella state migrations.

Counterpart of ``consensus/state_processing/src/upgrade/
{altair,merge,capella}.rs``.  Each upgrade re-homes the state into the next
fork's class, carrying fields per the spec's ``upgrade_to_*`` functions.
"""

from __future__ import annotations

import numpy as np

from ..types.chain_spec import ForkName


def upgrade_state(state, epoch: int, preset, spec, T):
    """Apply any upgrade scheduled exactly at ``epoch``."""
    fork_now = spec.fork_name_at_epoch(epoch)
    current = T.fork_of_state(state)
    while current < fork_now:
        nxt = spec.next_fork(current)
        state = _UPGRADES[nxt](state, epoch, preset, spec, T)
        current = nxt
    return state


def _carry_common(old, new, T) -> None:
    for name in type(old).FIELDS:
        if name in type(new).FIELDS and name in (
                set(type(old).FIELDS) & set(type(new).FIELDS)):
            if name == "latest_execution_payload_header":
                continue  # per-fork type; handled by the upgrade fn
            setattr(new, name, getattr(old, name))


def upgrade_to_altair(state, epoch, preset, spec, T):
    from .per_epoch import get_next_sync_committee
    new = T.BeaconStateAltair()
    _carry_common(state, new, T)
    new.fork = T.Fork(previous_version=state.fork.current_version,
                      current_version=spec.altair_fork_version,
                      epoch=epoch)
    n = len(state.validators)
    new.previous_epoch_participation = np.zeros(n, dtype=np.uint8)
    new.current_epoch_participation = np.zeros(n, dtype=np.uint8)
    new.inactivity_scores = np.zeros(n, dtype=np.uint64)
    # NOTE: the spec translates phase0 pending attestations into
    # participation flags; chains here start at altair+ so the pending lists
    # are empty (phase0 epoch processing is likewise not implemented).
    sync = get_next_sync_committee(new, preset, T)
    new.current_sync_committee = sync
    new.next_sync_committee = get_next_sync_committee(new, preset, T)
    return new


def upgrade_to_bellatrix(state, epoch, preset, spec, T):
    new = T.BeaconStateBellatrix()
    _carry_common(state, new, T)
    new.fork = T.Fork(previous_version=state.fork.current_version,
                      current_version=spec.bellatrix_fork_version,
                      epoch=epoch)
    new.latest_execution_payload_header = T.ExecutionPayloadHeaderBellatrix()
    return new


def upgrade_to_capella(state, epoch, preset, spec, T):
    new = T.BeaconStateCapella()
    _carry_common(state, new, T)
    new.fork = T.Fork(previous_version=state.fork.current_version,
                      current_version=spec.capella_fork_version,
                      epoch=epoch)
    old_h = state.latest_execution_payload_header
    new.latest_execution_payload_header = T.ExecutionPayloadHeaderCapella(
        **{f: getattr(old_h, f) for f in type(old_h).FIELDS},
        withdrawals_root=b"\x00" * 32)
    new.next_withdrawal_index = 0
    new.next_withdrawal_validator_index = 0
    new.historical_summaries = []
    return new


def upgrade_to_deneb(state, epoch, preset, spec, T):
    new = T.BeaconStateDeneb()
    _carry_common(state, new, T)
    new.fork = T.Fork(previous_version=state.fork.current_version,
                      current_version=spec.deneb_fork_version,
                      epoch=epoch)
    old_h = state.latest_execution_payload_header
    new.latest_execution_payload_header = T.ExecutionPayloadHeaderDeneb(
        **{f: getattr(old_h, f) for f in type(old_h).FIELDS},
        blob_gas_used=0, excess_blob_gas=0)
    return new


_UPGRADES = {
    ForkName.ALTAIR: upgrade_to_altair,
    ForkName.BELLATRIX: upgrade_to_bellatrix,
    ForkName.CAPELLA: upgrade_to_capella,
    ForkName.DENEB: upgrade_to_deneb,
}
