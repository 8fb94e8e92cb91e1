"""Genesis state construction — interop/deterministic path.

Counterpart of ``beacon_node/genesis/src/interop.rs`` and
the deterministic keypairs of ``common/eth2_interop_keypairs`` (used by
every reference test via ``beacon_chain/src/test_utils.rs:53,310-316``).
Keys follow the standard interop rule:
``privkey_i = int(sha256(uint32_le(i)).digest(), 'little') % r``.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np

from ..crypto import bls as B
from ..crypto import fields as F
from ..types.chain_spec import FAR_FUTURE_EPOCH, ForkName, GENESIS_EPOCH
from ..types.validators import Validator, ValidatorRegistry

ETH1_BLOCK_HASH = b"\x42" * 32


@lru_cache(maxsize=None)
def interop_secret_key(index: int) -> B.SecretKey:
    h = hashlib.sha256(index.to_bytes(32, "little")).digest()
    return B.SecretKey(int.from_bytes(h, "little") % F.R)


@lru_cache(maxsize=None)
def interop_pubkey(index: int) -> bytes:
    return interop_secret_key(index).public_key().serialize()


def interop_keypairs(n: int) -> list[tuple[B.SecretKey, bytes]]:
    return [(interop_secret_key(i), interop_pubkey(i)) for i in range(n)]


def bls_withdrawal_credentials(pubkey: bytes) -> bytes:
    return b"\x00" + hashlib.sha256(pubkey).digest()[1:]


def interop_genesis_state(n_validators: int, genesis_time: int, preset, spec,
                          T, fork: ForkName = ForkName.CAPELLA):
    """Build a fully-active genesis state directly at ``fork`` (the
    reference builds deposits then replays them; for the hermetic harness we
    construct the registry directly, like ``interop.rs`` fast-path)."""
    from .per_epoch import get_next_sync_committee

    reg = ValidatorRegistry(n_validators)
    reg._n = n_validators
    pubs = np.zeros((n_validators, 48), dtype=np.uint8)
    creds = np.zeros((n_validators, 32), dtype=np.uint8)
    for i in range(n_validators):
        pk = interop_pubkey(i)
        pubs[i] = np.frombuffer(pk, dtype=np.uint8)
        creds[i] = np.frombuffer(bls_withdrawal_credentials(pk),
                                 dtype=np.uint8)
    reg.init_columns(
        pubkey=pubs,
        withdrawal_credentials=creds,
        effective_balance=np.full(n_validators, preset.MAX_EFFECTIVE_BALANCE,
                                  dtype=np.uint64),
        activation_eligibility_epoch=np.full(n_validators, GENESIS_EPOCH,
                                             dtype=np.uint64),
        activation_epoch=np.full(n_validators, GENESIS_EPOCH, dtype=np.uint64),
        exit_epoch=np.full(n_validators, FAR_FUTURE_EPOCH, dtype=np.uint64),
        withdrawable_epoch=np.full(n_validators, FAR_FUTURE_EPOCH,
                                   dtype=np.uint64))

    scls = T.state_cls(fork)
    state = scls()
    state.genesis_time = genesis_time
    state.fork = T.Fork(
        previous_version=spec.fork_version(fork),
        current_version=spec.fork_version(fork),
        epoch=GENESIS_EPOCH)
    state.validators = reg
    state.balances = np.full(n_validators, preset.MAX_EFFECTIVE_BALANCE,
                             dtype=np.uint64)
    for i in range(preset.EPOCHS_PER_HISTORICAL_VECTOR):
        state.randao_mixes.set(i, ETH1_BLOCK_HASH)
    state.eth1_data = T.Eth1Data(
        deposit_root=b"\x00" * 32,
        deposit_count=n_validators,
        block_hash=ETH1_BLOCK_HASH)
    state.eth1_deposit_index = n_validators

    body_root = T.body_cls(fork)().tree_hash_root()
    state.latest_block_header = T.BeaconBlockHeader(body_root=body_root)

    state.genesis_validators_root = type(state).FIELDS[
        "validators"].hash_tree_root(reg)

    if fork >= ForkName.ALTAIR:
        state.previous_epoch_participation = np.zeros(n_validators,
                                                      dtype=np.uint8)
        state.current_epoch_participation = np.zeros(n_validators,
                                                     dtype=np.uint8)
        state.inactivity_scores = np.zeros(n_validators, dtype=np.uint64)
        sync = get_next_sync_committee(state, preset, T)
        state.current_sync_committee = sync
        state.next_sync_committee = get_next_sync_committee(state, preset, T)

    if fork >= ForkName.BELLATRIX:
        # Post-merge genesis: a synthetic terminal execution header so the
        # payload chain links up (mock-EL style, ``interop`` + test_utils).
        header_cls = type(state).FIELDS["latest_execution_payload_header"]
        state.latest_execution_payload_header = header_cls(
            block_hash=ETH1_BLOCK_HASH,
            timestamp=genesis_time,
            prev_randao=ETH1_BLOCK_HASH,
        )
    return state
