"""Validator store: initialized keys + slashing-protected signing —
``validator_client/src/validator_store.rs`` and ``signing_method.rs``
(port of ``lighthouse_tpu/validator_client/store.py``).  Each key is
backed by a :class:`~.signing.LocalKeystore` or a
:class:`~.signing.Web3SignerMethod`; the store computes the signing roots
and enforces slashing protection identically for both.
``import_keystore`` takes any keystore object with ``decrypt(password)``
(the EIP-2335 keystore module is not ported yet)."""

from __future__ import annotations

from typing import Dict, List, Optional

from ..crypto import bls
from ..state_transition.helpers import compute_signing_root, get_domain
from ..types.chain_spec import Domain
from .signing import LocalKeystore, Web3SignerMethod
from .slashing_protection import SlashingDatabase, SlashingProtectionError


class ValidatorStore:
    def __init__(self, slashing_db: Optional[SlashingDatabase] = None):
        self.keys: Dict[bytes, object] = {}  # pubkey → signing method
        self.index_by_pubkey: Dict[bytes, int] = {}
        self.slashing_db = slashing_db or SlashingDatabase()
        self.doppelganger_blocked: set[bytes] = set()

    # -- keys ----------------------------------------------------------------

    def add_validator(self, sk: bls.SecretKey,
                      index: Optional[int] = None) -> bytes:
        return self.add_signing_method(LocalKeystore(sk), index)

    def add_web3signer_validator(self, url: str, pubkey: bytes,
                                 index: Optional[int] = None) -> bytes:
        return self.add_signing_method(Web3SignerMethod(url, pubkey), index)

    def add_signing_method(self, method,
                           index: Optional[int] = None) -> bytes:
        pk = method.pubkey
        self.keys[pk] = method
        if index is not None:
            self.index_by_pubkey[pk] = index
        return pk

    def remove_validator(self, pubkey: bytes) -> bool:
        self.index_by_pubkey.pop(pubkey, None)
        return self.keys.pop(pubkey, None) is not None

    def import_keystore(self, keystore, password: str,
                        index: Optional[int] = None) -> bytes:
        secret = keystore.decrypt(password)
        return self.add_validator(bls.SecretKey.deserialize(secret), index)

    def pubkeys(self) -> List[bytes]:
        return list(self.keys)

    def indices(self) -> List[int]:
        return [self.index_by_pubkey[pk] for pk in self.keys
                if pk in self.index_by_pubkey]

    # -- signing (slashing-protected) ---------------------------------------

    def _check_doppelganger(self, pubkey: bytes) -> None:
        if pubkey in self.doppelganger_blocked:
            raise SlashingProtectionError(
                "doppelganger protection: signing disabled")

    @staticmethod
    def _fork_info(state) -> dict:
        f = state.fork
        return {"fork": {
            "previous_version": "0x" + bytes(f.previous_version).hex(),
            "current_version": "0x" + bytes(f.current_version).hex(),
            "epoch": str(int(f.epoch))},
            "genesis_validators_root":
                "0x" + bytes(state.genesis_validators_root).hex()}

    def sign_block(self, pubkey: bytes, block, state, preset) -> bytes:
        self._check_doppelganger(pubkey)
        epoch = int(block.slot) // preset.SLOTS_PER_EPOCH
        domain = get_domain(state, Domain.BEACON_PROPOSER, epoch, preset)
        signing_root = compute_signing_root(block, domain)
        self.slashing_db.check_and_insert_block_proposal(
            pubkey, int(block.slot), signing_root)
        return self.keys[pubkey].sign(
            signing_root, msg_type="BLOCK_V2",
            fork_info=self._fork_info(state))

    def sign_attestation(self, pubkey: bytes, data, state, preset) -> bytes:
        self._check_doppelganger(pubkey)
        domain = get_domain(state, Domain.BEACON_ATTESTER,
                            int(data.target.epoch), preset)
        signing_root = compute_signing_root(data, domain)
        self.slashing_db.check_and_insert_attestation(
            pubkey, int(data.source.epoch), int(data.target.epoch),
            signing_root)
        return self.keys[pubkey].sign(
            signing_root, msg_type="ATTESTATION",
            fork_info=self._fork_info(state))

    def sign_randao(self, pubkey: bytes, epoch: int, state, preset) -> bytes:
        self._check_doppelganger(pubkey)
        from ..ssz import uint64
        domain = get_domain(state, Domain.RANDAO, epoch, preset)
        root = compute_signing_root(uint64.hash_tree_root(epoch), domain)
        return self.keys[pubkey].sign(
            root, msg_type="RANDAO_REVEAL",
            fork_info=self._fork_info(state))

    def sign_sync_committee_message(self, pubkey: bytes, slot: int,
                                    block_root: bytes, state,
                                    preset) -> bytes:
        """Sync-committee vote over a beacon block root (`sync_committee
        _service.rs` signing; not slashable — no DB entry)."""
        self._check_doppelganger(pubkey)
        domain = get_domain(state, Domain.SYNC_COMMITTEE,
                            slot // preset.SLOTS_PER_EPOCH, preset)
        root = compute_signing_root(bytes(block_root), domain)
        return self.keys[pubkey].sign(
            root, msg_type="SYNC_COMMITTEE_MESSAGE",
            fork_info=self._fork_info(state))
