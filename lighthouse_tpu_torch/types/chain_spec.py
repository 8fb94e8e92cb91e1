"""Runtime chain configuration — the ``ChainSpec`` analogue.

Mirrors ``consensus/types/src/chain_spec.rs`` (~115 params;
the subset the state transition, fork choice, and networking layers consume).
Fork scheduling follows the same model: each fork has a version and an
activation epoch (``None``/``FAR_FUTURE_EPOCH`` = never).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace

FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_EPOCH = 0
GENESIS_SLOT = 0

# Participation flag indices / weights (altair constants,
# consensus-specs `specs/altair/beacon-chain.md`).
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64
PARTICIPATION_FLAG_WEIGHTS = (
    TIMELY_SOURCE_WEIGHT, TIMELY_TARGET_WEIGHT, TIMELY_HEAD_WEIGHT)

BLS_WITHDRAWAL_PREFIX = b"\x00"
ETH1_ADDRESS_WITHDRAWAL_PREFIX = b"\x01"


class Domain(bytes, enum.Enum):
    """Signature domain types (``chain_spec.rs`` domain constants)."""
    BEACON_PROPOSER = bytes([0, 0, 0, 0])
    BEACON_ATTESTER = bytes([1, 0, 0, 0])
    RANDAO = bytes([2, 0, 0, 0])
    DEPOSIT = bytes([3, 0, 0, 0])
    VOLUNTARY_EXIT = bytes([4, 0, 0, 0])
    SELECTION_PROOF = bytes([5, 0, 0, 0])
    AGGREGATE_AND_PROOF = bytes([6, 0, 0, 0])
    SYNC_COMMITTEE = bytes([7, 0, 0, 0])
    SYNC_COMMITTEE_SELECTION_PROOF = bytes([8, 0, 0, 0])
    CONTRIBUTION_AND_PROOF = bytes([9, 0, 0, 0])
    BLS_TO_EXECUTION_CHANGE = bytes([10, 0, 0, 0])


class ForkName(str, enum.Enum):
    """Fork schedule order (``types/src/fork_name.rs``)."""
    PHASE0 = "phase0"
    ALTAIR = "altair"
    BELLATRIX = "bellatrix"
    CAPELLA = "capella"
    DENEB = "deneb"

    @property
    def order(self) -> int:
        return _FORK_ORDER[self]

    def __ge__(self, other):  # type: ignore[override]
        if isinstance(other, ForkName):
            return self.order >= other.order
        return NotImplemented

    def __gt__(self, other):  # type: ignore[override]
        if isinstance(other, ForkName):
            return self.order > other.order
        return NotImplemented

    def __le__(self, other):  # type: ignore[override]
        if isinstance(other, ForkName):
            return self.order <= other.order
        return NotImplemented

    def __lt__(self, other):  # type: ignore[override]
        if isinstance(other, ForkName):
            return self.order < other.order
        return NotImplemented


_FORK_ORDER = {ForkName.PHASE0: 0, ForkName.ALTAIR: 1,
               ForkName.BELLATRIX: 2, ForkName.CAPELLA: 3,
               ForkName.DENEB: 4}


@dataclass
class ChainSpec:
    config_name: str = "mainnet"
    preset_base: str = "mainnet"

    # Genesis
    min_genesis_active_validator_count: int = 16384
    min_genesis_time: int = 1606824000
    genesis_fork_version: bytes = bytes(4)
    genesis_delay: int = 604800

    # Forking
    altair_fork_version: bytes = bytes([1, 0, 0, 0])
    altair_fork_epoch: int | None = 74240
    bellatrix_fork_version: bytes = bytes([2, 0, 0, 0])
    bellatrix_fork_epoch: int | None = 144896
    capella_fork_version: bytes = bytes([3, 0, 0, 0])
    capella_fork_epoch: int | None = 194048
    deneb_fork_version: bytes = bytes([4, 0, 0, 0])
    deneb_fork_epoch: int | None = 269568

    # Time parameters
    seconds_per_slot: int = 12
    seconds_per_eth1_block: int = 14
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    eth1_follow_distance: int = 2048

    # Validator cycle
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    ejection_balance: int = 16_000_000_000
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 65536

    # Fork choice
    proposer_score_boost: int = 40
    safe_slots_to_update_justified: int = 8

    # Deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = bytes(20)

    # Networking / validator
    target_aggregators_per_committee: int = 16
    attestation_subnet_count: int = 64
    epochs_per_subnet_subscription: int = 256
    attestation_propagation_slot_range: int = 32
    maximum_gossip_clock_disparity_ms: int = 500

    # Terminal-difficulty merge params (bellatrix); mainnet TTD per
    # `chain_spec.rs` / mainnet config.yaml.
    terminal_total_difficulty: int = 58750000000000000000000
    terminal_block_hash: bytes = bytes(32)
    terminal_block_hash_activation_epoch: int = FAR_FUTURE_EPOCH

    # -- fork schedule -------------------------------------------------------

    def fork_version(self, fork: ForkName) -> bytes:
        return {
            ForkName.PHASE0: self.genesis_fork_version,
            ForkName.ALTAIR: self.altair_fork_version,
            ForkName.BELLATRIX: self.bellatrix_fork_version,
            ForkName.CAPELLA: self.capella_fork_version,
            ForkName.DENEB: self.deneb_fork_version,
        }[fork]

    def fork_epoch(self, fork: ForkName) -> int | None:
        return {
            ForkName.PHASE0: 0,
            ForkName.ALTAIR: self.altair_fork_epoch,
            ForkName.BELLATRIX: self.bellatrix_fork_epoch,
            ForkName.CAPELLA: self.capella_fork_epoch,
            ForkName.DENEB: self.deneb_fork_epoch,
        }[fork]

    def fork_name_at_epoch(self, epoch: int) -> ForkName:
        """``ChainSpec::fork_name_at_epoch`` (``chain_spec.rs``)."""
        current = ForkName.PHASE0
        for fork in (ForkName.ALTAIR, ForkName.BELLATRIX, ForkName.CAPELLA,
                     ForkName.DENEB):
            fe = self.fork_epoch(fork)
            if fe is not None and fe != FAR_FUTURE_EPOCH and epoch >= fe:
                current = fork
        return current

    def next_fork(self, fork: ForkName) -> ForkName | None:
        order = [ForkName.PHASE0, ForkName.ALTAIR, ForkName.BELLATRIX,
                 ForkName.CAPELLA, ForkName.DENEB]
        i = order.index(fork)
        return order[i + 1] if i + 1 < len(order) else None

    # -- constructors --------------------------------------------------------

    # -- YAML config (`config.yaml`, `chain_spec.rs` from_config) ------------

    def to_yaml(self) -> str:
        """Spec ``config.yaml`` conventions: UPPER_SNAKE keys, fork
        versions as 0x-hex, epochs as ints (None → far-future)."""
        import dataclasses
        import yaml
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            key = f.name.upper()
            if isinstance(v, bytes):
                v = "0x" + v.hex()
            elif v is None:
                v = FAR_FUTURE_EPOCH
            out[key] = v
        return yaml.safe_dump(out, sort_keys=False)

    @classmethod
    def from_yaml(cls, text: str) -> "ChainSpec":
        """Load a spec `config.yaml`; unknown keys are ignored (forward
        compatibility, like the reference's serde defaults)."""
        import dataclasses
        import yaml
        raw = yaml.safe_load(text) or {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, v in raw.items():
            name = key.lower()
            f = fields.get(name)
            if f is None:
                continue
            if isinstance(f.default, bytes):
                # Bytes fields (fork versions): published configs write
                # them as UNQUOTED 0x-hex, which PyYAML resolves to int —
                # convert either form to the field's byte width.
                if isinstance(v, str):
                    v = bytes.fromhex(v.removeprefix("0x"))
                elif isinstance(v, int):
                    v = v.to_bytes(len(f.default), "big")
            elif isinstance(v, str) and v.startswith("0x"):
                v = bytes.fromhex(v[2:])
            kwargs[name] = v
        return cls(**kwargs)

    @classmethod
    def mainnet(cls) -> "ChainSpec":
        return cls()

    @classmethod
    def minimal(cls) -> "ChainSpec":
        return cls(
            config_name="minimal",
            preset_base="minimal",
            min_genesis_active_validator_count=64,
            genesis_fork_version=bytes([0, 0, 0, 1]),
            genesis_delay=300,
            altair_fork_version=bytes([1, 0, 0, 1]),
            altair_fork_epoch=FAR_FUTURE_EPOCH,
            bellatrix_fork_version=bytes([2, 0, 0, 1]),
            bellatrix_fork_epoch=FAR_FUTURE_EPOCH,
            capella_fork_version=bytes([3, 0, 0, 1]),
            capella_fork_epoch=FAR_FUTURE_EPOCH,
            deneb_fork_version=bytes([4, 0, 0, 1]),
            deneb_fork_epoch=FAR_FUTURE_EPOCH,
            seconds_per_slot=6,
            shard_committee_period=64,
            eth1_follow_distance=16,
            min_per_epoch_churn_limit=2,
            churn_limit_quotient=32,
        )

    def with_forks_at_genesis(self, fork: ForkName) -> "ChainSpec":
        """All forks up to ``fork`` active from epoch 0 — the pattern the
        reference's harness uses for fork-parameterized tests
        (``beacon_chain/src/test_utils.rs``, ``fork_from_env``)."""
        updates = {}
        for f, attr in ((ForkName.ALTAIR, "altair_fork_epoch"),
                        (ForkName.BELLATRIX, "bellatrix_fork_epoch"),
                        (ForkName.CAPELLA, "capella_fork_epoch"),
                        (ForkName.DENEB, "deneb_fork_epoch")):
            if fork >= f:
                updates[attr] = 0
        return replace(self, **updates)
