"""The port's validator client on the CPU, against the JAX package's.

Every comparison is exact (outcomes, interchange JSON, SSZ bytes, roots),
so no tolerance is stated.

- Slashing protection: the same sequence of proposals and votes gives
  the same accept / refuse outcomes in both packages' ``SlashingDatabase``;
  the EIP-3076 interchange the port exports equals the JAX package's, and
  each package imports the other's export.
- The proposer and attester flow (the JAX package's
  ``test_validator_client_proposes_and_attests``, side by side): a
  16-validator MINIMAL Capella chain in each package, the fake BLS
  backend, one ``ValidatorClient`` with all 16 interop keys over
  ``InProcessBeaconNode``, slots 1-10 (across the epoch boundary at 8):
  every slot's signed block bytes, head and op-pool bytes are equal.
- Doppelganger protection blocks signing through the watch window,
  releases after it, and never re-blocks on the client's own liveness.
- The sync-committee aggregate of the port's pool, from the port's
  ``ValidatorStore`` signing with real keys, equals the JAX package's and
  the harness's full-participation aggregate.
"""

import importlib

import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.validator_client import SlashingDatabase as JDB
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import bls as tbls
from lighthouse_tpu_torch.validator_client import (
    SlashingDatabase as TDB,
    SlashingProtectionError,
)

N_VALIDATORS = 16
SLOTS = 10


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    jprev, tprev = jbls._active, tbls._active
    jbls.set_backend("fake")
    tbls.set_backend("fake")
    yield
    jbls._active, tbls._active = jprev, tprev
    device.set_default_device(prev)
    torch.set_num_threads(threads)


def _ser(obj) -> bytes:
    return type(obj).serialize(obj)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# Slashing protection
# ---------------------------------------------------------------------------

PK_A, PK_B = b"\x11" * 48, b"\x22" * 48
# (kind, pubkey, slot or (source, target), signing root)
_OPS = [
    ("block", PK_A, 10, b"\xaa" * 32),
    ("block", PK_A, 10, b"\xaa" * 32),        # identical re-sign
    ("block", PK_A, 10, b"\xbb" * 32),        # double proposal
    ("block", PK_A, 9, b"\xcc" * 32),         # below the max slot
    ("block", PK_B, 9, b"\xcc" * 32),
    ("block", PK_A, 11, b"\xdd" * 32),
    ("att", PK_A, (2, 4), b"\x01" * 32),
    ("att", PK_A, (2, 4), b"\x01" * 32),      # identical re-sign
    ("att", PK_A, (3, 4), b"\x02" * 32),      # double vote
    ("att", PK_A, (1, 5), b"\x03" * 32),      # surrounds 2 -> 4
    ("att", PK_A, (4, 6), b"\x04" * 32),
    ("att", PK_A, (5, 5), b"\x05" * 32),      # surrounded by 4 -> 6
    ("att", PK_A, (3, 3), b"\x06" * 32),      # target below the max
    ("att", PK_A, (7, 6), b"\x07" * 32),      # source after target
    ("att", PK_B, (0, 3), b"\x08" * 32),
]


def _apply(db, ops) -> list:
    out = []
    for kind, pk, at, root in ops:
        try:
            if kind == "block":
                db.check_and_insert_block_proposal(pk, at, root)
            else:
                db.check_and_insert_attestation(pk, at[0], at[1], root)
            out.append("ok")
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
    return out


def test_slashing_protection_rules_equal_the_reference():
    want = _apply(JDB(), _OPS)
    assert _apply(TDB(), _OPS) == want
    assert want.count("ok") == 8


def test_interchange_equals_the_reference_and_crosses_packages(tmp_path):
    gvr = b"\x99" * 32
    jdb, tdb = JDB(), TDB(str(tmp_path / "slashing.sqlite"))
    _apply(jdb, _OPS)
    _apply(tdb, _OPS)
    exported = tdb.export_interchange(gvr)
    assert exported == jdb.export_interchange(gvr)
    into_port, into_ref = TDB(), JDB()
    assert into_port.import_interchange(jdb.export_interchange(gvr),
                                        gvr) == 6
    assert into_ref.import_interchange(exported, gvr) == 6
    assert into_port.export_interchange(gvr) == exported
    with pytest.raises(SlashingProtectionError):
        into_port.check_and_insert_block_proposal(PK_A, 11, b"\xee" * 32)
    with pytest.raises(SlashingProtectionError, match="genesis"):
        into_port.import_interchange(exported, b"\x00" * 32)


# ---------------------------------------------------------------------------
# The validator client over both packages' chains
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def genesis():
    from lighthouse_tpu.testing.harness import StateHarness
    h = StateHarness(N_VALIDATORS)
    hdr = h.state.latest_block_header.copy()
    hdr.state_root = h.state.tree_hash_root()
    return _ser(h.state), hdr.tree_hash_root()


def _client(pkg: str, genesis, doppelganger=False):
    """(chain, ValidatorClient) of ``pkg`` at genesis, the client holding
    all interop keys over one ``InProcessBeaconNode``."""
    presets = _mod(pkg, "types.presets")
    factory = _mod(pkg, "types.factory")
    cs = _mod(pkg, "types.chain_spec")
    store = _mod(pkg, "store")
    bc = _mod(pkg, "beacon_chain")
    vc = _mod(pkg, "validator_client")
    gen = _mod(pkg, "state_transition.genesis")
    preset, T = presets.MINIMAL, factory.spec_types(presets.MINIMAL)
    spec = cs.ChainSpec.minimal().with_forks_at_genesis(cs.ForkName.CAPELLA)
    chain = bc.BeaconChain(
        store=store.HotColdDB.memory(preset, spec, T),
        genesis_state=T.state_cls(cs.ForkName.CAPELLA).deserialize(
            genesis[0]),
        genesis_block_root=genesis[1], preset=preset, spec=spec, T=T)
    keys = vc.ValidatorStore()
    for i in range(N_VALIDATORS):
        keys.add_validator(gen.interop_secret_key(i), index=i)
    log = _mod(pkg, "common.logging").test_logger()
    return chain, vc.ValidatorClient(keys, [vc.InProcessBeaconNode(chain)],
                                     preset, log=log,
                                     doppelganger=doppelganger)


def _slot_record(pkg: str, chain) -> tuple:
    """The head, its signed block's bytes and the op pool's count and
    bytes."""
    enc = _mod(pkg, "op_pool.persistence").encode_op_pool
    block = chain.store.get_block(chain.head.root)
    return (chain.head.root, chain.head.slot, _ser(block),
            chain.op_pool.num_attestations(), enc(chain.op_pool, chain.T))


@pytest.fixture(scope="module")
def runs(genesis):
    """Both packages' clients driven over slots 1-10: a record per slot."""
    out = {}
    for pkg in ("lighthouse_tpu", "lighthouse_tpu_torch"):
        chain, client = _client(pkg, genesis)
        recs = []
        for slot in range(1, SLOTS + 1):
            chain.per_slot_task(slot)
            client.on_slot(slot)
            recs.append(_slot_record(pkg, chain))
        out[pkg] = (chain, client, recs)
    return out


def test_validator_client_proposes_and_attests_side_by_side(runs):
    _, _, want = runs["lighthouse_tpu"]
    chain, client, got = runs["lighthouse_tpu_torch"]
    for slot, (g, w) in enumerate(zip(got, want), start=1):
        assert g == w, f"slot {slot}"
        assert g[1] == slot, f"no block at slot {slot}"
    assert chain.op_pool.num_attestations() > 0
    blocks = [chain.T.signed_block_cls(chain.spec.fork_name_at_epoch(0))
              .deserialize(r[2]) for r in got]
    assert any(len(b.message.body.attestations) for b in blocks)
    assert any(any(b.message.body.sync_aggregate.sync_committee_bits)
               for b in blocks)
    assert chain.proposer_preparations
    # the slashing database holds every proposal: a second block at a
    # proposed slot is refused
    store = client.store
    duty = client.duties.proposer_at(SLOTS)
    pk = next(p for p, i in store.index_by_pubkey.items()
              if i == duty.validator_index)
    with pytest.raises(SlashingProtectionError):
        store.slashing_db.check_and_insert_block_proposal(pk, SLOTS,
                                                          b"\xff" * 32)
    assert client.log.ring and client.log.stream is None


def test_doppelganger_blocks_then_releases_and_stays_released(genesis):
    heads = {}
    for pkg in ("lighthouse_tpu", "lighthouse_tpu_torch"):
        chain, client = _client(pkg, genesis, doppelganger=True)
        chain.per_slot_task(1)
        client.on_slot(1)
        assert chain.head.slot == 0, "signed while watching"
        for epoch in range(0, 4):
            client.doppelganger.check_epoch(epoch)
        assert client.doppelganger.complete
        assert not client.store.doppelganger_blocked
        chain.per_slot_task(2)
        client.on_slot(2)
        assert chain.head.slot == 2
        # the released client's own attestations show up as liveness
        for idx in client.store.indices():
            chain.observed_attesters.observe(3, int(idx))
        for _ in range(3):
            client.doppelganger.check_epoch(3)
            client.doppelganger.check_epoch(4)
        assert not client.store.doppelganger_blocked
        assert not client.doppelganger.detected
        heads[pkg] = _slot_record(pkg, chain)
    assert heads["lighthouse_tpu_torch"] == heads["lighthouse_tpu"]


def test_sync_committee_aggregate_equals_the_reference():
    """Real signatures: every sync-committee member signs the previous
    slot's block root through each package's ``ValidatorStore``; the
    port's ``SyncMessagePool`` aggregate equals the JAX package's and the
    harness's full-participation aggregate."""
    from lighthouse_tpu.state_transition.helpers import \
        get_block_root_at_slot
    from lighthouse_tpu.testing.harness import StateHarness
    h = StateHarness(N_VALIDATORS)
    h.extend_chain(2)
    state = h.state
    block_slot = int(state.slot)
    prev_slot = block_slot - 1
    root = get_block_root_at_slot(state, prev_slot, h.preset)
    pk_index = {state.validators.col("pubkey")[i].tobytes(): i
                for i in range(len(state.validators))}
    by_validator = {}
    for pos, pk in enumerate(state.current_sync_committee.pubkeys):
        by_validator.setdefault(pk_index[bytes(pk)], []).append(pos)
    aggs = {}
    jbls.set_backend("python")
    tbls.set_backend("python")
    try:
        for pkg in ("lighthouse_tpu", "lighthouse_tpu_torch"):
            vc = _mod(pkg, "validator_client")
            gen = _mod(pkg, "state_transition.genesis")
            preset = _mod(pkg, "types.presets").MINIMAL
            T = _mod(pkg, "types.factory").spec_types(preset)
            cs = _mod(pkg, "types.chain_spec")
            st = T.state_cls(cs.ForkName.CAPELLA).deserialize(_ser(state))
            keys = vc.ValidatorStore()
            for i in range(N_VALIDATORS):
                keys.add_validator(gen.interop_secret_key(i), index=i)
            pool = _mod(pkg, "beacon_chain.chain").SyncMessagePool(preset)
            for vi, positions in by_validator.items():
                pk = next(p for p, i in keys.index_by_pubkey.items()
                          if i == vi)
                sig = keys.sign_sync_committee_message(pk, prev_slot, root,
                                                       st, preset)
                pool.insert(prev_slot, root, positions, sig)
            aggs[pkg] = _ser(pool.aggregate(prev_slot, root, T))
        want = _ser(h.sync_aggregate_for(state, block_slot))
    finally:
        jbls.set_backend("fake")
        tbls.set_backend("fake")
    assert aggs["lighthouse_tpu_torch"] == aggs["lighthouse_tpu"] == want


def test_a_failing_node_ends_the_call():
    """``first_success`` skips unhealthy nodes and wraps the last node's
    error in ``BeaconNodeError``: with one node the error ends the call,
    as in the JAX package."""
    from lighthouse_tpu.validator_client import beacon_node as jbn
    from lighthouse_tpu_torch.validator_client import beacon_node as tbn

    class Node:
        def __init__(self, healthy):
            self.healthy = healthy

    def boom(node):
        raise ZeroDivisionError("node down")

    for bn in (jbn, tbn):
        with pytest.raises(bn.BeaconNodeError, match="node down"):
            bn.BeaconNodeFallback([Node(True)]).first_success(boom)
        with pytest.raises(bn.BeaconNodeError):
            bn.BeaconNodeFallback([Node(False)]).first_success(
                lambda node: 1)
        assert bn.BeaconNodeFallback([Node(False), Node(True)]) \
            .first_success(lambda node: node.healthy) is True
    with pytest.raises(tbn.BeaconNodeError) as err:
        tbn.BeaconNodeFallback([Node(True)]).first_success(boom)
    assert isinstance(err.value.__cause__, ZeroDivisionError)
