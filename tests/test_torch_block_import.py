"""Block import through the port's three stages, on the CPU, against the
JAX package's stages.

A real-signature MINIMAL Capella chain (64 validators, about 10 blocks) is
built by the port's ``StateHarness`` under the port's python BLS backend.
Each block is imported by the port's ``BeaconChain.process_block``
(``GossipVerifiedBlock`` → ``SignatureVerifiedBlock`` → ``ExecutedBlock``,
then fork choice and the store); every post-state root must equal the
block's ``state_root`` (the stage checks it) and the final state must
equal the harness's byte for byte.

- The overlapped dispatch and the synchronous oracle
  (``LIGHTHOUSE_TPU_OVERLAP_BLOCK_SIGS=0``) give the same states and
  verdicts.
- Each tamper class (a wrong attestation signature, a wrong
  ``state_root``, a wrong proposal signature) raises the same error class
  from the port's stages as from the JAX package's stages on the same
  bytes (the JAX side gets the parent state and the block by SSZ bytes,
  and starts its ``BeaconChain`` from that parent with
  ``from_checkpoint``).
- An exception on the signature worker re-raises at ``join()`` and at the
  import, and no host backend is asked for a verdict in its place.

All comparisons are exact.
"""

import importlib

import pytest
import torch

from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import bls as tbls
from lighthouse_tpu_torch.crypto import native
from lighthouse_tpu_torch.state_transition import SignatureStrategy
from lighthouse_tpu_torch.state_transition import sig_dispatch as SD
from lighthouse_tpu_torch.testing import StateHarness
from lighthouse_tpu_torch.types.carry import signed_block_from_ssz

pytestmark = pytest.mark.usefixtures("pin_device_path")

N_BLOCKS = 10


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    device.set_default_device(prev)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def python_backends():
    """Both packages on their python (real pairing) backends for the
    module; the previous choices come back after it."""
    jbls = importlib.import_module("lighthouse_tpu.crypto.bls")
    prev = (tbls._active, jbls._active)
    native.available(block=True)
    tbls.set_backend("python")
    jbls.set_backend("python")
    yield
    tbls._active, jbls._active = prev


def _ser(obj) -> bytes:
    return type(obj).serialize(obj)


def _chain_of(pkg: str, anchor, preset, spec, T, anchor_block=None):
    """A ``BeaconChain`` of ``pkg`` over an in-memory store: from genesis
    (``anchor`` a genesis state), or from ``anchor_block`` and its
    post-state ``anchor`` (``from_checkpoint``)."""
    bc = importlib.import_module(f"{pkg}.beacon_chain")
    store = importlib.import_module(f"{pkg}.store")
    db = store.HotColdDB.memory(preset, spec, T)
    if anchor_block is not None:
        return bc.BeaconChain.from_checkpoint(
            store=db, anchor_state=anchor, anchor_block=anchor_block,
            preset=preset, spec=spec, T=T)
    hdr = anchor.latest_block_header.copy()
    hdr.state_root = anchor.tree_hash_root()
    return bc.BeaconChain(store=db, genesis_state=anchor,
                          genesis_block_root=hdr.tree_hash_root(),
                          preset=preset, spec=spec, T=T)


def import_block(chain, signed_block):
    """Tick the chain to the block's slot, import the block, and return
    its post-state."""
    chain.per_slot_task(int(signed_block.message.slot))
    root = chain.process_block(signed_block)
    assert chain.head.root == root
    return chain.state_at_block_root(root)


@pytest.fixture(scope="module")
def real_chain(python_backends):
    """(genesis state, signed blocks, harness) of a real-signature chain
    with an exit and a proposer slashing among its blocks."""
    h = StateHarness(64)
    h.spec.shard_committee_period = 0
    genesis = h.state.copy()
    blocks = []
    for i in range(N_BLOCKS):
        kw = {}
        if i == 3:
            kw["voluntary_exits"] = [h.make_exit(h.state, 5)]
        if i == 5:
            kw["proposer_slashings"] = [h.make_proposer_slashing(h.state, 3)]
        sb = h.build_block(**kw)
        h.apply_block(sb, strategy=SignatureStrategy.NO_VERIFICATION)
        blocks.append(sb)
    return genesis, blocks, h


def _port_chain(genesis, h):
    return _chain_of("lighthouse_tpu_torch", genesis.copy(), h.preset,
                     h.spec, h.T)


def _import_all(chain, blocks) -> list:
    out = []
    for sb in blocks:
        st = import_block(chain, sb)
        out.append((_ser(st), dict(SD.LAST_SIG_DISPATCH)))
    return out


@pytest.fixture(scope="module")
def overlapped_import(real_chain):
    genesis, blocks, h = real_chain
    return _import_all(_port_chain(genesis, h), blocks)


def test_three_stages_import_the_real_chain(real_chain, overlapped_import):
    genesis, blocks, h = real_chain
    assert overlapped_import[-1][0] == _ser(h.state)
    for _, stats in overlapped_import:
        assert stats["overlapped"] is True and stats["path"] == "python"
        for key in ("device_verify_ms", "join_wait_ms",
                    "overlap_efficiency", "path"):
            assert key in stats


def test_traced_import_records_the_stages(real_chain):
    """With the tracer on, one import records the three stages' spans,
    the block's phase split as children of the transition span, and the
    worker's verify span adopted from the importing thread."""
    from lighthouse_tpu_torch.common.tracing import TRACER
    genesis, blocks, h = real_chain
    slot = int(blocks[0].message.slot)
    TRACER.reset()
    TRACER.set_slot(slot)
    TRACER.enable()
    try:
        import_block(_port_chain(genesis, h), blocks[0])
    finally:
        TRACER.disable()
    spans = TRACER.slot_spans(slot)
    by_name = {s["name"]: s for s in spans}
    for name in ("gossip_verify", "state_transition", "post_state_root",
                 "sig_dispatch", "sig_device_verify", "sig_join",
                 "block:header", "block:operations"):
        assert name in by_name, (name, sorted(by_name))
    st = by_name["state_transition"]
    assert by_name["block:header"]["parent"] == st["id"]
    worker = by_name["sig_device_verify"]
    assert worker["attrs"]["adopted"] is True
    assert worker["thread"] == "block-sig-verify"
    assert TRACER.stage_split("block_sigs")["path"] == "python"


def test_overlapped_and_synchronous_agree(real_chain, overlapped_import,
                                          monkeypatch):
    genesis, blocks, h = real_chain
    monkeypatch.setenv("LIGHTHOUSE_TPU_OVERLAP_BLOCK_SIGS", "0")
    sync = _import_all(_port_chain(genesis, h), blocks)
    assert [s for s, _ in sync] == [s for s, _ in overlapped_import]
    assert all(st["path"] == "sync" and st["overlapped"] is False
               for _, st in sync)


def _resign(h, block, parent_state):
    """``block`` signed by its proposer over the parent state's domain."""
    from lighthouse_tpu_torch.state_transition import interop_secret_key
    from lighthouse_tpu_torch.state_transition.helpers import (
        compute_epoch_at_slot, compute_signing_root, get_domain)
    from lighthouse_tpu_torch.types import Domain
    epoch = compute_epoch_at_slot(int(block.slot), h.preset.SLOTS_PER_EPOCH)
    domain = get_domain(parent_state, Domain.BEACON_PROPOSER, epoch,
                        h.preset)
    return interop_secret_key(int(block.proposer_index)).sign(
        compute_signing_root(block, domain)).serialize()


def _tamper(kind: str, h, sb, parent_state) -> bytes:
    """The SSZ bytes of ``sb`` with one tamper of ``kind``."""
    from lighthouse_tpu_torch.state_transition import interop_secret_key
    fork = h.fork_at(int(sb.message.slot))
    t = signed_block_from_ssz(_ser(sb), "minimal", fork)
    wrong = interop_secret_key(1).sign(b"\x5a" * 32).serialize()
    if kind == "attestation_signature":
        t.message.body.attestations[0].signature = wrong
        t.signature = _resign(h, t.message, parent_state)
    elif kind == "state_root":
        t.message.state_root = b"\x33" * 32
        t.signature = _resign(h, t.message, parent_state)
    else:
        t.signature = wrong
    return _ser(t)


_TAMPERS = {"attestation_signature": "InvalidSignatures",
            "state_root": "StateRootMismatch",
            "proposal_signature": "ProposalSignatureInvalid"}


@pytest.mark.parametrize("kind", sorted(_TAMPERS))
def test_tampered_block_raises_reference_error_class(real_chain, kind):
    """Import the chain up to block 6, tamper block 7, and import it
    through both packages' stages from the same parent bytes."""
    from lighthouse_tpu.types.factory import spec_types as jspec_types
    from lighthouse_tpu.types.presets import MINIMAL as JMINIMAL
    from lighthouse_tpu.types.chain_spec import ChainSpec as JChainSpec
    from lighthouse_tpu.types.chain_spec import ForkName as JForkName
    genesis, blocks, h = real_chain
    k = 7
    port = _port_chain(genesis, h)
    for sb in blocks[:k]:
        parent = import_block(port, sb)
    assert len(blocks[k].message.body.attestations) > 0
    data = _tamper(kind, h, blocks[k], parent)

    JT = jspec_types(JMINIMAL)
    jspec = JChainSpec.minimal().with_forks_at_genesis(JForkName.CAPELLA)
    jspec.shard_committee_period = 0
    fork = h.fork_at(int(blocks[k].message.slot)).value
    jparent = JT.state_cls(JForkName(fork)).deserialize(_ser(parent))
    janchor = JT.signed_block_cls(JForkName(fork)).deserialize(
        _ser(blocks[k - 1]))
    ref = _chain_of("lighthouse_tpu", jparent, JMINIMAL, jspec, JT,
                    anchor_block=janchor)
    jblock = JT.signed_block_cls(JForkName(fork)).deserialize(data)

    errs = []
    for chain, block in ((port, signed_block_from_ssz(data, "minimal", fork)),
                         (ref, jblock)):
        with pytest.raises(Exception) as ei:
            import_block(chain, block)
        errs.append(type(ei.value))
    assert [e.__name__ for e in errs] == [_TAMPERS[kind]] * 2
    assert errs[0].__module__.startswith("lighthouse_tpu_torch.")
    assert errs[1].__module__.startswith("lighthouse_tpu.")


def test_verifier_exception_reraises_at_join_without_host_verdict(
        real_chain, monkeypatch):
    """A failing device verify raises at ``join()`` and out of the
    import; neither host backend is asked for a verdict."""
    from lighthouse_tpu_torch.crypto import tpu_backend
    genesis, blocks, h = real_chain

    def host_called(*a, **k):
        raise AssertionError("a host backend was asked for a verdict")

    monkeypatch.setattr(tbls.PythonBackend, "verify_signature_sets",
                        host_called)
    monkeypatch.setattr(tbls.FakeBackend, "verify_signature_sets",
                        host_called)

    batch = SD.BlockSigDispatcher(
        device_fn=lambda sets: 1 / 0).submit([], slot=1)
    with pytest.raises(ZeroDivisionError):
        batch.join()
    assert batch.stats["path"] == "error"

    def device_lost(self, sets):
        if len(sets) > 1:        # the block batch, not the gossip set
            raise RuntimeError("device lost")
        return True

    monkeypatch.setattr(tpu_backend.TpuBackend, "verify_signature_sets",
                        device_lost)
    tbls.set_backend("tpu")
    try:
        chain = _port_chain(genesis, h)
        with pytest.raises(RuntimeError, match="device lost"):
            import_block(chain, blocks[0])
        assert SD.LAST_SIG_DISPATCH["path"] == "error"
    finally:
        tbls.set_backend("python")


def test_harness_votes_its_deposit_in(python_backends):
    """The port's harness carries a deposit through eth1 voting: blocks
    vote for the deposit tree's ``eth1_data`` and the block whose vote
    makes the majority includes the deposit.  The chain imports through
    the three stages from genesis, every import on the state the one
    before produced, and ends byte-equal to the harness's state."""
    prev = tbls._active
    tbls.set_backend("fake")
    try:
        h = StateHarness(64)
        genesis = h.state.copy()
        h.make_deposit(64)
        needed = (h.preset.EPOCHS_PER_ETH1_VOTING_PERIOD
                  * h.preset.SLOTS_PER_EPOCH)
        blocks = []
        while h.pending_deposits:
            sb = h.build_block()
            h.apply_block(sb, strategy=SignatureStrategy.NO_VERIFICATION)
            blocks.append(sb)
        assert len(blocks) == needed // 2 + 1
        assert [len(sb.message.body.deposits) for sb in blocks] == \
            [0] * (len(blocks) - 1) + [1]
        assert len(h.state.validators) == 65
        assert int(h.state.eth1_data.deposit_count) == 65
        chain = _port_chain(genesis, h)
        for sb in blocks:
            post = import_block(chain, sb)
        assert _ser(post) == _ser(h.state)
    finally:
        tbls._active = prev


def test_device_backend_imports_a_block(real_chain, monkeypatch):
    """One block through the stages on the port's ``tpu`` backend (its
    plain versions on CPU tensors): the gossip stage's single set takes
    the native host fast path, the block batch the device route on the
    signature worker, and the verdict and post-state match the python
    backend's import."""
    from lighthouse_tpu_torch.crypto import tpu_backend  # noqa: F401
    genesis, blocks, h = real_chain
    monkeypatch.setenv("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX", "1")
    tbls.set_backend("tpu")
    try:
        st = import_block(_port_chain(genesis, h), blocks[0])
    finally:
        tbls.set_backend("python")
    stats = dict(SD.LAST_SIG_DISPATCH)
    assert stats["path"] == "device" and stats["overlapped"] is True
    assert stats["sets"] >= 4
    want = import_block(_port_chain(genesis, h), blocks[0])
    assert _ser(st) == _ser(want)
