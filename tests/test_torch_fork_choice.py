"""Fork choice of the port on the CPU, against the JAX package's.

One seeded interleaving of the kind ``lighthouse_tpu/testing/
fork_choice_fuzz.py`` draws (block inserts with random parents, unknown
parents and FFG mismatches; attestation batches with stale re-votes and
unknown targets; equivocations; payload invalidation and validation;
pruning; head rounds with random balances, proposer boost and checkpoint
flips) drives five proto-arrays at once:

- the JAX package's host walk ``ProtoArrayForkChoice`` (the oracle);
- the port's host walk ``ProtoArrayForkChoice`` (the port's oracle, whose
  node types the port persists);
- the JAX package's ``DeviceProtoArrayForkChoice(engine="numpy")``;
- the port's ``DeviceProtoArrayForkChoice(engine="torch")`` on CPU
  tensors (the device round's torch ops, run on the CPU);
- the port's ``DeviceProtoArrayForkChoice(engine="numpy")``.

After every head round the head (or the same error), the weights,
best-child and best-descendant columns, the votes, the balances and the
index map are exactly equal across the five.  Bushy and chainy trees run,
the chainy one with ``jit_max_depth`` forced small so the torch engine's
host route runs (and is counted).  A persisted fork choice's bytes equal
the JAX ``encode_fork_choice``'s.  No JAX program runs: the JAX side is
its numpy engine and host oracle only.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.fork_choice import proto_array as JPA
from lighthouse_tpu.fork_choice.device_proto_array import \
    DeviceProtoArrayForkChoice as JDevice
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.fork_choice import proto_array as TPA
from lighthouse_tpu_torch.fork_choice.device_proto_array import \
    DeviceProtoArrayForkChoice as TDevice

ZERO = b"\x00" * 32


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = device.default_device()
    device.set_default_device("cpu")
    yield
    device.set_default_device(prev)


def _root(i: int) -> bytes:
    return int(i).to_bytes(4, "little") + b"\xab" * 28


class FiveWay:
    """One seeded interleaving applied to the five proto-arrays; every
    op's result (or error class name and message) must agree."""

    def __init__(self, seed: int, *, n_validators: int = 64,
                 prune_threshold: int = 4, chain_bias: float = 0.0,
                 jit_max_depth=None, with_host: bool = True):
        self.rng = np.random.default_rng(seed)
        self.nv = n_validators
        self.chain_bias = chain_bias
        self.last_root = None
        self.pas = [
            JPA.ProtoArrayForkChoice(prune_threshold=prune_threshold),
            TPA.ProtoArrayForkChoice(prune_threshold=prune_threshold),
            JDevice(prune_threshold=prune_threshold, engine="numpy"),
            TDevice(prune_threshold=prune_threshold, engine="torch",
                    jit_max_depth=jit_max_depth),
            TDevice(prune_threshold=prune_threshold, engine="numpy"),
        ]
        self.jax_numpy_pa = self.pas[2]
        self.torch_pa = self.pas[3]
        if not with_host:
            del self.pas[:2]
        self.host = self.pas[0]
        self.anchor = _root(0)
        self.next_id = 1
        self.slot = 1
        self.jcp = (1, _root(0))
        self.fcp = (1, _root(0))
        self.head_rounds = 0
        self.every(lambda pa: pa.on_block(
            slot=0, root=self.anchor, parent_root=ZERO,
            state_root=self.anchor, justified_epoch=1,
            justified_root=_root(0), finalized_epoch=1,
            finalized_root=_root(0), execution_status=JPA.EXEC_OPTIMISTIC))

    def every(self, fn, label: str = "op"):
        outs = []
        for pa in self.pas:
            try:
                outs.append(("ok", fn(pa)))
            except (JPA.ProtoArrayError, TPA.ProtoArrayError) as e:
                outs.append(("err", str(e)))
        assert all(o == outs[0] for o in outs), (label, outs)
        return outs[0]

    def pick(self) -> bytes:
        roots = list(self.host.indices)
        return roots[int(self.rng.integers(len(roots)))]

    def op_block(self) -> None:
        root = _root(self.next_id)
        self.next_id += 1
        self.slot += 1
        if self.last_root is not None and self.rng.random() < self.chain_bias \
                and self.last_root in self.host.indices:
            parent = self.last_root
        elif self.rng.random() < 0.06:
            parent = _root(10_000_000 + self.next_id)
        else:
            parent = self.pick()
        self.last_root = root
        je = 2 if self.rng.random() < 0.15 else 1
        self.every(lambda pa: pa.on_block(
            slot=self.slot, root=root, parent_root=parent, state_root=root,
            justified_epoch=je, justified_root=_root(0), finalized_epoch=1,
            finalized_root=_root(0), execution_status=JPA.EXEC_OPTIMISTIC))

    def op_attestation(self) -> None:
        k = int(self.rng.integers(1, 9))
        vals = self.rng.choice(self.nv, size=k, replace=False).astype(
            np.int64)
        epoch = int(self.rng.integers(0, 7))
        target = (_root(20_000_000) if self.rng.random() < 0.05
                  else self.pick())
        self.every(lambda pa: pa.process_attestation_batch(
            [(vals.copy(), target, epoch)]), "attestation")

    def op_equivocation(self) -> None:
        v = int(self.rng.integers(self.nv))
        self.every(lambda pa: pa.process_equivocation(v))

    def op_invalidate(self) -> None:
        root = self.pick()
        if root != self.anchor:
            self.every(lambda pa: pa.on_invalid_execution_payload(root))

    def op_validate(self) -> None:
        root = self.pick()
        self.every(lambda pa: pa.on_valid_execution_payload(root),
                   "on_valid")

    def op_prune(self) -> None:
        root = self.pick()
        self.every(lambda pa: pa.maybe_prune(root))
        if self.host.indices.get(root) == 0:
            self.anchor = root

    def op_head(self, *, skip_apply: bool = False) -> None:
        bal = self.rng.integers(0, 100, self.nv).astype(np.uint64)
        boost_root, boost_score = ZERO, 0
        if self.rng.random() < 0.3:
            boost_root = self.pick()
            boost_score = int(self.rng.integers(0, 50))
        if self.rng.random() < 0.1:
            self.jcp = (2, _root(0)) if self.jcp[0] == 1 else (1, _root(0))

        def run(pa):
            deltas = pa.compute_deltas(bal.copy())
            if skip_apply:
                return None
            pa.apply_score_changes(deltas, self.jcp, self.fcp, boost_root,
                                   boost_score, self.slot)
            return pa.find_head(self.anchor, self.slot)

        self.every(run, "head")
        if not skip_apply:
            self.head_rounds += 1
            self.compare()

    @staticmethod
    def node_rows(pa) -> list:
        if isinstance(pa, (JPA.ProtoArrayForkChoice,
                           TPA.ProtoArrayForkChoice)):
            return [(n.weight, n.best_child, n.best_descendant,
                     n.execution_status) for n in pa.nodes]
        c = pa.cols
        return [(int(c.weight[i]),
                 None if c.best_child[i] < 0 else int(c.best_child[i]),
                 None if c.best_desc[i] < 0 else int(c.best_desc[i]),
                 int(c.exec_status[i])) for i in range(c.n)]

    def compare(self) -> None:
        host = self.host
        want_nodes = self.node_rows(host)
        for pa in self.pas[1:]:
            assert dict(pa.indices) == dict(host.indices)
            assert self.node_rows(pa) == want_nodes
            for name in ("current", "next", "next_epoch"):
                a, b = getattr(host.votes, name), getattr(pa.votes, name)
                assert a.shape == b.shape and np.array_equal(a, b), name
            assert np.array_equal(host.old_balances, pa.old_balances)
            assert set(host.equivocating) == set(pa.equivocating)

    def run(self, *, blocks=30, atts=40, equivocations=3, invalidations=3,
            validations=3, prunes=2, head_rounds=10, lone_deltas=0) -> int:
        ops = (["block"] * blocks + ["att"] * atts
               + ["equiv"] * equivocations + ["invalid"] * invalidations
               + ["valid"] * validations + ["prune"] * prunes
               + ["head"] * head_rounds + ["deltas"] * lone_deltas)
        self.rng.shuffle(ops)
        fns = {"block": self.op_block, "att": self.op_attestation,
               "equiv": self.op_equivocation, "invalid": self.op_invalidate,
               "valid": self.op_validate, "prune": self.op_prune,
               "head": self.op_head,
               "deltas": lambda: self.op_head(skip_apply=True)}
        for op in ops:
            fns[op]()
        self.op_head()
        return self.head_rounds


@pytest.mark.parametrize("seed", range(12))
def test_bushy_interleavings_agree_exactly(seed):
    run = FiveWay(seed)
    assert run.run() >= 11
    assert run.torch_pa.host_rounds == 0
    assert run.torch_pa.engine == "torch"


@pytest.mark.parametrize("seed", range(3))
def test_chainy_interleavings_take_the_host_route(seed):
    """Chain-shaped growth past a forced-small depth: rounds past it run
    on the host with the device mirrors kept moving, later shallow rounds
    on the torch engine again, and all five agree."""
    run = FiveWay(100 + seed, chain_bias=0.9, prune_threshold=64,
                  jit_max_depth=6)
    run.run(blocks=40, head_rounds=12, prunes=0)
    assert run.torch_pa.host_rounds > 0


@pytest.mark.parametrize("seed", range(3))
def test_compute_deltas_without_apply_moves_the_device_mirror(seed):
    """``compute_deltas`` with no ``apply_score_changes`` after it: the
    host-side columns move votes and balances, and so must the torch
    engine's device mirror.  Held against the JAX package's numpy engine
    (the host walks keep weights of their own across a discarded round)."""
    run = FiveWay(200 + seed, with_host=False)
    assert run.run(lone_deltas=6) >= 11


def test_validator_bucket_growth_before_flush():
    """A buffered vote crosses the pow-2 validator bucket before the
    flush: the device mirror is rebuilt for the post-flush size."""
    run = FiveWay(7, n_validators=20)
    for _ in range(4):
        run.op_block()
    run.op_head()
    run.nv = 40                      # later votes reach validator 39
    for _ in range(6):
        run.op_attestation()
    run.op_head()
    run.op_head()
    assert run.torch_pa._mirror is not None
    assert run.torch_pa._mirror.nv_pad >= 40


def test_torch_engine_columns_are_torch_tensors_and_copy_on_write():
    """The torch round keeps its mirrors as tensors on the port's device,
    and a vote scatter after a round writes a fresh ``nxt`` column, never
    the ``cur`` column the round aliased."""
    run = FiveWay(11)
    for _ in range(5):
        run.op_block()
    for _ in range(5):
        run.op_attestation()
    run.op_head()
    mir = run.torch_pa._mirror
    assert isinstance(mir.cur, torch.Tensor) and mir.cur is mir.nxt
    before = mir.cur.clone()
    held = mir.cur
    run.op_attestation()
    run.torch_pa.votes                     # flushes the buffer
    assert mir.nxt is not held and torch.equal(held, before)
    run.op_head()


def test_unknown_engine_raises():
    with pytest.raises(ValueError):
        TDevice(engine="jit")


def test_persistence_bytes_equal_the_jax_encoding():
    """``encode_fork_choice`` of a port ForkChoice equals the JAX one's
    after the same blocks, votes and head rounds; each decodes the other's
    bytes back to the same encoding."""
    from lighthouse_tpu.fork_choice import persistence as JP
    from lighthouse_tpu.fork_choice.fork_choice import ForkChoice as JFC
    from lighthouse_tpu_torch.fork_choice import persistence as TP
    from lighthouse_tpu_torch.fork_choice.fork_choice import ForkChoice as TFC

    run = FiveWay(21)
    run.run(blocks=20, atts=20, prunes=0, invalidations=0)
    fcs = []
    for FC, pa in ((JFC, run.jax_numpy_pa), (TFC, run.torch_pa)):
        fc = FC.__new__(FC)
        fc.preset, fc.spec, fc.proto = None, None, pa
        fc.justified_state = None
        fc.justified_checkpoint = (3, _root(1))
        fc.finalized_checkpoint = (2, _root(0))
        fc.proposer_boost_root = _root(2)
        fc.current_slot = run.slot
        fc.queued = []
        fcs.append(fc)
    from lighthouse_tpu.fork_choice.fork_choice import \
        QueuedAttestation as JQ
    from lighthouse_tpu_torch.fork_choice.fork_choice import \
        QueuedAttestation as TQ
    for fc, Q in ((fcs[0], JQ), (fcs[1], TQ)):
        fc.queued.append(Q(slot=run.slot, indices=np.arange(5, dtype=np.int64),
                           block_root=_root(1), target_epoch=3))
    jb = JP.encode_fork_choice(fcs[0])
    tb = TP.encode_fork_choice(fcs[1])
    assert jb == tb
    back = TP.decode_fork_choice(jb, preset=None, spec=None,
                                 justified_state=None)
    assert TP.encode_fork_choice(back) == jb
    assert JP.encode_fork_choice(JP.decode_fork_choice(
        tb, preset=None, spec=None, justified_state=None)) == tb


def test_fork_choice_builds_and_resumes_on_the_columnar_engine():
    """``ForkChoice`` has one route: it builds the columnar engine, and a
    decoded fork choice resumes on it with the persisted columns and the
    same head as the live one."""
    from lighthouse_tpu_torch.fork_choice import persistence as TP
    from lighthouse_tpu_torch.fork_choice.fork_choice import ForkChoice as TFC

    run = FiveWay(31)
    run.run(blocks=12, atts=12, prunes=0, invalidations=0)
    fc = TFC.__new__(TFC)
    fc.preset, fc.spec, fc.proto = None, None, run.torch_pa
    fc.justified_state = None
    fc.justified_checkpoint = run.jcp
    fc.finalized_checkpoint = run.fcp
    fc.proposer_boost_root = ZERO
    fc.current_slot = run.slot
    fc.queued = []
    back = TP.decode_fork_choice(TP.encode_fork_choice(fc), preset=None,
                                 spec=None, justified_state=None)
    assert isinstance(back.proto, TDevice)
    assert back.proto.engine == "numpy"          # the CPU's engine
    assert FiveWay.node_rows(back.proto) == FiveWay.node_rows(run.torch_pa)
    bal = run.rng.integers(0, 100, run.nv).astype(np.uint64)
    heads = []
    for pa in (run.torch_pa, back.proto):
        deltas = pa.compute_deltas(bal.copy())
        pa.apply_score_changes(deltas, run.jcp, run.fcp, ZERO, 0, run.slot)
        heads.append(pa.find_head(run.anchor, run.slot))
    assert heads[0] == heads[1]
    assert FiveWay.node_rows(back.proto) == FiveWay.node_rows(run.torch_pa)
