"""Epoch-batched replay: a WINDOW of already-downloaded blocks applied
as one device-program-shaped unit instead of N serial imports.

The serial :class:`~.block_replayer.BlockReplayer` applies one block at a
time through the full import path — per-block signature dispatch,
per-slot state-root hashing — so catching up from months behind runs at
host rate while the sharded BLS path and the device-resident columns sit
idle.  :class:`EpochReplayer` fuses three things across the window
(Lighthouse ``block_replayer.rs`` generalized to a batch):

1. **Signatures** — every block runs under
   ``SignatureStrategy.BATCH_DEFERRED``: the per-block
   :class:`~.per_block.SigAccumulator` collects its sets without
   verifying, the window owner concatenates them and dispatches ONE
   batch through :mod:`.sig_dispatch` (onto the card's BLS kernels when
   the ``tpu`` backend is active).  The verdict gates commit of the WHOLE window; on
   ``False`` the per-block set slices are re-verified serially to name
   the exact offending block (:class:`WindowSignaturesInvalid`).
2. **State roots** — per-slot ``tree_hash_root`` collapses to known
   roots: the caller's ``state_root_fn`` (store-fed) where present, else
   the blocks' own claimed ``state_root``s; ONE root is computed at the
   window boundary and checked against the final block's claim.  On
   mismatch the serial :class:`BlockReplayer` oracle re-runs from the
   saved pre-state with full hashing to bisect the offending block
   (:class:`WindowRootMismatch`).
3. **Scatters** — the participation/balance/inactivity column writes of
   the whole window land on the device-resident state
   (``types/device_state.py`` coalesces dirty indices across blocks; the
   epoch sweep at window-internal boundaries is the existing single-pass
   path), so the window compiles to a handful of device programs.

Timings for the last window land in :data:`LAST_REPLAY_TIMINGS`
(``collect_ms`` / ``apply_ms`` / ``root_ms`` / ``verify_ms``), surfaced
via ``tracing.stage_split("replay")`` and a ``replay`` device-ledger
family with a per-window transfer budget
(:data:`~..common.device_ledger.REPLAY_WINDOW_BUDGET`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..common.knobs import knob_tribool
from ..crypto import bls as B
from .block_replayer import BlockReplayer
from .per_block import (
    BlockProcessingError,
    SignatureStrategy,
    process_block,
)
from .per_slot import process_slots

# Windows shorter than this stay serial under the "auto" knob setting:
# one dispatch + one boundary root amortize over too few blocks to beat
# the plain path.
MIN_BATCH_WINDOW = 4

# Wall-time decomposition of the most recent replay window plus the
# cumulative window counters — read via tracing.stage_split("replay").
# ``*_ms`` keys become child spans of the enclosing span; ``path`` is
# "batched" / "serial" / "fell_back".
LAST_REPLAY_TIMINGS: dict = {}

# Cumulative across windows (merged into the stage dict on publish):
# the simulator's partition-heal scenario asserts batched_windows > 0
# to prove the healed node actually caught up through this path.
_COUNTERS = {"batched_windows": 0, "serial_windows": 0, "fallbacks": 0}


def batch_replay_enabled(n_blocks: Optional[int] = None) -> bool:
    """Resolve the ``LIGHTHOUSE_TPU_BATCH_REPLAY`` tribool: forced
    on/off wins; auto batches windows of >= :data:`MIN_BATCH_WINDOW`."""
    forced = knob_tribool("LIGHTHOUSE_TPU_BATCH_REPLAY")
    if forced is not None:
        return forced
    return n_blocks is None or n_blocks >= MIN_BATCH_WINDOW


def known_roots_fn(blocks: Sequence) -> Callable[[int], Optional[bytes]]:
    """``state_root_fn`` from a block window's CLAIMED state roots: the
    post-state at a block's slot has exactly that block's
    ``message.state_root`` (empty slots return None and fall back to
    hashing).  Safe for already-imported chains (the claim was checked
    at import); untrusted windows are caught by the boundary-root check
    + serial bisect."""
    roots = {int(b.message.slot): bytes(b.message.state_root)
             for b in blocks}
    return lambda slot: roots.get(int(slot))


class WindowError(BlockProcessingError):
    """Batched-window failure naming the offending block where known."""

    def __init__(self, msg: str, *, block_root: Optional[bytes] = None,
                 slot: Optional[int] = None):
        super().__init__(msg)
        self.block_root = block_root
        self.slot = slot


class WindowSignaturesInvalid(WindowError):
    """The window batch verdict was False; bisect named the block."""


class WindowRootMismatch(WindowError):
    """Boundary root disagreed with the final claim; the serial oracle
    named the block whose claimed state_root is wrong."""


class WindowBlockInvalid(WindowError):
    """A block failed the state transition itself (bad proposer, bad
    operation, …) while applying the window."""


def _set_bytes(sets: Sequence[B.SignatureSet]) -> int:
    # Marshalled device footprint: 32 B message + 96 B signature +
    # 48 B per signing key (compressed points; decompression happens
    # on-device in the sharded path).
    return sum(32 + 96 + 48 * len(s.signing_keys) for s in sets)


def _publish(timings: dict) -> None:
    from ..common.tracing import TRACER
    LAST_REPLAY_TIMINGS.clear()
    LAST_REPLAY_TIMINGS.update(timings)
    LAST_REPLAY_TIMINGS.update(_COUNTERS)
    TRACER.record_stages("replay", cat="state_transition")


class EpochReplayer:
    """Builder-style batched replayer: configure, then
    :meth:`apply_window`.

    ``verify_signatures=True`` collects every block's sets and verifies
    them as ONE batch whose verdict gates the whole window; off, the
    window replays trusted blocks (store rebuild) with no signature
    work.  ``state_root_fn`` supplies store-known roots; the blocks' own
    claimed roots fill the gaps.  ``post_block_hook(state, signed)``
    fires after each block's transition (callers snapshot per-block
    post-states for import) — note the hook runs BEFORE the window
    verdict; consumers must not commit snapshots until
    :meth:`apply_window` returns.
    """

    def __init__(self, state, preset, spec, T, *,
                 verify_signatures: bool = False,
                 state_root_fn: Optional[Callable[[int], Optional[bytes]]] = None,
                 pubkey_cache=None,
                 sig_dispatcher=None,
                 boundary_root_check: bool = True):
        self.state = state
        self.preset = preset
        self.spec = spec
        self.T = T
        self.verify_signatures = verify_signatures
        self.state_root_fn = state_root_fn
        self.pubkey_cache = pubkey_cache
        self.sig_dispatcher = sig_dispatcher
        self.boundary_root_check = boundary_root_check
        self.post_block_hook: Optional[Callable] = None

    # -- internals ----------------------------------------------------

    def _root_fn(self, blocks: Sequence) -> Callable[[int], Optional[bytes]]:
        known = known_roots_fn(blocks)
        caller = self.state_root_fn
        if caller is None:
            return known
        return lambda slot: caller(slot) or known(slot)

    def _apply(self, state, blocks: Sequence, root_fn, strategy,
               sets: Optional[List[B.SignatureSet]],
               slices: Optional[List[Tuple[int, int, int, int]]]):
        """The fused forward pass.  Mutates ``state`` through the window;
        harvests each block's signature sets into ``sets`` with per-block
        ``(index, slot, start, end)`` slices for the bisect path."""
        for i, signed in enumerate(blocks):
            slot = int(signed.message.slot)
            if slot <= int(state.slot):
                raise ValueError(
                    f"window block slot {slot} not after state slot "
                    f"{int(state.slot)}")
            state = process_slots(state, slot, self.preset, self.spec,
                                  self.T, state_root_fn=root_fn)
            fork = self.spec.fork_name_at_epoch(
                slot // self.preset.SLOTS_PER_EPOCH)
            try:
                acc = process_block(
                    state, signed, fork, self.preset, self.spec, self.T,
                    strategy=strategy, pubkey_cache=self.pubkey_cache,
                    defer_sig_join=True)
            except WindowError:
                raise
            except (BlockProcessingError, ValueError) as e:
                raise WindowBlockInvalid(
                    f"block at slot {slot} failed the window transition: "
                    f"{e}", slot=slot,
                    block_root=bytes(signed.message.tree_hash_root()),
                ) from e
            if sets is not None and acc is not None and acc.sets:
                start = len(sets)
                sets.extend(acc.sets)
                slices.append((i, slot, start, len(sets)))
            if self.post_block_hook is not None:
                self.post_block_hook(state, signed)
        return state

    def _bisect_signatures(self, blocks, sets, slices) -> None:
        """Batch verdict was False: re-verify per-block slices serially
        to name the offender (the differential tests pin exactness)."""
        for i, slot, start, end in slices:
            if not B.verify_signature_sets(sets[start:end]):
                raise WindowSignaturesInvalid(
                    f"window signature batch invalid: block at slot "
                    f"{slot} (index {i}) fails",
                    slot=slot,
                    block_root=bytes(blocks[i].message.tree_hash_root()))
        # Every slice passes individually yet the batch failed — a
        # backend inconsistency, not a nameable block.  Still reject.
        raise WindowSignaturesInvalid(
            "window signature batch invalid (no single block names the "
            "failure)")

    def _bisect_roots(self, pre_state, blocks, target_slot):
        """Boundary root mismatched: replay serially from the saved
        pre-state with FULL hashing, checking each block's claimed
        state_root, to name the first lying block.  If every claim
        matches the serial computation, the batched path itself diverged
        — the serial state is authoritative (``path="fell_back"``)."""
        _COUNTERS["fallbacks"] += 1
        state = pre_state
        rep = BlockReplayer(state, self.preset, self.spec, self.T,
                            strategy=SignatureStrategy.NO_VERIFICATION)
        for signed in blocks:
            rep.apply_blocks([signed])
            computed = bytes(rep.state.tree_hash_root())
            claimed = bytes(signed.message.state_root)
            if computed != claimed:
                raise WindowRootMismatch(
                    f"block at slot {int(signed.message.slot)} claims "
                    f"state root {claimed.hex()[:16]}… but the serial "
                    f"oracle computes {computed.hex()[:16]}…",
                    slot=int(signed.message.slot),
                    block_root=bytes(signed.message.tree_hash_root()))
        if target_slot is not None and target_slot > int(rep.state.slot):
            rep.apply_blocks([], target_slot=target_slot)
        return rep.state

    # -- public -------------------------------------------------------

    def apply_window(self, blocks: Sequence, target_slot: Optional[int] = None):
        """Apply ``blocks`` (slot-ascending, parent-linked) as one
        window, then optionally advance to ``target_slot``.  Returns the
        final state only after the window verdict (signatures + boundary
        root) passes — a failed window raises a typed
        :class:`WindowError` and commits nothing."""
        blocks = list(blocks)
        if not blocks:
            if target_slot is not None and target_slot > int(self.state.slot):
                self.state = process_slots(
                    self.state, target_slot, self.preset, self.spec,
                    self.T, state_root_fn=self.state_root_fn)
            return self.state

        verify = self.verify_signatures
        # The saved pre-state feeds the serial root-bisect oracle; the
        # boundary check is the only consumer.
        pre_state = self.state.copy() if self.boundary_root_check else None
        root_fn = self._root_fn(blocks)
        strategy = (SignatureStrategy.BATCH_DEFERRED if verify
                    else SignatureStrategy.NO_VERIFICATION)
        sets: Optional[List[B.SignatureSet]] = [] if verify else None
        slices: Optional[List[Tuple[int, int, int, int]]] = \
            [] if verify else None

        t0 = time.perf_counter()
        state = self._apply(self.state, blocks, root_fn, strategy,
                            sets, slices)
        t1 = time.perf_counter()

        # ONE window-wide dispatch: the batch verifies on a worker
        # thread (onto the card on the tpu backend) while the boundary root
        # hashes below.
        batch = None
        if verify and sets:
            from .sig_dispatch import get_dispatcher
            dispatcher = self.sig_dispatcher or get_dispatcher()
            batch = dispatcher.submit(sets, slot=int(blocks[-1].message.slot))
        t2 = time.perf_counter()

        # ONE computed root at the boundary (vs one per block serially),
        # checked against the final block's claim.
        boundary_ok = True
        if self.boundary_root_check:
            boundary_ok = (bytes(state.tree_hash_root())
                           == bytes(blocks[-1].message.state_root))
        t3 = time.perf_counter()

        verdict = True
        if batch is not None:
            try:
                verdict = batch.join()
            except Exception as e:
                raise WindowSignaturesInvalid(
                    f"window signature dispatch failed: {e}") from e
        t4 = time.perf_counter()

        timings = {
            "apply_ms": round((t1 - t0) * 1e3, 3),
            "collect_ms": round((t2 - t1) * 1e3, 3),
            "root_ms": round((t3 - t2) * 1e3, 3),
            "verify_ms": round((t4 - t3) * 1e3, 3),
            "blocks": len(blocks),
            "sets": len(sets) if sets else 0,
            "path": "batched",
        }
        if batch is not None:
            h2d = _set_bytes(sets)
            from ..common.device_ledger import (LEDGER,
                                                REPLAY_WINDOW_BUDGET)
            LEDGER.note_dispatch("replay", timings["verify_ms"])
            timings["window_h2d_bytes"] = h2d
            timings["budget_ok"] = h2d <= REPLAY_WINDOW_BUDGET["h2d_bytes"]

        if not verdict:
            _publish(dict(timings, path="rejected"))
            self._bisect_signatures(blocks, sets, slices)

        if not boundary_ok:
            # Serial oracle from the saved pre-state: names the lying
            # block, or supersedes the batched state if every claim
            # checks out (a batched-path divergence).
            state = self._bisect_roots(pre_state, blocks, target_slot)
            _COUNTERS["batched_windows"] += 1
            _publish(dict(timings, path="fell_back"))
            self.state = state
            return state

        if target_slot is not None and target_slot > int(state.slot):
            state = process_slots(state, target_slot, self.preset,
                                  self.spec, self.T, state_root_fn=root_fn)

        _COUNTERS["batched_windows"] += 1
        _publish(timings)
        self.state = state
        return state


def replay_states(base_state, pairs: Sequence[Tuple[bytes, object]],
                  preset, spec, T, *,
                  state_root_fn=None) -> Dict[bytes, object]:
    """Batched trusted replay of a parent-linked run of stored blocks:
    returns ``{block_root: post_state copy}`` for every block in
    ``pairs`` (``(root, signed_block)`` slot-ascending).  The recovery
    rebuild uses this to prime per-block states in ONE window instead of
    one O(summary-replay) store fetch per block.  Mutates (a copy of)
    ``base_state``; no signature work, no boundary check — the blocks
    were committed by a prior import."""
    out: Dict[bytes, object] = {}
    roots = [r for r, _ in pairs]
    rep = EpochReplayer(base_state.copy(), preset, spec, T,
                        verify_signatures=False,
                        state_root_fn=state_root_fn,
                        boundary_root_check=False)
    idx = {"i": 0}

    def hook(state, signed) -> None:
        out[roots[idx["i"]]] = state.copy()
        idx["i"] += 1

    rep.post_block_hook = hook
    rep.apply_window([b for _, b in pairs])
    return out


def note_serial_window() -> None:
    """Consumers on the knob-off / short-window serial path record the
    window here so the batched-vs-serial split stays visible in the
    stage counters."""
    _COUNTERS["serial_windows"] += 1
    LAST_REPLAY_TIMINGS.update(_COUNTERS)
