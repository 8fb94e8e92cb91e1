#!/usr/bin/env python3
"""Drive the PyTorch port (lighthouse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. Print the card (``nvidia-smi`` name and power limit) and the torch /
   CUDA versions; build the CUDA kernels from ``lighthouse_tpu_torch/
   csrc`` and count their SASS instructions; beside them, build the
   native host library (g++ of ``native/bls381.cpp`` into
   ``build/native/``), which must load (else g++'s output is printed).
2. Hold each kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes (``hash64`` on 2^20 pairs, on
   2^20 + 37 pairs for the masked tail, on strided tree-level views; the
   sub-tree kernel on 2^20 leaves), sample both against hashlib, and time
   them with CUDA events beside their bounds.
3. The state root of a MAINNET Capella BeaconState with 2^20 validators
   built from a numpy seed: the uncached root (``type(state).
   hash_tree_root``, which runs the sub-tree kernel), the materialized
   device-resident root (registry mirror + packed-column trees, which run
   ``hash64``), the host-cached root, and warm roots after dirtying 0.1%
   and 1% of ``effective_balance`` and ``balances`` must all agree, each
   warm root with a fresh uncached root of the mutated state; the
   registry root is also checked against an independent hashlib fold.
   The host-cached cold root and the materialize stream the registry's
   raw columns through the chunk stager (side-stream copies from pinned
   memory; chunks, wait and transfer ms and fallbacks printed, fallbacks
   must be 0); every byte count comes from the device ledger.  Each
   kernel's launch counter is zeroed just before this phase and must be
   > 0 just after it; after that read, 2^20 random leaves through the
   stager in 4 chunks must give every level raw equal to the one-copy
   build.
4. Where the time goes: the clean, warm (1%) and uncached roots once
   more under ``torch.profiler`` (device busy time and idle share, top
   device and host ops) and once under cProfile (top Python functions).
5. The BLS kernels (``csrc/bls381.cu``) against their plain PyTorch
   versions on the card, at the shared verify path's shapes: hash-to-G2
   on 2 cells (512 u lanes), sigma on 2 chunks (the path's signature
   columns, and random live/dead lanes with an all-dead chunk),
   sigma_combine on the path's two partials side by side and with an
   all-dead partial, Miller+fold on one 256-lane cell with the path's 2
   live lanes, with every lane live, with every lane dead and with only
   lanes j + 128 live, finalize on a product that is 1 and on one that is
   not.  Outputs agree limb for limb and the verdict exactly; 4 hash
   columns match the host's pure-Python ``hash_to_g2_python``.  A probe times one thread's
   chain of dependent Montgomery products: the latency of one prices the
   chain bounds of the BLS kernels, whose critical paths are dependent
   chains.  Each kernel is timed with CUDA events beside its plain
   version and its bounds.  The group kernels (one thread group per lane
   pair, message, lane, set or output lane; the sigma butterfly a
   cluster of blocks per chunk) print their launch shape, shared memory,
   registers and stack, and compute-sanitizer's racecheck runs on one
   cell or chunk of Miller+fold, hash-to-G2, sigma and prepare in a
   child process where the toolkit has it and the card allows it (else
   the script says it did not run).
6. ``verify_signature_sets`` of the port's default (``tpu``) backend on the
   sync-committee shape (512 shared keys × 256 messages, built like
   ``bench.py``): the valid batch verifies, a swapped signature and an
   altered message fail.  The BLS launch counters are zeroed just before
   and must be > 0 just after; the wall time, ``aggregate_keys_ms`` (the
   512-key sum, by the native library), the stage split, the device idle
   share and the CUDA kernels launched (torch.profiler) are printed.
7. The general path's kernels against their plain versions on the card,
   limb for limb, at its shapes: prepare on BASELINE row 1's marshalled
   batch (K = 16, C = 8) and again with masked key slots, a set whose
   keys are P and −P and dead lanes; Miller at 256, 384 and 1024 lanes;
   product_chunks on 640 lanes padded with a ONE block (768) and on 512
   and 256 lanes (the path's three shapes), with and without a mask;
   product at 128, 256, 512 and 1024 lanes, with the mask all ones and
   random; finalize at 256 and 512 lanes;
   and PR 2's kernels at this path's shapes: hash-to-G2 on 8 cells,
   sigma on C = 8, sigma_combine on its C = 8 partial and on an all-dead
   one, Miller+fold on the padded 1280-lane cell (1025 live).
   A few lanes of each match the host curve, Fq12 and pairing oracles.
8. BASELINE row 1 on the general path (``bench.py:154-177``): 1024 sets
   × 16 keys (secret key 0x10000 + 7v), 64 messages.  The valid batch
   verifies from an empty pubkey table (cold; launch counts zeroed just
   before and read just after: prepare 1, sigma_combine 1, miller_fold
   1, product_chunks 3, finalize 1); bench's key swap, a wrong
   signature, an altered message and a set whose keys sum to the
   identity fail; then 5 warm walls, one host sync per warm call, the
   fenced stage split, and the idle share and the CUDA kernel launches
   (fewer than 200) under ``torch.profiler``; then the same batch in two
   sub-batches of 512 (``LIGHTHOUSE_TPU_PIPELINE_SETS=512``, 2
   sigma_combine launches), valid and key-swapped.
9. A mainnet block's batch through the multi-K route: 128 attestation
   aggregates of ~90% of 512-member committees, a sync aggregate of ~460
   of 512 keys, the proposer's block and randao sets.  Two work items
   (K 512 and 1), so the finalize takes 256 lanes; the valid batch
   verifies, a swapped signature fails; the two items' Miller+fold and
   prepare inputs, recorded in one more call, give each kernel's output
   raw (prepare is timed on both items beside its chain bound);
   ``verify`` and ``aggregate_verify`` once each, valid and tampered, on
   the device route (fast path off) and on the native host fast path,
   which must launch no kernel.
10. ``profile_stages(C=8)`` (the unfused Miller kernel) and the
    prepare → miller(256) → product chain (the product kernel), each
    with its launches counted and its time printed.
11. The host/device crossover: 1, 2, 4, 8 and 16 sets of BASELINE row
    1's shape, the median of 5 warm calls on the native host path
    (``LIGHTHOUSE_TPU_HOST_FASTPATH_MAX=16``, no kernel may launch) and
    on the device pipeline (``=0``); a tampered batch fails on the host.
12. The Merkle proof engine on the resident 2^20 registry tree: 1024
    random validator branches in one gather, each equal to a hashlib walk
    (sampled record roots from the raw columns, the levels above from the
    record-root plane) and verified with ``verify_merkle_proof``; its
    device→host bytes equal 32 × distinct nodes; ``ProofServer.
    field_branch`` for every field of the state equals a hashlib fold of
    the field roots to the state root.
13. Block import through the port's ``BeaconChain`` (gossip →
    signature-verified → executed, then the store, fork choice on the
    ``torch`` engine and the head).  (a) A MINIMAL Capella chain of 4
    epochs + 1 slot at 64 validators with real signatures (a deposit, an
    exit, a proposer and an attester slashing), built by the port's
    ``StateHarness`` on the host oracle (``LIGHTHOUSE_TPU_DEVICE_STATE=0``,
    ``NO_VERIFICATION``), with each slot's unaggregated attestations and
    one competing block on a side branch.  It runs first through a second
    port chain on the CPU (numpy fork-choice engine, fake BLS backend),
    then on the card through ``per_slot_task``, ``process_block`` and
    ``process_attestation_batch`` over ``SqliteStore`` in a datadir under
    ``build/``, on a device-resident genesis with every batch on the card
    (``LIGHTHOUSE_TPU_HOST_FASTPATH_MAX=0``), once with the epoch sweep on
    numpy and once on the card: after every step the head and the
    justified and finalized checkpoints equal the CPU chain's, every
    returned block root reloads from the store, the chain finalizes (the
    freezer receives blocks), the head state equals the oracle's byte for
    byte, and ``BeaconChain.resume`` on the datadir restores the head; a
    wrong attestation signature, state root and proposal signature raise
    ``InvalidSignatures``, ``StateRootMismatch`` and
    ``ProposalSignatureInvalid`` on chains booted with
    ``from_checkpoint``.  (b) One MAINNET Capella block at 2^20
    validators (keys [0x10000 + 7v]G, 128 aggregates of ~90% of their
    committees, a sync aggregate of ~460 of 512, withdrawals), its state
    root from the port's host oracle, imported by ``process_block`` on a
    chain booted by ``BeaconChain.from_checkpoint`` from an anchor block
    at the first slot of an epoch and its post-state (the block is the
    next epoch's first slot, so the import crosses the empty slots and
    the epoch transition); every chain is built anew, outside the timed
    window, with the pubkey cache filled from the derived keys and the
    registry's pubkey index built, as a running node's are warm.  Every
    launch counter is zeroed before the anchor's materialize and read
    after the first import: each kernel of the path must have launched,
    and the head must become the block.  The slots to the block run with
    the sweep on the card and on numpy (post-states raw equal), then 3
    warm imports give the median stage split, the chain's own spans
    (store, fork choice, attester cache, head), the overlap, launches and
    ledger bytes per import, and one more runs under torch.profiler (busy
    time, idle share).
14. Fork choice at 2^20 validators: ``DeviceProtoArrayForkChoice`` on the
    ``torch`` engine (the card) and on the ``numpy`` engine, a tree of 96
    nodes over 3 epochs of slots with two forks, 8 head rounds with
    proposer boost after 1/32 of the registry re-votes, the justified
    balances changing once; the weights, best-child and best-descendant
    columns, votes, balances and head equal exactly after every round;
    ms per round (host clock ending in a sync), bytes up and down per
    round (ledger), CUDA launches of one round (torch.profiler).  Then a
    64-node chain with ``jit_max_depth`` forced to 16: its 4 rounds take
    the host route, counted, and equal numpy's.
15. Block production.  (a) One ``ValidatorClient`` with the 64 interop
    keys drives ``InProcessBeaconNode`` over a port chain on the card (a
    device-resident MINIMAL Capella genesis, an in-memory store, the
    ``tpu`` BLS backend with every batch on the card) over slots 1-10:
    each slot it proposes (randao reveal and block signed on the host
    under slashing protection; the chain produces the block, its state
    root from a scratch ``process_block`` on the device-resident state;
    ``publish_block`` imports it), attests and sends sync messages.  A
    CPU chain fed the same signed blocks, attestations and sync messages
    produces its own block at each slot: its unsigned bytes, the head and
    the op pool's bytes equal the card's; every kernel of the path
    launches; the slashing database refuses a second proposal at a
    proposed slot.  (b) ``produce_block`` at 2^20 validators on chains
    booted from 13(b)'s checkpoint, with 13(b)'s 128 aggregates and 16
    subset aggregates of each in the op pool (2,176 candidates, so the
    pack takes the columnar path and the torch rounds on the card): the
    adopted route (after ``_advance_and_prime``) and the serial route,
    each timed with its split (state copy, slot advance, CSR build,
    coverage, push, rounds, scratch block, state root), launches and
    ledger bytes; the blocks are byte-equal, the selection equals CELF's
    on the same CSR (the rounds and CELF then timed on that CSR, the
    median of 5 warm calls each), the state root equals the host
    oracle's, and the block, signed with the proposer's derived key,
    imports on the card and becomes the head.
    (c) BASELINE row 5: ``bench_pack_attestations(100_000)`` at 2^20
    validators, then its pool's ``get_attestations`` on the torch rounds
    and with the host CELF ``greedy_pack`` in the rounds' place, in
    turns, the median of 5 warm calls each, the same packed list; the
    rounds alone
    beside their bound, the CUDA launches of one pack (torch.profiler)
    and its bytes (ledger).  Then the device ledger's snapshot (with the
    caching allocator's memory figures).
16. Deneb data availability (``csrc/kzg_fr.cu`` and the BLS pairing
    kernels).  Six mainnet-width blobs (4096 elements, ``random.Random(0)``
    as ``bench.py:1371-1405``) under ``verification_setup(4096)``, their
    commitments and proofs made once by the known-τ paths in spawned host
    workers (which also run the host oracle and the host fold beside the
    card).  (a) ``lh_kzg_eval_kernel`` against its plain version in
    canonical words at (6, 4096) on the fixture, on an edge batch (z on a
    domain root, the zero blob, a blob of r − 1) and at B = 1, the six
    fixture values equal to the host oracle; timed (median of 10) beside
    the function's rate bound and chain bound (its least products and
    shortest dependent chain; a probe times one dependent Fr product) and
    the kernel's own products and path.  (b) ``verify_blob_kzg_proof_batch`` on the card's route: the
    valid batch, swapped proofs, an altered element, a wrong commitment, a
    batch holding the zero blob, a single blob, an off-subgroup commitment
    (``KzgError``), each equal to the host fold's verdict; one valid batch
    launches exactly ``kzg_eval``, ``miller_fold`` and ``finalize`` once
    (counters zeroed before, read after); 5 warm calls with the stage
    split, ledger bytes, a profile.  (c) ``DataAvailabilityChecker.
    put_sidecars`` on the six sidecars and ``put_sidecar`` on one, timed; a
    tampered inclusion proof and a wrong KZG proof raise
    ``BlobSidecarError``.  (d) 13(b)'s anchor upgraded to Deneb
    (``upgrade_to_deneb`` at its epoch; its root held to a fresh SSZ
    copy's, 13(b)'s parent unchanged) and 13(b)'s block shape with the
    six commitments, imported at 2^20 validators through ``BeaconChain``:
    ``BlobsUnavailable`` without sidecars, then ``put_sidecars`` and the
    retry make it the head, its post-state root the host oracle's, its six
    sidecars read back from the store byte for byte, every kernel of the
    path launched, the state transition's split beside 13(b)'s.  (e) A
    MINIMAL chain at 64 validators crossing
    ``deneb_fork_epoch = 1`` with real signatures and blob blocks of width
    4 (``embedded_setup(4)``), on the card and on a CPU chain: every head
    and post-state equal.

Device busy times and CUDA launch counts come from torch.profiler's
device-side events only (kernels, copies, memsets): the host op that
launched a kernel reports the same device time.

The line before the last is one JSON object with each kernel's launches,
error, time, plain-version time and bound (for every BLS kernel also its
chain bound; the group kernels their launch shape, registers and stack;
product_chunks, Miller and product their time at each shape phase 7
drives; product_chunks and product with their calls queued behind a spin
(``queued_ms``) and one call at a time;
Miller+fold, hash-to-G2 and sigma take ``ms`` at the shared path's
shapes and add ``ms_general`` and its bounds at the general path's,
prepare adds ``ms_block`` and its chain bounds on the block batch's two
items; every row adds ``launches_import``, its launches in one warm
phase-13(b) import, ``launches_production``, its launches in phase
15(b)'s adopted production, and ``launches_kzg``, its launches in one
phase-16(b) batch; ``kzg_eval`` has its rate and chain bounds at (6,
4096)); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20
LOG2_VALIDATORS = 20
BLS_KEYS = 512               # sync committee
BLS_MSGS = 256               # messages per batch
BLS_TIMED_RUNS = 10
VERIFY_RUNS = 5
GEN_SETS = 1024               # BASELINE row 1 (bench.py:129-131, 154-164)
GEN_KEYS = 16
GEN_MSGS = 64
GEN_SK0, GEN_SK_STEP = 0x10000, 7   # validator v's secret key sk0 + 7v
BLOCK_AGGREGATES = 128        # attestation aggregates in a mainnet block
COMMITTEE = 512               # 2^20 validators / (32 slots × 64 committees)
PARTICIPATION = 0.9
SYNC_PARTICIPATION = 460 / 512
SHARED_PATH_KERNELS = ("hash_g2", "sigma", "sigma_combine", "miller_fold",
                       "finalize")
CHAIN_SHORT, CHAIN_LONG = 1000, 21000   # dependent products of the probe
CROSSOVER_SETS = (1, 2, 4, 8, 16)  # host/device crossover batch sizes
PROOF_BATCH = 1024            # validator branches in one proof gather
SPIN_CYCLES = 20_000_000      # ~10 ms at 2 GHz: the queue ahead of queued_ms
MAX_WARM_LAUNCHES = 200       # CUDA kernels per warm general verify
# A launch counter that counts a call of two CUDA kernels (the sigma
# ladder, then its butterfly), and the traced kernel names it counts.
KERNELS_PER_CALL = {"sigma": 2, "kzg_eval": 2}
TRACE_NAMES = {"sigma_ladder": "sigma", "sigma_fold": "sigma",
               "kzg_eval_finish": "kzg_eval"}
RACECHECK_TIMEOUT_S = 300
KERNEL_N = 1 << 20            # hash64 pairs / sub-tree leaves timed
TIMED_RUNS = 20
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
INT32_LANES_PER_SM = 64       # INT32 lanes per Hopper SM per clock
FAR = 2 ** 64 - 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 1: card, build, SASS
# ---------------------------------------------------------------------------

def sass_instruction_counts(so_path: str) -> dict:
    """Non-NOP SASS instructions of each kernel in the built library (the
    kernels are fully unrolled, so the static count of ``lh_hash64_kernel``
    is the per-thread, i.e. per-hash, count)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for line in dump.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            current = s.split(":", 1)[1].strip()
            counts[current] = 0
        elif current and s.startswith("/*") and "*/" in s:
            body = s.split("*/", 1)[1].strip()
            if body and not body.startswith("NOP") and not body.startswith("/*"):
                counts[current] += 1
    return counts


def phase_build(torch, mk, pk, cuda_build) -> dict:
    import threading

    from lighthouse_tpu_torch.crypto import native
    from lighthouse_tpu_torch.kzg import device as KD

    card = smi("name,power.limit")
    print(f"card: {card}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  python "
          f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    native_err = []

    def build_native():
        try:
            native.available(block=True)
        except native.NativeBuildError as e:
            native_err.append(str(e))

    g_native = threading.Thread(target=build_native)
    g_native.start()               # g++ beside the nvcc processes
    built = cuda_build.build_all(["sha256_merkle", "bls381", "kzg_fr"])
    mk.kernel_library()                     # (3 nvcc at once)
    pk.kernel_library()
    KD.kernel_library()
    print(f"kernel builds: {time.perf_counter() - t0:.1f} s wall, every "
          f"nvcc started together")
    g_native.join()
    check(not native_err, "the native BLS library did not build:\n"
          + "".join(native_err))
    check(native.available(block=True) is True,
          "the native BLS library is not available")
    print(f"native host library: {native.BUILD_INFO['build_s']:.1f} s g++ "
          f"({' '.join(native.GXX_FLAGS)}) -> {native.BUILD_INFO['path']}")
    sass = {}
    for lib in ("sha256_merkle", "bls381", "kzg_fr"):
        took, ptxas = built.get(lib, (0.0, ""))
        path = cuda_build.build_info(lib)["path"]
        print(f"  {lib}: {took:.1f} s nvcc -> {path}")
        entry = "?"
        for line in ptxas.splitlines():     # one line per kernel entry
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "registers" in line:
                print(f"    ptxas {entry}: {line.split(':', 1)[1].strip()}")
        sass.update(sass_instruction_counts(path))
    print(f"SASS instructions (non-NOP): {json.dumps(sass)}")
    check("lh_hash64_kernel" in sass and sass["lh_hash64_kernel"] > 1000,
          f"cannot read the hash64 kernel's SASS: {sass}")
    # fp_mul's own section if it has one, else the one-product probe
    # kernel (its loads and stores included), never another kernel
    priced = next((k for k in sass if "fp_mul" in k and "lh_" not in k),
                  next((k for k in sass if "lh_fp_mul_kernel" in k), None))
    instr_per_mont = sass.get(priced, 0)
    check(instr_per_mont > 100,
          f"cannot price a Montgomery product from SASS: {sass}")
    print(f"SASS instructions per Montgomery product: {instr_per_mont} "
          f"({priced})")
    # an Fr product: the one-product probe of csrc/kzg_fr.cu, its loads
    # and stores included
    instr_per_fr = sass.get("lh_fr_mul_kernel", 0)
    check(instr_per_fr > 100, f"cannot price an Fr product from SASS: {sass}")
    print(f"SASS instructions per Fr product: {instr_per_fr} "
          f"(lh_fr_mul_kernel)")
    clk_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"max SM clock {clk_mhz:.0f} MHz, {sms} SMs")
    return {"card": card, "instr_per_hash": sass["lh_hash64_kernel"],
            "instr_per_mont": instr_per_mont, "instr_per_fr": instr_per_fr,
            "clk_hz": clk_mhz * 1e6, "sms": sms}


def bound_ms(hw: dict, hashes: int, nbytes: int) -> tuple:
    """Least time for ``hashes`` hash64 of integer work moving ``nbytes``:
    the larger of instructions over the INT32 lane rate and bytes over
    the memory rate."""
    ops_s = hashes * hw["instr_per_hash"] / (
        INT32_LANES_PER_SM * hw["sms"] * hw["clk_hz"])
    mem_s = nbytes / HBM_BYTES_PER_S
    return (max(ops_s, mem_s) * 1e3,
            "operations" if ops_s >= mem_s else "bytes")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, runs: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` CUDA-event-timed
    calls (after two warm-up calls)."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(torch, fn, runs: int) -> float:
    """Device milliseconds per call of ``fn()`` with the calls queued back
    to back: a spin kernel holds the stream while the host enqueues
    ``runs`` calls between two events, so the host's own time per call
    (wrapper, ctypes, launch) is not counted where it is longer than the
    kernel, as it is in :func:`cuda_ms`.  Fails if the host did not finish
    enqueueing before the spin ended."""
    fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    b.synchronize()
    check(host_ms < SPIN_CYCLES / 4e6,      # half the spin at up to 2 GHz
          f"queued timing: the host took {host_ms:.3f} ms to enqueue, not "
          f"within the spin")
    return a.elapsed_time(b) / runs


def max_abs_err(torch, got, want) -> int:
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    d = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
    return int(d.item())


def hashlib_pairs(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    return np.stack([np.frombuffer(hashlib.sha256(
        left[i].astype(">u4").tobytes() + right[i].astype(">u4").tobytes()
    ).digest(), dtype=">u4").astype(np.uint32) for i in range(len(left))])


def phase_kernels(torch, mk, hw: dict) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def rand_words(n):
        w = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(dev)

    errs = {"hash64": 0, "subtree": 0}
    # hash64: the timed shape, a ragged n (masked tail), strided levels.
    for n in (KERNEL_N, KERNEL_N + 37, 37, 1):
        left, right = rand_words(n), rand_words(n)
        err = max_abs_err(torch, mk.hash64_kernel(left, right),
                          mk.hash64_plain(left, right))
        errs["hash64"] = max(errs["hash64"], err)
        check(err == 0, f"hash64 kernel != plain at n={n} (max err {err})")
    cur = rand_words(2 * KERNEL_N)
    err = max_abs_err(torch, mk.hash64_kernel(cur[0::2], cur[1::2]),
                      mk.hash64_plain(cur[0::2], cur[1::2]))
    check(err == 0, f"hash64 kernel != plain on strided level views")
    pk = torch.from_numpy(rng.integers(0, 2 ** 32, (4096, 12),
                                       dtype=np.uint64).astype(np.uint32)
                          .view(np.int32)).to(dev)
    hi = torch.zeros((4096, 8), dtype=torch.int32, device=dev)
    hi[:, :4] = pk[:, 8:]
    err = max_abs_err(torch, mk.hash64_kernel(pk[:, :8], hi),
                      mk.hash64_plain(pk[:, :8], hi))
    check(err == 0, "hash64 kernel != plain on 12-word pubkey rows")

    left, right = rand_words(KERNEL_N), rand_words(KERNEL_N)
    out = mk.hash64_kernel(left, right)
    sample = rng.choice(KERNEL_N, 64, replace=False)
    ln = left.cpu().numpy().view(np.uint32)[sample]
    rn = right.cpu().numpy().view(np.uint32)[sample]
    check(np.array_equal(out.cpu().numpy().view(np.uint32)[sample],
                         hashlib_pairs(ln, rn)),
          "hash64 kernel disagrees with hashlib on sampled rows")

    leaves = rand_words(KERNEL_N)
    roots = mk.chunk_roots_natural(leaves, mk.CHUNK_LOG2)
    err = max_abs_err(torch, roots, mk.chunk_roots_plain(leaves,
                                                         mk.CHUNK_LOG2))
    errs["subtree"] = err
    check(err == 0, f"sub-tree kernel != plain (max err {err})")
    for c in range(1, mk.MAX_CHUNK_LOG2 + 1):  # every block size it takes
        small = rand_words(37 << c)
        err = max_abs_err(torch, mk.chunk_roots_natural(small, c),
                          mk.chunk_roots_plain(small, c))
        check(err == 0, f"sub-tree kernel != plain at chunk_log2={c}")
    host_leaves = leaves.cpu().numpy().view(np.uint32)
    c = 1 << mk.CHUNK_LOG2
    for g in rng.choice(KERNEL_N // c, 3, replace=False):
        level = host_leaves[g * c:(g + 1) * c]
        while level.shape[0] > 1:
            level = hashlib_pairs(level[0::2], level[1::2])
        check(np.array_equal(roots[g].cpu().numpy().view(np.uint32),
                             level[0]),
              f"sub-tree kernel disagrees with hashlib on chunk {g}")
    print(f"kernels vs plain on the card: bit-identical (hash64 n in "
          f"{{2^20, 2^20+37, 37, 1}}, strided, pubkey rows; sub-tree "
          f"2^20 leaves, and 37 chunks at every chunk_log2 1.."
          f"{mk.MAX_CHUNK_LOG2}); 64 hash64 rows and 3 chunks match "
          f"hashlib")

    timing = {}
    h_ms = cuda_ms(torch, lambda: mk.hash64_kernel(left, right), TIMED_RUNS)
    h_plain = cuda_ms(torch, lambda: mk.hash64_plain(left, right), 3)
    h_bound, h_by = bound_ms(hw, KERNEL_N, 96 * KERNEL_N)
    timing["hash64"] = {"ms": h_ms, "plain_ms": h_plain, "bound_ms": h_bound,
                        "bound_by": h_by, "n": KERNEL_N}
    g = KERNEL_N // c
    s_ms = cuda_ms(torch, lambda: mk.chunk_roots_natural(leaves,
                                                         mk.CHUNK_LOG2),
                   TIMED_RUNS)
    s_plain = cuda_ms(torch, lambda: mk.chunk_roots_plain(leaves,
                                                          mk.CHUNK_LOG2), 3)
    s_bound, s_by = bound_ms(hw, KERNEL_N - g, 32 * (KERNEL_N + g))
    timing["subtree"] = {"ms": s_ms, "plain_ms": s_plain,
                         "bound_ms": s_bound, "bound_by": s_by,
                         "n": KERNEL_N}
    for name, t in timing.items():
        print(f"{name}: {t['ms']:.4f} ms kernel (median of {TIMED_RUNS}), "
              f"{t['plain_ms']:.2f} ms plain, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) -> {100 * t['bound_ms'] / t['ms']:.1f}% "
              f"of bound, n={t['n']} [{hw['card']}]")
    return {"errs": errs, "timing": timing}


# ---------------------------------------------------------------------------
# Phase 3: the state root at 2^20 validators
# ---------------------------------------------------------------------------

def build_state(T, ForkName, ValidatorRegistry, n: int, rng):
    state = T.state_cls(ForkName.CAPELLA)()
    reg = ValidatorRegistry(n)
    act = rng.integers(0, 200_000, n).astype(np.uint64)
    exited = rng.random(n) < 0.02
    exit_epoch = np.where(exited, act + np.uint64(1000),
                          np.uint64(FAR)).astype(np.uint64)
    reg.init_columns(
        pubkey=rng.integers(0, 256, (n, 48), dtype=np.uint8),
        withdrawal_credentials=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        effective_balance=(rng.integers(16, 33, n) * 10 ** 9).astype(
            np.uint64),
        slashed=rng.random(n) < 0.01,
        activation_eligibility_epoch=act,
        activation_epoch=act + np.uint64(5),
        exit_epoch=exit_epoch,
        withdrawable_epoch=np.where(exited, exit_epoch + np.uint64(256),
                                    np.uint64(FAR)).astype(np.uint64))
    state.validators = reg
    state.balances = rng.integers(16 * 10 ** 9, 33 * 10 ** 9, n).astype(
        np.uint64)
    state.previous_epoch_participation = rng.integers(0, 8, n).astype(
        np.uint8)
    state.current_epoch_participation = rng.integers(0, 8, n).astype(np.uint8)
    state.inactivity_scores = rng.integers(0, 50, n).astype(np.uint64)
    state.slot = 9_000_000
    state.block_roots[:] = rng.integers(0, 256, state.block_roots.shape,
                                        dtype=np.uint8)
    state.randao_mixes[:] = rng.integers(0, 256, state.randao_mixes.shape,
                                         dtype=np.uint8)
    return state


def _hash_rows(msgs: np.ndarray) -> np.ndarray:
    """hashlib SHA-256 of every 64-byte row of ``msgs`` ((m, 64) u8)."""
    buf = msgs.tobytes()
    sha = hashlib.sha256
    out = b"".join(sha(buf[i:i + 64]).digest()
                   for i in range(0, len(buf), 64))
    return np.frombuffer(out, dtype=np.uint8).reshape(-1, 32)


def record_roots_hashlib(reg, idx=None) -> np.ndarray:
    """(k, 32) u8 hash_tree_root of the records at ``idx`` (all when None)
    from the raw columns by hashlib alone: the pubkey pre-hash, then the
    record's 3-level mini-tree."""
    sel = slice(None, len(reg)) if idx is None else np.asarray(idx)

    def col(name):
        return np.asarray(reg.col(name))[sel]

    k = col("slashed").shape[0]

    def u64_chunks(c):
        out = np.zeros((k, 32), np.uint8)
        out[:, :8] = np.ascontiguousarray(c, dtype="<u8").view(
            np.uint8).reshape(k, 8)
        return out

    pk = np.zeros((k, 64), np.uint8)
    pk[:, :48] = col("pubkey")
    slashed = np.zeros((k, 32), np.uint8)
    slashed[:, 0] = col("slashed")
    leaves = np.stack([
        _hash_rows(pk), col("withdrawal_credentials"),
        u64_chunks(col("effective_balance")), slashed,
        u64_chunks(col("activation_eligibility_epoch")),
        u64_chunks(col("activation_epoch")),
        u64_chunks(col("exit_epoch")),
        u64_chunks(col("withdrawable_epoch"))], axis=1)  # (k, 8, 32)
    level = leaves.reshape(-1, 64)
    for _ in range(3):
        level = _hash_rows(level)
        level = level.reshape(-1, 64) if level.shape[0] > k else level
    return level


def tree_levels_hashlib(nodes: np.ndarray) -> list:
    """Every level of the tree over ``(w, 32)`` u8 nodes (w a power of
    two) by hashlib: ``[nodes, ..., (1, 32) root]``."""
    levels = [nodes]
    while levels[-1].shape[0] > 1:
        levels.append(_hash_rows(levels[-1].reshape(-1, 64)))
    return levels


def zero_cap_hashlib(root: bytes, lvl: int, limit: int, n: int) -> bytes:
    """Fold a subtree root at level ``lvl`` with zero subtrees up to the
    ``limit``-leaf list depth, then mix in the length ``n``."""
    zero = [b"\x00" * 32]
    depth = (limit - 1).bit_length()
    for _ in range(depth):
        zero.append(hashlib.sha256(zero[-1] * 2).digest())
    while lvl < depth:
        root = hashlib.sha256(root + zero[lvl]).digest()
        lvl += 1
    return hashlib.sha256(root + n.to_bytes(32, "little")).digest()


def registry_root_hashlib(reg, limit: int) -> bytes:
    """The SSZ registry root from the raw columns by hashlib alone: record
    mini-trees, the record-root tree, zero caps to the limit, the length
    mixin."""
    n = len(reg)
    w = 1 << (n - 1).bit_length()
    nodes = np.zeros((w, 32), np.uint8)
    nodes[:n] = record_roots_hashlib(reg)
    levels = tree_levels_hashlib(nodes)
    return zero_cap_hashlib(levels[-1][0].tobytes(), len(levels) - 1,
                            limit, n)


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def ledger_moved(LEDGER, before: dict) -> dict:
    """Bytes each way over every subsystem since ``before`` (a
    ``LEDGER.transfer_totals()``), from the ledger alone, with the
    host→device bytes of each subsystem that moved any."""
    after = LEDGER.transfer_totals()
    return {"h2d": sum(after[s][0] - before[s][0] for s in after),
            "d2h": sum(after[s][1] - before[s][1] for s in after),
            "h2d_by": {s: after[s][0] - before[s][0] for s in after
                       if after[s][0] != before[s][0]}}


# The raw bytes of one SSZ Validator record: pubkey, withdrawal
# credentials, effective balance, slashed, four epochs.
RECORD_RAW_BYTES = 48 + 32 + 8 + 1 + 4 * 8


def dirty_push_bytes(k: int, row_bytes: int) -> int:
    """H2D of one scatter of ``k`` dirty rows: the batch padded to its
    power-of-two bucket (at least 8), each entry an 8-byte index and its
    row."""
    return 0 if k == 0 else max(8, 1 << (k - 1).bit_length()) * (
        8 + row_bytes)


def stager_note(stats: dict) -> str:
    return ", ".join(f"{k} {round(v, 2) if isinstance(v, float) else v}"
                     for k, v in stats.items())


def phase_state_root(torch, hw: dict) -> dict:
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.ops import merkle_kernel as mk
    from lighthouse_tpu_torch.types import ForkName, MAINNET, spec_types
    from lighthouse_tpu_torch.types import validators as tv
    from lighthouse_tpu_torch.types.device_state import (
        LAST_MATERIALIZE_STATS, materialize_state)
    from lighthouse_tpu_torch.types.validators import (
        ValidatorRegistry, registry_device_columns, registry_root_device)

    n = 1 << LOG2_VALIDATORS
    rng = np.random.default_rng(SEED)
    T = spec_types(MAINNET)
    t0 = time.perf_counter()
    state = build_state(T, ForkName, ValidatorRegistry, n, rng)
    print(f"state: MAINNET Capella, {n} validators, built in "
          f"{time.perf_counter() - t0:.1f} s from seed {SEED}")
    limit = MAINNET.VALIDATOR_REGISTRY_LIMIT
    uncached = type(state).hash_tree_root

    t0 = time.perf_counter()
    reg_ref = registry_root_hashlib(state.validators, limit)
    print(f"registry root by hashlib: {reg_ref.hex()} "
          f"({time.perf_counter() - t0:.1f} s)")

    for k in mk.LAUNCHES:
        mk.LAUNCHES[k] = 0
    per_path = {}

    def launches_since(before):
        return {k: mk.LAUNCHES[k] - before[k] for k in mk.LAUNCHES}

    before = dict(mk.LAUNCHES)
    reg_root, reg_ms = timed(torch, lambda: type(state).FIELDS[
        "validators"].hash_tree_root(state.validators))
    check(reg_root == reg_ref, "registry root != hashlib registry root")
    r_unc, unc_ms = timed(torch, lambda: uncached(state))
    per_path["uncached"] = launches_since(before)
    print(f"uncached root {r_unc.hex()}: {unc_ms:.1f} ms "
          f"(registry field alone {reg_ms:.1f} ms); launches "
          f"{per_path['uncached']}")

    before = dict(mk.LAUNCHES)
    cols = registry_device_columns(state.validators)
    fused, fused_ms = timed(torch, lambda: registry_root_device(cols, n,
                                                                limit))
    del cols
    check(fused == reg_ref, "expansion-tree registry root != hashlib root")
    per_path["registry_root_device"] = launches_since(before)
    print(f"registry_root_device (expansion tree): {fused_ms:.1f} ms, "
          f"matches; launches {per_path['registry_root_device']}")

    host_state = state.copy()
    os.environ["LIGHTHOUSE_TPU_DEVICE_STATE"] = "0"
    before = dict(mk.LAUNCHES)
    mk.reset_push_stats()
    tv.LAST_COLD_TIMINGS.clear()
    r_host, host_ms = timed(torch, host_state.tree_hash_root)
    per_path["host_cached_cold"] = launches_since(before)
    del os.environ["LIGHTHOUSE_TPU_DEVICE_STATE"]
    check(r_host == r_unc, "host-cached root != uncached root")
    cold_reg = dict(tv.LAST_COLD_TIMINGS)
    check(cold_reg.get("push_chunks", 0) > 1,
          f"the registry's cold build did not stream in chunks: {cold_reg}")
    check(cold_reg["push_fallbacks"] == 0 and mk.LAST_PUSH_STATS.get(
        "staging_fallbacks", 0) == 0, "a chunk stager fell back")
    leaf_note = (stager_note(mk.LAST_PUSH_STATS)
                 or "one copy each (no tree wider than a push chunk)")
    print(f"host-cached cold root: {host_ms:.1f} ms, matches; launches "
          f"{per_path['host_cached_cold']}; registry cold build through "
          f"the chunk stager: {stager_note(cold_reg)}; leaf builds "
          f"{leaf_note} [{hw['card']}]")
    del host_state

    before = dict(mk.LAUNCHES)
    ledger0 = LEDGER.transfer_totals()
    _, mat_ms = timed(torch, lambda: check(materialize_state(state),
                                           "materialize_state refused"))
    mat_moved = ledger_moved(LEDGER, ledger0)
    mat_bytes = mat_moved["h2d"]
    reg_cols = n * RECORD_RAW_BYTES
    check(mat_moved["h2d_by"].get("registry_mirror") == reg_cols,
          f"materialize pushed {mat_moved['h2d_by']} B; the registry's raw "
          f"columns are {reg_cols} B")
    mat_stager = dict(tv.LAST_COLD_TIMINGS)
    check(mat_stager.get("push_chunks", 0) > 1
          and mat_stager["push_fallbacks"] == 0,
          f"materialize did not stream cleanly in chunks: {mat_stager}")
    clean = [timed(torch, state.tree_hash_root) for _ in range(3)]
    per_path["materialize"] = launches_since(before)
    check(all(r == r_unc for r, _ms in clean),
          "materialized root != uncached root")
    clean_ms = [ms for _r, ms in clean]
    print(f"materialize: {mat_ms:.1f} ms cold, {mat_bytes} B host->device "
          f"(ledger; {LAST_MATERIALIZE_STATS['bytes_pushed']} B of them to "
          f"the residency feeders, "
          f"{LAST_MATERIALIZE_STATS['materialize_ms']:.1f} ms inside "
          f"materialize_state); registry columns through the chunk stager: "
          f"{stager_note(mat_stager)}; clean roots ms "
          f"{[round(ms, 2) for ms in clean_ms]}; match; launches "
          f"{per_path['materialize']} [{hw['card']}]")

    warm = {}
    for frac in (0.001, 0.01):
        k = int(n * frac)
        rows = []
        for rep in range(3):
            idx = np.sort(rng.choice(n, k, replace=False))
            reg = state.validators
            eb = reg.wcol("effective_balance")
            new_eb = (rng.integers(16, 33, k) * 10 ** 9).astype(np.uint64)
            k_records = int(np.count_nonzero(eb[idx] != new_eb))
            eb[idx] = new_eb
            state.balances[idx] = rng.integers(
                16 * 10 ** 9, 33 * 10 ** 9, k).astype(np.uint64)
            k_chunks = np.unique(idx // 4).size   # 4 balances a chunk
            # Only the dirty rows may go up: the records whose bytes
            # changed (the registry diffs its columns) and the balance
            # chunks written (the column keeps the written indices), each
            # as one bucketed scatter; roots come down.
            want = {"registry_mirror": dirty_push_bytes(k_records,
                                                        RECORD_RAW_BYTES),
                    "packed_cache": dirty_push_bytes(k_chunks, 32)}
            want = {s: b for s, b in want.items() if b}
            before = dict(mk.LAUNCHES)
            ledger0 = LEDGER.transfer_totals()
            r_warm, warm_ms = timed(torch, state.tree_hash_root)
            moved = ledger_moved(LEDGER, ledger0)
            check(moved["h2d_by"] == want,
                  f"warm root at {frac:.1%} pushed {moved['h2d_by']} B; "
                  f"its dirty rows are {want} B")
            check(moved["d2h"] % 32 == 0
                  and moved["d2h"] <= 32 * len(type(state).FIELDS),
                  f"warm root pulled {moved['d2h']} B, more than one root "
                  f"a field")
            launched = launches_since(before)
            r_fresh = uncached(state)
            check(r_warm == r_fresh,
                  f"warm root != fresh uncached root at {frac:.1%} rep {rep}")
            rows.append({"ms": warm_ms, "h2d": moved["h2d"],
                         "d2h": moved["d2h"], "launches": launched,
                         "dirty": (k_records, k_chunks)})
        warm[frac] = rows
        per_path[f"warm_{frac:.1%}"] = rows[-1]["launches"]
        print(f"warm root, {k} dirty records + {k} balances "
              f"({frac:.1%}): ms {[round(r['ms'], 2) for r in rows]} "
              f"(median {statistics.median(r['ms'] for r in rows):.2f}); "
              f"h2d B/root (ledger, each equal to its dirty rows' bucketed "
              f"bytes) {[r['h2d'] for r in rows]}; changed records, "
              f"balance chunks {[r['dirty'] for r in rows]}; d2h B/root "
              f"{[r['d2h'] for r in rows]}; launches/root "
              f"{rows[-1]['launches']}; each == fresh uncached root")

    launches = dict(mk.LAUNCHES)
    print(f"main-path launches: {launches} [{hw['card']}]")
    for name, count in launches.items():
        check(count > 0, f"the main path never launched the {name} kernel")
    leaf_stager = stage_leaves(torch, hw, mk, rng)

    def dirty(frac):
        k = int(n * frac)
        idx = np.sort(rng.choice(n, k, replace=False))
        state.validators.wcol("effective_balance")[idx] = np.uint64(
            32 * 10 ** 9)
        state.balances[idx] = np.uint64(31 * 10 ** 9)

    profile_roots(torch, hw, [
        ("clean root", lambda: None, state.tree_hash_root),
        ("warm root 1%", lambda: dirty(0.01), state.tree_hash_root),
        ("uncached root", lambda: None, lambda: uncached(state))])
    return {"launches": launches, "per_path": per_path,
            "uncached_ms": unc_ms, "materialize_ms": mat_ms,
            "clean_ms": clean_ms, "warm": warm, "state": state,
            "stager": {"host_cached_registry": cold_reg,
                       "materialize": mat_stager, "leaves": leaf_stager}}


def stage_leaves(torch, hw: dict, mk, rng) -> dict:
    """``merkle_levels_device`` on 2^20 random leaves streamed through the
    chunk stager (the default push chunk, 2^18 rows: 4 chunks from pinned
    memory on a side stream) against the one-copy build: every level raw
    equal, no fallback."""
    leaves = rng.integers(0, 2 ** 32, (1 << 20, 8), dtype=np.uint64).astype(
        np.uint32)
    r_one, one = mk.merkle_levels_device(leaves, chunk_rows=0)
    for _ in range(2):             # the second build is the one reported
        mk.reset_push_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_ch, ch = mk.merkle_levels_device(leaves)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    stats = dict(mk.LAST_PUSH_STATS)
    check(stats.get("chunks", 0) == 4 and stats["staging_fallbacks"] == 0,
          f"the leaf build did not stream in 4 chunks cleanly: {stats}")
    check(np.array_equal(r_one, r_ch) and len(one) == len(ch)
          and all(torch.equal(a, b) for a, b in zip(one, ch)),
          "chunk-staged levels != one-copy levels")
    print(f"chunk-staged leaf build, 2^20 leaves: every level raw equal to "
          f"the one-copy build; {stager_note(stats)}; {wall:.2f} ms wall "
          f"[{hw['card']}]")
    return stats


# ---------------------------------------------------------------------------
# Phase 4: where the time goes (after the launch counts are read)
# ---------------------------------------------------------------------------

def device_events(prof) -> list:
    """(self device µs, count, name) of every device-side event of a
    torch.profiler run: kernels, copies and memsets.  The host ops that
    launched them report the same self device time, so summing every
    event with device time would count each torch op's kernels twice."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)


def profile_roots(torch, hw: dict, cases) -> None:
    """For each (label, prepare, root) case: wall time, the device's busy
    time from torch.profiler (sum of kernel and copy self time) and its
    idle share, the top device and host ops, and the top Python
    functions by own time under cProfile (a separate run of the same
    case, prepared again)."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile

    for label, prepare, fn in cases:
        prepare()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall_ms = timed(torch, fn)
        dev = device_events(prof)
        busy_ms = sum(d for d, _c, _k in dev) / 1e3
        host = sorted(((e.self_cpu_time_total, e.count, e.key)
                       for e in prof.key_averages()), reverse=True)[:6]
        print(f"profile {label}: wall {wall_ms:.2f} ms (under the "
              f"profiler), device busy {busy_ms:.3f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f} [{hw['card']}]")
        print("  device: " + "; ".join(
            f"{k} x{c} {d / 1e3:.3f} ms" for d, c, k in dev[:6]))
        print("  host ops: " + "; ".join(
            f"{k} x{c} {t / 1e3:.2f} ms" for t, c, k in host))
        prepare()
        pr = cProfile.Profile()
        pr.enable()
        fn()
        torch.cuda.synchronize()
        pr.disable()
        stats = pstats.Stats(pr).stats
        top = sorted(((v[2], v[1], f"{os.path.basename(k[0])}:{k[1]}"
                       f"({k[2]})") for k, v in stats.items()),
                     reverse=True)[:8]
        print("  python (own time): " + "; ".join(
            f"{name} x{calls} {t * 1e3:.2f} ms" for t, calls, name in top))


# ---------------------------------------------------------------------------
# Phase 5: the BLS kernels against their plain versions on the card
# ---------------------------------------------------------------------------

def canonical_blocks(planes) -> np.ndarray:
    """(32·k, M) int32 Montgomery blocks → (k, M) object array of each
    element's value mod p (the comparison the lazy < 2N residues allow)."""
    from lighthouse_tpu_torch.crypto.fields import P
    arr = planes.cpu().numpy().astype(np.int64)
    k, m = arr.shape[0] // 32, arr.shape[1]
    limbs = arr.reshape(k, 32, m)[:, :26]
    out = np.empty((k, m), dtype=object)
    for b in range(k):
        for j in range(m):
            v = 0
            for i in range(25, -1, -1):
                v = (v << 16) | int(limbs[b, i, j])
            out[b, j] = v % P
    return out


def mont_bound_ms(hw: dict, products: int, instr=None) -> float:
    """Least time for ``products`` Montgomery products: their SASS
    instructions (``instr`` each, by default a BLS Fq product's) over the
    card's INT32 issue rate."""
    return products * (instr or hw["instr_per_mont"]) / (
        INT32_LANES_PER_SM * hw["sms"] * hw["clk_hz"]) * 1e3


def chain_products(PK, kernel: str, C=None, K=None, M=None) -> int:
    """The critical path in dependent Montgomery products, where the
    independent products of one tower step (one wave of a thread group)
    count as one, worked out from the kernels' formulas
    (csrc/bls381_field.cuh).  The Fermat ladder a^(p-2) is one product per
    bit plus one per set bit; an RCB point addition is two waves; f^|x|
    one step per bit and set bit.

    ``sigma_combine`` of C chunks: C - 1 additions, then fp2_inv (the
    squares, the ladder, the two products) and the affine products.
    ``finalize``: the 7 levels of the 128 -> 1 fold; the easy part (Fq6
    squares, in fp6_inv two Fq2 waves, the squares, the ladder, the
    products, one Fq2 wave, then the Fq6 products, conj·inv, the
    Frobenius, one product: 10 steps and the ladder); the hard part (five
    f^u and six products, the Frobenius maps and m^3 beside them).
    ``miller_fold``: a doubling step per bit of |x| below its top, four
    waves (f² beside XX YY ZZ and 2T's first wave; the line's second wave
    beside 2T's second; B and C; f²·line), an addition step per set bit
    among them, three waves (Q·T.Z beside T + Q's first wave; the line
    and T + Q's second; f·line), and the fold's product.  ``hash_g2``:
    SSWU (t², Z·t², tv1², the norm's squares, the ladder, the inverse's
    products, NEGBA·(1 + 1/tv2), x1² beside A·x1, x1³: 8 waves and the
    ladder; (p²+7)/16, one wave per bit; the candidates, their squares,
    (tv1·t)·s, sgn0(y): 4), the isogeny's 5 waves, q0 + q1, the two
    [|x|] ladders (an addition per bit and per set bit), the four final
    additions (the ψ terms beside them), then the affine point (squares,
    the ladder, the inverse's products, X·zi beside Y·zi).  ``sigma``:
    the 64-bit ladder (acc + base beside base + base: two waves a bit)
    and the 7 butterfly steps (one addition, two waves, each).
    ``prepare`` with K key slots: the K in-order additions (two waves
    each), the 64-bit ladder (two waves a bit), the Fermat ladder of Z,
    then X·zi beside Y·zi.  ``miller``: Miller+fold's loop without the
    fold.  ``product_chunks``: one Fq12 product (one wave).  ``product``
    on M lanes: the roll butterfly's log2(M / 128) levels, one Fq12
    product each."""
    ladder = len(PK.P_MINUS_2_BITS) + int(sum(PK.P_MINUS_2_BITS))
    x_adds = len(PK.X_BITS_FULL) + int(sum(PK.X_BITS_FULL))
    if kernel == "sigma_combine":
        return 2 * (C - 1) + 1 + ladder + 1 + 1
    if kernel == "finalize":
        fold = PK.LANE_BLOCK.bit_length() - 1
        return fold + (10 + ladder) + (5 * x_adds + 6)
    if kernel in ("miller_fold", "miller"):
        return (4 * len(PK.X_BITS_MILLER) + 3 * int(sum(PK.X_BITS_MILLER))
                + (kernel == "miller_fold"))
    if kernel == "product_chunks":
        return 1
    if kernel == "product":
        return (M // PK.LANE_BLOCK).bit_length() - 1
    if kernel == "sigma":
        return 2 * 64 + 2 * (PK.LANE_BLOCK.bit_length() - 1)
    if kernel == "prepare":
        return 2 * K + 2 * 64 + ladder + 1
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    sswu = 8 + ladder + len(HK.E16_BITS_LSB) + 4
    return sswu + 5 + 2 + 2 * 2 * x_adds + 4 * 2 + (1 + ladder + 2)


def bounds(hw: dict, products: int, nbytes: int = 0, chain=None,
           field: str = "fq") -> dict:
    """The rate bound (operations over the INT32 issue rate, or bytes
    over the memory rate, whichever is larger) and, for a kernel that is
    one dependent chain, its chain bound: the critical path in products
    times the measured latency of one dependent product.  ``field`` "fq"
    prices BLS Fq products, "fr" the KZG kernel's Fr products."""
    instr = hw["instr_per_fr"] if field == "fr" else hw["instr_per_mont"]
    latency = (hw["fr_latency_ms"] if field == "fr"
               else hw.get("mont_latency_ms"))
    ops_ms = mont_bound_ms(hw, products, instr)
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"bound_ms": max(ops_ms, mem_ms),
           "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
           "products": products}
    if chain is not None:
        out.update(chain_products=chain,
                   chain_bound_ms=chain * latency,
                   rate_bound_ms=out["bound_ms"])
        out["binds"] = ("chain" if out["chain_bound_ms"] > out["bound_ms"]
                        else "rate")
    return out


def bound_note(t: dict) -> str:
    if "chain_bound_ms" not in t:
        return f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
    return (f"rate bound {t['rate_bound_ms']:.4f} ms ({t['bound_by']}), "
            f"chain bound {t['chain_bound_ms']:.4f} ms ({t['chain_products']}"
            f" dependent products), the {t['binds']} bound binds")


def probe_product_latency(torch, PK, hw: dict) -> None:
    """One thread's chain of dependent Montgomery products, checked
    against the plain chain, then timed at two lengths: the difference
    over the extra products is the latency of one (it prices the chain
    bounds)."""
    from lighthouse_tpu_torch.crypto import fields as F
    from lighthouse_tpu_torch.crypto import limb_field as LF
    xy = rand_planes(torch, np.random.default_rng(SEED + 7), F, LF, 1, 2)
    check(torch.equal(PK.fp_mul_chain_kernel(xy, 64),
                      PK.fp_mul_chain_plain(xy, 64)),
          "fp_mul chain kernel != plain (raw limbs)")
    short = cuda_ms(torch, lambda: PK.fp_mul_chain_kernel(xy, CHAIN_SHORT), 5)
    long_ = cuda_ms(torch, lambda: PK.fp_mul_chain_kernel(xy, CHAIN_LONG), 5)
    hw["mont_latency_ms"] = (long_ - short) / (CHAIN_LONG - CHAIN_SHORT)
    print(f"dependent Montgomery product latency: "
          f"{hw['mont_latency_ms'] * 1e3:.4f} us "
          f"({hw['mont_latency_ms'] * 1e-3 * hw['clk_hz']:.0f} cycles at the "
          f"max SM clock; chains of {CHAIN_SHORT} and {CHAIN_LONG} on one "
          f"thread: {short:.3f} and {long_:.3f} ms; raw equal to the plain "
          f"chain of 64) [{hw['card']}]")


def combine_err(torch, PK, args) -> int:
    """Raw limbs of ``sigma_combine`` (the kernel) against
    ``sigma_combine_plain`` on the same partials; the flags exactly."""
    got, want = PK.sigma_combine(*args), PK.sigma_combine_plain(*args)
    if len(args) == 1:
        got, want = [got], [want]
    err = 0
    for (g_col, g_flag), (w_col, w_flag) in zip(got, want):
        check(bool(g_flag) == bool(w_flag), "sigma_combine identity flag "
                                            "!= plain")
        err = max(err, max_abs_err(torch, g_col, w_col))
    return err


def build_bls_batch(bls, F, rng):
    """The sync-committee batch of ``bench.py``: BLS_KEYS keys from a
    seed, BLS_MSGS messages, each signed by the summed secret key."""
    sks = [int(rng.integers(1, 2 ** 63)) * int(rng.integers(1, 2 ** 63))
           % F.R for _ in range(BLS_KEYS)]
    pks = [bls.SecretKey(k).public_key() for k in sks]
    fsum = sum(sks) % F.R
    msgs = [b"sync-comm-%03d" % i for i in range(BLS_MSGS)]
    signer = bls.SecretKey(fsum)
    return [bls.SignatureSet(signer.sign(m), list(pks), m) for m in msgs]


def rand_planes(torch, rng, F, LF, k: int, m: int):
    """(32·k, m) int32 blocks of random field elements below 2N."""
    vals = rng.integers(0, 2 ** 63, (k, m, 7), dtype=np.uint64)
    out = np.zeros((k, 32, m), np.int32)
    for b in range(k):
        for j in range(m):
            v = 0
            for w in vals[b, j]:
                v = (v << 63) | int(w)
            out[b, :26, j] = LF.int_to_limbs(v % (2 * F.P)).astype(np.int32)
    return torch.from_numpy(out.reshape(32 * k, m)).cuda()


def plain_products(PK, fn) -> int:
    """Montgomery products the plain version runs for ``fn()`` — the work
    these inputs need (dead lanes and repeated lanes are skipped)."""
    PK.MONT_PRODUCTS[0] = 0
    fn()
    return PK.MONT_PRODUCTS[0]


def group_configs(torch, PK, hw: dict) -> dict:
    """The group kernels' launch shapes at the paths' sizes (one group per
    lane pair for Miller+fold on 256 and 1280 lanes and for the Miller
    loop alone on 256 and 1024, per message for hash-to-G2 on 2 and 8
    cells, per lane for the sigma ladder at C = 2 and 8, per set for
    prepare on the block batch's 256 sets and BASELINE row 1's 1024, per
    output lane for product_chunks on the general path's 256, 512 and 768
    input lanes; the sigma butterfly one block of a cluster per 16
    lanes; the product butterfly a block per residue class, a group per K
    lanes of it, at 256, 512 and 1024 lanes), their dynamic shared memory
    and what ptxas gave them.  At the general path's largest sizes every
    SM gets a block, the sigma butterfly a cluster per chunk (64 blocks at
    C = 8), and the product butterfly one block per class (128)."""
    out = {}
    for which, sizes in (("miller_fold", (256, 1280)),
                         ("hash_g2", (2 * 256, 8 * 256)),
                         ("sigma", (2 * 128, 8 * 128)),
                         ("sigma_fold", (2 * 128, 8 * 128)),
                         ("prepare", (2 * 128, GEN_SETS)),
                         ("product_chunks", (256, 512, 768)),
                         ("miller", (256, GEN_SETS)),
                         ("product", (256, 512, 1024))):
        info = PK.group_kernel_info(which)
        if which == "product":    # a block a class, R / K groups (capped)
            R = [n // PK.LANE_BLOCK for n in sizes]
            groups = [min(r // min(info["lanes_per_group"], r),
                          info["groups"]) for r in R]
            blocks = [PK.LANE_BLOCK] * len(sizes)
            smem = [2 * r * 12 * 13 * 4    # the class's lanes twice, Fq12
                    + g * info["shared_bytes_per_group"]
                    for r, g in zip(R, groups)]
        else:
            groups = info["groups"]
            blocks = [n // info["lanes_per_group"] // groups for n in sizes]
            smem = groups * info["shared_bytes_per_group"]
        out[which] = {**info, "blocks": blocks,
                      "shared_bytes_per_block": smem}
        print(f"{which}: {info['G']} threads a group, {groups} "
              f"groups a block, {info['cluster']} blocks a cluster, blocks "
              f"{blocks} at {sizes} lanes, {smem} B shared memory a "
              f"block, {info['registers']} registers and "
              f"{info['local_bytes']} B stack a thread [{hw['card']}]")
        least = (sizes[-1] // PK.LANE_BLOCK * info["cluster"]
                 if which == "sigma_fold" else PK.LANE_BLOCK
                 if which == "product" else hw["sms"])
        check(blocks[-1] >= least, f"{which} launches {blocks[-1]} blocks "
                                   f"(want {least}) on {hw['sms']} SMs")
    return out


def race_child(which: str) -> None:
    """One small launch of a group kernel (one cell or chunk), for
    racecheck."""
    import torch
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.crypto import fields as F
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import limb_field as LF
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    device.set_default_device("cuda")
    rng = np.random.default_rng(SEED + 8)
    S = PK.PREP_S
    if which == "miller_fold":      # a live pair, j + 128 alone, dead pairs
        mask = torch.zeros((1, 2 * S), dtype=torch.int32, device="cuda")
        mask[0, [0, S, S + 1]] = 1
        PK.miller_fold_kernel_call(rand_planes(torch, rng, F, LF, 2, 2 * S),
                                   rand_planes(torch, rng, F, LF, 4, 2 * S),
                                   mask)
    elif which == "hash_g2":
        HK.hash_g2_kernel_call(rand_planes(torch, rng, F, LF, 2, 2 * S))
    else:                           # one chunk: live, dead and masked lanes
        def u32(n):
            return torch.from_numpy(rng.integers(0, 2 ** 32, (1, n),
                                                 dtype=np.uint64)
                                    .astype(np.uint32).view(np.int32)).cuda()
        mask = torch.ones((1, S), dtype=torch.int32, device="cuda")
        mask[0, :8] = 0
        lo, hi = u32(S), u32(S)
        lo[0, :4], hi[0, :4] = 0, 0
        if which == "sigma":
            PK.sigma_kernel_call(rand_planes(torch, rng, F, LF, 4, S), mask,
                                 lo, hi)
        else:                       # prepare, K = 2
            PK.prepare_kernel_call(rand_planes(torch, rng, F, LF, 2, 2 * S),
                                   torch.cat([mask, mask], 1), lo, hi, 2)
    torch.cuda.synchronize()
    print(f"race child {which}: launched")


def racecheck_group_kernels(hw: dict) -> dict:
    """compute-sanitizer's racecheck on one small launch of each group
    kernel, in a child process (this script with --race-child).  Fails on
    any hazard reported; where the tool is absent or cannot run on this
    card, says so: that is no pass."""
    tool = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(tool):
        print("racecheck: NOT RUN (no compute-sanitizer under the CUDA "
              "toolkit)")
        return {"run": False}
    result = {}
    for which in ("miller_fold", "hash_g2", "sigma", "prepare"):
        kernels = "lh_sigma_" if which == "sigma" else f"lh_{which}_kernel"
        cmd = [tool, "--tool", "racecheck", "--kernel-name",
               f"kns={kernels}", sys.executable,
               os.path.abspath(__file__), "--race-child", which]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=RACECHECK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            print(f"racecheck {which}: NOT RUN to its end (over "
                  f"{RACECHECK_TIMEOUT_S} s)")
            result[which] = "timeout"
            continue
        text = r.stdout + r.stderr
        if "Device not supported" in text:
            print(f"racecheck {which}: NOT RUN (compute-sanitizer reports "
                  f"'Device not supported' on {hw['card']}); no hazard "
                  f"result")
            result[which] = "device not supported"
            continue
        summary = [ln for ln in text.splitlines() if "RACECHECK SUMMARY" in ln]
        check(r.returncode == 0 and summary and " 0 hazards" in summary[-1]
              and "race child" in text,
              f"racecheck {which}: rc {r.returncode}, {summary or text[-800:]}")
        print(f"racecheck {which}: {summary[-1].strip(' =')}")
        result[which] = "clean"
    return result


def phase_bls_kernels(torch, hw: dict, sets, rand_fn) -> dict:
    from lighthouse_tpu_torch.crypto import fields as F
    from lighthouse_tpu_torch.crypto import hash_to_curve as H2C
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import limb_field as LF
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.crypto import tpu_backend as TB

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    S = PK.PREP_S
    entries = [(s.signature.point, [k.point for k in s.signing_keys],
                bytes(s.message)) for s in sets]
    entries, _ok = TB._dedup_shared_keygroups(entries)
    pk_pt = TB._shared_group_key(entries)
    check(pk_pt is not None, "the sync-committee batch did not collapse")
    n_chunks = (len(entries) + S - 1) // S
    (_c, lo, hi, u_np, sig_np, sigmask, setlive) = \
        TB._rlc_message_sig_columns(entries, n_chunks, rand_fn)

    def dev32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    u, sig_cols = dev32(u_np), dev32(sig_np)
    lo_d, hi_d = dev32(lo), dev32(hi)
    live, smask = dev32(setlive), dev32(sigmask)
    pk_col = dev32(TB.pk_columns(pk_pt))
    errs, timing = {}, {}

    # the field core alone: one Montgomery product per lane, edge words in
    a, b = rand_planes(torch, rng, F, LF, 1, 4096), \
        rand_planes(torch, rng, F, LF, 1, 4096)
    for j, v in enumerate((0, F.P - 1, 2 * F.P - 1, 2 * F.P)):
        a[:26, j] = torch.from_numpy(LF.int_to_limbs(v).astype(np.int32))
    want = PK.mont_mul(a[:26].long(), b[:26].long())
    check(torch.equal(PK.fp_mul_kernel(a, b)[:26].long(), want),
          "fp_mul kernel != plain mont_mul (raw limbs)")
    probe_product_latency(torch, PK, hw)

    def record(name, kern, plain, products, shape, chain=None):
        k_ms = cuda_ms(torch, kern, BLS_TIMED_RUNS)
        p_ms = cuda_ms(torch, plain, 1)
        t = {"ms": k_ms, "plain_ms": p_ms, **bounds(hw, products,
                                                    chain=chain)}
        timing[name] = t
        best = max(t["bound_ms"], t.get("chain_bound_ms", 0.0))
        print(f"{name}: {k_ms:.3f} ms kernel (median of {BLS_TIMED_RUNS}), "
              f"{p_ms:.1f} ms plain, {bound_note(t)} ({products} Montgomery "
              f"products × {hw['instr_per_mont']} instr) -> "
              f"{100 * best / k_ms:.2f}% of the binding bound, {shape} "
              f"[{hw['card']}]")

    # hash to G2: 2 cells, the path's 256 messages
    h_k = HK.hash_g2_kernel_call(u)
    h_p = HK.hash_g2_plain(u)
    errs["hash_g2"] = max_abs_err(torch, h_k, h_p)
    check(errs["hash_g2"] == 0, "hash_g2 kernel != plain (raw limbs)")
    cols = canonical_blocks(h_k)
    for j in rng.choice(len(entries), 4, replace=False):
        # the pure-Python curve half: independent of the native library
        want = H2C.hash_to_g2_python(entries[j][2])
        got = ((cols[0, j] * LF.RINV_INT % F.P, cols[1, j] * LF.RINV_INT
                % F.P), (cols[2, j] * LF.RINV_INT % F.P,
                         cols[3, j] * LF.RINV_INT % F.P))
        check(got == want, f"hash_g2 column {j} != host hash_to_g2")
    record("hash_g2", lambda: HK.hash_g2_kernel_call(u),
           lambda: HK.hash_g2_plain(u),
           plain_products(PK, lambda: HK.hash_g2_plain(u)),
           f"u {tuple(u.shape)}", chain=chain_products(PK, "hash_g2"))

    # sigma: the path's signature columns; random live/dead + dead chunk
    err = 0
    rsig = rand_planes(torch, rng, F, LF, 4, 2 * S)
    rmask = torch.from_numpy((rng.random((1, 2 * S)) < 0.6)
                             .astype(np.int32)).to(dev)
    rmask[0, S:] = 0
    rlo = dev32(rng.integers(0, 2 ** 32, (1, 2 * S), dtype=np.uint64)
                .astype(np.uint32))
    rhi = dev32(rng.integers(0, 2 ** 32, (1, 2 * S), dtype=np.uint64)
                .astype(np.uint32))
    rlo[0, S + 64:] = 0
    rhi[0, S + 64:] = 0
    for args in ((sig_cols, smask, lo_d, hi_d), (h_k, live, lo_d, hi_d),
                 (rsig, rmask, rlo, rhi)):
        err = max(err, max_abs_err(torch, PK.sigma_kernel_call(*args),
                                   PK.sigma_plain(*args)))
    errs["sigma"] = err
    check(err == 0, "sigma kernel != plain (raw limbs)")
    record("sigma", lambda: PK.sigma_kernel_call(sig_cols, smask, lo_d, hi_d),
           lambda: PK.sigma_plain(sig_cols, smask, lo_d, hi_d),
           plain_products(PK, lambda: PK.sigma_plain(sig_cols, smask, lo_d,
                                                     hi_d)),
           f"sig {tuple(sig_cols.shape)}, the path's columns",
           chain=chain_products(PK, "sigma"))

    # sigma_combine as the shared path calls it (the H and σ partials side
    # by side), and with an all-dead partial (its sum is the identity)
    h_part = PK.sigma_kernel_call(h_k, live, lo_d, hi_d)
    s_part = PK.sigma_kernel_call(sig_cols, smask, lo_d, hi_d)
    zeros = torch.zeros_like(lo_d)
    dead_part = PK.sigma_kernel_call(sig_cols, zeros, zeros, zeros)
    errs["sigma_combine"] = max(combine_err(torch, PK, args) for args in (
        (h_part, s_part), (dead_part,), (s_part, dead_part)))
    check(errs["sigma_combine"] == 0, "sigma_combine kernel != plain "
                                      "(raw limbs)")
    d_col, d_id = PK.sigma_combine(dead_part)
    check(bool(d_id) and not bool(d_col.any()),
          "sigma_combine of an all-dead partial: want flag 1 and zeros")
    n_chunks = h_part.shape[1] // S
    record("sigma_combine", lambda: PK.sigma_combine(h_part, s_part),
           lambda: PK.sigma_combine_plain(h_part, s_part),
           plain_products(PK, lambda: PK.sigma_combine_plain(h_part,
                                                             s_part)),
           f"two partials of C={n_chunks}",
           chain=chain_products(PK, "sigma_combine", n_chunks))

    # the path's Miller cell, then one with every lane live
    (h_col, h_id), (s_col, s_id) = PK.sigma_combine(h_part, s_part)
    g2 = torch.zeros((128, 2 * S), dtype=torch.int32, device=dev)
    g2[:, 0], g2[:, 1] = h_col, s_col
    mask = torch.zeros((1, 2 * S), dtype=torch.int32, device=dev)
    mask[0, 0] = (~h_id).to(torch.int32)
    mask[0, 1] = (~s_id).to(torch.int32)
    prod = PK.miller_fold_kernel_call(pk_col, g2, mask)
    err = max_abs_err(torch, prod, PK.miller_fold_plain(pk_col, g2, mask))
    rg1, rg2 = rand_planes(torch, rng, F, LF, 2, 2 * S), \
        rand_planes(torch, rng, F, LF, 4, 2 * S)
    ones = torch.ones((1, 2 * S), dtype=torch.int32, device=dev)
    high = torch.zeros_like(ones)
    high[0, S:] = 1                      # only lanes j + 128 live
    for mk in (ones, torch.zeros_like(ones), high):
        err = max(err, max_abs_err(torch, PK.miller_fold_kernel_call(
            rg1, rg2, mk), PK.miller_fold_plain(rg1, rg2, mk)))
    errs["miller_fold"] = err
    check(err == 0, "miller_fold kernel != plain (raw limbs)")
    record("miller_fold", lambda: PK.miller_fold_kernel_call(pk_col, g2, mask),
           lambda: PK.miller_fold_plain(pk_col, g2, mask),
           plain_products(PK, lambda: PK.miller_fold_plain(pk_col, g2, mask)),
           "one 256-lane cell, the path's 2 live lanes",
           chain=chain_products(PK, "miller_fold"))
    full_ms = cuda_ms(torch, lambda: PK.miller_fold_kernel_call(rg1, rg2, ones),
                      BLS_TIMED_RUNS)
    full_bound = mont_bound_ms(hw, plain_products(
        PK, lambda: PK.miller_fold_plain(rg1, rg2, ones)))
    print(f"miller_fold with all 256 lanes live: {full_ms:.3f} ms, bound "
          f"{full_bound:.4f} ms -> {100 * full_bound / full_ms:.2f}% of "
          f"bound [{hw['card']}]")

    # finalize: the valid product (== 1) and a random block (!= 1)
    ok_k, g_k = PK.finalize_kernel_call(prod, with_value=True)
    ok_p, g_p = PK.finalize_plain(prod, with_value=True)
    check(int(ok_k.item()) == 1 and int(ok_p.item()) == 1,
          f"finalize of the valid product: kernel {int(ok_k.item())}, "
          f"plain {int(ok_p.item())} (want 1)")
    err = max_abs_err(torch, g_k, g_p)
    rf = rand_planes(torch, rng, F, LF, 12, S)
    ok_k, g_k = PK.finalize_kernel_call(rf, with_value=True)
    ok_p, g_p = PK.finalize_plain(rf, with_value=True)
    check(int(ok_k.item()) == 0 and int(ok_p.item()) == 0,
          "finalize of a random block claims == 1")
    errs["finalize"] = max(err, max_abs_err(torch, g_k, g_p))
    check(errs["finalize"] == 0, "finalize kernel != plain (raw limbs)")
    record("finalize", lambda: PK.finalize_kernel_call(prod),
           lambda: PK.finalize_plain(prod),
           plain_products(PK, lambda: PK.finalize_plain(prod)),
           "(384, 128)", chain=chain_products(PK, "finalize"))
    print(f"BLS kernels vs plain on the card: raw limbs equal {errs} (Miller+"
          f"fold also all-dead and with only lanes j + 128 live); finalize "
          f"verdicts exact; 4 hash columns match the host hash_to_g2 "
          f"(pure Python)")
    return {"errs": errs, "timing": timing,
            "groups": group_configs(torch, PK, hw),
            "racecheck": racecheck_group_kernels(hw)}


# ---------------------------------------------------------------------------
# Phase 6: verify_signature_sets at 512 keys × 256 messages
# ---------------------------------------------------------------------------

def phase_bls_verify(torch, hw: dict, sets, rand_fn, kernel_ms) -> dict:
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.crypto import tpu_backend as TB

    backend = bls.get_backend()        # the port's default backend
    check(backend.name == "tpu", f"default BLS backend is {backend.name}")
    fbad = list(sets)
    fbad[3] = bls.SignatureSet(sets[4].signature, sets[3].signing_keys,
                               sets[3].message)
    falt = list(sets)
    falt[7] = bls.SignatureSet(sets[7].signature, sets[7].signing_keys,
                               sets[7].message + b"!")
    for d in (HK.LAUNCHES, PK.LAUNCHES):
        for k in d:
            d[k] = 0
    ok, ms = timed(torch, lambda: backend.verify_signature_sets(
        sets, rand_fn=rand_fn))
    check(ok is True, "the valid 512 × 256 batch did not verify")
    check(backend.verify_signature_sets(fbad, rand_fn=rand_fn) is False,
          "a batch with a swapped signature verified")
    check(backend.verify_signature_sets(falt, rand_fn=rand_fn) is False,
          "a batch with an altered message verified")
    launches = {k: v for k, v in {**HK.LAUNCHES, **PK.LAUNCHES}.items()
                if k in SHARED_PATH_KERNELS}
    print(f"verify main-path launches: {launches} [{hw['card']}]")
    for name, count in launches.items():
        check(count > 0, f"the verify path never launched the {name} kernel")
    print(f"verify 512 keys × 256 messages: valid True ({ms:.1f} ms cold), "
          f"swapped signature False, altered message False")

    walls = [timed(torch, lambda: backend.verify_signature_sets(
        sets, rand_fn=rand_fn))[1] for _ in range(VERIFY_RUNS)]
    print(f"verify wall ms {[round(w, 1) for w in walls]} median "
          f"{statistics.median(walls):.1f} [{hw['card']}]")
    agg_ms = TB.LAST_FAST_AGG_TIMINGS.get("aggregate_keys_ms")
    check(agg_ms is not None, "the shared path summed no keys")
    from lighthouse_tpu_torch.crypto import native
    check(native.ready(), "the key sum did not have the native library")
    print(f"aggregate_keys_ms {agg_ms:.3f} (native g1_aggregate of "
          f"{BLS_KEYS} keys, last warm call) [{hw['card']}]")
    stages = fenced_stages(TB, TB.LAST_FAST_AGG_TIMINGS, lambda:
                           backend.verify_signature_sets(sets,
                                                         rand_fn=rand_fn))
    print("stage split (ms, each stage fenced): " + json.dumps(
        {k: (round(v, 2) if isinstance(v, float) else v)
         for k, v in stages.items()}) + f" [{hw['card']}]")
    prof = profile_call(torch, hw, "verify", lambda:
                        backend.verify_signature_sets(sets, rand_fn=rand_fn),
                        kernel_ms)
    return {"launches": launches, "wall_ms": walls, "stages": stages,
            "profile": prof, "aggregate_keys_ms": agg_ms}


# ---------------------------------------------------------------------------
# Set-up of the general path's batches (host, pure Python)
# ---------------------------------------------------------------------------

def derive_g1_keys(F, C, sk0: int, step: int, n: int) -> list:
    """Affine [sk0 + step·i]·G for i < n: Jacobian mixed additions of
    [step]·G, then one batch inversion for all the Z coordinates."""
    p = F.P
    X, Y = C.g1_mul(C.G1_GEN, sk0)
    qx, qy = C.g1_mul(C.G1_GEN, step)
    Z = 1
    jac = [(X, Y, Z)]
    for _ in range(n - 1):
        zz = Z * Z % p
        h = (qx * zz - X) % p
        hh = h * h % p
        i4 = 4 * hh % p
        j = h * i4 % p
        r = 2 * (qy * Z % p * zz - Y) % p
        v = X * i4 % p
        X3 = (r * r - j - 2 * v) % p
        Y = (r * (v - X3) - 2 * Y * j) % p
        Z = ((Z + h) * (Z + h) - zz - hh) % p
        X = X3
        jac.append((X, Y, Z))
    prefix, acc = [], 1
    for _x, _y, z in jac:
        acc = acc * z % p
        prefix.append(acc)
    inv = pow(acc, p - 2, p)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        zi = inv * (prefix[i - 1] if i else 1) % p
        inv = inv * jac[i][2] % p
        zi2 = zi * zi % p
        out[i] = (jac[i][0] * zi2 % p, jac[i][1] * zi2 % p * zi % p)
    return out


def build_general_batch(bls, C, H2C, F, keys):
    """BASELINE row 1 as ``bench.py:154-164`` builds it: set i signs
    ``att-data-%03d`` % (i mod 64) under keys 16i … 16i+15 (secret key
    0x10000 + 7k), with the summed secret key A + B·i.  For one message
    the sets are r + 64t, so each signature is the previous one plus
    64·B·H(m): two scalar multiplications per message."""
    msgs = [b"att-data-%03d" % i for i in range(GEN_MSGS)]
    a = GEN_KEYS * GEN_SK0 + GEN_SK_STEP * GEN_KEYS * (GEN_KEYS - 1) // 2
    b = GEN_SK_STEP * GEN_KEYS * GEN_KEYS
    sigs = [None] * GEN_SETS
    for r in range(GEN_MSGS):
        h = H2C.hash_to_g2(msgs[r])
        pt = C.g2_mul(h, (a + b * r) % F.R)
        step = C.g2_mul(h, GEN_MSGS * b % F.R)
        for i in range(r, GEN_SETS, GEN_MSGS):
            sigs[i] = pt
            pt = C.g2_add(pt, step)
    pks = [bls.PublicKey(k) for k in keys[:GEN_SETS * GEN_KEYS]]
    sets = [bls.SignatureSet(bls.Signature(sigs[i]),
                             pks[i * GEN_KEYS:(i + 1) * GEN_KEYS],
                             msgs[i % GEN_MSGS]) for i in range(GEN_SETS)]
    sk17 = sum(GEN_SK0 + GEN_SK_STEP * (17 * GEN_KEYS + j)
               for j in range(GEN_KEYS)) % F.R
    check(bls.SecretKey(sk17).sign(msgs[17 % GEN_MSGS]).point
          == sets[17].signature.point, "set 17's signature != bench's")
    return sets


def build_block_batch(bls, C, H2C, F, keys, rng):
    """A mainnet block's signature batch at 2^20 validators: 128
    attestation aggregates over disjoint 512-member committees with about
    90% participation, one sync aggregate of about 460 of 512 members,
    and the proposer's block and randao sets (one key each).  Validator v
    has secret key 0x10000 + 7v; the committees take the validators after
    BASELINE row 1's 2^14."""
    base = GEN_SETS * GEN_KEYS
    sk = [GEN_SK0 + GEN_SK_STEP * v for v in range(len(keys))]
    pks = [bls.PublicKey(k) for k in keys]
    sets = []

    def signed(members, msg):
        s = sum(sk[v] for v in members) % F.R
        return bls.SignatureSet(bls.Signature(C.g2_mul(H2C.hash_to_g2(msg), s)),
                                [pks[v] for v in members], msg)

    for a in range(BLOCK_AGGREGATES):
        committee = base + a * COMMITTEE + np.arange(COMMITTEE)
        members = committee[rng.random(COMMITTEE) < PARTICIPATION]
        sets.append(signed(members.tolist(), b"block-att-data-%03d" % a))
    pool = base + np.arange(BLOCK_AGGREGATES * COMMITTEE)
    sync = rng.choice(pool, COMMITTEE, replace=False)
    sync = sync[rng.random(COMMITTEE) < SYNC_PARTICIPATION]
    sets.append(signed(sync.tolist(), b"sync-committee-block-root"))
    proposer = int(pool[7])
    sets.append(signed([proposer], b"beacon-block-root"))
    sets.append(signed([proposer], b"randao-reveal-epoch"))
    return sets, pks, sk


def lane_ints(planes, lane: int) -> list:
    """The Fq blocks of one lane as canonical integers (out of the
    Montgomery domain)."""
    from lighthouse_tpu_torch.crypto import limb_field as LF
    from lighthouse_tpu_torch.crypto.fields import P
    return [int(v) * LF.RINV_INT % P
            for v in canonical_blocks(planes[:, lane:lane + 1])[:, 0]]


def lane_fq12(planes, lane: int):
    c = lane_ints(planes, lane)
    return tuple(tuple((c[(i * 3 + j) * 2], c[(i * 3 + j) * 2 + 1])
                       for j in range(3)) for i in range(2))


def device_of_port():
    from lighthouse_tpu_torch import device
    return device.get_device()


def host_syncs(torch, call) -> list:
    """The synchronizing CUDA operations the port makes during ``call()``
    (PyTorch's sync debug mode), each as the innermost port frames that
    made it.  A warning raised with no port frame on the stack comes from
    switching the debug mode itself (seen once per process on the card)
    and is not counted."""
    import traceback
    import warnings
    where = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()
                      if "lighthouse_tpu_torch" in f.filename]
            if frames:
                where.append(" <- ".join(
                    f"{os.path.basename(f.filename)}:{f.lineno}({f.name})"
                    for f in reversed(frames[-3:])))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return where


def fenced_stages(TB, stats: dict, call) -> dict:
    """One verify with STAGE_TIMINGS on: each stage fenced by a device
    sync and timed into ``stats``; returns a copy of it."""
    TB.STAGE_TIMINGS = True
    try:
        call()
        return dict(stats)
    finally:
        TB.STAGE_TIMINGS = False


def zero_launches(*dicts) -> None:
    for d in dicts:
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# Phase 7: the general path's kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_general_kernels(torch, hw: dict, sets, rand_fn) -> dict:
    from lighthouse_tpu_torch.crypto import curve as C
    from lighthouse_tpu_torch.crypto import fields as F
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing as PAIR
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.crypto import tpu_backend as TB

    dev = device_of_port()
    rng = np.random.default_rng(SEED + 3)
    S, K = PK.PREP_S, GEN_KEYS
    entries = [(s.signature.point, [k.point for k in s.signing_keys],
                bytes(s.message)) for s in sets]
    (idx, kmask, lo, hi, u, sig, sigmask, setlive,
     k_bucket) = TB._marshal_group(entries, rand_fn)
    check(k_bucket == K, f"K bucket {k_bucket} != {K}")

    def dev32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    table = TB._PK_TABLE.device()
    pk = table.index_select(1, dev32(idx))
    kmask_d, lo_d, hi_d = dev32(kmask), dev32(lo), dev32(hi)
    errs, timing = {}, {}

    def record(name, kern, plain, products, nbytes, shape, chain=None,
               k_ms=None):
        if k_ms is None:
            k_ms = cuda_ms(torch, kern, BLS_TIMED_RUNS)
        p_ms = cuda_ms(torch, plain, 1)
        t = {"ms": k_ms, "plain_ms": p_ms, "bytes": nbytes,
             **bounds(hw, products, nbytes, chain)}
        timing[name] = t
        best = max(t["bound_ms"], t.get("chain_bound_ms", 0.0))
        print(f"{name}: {k_ms:.3f} ms kernel (median of {BLS_TIMED_RUNS}), "
              f"{p_ms:.1f} ms plain, {bound_note(t)}; {products} "
              f"Montgomery products, {nbytes} B -> "
              f"{100 * best / k_ms:.2f}% of the binding bound, {shape} "
              f"[{hw['card']}]")

    def compare_once(name, kern, plain, ins, shape, chain=None) -> int:
        """Raw limbs of one kernel call against one plain call on the
        same inputs (timed with CUDA events, its Montgomery products
        counted), then the kernel's median of BLS_TIMED_RUNS."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        PK.MONT_PRODUCTS[0] = 0
        a.record()
        want = plain(*ins)
        b.record()
        b.synchronize()
        p_ms, products = a.elapsed_time(b), PK.MONT_PRODUCTS[0]
        err = max_abs_err(torch, kern(*ins), want)
        check(err == 0, f"{name} kernel != plain at the general path's "
                        f"shape {shape} (raw limbs)")
        k_ms = cuda_ms(torch, lambda: kern(*ins), BLS_TIMED_RUNS)
        nbytes = 4 * (sum(x.numel() for x in ins) + want.numel())
        t = {"ms": k_ms, "plain_ms": p_ms, "shape": shape,
             **bounds(hw, products, nbytes, chain)}
        timing[name] = t
        best = max(t["bound_ms"], t.get("chain_bound_ms", 0.0))
        print(f"{name} at the general path's shape: raw max abs err {err}; "
              f"{k_ms:.3f} ms kernel (median of {BLS_TIMED_RUNS}), "
              f"{p_ms:.1f} ms plain (one run), {bound_note(t)}; {products} "
              f"Montgomery products, {nbytes} B -> {100 * best / k_ms:.2f}% "
              f"of the binding bound, {shape} [{hw['card']}]")
        return err

    # prepare at the path's shape, then with edge lanes: masked key slots,
    # a set whose keys are P and −P, dead lanes (one with a scalar)
    def col(set_i, k):
        return (set_i // S) * K * S + k * S + set_i % S

    pk_e, km_e = pk.clone(), kmask.copy()
    lo_e, hi_e = lo.copy(), hi.copy()
    km_e[0, [col(5, k) for k in range(8, K)]] = 0
    p77 = entries[77][1][0]
    for k, pt in ((0, p77), (1, C.g1_neg(p77))):
        pk_e[:, col(77, k)] = dev32(np.frombuffer(TB._g1_aff_col(pt),
                                                  np.uint32).copy())
    km_e[0, [col(77, k) for k in range(2, K)]] = 0
    dead = list(range(GEN_SETS - 24, GEN_SETS))
    keyless = GEN_SETS - 25                # no live key, a nonzero scalar
    km_e[0, [col(s_, k) for s_ in dead + [keyless] for k in range(K)]] = 0
    lo_e[0, dead], hi_e[0, dead] = 0, 0
    edge = (pk_e, dev32(km_e), dev32(lo_e), dev32(hi_e))
    err = 0
    for args in ((pk, kmask_d, lo_d, hi_d), edge):
        g_k, f_k = PK.prepare_kernel_call(*args, K)
        g_p, f_p = PK.prepare_plain(*args, K)
        err = max(err, max_abs_err(torch, g_k, g_p),
                  max_abs_err(torch, f_k, f_p))
    errs["prepare"] = err
    check(err == 0, "prepare kernel != plain (raw limbs)")
    g_e, f_e = PK.prepare_kernel_call(*edge, K)

    def scalar(lane):
        return int(lo_e[0, lane]) | (int(hi_e[0, lane]) << 32)

    for lane, nkeys in ((0, K), (5, 8)):
        agg = None
        for p in entries[lane][1][:nkeys]:
            agg = C.g1_add(agg, p)
        check(tuple(lane_ints(g_e, lane)) == C.g1_mul(agg, scalar(lane)),
              f"prepare lane {lane} != c·Σ keys on the host")
        check(int(f_e[0, lane]) == 0, f"prepare flagged live lane {lane}")
    for lane in (77, keyless, dead[0], dead[-1]):
        check(int(f_e[0, lane]) == 1 and lane_ints(g_e, lane) == [0, 0],
              f"prepare lane {lane}: want flag 1 and (0, 0)")
    g1_aff, _flags = PK.prepare_kernel_call(pk, kmask_d, lo_d, hi_d, K)
    record("prepare",
           lambda: PK.prepare_kernel_call(pk, kmask_d, lo_d, hi_d, K),
           lambda: PK.prepare_plain(pk, kmask_d, lo_d, hi_d, K),
           plain_products(PK, lambda: PK.prepare_plain(pk, kmask_d, lo_d,
                                                       hi_d, K)),
           4 * (64 * pk.shape[1] + pk.shape[1] + 2 * GEN_SETS
                + 65 * GEN_SETS), f"C=8, K={K}, pk {tuple(pk.shape)}",
           chain=chain_products(PK, "prepare", K=K))

    # PR 2's kernels at this path's shapes: hash-to-G2 on 8 cells, sigma
    # on C = 8, Miller+fold on the padded (C+1)·128 → 1280-lane cell
    u_d, sig_d = dev32(u), dev32(sig)
    smask_d, live_d = dev32(sigmask), dev32(setlive)
    h_cols = HK.hash_g2_kernel_call(u_d)
    cell = TB.miller_cell(g1_aff, h_cols, *PK.sigma_combine(
        PK.sigma_kernel_call(sig_d, smask_d, lo_d, hi_d)), smask_d, live_d)
    n_live, width = int(cell[2].sum()), cell[0].shape[1]
    check(width == -(-(GEN_SETS + S) // (2 * S)) * 2 * S
          and n_live == GEN_SETS + 1,
          f"Miller cell of {width} lanes with {n_live} live")
    # sigma_combine at C = 8 (one partial, as fused_pipeline_body calls
    # it), and an all-dead partial of the same width
    part = PK.sigma_kernel_call(sig_d, smask_d, lo_d, hi_d)
    zeros = torch.zeros_like(lo_d)
    dead_part = PK.sigma_kernel_call(sig_d, zeros, zeros, zeros)
    errs["sigma_combine"] = max(combine_err(torch, PK, (p,))
                                for p in (part, dead_part))
    check(errs["sigma_combine"] == 0, "sigma_combine kernel != plain at "
                                      "C=8 (raw limbs)")
    check(bool(PK.sigma_combine(dead_part)[1]),
          "sigma_combine of an all-dead C=8 partial is not the identity")
    n_chunks = part.shape[1] // S
    record("sigma_combine", lambda: PK.sigma_combine(part),
           lambda: PK.sigma_combine_plain(part),
           plain_products(PK, lambda: PK.sigma_combine_plain(part)),
           4 * (part.numel() + 129), f"one partial, C={n_chunks}",
           chain=chain_products(PK, "sigma_combine", n_chunks))
    for name, kern, plain, ins, shape in (
            ("hash_g2", HK.hash_g2_kernel_call, HK.hash_g2_plain, (u_d,),
             f"u {tuple(u_d.shape)}"),
            ("sigma", PK.sigma_kernel_call, PK.sigma_plain,
             (sig_d, smask_d, lo_d, hi_d),
             f"sig {tuple(sig_d.shape)}, C={sig_d.shape[1] // S}"),
            ("miller_fold", PK.miller_fold_kernel_call, PK.miller_fold_plain,
             cell, f"{cell[0].shape[1]} lanes, {n_live} live")):
        chain = chain_products(PK, name)
        errs[name] = compare_once(name, kern, plain, ins, shape, chain)

    # miller at 256, 384 (three blocks) and 1024 lanes on the path's
    # points (c·aggpk, H(m)), each shape timed
    err, miller_ms = 0, {}
    for m in (256, 384, GEN_SETS):
        g1m, g2m = g1_aff[:, :m].contiguous(), h_cols[:, :m].contiguous()
        err = max(err, max_abs_err(torch, PK.miller_kernel_call(g1m, g2m),
                                   PK.miller_plain(g1m, g2m)))
        miller_ms[m] = cuda_ms(torch, lambda g1m=g1m, g2m=g2m:
                               PK.miller_kernel_call(g1m, g2m),
                               BLS_TIMED_RUNS)
    errs["miller"] = err
    check(err == 0, "miller kernel != plain (raw limbs)")
    print(f"miller ms by lanes (median of {BLS_TIMED_RUNS}): "
          f"{ {k: round(v, 4) for k, v in miller_ms.items()} } "
          f"[{hw['card']}]")
    f = PK.miller_kernel_call(g1_aff, h_cols)
    for lane in (3,):
        P1 = tuple(lane_ints(g1_aff, lane))
        x0, x1, y0, y1 = lane_ints(h_cols, lane)
        fe3 = PAIR.final_exponentiation_cubed
        check(fe3(lane_fq12(f, lane))
              == fe3(PAIR.miller_loop(P1, ((x0, x1), (y0, y1)))),
              f"miller lane {lane} != the host pairing")
    record("miller", lambda: PK.miller_kernel_call(g1_aff, h_cols),
           lambda: PK.miller_plain(g1_aff, h_cols),
           plain_products(PK, lambda: PK.miller_plain(g1_aff, h_cols)),
           4 * (64 + 128 + 384) * GEN_SETS, f"{GEN_SETS} lanes",
           chain=chain_products(PK, "miller"))
    timing["miller"]["ms_by_lanes"] = miller_ms

    # product_chunks at the main path's shapes: 5 blocks padded with the
    # ONE block (768 lanes), then 512 and 256, masked or not, each timed
    one = torch.from_numpy(TB._ONE_BLOCK.view(np.int32)).to(dev)
    f768 = torch.cat([f[:, :640], one], 1)
    ones = torch.ones((1, 768), dtype=torch.int32, device=dev)
    rmask = dev32((rng.random((1, 768)) < 0.7).astype(np.int32))
    err, pc_ms, pc_paced = 0, {}, {}
    for lanes in (768, 512, 256):
        fl, ol = f768[:, :lanes].contiguous(), ones[:, :lanes].contiguous()
        for mk in (ol, rmask[:, :lanes].contiguous()):
            err = max(err, max_abs_err(
                torch, PK.product_chunks_kernel_call(fl, mk),
                PK.product_chunks_plain(fl, mk)))
        pc_paced[lanes] = cuda_ms(torch, lambda fl=fl, ol=ol:
                                  PK.product_chunks_kernel_call(fl, ol),
                                  BLS_TIMED_RUNS)
        pc_ms[lanes] = queued_ms(torch, lambda fl=fl, ol=ol:
                                 PK.product_chunks_kernel_call(fl, ol),
                                 BLS_TIMED_RUNS)
    errs["product_chunks"] = err
    check(err == 0, "product_chunks kernel != plain (raw limbs)")
    print(f"product_chunks ms by input lanes, {BLS_TIMED_RUNS} calls queued "
          f"behind a spin (device time a call): "
          f"{ {k: round(v, 4) for k, v in pc_ms.items()} }; one call at a "
          f"time (median of {BLS_TIMED_RUNS}, the host's launch included): "
          f"{ {k: round(v, 4) for k, v in pc_paced.items()} } [{hw['card']}]")
    pc = PK.product_chunks_kernel_call(f768, ones)
    for lane in (0, 2 * 128 + 9):        # chunk 2: lanes 521 and 649
        c, j = divmod(lane, 128)
        check(lane_fq12(pc, lane) == F.fq12_mul(
            lane_fq12(f768, 256 * c + j), lane_fq12(f768, 256 * c + 128 + j)),
            f"product_chunks lane {lane} != the host Fq12 product")
    record("product_chunks",
           lambda: PK.product_chunks_kernel_call(f768, ones),
           lambda: PK.product_chunks_plain(f768, ones),
           plain_products(PK, lambda: PK.product_chunks_plain(f768, ones)),
           4 * (384 * 768 + 768 + 384 * 384), "768 -> 384 lanes",
           chain=chain_products(PK, "product_chunks"), k_ms=pc_ms[768])
    timing["product_chunks"].update(ms_paced=pc_paced[768],
                                    ms_by_lanes=pc_ms)

    # product on the path's Miller values at 128 ... 1024 lanes, the mask
    # all ones and random, each timed; 512 lanes with the random mask is
    # the recorded shape
    check(f.shape[1] == 1024, f"Miller values on {f.shape[1]} lanes")
    rm1024 = dev32((rng.random((1, 1024)) < 0.8).astype(np.int32))
    err, pr_ms, pr_paced = 0, {}, {}
    for lanes in (128, 256, 512, 1024):
        fl = f[:, :lanes].contiguous()
        ml = rm1024[:, :lanes].contiguous()
        for mk in (torch.ones_like(ml), ml):
            err = max(err, max_abs_err(torch, PK.product_kernel_call(fl, mk),
                                       PK.product_plain(fl, mk)))
        pr_paced[lanes] = cuda_ms(torch, lambda fl=fl, ml=ml:
                                  PK.product_kernel_call(fl, ml),
                                  BLS_TIMED_RUNS)
        pr_ms[lanes] = queued_ms(torch, lambda fl=fl, ml=ml:
                                 PK.product_kernel_call(fl, ml),
                                 BLS_TIMED_RUNS)
    errs["product"] = err
    check(err == 0, "product kernel != plain (raw limbs)")
    print(f"product ms by lanes (random mask), {BLS_TIMED_RUNS} calls queued "
          f"behind a spin (device time a call): "
          f"{ {k: round(v, 4) for k, v in pr_ms.items()} }; one call at a "
          f"time (median of {BLS_TIMED_RUNS}, the host's launch included): "
          f"{ {k: round(v, 4) for k, v in pr_paced.items()} } [{hw['card']}]")
    f512 = f[:, :512].contiguous()
    m512 = rm1024[:, :512].contiguous()
    pr = PK.product_kernel_call(f512, m512)
    want = F.FQ12_ONE
    for r in range(4):
        if int(m512[0, 128 * r + 7]):
            want = F.fq12_mul(want, lane_fq12(f512, 128 * r + 7))
    check(lane_fq12(pr, 7) == want, "product lane 7 != the host product")
    # the kernel's products: 54 a lane at each of the log2(M/128) levels
    levels = chain_products(PK, "product", M=512)
    products = 54 * 512 * levels
    check(products == plain_products(PK, lambda: PK.product_plain(f512, m512)),
          "the product kernel's Montgomery products != the plain version's")
    record("product", lambda: PK.product_kernel_call(f512, m512),
           lambda: PK.product_plain(f512, m512), products,
           4 * (384 * 512 * 2 + 512), "512 lanes", chain=levels,
           k_ms=pr_ms[512])
    timing["product"].update(ms_paced=pr_paced[512], ms_by_lanes=pr_ms)

    # finalize at 256 and 512 lanes: a product of 1 (the path's valid
    # product beside ONE blocks) and one that is not 1
    prod_valid, bad_flag = TB.fused_pipeline_body(
        table, dev32(idx), kmask_d, lo_d, hi_d, dev32(u), dev32(sig),
        dev32(sigmask), dev32(setlive), K=K)
    check(not bool(bad_flag), "the valid batch flagged an identity key sum")
    err = 0
    for lanes in (256, 512):
        for fin, want_ok in (
                (torch.cat([prod_valid] + [one] * (lanes // 128 - 1), 1), 1),
                (f[:, :lanes].contiguous(), 0)):
            ok_k, g_k = PK.finalize_kernel_call(fin, with_value=True)
            ok_p, g_p = PK.finalize_plain(fin, with_value=True)
            check(int(ok_k.item()) == want_ok == int(ok_p.item()),
                  f"finalize at {lanes} lanes: kernel {int(ok_k.item())}, "
                  f"plain {int(ok_p.item())}, want {want_ok}")
            err = max(err, max_abs_err(torch, g_k, g_p))
        f_ms = cuda_ms(torch, lambda: PK.finalize_kernel_call(fin),
                       BLS_TIMED_RUNS)
        print(f"finalize at {lanes} lanes: {f_ms:.3f} ms (median of "
              f"{BLS_TIMED_RUNS}; {lanes // 128 - 1} product_chunks "
              f"launches ahead of the kernel) [{hw['card']}]")
    check(err == 0, "widened finalize kernel != plain (raw limbs)")
    errs["finalize_wide"] = err
    print(f"general-path kernels vs plain on the card: raw limbs equal "
          f"{errs}; host checks pass (prepare c·Σ keys, the P + (−P) and "
          f"dead lanes, a Miller lane, product_chunks and product lanes)")
    return {"errs": errs, "timing": timing}


# ---------------------------------------------------------------------------
# Phase 8: BASELINE row 1 on the general path
# ---------------------------------------------------------------------------

def profile_call(torch, hw: dict, label: str, fn, kernel_ms=None) -> dict:
    """One call under torch.profiler: wall, device busy time, idle share,
    the CUDA kernels launched (device events other than copies and
    memsets), the top device ops.

    Late in this long process the trace has been seen to miss the first
    port kernels of a call (the first ~50 ms of a verify's ctypes
    launches; a fresh process records them all).  The port's launch
    counters are exact, so the port kernels the trace lacks are added to
    the kernel count (a sigma call is two CUDA kernels,
    ``KERNELS_PER_CALL``), and their time at ``kernel_ms`` (name → median
    ms of that call on this card, phases 5 and 7) to the busy time; the
    correction is printed."""
    from torch.profiler import ProfilerActivity, profile

    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.kzg import device as KD

    before = {**HK.LAUNCHES, **PK.LAUNCHES, **KD.LAUNCHES}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(torch, fn)
    launched = {k: v - before[k] for k, v in {**HK.LAUNCHES, **PK.LAUNCHES,
                                              **KD.LAUNCHES}.items()}
    devt = device_events(prof)
    traced_busy = sum(d for d, _c, _k in devt) / 1e3
    copies = sum(c for _d, c, k in devt if k.startswith(("Memcpy", "Memset")))
    traced = {}
    for _d, c, k in devt:   # "lh_<name>_kernel(...)", "void lh_<name>_kernel<G>(...)"
        k = k.removeprefix("void ")
        if k.startswith("lh_"):
            name = k.split("(")[0].split("<")[0][3:].removesuffix("_kernel")
            name = TRACE_NAMES.get(name, name)
            traced[name] = traced.get(name, 0) + c
    # CUDA kernels the trace lacks, per launch counter
    missed = {k: KERNELS_PER_CALL.get(k, 1) * n - traced.get(k, 0)
              for k, n in launched.items()
              if KERNELS_PER_CALL.get(k, 1) * n > traced.get(k, 0)}
    kernel_ms = kernel_ms or {}
    unpriced = sorted(k for k in missed if k not in kernel_ms)
    check(not unpriced, f"profile {label}: the trace missed {unpriced} "
                        f"and no kernel time prices them")
    added = sum(n * kernel_ms[k] / KERNELS_PER_CALL.get(k, 1)
                for k, n in missed.items())
    busy = traced_busy + added
    kernels = sum(c for _d, c, _k in devt) - copies + sum(missed.values())
    note = "" if not missed else (
        f" ({traced_busy:.3f} traced + {added:.3f} for the port launches "
        f"the trace missed: {missed}, at their kernel medians)")
    print(f"profile {label}: wall {wall:.1f} ms (under the profiler), "
          f"device busy {busy:.3f} ms{note}, idle share "
          f"{1 - busy / wall:.4f}, {kernels} CUDA kernel launches and "
          f"{copies} copies/memsets [{hw['card']}]")
    print("  device: " + "; ".join(f"{k} x{c} {d / 1e3:.3f} ms"
                                   for d, c, k in devt[:8]))
    return {"wall_ms": wall, "busy_ms": busy, "kernels": kernels,
            "copies": copies, "missed": missed}


def verify_in_two_sub_batches(torch, hw: dict, backend, sets, swapped,
                              rand_fn) -> None:
    """The sub-batch split under one K: LIGHTHOUSE_TPU_PIPELINE_SETS =
    half the batch cuts BASELINE row 1 into two C = 4 work items (each
    640 → 768 → 384 → 512 → 256 → 128 lanes), and the finalize takes 256
    lanes."""
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.crypto import tpu_backend as TB

    os.environ["LIGHTHOUSE_TPU_PIPELINE_SETS"] = str(len(sets) // 2)
    try:
        zero_launches(HK.LAUNCHES, PK.LAUNCHES)
        ok, split_ms = timed(torch, lambda: backend.verify_signature_sets(
            sets, rand_fn=rand_fn))
        launches = {**HK.LAUNCHES, **PK.LAUNCHES}
        stats = dict(TB.LAST_PIPELINE_STATS)
        check(ok is True, "the valid batch in two sub-batches did not verify")
        want = {"prepare": 2, "hash_g2": 2, "sigma": 2, "sigma_combine": 2,
                "miller_fold": 2, "product_chunks": 5, "finalize": 1,
                "miller": 0, "product": 0}
        check(launches == want and stats["dispatches"] == 2,
              f"split launches {launches}, dispatches {stats['dispatches']}; "
              f"want {want} and 2")
        check(backend.verify_signature_sets(swapped, rand_fn=rand_fn)
              is False, "the key-swapped batch in two sub-batches verified")
    finally:
        del os.environ["LIGHTHOUSE_TPU_PIPELINE_SETS"]
    print(f"verify {len(sets)} sets in two sub-batches "
          f"(LIGHTHOUSE_TPU_PIPELINE_SETS={len(sets) // 2}): valid True in "
          f"{split_ms:.1f} ms, key swap False; launches {launches}; "
          f"host_prep_ms {stats['host_prep_ms']:.2f}, overlap_efficiency "
          f"{stats['overlap_efficiency']} [{hw['card']}]")


def phase_general_verify(torch, hw: dict, sets, rand_fn, kernel_ms) -> dict:
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto import curve as C
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.crypto import tpu_backend as TB

    backend = bls.get_backend()
    check(backend.name == "tpu", f"default BLS backend is {backend.name}")
    tampered = {}
    bad = list(sets)
    bad[17] = bls.SignatureSet(sets[17].signature, sets[18].signing_keys,
                               sets[17].message)           # bench.py's swap
    tampered["key swap (bench.py)"] = bad
    bad = list(sets)
    bad[5] = bls.SignatureSet(sets[6].signature, sets[5].signing_keys,
                              sets[5].message)
    tampered["wrong signature"] = bad
    bad = list(sets)
    bad[9] = bls.SignatureSet(sets[9].signature, sets[9].signing_keys,
                              sets[9].message + b"!")
    tampered["altered message"] = bad
    bad = list(sets)
    half = sets[33].signing_keys[:GEN_KEYS // 2]
    bad[33] = bls.SignatureSet(
        sets[33].signature,
        half + [bls.PublicKey(C.g1_neg(k.point)) for k in half],
        sets[33].message)
    tampered["identity key sum"] = bad

    TB._PK_TABLE = TB._DevicePubkeyTable()        # cold: an empty table
    zero_launches(HK.LAUNCHES, PK.LAUNCHES)
    ok, cold_ms = timed(torch, lambda: backend.verify_signature_sets(
        sets, rand_fn=rand_fn))
    launches = {**HK.LAUNCHES, **PK.LAUNCHES}
    check(ok is True, "the valid 1024 × 16 batch did not verify")
    check(TB.LAST_PIPELINE_STATS.get("path") == "cuda_general",
          f"the batch took {TB.LAST_PIPELINE_STATS.get('path')}")
    print(f"general verify main-path launches (one call): {launches} "
          f"[{hw['card']}]")
    want = {"prepare": 1, "hash_g2": 1, "sigma": 1, "sigma_combine": 1,
            "miller_fold": 1, "product_chunks": 3, "finalize": 1, "miller": 0,
            "product": 0}
    check(launches == want, f"launches {launches} != {want}")
    print(f"verify 1024 sets × 16 keys: valid True, cold {cold_ms:.1f} ms "
          f"(empty pubkey table, {TB._PK_TABLE._n - 1} keys added)")
    for name, batch in tampered.items():
        check(backend.verify_signature_sets(batch, rand_fn=rand_fn) is False,
              f"the batch with a {name} verified")
    print("tampered batches all False: " + ", ".join(tampered))
    walls = [timed(torch, lambda: backend.verify_signature_sets(
        sets, rand_fn=rand_fn))[1] for _ in range(VERIFY_RUNS)]
    print(f"general verify warm wall ms {[round(w, 1) for w in walls]} "
          f"median {statistics.median(walls):.1f} [{hw['card']}]")
    stats = dict(TB.LAST_PIPELINE_STATS)
    syncs = host_syncs(torch, lambda: backend.verify_signature_sets(
        sets, rand_fn=rand_fn))
    print(f"host syncs in one warm general verify: {len(syncs)} {syncs}")
    check(len(syncs) == 1, f"a general verify made {len(syncs)} host "
                           f"syncs, not 1 (the verdict): {syncs}")
    stages = fenced_stages(TB, TB.LAST_PIPELINE_STATS, lambda:
                           backend.verify_signature_sets(sets,
                                                         rand_fn=rand_fn))
    print("general stage split (ms, each stage fenced): " + json.dumps(
        {k: (round(v, 2) if isinstance(v, float) else v)
         for k, v in stages.items()}) + f" [{hw['card']}]")
    prof = profile_call(torch, hw, "general verify 1024 × 16", lambda:
                        backend.verify_signature_sets(sets, rand_fn=rand_fn),
                        kernel_ms)
    check(prof["kernels"] < MAX_WARM_LAUNCHES,
          f"a warm general verify launched {prof['kernels']} CUDA kernels, "
          f"not fewer than {MAX_WARM_LAUNCHES}")

    verify_in_two_sub_batches(torch, hw, backend, sets,
                              tampered["key swap (bench.py)"], rand_fn)
    return {"launches": launches, "cold_ms": cold_ms, "walls": walls,
            "stats": stats, "stages": stages, "profile": prof}


# ---------------------------------------------------------------------------
# Phase 9: a mainnet block's batch through the multi-K route
# ---------------------------------------------------------------------------

def phase_block_verify(torch, hw: dict, block, rand_fn) -> dict:
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto import curve as C
    from lighthouse_tpu_torch.crypto import hash_to_curve as H2C
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.crypto import tpu_backend as TB
    from lighthouse_tpu_torch.crypto.fields import R

    sets, pks, sk = block
    backend = bls.get_backend()
    ks = sorted({len(s.signing_keys) for s in sets})
    print(f"block batch: {len(sets)} sets, key counts {ks[0]}..{ks[-1]} "
          f"(K buckets {sorted({TB._next_pow2(k) for k in ks})})")
    zero_launches(HK.LAUNCHES, PK.LAUNCHES)
    ok, ms = timed(torch, lambda: backend.verify_signature_sets(
        sets, rand_fn=rand_fn))
    launches = {**HK.LAUNCHES, **PK.LAUNCHES}
    check(ok is True, "the valid block batch did not verify")
    want = {"prepare": 2, "hash_g2": 2, "sigma": 2, "sigma_combine": 2,
            "miller_fold": 2, "product_chunks": 2, "finalize": 1, "miller": 0,
            "product": 0}
    check(launches == want, f"block launches {launches} != {want}")
    check(TB.LAST_PIPELINE_STATS["dispatches"] == 2,
          f"block batch dispatches {TB.LAST_PIPELINE_STATS['dispatches']}")
    bad = list(sets)
    bad[3] = bls.SignatureSet(sets[4].signature, sets[3].signing_keys,
                              sets[3].message)
    check(backend.verify_signature_sets(bad, rand_fn=rand_fn) is False,
          "the block batch with a swapped signature verified")
    # the two work items' Miller+fold and prepare inputs (K 512 and K 1),
    # recorded in one more valid call, each kernel against its plain version
    recorded = {"miller_fold": [], "prepare": []}
    calls = {name: getattr(PK, f"{name}_kernel_call") for name in recorded}

    def recorder(name):
        def call(*args):
            recorded[name].append([a.clone() if isinstance(a, torch.Tensor)
                                   else a for a in args])
            return calls[name](*args)
        return call

    for name in recorded:
        setattr(PK, f"{name}_kernel_call", recorder(name))
    try:
        check(backend.verify_signature_sets(sets, rand_fn=rand_fn) is True,
              "the valid block batch did not verify (recorded call)")
    finally:
        for name, fn in calls.items():
            setattr(PK, f"{name}_kernel_call", fn)
    for name, got in recorded.items():
        check(len(got) == 2, f"{len(got)} {name} calls, not 2")
    miller_err = max(max_abs_err(torch, calls["miller_fold"](*a),
                                 PK.miller_fold_plain(*a))
                     for a in recorded["miller_fold"])
    check(miller_err == 0, "miller_fold kernel != plain on the block batch's "
                           "inputs (raw limbs)")
    print("block batch Miller+fold inputs " + ", ".join(
        f"{a[0].shape[1]} lanes ({int(a[2].sum())} live)"
        for a in recorded["miller_fold"]) + ": kernel raw equal to plain")
    prepare_err, prepare_block = 0, []
    for a in recorded["prepare"]:
        K, lanes = a[4], a[2].shape[1]
        (g_k, f_k), (g_p, f_p) = calls["prepare"](*a), PK.prepare_plain(*a)
        err = max(max_abs_err(torch, g_k, g_p), max_abs_err(torch, f_k, f_p))
        check(err == 0, f"prepare kernel != plain on the block batch's K={K} "
                        f"item (raw limbs)")
        prepare_err = max(prepare_err, err)
        live = int(((a[1].view(-1, K, PK.PREP_S) != 0).any(1).flatten()
                    | (a[2][0] != 0) | (a[3][0] != 0)).sum())
        ms = cuda_ms(torch, lambda: calls["prepare"](*a), BLS_TIMED_RUNS)
        chain = chain_products(PK, "prepare", K=K)
        t = {"K": K, "sets": lanes, "live": live, "ms": ms,
             "chain_products": chain,
             "chain_bound_ms": chain * hw["mont_latency_ms"]}
        prepare_block.append(t)
        print(f"block batch prepare K={K}: {lanes} sets ({live} live), kernel "
              f"raw equal to plain; {ms:.3f} ms (median of {BLS_TIMED_RUNS}), "
              f"chain bound {t['chain_bound_ms']:.4f} ms ({chain} dependent "
              f"products) -> {100 * t['chain_bound_ms'] / ms:.2f}% of it "
              f"[{hw['card']}]")
    warm = [timed(torch, lambda: backend.verify_signature_sets(
        sets, rand_fn=rand_fn))[1] for _ in range(3)]
    print(f"block verify: valid True ({ms:.1f} ms cold table for its keys, "
          f"warm {[round(w, 1) for w in warm]} ms), swapped signature "
          f"False; launches {launches}: two work items, the finalize on 256 "
          f"lanes [{hw['card']}]")
    stages = fenced_stages(TB, TB.LAST_PIPELINE_STATS, lambda:
                           backend.verify_signature_sets(sets,
                                                         rand_fn=rand_fn))
    print("block stage split (ms, each stage fenced, summed over the two "
          "work items): " + json.dumps(
              {k: (round(v, 2) if isinstance(v, float) else v)
               for k, v in stages.items()}) + f" [{hw['card']}]")

    att = sets[0]
    signers = [int(v) for v in np.arange(4) * 1000 + 3 + GEN_SETS * GEN_KEYS]
    msgs = [b"aggregate-verify-%d" % i for i in range(4)]
    agg = None
    for v, m in zip(signers, msgs):
        agg = C.g2_add(agg, C.g2_mul(H2C.hash_to_g2_python(m), sk[v] % R))
    keys = [pks[v] for v in signers]
    # both routes: the device pipeline (fast path off) and the native host
    # fast path (the default takes batches of up to 4 sets)
    for route, knob in (("device", "0"), ("host", None)):
        if knob is None:
            os.environ.pop("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX", None)
        else:
            os.environ["LIGHTHOUSE_TPU_HOST_FASTPATH_MAX"] = knob
        zero_launches(HK.LAUNCHES, PK.LAUNCHES)
        check(backend.verify(att.signature, att.signing_keys, att.message)
              is True, f"verify of one attestation aggregate failed "
                       f"({route})")
        check(backend.verify(att.signature, att.signing_keys,
                             att.message + b"!") is False,
              f"verify of an altered message passed ({route})")
        check(backend.aggregate_verify(bls.Signature(agg), keys, msgs)
              is True, f"aggregate_verify of 4 signers failed ({route})")
        check(backend.aggregate_verify(bls.Signature(agg), keys,
                                       msgs[1:] + msgs[:1]) is False,
              f"aggregate_verify with the messages rotated passed ({route})")
        launched = sum(HK.LAUNCHES.values()) + sum(PK.LAUNCHES.values())
        check((launched > 0) == (route == "device"),
              f"{route} route launched {launched} BLS kernels")
    os.environ.pop("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX", None)
    print("verify: valid True, altered message False; aggregate_verify "
          "(4 signers): valid True, messages rotated False; on the device "
          "route and on the host fast path (no kernel launched)")
    return {"launches": launches, "ms": ms, "warm": warm, "stages": stages,
            "miller_err": miller_err, "prepare_err": prepare_err,
            "prepare_block": prepare_block}


# ---------------------------------------------------------------------------
# Phase 10: the stage profile and the latency chain (miller, product)
# ---------------------------------------------------------------------------

def phase_profiles(torch, hw: dict) -> dict:
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.crypto import profiling

    zero_launches(HK.LAUNCHES, PK.LAUNCHES)
    prof = profiling.profile_stages(n=10, C=8)
    stage_launches = {**HK.LAUNCHES, **PK.LAUNCHES}
    print("profile_stages(C=8): " + json.dumps(
        {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in prof.items()}) + f" [{hw['card']}]")
    check(stage_launches["miller"] > 0, "the stage profile never launched "
                                        "the miller kernel")

    dev = device_of_port()
    rng = np.random.default_rng(SEED + 4)
    S = PK.PREP_S

    def planes(rows, cols):
        return torch.from_numpy(rng.integers(0, 2 ** 16, (rows, cols))
                                .astype(np.int32)).to(dev)

    pk, g2 = planes(64, 2 * S), planes(128, 2 * S)
    ones = torch.ones((1, 2 * S), dtype=torch.int32, device=dev)
    zeros = torch.zeros((1, 2 * S), dtype=torch.int32, device=dev)
    zero_launches(HK.LAUNCHES, PK.LAUNCHES)
    g1, _fl = PK.prepare_kernel_call(pk, ones, ones, zeros, 1)
    f = PK.miller_kernel_call(g1, g2)
    PK.product_kernel_call(f, ones)
    chain = {}
    for name, fn in (
            ("prepare", lambda: PK.prepare_kernel_call(pk, ones, ones,
                                                       zeros, 1)),
            ("miller(256)", lambda: PK.miller_kernel_call(g1, g2)),
            ("product(256)", lambda: PK.product_kernel_call(f, ones))):
        chain[name] = cuda_ms(torch, fn, 10)

    def whole():
        a, _ = PK.prepare_kernel_call(pk, ones, ones, zeros, 1)
        PK.product_kernel_call(PK.miller_kernel_call(a, g2), ones)

    chain["chain"] = cuda_ms(torch, whole, 10)
    chain_launches = {**HK.LAUNCHES, **PK.LAUNCHES}
    print("latency chain (ms per call, median of 10): " + json.dumps(
        {k: round(v, 3) for k, v in chain.items()}) + f" [{hw['card']}]")
    check(chain_launches["product"] > 0, "the latency chain never launched "
                                         "the product kernel")
    return {"stages": prof, "chain": chain,
            "launches": {"miller": stage_launches["miller"],
                         "product": chain_launches["product"]}}


# ---------------------------------------------------------------------------
# Phase 11: the host/device crossover of small batches
# ---------------------------------------------------------------------------

def phase_crossover(torch, hw: dict, sets, rand_fn) -> dict:
    """1, 2, 4, 8 and 16 sets of BASELINE row 1's shape (16 keys each,
    keys already in the pubkey table) through ``verify_signature_sets``,
    the median of 5 warm calls with ``LIGHTHOUSE_TPU_HOST_FASTPATH_MAX`` at
    16 (the native host pairing) and at 0 (the device pipeline).  The host
    calls must launch no kernel."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.ops import merkle_kernel as mk

    backend = bls.get_backend()
    table = {}
    try:
        for n in CROSSOVER_SETS:
            batch = sets[:n]
            row = {}
            for route, knob in (("host", "16"), ("device", "0")):
                os.environ["LIGHTHOUSE_TPU_HOST_FASTPATH_MAX"] = knob
                check(backend.verify_signature_sets(batch, rand_fn=rand_fn)
                      is True, f"{n} sets did not verify ({route})")
                zero_launches(HK.LAUNCHES, PK.LAUNCHES, mk.LAUNCHES)
                walls = [timed(torch, lambda: backend.verify_signature_sets(
                    batch, rand_fn=rand_fn))[1] for _ in range(VERIFY_RUNS)]
                launched = sum(HK.LAUNCHES.values()) + sum(
                    PK.LAUNCHES.values()) + sum(mk.LAUNCHES.values())
                if route == "host":
                    check(launched == 0, f"the host fast path launched "
                                         f"{launched} kernels at {n} sets")
                else:
                    check(launched > 0, f"the device path launched no "
                                        f"kernel at {n} sets")
                row[f"{route}_ms"] = statistics.median(walls)
                row[f"{route}_launches"] = launched
            bad = list(batch)
            bad[-1] = bls.SignatureSet(batch[-1].signature,
                                       batch[-1].signing_keys,
                                       batch[-1].message + b"!")
            os.environ["LIGHTHOUSE_TPU_HOST_FASTPATH_MAX"] = "16"
            check(backend.verify_signature_sets(bad, rand_fn=rand_fn)
                  is False, f"a tampered batch of {n} verified (host)")
            table[n] = row
    finally:
        os.environ.pop("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX", None)
    faster = [n for n, r in table.items() if r["host_ms"] < r["device_ms"]]
    print("host/device crossover, 16-key sets, median of "
          f"{VERIFY_RUNS} warm calls (ms): " + json.dumps(
              {n: {k: round(v, 3) for k, v in r.items()}
               for n, r in table.items()}) + f"; the host is faster at "
          f"{faster} sets; host calls launched no kernel [{hw['card']}]")
    return table


# ---------------------------------------------------------------------------
# Phase 12: the Merkle proof engine on the resident registry tree
# ---------------------------------------------------------------------------

def phase_proof_engine(torch, hw: dict, state) -> dict:
    """1024 random validator branches of the 2^20 registry mirror's
    record-root tree in one gather, against a hashlib walk (record roots
    of the sampled validators from their raw columns, every level above
    from the resident record-root plane) and ``verify_merkle_proof``; the
    gather's device→host bytes against 32 × distinct nodes; then
    ``ProofServer.field_branch`` for every field of the state against a
    hashlib fold of the field roots to the state root."""
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.ops.merkle_proof import verify_merkle_proof
    from lighthouse_tpu_torch.ops.proof_engine import (DeviceProofEngine,
                                                      ProofServer,
                                                      branch_gindices)
    from lighthouse_tpu_torch.types import MAINNET

    reg = state.validators
    state_root = state.tree_hash_root()       # lands any pending dirt
    tree = reg._dev_mirror.tree
    depth, n = len(tree.levels) - 1, len(reg)
    rng = np.random.default_rng(SEED + 7)
    idx = np.sort(rng.choice(n, PROOF_BATCH, replace=False))
    gs = [(1 << depth) + int(i) for i in idx]
    distinct = len(set().union(*(branch_gindices(g) for g in gs)))
    eng = DeviceProofEngine(tree)
    eng.branches(gs)
    times, moved = [], []
    for _ in range(VERIFY_RUNS):
        before = LEDGER.transfer_totals()["proof_engine"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        branches = eng.branches(gs)
        times.append((time.perf_counter() - t0) * 1e3)
        after = LEDGER.transfer_totals()["proof_engine"]
        moved.append((after[0] - before[0], after[1] - before[1]))
    check(all(d2h == 32 * distinct for _h2d, d2h in moved),
          f"proof gather D2H {moved} != 32 B × {distinct} distinct nodes")

    t0 = time.perf_counter()
    plane = tree.levels[0].cpu().numpy().view(np.uint32).astype(
        ">u4").view(np.uint8)
    plane = plane.reshape(-1, 32)
    check(np.array_equal(plane[idx], record_roots_hashlib(reg, idx)),
          "resident record roots != hashlib record roots")
    host = tree_levels_hashlib(plane)
    root = host[-1][0].tobytes()
    check(zero_cap_hashlib(root, depth, MAINNET.VALIDATOR_REGISTRY_LIMIT, n)
          == type(state).FIELDS["validators"].hash_tree_root(reg),
          "hashlib registry tree root != the registry's hash_tree_root")
    for g, i in zip(gs, idx):
        want = [host[lv][(int(i) >> lv) ^ 1].tobytes() for lv in range(depth)]
        check(branches[g] == want, f"branch of validator {i} != hashlib walk")
        check(verify_merkle_proof(plane[i].tobytes(), branches[g], depth,
                                  int(i), root),
              f"branch of validator {i} does not verify")
    walk_s = time.perf_counter() - t0

    server = ProofServer(window_ms=0)
    names = list(type(state).FIELDS)
    field_roots = [type(state).FIELDS[f].hash_tree_root(getattr(state, f))
                   for f in names]
    w = 1 << (len(names) - 1).bit_length()
    leaves = np.zeros((w, 32), np.uint8)
    leaves[:len(names)] = np.frombuffer(b"".join(field_roots),
                                        np.uint8).reshape(-1, 32)
    flevels = tree_levels_hashlib(leaves)
    check(flevels[-1][0].tobytes() == state_root,
          "hashlib fold of the field roots != the state root")
    t0 = time.perf_counter()
    for k, name in enumerate(names):
        branch, at = server.field_branch(state, name)
        check(at == k and branch == [flevels[lv][(k >> lv) ^ 1].tobytes()
                                     for lv in range(len(flevels) - 1)],
              f"field_branch({name}) != hashlib walk")
        check(verify_merkle_proof(field_roots[k], branch, len(flevels) - 1,
                                  k, state_root),
              f"field_branch({name}) does not verify")
    field_ms = (time.perf_counter() - t0) * 1e3
    print(f"proof engine: {PROOF_BATCH} validator branches of the 2^{depth} "
          f"registry tree in one gather, ms {[round(t, 3) for t in times]} "
          f"(median {statistics.median(times):.3f}); {distinct} distinct "
          f"nodes, D2H {moved[-1][1]} B = 32 × distinct, H2D {moved[-1][0]} "
          f"B of indices; every branch == hashlib walk and verifies "
          f"(hashlib check {walk_s:.1f} s); field_branch of all "
          f"{len(names)} fields == hashlib, {field_ms:.1f} ms; server "
          f"{server.stats()} [{hw['card']}]")
    return {"batch_ms": times, "distinct": distinct, "d2h": moved[-1][1],
            "h2d": moved[-1][0], "field_ms": field_ms}


# ---------------------------------------------------------------------------
# Phase 13: block import through the three stages on the card
# ---------------------------------------------------------------------------

IMPORT_SMALL_VALIDATORS = 64
IMPORT_SMALL_SLOTS = 4 * 8 + 1       # 4 MINIMAL epochs + 1 slot
IMPORT_SIDE_AT = 13                  # the side block extends this slot's
#                                      parent, at the next slot
IMPORT_LOG2_VALIDATORS = 20
IMPORT_EPOCH = 1000                  # the anchor's epoch: its end crosses
#                                      no sync-committee, historical or
#                                      eth1-voting boundary
IMPORT_GENESIS_TIME = 1_606_824_023
IMPORT_WARM_RUNS = 3
IMPORT_PATH_KERNELS = ("hash64", "subtree", "hash_g2", "prepare", "sigma",
                       "sigma_combine", "miller_fold", "product_chunks",
                       "finalize")
IMPORT_SPANS = ("gossip_verify", "epoch_transition", "state_transition",
                "post_state_root", "sig_join")
CHAIN_SPANS = ("block_import", "store_put", "fork_choice_on_block",
               "attester_cache_prime", "fork_choice_attestations",
               "head_update", "compute_deltas", "apply_scores", "persist",
               "migrate_to_cold")
DATADIR_ROOT = os.path.join("build", "chip_smoke_datadir")


def all_launches() -> dict:
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.kzg import device as KD
    from lighthouse_tpu_torch.ops import merkle_kernel as mk
    return {**mk.LAUNCHES, **HK.LAUNCHES, **PK.LAUNCHES, **KD.LAUNCHES}


def zero_all_launches() -> None:
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.kzg import device as KD
    from lighthouse_tpu_torch.ops import merkle_kernel as mk
    zero_launches(mk.LAUNCHES, HK.LAUNCHES, PK.LAUNCHES, KD.LAUNCHES)


def genesis_chain(state, preset, spec, T, kv_path=None):
    """A port ``BeaconChain`` at the genesis ``state``, over a
    ``SqliteStore`` at ``kv_path`` or an in-memory store."""
    from lighthouse_tpu_torch.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.store import HotColdDB, SqliteStore
    hdr = state.latest_block_header.copy()
    hdr.state_root = state.tree_hash_root()
    db = (HotColdDB.memory(preset, spec, T) if kv_path is None
          else HotColdDB(SqliteStore(kv_path), preset, spec, T))
    return BeaconChain(store=db, genesis_state=state,
                       genesis_block_root=hdr.tree_hash_root(),
                       preset=preset, spec=spec, T=T)


def checkpoint_chain(anchor_state, anchor_block, preset, spec, T,
                     pubkey_cache=None):
    """A port ``BeaconChain`` booted from ``anchor_block`` and its
    post-state (``from_checkpoint``) over an in-memory store; a running
    node's warm ``pubkey_cache`` may be handed in."""
    from lighthouse_tpu_torch.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.store import HotColdDB
    chain = BeaconChain.from_checkpoint(
        store=HotColdDB.memory(preset, spec, T), anchor_state=anchor_state,
        anchor_block=anchor_block, preset=preset, spec=spec, T=T)
    if pubkey_cache is not None:
        chain.pubkey_cache = pubkey_cache
    return chain


def chain_head(chain) -> tuple:
    fc = chain.fork_choice
    return (chain.head.root, chain.head.slot, fc.justified_checkpoint,
            fc.finalized_checkpoint)


def run_steps(chain, steps, on_step=None) -> list:
    """Drive ``chain`` through ``steps`` — ``("tick", slot)``,
    ``("block", signed_block)``, ``("atts", [attestation, ...])`` — and
    return the head after each; ``on_step(i, root_or_None)`` runs after
    each step.  Every returned block root must be stored and reload."""
    heads = []
    for i, step in enumerate(steps):
        root = None
        if step[0] == "tick":
            chain.per_slot_task(step[1])
        elif step[0] == "block":
            sb = step[1]
            root = chain.process_block(sb, is_timely=True)
            got = chain.store.get_block(root)
            check(got is not None and type(got).serialize(got)
                  == type(sb).serialize(sb),
                  f"13(a): block {root.hex()[:12]} did not reload")
        else:
            res = chain.process_attestation_batch(step[1])
            check(all(v is not None for v, _ in res),
                  f"13(a): an attestation was refused: "
                  f"{[repr(e) for _, e in res if e is not None][:3]}")
        heads.append(chain_head(chain))
        if on_step is not None:
            on_step(i, root)
    return heads


def import_expecting(chain, sb, error_cls) -> None:
    try:
        chain.per_slot_task(int(sb.message.slot))
        chain.process_block(sb)
    except error_cls:
        return
    except Exception as e:  # noqa: BLE001 — reported as the failure
        fail(f"import raised {type(e).__name__}: {e}, not "
             f"{error_cls.__name__}")
    fail(f"a tampered block imported (expected {error_cls.__name__})")


def resign_block(block, parent_state, sk: int, preset) -> bytes:
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_transition.helpers import (
        compute_epoch_at_slot, compute_signing_root, get_domain)
    from lighthouse_tpu_torch.types import Domain
    epoch = compute_epoch_at_slot(int(block.slot), preset.SLOTS_PER_EPOCH)
    domain = get_domain(parent_state, Domain.BEACON_PROPOSER, epoch, preset)
    return bls.SecretKey(sk).sign(
        compute_signing_root(block, domain)).serialize()


def tamper_imports(chain_fn, sb, parent_state, sk_of, preset, fork) -> list:
    """The three tamper classes on ``sb``, each on a fresh chain from
    ``chain_fn()``: a wrong attestation signature (block re-signed), a
    wrong state root (re-signed), a wrong proposal signature."""
    from lighthouse_tpu_torch.beacon_chain import errors as BE
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.types.carry import signed_block_from_ssz
    data = type(sb).serialize(sb)
    wrong = bls.SecretKey(12345).sign(b"\x5a" * 32).serialize()
    out = []
    for kind, err in (("attestation signature", BE.InvalidSignatures),
                      ("state root", BE.StateRootMismatch),
                      ("proposal signature", BE.ProposalSignatureInvalid)):
        t = signed_block_from_ssz(data, preset.name, fork)
        sk = sk_of(int(t.message.proposer_index))
        if kind == "attestation signature":
            t.message.body.attestations[0].signature = wrong
            t.signature = resign_block(t.message, parent_state, sk, preset)
        elif kind == "state root":
            t.message.state_root = b"\x33" * 32
            t.signature = resign_block(t.message, parent_state, sk, preset)
        else:
            t.signature = wrong
        import_expecting(chain_fn(), t, err)
        out.append(f"{kind} -> {err.__name__}")
    return out


def span_split(TRACER, slot: int, names) -> dict:
    """``{name}_ms`` summed over the tracer's spans of ``slot``."""
    out = {}
    for s in TRACER.slot_spans(slot):
        if s["name"] in names:
            out[s["name"] + "_ms"] = out.get(s["name"] + "_ms", 0.0) \
                + s["dur_us"] / 1e3
    return out


def timed_import(torch, chain, sb) -> tuple:
    """One ``process_block`` on ``chain``, fenced by device syncs: its
    wall, the stage spans and the chain's own spans of the tracer, the
    signature dispatch's stats, the block's phase split and the ledger's
    bytes."""
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.common.tracing import TRACER
    from lighthouse_tpu_torch.state_transition import per_block as PB
    from lighthouse_tpu_torch.state_transition import sig_dispatch as SD
    slot = int(sb.message.slot)
    TRACER.reset()
    TRACER.set_slot(slot)
    ledger0 = LEDGER.transfer_totals()
    root, wall = timed(torch, lambda: chain.process_block(sb,
                                                          is_timely=True))
    sig = {k: SD.LAST_SIG_DISPATCH.get(k) for k in
           ("sets", "deduped", "path", "device_verify_ms", "join_wait_ms",
            "overlap_efficiency")}
    return root, {"wall_ms": wall, **span_split(TRACER, slot, IMPORT_SPANS),
                  "chain": span_split(TRACER, slot, CHAIN_SPANS), "sig": sig,
                  "block_phases": dict(PB.LAST_BLOCK_TIMINGS),
                  "ledger": ledger_moved(LEDGER, ledger0)}


def build_minimal_steps(h):
    """The harness's chain as chain steps: each block at its slot, then
    the next slot's tick and that block's slot's unaggregated
    attestations (every committee member, real signatures); after the
    block at ``IMPORT_SIDE_AT`` a competing block from the next slot's
    proposer on the same parent (the canonical chain skips that slot).
    Returns (steps, blocks) — ``blocks`` the canonical ones."""
    from lighthouse_tpu_torch.state_transition import SignatureStrategy
    from lighthouse_tpu_torch.state_transition.per_slot import process_slots
    steps, blocks, i = [], [], 0
    while int(h.state.slot) < IMPORT_SMALL_SLOTS:
        kw = {}
        if i == 3:
            h.make_deposit(IMPORT_SMALL_VALIDATORS)
        elif i == 6:
            kw["voluntary_exits"] = [h.make_exit(h.state, 5)]
        elif i == 9:
            kw["proposer_slashings"] = [h.make_proposer_slashing(h.state, 3)]
        elif i == 12:
            kw["attester_slashings"] = [
                h.make_attester_slashing(h.state, [10, 11])]
        slot = int(h.state.slot) + 1
        if slot == IMPORT_SIDE_AT + 1:
            slot += 1
        parent = h.state.copy()
        sb = h.build_block(slot, **kw)
        h.apply_block(sb, strategy=SignatureStrategy.NO_VERIFICATION)
        blocks.append(sb)
        adv = process_slots(h.state.copy(), slot + 1, h.preset, h.spec, h.T)
        steps += [("tick", slot), ("block", sb), ("tick", slot + 1),
                  ("atts", h.single_attestations_for_slot(adv, slot))]
        if slot == IMPORT_SIDE_AT:
            live, h.state = h.state, parent
            side = h.build_block(slot + 1,
                                 graffiti=b"side".ljust(32, b"\x00"))
            h.state = live
            steps.append(("block", side))
        i += 1
    return steps, blocks


def cpu_reference_heads(genesis, steps, preset, spec, T) -> list:
    """The same steps through a second port chain on the CPU (the port's
    device set to cpu, the numpy fork-choice engine, the fake BLS
    backend: the blocks and attestations were verified on the card), from
    genesis carried by its SSZ bytes: the head after each step."""
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.types import ForkName
    prev = (device.default_device(), bls._active)
    device.set_default_device("cpu")
    bls.set_backend("fake")
    try:
        state = T.state_cls(ForkName.CAPELLA).deserialize(
            type(genesis).serialize(genesis))
        chain = genesis_chain(state, preset, spec, T)
        check(chain.fork_choice.proto.engine == "numpy",
              "13(a): the CPU chain's fork choice is not the numpy engine")
        return run_steps(chain, steps)
    finally:
        device.set_default_device(prev[0])
        bls._active = prev[1]


def phase_import_minimal(torch, hw: dict) -> dict:
    """13(a): a MINIMAL Capella chain of 4 epochs + 1 slot at 64
    validators with real signatures, built by the port's harness on the
    host oracle (``LIGHTHOUSE_TPU_DEVICE_STATE=0``, ``NO_VERIFICATION``)
    with each slot's unaggregated attestations and one competing block,
    driven through ``BeaconChain`` (``per_slot_task``, ``process_block``,
    ``process_attestation_batch``) on a device-resident genesis over
    ``SqliteStore`` in a datadir under ``build/``, with every batch on
    the card (fast path off) and fork choice on the ``torch`` engine, once
    with the epoch sweep on numpy and once on the card.  After every step
    the head and the justified and finalized checkpoints equal a second
    port chain's on the CPU; the chain finalizes; ``resume`` on the
    datadir restores the head; three tamper classes raise the
    reference's errors."""
    from lighthouse_tpu_torch.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.state_transition import interop_secret_key
    from lighthouse_tpu_torch.store import HotColdDB, SqliteStore
    from lighthouse_tpu_torch.testing import StateHarness
    from lighthouse_tpu_torch.types.device_state import (is_materialized,
                                                         materialize_state)

    t0 = time.perf_counter()
    os.environ["LIGHTHOUSE_TPU_DEVICE_STATE"] = "0"
    try:
        h = StateHarness(IMPORT_SMALL_VALIDATORS)
        h.spec.shard_committee_period = 0     # exits from genesis on
        genesis = h.state.copy()
        steps, blocks = build_minimal_steps(h)
    finally:
        os.environ.pop("LIGHTHOUSE_TPU_DEVICE_STATE", None)
    final = h.state
    check(len(final.validators) == IMPORT_SMALL_VALIDATORS + 1
          and int(final.finalized_checkpoint.epoch) >= 1,
          "13(a): the harness chain lacks its deposit or finality")
    n_atts = sum(len(s[1]) for s in steps if s[0] == "atts")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cpu_reference_heads(genesis, steps, h.preset, h.spec, h.T)
    cpu_s = time.perf_counter() - t0
    check(want[-1][3][0] >= 1, "13(a): the CPU chain did not finalize")
    fork = h.fork_at(IMPORT_SMALL_SLOTS)
    os.environ["LIGHTHOUSE_TPU_HOST_FASTPATH_MAX"] = "0"
    shutil.rmtree(DATADIR_ROOT, ignore_errors=True)
    os.makedirs(DATADIR_ROOT)
    out = {}
    try:
        # untimed: the first steps once, so neither timed run is the
        # cold one (device key table, allocator)
        anchor = genesis.copy()
        materialize_state(anchor)
        run_steps(genesis_chain(anchor, h.preset, h.spec, h.T), steps[:12])
        for sweep in ("0", "1"):
            os.environ["LIGHTHOUSE_TPU_EPOCH_DEVICE"] = sweep
            anchor = genesis.copy()
            check(materialize_state(anchor), "13(a): materialize refused")
            path = os.path.join(DATADIR_ROOT, f"sweep{sweep}.sqlite")
            chain = genesis_chain(anchor, h.preset, h.spec, h.T, path)
            check(chain.fork_choice.proto.engine == "torch",
                  "13(a): fork choice is not on the torch engine")

            def on_step(i, root, chain=chain, sweep=sweep):
                check(chain_head(chain) == want[i],
                      f"13(a): head after step {i} ({steps[i][0]}) != the "
                      f"CPU chain's (sweep {sweep}): "
                      f"{chain_head(chain)} vs {want[i]}")
                if root is not None:
                    check(is_materialized(chain._states_by_block[root]),
                          "13(a): a post-state left the device")

            zero_all_launches()
            t1 = time.perf_counter()
            run_steps(chain, steps, on_step)
            ms = (time.perf_counter() - t1) * 1e3
            launched = all_launches()
            post = chain.head.state
            check(chain.head.root == blocks[-1].message.tree_hash_root()
                  and type(post).serialize(post)
                  == type(final).serialize(final),
                  f"13(a): the head state != the host oracle's "
                  f"(sweep {sweep})")
            check(all(launched[k] > 0 for k in IMPORT_PATH_KERNELS
                      if k != "subtree"),
                  f"13(a): a kernel of the path never launched: {launched}")
            check(chain.store.split_slot > 0,
                  "13(a): finalization migrated nothing to the freezer")
            live = chain_head(chain)
            fc_rounds = chain.fork_choice.proto.host_rounds
            chain.store.kv.close()
            db = HotColdDB(SqliteStore(path), h.preset, h.spec, h.T)
            resumed = BeaconChain.resume(store=db, preset=h.preset,
                                         spec=h.spec, T=h.T)
            check(chain_head(resumed) == live,
                  f"13(a): resume restored {chain_head(resumed)}, not the "
                  f"live head {live}")
            check(resumed.head.state.tree_hash_root()
                  == final.tree_hash_root(),
                  "13(a): the resumed head state's root != the oracle's")
            db.kv.close()
            out[sweep] = {"ms": ms, "launches": launched,
                          "host_rounds": fc_rounds,
                          "replayed": len(resumed.last_recovery.replayed)}
        os.environ.pop("LIGHTHOUSE_TPU_EPOCH_DEVICE", None)
        k = 10
        parent_chain = genesis_chain(genesis.copy(), h.preset, h.spec, h.T)
        materialize_state(parent_chain.head.state)
        for sb in blocks[:k]:
            parent_chain.per_slot_task(int(sb.message.slot))
            root = parent_chain.process_block(sb)
        parent = parent_chain.state_at_block_root(root)

        def fresh():
            return checkpoint_chain(parent.copy(), blocks[k - 1], h.preset,
                                    h.spec, h.T, parent_chain.pubkey_cache)

        tampers = tamper_imports(
            fresh, blocks[k], parent,
            lambda v: interop_secret_key(v).scalar, h.preset, fork)
    finally:
        os.environ.pop("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX", None)
        os.environ.pop("LIGHTHOUSE_TPU_EPOCH_DEVICE", None)
        shutil.rmtree(DATADIR_ROOT, ignore_errors=True)
    heads = {w[0] for w in want}
    print(f"13(a) MINIMAL chain through BeaconChain: {len(blocks)} blocks "
          f"to slot {int(final.slot)} and a competing block at slot "
          f"{IMPORT_SIDE_AT + 1} (a deposit, an exit, a proposer and an "
          f"attester slashing; {n_atts} unaggregated attestations in "
          f"{sum(s[0] == 'atts' for s in steps)} batches; finalized epoch "
          f"{want[-1][3][0]}, {len(heads)} distinct heads), built on the "
          f"host oracle in {build_s:.1f} s, the CPU chain's heads in "
          f"{cpu_s:.1f} s; on the card over SQLite with every batch on the "
          f"card and fork choice on the torch engine ({len(steps)} steps, "
          f"after an untimed pass over 12): {out['0']['ms']:.0f} ms (numpy "
          f"sweep), {out['1']['ms']:.0f} ms (sweep on the card); every head "
          f"and checkpoint equal to the CPU chain's, the head state "
          f"byte-equal to the oracle's, resume restored the head "
          f"(replayed {out['1']['replayed']} journaled imports); host-route "
          f"fork-choice rounds {out['1']['host_rounds']}; launches "
          f"{out['1']['launches']}; tampers: {'; '.join(tampers)} "
          f"[{hw['card']}]")
    return out


def build_import_parent(T, spec, preset, C, bls, keys, rng):
    """A checkpoint anchor: a MAINNET Capella block at the first slot of
    ``IMPORT_EPOCH`` and its post-state of ``len(keys)`` active
    validators (validator v's key is [0x10000 + 7v]G, ~90% of both
    epochs' participation flags set, a sync committee of 512 distinct
    validators, execution-address credentials with a small excess balance
    for partial withdrawals).  The anchor sits at an epoch boundary, as a
    checkpoint sync's does, so the epoch's justification names it and
    fork choice knows the justified root.  Returns (state, the sync
    committee's indices, the anchor block with its state root left for
    the caller to fill in)."""
    from lighthouse_tpu_torch.types import ForkName
    from lighthouse_tpu_torch.types.validators import ValidatorRegistry
    n = len(keys)
    slots = preset.SLOTS_PER_EPOCH
    e = IMPORT_EPOCH
    pubs = np.frombuffer(b"".join(C.g1_compress(k) for k in keys),
                         dtype=np.uint8).reshape(n, 48)
    creds = np.zeros((n, 32), dtype=np.uint8)
    creds[:, 0] = 1
    creds[:, 12:] = rng.integers(0, 256, (n, 20), dtype=np.uint8)
    reg = ValidatorRegistry(n)
    zero = np.zeros(n, dtype=np.uint64)
    reg.init_columns(
        pubkey=pubs, withdrawal_credentials=creds,
        effective_balance=np.full(n, preset.MAX_EFFECTIVE_BALANCE,
                                  dtype=np.uint64),
        slashed=np.zeros(n, dtype=bool), activation_eligibility_epoch=zero,
        activation_epoch=zero, exit_epoch=np.full(n, FAR, dtype=np.uint64),
        withdrawable_epoch=np.full(n, FAR, dtype=np.uint64))
    state = T.state_cls(ForkName.CAPELLA)()
    state.genesis_time = IMPORT_GENESIS_TIME
    state.genesis_validators_root = rng.bytes(32)
    state.slot = e * slots
    version = spec.fork_version(ForkName.CAPELLA)
    state.fork = T.Fork(previous_version=version, current_version=version,
                        epoch=0)
    state.validators = reg
    state.balances = (preset.MAX_EFFECTIVE_BALANCE + rng.integers(
        0, 20_000_000, n)).astype(np.uint64)
    for vec in (state.block_roots, state.state_roots, state.randao_mixes):
        vec[:] = rng.integers(0, 256, vec.shape, dtype=np.uint8)
    state.eth1_data = T.Eth1Data(deposit_root=rng.bytes(32),
                                 deposit_count=n, block_hash=rng.bytes(32))
    state.eth1_deposit_index = n
    anchor_body = T.body_cls(ForkName.CAPELLA)()
    state.latest_block_header = T.BeaconBlockHeader(
        slot=int(state.slot), proposer_index=int(rng.integers(n)),
        parent_root=rng.bytes(32), state_root=b"\x00" * 32,
        body_root=anchor_body.tree_hash_root())
    for name in ("previous_epoch_participation",
                 "current_epoch_participation"):
        flags = np.where(rng.random(n) < 0.9, 7,
                         rng.integers(0, 8, n)).astype(np.uint8)
        setattr(state, name, flags)
    state.inactivity_scores = np.zeros(n, dtype=np.uint64)
    state.justification_bits[:] = [True, True, True, False]

    def cp(epoch):
        return T.Checkpoint(epoch=epoch, root=bytes(
            state.block_roots[epoch * slots
                              % preset.SLOTS_PER_HISTORICAL_ROOT]))

    state.current_justified_checkpoint = cp(e - 1)
    state.previous_justified_checkpoint = cp(e - 2)
    state.finalized_checkpoint = cp(e - 3)
    sync = rng.choice(n, preset.SYNC_COMMITTEE_SIZE, replace=False)
    committee = T.SyncCommittee(
        pubkeys=[pubs[v].tobytes() for v in sync],
        aggregate_pubkey=C.g1_compress(bls.aggregate_points(
            [keys[v] for v in sync])))
    state.current_sync_committee = committee
    state.next_sync_committee = committee
    header_cls = type(state).FIELDS["latest_execution_payload_header"]
    state.latest_execution_payload_header = header_cls(
        parent_hash=rng.bytes(32), block_hash=rng.bytes(32),
        block_number=17_000_000, gas_limit=30_000_000,
        timestamp=IMPORT_GENESIS_TIME + int(state.slot) * 12,
        prev_randao=rng.bytes(32))
    state.next_withdrawal_validator_index = int(rng.integers(n))
    hdr = state.latest_block_header
    anchor = T.signed_block_cls(ForkName.CAPELLA)(
        message=T.block_cls(ForkName.CAPELLA)(
            slot=hdr.slot, proposer_index=hdr.proposer_index,
            parent_root=hdr.parent_root, state_root=b"\x00" * 32,
            body=anchor_body),
        signature=bls.INFINITY_SIGNATURE)
    return state, sync, anchor


def build_import_block(T, spec, preset, bls, adv, sync, rng, fork=None,
                       commitments=()):
    """The block at ``adv.slot`` (``adv``: the parent advanced to it):
    one aggregate per committee of the two slots before it (~90% of each
    committee), a sync aggregate of ~460 of 512, the randao reveal, the
    execution payload with the expected withdrawals; a ``fork`` of Deneb
    or later (Capella by default) also carries the blob ``commitments``.
    The state root and the proposal signature are filled in by the
    caller.  Returns the block, its proposer, the sync participants,
    every signer and each aggregate's committee."""
    import hashlib as _hl

    from lighthouse_tpu_torch.crypto.fields import R
    from lighthouse_tpu_torch.ssz import uint64 as u64
    from lighthouse_tpu_torch.state_transition import committees as CM
    from lighthouse_tpu_torch.state_transition.helpers import (
        compute_signing_root, current_epoch, get_block_root_at_slot,
        get_domain, get_randao_mix)
    from lighthouse_tpu_torch.state_transition.per_block import \
        get_expected_withdrawals
    from lighthouse_tpu_torch.types import Domain, ForkName

    fork = ForkName.CAPELLA if fork is None else fork
    blob_kw = ({"blob_kzg_commitments": list(commitments)}
               if fork >= ForkName.DENEB else {})

    def sk(v):
        return GEN_SK0 + GEN_SK_STEP * int(v)

    def signed(members, root):
        return bls.SecretKey(sum(sk(v) for v in members) % R).sign(
            root).serialize()

    slot, slots = int(adv.slot), preset.SLOTS_PER_EPOCH
    epoch = slot // slots
    atts, signers, committees = [], set(), []
    for s in (slot - 2, slot - 1):
        e = s // slots
        source = (adv.current_justified_checkpoint
                  if e == current_epoch(adv, preset)
                  else adv.previous_justified_checkpoint)
        target = T.Checkpoint(epoch=e, root=get_block_root_at_slot(
            adv, e * slots, preset))
        domain = get_domain(adv, Domain.BEACON_ATTESTER, e, preset)
        for index in range(CM.get_committee_count_per_slot(adv, e, preset)):
            committee = CM.get_beacon_committee(adv, s, index, preset)
            data = T.AttestationData(
                slot=s, index=index,
                beacon_block_root=get_block_root_at_slot(adv, s, preset),
                source=T.Checkpoint(epoch=source.epoch, root=source.root),
                target=target)
            bits = rng.random(len(committee)) < PARTICIPATION
            signers.update(int(v) for v in committee[bits])
            committees.append(committee)
            atts.append(T.Attestation(
                aggregation_bits=bits, data=data,
                signature=signed(committee[bits],
                                 compute_signing_root(data, domain))))
    prev = slot - 1
    sync_bits = rng.random(len(sync)) < SYNC_PARTICIPATION
    sync_root = compute_signing_root(
        get_block_root_at_slot(adv, prev, preset),
        get_domain(adv, Domain.SYNC_COMMITTEE, prev // slots, preset))
    proposer = CM.get_beacon_proposer_index(adv, preset)
    reveal = bls.SecretKey(sk(proposer)).sign(compute_signing_root(
        u64.hash_tree_root(epoch),
        get_domain(adv, Domain.RANDAO, epoch, preset))).serialize()
    hdr = adv.latest_execution_payload_header
    payload = T.payload_cls(fork)(
        parent_hash=hdr.block_hash,
        prev_randao=get_randao_mix(adv, epoch, preset),
        block_number=hdr.block_number + 1, gas_limit=30_000_000,
        timestamp=adv.genesis_time + slot * spec.seconds_per_slot,
        block_hash=_hl.sha256(bytes(hdr.block_hash)
                              + slot.to_bytes(8, "little")).digest(),
        withdrawals=[T.Withdrawal(index=w[0], validator_index=w[1],
                                  address=w[2], amount=w[3])
                     for w in get_expected_withdrawals(adv, preset)])
    body = T.body_cls(fork)(
        randao_reveal=reveal, eth1_data=adv.eth1_data,
        graffiti=b"\x00" * 32, proposer_slashings=[], attester_slashings=[],
        attestations=atts, deposits=[], voluntary_exits=[],
        sync_aggregate=T.SyncAggregate(
            sync_committee_bits=sync_bits,
            sync_committee_signature=signed(sync[sync_bits], sync_root)),
        execution_payload=payload, bls_to_execution_changes=[], **blob_kw)
    block = T.block_cls(fork)(
        slot=slot, proposer_index=proposer,
        parent_root=adv.latest_block_header.tree_hash_root(),
        state_root=b"\x00" * 32, body=body)
    return block, proposer, int(sync_bits.sum()), signers, committees


def python_profile(torch, label: str, fn, top: int = 12) -> None:
    """One run of ``fn`` under cProfile (the calling thread only): the
    port's functions with the most cumulative time."""
    import cProfile
    import pstats
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    rows = sorted(((v[3], v[1], f"{os.path.basename(k[0])}:{k[1]}({k[2]})")
                   for k, v in pstats.Stats(pr).stats.items()
                   if "lighthouse_tpu_torch" in k[0]), reverse=True)[:top]
    print(f"cProfile {label} (cumulative, the importing thread): " + "; ".join(
        f"{name} x{calls} {t * 1e3:.1f} ms" for t, calls, name in rows))


def phase_import_mainnet(torch, hw: dict, keys, kernel_ms: dict) -> dict:
    """13(b): one MAINNET Capella block at ``len(keys)`` validators,
    imported by ``BeaconChain.process_block`` with the defaults
    (device-resident state, device BLS, overlapped dispatch, fork choice
    on the torch engine) on a chain booted by ``from_checkpoint`` from an
    anchor at the first slot of an epoch; each import runs on a chain
    built anew from the checkpoint, outside the timed window.  The block
    is the next epoch's first slot, so the gossip stage's
    ``process_slots`` crosses the epoch's empty slots and runs the epoch
    transition; its state root comes from the port's host oracle
    (``LIGHTHOUSE_TPU_DEVICE_STATE=0``, ``NO_VERIFICATION``).  Its 128
    aggregates feed fork choice at 2^20 votes and the head must become
    the block."""
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.common.tracing import TRACER
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto import curve as C
    from lighthouse_tpu_torch.state_transition import SignatureStrategy
    from lighthouse_tpu_torch.state_transition import per_epoch as PE
    from lighthouse_tpu_torch.state_transition.helpers import (
        compute_signing_root, get_domain)
    from lighthouse_tpu_torch.state_transition.per_block import process_block
    from lighthouse_tpu_torch.state_transition.per_slot import process_slots
    from lighthouse_tpu_torch.state_transition.signature_sets import \
        PubkeyCache
    from lighthouse_tpu_torch.types import (MAINNET, ChainSpec, Domain,
                                            ForkName)
    from lighthouse_tpu_torch.types.device_state import (is_materialized,
                                                         materialize_state)
    from lighthouse_tpu_torch.types.factory import spec_types

    preset, T = MAINNET, spec_types(MAINNET)
    spec = ChainSpec.mainnet().with_forks_at_genesis(ForkName.CAPELLA)
    n = len(keys)
    rng = np.random.default_rng(SEED + 13)
    t0 = time.perf_counter()
    parent, sync, anchor = build_import_parent(T, spec, preset, C, bls, keys,
                                               rng)
    slot = int(parent.slot) + preset.SLOTS_PER_EPOCH
    t_state = time.perf_counter() - t0

    t0 = time.perf_counter()
    os.environ["LIGHTHOUSE_TPU_DEVICE_STATE"] = "0"
    try:
        adv = process_slots(parent.copy(), slot, preset, spec, T)
        anchor.message.state_root = bytes(adv.latest_block_header.state_root)
        block, proposer, n_sync, signers, committees = build_import_block(
            T, spec, preset, bls, adv, sync, rng)
        scratch = adv.copy()
        process_block(scratch, T.signed_block_cls(ForkName.CAPELLA)(
            message=block, signature=bls.INFINITY_SIGNATURE),
            ForkName.CAPELLA, preset, spec, T,
            strategy=SignatureStrategy.NO_VERIFICATION)
        block.state_root = scratch.tree_hash_root()
        domain = get_domain(adv, Domain.BEACON_PROPOSER,
                            slot // preset.SLOTS_PER_EPOCH, preset)
        want_jcp = (int(scratch.current_justified_checkpoint.epoch),
                    bytes(scratch.current_justified_checkpoint.root))
    finally:
        os.environ.pop("LIGHTHOUSE_TPU_DEVICE_STATE", None)
    sb = T.signed_block_cls(ForkName.CAPELLA)(
        message=block, signature=bls.SecretKey(
            GEN_SK0 + GEN_SK_STEP * proposer).sign(
            compute_signing_root(block, domain)).serialize())
    anchor_root = anchor.message.tree_hash_root()
    block_root = block.tree_hash_root()
    check(bytes(block.parent_root) == anchor_root,
          "13(b): the block's parent root != the anchor block's root")
    check(want_jcp == (IMPORT_EPOCH, anchor_root),
          f"13(b): the block's justified checkpoint {want_jcp} is not the "
          f"anchor's epoch and root")
    del scratch
    t_block = time.perf_counter() - t0
    # a running node's pubkey cache is warm: fill it from the derived keys
    cache = PubkeyCache()
    col = parent.validators.col("pubkey")
    for v in signers | {proposer} | {int(s) for s in sync}:
        cache._by_index[v] = bls.PublicKey(keys[v])
    for s in sync:
        cache._index_by_pubkey[col[s].tobytes()] = int(s)
    # so is the registry's pubkey → index map, which copies share
    check(parent.validators.pubkey_index(col[proposer].tobytes())
          == proposer, "13(b): the registry's pubkey index is wrong")
    n_atts = len(block.body.attestations)
    print(f"13(b) set-up (host): the {n}-validator anchor state at slot "
          f"{int(parent.slot)} in {t_state:.1f} s; the block at slot {slot} "
          f"({n_atts} aggregates of {len(signers)} signers, sync "
          f"{n_sync}/{len(sync)}, "
          f"{len(block.body.execution_payload.withdrawals)} withdrawals) "
          f"and its state root on the host oracle in {t_block:.1f} s")

    build_s = []

    def chain():
        """A chain booted from the checkpoint, ticked to the block's slot
        (fork choice only: no pre-advance, so the import runs the epoch
        transition as a node without the state-advance timer does)."""
        t = time.perf_counter()
        c = checkpoint_chain(parent, anchor, preset, spec, T, cache)
        c.fork_choice.on_tick(slot)
        check(c.fork_choice.proto.engine == "torch",
              "13(b): fork choice is not on the torch engine")
        build_s.append(time.perf_counter() - t)
        return c

    def imported(c, root) -> None:
        check(root == block_root and c.head.root == block_root
              and c.head.slot == slot,
              f"13(b): the head is {c.head.root.hex()[:12]} at "
              f"{c.head.slot}, not the block")
        post = c.state_at_block_root(root)
        check(is_materialized(post), "13(b): the post-state left the device")
        check(post.tree_hash_root() == bytes(block.state_root),
              "13(b): post-state root != the host oracle's")

    TRACER.enable()
    try:
        # the path's counted run: the parent's device root (materialize),
        # its uncached root, then the first import (cold device key table,
        # cold fork-choice mirrors)
        zero_all_launches()
        ledger0 = LEDGER.transfer_totals()
        _, mat_ms = timed(torch, lambda: check(materialize_state(parent),
                                               "materialize refused"))
        r_unc, unc_ms = timed(torch, lambda: type(parent).hash_tree_root(
            parent))
        check(parent.tree_hash_root() == r_unc == bytes(
            anchor.message.state_root),
            "13(b): the anchor's device root != its uncached root or the "
            "host oracle's")
        c = chain()
        root, cold = timed_import(torch, c, sb)
        imported(c, root)
        launched = all_launches()
        moved = ledger_moved(LEDGER, ledger0)
        missing = [k for k in IMPORT_PATH_KERNELS if launched[k] == 0]
        check(not missing, f"13(b): kernels of the path never launched: "
                           f"{missing} ({launched})")
        fc_votes = int((c.fork_choice.proto.votes.current >= 0).sum())
        del c
        print(f"13(b) counted run: materialize {mat_ms:.1f} ms, uncached "
              f"root {unc_ms:.1f} ms, cold import {cold['wall_ms']:.1f} ms "
              f"(chain spans {json.dumps(cold['chain'])}); {fc_votes} "
              f"fork-choice votes after it; launches {launched}; ledger "
              f"h2d {moved['h2d']} B, d2h {moved['d2h']} B [{hw['card']}]")

        # the slots to the block at this width: sweep on the card vs numpy
        epoch, posts = {}, {}
        for sweep in ("1", "0"):
            os.environ["LIGHTHOUSE_TPU_EPOCH_DEVICE"] = sweep
            st = parent.copy()
            posts[sweep], ms = timed(torch, lambda: process_slots(
                st, slot, preset, spec, T))
            epoch[sweep] = {
                "process_slots_ms": ms,
                "device": bool(PE.LAST_EPOCH_TIMINGS.get("device")),
                **{k: v for k, v in PE.LAST_EPOCH_TIMINGS.items()
                   if isinstance(v, float)}}
        os.environ.pop("LIGHTHOUSE_TPU_EPOCH_DEVICE", None)
        check(epoch["1"]["device"] and not epoch["0"]["device"],
              "13(b): the sweep did not run where the knob put it")
        a, b = posts["1"], posts["0"]
        check(a.tree_hash_root() == b.tree_hash_root()
              and type(a).serialize(a) == type(b).serialize(b),
              "13(b): the epoch post-state with the sweep on the card != "
              "the numpy sweep's (raw)")
        del posts, a, b, st

        runs = []
        for _ in range(IMPORT_WARM_RUNS):
            c = chain()
            zero_all_launches()
            root, r = timed_import(torch, c, sb)
            r["launches"] = all_launches()
            imported(c, root)
            runs.append(r)
            del c
        c = chain()
        prof = profile_call(torch, hw, "13(b) warm block import",
                            lambda: c.process_block(sb, is_timely=True),
                            kernel_ms)
        c = chain()
        python_profile(torch, "13(b) warm block import",
                       lambda: c.process_block(sb, is_timely=True))
        del c
    finally:
        TRACER.disable()
        os.environ.pop("LIGHTHOUSE_TPU_EPOCH_DEVICE", None)

    def med(get):
        vals = [get(r) for r in runs]
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    stages = {k: med(lambda r, k=k: r.get(k)) for k in
              ["wall_ms"] + [f"{s}_ms" for s in IMPORT_SPANS]}
    chain_spans = {k: med(lambda r, k=k: r["chain"].get(k)) for k in
                   [f"{s}_ms" for s in CHAIN_SPANS]}
    sig = {k: med(lambda r, k=k: r["sig"].get(k)) for k in
           ("device_verify_ms", "join_wait_ms", "overlap_efficiency")}
    phases = {k: med(lambda r, k=k: r["block_phases"].get(k))
              for k in runs[0]["block_phases"]}
    launches = runs[-1]["launches"]
    check(all(r["launches"] == launches for r in runs),
          f"13(b): launches differ between warm imports: "
          f"{[r['launches'] for r in runs]}")
    summary = {
        "validators": n, "slot": slot, "aggregates": n_atts,
        "fork_choice_votes": fc_votes,
        "batch_sets": runs[-1]["sig"]["sets"],
        "warm_runs": IMPORT_WARM_RUNS, "stages_ms": stages,
        "cold_import_ms": cold["wall_ms"],
        "chain_spans_ms": chain_spans,
        "chain_build_s": {"median": statistics.median(build_s),
                          "max": max(build_s)},
        "sig_dispatch": sig, "block_phases_ms": phases,
        "epoch_sweep_card": epoch["1"], "epoch_sweep_numpy": epoch["0"],
        "launches_per_import": launches,
        "ledger_per_import": {"h2d": med(lambda r: r["ledger"]["h2d"]),
                              "d2h": med(lambda r: r["ledger"]["d2h"]),
                              "fork_choice_h2d": med(
                                  lambda r: r["ledger"]["h2d_by"].get(
                                      "fork_choice", 0))},
        "profile": {k: prof[k] for k in ("wall_ms", "busy_ms", "kernels")},
        "idle_share": 1 - prof["busy_ms"] / prof["wall_ms"],
        "card": hw["card"]}
    print("13(b) block import through BeaconChain at 2^%d validators "
          "(median of %d warm imports, each on a chain built anew from the "
          "checkpoint): %s" % (n.bit_length() - 1, IMPORT_WARM_RUNS,
                               json.dumps(summary)))
    # what phase 15(b) produces on: the checkpoint, the block (its real
    # aggregates and randao reveal), their committees, the warm pubkey
    # cache and the host oracle's parent advanced to the block's slot
    ctx = {"parent": parent, "anchor": anchor, "block": sb,
           "committees": committees, "pubkey_cache": cache, "adv": adv,
           "sync": sync, "preset": preset, "spec": spec, "T": T}
    return summary, ctx


# ---------------------------------------------------------------------------
# Phase 14: fork choice at 2^20 validators on the card
# ---------------------------------------------------------------------------

FC_LOG2_VALIDATORS = 20
FC_SLOTS = 96                        # 3 MAINNET epochs of slots
FC_NODES = 96                        # a main chain and two forks in them
ZERO32 = b"\x00" * 32
FC_ROUNDS = 8
FC_REVOTES = 1 << 15                 # one slot's committees: 2^20 / 32
FC_CHAINY_NODES = 64
FC_CHAINY_MAX_DEPTH = 16             # forced small: the host route runs


def fc_root(i: int) -> bytes:
    return int(i).to_bytes(4, "little") + b"\x5c" * 28


def fc_tree(engines, n_slots: int, forks):
    """A block per slot on a main chain from an anchor at slot 0, and for
    each ``(at, length)`` of ``forks`` a side chain of ``length`` blocks
    from the main block at slot ``at``: the same inserts on every engine.
    Returns (roots by node index, main-chain roots, the fork tips)."""
    from lighthouse_tpu_torch.fork_choice.proto_array import (
        EXEC_IRRELEVANT, ZERO_ROOT)
    roots, main, tips = [], [], []

    def add(root, parent, slot):
        for e in engines:
            e.on_block(slot=slot, root=root, parent_root=parent,
                       state_root=root, justified_epoch=1,
                       justified_root=fc_root(0), finalized_epoch=1,
                       finalized_root=fc_root(0),
                       execution_status=EXEC_IRRELEVANT)
        roots.append(root)

    add(fc_root(0), ZERO_ROOT, 0)
    main.append(fc_root(0))
    side_len = {at: length for at, length in forks}
    nid = 1
    for slot in range(1, n_slots):
        add(fc_root(nid), main[-1], slot)
        main.append(fc_root(nid))
        nid += 1
        if slot in side_len:
            parent = main[-2]
            for k in range(side_len[slot]):
                add(fc_root(nid), parent, slot + k + 1)
                parent = fc_root(nid)
                nid += 1
            tips.append(parent)
    return roots, main, tips


def fc_round(torch, eng, bal, jcp, boost_root, boost_score, slot):
    """One head round on ``eng``: host clock ending in a device sync."""
    def go():
        deltas = eng.compute_deltas(bal)
        eng.apply_score_changes(deltas, jcp, jcp, boost_root, boost_score,
                                slot)
        return eng.find_head(jcp[1], slot)
    return timed(torch, go)


def fc_equal(a, b) -> bool:
    n = a.cols.n
    return (n == b.cols.n
            and np.array_equal(a.cols.weight[:n], b.cols.weight[:n])
            and np.array_equal(a.cols.best_child[:n], b.cols.best_child[:n])
            and np.array_equal(a.cols.best_desc[:n], b.cols.best_desc[:n])
            and np.array_equal(a.votes_store.current, b.votes_store.current)
            and np.array_equal(a.old_balances, b.old_balances))


def phase_fork_choice(torch, hw: dict) -> dict:
    """14: fork choice at 2^20 validators, the ``torch`` engine on the
    card against the ``numpy`` engine on the host.  A tree of 96 nodes
    over 3 epochs of slots with two forks; 8 head rounds with proposer
    boost, each after 1/32 of the registry re-votes (one slot's
    committees), the justified balances changing once at an epoch
    boundary; the weights, best-child and best-descendant columns, votes,
    balances and head equal exactly after every round.  Then a chain of
    64 nodes with ``jit_max_depth`` forced to 16: its rounds take the
    host route (counted), equal to numpy's."""
    from torch.profiler import ProfilerActivity, profile

    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.fork_choice.device_proto_array import \
        DeviceProtoArrayForkChoice

    nv = 1 << FC_LOG2_VALIDATORS
    rng = np.random.default_rng(SEED + 14)
    card = DeviceProtoArrayForkChoice(engine="torch")
    host = DeviceProtoArrayForkChoice(engine="numpy")
    roots, main, tips = fc_tree((card, host), FC_NODES - 10,
                                [(30, 6), (70, 4)])
    n_nodes = len(roots)
    check(n_nodes == FC_NODES and len(tips) == 2,
          f"14: the tree has {n_nodes} nodes, not {FC_NODES}")
    depth = card.cols.max_depth()
    jcp = (1, fc_root(0))
    bal = np.full(nv, 32 * 10 ** 9, dtype=np.uint64)
    # every validator votes first: 49.2% for fork A's tip, 26.8% for the
    # main tip, 24% for fork B's tip (B branches off the main chain above
    # A's fork point); each later round's re-voters go to one tip, whose
    # block also takes the proposer boost, so the head moves between the
    # branches (main, A, B, B, main, ...) with margins of 0.9% or more
    targets = [tips[0], main[-1], tips[1]]
    first = rng.choice(3, nv, p=[0.492, 0.268, 0.240])
    for t in range(3):
        idx = np.flatnonzero(first == t)
        for e in (card, host):
            e.process_attestation_batch([(idx, targets[t], 2)])
    schedule = [None, 0, 2, 2, 1, 1, 0, 0]
    rows, heads = [], []
    for r in range(FC_ROUNDS):
        slot = FC_SLOTS + r
        if schedule[r] is not None:
            voters = rng.choice(nv, FC_REVOTES, replace=False)
            for e in (card, host):
                e.process_attestation_batch(
                    [(voters, targets[schedule[r]], 3 + r)])
        if r == FC_ROUNDS // 2:        # an epoch boundary: balances move
            moved = rng.choice(nv, nv // 64, replace=False)
            bal = bal.copy()
            bal[moved] -= np.uint64(10 ** 9)
        boost_root = targets[1 if schedule[r] is None else schedule[r]]
        boost = int(bal.sum()) // 32 * 40 // 100
        t0 = LEDGER.transfer_totals()["fork_choice"]
        h_card, ms_card = fc_round(torch, card, bal, jcp, boost_root, boost,
                                   slot)
        t1 = LEDGER.transfer_totals()["fork_choice"]
        h_host, ms_host = fc_round(torch, host, bal, jcp, boost_root, boost,
                                   slot)
        check(h_card == h_host and fc_equal(card, host),
              f"14: round {r}: the torch engine != the numpy engine")
        heads.append(h_card)
        rows.append({"round": r, "card_ms": ms_card, "numpy_ms": ms_host,
                     "h2d": t1[0] - t0[0], "d2h": t1[1] - t0[1]})
    check(card.host_rounds == 0, "14: a shallow round took the host route")
    check(len(set(heads)) >= 3,
          f"14: the head visited {len(set(heads))} branches, not 3")
    # CUDA launches of one warm round (torch.profiler), equality after it
    voters = rng.choice(nv, FC_REVOTES, replace=False)
    for e in (card, host):
        e.process_attestation_batch([(voters, targets[0], 20)])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h_card, ms_prof = fc_round(torch, card, bal, jcp, ZERO32, 0,
                                   FC_SLOTS + FC_ROUNDS)
    h_host, _ = fc_round(torch, host, bal, jcp, ZERO32, 0,
                         FC_SLOTS + FC_ROUNDS)
    check(h_card == h_host and fc_equal(card, host),
          "14: the profiled round: the torch engine != the numpy engine")
    devt = device_events(prof)
    copies = sum(c for _d, c, k in devt if k.startswith(("Memcpy",
                                                         "Memset")))
    launches = sum(c for _d, c, _k in devt) - copies
    busy = sum(d for d, _c, _k in devt) / 1e3

    # the host route: a chain deeper than a forced-small max depth
    deep = DeviceProtoArrayForkChoice(engine="torch",
                                      jit_max_depth=FC_CHAINY_MAX_DEPTH)
    deep_np = DeviceProtoArrayForkChoice(engine="numpy")
    _, chain_roots, _ = fc_tree((deep, deep_np), FC_CHAINY_NODES, [])
    for r in range(4):
        voters = rng.choice(nv, FC_REVOTES, replace=False)
        tgt = chain_roots[-1 - 3 * r]
        for e in (deep, deep_np):
            e.process_attestation_batch([(voters, tgt, 2 + r)])
        a, _ = fc_round(torch, deep, bal, jcp, ZERO32, 0, FC_CHAINY_NODES)
        b, _ = fc_round(torch, deep_np, bal, jcp, ZERO32, 0,
                        FC_CHAINY_NODES)
        check(a == b and fc_equal(deep, deep_np),
              f"14: chainy round {r}: the host route != numpy")
    check(deep.host_rounds == 4, f"14: {deep.host_rounds} host-route "
                                 f"rounds, expected 4")
    warm = rows[1:]
    summary = {
        "validators": nv, "nodes": n_nodes, "max_depth": depth,
        "revotes_per_round": FC_REVOTES, "rounds": FC_ROUNDS,
        "head_node_per_round": [card.cols.indices[h] for h in heads],
        "cold_round_ms": {"card": rows[0]["card_ms"],
                          "numpy": rows[0]["numpy_ms"]},
        "warm_round_ms_median": {
            "card": statistics.median(r["card_ms"] for r in warm),
            "numpy": statistics.median(r["numpy_ms"] for r in warm)},
        "warm_round_ms": [(round(r["card_ms"], 3), round(r["numpy_ms"], 3))
                          for r in warm],
        "cold_round_bytes": {"h2d": rows[0]["h2d"], "d2h": rows[0]["d2h"]},
        "warm_round_bytes_median": {
            "h2d": statistics.median(r["h2d"] for r in warm),
            "d2h": statistics.median(r["d2h"] for r in warm)},
        "launches_per_round": launches, "copies_per_round": copies,
        "profiled_round": {"wall_ms": ms_prof, "busy_ms": busy,
                           "idle_share": 1 - busy / ms_prof},
        "host_route_rounds": {"chainy": deep.host_rounds,
                              "bushy": card.host_rounds},
        "card": hw["card"]}
    print("14 fork choice at 2^%d validators, torch engine on the card vs "
          "numpy, equal after every round: %s" % (
              FC_LOG2_VALIDATORS, json.dumps(summary)))
    return summary


# ---------------------------------------------------------------------------
# Phase 15: block production on the card
# ---------------------------------------------------------------------------

PRODUCE_SLOTS = 10                   # 15(a): MINIMAL slots 1-10, across
#                                      the epoch boundary at slot 8
PRODUCE_PATH_KERNELS = ("hash64", "hash_g2", "prepare", "sigma",
                        "sigma_combine", "miller_fold", "finalize")
PACK_SUBSETS = 16                    # 15(b): subset aggregates a real
#                                      one: 128 × 17 = 2176 candidates,
#                                      past the 2048 columnar threshold
PACK_BENCH_AGGREGATES = 100_000      # 15(c): BASELINE row 5
PACK_WARM_RUNS = 5
PRODUCE_SPANS = ("block_production", "produce_components",
                 "produce_scratch_block", "produce_state_root")


def ssz_copy(obj):
    return type(obj).deserialize(type(obj).serialize(obj))


def cpu_reference_production(genesis, records, preset, spec, T) -> list:
    """15(a)'s reference: a second port chain on the CPU (the port's
    device set to cpu, the fake BLS backend: the card verified the
    signatures) from genesis by its SSZ bytes.  At each slot it produces
    its own block with the card's randao reveal, then imports the card's
    signed block and submits the card's attestations and sync messages.
    Returns, per slot, (its unsigned block's bytes, its head root, its op
    pool's bytes)."""
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.op_pool.persistence import encode_op_pool
    from lighthouse_tpu_torch.types import ForkName
    from lighthouse_tpu_torch.validator_client import InProcessBeaconNode
    prev = (device.default_device(), bls._active)
    device.set_default_device("cpu")
    bls.set_backend("fake")
    try:
        state = T.state_cls(ForkName.CAPELLA).deserialize(
            type(genesis).serialize(genesis))
        chain = genesis_chain(state, preset, spec, T)
        node = InProcessBeaconNode(chain)
        out = []
        for slot in sorted(records):
            rec = records[slot]
            chain.per_slot_task(slot)
            block = node.produce_block(slot, bytes(
                rec["signed"].message.body.randao_reveal))
            node.publish_block(ssz_copy(rec["signed"]))
            res = chain.process_attestation_batch(
                [ssz_copy(a) for a in rec.get("atts", [])])
            check(all(v is not None for v, _ in res),
                  f"15(a): the CPU chain refused an attestation at slot "
                  f"{slot}")
            if "sync" in rec:
                node.submit_sync_messages(*rec["sync"])
            out.append((type(block).serialize(block), chain.head.root,
                        encode_op_pool(chain.op_pool, T)))
        return out
    finally:
        device.set_default_device(prev[0])
        bls._active = prev[1]


def phase_produce_minimal(torch, hw: dict) -> dict:
    """15(a): one ``ValidatorClient`` with the 64 interop keys drives
    ``InProcessBeaconNode`` over a port chain on the card (a
    device-resident MINIMAL Capella genesis, an in-memory store, the
    default ``tpu`` BLS backend with every batch on the card) from genesis
    over slots 1-10: each slot it proposes (randao and block signed on
    the host under slashing protection, the block produced by the chain
    and imported by ``publish_block``), attests and sends sync messages.
    A CPU chain fed the same signed blocks, attestations and sync
    messages produces its own block at each slot: its unsigned bytes, the
    head and the op pool's bytes must equal the card's.  Every kernel of
    the path launches; the slashing database then refuses a second
    proposal at a proposed slot."""
    from lighthouse_tpu_torch.common.logging import test_logger
    from lighthouse_tpu_torch.op_pool.persistence import encode_op_pool
    from lighthouse_tpu_torch.state_transition import interop_secret_key
    from lighthouse_tpu_torch.testing import StateHarness
    from lighthouse_tpu_torch.types.device_state import (is_materialized,
                                                         materialize_state)
    from lighthouse_tpu_torch.validator_client import (
        InProcessBeaconNode, SlashingProtectionError, ValidatorClient,
        ValidatorStore)

    class RecordingNode(InProcessBeaconNode):
        """The in-process node, keeping what the client sends it; an
        attestation the chain refuses fails the phase."""

        def __init__(self, chain):
            super().__init__(chain)
            self.records = {}

        def _rec(self, slot: int) -> dict:
            return self.records.setdefault(int(slot), {})

        def produce_block(self, slot, randao_reveal, *args, **kw):
            block = super().produce_block(slot, randao_reveal, *args, **kw)
            self._rec(slot)["unsigned"] = type(block).serialize(block)
            return block

        def publish_block(self, signed_block):
            self._rec(signed_block.message.slot)["signed"] = signed_block
            return super().publish_block(signed_block)

        def submit_attestations(self, atts):
            if not atts:
                return
            self._rec(atts[0].data.slot)["atts"] = list(atts)
            res = self.chain.process_attestation_batch(atts)
            check(all(v is not None for v, _ in res),
                  f"15(a): the card's chain refused an attestation: "
                  f"{[repr(e) for _, e in res if e is not None][:3]}")

        def submit_sync_messages(self, slot, block_root, items):
            self._rec(slot)["sync"] = (slot, block_root, list(items))
            super().submit_sync_messages(slot, block_root, items)

    t0 = time.perf_counter()
    h = StateHarness(IMPORT_SMALL_VALIDATORS)
    genesis = h.state.copy()
    setup_s = time.perf_counter() - t0
    os.environ["LIGHTHOUSE_TPU_HOST_FASTPATH_MAX"] = "0"
    try:
        anchor = genesis.copy()
        check(materialize_state(anchor), "15(a): materialize refused")
        chain = genesis_chain(anchor, h.preset, h.spec, h.T)
        keys = ValidatorStore()
        for v in range(IMPORT_SMALL_VALIDATORS):
            keys.add_validator(interop_secret_key(v), index=v)
        node = RecordingNode(chain)
        client = ValidatorClient(keys, [node], h.preset, log=test_logger())
        zero_all_launches()
        t1 = time.perf_counter()
        slots = []
        for slot in range(1, PRODUCE_SLOTS + 1):
            chain.per_slot_task(slot)
            client.on_slot(slot)
            check(chain.head.slot == slot and is_materialized(
                chain.head.state), f"15(a): no device-resident head at "
                                   f"slot {slot}")
            slots.append((node.records[slot]["unsigned"], chain.head.root,
                          encode_op_pool(chain.op_pool, h.T)))
        card_ms = (time.perf_counter() - t1) * 1e3
        launched = all_launches()
    finally:
        os.environ.pop("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX", None)
    missing = [k for k in PRODUCE_PATH_KERNELS if launched[k] == 0]
    check(not missing, f"15(a): kernels of the path never launched: "
                       f"{missing} ({launched})")
    duty = client.duties.proposer_at(PRODUCE_SLOTS)
    pk = next(p for p, v in keys.index_by_pubkey.items()
              if v == duty.validator_index)
    try:
        keys.slashing_db.check_and_insert_block_proposal(
            pk, PRODUCE_SLOTS, b"\xff" * 32)
        fail("15(a): the slashing database signed a second proposal at a "
             "proposed slot")
    except SlashingProtectionError:
        pass
    t1 = time.perf_counter()
    want = cpu_reference_production(genesis, node.records, h.preset,
                                    h.spec, h.T)
    cpu_s = time.perf_counter() - t1
    for slot, (got, ref) in enumerate(zip(slots, want), start=1):
        check(got[0] == ref[0], f"15(a): the card's unsigned block at slot "
                                f"{slot} != the CPU chain's")
        check(got[1] == ref[1], f"15(a): the head at slot {slot} != the CPU "
                                f"chain's")
        check(got[2] == ref[2], f"15(a): the op pool at slot {slot} != the "
                                f"CPU chain's")
    blocks = [node.records[s]["signed"].message for s in node.records]
    n_atts = sum(len(b.body.attestations) for b in blocks)
    n_sync = sum(int(np.sum(b.body.sync_aggregate.sync_committee_bits))
                 for b in blocks)
    out = {"slots": PRODUCE_SLOTS, "card_ms": card_ms,
           "ms_per_slot": card_ms / PRODUCE_SLOTS,
           "packed_attestations": n_atts, "sync_bits": n_sync,
           "launches": launched}
    print(f"15(a) ValidatorClient over a MINIMAL chain at "
          f"{IMPORT_SMALL_VALIDATORS} validators on the card, slots 1-"
          f"{PRODUCE_SLOTS}: {card_ms:.0f} ms ({card_ms / PRODUCE_SLOTS:.0f} "
          f"ms a slot: proposal, publication, attestations, sync messages; "
          f"{n_atts} attestations packed, {n_sync} sync bits); every "
          f"unsigned block, head and op pool equal to the CPU chain's "
          f"({cpu_s:.1f} s); a second proposal at slot {PRODUCE_SLOTS} "
          f"refused; launches {launched} (genesis {setup_s:.1f} s) "
          f"[{hw['card']}]")
    return out


def subset_aggregates(T, atts, rng) -> list:
    """``PACK_SUBSETS`` aggregates of each of ``atts``' AttestationData
    whose bits are strict subsets, at most half, of the real aggregate's
    and hold its first attester (so no two are disjoint and none merge in
    the pool); they carry the real signature, and since the real
    aggregate covers each of them and sits before them in the pool,
    greedy max-cover never selects one."""
    out = []
    for att in atts:
        on = np.flatnonzero(np.asarray(att.aggregation_bits, bool))
        for _ in range(PACK_SUBSETS):
            k = int(rng.integers(1, on.size // 2 + 1))
            bits = np.zeros(len(att.aggregation_bits), bool)
            bits[on[0]] = True
            bits[rng.choice(on[1:], k - 1, replace=False)] = True
            out.append(T.Attestation(aggregation_bits=bits.tolist(),
                                     data=att.data,
                                     signature=att.signature))
    return out


def phase_produce_mainnet(torch, hw: dict, ctx: dict) -> dict:
    """15(b): production at 2^20 validators through
    ``InProcessBeaconNode.produce_block`` on chains booted by
    ``from_checkpoint`` from 13(b)'s anchor (outside the timed window),
    whose op pools hold 13(b)'s 128 real aggregates and, after each,
    ``PACK_SUBSETS`` subset aggregates of it: ≥ 2048 candidates, so the
    pack runs the columnar path and the torch rounds on the card.  The
    block's slot is 13(b)'s; adopted (after ``_advance_and_prime``) and
    serial routes, each timed once on a host clock ending in a sync, must
    give byte-equal blocks; the selection equals CELF's on the same CSR,
    and the rounds and CELF are then timed on that CSR (the median of
    ``PACK_WARM_RUNS`` warm calls each, in turns); the state root equals
    the host oracle's; signed with the proposer's derived key, the block
    imports on the card and becomes the head."""
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.common.tracing import TRACER, stage_split
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.op_pool import device_pack as DP
    from lighthouse_tpu_torch.op_pool.max_cover import greedy_pack
    from lighthouse_tpu_torch.state_transition import SignatureStrategy
    from lighthouse_tpu_torch.state_transition.helpers import (
        compute_signing_root, get_domain)
    from lighthouse_tpu_torch.state_transition.per_block import process_block
    from lighthouse_tpu_torch.types import Domain, ForkName
    from lighthouse_tpu_torch.validator_client import InProcessBeaconNode

    preset, spec, T = ctx["preset"], ctx["spec"], ctx["T"]
    sb = ctx["block"]
    slot = int(sb.message.slot)
    real = list(sb.message.body.attestations)
    subsets = subset_aggregates(T, real, np.random.default_rng(SEED + 15))
    reveal = bytes(sb.message.body.randao_reveal)
    anchor_root = ctx["anchor"].message.tree_hash_root()

    def chain_with_pool():
        c = checkpoint_chain(ctx["parent"], ctx["anchor"], preset, spec, T,
                             ctx["pubkey_cache"])
        for att, committee in zip(real, ctx["committees"]):
            c.op_pool.insert_attestation(att, committee)
        for i, att in enumerate(subsets):
            c.op_pool.insert_attestation(att,
                                         ctx["committees"][i // PACK_SUBSETS])
        check(c.op_pool.num_attestations() == len(real) + len(subsets),
              "15(b): the pool merged aggregates")
        return c

    packs = []
    pack = DP.greedy_pack_device

    def recording_pack(flat_e, flat_w, offsets, n_elements, limit, **kw):
        chosen = pack(flat_e, flat_w, offsets, n_elements, limit, **kw)
        packs.append((flat_e, flat_w, offsets, n_elements, limit, chosen,
                      dict(DP.LAST_PACK_STATS)))
        return chosen

    def produce(c, label):
        """One timed production on ``c``: the block, its split, the
        launches and the ledger's bytes."""
        node = InProcessBeaconNode(c)
        TRACER.reset()
        TRACER.set_slot(slot)
        DP.reset_stats()
        zero_all_launches()
        ledger0 = LEDGER.transfer_totals()
        block, wall = timed(torch, lambda: node.produce_block(slot, reveal))
        moved = ledger_moved(LEDGER, ledger0)
        after = LEDGER.transfer_totals()
        return block, {
            "route": label, "wall_ms": wall, "launches": all_launches(),
            "pack": dict(DP.LAST_PACK_STATS),
            "state": stage_split("production"),
            "spans": span_split(TRACER, slot, PRODUCE_SPANS),
            "ledger": {"h2d": moved["h2d"], "d2h": moved["d2h"],
                       "h2d_by": moved["h2d_by"],
                       "op_pool_h2d": after["op_pool"][0]
                       - ledger0["op_pool"][0],
                       "op_pool_d2h": after["op_pool"][1]
                       - ledger0["op_pool"][1]}}

    t0 = time.perf_counter()
    ca = chain_with_pool()
    cb = chain_with_pool()
    boot_s = time.perf_counter() - t0
    _, advance_ms = timed(torch, lambda: ca._advance_and_prime(slot))
    check((anchor_root, slot) in ca._advanced_states,
          "15(b): the advance was not cached")
    DP.greedy_pack_device = recording_pack
    TRACER.enable()
    try:
        adopted_block, adopted = produce(ca, "adopted")
        serial_block, serial = produce(cb, "serial")
    finally:
        TRACER.disable()
        DP.greedy_pack_device = pack
    check((ca._produce_adopted, ca._produce_serial, cb._produce_adopted,
           cb._produce_serial) == (1, 0, 0, 1),
          "15(b): the routes were not adopted and serial")
    check(type(adopted_block).serialize(adopted_block)
          == type(serial_block).serialize(serial_block),
          "15(b): the adopted and serial blocks differ")
    check(len(packs) == 2
          and all(p[6].get("device", "").startswith("cuda") for p in packs)
          and packs[0][6]["candidates"] >= 2048,
          f"15(b): the pack did not run the rounds on the card on >= 2048 "
          f"candidates: {[p[6] for p in packs]}")
    for flat_e, flat_w, offsets, n_el, limit, chosen, _ in packs:
        celf, _, _ = greedy_pack(flat_e, flat_w, offsets, n_el, limit)
        check(list(chosen) == list(celf),
              "15(b): the torch rounds' selection != CELF's")
    # the rounds against CELF on the production CSR, in turns
    csr = packs[0][:5]
    rounds_ms, celf_ms = [], []
    for i in range(PACK_WARM_RUNS):
        for path in (("torch", "celf") if i % 2 == 0 else ("celf", "torch")):
            if path == "torch":
                rounds_ms.append(timed(torch, lambda: pack(*csr))[1])
            else:
                celf_ms.append(timed(torch, lambda: greedy_pack(*csr))[1])
    packed = adopted_block.body.attestations
    real_bytes = {type(a).serialize(a) for a in real}
    check(0 < len(packed) <= len(real)
          and all(type(a).serialize(a) in real_bytes for a in packed),
          "15(b): the block packed a subset aggregate")
    check(adopted["launches"]["hash64"] > 0,
          f"15(b): the state root launched no hash64: "
          f"{adopted['launches']}")

    # the host oracle: the same block on the parent advanced on the host
    t0 = time.perf_counter()
    os.environ["LIGHTHOUSE_TPU_DEVICE_STATE"] = "0"
    try:
        scratch = ctx["adv"].copy()
        process_block(scratch, T.signed_block_cls(ForkName.CAPELLA)(
            message=ssz_copy(adopted_block),
            signature=bls.INFINITY_SIGNATURE), ForkName.CAPELLA, preset,
            spec, T, strategy=SignatureStrategy.NO_VERIFICATION)
        want_root = scratch.tree_hash_root()
    finally:
        os.environ.pop("LIGHTHOUSE_TPU_DEVICE_STATE", None)
    oracle_s = time.perf_counter() - t0
    del scratch
    check(bytes(adopted_block.state_root) == want_root,
          "15(b): the produced block's state root != the host oracle's")

    # signed with the proposer's derived key, it imports on the card
    proposer = int(adopted_block.proposer_index)
    check(proposer == int(sb.message.proposer_index),
          "15(b): the proposer differs from 13(b)'s")
    domain = get_domain(ctx["adv"], Domain.BEACON_PROPOSER,
                        slot // preset.SLOTS_PER_EPOCH, preset)
    signed = T.signed_block_cls(ForkName.CAPELLA)(
        message=adopted_block, signature=bls.SecretKey(
            GEN_SK0 + GEN_SK_STEP * proposer).sign(compute_signing_root(
                adopted_block, domain)).serialize())
    zero_all_launches()
    root, import_ms = timed(torch, lambda: InProcessBeaconNode(
        ca).publish_block(signed))
    launched_import = all_launches()
    check(root == adopted_block.tree_hash_root() and ca.head.root == root,
          "15(b): the produced block did not become the head")
    missing = [k for k in PRODUCE_PATH_KERNELS if launched_import[k] == 0]
    check(not missing, f"15(b): the import launched no {missing}")

    def split(r):
        p = r["pack"]
        return {"wall_ms": r["wall_ms"], "state_ms": r["state"],
                "pack": {k: p.get(k) for k in (
                    "csr_build_ms", "coverage_ms", "stage_ms",
                    "select_rounds_ms", "candidates", "entries",
                    "selected")},
                "spans_ms": r["spans"], "ledger": r["ledger"]}

    summary = {
        "validators": len(ctx["parent"].validators), "slot": slot,
        "pool": len(real) + len(subsets), "packed": len(packed),
        "advance_and_prime_ms": advance_ms, "chain_boot_s": boot_s,
        "adopted": split(adopted), "serial": split(serial),
        "launches_production": adopted["launches"],
        "launches_serial": serial["launches"],
        "pack_bound_ms": DP.modeled_pack_ms(
            packs[0][6]["entries"], packs[0][6]["candidates"],
            packs[0][6]["rounds"]),
        "rounds_warm_ms": statistics.median(rounds_ms),
        "rounds_warm_ms_runs": rounds_ms,
        "celf_ms": statistics.median(celf_ms), "celf_ms_runs": celf_ms,
        "import_ms": import_ms, "launches_import": launched_import,
        "host_oracle_s": oracle_s, "card": hw["card"]}
    print("15(b) production at 2^%d validators through InProcessBeaconNode."
          "produce_block (adopted == serial byte for byte, the torch pack "
          "== CELF, the state root == the host oracle's, the signed block "
          "imported and became the head): %s" % (
              len(ctx["parent"].validators).bit_length() - 1,
              json.dumps(summary)))
    return summary


def phase_pack_baseline(torch, hw: dict) -> dict:
    """15(c): BASELINE row 5 — ``bench_pack_attestations(100_000)`` at
    2^20 validators (the pool built outside the timed window), the
    ``get_attestations`` of its pool on the torch rounds and with the
    host CELF ``greedy_pack`` in the rounds' place: the median of 5 warm
    calls each (host clock ending in a sync), the rounds alone, the
    bound, the CUDA launches of one pack (torch.profiler) and its bytes
    (ledger).  The two paths run in turns, after one call of each.  Both
    pack the same candidates in the same order."""
    from lighthouse_tpu_torch import op_pool as OP
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.op_pool import device_pack as DP
    from lighthouse_tpu_torch.op_pool.max_cover import greedy_pack

    bench_ms, bench_n = OP.bench_pack_attestations(PACK_BENCH_AGGREGATES)
    check(bench_n > 0
          and DP.LAST_PACK_STATS.get("device", "").startswith("cuda"),
          f"15(c): bench_pack_attestations packed {bench_n} on "
          f"{DP.LAST_PACK_STATS.get('device')}")
    t0 = time.perf_counter()
    pool, state, T = OP.bench_pool(PACK_BENCH_AGGREGATES)
    build_s = time.perf_counter() - t0

    def pack():
        return [type(a).serialize(a) for a in pool.get_attestations(state, T)]

    celf_ms = []
    rounds = DP.greedy_pack_device

    def celf(flat_e, flat_w, offsets, n_elements, limit, **_):
        t = time.perf_counter()
        chosen, _, _ = greedy_pack(flat_e, flat_w, offsets, n_elements,
                                   limit)
        celf_ms.append((time.perf_counter() - t) * 1e3)
        return chosen

    def run(path):
        """One timed call on ``path`` ("torch" or "celf", the CELF oracle
        swapped in for the rounds)."""
        DP.greedy_pack_device = rounds if path == "torch" else celf
        try:
            ledger0 = LEDGER.transfer_totals()
            packed, ms = timed(torch, pack)
            after = LEDGER.transfer_totals()
        finally:
            DP.greedy_pack_device = rounds
        return {"ms": ms, "packed": packed,
                "stats": dict(DP.LAST_PACK_STATS),
                "h2d": after["op_pool"][0] - ledger0["op_pool"][0],
                "d2h": after["op_pool"][1] - ledger0["op_pool"][1]}

    zero_all_launches()
    run("torch")                  # one call of each first, not kept
    run("celf")
    dev, host = [], []
    for i in range(PACK_WARM_RUNS):   # in turns: T C, C T, T C, ...
        for path in (("torch", "celf") if i % 2 == 0 else ("celf", "torch")):
            (dev if path == "torch" else host).append(run(path))
    check(all(k == 0 for k in all_launches().values()),
          "15(c): the pack launched a port kernel")
    prof = profile_call(torch, hw, "15(c) one pack, torch rounds", pack)
    check(all(r["packed"] == dev[0]["packed"] for r in dev + host),
          "15(c): the torch rounds and CELF packed different lists")
    st = dev[-1]["stats"]
    bound = DP.modeled_pack_ms(st["entries"], st["candidates"],
                               st["rounds"])

    def med(rows, key):
        return statistics.median(r[key] for r in rows)

    summary = {
        "aggregates": PACK_BENCH_AGGREGATES, "validators": 1 << 20,
        "candidates": st["candidates"], "entries": st["entries"],
        "packed": len(dev[0]["packed"]), "pool_build_s": build_s,
        "bench_pack_attestations_ms": bench_ms,
        "torch_ms": med(dev, "ms"), "torch_ms_runs": [r["ms"] for r in dev],
        "celf_ms": med(host, "ms"), "celf_ms_runs": [r["ms"] for r in host],
        "select_rounds_ms": statistics.median(
            r["stats"]["select_rounds_ms"] for r in dev),
        "stage_ms": statistics.median(r["stats"]["stage_ms"] for r in dev),
        "csr_build_ms": med([r["stats"] for r in dev], "csr_build_ms"),
        "coverage_ms": med([r["stats"] for r in dev], "coverage_ms"),
        "celf_greedy_ms": statistics.median(celf_ms[1:]),
        "bound_ms": bound, "bound_by": "bytes",
        "launches_per_pack": prof["kernels"],
        "copies_per_pack": prof["copies"],
        "profiled": {"wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                     "idle_share": 1 - prof["busy_ms"] / prof["wall_ms"]},
        "bytes_per_pack": {"h2d": dev[-1]["h2d"], "d2h": dev[-1]["d2h"]},
        "card": hw["card"]}
    print("15(c) BASELINE row 5, get_attestations over %d pooled aggregates "
          "at 2^20 validators, torch rounds vs CELF (the same %d "
          "attestations in the same order): %s" % (
              PACK_BENCH_AGGREGATES, summary["packed"], json.dumps(summary)))
    return summary


# ---------------------------------------------------------------------------
# Phase 16: Deneb data availability on the card
# ---------------------------------------------------------------------------

KZG_WIDTH = 4096                     # MAINNET FIELD_ELEMENTS_PER_BLOB
KZG_BLOBS = 6                        # MAX_BLOBS_PER_BLOCK (bench.py:1391)
KZG_TIMED_RUNS = 10
KZG_WARM_RUNS = 5
KZG_PATH_KERNELS = ("kzg_eval", "miller_fold", "finalize")
FORK_SMALL_VALIDATORS = 64
FORK_SMALL_SLOTS = 14                # epoch 0 on Capella, then Deneb
FORK_SMALL_EPOCH = 1                 # deneb_fork_epoch of 16(e)


def kzg_worker_init() -> None:
    """A host worker of phase 16 (spawned: it never touches the card):
    the native pairing loaded from the parent's build."""
    from lighthouse_tpu_torch.crypto import native
    native.available(block=True)


def kzg_setup():
    from lighthouse_tpu_torch.kzg.trusted_setup import verification_setup
    global _KZG_SETUP
    if _KZG_SETUP is None:
        _KZG_SETUP = verification_setup(KZG_WIDTH)
    return _KZG_SETUP


_KZG_SETUP = None


def kzg_commit_prove(blob: bytes) -> tuple:
    """A worker's commitment and proof of one blob (the known-τ paths)."""
    from lighthouse_tpu_torch.kzg import kzg as K
    cm = K.blob_to_kzg_commitment(blob, kzg_setup())
    return cm, K.compute_blob_kzg_proof(blob, cm, kzg_setup())


def kzg_oracle_eval(args) -> int:
    """A worker's host-oracle p(z) of one blob."""
    from lighthouse_tpu_torch.kzg import fr
    from lighthouse_tpu_torch.kzg import kzg as K
    blob, z = args
    return fr.evaluate_polynomial_in_evaluation_form(
        K.blob_to_polynomial(blob, KZG_WIDTH), z, kzg_setup().roots)


def kzg_host_verdict(args) -> tuple:
    """A worker's host RLC fold of one batch: its verdict (or the error
    class it raised) and its wall ms."""
    from lighthouse_tpu_torch.kzg import kzg as K
    t0 = time.perf_counter()
    try:
        out = bool(K.verify_blob_kzg_proof_batch_host(*args, kzg_setup()))
    except K.KzgError:
        out = "KzgError"
    return out, (time.perf_counter() - t0) * 1e3


def kzg_verdict(fn):
    from lighthouse_tpu_torch.kzg import kzg as K
    try:
        return bool(fn())
    except K.KzgError:
        return "KzgError"


def off_subgroup_g1() -> bytes:
    """A compressed G1 point on the curve but outside the r-order
    subgroup (the smallest x that gives one)."""
    from lighthouse_tpu_torch.crypto import curve as C
    from lighthouse_tpu_torch.crypto import fields as F
    x = 1
    while True:
        y = F.fq_sqrt((x ** 3 + 4) % F.P)
        if y is not None and not C.g1_subgroup_check((x, y)):
            return C.g1_compress((x, y))
        x += 1


def event_ms(torch, fn) -> float:
    """One call of ``fn`` between two CUDA events (a warm call of a slow
    plain version)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def fermat_chain(bits) -> int:
    """Dependent products of the shortest sliding-window ladder for the
    exponent whose bits (most significant first) are ``bits``: over the
    window k, the odd powers' table (a squaring and 2^(k-1) - 1
    products), then a squaring a bit after the top window and a product
    a further window."""
    top = "".join(str(int(b)) for b in bits).lstrip("0")
    best = None
    for k in range(1, 9):
        i, cost = 0, (2 ** (k - 1) if k > 1 else 0)
        first = True
        while i < len(top):
            if top[i] == "0":
                cost += 0 if first else 1
                i += 1
                continue
            j = min(i + k, len(top))
            while top[j - 1] == "0":
                j -= 1
            cost += 0 if first else (j - i) + 1
            first, i = False, j
        best = cost if best is None else min(best, cost)
    return best


def kzg_eval_products(blobs: int, width: int) -> int:
    """The fewest Fr products p_i(z_i) needs (the rate bound's count): per
    blob a batched inversion of the W differences z - w_j (3(W - 1)
    products and one Fermat inversion), two products a term (f_j·w_j,
    then its inverse), log2 W squarings for z^W and two products for the
    factor and the sum; the roots resident in Montgomery form and z
    converted once on the host."""
    from lighthouse_tpu_torch.kzg import fr_limb as FL
    inv = fermat_chain(FL.N_MINUS_2_BITS)
    return blobs * (3 * (width - 1) + inv + 2 * width
                    + width.bit_length() - 1 + 2)


def kzg_eval_chain(width: int) -> int:
    """The shortest chain of dependent Fr products p_i(z_i) needs (the
    chain bound's count): one Fermat inversion on the shortest
    sliding-window ladder, its product with f_j·w_j, and the sum's
    product with the factor (z^W, the factor and f_j·w_j off the path).
    A batched inversion's chain is longer (log2 W levels up and down)."""
    from lighthouse_tpu_torch.kzg import fr_limb as FL
    return fermat_chain(FL.N_MINUS_2_BITS) + 2


def kzg_eval_products_run(blobs: int, width: int) -> tuple:
    """What lh_kzg_eval runs (csrc/kzg_fr.cu): (Fr products, dependent
    products on its path).  An element: the binary Fermat ladder (254
    squarings, 163 products) and two products; a blob's finishing
    thread: log2 W squarings, W^-1's conversion and two products, after
    the first launch."""
    from lighthouse_tpu_torch.kzg import fr_limb as FL
    ladder = len(FL.N_MINUS_2_BITS) - 1 + sum(FL.N_MINUS_2_BITS) - 1
    finish = width.bit_length() - 1 + 3
    return (blobs * width * (ladder + 2) + blobs * finish,
            ladder + 1 + finish - 1)


def probe_fr_latency(torch, KD, hw: dict) -> None:
    """One thread's chain of dependent Fr products, checked against its
    plain chain, timed at two lengths: the difference over the extra
    products is one product's latency (it prices the eval's chain
    bound)."""
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.kzg.fr import BLS_MODULUS as N
    x, y = 0x1234567 ** 9 % N, 0x7654321 ** 11 % N
    xy = device.to_device(KD.ints_words([x, y]), "kzg")
    check(KD.words_ints(device.to_host(KD.fr_mul_chain_kernel(xy, 64)))
          == [KD.fr_mul_chain_plain(x, y, 64)],
          "fr_mul chain kernel != its plain chain")
    short = cuda_ms(torch, lambda: KD.fr_mul_chain_kernel(xy, CHAIN_SHORT), 5)
    long_ = cuda_ms(torch, lambda: KD.fr_mul_chain_kernel(xy, CHAIN_LONG), 5)
    hw["fr_latency_ms"] = (long_ - short) / (CHAIN_LONG - CHAIN_SHORT)
    print(f"dependent Fr product latency: {hw['fr_latency_ms'] * 1e3:.4f} us "
          f"({hw['fr_latency_ms'] * 1e-3 * hw['clk_hz']:.0f} cycles at the "
          f"max SM clock; chains of {CHAIN_SHORT} and {CHAIN_LONG}: "
          f"{short:.3f} and {long_:.3f} ms; equal to the plain chain of 64) "
          f"[{hw['card']}]")


def phase_kzg_kernel(torch, hw: dict, KD, setup, blobs, zs, oracle) -> dict:
    """16(a): lh_kzg_eval_kernel against its plain version on the card in
    canonical words, at (6, 4096) on the mainnet fixture (each value also
    the host oracle's, ``oracle`` a pending map of the pool), on an edge
    batch (a z on a domain root, the zero blob, a blob of r - 1, two more
    hit lanes) and at B = 1; timed beside its rate and chain bounds."""
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.kzg.fr import BLS_MODULUS as N
    W = KZG_WIDTH
    roots = KD.roots_on_device(setup)

    def on_card(bl, zz):
        return (device.to_device(KD.blob_words(bl, W), "kzg"),
                device.to_device(KD.mont_words(zz), "kzg"))

    zero = bytes(32 * W)
    top = (N - 1).to_bytes(32, "big") * W
    rz = [int.from_bytes(hashlib.sha256(bytes([i])).digest(), "big") % N
          for i in range(3)]
    j = W // 3                          # blob 0's hit lane
    edge = ([blobs[0], zero, top, blobs[3], blobs[4], blobs[5]],
            [setup.roots[j], rz[0], rz[1], zs[3], setup.roots[W - 1],
             setup.roots[0]])
    cases = {"mainnet (6, 4096)": (blobs, zs), "edge (6, 4096)": edge,
             "B = 1": ([blobs[2]], [zs[2]]),
             "B = 1 hit": ([blobs[1]], [setup.roots[7]])}
    err, vals = 0, {}
    for name, (bl, zz) in cases.items():
        f, z = on_card(bl, zz)
        got = KD.eval_kernel_call(f, z, roots)
        want = KD.eval_plain(f, z, roots)
        err = max(err, max_abs_err(torch, got, want))
        check(torch.equal(got, want), f"16(a) {name}: kzg_eval != plain")
        vals[name] = KD.words_ints(device.to_host(got))
    felem = [[int.from_bytes(b[32 * i:32 * i + 32], "big") for i in (j,
                                                                     W - 1, 0)]
             for b in (blobs[0], blobs[4], blobs[5])]
    check(vals["edge (6, 4096)"] == [felem[0][0], 0, N - 1,
                                     vals["mainnet (6, 4096)"][3],
                                     felem[1][1], felem[2][2]],
          f"16(a): the edge batch's values are wrong: "
          f"{vals['edge (6, 4096)']}")
    check(vals["B = 1"] == [vals["mainnet (6, 4096)"][2]]
          and vals["B = 1 hit"] == [int.from_bytes(blobs[1][224:256], "big")],
          "16(a): B = 1 disagrees with the batch or the hit lane")
    f, z = on_card(blobs, zs)
    ms = cuda_ms(torch, lambda: KD.eval_kernel_call(f, z, roots),
                 KZG_TIMED_RUNS)
    plain_ms = event_ms(torch, lambda: KD.eval_plain(f, z, roots))
    probe_fr_latency(torch, KD, hw)
    nbytes = (len(blobs) * W + len(blobs) + W + len(blobs)) * 32
    run, run_chain = kzg_eval_products_run(len(blobs), W)
    t = {"ms": ms, "plain_ms": plain_ms, "shape": [len(blobs), W],
         **bounds(hw, kzg_eval_products(len(blobs), W), nbytes,
                  kzg_eval_chain(W), field="fr"),
         "products_run": run, "chain_products_run": run_chain,
         "issue_ms_run": mont_bound_ms(hw, run, hw["instr_per_fr"]),
         "chain_ms_run": run_chain * hw["fr_latency_ms"]}
    check(oracle.get() == vals["mainnet (6, 4096)"],
          "16(a): kzg_eval != the host oracle on the mainnet fixture")
    print(f"16(a) lh_kzg_eval_kernel at (6, {W}): {ms:.4f} ms (median of "
          f"{KZG_TIMED_RUNS}), plain {plain_ms:.1f} ms, {bound_note(t)} "
          f"({t['products']} Fr products the function needs); the kernel "
          f"runs {run} products ({t['issue_ms_run']:.4f} ms of issue) on a "
          f"{run_chain}-product path ({t['chain_ms_run']:.4f} ms); raw "
          f"equal to the plain version "
          f"on {len(cases)} batches (max abs err {err}), the six mainnet "
          f"values equal to the host oracle [{hw['card']}]")
    return {"timing": t, "err": err}


def kzg_batches(blobs, cms, pfs, zero_cp):
    """16(b)'s batches, each with the verdict it must give."""
    from lighthouse_tpu_torch.kzg.fr import BLS_MODULUS as N
    altered = bytearray(blobs[0])
    v = int.from_bytes(altered[160:192], "big")
    altered[160:192] = ((v + 1) % N).to_bytes(32, "big")
    zero = bytes(32 * KZG_WIDTH)
    return {
        "valid": ((blobs, cms, pfs), True),
        "swapped proofs": ((blobs, cms, [pfs[1], pfs[0]] + pfs[2:]), False),
        "altered element": (([bytes(altered)] + blobs[1:], cms, pfs), False),
        "wrong commitment": ((blobs, cms[:2] + [cms[3]] + cms[3:], pfs),
                             False),
        "zero blob": ((blobs[:5] + [zero], cms[:5] + [zero_cp[0]],
                       pfs[:5] + [zero_cp[1]]), True),
        "single blob": (([blobs[0]], [cms[0]], [pfs[0]]), True),
        "off-subgroup commitment": ((blobs, [off_subgroup_g1()] + cms[1:],
                                     pfs), "KzgError"),
    }


def phase_kzg_verify(torch, hw: dict, KD, setup, batches, host,
                     kernel_ms: dict) -> dict:
    """16(b): ``verify_blob_kzg_proof_batch`` on the card's route (the
    port's default on a GPU) on each batch, each verdict the host fold's
    (``host``: a pending map of the pool); the launches of one valid
    batch; 5 warm calls with the stage split; ledger bytes; a profile."""
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.kzg import kzg as K
    args = batches["valid"][0]
    K.verify_blob_kzg_proof_batch(*args, setup)          # warm
    zero_all_launches()
    check(K.verify_blob_kzg_proof_batch(*args, setup) is True,
          "16(b): the valid batch did not verify")
    launched = {k: v for k, v in all_launches().items() if v}
    check(launched == {k: 1 for k in KZG_PATH_KERNELS},
          f"16(b): one batch launched {launched}, not kzg_eval, miller_fold "
          f"and finalize once each")
    card = {name: kzg_verdict(lambda a=a: K.verify_blob_kzg_proof_batch(
        *a, setup)) for name, (a, _) in batches.items()}
    for name, (_, want) in batches.items():
        check(card[name] == want, f"16(b) {name}: the card gave {card[name]}"
                                  f", not {want}")
    walls, splits = [], []
    ledger0 = LEDGER.transfer_totals()
    for _ in range(KZG_WARM_RUNS):
        _, ms = timed(torch, lambda: K.verify_blob_kzg_proof_batch(*args,
                                                                   setup))
        walls.append(ms)
        splits.append(dict(KD.LAST_KZG_TIMINGS))
    moved = ledger_moved(LEDGER, ledger0)
    split = {k: statistics.median(s[k] for s in splits)
             for k in splits[0] if k.endswith("_ms")}
    prof = profile_call(torch, hw, "16(b) 6-blob KZG batch", lambda:
                        K.verify_blob_kzg_proof_batch(*args, setup),
                        kernel_ms)
    verdicts = dict(zip(batches, host.get()))
    for name in batches:
        check(verdicts[name][0] == card[name],
              f"16(b) {name}: the card gave {card[name]}, the host fold "
              f"{verdicts[name][0]}")
    out = {"wall_ms": statistics.median(walls), "split_ms": split,
           "lanes": splits[0]["lanes"], "launches": launched,
           "host_fold_ms": verdicts["valid"][1],
           "ledger": {"h2d": moved["h2d"] // KZG_WARM_RUNS,
                      "d2h": moved["d2h"] // KZG_WARM_RUNS},
           "profile": {k: prof[k] for k in ("wall_ms", "busy_ms", "kernels",
                                            "copies")},
           "idle_share": 1 - prof["busy_ms"] / prof["wall_ms"],
           "verdicts": card}
    print(f"16(b) verify_blob_kzg_proof_batch on the card, {KZG_BLOBS} "
          f"blobs of {KZG_WIDTH}: {json.dumps(out)} (median of "
          f"{KZG_WARM_RUNS} warm calls; the host fold's wall on the same "
          f"batch {verdicts['valid'][1]:.1f} ms, in a worker process; every "
          f"verdict equal to the host fold's) [{hw['card']}]")
    return out


def build_deneb_import(ctx: dict, keys, cms) -> dict:
    """16(d)'s set-up: 13(b)'s anchor state upgraded to Deneb at its own
    epoch (``upgrade_to_deneb``, ``deneb_fork_epoch`` = that epoch), with
    a Deneb anchor block, then ``build_import_block`` at the next epoch's
    first slot with the blob commitments ``cms``; the state root from the
    host oracle.  The upgrade's state is held to a fresh SSZ copy's root
    (the residency across the upgrade) and the import starts from that
    copy; 13(b)'s parent must keep its root (copy-on-write).  As in
    13(b)'s set-up, the copy's registry pubkey → index map is built
    before any copy of it is made (its build is timed: a node booted from
    this checkpoint pays it once, in its first block's sync aggregate,
    and every later copy shares it)."""
    from dataclasses import replace

    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_transition import SignatureStrategy
    from lighthouse_tpu_torch.state_transition.helpers import (
        compute_signing_root, get_domain)
    from lighthouse_tpu_torch.state_transition.per_block import process_block
    from lighthouse_tpu_torch.state_transition.per_slot import process_slots
    from lighthouse_tpu_torch.state_transition.upgrade import \
        upgrade_to_deneb
    from lighthouse_tpu_torch.types import Domain, ForkName

    preset, T = ctx["preset"], ctx["T"]
    spec = replace(ctx["spec"], deneb_fork_epoch=IMPORT_EPOCH)
    capella_root = ctx["parent"].tree_hash_root()
    t0 = time.perf_counter()
    up = upgrade_to_deneb(ctx["parent"].copy(), IMPORT_EPOCH, preset, spec, T)
    body = T.body_cls(ForkName.DENEB)()
    hdr = up.latest_block_header
    up.latest_block_header = T.BeaconBlockHeader(
        slot=hdr.slot, proposer_index=hdr.proposer_index,
        parent_root=hdr.parent_root, state_root=b"\x00" * 32,
        body_root=body.tree_hash_root())
    up_roots = (up.tree_hash_root(), type(up).hash_tree_root(up))
    data = type(up).serialize(up)
    del up
    os.environ["LIGHTHOUSE_TPU_DEVICE_STATE"] = "0"
    try:
        parent = T.state_cls(ForkName.DENEB).deserialize(data)
        check(up_roots == (parent.tree_hash_root(),) * 2,
              "16(d): the upgraded state's root != a fresh copy's")
        pk0 = parent.validators.col("pubkey")[0].tobytes()
        t_map = time.perf_counter()
        check(parent.validators.pubkey_index(pk0) == 0,
              "16(d): the registry's pubkey index is wrong")
        map_ms = (time.perf_counter() - t_map) * 1e3
        slot = int(parent.slot) + preset.SLOTS_PER_EPOCH
        adv = process_slots(parent.copy(), slot, preset, spec, T)
        anchor = T.signed_block_cls(ForkName.DENEB)(
            message=T.block_cls(ForkName.DENEB)(
                slot=hdr.slot, proposer_index=hdr.proposer_index,
                parent_root=hdr.parent_root,
                state_root=bytes(adv.latest_block_header.state_root),
                body=body), signature=bls.INFINITY_SIGNATURE)
        block, proposer, n_sync, signers, committees = build_import_block(
            T, spec, preset, bls, adv, ctx["sync"],
            np.random.default_rng(SEED + 16), ForkName.DENEB, cms)
        scratch = adv.copy()
        process_block(scratch, T.signed_block_cls(ForkName.DENEB)(
            message=block, signature=bls.INFINITY_SIGNATURE),
            ForkName.DENEB, preset, spec, T,
            strategy=SignatureStrategy.NO_VERIFICATION)
        block.state_root = scratch.tree_hash_root()
        del scratch
    finally:
        os.environ.pop("LIGHTHOUSE_TPU_DEVICE_STATE", None)
    domain = get_domain(adv, Domain.BEACON_PROPOSER,
                        slot // preset.SLOTS_PER_EPOCH, preset)
    sb = T.signed_block_cls(ForkName.DENEB)(
        message=block, signature=bls.SecretKey(
            GEN_SK0 + GEN_SK_STEP * proposer).sign(
            compute_signing_root(block, domain)).serialize())
    check(bytes(block.parent_root) == anchor.message.tree_hash_root(),
          "16(d): the block's parent root != the Deneb anchor's root")
    check(ctx["parent"].tree_hash_root() == capella_root,
          "16(d): the upgrade changed 13(b)'s Capella parent")
    cache = ctx["pubkey_cache"]
    for v in signers | {proposer}:
        if v not in cache._by_index:
            cache._by_index[v] = bls.PublicKey(keys[v])
    print(f"16(d) set-up (host): 13(b)'s anchor upgraded to Deneb at epoch "
          f"{IMPORT_EPOCH} and the block at slot {slot} "
          f"({len(block.body.attestations)} aggregates, sync {n_sync}/"
          f"{len(ctx['sync'])}, {len(cms)} blob commitments) with its state "
          f"root on the host oracle in {time.perf_counter() - t0:.1f} s; the "
          f"fresh registry's pubkey map built in {map_ms:.1f} ms")
    return {"parent": parent, "anchor": anchor, "block": sb, "spec": spec,
            "slot": slot, "pubkey_cache": cache, "preset": preset, "T": T,
            "pubkey_map_ms": map_ms}


def phase_kzg_gate(torch, hw: dict, setup, sb, sidecars, pfs) -> dict:
    """16(c): ``DataAvailabilityChecker.put_sidecars`` on the block's six
    sidecars and ``put_sidecar`` on one (the gossip shape), each timed on
    a fresh checker; a tampered inclusion proof and a wrong KZG proof
    raise ``BlobSidecarError``."""
    from lighthouse_tpu_torch.beacon_chain import (BlobSidecarError,
                                                   DataAvailabilityChecker)
    from lighthouse_tpu_torch.types import MAINNET
    from lighthouse_tpu_torch.types.factory import spec_types
    T = spec_types(MAINNET)

    def checker():
        return DataAvailabilityChecker(MAINNET, T, setup=setup)

    checker().put_sidecars(sidecars)                    # warm
    da = checker()
    _, six_ms = timed(torch, lambda: da.put_sidecars(sidecars))
    root = sb.message.tree_hash_root()
    check(da.missing_indices(sb, root) == [],
          "16(c): put_sidecars left the block's blobs missing")
    one = checker()
    _, one_ms = timed(torch, lambda: one.put_sidecar(sidecars[0]))
    check(one.missing_indices(sb, root) == list(range(1, len(sidecars))),
          "16(c): put_sidecar did not cache its sidecar")
    refused = []
    for kind in ("inclusion proof", "KZG proof"):
        bad = T.BlobSidecar.deserialize(T.BlobSidecar.serialize(sidecars[1]))
        if kind == "inclusion proof":
            bad.kzg_commitment_inclusion_proof[3] = b"\x5a" * 32
        else:
            bad.kzg_proof = pfs[2]
        try:
            checker().put_sidecar(bad)
        except BlobSidecarError as e:
            refused.append(f"{kind}: {e}")
            continue
        fail(f"16(c): a sidecar with a wrong {kind} was accepted")
    print(f"16(c) the availability gate at mainnet width: put_sidecars of "
          f"{len(sidecars)} {six_ms:.1f} ms, put_sidecar of one "
          f"{one_ms:.1f} ms; refused: {'; '.join(refused)} [{hw['card']}]")
    return {"put_sidecars_ms": six_ms, "put_sidecar_ms": one_ms}


def phase_kzg_import(torch, hw: dict, dctx: dict, sidecars, imp) -> dict:
    """16(d): the Deneb block at 2^20 through ``BeaconChain.process_block``
    on chains booted from the Deneb checkpoint, the counted (cold) run and
    a warm one: BlobsUnavailable without sidecars, then ``put_sidecars``
    and the retry imports; the head, the post-state root (the host
    oracle's), the six sidecars from the store byte for byte, every
    kernel of the path launched in the counted run."""
    from lighthouse_tpu_torch.beacon_chain import BlobsUnavailable
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.common.tracing import TRACER
    from lighthouse_tpu_torch.state_transition import per_block as PB
    from lighthouse_tpu_torch.types.device_state import (is_materialized,
                                                         materialize_state)

    parent, sb, slot = dctx["parent"], dctx["block"], dctx["slot"]
    parent_root = parent.tree_hash_root()
    block_root = sb.message.tree_hash_root()

    def gated_then_imported():
        """On a chain built anew from the checkpoint: the import refused
        for its blobs, ``put_sidecars``, the retry; each timed."""
        c = checkpoint_chain(parent, dctx["anchor"], dctx["preset"],
                             dctx["spec"], dctx["T"], dctx["pubkey_cache"])
        c.fork_choice.on_tick(slot)
        TRACER.reset()
        TRACER.set_slot(slot)
        t0 = time.perf_counter()
        try:
            c.process_block(sb, is_timely=True)
        except BlobsUnavailable:
            pass
        else:
            fail("16(d): the block imported without its sidecars")
        torch.cuda.synchronize()
        gated = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                 **span_split(TRACER, slot, IMPORT_SPANS),
                 "chain": span_split(TRACER, slot, CHAIN_SPANS),
                 "block_phases": dict(PB.LAST_BLOCK_TIMINGS)}
        _, put_ms = timed(torch, lambda: c.data_availability.put_sidecars(
            sidecars))
        root, retry = timed_import(torch, c, sb)
        check(root == block_root and c.head.root == block_root
              and c.head.slot == slot, "16(d): the head is not the block")
        return c, {"gated_import": gated, "put_sidecars_ms": put_ms,
                   "retry_import": {k: v for k, v in retry.items()
                                    if k not in ("sig", "block_phases",
                                                 "ledger")}}

    TRACER.enable()
    try:
        zero_all_launches()
        ledger0 = LEDGER.transfer_totals()
        check(materialize_state(parent), "16(d): materialize refused")
        check(type(parent).hash_tree_root(parent) == parent.tree_hash_root()
              == parent_root, "16(d): the Deneb anchor's device root != its "
                              "uncached root")
        c, cold = gated_then_imported()
        launched = all_launches()
        moved = ledger_moved(LEDGER, ledger0)
        post = c.state_at_block_root(block_root)
        check(is_materialized(post), "16(d): the post-state left the device")
        check(post.tree_hash_root() == bytes(sb.message.state_root),
              "16(d): post-state root != the host oracle's")
        stored = c.store.get_blob_sidecars(block_root)
        check([type(x).serialize(x) for x in stored]
              == [type(x).serialize(x) for x in sidecars],
              "16(d): the store's sidecars != the six sidecars")
        del c, post
        c, warm = gated_then_imported()
        del c
    finally:
        TRACER.disable()
    check(parent.tree_hash_root() == parent_root,
          "16(d): the import changed the anchor state (copy-on-write)")
    missing = [k for k in IMPORT_PATH_KERNELS + ("kzg_eval",)
               if launched[k] == 0]
    check(not missing, f"16(d): kernels of the path never launched: "
                       f"{missing} ({launched})")
    out = {"cold": cold, "warm": warm, "launches": launched,
           "ledger": {"h2d": moved["h2d"], "d2h": moved["d2h"]},
           "pubkey_map_ms": dctx["pubkey_map_ms"],
           "capella_13b": {"cold_import_ms": imp["cold_import_ms"],
                           "warm_median_ms": imp["stages_ms"],
                           "block_phases_ms": imp["block_phases_ms"]}}
    print("16(d) the state transition's split, warm, Deneb beside 13(b)'s "
          "Capella: " + json.dumps({
              k: [warm["gated_import"]["block_phases"].get(k),
                  imp["block_phases_ms"].get(k)]
              for k in imp["block_phases_ms"]}) + f" [{hw['card']}]")
    print(f"16(d) a MAINNET Deneb block with {len(sidecars)} blobs at 2^20 "
          f"validators through BeaconChain, on two chains built anew from "
          f"the checkpoint (cold: the counted run, launches and bytes from "
          f"the anchor's materialize on; warm): BlobsUnavailable before its "
          f"sidecars, then put_sidecars and the retry imported it as the "
          f"head, its root the host oracle's, its sidecars read back byte "
          f"for byte: {json.dumps(out)} [{hw['card']}]")
    return out


def phase_kzg(torch, hw: dict, ctx: dict, keys, imp: dict,
              kernel_ms: dict) -> dict:
    """Phase 16 (a)–(d) at mainnet width: six blobs of 4096 from
    ``random.Random(0)`` (``bench.py:1371-1405``) under
    ``verification_setup(4096)``, their commitments and proofs made once
    with the known-τ paths in spawned host workers, which also run the
    host oracle and the host fold while the card works."""
    import random
    from multiprocessing import get_context

    from lighthouse_tpu_torch.beacon_chain import build_blob_sidecars
    from lighthouse_tpu_torch.kzg import device as KD
    from lighthouse_tpu_torch.kzg import kzg as K
    from lighthouse_tpu_torch.kzg.fr import BLS_MODULUS as N

    t0 = time.perf_counter()
    setup = kzg_setup()
    rng = random.Random(0)
    blobs = [K.polynomial_to_blob([rng.randrange(N) for _ in range(KZG_WIDTH)])
             for _ in range(KZG_BLOBS)]
    workers = min(KZG_BLOBS + 1, os.cpu_count() or 1)
    with get_context("spawn").Pool(workers, kzg_worker_init) as pool:
        made = pool.map(kzg_commit_prove, blobs + [bytes(32 * KZG_WIDTH)])
        cms, pfs = [m[0] for m in made[:-1]], [m[1] for m in made[:-1]]
        zs = [K.compute_challenge(b, c, KZG_WIDTH) for b, c in zip(blobs, cms)]
        print(f"16 set-up: {KZG_BLOBS} blobs of {KZG_WIDTH}, commitments and "
              f"proofs by the known-τ paths in {workers} host workers in "
              f"{time.perf_counter() - t0:.1f} s")
        oracle = pool.map_async(kzg_oracle_eval, list(zip(blobs, zs)))
        kern = phase_kzg_kernel(torch, hw, KD, setup, blobs, zs, oracle)
        batches = kzg_batches(blobs, cms, pfs, made[-1])
        host = pool.map_async(kzg_host_verdict,
                              [a for a, _ in batches.values()])
        kernel_ms = {**kernel_ms, "kzg_eval": kern["timing"]["ms"]}
        ver = phase_kzg_verify(torch, hw, KD, setup, batches, host, kernel_ms)
    dctx = build_deneb_import(ctx, keys, cms)
    sidecars = build_blob_sidecars(dctx["block"], blobs, setup, ctx["preset"],
                                   ctx["T"], proofs=pfs)
    gate = phase_kzg_gate(torch, hw, setup, dctx["block"], sidecars, pfs)
    dimp = phase_kzg_import(torch, hw, dctx, sidecars, imp)
    return {"kernel": kern, "verify": ver, "gate": gate, "import": dimp,
            "launches_kzg": ver["launches"]}


def phase_fork_crossing(torch, hw: dict) -> dict:
    """16(e): a MINIMAL chain at 64 validators with ``deneb_fork_epoch``
    1 and real signatures, built by the port's harness on the host oracle,
    blocks after the fork carrying 1–2 blobs of width 4 (``embedded_
    setup(4)``) with their sidecars inline; through a port chain on the
    card (device-resident genesis, every BLS batch and KZG batch on the
    card) and a port chain on the CPU (fake BLS, host fold): every head
    and post-state equal."""
    import random
    from dataclasses import replace

    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.beacon_chain import build_blob_sidecars
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.kzg import kzg as K
    from lighthouse_tpu_torch.kzg.fr import BLS_MODULUS as N
    from lighthouse_tpu_torch.kzg.trusted_setup import embedded_setup
    from lighthouse_tpu_torch.state_transition import SignatureStrategy
    from lighthouse_tpu_torch.testing import StateHarness
    from lighthouse_tpu_torch.types import ChainSpec, ForkName
    from lighthouse_tpu_torch.types.device_state import materialize_state

    spec = replace(ChainSpec.minimal().with_forks_at_genesis(
        ForkName.CAPELLA), deneb_fork_epoch=FORK_SMALL_EPOCH)
    setup = embedded_setup(4)
    rng = random.Random(SEED + 16)
    t0 = time.perf_counter()
    os.environ["LIGHTHOUSE_TPU_DEVICE_STATE"] = "0"
    try:
        h = StateHarness(FORK_SMALL_VALIDATORS, spec=spec)
        genesis = h.state.copy()
        steps = []
        for slot in range(1, FORK_SMALL_SLOTS + 1):
            blobs = []
            if h.fork_at(slot) >= ForkName.DENEB and slot % 3:
                blobs = [K.polynomial_to_blob([rng.randrange(N)
                                               for _ in range(4)])
                         for _ in range(1 + slot % 2)]
            cms = [K.blob_to_kzg_commitment(b, setup) for b in blobs]
            sb = h.build_block(slot, blob_kzg_commitments=cms)
            h.apply_block(sb, strategy=SignatureStrategy.NO_VERIFICATION)
            steps.append((slot, sb, build_blob_sidecars(
                sb, blobs, setup, h.preset, h.T) if blobs else None))
    finally:
        os.environ.pop("LIGHTHOUSE_TPU_DEVICE_STATE", None)
    check(h.fork_at(FORK_SMALL_SLOTS) == ForkName.DENEB
          and type(h.state).__name__.endswith("Deneb"),
          "16(e): the harness chain did not cross into Deneb")
    n_blobs = sum(len(s[2]) for s in steps if s[2])
    build_s = time.perf_counter() - t0

    def run(chain):
        out = []
        for slot, sb, sidecars in steps:
            chain.per_slot_task(slot)
            root = chain.process_block(sb, is_timely=True,
                                       blob_sidecars=sidecars)
            st = chain.head.state
            out.append((root, chain.head.root, chain.head.slot,
                        type(st).__name__, type(st).serialize(st),
                        len(chain.store.get_blob_sidecars(root))))
        return out

    prev = (device.default_device(), bls._active)
    device.set_default_device("cpu")
    bls.set_backend("fake")
    try:
        state = type(genesis).deserialize(type(genesis).serialize(genesis))
        want = run(genesis_chain(state, h.preset, spec, h.T))
    finally:
        device.set_default_device(prev[0])
        bls._active = prev[1]
    os.environ["LIGHTHOUSE_TPU_HOST_FASTPATH_MAX"] = "0"
    try:
        anchor = genesis.copy()
        check(materialize_state(anchor), "16(e): materialize refused")
        chain = genesis_chain(anchor, h.preset, spec, h.T)
        zero_all_launches()
        t1 = time.perf_counter()
        got = run(chain)
        ms = (time.perf_counter() - t1) * 1e3
        launched = all_launches()
    finally:
        os.environ.pop("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX", None)
    for i, (g, w) in enumerate(zip(got, want)):
        check(g == w, f"16(e): step {i} (slot {steps[i][0]}, {w[3]}) on the "
                      f"card != the CPU chain's")
    check(len(got) == len(want) and got[-1][3].endswith("Deneb")
          and got[0][3].endswith("Capella"),
          "16(e): the chains did not cross the fork")
    check(launched["kzg_eval"] > 0 and launched["miller_fold"] > 0
          and launched["finalize"] > 0,
          f"16(e): the card's KZG route did not run: {launched}")
    print(f"16(e) the fork crossing at {FORK_SMALL_VALIDATORS} validators: "
          f"{len(steps)} blocks (Capella to slot "
          f"{spec.deneb_fork_epoch * h.preset.SLOTS_PER_EPOCH - 1}, then "
          f"Deneb with {n_blobs} blobs of width 4 in their sidecars) built "
          f"in {build_s:.1f} s; on the card {ms:.0f} ms, every head and "
          f"post-state equal to the CPU chain's; launches {launched} "
          f"[{hw['card']}]")
    return {"ms": ms, "launches": launched}


def main() -> None:
    if sys.argv[1:2] == ["--race-child"]:
        race_child(sys.argv[2])
        return
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.ops import cuda_build
    from lighthouse_tpu_torch.ops import merkle_kernel as mk

    device.set_default_device("cuda")
    t_start = time.perf_counter()

    def lap(phases: str) -> None:
        print(f"[phases {phases} done at "
              f"{time.perf_counter() - t_start:.1f} s]", flush=True)

    from lighthouse_tpu_torch.crypto import bls, fields as F
    from lighthouse_tpu_torch.crypto import pairing_kernel as pk
    hw = phase_build(torch, mk, pk, cuda_build)
    kern = phase_kernels(torch, mk, hw)
    state = phase_state_root(torch, hw)
    lap("1-4")

    t0 = time.perf_counter()
    brng = np.random.default_rng(SEED)
    sets = build_bls_batch(bls, F, brng)
    srng = np.random.default_rng(SEED + 2)

    def rand_fn():
        return int(srng.integers(1, 2 ** 64, dtype=np.uint64))

    print(f"BLS set-up (host, pure Python): {BLS_KEYS} keys and "
          f"{BLS_MSGS} signatures in {time.perf_counter() - t0:.1f} s")
    bk = phase_bls_kernels(torch, hw, sets, rand_fn)
    bv = phase_bls_verify(torch, hw, sets, rand_fn,
                          {k: t["ms"] for k, t in bk["timing"].items()})
    lap("5-6")

    from lighthouse_tpu_torch.crypto import curve as C
    from lighthouse_tpu_torch.crypto import hash_to_curve as H2C
    t0 = time.perf_counter()
    n_keys = GEN_SETS * GEN_KEYS + BLOCK_AGGREGATES * COMMITTEE
    # phase 13(b)'s registry takes the same keys: derive them once
    all_keys = derive_g1_keys(F, C, GEN_SK0, GEN_SK_STEP,
                              max(n_keys, 1 << IMPORT_LOG2_VALIDATORS))
    keys = all_keys[:n_keys]
    for v in (0, 1, 12345, n_keys - 1, len(all_keys) - 1):
        check(all_keys[v] == C.g1_mul(C.G1_GEN, GEN_SK0 + GEN_SK_STEP * v),
              f"derived key {v} != [sk]G")
    t_keys = time.perf_counter() - t0
    gsets = build_general_batch(bls, C, H2C, F, keys)
    t_gen = time.perf_counter() - t0 - t_keys
    block = build_block_batch(bls, C, H2C, F, keys,
                              np.random.default_rng(SEED + 6))
    print(f"general-path set-up (host, pure Python): {len(all_keys)} G1 "
          f"keys ({n_keys} for phases 7-11, all for phase 13) in "
          f"{t_keys:.1f} s, {GEN_SETS} signatures in {t_gen:.1f} s, the "
          f"block's {len(block[0])} sets in "
          f"{time.perf_counter() - t0 - t_keys - t_gen:.1f} s")
    grng = np.random.default_rng(SEED + 5)

    def grand():
        return int(grng.integers(1, 2 ** 64, dtype=np.uint64))

    gk = phase_general_kernels(torch, hw, gsets, grand)
    gv = phase_general_verify(torch, hw, gsets, grand, {
        **{k: t["ms"] for k, t in bk["timing"].items()},
        **{k: t["ms"] for k, t in gk["timing"].items()}})
    blk = phase_block_verify(torch, hw, block, grand)
    pf = phase_profiles(torch, hw)
    phase_crossover(torch, hw, gsets, grand)
    phase_proof_engine(torch, hw, state.pop("state"))
    lap("7-12")
    phase_import_minimal(torch, hw)
    lap("13(a)")
    imp, ctx = phase_import_mainnet(torch, hw, all_keys, {
        **{k: t["ms"] for k, t in bk["timing"].items()},
        **{k: t["ms"] for k, t in gk["timing"].items()}})
    lap("13(b)")
    phase_fork_choice(torch, hw)
    lap("14")
    phase_produce_minimal(torch, hw)
    production = phase_produce_mainnet(torch, hw, ctx)
    kz = phase_kzg(torch, hw, ctx, all_keys, imp, {
        k: t["ms"] for k, t in bk["timing"].items()})
    del ctx, all_keys
    lap("15(a)-(b), 16(a)-(d)")
    phase_pack_baseline(torch, hw)
    lap("15(c)")
    phase_fork_crossing(torch, hw)
    lap("16(e)")
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    print("device ledger: " + json.dumps(LEDGER.snapshot()))

    replaces = {"hash64": "lighthouse_tpu/ops/merkle_kernel.py:192",
                "subtree": "lighthouse_tpu/ops/merkle_kernel.py:159",
                "hash_g2": "lighthouse_tpu/crypto/htc_kernel.py:285",
                "sigma": "lighthouse_tpu/crypto/pairing_kernel.py:1001",
                "miller_fold": "lighthouse_tpu/crypto/pairing_kernel.py:938",
                "finalize": "lighthouse_tpu/crypto/pairing_kernel.py:1165",
                "prepare": "lighthouse_tpu/crypto/pairing_kernel.py:1240",
                "product_chunks":
                    "lighthouse_tpu/crypto/pairing_kernel.py:877",
                "miller": "lighthouse_tpu/crypto/pairing_kernel.py:781",
                "product": "lighthouse_tpu/crypto/pairing_kernel.py:843",
                "sigma_combine":
                    "lighthouse_tpu/crypto/pairing_kernel.py:1021",
                "kzg_eval": "lighthouse_tpu/kzg/device.py:81"}
    kernels = []

    def launch_keys(info):
        return {f"{k}_launch": info[k]
                for k in ("G", "groups", "registers", "local_bytes")}

    def row(name, source, launches, err, t):
        out = {"name": name, "route": "cuda",
               "source": f"lighthouse_tpu_torch/csrc/{source}",
               "replaces": replaces[name], "launches": launches,
               "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": None,
               "launches_import": imp["launches_per_import"].get(name, 0),
               "launches_production":
                   production["launches_production"].get(name, 0),
               "launches_kzg": kz["launches_kzg"].get(name, 0)}
        if "chain_bound_ms" in t:      # a single dependent chain
            out.update({k: t[k] for k in ("chain_bound_ms", "chain_products",
                                          "rate_bound_ms", "binds")})
        kernels.append(out)

    for name in ("hash64", "subtree"):
        row(name, "sha256_merkle.cu", state["launches"][name],
            kern["errs"][name], kern["timing"][name])
    general_errs = {**gk["errs"], "finalize": gk["errs"]["finalize_wide"]}
    general_errs["miller_fold"] = max(general_errs["miller_fold"],
                                      blk["miller_err"])
    general_errs["prepare"] = max(general_errs["prepare"], blk["prepare_err"])
    for name in ("hash_g2", "sigma", "miller_fold", "finalize"):
        row(name, "bls381.cu", bv["launches"][name],
            max(bk["errs"][name], general_errs[name]), bk["timing"][name])
        if name in ("hash_g2", "sigma", "miller_fold"):   # the general shape
            g = gk["timing"][name]
            kernels[-1].update(
                ms_general=g["ms"], shape_general=g["shape"],
                rate_bound_ms_general=g["bound_ms"],
                chain_bound_ms_general=g["chain_bound_ms"],
                binds_general=g["binds"], plain_ms_general=g["plain_ms"],
                **launch_keys(bk["groups"][name]))
    row("sigma_combine", "bls381.cu", gv["launches"]["sigma_combine"],
        max(bk["errs"]["sigma_combine"], gk["errs"]["sigma_combine"]),
        gk["timing"]["sigma_combine"])
    launches = {"prepare": gv["launches"]["prepare"],
                "product_chunks": gv["launches"]["product_chunks"],
                **pf["launches"]}
    for name in ("prepare", "product_chunks", "miller", "product"):
        row(name, "bls381.cu", launches[name], general_errs[name],
            gk["timing"][name])
        if name in ("product_chunks", "miller", "product"):
            t = gk["timing"][name]
            kernels[-1].update(**{k: t[k] for k in ("ms_by_lanes", "ms_paced")
                                  if k in t},
                               **launch_keys(bk["groups"][name]))
        if name == "prepare":           # the block batch's two work items
            kernels[-1].update(
                ms_block=[t["ms"] for t in blk["prepare_block"]],
                K_block=[t["K"] for t in blk["prepare_block"]],
                chain_bound_ms_block=[t["chain_bound_ms"]
                                      for t in blk["prepare_block"]],
                **launch_keys(bk["groups"][name]))
    row("kzg_eval", "kzg_fr.cu", kz["launches_kzg"]["kzg_eval"],
        kz["kernel"]["err"], kz["kernel"]["timing"])
    kernels[-1]["shape"] = kz["kernel"]["timing"]["shape"]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(hw["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
