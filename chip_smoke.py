#!/usr/bin/env python3
"""Drive the PyTorch port (lighthouse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. Print the card (``nvidia-smi`` name and power limit) and the torch /
   CUDA versions; build the CUDA kernels from ``lighthouse_tpu_torch/
   csrc`` and count their SASS instructions.
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
   Each kernel's launch counter is zeroed just before this phase and
   must be > 0 just after it.
4. Where the time goes: the clean, warm (1%) and uncached roots once
   more under ``torch.profiler`` (device busy time and idle share, top
   device and host ops) and once under cProfile (top Python functions).
5. The BLS kernels (``csrc/bls381.cu``) against their plain PyTorch
   versions on the card, at the shared verify path's shapes: hash-to-G2
   on 2 cells (512 u lanes), sigma on 2 chunks (the path's signature
   columns, and random live/dead lanes with an all-dead chunk), Miller+
   fold on one 256-lane cell with every lane live and with the path's 2
   live lanes, finalize on a product that is 1 and on one that is not.
   Outputs agree after canonical reduction (x mod p) and the verdict
   exactly; 4 hash columns match the host ``hash_to_g2``.  Each kernel
   is timed with CUDA events beside its plain version and its bound.
6. ``verify_signature_sets`` of the port's default (``tpu``) backend on the
   sync-committee shape (512 shared keys × 256 messages, built like
   ``bench.py``): the valid batch verifies, a swapped signature and an
   altered message fail.  The BLS launch counters are zeroed just before
   and must be > 0 just after; the wall time, the stage split and the
   device idle share are printed.

The line before the last is one JSON object with each kernel's launches,
error, time, plain-version time and bound; the last line is
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
    card = smi("name,power.limit")
    print(f"card: {card}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  python "
          f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = cuda_build.build_all(["sha256_merkle", "bls381"])  # 2 nvcc at once
    mk.kernel_library()
    pk.kernel_library()
    print(f"kernel builds: {time.perf_counter() - t0:.1f} s wall, both "
          f"nvcc started together")
    sass = {}
    for lib in ("sha256_merkle", "bls381"):
        took, ptxas = built.get(lib, (0.0, ""))
        path = cuda_build.build_info(lib)["path"]
        print(f"  {lib}: {took:.1f} s nvcc -> {path}")
        for line in ptxas.splitlines():
            if any(k in line for k in ("registers", "spill", "stack",
                                       "Compiling")):
                print(f"    ptxas: {line.strip()}")
        sass.update(sass_instruction_counts(path))
    print(f"SASS instructions (non-NOP): {json.dumps(sass)}")
    check("lh_hash64_kernel" in sass and sass["lh_hash64_kernel"] > 1000,
          f"cannot read the hash64 kernel's SASS: {sass}")
    mul_fns = [k for k in sass if "fp_mul" in k and not k.startswith("lh_")]
    instr_per_mont = (sass[mul_fns[0]] if mul_fns
                      else sass.get("lh_fp_mul_kernel", 0))
    check(instr_per_mont > 100,
          f"cannot price a Montgomery product from SASS: {sass}")
    print(f"SASS instructions per Montgomery product: {instr_per_mont} "
          f"({mul_fns[0] if mul_fns else 'lh_fp_mul_kernel'})")
    clk_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"max SM clock {clk_mhz:.0f} MHz, {sms} SMs")
    return {"card": card, "instr_per_hash": sass["lh_hash64_kernel"],
            "instr_per_mont": instr_per_mont,
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


def registry_root_hashlib(reg, limit: int) -> bytes:
    """The SSZ registry root from the raw columns by hashlib alone: record
    mini-trees (pubkey pre-hash, 3 levels), the record-root tree, zero
    caps to the limit, the length mixin."""
    n = len(reg)

    def u64_chunks(col):
        out = np.zeros((n, 32), np.uint8)
        out[:, :8] = np.ascontiguousarray(col[:n], dtype="<u8").view(
            np.uint8).reshape(n, 8)
        return out

    pk = np.zeros((n, 64), np.uint8)
    pk[:, :48] = reg.col("pubkey")
    slashed = np.zeros((n, 32), np.uint8)
    slashed[:, 0] = reg.col("slashed")
    leaves = np.stack([
        _hash_rows(pk), reg.col("withdrawal_credentials"),
        u64_chunks(reg.col("effective_balance")), slashed,
        u64_chunks(reg.col("activation_eligibility_epoch")),
        u64_chunks(reg.col("activation_epoch")),
        u64_chunks(reg.col("exit_epoch")),
        u64_chunks(reg.col("withdrawable_epoch"))], axis=1)  # (n, 8, 32)
    level = leaves.reshape(-1, 64)
    for _ in range(3):
        level = _hash_rows(level)
        level = level.reshape(-1, 64) if level.shape[0] > n else level
    w = 1 << (n - 1).bit_length()
    nodes = np.zeros((w, 32), np.uint8)
    nodes[:n] = level
    zero = [b"\x00" * 32]
    depth = (limit - 1).bit_length()
    for _ in range(depth):
        zero.append(hashlib.sha256(zero[-1] * 2).digest())
    lvl = 0
    while nodes.shape[0] > 1:
        nodes = _hash_rows(nodes.reshape(-1, 64))
        lvl += 1
    root = nodes[0].tobytes()
    while lvl < depth:
        root = hashlib.sha256(root + zero[lvl]).digest()
        lvl += 1
    return hashlib.sha256(root + n.to_bytes(32, "little")).digest()


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_state_root(torch, hw: dict) -> dict:
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.ops import merkle_kernel as mk
    from lighthouse_tpu_torch.types import ForkName, MAINNET, spec_types
    from lighthouse_tpu_torch.types.device_state import materialize_state
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
    r_host, host_ms = timed(torch, host_state.tree_hash_root)
    per_path["host_cached_cold"] = launches_since(before)
    del os.environ["LIGHTHOUSE_TPU_DEVICE_STATE"]
    check(r_host == r_unc, "host-cached root != uncached root")
    print(f"host-cached cold root: {host_ms:.1f} ms, matches; launches "
          f"{per_path['host_cached_cold']}")
    del host_state

    before = dict(mk.LAUNCHES)
    device.reset_transfer_counters()
    _, mat_ms = timed(torch, lambda: check(materialize_state(state),
                                           "materialize_state refused"))
    mat_bytes = device.transfer_totals()["h2d"]
    clean = [timed(torch, state.tree_hash_root) for _ in range(3)]
    per_path["materialize"] = launches_since(before)
    check(all(r == r_unc for r, _ms in clean),
          "materialized root != uncached root")
    clean_ms = [ms for _r, ms in clean]
    print(f"materialize: {mat_ms:.1f} ms cold, {mat_bytes} B host->device; "
          f"clean roots ms {[round(ms, 2) for ms in clean_ms]}; match; "
          f"launches {per_path['materialize']}")

    warm = {}
    for frac in (0.001, 0.01):
        k = int(n * frac)
        rows = []
        for rep in range(3):
            idx = np.sort(rng.choice(n, k, replace=False))
            reg = state.validators
            reg.wcol("effective_balance")[idx] = (
                rng.integers(16, 33, k) * 10 ** 9).astype(np.uint64)
            state.balances[idx] = rng.integers(
                16 * 10 ** 9, 33 * 10 ** 9, k).astype(np.uint64)
            before = dict(mk.LAUNCHES)
            device.reset_transfer_counters()
            r_warm, warm_ms = timed(torch, state.tree_hash_root)
            moved = device.transfer_totals()
            launched = launches_since(before)
            r_fresh = uncached(state)
            check(r_warm == r_fresh,
                  f"warm root != fresh uncached root at {frac:.1%} rep {rep}")
            rows.append({"ms": warm_ms, "h2d": moved["h2d"],
                         "d2h": moved["d2h"], "launches": launched})
        warm[frac] = rows
        per_path[f"warm_{frac:.1%}"] = rows[-1]["launches"]
        print(f"warm root, {k} dirty records + {k} balances "
              f"({frac:.1%}): ms {[round(r['ms'], 2) for r in rows]} "
              f"(median {statistics.median(r['ms'] for r in rows):.2f}); "
              f"h2d B/root {[r['h2d'] for r in rows]}; d2h B/root "
              f"{[r['d2h'] for r in rows]}; launches/root "
              f"{rows[-1]['launches']}; each == fresh uncached root")

    launches = dict(mk.LAUNCHES)
    print(f"main-path launches: {launches} [{hw['card']}]")
    for name, count in launches.items():
        check(count > 0, f"the main path never launched the {name} kernel")

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
            "clean_ms": clean_ms, "warm": warm}


# ---------------------------------------------------------------------------
# Phase 4: where the time goes (after the launch counts are read)
# ---------------------------------------------------------------------------

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
        events = prof.key_averages()
        dev = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in events if e.self_device_time_total > 0),
                     reverse=True)
        busy_ms = sum(d for d, _c, _k in dev) / 1e3
        host = sorted(((e.self_cpu_time_total, e.count, e.key)
                       for e in events), reverse=True)[:6]
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


def canonical_err(got, want) -> int:
    """Largest |a − b| over elements after canonical reduction (0 when the
    kernel and the plain version agree)."""
    check(tuple(got.shape) == tuple(want.shape),
          f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    a, b = canonical_blocks(got), canonical_blocks(want)
    return max(abs(int(x) - int(y)) for x, y in zip(a.flat, b.flat))


def mont_bound_ms(hw: dict, products: int) -> float:
    """Least time for ``products`` Montgomery products: their SASS
    instructions over the card's INT32 issue rate."""
    return products * hw["instr_per_mont"] / (
        INT32_LANES_PER_SM * hw["sms"] * hw["clk_hz"]) * 1e3


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

    def record(name, kern, plain, products, shape, note=""):
        k_ms = cuda_ms(torch, kern, BLS_TIMED_RUNS)
        p_ms = cuda_ms(torch, plain, 1)
        b_ms = mont_bound_ms(hw, products)
        timing[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": "operations", "products": products}
        print(f"{name}: {k_ms:.3f} ms kernel (median of {BLS_TIMED_RUNS}), "
              f"{p_ms:.1f} ms plain, bound {b_ms:.4f} ms ({products} "
              f"Montgomery products × {hw['instr_per_mont']} instr){note} "
              f"-> {100 * b_ms / k_ms:.2f}% of bound, {shape} "
              f"[{hw['card']}]")

    # hash to G2: 2 cells, the path's 256 messages
    h_k = HK.hash_g2_kernel_call(u)
    h_p = HK.hash_g2_plain(u)
    errs["hash_g2"] = canonical_err(h_k, h_p)
    check(errs["hash_g2"] == 0, "hash_g2 kernel != plain")
    cols = canonical_blocks(h_k)
    for j in rng.choice(len(entries), 4, replace=False):
        want = H2C.hash_to_g2(entries[j][2])
        got = ((cols[0, j] * LF.RINV_INT % F.P, cols[1, j] * LF.RINV_INT
                % F.P), (cols[2, j] * LF.RINV_INT % F.P,
                         cols[3, j] * LF.RINV_INT % F.P))
        check(got == want, f"hash_g2 column {j} != host hash_to_g2")
    record("hash_g2", lambda: HK.hash_g2_kernel_call(u),
           lambda: HK.hash_g2_plain(u),
           plain_products(PK, lambda: HK.hash_g2_plain(u)),
           f"u {tuple(u.shape)}")

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
        err = max(err, canonical_err(PK.sigma_kernel_call(*args),
                                     PK.sigma_plain(*args)))
    errs["sigma"] = err
    check(err == 0, "sigma kernel != plain")
    record("sigma", lambda: PK.sigma_kernel_call(sig_cols, smask, lo_d, hi_d),
           lambda: PK.sigma_plain(sig_cols, smask, lo_d, hi_d),
           plain_products(PK, lambda: PK.sigma_plain(sig_cols, smask, lo_d,
                                                     hi_d)),
           f"sig {tuple(sig_cols.shape)}, the path's columns")

    # the path's Miller cell, then one with every lane live
    h_col, h_id = PK.sigma_combine(PK.sigma_kernel_call(h_k, live, lo_d,
                                                        hi_d))
    s_col, s_id = PK.sigma_combine(PK.sigma_kernel_call(sig_cols, smask,
                                                        lo_d, hi_d))
    g2 = torch.zeros((128, 2 * S), dtype=torch.int32, device=dev)
    g2[:, 0], g2[:, 1] = h_col, s_col
    mask = torch.zeros((1, 2 * S), dtype=torch.int32, device=dev)
    mask[0, 0] = (~h_id).to(torch.int32)
    mask[0, 1] = (~s_id).to(torch.int32)
    prod = PK.miller_fold_kernel_call(pk_col, g2, mask)
    err = canonical_err(prod, PK.miller_fold_plain(pk_col, g2, mask))
    rg1, rg2 = rand_planes(torch, rng, F, LF, 2, 2 * S), \
        rand_planes(torch, rng, F, LF, 4, 2 * S)
    ones = torch.ones((1, 2 * S), dtype=torch.int32, device=dev)
    err = max(err, canonical_err(PK.miller_fold_kernel_call(rg1, rg2, ones),
                                 PK.miller_fold_plain(rg1, rg2, ones)))
    errs["miller_fold"] = err
    check(err == 0, "miller_fold kernel != plain")
    record("miller_fold", lambda: PK.miller_fold_kernel_call(pk_col, g2, mask),
           lambda: PK.miller_fold_plain(pk_col, g2, mask),
           plain_products(PK, lambda: PK.miller_fold_plain(pk_col, g2, mask)),
           "one 256-lane cell, the path's 2 live lanes")
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
    err = canonical_err(g_k, g_p)
    rf = rand_planes(torch, rng, F, LF, 12, S)
    ok_k, g_k = PK.finalize_kernel_call(rf, with_value=True)
    ok_p, g_p = PK.finalize_plain(rf, with_value=True)
    check(int(ok_k.item()) == 0 and int(ok_p.item()) == 0,
          "finalize of a random block claims == 1")
    errs["finalize"] = max(err, canonical_err(g_k, g_p))
    check(errs["finalize"] == 0, "finalize kernel != plain")
    record("finalize", lambda: PK.finalize_kernel_call(prod),
           lambda: PK.finalize_plain(prod),
           plain_products(PK, lambda: PK.finalize_plain(prod)),
           "(384, 128)", note="; one serial chain (one thread), so the "
           "rate bound is far below its latency")
    print(f"BLS kernels vs plain on the card: equal after canonical "
          f"reduction {errs}; finalize verdicts exact; 4 hash columns "
          f"match the host hash_to_g2")
    return {"errs": errs, "timing": timing}


# ---------------------------------------------------------------------------
# Phase 6: verify_signature_sets at 512 keys × 256 messages
# ---------------------------------------------------------------------------

def phase_bls_verify(torch, hw: dict, sets, rand_fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

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
    launches = {**HK.LAUNCHES, **PK.LAUNCHES}
    print(f"verify main-path launches: {launches} [{hw['card']}]")
    for name, count in launches.items():
        check(count > 0, f"the verify path never launched the {name} kernel")
    print(f"verify 512 keys × 256 messages: valid True ({ms:.1f} ms cold), "
          f"swapped signature False, altered message False")

    walls = [timed(torch, lambda: backend.verify_signature_sets(
        sets, rand_fn=rand_fn))[1] for _ in range(VERIFY_RUNS)]
    print(f"verify wall ms {[round(w, 1) for w in walls]} median "
          f"{statistics.median(walls):.1f} [{hw['card']}]")
    TB.STAGE_TIMINGS = True
    try:
        backend.verify_signature_sets(sets, rand_fn=rand_fn)
        stages = dict(TB.LAST_FAST_AGG_TIMINGS)
    finally:
        TB.STAGE_TIMINGS = False
    print("stage split (ms, each stage fenced): " + json.dumps(
        {k: (round(v, 2) if isinstance(v, float) else v)
         for k, v in stages.items()}) + f" [{hw['card']}]")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(torch, lambda: backend.verify_signature_sets(
            sets, rand_fn=rand_fn))
    events = prof.key_averages()
    devt = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in events if e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(d for d, _c, _k in devt) / 1e3
    print(f"profile verify: wall {wall:.1f} ms (under the profiler), device "
          f"busy {busy:.3f} ms, idle share {1 - busy / wall:.4f} "
          f"[{hw['card']}]")
    print("  device: " + "; ".join(f"{k} x{c} {d / 1e3:.3f} ms"
                                   for d, c, k in devt[:8]))
    return {"launches": launches, "wall_ms": walls, "stages": stages,
            "busy_ms": busy}



def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.ops import cuda_build
    from lighthouse_tpu_torch.ops import merkle_kernel as mk

    device.set_default_device("cuda")
    t_start = time.perf_counter()
    from lighthouse_tpu_torch.crypto import bls, fields as F
    from lighthouse_tpu_torch.crypto import pairing_kernel as pk
    hw = phase_build(torch, mk, pk, cuda_build)
    kern = phase_kernels(torch, mk, hw)
    state = phase_state_root(torch, hw)

    t0 = time.perf_counter()
    brng = np.random.default_rng(SEED)
    sets = build_bls_batch(bls, F, brng)
    srng = np.random.default_rng(SEED + 2)

    def rand_fn():
        return int(srng.integers(1, 2 ** 64, dtype=np.uint64))

    print(f"BLS set-up (host, pure Python): {BLS_KEYS} keys and "
          f"{BLS_MSGS} signatures in {time.perf_counter() - t0:.1f} s")
    bk = phase_bls_kernels(torch, hw, sets, rand_fn)
    bv = phase_bls_verify(torch, hw, sets, rand_fn)

    replaces = {"hash64": "lighthouse_tpu/ops/merkle_kernel.py:192",
                "subtree": "lighthouse_tpu/ops/merkle_kernel.py:159",
                "hash_g2": "lighthouse_tpu/crypto/htc_kernel.py:285",
                "sigma": "lighthouse_tpu/crypto/pairing_kernel.py:1001",
                "miller_fold": "lighthouse_tpu/crypto/pairing_kernel.py:938",
                "finalize": "lighthouse_tpu/crypto/pairing_kernel.py:1165"}
    kernels = []
    for name in ("hash64", "subtree"):
        t = kern["timing"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "lighthouse_tpu_torch/csrc/sha256_merkle.cu",
            "replaces": replaces[name],
            "launches": state["launches"][name],
            "max_abs_err": kern["errs"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    for name in ("hash_g2", "sigma", "miller_fold", "finalize"):
        t = bk["timing"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "lighthouse_tpu_torch/csrc/bls381.cu",
            "replaces": replaces[name],
            "launches": bv["launches"][name],
            "max_abs_err": bk["errs"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(hw["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
