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


def phase_build(torch, mk, cuda_build) -> dict:
    card = smi("name,power.limit")
    print(f"card: {card}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  python "
          f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    mk.kernel_library()
    info = cuda_build.build_info("sha256_merkle")
    print(f"kernel build: {info['build_s']:.1f} s nvcc "
          f"({time.perf_counter() - t0:.1f} s with load) -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    sass = sass_instruction_counts(info["path"])
    print(f"SASS instructions (non-NOP): {json.dumps(sass)}")
    check("lh_hash64_kernel" in sass and sass["lh_hash64_kernel"] > 1000,
          f"cannot read the hash64 kernel's SASS: {sass}")
    clk_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"max SM clock {clk_mhz:.0f} MHz, {sms} SMs")
    return {"card": card, "instr_per_hash": sass["lh_hash64_kernel"],
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
    hw = phase_build(torch, mk, cuda_build)
    kern = phase_kernels(torch, mk, hw)
    state = phase_state_root(torch, hw)

    replaces = {"hash64": "lighthouse_tpu/ops/merkle_kernel.py:192",
                "subtree": "lighthouse_tpu/ops/merkle_kernel.py:159"}
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
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(hw["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
