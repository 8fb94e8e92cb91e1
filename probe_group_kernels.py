#!/usr/bin/env python3
"""Tuning probe for the thread-group kernels of the port on one NVIDIA
GPU: ``lh_miller_fold_kernel``, ``lh_hash_g2_kernel``, the sigma ladder
(``lh_sigma_ladder_kernel``), ``lh_prepare_kernel``,
``lh_product_chunks_kernel``, ``lh_miller_kernel`` and
``lh_product_kernel``.

    python3 probe_group_kernels.py

It builds ``csrc/bls381.cu`` and ``csrc/bls381_phases.cu`` (the same
bodies at any launch shape, under a runner that can stamp the SM clock
after every barrier of one group) and prints:

1. a launch-shape table: each body at G = 32, 64, 128 threads a group and
   several groups a block, raw equal to the port's kernel, timed (median
   of 5 CUDA-event runs) beside the port's kernel at the shared path's
   and the general path's sizes (Miller+fold on 256 lanes with 2 live and
   on 1280 lanes with 1025 live, laid out as ``tpu_backend.miller_cell``
   lays them out; hash-to-G2 on 2 and 8 cells); likewise the sigma ladder
   at G = 16, 32, 64 (with the port's butterfly after it) at C = 2 and 8,
   and prepare at G = 8, 16, 32 at K = 16, C = 8 and on the block batch's
   K = 512 (half the sets live) and K = 1 items; product_chunks at G =
   32, 64 on 768 and 256 input lanes (five calls queued behind a spin,
   ``chip_smoke.queued_ms``: one call at a time would time its launch),
   the Miller loop alone at G = 64, 128 on 256 and 1024 lanes, and the
   product butterfly at (G, K) = 32 or 64 threads a group and 1 or 2
   lanes a group's wave on 256, 512 and 1024 lanes (calls queued);
2. the phase profile of one group at the port's launch shape: cycles of
   each phase of a Miller doubling and addition step (one live lane), and
   of the hash's ladders, (p²+7)/16 bits and point additions;
3. the latency of one dependent fp_add and fp_sub.

Inputs are random field elements from a seed: the kernels' time does not
depend on the values, only on which lanes are live.  The phase map in
``phase_profile`` is the bodies' own phase sequence (Miller+fold:
``miller_pair_load``'s phase, ``miller_pair_loop``'s eight a doubling or
addition step and the conjugation, the fold's four); a change to
``miller_fold_body``, its pieces or ``hash_g2_body`` that it does not
know fails its count check, and the map is then brought up to date with
the body.
``chip_smoke.py`` does not run this script; a retune of either kernel
does.
"""

from __future__ import annotations

import ctypes

import numpy as np

from chip_smoke import SEED, check, cuda_ms, fail, max_abs_err, queued_ms, \
    rand_planes, smi

MILLER_SHAPES = ((32, 2), (32, 4), (64, 1), (64, 2), (64, 4), (128, 1),
                 (128, 2))
HASH_SHAPES = ((32, 1), (32, 2), (32, 4), (32, 8), (64, 1), (64, 2),
               (128, 1))
SIGMA_SHAPES = ((16, 2), (16, 4), (32, 1), (32, 2), (32, 4), (64, 1),
                (64, 2))
PREP_SHAPES = ((8, 4), (8, 8), (16, 1), (16, 2), (16, 4), (32, 1), (32, 2))
PCHUNK_SHAPES = ((32, 2), (32, 4), (64, 1), (64, 2), (64, 4))
MILLER_ALONE_SHAPES = ((64, 1), (64, 2), (128, 1))
PRODUCT_SHAPES = ((32, 1), (32, 2), (64, 1), (64, 2))   # (G, K)
STAMPS = 4096                 # LH_STAMPS of csrc/bls381_phases.cu


def miller_inputs(torch, rng, F, LF, S) -> list:
    """(note, g1, g2, mask) at the shared path's 256 lanes (lanes 0 and 1
    live: two groups with one live lane each) and the general path's 1280
    (1024 set lanes, the signature lane, zero padding)."""
    out = []
    for lanes, live in ((2 * S, [0, 1]), (10 * S, list(range(8 * S + 1)))):
        mask = torch.zeros((1, lanes), dtype=torch.int32, device="cuda")
        mask[0, live] = 1
        out.append((f"{lanes} lanes, {len(live)} live",
                    rand_planes(torch, rng, F, LF, 2, lanes),
                    rand_planes(torch, rng, F, LF, 4, lanes), mask))
    return out


def shape_rows(torch, card, name, note, shapes, port, at, outs,
               timer=cuda_ms, what="(G, groups a block)") -> None:
    """One table row: port() (the port's kernel, a tuple of outputs)
    against at(*shape) writing ``outs`` at each launch shape ``what``
    names, raw equal, and each timed by ``timer`` (five calls)."""
    want = port()
    times = {}
    for G, n in shapes:
        def go():
            rc = at(G, n)
            check(rc == 0, f"{name} at ({G}, {n}): CUDA error {rc}")
        go()
        check(all(max_abs_err(torch, o, w) == 0 for o, w in zip(outs, want)),
              f"{name} at ({G}, {n}) != the port's kernel")
        times[(G, n)] = timer(torch, go, 5)
    print(f"{name} launch shapes {what} at {note}, raw equal, "
          f"ms: " + ", ".join(f"{c} {t:.4f}" for c, t in times.items())
          + f"; the port's kernel {timer(torch, port, 5):.4f} [{card}]")


def shape_table(torch, card, lib, PK, HK, minputs, uinputs) -> None:
    """Miller+fold and hash-to-G2 at each launch shape."""
    stream = torch.cuda.current_stream().cuda_stream
    for note, *a in minputs:
        out = torch.empty((384, a[0].shape[1] // 2), dtype=torch.int32,
                          device="cuda")
        shape_rows(torch, card, "miller_fold", note, MILLER_SHAPES,
                   lambda a=a: (PK.miller_fold_kernel_call(*a),),
                   lambda G, n, a=a, out=out: lib.lh_miller_fold_phases(
                       *(x.data_ptr() for x in a), out.data_ptr(),
                       a[0].shape[1], G, n, None, stream), (out,))
    for u in uinputs:
        out = torch.empty((128, u.shape[1] // 2), dtype=torch.int32,
                          device="cuda")
        shape_rows(torch, card, "hash_g2", f"{u.shape[1] // 256} cells",
                   HASH_SHAPES, lambda u=u: (HK.hash_g2_kernel_call(u),),
                   lambda G, n, u=u, out=out: lib.lh_hash_g2_phases(
                       u.data_ptr(), out.data_ptr(), u.shape[1], G, n, None,
                       stream), (out,))


def ladder_shape_table(torch, card, lib, PK, rng, F, LF, S) -> None:
    """The sigma ladder and prepare at each launch shape, raw equal to the
    port's kernels (sigma's whole output, prepare's points and flags) and
    timed beside them.  Sets and lanes are live (random keys, masks with
    90% live slots, random scalars) but for the K = 512 item, whose second
    chunk of sets is dead (no live slot, scalar 0), as in a block batch."""
    stream = torch.cuda.current_stream().cuda_stream

    def u32(n):
        return torch.from_numpy(rng.integers(0, 2 ** 32, (1, n),
                                             dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).cuda()

    for C in (2, 8):
        m = C * S
        a = (rand_planes(torch, rng, F, LF, 4, m),
             torch.ones((1, m), dtype=torch.int32, device="cuda"), u32(m),
             u32(m))
        out = torch.empty((192, m), dtype=torch.int32, device="cuda")
        shape_rows(torch, card, "sigma", f"C={C}", SIGMA_SHAPES,
                   lambda a=a: (PK.sigma_kernel_call(*a),),
                   lambda G, n, a=a, out=out, m=m: lib.lh_sigma_phases(
                       *(x.data_ptr() for x in a), out.data_ptr(), m, G, n,
                       stream), (out,))
    for C, K, dead in ((8, 16, 0), (2, 512, S), (2, 1, 0)):
        m = C * S
        kmask = torch.from_numpy((rng.random((1, m * K)) < 0.9)
                                 .astype(np.int32)).cuda()
        lo, hi = u32(m), u32(m)
        if dead:
            kmask.view(C, K, S)[-1, :, S - dead:] = 0
            lo[0, m - dead:], hi[0, m - dead:] = 0, 0
        a = (rand_planes(torch, rng, F, LF, 2, m * K), kmask, lo, hi)
        out = torch.empty((64, m), dtype=torch.int32, device="cuda")
        flags = torch.empty((1, m), dtype=torch.int32, device="cuda")
        shape_rows(torch, card, "prepare", f"C={C}, K={K}, {dead} dead sets",
                   PREP_SHAPES, lambda a=a, K=K: PK.prepare_kernel_call(*a, K),
                   lambda G, n, a=a, K=K, out=out, flags=flags, m=m:
                       lib.lh_prepare_phases(*(x.data_ptr() for x in a),
                                             out.data_ptr(), flags.data_ptr(),
                                             m, K, G, n, stream),
                   (out, flags))


def fq12_shape_table(torch, card, lib, PK, rng, F, LF) -> None:
    """product_chunks (every lane unmasked, as the verify path calls it;
    timed with its calls queued behind a spin, as its launch is longer
    than the kernel), the Miller loop alone and the product butterfly
    (about 20% of the lanes masked; calls queued) at each launch shape,
    raw equal to the port's kernels and timed beside them, on random
    planes."""
    stream = torch.cuda.current_stream().cuda_stream
    for lanes in (768, 256):
        f = rand_planes(torch, rng, F, LF, 12, lanes)
        ones = torch.ones((1, lanes), dtype=torch.int32, device="cuda")
        out = torch.empty((384, lanes // 2), dtype=torch.int32, device="cuda")
        shape_rows(torch, card, "product_chunks",
                   f"{lanes} -> {lanes // 2} lanes", PCHUNK_SHAPES,
                   lambda f=f, ones=ones: (
                       PK.product_chunks_kernel_call(f, ones),),
                   lambda G, n, f=f, ones=ones, out=out, m=lanes:
                       lib.lh_product_chunks_phases(
                           f.data_ptr(), ones.data_ptr(), out.data_ptr(), m,
                           G, n, stream), (out,), queued_ms)
    for lanes in (256, 1024):
        g1 = rand_planes(torch, rng, F, LF, 2, lanes)
        g2 = rand_planes(torch, rng, F, LF, 4, lanes)
        out = torch.empty((384, lanes), dtype=torch.int32, device="cuda")
        shape_rows(torch, card, "miller", f"{lanes} lanes",
                   MILLER_ALONE_SHAPES,
                   lambda g1=g1, g2=g2: (PK.miller_kernel_call(g1, g2),),
                   lambda G, n, g1=g1, g2=g2, out=out, m=lanes:
                       lib.lh_miller_phases(g1.data_ptr(), g2.data_ptr(),
                                            out.data_ptr(), m, G, n, stream),
                   (out,))
    for lanes in (256, 512, 1024):
        f = rand_planes(torch, rng, F, LF, 12, lanes)
        mask = torch.from_numpy((rng.random((1, lanes)) < 0.8)
                                .astype(np.int32)).cuda()
        out = torch.empty((384, lanes), dtype=torch.int32, device="cuda")
        shape_rows(torch, card, "product", f"{lanes} lanes", PRODUCT_SHAPES,
                   lambda f=f, mask=mask: (PK.product_kernel_call(f, mask),),
                   lambda G, K, f=f, mask=mask, out=out, m=lanes:
                       lib.lh_product_phases(f.data_ptr(), mask.data_ptr(),
                                             out.data_ptr(), m, G, K, stream),
                   (out,), queued_ms, "(G, lanes a group's wave)")


def phase_profile(torch, card, clk_hz, lib, PK, HK, g1, g2, mask, u) -> None:
    """Group 0's clock after every barrier, at the port's launch shape:
    Miller+fold on ``g1, g2, mask`` (pair 0 has one live lane), hash-to-G2
    on ``u``."""
    stream = torch.cuda.current_stream().cuda_stream
    us = 1e6 / clk_hz                            # µs a cycle at max clock

    def stamps(launch, want):
        buf = torch.zeros(STAMPS, dtype=torch.int64, device="cuda")
        out = torch.empty_like(want)
        check(launch(out.data_ptr(), buf.data_ptr()) == 0,
              "phase profile launch failed")
        torch.cuda.synchronize()
        check(torch.equal(out, want), "phase-profiled body != the kernel")
        s = buf.cpu().numpy()
        return np.diff(s[:int(s[-1])])

    shape = PK.group_kernel_info("miller_fold")
    d = stamps(lambda o, b: lib.lh_miller_fold_phases(
        g1.data_ptr(), g2.data_ptr(), mask.data_ptr(), o, g1.shape[1],
        shape["G"], shape["groups"], b, stream),
        PK.miller_fold_kernel_call(g1, g2, mask))
    bits = [int(b) for b in PK.X_BITS_MILLER]
    # miller_pair_load, miller_pair_loop (8 a step), then the conjugation
    # and the fold's wave and three post phases
    check(len(d) == 1 + 8 * (len(bits) + sum(bits)) + 5,
          f"Miller+fold phase profile: {len(d)} phases")
    pos, dbl, add = 1, [], []
    for b in bits:
        dbl.append(d[pos:pos + 8])
        pos += 8
        if b:
            add.append(d[pos:pos + 8])
            pos += 8
    dbl, add = np.mean(dbl, 0), np.mean(add, 0)
    loop = float(d[1:pos].sum())
    print("miller_fold phases (one group, one live lane; cycles): doubling "
          f"step W1 P1 W2 W3 W4 P5 P6 P7 = {dbl.round().astype(int).tolist()}"
          f" ({dbl.sum() * us:.2f} µs), addition step "
          f"{add.round().astype(int).tolist()} ({add.sum() * us:.2f} µs); "
          f"the loop {loop * us:.1f} µs of {d.sum() * us:.1f} µs [{card}]")

    shape = PK.group_kernel_info("hash_g2")
    d = stamps(lambda o, b: lib.lh_hash_g2_phases(
        u.data_ptr(), o, u.shape[1], shape["G"], shape["groups"], b, stream),
        HK.hash_g2_kernel_call(u))
    e16 = len(HK.E16_BITS_LSB)
    f0 = 17 + 2 * e16 + 19                  # the first point addition
    check(len(d) == f0 + 602, f"hash-to-G2 phase profile: {len(d)} phases")
    adds = [d[f0:f0 + 4]]                   # q0 + q1, the two ladders,
    for base in (f0 + 5, f0 + 287):         # the six final additions
        adds += [d[base + 4 * k:base + 4 * k + 4] for k in range(70)]
    adds += [d[f0 + k:f0 + k + 4] for k in (567, 571, 575, 581, 585, 593)]
    adds = np.array(adds)
    ladders = float(d[8] + d[f0 + 598])
    e = d[17:17 + 2 * e16]
    rest = float(d.sum() - adds.sum() - ladders - e.sum())
    print(f"hash_g2 phases (one group; cycles): the two Fermat ladders "
          f"{ladders * us:.1f} µs; (p²+7)/16: {e16} × (product phase "
          f"{e[0::2].mean():.0f} + post {e[1::2].mean():.0f}) = "
          f"{e.sum() * us:.1f} µs; {len(adds)} point additions × (W1 mid W2 "
          f"out = {adds.mean(0).round().astype(int).tolist()}) = "
          f"{adds.sum() * us:.1f} µs; the rest {rest * us:.1f} µs; total "
          f"{d.sum() * us:.1f} µs [{card}]")


def add_latency(torch, card, lib, xy) -> None:
    """Cycles of one dependent fp_add and fp_sub on one thread."""
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty((32, 1), dtype=torch.int32, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    lat = {}
    for sub, name in ((0, "fp_add"), (1, "fp_sub")):
        for _ in range(2):                   # the second run is timed
            check(lib.lh_fp_add_chain(xy.data_ptr(), o.data_ptr(), 1000, sub,
                                      cyc.data_ptr(), stream) == 0,
                  "add chain launch failed")
        torch.cuda.synchronize()
        lat[name] = int(cyc.item()) / 1000
    print(f"dependent fp_add / fp_sub on one thread: {lat['fp_add']:.1f} / "
          f"{lat['fp_sub']:.1f} cycles [{card}]")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this probe needs an "
             "NVIDIA GPU")
    from lighthouse_tpu_torch import device
    from lighthouse_tpu_torch.crypto import fields as F
    from lighthouse_tpu_torch.crypto import htc_kernel as HK
    from lighthouse_tpu_torch.crypto import limb_field as LF
    from lighthouse_tpu_torch.crypto import pairing_kernel as PK
    from lighthouse_tpu_torch.ops import cuda_build

    device.set_default_device("cuda")
    card = smi("name,power.limit")
    print(f"card: {card}")
    cuda_build.build_all(["bls381", "bls381_phases"])   # 2 nvcc at once
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = cuda_build.load("bls381_phases", {
        "lh_phases_init": [P, I],
        "lh_miller_fold_phases": [P, P, P, P, LL, I, I, P, P],
        "lh_hash_g2_phases": [P, P, LL, I, I, P, P],
        "lh_fp_add_chain": [P, P, I, I, P, P],
        "lh_sigma_phases": [P, P, P, P, P, LL, I, I, P],
        "lh_prepare_phases": [P, P, P, P, P, P, LL, I, I, I, P],
        "lh_product_chunks_phases": [P, P, P, LL, I, I, P],
        "lh_miller_phases": [P, P, P, LL, I, I, P],
        "lh_product_phases": [P, P, P, LL, I, I, P]})
    consts = PK.cuda_consts()
    check(lib.lh_phases_init(consts.ctypes.data, consts.size) == 0,
          "constant upload failed")
    clk_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    rng = np.random.default_rng(SEED + 9)
    S = PK.PREP_S
    minputs = miller_inputs(torch, rng, F, LF, S)
    uinputs = [rand_planes(torch, rng, F, LF, 2, c * 2 * S) for c in (2, 8)]
    shape_table(torch, card, lib, PK, HK, minputs, uinputs)
    ladder_shape_table(torch, card, lib, PK, rng, F, LF, S)
    fq12_shape_table(torch, card, lib, PK, rng, F, LF)
    phase_profile(torch, card, clk_hz, lib, PK, HK, *minputs[0][1:],
                  uinputs[0])
    add_latency(torch, card, lib, rand_planes(torch, rng, F, LF, 1, 2))


if __name__ == "__main__":
    main()
