"""The port's plain BLS12-381 field core against the JAX package.

Base-field ops, the Fq2 tower, the RCB point law, ψ and sgn0 are held
limb for limb against the JAX package's in-kernel helpers driven eagerly
with the constant planes bound (as ``tests/test_pairing_kernel_cpu.py``
drives them), at 3 lanes with the edge words 0, N−1 and 2N−1.  The Fq12
tower, the Miller steps and the isogeny are held against the host
oracles (``crypto/fields.py`` and the formulas in host integers): driven
eagerly, the JAX package's Fq12 products and Miller steps take 10–35 s
each on a CPU, too slow for this suite.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lighthouse_tpu.crypto import fields as F
from lighthouse_tpu.crypto import hash_to_curve as H2C
from lighthouse_tpu.crypto import htc_kernel as JHK
from lighthouse_tpu.crypto import limb_field as JLF
from lighthouse_tpu.crypto import pairing_kernel as JPK
from lighthouse_tpu_torch.crypto import htc_kernel as HK
from lighthouse_tpu_torch.crypto import limb_field as LF
from lighthouse_tpu_torch.crypto import pairing_kernel as PK

P = F.P
M = 3  # lanes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of small ops: one torch thread per
    test worker (for the module's fixtures too) keeps parallel workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def bind_consts():
    JPK._bind_consts(
        jnp.asarray(JPK.CONSTS_PLANES),
        jnp.asarray(JPK.X_BITS_FULL.reshape(-1, 1).astype(np.int32)),
        jnp.asarray(JPK.P_MINUS_2_BITS.reshape(-1, 1).astype(np.int32)))
    yield


def _vals(rng, edge: bool):
    """M raw values below 2N: the edge words, or random ones."""
    if edge:
        return [0, P - 1, 2 * P - 1]
    return [int.from_bytes(rng.bytes(56), "little") % (2 * P)
            for _ in range(M)]


def _plane(vals) -> np.ndarray:
    return np.stack([LF.int_to_limbs(v) for v in vals], axis=1)


def _t(plane) -> torch.Tensor:
    return torch.from_numpy(np.asarray(plane, np.int64).copy())


def _fq2(rng, edge=False):
    """(host (26, M) planes c0, c1; port (26, M, 2) tensor)."""
    c0, c1 = _plane(_vals(rng, edge)), _plane(_vals(rng, False))
    return (c0, c1), _t(np.stack([c0, c1], -1))


def _np(x) -> np.ndarray:
    return np.asarray(x, np.int64)


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub", "neg", "muls3",
                                "muls12", "is_zero"])
def test_base_field_op_matches_jax_limbs(op):
    rng = np.random.default_rng(1)
    for a_edge, b_edge in ((True, False), (False, True)):
        a, b = _plane(_vals(rng, a_edge)), _plane(_vals(rng, b_edge))
        ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
        want, got = {
            "mont_mul": lambda: (JPK.k_mont_mul(ja, jb), PK.mont_mul(ta, tb)),
            "add": lambda: (JPK.k_add(ja, jb), PK.k_add(ta, tb)),
            "sub": lambda: (JPK.k_sub(ja, jb), PK.k_sub(ta, tb)),
            "neg": lambda: (JPK.k_neg(ja), PK.k_neg(ta)),
            "muls3": lambda: (JPK.k_muls(ja, 3), PK.k_muls(ta, 3)),
            "muls12": lambda: (JPK.k_muls(ja, 12), PK.k_muls(ta, 12)),
            "is_zero": lambda: (JPK.k_is_zero(ja)[0], PK.k_is_zero(ta)),
        }[op]()
        assert np.array_equal(_np(want), got.numpy()), (op, a_edge)


def test_fq2_mul_sqr_conj_xi_match_jax_limbs():
    rng = np.random.default_rng(2)
    (a0, a1), ta = _fq2(rng, edge=True)
    (b0, b1), tb = _fq2(rng)
    ja = (jnp.asarray(a0), jnp.asarray(a1))
    jb = (jnp.asarray(b0), jnp.asarray(b1))
    for want, got in ((JPK.fq2_mul(ja, jb), PK.fq2_mul(ta, tb)),
                      (JPK.fq2_mul(ja, ja), PK.fq2_mul(ta, ta)),
                      (JPK.fq2_conj(ja), PK.fq2_conj(ta)),
                      (JPK.fq2_mul_by_xi(ja), PK.fq2_mul_by_xi(ta))):
        assert np.array_equal(np.stack([_np(w) for w in want], -1),
                              got.numpy())


def _rand_point(rng, g2: bool):
    """Random projective coordinates (not on the curve: the law's
    formulas are what is compared)."""
    if g2:
        host = [_fq2(rng) for _ in range(3)]
        return (tuple((jnp.asarray(h[0][0]), jnp.asarray(h[0][1]))
                      for h in host),
                torch.stack([h[1] for h in host], -2))
    planes = [_plane(_vals(rng, False)) for _ in range(3)]
    return (tuple(jnp.asarray(p) for p in planes),
            torch.stack([_t(p) for p in planes], -1))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_matches_jax_limbs(group):
    rng = np.random.default_rng(3)
    g2 = group == "g2"
    jp, tp = _rand_point(rng, g2)
    jq, tq = _rand_point(rng, g2)
    jops, tops = (JPK._G2ops, PK._G2ops) if g2 else (JPK._G1ops, PK._G1ops)
    cases = [(jp, jq, tp, tq)] + ([(jp, jp, tp, tp)] if g2 else [])
    for a, b, c, d in cases:                # G2 also doubles (the ladders)
        want = JPK.point_add(jops, a, b)
        got = PK.point_add(tops, c, d).numpy()
        if g2:
            want = np.stack([np.stack([_np(x) for x in co], -1)
                             for co in want], -2)
        else:
            want = np.stack([_np(x) for x in want], -1)
        assert np.array_equal(want, got)


def test_psi_and_sgn0_match_jax_limbs():
    rng = np.random.default_rng(4)
    jp, tp = _rand_point(rng, True)
    want = JHK.k_psi(jp)
    want = np.stack([np.stack([_np(x) for x in co], -1) for co in want], -2)
    assert np.array_equal(want, HK.k_psi(tp).numpy())
    (a0, a1), ta = _fq2(rng, edge=True)
    ja = (jnp.asarray(a0), jnp.asarray(a1))
    assert np.array_equal(_np(JHK.k_sgn0_fq2(ja))[0],
                          HK.k_sgn0_fq2(ta).numpy())


# --- Fq12, Miller steps and the isogeny against the host oracles ------------

def _canon(t: torch.Tensor):
    """(26, ...) Montgomery limbs → nested lists of canonical ints."""
    arr = t.numpy()
    flat = arr.reshape(26, -1)
    out = [LF.from_mont(flat[:, i]) for i in range(flat.shape[1])]
    return np.array(out, dtype=object).reshape(arr.shape[1:])


def _fq12_host(c, lane):
    """Canonical (M, 2, 3, 2) object array → host Fq12 tuple of a lane."""
    return tuple(tuple((int(c[lane, i, j, 0]), int(c[lane, i, j, 1]))
                       for j in range(3)) for i in range(2))


def _rand_fq12(rng):
    vals = [[[[int.from_bytes(rng.bytes(48), "little") % P for _ in range(2)]
              for _ in range(3)] for _ in range(2)] for _ in range(M)]
    mont = np.stack([np.stack([np.stack([np.stack(
        [LF.to_mont(v) for v in c2], -1) for c2 in c6], -2) for c6 in lane],
        -3) for lane in vals], 1)                       # (26, M, 2, 3, 2)
    host = [tuple(tuple(tuple(c2) for c2 in c6) for c6 in lane)
            for lane in vals]
    return host, _t(mont)


def test_fq12_mul_sqr_conj_frobenius_inv_match_host_oracle():
    rng = np.random.default_rng(5)
    ha, ta = _rand_fq12(rng)
    hb, tb = _rand_fq12(rng)
    cases = [(PK.fq12_mul(ta, tb), lambda a, b: F.fq12_mul(a, b)),
             (PK.fq12_sqr(ta), lambda a, b: F.fq12_sqr(a)),
             (PK.fq12_conj(ta), lambda a, b: F.fq12_conj(a)),
             (PK.fq12_inv(ta), lambda a, b: F.fq12_inv(a))]
    cases += [(PK.fq12_frobenius(ta, n),
               lambda a, b, n=n: F.fq12_frobenius(a, n)) for n in (1, 2, 3)]
    for got, host in cases:
        c = _canon(got)
        for lane in range(M):
            assert _fq12_host(c, lane) == host(ha[lane], hb[lane])


def _host_rcb(p, q):
    """RCB complete addition on host Fq2 ints (b3 = 12·ξ)."""
    (X1, Y1, Z1), (X2, Y2, Z2) = p, q
    mul, add, sub = F.fq2_mul, F.fq2_add, F.fq2_sub
    b3 = lambda t: F.fq2_muls(F._mul_by_xi(t), 12)
    t0, t1, t2 = mul(X1, X2), mul(Y1, Y2), mul(Z1, Z2)
    s3 = sub(mul(add(X1, Y1), add(X2, Y2)), add(t0, t1))
    s4 = sub(mul(add(Y1, Z1), add(Y2, Z2)), add(t1, t2))
    s5 = sub(mul(add(X1, Z1), add(X2, Z2)), add(t0, t2))
    um, up = sub(t1, b3(t2)), add(t1, b3(t2))
    return (sub(mul(s3, um), b3(mul(s4, s5))),
            add(mul(up, um), F.fq2_muls(b3(mul(t0, s5)), 3)),
            add(mul(s4, up), F.fq2_muls(mul(t0, s3), 3)))


def _line(A, B, C):
    z = F.FQ2_ZERO
    return ((A, B, z), (z, C, z))


def test_miller_dbl_and_add_steps_match_host_formulas():
    rng = np.random.default_rng(6)
    hf, tf = _rand_fq12(rng)
    rnd = lambda: int.from_bytes(rng.bytes(48), "little") % P
    hT = [tuple((rnd(), rnd()) for _ in range(3)) for _ in range(M)]
    hQ = [((rnd(), rnd()), (rnd(), rnd())) for _ in range(M)]
    hP = [(rnd(), rnd()) for _ in range(M)]
    fq2m = lambda v: np.stack([LF.to_mont(v[0]), LF.to_mont(v[1])], -1)
    tT = _t(np.stack([np.stack([fq2m(c) for c in T], -2) for T in hT], 1))
    tQx = _t(np.stack([fq2m(q[0]) for q in hQ], 1))
    tQy = _t(np.stack([fq2m(q[1]) for q in hQ], 1))
    txP = _t(np.stack([LF.to_mont(p[0]) for p in hP], 1))
    tyP = _t(np.stack([LF.to_mont(p[1]) for p in hP], 1))
    f1, T1 = PK.miller_dbl_step(tf, tT, txP, tyP)
    Q = torch.stack([tQx, tQy, PK._fq2_one((M,), tQx.device)], -2)
    f2, T2 = PK.miller_add_step(f1, T1, tQx, tQy, Q, txP, tyP)
    cf1, cT1, cf2, cT2 = _canon(f1), _canon(T1), _canon(f2), _canon(T2)
    mul, sub, muls = F.fq2_mul, F.fq2_sub, F.fq2_muls
    for lane in range(M):
        X, Y, Z = hT[lane]
        xP, yP = hP[lane]
        XX, YY, ZZ = mul(X, X), mul(Y, Y), mul(Z, Z)
        A = sub(muls(mul(X, XX), 3), muls(mul(YY, Z), 2))
        B = F.fq2_neg(muls(muls(mul(XX, Z), 3), xP))
        C = muls(muls(mul(Y, ZZ), 2), yP)
        want_f = F.fq12_mul(F.fq12_sqr(hf[lane]), _line(A, B, C))
        want_T = _host_rcb(hT[lane], hT[lane])
        assert _fq12_host(cf1, lane) == want_f
        assert tuple((int(cT1[lane, k, 0]), int(cT1[lane, k, 1]))
                     for k in range(3)) == want_T
        (Qx, Qy), (X, Y, Z) = hQ[lane], want_T
        Nn, Dd = sub(mul(Qy, Z), Y), sub(mul(Qx, Z), X)
        A = sub(mul(Nn, Qx), mul(Qy, Dd))
        B, C = F.fq2_neg(muls(Nn, xP)), muls(Dd, yP)
        assert _fq12_host(cf2, lane) == F.fq12_mul(want_f, _line(A, B, C))
        assert tuple((int(cT2[lane, k, 0]), int(cT2[lane, k, 1]))
                     for k in range(3)) == _host_rcb(want_T,
                                                     (Qx, Qy, F.FQ2_ONE))


def test_sswu_and_iso_map_match_host_oracle():
    u0, u1 = H2C.hash_to_field_fq2(b"iso", 2)
    t = _t(np.stack([np.stack([LF.to_mont(u[0]), LF.to_mont(u[1])], -1)
                     for u in (u0, u1)], 1))
    x, y = HK.k_sswu_map(t)
    q = HK.k_iso_map_proj(x, y)
    cq = _canon(q)
    for lane, u in enumerate((u0, u1)):
        want = H2C.iso_map(H2C.map_to_curve_sswu(u))
        Xc, Yc, Zc = (tuple(int(v) for v in cq[lane, k]) for k in range(3))
        zi = F.fq2_inv(Zc)
        assert (F.fq2_mul(Xc, zi), F.fq2_mul(Yc, zi)) == want


def test_carry_lookahead_matches_carry_loop():
    """The GPU's sync-free carry scheme equals the CPU's loop, on random
    columns and on runs of 0xFFFF limbs that pass a carry all the way."""
    rng = np.random.default_rng(10)
    cols = rng.integers(0, 2 ** 38, (52, 64), dtype=np.int64)
    chain = np.full((52, 8), 0xFFFF, np.int64)
    chain[0] = 0x10000 + np.arange(8)                    # carries into a run
    chain[-1] = np.arange(8)
    for t in (torch.from_numpy(cols), torch.from_numpy(chain),
              torch.from_numpy(rng.integers(0, 2 ** 17, (26, 5, 3))
                               .astype(np.int64))):
        for wrap in (False, True):
            loop = PK._carry(t, wrap, lookahead=False)
            look = PK._carry(t, wrap, lookahead=True)
            assert torch.equal(loop, look)
            assert (loop[:-1] <= 0xFFFF).all()
            n = t.shape[0]
            value = sum(int(v) << (16 * i) for i, v in enumerate(
                t.reshape(n, -1)[:, 0].tolist()))
            got = sum(int(v) << (16 * i) for i, v in enumerate(
                loop.reshape(n, -1)[:, 0].tolist()))
            assert got == (value % (1 << (16 * n)) if wrap else value)
