"""K1 and K6 at 129 ≤ n ≤ 224 against the JAX package, and the push and
wait schedule of their cluster instances replayed.

The JAX kernels ``ns_vmem_iterate`` (the four fixed Newton-Schulz lanes)
and ``_gp_ns_kernel`` (the GP method ``pallas_ns``) serve n ≤ 224; the
port's K1 and K6 serve the same band, one 2 × 2 thread-block cluster a
matrix past n = 128 (``csrc/ns_quad_rounds.cuh``).  On the CPU the
wrappers run their plain versions (``ns_iterate_plain``,
``gp_fused_ns_plain``), which these tests hold
against the JAX kernels in interpret mode (every product fp32,
``block=1``).  Inputs are NumPy draws from a seed of each test, cast to
float32 (the suite runs JAX with x64 on).  Tolerances are max-norm
relative on inverses and absolute on mean and variance.
"""

import re
import warnings

import numpy as np
import pytest
import threadpoolctl
import torch

from cuda_matrix_inversion_tpu.ops import newton_schulz as jax_ns
from cuda_matrix_inversion_tpu.ops import pallas_gp
from cuda_matrix_inversion_tpu.ops import schur as jax_schur
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_nonsym_cond,
    make_spd_batch,
)
from cuda_matrix_inversion_tpu_torch.ops import cuda_build, cuda_gp, linalg
from cuda_matrix_inversion_tpu_torch.ops import newton_schulz as ns
from cuda_matrix_inversion_tpu_torch.ops.registry import LANES

_FIXED = ("newton_schulz_spd10_pallas", "newton_schulz_spd_pallas",
          "newton_schulz_pallas", "newton_schulz_pan500_pallas")
# The port's CPU path rounds its products to bf16 as the card does; JAX's
# interpret mode computes them in fp32.  Each lands within its residual
# (≲ 2e-5 on these draws) of A⁻¹, so they differ by at most K1's 2e-4
# relative; with fp32 products on both sides (bf16_products=False) only
# the order of the sums differs: 1e-5.
RTOL_PATH, RTOL_FP32 = 2e-4, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The suite runs in parallel workers: with PyTorch's OpenMP pool and
    NumPy's BLAS on one thread each of these small products runs at once
    instead of waiting for the worker's other threads.
    ``torch.set_num_threads`` is not called: restoring a count above one
    with it left a later batched ``torch.linalg.inv_ex`` at n = 300 in the
    same worker spinning for good (MKL reporting a bad SLASWP argument) on
    a PyTorch 2.13 CPU build, while threadpoolctl's limit restores cleanly."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _batch(lane, n, seed):
    """Two members of the lane's class: the general lanes' κ = 300
    nonsymmetric batches for pan500 (as ``tests/test_torch_slice.py``
    draws them past 128), the reference's SPD class for the others."""
    rng = np.random.default_rng(seed)
    if lane == "newton_schulz_pan500_pallas":
        return make_nonsym_cond(2, n, 300.0, rng)
    return make_spd_batch(2, n, rng).astype(np.float32)


@pytest.mark.parametrize("lane", _FIXED)
@pytest.mark.parametrize("n", [140, 200])
def test_k1_band_plain_matches_jax_interpret(lane, n):
    """K1's plain version with fp32 products is JAX's interpret-mode
    ``ns_vmem_iterate`` arithmetic (RTOL_FP32); the lane's CPU path (bf16
    products, as the card; split3's polish residual fp64) runs it with no
    warning and no launch, within RTOL_PATH of JAX's; all three through
    the gate."""
    a = _batch(lane, n, 3000 + n + len(lane))
    keywords = LANES[lane]["keywords"]
    ref = np.asarray(jax_ns.inverse_newton_schulz_pallas(
        a, block=1, interpret=True, **keywords))
    fp32 = ns.ns_iterate_plain(torch.tensor(a), LANES[lane]["schedule"],
                               bf16_products=False).numpy()
    before = (ns.ns_iterate_cuda.launches, ns.ns_iterate_cuda.band_launches)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x = ns.inverse_newton_schulz_fixed(torch.tensor(a),
                                           **keywords).numpy()
    assert (ns.ns_iterate_cuda.launches,
            ns.ns_iterate_cuda.band_launches) == before
    assert x.shape == a.shape and x.dtype == np.float32
    assert _rel(fp32, ref) <= RTOL_FP32
    assert _rel(x, ref) <= RTOL_PATH
    for out in (x, fp32, ref):
        assert identity_error_inf(a, out) < 1e-4


@pytest.mark.parametrize("n", [192, 224])
def test_k1_band_split3_residual_is_fp64(n):
    """Past n = 128 K1's split3 polish residuals are float64 (as the
    kernel's cluster instance accumulates them): the pan500 lane's CPU path
    is the rounds written out with ``residual_f64``, bit for bit, the same
    bits as the batched route it replaced, and holds the gate on the
    κ = 500 class at n = 192 and 224."""
    a = make_nonsym_cond(3, n, 500.0, np.random.default_rng(3100 + n))
    at = torch.tensor(a)
    lane = "newton_schulz_pan500_pallas"
    sched = LANES[lane]["schedule"]
    x = ns.inverse_newton_schulz_fixed(at, **LANES[lane]["keywords"])
    eye = torch.eye(n)
    want = ns._seed(at, "pan")
    for c in sched.coeffs:
        t = (2.0 * c) * eye - (c * c) * ns._mm_split3(at, want)
        want = ns._mm_split3(want, t)
    for _ in range(sched.hi_iters):
        want = want + ns._mm_split3(want, linalg.residual_f64(at, want))
    assert torch.equal(x, want)
    assert torch.equal(x, ns.inverse_newton_schulz_pan500_batched(at))
    assert identity_error_inf(a, x.numpy()) < 1e-4


def _gp_system(n, seed):
    g = make_gp_batch(2, n, np.random.default_rng(seed))
    return ({k: g[k].astype(np.float32) for k in "abcde"},
            g["means"][:, 0, 0], g["variances"][:, 0, 0])


@pytest.mark.parametrize("n", [160, 200])
def test_k6_band_plain_matches_jax_interpret(n, monkeypatch):
    """K6's plain version with fp32 products against JAX's interpret-mode
    ``_gp_ns_kernel``: 1e-5 on mean and var.  ``pallas_ns``'s CPU path
    runs K6's plain version (not K5's Schur route, no launch, no warning)
    within 1e-4 of the fp64 closed form."""
    data, means, variances = _gp_system(n, 3200 + n)
    args = [data[k] for k in "abcde"]
    ref = [np.asarray(x)[:, 0, 0] for x in pallas_gp.gp_mean_variance_fused_ns(
        *args, block=1, interpret=True)]
    flat = cuda_gp._flat(*(torch.tensor(x) for x in args),
                         max_n=cuda_build.WARM_MAX_N)
    fp32 = cuda_gp.gp_fused_ns_plain(*flat, bf16_products=False).numpy()
    seen = []
    plain = cuda_gp.gp_fused_ns_plain

    def spy(*xs):
        seen.append(xs[1].shape[-1])
        return plain(*xs)

    monkeypatch.setattr(cuda_gp, "gp_fused_ns_plain", spy)
    before = (cuda_gp.gp_fused_ns_cuda.launches,
              cuda_gp.gp_fused_ns_cuda.band_launches)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = [x.numpy()[:, 0, 0] for x in cuda_gp.gp_mean_variance_fused_ns(
            *(torch.tensor(x) for x in args))]
    assert seen == [n]
    assert (cuda_gp.gp_fused_ns_cuda.launches,
            cuda_gp.gp_fused_ns_cuda.band_launches) == before
    for col, exact in ((0, means), (1, variances)):
        assert np.abs(fp32[:, col] - ref[col]).max() <= RTOL_FP32
        assert np.abs(got[col] - exact).max() < 1e-4
        assert np.abs(ref[col] - exact).max() < 1e-4


def test_spd_schur_base_past_224_is_224(monkeypatch):
    """Past K1's 224 the spd lanes take the Schur recursion down to a base
    of 224, as JAX's does: at n = 320 the base runs at 128 and 192 on both
    sides (a base of 128 would split the 192 block again), and the result
    passes the gate."""
    seen = []
    plain = ns.ns_iterate_plain

    def spy(a, sched, bf16_products=True):
        seen.append(a.shape[-1])
        return plain(a, sched, bf16_products)

    monkeypatch.setattr(ns, "ns_iterate_plain", spy)
    a = make_spd_batch(2, 320, np.random.default_rng(3320)).astype(
        np.float32)
    x = ns.inverse_newton_schulz_fixed(
        torch.tensor(a), **LANES["newton_schulz_spd_pallas"]["keywords"])
    jax_seen = []

    def jax_base(block):
        jax_seen.append(block.shape[-1])
        return np.linalg.inv(np.asarray(block))

    jax_schur.spd_blocked_inverse(a, jax_base, max_base_n=224)
    assert seen == jax_seen == [128, 192]
    assert identity_error_inf(a, x.numpy()) < 1e-4


def test_k1_k6_wrappers_reject_past_224_before_any_launch():
    """``ns_iterate_cuda`` and ``gp_fused_ns_cuda`` reject n = 225 (the
    JAX kernels' ceiling is 224) with ValueError before any launch, and
    still reject a CPU tensor inside the band."""
    sched = LANES["newton_schulz_spd10_pallas"]["schedule"]
    e = torch.ones(1)
    before = (ns.ns_iterate_cuda.launches, cuda_gp.gp_fused_ns_cuda.launches)
    for n, match in ((225, "1..224"), (160, "float32 CUDA")):
        a = torch.eye(n)[None]
        v = torch.ones(1, n)
        with pytest.raises(ValueError, match=match):
            ns.ns_iterate_cuda(a, sched)
        with pytest.raises(ValueError, match=match):
            cuda_gp.gp_fused_ns_cuda(v, a, v, v, e)
    assert (ns.ns_iterate_cuda.launches,
            cuda_gp.gp_fused_ns_cuda.launches) == before


# ---- the quadrant loop's push and wait schedule, replayed ----
#
# ``csrc/ns_quad_rounds.cuh`` runs K1 and K6 past n = 128 on a 2 x 2
# cluster: CTA rank = 2p + q holds quadrant (p, q) and takes the left
# operand's other quadrant from its row peer (rank ^ 1) and the right
# operand's from its column peer (rank ^ 2), pushed by bulk copies that
# complete on an mbarrier of the receiving slot.  The replay below writes
# each CTA's operations in the kernel's order (stores, loads from device
# memory, pushes, arms, waits and the MMA passes, with a cluster barrier
# closing each epoch) and runs the four programs epoch by epoch on slots
# that hold tags of what they contain.  It checks that every pass reads the
# quadrants its product needs, that each mbarrier is armed once a phase
# with the bytes pushed into it and waited on in that phase, and W10: no
# push fills a slot its receiver reads or writes in that epoch before the
# wait, and no CTA writes a slot it pushes from in that epoch.

_AF, _XH, _XL, _TT, _T3, _S0, _S1 = 0, 2, 3, 4, 5, 6, 7  # the kernel's slots
_F0, _F1, _F2 = _XH, _TT, _S0  # its fp32 areas (two slots each)


def _area(s):
    return (s, s + 1)


class _QuadProgram:
    """One CTA's operations, an epoch a list; ``mutant`` breaks one step
    of the schedule (the replay must then fail)."""

    def __init__(self, rank, lo, hi, split3, polish_highest, spd,
                 mutant=None):
        self.rank, self.p, self.q = rank, rank >> 1, rank & 1
        self.diag = self.p == self.q
        self.row, self.col = rank ^ 1, rank ^ 2
        self.lo, self.hi, self.split3 = lo, hi, split3
        self.polish_highest, self.mutant = polish_highest, mutant
        self.epochs = [[]]
        self.xs = _XH  # X's bf16 slot
        self._build(spd)

    def op(self, *o):
        self.epochs[-1].append(o)

    def sync(self):
        self.epochs.append([])

    def f32_round(self, r):
        rounds = self.lo + self.hi
        return r == rounds or (r >= self.lo and (
            self.split3 or (r == rounds - 1 and self.polish_highest)))

    # expected passes of a product: (left tag, right tag) pairs
    def _expect(self, left, right, split, v_l, v_r):
        p, q, out = self.p, self.q, []
        for k in (0, 1):
            lt = left(p, k, v_l)
            rt = right(k, q, v_r)
            out.append((lt + (".hi",), rt + (".hi",)))
            if split:
                out.append((lt + (".lo",), rt + (".hi",)))
                out.append((lt + (".hi",), rt + (".lo",)))
        return out

    def publish(self, r):
        # a bf16 lo round after a lo round writes X's bf16 part into the
        # other of slots 2 and 3 and needs no barrier first
        turn = (not self.split3 and 0 < r < self.lo
                and self.mutant != "no_turn")
        if r > 0 and not turn and self.mutant not in (
                "no_barrier_before_publish", "no_turn"):
            self.sync()
        p, q = self.p, self.q
        self.xs = (_XH + _XL - self.xs) if turn else _XH
        if self.f32_round(r):
            self.op("write", _area(_F0), ("X", p, q, r))
        else:
            self.op("write", (self.xs,), ("X", p, q, r, ".hi"))
            if self.split3 or r >= self.lo:
                self.op("write", (_XL,), ("X", p, q, r, ".lo"))
        self.sync()

    def push(self, src, peer, dst, bar):
        self.op("push", src, peer, dst, bar)

    def ax_one(self, r):
        self.op("product", self._expect(lambda p, k, v: ("A", p, k),
                                        lambda k, q, v: ("X", k, q, v),
                                        False, None, r))
        self.op("arm", 1, 1)
        self.push((self.xs,), self.col, (_S1,), 1)
        if self.diag:
            self.op("pass", _area(_AF), "hi", self.xs)
            self.op("wait", 1)
            self.op("pass", (_T3,), "tile", _S1)
        else:
            self.op("pass", (_T3,), "tile", self.xs)
            self.op("wait", 1)
            self.op("pass", _area(_AF), "hi", _S1)

    def ax_split(self, r):
        p, q = self.p, self.q
        self.op("product", self._expect(lambda p, k, v: ("A", p, k),
                                        lambda k, q, v: ("X", k, q, v),
                                        True, None, r))
        if self.split3 and self.mutant != "no_af_reload":
            self.op("write", _area(_AF), ("A", p, q))
        self.op("write", _area(_F1), ("A", p, 1 - q))
        self.op("arm", 0, 1)
        self.push((_XH,), self.col, (_S0,), 0)
        self.op("arm", 1, 1)
        self.push((_XL,), self.col, (_S1,), 1)

        def three(left, rh, rl):
            self.op("pass", left, "hi", rh)
            self.op("pass", left, "lo", rh)
            self.op("pass", left, "hi", rl)

        if self.diag:
            three(_area(_AF), _XH, _XL)
            self.op("wait", 0)
            self.op("wait", 1)
            three(_area(_F1), _S0, _S1)
        else:
            three(_area(_F1), _XH, _XL)
            self.op("wait", 0)
            self.op("wait", 1)
            three(_area(_AF), _S0, _S1)

    def store_t(self, r):
        p, q = self.p, self.q
        self.op("write", (_TT,), ("T", p, q, r, ".hi"))
        if self.split3:
            self.op("write", (_T3,), ("T", p, q, r, ".lo"))
        self.sync()

    def xt_one(self, r):
        self.op("product", self._expect(lambda p, k, v: ("X", p, k, v),
                                        lambda k, q, v: ("T", k, q, v),
                                        False, r, r))
        x = self.xs
        self.op("arm", 0, 1)
        self.push((x,), self.row, (_S0,), 0)
        self.op("arm", 1, 1)
        self.push((_TT,), self.col, (_S1,), 1)
        if self.diag:
            self.op("pass", (x,), "tile", _TT)
            self.op("wait", 0)
            self.op("wait", 1)
            self.op("pass", (_S0,), "tile", _S1)
        else:
            self.op("wait", 0)
            self.op("pass", (_S0,), "tile", _TT)
            self.op("wait", 1)
            self.op("pass", (x,), "tile", _S1)

    def xt_split(self, r):
        # the row peer's X hi and lo into A's own slots, the column peer's
        # T hi and lo into S0 and S1
        self.op("product", self._expect(lambda p, k, v: ("X", p, k, v),
                                        lambda k, q, v: ("T", k, q, v),
                                        True, r, r))

        def split(lh, ll, rh, rl):
            self.op("pass", (lh,), "tile", rh)
            self.op("pass", (ll,), "tile", rh)
            self.op("pass", (lh,), "tile", rl)

        self.op("arm", 0, 2)
        self.push((_XH,), self.row, (_AF,), 0)
        self.push((_XL,), self.row, (_AF + 1,), 0)
        self.op("arm", 1, 2)
        self.push((_TT,), self.col, (_S0,), 1)
        self.push((_T3,), self.col, (_S1,), 1)
        if self.diag:
            split(_XH, _XL, _TT, _T3)
            self.op("wait", 0)
            self.op("wait", 1)
            split(_AF, _AF + 1, _S0, _S1)
        else:
            self.op("wait", 0)
            split(_AF, _AF + 1, _TT, _T3)
            self.op("wait", 1)
            split(_XH, _XL, _S0, _S1)

    def residual(self, r):
        p, q = self.p, self.q
        self.op("product", [(("A", p, k), ("X", k, q, r)) for k in (0, 1)])
        if self.split3 and self.mutant != "no_af_reload":
            self.op("write", _area(_AF), ("A", p, q))
        self.op("write", _area(_F1), ("A", p, 1 - q))
        self.op("arm", 0, 2)
        self.push(_area(_F0), self.col, _area(_F2), 0)
        own_a, rem_a = ((_area(_AF), _area(_F1)) if self.diag
                        else (_area(_F1), _area(_AF)))
        self.op("term", own_a, _area(_F0))
        self.op("wait", 0)
        self.op("term", rem_a, _area(_F2))
        self.op("write", (_TT,), ("T", p, q, r, ".hi"))
        if self.split3:
            self.op("write", (_T3,), ("T", p, q, r, ".lo"))
        if self.mutant != "no_barrier_after_residual":
            self.sync()
        self.op("write", (_XH,), ("X", p, q, r, ".hi"))
        if self.split3:
            self.op("write", (_XL,), ("X", p, q, r, ".lo"))
        self.sync()

    def _build(self, spd):
        p, q = self.p, self.q
        # quad_stage, then quad_seed's three cluster barriers
        self.op("write", _area(_AF), ("A", p, q))
        if not spd:
            self.op("write", _area(_F2), ("At", q, p))
        if not self.split3:
            self.op("write", (_T3,), ("A", p, 1 - q, ".hi"))
        self.sync()
        self.sync()
        self.sync()
        if not spd:
            self.op("read", _area(_F2))
        self.publish(0)
        xt = self.xt_split if self.split3 else self.xt_one
        for r in range(self.lo):
            (self.ax_split if self.split3 else self.ax_one)(r)
            self.store_t(r)
            xt(r)
            self.publish(r + 1)
        for r in range(self.lo, self.lo + self.hi):
            if self.f32_round(r):
                self.residual(r)
            else:
                self.ax_split(r)
                self.store_t(r)
            xt(r)
            self.publish(r + 1)


def _replay_quad(np_, lo, hi, split3, polish_highest=True, spd=True,
                 mutant=None):
    """Run the four CTAs' programs epoch by epoch; raise AssertionError on
    a fault.  Returns the pushes as (epoch, source, receiver, slot, tag)."""
    q = np_ // 2
    tile_bytes = q * (q + 8) * 2
    progs = [_QuadProgram(r, lo, hi, split3, polish_highest, spd, mutant)
             for r in range(4)]
    n_epochs = {len(pr.epochs) for pr in progs}
    assert len(n_epochs) == 1, "the CTAs pass different cluster barriers"
    slots = [dict() for _ in range(4)]
    # each CTA's product being checked: its expected passes and those seen
    # (a product's windows span epochs)
    products = [[None, []] for _ in range(4)]

    def close(rank):
        expect, got = products[rank]
        assert expect is None or sorted(got) == sorted(expect), (
            f"CTA {rank}: passes {sorted(got)} != {sorted(expect)}")

    pushes_log = []
    for e in range(n_epochs.pop()):
        start = [dict(s) for s in slots]
        # the pushes of the epoch carry their source's content at its start
        incoming = [{0: [], 1: []} for _ in range(4)]
        for src, pr in enumerate(progs):
            written = {s for o in pr.epochs[e] if o[0] == "write"
                       for s in o[1]}
            for o in pr.epochs[e]:
                if o[0] != "push":
                    continue
                _, src_slots, peer, dst_slots, bar = o
                assert not written & set(src_slots), (
                    f"W10: CTA {src} writes slot {src_slots} it pushes "
                    f"from in epoch {e}")
                assert peer in (src ^ 1, src ^ 2)
                tag = start[src].get(src_slots[0])
                assert tag is not None and tag[1:3] == (pr.p, pr.q), (
                    f"CTA {src} pushes {tag}, not its own quadrant")
                incoming[peer][bar].append((src, dst_slots, tag))
        for rank, pr in enumerate(progs):
            cur = start[rank]
            filled = [s for bar in (0, 1)
                      for _, dst, _ in incoming[rank][bar] for s in dst]
            assert len(filled) == len(set(filled)), (
                f"W10: two pushes fill one slot of CTA {rank} in epoch {e}")
            pending = dict.fromkeys(filled)
            armed, waited = {}, {0: 0, 1: 0}
            got = products[rank][1]

            def read(s, what):
                assert s not in pending, (
                    f"W10: CTA {rank} reads slot {s} ({what}) before its "
                    f"push landed in epoch {e}")
                assert s in cur, f"CTA {rank} reads empty slot {s}"
                return cur[s]

            for o in pr.epochs[e]:
                kind = o[0]
                if kind == "write":
                    for s in o[1]:
                        assert s not in pending, (
                            f"W10: CTA {rank} writes slot {s} a push fills "
                            f"in epoch {e}")
                        cur[s] = o[2]
                elif kind == "arm":
                    assert o[1] not in armed, "armed twice in a phase"
                    armed[o[1]] = o[2] * tile_bytes
                elif kind == "wait":
                    bar = o[1]
                    assert bar in armed and waited[bar] == 0, (
                        f"CTA {rank} waits on bar {bar} unarmed in epoch {e}")
                    waited[bar] += 1
                    got_bytes = 0
                    for src, dst, tag in incoming[rank][bar]:
                        got_bytes += len(dst) * tile_bytes
                        for s in dst:
                            cur[s] = tag
                            del pending[s]
                        pushes_log.append((e, src, rank, dst[0], tag))
                    assert got_bytes == armed[bar], (
                        f"CTA {rank} bar {bar}: armed {armed[bar]} bytes, "
                        f"{got_bytes} pushed in epoch {e}")
                elif kind == "product":
                    close(rank)
                    got = []
                    products[rank] = [o[1], got]
                elif kind == "pass":
                    _, left, part, right = o
                    lt = read(left[0], "left")
                    if part != "tile":
                        lt = lt + ("." + part,)
                    got.append((lt, read(right, "right")))
                elif kind == "term":
                    got.append((read(o[1][0], "A"), read(o[2][0], "X")))
                elif kind == "read":
                    read(o[1][0], "seed")
            assert not pending, f"CTA {rank}: pushes never waited for"
            assert set(armed) == {b for b in (0, 1) if waited[b]}, (
                f"CTA {rank} epoch {e}: a phase armed and not waited")
            slots[rank] = cur
    for rank in range(4):
        close(rank)
    return pushes_log


def _quad_schedules():
    """(name, lo, hi, split3, polish_highest, spd): the four fixed lanes,
    K6's spd schedule, the pan schedule at 33 lo rounds in both precisions,
    the bf16 pan schedule without the fp32 polish, and lo rounds alone
    (hi = 0, the polish flag set) in both precisions."""
    out = []
    for lane in _FIXED:
        s = LANES[lane]["schedule"]
        out.append((lane, s.lo_iters, s.hi_iters, s.split3,
                    s.polish_highest, s.init == "spd"))
    s = cuda_gp.GP_NS_SCHEDULE
    out.append(("k6", s.lo_iters, s.hi_iters, s.split3, s.polish_highest,
                True))
    out += [("pan33", 33, 2, False, True, False),
            ("pan33_split3", 33, 2, True, True, False),
            ("pan_no_polish_highest", 12, 2, False, False, False),
            ("spd_lo_only", 6, 0, False, True, True),
            ("pan500_lo_only", 14, 0, True, True, False)]
    return out


@pytest.mark.parametrize("np_", [160, 192, 224])
def test_quad_schedule_replays_every_round(np_):
    """Every schedule's rounds on the quadrant loop at NP: each CTA gets the
    other quadrant of a left operand from its row peer and of a right one
    from its column peer, every pass of every product reads the quadrants
    its term needs (the round's X, T or R and A's quadrants), each
    mbarrier is armed once a phase with the bytes pushed into it, and no
    push fills or copies a slot while a CTA still reads or writes it."""
    for name, lo, hi, split3, polish, spd in _quad_schedules():
        log = _replay_quad(np_, lo, hi, split3, polish, spd)
        for _, src, dst, _, tag in log:
            # X as the left operand of X T (into S0) comes from the row
            # peer; every other part is a right operand, from the column
            # peer
            assert src in (dst ^ 1, dst ^ 2), name
            left = tag[0] == "X" and tag[-1] in (".hi", ".lo") and (
                src == dst ^ 1)
            assert left or src == dst ^ 2, (name, tag, src, dst)
        assert log, name


@pytest.mark.parametrize("mutant,lo,hi,split3", [
    ("no_barrier_before_publish", 14, 2, True),
    ("no_turn", 6, 2, False),
    ("no_af_reload", 14, 2, True),
    ("no_barrier_after_residual", 6, 2, False)])
def test_quad_replay_catches_a_broken_schedule(mutant, lo, hi, split3):
    """The replay fails a schedule with a cluster barrier or a load taken
    out: a publish over a slot still being pushed (split3), a bf16 lo
    round publishing into the slot it just pushed from, split3's A X
    reading the row peer's X left in A's slots, R's bf16 parts stored
    over X's fp32 publish before its push landed."""
    with pytest.raises(AssertionError):
        _replay_quad(224, lo, hi, split3, spd=not split3, mutant=mutant)


def test_quad_smem_fits_the_card():
    """``quad_smem_bytes`` (csrc/ns_quad_rounds.cuh): eight slots of one
    bf16 quadrant tile, two mbarriers and 3 NP + 16 floats; one CTA an SM
    fits the 227 KB opt-in at every NP, and two share an SM's 228 KB at
    NP = 160 (each with 1 KB the card reserves a block)."""
    text = (cuda_build.CSRC_DIR / "ns_quad_rounds.cuh").read_text()
    assert "8 * q * (q + 8) * 2 + 2 * sizeof(uint64_t) +" in text
    sizes = {}
    for np_ in (160, 192, 224):
        q = np_ // 2
        sizes[np_] = 8 * q * (q + 8) * 2 + 2 * 8 + (3 * np_ + 16) * 4
        assert sizes[np_] <= 232448
        # an fp32 quadrant is two bf16 slots, and every push a multiple of
        # 16 bytes
        assert q * (q + 8) * 4 == 2 * q * (q + 8) * 2
        assert (q * (q + 8) * 2) % 16 == 0
    assert 2 * (sizes[160] + 1024) <= 228 * 1024


def _c_params(name):
    """The parameter list of ``extern "C" int name(...)`` in ``csrc/``."""
    src = "".join(p.read_text()
                  for p in sorted(cuda_build.CSRC_DIR.glob("*.cu")))
    found = re.findall(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert len(found) == 1, name
    return [" ".join(p.split()) for p in found[0].split(",")]


@pytest.mark.parametrize("name", sorted(cuda_build._SIGNATURES))
def test_entry_point_signatures_match_the_sources(name):
    """Each C entry point's ctypes signature (``cuda_build._SIGNATURES``)
    has its parameters in number and kind: a pointer for each pointer, a
    C int for each int.  ctypes checks nothing against the library, so a
    parameter added on one side alone (say K1's and K6's ``quad_np``)
    would shift every argument after it silently."""
    params = _c_params(name)
    argtypes = cuda_build._SIGNATURES[name]
    assert len(params) == len(argtypes), (name, params)
    for param, argtype in zip(params, argtypes):
        if "*" in param:
            assert argtype in (cuda_build._VP, cuda_build._IP), (name, param)
        else:
            assert re.match(r"(const )?int \w+$", param), (name, param)
            assert argtype is cuda_build._I, (name, param)
    if name in ("cmi_ns_inverse", "cmi_gp_fused_ns"):
        assert params[-1] == "int* quad_np"
        assert argtypes[-1] is cuda_build._IP
