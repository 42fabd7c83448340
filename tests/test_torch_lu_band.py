"""K2's cluster instance (``csrc/lu_band.cu``, 129 ≤ n ≤ 256) on the CPU:
its schedule replayed in plain PyTorch against ``lu_inverse_plain`` bit for
bit, the ``lu_pallas`` lane in the band against the JAX package's
``pallas_lu.inverse_lu`` in interpret mode, the routes around the band,
and the card probe's patches.

Inputs are NumPy draws cast to float32 explicitly (the suite runs JAX with
x64 on).  The replay and the plain version are thousands of small tensor
operations: each test runs PyTorch on one thread (``one_thread``), so
that parallel workers do not oversubscribe the cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from cuda_matrix_inversion_tpu.ops import pallas_lu as jax_pallas_lu
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io import fixtures
from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_build,
    cuda_lu,
    linalg,
    lu_bign,
)
from cuda_matrix_inversion_tpu_torch.ops.registry import get_inverse_algorithm

# Port and JAX factor with the same pivots and the same fp32 operations in
# another order (JAX's rows stay in place and are gathered by one-hot
# products; its polish residual is fp32, the port's fp64): both land
# within κ·ε₃₂ of A⁻¹ on the κ = 500 class.
LU_RTOL = 1e-4


@pytest.fixture
def one_thread():
    """The replay runs thousands of small tensor ops on one thread.
    ``torch.set_num_threads`` is not called: restoring a count above one
    with it left a later batched ``torch.linalg.inv_ex`` at n = 300 in the
    same worker spinning for good (MKL reporting a bad SLASWP argument) on
    a PyTorch 2.13 CPU build, while threadpoolctl's limit restores cleanly."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _k2_band_replay(a: torch.Tensor, mutant: str | None = None):
    """K2's cluster schedule (``csrc/lu_band.cu``) in plain PyTorch,
    float32, each step an unfused mul then sub.  The batch padded with the
    identity to NP (160, 192, 224, 256); C = NP / 32 slabs, slab c holding
    W's columns [32c, 32c + 32) and the same columns of Y = I, rows by slot
    (they never move; a map gives the slot at each position).  Panel g's
    columns are the owner's slab's after the tile warps' panels up to g -
    2; the panel threads give them panel g - 1 (U12 on g - 1's rows, each
    taking its earlier steps in order, then the rank-4 update of the rows
    past), then factor them by slot (the first maximum by position, NaN
    never winning; each column's step on the panel's columns).  The owner's
    slab takes the factored panel, and every slab panel g on its quads past
    g + 1 (past g where it does not own g + 1) and on all of Y: U12, then
    the rows past the panel through the map.  Then U by position, and each
    slab's back pass by blocks of 8 rows descending: the triangle, each Y
    column a scalar chain (each row's terms last first, then its quotient),
    then the block's 8 terms on the rows above, last first.  ``mutant``
    breaks one order: ``"u12"`` (U12's steps reversed), ``"back"`` (the
    block's terms on the rows above first first), ``"early_factor"`` (panel
    g + 1 factored before its columns take panel g) or ``"early_triangle"``
    (block b - 1's triangle solved before its rows take block b's terms).
    Returns ``(A⁻¹, ipiv)`` cut to n."""
    batch, n, _ = a.shape
    np_ = cuda_lu.band_np(n)
    rows = torch.arange(batch)
    r_ = rows[:, None]
    full = torch.eye(np_).repeat(batch, 1, 1)
    full[:, :n, :n] = a
    eye = torch.eye(np_)
    slabs = [torch.cat([full[:, :, 32 * c:32 * c + 32],
                        eye[:, 32 * c:32 * c + 32].repeat(batch, 1, 1)], 2)
             for c in range(np_ // 32)]
    perm = torch.arange(np_).repeat(batch, 1)  # the slot at each position
    ipiv = torch.empty((batch, np_), dtype=torch.int32)

    def apply(x, lp, psl, past):
        """A panel's steps on columns x (rows by slot): U12, then the rows
        past it (the slots ``past``), each taking the 4 steps in order."""
        for r in range(1, 4):
            steps = reversed(range(r)) if mutant == "u12" else range(r)
            for h in steps:
                x[rows, psl[:, r]] = (x[rows, psl[:, r]]
                                      - lp[rows, psl[:, r], h:h + 1]
                                      * x[rows, psl[:, h]])
        for h in range(4):
            x[r_, past] = (x[r_, past] - lp[r_, past, h:h + 1]
                           * x[rows, psl[:, h]][:, None])

    def factor(cols, k0):
        """Panel k0 / 4 by slot; updates the map; returns its pivots'
        slots (psl)."""
        psl = torch.empty((batch, 4), dtype=torch.long)
        for h in range(4):
            j = k0 + h
            mag = torch.nan_to_num(cols[r_, perm[:, j:], h].abs(), nan=-1.0)
            p = torch.where(mag.max(1).values >= 0, j + mag.argmax(1),
                            torch.full_like(rows, j))
            ipiv[:, j] = p.to(torch.int32)
            sp, sj = perm[rows, p].clone(), perm[rows, j].clone()
            perm[rows, j], perm[rows, p] = sp, sj
            psl[:, h] = sp
            past = perm[:, j + 1:]
            l = cols[r_, past, h] / cols[rows, sp, h][:, None]
            cols[r_, past, h] = l
            for e in range(h + 1, 4):
                cols[r_, past, e] = (cols[r_, past, e]
                                     - l * cols[rows, sp, e][:, None])
        return psl

    prev = None  # the last panel: (its factored columns, psl, rows past)
    for g in range(np_ // 4):
        k0, owner, pq = 4 * g, g // 8, g % 8
        cols = slabs[owner][:, :, 4 * pq:4 * pq + 4].clone()
        if prev is not None and mutant != "early_factor":
            apply(cols, *prev)
        psl = factor(cols, k0)
        if prev is not None and mutant == "early_factor":
            apply(cols, *prev)
        slabs[owner][:, :, 4 * pq:4 * pq + 4] = cols
        prev = (cols, psl, perm[:, k0 + 4:].clone())
        for c, slab in enumerate(slabs):
            qa = min(max(g + 2 - 8 * c, 0), 8)
            apply(slab[:, :, 4 * qa:], *prev)
    u = torch.cat([slab[r_, perm, :32] for slab in slabs], 2)  # U, L below
    ys = []
    for slab in slabs:
        y = slab[r_, perm, 32:].clone()  # Y by position

        def triangle(b):
            r0 = 8 * b
            for r in reversed(range(8)):
                i = r0 + r
                for e in reversed(range(r + 1, 8)):
                    y[:, i] = (y[:, i]
                               - u[:, i, r0 + e:r0 + e + 1] * y[:, r0 + e])
                y[:, i] = y[:, i] / u[:, i, i:i + 1]

        early = set()
        for b in reversed(range(np_ // 8)):
            r0 = 8 * b
            if b not in early:
                triangle(b)
            if mutant == "early_triangle" and b > 0:
                triangle(b - 1)
                early.add(b - 1)
            terms = range(8) if mutant == "back" else reversed(range(8))
            for e in terms:
                y[:, :r0] = (y[:, :r0] - u[:, :r0, r0 + e:r0 + e + 1]
                             * y[:, r0 + e:r0 + e + 1])
        ys.append(y)
    return torch.cat(ys, 2)[:, :n, :n], ipiv[:, :n]


def _draw(n, draw):
    """A general draw with member 1 singular (rank 1), or small integers in
    [-2, 2] (exact ties decide the pivots; a member may be singular)."""
    rng = np.random.default_rng(5000 + n)
    if draw == "general":
        a = rng.standard_normal((3, n, n)).astype(np.float32)
        a[1] = 1.0
        return a
    return rng.integers(-2, 3, (3, n, n)).astype(np.float32)


@pytest.mark.parametrize(
    "n,draw", [(n, d) for d in ("general", "ties")
               for n in (129, 160, 200, 224, 256)]
    + [(161, "general"), (193, "general"), (225, "general")])
def test_k2_band_schedule_is_bitwise_the_plain_order(n, draw, one_thread):
    """The cluster schedule against :func:`cuda_lu.lu_inverse_plain`:
    ``inv`` and ``ipiv`` equal (``torch.equal``) on every finite member
    and the same members non-finite.  The identity padding, the forward
    pass folded into the factor (Y = I taking every swap and step), rows
    by slot through the map, each panel's columns taking the panel before
    them ahead of the slabs, and the back pass by blocks of 8 keep every
    element's terms in the plain order (n = 161, 193, 225: a last slab
    with 31 rows of padding)."""
    at = torch.tensor(_draw(n, draw))
    x, piv = _k2_band_replay(at)
    ref, ref_piv = cuda_lu.lu_inverse_plain(at)
    finite = torch.isfinite(ref).all(dim=(1, 2))
    assert torch.equal(torch.isfinite(x).all(dim=(1, 2)), finite)
    if draw == "general":
        assert finite.tolist() == [True, False, True]
    assert torch.equal(x[finite], ref[finite])
    assert torch.equal(piv[finite], ref_piv[finite])


@pytest.mark.parametrize("mutant", ["u12", "back", "early_factor",
                                    "early_triangle"])
def test_k2_band_replay_catches_a_broken_order(mutant, one_thread):
    """The replay's comparison sees one reordered step: U12's steps or the
    back pass's terms in the other order, a panel factored before its
    columns take the panel before it, or a triangle solved before its rows
    take the block below, change bits."""
    at = torch.tensor(_draw(160, "general"))
    x, _ = _k2_band_replay(at, mutant)
    ref, _ = cuda_lu.lu_inverse_plain(at)
    assert not torch.equal(x[0], ref[0])


class _Ring:
    """The slot ring of ``csrc/lu_band.cu`` on tagged slots: C CTAs, 8
    slots each, slot j holding panel 8 o + j of owner o.  Each CTA runs its
    tile warps' program and its panel threads' program as generators that
    yield the condition their next operation waits for, and each push is
    delivered later by an actor of its own.  A random actor among those
    whose condition holds takes its next operation, each actor with a
    random speed of its own, so some run far behind the others.  The
    mbarriers (phase, pending arrivals, transaction bytes) and the
    hand-over barriers are modelled as the kernel uses them.  A fault
    raises AssertionError: a slot written before every CTA released its
    last panel, a slot read before its push landed (or overwritten while
    read), an over-arrived barrier, or no actor able to go on (a deadlock).
    ``mutant``: ``"no_empty_wait"`` (the owner writes and pushes a slot
    without waiting for its release) or ``"no_full_wait"`` (the tile warps
    read a panel's slot without waiting for it)."""

    def __init__(self, c, rng, mutant=None):
        self.c, self.rng, self.mutant = c, rng, mutant
        self.panels = 8 * c
        self.slot = [[None] * 8 for _ in range(c)]  # the panel a slot holds
        self.reading = [[0] * 8 for _ in range(c)]  # open reads of a slot
        self.released = {}  # panel -> the CTAs that released its slot
        self.bars = {}      # (cta, name) -> mbarrier state
        self.hand = {}      # (cta, id) -> hand-over arrivals not yet taken
        self.log = []
        for r in range(c):
            for j in range(8):
                self._init(r, ("full", j), 1)
                self._init(r, ("empty", j), c)
                if r > 0:
                    self._arm(r, ("full", j))
            self._init(r, "pos", 1)
            if r > 0:
                self._arm(r, "pos")
        self.actors = []
        for r in range(c):
            self._spawn(self._tile(r))
            self._spawn(self._panel(r))

    def _spawn(self, gen):
        self.actors.append([gen, None, self.rng.exponential() ** 2 + 1e-3])

    def _init(self, r, name, count):
        self.bars[r, name] = {"count": count, "pending": count, "tx": 0,
                              "phase": 0}

    def _check(self, st):
        assert st["pending"] >= 0, "an mbarrier over-arrived"
        if st["pending"] == 0 and st["tx"] == 0:
            st["phase"] += 1
            st["pending"] = st["count"]

    def _arm(self, r, name):
        st = self.bars[r, name]
        st["tx"] += 1
        st["pending"] -= 1
        self._check(st)

    def _arrive(self, r, name):
        st = self.bars[r, name]
        st["pending"] -= 1
        self._check(st)

    def _phase(self, r, name, parity):
        st = self.bars[r, name]
        return lambda: st["phase"] % 2 != parity

    def _write(self, r, j, tag):
        if tag >= 8:
            assert self.released.get(tag - 8, set()) == set(range(self.c)), (
                f"slot {j} of CTA {r} written with panel {tag} before every "
                f"CTA released panel {tag - 8}")
        assert self.reading[r][j] == 0, (
            f"slot {j} of CTA {r} overwritten while read")
        self.slot[r][j] = tag

    def _read(self, r, j, tag):
        assert self.slot[r][j] == tag, (
            f"CTA {r} reads slot {j} for panel {tag} before its push landed "
            f"(it holds {self.slot[r][j]})")
        self.reading[r][j] += 1

    def _tile(self, r):
        yield self._phase(r, ("full", 0), 0)
        for g in range(self.panels):
            o, j = divmod(g, 8)
            self._read(r, j, g)
            yield None
            if g + 1 < self.panels and self.mutant != "no_full_wait":
                yield self._phase(r, ("full", (g + 1) % 8), (g + 1) // 8 % 2)
            self.reading[r][j] -= 1  # the tile warps' barrier
            if g + 8 < self.panels:
                self.released.setdefault(g, set()).add(r)
                self._arrive(o + 1, ("empty", j))
                if o + 1 != r:
                    self._arm(r, ("full", j))
            if g + 2 < self.panels and (g + 2) // 8 == r:
                key = (r, g % 2)
                self.hand[key] = self.hand.get(key, 0) + 1
                assert self.hand[key] <= 1, "a hand-over barrier over-arrived"
            yield None

    def _panel(self, r):
        for jj in range(8):
            p = 8 * r + jj
            if p >= 2:
                key = (r, p % 2)
                yield lambda: self.hand.get(key, 0) > 0
                self.hand[key] -= 1
            if jj == 0 and r > 0:
                yield self._phase(r, "pos", 0)
            if r > 0 and self.mutant != "no_empty_wait":
                yield self._phase(r, ("empty", jj), 0)
            if p >= 1:
                jp = (p - 1) % 8
                yield self._phase(r, ("full", jp), (p - 1) // 8 % 2)
                self._read(r, jp, p - 1)  # panel p - 1 on p's columns
                yield None
                self.reading[r][jp] -= 1
            self._write(r, jj, p)
            yield None
            self._arrive(r, ("full", jj))
            for k in range(self.c - 1):
                self._spawn(self._push((r + 1 + k) % self.c, jj, p))
            if jj == 7 and r < self.c - 1:
                self._spawn(self._push(r + 1, None, p))
            yield None

    def _push(self, peer, j, tag):
        yield None  # lands later
        if j is None:  # the positions at a change of owner
            st = self.bars[peer, "pos"]
        else:
            self._write(peer, j, tag)
            self.log.append((tag, peer))
            st = self.bars[peer, ("full", j)]
        st["tx"] -= 1
        self._check(st)

    def run(self):
        while self.actors:
            ready = [a for a in self.actors if a[1] is None or a[1]()]
            assert ready, "no actor can go on: a deadlock"
            w = np.array([a[2] for a in ready])
            actor = ready[self.rng.choice(len(ready), p=w / w.sum())]
            try:
                actor[1] = next(actor[0])
            except StopIteration:
                self.actors.remove(actor)
        return self.log


@pytest.mark.parametrize("c", [5, 6, 7, 8])
def test_k2_band_ring_replays_every_owner_change(c, one_thread):
    """The slot ring at C = 5 … 8 CTAs (NP = 160 … 256) under 6 random
    schedules each: every panel reaches every peer's slot, no slot is
    written before every CTA released its last panel, none is read before
    its push landed, and every barrier completes, across every change of
    owner."""
    for seed in range(6):
        log = _Ring(c, np.random.default_rng(seed)).run()
        assert sorted(log) == sorted((p, peer) for p in range(8 * c)
                                     for peer in range(c) if peer != p // 8)


@pytest.mark.parametrize("mutant", ["no_empty_wait", "no_full_wait"])
def test_k2_band_ring_replay_catches_a_broken_protocol(mutant, one_thread):
    """Without the owner's wait on a slot's empty barrier, some schedule
    overwrites a slot before every CTA released it; without the tile warps'
    wait on a full barrier, some schedule reads a slot before its push
    landed."""
    with pytest.raises(AssertionError):
        for seed in range(20):
            _Ring(8, np.random.default_rng(seed), mutant).run()


@pytest.mark.parametrize("n", [136, 160])
def test_lu_pallas_in_the_band_matches_jax(n, one_thread):
    """``lu_pallas`` at n = 136 (padded to NP = 160) and 160 on the κ = 500
    class against JAX's one-launch kernel in interpret mode: both through
    the gate, and agreement to :data:`LU_RTOL`."""
    a = fixtures.make_nonsym_cond(2, n, 500.0, np.random.default_rng(n + 1))
    ref = np.asarray(jax_pallas_lu.inverse_lu(jnp.asarray(a), block=1,
                                              interpret=True))
    x = get_inverse_algorithm("lu_pallas")(torch.tensor(a)).numpy()
    assert x.dtype == np.float32 and x.shape == a.shape
    assert identity_error_inf(a, ref) < 1e-4
    assert identity_error_inf(a, x) < 1e-4
    assert np.abs(x - ref).max() / np.abs(ref).max() <= LU_RTOL


@pytest.mark.parametrize("n", [129, 256, 257])
def test_lu_pallas_routes_around_the_band(n, one_thread):
    """On a CPU tensor the lane runs K2's plain version and the fp64
    polish at 129 ≤ n ≤ 256, the blocked LU past 256, and launches no
    kernel; float64 takes the library route."""
    a = torch.tensor(fixtures.make_nonsym_cond(2, n, 100.0,
                                               np.random.default_rng(n)))
    counts = (cuda_lu.lu_inverse_cuda.launches,
              cuda_lu.lu_inverse_cuda.band_launches,
              lu_bign.lu_panel_cuda.launches)
    x = cuda_lu.inverse_lu(a)
    if n <= cuda_build.LU_MAX_N:
        x0 = cuda_lu.lu_inverse_plain(a)[0]
        route = x0 + x0 @ linalg.residual_f64(a, x0)
    else:
        route = lu_bign.inverse_lu_big(a)
    assert torch.equal(x, route)
    assert (cuda_lu.lu_inverse_cuda.launches,
            cuda_lu.lu_inverse_cuda.band_launches,
            lu_bign.lu_panel_cuda.launches) == counts
    assert identity_error_inf(a.numpy(), x.numpy()) < 1e-4
    a64 = a.double()
    assert torch.equal(cuda_lu.inverse_lu(a64), linalg.inverse_lu(a64))


def test_lu_hiacc_seeded_in_the_band(one_thread):
    """``lu_hiacc`` at n = 200 (its ``lu_pallas`` seed in the band) holds
    its fp64 contract at κ = 500: max |I − AX| ≤ 1e-11."""
    a = fixtures.make_nonsym_cond(3, 200, 500.0,
                                  np.random.default_rng(2031)).astype(
                                      np.float64)
    x = get_inverse_algorithm("lu_hiacc")(torch.tensor(a)).numpy()
    assert x.dtype == np.float64
    assert np.abs(np.eye(200) - a @ x).max() <= 1e-11


def test_band_kernel_checks_on_the_cpu():
    """The wrapper takes n up to 256 and raises past it; a CPU tensor never
    reaches the library (there is none to build here)."""
    with pytest.raises(ValueError, match="256"):
        cuda_lu.lu_inverse_cuda(torch.zeros(1, 257, 257))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lu.lu_inverse_cuda(torch.zeros(1, 200, 200))
    assert [cuda_lu.band_np(n) for n in (129, 160, 161, 192, 193, 224, 225,
                                         256)] == [160, 160, 192, 192, 224,
                                                   224, 256, 256]
    src = (cuda_build.CSRC_DIR / "lu_band.cu").read_text()
    assert ("return n <= 160 ? 160 : n <= 192 ? 192 : n <= 224 ? 224 : 256;"
            in src)


def test_lu_band_probe_patches_match_the_kernel_source():
    """The card probe of the cluster instance (``bench/lu_band_probe.py``)
    stamps a clock split into a copy of ``csrc/lu_band.cu``: every anchor
    of its patches occurs as often as the probe expects, every stamp id
    has a step name, the names its reader calls are the source's, and the
    probe refuses to run without a card."""
    import re

    from cuda_matrix_inversion_tpu_torch.bench import lu_band_probe

    src = (cuda_build.CSRC_DIR / "lu_band.cu").read_text()
    for anchor, new, count in lu_band_probe.STAMPS:
        assert src.count(anchor) == count, anchor
        for step in re.findall(r"lb_step\((\d+)\)", new):
            assert int(step) < len(lu_band_probe.STEPS)
    for name in ("lu_band_kernel", "struct LuBand", "int lu_band_np(int n)",
                 "cudaError_t launch_lu_band("):
        assert name in src, name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            lu_band_probe.main()
