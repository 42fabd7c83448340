"""The Cholesky kernels' band, 129 ≤ n ≤ 256: K4 (the factor), K5 (the
fused GP mean/variance) and K10 (the fused LML, with and without W) on the
packed lower triangle (``csrc/cholesky_common.cuh::CholPacked``), against
the JAX package and against their own plain versions.

On the CPU the port runs the kernels' plain versions; the JAX kernels run
in interpret mode with a batch block of one system, each interpreted once
(module-scoped results).  The kernels' schedules on the packed layout
are replayed on a flat buffer at the layout's offsets (in NumPy: the
two-barrier factor and the band factor, whose panel warp and tile warps
run as generators under a scheduler of their named barriers, with K5's
border; in PyTorch: W = L⁻¹ built in place over L), and must give the
plain versions' bits.  PyTorch runs on one thread for the
module: its CPU kernels and BLAS oversubscribe the cores of a test worker
otherwise.  Tolerances are stated where they are used.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
from cuda_matrix_inversion_tpu.ops import pallas_cholesky, pallas_gp
from cuda_matrix_inversion_tpu_torch.io import fixtures
from cuda_matrix_inversion_tpu_torch.models import gp
from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_build,
    cuda_cholesky,
    cuda_gp,
    cuda_gp_lml,
    linalg,
)

NB, TILE_ROWS, TILE_COLS = 8, 64, 8  # cholesky_common.cuh's constants


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The replay runs thousands of small tensor ops on one thread.
    ``torch.set_num_threads`` is not called: restoring a count above one
    with it left a later batched ``torch.linalg.inv_ex`` at n = 300 in the
    same worker spinning for good (MKL reporting a bad SLASWP argument) on
    a PyTorch 2.13 CPU build, while threadpoolctl's limit restores cleanly."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _spd(batch, n, seed):
    return make_spd_batch(batch, n, np.random.default_rng(seed)
                          ).astype(np.float32)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _gp_system(batch, n, seed):
    g = fixtures.make_gp_batch(batch, n, np.random.default_rng(seed))
    return {k: g[k].astype(np.float32) for k in "abcde"}, g


def _lml_system(batch, n, seed):
    """The fit test's draw (tests/test_torch_gp_fit.py ``_synth``):
    B = W Wᵀ + 0.05 I of rank 4, c ∈ [0.5, 1.5), d drawn from K*."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((batch, n, 4))
    b = (w @ np.transpose(w, (0, 2, 1)) + 0.05 * np.eye(n)).astype(np.float32)
    c = (rng.random((batch, n, 1)) + 0.5).astype(np.float32)
    k = 1.8 ** 2 * b.astype(np.float64) + 0.25 * np.eye(n) * c[:, :, 0][
        :, None, :]
    d = (np.linalg.cholesky(k) @ rng.standard_normal((batch, n, 1))
         ).astype(np.float32)
    return b, c, d


# ---- the packed layout and its schedule, replayed --------------------------

def _row(i):
    """cholesky_common.cuh::CholPacked::row."""
    g, r = i // 8, i % 8
    return 32 * g * (g + 2) + 4 * r * (2 * g + 3)


def _packed_floats(n):
    g = (n + 7) // 8
    return 32 * g * (g + 2)


@pytest.mark.parametrize("n", [129, 136, 200, 229, 256])
def test_packed_layout_rows_are_disjoint_aligned_and_conflict_free(n):
    """Rows start on 16 bytes, hold their elements up to the diagonal
    rounded up to 4 (a float4 store) without reaching the next row, end
    inside the buffer, and the 8 rows of a group start in 8 distinct
    groups of 4 banks; 136 KB at n = 256, under one block's 227 KB."""
    offs = [_row(i) for i in range(n)]
    assert all(o % 4 == 0 for o in offs)
    for i in range(n - 1):
        assert offs[i] + (i + 4) // 4 * 4 <= offs[i + 1]
    assert offs[-1] + (n + 3) // 4 * 4 <= _packed_floats(n)
    for g0 in range(0, n - 7, 8):
        assert len({offs[i] // 4 % 8 for i in range(g0, g0 + 8)}) == 8
    assert _packed_floats(256) * 4 == 139264 <= 232448


def _sub_mul(x, y, z):
    """``__fsub_rn(x, __fmul_rn(y, z))``: a rounded product, then a rounded
    difference, never fused."""
    return torch.sub(x, torch.mul(y, z))


class _Packed:
    """A batch of matrices in a flat buffer at the packed offsets: every
    read and write goes through the rows' offsets, so an overlap of two
    rows or a read past the buffer shows as a wrong bit or an index
    error."""

    def __init__(self, a):
        batch, n, _ = a.shape
        self.n = n
        self.f = torch.full((batch, _packed_floats(n)), float("nan"))
        for i in range(n):  # the loader's float4s, up to the diagonal
            j1 = min((i + 4) // 4 * 4, n) if n % 4 == 0 else i + 1
            self.f[:, _row(i):_row(i) + j1] = a[:, i, :j1]

    def idx(self, rows, cols):
        return (torch.tensor([_row(i) for i in rows])[:, None]
                + torch.as_tensor(cols)[None, :]
                if isinstance(cols, range) else
                torch.tensor([[_row(i) + j for j in c]
                              for i, c in zip(rows, cols)]))

    def get(self, rows, cols):
        return self.f[:, self.idx(rows, cols)]

    def put(self, rows, cols, x, keep):
        """Store x[:, r, c] where keep(row, col)."""
        ix = self.idx(rows, cols)
        ri = torch.tensor(list(rows))[:, None]
        ci = (torch.as_tensor(cols)[None, :].expand(len(rows), -1)
              if isinstance(cols, range) else torch.tensor(cols))
        m = keep(ri, ci)
        self.f[:, ix[m]] = x[:, m]

    def lower(self):
        n = self.n
        out = torch.zeros((self.f.shape[0], n, n))
        for i in range(n):
            out[:, i, :i + 1] = self.f[:, _row(i):_row(i) + i + 1]
        return out


PANEL_READY, COLUMN_TAKEN, STRIP_DONE = 1, 2, 3  # chol_factor_band's barriers


def _inv_sqrt(x):
    """1 / sqrt(x) as ``cholesky_plain`` computes it (PyTorch's own sqrt:
    on this CPU it is not always NumPy's correctly rounded one)."""
    return torch.reciprocal(torch.sqrt(torch.from_numpy(x))).numpy()


def _band_row(i, n, border):
    """cholesky_common.cuh::CholBand::row: the packed rows, then (with the
    border) rows n and n + 1 on the stride chol_ld(n) after the
    triangle."""
    if border and i >= n:
        return _packed_floats(n) + (i - n) * ((n + 7) // 8 * 8 + 4)
    return _row(i)


def _tile_walk(n, nr, k1, k2, square):
    """chol_factor's trailing tiles (i0, j0) of one panel in its flat
    order on the packed layout: every 64-row tile of rows [k2, nr), its
    columns up to min(its last row, n - 1); or the square instances' (at
    most two row tiles, the second with every column up to n - 1) as a
    broken order for n > 144."""
    if square:
        m = n - k2
        last0 = k2 + min(TILE_ROWS, m) - 1
        tiles0 = (last0 - k1) // TILE_COLS + 1 if m > 0 else 0
        tiles = tiles0 + ((n - 1 - k1) // TILE_COLS + 1
                          if m > TILE_ROWS else 0)
        return [(k2 + (TILE_ROWS if t >= tiles0 else 0),
                 k1 + TILE_COLS * (t - tiles0 if t >= tiles0 else t))
                for t in range(tiles)]
    return [(i0, j0) for i0 in range(k2, nr, TILE_ROWS)
            for j0 in range(k1, min(i0 + TILE_ROWS, n), TILE_COLS)]


def _two_barrier_factor(a, square_walk=False):
    """chol_factor on the packed layout (K10's band instances, and K4 and
    K5 where two blocks share an SM), in NumPy float32 on a flat buffer at
    the packed offsets: each diagonal block updated by the previous
    panel's columns and factored column by column (warp 0; inv_k on the
    diagonal until the next step puts L[k][k] there), each strip solved
    right-looking by rows, and the rest of the trailing rows updated in 64
    × 8 tiles by the panel's columns in increasing order (two barriers a
    panel).  Returns L as a _Packed."""
    a = np.asarray(a, np.float32)
    batch, n, _ = a.shape
    off = np.array([_row(i) for i in range(n)])
    f = np.full((batch, _packed_floats(n)), np.nan, np.float32)
    for i in range(n):
        f[:, off[i]:off[i] + i + 1] = a[:, i, :i + 1]

    def ix(rows, cols):
        return off[np.asarray(rows)][:, None] + np.asarray(cols)[None, :]

    def diag_block(k0, kp, last):
        w = min(NB, n - k0)
        rows = np.arange(k0, k0 + w)
        m = np.tri(w, dtype=bool)
        blk = np.where(m, f[:, ix(rows, rows)], np.float32(0))
        if kp < k0:
            x = f[:, ix(rows, np.arange(kp, k0))]
            for k in range(k0 - kp):
                blk = blk - x[:, :, k:k + 1] * x[:, None, :, k]
        inv = []
        for c in range(w):
            inv.append(_inv_sqrt(blk[:, c, c]))
            blk[:, c:, c] = blk[:, c:, c] * inv[c][:, None]
            col = blk[:, c + 1:, c]
            blk[:, c + 1:, c + 1:] = (blk[:, c + 1:, c + 1:]
                                      - col[:, :, None] * col[:, None, :])
        lrr = np.diagonal(blk, axis1=1, axis2=2).copy()
        if not last:
            for c in range(w):
                blk[:, c, c] = inv[c]
        f[:, ix(rows, rows)[m]] = blk[:, m]
        return lrr

    lrr = diag_block(0, 0, n <= NB)
    for k0 in range(0, n - NB, NB):
        k1, k2 = k0 + NB, min(k0 + 2 * NB, n)
        rows, kc = np.arange(k1, n), np.arange(k0, k1)
        s = f[:, ix(rows, kc)]
        blk = f[:, ix(kc, kc)]
        for c in range(NB):
            s[:, :, c] = s[:, :, c] * blk[:, c, c][:, None]
            for r in range(c + 1, NB):
                s[:, :, r] = s[:, :, r] - s[:, :, c] * blk[:, r, c][:, None]
        f[:, ix(rows, kc)] = s
        for c in range(NB):  # warp 0 puts L[k][k] in place
            f[:, off[k0 + c] + k0 + c] = lrr[:, c]
        lrr = diag_block(k1, k0, k2 == n)
        for i0, j0 in _tile_walk(n, n, k1, k2, square_walk):
            rows = np.arange(i0, min(i0 + TILE_ROWS, n))
            cols = np.minimum(np.arange(j0, j0 + TILE_COLS), n - 1)
            keep = np.arange(j0, j0 + TILE_COLS)[None, :] <= rows[:, None]
            acc = f[:, ix(rows, cols)]
            x, y = f[:, ix(rows, kc)], f[:, ix(cols, kc)]
            for k in range(NB):
                acc = acc - x[:, :, k:k + 1] * y[:, None, :, k]
            f[:, ix(rows, cols)[keep]] = acc[:, keep]
    p = _Packed.__new__(_Packed)
    p.n = n
    p.f = torch.from_numpy(f)
    return p


def _packed_factor(a, rhs=None, ntw=7, first="panel", mutant=None):
    """chol_factor_band replayed in NumPy float32 on a flat buffer at
    CholBand's offsets, ``rhs`` ((batch, n, 2): d and a) bordered below
    the triangle as rows n and n + 1.  The panel warp (each diagonal block
    factored in registers, its L and inv stored, then the strip's first 8
    rows: the next block's rows, or after the last block the border rows)
    and ``ntw`` tile warps (the panel's column in 32-row pieces, piece q
    on warp q mod ntw: its strip rows, rows below n times inv_k and border
    rows divided by L[k][k], then its rows of the next panel's column;
    kColumnTaken; kStripDone; then the rest of the panel in 64 x 8 tiles,
    tile t of the flat order on warp t mod ntw) run as generators.  A
    scheduler models the named barriers as the hardware counts them
    (every participating warp's arrive or sync counts; a sync blocks until
    the count reaches them all: every warp, or the tile warps for
    kStripDone) and always runs ``first`` ("panel" or "tiles") when it
    can.  Every element carries tags, the panels applied to it and whether
    it is final; each step checks the tags of what it reads and writes,
    and a mismatch, a deadlock, an unbalanced barrier or an element left
    unfinished is recorded.  Returns (L as a _Packed, the border rows
    (batch, n, 2) or None, the violations).  Broken versions:
    ``factor_early`` (the panel warp does not wait for the next column),
    ``border_times_inv`` (a border row multiplied by inv_k),
    ``skip_last_border`` (no strip after the last panel's block),
    ``no_strip_barrier`` (the rest of a panel before every strip row is
    solved), ``square_tile_walk`` (the rest of a panel on at most two row
    tiles, the square instances' walk)."""
    a = np.asarray(a, np.float32)
    batch, n, _ = a.shape
    border = rhs is not None
    nr = n + 2 if border else n
    off = np.array([_band_row(i, n, border) for i in range(nr)])
    size = _packed_floats(n) + (2 * ((n + 7) // 8 * 8 + 4) if border else 0)
    f = np.full((batch, size), np.nan, np.float32)
    for i in range(n):
        f[:, off[i]:off[i] + i + 1] = a[:, i, :i + 1]
    if border:
        rhs = np.asarray(rhs, np.float32)
        for r in range(2):
            f[:, off[n + r]:off[n + r] + n] = rhs[:, :, r]
    applied = np.zeros((nr, n), np.int64)  # panels applied
    final = np.zeros((nr, n), bool)
    elem = np.tri(nr, n, dtype=bool)  # j <= i; every j < n on the border
    pinv = {}  # the panel warp's inv, by panel
    violations = []

    def ix(rows, cols):
        return off[np.asarray(rows)][:, None] + np.asarray(cols)[None, :]

    def expect(ok, what):
        if not np.all(ok):
            violations.append(what)

    def solve(rows, k0, w, b, inv):
        """Strip rows ``rows`` of the panel at k0 from its block b (L)."""
        if mutant == "skip_last_border" and k0 + NB >= n:
            rows = rows[rows < n]
        if not len(rows):
            return
        p, cols = k0 // NB, np.arange(k0, k0 + w)
        expect(applied[np.ix_(rows, cols)] == p,
               f"strip {p} solved before it took every earlier panel")
        block = final[np.ix_(np.arange(k0, k0 + w), cols)]
        expect(block[np.tri(w, dtype=bool)],
               f"strip {p} solved before its block")
        s = f[:, ix(rows, cols)]
        bd = (rows >= n) & (mutant != "border_times_inv")
        for c in range(w):
            s[:, ~bd, c] = s[:, ~bd, c] * inv[c][:, None]
            s[:, bd, c] = s[:, bd, c] / b[:, c, c][:, None]
            for r in range(c + 1, w):
                s[:, :, r] = s[:, :, r] - s[:, :, c] * b[:, r, c][:, None]
        f[:, ix(rows, cols)] = s
        final[np.ix_(rows, cols)] = True

    def panel_step(k0):
        p, w = k0 // NB, min(NB, n - k0)
        rows = cols = np.arange(k0, k0 + w)
        m = elem[np.ix_(rows, cols)]
        expect(applied[np.ix_(rows, cols)][m] == p,
               f"block {p} factored before it took every earlier panel")
        b = np.where(m, f[:, ix(rows, cols)], np.float32(0))
        inv = []
        for c in range(w):
            inv.append(_inv_sqrt(b[:, c, c]))
            b[:, c:, c] = b[:, c:, c] * inv[c][:, None]
            col = b[:, c + 1:, c]
            b[:, c + 1:, c + 1:] = (b[:, c + 1:, c + 1:]
                                    - col[:, :, None] * col[:, None, :])
        f[:, ix(rows, cols)[m]] = b[:, m]
        final[np.ix_(rows, cols)] |= m
        pinv[p] = inv
        solve(np.arange(k0 + w, min(k0 + w + NB, nr)), k0, w, b, inv)

    def tile(i0, j0, k0, height=TILE_ROWS):
        rows = np.arange(i0, min(i0 + height, nr))
        cols = np.minimum(np.arange(j0, j0 + TILE_COLS), n - 1)
        keep = np.arange(j0, j0 + TILE_COLS)[None, :] <= np.minimum(
            rows, n - 1)[:, None]
        ri, ci = np.nonzero(keep)
        gi, gj = rows[ri], cols[ci]
        kc = np.arange(k0, k0 + NB)
        expect(applied[gi, gj] == k0 // NB,
               f"panel {k0 // NB} applied out of order at tile {i0, j0}")
        expect(~final[gi, gj], f"tile {i0, j0} wrote a final element")
        expect(final[np.ix_(np.unique(gi), kc)],
               f"tile {i0, j0} read L's rows before panel {k0 // NB}")
        expect(final[np.ix_(np.unique(gj), kc)],
               f"tile {i0, j0} read L's columns before panel {k0 // NB}")
        acc = f[:, ix(rows, cols)]
        x, y = f[:, ix(rows, kc)], f[:, ix(cols, kc)]
        for k in range(NB):
            acc = acc - x[:, :, k:k + 1] * y[:, None, :, k]
        f[:, ix(rows, cols)[keep]] = acc[:, keep]
        applied[gi, gj] += 1

    def panel_warp():
        for k0 in range(0, n, NB):
            if k0 > 0 and mutant != "factor_early":
                yield "sync", COLUMN_TAKEN
            panel_step(k0)
            if k0 + NB < n:
                yield "arrive", PANEL_READY
            yield "run", None

    def tile_warp(tw):
        for k0 in range(0, n - NB, NB):
            k1, k2 = k0 + NB, min(k0 + 2 * NB, n)
            yield "sync", PANEL_READY
            pieces = -(-(nr - k1) // 32)
            mine = range(tw, pieces, ntw)
            if len(mine):
                rows = k0 + np.arange(NB)
                b = np.where(np.tri(NB, dtype=bool), f[:, ix(rows, rows)],
                             np.float32(0))
                for q in mine:
                    i = np.arange(k1 + 32 * q, min(k1 + 32 * q + 32, nr))
                    solve(i[i >= k1 + NB], k0, NB, b, pinv[k0 // NB])
                    yield "run", None
                for q in mine:
                    tile(k1 + 32 * q, k1, k0, height=32)
                    yield "run", None
            yield "arrive", COLUMN_TAKEN
            if mutant != "no_strip_barrier":
                yield "sync", STRIP_DONE
            t = tw
            for r in range(2 if mutant == "square_tile_walk" else 4):
                i0 = k2 + TILE_ROWS * r
                if i0 >= nr or k2 >= n:
                    break
                cols = (min(i0 + TILE_ROWS, n) - 1 - k2) // TILE_COLS + 1
                while t < cols:
                    tile(i0, k2 + TILE_COLS * t, k0)
                    t += ntw
                    yield "run", None
                t -= cols

    agents = [panel_warp()] + [tile_warp(t) for t in range(ntw)]
    order = (list(range(len(agents))) if first == "panel"
             else list(range(1, len(agents))) + [0])
    members = {PANEL_READY: len(agents), COLUMN_TAKEN: len(agents),
               STRIP_DONE: ntw}
    count = dict.fromkeys(members, 0)
    waiting = {bar: [] for bar in members}
    alive, blocked = set(order), set()
    while alive:
        ready = [g for g in order if g in alive and g not in blocked]
        if not ready:
            violations.append("deadlock")
            break
        g = ready[0]
        try:
            act, bar = next(agents[g])
        except StopIteration:
            alive.discard(g)
            continue
        if act == "run":
            continue
        count[bar] += 1
        if act == "sync":
            waiting[bar].append(g)
            blocked.add(g)
        if count[bar] == members[bar]:
            count[bar] = 0
            blocked.difference_update(waiting[bar])
            waiting[bar] = []
    expect(np.array(list(count.values())) == 0, "an unbalanced barrier")
    expect(final[elem], "an element left unfinished")
    expect(applied[elem] == np.broadcast_to(np.arange(n) // NB,
                                            (nr, n))[elem],
           "an element that missed a panel")
    p = _Packed.__new__(_Packed)
    p.n = n
    p.f = torch.from_numpy(f[:, :_packed_floats(n)].copy())
    y = (np.stack([f[:, off[n + r]:off[n + r] + n] for r in range(2)], -1)
         if border else None)
    return p, y, violations


def _w_in_place(p, mutant=None):
    """chol_tri_inverse_in_place in plain PyTorch: W = L⁻¹ over L,
    right-looking by 8-row panels, one step a panel p = [k0, k1).  The
    columns j < k1 of the panel's rows first take panel p - 1 (L's columns
    from strip p - 1, W's rows kp..k0 from the buffer, zero above their
    diagonal), then the panel's own rows from the saved diagonal block and
    the divisions, and are stored whole (zeros above the diagonal); then
    the next diagonal block is saved, the 64 × 8 tiles apply panel p - 1 to
    rows [k1, n), columns [0, k0), from the strip, in the kernel's order
    (the warps take tiles from a counter in the flat order; each writes its
    tile over K at once), and strip p (L[k1..n)[k0..k1)) replaces strip p -
    1: one buffer, half of each row in the scratch and half in the row's
    last float4 of the packed buffer.  Broken orders: ``tiles_read_k``
    takes each tile's L operand from K instead of the strip, after the
    tiles of the panel's own columns (j0 = kp) have stored W over it;
    ``panel_order`` defers the first tile of a step to the next step and
    applies the two panels to it in reverse order; ``early_strip`` saves
    strip p before the tiles that still read strip p - 1."""
    n = p.n
    batch = p.f.shape[0]
    n8 = (n + 7) // 8 * 8
    strip = torch.full((batch, n8, 4), float("nan"))
    blocks = [torch.full((batch, NB, NB), float("nan")) for _ in range(2)]

    def slot(rows):  # row i's last float4: 8 (i // 8) + 8 .. + 12
        return (torch.tensor([_row(i) + 8 * (i // 8) + 8 for i in rows])
                [:, None] + torch.arange(4)[None, :])

    def read_strip(rows):
        rows = list(rows)
        return torch.cat([strip[:, rows], p.f[:, slot(rows)]], -1)

    def save_strip(k0, k1):
        rows = list(range(k1, n))
        v = p.get(rows, range(k0, k1))
        strip[:, rows] = v[..., :4]
        p.f[:, slot(rows)] = v[..., 4:]

    def save_block(k1, slot_):
        for r in range(min(NB, n - k1)):
            blocks[slot_][:, r] = p.f[:, _row(k1 + r) + k1:
                                      _row(k1 + r) + k1 + NB]

    def tile(i0, j0, x_of, panels):
        rows = [i for i in range(i0, min(i0 + TILE_ROWS, n))]
        ix = p.idx(rows, range(j0, j0 + TILE_COLS))
        acc = (torch.zeros((batch, len(rows), TILE_COLS)) if j0 == panels[0]
               else p.f[:, ix])
        for q in panels:
            x = x_of(rows, q)
            y = p.get(range(q, q + NB), range(j0, j0 + TILE_COLS))
            for k in range(NB):
                acc = _sub_mul(acc, x[:, :, k:k + 1], y[:, None, k, :])
        p.f[:, ix] = acc

    deferred = None
    save_block(0, 0)
    for step, k0 in enumerate(range(0, n, NB)):
        k1, kp = min(k0 + NB, n), k0 - NB
        lb = blocks[step % 2]
        rows = range(k0, k1)
        w = torch.zeros((batch, NB, k1))
        for r, i in enumerate(rows):
            if kp > 0:
                w[:, r, :kp] = p.f[:, _row(i):_row(i) + kp]
            if k0 <= i < k1:
                w[:, r, i] = 1.0
        if k0 > 0:
            wk = p.get(range(kp, k0), range(k0))
            lp = read_strip(range(k0, k0 + NB))
            for r in range(k1 - k0):
                for kk in range(NB):
                    w[:, r, :k0] = _sub_mul(w[:, r, :k0], lp[:, r, kk:kk + 1],
                                            wk[:, kk])
        for r in range(NB):
            for c in range(r):
                w[:, r] = _sub_mul(w[:, r], lb[:, r, c:c + 1], w[:, c])
            w[:, r] = torch.div(w[:, r], lb[:, r, r:r + 1])
        for r, i in enumerate(rows):
            p.f[:, _row(i):_row(i) + k1] = w[:, r]
        if k1 >= n:
            continue
        if mutant == "early_strip":
            save_strip(k0, k1)
        save_block(k1, (step + 1) % 2)
        if k0 > 0:
            if deferred is not None:  # panel_order: the later panel first
                i0, j0, q, old = deferred
                tile(i0, j0, lambda r, qq: (read_strip(r) if qq == kp
                                            else old[:, r]), [kp, q])
                deferred = None
            cols = k0 // TILE_COLS
            tiles = [(k1 + TILE_ROWS * (t // cols), TILE_COLS * (t % cols))
                     for t in range(-(-(n - k1) // TILE_ROWS) * cols)]
            if mutant == "tiles_read_k":
                tiles.sort(key=lambda t: -t[1])
            for i0, j0 in tiles:
                if mutant == "panel_order" and (i0, j0) == (k1, 0) and \
                        k1 + NB < n and j0 < kp:
                    deferred = (i0, j0, kp, read_strip(range(n8)))
                    continue
                if mutant == "tiles_read_k":
                    x_of = lambda r, q: p.get(r, range(q, q + NB))  # noqa
                else:
                    x_of = lambda r, q: read_strip(r)  # noqa: E731
                tile(i0, j0, x_of, [kp])
        if mutant != "early_strip":
            save_strip(k0, k1)
    return p.lower()


@pytest.mark.parametrize("n", [129, 200, 256, 225, 255, 209, 224])
def test_packed_schedule_is_bitwise_the_plain_order(n):
    """The two-barrier factor on the packed layout (chol_factor: K10's band
    instances, K4's and K5's where two blocks share an SM) gives L bit for
    bit ``cholesky_plain``'s, and W = L⁻¹ built in place over it
    right-looking bit for bit ``forward_substitution_plain(L, I)``'s, half
    of its strip in the rows' last float4, which no element of L or W may
    reach (n = 129: one row past the square instances; 200: a partial last
    row tile; 225 and 255: a partial last panel; 256: the ceiling; 209: one
    row into its last panel; 224: the largest n at which K10 with W runs
    256 threads a block).  The band factor's L: the bordered test below."""
    a = torch.tensor(_spd(2, n, 1900 + n))
    l_ref = cuda_cholesky.cholesky_plain(a)
    p = _two_barrier_factor(a)
    assert torch.equal(p.lower(), l_ref)
    eye = torch.eye(n).expand_as(a)
    assert torch.equal(_w_in_place(p),
                       cuda_cholesky.forward_substitution_plain(l_ref, eye))


@pytest.mark.parametrize("mutant", ["square_tile_walk", "tiles_read_k",
                                    "panel_order", "early_strip"])
def test_packed_replay_catches_a_broken_order(mutant):
    """The square instances' tile walk leaves rows past the second row
    tile without their updates at n = 200 (the two-barrier factor's L
    changes bits); W's tiles reading L from K after the tiles of the
    panel's own columns stored W there, a tile taking panel p before panel
    p - 1, or strip p saved before the tiles that read strip p - 1,
    change bits of W."""
    n = 200
    a = torch.tensor(_spd(2, n, 2900 + n))
    l_ref = cuda_cholesky.cholesky_plain(a)
    if mutant == "square_tile_walk":
        assert not torch.equal(
            _two_barrier_factor(a, square_walk=True).lower(), l_ref)
        return
    p = _two_barrier_factor(a)
    w_ref = cuda_cholesky.forward_substitution_plain(
        l_ref, torch.eye(n).expand_as(a))
    assert not torch.equal(_w_in_place(p, mutant), w_ref)


def _bordered(n, seed, batch=2):
    """K5's system as the kernel stages it: K = B + diag(c) (the diagonal
    one rounded sum) and [d a], with the plain versions' L and [y_d y_a]
    = L⁻¹[d a]."""
    data, _ = _gp_system(batch, n, seed)
    t = {k: torch.tensor(v) for k, v in data.items()}
    k = linalg.add_diagonal(t["b"], t["c"][..., 0])
    rhs = torch.cat([t["d"], t["a"]], -1)
    l = cuda_cholesky.cholesky_plain(k)
    return k, rhs, l, cuda_cholesky.forward_substitution_plain(l, rhs)


@pytest.mark.parametrize("n", [129, 131, 136, 160, 200, 225, 232, 255, 256])
def test_bordered_factor_gives_the_substitutions_bits(n):
    """K5's band instance: d and a bordered below the triangle as rows n
    and n + 1 and carried through the band factor (the tile warps' tiles,
    their strip rows divided by L[k][k], the panel warp's strip after the
    last block) come out as y_d and y_a bit for bit
    ``forward_substitution_plain``'s, beside L bit for bit
    ``cholesky_plain``'s, at the 15 tile warps of its 512-thread blocks
    (n = 131 and 255: a last panel of 3 and 7 columns)."""
    k, rhs, l_ref, y_ref = _bordered(n, 3500 + n)
    p, y, violations = _packed_factor(k, rhs.numpy(), ntw=15)
    assert violations == []
    assert torch.equal(p.lower(), l_ref)
    assert torch.equal(torch.from_numpy(y), y_ref)


@pytest.mark.parametrize("first", ["panel", "tiles"])
@pytest.mark.parametrize("ntw", [7, 15, 2])
def test_band_handoffs_replay_clean(first, ntw):
    """The hand-offs on tagged elements at n = 147 with the border, under
    the schedule that runs the panel warp whenever it can and the one that
    runs the tile warps first, at 7 and 15 tile warps and at 2 (several
    column tiles a warp): no tag mismatch, no deadlock, no unbalanced
    barrier, and the plain versions' bits."""
    k, rhs, l_ref, y_ref = _bordered(147, 3647)
    p, y, violations = _packed_factor(k, rhs.numpy(), ntw=ntw, first=first)
    assert violations == []
    assert torch.equal(p.lower(), l_ref)
    assert torch.equal(torch.from_numpy(y), y_ref)


@pytest.mark.parametrize("mutant", ["factor_early", "border_times_inv",
                                    "skip_last_border", "no_strip_barrier",
                                    "square_tile_walk"])
def test_band_handoffs_replay_catches_a_broken_protocol(mutant):
    """The replay fails the panel warp factoring a block before the next
    column took the panel (the tags), a border row multiplied by inv_k
    (y's bits), the border's last strip step skipped (the tags and y's
    bits) and a tile warp starting the rest of a panel before every strip
    row is solved (the tags, when the tile warps run first) and the rest
    of a panel on the square instances' two row tiles (the tags), at n =
    147 with the border."""
    k, rhs, l_ref, y_ref = _bordered(147, 3647)
    p, y, violations = _packed_factor(
        k, rhs.numpy(), mutant=mutant,
        first="tiles" if mutant == "no_strip_barrier" else "panel")
    y_ok = torch.equal(torch.from_numpy(y), y_ref)
    if mutant == "border_times_inv":
        assert violations == [] and not y_ok
    elif mutant == "skip_last_border":
        assert violations and not y_ok
    else:
        assert violations
        if mutant == "square_tile_walk":
            assert not torch.equal(p.lower(), l_ref)


def _lane_order_sum(x, square):
    """K10's warp sum in NumPy float32: lane l adds x[l], x[l + 32], …
    (squared first with ``square``) to 0, then lane l adds lane l ^ o for
    o = 16, 8, 4, 2, 1 (lanes that ran out of elements add nothing)."""
    lanes = np.zeros(32, np.float32)
    for i, v in enumerate(np.asarray(x, np.float32)):
        lanes[i % 32] = lanes[i % 32] + (v * v if square else v)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ o]
    return lanes[0]


@pytest.mark.parametrize("n", [129, 200])
def test_k10_plain_sums_in_the_packed_kernels_order(n):
    """``lml_quad_logdet_plain`` sums as K10's packed instance does, which
    the card holds it to bit for bit: tᵢ = Σₖ Wᵢₖ dₖ and αⱼ = Σᵢ Wᵢⱼ tᵢ one
    rounded product and one rounded sum at a time in increasing index,
    quad = Σ t² (or Σ y² without W) and log|K| = 2 Σ log Lₖₖ lane by lane
    and then across the lanes (a NumPy float32 replay of one system)."""
    b, c, d = (torch.tensor(x) for x in _lml_system(1, n, 3100 + n))
    c, d = c[..., 0], d[..., 0]
    quad, logdet, w, alpha = cuda_gp_lml.lml_quad_logdet_plain(b, c, d, True)
    quad0, logdet0 = cuda_gp_lml.lml_quad_logdet_plain(b, c, d)
    l = cuda_cholesky.cholesky_plain(linalg.add_diagonal(b, c))[0].numpy()
    y = cuda_cholesky.forward_substitution_plain(
        torch.tensor(l)[None], d[..., None])[0, :, 0].numpy()
    w0, d0 = w[0].numpy(), d[0].numpy()
    t = np.zeros(n, np.float32)  # row i takes k = 0, 1, ..., i
    for k in range(n):
        t[k:] = t[k:] + w0[k:, k] * d0[k]
    al = np.zeros(n, np.float32)  # column j takes i = j, j + 1, ...
    for i in range(n):
        al[:i + 1] = al[:i + 1] + w0[i, :i + 1] * t[i]
    logs = torch.log(torch.diagonal(torch.tensor(l))).numpy()
    ld = np.float32(2) * _lane_order_sum(logs, False)
    assert np.array_equal(alpha[0].numpy(), al)
    assert quad[0].item() == _lane_order_sum(t, True)
    assert quad0[0].item() == _lane_order_sum(y, True)
    assert logdet[0].item() == logdet0[0].item() == ld


# ---- the port against the JAX package --------------------------------------

@pytest.mark.parametrize("n", [136, 160, 256])
def test_k4_band_matches_jax(n):
    """K4's plain version (the band instance's bits) against the JAX
    kernel: fp32 on both sides, the same right-looking order — 1e-5
    relative; both 1e-5 of the fp64 factor."""
    a = _spd(2, n, 4100 + n)
    ref = np.asarray(pallas_cholesky.cholesky(a, block=1))
    l = cuda_cholesky.cholesky(torch.tensor(a)).numpy()
    assert l.dtype == np.float32 and l.shape == a.shape
    assert (np.triu(l, 1) == 0).all()
    assert _rel(l, ref) <= 1e-5
    assert _rel(l, np.linalg.cholesky(a.astype(np.float64))) <= 1e-5


@pytest.fixture(scope="module")
def gp160():
    data, g = _gp_system(3, 160, 5160)
    ref = [np.asarray(x) for x in pallas_gp.gp_mean_variance_fused(
        *(data[k] for k in "abcde"), block=1)]
    return data, g, ref


def test_k5_band_matches_jax(gp160):
    """``gp_mean_variance_fused`` at n = 160 (K5's plain version) against
    the JAX kernel (its panel width 32): the same factor, the two dot
    products in another order — 1e-5 absolute; both within 1e-4 of the
    fp64 closed form."""
    data, g, ref = gp160
    got = [x.numpy() for x in cuda_gp.gp_mean_variance_fused(
        *(torch.tensor(data[k]) for k in "abcde"))]
    for x, r, exact in zip(got, ref, (g["means"], g["variances"])):
        assert x.shape == (3, 1, 1) and x.dtype == np.float32
        assert np.abs(x - r).max() <= 1e-5
        assert np.abs(x - exact).max() < 1e-4
        assert np.abs(r - exact).max() < 1e-4


@pytest.fixture(scope="module")
def lml160():
    b, c, d = _lml_system(3, 160, 10160)
    ref = {emit_w: [np.asarray(x) for x in pallas_gp._lml_fused_quad_logdet(
        b, c, d, emit_w=emit_w, block=1)] for emit_w in (False, True)}
    return (b, c, d), ref


@pytest.mark.parametrize("emit_w", [False, True])
def test_k10_band_matches_jax(lml160, emit_w):
    """quad and logdet (with ``emit_w`` also W = L⁻¹ and α = K⁻¹d) at
    n = 160 against the JAX kernel's blocked factor-inverse body: 1e-5
    relative, the same factorization in another summation order."""
    (b, c, d), ref = lml160
    got = cuda_gp_lml.lml_quad_logdet(
        *(torch.tensor(x) for x in (b, c[..., 0], d[..., 0])), emit_w=emit_w)
    assert len(got) == len(ref[emit_w]) == (4 if emit_w else 2)
    for x, r in zip(got, ref[emit_w]):
        assert tuple(x.shape) == r.shape
        assert _rel(x.numpy(), r) <= 1e-5
    if emit_w:
        assert (np.triu(got[2].numpy(), 1) == 0).all()


def test_k10_band_gradients_match_jax(lml160):
    """∂/∂b, ∂/∂c, ∂/∂d of Σ LML at n = 160 through the port's analytic
    backward against the JAX custom VJP's backward (``_lml_fused_bwd``)
    on the JAX kernel's own W and α, at the JAX test's 2e-3; the LML
    against JAX's at its rtol 1e-4 / atol 1e-3."""
    (b, c, d), ref = lml160
    quad, logdet, w, alpha = ref[True]
    args = [torch.tensor(x, requires_grad=True) for x in (b, c, d)]
    lml = cuda_gp_lml.gp_log_marginal_likelihood_fused(*args)
    np.testing.assert_allclose(
        lml.detach().numpy(), np.asarray(pallas_gp._lml_from(quad, logdet,
                                                            160)),
        rtol=1e-4, atol=1e-3)
    lml.sum().backward()
    grads = pallas_gp._lml_fused_bwd((w, alpha), np.ones(3, np.float32))
    for x, r in zip(args, grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=2e-3)


# ---- the routes ------------------------------------------------------------

@pytest.mark.parametrize("n", [129, 256, 257])
def test_routes_around_the_band(n, monkeypatch):
    """Up to 256 the three entry points run the kernels' plain versions on
    CPU tensors (the band instances' arithmetic) and launch nothing; at
    257 they take the JAX package's routes past its kernels: the library
    factor, the Schur solve (``gp_schur_route``) and the ``torch.linalg``
    LML.  Each result equals (``torch.equal``) its route's own."""
    counters = (cuda_cholesky.cholesky_cuda, cuda_gp.gp_fused_cuda,
                cuda_gp_lml.lml_quad_logdet_cuda)
    before = [(f.launches, f.band_launches) for f in counters]
    before_w = cuda_gp_lml.lml_quad_logdet_cuda.band_emit_w_launches
    calls = []
    for name in ("cholesky_plain", "forward_substitution_plain"):
        fn = getattr(cuda_cholesky, name)
        monkeypatch.setattr(cuda_cholesky, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    a = torch.tensor(_spd(1, n, 6000 + n))
    l = cuda_cholesky.cholesky(a)
    band = n <= cuda_build.CHOL_MAX_N
    assert torch.equal(l, cuda_cholesky.cholesky_plain(a) if band
                       else linalg.cholesky(a))
    data, _ = _gp_system(1, n, 6100 + n)
    t = [torch.tensor(data[k]) for k in "abcde"]
    got = torch.cat(cuda_gp.gp_mean_variance_fused(*t), -1)
    if band:
        out = cuda_gp.gp_fused_plain(*cuda_gp._flat(*t, max_n=n))
        assert torch.equal(got[:, 0, :], out)
    else:
        assert torch.equal(got, torch.cat(cuda_gp.gp_schur_route(*t), -1))
    b, c, d = (torch.tensor(x) for x in _lml_system(1, n, 6200 + n))
    lml = cuda_gp_lml.gp_log_marginal_likelihood_fused(b, c, d)
    if band:
        quad, logdet = cuda_gp_lml.lml_quad_logdet_plain(b, c[..., 0],
                                                         d[..., 0])
        assert torch.equal(lml, cuda_gp_lml._lml_from(quad, logdet, n))
        assert "cholesky_plain" in calls
    else:
        assert torch.equal(lml, gp.gp_log_marginal_likelihood(b, c, d))
    assert [(f.launches, f.band_launches) for f in counters] == before
    assert cuda_gp_lml.lml_quad_logdet_cuda.band_emit_w_launches == before_w


def test_f64_routes_and_kernel_checks_in_the_band():
    """float64 keeps the library routes in the band; the kernels' wrappers
    take n ≤ 256 and a CUDA float32 tensor, and raise otherwise (K3
    keeps 128)."""
    a64 = torch.tensor(make_spd_batch(1, 160, np.random.default_rng(7)))
    assert torch.equal(cuda_cholesky.cholesky(a64), linalg.cholesky(a64))
    data, _ = _gp_system(1, 160, 7160)
    t = [torch.tensor(data[k], dtype=torch.float64) for k in "abcde"]
    mean, var = cuda_gp.gp_mean_variance_fused(*t)
    x = linalg.spd_solve(linalg.add_diagonal(t[1], t[2]),
                         torch.cat([t[3], t[0]], -1))
    proj = t[0].mT @ x
    assert mean.dtype == torch.float64
    np.testing.assert_allclose(mean.numpy(), proj[:, :, 0:1].numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(var.numpy(), (t[4] - proj[:, :, 1:2]).numpy(),
                               rtol=1e-12)
    b, c, d = (torch.tensor(x, dtype=torch.float64)
               for x in _lml_system(1, 160, 7161))
    assert torch.equal(cuda_gp_lml.gp_log_marginal_likelihood_fused(b, c, d),
                       gp.gp_log_marginal_likelihood(b, c, d))
    a = torch.eye(160)[None]
    v = torch.ones(1, 160)
    for fn, args in ((cuda_cholesky.cholesky_cuda, (a,)),
                     (cuda_gp.gp_fused_cuda, (v, a, v, v, torch.ones(1))),
                     (cuda_gp_lml.lml_quad_logdet_cuda, (a, v, v))):
        with pytest.raises(ValueError, match="float32 CUDA"):
            fn(*args)
    a, v = torch.eye(257)[None], torch.ones(1, 257)
    for fn, args in ((cuda_cholesky.cholesky_cuda, (a,)),
                     (cuda_gp.gp_fused_cuda, (v, a, v, v, torch.ones(1))),
                     (cuda_gp_lml.lml_quad_logdet_cuda, (a, v, v))):
        with pytest.raises(ValueError, match="1..256"):
            fn(*args)
    with pytest.raises(ValueError, match="1..128"):
        cuda_cholesky.inverse_cholesky_cuda(torch.eye(129)[None])


def test_chol_band_probe_patches_match_the_kernel_source():
    """The card probe of the packed instances (``bench/chol_band_probe.py``)
    builds its stamped variants (K4; K5 and K10 in one gp.cu; the band
    factor's steps on the panel warp and on the first tile warp, W's) and
    its pinned builds (every packed instance at one block size, K4 and K5
    on one factor) and its square instances' split by patching ``csrc/``:
    every anchor must still occur as often as the probe expects, and the
    probe refuses to run without a card."""
    from cuda_matrix_inversion_tpu_torch.bench import chol_band_probe, chol_probe

    for unit, patches in (
            ("cholesky.cu", chol_band_probe.K4_STAMPS),
            ("gp.cu", [*chol_band_probe.K10_STAMPS,
                       *chol_band_probe.K5_STAMPS]),
            ("cholesky_common.cuh",
             [*chol_band_probe.BAND_STEPS, *chol_band_probe.W_STEPS]),
            ("cholesky_common.cuh", chol_probe.STEPS),
            *[(unit, patches) for threads in chol_band_probe.THREADS
              for unit, (patches, _) in
              chol_band_probe._threads_patch(threads).items()]):
        src = (cuda_build.CSRC_DIR / unit).read_text()
        for anchor, _, count in patches:
            assert src.count(anchor) == count, (unit, anchor)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            chol_band_probe.main()
