"""Dense per-cell particle table — the vectorized replacement for the
reference's binned-particle indirection.

The reference's GPU pipeline bins particles (count + prefix sum + scatter)
and then *iterates variable-length per-cell particle lists* inside its
seeding/P2G kernels (gpParticleIndexing.hlsli, gpComputeClosestParticle-
Neighbors.hlsl, gpTransferParticleVelocities*.hlsl).  Dynamic-length lists
are hostile to vectorization, and XLA element gathers/scatters are paid per
transaction — the binned-list formulation is transaction-bound.

Instead we build a dense per-cell table of up to K particles, stored as
[pos(3), vel(3), present(1), pad] and laid out (nx, ny, K, 8, nz) with the
z axis minor (full 128-lane vectors for every consumer).  Building it costs
one joint key sort plus one bounded index scatter; every consumer (seeding, P2G
transfer) then becomes pure shifted-window arithmetic over dense arrays —
zero gathers, zero scatters, full VPU utilization.

Slot order within a cell is original-particle-index order (stable argsort),
which reproduces the reference's first-wins tie-breaks.  Cells holding more
than K particles overflow: overflow particles are counted (``n_overflow``)
and their *indices* captured (up to ``overflow_cap``) so callers can apply
an exact fallback; with the default K = 2*ppc^3 + 4 overflow is empty in
practice (the dam break seeds ppc^3 per cell).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from .common import cell_of, rank_ge


def default_k(cfg: SimConfig) -> int:
    """Slots per cell: nominal seeding density + headroom.  Mild compression
    beyond K is handled exactly by the bounded overflow corrections; the
    table's memory/bandwidth cost is linear in K, so keep it tight."""
    return cfg.particles_per_cell_axis**3 + 4


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CellTable:
    """slots: (nx, ny, K, 8, nz) f32, fields [px,py,pz, vx,vy,vz, present,
    0] along axis 3, positions in *cell units*; n_overflow: scalar int32;
    overflow_idx: (overflow_cap,) int32 particle indices (== N unused)."""

    slots: Any
    n_overflow: Any
    overflow_idx: Any


def build_cell_table(
    cfg: SimConfig, pos, vel, k: int | None = None,
    overflow_cap: int | None = None,
) -> CellTable:
    """Build the dense table from positions in METERS (the public form).
    See _build_from_cells for the algorithm.  overflow_cap defaults to
    cfg.overflow_cap (auto-raised by drivers, see step3d.overflow_autotune)."""
    K = default_k(cfg) if k is None else k
    cap = cfg.overflow_cap if overflow_cap is None else overflow_cap
    m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
    return _build_from_cells(
        (cfg.nx, cfg.ny, cfg.nz), K, pos * m, vel, None, cap
    )


def _build_from_cells(
    dims, K: int, pc, vel, valid=None, overflow_cap: int = 4096
) -> CellTable:
    """Design: row gathers are paid per row and scatters per ELEMENT, so
    the build is organized as three gathers and one small scatter:

      1. one ``lax.sort`` of (cell key, index) pairs — grouping;
      2. ``payload[perm]`` — 1 row gather (8 lanes) per particle;
      3. per-cell START offsets — a 1-element scatter-min of run starts
         plus a log-passes suffix fill (empty cells inherit the next start);
      4. the dense table as ONE 64-lane row gather per CELL: a windowed view
         ``win64[i] = sorted payload rows [i, i+8)`` (built with 8 cheap
         shifted copies) makes each cell's <=K slots one contiguous row at
         ``win64[start_c]`` — ncells rows instead of the round-1 form's
         ncells*K rows (the single hottest op of the round-1 step).

    Presence/overflow masking is dense arithmetic on the counts.

    pc: positions in CELL units; valid: optional (n,) bool — invalid rows
    (e.g. padding in a sharded shard-local build) are excluded from the
    table, counts, and overflow."""
    nx, ny, nz = dims
    # Window width: 8 or 16 payload rows (64/128-lane gather rows — both in
    # the fast-gather regime; 16-40 lane rows are 3-5x slower).
    W = 8 if K <= 8 else 16
    assert K <= W, "windowed build fetches at most 16 payload rows per cell"
    n = pc.shape[0]
    ncells = nx * ny * nz
    cell = cell_of(pc)
    lin = (cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]
    present_in = jnp.ones((n, 1), jnp.float32)
    if valid is not None:
        # Invalid rows sort to the sentinel cell `ncells` past every real
        # cell (counts/overflow never see them).
        lin = jnp.where(valid, lin, ncells)
        present_in = jnp.where(valid[:, None], present_in, 0.0)

    # Stable single-key sort carrying the particle index: within-cell slot
    # order == original particle-index order (the reference's first-wins
    # tie-break).  num_keys=1 + is_stable replaces a num_keys=2 pair sort.
    idx = jnp.arange(n, dtype=jnp.int32)
    lin_s, perm = jax.lax.sort((lin, idx), num_keys=1, is_stable=True)

    payload = jnp.concatenate(
        [
            pc,
            vel,
            present_in,
            jnp.zeros((n, 1), jnp.float32),
        ],
        axis=1,
    )
    payload_s = payload[perm]

    # Per-cell start offsets into the sorted order: histogram + exclusive
    # cumsum (in place of scatter-min + suffix-fill).  Empty cells inherit the next occupied
    # start by construction.  Invalid rows (lin == ncells) drop out of the
    # histogram, so starts[ncells] == n_valid (only ever consulted for
    # invalid rows, which the overflow extraction excludes).
    counts_all = jnp.zeros(ncells, jnp.int32).at[lin].add(1, mode="drop")
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts_all)]
    )
    counts = counts_all  # true per-cell counts (may exceed K)

    # Windowed view: row i = sorted payload rows [i, i+W).
    pe = jnp.concatenate([payload_s, jnp.zeros((W, 8), jnp.float32)], axis=0)
    win = jnp.concatenate([pe[j : j + n] for j in range(W)], axis=1)  # (n, W*8)

    src = jnp.minimum(starts[:ncells], n - 1)
    rows = win[src].reshape(ncells, W, 8)[:, :K, :]  # (ncells, K, 8)

    kk = jnp.arange(K, dtype=jnp.int32)
    present = (kk[None, :] < counts[:, None]).astype(jnp.float32)
    rows = rows * present[..., None]
    rows = rows.at[:, :, 6].set(present)
    slots = rows.reshape(nx, ny, nz, K, 8).transpose(0, 1, 3, 4, 2)

    n_valid = n if valid is None else valid.sum()
    n_overflow = (n_valid - jnp.minimum(counts, K).sum()).astype(jnp.int32)
    cap = min(overflow_cap, n)

    def find_overflow(_):
        # Overflow particles: sorted positions p whose in-cell rank is >= K
        # (excluding the invalid tail); original indices are perm[p].
        # rank >= K iff the key K positions earlier is equal (sorted keys) —
        # avoids the 1M-row starts[lin_s] gather (ops/common.rank_ge).
        over = rank_ge(lin_s, K) & (lin_s < ncells)
        (pos_s,) = jnp.nonzero(over, size=cap, fill_value=n)
        return jnp.where(
            pos_s < n, perm[jnp.minimum(pos_s, n - 1)], n
        ).astype(jnp.int32)

    overflow_idx = jax.lax.cond(
        n_overflow > 0,
        find_overflow,
        # `+ 0 * perm[:1]` keeps both branch outputs device-varying when this
        # runs inside shard_map (VMA type-matching); a no-op otherwise.
        lambda _: jnp.full(cap, n, jnp.int32) + 0 * perm[:1],
        operand=None,
    )
    return CellTable(
        slots=slots,
        n_overflow=n_overflow,
        overflow_idx=overflow_idx,
    )


def counts_from_table(cfg: SimConfig, table: CellTable, pos=None):
    """Per-cell particle histogram (the reference's m_gpCounts grid,
    gpCountParticles.hlsl).  Pass `pos` to also count overflow particles
    (exact up to overflow_cap)."""
    counts = table.slots[:, :, :, 6, :].sum(axis=2).astype(jnp.int32)
    if pos is not None:
        n = pos.shape[0]
        ov = table.overflow_idx
        live = ov < n
        m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
        cell = cell_of(pos[jnp.where(live, ov, 0)] * m)
        lin = (cell[:, 0] * cfg.ny + cell[:, 1]) * cfg.nz + cell[:, 2]
        lin = jnp.where(live, lin, cfg.nx * cfg.ny * cfg.nz)
        counts = (
            counts.reshape(-1)
            .at[lin]
            .add(live.astype(jnp.int32), mode="drop")
            .reshape(counts.shape)
        )
    return counts


# ---------------------------------------------------------------------------
# Level-set seeding from the table (replaces scatter-min + index gathers).
# ---------------------------------------------------------------------------

def seed_closest_from_table(cfg: SimConfig, table: CellTable, far: float):
    """Own-cell best candidate per cell: (phi0, cpos0) as in
    ops/levelset.seed_closest's first stage.  First-present slot wins ties
    (slot order == original index order == reference first-wins)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    r = jnp.float32(cfg.particle_radius)
    slots = table.slots  # (nx, ny, K, 8, nz)
    px = slots[:, :, :, 0, :]
    py = slots[:, :, :, 1, :]
    pz = slots[:, :, :, 2, :]
    present = slots[:, :, :, 6, :] > 0.0

    xg = jnp.arange(nx, dtype=jnp.float32)[:, None, None, None]
    yg = jnp.arange(ny, dtype=jnp.float32)[None, :, None, None]
    zg = jnp.arange(nz, dtype=jnp.float32)[None, None, None, :]
    dx = px - xg
    dy = py - yg
    dz = pz - zg
    d = jnp.sqrt(dx * dx + dy * dy + dz * dz) - r
    d = jnp.where(present, d, jnp.inf)

    best = jnp.min(d, axis=2)
    # First slot achieving the min (ties -> smallest original index), taken
    # with a one-hot select over the small K axis (cheaper than a dense
    # take_along_axis gather over every cell).
    is_best = d == best[:, :, None, :]
    K = d.shape[2]
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, d.shape, 2)
    first = jnp.min(jnp.where(is_best, slot_ids, K), axis=2)
    onehot = slot_ids == first[:, :, None, :]
    cpos0 = jnp.stack(
        [jnp.where(onehot, c, 0.0).sum(axis=2) for c in (px, py, pz)],
        axis=-1,
    )
    seeded = jnp.isfinite(best)
    phi0 = jnp.where(seeded, best, jnp.inf)
    cpos0 = jnp.where(seeded[..., None], cpos0, far)
    return phi0, cpos0


# ---------------------------------------------------------------------------
# P2G transfer from the table (replaces 48M-element scatter-adds).
# ---------------------------------------------------------------------------

def p2g_from_table(cfg: SimConfig, table: CellTable, pos=None, vel=None, pc=None):
    """Gather-free P2G: every MAC face accumulates hat-weighted velocity
    from the 18 neighbor cells' table slots (the GPU kernels' neighborhood,
    gpTransferParticleVelocitiesU.hlsl:36-59) as dense shifted-window sums.

    If (pos, vel) are given, contributions of overflow particles (those
    beyond slot K, captured in table.overflow_idx) are added exactly via a
    small bounded scatter, so the result matches ops/p2g.transfer_to_grid
    up to summation order whenever n_overflow <= overflow_cap.

    Returns (u, v, w, u_valid, v_valid, w_valid).  Positions may be given in
    meters (`pos`) or directly in cell units (`pc`, e.g. shard-local frames).
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    if pc is None and pos is not None:
        pc = pos * jnp.array([nx, ny, nz], jnp.float32)
    slots = table.slots  # (nx, ny, K, 8, nz)
    padded = jnp.pad(slots, ((1, 1), (1, 1), (0, 0), (0, 0), (1, 1)))

    def component(comp_axis: int, shape):
        # Face sample position: staggered axis offset by -0.5; broadcast
        # shapes target (n_face_x, n_face_y, K, n_face_z).
        coords = []
        bshape = [(shape[0], 1, 1, 1), (1, shape[1], 1, 1), (1, 1, 1, shape[2])]
        for ax, n_face in enumerate(shape):
            c = jnp.arange(n_face, dtype=jnp.float32)
            if ax == comp_axis:
                c = c - 0.5
            coords.append(c.reshape(bshape[ax]))

        acc = jnp.zeros(shape, jnp.float32)
        amt = jnp.zeros(shape, jnp.float32)
        offs_axis = (-1, 0)
        offs_other = (-1, 0, 1)
        rng = [
            offs_axis if ax == comp_axis else offs_other for ax in range(3)
        ]
        for ox in rng[0]:
            for oy in rng[1]:
                for oz in rng[2]:
                    # Neighbor cell index = face index + (ox, oy, oz);
                    # face index ranges over `shape` (staggered axis has one
                    # extra face), cells come from the zero-padded table.
                    win = padded[
                        1 + ox : 1 + ox + shape[0],
                        1 + oy : 1 + oy + shape[1],
                        :,
                        :,
                        1 + oz : 1 + oz + shape[2],
                    ]
                    velc = win[:, :, :, 3 + comp_axis, :]
                    present = win[:, :, :, 6, :]
                    wx = jnp.maximum(0.0, 1.0 - jnp.abs(win[:, :, :, 0, :] - coords[0]))
                    wy = jnp.maximum(0.0, 1.0 - jnp.abs(win[:, :, :, 1, :] - coords[1]))
                    wz = jnp.maximum(0.0, 1.0 - jnp.abs(win[:, :, :, 2, :] - coords[2]))
                    wgt = wx * wy * wz * present
                    acc = acc + (wgt * velc).sum(2)
                    amt = amt + wgt.sum(2)

        if pc is not None:
            acc, amt = _overflow_scatter(
                cfg, table, pc, vel, comp_axis, shape, acc, amt
            )

        g = acc / jnp.maximum(amt, jnp.float32(1e-30))
        valid = amt > cfg.zero_thresh
        sl = [slice(None)] * 3
        for edge in (0, (nx, ny, nz)[comp_axis]):
            s2 = list(sl)
            s2[comp_axis] = edge
            g = g.at[tuple(s2)].set(0.0)
            valid = valid.at[tuple(s2)].set(True)
        return g, valid

    u, uv = component(0, (nx + 1, ny, nz))
    v, vv = component(1, (nx, ny + 1, nz))
    w, wv = component(2, (nx, ny, nz + 1))
    return u, v, w, uv, vv, wv


def p2g_from_table_fused(cfg: SimConfig, table: CellTable, pos=None, vel=None, pc=None):
    """Same result as p2g_from_table, restructured as ONE sweep over the 27
    cell offsets that accumulates all three components at once — each window
    of the table is read once (7 fields) instead of three times (5 fields
    each), ~1.4x less HBM traffic.

    Key observation: for every component, a particle in cell c contributes
    to faces at cell-relative offsets {0,+1} along the staggered axis and
    {-1,0,+1} along the others; equivalently, face f accumulates from cells
    f+off with off in {-1,0}x{-1,0,1}^2 (staggered axis first).  Working in
    *cell-indexed* accumulators (component face i+1 stored at cell i) turns
    all three neighborhoods into subsets of the 27-neighborhood.
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    slots = table.slots  # (nx, ny, K, 8, nz)
    padded = jnp.pad(slots, ((1, 1), (1, 1), (0, 0), (0, 0), (1, 1)))

    # Cell-indexed accumulators: entry c holds the face at staggered index
    # c+1 for the staggered axis (interior faces 1..n-1 live at cells
    # 0..n-2; boundary faces are forced afterwards).  For component a, face
    # (c+e_a) gathers cells (c+e_a)+off with off_a in {-1,0} -> cell-relative
    # offsets d = off + e_a with d_a in {0,1}, d_other in {-1,0,1}.
    accs = [jnp.zeros((nx, ny, nz), jnp.float32) for _ in range(3)]
    amts = [jnp.zeros((nx, ny, nz), jnp.float32) for _ in range(3)]

    xs = jnp.arange(nx, dtype=jnp.float32).reshape(nx, 1, 1, 1)
    ys = jnp.arange(ny, dtype=jnp.float32).reshape(1, ny, 1, 1)
    zs = jnp.arange(nz, dtype=jnp.float32).reshape(1, 1, 1, nz)
    cell_coord = (xs, ys, zs)

    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                d = (dx, dy, dz)
                win = padded[
                    1 + dx : 1 + dx + nx,
                    1 + dy : 1 + dy + ny,
                    :,
                    :,
                    1 + dz : 1 + dz + nz,
                ]
                p3 = (win[:, :, :, 0, :], win[:, :, :, 1, :], win[:, :, :, 2, :])
                present = win[:, :, :, 6, :]
                # Per-axis hat weights at the normal (cell-center-aligned)
                # and staggered (half-offset) sample positions.
                wn = []  # weight vs face coordinate == cell coordinate
                wsv = []  # weight vs staggered face at cell+0.5
                for ax in range(3):
                    rel = p3[ax] - cell_coord[ax]
                    wn.append(jnp.maximum(0.0, 1.0 - jnp.abs(rel)))
                    wsv.append(jnp.maximum(0.0, 1.0 - jnp.abs(rel - 0.5)))
                for a in range(3):
                    if d[a] not in (0, 1):
                        continue
                    wgt = present
                    for ax in range(3):
                        wgt = wgt * (wsv[ax] if ax == a else wn[ax])
                    velc = win[:, :, :, 3 + a, :]
                    accs[a] = accs[a] + (wgt * velc).sum(2)
                    amts[a] = amts[a] + wgt.sum(2)

    out = []
    for a, shape in ((0, (nx + 1, ny, nz)), (1, (nx, ny + 1, nz)), (2, (nx, ny, nz + 1))):
        # Reposition: cell-indexed entry c -> staggered face c+1; boundary
        # faces (0 and n) zero/valid.
        pad = [(0, 0)] * 3
        pad[a] = (1, 0)
        acc = jnp.pad(accs[a], pad)
        amt = jnp.pad(amts[a], pad)
        if pc is not None:
            acc, amt = _overflow_scatter(cfg, table, pc, vel, a, shape, acc, amt)
        g = acc / jnp.maximum(amt, jnp.float32(1e-30))
        valid = amt > cfg.zero_thresh
        for edge in (0, (nx, ny, nz)[a]):
            sl = [slice(None)] * 3
            sl[a] = edge
            g = g.at[tuple(sl)].set(0.0)
            valid = valid.at[tuple(sl)].set(True)
        out.append((g, valid))
    (u, uv), (v, vv), (w, wv) = out
    return u, v, w, uv, vv, wv


def _overflow_scatter(cfg, table, pc, vel, comp_axis, shape, acc, amt):
    """Exact scatter-add of overflow particles' hat contributions (bounded
    by overflow_cap, so it is cheap and always on).  pc in CELL units."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    n = pc.shape[0]
    ov = table.overflow_idx
    live = ov < n
    safe = jnp.where(live, ov, 0)
    p = pc[safe]
    pv = vel[safe, comp_axis]

    base = []
    alpha = []
    for ax in range(3):
        c = p[:, ax] + (0.5 if ax == comp_axis else 0.0)
        b = jnp.floor(c)
        base.append(b.astype(jnp.int32))
        alpha.append(c - b)
    dims = (nx, ny, nz)
    lin_all, w_all = [], []
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                offs = (ox, oy, oz)
                idx = [base[ax] + offs[ax] for ax in range(3)]
                ok = live
                for ax in range(3):
                    hi = dims[ax] + (1 if ax == comp_axis else 0)
                    ok = ok & (idx[ax] >= 0) & (idx[ax] < hi)
                wgt = jnp.ones_like(pv)
                for ax in range(3):
                    a = alpha[ax]
                    wgt = wgt * (a if offs[ax] > 0 else 1.0 - a)
                lin = (idx[0] * shape[1] + idx[1]) * shape[2] + idx[2]
                lin_all.append(jnp.where(ok, lin, 0))
                w_all.append(jnp.where(ok, wgt, 0.0))
    lin = jnp.concatenate(lin_all)
    wgt = jnp.concatenate(w_all)
    vals = jnp.concatenate([wi * pv for wi in w_all])
    acc = acc.reshape(-1).at[lin].add(vals).reshape(shape)
    amt = amt.reshape(-1).at[lin].add(wgt).reshape(shape)
    return acc, amt


def seed_overflow_correction(
    cfg: SimConfig, table: CellTable, pos, phi0, cpos0, pc_all=None
):
    """Fold overflow particles into the own-cell seeding result (exact,
    first-wins tie-breaks preserved: in-table particles have smaller
    indices, and strict improvement is required to replace).  Positions in
    meters (`pos`) or cell units (`pc_all`)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    r = jnp.float32(cfg.particle_radius)
    if pc_all is None:
        pc_all = pos * jnp.array([nx, ny, nz], jnp.float32)
    n = pc_all.shape[0]
    ov = table.overflow_idx
    live = ov < n
    safe = jnp.where(live, ov, 0)
    pc = pc_all[safe]
    cell = cell_of(pc)
    lin = (cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]
    d = jnp.sqrt(((pc - cell.astype(jnp.float32)) ** 2).sum(-1)) - r
    d = jnp.where(live, d, jnp.inf)

    phi_flat = phi0.reshape(-1)
    best = phi_flat.at[lin].min(d)
    # Among overflow winners, pick the smallest particle index.
    improved = best < phi_flat
    is_winner = (d == best[lin]) & live
    big = jnp.int32(2**31 - 1)
    win = (
        jnp.full(phi_flat.shape, big, jnp.int32)
        .at[lin]
        .min(jnp.where(is_winner, ov, big))
    )
    has_win = improved & (win != big)
    # Winner positions via a bounded scatter from the overflow rows (a dense
    # gather over all cells would cost more than the whole correction).
    winner_row = is_winner & (ov == win[lin])
    ncells = phi_flat.shape[0]
    tgt = jnp.where(winner_row & improved[lin], lin, ncells)
    win_pos = (
        jnp.zeros((ncells + 1, 3), jnp.float32).at[tgt].set(pc, mode="drop")
    )[:ncells]
    phi_new = jnp.where(has_win, best, phi_flat).reshape(phi0.shape)
    cpos_new = jnp.where(
        has_win[:, None], win_pos, cpos0.reshape(-1, 3)
    ).reshape(cpos0.shape)
    return phi_new, cpos_new
