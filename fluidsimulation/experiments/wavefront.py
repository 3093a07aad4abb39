"""Wavefront (global ray-pool) formulation of the exact renderer.

Motivation: the tiled renderer's md() row gathers decay to 6-26k-row
batches as tiles converge, where a gather costs more per row than in
large batches, and lanes that converged keep
paying for gathers until their whole tile exits.  Here every ray that
actually needs marching — across the whole frame and each bounce level's
ray list — is fed through one fixed-size pool of P lanes: each pool step
issues ONE md() gather of exactly P rows (the fast regime), finished
lanes are evacuated and the pool is refilled from a compacted queue
(``jnp.nonzero(size=...)``), and the march stops when the queue drains.

Per-ray march semantics are the EXACT per-lane serial semantics of
``raytrace.intersect_water`` (same fp ops in the same order per lane), so
frames are bit-identical to the tiled/dense path; equality is tested in
tests/test_wavefront.py.

Reference anchors: Render.fx:358-424 (intersectWater, trip counts
64 / 128 / 48), Render.fx:442-515 (bounce recursion), Render.fx:518-578
(pixel shader main).

Pool mechanics
--------------
A lane holds one ray and a phase:

  EMPTY     no ray.
  CLASSIFY  first probe: md(p0) decides outside/inside
            (Render.fx:361-366; the serial code's ``initial`` probe and
            the outside loop's first ``md(p)`` coincide at p0, so the
            classify step already applies the first march update).
  OUT       64-step sphere trace (Render.fx:369-381).
  INS       128-step fixed 1-cell march (Render.fx:391-409).
  BWD       backward sphere trace, budget 48 - i_exit (Render.fx:411-423,
            the reference's reused loop counter quirk).
  FIN       finished, result (t, t_p) awaiting evacuation.

Every pool step costs exactly one md() row-gather of P rows regardless of
phase mix.  A "round" = (conditional refill) + ``steps_per_round`` march
steps.  Refill evacuates FIN lanes into a trace row and pulls the next
queue entries in order (exclusive cumsum over free lanes), and is skipped
(lax.cond) unless at least P/8 lanes are free — the queue-record gather
is the round's main fixed cost.  Rays whose result is discarded upstream
(glass-miss ``max_t >= LARGE``, zero-weight TIR children) ride the queue
with a negative ray key and finish in one pool step (phase JUNKED) with
the dense default t = t_p = 0, which matches the serial path's
done-at-start lanes (TIR children always carry ``max_t ~ 1e11 >= LARGE``
because their direction is the exact zero vector, so the ambiguity
between the outside/inside defaults is vacuous — see tests).  One known
twin divergence, unreachable from the product path: a ``dead`` lane whose
box lies strictly BEHIND the ray (max_t < 0 < LARGE) returns t = 0 here,
while the serial path returns min(0, max_t) = max_t if its classify probe
says outside — classifying would cost a dense md() pass over every ray,
and the lane's contribution is multiplied by exactly 0 upstream either
way (tests/test_wavefront.py::test_intersect_water_pool_dead_mask pins
this).

The lane result is (t, t_p): t is the returned march distance and t_p the
distance at which the returned *point* sits (they differ where the serial
code advances t but freezes p: the inside exit step and the backward
firing step).  The dense caller reconstructs p = p0 + t_p*ci — the same
expression the serial code used to produce p, so bit-identical.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..render import raytrace as rt

# Lane phases.  JUNKED lanes (rays whose result is discarded upstream)
# finish on their first step with the dense-default (t = t_p = 0) — they
# ride the queue instead of being nonzero-compacted away, because the
# compaction (a (N,8) record gather behind a jnp.nonzero) costs far more
# than the ONE pool step a junk lane costs.
EMPTY, CLASSIFY, OUT, INS, BWD, JUNKED, FIN = -1, 0, 1, 2, 3, 4, 5

_DEF_POOL = 131072
_DEF_SPR = 6    # gathers per round
_DEF_REUSE = 4  # eval sub-steps per gathered row (tex path)


# Trace rows encode the ray index as the float VALUE oidx+1 (exact for
# indices < 2^24), NOT a bitcast: accelerator float paths may canonicalize
# NaN bit patterns (an int -1 bitcast is 0xFFFFFFFF = NaN), which corrupts
# bitcast-encoded keys.  0.0 marks an invalid record,
# so never-written all-zero trace rows are invalid by construction.
_MAX_RAYS = 1 << 24


def _lane_step(dt, st, inv_m0, d8=None, margin=None, gate=None):
    """Advance every pool lane by one march step given dt = md(p).

    Replicates raytrace.intersect_water's per-lane updates exactly:
    the same jnp expressions in the same order, selected per phase.

    ``d8``/``margin``: interior L1 distance at the probe's cell and the
    skip safety margin (render/interior.py).  An INS lane that keeps
    marching jumps floor((d8 - margin)/sqrt(3)) extra lattice steps —
    all provably non-exit, non-box probe points, so the lane visits the
    same decision sequence as the serial loop.  margin is TRACED: the
    same compiled program with margin=+big is the no-skip march, which
    is how bit-equality of the skip is asserted (tests/test_interior.py).
    """
    phase, p, t, t_p, i, aux, max_t, p0, ci, oidx = st

    is_cls = phase == CLASSIFY
    outside = (dt > 0.0) | (p0[:, 1] > 0.9999)
    ph = jnp.where(is_cls, jnp.where(outside, OUT, INS), phase)
    junked = phase == JUNKED

    o = ph == OUT
    ins = ph == INS
    bwd = ph == BWD

    # OUT candidate update (Render.fx:369-381 / raytrace.out_body).
    t2o = t + dt
    fire_o = (dt < 0.001) | (t2o >= max_t)
    # INS candidate update (Render.fx:391-409 / raytrace.fwd_body).
    t2i = t + inv_m0
    exit_i = dt >= 0.0
    box_i = (~exit_i) & (t2i >= max_t)
    bud = jnp.maximum(48 - i, 0)  # 48 - i_exit backward budget
    # BWD candidate update (Render.fx:411-423 / raytrace.bwd_body).
    dtb = -dt
    t2b = t + dtb
    fire_b = dtb > -0.001

    t_new = jnp.where(o, t2o, jnp.where(ins, t2i, jnp.where(bwd, t2b, t)))
    adv_p = o | (ins & ~exit_i) | (bwd & ~fire_b)
    p_new = jnp.where(adv_p[:, None], p0 + t_new[:, None] * ci, p)
    tp_new = jnp.where(adv_p, t_new, t_p)
    i_new = i + (o | ins).astype(i.dtype)
    aux_new = jnp.where(ins & exit_i, bud, jnp.where(bwd, aux - 1, aux))

    fin_o = o & (fire_o | (i_new >= 64))
    fin_box = ins & box_i
    fin_exit0 = ins & exit_i & (bud == 0)
    fin_full = ins & ~exit_i & ~box_i & (i_new >= 128)
    go_bwd = ins & exit_i & (bud > 0)
    fin_b = bwd & (fire_b | (aux_new <= 0))
    fin = fin_o | fin_box | fin_exit0 | fin_full | fin_b | junked

    # Result finalization: OUT lanes emit min(t, max_t) twice (the serial
    # path clamps then recomputes p from the clamped t); boxed INS lanes
    # emit (max_t, max_t) (serial box-exit override).
    out_clamped = jnp.minimum(t_new, max_t)
    t_fin = jnp.where(fin_o, out_clamped, jnp.where(fin_box, max_t, t_new))
    tp_fin = jnp.where(fin_o, out_clamped, jnp.where(fin_box, max_t, tp_new))
    t_fin = jnp.where(junked, 0.0, t_fin)
    tp_fin = jnp.where(junked, 0.0, tp_fin)
    t_new = jnp.where(fin, t_fin, t_new)
    tp_new = jnp.where(fin, tp_fin, tp_new)

    if gate is not None:
        # Row-reuse sub-step: lanes whose probe key left the fetched row
        # freeze until the next gather (their dt is garbage).  JUNKED
        # lanes never read dt, so they always pass.
        g = gate | junked
        fin = fin & g
        go_bwd = go_bwd & g
        t_new = jnp.where(g, t_new, t)
        tp_new = jnp.where(g, tp_new, t_p)
        p_new = jnp.where(g[:, None], p_new, p)
        i_new = jnp.where(g, i_new, i)
        aux_new = jnp.where(g, aux_new, aux)
        ph = jnp.where(g, ph, phase)
        ins = ins & g

    if d8 is not None:
        # Interior skip (render/interior.py): INS lanes that keep
        # marching jump k provably-interior lattice steps at once.
        cont = ins & ~exit_i & ~box_i & (i_new < 128)
        k = jnp.floor((d8 - margin) * jnp.float32(0.57735026)).astype(
            jnp.int32
        )
        k = jnp.minimum(k, 127 - i_new)
        k_box = jnp.floor((max_t - t_new) / inv_m0).astype(jnp.int32) - 2
        k = jnp.maximum(jnp.minimum(k, k_box), 0)
        k = jnp.where(cont, k, 0)
        t_new = t_new + k.astype(jnp.float32) * inv_m0
        i_new = i_new + k
        skipped = k > 0
        p_new = jnp.where(skipped[:, None], p0 + t_new[:, None] * ci, p_new)
        tp_new = jnp.where(skipped, t_new, tp_new)

    ph_new = jnp.where(fin, FIN, jnp.where(go_bwd, BWD, ph))
    return (ph_new, p_new, t_new, tp_new, i_new, aux_new, max_t, p0, ci, oidx)


# -- packed-row key/eval split (row reuse) ------------------------------------

def _pkey(dims, ns, p):
    """Gather key of the packed phi row at p — sample_phi_packed's key
    computation factored out, so ONE gathered 512 B row can serve several
    consecutive probes: the z lane axis holds a 32-cell window, and both
    the inside march's 1-cell steps and the sphere trace's short
    near-surface steps often stay in the same (ix, iy, seg) row (the
    default camera looks along +z, FluidSimDemo.cpp:144-163)."""
    n = jnp.array(dims, jnp.float32)
    w = rt._warp(p, dims)
    q = jnp.clip(w * n - 0.5, 0.0, n - 1.0)
    i = jnp.minimum(jnp.floor(q), n - 2.0)
    ix = i[:, 0].astype(jnp.int32)
    iy = i[:, 1].astype(jnp.int32)
    iz = i[:, 2].astype(jnp.int32)
    seg = iz // rt._SEG
    return (ix * (dims[1] - 1) + iy) * ns + seg


def _peval(rows, dims, p, skip: bool):
    """map_dist (and d8 when ``skip``) at p from pre-gathered rows — the
    arithmetic of sample_phi_packed / interior.sample_phi_skip minus the
    gather; bit-identical given the row _pkey(p) selects."""
    n = jnp.array(dims, jnp.float32)
    w = rt._warp(p, dims)
    q = jnp.clip(w * n - 0.5, 0.0, n - 1.0)
    i = jnp.minimum(jnp.floor(q), n - 2.0)
    f = q - i
    iz = i[:, 2].astype(jnp.int32)
    seg = iz // rt._SEG
    phi_rows = rows[:, : 4 * rt._LANES].reshape(-1, 4, rt._LANES)
    lane = jax.lax.broadcasted_iota(jnp.float32, (1, 1, rt._LANES), 2)
    zpos = (jnp.float32(rt._SEG)
            * seg.reshape(-1, 1, 1).astype(jnp.float32) + lane)
    qz = q[:, 2].reshape(-1, 1, 1)
    wz = jnp.maximum(0.0, 1.0 - jnp.abs(qz - zpos))
    zred = (phi_rows * wz).sum(-1)
    fx = f[:, 0]
    fy = f[:, 1]
    w4 = jnp.stack(
        [(1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy), fx * fy],
        axis=-1,
    )
    val = (zred * w4).sum(-1) / jnp.float32(dims[0])
    if not skip:
        return val, None
    d_rows = rows[:, 4 * rt._LANES:]
    zlane = (iz - rt._SEG * seg).reshape(-1, 1)
    lane1 = jax.lax.broadcasted_iota(jnp.int32, (1, rt._LANES), 1)
    d8 = jnp.where(lane1 == zlane, d_rows, 0.0).sum(-1)
    return val, d8


def _march_pool(probe, rec_q, m_count, n_out, inv_m0, pool, spr, r_trace,
                reuse=1, margin=None):
    """Run the ray pool over the queue ``rec_q`` (rows
    [p0.xyz, ci.xyz, max_t, signed_key]); returns dense (t, t_p) of
    length ``n_out``.

    ``probe`` is either ("md", fn) / ("md2", fn) — a legacy closure
    issuing its own gather per eval — or ("tex", rows, dims, ns, skip):
    the row-reuse path, where each of the ``spr`` gathers per round is
    followed by ``reuse`` eval sub-steps gated on the probe key staying
    in the fetched row."""
    P = pool
    zf = jnp.zeros((P,), jnp.float32)
    zi = jnp.zeros((P,), jnp.int32)
    st0 = (
        jnp.full((P,), EMPTY, jnp.int32),  # phase
        jnp.zeros((P, 3), jnp.float32),    # p
        zf, zf,                            # t, t_p
        zi, zi,                            # i, aux
        zf,                                # max_t
        jnp.zeros((P, 3), jnp.float32),    # p0
        jnp.zeros((P, 3), jnp.float32),    # ci
        jnp.full((P,), -1, jnp.int32),     # oidx
    )
    trace0 = jnp.zeros((r_trace + 1, P, 4), jnp.float32)
    thresh = max(1, P // 8)

    def refill(carry):
        cursor, rt_i, trace, st = carry
        phase, p, t, t_p, i, aux, max_t, p0, ci, oidx = st
        fin = phase == FIN
        free = fin | (phase == EMPTY)
        # Evacuate FIN lanes into the trace (key 0.0 marks empty slots).
        key = jnp.where(fin, oidx + 1, 0).astype(jnp.float32)
        row = jnp.stack([key, t, t_p, jnp.zeros_like(t)], axis=-1)
        trace = lax.dynamic_update_index_in_dim(trace, row, rt_i, 0)
        # Pull the next queue entries, in order, into the free lanes.
        rank = jnp.cumsum(free.astype(jnp.int32)) - free
        qnew = cursor + rank
        take = free & (qnew < m_count)
        newrec = rec_q[jnp.clip(qnew, 0, rec_q.shape[0] - 1)]
        np0 = jnp.where(take[:, None], newrec[:, 0:3], p0)
        nci = jnp.where(take[:, None], newrec[:, 3:6], ci)
        nmax = jnp.where(take, newrec[:, 6], max_t)
        # lane 7 is the SIGNED ray key: +(oidx+1) marchable, -(oidx+1)
        # junk (result discarded upstream; finishes in one step).
        key7 = newrec[:, 7].astype(jnp.int32)
        noidx = jnp.where(take, jnp.abs(key7) - 1,
                          jnp.where(free, -1, oidx))
        nphase = jnp.where(take, jnp.where(key7 < 0, JUNKED, CLASSIFY),
                           jnp.where(free, EMPTY, phase))
        np_ = jnp.where(take[:, None], np0, p)
        nt = jnp.where(take, 0.0, t)
        ntp = jnp.where(take, 0.0, t_p)
        ni = jnp.where(take, 0, i)
        naux = jnp.where(take, 0, aux)
        cursor = jnp.minimum(cursor + free.sum(), m_count)
        st = (nphase, np_, nt, ntp, ni, naux, nmax, np0, nci, noidx)
        return cursor, rt_i + 1, trace, st

    def cond(c):
        r, cursor, rt_i, trace, st = c
        phase = st[0]
        marching = jnp.any((phase >= CLASSIFY) & (phase < FIN))
        return (r < 4096) & ((cursor < m_count) | marching)

    def body(c):
        r, cursor, rt_i, trace, st = c
        free_n = ((st[0] == FIN) | (st[0] == EMPTY)).sum()
        want = (cursor < m_count) & (free_n >= thresh) & (rt_i < r_trace)
        cursor, rt_i, trace, st = lax.cond(
            want, refill, lambda x: x, (cursor, rt_i, trace, st)
        )
        mode = probe[0]
        for _ in range(spr):
            if mode == "md":
                st = _lane_step(probe[1](st[1]), st, inv_m0)
            elif mode == "md2":
                dt, d8 = probe[1](st[1])
                st = _lane_step(dt, st, inv_m0, d8=d8, margin=margin)
            else:
                _, rows_arr, dims, ns, skip = probe
                key0 = _pkey(dims, ns, st[1])
                rows = rows_arr[key0]
                for j in range(reuse):
                    gate = (None if j == 0
                            else _pkey(dims, ns, st[1]) == key0)
                    dt, d8 = _peval(rows, dims, st[1], skip)
                    st = _lane_step(dt, st, inv_m0, d8=d8, margin=margin,
                                    gate=gate)
        return r + 1, cursor, rt_i, trace, st

    r, cursor, rt_i, trace, st = lax.while_loop(
        cond, body, (jnp.int32(0), jnp.int32(0), jnp.int32(0), trace0, st0)
    )
    # Final evacuation of lanes still FIN when the queue drained.
    phase, _, t, t_p, _, _, _, _, _, oidx = st
    fin = phase == FIN
    key = jnp.where(fin, oidx + 1, 0).astype(jnp.float32)
    row = jnp.stack([key, t, t_p, jnp.zeros_like(t)], axis=-1)
    trace = lax.dynamic_update_index_in_dim(
        trace, row, jnp.minimum(rt_i, r_trace), 0
    )

    # Writeback: compact the evacuation records, scatter to dense.
    flat = trace.reshape(-1, 4)
    sel = jnp.nonzero(flat[:, 0] > 0.0, size=n_out, fill_value=0)[0]
    rows = flat[sel]
    ridx = rows[:, 0].astype(jnp.int32) - 1
    idx = jnp.where(ridx >= 0, ridx, n_out)  # invalid -> dump slot
    out_t = jnp.zeros((n_out + 1,), jnp.float32).at[idx].set(
        rows[:, 1], mode="drop"
    )[:n_out]
    out_tp = jnp.zeros((n_out + 1,), jnp.float32).at[idx].set(
        rows[:, 2], mode="drop"
    )[:n_out]
    stats = {"rounds": r, "refills": rt_i, "consumed": cursor,
             "queued": m_count}
    return out_t, out_tp, stats


def intersect_water_wf(md, inv_m0, co, ci, max_t, dead=None,
                       pool=_DEF_POOL, spr=_DEF_SPR, with_stats=False,
                       probe2=None, margin=None, reuse=_DEF_REUSE):
    """Pool-marched twin of raytrace.intersect_water: same (p, t) up to
    program-level fp-contraction drift (see module docstring).

    ``md`` may be a PackedPhi / interior.PackedPhiSkip texture — the fast
    row-reuse path (one gather per ``reuse`` eval sub-steps; skip margin
    enabled for PackedPhiSkip) — or a legacy ``md(p)`` closure (optional
    ``probe2(p) -> (dt, d8)`` for the interior skip), which gathers per
    eval.  ``co/ci/max_t`` may have any leading shape; flattened
    internally.  ``with_stats`` additionally returns the pool's (rounds,
    refills, consumed, queued) scalars for perf diagnosis.
    """
    shape = max_t.shape
    co_f = co.reshape(-1, 3)
    ci_f = ci.reshape(-1, 3)
    mt_f = max_t.reshape(-1)
    n = mt_f.shape[0]
    p0 = co_f + 0.5

    junk = mt_f >= rt.LARGE
    if dead is not None:
        junk = junk | dead.reshape(-1)

    assert n < _MAX_RAYS, "ray index must stay exact as a float value"
    # Signed ray key in lane 7: junk rays ride the queue (no compaction —
    # see the JUNKED phase note) and finish in one pool step.
    key7 = jnp.where(junk, -(jnp.arange(n, dtype=jnp.float32) + 1.0),
                     jnp.arange(n, dtype=jnp.float32) + 1.0)
    rec_q = jnp.stack(
        [p0[:, 0], p0[:, 1], p0[:, 2], ci_f[:, 0], ci_f[:, 1], ci_f[:, 2],
         mt_f, key7],
        axis=-1,
    )

    P = min(pool, max(256, -(-n // 8) * 8))
    # Trace rows bound: each gated refill consumes >= P/8 queue entries
    # (except the last), plus the initial and final evacuation rows.
    r_trace = 8 * (-(-n // P)) + 4

    from ..render import interior as intr

    if isinstance(md, intr.PackedPhiSkip):
        probe = ("tex", md.rows, md.dims, md.ns, True)
        if margin is None:
            margin = jnp.float32(intr._SKIP_MARGIN)
    elif isinstance(md, rt.PackedPhi):
        probe = ("tex", md.rows, md.dims, md.ns, False)
    elif probe2 is not None:
        probe = ("md2", probe2)
        reuse = 1
    else:
        probe = ("md", md)
        reuse = 1

    t, t_p, stats = _march_pool(probe, rec_q, jnp.int32(n), n, inv_m0, P,
                                spr, r_trace, reuse=reuse, margin=margin)
    p = p0 + t_p[:, None] * ci_f
    if with_stats:
        return p.reshape(*shape, 3), t.reshape(shape), stats
    return p.reshape(*shape, 3), t.reshape(shape)


# -- bounce-level orchestration (wavefront twins of raytrace's) --------------

def _expand_bounce_wf(texq, md, inv_m0, co, ci, w=None, pool=_DEF_POOL,
                      spr=_DEF_SPR, reuse=_DEF_REUSE, g9=None):
    """Wavefront twin of raytrace._expand_bounce (identical dense math,
    the march routed through the pool).  ``texq`` feeds the pool (texture
    or legacy closure); ``md`` is the plain closure for the dense
    gradient taps; ``g9`` the optional single-gather gradient texture
    (raytrace.PackedPhi9, bit-identical taps)."""
    co = co + 0.001 * ci
    half = jnp.array([0.5, 0.5, 0.5], jnp.float32)
    _, max_t, _, _ = rt.intersect_aabb(co, ci, -half, half)
    dead = None if w is None else (w <= 0.0)
    p_hit, t_hit = intersect_water_wf(
        texq, inv_m0, co, ci, max_t, dead=dead, pool=pool, spr=spr,
        reuse=reuse,
    )
    ipoint = p_hit - 0.5
    # max_t <= 0 (box behind an epsilon-escaped child) forwards as a
    # miss, matching raytrace._expand_bounce round-4 semantics.
    missed = (t_hit >= max_t) | (max_t >= rt.LARGE) | (max_t <= 0.0)

    if g9 is not None:
        grad = rt.compute_gradient9(g9, p_hit)
    else:
        grad = rt.compute_gradient(md, p_hit)
    norm = rt._norm(grad, eps=1e-20)
    from_inside = rt._dot(norm, ci) > 0.0
    n1 = jnp.where(from_inside, 1.333, 1.000)
    n2 = jnp.where(from_inside, 1.000, 1.333)
    norm = jnp.where(from_inside[..., None], -norm, norm)
    fres, refl, trans = rt.fresnel_tr(ci, norm, n1, n2)

    d_a = jnp.where(missed[..., None], ci, refl)
    w_a = jnp.where(missed, 1.0, fres)
    d_b = jnp.where(missed[..., None], ci, trans)
    w_b = jnp.where(missed, 0.0, 1.0 - fres)
    return ipoint, d_a, w_a, d_b, w_b


def trace_water2_wf(texq, md, inv_m0, co, ci, pool=_DEF_POOL, spr=_DEF_SPR,
                    reuse=_DEF_REUSE, g9=None):
    """Wavefront twin of raytrace.trace_water2."""
    shape = co.shape

    ip1, d_a, w_a, d_b, w_b = _expand_bounce_wf(
        texq, md, inv_m0, co, ci, pool=pool, spr=spr, reuse=reuse, g9=g9
    )
    co2 = jnp.concatenate([ip1, ip1], axis=0)
    d2 = jnp.concatenate([d_a, d_b], axis=0)
    w2 = jnp.concatenate([w_a, w_b], axis=0)

    ip2, d_c, w_c, d_d, w_d = _expand_bounce_wf(
        texq, md, inv_m0, co2, d2, w=w2, pool=pool, spr=spr, reuse=reuse,
        g9=g9,
    )
    co3 = jnp.concatenate([ip2, ip2], axis=0)
    d3 = jnp.concatenate([d_c, d_d], axis=0)
    w3 = jnp.concatenate([w2 * w_c, w2 * w_d], axis=0)

    cols = rt.trace_water0(co3, d3)
    cols = cols.reshape(4, *shape)
    w3 = w3.reshape(4, *shape[:-1])
    return (cols * w3[..., None]).sum(axis=0)


def shade_wf(phi, co, ci, pool=_DEF_POOL, spr=_DEF_SPR, reuse=_DEF_REUSE,
             g9=None):
    """Wavefront twin of raytrace.shade (PS main, Render.fx:518-578).

    A PackedPhiSkip texture (render/interior.py) additionally enables the
    inside-march interior skip, bit-identical on power-of-two grids."""
    from ..render import interior as intr

    if isinstance(phi, intr.PackedPhiSkip):
        tex = phi
        md = lambda p: intr.probe_skip(tex, p)[0]
    elif isinstance(phi, rt.PackedPhi):
        tex = phi
        md = lambda p: rt.map_dist_packed(tex, p)
    else:
        tex = rt.PackedPhi(phi)
        md = lambda p: rt.map_dist_packed(tex, p)
    inv_m0 = 1.0 / jnp.float32(tex.dims[0])
    shape = ci.shape
    co_f = jnp.broadcast_to(co, shape).reshape(-1, 3)
    ci_f = ci.reshape(-1, 3)
    h, prim_co, prim_ci, _, _ = rt.trace_glass(co_f, ci_f)
    hit = h < rt.LARGE
    col_water = trace_water2_wf(
        tex, md, inv_m0, prim_co, prim_ci, pool=pool, spr=spr, reuse=reuse,
        g9=g9,
    )
    col_sky = rt.sample_environment(ci_f)
    col = jnp.where(hit[..., None], col_water, col_sky)
    out = jnp.abs(col) ** 2.2
    return jnp.nan_to_num(out, nan=0.0, posinf=1.0, neginf=0.0).reshape(shape)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "pool", "spr", "build", "reuse"),
)
def _render_wf(tex, cam_pos, cam_right, cam_up, cam_fwd,
               width: int, height: int, pool: int, spr: int,
               build: str = "none", reuse: int = _DEF_REUSE):
    g9 = None
    if build != "none":  # tex is the raw phi; pack it inside the program
        from ..render import interior as intr

        if rt.gradient_fits_phi9(tex.shape):
            g9 = rt.PackedPhi9(tex)
        tex = intr.PackedPhiSkip(tex) if build == "skip" else rt.PackedPhi(tex)
    px = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    py = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    fx, fy = jnp.meshgrid(px, py, indexing="xy")
    u = -1.0 + 2.0 * fx
    v = 1.0 - 2.0 * fy
    ci = rt._norm(u[..., None] * cam_right + v[..., None] * cam_up + cam_fwd)
    co = jnp.broadcast_to(cam_pos, ci.shape)
    return shade_wf(tex, co, ci, pool=pool, spr=spr, reuse=reuse, g9=g9)


def render_wavefront(phi, cam_pos, cam_right, cam_up, cam_fwd,
                     width: int, height: int,
                     pool: int = _DEF_POOL, spr: int = _DEF_SPR,
                     skip: bool = True, reuse: int = _DEF_REUSE):
    """Whole-frame wavefront render (the exact reference image — same
    per-lane march decisions as raytrace.render, to fp-contraction drift).

    ``skip=True`` builds the PackedPhiSkip texture when the grid is
    power-of-two, enabling the provably-exact inside-march interior skip
    (render/interior.py).  ``reuse`` = eval sub-steps per gathered row."""
    from ..render import interior as intr

    if isinstance(phi, (rt.PackedPhi, intr.PackedPhiSkip)):
        return _render_wf(phi, cam_pos, cam_right, cam_up, cam_fwd,
                          width, height, pool, spr, reuse=reuse)
    pow2 = all((d & (d - 1)) == 0 for d in phi.shape)
    build = "skip" if (skip and pow2) else "plain"
    return _render_wf(phi, cam_pos, cam_right, cam_up, cam_fwd,
                      width, height, pool, spr, build=build, reuse=reuse)
