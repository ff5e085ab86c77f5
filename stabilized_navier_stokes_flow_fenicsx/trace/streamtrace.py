"""Vmapped RK45 particle tracing with terminal events.

Replacement for the reference's per-seed scipy ``solve_ivp``
calls (reference NavierStokes/streamtrace.py:198-218, 357-383): instead of
a ThreadPool on rank 0 (forward, :220-250) and an MPI master/worker farm
(reverse, :385-446), ALL seeds integrate simultaneously as one vmapped
Dormand-Prince RK45 with per-seed adaptive steps and masked terminal
events:

  * speed < 1e-6            (terminal; particle stalled at a wall)
  * x crosses 3.7 forward / 0.13 backward (plane events, :183 :188)

Velocity lookup is the packed-row locator (fem/interpolate.py) + a
barycentric P1 eval from a per-cell packed value row; points outside the
domain get zero velocity exactly like ``velfunc`` (:144-157).  Event
times are refined by bisection of the free FSAL Hermite interpolant.

Hot-loop cost structure (the trace is bound by gather granularity —
each dynamic row gather pays a fixed cost regardless of width):

  * FSAL carry: DP45's 7th stage IS the next step's first stage, and a
    rejected step restarts from the same x, so stage 0 is NEVER
    re-evaluated — 6 velocity evals per step instead of 7.
  * one velocity eval = 5 gather rows: tab2 (2D candidates + geometry),
    prism_base, prism_geom (3 tets' x0/Tinv), u_cell (12 nodal values
    of the chosen tet).  The round-4 layout paid ~35 rows.
"""

from __future__ import annotations

import time as _time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.interpolate import locate_any

# Dormand-Prince RK45 tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0])
_B4 = np.array([5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
                187 / 2100, 1 / 40])


class TraceConfigDevice(NamedTuple):
    """Trace parameters.

    Passed to the jitted segment as a DYNAMIC pytree (the same trick as
    the traced-parameter element kernels, utils/kernelbase.py): the
    forward and reverse traces — and every Re rung of a sweep — share
    ONE compiled executable per (mesh, chunk) shape instead of one per
    parameter set.  Only ``max_steps`` is read on the host (dispatch
    count); everything else traces.
    """

    t_max: float = 20.0
    max_step: float = 0.125
    speed_eps: float = 1e-6
    x_stop: float = 3.7           # plane event
    stop_direction: int = 1       # +1: trigger when x rises past plane
    rtol: float = 1e-6
    atol: float = 1e-8
    max_steps: int = 4096
    sign: float = 1.0             # velocity sign: -1.0 = reverse trace


def pack_u_cells(dloc, u_nodes: jnp.ndarray) -> jnp.ndarray:
    """Per-cell packed nodal values (nc, nv*3): ONE row gather per
    velocity eval instead of nv scattered node-row gathers.  Rebuilt
    once per (field, trace) — a single device gather over the mesh."""
    nc = dloc.cells.shape[0]
    return u_nodes[dloc.cells].reshape(nc, -1)


def _velocity(dloc, u_cell: jnp.ndarray, x: jnp.ndarray,
              sign) -> jnp.ndarray:
    """Velocity at point x; zero outside the domain (velfunc semantics).

    dloc may be the general DeviceLocator or the extrusion-aware
    LayeredDeviceLocator (packed: 5 gather rows per eval — the trace is
    gather-granularity-bound on exactly this path at 1M dofs)."""
    cell, bary = locate_any(dloc, x)
    nv = bary.shape[0]
    nodal = u_cell[jnp.maximum(cell, 0)].reshape(nv, -1)   # (nv, 3)
    v = bary @ nodal
    return jnp.where(cell >= 0, sign * v, 0.0)


class TraceState(NamedTuple):
    """Per-seed integration state (resumable across dispatches)."""

    x: jnp.ndarray        # (n, 3)
    v: jnp.ndarray        # (n, 3) FSAL carry: f(x) at the current x
    t: jnp.ndarray        # (n,)
    dt: jnp.ndarray       # (n,)
    done: jnp.ndarray     # (n,) bool
    steps: jnp.ndarray    # (n,) int32


def init_trace_state(seeds: jnp.ndarray, cfg: TraceConfigDevice,
                     dloc, u_cell) -> TraceState:
    """Fresh state; the FSAL carry ``v`` is a placeholder — trace_segment
    computes f(x) on device for lanes with steps == 0 (see seed_v)."""
    dtype = u_cell.dtype
    n = seeds.shape[0]
    x = seeds.astype(dtype)
    return TraceState(
        x=x,
        v=jnp.zeros((n, 3), dtype),
        t=jnp.zeros(n, dtype),
        dt=jnp.full(n, cfg.max_step, dtype),
        done=jnp.zeros(n, bool),
        steps=jnp.zeros(n, jnp.int32),
    )


@partial(jax.jit, static_argnums=(4,))
def trace_segment(
    cfg: TraceConfigDevice,
    dloc,
    u_cell: jnp.ndarray,
    state: TraceState,
    seg_steps: int = 256,
) -> TraceState:
    """Advance all seeds by at most seg_steps RK45 steps (one bounded
    device dispatch — a full 4096-step batched integration in a single
    program can outlive the device watchdog).  cfg is a traced pytree:
    forward/reverse (cfg.sign) and every event-plane/tolerance variant
    share one executable per shape."""
    return _segment_core(cfg, dloc, u_cell, state, seg_steps)


def _segment_core(
    cfg: TraceConfigDevice,
    dloc,
    u_cell: jnp.ndarray,
    state: TraceState,
    seg_steps,
) -> TraceState:
    """trace_segment's body as a plain traced function (seg_steps may be
    a Python int or a traced scalar) — shared by the standalone jitted
    wrapper above and the device-resident ``_run_chunk`` program."""
    dtype = u_cell.dtype
    sign = jnp.asarray(cfg.sign, dtype)
    A = jnp.asarray(_A, dtype)
    B5 = jnp.asarray(_B5, dtype)
    B4 = jnp.asarray(_B4, dtype)

    def f(x):
        return _velocity(dloc, u_cell, x, sign)

    # FSAL seed init folded into the segment (round 5): a lane with
    # steps == 0 has never evaluated its carry, so compute f(x) for it
    # here — ONE masked velocity eval per lane-segment (~0.1% of the
    # ~128-step x 6-eval segment budget) instead of a separate _init_v
    # program with per-chunk dispatches.
    def seed_v(x, v, steps):
        return jnp.where(steps == 0, f(x), v)

    def rk_step(x, dt, v0):
        # FSAL: stage 0 is the carried f(x) — 6 evals, not 7
        ks = [v0]
        for i in range(1, 7):
            xi = x
            for j in range(i):
                xi = xi + dt * A[i, j] * ks[j]
            ks.append(f(xi))
        K = jnp.stack(ks)
        x5 = x + dt * (B5 @ K)
        x4 = x + dt * (B4 @ K)
        scale = cfg.atol + cfg.rtol * jnp.maximum(jnp.abs(x), jnp.abs(x5))
        err = jnp.sqrt(jnp.mean(((x5 - x4) / scale) ** 2))
        return x5, err, K

    plane = cfg.x_stop
    sdir = jnp.asarray(cfg.stop_direction, dtype)

    def one_seed(st_x, st_v, st_t, st_dt, st_done, st_steps):
        def cond(s):
            x, v, t, dt, done, steps, k = s
            return (~done) & (steps < cfg.max_steps) & (k < seg_steps)

        def body(s):
            x, v0, t, dt, done, steps, k = s
            dt_eff = jnp.minimum(dt, cfg.t_max - t)
            x_new, err, K = rk_step(x, dt_eff, v0)
            accept = err <= 1.0
            speed = jnp.linalg.norm(v0)
            speed_stop = speed < cfg.speed_eps
            g0 = (x[0] - plane) * sdir
            g1 = (x_new[0] - plane) * sdir
            hit = (g0 < 0) & (g1 >= 0) & accept
            # event refinement on a FREE dense interpolant: DP45 is FSAL
            # (K[6] = f(x_new)), so a cubic Hermite through (x, v0) ->
            # (x_new, K[6]) needs zero extra velocity evals; bisecting it
            # refines the crossing TIME too (a linear-chord frac has
            # O(h^2) error, the Hermite path error is O(h^4)).
            v6 = K[6]

            def dense(theta):
                t2 = theta * theta
                t3 = t2 * theta
                return ((2 * t3 - 3 * t2 + 1) * x
                        + (t3 - 2 * t2 + theta) * dt_eff * v0
                        + (-2 * t3 + 3 * t2) * x_new
                        + (t3 - t2) * dt_eff * v6)

            def bis(_, lohi):
                lo, hi = lohi
                mid = 0.5 * (lo + hi)
                gm = (dense(mid)[0] - plane) * sdir
                return (jnp.where(gm < 0, mid, lo),
                        jnp.where(gm < 0, hi, mid))

            lo, hi = jax.lax.fori_loop(
                0, 16, bis, (jnp.zeros((), dtype), jnp.ones((), dtype)))
            frac = jnp.where(hit, hi, 1.0)
            x_acc = jnp.where(hit, dense(frac), x_new)
            t_new = jnp.where(accept, t + dt_eff * jnp.where(hit, frac, 1.0), t)
            x_out = jnp.where(accept, x_acc, x)
            # FSAL carry: an accepted step's K[6] IS f(x_new); a rejected
            # step restarts from the same x, so v0 still holds.  (On an
            # event hit x_out is the Hermite endpoint, not x_new — but
            # that lane is done and its carry is never read again.)
            v_out = jnp.where(accept, v6, v0)
            fac = jnp.clip(0.9 * err ** (-0.2), 0.2, 5.0)
            dt_new = jnp.clip(dt * fac, 1e-6, cfg.max_step)
            finished = speed_stop | hit | (t_new >= cfg.t_max - 1e-12)
            return (x_out, v_out, t_new, dt_new,
                    done | (accept & finished) | speed_stop,
                    steps + 1, k + 1)

        s = (st_x, seed_v(st_x, st_v, st_steps), st_t, st_dt, st_done,
             st_steps, jnp.array(0, jnp.int32))
        x, v, t, dt, done, steps, _ = jax.lax.while_loop(cond, body, s)
        return x, v, t, dt, done, steps

    x, v, t, dt, done, steps = jax.vmap(one_seed)(
        state.x, state.v, state.t, state.dt, state.done, state.steps)
    return TraceState(x, v, t, dt, done, steps)


class FullTraceState(NamedTuple):
    """Device-resident full-grid state for the compacted chunked tracer.

    Everything stays in device memory between dispatches, instead of a
    host repack that moves ~12 small arrays per chunk-dispatch.  The
    host only ever reads ONE scalar per round (the not-done count) and
    the endpoints once at the end.
    """

    x: jnp.ndarray         # (N, 3)
    v: jnp.ndarray         # (N, 3) FSAL carry
    t: jnp.ndarray         # (N,)
    dt: jnp.ndarray        # (N,)
    done: jnp.ndarray      # (N,) bool
    steps: jnp.ndarray     # (N,) int32
    seed_id: jnp.ndarray   # (N,) int32 original seed index (or N = pad)
    lane_steps: jnp.ndarray  # () int64-ish f64-safe counter (int32 ok)


@jax.jit
def _init_full_state(x0: jnp.ndarray, max_step, n) -> FullTraceState:
    """Whole-grid state built ON DEVICE in one program from the single
    uploaded (N, 3) seed array, instead of eager per-field creation."""
    N = x0.shape[0]
    dtype = x0.dtype
    ar = jnp.arange(N, dtype=jnp.int32)
    return FullTraceState(
        x=x0,
        v=jnp.zeros((N, 3), dtype),
        t=jnp.zeros(N, dtype),
        dt=jnp.full(N, max_step, dtype),
        done=ar >= n,                     # pad lanes born done
        steps=jnp.zeros(N, jnp.int32),
        seed_id=jnp.minimum(ar, n),
        lane_steps=jnp.zeros((), jnp.int32),
    )


@jax.jit
def _finalize_full_state(st: FullTraceState, n):
    """(endpoints unpermuted to seed order, accepted-step count) in one
    device program + exactly two host fetches at the call site."""
    N = st.x.shape[0]
    ends = jnp.zeros((N, 3), st.x.dtype).at[st.seed_id].set(st.x)
    real = st.seed_id < n
    return ends, jnp.sum(jnp.where(real, st.steps, 0))


@jax.jit
def _compact_state(st: FullTraceState):
    """Pack not-done lanes to the front (stable) and return the count.

    argsort of the done flags is a stable partition: active lanes keep
    their relative order, so chunk k always holds the same seeds until
    they finish — executables see identical shapes every dispatch."""
    order = jnp.argsort(st.done, stable=True)
    packed = FullTraceState(*(a[order] for a in st[:7]), st.lane_steps)
    return packed, jnp.sum(~st.done, dtype=jnp.int32)


@partial(jax.jit, static_argnums=(4,))
def _run_chunk(cfg: TraceConfigDevice, dloc, u_cell,
               st: FullTraceState, chunk: int, offset: jnp.ndarray,
               seg_steps: jnp.ndarray) -> FullTraceState:
    """Advance lanes [offset, offset+chunk) by one bounded segment —
    slice, integrate, write back, all in ONE device program.  offset and
    seg_steps are traced scalars: one executable per (mesh, chunk)."""
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, offset, chunk)
    sub = TraceState(sl(st.x), sl(st.v), sl(st.t), sl(st.dt),
                     sl(st.done), sl(st.steps))
    prev = sub.steps
    # inline trace_segment's body (calling the jitted wrapper from inside
    # jit would re-trace it anyway); cfg._replace keeps max_steps honest
    out = _segment_core(cfg, dloc, u_cell, sub, seg_steps)
    wr = lambda a, b: jax.lax.dynamic_update_slice_in_dim(a, b, offset, 0)
    executed = jnp.max(jnp.where(sub.done, 0, out.steps - prev))
    return FullTraceState(
        wr(st.x, out.x), wr(st.v, out.v), wr(st.t, out.t),
        wr(st.dt, out.dt), wr(st.done, out.done), wr(st.steps, out.steps),
        st.seed_id,
        st.lane_steps + jnp.int32(chunk) * executed.astype(jnp.int32))


def trace_particles(
    cfg: TraceConfigDevice,
    dloc,
    u_nodes: jnp.ndarray,
    seeds: jnp.ndarray,            # (n, 3)
    reverse: bool = False,
    chunk: int = 0,
    seg_steps: int = 128,
    stats: dict | None = None,
) -> jnp.ndarray:
    """Integrate all seeds; returns endpoints (n, 3).

    reverse=True negates the field (velfunc_reverese, :159-173).

    chunk > 0 enables COMPACTED chunked dispatch (the product path for
    big seed grids): under vmap a finished lane still executes — and
    pays the locator gather bandwidth of — every remaining step of its
    batch, and wall-stalled stragglers run to max_steps (4096), so one
    straggler per 4096-seed chunk used to drag the whole chunk through
    all 16 segments.  Between bounded seg_steps segments the not-done
    seeds of ALL chunks are re-packed (host-side, ~100 KB round trips)
    into fresh chunk-width batches, always padded to the SAME width so
    every dispatch reuses ONE compiled executable per mesh.

    stats (optional dict) accumulates grounding numbers for the bench:
    total RK steps executed (lane-steps), dispatches, and seeds.
    """
    if reverse:
        cfg = cfg._replace(sign=-1.0)
    _t0 = _time.time()
    u_cell = pack_u_cells(dloc, u_nodes)
    jax.block_until_ready(u_cell)
    if stats is not None:
        stats.setdefault("pack_s", []).append(
            round(_time.time() - _t0, 3))
    if stats is not None:
        stats.setdefault("seeds", 0)
        stats.setdefault("dispatches", 0)
        stats.setdefault("lane_steps", 0)
        stats.setdefault("seed_steps", 0)
        stats["seeds"] += int(seeds.shape[0])
    if not chunk:
        state = init_trace_state(jnp.asarray(seeds), cfg, dloc, u_cell)
        max_dispatch = -(-int(cfg.max_steps) // seg_steps)
        for _ in range(max_dispatch):
            prev = np.asarray(state.steps)
            state = trace_segment(cfg, dloc, u_cell, state, seg_steps)
            if stats is not None:
                # masked lanes still execute every iteration of the
                # vmapped while_loop: executed lane-steps = lanes x the
                # max per-lane step delta this segment
                delta = int((np.asarray(state.steps) - prev).max())
                stats["dispatches"] += 1
                stats["lane_steps"] += state.x.shape[0] * delta
            if bool(state.done.all()):
                break
        if stats is not None:
            stats["seed_steps"] += int(np.asarray(state.steps).sum())
        return state.x

    n = int(seeds.shape[0])
    dtype = u_cell.dtype
    # pad the grid to a power-of-2 number of chunks: the compact /
    # run-chunk / finalize programs are shaped by N, and bucketing keeps
    # the set of N values (hence big-integrator compiles) tiny across
    # images/sweeps — fwd seed counts vary per image, rev is always the
    # product's 200x200 grid
    n_chunks = 1
    while n_chunks * chunk < n:
        n_chunks *= 2
    N = n_chunks * chunk
    _t0 = _time.time()
    x0 = np.zeros((N, 3), dtype)
    x0[:n] = np.array(seeds, dtype)
    # ONE upload + ONE device program builds the whole state (the FSAL
    # carry v is a placeholder — the segment seeds f(x) on device for
    # steps == 0 lanes, so there is no separate init program)
    st = _init_full_state(jnp.asarray(x0), cfg.max_step,
                          jnp.asarray(n, jnp.int32))
    max_rounds = -(-int(cfg.max_steps) // seg_steps)
    seg = jnp.asarray(seg_steps, jnp.int32)
    if stats is not None:
        jax.block_until_ready(st.x)
        stats.setdefault("setup_s", []).append(
            round(_time.time() - _t0, 3))
    for _ in range(max_rounds):
        _t0 = _time.time()
        st, n_active = _compact_state(st)
        na = int(n_active)                # the ONLY per-round host read
        if stats is not None:
            stats.setdefault("dispatch_s", []).append(
                round(_time.time() - _t0, 3))
        if na == 0:
            break
        _t0 = _time.time()
        for k in range(-(-na // chunk)):
            st = _run_chunk(cfg, dloc, u_cell, st, chunk,
                            jnp.asarray(k * chunk, jnp.int32), seg)
            if stats is not None:
                stats["dispatches"] += 1
        if stats is not None:
            # async dispatches: the wall of this round's chunk loop is
            # realized at the NEXT round's compact fetch; record enqueue
            # wall here, sync wall in the compact entry above
            stats.setdefault("dispatch_s", []).append(
                round(_time.time() - _t0, 3))
    # finalize ON DEVICE: unpermute to original seed order in one
    # program, then ONE bulk fetch (endpoints) + two scalars
    _t0 = _time.time()
    ends, seed_steps = _finalize_full_state(st, jnp.asarray(n, jnp.int32))
    ends = np.asarray(ends)[:n]
    if stats is not None:
        stats["seed_steps"] += int(seed_steps)
        stats["lane_steps"] += int(st.lane_steps)
        stats.setdefault("final_s", []).append(
            round(_time.time() - _t0, 3))
    return ends
