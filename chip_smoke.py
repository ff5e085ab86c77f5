#!/usr/bin/env python
"""Smoke run of the image -> Navier-Stokes -> outlet-points pipeline on a GPU.

    python chip_smoke.py                 # one GPU: phases 1-5
    python chip_smoke.py --four-cards    # four GPUs: phase 1 and phase 6 only

Phases, in one process; any failure exits nonzero:

1. Device: a GPU or exit.  Prints the card name and power limit, the JAX
   version, ``XLA_FLAGS`` and the compile-cache directory.
2. Double-float arithmetic (utils/dfloat.py) on the card against numpy
   float64: the error-free transforms must be exact; the df helpers and
   the df residual must agree with float64 to their stated bounds.
3. Parity at the production shape: the channel at lc 0.04 (~230k dofs),
   f32 Newton + df refinement through ``solve_ns_flow``, against the
   CPU-f64 oracle ``tests/fixtures/channel_ns_prod.npz`` (relative L2
   below 1e-6, the bar of tests/test_parity.py).
4. The main path at 1,053,696 dofs, as apps/inlet_batch.py runs it:
   solve -> XDMF write -> XDMF read -> forward and 200x200 reverse
   streamtrace (figures skipped).  Converged to 1e-8 of the initial
   residual, with outlet points.
5. SpMV: the solver's segment-sum layered matvec against the ELL
   formulation at the 1.05M shape, 100 applies each.
6. ``--four-cards``: the plane-sharded layered Newton and the
   row-partitioned BCSR Newton on a 4-GPU mesh against their
   single-device solves.

On the GPU, ``segment_sum`` scatter-adds lower to atomics, so sums can
differ from run to run in the last bits; every tolerance below leaves
room for that and says so.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PROD_FIXTURE = os.path.join(REPO, "tests", "fixtures", "channel_ns_prod.npz")

RE = 10                # apps/inlet_batch.py takes Re as an int
RATIO = 0.5
LC_PROD = 0.04         # tests/parity_fixtures.py::CHANNEL_PROD
LC_MAIN = 0.024        # 1,053,696 dofs
NUM_SEEDS = 200        # reference InletBatchScript.py:41


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> list:
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def phase_device(n_cards: int):
    """Phase 1.  Returns the JAX devices; exits when they are not GPUs
    (or, for ``n_cards`` > 1, not exactly that many)."""
    import jax

    from stabilized_navier_stokes_flow_fenicsx.utils.compile_cache import (
        enable_compile_cache)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform is "
                 f"{devices[0].platform!r}); this check runs only on a GPU")
    if n_cards > 1 and len(devices) != n_cards:
        sys.exit(f"chip_smoke: needs exactly {n_cards} GPUs, JAX sees "
                 f"{len(devices)}")
    cache = enable_compile_cache()
    log(f"[1] device_kind: {devices[0].device_kind} x{len(devices)}")
    for line in card_info():
        log(f"[1] card: {line}")
    log(f"[1] jax {jax.__version__}  "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}  "
        f"compile cache: {cache}")
    return devices


def _rand_f32(rng, n: int) -> np.ndarray:
    """Signed significands in [1, 2) times 2^[-12, 12]: every sum and
    product of two of them is exact in float64."""
    sig = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
    return (sig * 2.0 ** rng.integers(-12, 13, n)).astype(np.float32)


def check_dfloat(n: int = 4_000_000, seed: int = 0) -> dict:
    """Phase 2: the double-float layer on the default device.

    Bounds: ``two_sum`` and ``two_prod`` must be error-free — s == fl(a+b)
    and s + e == a + b exactly, p == fl(a*b) and p + e == a*b exactly,
    on every input.  A contracted FMA or a reassociated sum breaks this.
    The df dot product (df_einsum) must agree with float64 to 1e-13 of
    sum |x_i y_i|, and df add/mul/div to 1e-12 of |x| + |y|, |x y| and
    |x / y|."""
    import jax

    from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes_df import (
        split64)
    from stabilized_navier_stokes_flow_fenicsx.utils.dfloat import (
        df_add, df_div, df_einsum, df_mul, two_prod, two_sum)

    rng = np.random.default_rng(seed)
    a, b = _rand_f32(rng, n), _rand_f32(rng, n)
    # a quarter of the pairs nearly cancel
    q = n // 4
    b[:q] = (-a[:q] * (1.0 + _rand_f32(rng, q) * 2.0 ** -14)).astype(
        np.float32)
    s, e = (np.asarray(v) for v in jax.jit(two_sum)(a, b))
    p, f = (np.asarray(v) for v in jax.jit(two_prod)(a, b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    bad_sum = int(np.count_nonzero(
        (s != a + b) | (s.astype(np.float64) + e != a64 + b64)))
    bad_prod = int(np.count_nonzero(
        (p != a * b) | (p.astype(np.float64) + f != a64 * b64)))

    def f64(x):
        return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)

    rows, k = n // 16, 16
    x64 = rng.standard_normal((rows, k))
    y64 = (rng.standard_normal((rows, k))
           * 10.0 ** rng.integers(-3, 4, (rows, k)))
    X, Y = split64(x64), split64(y64)
    X64, Y64 = f64(X), f64(Y)
    dot = f64(jax.jit(lambda u, v: df_einsum("bi,bi->b", u, v))(X, Y))
    dot_err = float(np.max(np.abs(dot - np.einsum("bi,bi->b", X64, Y64))
                           / np.einsum("bi,bi->b", np.abs(X64), np.abs(Y64))))
    ew_err = 0.0
    for fn, ref, scale in (
            (df_add, X64 + Y64, np.abs(X64) + np.abs(Y64)),
            (df_mul, X64 * Y64, np.abs(X64 * Y64)),
            (df_div, X64 / Y64, np.abs(X64 / Y64))):
        got = f64(jax.jit(fn)(X, Y))
        ew_err = max(ew_err, float(np.max(np.abs(got - ref) / scale)))
    out = dict(n=n, two_sum_inexact=bad_sum, two_prod_inexact=bad_prod,
               df_dot_rel_err=dot_err, df_elementwise_rel_err=ew_err)
    if bad_sum or bad_prod or dot_err > 1e-13 or ew_err > 1e-12:
        raise AssertionError(f"double-float arithmetic broken on "
                             f"{jax.devices()[0].device_kind}: {out}")
    return out


def check_df_residual(img: str, lc: float = LC_PROD, seed: int = 0) -> dict:
    """Phase 2, assembled: the df NS residual (assemble/df_assembly.py)
    on the channel mesh at ``lc`` against the float64 assembly of the same
    residual.  Bound 5e-12 of max |r| (tests/test_dfloat.py); the f64
    reference sums with atomics, which moves it by ~1e-16 relative."""
    import jax
    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
        assembler_for_mixed)
    from stabilized_navier_stokes_flow_fenicsx.assemble.df_assembly import (
        DFResidual)
    from stabilized_navier_stokes_flow_fenicsx.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx.flow.channel import (
        generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes_df import (
        make_ns_sups_kernel_df, split64)

    mesh, _, _ = generate_channel_mesh(img, lc, DEFAULT, layered=True)
    W = make_mixed_space(mesh, 1, 1)
    w64 = np.random.default_rng(seed).standard_normal(W.ndofs) * 0.5
    rdf = DFResidual(W, make_ns_sups_kernel_df("tetrahedron", nu=1.0 / RE)
                     ).raw(split64(w64))
    got = np.asarray(rdf.hi, np.float64) + np.asarray(rdf.lo, np.float64)
    with jax.enable_x64(True):
        asm = assembler_for_mixed(W, dtype=jnp.float64)
        r64 = np.asarray(asm.residual(
            make_ns_sups_kernel("tetrahedron", nu=1.0 / RE),
            jnp.asarray(w64, jnp.float64)))
    assert r64.dtype == np.float64, r64.dtype
    scale = float(np.max(np.abs(r64)))
    err = float(np.max(np.abs(got - r64))) / scale
    out = dict(ndofs=W.ndofs, df_residual_err_over_max=err)
    if not err <= 5e-12:
        raise AssertionError(f"df residual disagrees with f64: {out}")
    return out


def check_prod_parity(img: str) -> dict:
    """Phase 3: f32 + df refinement at the production shape against the
    CPU-f64 oracle.  Bar: relative L2 < 1e-6 (tests/test_parity.py).
    Atomic scatter order changes the f32 Newton iterates in the last
    bits; the refined solution is pinned by the 1e-8 df residual, which
    atomics do not touch (the df reduction is a gather)."""
    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx.flow.channel import (
        solve_ns_flow)

    ref = np.load(PROD_FIXTURE)
    t0 = time.perf_counter()
    sol = solve_ns_flow(float(ref["Re"]), img, float(ref["ratio"]),
                        channel_mesh_size=float(ref["lc"]),
                        coarse_lc=float(ref["lc"]), dtype=jnp.float32)
    wall = time.perf_counter() - t0
    w = np.asarray(sol.w, np.float64) + np.asarray(sol.w_lo, np.float64)
    rel = float(np.linalg.norm(w - ref["w"]) / np.linalg.norm(ref["w"]))
    out = dict(ndofs=int(w.size), rel_l2=rel, wall_s=wall,
               newton_its=sol.newton_iters, refine_its=sol.refine_iters,
               df_resnorm=sol.refine_resnorm, n0=sol.refine_n0,
               converged=sol.converged)
    if not (sol.refined and sol.converged and rel < 1e-6):
        raise AssertionError(f"production parity failed: {out}")
    return out


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations (over all
    threads) while installed."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.seconds = {e.rsplit("/", 1)[1]: 0.0 for e in self.EVENTS}

    def __call__(self, event, duration, **kwargs):
        if event in self.EVENTS:
            self.seconds[event.rsplit("/", 1)[1]] += duration

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self)


def run_main_path(img: str, folder_root: str, lc: float = LC_MAIN,
                  num_seeds: int = NUM_SEEDS):
    """Phase 4: the calls of apps/inlet_batch.py::run_trace_save, in its
    order and with its config, minus the figure writer."""
    import jax

    from stabilized_navier_stokes_flow_fenicsx.apps.ns_channel import (
        save_navier_stokes_solution)
    from stabilized_navier_stokes_flow_fenicsx.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx.flow.channel import (
        solve_ns_flow)
    from stabilized_navier_stokes_flow_fenicsx.flow.inlet import (
        solve_inlet_profiles)
    from stabilized_navier_stokes_flow_fenicsx.io.metadata import (
        make_output_folder, write_run_metadata)
    from stabilized_navier_stokes_flow_fenicsx.io.xdmf import (
        read_xdmf_function)
    from stabilized_navier_stokes_flow_fenicsx.trace.pipeline import (
        for_and_rev_streamtrace)

    wall = {}
    with CompileClock() as clock:
        t0 = time.perf_counter()
        sol = solve_ns_flow(RE, img, RATIO, lc, DEFAULT)
        wall["solve"] = time.perf_counter() - t0
        folder, img_name = make_output_folder(RE, img, lc, root=folder_root)
        write_run_metadata(
            folder, RE, img, RATIO, lc, sol.space.Q.ndofs, sol.space.V.ndofs,
            len(jax.devices()), img_name)
        t0 = time.perf_counter()
        save_navier_stokes_solution(sol, folder)
        wall["xdmf_write"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh, u = read_xdmf_function(
            f"{folder}/Re{RE}ChannelVelocity", "Velocity")
        wall["xdmf_read"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inlet1, _ = solve_inlet_profiles(img, RATIO, DEFAULT)
        result = for_and_rev_streamtrace(
            num_seeds, img, mesh, u, inlet1.mesh.points, DEFAULT)
        wall["trace"] = time.perf_counter() - t0
    return sol, result, wall, clock.seconds


def check_main_path(sol, result) -> dict:
    """Phase 4 bar: the refined residual reached 1e-8 of ||F(w0)|| (the
    reference's SNES rtol), and the reverse trace found outlet points."""
    rel = sol.refine_resnorm / sol.refine_n0
    out = dict(ndofs=int(sol.space.ndofs), newton_its=sol.newton_iters,
               refine_its=sol.refine_iters, df_resnorm=sol.refine_resnorm,
               n0=sol.refine_n0, rel_resnorm=rel,
               n_outlet_points=int(len(result.outlet_points)))
    if not (sol.refined and rel <= 1e-8 and out["n_outlet_points"] > 0):
        raise AssertionError(f"main path failed: {out}")
    return out


def _median_time(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))               # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def ell_layout(row_ids, cols, n2d: int):
    """The ELL alternative to the segment-sum SpMV, kept here only to be
    timed against it: the row-sorted 2D pair list padded to a fixed
    degree D.  Returns (perm, slot_mask, ell_cols), each (n2d, D)."""
    row_ids, cols = np.asarray(row_ids), np.asarray(cols)
    counts = np.bincount(row_ids, minlength=n2d)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(row_ids)) - start[row_ids]
    shape = (n2d, int(counts.max()))
    perm, mask, ell_cols = (np.zeros(shape, np.int32),
                            np.zeros(shape, np.float32),
                            np.zeros(shape, np.int32))
    perm[row_ids, slot] = np.arange(len(row_ids))
    mask[row_ids, slot] = 1.0
    ell_cols[row_ids, slot] = cols
    return perm, mask, ell_cols


def ell_values(perm, mask, n2d: int, V):
    """(bs, bs, 3, E, Lp) layered values -> (n2d, D, bs, bs, 3, Lp)."""
    bs, Lp = V.shape[0], V.shape[-1]
    v = V.reshape(bs * bs * 3, -1, Lp)[:, perm.reshape(-1), :]
    v = v * mask.reshape(1, -1, 1)
    return v.transpose(1, 0, 2).reshape(n2d, perm.shape[1], bs, bs, 3, Lp)


def ell_matvec(ell_cols, n2d: int, v_ell, x):
    """y = A x with the row reduction a dense sum over the D slots."""
    import jax.numpy as jnp

    _, D, bs, _, _, Lp = v_ell.shape
    xg = x.reshape(Lp, n2d, bs)[:, ell_cols.reshape(-1), :]
    xg = xg.transpose(1, 2, 0).reshape(n2d, D, bs, Lp)
    zero = jnp.zeros((n2d, D, bs, 1), xg.dtype)
    xs = jnp.stack([jnp.concatenate([zero, xg[..., :-1]], axis=-1), xg,
                    jnp.concatenate([xg[..., 1:], zero], axis=-1)], axis=3)
    y = (v_ell * xs[:, :, None]).sum(axis=(1, 3, 4))     # (n2d, bs, Lp)
    return y.transpose(2, 0, 1).reshape(-1)


def compare_spmv(sol, n_apply: int = 100, seed: int = 0) -> dict:
    """Phase 5: the solver's segment-sum ``layered_matvec`` against the
    ELL matvec on the solved mesh, ``n_apply`` distinct vectors in one
    program, each timed as the median of 5 runs.  They must agree to
    f32 rounding: |y_seg - y_ell| <= 2 * terms * eps32 * (|A| |x|)
    row-wise, where terms is the most products one row sums (the two
    orders round independently; atomics reorder the segment sum)."""
    import jax
    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx.assemble.layered import (
        build_layered, layered_matvec, matrix_values_layered)
    from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
        make_ns_sups_kernel)

    n2d, Lp, _ = sol.mesh.layered
    lp = build_layered(sol.space, n2d, Lp, jnp.float32)
    arrays = lp.arrays
    V = matrix_values_layered(make_ns_sups_kernel("tetrahedron", nu=1 / RE),
                              lp.E, Lp, lp.bs, arrays,
                              jnp.asarray(sol.w, jnp.float32))
    perm, mask, ell_cols = (jnp.asarray(a) for a in ell_layout(
        arrays.row_ids, arrays.cols, n2d))
    X = jax.random.normal(jax.random.PRNGKey(seed),
                          (n_apply, lp.ndofs), jnp.float32)

    @jax.jit
    def seg(arrays, V, X):
        return jax.lax.map(
            lambda x: layered_matvec(arrays, n2d, Lp, V, x), X)

    @jax.jit
    def ell(ell_cols, v_ell, X):
        return jax.lax.map(lambda x: ell_matvec(ell_cols, n2d, v_ell, x), X)

    to_ell = jax.jit(lambda perm, mask, V: ell_values(perm, mask, n2d, V))
    v_ell = to_ell(perm, mask, V)
    t_seg = _median_time(seg, arrays, V, X) / n_apply
    t_ell = _median_time(ell, ell_cols, v_ell, X) / n_apply
    t_to_ell = _median_time(to_ell, perm, mask, V)
    y_seg, y_ell = seg(arrays, V, X[:2]), ell(ell_cols, v_ell, X[:2])
    bound = seg(arrays, jnp.abs(V), jnp.abs(X[:2]))
    terms = 3 * int(perm.shape[1]) * lp.bs
    excess = float(jnp.max(jnp.abs(y_seg - y_ell)
                           - 2 * terms * np.finfo(np.float32).eps * bound))
    value_bytes = V.size * V.dtype.itemsize
    out = dict(ndofs=lp.ndofs, segment_sum_ms=t_seg * 1e3,
               ell_ms=t_ell * 1e3, ell_value_permute_ms=t_to_ell * 1e3,
               ell_slots_per_row=int(perm.shape[1]),
               value_mb=value_bytes / 1e6,
               segment_sum_value_gbps=value_bytes / t_seg / 1e9,
               ell_value_gbps=value_bytes / t_ell / 1e9)
    if excess > 0:
        raise AssertionError(f"ELL and segment-sum SpMV disagree beyond "
                             f"f32 rounding by {excess}: {out}")
    return out


def channel_problem(img: str, lc: float):
    """The channel's layered pattern, BC mask/values and kernel — the
    setup of flow/channel.py::_setup_layered, as host arrays."""
    from stabilized_navier_stokes_flow_fenicsx.config import DEFAULT
    from stabilized_navier_stokes_flow_fenicsx.fem.bc import (
        DirichletBC, bc_mask, bc_vector, combine_bcs)
    from stabilized_navier_stokes_flow_fenicsx.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx.flow.channel import (
        channel_bcs, generate_channel_mesh)
    from stabilized_navier_stokes_flow_fenicsx.flow.inlet import (
        solve_inlet_profiles)

    inlet1, inlet2 = solve_inlet_profiles(img, RATIO, DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, lc, DEFAULT, layered=True)
    W = make_mixed_space(mesh, 1, 1)
    _, _, used = mesh.layered
    bs = W.block_size
    unused = np.nonzero(~used)[0].astype(np.int64)
    unused_dofs = (unused[:, None] * bs + np.arange(bs)[None, :]).ravel()
    bc = combine_bcs([DirichletBC(unused_dofs, np.zeros(len(unused_dofs))),
                      channel_bcs(mesh, W, inlet1, inlet2)])
    mask = bc_mask(W.ndofs, bc).astype(np.float32)
    g = bc_vector(W.ndofs, bc).astype(np.float32)
    return mesh, W, mask, g


def check_sharded(devices, img: str, lc: float = LC_PROD,
                  n_steps: int = 3) -> dict:
    """Phase 6: the multi-device Newton paths against one device, same
    number of Newton steps.  Bar: relative L2 < 1e-5 between the
    iterates.  The sharded runs sum over ``psum`` (and the single-device
    runs over atomics) in other orders, so the f32 iterates differ by
    rounding that a few Krylov solves amplify; 1e-5 after 3 steps holds
    that with margin and still catches a wrong halo or partition."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
        assembler_for_mixed)
    from stabilized_navier_stokes_flow_fenicsx.assemble.layered import (
        build_layered)
    from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx.parallel.layered_shard import (
        pad_mask_g, padded_planes, sharded_newton_layered)
    from stabilized_navier_stokes_flow_fenicsx.parallel.shard import (
        spmd_newton_bcsr)
    from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
        solve_newton_bcsr, solve_newton_layered)
    from stabilized_navier_stokes_flow_fenicsx.solve.mg import (
        build_mg_hierarchy)

    n_dev = len(devices)
    mesh, W, mask, g = channel_problem(img, lc)
    n2d, Lp, _ = mesh.layered
    kern = make_ns_sups_kernel("tetrahedron", nu=1.0 / RE)
    ksp = dict(ksp_rtol=1e-6, ksp_restart=30, ksp_max_restarts=8)
    out = dict(ndofs=W.ndofs, devices=n_dev, newton_steps=n_steps)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # plane-sharded layered Newton with the MG V-cycle
    lp1 = build_layered(W, n2d, Lp, jnp.float32)
    hier = build_mg_hierarchy(
        np.asarray(lp1.pattern_like.row_ids),
        np.asarray(lp1.pattern_like.indices),
        lp1.n2d, lp1.n_planes, mask, lp1.bs, n_levels=2)
    t0 = time.perf_counter()
    one = solve_newton_layered(
        kern, n2d, Lp, lp1.bs, lp1.arrays, jnp.asarray(mask),
        jnp.asarray(g), jnp.asarray(g), lp1.E, 0.0, 0.0, n_steps,
        ksp["ksp_rtol"], ksp["ksp_restart"], ksp["ksp_max_restarts"],
        "mg_cheby", hier)
    x1 = np.asarray(one.x)
    out["layered_single_s"] = time.perf_counter() - t0
    lp = build_layered(W, n2d, padded_planes(Lp, n_dev), jnp.float32)
    mask_p, g_p = pad_mask_g(mask, g, lp.ndofs)
    t0 = time.perf_counter()
    many = sharded_newton_layered(
        kern, lp, mask_p, g_p, g_p, Mesh(np.array(devices), ("planes",)),
        pc="mg", mg_levels=2, rtol=0.0, atol=0.0, max_it=n_steps, **ksp)
    xs = np.asarray(many.x)[:W.ndofs]
    out["layered_sharded_s"] = time.perf_counter() - t0
    if int(one.iters) < n_steps or int(many.iters) < n_steps:
        raise AssertionError(f"layered Newton stopped early: "
                             f"{int(one.iters)}, {int(many.iters)}")
    out["layered_rel_l2"] = rel(xs, x1)

    # row-partitioned BCSR Newton (GSPMD) with block Jacobi
    asm = assembler_for_mixed(W, dtype=jnp.float32)
    pat = asm.pattern
    bcsr = dict(rtol=0.0, atol=0.0, max_it=n_steps, ksp_rtol=1e-2,
                ksp_restart=20, ksp_max_restarts=2)
    w0 = jnp.zeros(W.ndofs, jnp.float32)
    t0 = time.perf_counter()
    one = solve_newton_bcsr(
        kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays,
        jnp.asarray(mask), jnp.asarray(g), w0, **bcsr)
    x1 = np.asarray(one.x)
    out["bcsr_single_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    many = spmd_newton_bcsr(asm, kern, jnp.asarray(mask), jnp.asarray(g),
                            w0, Mesh(np.array(devices), ("dofs",)), **bcsr)
    xs = np.asarray(many.x)[:W.ndofs]
    out["bcsr_sharded_s"] = time.perf_counter() - t0
    out["bcsr_rel_l2"] = rel(xs, x1)
    if not (out["layered_rel_l2"] < 1e-5 and out["bcsr_rel_l2"] < 1e-5):
        raise AssertionError(f"sharded Newton diverges from one device: "
                             f"{out}")
    return out


def _fmt(d: dict) -> str:
    return "  ".join(f"{k}={v}" for k, v in d.items())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded Newton check")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    n_cards = 4 if args.four_cards else 1
    devices = phase_device(n_cards)

    import jax

    from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
        make_annulus_image)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        img = make_annulus_image(os.path.join(tmp, "circle.png"), "circle")
        if args.four_cards:
            log(f"[6] {_fmt(check_sharded(devices, img))}")
        else:
            t0 = time.perf_counter()
            log(f"[2] {_fmt(check_dfloat())}")
            log(f"[2] {_fmt(check_df_residual(img))}")
            log(f"[2] wall {time.perf_counter() - t0:.2f} s")
            log(f"[3] {_fmt(check_prod_parity(img))}")
            sol, result, wall, compile_s = run_main_path(img, tmp)
            log(f"[4] {_fmt(check_main_path(sol, result))}")
            log(f"[4] wall_s {_fmt(wall)}")
            log(f"[4] solve phases_s {_fmt(sol.timings)}")
            log(f"[4] trace stats {_fmt(result.stats)}")
            log(f"[4] compile_s (summed over programs and threads) "
                f"{_fmt(compile_s)}")
            peak = devices[0].memory_stats().get("peak_bytes_in_use", 0)
            log(f"[4] peak_bytes_in_use {peak} ({peak / 2**30:.2f} GiB)")
            log(f"[4] card {'; '.join(card_info())}")
            log(f"[5] {_fmt(compare_spmv(sol))}")
            log(f"[5] card {'; '.join(card_info())}")
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
