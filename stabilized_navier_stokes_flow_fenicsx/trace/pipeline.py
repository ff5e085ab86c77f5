"""Forward + reverse streamtrace pipeline (outlet-profile recovery).

Replicates reference NavierStokes/streamtrace.py:556-664
(for_and_rev_streamtrace):

  1. forward-trace the inner-inlet mesh vertices through the velocity
     field; keep endpoints past x = 0.5 (:211-218)
  2. alpha-shape (alpha=0.2) of the endpoints' (y, z); push the bbox out
     by 20% (:292-343)
  3. release a num_seeds x num_seeds grid at x = 3.9 (:346-355)
  4. reverse-trace the grid; keep endpoints that return past x < 0.5,
     else mark (10, 10, 10) (:357-383)
  5. keep seeds whose backward endpoints land inside the inlet inner
     contour — their (y, z) are the predicted outlet profile (:536-553)

The reference farms this over MPI ranks with tqdm progress bars; here both
traces are single vmapped device programs (trace/streamtrace.py).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..config import Config, DEFAULT
from ..fem.interpolate import build_trace_locator
from ..mesh.core import SimplexMesh
from ..mesh.image import get_contours, load_image, optimize_contour
from ..mesh.tri2d import points_in_polygon
from .alpha_shape import alpha_shape_polygon, expand_bbox
from .streamtrace import TraceConfigDevice, trace_particles

# seeds per device dispatch: bounds the locator gather intermediates.
# trace_particles COMPACTS not-done seeds across chunks between 128-step
# segments and always pads to this width, so the whole pipeline (forward
# + every reverse round + every Re rung) runs ONE compiled executable per
# mesh.
SEED_CHUNK = 4096


def _trace_chunked(cfg, dloc, u_dev, seeds, reverse, stats=None):
    return np.asarray(trace_particles(
        cfg, dloc, u_dev, jnp.asarray(seeds), reverse, chunk=SEED_CHUNK,
        stats=stats))


@dataclasses.dataclass
class StreamtraceResult:
    forward_endpoints: np.ndarray     # (nf, 3) kept forward endpoints
    seeds: np.ndarray                 # (ns, 3) reverse seed grid
    reverse_endpoints: np.ndarray     # (ns, 3)
    outlet_points: np.ndarray         # (m, 2) predicted outlet profile (y, z)
    inner_contour: np.ndarray         # (k, 2) inlet inner contour (y, z)
    stats: dict = dataclasses.field(default_factory=dict)
    # grounding numbers (bench trace roofline): seeds, dispatches,
    # executed lane_steps (masked lanes included), accepted seed_steps,
    # per-phase wall seconds


def update_contour(img_fname: str, cfg: Config = DEFAULT) -> np.ndarray:
    """Inlet inner contour as (k, 3) rows (0, y, z) — reference
    streamtrace.py:132-142."""
    gray = load_image(img_fname)
    contours = get_contours(gray, cfg.contour)
    c, _ = optimize_contour(
        contours[1], cfg.contour.fft_cutoff_inlet, cfg.contour.rdp_epsilon,
        cfg.contour.mesh_lc_frac_inlet)
    yz = c[:, [1, 0]]
    return np.hstack([np.zeros((len(yz), 1)), yz])


def for_and_rev_streamtrace(
    num_seeds: int,
    img_fname: str,
    mesh: SimplexMesh,
    u_nodal: np.ndarray,
    seed_points: np.ndarray,
    cfg: Config = DEFAULT,
) -> StreamtraceResult:
    """Full forward+reverse trace.

    seed_points: (n, 2) (y, z) forward seeds (inner inlet mesh vertices —
    the reference re-solves the inlet profiles to get them, :190-196).
    """
    import time as _time

    tc = cfg.trace
    contour3 = update_contour(img_fname, cfg)
    inner_contour = contour3[:, 1:3]

    stats: dict = {}
    t0 = _time.time()
    dloc = build_trace_locator(mesh)
    u_dev = jnp.asarray(u_nodal)
    stats["locator_build_s"] = round(_time.time() - t0, 2)

    fwd_cfg = TraceConfigDevice(
        t_max=tc.t_span, max_step=tc.max_step, speed_eps=tc.speed_eps,
        x_stop=tc.x_forward_stop, stop_direction=1,
        rtol=tc.rtol, atol=tc.atol, max_steps=tc.max_steps)
    seeds_fwd = np.hstack(
        [np.zeros((len(seed_points), 1)), seed_points])
    t0 = _time.time()
    fwd_end = _trace_chunked(fwd_cfg, dloc, u_dev, seeds_fwd, False, stats)
    stats["fwd_s"] = round(_time.time() - t0, 2)
    kept = fwd_end[fwd_end[:, 0] > tc.x_forward_keep]

    # expansion + reverse seed grid
    poly = alpha_shape_polygon(kept[:, 1:3], tc.alpha)
    minx, maxx, miny, maxy = expand_bbox(poly[:, 0], poly[:, 1], tc.blurr)
    ys = np.linspace(minx, maxx, num_seeds)
    zs = np.linspace(miny, maxy, num_seeds)
    Y, Z = np.meshgrid(ys, zs)
    grid = np.stack([Y.ravel(), Z.ravel()], axis=1)
    seeds_rev = np.hstack(
        [np.full((len(grid), 1), tc.x_seed_plane), grid])

    rev_cfg = TraceConfigDevice(
        t_max=tc.t_span, max_step=tc.max_step, speed_eps=tc.speed_eps,
        x_stop=tc.x_reverse_stop, stop_direction=-1,
        rtol=tc.rtol, atol=tc.atol, max_steps=tc.max_steps)
    t0 = _time.time()
    rev_end = _trace_chunked(rev_cfg, dloc, u_dev, seeds_rev, True, stats)
    stats["rev_s"] = round(_time.time() - t0, 2)
    # reference: endpoints not back past x=0.5 are marked (10,10,10)
    rev_end = np.where(
        (rev_end[:, 0] < tc.x_forward_keep)[:, None], rev_end, 10.0)

    inside = points_in_polygon(rev_end[:, 1:3], inner_contour)
    outlet = seeds_rev[inside][:, 1:3]

    return StreamtraceResult(
        forward_endpoints=kept,
        seeds=seeds_rev,
        reverse_endpoints=rev_end,
        outlet_points=outlet,
        inner_contour=inner_contour,
        stats=stats,
    )
