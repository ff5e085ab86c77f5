"""CLI: the full batch pipeline — solve + streamtrace + figures.

Reference NavierStokes/InletBatchScript.py: run with
    mpirun -n 6 ./InletBatchScript.py <Re> <img> <ratio> <lc>
(reference run_all_RE.sh:9); here one process drives the device:
    python -m ...apps.inlet_batch <Re> <img> <ratio> [<lc>]
num_seeds=200, limits=1 per InletBatchScript.py:41-42.
"""

from __future__ import annotations

import sys
import traceback

import jax

from ..config import DEFAULT
from ..flow.inlet import solve_inlet_profiles
from ..io.metadata import make_output_folder, write_run_metadata
from ..io.xdmf import read_xdmf_function
from ..trace.figures import save_trace_figures
from ..trace.pipeline import for_and_rev_streamtrace
from .ns_channel import parse_arguments, save_navier_stokes_solution
from ..flow.channel import solve_ns_flow

NUM_SEEDS = 200
LIMITS = 1.0


def run_trace_save(Re, img_fname, flowrate_ratio, channel_mesh_size,
                   num_seeds=NUM_SEEDS, limits=LIMITS, warm=None):
    """Solve -> save -> re-read from disk -> trace -> figures (the
    reference's exact flow, including the checkpoint round-trip:
    streamtrace re-reads the saved velocity, streamtrace.py:590).

    warm: previous-Re ChannelSolution on the same (image, lc) — the
    sweep fast path (flow/channel.py::_solve_ns_flow_warm)."""
    try:
        sol = solve_ns_flow(Re, img_fname, flowrate_ratio,
                            channel_mesh_size, DEFAULT, warm=warm)
        folder, img_name = make_output_folder(
            Re, img_fname, channel_mesh_size)
        write_run_metadata(
            folder, Re, img_fname, flowrate_ratio, channel_mesh_size,
            sol.space.Q.ndofs, sol.space.V.ndofs,
            len(jax.devices()), img_name)
        save_navier_stokes_solution(sol, folder)

        # checkpoint round-trip, like the reference
        mesh, u = read_xdmf_function(
            f"{folder}/Re{Re}ChannelVelocity", "Velocity")

        inlet1, _ = solve_inlet_profiles(img_fname, flowrate_ratio, DEFAULT)
        seed_points = inlet1.mesh.points
        result = for_and_rev_streamtrace(
            num_seeds, img_fname, mesh, u, seed_points, DEFAULT)
        save_trace_figures(folder, img_fname, result, seed_points,
                           num_seeds, limits)
        print(f"Saved outputs to {folder}", flush=True)
        return sol, result, folder
    except Exception:
        traceback.print_exc()
        raise


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    Re, img_fname, ratio, lc = parse_arguments(argv)
    return run_trace_save(Re, img_fname, ratio, lc)


if __name__ == "__main__":
    main()
