"""Production-scale benchmark (VERDICT round-1 item 3): the full
InletBatchScript equivalent at the reference's production settings —
lc=0.04, Re sweep, 200 forward / 200x200 reverse seeds — converged to
the demonstrated floor, wall-clock per phase.  Matches
/root/reference/NavierStokes/run_all_RE.sh + InletBatchScript.py."""
import json
import os
import sys
import tempfile
import time

from stabilized_navier_stokes_flow_fenicsx.apps.inlet_batch import (
    run_trace_save)
from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
    make_annulus_image)

img = os.path.join(tempfile.gettempdir(), "bench_circle.png")
if not os.path.exists(img):
    make_annulus_image(img, "circle")

lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.04
res_list = [float(x) for x in sys.argv[2].split(",")] if len(sys.argv) > 2 \
    else [40.0, 50.0, 60.0, 70.0]
warm_mode = os.environ.get("SNS_SWEEP_WARM", "1") != "0"
rows = []
warm = None
for Re in res_list:
    t0 = time.time()
    sol, result, folder = run_trace_save(Re, img, 0.5, lc, warm=warm)
    if warm_mode:
        warm = sol          # sweep fast path (apps/sweep.py semantics)
    total = time.time() - t0
    row = {
        "Re": Re, "ndofs": 4 * sol.mesh.n_nodes,
        "n_cells": sol.mesh.n_cells,
        "newton_iters": sol.newton_iters,
        "resnorm": sol.newton_resnorm,
        "converged": bool(sol.converged),
        "refined": bool(sol.refined),
        "refine_resnorm": sol.refine_resnorm,
        "total_s": round(total, 1),
        "timings": {k: round(v, 1) for k, v in sol.timings.items()},
    }
    rows.append(row)
    print("ROW " + json.dumps(row), flush=True)
print("DONE " + json.dumps(rows), flush=True)
