"""CLI: parameter sweeps replacing run_all_RE.sh / run_all_images.sh.

Reference shell sweeps (run_all_RE.sh:7-10, run_all_images.sh:4-7):
Re in {40,50,60,70} at a fixed image, or all images at Re=10; both with
flowrate ratio 0.5, lc 0.04 and mpirun -n 6.  One device process replaces
the MPI job; runs are sequential (each is itself device-parallel).

    sweep.py re  <img> [Re...]            # default 40 50 60 70
    sweep.py img <img_dir> [Re]           # default 10
"""

from __future__ import annotations

import glob
import os
import sys

from .inlet_batch import run_trace_save

RATIO = 0.5
LC = 0.04


def sweep_re(img: str, res) -> None:
    # Reynolds-sweep warm start: each Re after the first begins its fine
    # Newton from the previous Re's fine solution (same image, same lc)
    # and skips the coarse continuation entirely — identical converged
    # result, a fraction of the wall-clock.  The reference re-runs the
    # whole pipeline per Re (run_all_RE.sh:7-10).
    warm = None
    for Re in res:
        print(f"==== Re={Re} {img} ====", flush=True)
        sol, _, _ = run_trace_save(int(Re), img, RATIO, LC, warm=warm)
        warm = sol


def sweep_images(img_dir: str, Re: int) -> None:
    for img in sorted(glob.glob(os.path.join(img_dir, "*.png"))):
        print(f"==== Re={Re} {img} ====", flush=True)
        try:
            run_trace_save(Re, img, RATIO, LC)
        except Exception as e:          # keep sweeping like the shell loop
            print(f"FAILED {img}: {e}", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise ValueError(__doc__)
    mode = argv[0]
    if mode == "re":
        img = os.path.abspath(argv[1])
        res = [int(r) for r in argv[2:]] or [40, 50, 60, 70]
        sweep_re(img, res)
    elif mode == "img":
        Re = int(argv[2]) if len(argv) > 2 else 10
        sweep_images(argv[1], Re)
    else:
        raise ValueError(__doc__)


if __name__ == "__main__":
    main()
