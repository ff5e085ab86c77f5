"""Phase timing + device profiling (SURVEY.md section 5 'tracing').

The reference brackets phases with wall-clock prints
(NavierStokesChannelFlow.py:289-299, streamtrace.py:221-249) and relies
on PETSc -ksp_monitor for solver residual histories.  Here:

* ``PhaseTimer`` collects named wall-clock spans (the ``timings`` dicts
  the pipeline returns);
* ``ksp/newton history`` lives in the solver results (NewtonResult.history);
* ``device_trace`` wraps ``jax.profiler.trace``; a profiler failure
  raises.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class PhaseTimer:
    def __init__(self):
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) \
                + (time.time() - t0)

    def report(self) -> str:
        width = max((len(k) for k in self.timings), default=0)
        return "\n".join(
            f"{k.ljust(width)}  {v:8.3f} s" for k, v in self.timings.items())


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """jax.profiler.trace wrapper; ``logdir=None`` traces nothing."""
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield
