"""Matched-mesh parity: L2 < 1e-6 against stored oracle fields.

The BASELINE.md north star requires fields matching the reference to
L2 < 1e-6 on matched meshes (reference solver tolerances:
NavierStokes/NavierStokesChannelFlow.py:281-283).  Fixtures are CPU-f64
solves of this framework, cross-validated by the physics oracles in
test_stokes_duct.py / test_cavity.py / test_dfg.py (see
parity_fixtures.py).  Each case checks:

  (a) regression: a fresh f64 solve reproduces the stored field, and
  (b) parity on the f32 configuration: the f32 + double-float-refinement
      path matches the stored f64 field to L2 < 1e-6 — the bar plain f32
      Newton cannot meet without the df refinement.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from parity_fixtures import (CHANNEL_PROD, FIXTURE_DIR, solve_cavity_ns,
                             solve_channel_ns, solve_duct_ns)


def _load(name):
    f = FIXTURE_DIR / f"{name}.npz"
    if not f.exists():
        pytest.skip(f"fixture {f} missing — run tests/parity_fixtures.py")
    return np.load(f)["w"]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_duct_f64_regression():
    w_ref = _load("duct_ns")
    w = solve_duct_ns(jnp.float64, refine=False)
    assert _rel(w, w_ref) < 1e-8


def test_duct_f32_refined_parity():
    w_ref = _load("duct_ns")
    w = solve_duct_ns(jnp.float32, refine=True)
    rel = _rel(w, w_ref)
    assert rel < 1e-6, rel
    # (that the bare f32 path does NOT meet this bar is pinned by
    # tests/test_dfloat.py::test_refine_reaches_1e8_and_matches_f64_solution)


def test_cavity_f64_regression():
    w_ref = _load("cavity_ns")
    w = solve_cavity_ns(jnp.float64)
    assert _rel(w, w_ref) < 1e-8


def test_cavity_f32_refined_parity():
    w_ref = _load("cavity_ns")
    w = solve_cavity_ns(jnp.float32)
    rel = _rel(w, w_ref)
    assert rel < 1e-6, rel


def test_channel_f32_refined_parity():
    """The flagship: image-derived channel, layered fast path, f32 solve +
    df refinement vs the stored f64 continuation solution."""
    w_ref = _load("channel_ns")
    w = solve_channel_ns(dtype=jnp.float32)
    rel = _rel(w, w_ref)
    assert rel < 1e-6, rel


# ---------------------------------------------------------------------------
# Production scale (VERDICT round-2 item 9): lc=0.04 — the lc the
# reference's NavierStokesChannelFlow.py actually runs at (~230k dofs).
# Hours per solve on the single-core CPU host, so gated behind
# PARITY_PROD=1 on top of the slow marker; run with
#   PARITY_PROD=1 python -m pytest tests/test_parity.py -k prod -m slow
# ---------------------------------------------------------------------------

_prod = pytest.mark.skipif(
    not os.environ.get("PARITY_PROD"),
    reason="production-scale parity: set PARITY_PROD=1 (hours on CPU)")


@_prod
@pytest.mark.slow
def test_channel_prod_f64_regression():
    w_ref = _load("channel_ns_prod")
    w = solve_channel_ns(case=CHANNEL_PROD)
    assert _rel(w, w_ref) < 1e-8


@_prod
@pytest.mark.slow
def test_channel_prod_f32_refined_parity():
    w_ref = _load("channel_ns_prod")
    w = solve_channel_ns(dtype=jnp.float32, case=CHANNEL_PROD)
    rel = _rel(w, w_ref)
    assert rel < 1e-6, rel
