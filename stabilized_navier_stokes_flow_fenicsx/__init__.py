"""Stabilized finite-element Navier-Stokes framework in JAX.

A from-scratch re-design (JAX/XLA) of the capabilities of the
reference application ``mungerct/Stabilized_Navier_Stokes_Flow_FEniCSx``:
image-defined co-extrusion channel flow solved with stabilized P1-P1 /
Taylor-Hood finite elements, Newton/Krylov solvers, and vmapped RK45
streamtracing — all device-resident.

Layers (bottom-up), mirroring SURVEY.md section 7:

- ``fem``       element tables, function spaces, dofmaps, boundary conditions
- ``mesh``      image->contour pipeline, native 2D/3D meshers, device mesh arrays
- ``forms``     element residual kernels (Poisson / stabilized Stokes / SUPS NS)
- ``assemble``  vmapped element kernels + segment-sum scatter, BCSR matrices
- ``solve``     Krylov (FGMRES/BiCGStab/TFQMR), Newton (SNES-equivalent), direct
- ``trace``     vmapped RK45 forward/reverse streamtracing with events
- ``io``        XDMF output, run manifests
- ``parallel``  shard_map element sharding over jax.sharding.Mesh
- ``apps``      CLI entry points with the reference's argv contracts
"""

__version__ = "0.1.0"

import jax as _jax

# FEM assembly is accuracy-critical: on Hopper, XLA may run f32
# matmul/einsum/dot through the tensor cores in TF32 (10-bit mantissa),
# which would put a noise floor far above the 1e-6 relative residual the
# f32 Newton reaches.  "float32" keeps f32 dots in full f32.
_jax.config.update("jax_default_matmul_precision", "float32")

from . import config as config
