"""2D Laplace on the unit square (FE_Practice notebook 3): u = x on the
left/right edges by Dirichlet BC, natural elsewhere — solution u = x."""

import jax
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
    assembler_for_space)
from stabilized_navier_stokes_flow_fenicsx.fem.bc import (
    DirichletBC, bc_mask, bc_vector, combine_bcs)
from stabilized_navier_stokes_flow_fenicsx.fem.space import make_space
from stabilized_navier_stokes_flow_fenicsx.forms.poisson import (
    make_poisson_kernel)
from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
    unit_square_tri)
from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
    solve_spd_cg)


def main(n=32):
    mesh = unit_square_tri(n, n)
    fs = make_space(mesh, 1)
    asm = assembler_for_space(fs)
    pts = mesh.points
    left = np.nonzero(np.abs(pts[:, 0]) < 1e-12)[0]
    right = np.nonzero(np.abs(pts[:, 0] - 1) < 1e-12)[0]
    bc = combine_bcs([
        DirichletBC(left, np.zeros(len(left))),
        DirichletBC(right, np.ones(len(right))),
    ])
    mask = jnp.asarray(bc_mask(fs.ndofs, bc), asm.dtype)
    g = jnp.asarray(bc_vector(fs.ndofs, bc), asm.dtype)
    kern = make_poisson_kernel("triangle", 1, forcing=0.0)
    res = solve_spd_cg(kern, fs.ndofs, 1e-12, asm.arrays, mask, g)
    u = np.asarray(res.x)
    err = np.abs(u - pts[:, 0]).max()
    print(f"n={n}: max error vs u=x : {err:.2e}")
    return u


if __name__ == "__main__":
    main()
