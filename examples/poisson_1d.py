"""1D Poisson: -u'' = f on (0,1), u(0)=u(1)=0  (FE_Practice notebook 1).

The reference keeps four pedagogy notebooks (FE_Practice/*.ipynb,
SURVEY.md 2.1); these scripts are their native equivalents built on the
framework's own element/assembly stack.
"""

import jax
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
    assembler_for_space, residual_of)
from stabilized_navier_stokes_flow_fenicsx.fem.bc import (
    DirichletBC, bc_mask, bc_vector)
from stabilized_navier_stokes_flow_fenicsx.fem.elements import (
    element, quadrature)
from stabilized_navier_stokes_flow_fenicsx.fem.space import make_space
from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
    unit_interval)
from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
    solve_spd_cg)


def make_kernel(f=lambda x: np.pi**2 * np.sin(np.pi * x)):
    elem = element("interval", 1)
    qr = quadrature("interval", 3)
    phi, dphi = elem.tabulate(qr.points)

    def kernel(coords, w):
        h = coords[1, 0] - coords[0, 0]
        xq = coords[0, 0] + jnp.asarray(qr.points[:, 0], w.dtype) * h
        g = jnp.asarray(dphi[:, :, 0], w.dtype) / h          # (nq, 2)
        du = g @ w
        wq = jnp.asarray(qr.weights, w.dtype) * h
        stiff = jnp.einsum("q,q,qa->a", wq, du, g)
        load = jnp.einsum("q,q,qa->a", wq, jnp.pi**2 * jnp.sin(jnp.pi * xq),
                          jnp.asarray(phi, w.dtype))
        return stiff - load

    return kernel


def main(n=64):
    mesh = unit_interval(n)
    fs = make_space(mesh, 1)
    asm = assembler_for_space(fs)
    bc = DirichletBC(np.array([0, n]), np.zeros(2))
    mask = jnp.asarray(bc_mask(fs.ndofs, bc), asm.dtype)
    g = jnp.asarray(bc_vector(fs.ndofs, bc), asm.dtype)
    res = solve_spd_cg(make_kernel(), fs.ndofs, 1e-12, asm.arrays, mask, g)
    u = np.asarray(res.x)
    x = mesh.points[:, 0]
    err = np.abs(u - np.sin(np.pi * x)).max()
    print(f"n={n}: max error vs sin(pi x) = {err:.2e}")
    return u


if __name__ == "__main__":
    main()
