"""Steady 1D viscous Burgers: u u' = nu u'' on (0,1), u(0)=1, u(1)=-1
(FE_Practice notebook 2 — Newton iteration on a nonlinear form)."""

import jax
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
    assembler_for_space)
from stabilized_navier_stokes_flow_fenicsx.fem.bc import (
    DirichletBC, bc_mask, bc_vector)
from stabilized_navier_stokes_flow_fenicsx.fem.elements import (
    element, quadrature)
from stabilized_navier_stokes_flow_fenicsx.fem.space import make_space
from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
    unit_interval)
from stabilized_navier_stokes_flow_fenicsx.solve.newton_host import (
    newton_host_lu)


def make_kernel(nu=0.05):
    elem = element("interval", 1)
    qr = quadrature("interval", 3)
    phi_np, dphi_np = elem.tabulate(qr.points)

    def kernel(coords, w):
        h = coords[1, 0] - coords[0, 0]
        phi = jnp.asarray(phi_np, w.dtype)
        g = jnp.asarray(dphi_np[:, :, 0], w.dtype) / h
        wq = jnp.asarray(qr.weights, w.dtype) * h
        uq = phi @ w
        du = g @ w
        adv = jnp.einsum("q,q,q,qa->a", wq, uq, du, phi)
        visc = nu * jnp.einsum("q,q,qa->a", wq, du, g)
        return adv + visc

    return kernel


def main(n=128, nu=0.05):
    mesh = unit_interval(n)
    fs = make_space(mesh, 1)
    asm = assembler_for_space(fs)
    bc = DirichletBC(np.array([0, n]), np.array([1.0, -1.0]))
    mask = jnp.asarray(bc_mask(fs.ndofs, bc), asm.dtype)
    g = jnp.asarray(bc_vector(fs.ndofs, bc), asm.dtype)
    x0 = jnp.asarray(1.0 - 2.0 * mesh.points[:, 0])    # linear initial guess
    res = newton_host_lu(asm, make_kernel(nu), mask, g, x0, rtol=1e-12)
    u = np.asarray(res.x)
    print(f"Newton iters: {res.iters}, converged: {res.converged}")
    # the solution is the tanh shock profile u = -tanh((x-1/2)/(2 nu)) * c
    mid = u[np.argmin(np.abs(mesh.points[:, 0] - 0.5))]
    print(f"u(0.5) = {mid:.3e} (expect ~0 by symmetry)")
    return u


if __name__ == "__main__":
    main()
