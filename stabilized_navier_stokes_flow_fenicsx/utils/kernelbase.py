"""Element kernels with traced physical parameters.

The reference rebuilds and re-JITs its forms per Reynolds number (FFCx
compiles per-UFL-form; run_all_RE.sh sweeps Re in {40,50,60,70}).  The
first port inherited that shape: ``make_*_kernel(cell, nu=...)``
returned a fresh closure with nu BAKED into the jaxpr as a constant, so
every Re rung of a sweep — and every nu rung of a continuation ladder —
recompiled every multi-minute XLA program.

``ElementKernel`` fixes the economics the XLA way: the element functions
(residual, analytic tangent) are static and cached per structural
signature (cell, quadrature, stabilization variant) via lru_cache, while
the physical parameters (nu, ...) are pytree LEAVES.  A jitted driver
that takes the kernel as a *regular* argument traces it once per mesh
and reuses the executable for every parameter value:

    k40 = make_ns_sups_kernel("tetrahedron", nu=1/40)
    k70 = make_ns_sups_kernel("tetrahedron", nu=1/70)
    solve_newton_layered(k40, ...)   # compiles
    solve_newton_layered(k70, ...)   # cache hit — same treedef

Two invariants make the cache hit real:

* the factory's inner builder is lru_cached, so k40 and k70 share the
  SAME res/jac function objects (the treedef compares aux by identity);
* the kernel casts its parameter leaves to the working dtype at use
  (jit turns a python-float leaf into an f64 array under x64 — without
  the cast an f32 solve would silently upcast).
"""

from __future__ import annotations

import jax


@jax.tree_util.register_pytree_node_class
class ElementKernel:
    """Callable element kernel: ``kernel(coords_e, w_e) -> r_e``.

    ``kernel.jac(coords_e, w_e) -> J_e`` when an analytic tangent
    exists, else ``kernel.jac is None`` (assembly falls back to jacfwd).
    ``params`` (a tuple of scalars/arrays) are pytree leaves; the
    element functions receive them as their first argument.  Extra
    static attributes (e.g. the df kernels' nv/bs) ride in ``attrs``.

    ``kernel.res_soa`` / ``kernel.jac_soa`` are the optional
    structure-of-arrays variants (forms/soa.py: cell-minor (…, C)
    layout, the VPU-shaped assembly) — bound the same way, or None.
    """

    def __init__(self, res_fn, jac_fn, params, attrs=(), soa=None):
        self._res = res_fn
        self._jac = jac_fn
        self.params = tuple(params)
        self._attrs = tuple(attrs)
        self._soa = soa
        for k, v in self._attrs:
            setattr(self, k, v)
        if jac_fn is not None:
            self.jac = lambda coords, w: jac_fn(self.params, coords, w)
        else:
            self.jac = None
        if soa is not None:
            res_soa_fn, jac_soa_fn = soa
            self.res_soa = (lambda cT, wT:
                            res_soa_fn(self.params, cT, wT))
            self.jac_soa = (lambda cT, wT:
                            jac_soa_fn(self.params, cT, wT))
        else:
            self.res_soa = None
            self.jac_soa = None

    def __call__(self, coords, w):
        return self._res(self.params, coords, w)

    def tree_flatten(self):
        return self.params, (self._res, self._jac, self._attrs, self._soa)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        soa = aux[3] if len(aux) > 3 else None
        return cls(aux[0], aux[1], leaves, aux[2], soa)
