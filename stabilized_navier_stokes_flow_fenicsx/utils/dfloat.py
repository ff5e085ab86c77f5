"""Double-float (two-f32) arithmetic for reference-grade precision from f32.

The solve runs in f32, where a plain Newton solve floors at ~1e-6
relative residual — far from the reference's SNES rtol=atol=1e-8
(reference NavierStokes/NavierStokesChannelFlow.py:281-283).  This module
provides compensated arithmetic where a value is carried as an unevaluated
sum ``hi + lo`` of two f32 numbers (~48 significand bits, eps ~ 4e-15),
built from the classical error-free transforms:

* ``two_sum``   — Knuth 1969 (no magnitude precondition),
* ``fast_two_sum`` — Dekker 1971 (|a| >= |b|),
* ``two_prod``  — Dekker product via 12-bit splitting (no FMA needed).

The transforms need f32 add/mul exactly rounded, neither contracted into
FMAs nor reassociated; ``_ob`` and ``_harden`` below keep XLA from doing
either, and chip_smoke.py phase 2 checks them on the GPU.

On top sit a ``DF`` pytree (works under jit/vmap/scan), NumPy-style
helpers, a generic ``df_einsum`` for the small tensor contractions element
kernels are made of, and closed-form det/inv for the 2x2/3x3 geometry
Jacobians (mirroring utils/linalg.py).

Everything is dtype-generic but intended for f32 components; under the
f64-enabled CPU test config the same code yields double-double, and
tests pin df32 results against plain f64 as the oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import jax
import jax.numpy as jnp


def _splitter(dtype) -> float:
    # 2^ceil(p/2) + 1 with p = significand bits (Dekker splitting constant)
    nmant = jnp.finfo(dtype).nmant + 1         # 24 for f32, 53 for f64
    return float(2 ** ((nmant + 1) // 2) + 1)  # 4097 for f32


def _ob(x):
    """Optimization barrier against HLO-level algebraic simplification of
    EFT patterns like ``s - (s - a) -> a``.  NOTE: XLA strips these before
    backend codegen, so they do NOT stop FMA contraction — see _harden."""
    return jax.lax.optimization_barrier(x)


def _harden(x):
    """Block backend FMA contraction of a rounded product.

    XLA:CPU contracts ``add(mul(a, b), c) -> fma(a, b, c)`` at LLVM level
    (measured: jit(a*b+c) bit-matches fma, eager matches separate
    rounding; ``--xla_allow_excess_precision=false`` does not disable it,
    and optimization_barrier is removed before codegen).  Contraction
    substitutes the EXACT product where the EFTs require the ROUNDED one
    (e.g. ``s - p`` inside fast_two_sum), silently destroying the
    compensation (~1 ulp error, measured on the df NS kernel).  A select
    on a data-dependent predicate the compiler cannot prove (x == x is
    false only for NaN) breaks the mul/add adjacency for good.  Everywhere
    else contraction is benign: inside two_prod's error expression it only
    makes partial products exact, which helps."""
    return jnp.where(x == x, x, jnp.zeros_like(x))


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b)."""
    s = _ob(a + b)
    bb = _ob(s - a)
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """s + e == a + b exactly, REQUIRES |a| >= |b| (or a == 0)."""
    s = _ob(a + b)
    e = b - (s - a)
    return s, e


def split(a):
    """a == hi + lo with hi, lo having <= ceil(p/2) significand bits."""
    # _harden: c - a must see the ROUNDED c, not fms(a, splitter, -a)
    c = _harden(_ob(a * jnp.asarray(_splitter(a.dtype), a.dtype)))
    t = _ob(c - a)
    hi = c - t
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b) (Dekker, FMA-free)."""
    p = _harden(_ob(a * b))
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


class DF(NamedTuple):
    """Unevaluated sum hi + lo; a jax pytree (jit/vmap/scan-transparent)."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    # -- structure ---------------------------------------------------------
    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    def __getitem__(self, idx):
        return DF(self.hi[idx], self.lo[idx])

    def reshape(self, *shape):
        return DF(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def astype_f64(self):
        """hi + lo evaluated in f64 (CPU test oracle only)."""
        return self.hi.astype(jnp.float64) + self.lo.astype(jnp.float64)

    def value(self):
        """Best single-word approximation (== hi after renormalization)."""
        return self.hi + self.lo

    # -- arithmetic --------------------------------------------------------
    def __neg__(self):
        return DF(-self.hi, -self.lo)

    def __add__(self, other):
        return df_add(self, df_const(other, self))

    __radd__ = __add__

    def __sub__(self, other):
        return df_add(self, -df_const(other, self))

    def __rsub__(self, other):
        return df_add(df_const(other, self), -self)

    def __mul__(self, other):
        return df_mul(self, df_const(other, self))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return df_div(self, df_const(other, self))

    def __rtruediv__(self, other):
        return df_div(df_const(other, self), self)


DFLike = Union[DF, jnp.ndarray, float, int]


def df(x, dtype=jnp.float32) -> DF:
    """Lift an exactly-representable array/scalar into DF (lo = 0)."""
    if isinstance(x, DF):
        return x
    hi = jnp.asarray(x, dtype)
    return DF(hi, jnp.zeros_like(hi))


def df_const(x: DFLike, like: DF) -> DF:
    return x if isinstance(x, DF) else df(x, like.dtype)


def df_add(x: DF, y: DF) -> DF:
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return DF(*fast_two_sum(s, e))


def df_mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DF(*fast_two_sum(p, e))


def df_div(x: DF, y: DF) -> DF:
    q1 = x.hi / y.hi
    r = df_add(x, df_mul(y, DF(-q1, jnp.zeros_like(q1))))
    q2 = (r.hi + r.lo) / y.hi
    return DF(*fast_two_sum(q1, q2))


def df_sqrt(x: DF) -> DF:
    """sqrt for x >= 0 (0 maps to 0)."""
    s = jnp.sqrt(x.hi)
    safe = jnp.where(s > 0, s, jnp.ones_like(s))
    p, e = two_prod(safe, safe)
    r_hi, r_lo = two_sum(x.hi, -p)
    d = ((r_hi + (r_lo + x.lo)) - e) / (2.0 * safe)
    hi, lo = fast_two_sum(safe, d)
    zero = jnp.zeros_like(s)
    return DF(jnp.where(s > 0, hi, zero), jnp.where(s > 0, lo, zero))


def df_rsqrt(x: DF) -> DF:
    return df_div(df(1.0, x.dtype), df_sqrt(x))


def df_sum(x: DF, axis: int) -> DF:
    """Compensated reduction along one axis (sequential df adds; axis
    lengths in element kernels are tiny, <= nq)."""
    n = x.hi.shape[axis]
    acc = x[(slice(None),) * _posaxis(axis, x.hi.ndim) + (0,)]
    for i in range(1, n):
        acc = df_add(acc, x[(slice(None),) * _posaxis(axis, x.hi.ndim) + (i,)])
    return acc


def _posaxis(axis, ndim):
    return axis % ndim


def df_stack(parts: Sequence[DF], axis: int = 0) -> DF:
    return DF(jnp.stack([p.hi for p in parts], axis),
              jnp.stack([p.lo for p in parts], axis))


def df_concatenate(parts: Sequence[DF], axis: int = 0) -> DF:
    return DF(jnp.concatenate([p.hi for p in parts], axis),
              jnp.concatenate([p.lo for p in parts], axis))


def df_where(cond, x: DF, y: DF) -> DF:
    return DF(jnp.where(cond, x.hi, y.hi), jnp.where(cond, x.lo, y.lo))


def df_norm(x: DF) -> jnp.ndarray:
    """||hi + lo||_2 to f32 relative accuracy — the summands are positive
    (no cancellation), so a plain f32 pairwise sum of squares is accurate
    to ~1e-7 relative, plenty for tolerance checks at 1e-8 * n0."""
    v = x.hi + x.lo
    scale = jnp.maximum(jnp.max(jnp.abs(v)), jnp.finfo(v.dtype).tiny)
    r = v / scale
    return scale * jnp.sqrt(jnp.sum(r * r))


# ----------------------------------------------------------------------------
# Generic small-tensor einsum in DF
# ----------------------------------------------------------------------------


def _take_diagonal(x: DF, labels: str):
    """Collapse repeated labels within one operand (e.g. 'qii' -> 'qi')."""
    while True:
        seen = {}
        dup = None
        for ax, l in enumerate(labels):
            if l in seen:
                dup = (seen[l], ax, l)
                break
            seen[l] = ax
        if dup is None:
            return x, labels
        a1, a2, l = dup
        x = DF(jnp.diagonal(x.hi, axis1=a1, axis2=a2),
               jnp.diagonal(x.lo, axis1=a1, axis2=a2))
        # diagonal moves the collapsed axis to the end
        labels = "".join(c for i, c in enumerate(labels)
                         if i not in (a1, a2)) + l


def _align(x: DF, labels: str, all_labels: str) -> DF:
    """Transpose + reshape operand axes into the joint label order, with
    size-1 axes for missing labels."""
    order = sorted(range(len(labels)), key=lambda i: all_labels.index(labels[i]))
    hi = jnp.transpose(x.hi, order)
    lo = jnp.transpose(x.lo, order)
    sorted_labels = [labels[i] for i in order]
    shape = []
    k = 0
    for l in all_labels:
        if k < len(sorted_labels) and sorted_labels[k] == l:
            shape.append(hi.shape[k])
            k += 1
        else:
            shape.append(1)
    return DF(hi.reshape(shape), lo.reshape(shape))


def df_einsum(spec: str, *ops: DFLike) -> DF:
    """einsum with compensated products and sums.

    Intended for the tiny per-element contractions of FEM kernels (axis
    sizes <= nq); materializes the joint index space, so do not use on
    large tensors.  Operands may be DF or plain arrays (lifted exactly).
    """
    lhs, rhs = spec.replace(" ", "").split("->")
    op_labels = lhs.split(",")
    assert len(op_labels) == len(ops), spec
    dtype = None
    for o in ops:
        if isinstance(o, DF):
            dtype = o.dtype
            break
    if dtype is None:
        dtype = jnp.asarray(ops[0]).dtype
    dops = [df(o, dtype) if not isinstance(o, DF) else o for o in ops]

    cleaned = []
    for o, labels in zip(dops, op_labels):
        o, labels = _take_diagonal(o, labels)
        cleaned.append((o, labels))

    all_labels = ""
    for _, labels in cleaned:
        for l in labels:
            if l not in all_labels:
                all_labels += l
    # put output labels first so contracted axes are trailing
    all_labels = rhs + "".join(l for l in all_labels if l not in rhs)

    out = _align(*cleaned[0], all_labels)
    for o, labels in cleaned[1:]:
        out = df_mul(out, _align(o, labels, all_labels))
    # broadcast to the full joint shape before reducing
    for ax in range(len(all_labels) - 1, len(rhs) - 1, -1):
        if out.hi.shape[ax] == 1:
            out = DF(jnp.squeeze(out.hi, ax), jnp.squeeze(out.lo, ax))
        else:
            out = df_sum(out, ax)
    # any leading output axes that stayed size-1 by broadcasting are fine:
    # caller's operands define their sizes; nothing to do.
    return out


# ----------------------------------------------------------------------------
# Small-matrix geometry in DF (mirrors utils/linalg.py closed forms)
# ----------------------------------------------------------------------------


def df_det_small(A: DF) -> DF:
    n = A.hi.shape[-1]
    if n == 1:
        return A[..., 0, 0]
    if n == 2:
        return df_mul(A[..., 0, 0], A[..., 1, 1]) - \
            df_mul(A[..., 0, 1], A[..., 1, 0])
    if n == 3:
        def m(i, j):
            return A[..., i, j]

        def c(i0, i1, j0, j1):
            return df_mul(m(i0, j0), m(i1, j1)) - df_mul(m(i0, j1), m(i1, j0))

        return df_mul(m(0, 0), c(1, 2, 1, 2)) - \
            df_mul(m(0, 1), c(1, 2, 0, 2)) + \
            df_mul(m(0, 2), c(1, 2, 0, 1))
    raise ValueError(f"df_det_small supports n<=3, got {n}")


def df_inv_small(A: DF) -> DF:
    n = A.hi.shape[-1]
    d = df_det_small(A)
    if n == 2:
        rows = [
            df_stack([A[..., 1, 1], -A[..., 0, 1]], -1),
            df_stack([-A[..., 1, 0], A[..., 0, 0]], -1),
        ]
        adj = df_stack(rows, -2)
    elif n == 3:
        def cof(i0, i1, j0, j1):
            return df_mul(A[..., i0, j0], A[..., i1, j1]) - \
                df_mul(A[..., i0, j1], A[..., i1, j0])

        adj = df_stack([
            df_stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)], -1),
            df_stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)], -1),
            df_stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)], -1),
        ], -2)
    else:
        raise ValueError(f"df_inv_small supports n in (2, 3), got {n}")
    return df_div(adj, DF(d.hi[..., None, None], d.lo[..., None, None]))


def df_abs(x: DF) -> DF:
    return df_where(x.hi < 0, -x, x)
