"""Chebyshev-cosine EvalMod for CKKS bootstrapping.

Port of gemini_seal_tpu/models/evalmod.py.  The modular-reduction stage
turns slots holding y = t/(K+1) (t = v/q0, v the mod-raised coefficients)
into slots holding sin(2 pi t) ~ 2 pi m/q0:

    h_0 = P(y) ~ cos((2 pi (K+1) y - pi/2)/2^r)   Chebyshev, degree d
    h_{j+1} = 2 h_j^2 - 1                          r double-angle squarings

The host planning (:func:`fit_cos_cheby`, :func:`choose_r`,
:func:`plan_evalmod`) is the JAX package's numpy arithmetic, so the
coefficients are the same doubles.  :class:`ChebyEvalMod` builds the same
node graph (Paterson-Stockmeyer over the Chebyshev basis, every node with
its exact (level, scale), alignments by a plain multiply and one rescale)
and runs it eagerly on tensors: every ciphertext product is the port's
multiply + relinearize + rescale, every plain product, addition and rescale
one launch or a few of the ``elementwise``, ``ntt`` and ``contract``
kernels.  The JAX package jits one small program per level and primitive so
that the TPU compiler does not run out of memory; eager PyTorch needs no
such split.  ``imag=True`` evaluates on slots holding i*y in the twisted
basis V_k(z) = i^k T_k(-iz) at no extra level.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fit_cos_cheby", "choose_r", "plan_evalmod", "ChebyEvalMod"]


def fit_cos_cheby(K: int, r: int, tol: float = 1e-12, max_degree: int = 2046):
    """Chebyshev-basis coefficients (numpy convention, index = T-degree) of
    f(y) = cos((2 pi (K+1) y - pi/2) / 2^r) on y in [-1, 1], trimmed at
    relative `tol`, by Chebyshev-point interpolation."""
    from numpy.polynomial import chebyshev as C

    c_arg = 2.0 * math.pi * (K + 1) / (2.0 ** r)
    deg = int(c_arg + 24.0 * max(c_arg, 1.0) ** (1.0 / 3.0) + 32)

    def f(y):
        return np.cos((2.0 * math.pi * (K + 1) * y - math.pi / 2.0) / (2.0 ** r))

    while True:
        coeffs = C.chebinterpolate(f, deg)
        mx = np.abs(coeffs).max()
        keep = np.nonzero(np.abs(coeffs) > tol * mx)[0]
        if keep.size and keep[-1] < deg - 4:
            return coeffs[: keep[-1] + 1]
        if deg >= max_degree:
            raise ValueError(f"cos Chebyshev fit did not converge by degree {deg} "
                             f"(K={K}, r={r})")
        deg = min(2 * deg, max_degree)


def _plan_lt(d: int):
    """(l, t): baby size m = 2^l, t giant doubling levels, 2^(l+t) > d."""
    if d < 1:
        return 1, 0
    D0 = max(1, int(math.ceil(math.log2(d + 1))))
    l = max(1, D0 // 2)
    t = max(0, D0 - l)
    while (1 << (l + t)) <= d:
        t += 1
    return l, t


def choose_r(K: int, r: int = None, tol: float = 1e-12):
    """The double-angle count: the smallest total level cost (split depth
    + 1 + r), ties to the smaller r.  Returns (r, coeffs)."""
    if r is not None:
        return r, fit_cos_cheby(K, r, tol)
    best = None
    for rr in range(2, 13):
        coeffs = fit_cos_cheby(K, rr, tol)
        l, t = _plan_lt(len(coeffs) - 1)
        key = (l + t + 1 + rr, rr)
        if best is None or key < best[0]:
            best = (key, rr, coeffs)
    return best[1], best[2]


def plan_evalmod(K: int, r: int = None, tol: float = 1e-12):
    """(r, coeffs, depth): depth = levels consumed from the engine's input
    level to its output level."""
    r, coeffs = choose_r(K, r, tol)
    l, t = _plan_lt(len(coeffs) - 1)
    return r, coeffs, l + t + 1 + r


class _Node:
    """Build-time handle: a ciphertext-producing closure with its exact
    (level, scale).  run(env) -> int64[..., 2, L, N]; results are memoized
    per invocation in env['cache']."""

    __slots__ = ("lvl", "sigma", "_run")

    def __init__(self, lvl, sigma, run):
        self.lvl = lvl
        self.sigma = float(sigma)
        self._run = run

    def run(self, env):
        out = env["cache"].get(id(self))
        if out is None:
            out = self._run(env)
            env["cache"][id(self)] = out
        return out


class ChebyEvalMod:
    """Builds stage(u, relin_key) evaluating sin(2 pi (K+1) y) from a
    ciphertext whose slots hold y (imag=False) or i*y (imag=True), at level
    `base` (an index into `cds`) and scale `Dl`.  Exposes .stage,
    .sigma_z (the exact output scale), .depth (levels consumed), .r,
    .degree and .n_ct_mults, as the JAX class does.

    cds, q, limbs, L: the chain's context data from the top, the prime each
    level drops, each level's LimbConstants and limb count."""

    def __init__(self, context, cds, q, limbs, L, encoder, base: int, Dl: float, coeffs,
                 r: int, imag: bool, device=None):
        from ..ops.dyadic import add_poly, dyadic_product, sub_poly
        from ..ops.rnsops import divide_and_round_q_last_ntt
        from .pipelines import build_ckks_mul_relin_rescale

        self.device = context.check_device(device)
        self._ctx = context
        self._cds = cds
        self._q = q
        self._limbs = limbs
        self._L = L
        self._enc = encoder
        self._imag = bool(imag)
        self.r = int(r)
        self._add_poly = add_poly
        self._sub_poly = sub_poly
        self._dyadic = dyadic_product
        self._div_qlast = divide_and_round_q_last_ntt
        self._build_mul = build_ckks_mul_relin_rescale
        self._muls = {}
        self._sqs = {}
        self._basis = {}
        self.n_ct_mults = 0

        coeffs = np.asarray(coeffs, dtype=np.complex128)
        d = len(coeffs) - 1
        self.degree = d
        self._l, self._t = _plan_lt(d)
        self._m = 1 << self._l
        self._giants = [self._m << j for j in range(max(self._t, 1))]

        u_node = _Node(base, Dl, lambda env: env["u"])
        self._basis[1] = u_node
        out_lvl = base + self._l + self._t + 1
        poly_node = self._eval(coeffs, out_lvl, Dl)

        # r double-angle squarings: h <- 2 h^2 - 1
        node = poly_node
        for _ in range(self.r):
            sq = self._ct_square(node)
            dbl = self._ct_add(sq, sq)
            node = self._plain_add_const(dbl, -1.0)
        self._root = node
        self.depth = node.lvl - base
        self.sigma_z = node.sigma

        def stage(u, relin_key):
            env = {"u": u.contiguous(), "rk": relin_key, "cache": {}}
            return self._root.run(env)

        self.stage = stage

    # ---- primitives on tensors (each a few kernel launches) ---------------

    def _top(self, x, lvl):
        """x cut to the limbs of level lvl (the mod-switch drop)."""
        return x[..., : self._L[lvl], :].contiguous()

    def _mul_fn(self, lvl):
        fn = self._muls.get(lvl)
        if fn is None:
            raw = self._build_mul(self._ctx, self._cds[lvl].parms_id, device=self.device)
            fn = self._muls[lvl] = lambda a, b, rk: raw(self._top(a, lvl), self._top(b, lvl), rk)
        return fn

    def _sq_fn(self, lvl):
        fn = self._sqs.get(lvl)
        if fn is None:
            raw = self._build_mul(self._ctx, self._cds[lvl].parms_id, square=True,
                                  device=self.device)
            fn = self._sqs[lvl] = lambda a, rk: raw(self._top(a, lvl), rk)
        return fn

    def _addsub(self, lvl, sub, x, y):
        op = self._sub_poly if sub else self._add_poly
        return op(self._top(x, lvl), self._top(y, lvl), self._limbs[lvl])

    def _pmul(self, lvl, x, pt):
        # both components in one launch: the plaintext broadcasts over them
        return self._dyadic(self._top(x, lvl), pt, self._limbs[lvl])

    def _padd(self, lvl, x, pt):
        x = self._top(x, lvl)
        c0 = self._add_poly(x[..., 0, :, :].contiguous(), pt, self._limbs[lvl])
        return torch.cat([c0.unsqueeze(-3), x[..., 1:, :, :]], dim=-3)

    def _rescale_at(self, lvl, x):
        cd = self._cds[lvl]
        return self._div_qlast(self._top(x, lvl), cd.device_rns_tool, cd.ntt_tables)

    # ---- nodes ---------------------------------------------------------------

    def _ct_mul(self, a, b):
        lvl = max(a.lvl, b.lvl)
        fn = self._mul_fn(lvl)
        self.n_ct_mults += 1
        sigma = a.sigma * b.sigma / float(self._q[lvl])
        return _Node(lvl + 1, sigma, lambda env: fn(a.run(env), b.run(env), env["rk"]))

    def _ct_square(self, a):
        fn = self._sq_fn(a.lvl)
        self.n_ct_mults += 1
        sigma = a.sigma * a.sigma / float(self._q[a.lvl])
        return _Node(a.lvl + 1, sigma, lambda env: fn(a.run(env), env["rk"]))

    def _ct_add(self, a, b, sub=False):
        if a.lvl != b.lvl:
            raise AssertionError("level mismatch in ct add")
        if not math.isclose(a.sigma, b.sigma, rel_tol=1e-9):
            raise AssertionError(f"scale mismatch in ct add: {a.sigma} vs {b.sigma}")
        lvl = a.lvl
        return _Node(lvl, a.sigma,
                     lambda env: self._addsub(lvl, sub, a.run(env), b.run(env)))

    def _encode(self, value, sigma, lvl):
        """Encode a constant (float or complex) at an exact scale."""
        if isinstance(value, complex) and value.imag == 0.0:
            value = value.real
        return self._enc.encode(value, float(sigma), self._cds[lvl].parms_id).data

    def _plain_mul_node(self, node, pt, lvl, sigma_out):
        return _Node(lvl, sigma_out, lambda env: self._pmul(lvl, node.run(env), pt))

    def _plain_add_const(self, node, value):
        pt = self._encode(value, node.sigma, node.lvl)
        lvl = node.lvl
        return _Node(lvl, node.sigma, lambda env: self._padd(lvl, node.run(env), pt))

    def _rescale(self, node, lvl, sigma):
        """node at level lvl -> node at lvl+1, scale sigma/q[lvl]."""
        return _Node(lvl + 1, sigma / float(self._q[lvl]),
                     lambda env: self._rescale_at(lvl, node.run(env)))

    def _align(self, node, lvl, sigma):
        """Value-preserving move to exactly (lvl, sigma): plain-multiply by
        encode(1.0, sigma*q/sigma_have), then one rescale."""
        if node.lvl == lvl and math.isclose(node.sigma, sigma, rel_tol=1e-12):
            return node
        if node.lvl > lvl - 1:
            raise AssertionError("alignment needs one level of headroom")
        s_pt = sigma * float(self._q[lvl - 1]) / node.sigma
        pt = self._encode(1.0, s_pt, lvl - 1)
        pm = self._plain_mul_node(node, pt, lvl - 1, node.sigma * s_pt)
        out = self._rescale(pm, lvl - 1, pm.sigma)
        if not math.isclose(out.sigma, sigma, rel_tol=1e-9):
            raise AssertionError("alignment scale bookkeeping broke")
        return out

    # ---- Chebyshev basis -------------------------------------------------------

    def _kappa(self, k):
        """Doubling/echo constant: T-basis 1; V-basis (-1)^k."""
        return (-1.0) ** k if self._imag else 1.0

    def _V(self, k):
        """Basis ciphertext for T_k (imag=False) or V_k (imag=True), by
        balanced product recurrences."""
        node = self._basis.get(k)
        if node is not None:
            return node
        if k % 2 == 0:
            half = self._V(k // 2)
            sq = self._ct_square(half)
            dbl = self._ct_add(sq, sq)
            node = self._plain_add_const(dbl, -self._kappa(k // 2))
        else:
            a, b = (k + 1) // 2, k // 2
            prod = self._ct_mul(self._V(a), self._V(b))
            dbl = self._ct_add(prod, prod)
            echo = self._align(self._V(a - b), dbl.lvl, dbl.sigma)
            kap = self._kappa(b)
            node = self._ct_add(dbl, echo, sub=(kap > 0))
        self._basis[k] = node
        return node

    # ---- Paterson-Stockmeyer recursion -----------------------------------------

    def _leaf(self, coeffs, lvl, sigma):
        """sum_k coeffs[k] T_k(y) from basis elements; each plaintext's
        encode scale compensates its basis element's scale."""
        terms = None
        for k in range(1, len(coeffs)):
            c = complex(coeffs[k])
            if c == 0.0:
                continue
            if self._imag:
                c *= (-1j) ** (k % 4)          # i^{-k}
            vk = self._V(k)
            if vk.lvl > lvl - 1:
                raise AssertionError("basis element deeper than leaf level")
            s_pt = sigma * float(self._q[lvl - 1]) / vk.sigma
            pt = self._encode(c, s_pt, lvl - 1)
            node = self._plain_mul_node(vk, pt, lvl - 1, vk.sigma * s_pt)
            terms = node if terms is None else self._ct_add(terms, node)
        if terms is None:
            raise AssertionError("leaf with no linear terms — degree-0 "
                                 "polynomials should be folded upstream")
        out = self._rescale(terms, lvl - 1, terms.sigma)
        c0 = complex(coeffs[0])
        if c0 != 0.0:
            out = self._plain_add_const(out, c0)
        if not math.isclose(out.sigma, sigma, rel_tol=1e-9):
            raise AssertionError("leaf scale bookkeeping broke")
        return out

    def _eval(self, coeffs, lvl, sigma):
        """Node computing sum_k coeffs[k] T_k(y) at exactly (lvl, sigma)."""
        coeffs = np.asarray(coeffs, dtype=np.complex128)
        nz = np.nonzero(np.abs(coeffs) > 0)[0]
        if nz.size == 0 or nz[-1] == 0:
            raise AssertionError("degree-0 evaluation should be folded upstream")
        d = int(nz[-1])
        coeffs = coeffs[: d + 1]
        fits = [g for g in self._giants if g <= d]
        if d < self._m or not fits:
            return self._leaf(coeffs, lvl, sigma)
        from numpy.polynomial import chebyshev as C

        g = max(fits)
        tg = np.zeros(g + 1)
        tg[g] = 1.0
        qv, rv = C.chebdiv(coeffs, tg)
        # divide by 2*T_g: keeps every recursive coefficient vector O(1);
        # the factor 2 returns as one ciphertext addition of the product
        qv = qv * 0.5
        vg = self._V(g)
        if self._imag:
            qv = qv * ((-1j) ** (g % 4))       # i^{-g} phase fold
        sigma_q = sigma * float(self._q[lvl - 1]) / vg.sigma
        qnz = np.nonzero(np.abs(qv) > 0)[0]
        if qnz.size == 0 or qnz[-1] == 0:
            # degree-0 quotient (d == g): one plaintext multiply
            c = 2.0 * complex(qv[0]) if qnz.size else 0.0
            pt = self._encode(c, sigma_q, lvl - 1)
            pm = self._plain_mul_node(vg, pt, lvl - 1, vg.sigma * sigma_q)
            M = self._rescale(pm, lvl - 1, pm.sigma)
        else:
            Q = self._eval(qv, lvl - 1, sigma_q)
            fn = self._mul_fn(lvl - 1)
            self.n_ct_mults += 1
            Mh = _Node(lvl, sigma_q * vg.sigma / float(self._q[lvl - 1]),
                       lambda env: fn(Q.run(env), vg.run(env), env["rk"]))
            M = self._ct_add(Mh, Mh)           # the folded factor 2
        rv = np.asarray(rv, dtype=np.complex128)
        if np.abs(rv).max() == 0.0:
            return M
        if np.nonzero(np.abs(rv) > 0)[0][-1] == 0:
            return self._plain_add_const(M, complex(rv[0]))
        R = self._eval(rv, lvl, sigma)
        return self._ct_add(M, R)
