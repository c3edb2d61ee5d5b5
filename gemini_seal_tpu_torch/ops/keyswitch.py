"""Hybrid multi-special-prime key switching, fused and sequential CKKS forms.

Port of gemini_seal_tpu/ops/keyswitch.py (the fork's
multi_special_primes.cpp and Evaluator::switch_key_inplace):

- :class:`KeySwitchPlan`: host constants of one (ciphertext level, key
  level) pair, copied from the JAX package and placed on the context's
  device;
- :func:`compute_modup_digits`: bundle-wise mod-up, one ``contract``
  launch (the punctured-inverse multiply folded in as its pre-scale)
  between inverse and forward ``ntt`` launches;
- :func:`keyswitch_inner_product`: the 128-bit-exact inner product with
  the key, one ``contract`` launch per key component, raw or followed by
  :func:`rescale_special` (the mod-down by P: ``ntt``, ``contract`` with
  the inv_hat multiply as its pre-scale, ``ntt``, one ``elementwise``);
- :func:`switch_key`: the two composed;
- :class:`NTTOps`: the transforms these take (``ntt=``), in-core by
  default (:data:`IN_CORE_NTT`), the coefficient-sharded four-step bodies
  in parallel/pipeline_csp.py;
- :func:`batched_rotated_inner_product`: the hoisted rotations' inner
  product, one ``galois`` launch that permutes the shared digits for all R
  rotations straight into [..., R, nb, n_ext, N], then one ``contract``
  launch per key component (:func:`keys_stack_inner_product`, which the
  counter-rotated keys' shared digits use as they are);
- :func:`fused_moddown`: one rounded division of (P*c + acc) by
  P*q_last, two ``elementwise`` epilogues around ``ntt`` and ``contract``.

Indexing and layout (``index_select``, ``index_copy_`` onto the bundle
diagonal, ``cat``, ``contiguous``) stay plain torch: none of it is modular
arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..modulus import Modulus
from ..tracing import span
from ..utils import numth
from .backend import to_tensor
from .dyadic import LimbConstants
from .galois import galois_permute
from .modops import contract_mulmod_128, rns_elementwise
from .ntt import (build_ntt_tables, ntt_forward, ntt_forward_lazy, ntt_inverse,
                  ntt_inverse_lazy)
from .rnsops import _dot_mod_128, _slice_tables, crt_drop_constants

__all__ = ["KeySwitchPlan", "switch_key", "compute_modup_digits",
           "keyswitch_inner_product", "rescale_special",
           "batched_rotated_inner_product", "keys_stack_inner_product", "fused_moddown",
           "NTTOps", "IN_CORE_NTT"]


class NTTOps:
    """Pluggable NTT strategy (the JAX package's keyswitch.NTTOps): the
    key-switch dataflow is the same in-core and under coefficient sharding;
    only the four transform entry points differ (parallel/pipeline_csp.py
    passes the four-step bodies).  This default calls this module's
    in-core transforms, looked up when called."""

    def forward(self, x, tables):
        return ntt_forward(x, tables)

    def forward_lazy(self, x, tables):
        return ntt_forward_lazy(x, tables)

    def inverse(self, x, tables):
        return ntt_inverse(x, tables)

    def inverse_lazy(self, x, tables):
        return ntt_inverse_lazy(x, tables)


IN_CORE_NTT = NTTOps()


class KeySwitchPlan:
    """Per-(ciphertext level, key level) constants for hybrid key switching
    (multi_special_primes.cpp:109-141, 186-234, 244-248, 291-299), exact
    ints on the host, stored as tensors on the context's device."""

    def __init__(self, context, parms_id):
        dev = context.device
        cd = context.get_context_data(parms_id)
        key_cd = context.key_context_data()
        first_cd = context.first_context_data()
        key_modulus = [m.value for m in key_cd.parms.coeff_modulus]
        log_n = key_cd.parms.poly_modulus_degree.bit_length() - 1

        self.device = dev
        self.n_ct_rns = len(cd.parms.coeff_modulus)
        self.n_ct_all_rns = len(first_cd.parms.coeff_modulus)
        self.n_total_rns = len(key_modulus)
        self.n_sp_rns = self.n_total_rns - self.n_ct_all_rns
        self.n_bundles = (self.n_ct_rns + self.n_sp_rns - 1) // self.n_sp_rns
        n_ct, n_sp = self.n_ct_rns, self.n_sp_rns

        # Extended limb set: normal limbs at this level + the special limbs.
        ext_idx = np.array(
            list(range(n_ct))
            + list(range(self.n_ct_all_rns, self.n_ct_all_rns + n_sp)),
            dtype=np.int64,
        )
        self.ext_key_indices = torch.from_numpy(ext_idx).to(dev)
        ext_moduli = [key_modulus[i] for i in ext_idx]
        self.ext_moduli = ext_moduli
        self.n_ext = len(ext_moduli)
        self.ext_limbs = LimbConstants.from_moduli(ext_moduli, dev)
        self.ct_limbs = LimbConstants.from_moduli(ext_moduli[:n_ct], dev)
        self.ext_tables = build_ntt_tables(log_n, ext_moduli).to(dev)
        self.ct_tables = _slice_tables(self.ext_tables, 0, n_ct)

        # Bundle mod-up data (modup_to_single_rns, :109-141): for bundle b
        # with limb set S, matrix[dst, i] = (Q_S / q_i) mod p_dst and
        # inv[i] = (Q_S / q_i)^{-1} mod q_i.  Diagonal rows (dst in S) are
        # unused: the mod-up overwrites them with the NTT-form target's rows
        # (diag_rows).  The last bundle may be short
        # (n_ct % n_sp != 0): its padding slots have inv = 0, so they
        # contribute nothing, with clamped gather indices.
        bundles = []
        for b in range(self.n_bundles):
            rns0 = b * n_sp
            rns1 = min(rns0 + n_sp, n_ct)
            S = list(range(rns0, rns1))
            inv = np.zeros(len(S), dtype=np.uint64)
            mat = np.zeros((self.n_ext, len(S)), dtype=np.uint64)
            for a, i in enumerate(S):
                qi = ext_moduli[i]
                punc = 1
                for j in S:
                    if j != i:
                        punc *= ext_moduli[j]
                inv_a = numth.try_invert_uint_mod(punc % qi, qi)
                if inv_a is None:
                    raise ValueError("key-switch modup: punctured product not invertible")
                inv[a] = inv_a
                for dst in range(self.n_ext):
                    mat[dst, a] = punc % ext_moduli[dst]
            bundles.append((rns0, rns1, inv, mat))

        s_max = max(r1 - r0 for r0, r1, _, _ in bundles)
        sel = np.zeros((self.n_bundles, s_max), dtype=np.int64)
        binv = np.zeros((self.n_bundles, s_max), dtype=np.uint64)
        bmat = np.zeros((self.n_bundles, self.n_ext, s_max), dtype=np.uint64)
        diag = np.zeros((self.n_bundles, self.n_ext, 1), dtype=bool)
        for b, (rns0, rns1, inv, mat) in enumerate(bundles):
            s = rns1 - rns0
            sel[b, :s] = np.arange(rns0, rns1)
            binv[b, :s] = inv
            bmat[b, :, :s] = mat
            diag[b, rns0:rns1, 0] = True
        self.bundle_shape = (self.n_bundles, s_max)
        self.bundle_sel = torch.from_numpy(sel.ravel().copy()).to(dev)
        # every bundle full: the selection is the ct limbs in order
        self.bundle_sel_identity = self.n_bundles * s_max == n_ct
        self.bundle_diag = torch.from_numpy(diag).to(dev)
        # the diagonal rows (b, i), i in S_b, of the flattened [nb * n_ext]
        # digit rows; the bundles partition the ct limbs in order, so they
        # take the target's rows 0 .. n_ct - 1
        self.diag_rows = torch.from_numpy(np.concatenate(
            [b * self.n_ext + np.arange(r0, r1) for b, (r0, r1, _, _) in enumerate(bundles)]
        ).astype(np.int64)).to(dev)
        # contraction weights [G=nb, K=s_max, J=n_ext, 1] and the pre-scale
        # (per-(bundle, slot) inverse and modulus constants) [nb, s_max]
        self.bundle_w = to_tensor(bmat.transpose(0, 2, 1)[..., None], dev)
        slot_mod = [Modulus(ext_moduli[i]) for i in sel.ravel()]
        self.bundle_prescale = (
            to_tensor(binv, dev),
            to_tensor(np.array([m.value for m in slot_mod], dtype=np.uint64)
                      .reshape(sel.shape), dev),
            to_tensor(np.array([m.const_ratio[0] for m in slot_mod], dtype=np.uint64)
                      .reshape(sel.shape), dev),
            to_tensor(np.array([m.const_ratio[1] for m in slot_mod], dtype=np.uint64)
                      .reshape(sel.shape), dev),
        )

        # Special-prime rescale constants (:186-234, 291-299): inv_hat[j] =
        # (P / p_j)^-1 mod p_j, neg_hat[i, j] = -(P / p_j) mod q_i and
        # inv_P[i] = P^-1 mod q_i.
        sp_moduli = [key_modulus[self.n_ct_all_rns + j] for j in range(n_sp)]
        inv_hat = np.zeros(n_sp, dtype=np.uint64)
        for j in range(n_sp):
            prod = 1
            for k in range(n_sp):
                if k != j:
                    prod = (prod * sp_moduli[k]) % sp_moduli[j]
            r = numth.try_invert_uint_mod(prod, sp_moduli[j])
            if r is None:
                raise ValueError("key-switch rescale: inverse failed")
            inv_hat[j] = r
        neg_hat = np.zeros((n_ct, n_sp), dtype=np.uint64)
        inv_p = np.zeros(n_ct, dtype=np.uint64)
        for i in range(n_ct):
            qi = ext_moduli[i]
            for j in range(n_sp):
                prod = 1
                for k in range(n_sp):
                    if k != j:
                        prod = (prod * sp_moduli[k]) % qi
                neg_hat[i, j] = (-prod) % qi
            p_qi = 1
            for j in range(n_sp):
                p_qi = (p_qi * sp_moduli[j]) % qi
            r = numth.try_invert_uint_mod(p_qi, qi)
            if r is None:
                raise ValueError("key-switch rescale: P not invertible")
            inv_p[i] = r
        self.inv_hat_pj_pj = to_tensor(inv_hat, dev)          # [n_sp]
        self.neg_hat_pj_qi = to_tensor(neg_hat, dev)          # [n_ct, n_sp]
        self.inv_P_qi = to_tensor(inv_p.reshape(-1, 1), dev)  # [n_ct, 1]
        self.sp_limbs = LimbConstants.from_moduli(sp_moduli, dev)
        self.sp_tables = _slice_tables(self.ext_tables, n_ct, self.n_ext)

        # Lazy-digit safety margin (exact-int check at plan build): the inner
        # product accumulates n_bundles terms of ct_k * key per output limb,
        # and n_bundles * 4p * p must stay below 2^128 for the 128-bit sum
        # to be exact with lazy [0, 4p) digits.
        self.lazy_digits = self._lazy_digits_safe(self.n_bundles, max(ext_moduli))
        self._sp_moduli = sp_moduli
        self._fused = None
        self._context_data = cd

    @property
    def device_rns_tool(self):
        """The level's DeviceRNSTool (its rescale-by-q_last constants)."""
        return self._context_data.device_rns_tool

    @staticmethod
    def _lazy_digits_safe(n_bundles: int, max_p: int) -> bool:
        return n_bundles * 4 * max_p * max_p < (1 << 128)

    def fused_drop_constants(self):
        """Constants for the fused mod-down by Q_D = P * q_last (dropping the
        special primes AND the level's last ciphertext prime in one
        interpolation pass).  D's limb rows are contiguous in the extended
        layout: [n_ct-1 (q_last), n_ct .. n_ext-1 (specials)]."""
        if self._fused is not None:
            return self._fused
        n_ct = self.n_ct_rns
        if n_ct < 2:
            raise ValueError("fused rescale needs at least two ct primes")
        dev = self.device
        d_moduli = [self.ext_moduli[n_ct - 1]] + list(self._sp_moduli)
        out_moduli = self.ext_moduli[: n_ct - 1]
        _, inv_hat, hat_qi, inv_qd = crt_drop_constants(d_moduli, out_moduli)
        neg_hat = np.zeros_like(hat_qi)
        for i, qi in enumerate(out_moduli):
            for j in range(len(d_moduli)):
                neg_hat[i, j] = (qi - hat_qi[i, j]) % qi
        P = 1
        for p in self._sp_moduli:
            P *= p
        p_mod = np.array([P % self.ext_moduli[i] for i in range(n_ct)],
                         dtype=np.uint64)
        d_limbs = LimbConstants.from_moduli(d_moduli, dev)
        self._fused = {
            "d_limbs": d_limbs,
            "d_tables": _slice_tables(self.ext_tables, n_ct - 1, self.n_ext),
            "out_limbs": LimbConstants.from_moduli(out_moduli, dev),
            "out_tables": _slice_tables(self.ext_tables, 0, n_ct - 1),
            "inv_hat_d": to_tensor(inv_hat, dev),
            "neg_hat_d_qi": to_tensor(neg_hat, dev),
            "inv_qd_qi": to_tensor(inv_qd.reshape(-1, 1), dev),
            "p_mod_qi": to_tensor(p_mod.reshape(-1, 1), dev),
        }
        return self._fused


@span("keyswitch.modup")
def compute_modup_digits(target, plan: KeySwitchPlan, is_ntt_form: bool,
                         ntt: NTTOps = IN_CORE_NTT):
    """Bundle-batched mod-up digit decomposition: [..., n_ct, N] target ->
    [..., n_bundles, n_ext, N] NTT-domain digit polynomials (ct_k).

    Inverse-NTT (lazy), take each bundle's limbs (a view when every bundle
    is full, else one gather), pre-multiply by the punctured inverses and
    CRT-contract onto all n_ext limbs in one ``contract`` launch,
    forward-NTT (lazy when plan.lazy_digits), and copy the NTT-form target
    onto the bundle-diagonal rows of that transform's output in place.
    """
    N = target.shape[-1]
    batch = target.shape[:-2]
    target = target.contiguous()

    power_target = ntt.inverse_lazy(target, plan.ct_tables) if is_ntt_form else target
    if is_ntt_form:
        ntt_target = target
    elif plan.lazy_digits:
        ntt_target = ntt.forward_lazy(target, plan.ct_tables)
    else:
        ntt_target = ntt.forward(target, plan.ct_tables)

    nb, s_max = plan.bundle_shape
    x_sel = power_target if plan.bundle_sel_identity else \
        power_target.index_select(-2, plan.bundle_sel)
    x_sel = x_sel.reshape(batch + (nb, s_max, 1, N))
    ext = plan.ext_limbs
    lifted = contract_mulmod_128(
        x_sel, plan.bundle_w, ext.p.reshape(-1), ext.ratio0.reshape(-1),
        ext.ratio1.reshape(-1), prescale=plan.bundle_prescale,
    )  # [..., nb, n_ext, N]
    if plan.lazy_digits:
        out = ntt.forward_lazy(lifted, plan.ext_tables)
    else:
        out = ntt.forward(lifted, plan.ext_tables)
    out = out.contiguous()
    out.view(batch + (nb * plan.n_ext, N)).index_copy_(-2, plan.diag_rows, ntt_target)
    return out


@span("keyswitch.moddown")
def rescale_special(ext_poly_ntt, plan: KeySwitchPlan, is_ntt_output: bool,
                    ntt: NTTOps = IN_CORE_NTT):
    """Mod-down by P = prod(special primes) (multi_special_primes.cpp:237-304).

    ext_poly_ntt: [..., n_ext, N] with every limb in the NTT domain (the
    inner product's output).  Returns [..., n_ct, N], in the NTT domain if
    is_ntt_output (CKKS), else in the power basis (BFV).

    temp_i = sum_j (c_pj * (P/p_j)^-1 mod p_j) * (-(P/p_j) mod q_i) is one
    ``contract`` launch with the inv_hat multiply as its pre-scale; the
    special limbs enter it lazy in [0, 2p), as in the JAX function, whose
    only consumer of them is the same full-range Barrett multiply.  The
    closing (c_qi + temp_i) * P^-1 mod q_i is one ``elementwise`` launch.
    """
    n_ct = plan.n_ct_rns
    sp_power = ntt.inverse_lazy(ext_poly_ntt[..., n_ct:, :].contiguous(), plan.sp_tables)
    sl = plan.sp_limbs
    temp = _dot_mod_128(sp_power, plan.neg_hat_pj_qi, plan.ct_limbs,
                        prescale=(plan.inv_hat_pj_pj, sl.p.reshape(-1),
                                  sl.ratio0.reshape(-1), sl.ratio1.reshape(-1)))
    normal = ext_poly_ntt[..., :n_ct, :].contiguous()
    if is_ntt_output:
        temp = ntt.forward(temp, plan.ct_tables)
    else:
        normal = ntt.inverse(normal, plan.ct_tables)
    q = plan.ct_limbs
    return rns_elementwise("addmul", normal, q.p, q.ratio0, q.ratio1, b=temp,
                           s=plan.inv_P_qi)


def keyswitch_inner_product(ct_k, key_vector_data, plan: KeySwitchPlan,
                            is_ntt_output: bool, raw: bool = False,
                            ntt: NTTOps = IN_CORE_NTT):
    """128-bit-exact inner product of mod-up digits with a key-switch key,
    then the special-prime rescale (evaluator.cpp:2313-2361).

    Both key components are the two weight sets of one ``contract`` launch
    in its broadcast mode: the digits are read once for both.  The
    contraction is span ``keyswitch.inner_product``, each mod-down
    ``keyswitch.moddown``.

    ct_k: [..., n_bundles, n_ext, N] NTT-domain digits;
    key_vector_data: [n_bundles, 2, L_key, N].
    Returns (delta0, delta1): [..., n_ct, N] (rescale_special of each
    accumulator), or with raw=True the accumulators: [..., n_ext, N], two
    views of one [..., 2, n_ext, N] tensor.
    """
    acc = _key_contraction(ct_k, key_vector_data, plan)     # [..., 2, n_ext, N]
    out = [acc[..., l, :, :] for l in range(2)]
    if not raw:
        out = [rescale_special(x, plan, is_ntt_output, ntt=ntt) for x in out]
    return out[0], out[1]


@span("keyswitch.inner_product")
def _key_contraction(ct_k, key_vector_data, plan: KeySwitchPlan):
    """keyswitch_inner_product's contraction: [..., 2, n_ext, N]."""
    nb, n_ext, N = ct_k.shape[-3:]
    if key_vector_data.shape[0] < nb:
        raise RuntimeError(f"the key has {key_vector_data.shape[0]} bundles, the digits {nb}")
    ext = plan.ext_limbs
    # a key made for the first level has a bundle for each of its limbs; a
    # lower level uses the first nb of them.  One index_select gives both
    # components' rows as weights [2, nb, n_ext, N].
    key_ext = key_vector_data[:nb].transpose(0, 1).index_select(-2, plan.ext_key_indices)
    a = ct_k.contiguous().reshape(ct_k.shape[:-3] + (1, nb, n_ext, N))
    return contract_mulmod_128(a, key_ext, ext.p.reshape(-1), ext.ratio0.reshape(-1),
                               ext.ratio1.reshape(-1))


@span("keyswitch.inner_product")
def batched_rotated_inner_product(ct_k, rot_tabs, keys_stack, plan: KeySwitchPlan):
    """Hoisted multi-rotation key-switch contraction: one ``galois`` launch
    applies every rotation's NTT permutation to the shared mod-up digits,
    writing [..., R, nb, n_ext, N] directly, then the 128-bit inner product
    with each rotation's key runs as one ``contract`` launch per key
    component with the rotation axis as its group axis.  R is not folded
    into the accumulation: the lazy_digits margin is sized for n_bundles
    terms.

    ct_k: [..., nb, n_ext, N] NTT-domain digits (one hoisted mod-up);
    rot_tabs: int64[R, N] stacked Galois NTT permutation tables
    (GaloisTool.ntt_tables); keys_stack: int64[R, nb, 2, L_key, N].
    Returns (a0, a1): int64[..., R, n_ext, N] reduced accumulators (before
    the special-prime rescale).
    """
    nb, n_ext, N = ct_k.shape[-3:]
    lead = ct_k.shape[:-3]
    R = rot_tabs.shape[0]
    rk = galois_permute(ct_k.contiguous().reshape(lead + (nb * n_ext, N)), rot_tabs)
    return keys_stack_inner_product(rk.reshape(lead + (R, nb, n_ext, N)), keys_stack, plan)


@span("keyswitch.inner_product")
def keys_stack_inner_product(digits, keys_stack, plan: KeySwitchPlan):
    """The 128-bit inner product of digits with R stacked keys, one
    ``contract`` launch per key component with the rotation axis as its
    group axis.

    digits: [..., R, nb, n_ext, N] (one set per key), or [..., 1, nb,
    n_ext, N] (one set read in place for every key: the contraction's
    broadcast mode); keys_stack: int64[R, nb', 2, L_key, N] with nb' >= nb.
    Returns (a0, a1): int64[..., R, n_ext, N] reduced accumulators.
    """
    nb = digits.shape[-3]
    keys_ext = keys_stack[:, :nb].index_select(-2, plan.ext_key_indices)  # [R, nb, 2, n_ext, N]
    ext = plan.ext_limbs
    out = []
    for l in range(2):
        w = keys_ext[:, :, l].contiguous()
        out.append(contract_mulmod_128(digits, w, ext.p.reshape(-1), ext.ratio0.reshape(-1),
                                       ext.ratio1.reshape(-1)))
    return out[0], out[1]


@span("keyswitch.moddown")
def fused_moddown(c, acc, plan: KeySwitchPlan):
    """One-pass mod-down of (P*c + acc) by Q_D = P * q_last, landing at the
    next level in NTT form (no reference analogue; decrypts equal to the
    sequential rescale_special + divide_and_round_q_last_ntt, but not
    bit-identical to it).

    c: [..., n_ct, N] NTT-form ciphertext component at the current level;
    acc: [..., n_ext, N] NTT-form raw inner-product accumulator.
    Returns [..., n_ct-1, N].
    """
    k = plan.fused_drop_constants()
    n_ct = plan.n_ct_rns
    q = plan.ct_limbs

    # P*c + acc on the ct limbs: one elementwise launch
    num_ct = rns_elementwise("muladd", c.contiguous(), q.p, q.ratio0, q.ratio1,
                             b=acc[..., :n_ct, :].contiguous(), s=k["p_mod_qi"])
    num = torch.cat([num_ct, acc[..., n_ct:, :]], dim=-2)

    # D rows are contiguous: [q_last, specials]; [0, 2p) lazy into the
    # full-range Barrett of the contraction's pre-scale
    d_power = ntt_inverse_lazy(num[..., n_ct - 1 :, :].contiguous(), k["d_tables"])
    dl = k["d_limbs"]
    temp = _dot_mod_128(d_power, k["neg_hat_d_qi"], k["out_limbs"],
                        prescale=(k["inv_hat_d"], dl.p.reshape(-1),
                                  dl.ratio0.reshape(-1), dl.ratio1.reshape(-1)))
    temp = ntt_forward(temp, k["out_tables"])

    ol = k["out_limbs"]
    return rns_elementwise("addmul", num[..., : n_ct - 1, :].contiguous(), ol.p,
                           ol.ratio0, ol.ratio1, b=temp, s=k["inv_qd_qi"])


def switch_key(target, key_vector_data, plan: KeySwitchPlan, is_ntt_form: bool,
               ntt: NTTOps = IN_CORE_NTT):
    """Core hybrid key switch (evaluator.cpp:2259-2368).

    target: [..., n_ct, N] in the ciphertext domain (NTT iff is_ntt_form);
    leading batch axes broadcast.
    key_vector_data: [n_bundles, 2, L_key, N] stacked key ciphertexts
    (NTT form at the key level).
    Returns (delta0, delta1): [..., n_ct, N] contributions in the
    ciphertext domain, to be added onto c0/c1.
    """
    ct_k = compute_modup_digits(target, plan, is_ntt_form, ntt=ntt)
    return keyswitch_inner_product(ct_k, key_vector_data, plan, is_ntt_form, ntt=ntt)
