"""Evaluator: the SEAL-style per-op API (reference: evaluator.{h,cpp}).

Port of gemini_seal_tpu/evaluator.py, every method, bit for bit: the
linear and plaintext ops, multiply and square (BFV by BEHZ, CKKS in the
NTT domain, any sizes), relinearize down from any size, the Galois ops
with the NAF fallback and the hoisted multi-rotation, the modulus switch
and rescale, the NTT transforms, and multiply_many / exponentiate through
the shared :func:`product_tree`.  Ciphertext data stays on the context's
device between ops; each modular-arithmetic stage is one launch of a
hand-written kernel: ``elementwise`` (the ring ops, the BFV x t and the
BEHZ tails), ``negacyclic`` (the monomial fast path of multiply_plain),
``tensor_product`` (the size-2 products), ``ntt``, ``contract``, ``behz``,
``galois`` and ``scale_round`` (the BFV plaintext scaling).  The plaintext
lifts that the JAX package computes with Python ints on the host (the CRT
decomposition, the plain upper-half lift) run on the host here too, and
their result is uploaded.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from .ciphertext import Ciphertext, Plaintext
from .context import ContextData, SealContext
from .keys import GaloisKeys, RelinKeys
from .models.pipelines import _tensor_product
from .ops.backend import to_numpy, to_tensor
from .ops.dyadic import (add_poly, dyadic_product, multiply_poly_scalar,
                         negacyclic_mono_mul_poly, negate_poly, sub_poly)
from .ops.keyswitch import (KeySwitchPlan, compute_modup_digits, keyswitch_inner_product,
                            switch_key)
from .ops.ntt import ntt_forward, ntt_forward_lazy, ntt_inverse
from .ops.rnsops import (MultiDropPlan, divide_and_round_multi, divide_and_round_q_last,
                         divide_and_round_q_last_ntt, fast_floor, fastbconv_m_tilde,
                         fastbconv_sk, multiply_add_plain_with_scaling_variant,
                         multiply_sub_plain_with_scaling_variant, sm_mrq)
from .params import SchemeType
from .utils.numth import naf

__all__ = ["Evaluator", "product_tree"]


def _same_scale(a: float, b: float) -> bool:
    """SEAL requires exactly equal scales (evaluator.h are_same_scale)."""
    return abs(a - b) < 1e-9 * max(abs(a), abs(b), 1.0)


def product_tree(layer, multiply, square, relinearize):
    """Balanced product tree (reference: evaluator.h multiply_many).

    The pairing and odd-carry order of the JAX package: the Evaluator and the
    DeviceEvaluator both use it, so their multiply_many/exponentiate results
    are bit-identical.  Identical-operand pairs take the square path
    (bit-identical to multiply)."""
    layer = list(layer)
    if not layer:
        raise ValueError("encrypteds cannot be empty")
    while len(layer) > 1:
        nxt = []
        for i in range(0, len(layer) - 1, 2):
            if layer[i] is layer[i + 1]:
                prod = square(layer[i])
            else:
                prod = multiply(layer[i], layer[i + 1])
            nxt.append(relinearize(prod))
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


def _with_c0(data: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """data with its component 0 replaced by c0."""
    return torch.cat([c0.unsqueeze(0), data[1:]])


class Evaluator:
    def __init__(self, context: SealContext, device=None):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        self.device = context.check_device(device)
        self.context = context
        self._ks_plans: Dict[tuple, KeySwitchPlan] = {}
        self._md_plans: Dict[tuple, MultiDropPlan] = {}
        self._t_cols: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _cd(self, ct: Ciphertext) -> ContextData:
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("ciphertext is not valid for encryption parameters")
        return cd

    def _scheme(self) -> SchemeType:
        return self.context.key_context_data().parms.scheme

    def _check_same(self, a: Ciphertext, b: Ciphertext):
        if a.parms_id != b.parms_id:
            raise ValueError("encrypted parameters mismatch")
        if a.is_ntt_form != b.is_ntt_form:
            raise ValueError("NTT form mismatch")
        if not _same_scale(a.scale, b.scale):
            raise ValueError("scale mismatch")

    def _check_scale_bounds(self, scale: float, cd: ContextData):
        if scale <= 0 or int(math.log2(scale)) >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")

    def _ks_plan(self, parms_id) -> KeySwitchPlan:
        key = tuple(parms_id)
        plan = self._ks_plans.get(key)
        if plan is None:
            plan = self._ks_plans[key] = KeySwitchPlan(self.context, parms_id)
        return plan

    def _plain_to_full(self, plain: Plaintext, n: int) -> np.ndarray:
        """A BFV plaintext's coefficients zero-padded to N, on the host."""
        m = np.zeros(n, dtype=np.uint64)
        pdata = to_numpy(plain.data)
        m[: pdata.shape[0]] = pdata
        return m

    def _plain_rns(self, m: np.ndarray, cd: ContextData) -> torch.Tensor:
        """The plain upper-half lift of m < t to the level's RNS base
        (evaluator.cpp:1552-1600), on the host, uploaded: coefficients >=
        (t+1)/2 become m + q - t (per limb under the fast lift, by CRT
        decomposition otherwise)."""
        parms = cd.parms
        n, L = parms.poly_modulus_degree, len(parms.coeff_modulus)
        thresh = cd.plain_upper_half_threshold
        if not cd.qualifiers.using_fast_plain_lift:
            qmt = cd.total_coeff_modulus - parms.plain_modulus.value
            temp = cd.rns_base.decompose_array([int(v) + qmt if int(v) >= thresh else int(v)
                                                for v in m])
        else:
            inc = cd.plain_upper_half_increment.reshape(-1, 1)
            temp = np.where(m >= thresh, m + inc, np.broadcast_to(m, (L, n)))
        return to_tensor(temp, self.device)

    def _ct_data(self, ct: Ciphertext) -> torch.Tensor:
        return ct.data.to(self.device).contiguous()

    # ------------------------------------------------------------------
    # linear ops
    # ------------------------------------------------------------------
    def negate(self, encrypted: Ciphertext) -> Ciphertext:
        cd = self._cd(encrypted)
        return Ciphertext(negate_poly(self._ct_data(encrypted), cd.limb_constants),
                          encrypted.parms_id, encrypted.is_ntt_form, encrypted.scale)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        limbs = self._cd(a).limb_constants
        x, y = self._ct_data(a), self._ct_data(b)
        if a.size == b.size:
            data = add_poly(x, y, limbs)
        else:
            big, small = (x, y) if a.size > b.size else (y, x)
            k = small.shape[0]
            data = torch.cat([add_poly(big[:k], small, limbs), big[k:]])
        return Ciphertext(data, a.parms_id, a.is_ntt_form, a.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        limbs = self._cd(a).limb_constants
        x, y = self._ct_data(a), self._ct_data(b)
        k = min(a.size, b.size)
        head = sub_poly(x[:k], y[:k], limbs)
        if a.size == b.size:
            data = head
        elif a.size > b.size:
            data = torch.cat([head, x[k:]])
        else:
            data = torch.cat([head, negate_poly(y[k:], limbs)])
        return Ciphertext(data, a.parms_id, a.is_ntt_form, a.scale)

    def add_many(self, encrypteds: Sequence[Ciphertext]) -> Ciphertext:
        if not encrypteds:
            raise ValueError("encrypteds cannot be empty")
        acc = encrypteds[0]
        for ct in encrypteds[1:]:
            acc = self.add(acc, ct)
        return acc

    # ------------------------------------------------------------------
    # plaintext ops
    # ------------------------------------------------------------------
    def _plain_op(self, encrypted: Ciphertext, plain: Plaintext, sub: bool) -> Ciphertext:
        cd = self._cd(encrypted)
        name = "sub_plain" if sub else "add_plain"
        data = self._ct_data(encrypted)
        if cd.parms.scheme == SchemeType.BFV:
            if encrypted.is_ntt_form or plain.is_ntt_form:
                raise ValueError(f"BFV {name} operands cannot be in NTT form")
            m = to_tensor(self._plain_to_full(plain, cd.parms.poly_modulus_degree),
                          self.device)
            scale = (multiply_sub_plain_with_scaling_variant if sub
                     else multiply_add_plain_with_scaling_variant)
            return Ciphertext(_with_c0(data, scale(data[0], m, cd)), encrypted.parms_id,
                              False, encrypted.scale)
        if not encrypted.is_ntt_form or not plain.is_ntt_form:
            raise ValueError(f"CKKS {name} operands must be in NTT form")
        if encrypted.parms_id != plain.parms_id:
            raise ValueError("encrypted and plain parameter mismatch")
        if not _same_scale(encrypted.scale, plain.scale):
            raise ValueError("scale mismatch")
        op = sub_poly if sub else add_poly
        c0 = op(data[0], plain.data.to(self.device).contiguous(), cd.limb_constants)
        return Ciphertext(_with_c0(data, c0), encrypted.parms_id, True, encrypted.scale)

    def add_plain(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._plain_op(encrypted, plain, sub=False)

    def sub_plain(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._plain_op(encrypted, plain, sub=True)

    def multiply_plain(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        if encrypted.is_ntt_form and plain.is_ntt_form:
            return self._multiply_plain_ntt(encrypted, plain)
        if not encrypted.is_ntt_form and not plain.is_ntt_form:
            return self._multiply_plain_normal(encrypted, plain)
        raise ValueError("NTT form mismatch")

    def _multiply_plain_ntt(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        if encrypted.parms_id != plain.parms_id:
            raise ValueError("encrypted_ntt and plain_ntt parameter mismatch")
        cd = self._cd(encrypted)
        new_scale = encrypted.scale * plain.scale
        self._check_scale_bounds(new_scale, cd)
        data = dyadic_product(self._ct_data(encrypted),
                              plain.data.to(self.device).contiguous(), cd.limb_constants)
        return Ciphertext(data, encrypted.parms_id, True, new_scale)

    def _multiply_plain_normal(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        """reference: evaluator.cpp:1475-1602: the monomial fast path (one
        ``negacyclic`` launch), else the plain lifted, NTT, dyadic, inverse."""
        cd = self._cd(encrypted)
        parms = cd.parms
        n = parms.poly_modulus_degree
        limbs = cd.limb_constants
        thresh = cd.plain_upper_half_threshold
        new_scale = encrypted.scale * plain.scale
        self._check_scale_bounds(new_scale, cd)
        data = self._ct_data(encrypted)

        pdata = to_numpy(plain.data)
        nonzero = np.nonzero(pdata)[0]
        if nonzero.size == 1:
            # monomial fast path (evaluator.cpp:1514-1551)
            e = int(nonzero[0])
            c = int(pdata[e])
            if c >= thresh:
                if not cd.qualifiers.using_fast_plain_lift:
                    mono = np.array(cd.rns_base.decompose(
                        c + (cd.total_coeff_modulus - parms.plain_modulus.value)),
                        dtype=np.uint64)
                else:
                    mono = cd.plain_upper_half_increment + np.uint64(c)
                mono = to_tensor(mono.reshape(-1, 1), self.device)
            else:
                mono = c
            out = negacyclic_mono_mul_poly(data, mono, e, limbs)
            return Ciphertext(out, encrypted.parms_id, False, new_scale)

        m = np.zeros(n, dtype=np.uint64)
        m[: pdata.shape[0]] = pdata
        temp = ntt_forward(self._plain_rns(m, cd), cd.ntt_tables)
        prod = dyadic_product(ntt_forward(data, cd.ntt_tables), temp, limbs)
        return Ciphertext(ntt_inverse(prod, cd.ntt_tables), encrypted.parms_id, False,
                          new_scale)

    # ------------------------------------------------------------------
    # multiplication
    # ------------------------------------------------------------------
    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.parms_id != b.parms_id:
            raise ValueError("encrypted parameters mismatch")
        scheme = self._cd(a).parms.scheme
        if scheme == SchemeType.BFV:
            out = self._bfv_multiply(a, b)
        elif scheme == SchemeType.CKKS:
            out = self._ckks_multiply(a, b)
        else:
            raise ValueError("unsupported scheme")
        if out.is_transparent():
            raise RuntimeError("result ciphertext is transparent")
        return out

    def square(self, encrypted: Ciphertext) -> Ciphertext:
        """Dedicated square (reference: evaluator.cpp:560-770): for size-2
        ciphertexts the BEHZ lift runs once and the convolution takes the
        3-product square (one ``tensor_product`` launch); bit-identical to
        multiply(x, x)."""
        if encrypted.size != 2:
            return self.multiply(encrypted, encrypted)
        scheme = self._cd(encrypted).parms.scheme
        if scheme == SchemeType.BFV:
            out = self._bfv_multiply(encrypted, None)
        elif scheme == SchemeType.CKKS:
            out = self._ckks_multiply(encrypted, None)
        else:
            raise ValueError("unsupported scheme")
        if out.is_transparent():
            raise RuntimeError("result ciphertext is transparent")
        return out

    @staticmethod
    def _convolve(x: torch.Tensor, y, limbs) -> torch.Tensor:
        """dest[k] = sum_{i+j=k} x_i * y_j (evaluator.cpp:376-420), in the
        JAX package's order: a size-2 pair (y None: the square) is one
        ``tensor_product`` launch, larger sizes take dyadic products and
        adds."""
        if x.shape[0] == 2 and (y is None or y.shape[0] == 2):
            return _tensor_product(x, y, limbs)
        if y is None:
            y = x
        sa, sb = x.shape[0], y.shape[0]
        dest = []
        for k in range(sa + sb - 1):
            acc = None
            for i in range(max(0, k - sb + 1), min(k, sa - 1) + 1):
                term = dyadic_product(x[i], y[k - i], limbs)
                acc = term if acc is None else add_poly(acc, term, limbs)
            dest.append(acc)
        return torch.stack(dest)

    def _t_columns(self, cd: ContextData):
        """t as per-limb constants of the q and Bsk bases (cached per level)."""
        key = tuple(cd.parms_id)
        cols = self._t_cols.get(key)
        if cols is None:
            t = cd.parms.plain_modulus.value
            tool = cd.device_rns_tool
            cols = self._t_cols[key] = (torch.full_like(cd.limb_constants.p, t),
                                        torch.full_like(tool.Bsk_limbs.p, t))
        return cols

    def _bfv_multiply(self, a: Ciphertext, b) -> Ciphertext:
        """BEHZ RNS multiplication (reference: evaluator.cpp:274-445); b None
        squares a with one base extension (evaluator.cpp:560-706)."""
        if a.is_ntt_form or (b is not None and b.is_ntt_form):
            raise ValueError("BFV square operand cannot be in NTT form" if b is None
                             else "BFV multiply operands cannot be in NTT form")
        cd = self._cd(a)
        tool = cd.device_rns_tool
        limbs, bsk_limbs = cd.limb_constants, tool.Bsk_limbs
        bsk_tables = tool.base_Bsk_ntt_tables

        def extend(ct):
            # steps (1)-(3): lift to q u Bsk, NTT both; lazy [0, 4p) outputs
            # into the convolution's full-range Barrett products, as in the
            # JAX package
            x = self._ct_data(ct)
            bsk = sm_mrq(fastbconv_m_tilde(x, tool), tool)
            return ntt_forward_lazy(x, cd.ntt_tables), ntt_forward_lazy(bsk, bsk_tables)

        a_q, a_bsk = extend(a)
        b_q, b_bsk = extend(b) if b is not None else (None, None)
        dest_q = self._convolve(a_q, b_q, limbs)
        dest_bsk = self._convolve(a_bsk, b_bsk, bsk_limbs)
        # steps (5)-(8), every component at once
        t_q, t_bsk = self._t_columns(cd)
        tq = multiply_poly_scalar(ntt_inverse(dest_q, cd.ntt_tables), t_q, limbs)
        tbsk = multiply_poly_scalar(ntt_inverse(dest_bsk, bsk_tables), t_bsk, bsk_limbs)
        data = fastbconv_sk(fast_floor(tq, tbsk, tool), tool)
        return Ciphertext(data, a.parms_id, False, a.scale)

    def _ckks_multiply(self, a: Ciphertext, b) -> Ciphertext:
        """reference: evaluator.cpp:447-527 (b None: the square, :708-770)."""
        if not (a.is_ntt_form and (b is None or b.is_ntt_form)):
            raise ValueError("CKKS square operand must be in NTT form" if b is None
                             else "CKKS multiply operands must be in NTT form")
        cd = self._cd(a)
        new_scale = a.scale * (a.scale if b is None else b.scale)
        self._check_scale_bounds(new_scale, cd)
        data = self._convolve(self._ct_data(a), None if b is None else self._ct_data(b),
                              cd.limb_constants)
        return Ciphertext(data, a.parms_id, True, new_scale)

    # ------------------------------------------------------------------
    # relinearization / key switching
    # ------------------------------------------------------------------
    def relinearize(self, encrypted: Ciphertext, relin_keys: RelinKeys) -> Ciphertext:
        return self._relinearize_internal(encrypted, relin_keys, 2)

    def _relinearize_internal(self, encrypted: Ciphertext, relin_keys: RelinKeys,
                              destination_size: int) -> Ciphertext:
        """reference: evaluator.cpp:772-827: components sz-1 .. destination_size
        are removed highest first, each by a key switch with the key for
        s^power folded into (c0, c1)."""
        if relin_keys.parms_id != self.context.key_parms_id:
            raise ValueError("relin_keys is not valid for encryption parameters")
        sz = encrypted.size
        if destination_size < 2 or destination_size > sz:
            raise ValueError("destination_size out of range")
        if relin_keys.size() < sz - 2:
            raise ValueError("not enough relinearization keys")
        if destination_size == sz:
            return encrypted
        limbs = self._cd(encrypted).limb_constants
        plan = self._ks_plan(encrypted.parms_id)
        data = self._ct_data(encrypted)
        for power in range(sz - 1, destination_size - 1, -1):
            d0, d1 = switch_key(data[power], relin_keys.stacked(power), plan,
                                encrypted.is_ntt_form)
            c0 = add_poly(data[0], d0, limbs)
            c1 = add_poly(data[1], d1, limbs)
            data = torch.cat([torch.stack([c0, c1]), data[2:power]])
        out = Ciphertext(data, encrypted.parms_id, encrypted.is_ntt_form, encrypted.scale)
        if out.is_transparent():
            raise RuntimeError("result ciphertext is transparent")
        return out

    def _galois_c0c1(self, data, galois_elt: int, cd: ContextData, is_ntt: bool):
        """Both components through the automorphism: one ``galois`` launch."""
        tool = cd.galois_tool
        if is_ntt:
            rot = tool.apply_galois_ntt(data[:2], galois_elt)
        else:
            rot = tool.apply_galois(data[:2], galois_elt, cd.limb_constants)
        return rot[0], rot[1]

    def apply_galois(self, encrypted: Ciphertext, galois_elt: int,
                     galois_keys: GaloisKeys) -> Ciphertext:
        """reference: evaluator.cpp:1841-1943."""
        if galois_keys.parms_id != self.context.key_parms_id:
            raise ValueError("galois_keys is not valid for encryption parameters")
        cd = self._cd(encrypted)
        if encrypted.size > 2:
            raise ValueError("encrypted size must be 2")
        if not galois_keys.has_key(galois_elt):
            raise ValueError("Galois key not present")
        is_ntt = encrypted.is_ntt_form
        c0, c1 = self._galois_c0c1(self._ct_data(encrypted), galois_elt, cd, is_ntt)
        plan = self._ks_plan(encrypted.parms_id)
        d0, d1 = switch_key(c1.contiguous(), galois_keys.stacked(galois_elt), plan, is_ntt)
        data = torch.stack([add_poly(c0.contiguous(), d0, cd.limb_constants), d1])
        return Ciphertext(data, encrypted.parms_id, is_ntt, encrypted.scale)

    def _rotate_internal(self, encrypted: Ciphertext, steps: int,
                         galois_keys: GaloisKeys) -> Ciphertext:
        """reference: evaluator.cpp:1945-2000 (direct key or NAF fallback)."""
        cd = self._cd(encrypted)
        if not cd.qualifiers.using_batching:
            raise RuntimeError("encryption parameters do not support batching")
        if galois_keys.parms_id != self.context.key_parms_id:
            raise ValueError("galois_keys is not valid for encryption parameters")
        if steps == 0:
            return encrypted
        elt = cd.galois_tool.get_elt_from_step(steps)
        if galois_keys.has_key(elt):
            return self.apply_galois(encrypted, elt, galois_keys)
        # NAF fallback (evaluator.cpp:1977-1999); a single-term NAF is a
        # power-of-two step whose key is absent: raise, as the reference does
        terms = naf(steps)
        if len(terms) == 1:
            raise ValueError("Galois key not present")
        out = encrypted
        for term in sorted(terms, key=abs, reverse=True):
            if abs(term) != (cd.parms.poly_modulus_degree >> 1):
                out = self._rotate_internal(out, term, galois_keys)
        return out

    # BFV batching rotations (evaluator.h:1057-1167)
    def rotate_rows(self, encrypted: Ciphertext, steps: int,
                    galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        return self._rotate_internal(encrypted, steps, galois_keys)

    def rotate_columns(self, encrypted: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        n = self._cd(encrypted).parms.poly_modulus_degree
        return self.apply_galois(encrypted, 2 * n - 1, galois_keys)

    # CKKS rotations (evaluator.h:1201-1307)
    def rotate_vector(self, encrypted: Ciphertext, steps: int,
                      galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        return self._rotate_internal(encrypted, steps, galois_keys)

    def complex_conjugate(self, encrypted: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        n = self._cd(encrypted).parms.poly_modulus_degree
        return self.apply_galois(encrypted, 2 * n - 1, galois_keys)

    def apply_galois_many(self, encrypted: Ciphertext, galois_elts: Sequence[int],
                          galois_keys: GaloisKeys) -> List[Ciphertext]:
        """Hoisted multi-rotation (no reference analogue): the mod-up digits
        of c1 are computed once and permuted for each element, then one key
        inner product each, as the JAX package's loop does."""
        if galois_keys.parms_id != self.context.key_parms_id:
            raise ValueError("galois_keys is not valid for encryption parameters")
        cd = self._cd(encrypted)
        if encrypted.size > 2:
            raise ValueError("encrypted size must be 2")
        for elt in galois_elts:
            if not galois_keys.has_key(elt):
                raise ValueError("Galois key not present")
        tool = cd.galois_tool
        limbs = cd.limb_constants
        plan = self._ks_plan(encrypted.parms_id)
        is_ntt = encrypted.is_ntt_form
        data = self._ct_data(encrypted)
        c0 = data[0]
        ct_k = compute_modup_digits(data[1], plan, is_ntt)   # hoisted (once)
        outs = []
        for elt in galois_elts:
            ct_k_rot = tool.apply_galois_ntt(ct_k, elt)
            d0, d1 = keyswitch_inner_product(ct_k_rot, galois_keys.stacked(elt), plan, is_ntt)
            p0 = (tool.apply_galois_ntt(c0, elt) if is_ntt
                  else tool.apply_galois(c0, elt, limbs))
            outs.append(Ciphertext(torch.stack([add_poly(p0, d0, limbs), d1]),
                                   encrypted.parms_id, is_ntt, encrypted.scale))
        return outs

    def rotate_vector_many(self, encrypted: Ciphertext, steps: Sequence[int],
                           galois_keys: GaloisKeys) -> List[Ciphertext]:
        """k CKKS rotations for one mod-up; every step needs a direct key."""
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        elts = self._cd(encrypted).galois_tool.get_elts_from_steps(list(steps))
        return self.apply_galois_many(encrypted, elts, galois_keys)

    def rotate_rows_many(self, encrypted: Ciphertext, steps: Sequence[int],
                         galois_keys: GaloisKeys) -> List[Ciphertext]:
        """k BFV row rotations for one mod-up."""
        if self._scheme() != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        elts = self._cd(encrypted).galois_tool.get_elts_from_steps(list(steps))
        return self.apply_galois_many(encrypted, elts, galois_keys)

    # ------------------------------------------------------------------
    # modulus switching / rescaling
    # ------------------------------------------------------------------
    def _mod_switch_scale_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        """Rounded division by the last prime (reference: evaluator.cpp:829-892)."""
        cd = self._cd(encrypted)
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV and encrypted.is_ntt_form:
            raise ValueError("BFV encrypted cannot be in NTT form")
        if scheme == SchemeType.CKKS and not encrypted.is_ntt_form:
            raise ValueError("CKKS encrypted must be in NTT form")
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        tool = cd.device_rns_tool
        data = self._ct_data(encrypted)
        if scheme == SchemeType.BFV:
            data = divide_and_round_q_last(data, tool)
        else:
            data = divide_and_round_q_last_ntt(data, tool, cd.ntt_tables)
        new_scale = encrypted.scale
        if scheme == SchemeType.CKKS:
            new_scale = encrypted.scale / cd.parms.coeff_modulus[-1].value
        return Ciphertext(data, next_cd.parms_id, encrypted.is_ntt_form, new_scale)

    def _mod_switch_drop_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        """Drop the last prime, keep the scale (reference: evaluator.cpp:894-994)."""
        cd = self._cd(encrypted)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        next_L = len(next_cd.parms.coeff_modulus)
        self._check_scale_bounds(encrypted.scale, next_cd)
        return Ciphertext(self._ct_data(encrypted)[:, :next_L, :].contiguous(),
                          next_cd.parms_id, encrypted.is_ntt_form, encrypted.scale)

    def mod_switch_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        if self._scheme() == SchemeType.BFV:
            return self._mod_switch_scale_to_next(encrypted)
        return self._mod_switch_drop_to_next(encrypted)

    def mod_switch_to(self, encrypted: Ciphertext, parms_id, fused: bool = False) -> Ciphertext:
        """Switch down to `parms_id` one level at a time; with ``fused`` a BFV
        ciphertext dropping two or more levels takes one rounded division by
        the product of the dropped primes (decrypts identically to the
        per-level chain, not bit-identical to it)."""
        cd = self._cd(encrypted)
        target = self.context.get_context_data(parms_id)
        if target is None:
            raise ValueError("parms_id is not valid")
        if cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        levels = cd.chain_index - target.chain_index
        if (fused and levels >= 2 and cd.parms.scheme == SchemeType.BFV
                and not encrypted.is_ntt_form):
            key = (tuple(encrypted.parms_id), levels)
            plan = self._md_plans.get(key)
            if plan is None:
                plan = self._md_plans[key] = MultiDropPlan(self.context, encrypted.parms_id,
                                                           levels)
            data = divide_and_round_multi(self._ct_data(encrypted), plan)
            return Ciphertext(data, tuple(parms_id), False, encrypted.scale)
        out = encrypted
        while out.parms_id != tuple(parms_id):
            out = self.mod_switch_to_next(out)
        return out

    def mod_switch_plain_to_next(self, plain: Plaintext) -> Plaintext:
        """NTT-form plaintext modulus drop (evaluator.cpp:966-994)."""
        if not plain.is_ntt_form:
            raise ValueError("plain is not in NTT form")
        next_cd = self.context.get_context_data(plain.parms_id).next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        next_L = len(next_cd.parms.coeff_modulus)
        return Plaintext(plain.data[:next_L].contiguous(), next_cd.parms_id, plain.scale)

    def mod_switch_plain_to(self, plain: Plaintext, parms_id) -> Plaintext:
        out = plain
        while out.parms_id != tuple(parms_id):
            out = self.mod_switch_plain_to_next(out)
        return out

    def rescale_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        return self._mod_switch_scale_to_next(encrypted)

    def rescale_to(self, encrypted: Ciphertext, parms_id) -> Ciphertext:
        target = self.context.get_context_data(parms_id)
        cd = self._cd(encrypted)
        if target is None or cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        out = encrypted
        while out.parms_id != tuple(parms_id):
            out = self.rescale_to_next(out)
        return out

    # ------------------------------------------------------------------
    # NTT transforms
    # ------------------------------------------------------------------
    def transform_to_ntt(self, encrypted: Ciphertext) -> Ciphertext:
        if encrypted.is_ntt_form:
            raise ValueError("encrypted is already in NTT form")
        cd = self._cd(encrypted)
        return Ciphertext(ntt_forward(self._ct_data(encrypted), cd.ntt_tables),
                          encrypted.parms_id, True, encrypted.scale)

    def transform_from_ntt(self, encrypted: Ciphertext) -> Ciphertext:
        if not encrypted.is_ntt_form:
            raise ValueError("encrypted is not in NTT form")
        cd = self._cd(encrypted)
        return Ciphertext(ntt_inverse(self._ct_data(encrypted), cd.ntt_tables),
                          encrypted.parms_id, False, encrypted.scale)

    def transform_plain_to_ntt(self, plain: Plaintext, parms_id) -> Plaintext:
        """Lift a BFV plaintext into NTT form at a level
        (reference: evaluator.cpp:1648-1718)."""
        if plain.is_ntt_form:
            raise ValueError("plain is already in NTT form")
        cd = self.context.get_context_data(parms_id)
        m = self._plain_to_full(plain, cd.parms.poly_modulus_degree)
        data = ntt_forward(self._plain_rns(m, cd), cd.ntt_tables)
        return Plaintext(data=data, parms_id=cd.parms_id, scale=plain.scale)

    # ------------------------------------------------------------------
    # composite ops
    # ------------------------------------------------------------------
    def multiply_many(self, encrypteds: Sequence[Ciphertext],
                      relin_keys: RelinKeys) -> Ciphertext:
        """Balanced product tree with relinearization
        (reference: evaluator.h multiply_many)."""
        if self._scheme() != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        return product_tree(encrypteds, self.multiply, self.square,
                            lambda ct: self.relinearize(ct, relin_keys))

    def exponentiate(self, encrypted: Ciphertext, exponent: int,
                     relin_keys: RelinKeys) -> Ciphertext:
        if exponent == 0:
            raise ValueError("exponent cannot be 0")
        if exponent == 1:
            return encrypted
        return self.multiply_many([encrypted] * exponent, relin_keys)
