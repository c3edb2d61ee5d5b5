"""DeviceEvaluator: the SEAL-style op API with ciphertexts resident on the card.

Port of gemini_seal_tpu/models/device_evaluator.py.  The JAX class runs
each op as one cached jitted program; PyTorch runs eagerly, so here each op
is the direct launches of the port's kernels on data that stays on the
context's device: the CKKS size-2 multiply and square (one
``tensor_product`` launch), relinearize and the Galois ops (one key switch),
the NAF rotation, the hoisted ``rotate_vector_many``, the one-call
``multiply_relin_rescale`` / ``square_relin_rescale`` (the port's
``build_ckks_mul_relin_rescale``, fused by default), rescale, the modulus
switches, the NTT transforms, ``add_many`` and the NTT-form plaintext ops.
What the JAX class hands to its host ``Evaluator`` (the BFV multiply,
odd sizes, the power-basis plaintext ops) goes to the port's ``Evaluator``
on the same device.  The jit cache has no counterpart; its contract, one
cached plan per level, is kept by the plan and pipeline caches, and keys
are stacked on the device once per (keys object, index).

The device ops take ciphertext data [..., size, L, N]: leading batch axes
broadcast through them, as in the JAX class's programs (the size is read
from axis -3).  What goes to the Evaluator takes unbatched data.

reference parity: evaluator.h op surface; no reference analogue for the
execution model.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..ciphertext import Ciphertext, Plaintext
from ..context import SealContext
from ..evaluator import Evaluator, _same_scale, product_tree
from ..keys import GaloisKeys, RelinKeys
from ..ops.dyadic import add_poly, dyadic_product, negate_poly, sub_poly
from ..ops.keyswitch import (KeySwitchPlan, compute_modup_digits, keyswitch_inner_product,
                             switch_key)
from ..ops.ntt import ntt_forward, ntt_inverse
from ..ops.rnsops import divide_and_round_q_last, divide_and_round_q_last_ntt
from ..params import SchemeType
from ..utils.numth import naf
from .pipelines import _tensor_product, build_ckks_mul_relin_rescale

__all__ = ["DeviceEvaluator"]


def _comp(x: torch.Tensor, i: int) -> torch.Tensor:
    """Component i of [..., size, L, N] data, contiguous."""
    return x[..., i, :, :].contiguous()


def _size(ct: Ciphertext) -> int:
    """The component count of [..., size, L, N] data (Ciphertext.size for
    unbatched data)."""
    return int(ct.data.shape[-3])


class DeviceEvaluator:
    def __init__(self, context: SealContext, device=None):
        self.device = context.check_device(device)
        self.context = context
        self.host = Evaluator(context, device=self.device)  # validation + generic ops
        self._plan_cache: Dict[tuple, KeySwitchPlan] = {}
        self._mrr_cache: Dict[tuple, object] = {}
        self._key_cache: Dict[tuple, object] = {}

    # -- infrastructure ----------------------------------------------------
    def put(self, ct: Ciphertext) -> Ciphertext:
        """The ciphertext with its data on the context's device."""
        return Ciphertext(ct.data.to(self.device).contiguous(), ct.parms_id,
                          ct.is_ntt_form, ct.scale)

    def get(self, ct: Ciphertext) -> Ciphertext:
        """The ciphertext with its data on the CPU."""
        return Ciphertext(ct.data.cpu(), ct.parms_id, ct.is_ntt_form, ct.scale)

    def _cd(self, ct: Ciphertext):
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("ciphertext is not valid for encryption parameters")
        return cd

    def _plan(self, parms_id) -> KeySwitchPlan:
        k = tuple(parms_id)
        plan = self._plan_cache.get(k)
        if plan is None:
            plan = self._plan_cache[k] = KeySwitchPlan(self.context, parms_id)
        return plan

    def _key_data(self, keys, *indices) -> torch.Tensor:
        """Stacked key tensor ([n_bundles, 2, L_key, N] for one index,
        [R, n_bundles, 2, L_key, N] for several), built once.

        The cache entry holds a reference to the keys object so that a
        garbage-collected id() can never alias another object's entry."""
        k = (id(keys), indices)
        hit = self._key_cache.get(k)
        if hit is not None and hit[0] is keys:
            return hit[1]
        data = keys.stacked(*indices).to(self.device).contiguous()
        self._key_cache[k] = (keys, data)
        return data

    def _data(self, ct: Ciphertext) -> torch.Tensor:
        return ct.data.to(self.device).contiguous()

    # -- linear ops ---------------------------------------------------------
    def _linear(self, a: Ciphertext, b: Ciphertext, op, host_op) -> Ciphertext:
        self.host._check_same(a, b)
        if _size(a) != _size(b):
            return host_op(a, b)
        limbs = self._cd(a).limb_constants
        return Ciphertext(op(self._data(a), self._data(b), limbs), a.parms_id,
                          a.is_ntt_form, a.scale)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._linear(a, b, add_poly, self.host.add)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._linear(a, b, sub_poly, self.host.sub)

    def negate(self, a: Ciphertext) -> Ciphertext:
        limbs = self._cd(a).limb_constants
        return Ciphertext(negate_poly(self._data(a), limbs), a.parms_id, a.is_ntt_form,
                          a.scale)

    # -- multiplication -----------------------------------------------------
    def _ckks_product(self, a: Ciphertext, b) -> torch.Tensor:
        """Size-2 x size-2 CKKS product (b None: square): one
        ``tensor_product`` launch, components stacked at axis -3."""
        limbs = self._cd(a).limb_constants
        out = _tensor_product(self._data(a), None if b is None else self._data(b), limbs)
        return out.movedim(0, -3).contiguous()

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        cd = self._cd(a)
        scheme = cd.parms.scheme
        self.host._check_same(a, b)
        if scheme == SchemeType.CKKS:
            self.host._check_scale_bounds(a.scale * b.scale, cd)
        if scheme == SchemeType.CKKS and _size(a) == 2 and _size(b) == 2:
            return Ciphertext(self._ckks_product(a, b), a.parms_id, True, a.scale * b.scale)
        # BFV (BEHZ) and odd sizes: the Evaluator's exact logic
        return self.host.multiply(a, b)

    def square(self, a: Ciphertext) -> Ciphertext:
        """Dedicated square: 3-product convolution, and for BFV one base
        extension instead of two (reference: evaluator.cpp:560-770);
        bit-exact with multiply(a, a)."""
        if _size(a) != 2:
            return self.multiply(a, a)
        cd = self._cd(a)
        if cd.parms.scheme == SchemeType.CKKS:
            if not a.is_ntt_form:
                raise ValueError("CKKS square operand must be in NTT form")
            self.host._check_scale_bounds(a.scale * a.scale, cd)
            return Ciphertext(self._ckks_product(a, None), a.parms_id, True,
                              a.scale * a.scale)
        return self.host.square(a)

    # -- key switching --------------------------------------------------
    def relinearize(self, a: Ciphertext, relin_keys: RelinKeys) -> Ciphertext:
        if _size(a) != 3:
            return self.host.relinearize(a, relin_keys)
        limbs = self._cd(a).limb_constants
        x = self._data(a)
        d0, d1 = switch_key(_comp(x, 2), self._key_data(relin_keys, 2),
                            self._plan(a.parms_id), a.is_ntt_form)
        out = torch.stack([add_poly(_comp(x, 0), d0, limbs), add_poly(_comp(x, 1), d1, limbs)],
                          dim=-3)
        return Ciphertext(out, a.parms_id, a.is_ntt_form, a.scale)

    def _check_galois(self, a: Ciphertext, galois_keys: GaloisKeys, elts):
        """The Evaluator's validations of apply_galois (a size-3 ciphertext's
        c2 would otherwise be silently dropped)."""
        if galois_keys.parms_id != self.context.key_parms_id:
            raise ValueError("galois_keys is not valid for encryption parameters")
        if _size(a) > 2:
            raise ValueError("encrypted size must be 2")
        for elt in elts:
            if not galois_keys.has_key(elt):
                raise ValueError("Galois key not present")

    def _galois(self, x, elt: int, cd, is_ntt: bool):
        tool = cd.galois_tool
        if is_ntt:
            return tool.apply_galois_ntt(x, elt)
        return tool.apply_galois(x, elt, cd.limb_constants)

    def apply_galois(self, a: Ciphertext, galois_elt: int,
                     galois_keys: GaloisKeys) -> Ciphertext:
        self._check_galois(a, galois_keys, (galois_elt,))
        cd = self._cd(a)
        is_ntt = a.is_ntt_form
        rot = self._galois(self._data(a), galois_elt, cd, is_ntt)   # both components
        d0, d1 = switch_key(_comp(rot, 1), self._key_data(galois_keys, galois_elt),
                            self._plan(a.parms_id), is_ntt)
        out = torch.stack([add_poly(_comp(rot, 0), d0, cd.limb_constants), d1], dim=-3)
        return Ciphertext(out, a.parms_id, is_ntt, a.scale)

    def rotate_vector(self, a: Ciphertext, steps: int, galois_keys: GaloisKeys) -> Ciphertext:
        """Direct key when present, else the reference's NAF fallback
        (evaluator.cpp:1945-1999); a single-term NAF with a missing key
        raises instead of recursing."""
        if steps == 0:
            return a
        cd = self._cd(a)
        elt = cd.galois_tool.get_elt_from_step(steps)
        if galois_keys.has_key(elt):
            return self.apply_galois(a, elt, galois_keys)
        terms = naf(steps)
        if len(terms) == 1:
            raise ValueError("Galois key not present")
        out = a
        for term in sorted(terms, key=abs, reverse=True):
            if abs(term) != (cd.parms.poly_modulus_degree >> 1):
                out = self.rotate_vector(out, term, galois_keys)
        return out

    rotate_rows = rotate_vector

    def complex_conjugate(self, a: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        n = self._cd(a).parms.poly_modulus_degree
        return self.apply_galois(a, 2 * n - 1, galois_keys)

    def rotate_vector_many(self, a: Ciphertext, steps: Sequence[int],
                           galois_keys: GaloisKeys) -> List[Ciphertext]:
        """Hoisted: one mod-up of c1 for all rotations, then each element's
        permuted digits, key inner product and rotated c0 (the JAX class's
        program, launch by launch)."""
        cd = self._cd(a)
        tool = cd.galois_tool
        limbs = cd.limb_constants
        plan = self._plan(a.parms_id)
        is_ntt = a.is_ntt_form
        elts = tuple(tool.get_elt_from_step(s) for s in steps)
        self._check_galois(a, galois_keys, elts)
        x = self._data(a)
        c0 = _comp(x, 0)
        ct_k = compute_modup_digits(_comp(x, 1), plan, is_ntt)
        outs = []
        for elt in elts:
            ct_k_rot = tool.apply_galois_ntt(ct_k, elt)
            d0, d1 = keyswitch_inner_product(ct_k_rot, self._key_data(galois_keys, elt), plan,
                                             is_ntt)
            p0 = self._galois(c0, elt, cd, is_ntt)
            outs.append(Ciphertext(torch.stack([add_poly(p0, d0, limbs), d1], dim=-3),
                                   a.parms_id, is_ntt, a.scale))
        return outs

    def multiply_relin_rescale(self, a: Ciphertext, b: Ciphertext, relin_keys: RelinKeys,
                               fused: bool = True) -> Ciphertext:
        """multiply + relinearize + rescale in one call: the port's
        build_ckks_mul_relin_rescale at the operands' level (with ``fused``,
        the one-pass P*q_last mod-down: decrypts equal to the sequential
        chain, not bit-identical to it)."""
        cd = self._cd(a)
        if cd.parms.scheme != SchemeType.CKKS:
            raise ValueError("multiply_relin_rescale is a CKKS op")
        if _size(a) != 2 or _size(b) != 2:
            raise ValueError("operands must be size-2 ciphertexts")
        if not (a.is_ntt_form and b.is_ntt_form):
            raise ValueError("CKKS operands must be in NTT form")
        if cd.next_context_data is None:
            raise ValueError("end of modulus switching chain reached")
        self.host._check_same(a, b)
        self.host._check_scale_bounds(a.scale * b.scale, cd)
        return self._mrr_run(a, (self._data(a), self._data(b)), relin_keys, fused, False,
                             a.scale * b.scale)

    def square_relin_rescale(self, a: Ciphertext, relin_keys: RelinKeys,
                             fused: bool = True) -> Ciphertext:
        """square + relinearize + rescale in one call (3-product
        convolution; bit-exact with multiply_relin_rescale(a, a))."""
        cd = self._cd(a)
        if cd.parms.scheme != SchemeType.CKKS:
            raise ValueError("square_relin_rescale is a CKKS op")
        if _size(a) != 2:
            raise ValueError("operand must be a size-2 ciphertext")
        if not a.is_ntt_form:
            raise ValueError("CKKS operand must be in NTT form")
        if cd.next_context_data is None:
            raise ValueError("end of modulus switching chain reached")
        self.host._check_scale_bounds(a.scale * a.scale, cd)
        return self._mrr_run(a, (self._data(a),), relin_keys, fused, True, a.scale * a.scale)

    def _mrr_run(self, a: Ciphertext, args, relin_keys, fused: bool, square: bool,
                 prod_scale: float) -> Ciphertext:
        cd = self._cd(a)
        key = (tuple(a.parms_id), fused, square)
        fn = self._mrr_cache.get(key)
        if fn is None:
            fn = self._mrr_cache[key] = build_ckks_mul_relin_rescale(
                self.context, a.parms_id, fused=fused, square=square, device=self.device)
        q_last = cd.parms.coeff_modulus[-1].value
        return Ciphertext(fn(*args, self._key_data(relin_keys, 2)),
                          cd.next_context_data.parms_id, True, prod_scale / q_last)

    # -- level movement ---------------------------------------------------
    def rescale_to_next(self, a: Ciphertext) -> Ciphertext:
        cd = self._cd(a)
        if cd.parms.scheme != SchemeType.CKKS or not a.is_ntt_form:
            return self.host.rescale_to_next(a)
        nxt = cd.next_context_data
        if nxt is None:
            raise ValueError("end of modulus switching chain reached")
        out = divide_and_round_q_last_ntt(self._data(a), cd.device_rns_tool, cd.ntt_tables)
        return Ciphertext(out, nxt.parms_id, True, a.scale / cd.parms.coeff_modulus[-1].value)

    def mod_switch_to_next(self, a: Ciphertext) -> Ciphertext:
        cd = self._cd(a)
        nxt = cd.next_context_data
        if nxt is None:
            raise ValueError("end of modulus switching chain reached")
        x = self._data(a)
        if cd.parms.scheme == SchemeType.CKKS:
            # drop the last limb (no scaling)
            L = len(nxt.parms.coeff_modulus)
            return Ciphertext(x[..., :L, :].contiguous(), nxt.parms_id, a.is_ntt_form,
                              a.scale)
        return Ciphertext(divide_and_round_q_last(x, cd.device_rns_tool), nxt.parms_id,
                          a.is_ntt_form, a.scale)

    def mod_switch_to(self, a: Ciphertext, parms_id) -> Ciphertext:
        """Per-level switches down to parms_id (evaluator.h mod_switch_to)."""
        cd = self._cd(a)
        target = self.context.get_context_data(parms_id)
        if target is None:
            raise ValueError("parms_id is not valid")
        if cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        out = a
        while out.parms_id != tuple(parms_id):
            out = self.mod_switch_to_next(out)
        return out

    def rescale_to(self, a: Ciphertext, parms_id) -> Ciphertext:
        cd = self._cd(a)
        target = self.context.get_context_data(parms_id)
        if target is None or cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        out = a
        while out.parms_id != tuple(parms_id):
            out = self.rescale_to_next(out)
        return out

    # -- NTT transforms -----------------------------------------------------
    def transform_to_ntt(self, a: Ciphertext) -> Ciphertext:
        if a.is_ntt_form:
            raise ValueError("encrypted is already in NTT form")
        cd = self._cd(a)
        return Ciphertext(ntt_forward(self._data(a), cd.ntt_tables), a.parms_id, True, a.scale)

    def transform_from_ntt(self, a: Ciphertext) -> Ciphertext:
        if not a.is_ntt_form:
            raise ValueError("encrypted is not in NTT form")
        cd = self._cd(a)
        return Ciphertext(ntt_inverse(self._data(a), cd.ntt_tables), a.parms_id, False,
                          a.scale)

    # -- composite ops ------------------------------------------------------
    def add_many(self, encrypteds: Sequence[Ciphertext]) -> Ciphertext:
        """The sum of k ciphertexts, one ``elementwise`` launch per add."""
        if not encrypteds:
            raise ValueError("encrypteds cannot be empty")
        a = encrypteds[0]
        if len(encrypteds) == 1:
            return a
        if any(_size(c) != _size(a) for c in encrypteds):
            return self.host.add_many(encrypteds)
        for c in encrypteds[1:]:
            self.host._check_same(a, c)
        limbs = self._cd(a).limb_constants
        acc = self._data(a)
        for c in encrypteds[1:]:
            acc = add_poly(acc, self._data(c), limbs)
        return Ciphertext(acc, a.parms_id, a.is_ntt_form, a.scale)

    def multiply_many(self, encrypteds: Sequence[Ciphertext],
                      relin_keys: RelinKeys) -> Ciphertext:
        """Balanced product tree (evaluator.h multiply_many; BFV only, like
        the reference), with the Evaluator's pairing order: bit-identical
        results."""
        if not encrypteds:
            raise ValueError("encrypteds cannot be empty")
        if self._cd(encrypteds[0]).parms.scheme != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        return product_tree(encrypteds, self.multiply, self.square,
                            lambda ct: self.relinearize(ct, relin_keys))

    def exponentiate(self, a: Ciphertext, exponent: int,
                     relin_keys: RelinKeys) -> Ciphertext:
        if exponent == 0:
            raise ValueError("exponent cannot be 0")
        if exponent == 1:
            return a
        return self.multiply_many([a] * exponent, relin_keys)

    # -- BFV batching rotations -------------------------------------------
    def rotate_columns(self, a: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        if self._cd(a).parms.scheme != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        n = self._cd(a).parms.poly_modulus_degree
        return self.apply_galois(a, 2 * n - 1, galois_keys)

    def rotate_rows_many(self, a: Ciphertext, steps: Sequence[int],
                         galois_keys: GaloisKeys) -> List[Ciphertext]:
        if self._cd(a).parms.scheme != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        return self.rotate_vector_many(a, steps, galois_keys)

    # -- plaintext ops ------------------------------------------------------
    def _check_plain_ntt(self, a: Ciphertext, plain: Plaintext):
        """The Evaluator's validations of the CKKS NTT-form add_plain/sub_plain."""
        if a.parms_id != plain.parms_id:
            raise ValueError("encrypted and plain parameter mismatch")
        if not _same_scale(a.scale, plain.scale):
            raise ValueError("scale mismatch")

    def _plain_ntt(self, a: Ciphertext, plain: Plaintext, op, host_op) -> Ciphertext:
        cd = self._cd(a)
        if cd.parms.scheme == SchemeType.CKKS and a.is_ntt_form and plain.is_ntt_form:
            self._check_plain_ntt(a, plain)
            x = self._data(a)
            c0 = op(_comp(x, 0), plain.data.to(self.device).contiguous(), cd.limb_constants)
            return Ciphertext(torch.cat([c0.unsqueeze(-3), x[..., 1:, :, :]], dim=-3),
                              a.parms_id, True, a.scale)
        return host_op(a, plain)

    def add_plain(self, a: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._plain_ntt(a, plain, add_poly, self.host.add_plain)

    def sub_plain(self, a: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._plain_ntt(a, plain, sub_poly, self.host.sub_plain)

    def multiply_plain(self, a: Ciphertext, plain: Plaintext) -> Ciphertext:
        cd = self._cd(a)
        if a.is_ntt_form and plain.is_ntt_form:
            if a.parms_id != plain.parms_id:
                raise ValueError("encrypted_ntt and plain_ntt parameter mismatch")
            self.host._check_scale_bounds(a.scale * plain.scale, cd)
            data = dyadic_product(self._data(a), plain.data.to(self.device).contiguous(),
                                  cd.limb_constants)
            return Ciphertext(data, a.parms_id, True, a.scale * plain.scale)
        return self.host.multiply_plain(a, plain)
