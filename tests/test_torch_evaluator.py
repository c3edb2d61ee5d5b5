"""The port's per-op API against the JAX package's host ``Evaluator``,
exact equality: every method of the Evaluator, the error types and
messages of its checks, the BFV noise budget, the IntegerEncoder, the
Plaintext and Ciphertext helpers, and the ex1 flow (examples/ex1_bfv_basics.py)
at N=1024 with every intermediate ciphertext compared.

Each ring is one context in both packages under one seed; the JAX package
makes the keys (relin keys for s^2 and s^3, the default Galois keys) and
the ciphertexts (sizes 2, 3 and 4), and gemini_seal_tpu_torch.convert
carries them into the port.  An op is a function of a namespace of one
package's objects (``OPS``), run through both and compared.  Rings: BFV at
N=64 with t = 257 below every prime (the fast plain lift) and at N=256 with
a 30-bit t above the first prime (20 bits: the CRT plain lift), and CKKS
at N=256.  The JAX functions run eagerly on numpy (the package's host
plane), the port's plain versions on the CPU.  tests/test_torch_device_evaluator.py
reuses this set-up for the DeviceEvaluator.
"""

import types

import numpy as np
import pytest

import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch import convert
from gemini_seal_tpu_torch.ops.backend import to_numpy
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

SEED = tuple(range(11, 19))


def _stack(keys, index):
    return np.stack([np.asarray(pk.data.data) for pk in keys.key(index)])


def _params(M, scheme, n, bits, t, nsp):
    parms = M.EncryptionParameters(getattr(M.SchemeType, scheme))
    parms.set_poly_modulus_degree(n)
    parms.set_n_special_primes(nsp)
    parms.set_coeff_modulus(M.CoeffModulus.create(n, bits))
    if t is not None:
        parms.set_plain_modulus(t)
    parms.set_random_seed(SEED)
    return parms


class Pair:
    """scheme "BFV" or "CKKS" at ring n with primes of `bits` (the last
    special) and plain modulus t (an int, or a batching prime's bit count
    as ("batching", bits))."""

    def __init__(self, scheme, n, bits, t=None, scale=2.0 ** 30, nsp=1):
        if isinstance(t, tuple):
            t = J.PlainModulus.batching(n, t[1]).value
        self.scheme, self.n, self.t, self.scale = scheme, n, t, scale
        self.jc = J.SealContext(_params(J, scheme, n, bits, t, nsp),
                                sec_level=J.SecLevelType.none)
        self.tc = T.SealContext(_params(T, scheme, n, bits, t, nsp),
                                sec_level=T.SecLevelType.none, device="cpu")
        self.jkg = J.KeyGenerator(self.jc)
        self.jenc = J.Encryptor(self.jc, public_key=self.jkg.public_key())
        self.jdec = J.Decryptor(self.jc, self.jkg.secret_key)
        self.tdec = T.Decryptor(self.tc, convert.secret_key_from_array(
            self.tc, self.jkg.secret_key.data), device="cpu")
        jrk = self.jkg.relin_keys(2)
        jgk = self.jkg.galois_keys()
        elts = [2 * i + 1 for i, k in enumerate(jgk.keys) if k]
        self.jkeys = (jrk, jgk)
        self.tkeys = (convert.relin_keys_from_array(self.tc, [_stack(jrk, 2), _stack(jrk, 3)]),
                      convert.galois_keys_from_arrays(self.tc, {e: _stack(jgk, e)
                                                               for e in elts}))
        self.first = self.jc.first_context_data()
        rng = np.random.default_rng(n + len(bits))
        if scheme == "BFV":
            self.values = [rng.integers(0, t, n).tolist() for _ in range(2)]
            self.cts = [self.jenc.encrypt(J.Plaintext.from_coeffs(v)) for v in self.values]
        else:
            self.encoder = J.CKKSEncoder(self.jc)
            slots = n // 2
            self.values = [rng.uniform(-1, 1, slots).tolist() for _ in range(2)]
            self.cts = [self.jenc.encrypt(self.encoder.encode(v, scale)) for v in self.values]
        jev = J.Evaluator(self.jc)
        x, y = self.cts
        self.cts.append(jev.multiply(x, y))                       # size 3
        self.cts.append(jev.multiply(self.cts[2], y))             # size 4

    def carry(self, jct):
        return convert.ciphertext_from_arrays(self.tc, jct.data, jct.parms_id,
                                              jct.is_ntt_form, jct.scale)

    def carry_plain(self, jpt):
        return convert.plaintext_from_array(self.tc, np.asarray(jpt.data), jpt.parms_id,
                                            jpt.scale)

    def namespaces(self, port_evaluator):
        """(JAX namespace, port namespace) of the same operands: ev, x, y,
        x3 (size 3), x4 (size 4), rk (keys for s^2 and s^3), gk (the default
        Galois keys), ctx, plains (a dict of named plaintexts) and M (the
        package)."""
        jns = types.SimpleNamespace(M=J, ev=J.Evaluator(self.jc), ctx=self.jc,
                                    rk=self.jkeys[0], gk=self.jkeys[1])
        tns = types.SimpleNamespace(M=T, ev=port_evaluator, ctx=self.tc,
                                    rk=self.tkeys[0], gk=self.tkeys[1])
        for name, ct in zip(("x", "y", "x3", "x4"), self.cts):
            setattr(jns, name, ct)
            setattr(tns, name, self.carry(ct))
        jns.plains, tns.plains = {}, {}
        for name, jpt in self._plains().items():
            jns.plains[name] = jpt
            tns.plains[name] = self.carry_plain(jpt)
        return jns, tns

    def _plains(self):
        if self.scheme == "BFV":
            t, n = self.t, self.n
            rng = np.random.default_rng(7)
            return {"dense": J.Plaintext.from_coeffs(rng.integers(0, t, n // 2)),
                    "upper": J.Plaintext.from_coeffs([t - 1, 0, (t + 1) // 2, 3]),
                    "small": J.Plaintext.from_coeffs([2]),
                    "mono_low": J.Plaintext.from_coeffs([0] * 5 + [3]),
                    "mono_high": J.Plaintext.from_coeffs([0] * (n - 1) + [t - 2])}
        enc = self.encoder
        pid = self.first.parms_id
        return {"vec": enc.encode(self.values[1], self.scale, pid),
                "one": enc.encode(1.0, self.scale, pid),
                "vec_sq": enc.encode(self.values[1], self.scale ** 2, pid)}


def assert_same(want, got):
    """Exact equality of two packages' outputs: ciphertexts (data, level,
    form and scale), plaintexts, lists of them, or plain values."""
    if isinstance(want, (list, tuple)):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert_same(w, g)
        return
    if isinstance(want, (J.Ciphertext, J.Plaintext)):
        assert tuple(got.parms_id) == tuple(want.parms_id)
        assert got.scale == want.scale
        if isinstance(want, J.Ciphertext):
            assert got.is_ntt_form == want.is_ntt_form
        np.testing.assert_array_equal(np.asarray(want.data, dtype=np.uint64),
                                      to_numpy(got.data))
        return
    assert want == got


RINGS = {
    "bfv_n64_fast_lift": ("BFV", 64, [40, 40, 40], 257),
    "bfv_n256_crt_lift": ("BFV", 256, [20, 50, 50, 50], ("batching", 30)),
    "ckks_n256": ("CKKS", 256, [40, 30, 30, 40], None),
}
_PAIRS = {}


def pair(name) -> Pair:
    """The ring's Pair, made once per test process."""
    if name not in _PAIRS:
        _PAIRS[name] = Pair(*RINGS[name])
        jkg, tc = _PAIRS[name].jkg, _PAIRS[name].tc
        rk1, gk1 = jkg.relin_keys(), jkg.galois_keys_from_steps([1])
        e1 = _PAIRS[name].first.galois_tool.get_elt_from_step(1)
        _PAIRS[name].extra = (
            (rk1, gk1),
            (convert.relin_keys_from_array(tc, _stack(rk1, 2)),
             convert.galois_keys_from_arrays(tc, {e1: _stack(gk1, e1)})))
    return _PAIRS[name]


def spaces(name, port_evaluator=None):
    p = pair(name)
    jns, tns = p.namespaces(port_evaluator or T.Evaluator(p.tc, device="cpu"))
    for ns, (rk1, gk1) in ((jns, p.extra[0]), (tns, p.extra[1])):
        ns.rk1, ns.gk1 = rk1, gk1
        ns.n, ns.t = p.n, p.t
        ns.first, ns.last = p.jc.first_parms_id, p.jc.last_parms_id
        ns.e1, ns.e2 = (p.first.galois_tool.get_elt_from_step(k) for k in (1, 2))
    return jns, tns


def _ntt(s, ct):
    return s.ev.transform_to_ntt(ct)


def _y2(s):
    """y at the scale of x3 (CKKS: y times an encoded 1)."""
    return s.y if s.t else s.ev.multiply_plain(s.y, s.plains["one"])


# op name -> fn(namespace); "bfv"/"ckks"/"both" says which rings run it
OPS = {
    "negate": ("both", lambda s: s.ev.negate(s.x)),
    "add": ("both", lambda s: s.ev.add(s.x, s.y)),
    "sub": ("both", lambda s: s.ev.sub(s.x, s.y)),
    "add_sizes": ("both", lambda s: [s.ev.add(s.x3, _y2(s)), s.ev.add(_y2(s), s.x3)]),
    "sub_sizes": ("both", lambda s: [s.ev.sub(s.x3, _y2(s)), s.ev.sub(_y2(s), s.x3)]),
    "add_many": ("both", lambda s: s.ev.add_many([s.x, s.y, s.x])),
    "multiply": ("both", lambda s: s.ev.multiply(s.x, s.y)),
    "square": ("both", lambda s: s.ev.square(s.x)),
    "multiply_size3": ("both", lambda s: [s.ev.multiply(s.x3, s.y), s.ev.multiply(s.y, s.x3)]),
    "square_size3": ("bfv", lambda s: s.ev.square(s.x3)),
    "relinearize": ("both", lambda s: s.ev.relinearize(s.x3, s.rk)),
    "relinearize_size4": ("both", lambda s: [s.ev.relinearize(s.x4, s.rk),
                                             s.ev._relinearize_internal(s.x4, s.rk, 3)]),
    "mod_switch": ("both", lambda s: [s.ev.mod_switch_to_next(s.x),
                                      s.ev.mod_switch_to(s.x, s.last)]),
    "mod_switch_fused": ("bfv", lambda s: s.ev.mod_switch_to(s.x, s.last, fused=True)),
    "transforms": ("both", lambda s: [_ntt(s, s.x) if not s.x.is_ntt_form
                                      else s.ev.transform_from_ntt(s.x)]),
    "transform_round_trip": ("both", lambda s: (
        s.ev.transform_from_ntt(_ntt(s, s.x)) if not s.x.is_ntt_form
        else _ntt(s, s.ev.transform_from_ntt(s.x)))),
    # BFV plaintext ops, power basis and NTT form
    "add_plain": ("bfv", lambda s: [s.ev.add_plain(s.x, s.plains[k]) for k in ("dense", "upper")]),
    "sub_plain": ("bfv", lambda s: [s.ev.sub_plain(s.x, s.plains[k]) for k in ("dense", "upper")]),
    "multiply_plain": ("bfv", lambda s: [s.ev.multiply_plain(s.x, s.plains[k])
                                         for k in ("dense", "upper")]),
    "multiply_plain_monomial": ("bfv", lambda s: [s.ev.multiply_plain(s.x, s.plains[k])
                                                  for k in ("small", "mono_low", "mono_high")]),
    "multiply_plain_monomial_size3": ("bfv", lambda s: s.ev.multiply_plain(
        s.x3, s.plains["mono_high"])),
    "transform_plain_to_ntt": ("bfv", lambda s: [s.ev.transform_plain_to_ntt(s.plains[k], s.first)
                                                 for k in ("dense", "upper", "mono_high")]),
    "multiply_plain_ntt": ("bfv", lambda s: s.ev.multiply_plain(
        _ntt(s, s.x), s.ev.transform_plain_to_ntt(s.plains["upper"], s.first))),
    "mod_switch_plain": ("bfv", lambda s: s.ev.mod_switch_plain_to(
        s.ev.transform_plain_to_ntt(s.plains["dense"], s.first), s.last)),
    # BFV rotations
    "rotate_rows": ("bfv", lambda s: [s.ev.rotate_rows(s.x, 1, s.gk),
                                      s.ev.rotate_rows(s.x, -1, s.gk)]),
    "rotate_rows_naf": ("bfv", lambda s: s.ev.rotate_rows(s.x, 3, s.gk)),
    "rotate_columns": ("bfv", lambda s: s.ev.rotate_columns(s.x, s.gk)),
    "rotate_rows_many": ("bfv", lambda s: s.ev.rotate_rows_many(s.x, [1, 2, -1], s.gk)),
    "apply_galois_ntt_form": ("bfv", lambda s: s.ev.apply_galois(_ntt(s, s.x), s.e1, s.gk)),
    "multiply_many": ("bfv", lambda s: s.ev.multiply_many([s.x, s.y, s.x], s.rk)),
    "exponentiate": ("bfv", lambda s: [s.ev.exponentiate(s.x, e, s.rk) for e in (1, 3, 4)]),
    # CKKS
    "add_plain_ntt": ("ckks", lambda s: [s.ev.add_plain(s.x, s.plains["vec"]),
                                         s.ev.sub_plain(s.x, s.plains["vec"])]),
    "multiply_plain_ntt_ckks": ("ckks", lambda s: s.ev.multiply_plain(s.x, s.plains["vec"])),
    "rescale": ("ckks", lambda s: [s.ev.rescale_to_next(s.ev.relinearize(s.x3, s.rk)),
                                   s.ev.rescale_to(s.x3, s.last)]),
    "mod_switch_plain_ckks": ("ckks", lambda s: [s.ev.mod_switch_plain_to_next(s.plains["vec"]),
                                                 s.ev.mod_switch_plain_to(s.plains["vec"],
                                                                          s.last)]),
    "rotate_vector": ("ckks", lambda s: [s.ev.rotate_vector(s.x, 1, s.gk),
                                         s.ev.rotate_vector(s.x, -1, s.gk)]),
    "rotate_vector_naf": ("ckks", lambda s: s.ev.rotate_vector(s.x, 3, s.gk)),
    "complex_conjugate": ("ckks", lambda s: s.ev.complex_conjugate(s.x, s.gk)),
    "rotate_vector_many": ("ckks", lambda s: s.ev.rotate_vector_many(s.x, [1, 2, -1], s.gk)),
    "apply_galois_many": ("ckks", lambda s: s.ev.apply_galois_many(
        s.x, [s.e1, 2 * s.n - 1], s.gk)),
    "apply_galois_many_power_basis": ("ckks", lambda s: s.ev.apply_galois_many(
        s.ev.transform_from_ntt(s.x), [s.e2, s.e1], s.gk)),
}


def op_cases(names=None):
    out = []
    for op, (kind, _) in OPS.items():
        if names is not None and op not in names:
            continue
        for ring in RINGS:
            if kind == "both" or ring.startswith(kind):
                out.append(pytest.param(ring, op, id=f"{ring}-{op}"))
    return out


@pytest.mark.parametrize("ring,op", op_cases())
def test_evaluator_op(ring, op):
    jns, tns = spaces(ring)
    fn = OPS[op][1]
    with contiguous_calls():
        got = fn(tns)
    assert_same(fn(jns), got)


def _raises_same(fn, jns, tns):
    with pytest.raises(Exception) as jerr:
        fn(jns)
    with pytest.raises(Exception) as terr:
        fn(tns)
    assert type(terr.value) is type(jerr.value), (terr.value, jerr.value)
    assert str(terr.value) == str(jerr.value)
    return str(jerr.value)


def _zero(s):
    return s.M.Ciphertext.zero(s.ctx.first_context_data())


ERRORS = {
    "parms_mismatch": ("both", lambda s: s.ev.add(s.x, s.ev.mod_switch_to_next(s.y))),
    "ntt_mismatch": ("both", lambda s: s.ev.add(s.x, _ntt(s, s.y)) if not s.y.is_ntt_form
                     else s.ev.add(s.x, s.ev.transform_from_ntt(s.y))),
    "plain_form_mismatch": ("bfv", lambda s: s.ev.multiply_plain(_ntt(s, s.x), s.plains["dense"])),
    "bfv_add_plain_ntt": ("bfv", lambda s: s.ev.add_plain(_ntt(s, s.x), s.plains["dense"])),
    "bfv_sub_plain_ntt": ("bfv", lambda s: s.ev.sub_plain(_ntt(s, s.x), s.plains["dense"])),
    "bfv_square_ntt": ("bfv", lambda s: s.ev.square(_ntt(s, s.x))),
    "bfv_multiply_ntt": ("bfv", lambda s: s.ev.multiply(_ntt(s, s.x), _ntt(s, s.y))),
    "not_enough_relin_keys": ("both", lambda s: s.ev.relinearize(s.x4, s.rk1)),
    "destination_size": ("both", lambda s: s.ev._relinearize_internal(s.x, s.rk, 3)),
    "galois_size3": ("both", lambda s: s.ev.apply_galois(s.x3, s.e1, s.gk)),
    "galois_many_size3": ("both", lambda s: s.ev.apply_galois_many(s.x3, [s.e1], s.gk)),
    "galois_key_absent": ("both", lambda s: s.ev.apply_galois(s.x, s.e2, s.gk1)),
    "galois_many_key_absent": ("both", lambda s: s.ev.apply_galois_many(
        s.x, [s.e1, s.e2], s.gk1)),
    "naf_single_term": ("bfv", lambda s: s.ev.rotate_rows(s.x, 2, s.gk1)),
    "naf_single_term_ckks": ("ckks", lambda s: s.ev.rotate_vector(s.x, 4, s.gk1)),
    "rotate_vector_on_bfv": ("bfv", lambda s: s.ev.rotate_vector(s.x, 1, s.gk)),
    "rotate_rows_on_ckks": ("ckks", lambda s: s.ev.rotate_rows(s.x, 1, s.gk)),
    "rescale_on_bfv": ("bfv", lambda s: s.ev.rescale_to_next(s.x)),
    "multiply_many_on_ckks": ("ckks", lambda s: s.ev.multiply_many([s.x, s.y], s.rk)),
    "end_of_chain": ("both", lambda s: s.ev.mod_switch_to_next(s.ev.mod_switch_to(s.x, s.last))),
    "switch_up": ("both", lambda s: s.ev.mod_switch_to(s.ev.mod_switch_to_next(s.x), s.first)),
    "already_ntt": ("both", lambda s: _ntt(s, s.x) if s.x.is_ntt_form else _ntt(s, _ntt(s, s.x))),
    "not_ntt": ("bfv", lambda s: s.ev.transform_from_ntt(s.x)),
    "plain_not_ntt": ("bfv", lambda s: s.ev.mod_switch_plain_to_next(s.plains["dense"])),
    "plain_already_ntt": ("bfv", lambda s: s.ev.transform_plain_to_ntt(
        s.ev.transform_plain_to_ntt(s.plains["dense"], s.first), s.first)),
    "exponent_zero": ("both", lambda s: s.ev.exponentiate(s.x, 0, s.rk)),
    "empty_multiply_many": ("bfv", lambda s: s.ev.multiply_many([], s.rk)),
    "empty_add_many": ("both", lambda s: s.ev.add_many([])),
    "transparent": ("both", lambda s: s.ev.multiply(_zero(s), _zero(s)) if s.t
                    else s.ev.multiply(s.ev.transform_to_ntt(_zero(s)),
                                       s.ev.transform_to_ntt(_zero(s)))),
    "scale_mismatch": ("ckks", lambda s: s.ev.add(s.x, s.x3)),
    "scale_out_of_bounds": ("ckks", lambda s: s.ev.multiply(s.x4, s.x4)),
    "ckks_add_plain_power_basis": ("ckks", lambda s: s.ev.add_plain(
        s.ev.transform_from_ntt(s.x), s.plains["vec"])),
    "plain_parms_mismatch": ("ckks", lambda s: s.ev.add_plain(s.ev.mod_switch_to_next(s.x),
                                                              s.plains["vec"])),
    "plain_scale_mismatch": ("ckks", lambda s: s.ev.sub_plain(s.x, s.plains["vec_sq"])),
    "multiply_plain_parms": ("ckks", lambda s: s.ev.multiply_plain(s.ev.mod_switch_to_next(s.x),
                                                                   s.plains["vec"])),
    "ckks_multiply_power_basis": ("ckks", lambda s: s.ev.multiply(
        s.ev.transform_from_ntt(s.x), s.ev.transform_from_ntt(s.y))),
    "ckks_square_power_basis": ("ckks", lambda s: s.ev.square(s.ev.transform_from_ntt(s.x))),
    "ckks_rescale_power_basis": ("ckks", lambda s: s.ev.rescale_to_next(
        s.ev.transform_from_ntt(s.x))),
}


@pytest.mark.parametrize("ring,case", [
    pytest.param(ring, case, id=f"{ring}-{case}")
    for case, (kind, _) in ERRORS.items() for ring in RINGS
    if kind == "both" or ring.startswith(kind)])
def test_evaluator_errors(ring, case):
    jns, tns = spaces(ring)
    _raises_same(ERRORS[case][1], jns, tns)


@pytest.mark.parametrize("ring", [r for r in RINGS if r.startswith("bfv")])
def test_invariant_noise_budget(ring):
    p = pair(ring)
    jns, tns = spaces(ring)
    for fn in (lambda s: s.x, lambda s: s.ev.relinearize(s.x3, s.rk),
               lambda s: s.ev.multiply_plain(s.x, s.plains["mono_high"]),
               lambda s: s.ev.mod_switch_to_next(s.x)):
        want = p.jdec.invariant_noise_budget(fn(jns))
        assert p.tdec.invariant_noise_budget(fn(tns)) == want
    assert p.tdec.invariant_noise_budget(tns.x) > 0
    with pytest.raises(ValueError, match="encrypted cannot be in NTT form"):
        p.tdec.invariant_noise_budget(_ntt(tns, tns.x))
    ck = pair("ckks_n256")
    with pytest.raises(ValueError, match="unsupported scheme"):
        ck.tdec.invariant_noise_budget(ck.carry(ck.cts[0]))


@pytest.mark.parametrize("value", [0, 1, 5, -7, 123456, -(2 ** 40) + 3])
def test_integer_encoder(value):
    p = pair("bfv_n64_fast_lift")
    jenc, tenc = J.IntegerEncoder(p.jc), T.IntegerEncoder(p.tc, device="cpu")
    jpt, tpt = jenc.encode(value), tenc.encode(value)
    np.testing.assert_array_equal(np.asarray(jpt.data), to_numpy(tpt.data))
    assert tenc.decode(tpt) == value == jenc.decode(jpt)
    # encrypted add (examples/ex2_encoders.py): the port adds and decrypts
    c1 = p.carry(p.jenc.encrypt(jenc.encode(value)))
    c2 = p.carry(p.jenc.encrypt(jenc.encode(-7)))
    total = T.Evaluator(p.tc, device="cpu").add(c1, c2)
    assert tenc.decode(p.tdec.decrypt(total)) == value - 7
    with pytest.raises(ValueError, match="unsupported scheme"):
        T.IntegerEncoder(pair("ckks_n256").tc, device="cpu")


@pytest.mark.parametrize("text", ["6", "1", "0", "", "5x^2 + 3x^1 + 1", "Fx^63 + 1x^7 + ab",
                                  "3x + 2", "x^3"])
def test_plaintext_helpers(text):
    jpt, tpt = J.Plaintext.from_hex(text), T.Plaintext.from_hex(text, device="cpu")
    np.testing.assert_array_equal(np.asarray(jpt.data), to_numpy(tpt.data))
    assert tpt.to_hex() == jpt.to_hex()
    assert tpt.coeff_count == jpt.coeff_count
    assert tpt.significant_coeff_count() == jpt.significant_coeff_count()
    back = T.Plaintext.from_hex(tpt.to_hex(), device="cpu")
    assert back.to_hex() == tpt.to_hex()
    coeffs = T.Plaintext.from_coeffs([1, 0, 2, 0, 0], device="cpu")
    assert coeffs.significant_coeff_count() == 3 and coeffs.coeff_count == 5


def test_ciphertext_helpers():
    p = pair("bfv_n64_fast_lift")
    cd = p.tc.first_context_data()
    zero = T.Ciphertext.zero(cd)
    jzero = J.Ciphertext.zero(p.first)
    np.testing.assert_array_equal(np.asarray(jzero.data), to_numpy(zero.data))
    assert zero.is_transparent() and jzero.is_transparent()
    assert T.Ciphertext.zero(cd, size=3, is_ntt_form=True).is_ntt_form
    ct = p.carry(p.cts[0])
    assert not ct.is_transparent()
    copy = ct.copy()
    copy.scale = 4.0                 # a mutable dataclass, as in the JAX package
    assert ct.scale == 1.0 and copy.data is ct.data
    with pytest.raises(ValueError, match="invalid ciphertext size"):
        T.Ciphertext.zero(cd, size=1)
    # data on the card counts as device data: no host check, no sync
    device_data = types.SimpleNamespace(shape=zero.data.shape,
                                        device=types.SimpleNamespace(type="cuda"))
    assert not T.Ciphertext(device_data, zero.parms_id).is_transparent()


def test_ex1_flow_n1024():
    """examples/ex1_bfv_basics.py at N=1024 through both packages, every
    intermediate ciphertext and noise budget compared: 4(x^2+1)(x+1)^2 at x=6
    decrypts 84 mod 1024, with the monomial multiply_plain by "4"."""
    pairs = []
    for M, kw in ((J, {}), (T, {"device": "cpu"})):
        parms = M.EncryptionParameters(M.SchemeType.BFV)
        parms.set_poly_modulus_degree(1024)
        parms.set_coeff_modulus(M.CoeffModulus.create(1024, [40, 40, 40]))
        parms.set_plain_modulus(1024)
        parms.set_random_seed(tuple(range(8)))
        pairs.append(M.SealContext(parms, sec_level=M.SecLevelType.none, **kw))
    jc, tc = pairs
    jkg = J.KeyGenerator(jc)
    jrk = jkg.relin_keys()
    jenc, jev = J.Encryptor(jc, public_key=jkg.public_key()), J.Evaluator(jc)
    jdec = J.Decryptor(jc, jkg.secret_key)
    trk = convert.relin_keys_from_array(tc, _stack(jrk, 2))
    tev = T.Evaluator(tc, device="cpu")
    tdec = T.Decryptor(tc, convert.secret_key_from_array(tc, jkg.secret_key.data),
                       device="cpu")

    def flow(M, ev, rk, x, check):
        P = (lambda h: M.Plaintext.from_hex(h, device="cpu")) if M is T else M.Plaintext.from_hex
        a = check(ev.add_plain(check(ev.relinearize(check(ev.square(x)), rk)), P("1")))
        xp1 = check(ev.add_plain(x, P("1")))
        b = check(ev.relinearize(check(ev.square(xp1)), rk))
        r = check(ev.multiply_plain(a, P("4")))
        return check(ev.relinearize(check(ev.multiply(r, b)), rk))

    jx = jenc.encrypt(J.Plaintext.from_hex("6"))
    jsteps = []
    jr = flow(J, jev, jrk, jx, lambda c: jsteps.append(c) or c)
    tsteps = []
    with contiguous_calls():
        tr = flow(T, tev, trk, convert.ciphertext_from_arrays(
            tc, jx.data, jx.parms_id, False, 1.0), lambda c: tsteps.append(c) or c)
    assert len(tsteps) == len(jsteps) == 9
    for want, got in zip(jsteps, tsteps):
        assert_same(want, got)
        assert tdec.invariant_noise_budget(got) == jdec.invariant_noise_budget(want)
    assert tdec.invariant_noise_budget(tr) > 0
    assert int(to_numpy(tdec.decrypt(tr).data)[0]) == 4 * 37 * 49 % 1024 == 84
