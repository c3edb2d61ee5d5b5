"""The port's DeviceEvaluator against the JAX package, exact equality: each
op of its surface against the JAX host ``Evaluator`` (as the JAX package's
tests/test_device_evaluator.py holds its own DeviceEvaluator), batched
ciphertext data against the per-ciphertext results, the key cache, the
validations, and ``multiply_relin_rescale`` / ``square_relin_rescale``
against the JAX ``build_ckks_mul_relin_rescale`` of the same form (fused
by default), run eagerly on numpy.  The rings and operands are
tests/test_torch_evaluator.py's.
"""

import numpy as np
import pytest
import torch

import gemini_seal_tpu as J
from gemini_seal_tpu.models import pipelines as jp
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.ops.backend import to_numpy
from test_torch_evaluator import ERRORS, OPS, RINGS, _raises_same, assert_same, pair, spaces
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

# the ops of the Evaluator table that the DeviceEvaluator's surface has
DEVICE_OPS = ("negate", "add", "sub", "add_sizes", "sub_sizes", "add_many", "multiply",
              "square", "multiply_size3", "square_size3", "relinearize", "mod_switch",
              "transforms", "transform_round_trip", "add_plain", "sub_plain",
              "multiply_plain", "multiply_plain_monomial",
              "rotate_rows", "rotate_rows_naf", "rotate_columns", "rotate_rows_many",
              "apply_galois_ntt_form", "multiply_many", "exponentiate", "add_plain_ntt",
              "multiply_plain_ntt_ckks", "rescale", "rotate_vector", "rotate_vector_naf",
              "complex_conjugate", "rotate_vector_many")
DEVICE_ERRORS = ("parms_mismatch", "ntt_mismatch", "galois_size3", "galois_key_absent",
                 "naf_single_term", "naf_single_term_ckks", "end_of_chain", "switch_up",
                 "already_ntt", "exponent_zero", "empty_multiply_many", "empty_add_many",
                 "scale_mismatch", "scale_out_of_bounds", "plain_parms_mismatch",
                 "plain_scale_mismatch", "multiply_plain_parms", "ckks_square_power_basis")


def _device(ring):
    return spaces(ring, T.DeviceEvaluator(pair(ring).tc, device="cpu"))


# the DeviceEvaluator checks equal scales before a multiply, as the JAX class
# does (the Evaluator checks only the level): x3 (scale^2) times y raises
NOT_ON_DEVICE = {("ckks_n256", "multiply_size3")}


def _cases(table, names):
    return [pytest.param(ring, name, id=f"{ring}-{name}") for name in names
            for ring in RINGS if (table[name][0] == "both" or ring.startswith(table[name][0]))
            and (ring, name) not in NOT_ON_DEVICE]


@pytest.mark.parametrize("ring,op", _cases(OPS, DEVICE_OPS))
def test_device_op_matches_host(ring, op):
    jns, tns = _device(ring)
    fn = OPS[op][1]
    with contiguous_calls():
        got = fn(tns)
    assert_same(fn(jns), got)


@pytest.mark.parametrize("ring,case", _cases(ERRORS, DEVICE_ERRORS))
def test_device_errors(ring, case):
    jns, tns = _device(ring)
    _raises_same(ERRORS[case][1], jns, tns)


def test_batched_data():
    """[B, size, L, N] data through the CKKS device ops (the BFV multiply goes
    to the Evaluator, which takes one ciphertext) equals the stacked
    per-ciphertext results of the Evaluator."""
    _, tns = _device("ckks_n256")
    dev, tev = tns.ev, T.Evaluator(tns.ctx, device="cpu")

    def batch(*cts):
        return T.Ciphertext(torch.stack([c.data for c in cts]), cts[0].parms_id, True,
                            cts[0].scale)

    def chain(ev, x, y):
        one = ev.relinearize(ev.multiply(x, y), tns.rk)
        down = ev.rescale_to_next(one)
        return [one, down, ev.rotate_vector(down, 1, tns.gk), ev.add(one, one)]

    outs = chain(dev, batch(tns.x, tns.y), batch(tns.y, tns.x))
    for b, (x, y) in enumerate(((tns.x, tns.y), (tns.y, tns.x))):
        for w, o in zip(chain(tev, x, y), outs):
            assert torch.equal(o.data[b], w.data) and o.parms_id == w.parms_id


def test_put_get_and_key_cache():
    jns, tns = _device("ckks_n256")
    dev = tns.ev
    got = dev.get(dev.put(tns.x))
    assert got.data.device.type == "cpu" and torch.equal(got.data, tns.x.data)
    a = dev._key_data(tns.rk, 2)
    assert dev._key_data(tns.rk, 2) is a                      # cached per (keys, index)
    other = T.RelinKeys()
    other.keys, other.parms_id = list(tns.rk.keys), tns.rk.parms_id
    b = dev._key_data(other, 2)
    assert b is not a and torch.equal(a, b)                   # another object: its own entry
    dev.multiply_relin_rescale(tns.x, tns.y, tns.rk)
    dev.multiply_relin_rescale(tns.x, tns.y, tns.rk)
    assert len(dev._mrr_cache) == 1                           # one plan per level and form
    assert dev.host.device == dev.device


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("square", [False, True])
def test_mul_relin_rescale_one_call(fused, square, monkeypatch):
    """Fused (the default) against the JAX fused pipeline on numpy; the
    sequential form against the host chain, which it equals bit for bit."""
    monkeypatch.setattr(jp, "jnp", np)
    jns, tns = _device("ckks_n256")
    p = pair("ckks_n256")
    dev = tns.ev
    with contiguous_calls():
        if square:
            got = dev.square_relin_rescale(tns.x, tns.rk, fused=fused)
        else:
            got = dev.multiply_relin_rescale(tns.x, tns.y, tns.rk, fused=fused)
    y = jns.x if square else jns.y
    nxt = p.first.next_context_data
    if fused:
        rk = np.stack([np.asarray(pk.data.data) for pk in jns.rk.key(2)])
        step = jp.build_ckks_mul_relin_rescale(p.jc, fused=True, square=square)
        data = step(np.asarray(jns.x.data), rk) if square else step(
            np.asarray(jns.x.data), np.asarray(y.data), rk)
        want = J.Ciphertext(data, nxt.parms_id, True,
                            jns.x.scale * y.scale / p.first.parms.coeff_modulus[-1].value)
    else:
        ev = jns.ev
        want = ev.rescale_to_next(ev.relinearize(ev.multiply(jns.x, y), jns.rk))
    assert_same(want, got)
    # the fused form decrypts as the sequential chain does
    dec = p.tdec.decrypt(got)
    seq = p.jdec.decrypt(jns.ev.rescale_to_next(jns.ev.relinearize(
        jns.ev.multiply(jns.x, y), jns.rk)))
    a = p.encoder.decode(seq)
    b = np.asarray(p.encoder.decode(J.Plaintext(to_numpy(dec.data), dec.parms_id, dec.scale)))
    assert np.abs(np.asarray(a) - b).max() < 1e-4


def test_mul_relin_rescale_checks():
    _, tns = _device("ckks_n256")
    dev = tns.ev
    with pytest.raises(ValueError, match="operands must be size-2 ciphertexts"):
        dev.multiply_relin_rescale(tns.x3, tns.y, tns.rk)
    with pytest.raises(ValueError, match="CKKS operands must be in NTT form"):
        dev.multiply_relin_rescale(dev.transform_from_ntt(tns.x), tns.y, tns.rk)
    last = dev.mod_switch_to(tns.x, tns.last)
    with pytest.raises(ValueError, match="end of modulus switching chain reached"):
        dev.square_relin_rescale(last, tns.rk)
    _, bns = _device("bfv_n64_fast_lift")
    with pytest.raises(ValueError, match="multiply_relin_rescale is a CKKS op"):
        bns.ev.multiply_relin_rescale(bns.x, bns.y, bns.rk)
