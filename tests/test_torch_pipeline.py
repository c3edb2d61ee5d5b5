"""The port's CKKS path against the JAX package, end to end on the CPU.

Under the pinned seed the parms_id, secret key, public key, relin key,
encoding and ciphertext are equal; the fused multiply + relinearize +
rescale step equals the JAX fused step bit for bit, in the multiply and
square forms; convert.py carries JAX-made keys and ciphertexts into the
same step output; decrypt + decode lands within 1e-4 of v^2.
"""

import jax
import numpy as np
import pytest
import torch

import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu.models.pipelines import build_ckks_mul_relin_rescale as jax_step
from gemini_seal_tpu_torch import convert
from gemini_seal_tpu_torch.ops.backend import to_numpy
from torch_helpers import one_torch_thread  # noqa: F401

SEED = tuple(range(71, 79))
BITS = [50, 40, 40, 50]  # bench.py's chain, cut to N <= 1024
SCALE = 2.0 ** 40
VALS = [0.5, -1.25, 3.0, 1.001, -0.75]


def _setup(M, n, **kw):
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(M.CoeffModulus.create(n, BITS))
    parms.set_random_seed(SEED)
    ctx = M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)
    return ctx


@pytest.fixture(scope="module", params=[256, 1024])
def both(request):
    n = request.param
    jctx, tctx = _setup(J, n), _setup(T, n, device="cpu")
    jkg, tkg = J.KeyGenerator(jctx), T.KeyGenerator(tctx, device="cpu")
    jrk = np.stack([np.asarray(pk.data.data) for pk in jkg.relin_keys().key(2)])
    trk = tkg.relin_keys().stacked(2)
    jenc = J.CKKSEncoder(jctx)
    tenc = T.CKKSEncoder(tctx, device="cpu")
    jplain, tplain = jenc.encode(VALS, SCALE), tenc.encode(VALS, SCALE)
    jct = J.Encryptor(jctx, public_key=jkg.public_key()).encrypt(jplain)
    tct = T.Encryptor(tctx, tkg.public_key(), device="cpu").encrypt(tplain)
    # one jit per form and ring, shared by the tests below
    jsteps = {sq: jax.jit(jax_step(jctx, fused=True, square=sq)) for sq in (False, True)}
    return dict(n=n, jctx=jctx, tctx=tctx, jkg=jkg, tkg=tkg, jrk=jrk, trk=trk,
                jenc=jenc, tenc=tenc, jplain=jplain, tplain=tplain, jct=jct, tct=tct,
                jsteps=jsteps)


def test_host_plane_equal(both):
    b = both
    assert b["jctx"].key_parms_id == b["tctx"].key_parms_id
    assert b["jctx"].first_parms_id == b["tctx"].first_parms_id
    np.testing.assert_array_equal(b["jkg"].secret_key.data, to_numpy(b["tkg"].secret_key.data))
    np.testing.assert_array_equal(b["jkg"].public_key().data.data,
                                  to_numpy(b["tkg"].public_key().data.data))
    np.testing.assert_array_equal(b["jrk"], to_numpy(b["trk"]))
    np.testing.assert_array_equal(b["jplain"].data, to_numpy(b["tplain"].data))
    np.testing.assert_array_equal(b["jct"].data, to_numpy(b["tct"].data))
    assert b["tct"].parms_id == b["jct"].parms_id and b["tct"].scale == b["jct"].scale


def _next_level(b):
    cd = b["tctx"].first_context_data()
    q_last = cd.parms.coeff_modulus[-1].value
    return cd.next_context_data.parms_id, SCALE * SCALE / q_last


@pytest.mark.parametrize("square", [False, True])
def test_fused_step_equal_and_decodes(both, square):
    b = both
    a = np.stack([np.asarray(b["jct"].data)] * 2)
    jfn = b["jsteps"][square]
    want = np.asarray(jfn(a, b["jrk"]) if square else jfn(a, a, b["jrk"]))
    ta = torch.stack([b["tct"].data] * 2)
    tfn = T.build_ckks_mul_relin_rescale(b["tctx"], fused=True, square=square,
                                         device="cpu")
    got = tfn(ta, b["trk"]) if square else tfn(ta, ta, b["trk"])
    np.testing.assert_array_equal(want, to_numpy(got))

    pid, scale = _next_level(b)
    dec = T.Decryptor(b["tctx"], b["tkg"].secret_key, device="cpu")
    vals = b["tenc"].decode(dec.decrypt(T.Ciphertext(got[1], pid, True, scale)))
    for g, v in zip(vals, VALS):
        assert abs(g - v * v) < 1e-4, (g, v * v)


def test_convert_carries_jax_objects_into_the_step(both):
    b = both
    tctx = b["tctx"]
    jct = b["jct"]
    ct = convert.ciphertext_from_arrays(tctx, jct.data, jct.parms_id, jct.is_ntt_form,
                                        jct.scale)
    rk = convert.relin_keys_from_array(tctx, b["jrk"])
    sk = convert.secret_key_from_array(tctx, b["jkg"].secret_key.data)
    step = T.build_ckks_mul_relin_rescale(tctx, fused=True, device="cpu")
    ta = torch.stack([ct.data] * 2)  # the batch shape the jitted step saw
    got = step(ta, ta, rk.stacked(2))
    a = np.stack([np.asarray(jct.data)] * 2)
    want = np.asarray(b["jsteps"][False](a, a, b["jrk"]))
    np.testing.assert_array_equal(want, to_numpy(got))

    pid, scale = _next_level(b)
    dec = T.Decryptor(tctx, sk, device="cpu")
    vals = b["tenc"].decode(dec.decrypt(T.Ciphertext(got[0], pid, True, scale)))
    jdec = J.Decryptor(b["jctx"], b["jkg"].secret_key)
    jvals = b["jenc"].decode(jdec.decrypt(J.Ciphertext(want[0], pid, True, scale)))
    assert vals == jvals
    with pytest.raises(ValueError):
        convert.relin_keys_from_array(tctx, b["jrk"][:, :, :2])
