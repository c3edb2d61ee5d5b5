"""The port's flagship step against the JAX package on the CPU.

gemini_seal_tpu_torch.entry() against __graft_entry__.entry(): the example
tensors (ciphertexts, relin key, Galois key) and the train step's output
(sequential multiply + relinearize + rescale, rotate by one, add) are equal
bit for bit, and the output decodes to v_i w_i + v_{i+1} w_{i+1}.  The
sequential build_ckks_mul_relin_rescale (multiply and square) on the same
ring equals the JAX package's default (fused=False) step, and differs from
the fused form.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as G
import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu.models.pipelines import build_ckks_mul_relin_rescale as jax_step
from gemini_seal_tpu_torch.entry import _build
from gemini_seal_tpu_torch.ops.backend import to_numpy
from torch_helpers import one_torch_thread  # noqa: F401

SEED = tuple(range(51, 59))
BITS = [40, 30, 40]
VALS = [0.5, -1.25, 2.0]   # entry()'s values; ct_b encrypts them reversed


@pytest.fixture(scope="module")
def flagship():
    jfn, jargs = G.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    tfn, targs = T.entry(device="cpu")
    _, _, tctx = _build(n=1024, bits=BITS, seed=SEED, device="cpu")
    parms = J.EncryptionParameters(J.SchemeType.CKKS)
    parms.set_poly_modulus_degree(1024)
    parms.set_coeff_modulus(J.CoeffModulus.create(1024, BITS))
    parms.set_random_seed(SEED)
    jctx = J.SealContext(parms, sec_level=J.SecLevelType.none)
    return dict(jargs=jargs, want=want, tfn=tfn, targs=targs, tctx=tctx, jctx=jctx)


def test_entry_step_equal_and_decodes(flagship):
    f = flagship
    for j, t in zip(f["jargs"], f["targs"]):
        np.testing.assert_array_equal(np.asarray(j), to_numpy(t))
    got = f["tfn"](*f["targs"])
    np.testing.assert_array_equal(f["want"], to_numpy(got))

    tctx = f["tctx"]
    cd = tctx.first_context_data()
    scale = 2.0 ** 60 / cd.parms.coeff_modulus[-1].value
    sk = T.KeyGenerator(tctx, device="cpu").secret_key
    out = T.CKKSEncoder(tctx, device="cpu").decode(T.Decryptor(tctx, sk, device="cpu").decrypt(
        T.Ciphertext(got, cd.next_context_data.parms_id, True, scale)))
    prod = [v * w for v, w in zip(VALS, VALS[::-1])] + [0.0]
    for i in range(len(VALS)):
        assert abs(out[i] - (prod[i] + prod[i + 1])) < 1e-3, out[: len(VALS)]


@pytest.mark.parametrize("square", [False, True])
def test_sequential_step_equal(flagship, square):
    """The JAX step squares bit-exactly like it multiplies identical
    operands, so one jitted multiply of (a, a) is the reference for both
    forms (distinct operands run through the train step above)."""
    f = flagship
    a, _, rk, _ = f["jargs"]
    if "want_aa" not in f:
        f["want_aa"] = np.asarray(jax.jit(jax_step(f["jctx"]))(a, a, rk))
    ta, _, trk, _ = f["targs"]
    tfn = T.build_ckks_mul_relin_rescale(f["tctx"], square=square, device="cpu")
    got = tfn(ta, trk) if square else tfn(ta, ta, trk)
    np.testing.assert_array_equal(f["want_aa"], to_numpy(got))
    fused = T.build_ckks_mul_relin_rescale(f["tctx"], fused=True, square=square,
                                           device="cpu")
    other = fused(ta, trk) if square else fused(ta, ta, trk)
    assert other.shape == got.shape and not torch.equal(other, got)
