"""The port's Galois automorphisms and rotations against the JAX package on
the CPU: GaloisTool's element maps and NTT permutation tables,
apply_galois_ntt, Galois keys (made after the relin keys under the pinned
seed), build_ckks_rotate and build_ckks_rotate_many, exact equality (the
counter-rotated-key form: equal decodes).
"""

import jax
import numpy as np
import pytest
import torch

import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu.models.pipelines import build_ckks_rotate as jax_rotate
from gemini_seal_tpu.models.pipelines import build_ckks_rotate_many as jax_rotate_many
from gemini_seal_tpu.ops.galois import GaloisTool as JaxGaloisTool
from gemini_seal_tpu_torch import convert
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from gemini_seal_tpu_torch.ops.galois import GaloisTool, galois_permute
from gemini_seal_tpu_torch.utils.numth import get_primes

SEED = tuple(range(51, 59))
BITS = [40, 30, 40]      # __graft_entry__.entry()'s ring
STEPS = (1, 2, 3)        # rotate-many at R=3


@pytest.mark.parametrize("log_n", [8, 10])
@pytest.mark.parametrize("step", [1, -1, 3, "conj"])
def test_ntt_table_and_apply_galois_ntt(log_n, step):
    n = 1 << log_n
    jtool, ttool = JaxGaloisTool(log_n), GaloisTool(log_n, "cpu")
    assert ttool.get_elts_all() == jtool.get_elts_all()
    elt = 2 * n - 1 if step == "conj" else jtool.get_elt_from_step(step)
    assert ttool.get_elt_from_step(0 if step == "conj" else step) == elt
    np.testing.assert_array_equal(ttool._ntt_table(elt), jtool._ntt_table(elt))

    rng = np.random.default_rng(log_n)
    mods = get_primes(2 * n, 40, 3)
    x = np.stack([rng.integers(0, p, size=(2, n), dtype=np.uint64) for p in mods], axis=1)
    want = np.asarray(jtool.apply_galois_ntt(x, elt))
    got = ttool.apply_galois_ntt(to_tensor(x, "cpu"), elt)
    np.testing.assert_array_equal(want, to_numpy(got))
    # several tables in one call: [..., R, rows, N]
    tabs = ttool.ntt_tables([elt, jtool.get_elt_from_step(2)])
    both = galois_permute(to_tensor(x, "cpu"), tabs)
    assert both.shape == (2, 2, 3, n)
    np.testing.assert_array_equal(want, to_numpy(both[:, 0]))
    with pytest.raises(ValueError):
        ttool.apply_galois_ntt(to_tensor(x, "cpu"), 2 * n)


def _setup(M, **kw):
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(1024)
    parms.set_coeff_modulus(M.CoeffModulus.create(1024, BITS))
    parms.set_random_seed(SEED)
    ctx = M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)
    return ctx, M.KeyGenerator(ctx, **kw)


@pytest.fixture(scope="module")
def keys():
    (jctx, jkg), (tctx, tkg) = _setup(J), _setup(T, device="cpu")
    tool = jctx.first_context_data().galois_tool
    elts = tool.get_elts_from_steps(list(STEPS))
    # the JAX order: relin keys first, then Galois keys in element order
    jrk, trk = jkg.relin_keys(), tkg.relin_keys()
    jgk = jkg.galois_keys(elts + [elts[0], 2 * 1024 - 1])
    tgk = tkg.galois_keys(elts + [elts[0], 2 * 1024 - 1])
    jstack = np.stack([np.stack([np.asarray(pk.data.data) for pk in jgk.key(e)])
                       for e in elts])
    enc = J.Encryptor(jctx, public_key=jkg.public_key())
    vals = [0.5, -1.25, 2.0, 0.75]
    jct = enc.encrypt(J.CKKSEncoder(jctx).encode(vals, 2.0 ** 30))
    return dict(jctx=jctx, tctx=tctx, jkg=jkg, tkg=tkg, jrk=jrk, trk=trk, jgk=jgk,
                tgk=tgk, elts=elts, jstack=jstack, jct=jct, vals=vals)


def test_galois_keys_equal(keys):
    k = keys
    np.testing.assert_array_equal(np.stack([np.asarray(pk.data.data) for pk in k["jrk"].key(2)]),
                                  to_numpy(k["trk"].stacked(2)))
    conj = 2 * 1024 - 1
    for e in k["elts"] + [conj]:
        assert k["tgk"].has_key(e) and k["tgk"].get_index(e) == k["jgk"].get_index(e)
        want = np.stack([np.asarray(pk.data.data) for pk in k["jgk"].key(e)])
        np.testing.assert_array_equal(want, to_numpy(k["tgk"].stacked(e)))
    assert k["tgk"].size() == k["jgk"].size() == len(k["elts"]) + 1
    assert not k["tgk"].has_key(7)
    np.testing.assert_array_equal(k["jstack"], to_numpy(k["tgk"].stacked(*k["elts"])))
    from_steps = k["tkg"].galois_keys_from_steps([STEPS[0]])
    torch.testing.assert_close(from_steps.stacked(k["elts"][0]), k["tgk"].stacked(k["elts"][0]),
                               rtol=0, atol=0)
    carried = convert.galois_keys_from_arrays(k["tctx"], {k["elts"][1]: k["jstack"][1]})
    np.testing.assert_array_equal(k["jstack"][1], to_numpy(carried.stacked(k["elts"][1])))
    with pytest.raises(ValueError):
        convert.galois_keys_from_arrays(k["tctx"], {k["elts"][1]: k["jstack"][1][:, :, :2]})


def test_rotate_equal(keys):
    k = keys
    a = np.stack([np.asarray(k["jct"].data)] * 2)
    want = np.asarray(jax.jit(jax_rotate(k["jctx"], STEPS[0]))(a, k["jstack"][0]))
    step = T.build_ckks_rotate(k["tctx"], STEPS[0], device="cpu")
    got = step(to_tensor(a, "cpu"), k["tgk"].stacked(k["elts"][0]))
    np.testing.assert_array_equal(want, to_numpy(got))


def test_rotate_many_equal_and_decodes(keys):
    k = keys
    a = np.stack([np.asarray(k["jct"].data)] * 2)
    want = np.asarray(jax.jit(jax_rotate_many(k["jctx"], list(STEPS)))(a, k["jstack"]))
    step = T.build_ckks_rotate_many(k["tctx"], list(STEPS), device="cpu")
    got = step(to_tensor(a, "cpu"), k["tgk"].stacked(*k["elts"]))
    assert got.shape == (len(STEPS), 2, 2, 2, 1024)
    np.testing.assert_array_equal(want, to_numpy(got))

    tctx = k["tctx"]
    dec = T.Decryptor(tctx, k["tkg"].secret_key, device="cpu")
    enc = T.CKKSEncoder(tctx, device="cpu")
    vals = k["vals"] + [0.0] * 4
    # the counter-rotated-key form decodes equal to the default form
    pstack = T.prepermute_galois_stack(tctx.first_context_data().galois_tool, k["elts"],
                                       k["tgk"].stacked(*k["elts"]))
    pgot = T.build_ckks_rotate_many(tctx, list(STEPS), prepermuted_keys=True,
                                    device="cpu")(to_tensor(a, "cpu"), pstack)
    assert pgot.shape == got.shape
    for r, s in enumerate(STEPS):
        out, pout = (enc.decode(dec.decrypt(T.Ciphertext(g[r, 1], k["jct"].parms_id, True,
                                                         k["jct"].scale)))
                     for g in (got, pgot))
        for i in range(len(k["vals"])):
            assert abs(out[i] - vals[i + s]) < 1e-3, (s, out[: len(k["vals"])])
        assert max(abs(x - y) for x, y in zip(out, pout)) < 1e-5
