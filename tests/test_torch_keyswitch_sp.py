"""The port's limb-sharded key switch (gemini_seal_tpu_torch.parallel.
keyswitch_sp) against the JAX package's schedules on root conftest.py's
virtual mesh, bit for bit: the one-gather switch in the NTT form (CKKS) and
the power basis (BFV), the mul + relin + rescale step with its zeroed
q_last row, the hoisted rotations in both schemes, and the (dp=2, limb=2)
layout against the JAX step; with the JAX package's collective profile
(tests/test_keyswitch_sp.py:89-110): one all_gather of n_ct rows a switch
and nothing else, one more 2-row psum a step.  Inputs come from the port
(keys and ciphertexts equal to the JAX package's under the pinned seed) and
enter both as numpy arrays.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu.models.pipelines import build_ckks_mul_relin_rescale as j_mrr
from gemini_seal_tpu.ops import keyswitch as jk
from gemini_seal_tpu.parallel import keyswitch_sp as jsp
from gemini_seal_tpu_torch.ops import keyswitch as tk
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from gemini_seal_tpu_torch.parallel import keyswitch_sp as tsp
from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd
from gemini_seal_tpu_torch.parallel.mesh import make_he_mesh, shard, unshard
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

SEED = tuple(range(91, 99))


def _contexts(scheme, n, bits, nsp=1, t=None):
    out = []
    for M, kw in ((J, {}), (T, {"device": "cpu"})):
        parms = M.EncryptionParameters(getattr(M.SchemeType, scheme))
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(M.CoeffModulus.create(n, list(bits)))
        if scheme == "CKKS":
            parms.set_n_special_primes(nsp)
        else:
            parms.set_plain_modulus(t)
        parms.set_random_seed(SEED)
        out.append(M.SealContext(parms, sec_level=M.SecLevelType.none, **kw))
    return out


@pytest.fixture(scope="module")
def ckks64():
    """N=64, [30] * 5, one special prime (the JAX tests' small case): the
    port's keys and two ciphertexts, batch 2."""
    jctx, tctx = _contexts("CKKS", 64, [30] * 5)
    kg = T.KeyGenerator(tctx, device="cpu")
    enc = T.Encryptor(tctx, kg.public_key(), device="cpu")
    encoder = T.CKKSEncoder(tctx, device="cpu")
    a = torch.stack([enc.encrypt(encoder.encode([0.5 * (i + 1), -1.0], 2.0 ** 25)).data
                     for i in range(2)])
    b = torch.stack([enc.encrypt(encoder.encode([1.5, 0.25 * i], 2.0 ** 25)).data
                     for i in range(2)])
    return {"jctx": jctx, "tctx": tctx, "kg": kg, "a": a, "b": b,
            "rk": kg.relin_keys().stacked(2),
            "jplan": jk.KeySwitchPlan(jctx, jctx.first_parms_id),
            "tplan": tk.KeySwitchPlan(tctx, tctx.first_parms_id)}


def _limb_mesh(C):
    return Mesh(np.asarray(jax.devices()[:C]), axis_names=("limb",))


def _rows(x, C):
    r = x.shape[-2] // C
    return [x[..., i * r:(i + 1) * r, :].contiguous() for i in range(C)]


def _run(fn, C, *per_rank, mesh=None):
    team = ThreadGroup(C, "cpu", mesh=mesh)
    with contiguous_calls():
        outs = run_spmd(fn, team, *per_rank)
    return outs, team.stats


@pytest.mark.parametrize("scheme", ["CKKS", "BFV"])
def test_switch_one_gather(scheme, ckks64):
    C = 4
    if scheme == "CKKS":
        jplan, tplan, rk = ckks64["jplan"], ckks64["tplan"], ckks64["rk"]
        target = ckks64["a"][0, 1]                                   # [n_ct, N]
    else:
        jctx, tctx = _contexts("BFV", 64, [30] * 5, t=257)
        kg = T.KeyGenerator(tctx, device="cpu")
        rk = kg.relin_keys().stacked(2)
        target = T.Encryptor(tctx, kg.public_key(), device="cpu").encrypt(
            T.Plaintext.from_hex("3x^2 + 2", device="cpu")).data[1]
        jplan = jk.KeySwitchPlan(jctx, jctx.first_parms_id)
        tplan = tk.KeySwitchPlan(tctx, tctx.first_parms_id)
    ntt_form = scheme == "CKKS"
    outs, stats = _run(lambda g, x: tsp.switch_key_limb_sharded(x, rk, tplan, g,
                                                                is_ntt_form=ntt_form),
                       C, _rows(target, C))
    mesh = _limb_mesh(C)
    x = to_numpy(target)
    w0, w1 = jsp.switch_key_limb_sharded(
        jax.device_put(x, NamedSharding(mesh, P("limb", None))), to_numpy(rk), jplan, mesh,
        is_ntt_form=ntt_form)
    for k, want in enumerate((w0, w1)):
        np.testing.assert_array_equal(np.concatenate([to_numpy(o[k]) for o in outs], -2),
                                      np.asarray(want))
    # the JAX profile: exactly one all_gather, of the n_ct-row target
    for s in stats:
        assert s.count == {"all-gather": 1} and s.bytes["all-gather"] == x.nbytes


def test_mul_relin_rescale_step(ckks64):
    C = 4
    # one ciphertext each, as the JAX test: its program is in .jax_cache
    a, b, rk, tplan = ckks64["a"][0], ckks64["b"][0], ckks64["rk"], ckks64["tplan"]
    n_ct = tplan.n_ct_rns
    outs, stats = _run(lambda g, x, y: tsp.ckks_mul_relin_rescale_limb_sharded(x, y, rk, tplan,
                                                                               g),
                       C, _rows(a, C), _rows(b, C))
    got = np.concatenate([to_numpy(o) for o in outs], -2)
    mesh = _limb_mesh(C)
    sh = NamedSharding(mesh, P(None, "limb", None))
    want = jsp.ckks_mul_relin_rescale_limb_sharded(
        jax.device_put(to_numpy(a), sh), jax.device_put(to_numpy(b), sh), to_numpy(rk),
        ckks64["jplan"], mesh)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.all(got[..., n_ct - 1, :] == 0)
    # one gather of the c2 target, one psum of the 2-row q_last broadcast
    for s in stats:
        assert s.count == {"all-gather": 1, "all-reduce": 1}, s
        assert s.bytes["all-gather"] == a[1].numel() * 8
        assert s.bytes["all-reduce"] == a[..., :1, :].numel() * 8


@pytest.mark.parametrize("scheme,steps", [("CKKS", [1, 2, -1]), ("BFV", [1, -2])])
def test_rotate_many_hoisted(scheme, steps, ckks64):
    C = 4
    if scheme == "CKKS":
        jctx, tctx, kg, tplan = ckks64["jctx"], ckks64["tctx"], ckks64["kg"], ckks64["tplan"]
        jplan, ct = ckks64["jplan"], ckks64["a"][0]
    else:
        jctx, tctx = _contexts("BFV", 64, [30] * 5, t=T.PlainModulus.batching(64, 17).value)
        kg = T.KeyGenerator(tctx, device="cpu")
        ct = T.Encryptor(tctx, kg.public_key(), device="cpu").encrypt(
            T.Plaintext.from_hex("5x^3 + 3x^2 + 2", device="cpu")).data
        jplan = jk.KeySwitchPlan(jctx, jctx.first_parms_id)
        tplan = tk.KeySwitchPlan(tctx, tctx.first_parms_id)
    ttool = tctx.first_context_data().galois_tool
    jtool = jctx.first_context_data().galois_tool
    elts = ttool.get_elts_from_steps(steps)
    keys = kg.galois_keys(elts).stacked(*elts)
    ntt_form = scheme == "CKKS"
    outs, stats = _run(lambda g, x: tsp.rotate_many_limb_sharded(x, keys, elts, ttool, tplan, g,
                                                                 is_ntt_form=ntt_form),
                       C, _rows(ct, C))
    mesh = _limb_mesh(C)
    want = jsp.rotate_many_limb_sharded(
        jax.device_put(to_numpy(ct), NamedSharding(mesh, P(None, "limb", None))),
        to_numpy(keys), elts, jtool, jplan, mesh, is_ntt_form=ntt_form)
    np.testing.assert_array_equal(np.concatenate([to_numpy(o) for o in outs], -2),
                                  np.asarray(want))
    # one gather for every rotation of the bundle
    assert all(s.count == {"all-gather": 1} for s in stats)


def test_dp_limb_layout_step():
    """The (dp=2, limb=2) layout at N=256, [30] * 9, batch 4: the batch
    split over dp, the limbs over limb, the collectives on limb only; equal
    to the JAX package's in-core step (jit)."""
    jctx, tctx = _contexts("CKKS", 256, [30] * 9)
    kg = T.KeyGenerator(tctx, device="cpu")
    enc = T.Encryptor(tctx, kg.public_key(), device="cpu")
    encoder = T.CKKSEncoder(tctx, device="cpu")
    a = torch.stack([enc.encrypt(encoder.encode([0.5 * (i + 1), -i], 2.0 ** 25)).data
                     for i in range(4)])
    rk = kg.relin_keys().stacked(2)
    tplan = tk.KeySwitchPlan(tctx, tctx.first_parms_id)
    n_ct = tplan.n_ct_rns
    mesh = make_he_mesh(4, dp=2, limb=2)
    spec = ("dp", None, "limb", None)
    outs, stats = _run(lambda g, x: tsp.ckks_mul_relin_rescale_limb_sharded(x, x, rk, tplan, g),
                       4, [shard(a, spec, mesh, r) for r in range(4)], mesh=mesh)
    got = to_numpy(unshard(outs, spec, mesh))
    want = np.asarray(jax.jit(j_mrr(jctx))(to_numpy(a), to_numpy(a), to_numpy(rk)))
    np.testing.assert_array_equal(got[..., : n_ct - 1, :], want)
    assert np.all(got[..., n_ct - 1, :] == 0)
    # per rank: its dp half of the batch, gathered over the 2 limb ranks
    assert stats[0].bytes["all-gather"] == a[:2, 1].numel() * 8


def test_plan_constants_are_cached_per_layout_and_keys(ckks64):
    tplan, rk = ckks64["tplan"], ckks64["rk"]
    c = tsp.plan_consts(tplan, 4, 1, rk)
    assert tsp.plan_consts(tplan, 4, 1, rk) is c
    assert tsp.plan_consts(tplan, 2, 1, rk) is not c
    for i in range(tsp.MAX_CACHED + 2):
        tsp.plan_consts(tplan, 4, 0, rk.clone())
    assert len(tplan.__dict__["_sp_consts_cache"]) <= tsp.MAX_CACHED
    with pytest.raises(ValueError, match="not divisible"):
        _run(lambda g, x: tsp.switch_key_limb_sharded(x, rk, tplan, g), 3,
             _rows(ckks64["a"][0, 1][:3], 3))
