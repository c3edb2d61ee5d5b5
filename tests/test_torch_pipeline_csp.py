"""The port's coefficient-sharded pipeline (gemini_seal_tpu_torch.parallel.
pipeline_csp: the in-core key switch and rescale on the four-step NTT
bodies) against the JAX package, bit for bit: the switch and the hoisted
rotations against the JAX schedules on root conftest.py's virtual mesh, the
mul + relin + rescale step against the JAX in-core step (jit), one rotation
at C = 8 whose Galois block map is not an involution (the ppermute sends
rank a's block to rank b while b's goes elsewhere), the block plans
against the JAX function's; and the all_to_all-only profile: two
transposes per NTT, nothing else.
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
from gemini_seal_tpu.parallel import pipeline_csp as jcsp
from gemini_seal_tpu_torch.ops import keyswitch as tk
from gemini_seal_tpu_torch.ops.backend import to_numpy
from gemini_seal_tpu_torch.parallel import pipeline_csp as tcsp
from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

SEED = tuple(range(51, 59))
N = 1024


@pytest.fixture(scope="module")
def ring():
    """N=1024, [30] * 6, one special prime (the JAX tests' ring)."""
    ctxs = []
    for M, kw in ((J, {}), (T, {"device": "cpu"})):
        parms = M.EncryptionParameters(M.SchemeType.CKKS)
        parms.set_poly_modulus_degree(N)
        parms.set_coeff_modulus(M.CoeffModulus.create(N, [30] * 6))
        parms.set_n_special_primes(1)
        parms.set_random_seed(SEED)
        ctxs.append(M.SealContext(parms, sec_level=M.SecLevelType.none, **kw))
    jctx, tctx = ctxs
    kg = T.KeyGenerator(tctx, device="cpu")
    enc = T.Encryptor(tctx, kg.public_key(), device="cpu")
    encoder = T.CKKSEncoder(tctx, device="cpu")
    a = torch.stack([enc.encrypt(encoder.encode([0.5 * (i + 1)], 2.0 ** 25)).data
                     for i in range(4)])
    return {"jctx": jctx, "tctx": tctx, "kg": kg, "a": a, "rk": kg.relin_keys().stacked(2),
            "jplan": jk.KeySwitchPlan(jctx, jctx.first_parms_id),
            "tplan": tk.KeySwitchPlan(tctx, tctx.first_parms_id),
            "ttool": tctx.first_context_data().galois_tool,
            "jtool": jctx.first_context_data().galois_tool}


def _chunks(x, C):
    b = x.shape[-1] // C
    return [x[..., r * b:(r + 1) * b].contiguous() for r in range(C)]


def _run(fn, C, *per_rank):
    team = ThreadGroup(C, "cpu")
    with contiguous_calls():
        outs = run_spmd(fn, team, *per_rank)
    return outs, team.stats


def _mesh(C):
    return Mesh(np.asarray(jax.devices()[:C]), axis_names=("coeff",))


def _put(x, mesh):
    x = to_numpy(x)
    return jax.device_put(x, NamedSharding(mesh, P(*([None] * (x.ndim - 1)), "coeff")))


def test_switch_key_batched(ring):
    C = 4
    base = ring["a"][0, 1]
    target = torch.stack([base, base.roll(3, -1)])
    rk, tplan = ring["rk"], ring["tplan"]
    outs, stats = _run(lambda g, x, k: tcsp.switch_key_coeff_sharded(x, k, tplan, g), C,
                       _chunks(target, C), _chunks(rk, C))
    mesh = _mesh(C)
    w0, w1 = jcsp.switch_key_coeff_sharded(_put(target, mesh), _put(rk, mesh), ring["jplan"],
                                           mesh)
    for k, want in enumerate((w0, w1)):
        np.testing.assert_array_equal(np.concatenate([to_numpy(o[k]) for o in outs], -1),
                                      np.asarray(want))
    # mod-up inverse + forward, two rescale_special inverse + forward: 6 NTTs
    assert all(s.count == {"all-to-all": 12} for s in stats), stats


def test_mul_relin_rescale_step(ring):
    """Batch 4 against the JAX in-core step (jit): 8 NTTs, 16 all_to_alls."""
    C = 4
    a, rk, tplan = ring["a"], ring["rk"], ring["tplan"]
    outs, stats = _run(lambda g, x, k: tcsp.ckks_mul_relin_rescale_coeff_sharded(x, x, k, tplan,
                                                                                 g),
                       C, _chunks(a, C), _chunks(rk, C))
    want = np.asarray(jax.jit(j_mrr(ring["jctx"]))(to_numpy(a), to_numpy(a), to_numpy(rk)))
    np.testing.assert_array_equal(np.concatenate([to_numpy(o) for o in outs], -1), want)
    assert all(s.count == {"all-to-all": 16} for s in stats), stats


def test_rotate_with_a_non_involutive_block_map(ring):
    """Step 1 at C = 8: rank src[b] sends block b, and src is not its own
    inverse; against the JAX schedule on an 8-device mesh."""
    C = 8
    ttool, jtool, kg = ring["ttool"], ring["jtool"], ring["kg"]
    elt = ttool.get_elt_from_step(1)
    perm, _ = tcsp.galois_block_plan(ttool, elt, C)
    assert perm is not None and not all((d, s) in perm for s, d in perm)
    key = kg.galois_keys([elt]).stacked(elt)
    ct = ring["a"][1]
    outs, stats = _run(lambda g, x, k: tcsp.ckks_rotate_coeff_sharded(x, k, elt, ttool,
                                                                      ring["tplan"], g),
                       C, _chunks(ct, C), _chunks(key, C))
    mesh = _mesh(C)
    want = jcsp.ckks_rotate_coeff_sharded(_put(ct, mesh), _put(key, mesh), elt, jtool,
                                          ring["jplan"], mesh)
    np.testing.assert_array_equal(np.concatenate([to_numpy(o) for o in outs], -1),
                                  np.asarray(want))
    assert all(s.count == {"all-to-all": 12, "collective-permute": 1} for s in stats)


def test_rotate_many_hoisted(ring):
    C = 4
    ttool, jtool, kg = ring["ttool"], ring["jtool"], ring["kg"]
    elts = ttool.get_elts_from_steps([1, -1, 4])
    keys = kg.galois_keys(elts).stacked(*elts)
    ct = ring["a"][0]
    outs, _ = _run(lambda g, x, k: tcsp.ckks_rotate_many_coeff_sharded(x, k, elts, ttool,
                                                                       ring["tplan"], g),
                   C, _chunks(ct, C), _chunks(keys, C))
    mesh = _mesh(C)
    want = jcsp.ckks_rotate_many_coeff_sharded(_put(ct, mesh), _put(keys, mesh), elts, jtool,
                                               ring["jplan"], mesh)
    np.testing.assert_array_equal(np.concatenate([to_numpy(o) for o in outs], -1),
                                  np.asarray(want))


@pytest.mark.parametrize("C", [2, 4, 8])
def test_galois_block_plans_equal_the_jax_ones(ring, C):
    ttool, jtool = ring["ttool"], ring["jtool"]
    for elt in (3, 5, 25, 2 * N - 1, ttool.get_elt_from_step(-1)):
        tp, tl = tcsp.galois_block_plan(ttool, elt, C)
        jp, jl = jcsp._galois_block_plan(jtool, elt, C)
        assert tp == jp
        np.testing.assert_array_equal(tl, jl)
