"""The port's limb-sharded BFV BEHZ multiply + relinearize
(gemini_seal_tpu_torch.parallel.behz_sp) against the JAX package, bit for
bit: the JAX schedule on root conftest.py's virtual mesh at N=64 (C = 4),
the (dp=2, limb=2) layout against the JAX in-core step (jit), both with
the JAX package's five-gather profile (two operand extensions, fast_floor,
fastbconv_sk, the relinearization's target) and nothing else.
"""

import jax
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu.models.pipelines import build_bfv_mul_relin as j_mul
from gemini_seal_tpu.parallel.behz_sp import bfv_mul_relin_limb_sharded as j_sharded
from gemini_seal_tpu_torch.ops.backend import to_numpy
from gemini_seal_tpu_torch.parallel.behz_sp import bfv_mul_relin_limb_sharded
from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd
from gemini_seal_tpu_torch.parallel.mesh import make_he_mesh, shard, unshard
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

SEED = tuple(range(71, 79))


def _case(batch=None):
    """N=64, [30] * 5, t = 257 (the JAX tests' ring): the port's keys and
    ciphertexts of 3x^2 + 2 and 5x + 7 (batch: the first rolled by i)."""
    ctxs = []
    for M, kw in ((J, {}), (T, {"device": "cpu"})):
        parms = M.EncryptionParameters(M.SchemeType.BFV)
        parms.set_poly_modulus_degree(64)
        parms.set_coeff_modulus(M.CoeffModulus.create(64, [30] * 5))
        parms.set_plain_modulus(257)
        parms.set_random_seed(SEED)
        ctxs.append(M.SealContext(parms, sec_level=M.SecLevelType.none, **kw))
    jctx, tctx = ctxs
    kg = T.KeyGenerator(tctx, device="cpu")
    enc = T.Encryptor(tctx, kg.public_key(), device="cpu")
    a = enc.encrypt(T.Plaintext.from_hex("3x^2 + 2", device="cpu")).data
    b = enc.encrypt(T.Plaintext.from_hex("5x^1 + 7", device="cpu")).data
    if batch:
        a = torch.stack([a.roll(i, -1) for i in range(batch)])
        b = b.expand((batch,) + tuple(b.shape)).contiguous()
    return jctx, tctx, a, b, kg.relin_keys().stacked(2)


def _profile(stats):
    for s in stats:
        assert s.count == {"all-gather": 5}, s


def test_limb4_against_the_jax_schedule():
    jctx, tctx, a, b, rk = _case()
    C = 4
    rows = lambda x: [x[..., i:i + 1, :].contiguous() for i in range(C)]  # noqa: E731
    team = ThreadGroup(C, "cpu")
    with contiguous_calls():
        outs = run_spmd(lambda g, x, y: bfv_mul_relin_limb_sharded(x, y, rk, tctx, g), team,
                        rows(a), rows(b))
    mesh = Mesh(np.asarray(jax.devices()[:C]), axis_names=("limb",))
    sh = NamedSharding(mesh, P(None, "limb", None))
    want = j_sharded(jax.device_put(to_numpy(a), sh), jax.device_put(to_numpy(b), sh),
                     to_numpy(rk), jctx, mesh)
    np.testing.assert_array_equal(np.concatenate([to_numpy(o) for o in outs], -2),
                                  np.asarray(want))
    _profile(team.stats)


def test_dp2_limb2_against_the_jax_step():
    jctx, tctx, a, b, rk = _case(batch=4)
    mesh = make_he_mesh(4, dp=2, limb=2)
    spec = ("dp", None, "limb", None)
    team = ThreadGroup(4, "cpu", mesh=mesh)
    with contiguous_calls():
        outs = run_spmd(lambda g, x, y: bfv_mul_relin_limb_sharded(x, y, rk, tctx, g), team,
                        [shard(a, spec, mesh, r) for r in range(4)],
                        [shard(b, spec, mesh, r) for r in range(4)])
    want = np.asarray(jax.jit(j_mul(jctx))(to_numpy(a), to_numpy(b), to_numpy(rk)))
    np.testing.assert_array_equal(to_numpy(unshard(outs, spec, mesh)), want)
    _profile(team.stats)
