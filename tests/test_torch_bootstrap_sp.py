"""The port's limb-sharded hoisted matvec (gemini_seal_tpu_torch.parallel.
bootstrap_sp, the bootstrap's C2S/S2C group on the one-gather schedule)
against the JAX schedule on root conftest.py's virtual mesh, bit for bit:
four diagonals (steps 0, 1, 3, -2: a negative step sorts before 0) with
two special primes at N=64, C = 4, and one all_gather bounded by the
n_ct-row target; and the port's in-core build_ckks_matvec on the same
diagonals against the JAX one.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu.models.pipelines import build_ckks_matvec as j_matvec
from gemini_seal_tpu.parallel.bootstrap_sp import build_ckks_matvec_limb_sharded as j_sharded
from gemini_seal_tpu_torch.ops.backend import to_numpy
from gemini_seal_tpu_torch.parallel.bootstrap_sp import build_ckks_matvec_limb_sharded
from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401


def test_matvec_limb4_against_the_jax_schedule():
    n, scale = 64, 2.0 ** 25
    ctxs = []
    for M, kw in ((J, {}), (T, {"device": "cpu"})):
        parms = M.EncryptionParameters(M.SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(M.CoeffModulus.create(n, [30] * 10))
        parms.set_n_special_primes(2)
        parms.set_random_seed((1, 2, 3, 4, 5, 6, 7, 8))
        ctxs.append(M.SealContext(parms, sec_level=M.SecLevelType.none, **kw))
    jctx, tctx = ctxs
    kg = T.KeyGenerator(tctx, device="cpu")
    encoder = T.CKKSEncoder(tctx, device="cpu")
    s = encoder.slot_count
    rng = np.random.default_rng(3)
    diag = {d: (rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)).tolist()
            for d in (0, 1, 3, -2)}
    tool = tctx.first_context_data().galois_tool
    elts = [tool.get_elt_from_step(d) for d in sorted(diag) if d]
    keys = kg.galois_keys(elts).stacked(*elts)
    ct = T.Encryptor(tctx, kg.public_key(), device="cpu").encrypt(encoder.encode(
        (rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)).tolist(), scale)).data
    C = 4
    n_ct = ct.shape[-2]
    rpn = n_ct // C
    fn = build_ckks_matvec_limb_sharded(tctx, diag, scale, encoder, C, device="cpu")
    team = ThreadGroup(C, "cpu")
    with contiguous_calls():
        outs = run_spmd(lambda g, x: fn(g, x, keys), team,
                        [ct[..., r * rpn:(r + 1) * rpn, :].contiguous() for r in range(C)])
    got = np.concatenate([to_numpy(o) for o in outs], -2)

    jenc = J.CKKSEncoder(jctx)
    mesh = Mesh(np.asarray(jax.devices()[:C]), axis_names=("limb",))
    jfn = j_sharded(jctx, diag, scale, jenc, mesh)
    want = np.asarray(jfn(jax.device_put(to_numpy(ct), NamedSharding(mesh, P(None, "limb", None))),
                          to_numpy(keys)))
    np.testing.assert_array_equal(got, want)
    assert fn.rot_steps == jfn.rot_steps == [-2, 1, 3]
    for st in team.stats:
        assert st.count == {"all-gather": 1} and st.bytes["all-gather"] == n_ct * n * 8
    # the in-core matvec on the same diagonals (ptc in rot_steps order)
    incore = T.build_ckks_matvec(tctx, diag, scale, encoder, device="cpu")(ct, keys)
    np.testing.assert_array_equal(to_numpy(incore), want)
    np.testing.assert_array_equal(
        want, np.asarray(jax.jit(j_matvec(jctx, diag, scale, jenc))(to_numpy(ct), to_numpy(keys))))
