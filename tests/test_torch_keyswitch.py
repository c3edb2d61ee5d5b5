"""The port's fused key switch (gemini_seal_tpu_torch.ops.keyswitch) against
the JAX package: compute_modup_digits, the raw inner product and
fused_moddown, with one and two special primes and a short last bundle
(n_ct % n_sp != 0), exact equality.
"""

import jax
import numpy as np
import pytest

import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu.ops import keyswitch as jk
from gemini_seal_tpu_torch.ops import keyswitch as tk
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor

N = 256

# (bit sizes, n_special_primes): n_ct = len(bits) - n_sp data primes
CASES = {
    "one_special": ([40, 30, 30, 40], 1),        # n_ct 3, bundles of 1
    "two_special": ([40, 30, 30, 30, 40, 40], 2),  # n_ct 4, bundles of 2
    "short_bundle": ([40, 30, 30, 40, 40], 2),   # n_ct 3: bundles {0,1},{2}
}


def _contexts(bits, nsp):
    out = []
    for M, kw in ((J, {}), (T, {"device": "cpu"})):
        parms = M.EncryptionParameters(M.SchemeType.CKKS)
        parms.set_poly_modulus_degree(N)
        parms.set_coeff_modulus(M.CoeffModulus.create(N, bits))
        parms.set_n_special_primes(nsp)
        out.append(M.SealContext(parms, sec_level=M.SecLevelType.none, **kw))
    return out


def _residues(rng, moduli, lead):
    return np.stack([rng.integers(0, p, size=lead + (N,), dtype=np.uint64)
                     for p in moduli], axis=len(lead))


@pytest.mark.parametrize("case", list(CASES))
def test_modup_inner_product_moddown(case):
    bits, nsp = CASES[case]
    jctx, tctx = _contexts(bits, nsp)
    assert jctx.first_parms_id == tctx.first_parms_id
    pid = jctx.first_parms_id
    jplan = jk.KeySwitchPlan(jctx, pid)
    tplan = tk.KeySwitchPlan(tctx, pid)
    assert (tplan.n_bundles, tplan.n_ext) == (jplan.n_bundles, jplan.n_ext)
    if case == "short_bundle":
        assert jplan.n_ct_rns % jplan.n_sp_rns != 0

    rng = np.random.default_rng(len(bits) * 10 + nsp)
    ct_mods = jplan.ext_moduli[: jplan.n_ct_rns]
    key_mods = [m.value for m in jctx.key_context_data().parms.coeff_modulus]
    target = _residues(rng, ct_mods, (2,))                       # [2, n_ct, N]
    key = np.stack([_residues(rng, key_mods, (2,))
                    for _ in range(jplan.n_bundles)])            # [nb, 2, L_key, N]

    j_digits = np.asarray(jax.jit(lambda x: jk.compute_modup_digits(x, jplan, True))(target))
    t_digits = tk.compute_modup_digits(to_tensor(target, "cpu"), tplan, True)
    np.testing.assert_array_equal(j_digits, to_numpy(t_digits))

    j_acc = jax.jit(lambda d, k: jk.keyswitch_inner_product(d, k, jplan, True, raw=True))(
        j_digits, key)
    t_acc = tk.keyswitch_inner_product(t_digits, to_tensor(key, "cpu"), tplan, True, raw=True)
    for a, b in zip(j_acc, t_acc):
        np.testing.assert_array_equal(np.asarray(a), to_numpy(b))

    c = _residues(rng, ct_mods, (2,))
    acc0 = np.asarray(j_acc[0])
    want = np.asarray(jax.jit(lambda x, y: jk.fused_moddown(x, y, jplan))(c, acc0))
    got = tk.fused_moddown(to_tensor(c, "cpu"), to_tensor(acc0, "cpu"), tplan)
    np.testing.assert_array_equal(want, to_numpy(got))


def test_non_ntt_target_and_sequential_forms_raise():
    """The non-NTT (BFV-domain) mod-up is ported with its lazy forward lift;
    the rescale_special form is not, and says so."""
    jctx, tctx = _contexts(*CASES["one_special"])
    pid = jctx.first_parms_id
    jplan, tplan = jk.KeySwitchPlan(jctx, pid), tk.KeySwitchPlan(tctx, pid)
    rng = np.random.default_rng(7)
    target = _residues(rng, jplan.ext_moduli[: jplan.n_ct_rns], (1,))
    want = np.asarray(jax.jit(lambda x: jk.compute_modup_digits(x, jplan, False))(target))
    got = tk.compute_modup_digits(to_tensor(target, "cpu"), tplan, False)
    np.testing.assert_array_equal(want, to_numpy(got))
    with pytest.raises(NotImplementedError):
        tk.keyswitch_inner_product(got, None, tplan, True, raw=False)
