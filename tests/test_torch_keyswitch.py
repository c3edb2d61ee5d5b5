"""The port's key switch (gemini_seal_tpu_torch.ops.keyswitch) against the
JAX package: compute_modup_digits, the raw inner product, fused_moddown,
rescale_special, switch_key and batched_rotated_inner_product, with one and
two special primes and a short last bundle (n_ct % n_sp != 0), exact
equality.
"""

import jax
import numpy as np
import pytest

import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu.ops import keyswitch as jk
from gemini_seal_tpu_torch.ops import keyswitch as tk
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import one_torch_thread  # noqa: F401

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
    """The non-NTT (BFV-domain) mod-up is ported with its lazy forward lift,
    and the sequential (raw=False) inner product ends in rescale_special;
    a key with fewer bundles than the level needs raises."""
    jctx, tctx = _contexts(*CASES["one_special"])
    pid = jctx.first_parms_id
    jplan, tplan = jk.KeySwitchPlan(jctx, pid), tk.KeySwitchPlan(tctx, pid)
    rng = np.random.default_rng(7)
    target = _residues(rng, jplan.ext_moduli[: jplan.n_ct_rns], (1,))
    want = np.asarray(jax.jit(lambda x: jk.compute_modup_digits(x, jplan, False))(target))
    got = tk.compute_modup_digits(to_tensor(target, "cpu"), tplan, False)
    np.testing.assert_array_equal(want, to_numpy(got))
    key_mods = [m.value for m in jctx.key_context_data().parms.coeff_modulus]
    key = to_tensor(np.stack([_residues(rng, key_mods, (2,))
                              for _ in range(jplan.n_bundles)]), "cpu")
    raw = tk.keyswitch_inner_product(got, key, tplan, False, raw=True)
    seq = tk.keyswitch_inner_product(got, key, tplan, False)
    for r, s in zip(raw, seq):
        np.testing.assert_array_equal(to_numpy(tk.rescale_special(r, tplan, False)),
                                      to_numpy(s))
    with pytest.raises(RuntimeError):
        tk.keyswitch_inner_product(got, key[:1], tplan, False)


@pytest.mark.parametrize("case", list(CASES))
def test_rescale_special_switch_key_and_rotated_inner_product(case):
    """rescale_special (NTT and power-basis output), switch_key and
    batched_rotated_inner_product at R=3.  The JAX functions run on numpy
    inputs here, through the package's host-plane dispatch (ops/backend.py
    xp): the same code as under jit, without a compile per ring."""
    bits, nsp = CASES[case]
    jctx, tctx = _contexts(bits, nsp)
    pid = jctx.first_parms_id
    jplan, tplan = jk.KeySwitchPlan(jctx, pid), tk.KeySwitchPlan(tctx, pid)
    rng = np.random.default_rng(len(bits) * 10 + nsp + 1)
    key_mods = [m.value for m in jctx.key_context_data().parms.coeff_modulus]
    acc = _residues(rng, jplan.ext_moduli, (2,))                  # [2, n_ext, N]
    target = _residues(rng, jplan.ext_moduli[: jplan.n_ct_rns], (2,))
    keys = np.stack([np.stack([_residues(rng, key_mods, (2,))
                               for _ in range(jplan.n_bundles)]) for _ in range(3)])
    tool = tctx.first_context_data().galois_tool
    elts = tool.get_elts_from_steps([1, -1, 3])
    tabs = np.stack([tool._ntt_table(e) for e in elts])

    def ref(acc, target, keys):
        digits = jk.compute_modup_digits(target, jplan, True)
        return (jk.rescale_special(acc, jplan, True), jk.rescale_special(acc, jplan, False),
                jk.switch_key(target, keys[0], jplan, True),
                jk.batched_rotated_inner_product(digits, tabs, keys, jplan))

    want = ref(acc, target, keys)
    t_acc, t_target, t_keys = (to_tensor(v, "cpu") for v in (acc, target, keys))
    got = (tk.rescale_special(t_acc, tplan, True), tk.rescale_special(t_acc, tplan, False),
           tk.switch_key(t_target, t_keys[0], tplan, True),
           tk.batched_rotated_inner_product(tk.compute_modup_digits(t_target, tplan, True),
                                            tool.ntt_tables(elts), t_keys, tplan))
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(np.asarray(w), to_numpy(g))
    for w2, g2 in zip(want[2:], got[2:]):
        for w, g in zip(w2, g2):
            np.testing.assert_array_equal(np.asarray(w), to_numpy(g))
    assert got[3][0].shape == (2, 3, jplan.n_ext, N)
