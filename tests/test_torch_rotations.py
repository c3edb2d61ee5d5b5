"""The port's power-basis Galois automorphism and the BFV and counter-rotated
rotations against the JAX package on the CPU, exact equality:
GaloisTool._coeff_table and apply_galois (zero inputs at signed positions
included), the signed and paired modes of galois_permute,
prepermute_galois_stack, BASELINE config 2's single row rotation (composed
as bench_all.py composes it: apply_galois on both components, the
power-basis switch_key, add_poly) and rotate_columns, build_bfv_rotate_many
in both key forms (against the JAX forms and the host
Evaluator.rotate_rows_many), and build_ckks_rotate_many's counter-rotated
form.  Decodes are exact for BFV (each row of the 2 x N/2 slot matrix
rotated), and the two key forms decode equal.

The JAX steps run on numpy inputs through the package's host-plane dispatch
(``jnp`` of models/pipelines.py swapped for numpy), so nothing is compiled.
"""

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.models import pipelines as jp
from gemini_seal_tpu.ops.dyadic import LimbConstants as JaxLimbs
from gemini_seal_tpu.ops.dyadic import add_poly as jax_add_poly
from gemini_seal_tpu.ops.galois import GaloisTool as JaxGaloisTool
from gemini_seal_tpu.ops.keyswitch import KeySwitchPlan as JaxPlan
from gemini_seal_tpu.ops.keyswitch import switch_key as jax_switch_key
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch import convert
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from gemini_seal_tpu_torch.ops.dyadic import LimbConstants, add_poly
from gemini_seal_tpu_torch.ops.galois import GaloisTool, galois_permute
from gemini_seal_tpu_torch.ops.keyswitch import KeySwitchPlan, switch_key
from gemini_seal_tpu_torch.utils.numth import get_primes
from torch_helpers import one_torch_thread  # noqa: F401

N = 256
STEPS = (1, 2, 3)


@pytest.fixture
def host_plane(monkeypatch):
    monkeypatch.setattr(jp, "jnp", np)


@pytest.mark.parametrize("log_n", [8, 10])
@pytest.mark.parametrize("step", [1, -1, 3, "conj"])
def test_coeff_table_and_apply_galois(log_n, step):
    n = 1 << log_n
    jtool, ttool = JaxGaloisTool(log_n), GaloisTool(log_n, "cpu")
    elt = 2 * n - 1 if step == "conj" else jtool.get_elt_from_step(step)
    src, neg = jtool._coeff_table(elt)
    tsrc, tneg = ttool._coeff_table(elt)
    np.testing.assert_array_equal(src, tsrc)
    np.testing.assert_array_equal(neg, tneg)
    assert neg.any() and not neg.all()

    mods = get_primes(2 * n, 40, 3)
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, p, size=(2, n), dtype=np.uint64) for p in mods], axis=1)
    x[..., src[neg][::3]] = 0          # zeros where the gather flips the sign
    jlimbs = JaxLimbs.from_moduli(mods)
    want = np.asarray(jtool.apply_galois(x, elt, jlimbs))
    got = ttool.apply_galois(to_tensor(x, "cpu"), elt, LimbConstants.from_moduli(mods, "cpu"))
    np.testing.assert_array_equal(want, to_numpy(got))
    assert (want[..., neg] == 0).any()


def test_galois_permute_signed_and_paired_modes():
    """Several signed tables at once ([..., R, rows, N], limb = row % L),
    and the paired mode (x carries R; row block r through table r), signed
    and unsigned, against numpy."""
    log_n = 8
    n = 1 << log_n
    tool = GaloisTool(log_n, "cpu")
    elts = tool.get_elts_from_steps([1, 5, -2])
    mods = get_primes(2 * n, 50, 2)
    p = np.array(mods, dtype=np.uint64)
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(0, q, size=(3, 2, n), dtype=np.uint64) for q in mods], axis=-2)
    x[..., :8] = 0
    srcs = [tool._coeff_table(e) for e in elts]

    def signed(v, r):
        g = v[..., srcs[r][0]]
        return np.where(srcs[r][1] & (g != 0), p[:, None] - g, g)

    moduli = to_tensor(p, "cpu")
    shared = galois_permute(to_tensor(x[0], "cpu"), tool.coeff_tables(elts), moduli)
    assert shared.shape == (2, 3, 2, n)
    for r in range(3):
        np.testing.assert_array_equal(to_numpy(shared[:, r]), signed(x[0], r))
    xr = to_tensor(x.reshape(3, 4, n), "cpu")       # [R, rows = 2 components x L, N]
    paired = galois_permute(xr, tool.coeff_tables(elts), moduli, paired=True)
    unsigned = galois_permute(xr, tool.ntt_tables(elts), paired=True)
    for r in range(3):
        np.testing.assert_array_equal(to_numpy(paired[r]).reshape(2, 2, n), signed(x[r], r))
        np.testing.assert_array_equal(to_numpy(unsigned[r]).reshape(2, 2, n),
                                      x[r][..., tool._ntt_table(elts[r])])
    inv = galois_permute(unsigned, tool.ntt_inverse_tables(elts), paired=True)
    np.testing.assert_array_equal(to_numpy(inv).reshape(x.shape), x)


def _bfv(M, **kw):
    parms = M.EncryptionParameters(M.SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(M.CoeffModulus.create(N, [40] * 5))
    parms.set_plain_modulus(M.PlainModulus.batching(N, 20))
    parms.set_random_seed(tuple(range(8)))
    ctx = M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)
    return ctx, M.KeyGenerator(ctx, **kw)


class Bfv:
    """Config 2's shape at N=256: four ciphertext primes and one special."""

    def __init__(self):
        (self.jc, self.jkg), (self.tc, self.tkg) = _bfv(J), _bfv(T, device="cpu")
        self.tool = self.jc.first_context_data().galois_tool
        self.elts = self.tool.get_elts_from_steps(list(STEPS))
        self.conj = 2 * N - 1
        all_elts = self.elts + [self.conj]
        self.jgk, self.tgk = self.jkg.galois_keys(all_elts), self.tkg.galois_keys(all_elts)
        self.jstack = np.stack([np.stack([np.asarray(pk.data.data) for pk in self.jgk.key(e)])
                                for e in all_elts])
        self.t = self.jc.first_context_data().parms.plain_modulus.value
        self.v = np.random.default_rng(5).integers(0, self.t, N)
        self.jct = J.Encryptor(self.jc, public_key=self.jkg.public_key()).encrypt(
            J.BatchEncoder(self.jc).encode(self.v.tolist()))
        self.a = np.stack([np.asarray(self.jct.data)] * 2)           # batch 2
        self.dec = T.Decryptor(self.tc, self.tkg.secret_key, device="cpu")
        self.be = T.BatchEncoder(self.tc, device="cpu")

    def decodes(self, data):
        return self.be.decode(self.dec.decrypt(T.Ciphertext(data, self.jct.parms_id, False)))

    def rows_rotated(self, s):
        half = N // 2
        return np.concatenate([np.roll(self.v[:half], -s), np.roll(self.v[half:], -s)]).tolist()


@pytest.fixture(scope="module")
def bfv():
    return Bfv()


def test_bfv_galois_keys_equal(bfv):
    np.testing.assert_array_equal(
        bfv.jstack, to_numpy(bfv.tgk.stacked(*bfv.elts, bfv.conj)))
    carried = convert.galois_stack_from_array(bfv.tc, bfv.jstack)
    np.testing.assert_array_equal(bfv.jstack, to_numpy(carried))
    with pytest.raises(ValueError):
        convert.galois_stack_from_array(bfv.tc, bfv.jstack[:, :, :1])


def test_prepermute_galois_stack(bfv):
    want = jp.prepermute_galois_stack(bfv.tool, bfv.elts, bfv.jstack[:3])
    tool = bfv.tc.first_context_data().galois_tool
    got = T.prepermute_galois_stack(tool, bfv.elts, to_tensor(bfv.jstack[:3], "cpu"))
    np.testing.assert_array_equal(want, to_numpy(got))
    with pytest.raises(ValueError):
        T.prepermute_galois_stack(tool, bfv.elts[:2], to_tensor(bfv.jstack[:3], "cpu"))


@pytest.mark.parametrize("which", ["rotate_rows", "rotate_columns"])
def test_bfv_single_rotation(bfv, which):
    """bench_all.py's config-2 step (bench_all.py:155-159): one signed
    gather of both components, the power-basis key switch of c1, add."""
    elt = bfv.elts[0] if which == "rotate_rows" else bfv.conj
    k = 0 if which == "rotate_rows" else 3
    jcd = bfv.jc.first_context_data()
    jlimbs = jcd.limb_constants
    c0 = bfv.tool.apply_galois(bfv.a[:, 0], elt, jlimbs)
    c1 = bfv.tool.apply_galois(bfv.a[:, 1], elt, jlimbs)
    d0, d1 = jax_switch_key(c1, bfv.jstack[k], JaxPlan(bfv.jc, bfv.jc.first_parms_id), False)
    want = np.stack([jax_add_poly(c0, d0, jlimbs), d1], axis=-3)

    cd = bfv.tc.first_context_data()
    limbs = cd.limb_constants
    rot = cd.galois_tool.apply_galois(to_tensor(bfv.a, "cpu"), elt, limbs)
    d0, d1 = switch_key(rot[:, 1], bfv.tgk.stacked(elt), KeySwitchPlan(bfv.tc, cd.parms_id),
                        False)
    got = np.stack([to_numpy(add_poly(rot[:, 0].contiguous(), d0, limbs)), to_numpy(d1)],
                   axis=-3)
    np.testing.assert_array_equal(want, got)
    host = J.Evaluator(bfv.jc)
    ref = (host.rotate_rows(bfv.jct, 1, bfv.jgk) if which == "rotate_rows"
           else host.rotate_columns(bfv.jct, bfv.jgk))
    np.testing.assert_array_equal(np.asarray(ref.data), got[0])
    half = N // 2
    expect = (bfv.rows_rotated(1) if which == "rotate_rows"
              else np.concatenate([bfv.v[half:], bfv.v[:half]]).tolist())
    assert bfv.decodes(to_tensor(got[1], "cpu")) == expect


@pytest.mark.parametrize("prepermuted", [False, True])
def test_bfv_rotate_many(bfv, prepermuted, host_plane):
    stack = bfv.jstack[:3]
    tool = bfv.tc.first_context_data().galois_tool
    tstack = to_tensor(stack, "cpu")
    if prepermuted:
        stack = jp.prepermute_galois_stack(bfv.tool, bfv.elts, stack)
        tstack = T.prepermute_galois_stack(tool, bfv.elts, tstack)
    want = jp.build_bfv_rotate_many(bfv.jc, list(STEPS), prepermuted_keys=prepermuted)(
        bfv.a, stack)
    got = T.build_bfv_rotate_many(bfv.tc, list(STEPS), prepermuted_keys=prepermuted,
                                  device="cpu")(to_tensor(bfv.a, "cpu"), tstack)
    assert got.shape == (len(STEPS), 2, 2, 5 - 1, N)
    np.testing.assert_array_equal(want, to_numpy(got))
    if not prepermuted:
        host = J.Evaluator(bfv.jc).rotate_rows_many(bfv.jct, list(STEPS), bfv.jgk)
        for r in range(len(STEPS)):
            np.testing.assert_array_equal(np.asarray(host[r].data), to_numpy(got[r, 0]))
    for r, s in enumerate(STEPS):
        assert bfv.decodes(got[r, 1]) == bfv.rows_rotated(s)


def _ckks(M, **kw):
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(M.CoeffModulus.create(N, [40, 30, 40]))
    parms.set_random_seed(tuple(range(51, 59)))
    ctx = M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)
    return ctx, M.KeyGenerator(ctx, **kw)


def test_ckks_rotate_many_prepermuted(host_plane):
    (jc, jkg), (tc, tkg) = _ckks(J), _ckks(T, device="cpu")
    jtool = jc.first_context_data().galois_tool
    elts = jtool.get_elts_from_steps(list(STEPS))
    jgk = jkg.galois_keys(elts)
    jstack = np.stack([np.stack([np.asarray(pk.data.data) for pk in jgk.key(e)])
                       for e in elts])
    vals = [0.5, -1.25, 2.0, 0.75]
    jct = J.Encryptor(jc, public_key=jkg.public_key()).encrypt(
        J.CKKSEncoder(jc).encode(vals, 2.0 ** 30))
    a = np.stack([np.asarray(jct.data)] * 2)
    pstack = jp.prepermute_galois_stack(jtool, elts, jstack)
    want = jp.build_ckks_rotate_many(jc, list(STEPS), prepermuted_keys=True)(a, pstack)
    tstack = T.prepermute_galois_stack(tc.first_context_data().galois_tool, elts,
                                       tkg.galois_keys(elts).stacked(*elts))
    np.testing.assert_array_equal(pstack, to_numpy(tstack))
    got = T.build_ckks_rotate_many(tc, list(STEPS), prepermuted_keys=True, device="cpu")(
        to_tensor(a, "cpu"), tstack)
    np.testing.assert_array_equal(want, to_numpy(got))
    enc = T.CKKSEncoder(tc, device="cpu")
    dec = T.Decryptor(tc, tkg.secret_key, device="cpu")
    padded = vals + [0.0] * 4
    for r, s in enumerate(STEPS):
        out = enc.decode(dec.decrypt(T.Ciphertext(got[r, 1], jct.parms_id, True, jct.scale)))
        assert max(abs(out[i] - padded[i + s]) for i in range(len(vals))) < 1e-3
