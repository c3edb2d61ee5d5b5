"""The port's encrypted linear layers against the JAX package on the CPU,
exact equality: CKKSEncoder.encode_at_base at the key-switch extended base,
build_ckks_matvec (hoisted rotations, both fuse_moddown forms) on
bench_all.py's 8x8 diagonals (bench_all.py:318-324) and
build_ckks_matvec_bsgs (the default baby size, an explicit one, and a step
set with negative steps and no giant 0), at N=1024 with
CoeffModulus.create(1024, [50, 40, 40, 50]) and two special primes'
worth of bundles (nsp=1 and 2), scale 2^40.  Each output also decrypts to
M x within 1e-4.

The JAX steps run on numpy inputs through the package's host-plane dispatch
(``jnp`` of models/pipelines.py swapped for numpy), so nothing is compiled.
Every kernel call of the port is held to the contiguity the card demands
(torch_helpers.py).
"""

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.models import pipelines as jp
from gemini_seal_tpu.modulus import Modulus as JModulus
from gemini_seal_tpu.ops.keyswitch import KeySwitchPlan as JPlan
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.convert import galois_stack_from_array, secret_key_from_array
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from gemini_seal_tpu_torch.ops.keyswitch import KeySwitchPlan
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

N = 1024
BITS = [50, 40, 40, 50]
SCALE = 2.0 ** 40
DIM = 8


def _setup(M, nsp, **kw):
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(M.CoeffModulus.create(N, BITS + [50] * (nsp - 1)))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(tuple(range(8)))
    ctx = M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)
    return ctx, M.CKKSEncoder(ctx, **kw)


def _dense8x8(slots):
    M = np.random.default_rng(1).uniform(-0.5, 0.5, size=(DIM, DIM))
    return {d: [M[i % DIM, (i + d) % DIM] for i in range(slots)] for d in range(DIM)}


def _sparse(slots):
    rng = np.random.default_rng(4)
    return {s: rng.uniform(-0.5, 0.5, slots).tolist() for s in (-2, 5, 6, 9)}


class Ring:
    def __init__(self, nsp):
        self.jc, self.jenc = _setup(J, nsp)
        self.tc, self.tenc = _setup(T, nsp, device="cpu")
        self.jkg = J.KeyGenerator(self.jc)
        self.slots = N // 2
        self.v = np.random.default_rng(7).uniform(-1.0, 1.0, self.slots)
        jct = J.Encryptor(self.jc, public_key=self.jkg.public_key()).encrypt(
            self.jenc.encode(self.v.tolist(), SCALE))
        self.a = np.stack([np.asarray(jct.data)] * 2)          # batch 2
        self.pid = jct.parms_id
        self.tool = self.jc.first_context_data().galois_tool
        sk = secret_key_from_array(self.tc, np.asarray(self.jkg.secret_key.data))
        self.dec = T.Decryptor(self.tc, sk, device="cpu")
        self._keys = {}

    def stack(self, steps):
        """The JAX package's Galois keys for `steps`, as numpy and as the
        port's stacked tensor."""
        steps = tuple(steps)
        if steps not in self._keys:
            elts = [self.tool.get_elt_from_step(s) for s in steps]
            gk = self.jkg.galois_keys(elts)
            arr = np.stack([np.stack([np.asarray(pk.data.data) for pk in gk.key(e)])
                            for e in elts])
            self._keys[steps] = (arr, galois_stack_from_array(self.tc, arr))
        return self._keys[steps]

    def decode_err(self, out, diagonals):
        ct = T.Ciphertext(out[1].contiguous(), self.pid, True, SCALE * SCALE)
        got = np.asarray(self.tenc.decode(self.dec.decrypt(ct)))
        want = sum(np.asarray(vec) * np.roll(self.v, -(d % self.slots))
                   for d, vec in diagonals.items())
        return float(np.abs(got - want).max())


@pytest.fixture(scope="module", params=[1, 2], ids=["nsp1", "nsp2"])
def ring(request):
    return Ring(request.param)


@pytest.fixture(autouse=True)
def eager_jax(monkeypatch):
    monkeypatch.setattr(jp, "jnp", np)
    with contiguous_calls():
        yield


def test_encode_at_base(ring):
    pid = ring.jc.first_parms_id
    jplan, plan = JPlan(ring.jc, pid), KeySwitchPlan(ring.tc, pid)
    assert plan.ext_moduli == jplan.ext_moduli
    vals = np.random.default_rng(3).uniform(-1, 1, ring.slots) * (1 + 0.5j)
    for values, scale in ((vals.tolist(), SCALE), (0.25, 2.0 ** 30), (1 - 2j, SCALE)):
        want = ring.jenc.encode_at_base(values, scale, pid,
                                        [JModulus(p) for p in jplan.ext_moduli],
                                        jplan.ext_tables)
        got = ring.tenc.encode_at_base(values, scale, pid, plan.ext_moduli, plan.ext_tables)
        np.testing.assert_array_equal(want, to_numpy(got))
    # on the ciphertext base it is the plain encode
    cd = ring.tc.get_context_data(pid)
    got = ring.tenc.encode_at_base(vals.tolist(), SCALE, pid, cd.parms.coeff_modulus,
                                   cd.ntt_tables)
    np.testing.assert_array_equal(to_numpy(got),
                                  to_numpy(ring.tenc.encode(vals.tolist(), SCALE).data))
    with pytest.raises(ValueError, match="too large"):
        ring.tenc.encode_at_base([0.0] * (ring.slots + 1), SCALE, pid, plan.ext_moduli,
                                 plan.ext_tables)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_matvec(ring, fuse):
    diagonals = _dense8x8(ring.slots)
    jstack, tstack = ring.stack(range(1, DIM))
    want = jp.build_ckks_matvec(ring.jc, diagonals, SCALE, ring.jenc,
                                fuse_moddown=fuse)(ring.a, jstack)
    step = T.build_ckks_matvec(ring.tc, diagonals, SCALE, ring.tenc, fuse_moddown=fuse,
                               device="cpu")
    got = step(to_tensor(ring.a, "cpu"), tstack)
    np.testing.assert_array_equal(want, to_numpy(got))
    assert ring.decode_err(got, diagonals) < 1e-4
    # one ciphertext without a batch axis gives the same residues
    np.testing.assert_array_equal(to_numpy(step(to_tensor(ring.a[0], "cpu"), tstack)),
                                  want[0])


@pytest.mark.parametrize("which,baby", [("dense8x8", None), ("dense8x8", 3), ("sparse", 2)])
def test_matvec_bsgs(ring, which, baby):
    diagonals = (_dense8x8 if which == "dense8x8" else _sparse)(ring.slots)
    jfn, jsteps = jp.build_ckks_matvec_bsgs(ring.jc, diagonals, SCALE, ring.jenc, baby=baby)
    step, steps = T.build_ckks_matvec_bsgs(ring.tc, diagonals, SCALE, ring.tenc, baby=baby,
                                           device="cpu")
    assert steps == jsteps
    jstack, tstack = ring.stack(steps)
    want = jfn(ring.a, jstack)
    got = step(to_tensor(ring.a, "cpu"), tstack)
    np.testing.assert_array_equal(want, to_numpy(got))
    assert ring.decode_err(got, diagonals) < 1e-4


def test_matvec_without_rotations(ring):
    diagonals = {0: _dense8x8(ring.slots)[0]}
    want = jp.build_ckks_matvec(ring.jc, diagonals, SCALE, ring.jenc)(ring.a, None)
    got = T.build_ckks_matvec(ring.tc, diagonals, SCALE, ring.tenc, device="cpu")(
        to_tensor(ring.a, "cpu"), None)
    np.testing.assert_array_equal(want, to_numpy(got))
    with pytest.raises(ValueError, match="collide"):
        T.build_ckks_matvec_bsgs(ring.tc, {1: [0.0], 1 - ring.slots: [0.0]}, SCALE, ring.tenc,
                                 device="cpu")
