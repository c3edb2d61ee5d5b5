"""The port's wire-to-wire server against the JAX package's on the CPU,
byte for byte: tests/test_serving.py's cases through both packages'
EncryptedComputeServer on the same blobs: the dense layer with deflate at
batch 4 and fewer requests than the batch (and the oversize, empty and
tampered batches), the encrypted matmul on (A, B) pairs with n_inputs=2,
the rejection of a bare blob on a two-operand server, and submit_stream
equal to submit (seeded blobs included).

Rings as the JAX tests': N=256 on [50, 40, 40, 50] and N=32 on [50, 40 x 4,
50], parms seed range(41, 49), scale 2^40.  The JAX package makes the keys
and the request blobs; convert.py carries the keys into the port.  The JAX
steps run eagerly on numpy inputs (test_torch_zoo.py's ``eager_jax``), so
nothing is compiled.
"""

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu import serialization as jser
from gemini_seal_tpu.models import pipelines as jp
from gemini_seal_tpu.models.serving import EncryptedComputeServer as JServer
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch import serialization as tser
from gemini_seal_tpu_torch.convert import galois_stack_from_array, secret_key_from_array
from gemini_seal_tpu_torch.models.serving import EncryptedComputeServer as TServer
from gemini_seal_tpu_torch.ops.backend import to_tensor
from test_torch_zoo import _key_array, eager_jax  # noqa: F401
from torch_helpers import one_torch_thread  # noqa: F401

SEED = tuple(range(41, 49))
SCALE = 2.0 ** 40


def _context(M, n, bits, **kw):
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(M.CoeffModulus.create(n, bits))
    parms.set_random_seed(SEED)
    return M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)


class Ring:
    def __init__(self, n, bits):
        self.jc = _context(J, n, bits)
        self.tc = _context(T, n, bits, device="cpu")
        self.jkg = J.KeyGenerator(self.jc)
        self.jenc = J.Encryptor(self.jc, public_key=self.jkg.public_key())
        self.jcod = J.CKKSEncoder(self.jc)
        self.tcod = T.CKKSEncoder(self.tc, device="cpu")
        self.sk = secret_key_from_array(self.tc, np.asarray(self.jkg.secret_key.data))
        self.dec = T.Decryptor(self.tc, self.sk, device="cpu")
        self.tool = self.jc.first_context_data().galois_tool
        self.jrk = _key_array(self.jkg.relin_keys(), 2)
        self.rk = to_tensor(self.jrk, "cpu")

    def galois(self, steps):
        elts = [self.tool.get_elt_from_step(s) for s in steps]
        gk = self.jkg.galois_keys(elts)
        arr = np.stack([_key_array(gk, e) for e in elts])
        return arr, galois_stack_from_array(self.tc, arr)

    def blob(self, values, compr=jser.COMPR_NONE):
        return jser.save(self.jenc.encrypt(self.jcod.encode(list(values), SCALE)), compr)

    def decode(self, blob):
        return np.asarray(self.tcod.decode(self.dec.decrypt(tser.load_ciphertext(blob,
                                                                                 self.tc))))


@pytest.fixture(scope="module")
def dense_ring():
    return Ring(256, [50, 40, 40, 50])


@pytest.fixture(scope="module")
def matmul_ring():
    return Ring(32, [50, 40, 40, 40, 40, 50])


def _dense_servers(ring, seed, batch_size, compr):
    dim = 4
    rng = np.random.default_rng(seed)
    M = rng.uniform(-0.5, 0.5, size=(dim, dim))
    b = rng.uniform(-0.2, 0.2, size=dim)
    slots = ring.tcod.slot_count
    diagonals = {d: [M[i % dim, (i + d) % dim] for i in range(slots)] for d in range(dim)}
    bias = [b[i % dim] for i in range(slots)]
    jgk, tgk = ring.galois([1, 2, 3])
    jlayer, jpid, jscale = jp.build_ckks_dense_layer(ring.jc, diagonals, bias, SCALE, ring.jcod)
    tlayer, tpid, tscale = T.build_ckks_dense_layer(ring.tc, diagonals, bias, SCALE, ring.tcod,
                                                    device="cpu")
    assert (tpid, tscale) == (jpid, jscale)
    jsrv = JServer(ring.jc, jlayer, [jgk, ring.jrk], out_parms_id=jpid, out_is_ntt=True,
                   out_scale=jscale, batch_size=batch_size, compr_mode=compr)
    tsrv = TServer(ring.tc, tlayer, [tgk, ring.rk], tpid, True, tscale, batch_size,
                   compr_mode=compr, device="cpu")
    return jsrv, tsrv, M, b, rng


def test_wire_to_wire_dense_layer(dense_ring):
    """tests/test_serving.py::test_wire_to_wire_dense_layer in both packages."""
    jsrv, tsrv, M, b, rng = _dense_servers(dense_ring, 3, 4, tser.COMPR_DEFLATE)
    xs = [rng.uniform(-1, 1, size=4) for _ in range(3)]
    blobs = [dense_ring.blob([x[i % 4] for i in range(128)]) for x in xs]
    outs = tsrv.submit(blobs)
    assert outs == jsrv.submit(blobs) and len(outs) == 3
    for x, blob in zip(xs, outs):
        assert blob[5] == tser.COMPR_DEFLATE
        assert np.abs(dense_ring.decode(blob)[:4] - (M @ x + b) ** 2).max() < 1e-3
    with pytest.raises(ValueError, match="exceeds compiled"):
        tsrv.submit(blobs * 2)
    assert tsrv.submit([]) == []
    bad = bytearray(blobs[0])
    bad[40] ^= 0xFF
    with pytest.raises(ValueError):
        tsrv.submit([bytes(bad)])
    with pytest.raises(ValueError):
        jsrv.submit([bytes(bad)])


def test_wire_to_wire_matmul_pairs(matmul_ring):
    """tests/test_serving.py::test_wire_to_wire_matmul_pairs in both
    packages: (A, B) pairs, one stacked batch per operand."""
    ring, d = matmul_ring, 4
    jfn, jpid, jscale = jp.build_ckks_matmul_square(ring.jc, d, SCALE, ring.jcod)
    tfn, tpid, tscale = T.build_ckks_matmul_square(ring.tc, d, SCALE, ring.tcod, device="cpu")
    assert tfn.rot_steps == jfn.rot_steps and (tpid, tscale) == (jpid, jscale)
    jgk, tgk = ring.galois(jfn.rot_steps)
    jsrv = JServer(ring.jc, jfn, [jgk, ring.jrk], out_parms_id=jpid, out_is_ntt=True,
                   out_scale=jscale, batch_size=4, n_inputs=2)
    tsrv = TServer(ring.tc, tfn, [tgk, ring.rk], tpid, True, tscale, 4, n_inputs=2,
                   device="cpu")
    rng = np.random.default_rng(9)
    mats = [(rng.uniform(-1, 1, (d, d)), rng.uniform(-1, 1, (d, d))) for _ in range(3)]
    reqs = [(ring.blob(A.flatten()), ring.blob(B.flatten())) for A, B in mats]
    outs = tsrv.submit(reqs)
    assert outs == jsrv.submit(reqs) and len(outs) == 3
    for (A, B), blob in zip(mats, outs):
        assert np.abs(ring.decode(blob)[: d * d] - (A @ B).flatten()).max() < 1e-2
    with pytest.raises(ValueError, match="needs 2 ciphertext"):
        tsrv.submit([(reqs[0][0],)])
    # a bare blob on a two-operand server (test_multi_operand_rejects_bare_blob)
    for srv in (tsrv, jsrv):
        with pytest.raises(ValueError, match="pass tuples"):
            srv.submit([reqs[0][0]])
        with pytest.raises(ValueError, match="pass tuples"):
            srv.warm(reqs[0][0])


def test_submit_stream_matches_submit(dense_ring):
    """tests/test_serving.py::test_submit_stream_matches_submit in both
    packages, and seed-compressed requests through the same server."""
    jsrv, tsrv, M, b, rng = _dense_servers(dense_ring, 11, 3, tser.COMPR_NONE)
    batches = []
    for k in range(3):
        xs = [rng.uniform(-1, 1, size=4) for _ in range(2 + k % 2)]
        batches.append([dense_ring.blob([x[i % 4] for i in range(128)]) for x in xs])
    want = [jsrv.submit(bl) for bl in batches]
    assert [tsrv.submit(bl) for bl in batches] == want
    assert list(tsrv.submit_stream(batches)) == want
    assert list(tsrv.submit_stream([batches[0], [], batches[1]])) == [want[0], want[1]]
    tsrv.warm(batches[0][0])
    enc = T.Encryptor(dense_ring.tc, secret_key=dense_ring.sk, device="cpu")
    seeded = [enc.encrypt_symmetric_serializable(dense_ring.tcod.encode([0.25 * i], SCALE))
              for i in range(3)]
    blobs = [s.save() for s in seeded]
    got = tsrv.submit(blobs)
    assert got == jsrv.submit(blobs) == list(tsrv.submit_stream([blobs]))[0]
    assert got == tsrv.submit([tser.save(s.ct) for s in seeded])
