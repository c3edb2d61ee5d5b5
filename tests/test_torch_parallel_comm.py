"""The group layer of the port's schedules (gemini_seal_tpu_torch.parallel.
comm and mesh): the ThreadGroup's collectives against jax.lax's on root
conftest.py's virtual mesh (shard_map, jit); a rank that raises fails the
call instead of leaving the others waiting; the (dp, limb) layout and its
sub-groups against the JAX package's make_he_mesh and partition specs;
and the gloo DistGroup in four spawned processes, whose results and
collective bytes equal the ThreadGroup's.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gemini_seal_tpu.parallel import mesh as jmesh
from gemini_seal_tpu.parallel.ntt_sp import shard_map
from gemini_seal_tpu_torch.ops.backend import to_numpy
from gemini_seal_tpu_torch.parallel import mesh as tmesh
from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd, spawn
from torch_helpers import ckks64_context, one_torch_thread, parallel_bodies  # noqa: F401


def test_thread_collectives_equal_jax_lax():
    C = 4
    x = np.arange(C * 2 * 8, dtype=np.int64).reshape(2, C * 8) * 7 + 3
    perm = [(0, 2), (2, 3), (3, 0)]            # rank 1 receives nothing: zeros

    def body(xl):
        return (jax.lax.all_gather(xl, "x", axis=1, tiled=True),
                jax.lax.all_to_all(xl.reshape(2, C, 2), "x", 1, 1),
                jax.lax.ppermute(xl, "x", perm),
                jax.lax.psum(xl, "x"))

    mesh = Mesh(np.asarray(jax.devices()[:C]), axis_names=("x",))
    spec = P(None, "x")
    out_specs = (P(None, "x"), P(None, "x", None), spec, P(None, "x"))
    want = jax.jit(shard_map(body, mesh, (spec,), out_specs))(
        jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec)))
    want = [np.asarray(w) for w in want]

    def tbody(g, xl):
        return (g.all_gather(xl, axis=1), g.all_to_all(xl.reshape(2, C, 2), axis=1),
                g.ppermute(xl, perm), g.psum(xl))

    team = ThreadGroup(C, "cpu")
    xt = torch.from_numpy(x)
    outs = run_spmd(tbody, team, [xt[:, r * 8:(r + 1) * 8].contiguous() for r in range(C)])
    got = [np.concatenate([o[k].numpy() for o in outs], axis=1) for k in range(4)]
    # the tiled all_gather gives every rank the whole of x
    np.testing.assert_array_equal(want[0][:, :C * 8], x)
    for o in outs:
        np.testing.assert_array_equal(o[0].numpy(), x)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert team.stats[0].count == {"all-gather": 1, "all-to-all": 1, "collective-permute": 1,
                                   "all-reduce": 1}
    assert team.stats[0].bytes["all-gather"] == x.nbytes


def test_a_rank_that_raises_fails_the_call():
    team = ThreadGroup(4, "cpu", timeout=60)

    def body(g):
        if g.rank == 2:
            raise KeyError("rank 2 fails")
        return g.all_gather(torch.zeros(1), axis=0)      # the others wait here

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="rank 2 fails"):
        run_spmd(body, team)
    assert time.perf_counter() - t0 < 30
    # the team is usable again after the failure
    out = run_spmd(lambda g: g.psum(torch.ones(2, dtype=torch.int64)), team)
    assert all(torch.equal(o, torch.full((2,), 4)) for o in out)
    assert not [t for t in threading.enumerate() if t.name.startswith("gst-rank-")]


def test_a_rank_that_never_arrives_breaks_the_barrier():
    team = ThreadGroup(2, "cpu", timeout=1.0)
    with pytest.raises(threading.BrokenBarrierError):
        run_spmd(lambda g: g.psum(torch.ones(1)) if g.rank == 0 else None, team)


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_mesh_split_equals_the_jax_package(size):
    want = jmesh.make_he_mesh(n_devices=size).shape
    got = tmesh.make_he_mesh(size)
    assert got.shape == dict(want)
    for dp in (1, 2):
        if size % dp == 0:
            assert tmesh.make_he_mesh(size, dp=dp).shape == dict(
                jmesh.make_he_mesh(n_devices=size, dp=dp).shape)
    with pytest.raises(ValueError, match="dp\\*limb"):
        tmesh.make_he_mesh(size, dp=3, limb=3)


def test_specs_and_shards_follow_the_jax_shardings():
    m = jmesh.make_he_mesh(n_devices=8, dp=2, limb=4)
    assert tuple(jmesh.ciphertext_sharding(m).spec) == tmesh.ciphertext_spec(True)
    assert tuple(jmesh.ciphertext_sharding(m, batched=False).spec) == tmesh.ciphertext_spec(False)
    assert tuple(jmesh.key_sharding(m).spec) == tmesh.key_spec()
    mesh = tmesh.make_he_mesh(8, dp=2, limb=4)
    x = torch.arange(4 * 2 * 8 * 3).reshape(4, 2, 8, 3)
    spec = tmesh.ciphertext_spec(True)
    blocks = [tmesh.shard(x, spec, mesh, r) for r in range(8)]
    assert blocks[5].shape == (2, 2, 2, 3)
    assert torch.equal(blocks[5], x[2:4, :, 2:4])                 # dp 1, limb 1
    assert torch.equal(tmesh.unshard(blocks, spec, mesh), x)
    assert torch.equal(tmesh.shard(x, tmesh.replicate_spec(4), mesh, 6), x)
    # the limb sub-group of rank 5: ranks 4..7 of the team
    team = ThreadGroup(8, "cpu", mesh=mesh)
    outs = run_spmd(lambda g, b: tmesh.limb_group(g).all_gather(b, axis=2), team, blocks)
    assert torch.equal(outs[5], x[2:4])
    assert team.stats[5].bytes["all-gather"] == x[2:4].numel() * 8


def test_gloo_processes_equal_the_threads():
    """Four gloo processes (DistGroup, a (dp=2, limb=2) layout) and four
    threads run the same bodies at N=64: equal results, equal collective
    counts and bytes."""
    import gemini_seal_tpu_torch as T

    ctx = ckks64_context()
    kg = T.KeyGenerator(ctx, device="cpu")
    enc = T.Encryptor(ctx, kg.public_key(), device="cpu")
    encoder = T.CKKSEncoder(ctx, device="cpu")
    a = torch.stack([enc.encrypt(encoder.encode([0.25 * (i + 1)], 2.0 ** 25)).data
                     for i in range(2)])
    rk = kg.relin_keys().stacked(2)
    mesh = tmesh.make_he_mesh(4, dp=2, limb=2)
    spec = ("dp", None, "limb", None)
    shards = [tmesh.shard(a, spec, mesh, r) for r in range(4)]
    team = ThreadGroup(4, "cpu", mesh=mesh)
    threads = run_spmd(lambda g: parallel_bodies(g, shards, rk), team)
    procs = spawn(parallel_bodies, 4, "gloo", shards, rk, mesh=mesh)
    for r in range(4):
        got, stats = procs[r]
        for g, t in zip(got, threads[r]):
            assert torch.equal(g, t)
        assert stats == team.stats[r].as_dict()
    assert procs[0][1]["count"] == {"all-gather": 1, "all-reduce": 1, "all-to-all": 1,
                                    "collective-permute": 1}
    # and the step is the in-core one's
    step = T.build_ckks_mul_relin_rescale(ctx, device="cpu")(a, a, rk)
    joined = to_numpy(tmesh.unshard([threads[r][0] for r in range(4)], spec, mesh))
    np.testing.assert_array_equal(joined[..., :-1, :], to_numpy(step))


def test_thread_collectives_under_a_short_switch_interval():
    """Sixteen ranks (more than the host's cores), 40 rounds of psum,
    all_gather and ppermute with the interpreter switching threads every
    microsecond: every round's results and every rank's counts are exact
    (a slot read before its write, or a lost count, would break them)."""
    import sys

    C, rounds = 16, 40
    team = ThreadGroup(C, "cpu", timeout=120)

    def body(g):
        bad = 0
        for i in range(rounds):
            x = torch.full((4,), g.rank * 1000 + i, dtype=torch.int64)
            s = g.psum(x)
            a = g.all_gather(x[:1], axis=0)
            p = g.ppermute(x, [(r, (r + 1) % C) for r in range(C)])
            bad += int(s[0] != sum(r * 1000 + i for r in range(C)))
            bad += int(not torch.equal(a, torch.arange(C) * 1000 + i))
            bad += int(p[0] != ((g.rank - 1) % C) * 1000 + i)
        return bad

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        bad = run_spmd(body, team)
    finally:
        sys.setswitchinterval(old)
    assert time.perf_counter() - t0 < 120
    assert bad == [0] * C
    assert all(s.count == {"all-reduce": rounds, "all-gather": rounds,
                           "collective-permute": rounds} for s in team.stats)
