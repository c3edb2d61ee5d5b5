"""Helpers of the port's CPU tests.

- ``contiguous_calls``: what the card demands of a kernel call, asserted on
  the CPU.  On a CUDA tensor every kernel wrapper of the port checks that
  each tensor it is handed is contiguous and raises otherwise; on a CPU
  tensor it runs the plain version, which takes any strides.  The context
  wraps every kernel wrapper wherever a module of the port holds it and
  asserts the same contiguity, so that a missing ``.contiguous()`` on a
  path shows in the CPU tests and not only on the card.
- ``one_torch_thread``: a module-scoped fixture that a test module imports
  to run its plain versions on one torch thread.  Their tensors hold a few
  thousand words, where intra-op threads only add overhead, and the suite
  runs six workers at once: at torch's default thread count six concurrent
  runs of tests/test_torch_matvec.py took 285 s each on an 8-core host, at
  one thread 10 s.
"""

import contextlib
import importlib
import pkgutil
import sys

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tensors(values):
    for v in values:
        if hasattr(v, "is_contiguous"):
            yield v
        elif isinstance(v, (tuple, list)):
            yield from _tensors(v)


@contextlib.contextmanager
def contiguous_calls():
    import gemini_seal_tpu_torch

    for info in pkgutil.walk_packages(gemini_seal_tpu_torch.__path__, "gemini_seal_tpu_torch."):
        importlib.import_module(info.name)
    from gemini_seal_tpu_torch.models import pipelines
    from gemini_seal_tpu_torch.ops import (dyadic, galois, modops, modraise, ntt, ntt_mxu, ntt_sp,
                                           rnsops)

    wrappers = [ntt.ntt_forward_lazy, ntt.ntt_forward, ntt.ntt_inverse_lazy,
                ntt.ntt_inverse, ntt.ntt_sub_row, ntt_sp.ntt_sp_exchange, ntt_sp.ntt_sp_rows,
                pipelines._tensor_product, modops.contract_mulmod_128,
                modops.rns_elementwise, galois.galois_permute, rnsops.behz,
                rnsops.scale_round, modraise.mod_raise_lift, dyadic.modulo_poly_coeffs,
                dyadic.negacyclic_shift_poly, dyadic.negacyclic_mono_mul_poly,
                dyadic.poly_infty_norm, ntt_mxu.mxu_pass]

    def strict(fn):
        def call(*args, **kwargs):
            for t in _tensors(list(args) + list(kwargs.values())):
                assert t.is_contiguous(), (
                    f"{fn.__name__}: a {tuple(t.shape)} argument with strides "
                    f"{t.stride()} would be refused by the kernel")
            return fn(*args, **kwargs)
        return call

    by_id = {id(fn): (fn, strict(fn)) for fn in wrappers}
    patched = []
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] != "gemini_seal_tpu_torch" or mod is None:
            continue
        for attr, value in list(vars(mod).items()):
            fn, wrapper = by_id.get(id(value), (None, None))
            if fn is not None and fn is value:
                setattr(mod, attr, wrapper)
                patched.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)


def ckks64_context(device="cpu"):
    """The port's N=64, [30] * 5 CKKS context with one special prime and
    parms seed range(91, 99) (the JAX key-switch tests' small ring)."""
    import gemini_seal_tpu_torch as T

    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(T.CoeffModulus.create(64, [30] * 5))
    parms.set_n_special_primes(1)
    parms.set_random_seed(tuple(range(91, 99)))
    return T.SealContext(parms, sec_level=T.SecLevelType.none, device=device)


def parallel_bodies(group, a_shards, rk):
    """What tests/test_torch_parallel_comm.py runs on each rank, as a thread
    and as a gloo process (a module-level function, so that a spawned
    process can import it): the limb-sharded mul + relin + rescale step on
    the group's (dp, limb) layout, then an all_to_all and a ppermute whose
    permutation is not an involution over the whole group."""
    from gemini_seal_tpu_torch.ops.keyswitch import KeySwitchPlan
    from gemini_seal_tpu_torch.parallel.keyswitch_sp import ckks_mul_relin_rescale_limb_sharded

    torch.set_num_threads(1)
    ctx = ckks64_context()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    x = a_shards[group.rank]
    step = ckks_mul_relin_rescale_limb_sharded(x, x, rk, plan, group)
    n = group.size
    y = group.all_to_all(torch.arange(4 * n).reshape(n, 4) + 100 * group.rank, axis=0)
    z = group.ppermute(torch.full((3,), group.rank), [(r, (r + 1) % n) for r in range(n - 1)])
    return [step, y, z]


def nccl_bodies(group, a, rk):
    """One rank of tests/test_torch_gpu.py's NCCL test (a process of its
    own on card `rank`): the limb-sharded and the coefficient-sharded mul +
    relin + rescale steps of the N=64 ring on this rank's shards of a."""
    from gemini_seal_tpu_torch.ops.keyswitch import KeySwitchPlan
    from gemini_seal_tpu_torch.parallel.keyswitch_sp import ckks_mul_relin_rescale_limb_sharded
    from gemini_seal_tpu_torch.parallel.pipeline_csp import ckks_mul_relin_rescale_coeff_sharded

    dev = torch.device("cuda", torch.cuda.current_device())
    ctx = ckks64_context(dev)
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    r, C = group.rank, group.size
    rows = a.shape[-2] // C
    x = a[..., r * rows:(r + 1) * rows, :].contiguous().to(dev)
    limb = ckks_mul_relin_rescale_limb_sharded(x, x, rk.to(dev), plan, group)
    b = a.shape[-1] // C
    x = a[..., r * b:(r + 1) * b].contiguous().to(dev)
    k = rk[..., r * b:(r + 1) * b].contiguous().to(dev)
    csp = ckks_mul_relin_rescale_coeff_sharded(x, x, k, plan, group)
    return [limb.cpu(), csp.cpu()]
