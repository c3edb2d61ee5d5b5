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
    from gemini_seal_tpu_torch.ops import dyadic, galois, modops, modraise, ntt, rnsops

    wrappers = [ntt.ntt_forward_lazy, ntt.ntt_forward, ntt.ntt_inverse_lazy,
                ntt.ntt_inverse, pipelines._tensor_product, modops.contract_mulmod_128,
                modops.rns_elementwise, galois.galois_permute, rnsops.behz,
                rnsops.scale_round, modraise.mod_raise_lift, dyadic.modulo_poly_coeffs,
                dyadic.negacyclic_shift_poly, dyadic.negacyclic_mono_mul_poly,
                dyadic.poly_infty_norm]

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
            if fn is value:
                setattr(mod, attr, wrapper)
                patched.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)
