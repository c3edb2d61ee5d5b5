"""Galois automorphisms x -> x^elt in the NTT domain (kernel ``galois``).

Port of the NTT-domain part of gemini_seal_tpu/ops/galois.py (the
reference's GaloisTool, native/src/seal/util/galois.{h,cpp}).  In the NTT
domain the automorphism is a pure permutation of each row's coefficients
(a bit-reversed index map, galois.cpp:18-47).  The element maps and the
permutation tables are host numpy, cached per element; each table is
mirrored once as an int64 tensor on the context's device.

:func:`galois_permute` is the kernel wrapper: one launch applies R tables
to every row of a [..., rows, N] tensor and writes [..., R, rows, N], so a
ciphertext's two components, or every mod-up digit for every rotation of a
hoisted batch, move in one pass.  The power-basis form (``apply_galois``,
a gather with a sign flip) belongs to the BFV rotation path and is not
ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils import numth
from . import cuda
from .backend import is_cuda

__all__ = ["GaloisTool", "galois_permute", "galois_plain"]


def galois_plain(x, tabs):
    """Plain version of :func:`galois_permute`."""
    R, N = tabs.shape
    out = x.index_select(-1, tabs.reshape(-1))            # [..., rows, R*N]
    out = out.reshape(x.shape[:-1] + (R, N))
    return out.movedim(-2, -3).contiguous()               # [..., R, rows, N]


def galois_permute(x, tabs):
    """out[..., r, row, j] = x[..., row, tabs[r, j]].

    x: int64[..., rows, N]; tabs: int64[R, N] permutation tables of the
    ring, on x's device.  Returns int64[..., R, rows, N].
    """
    if not is_cuda(x, tabs):
        return galois_plain(x, tabs)
    if x.dim() < 2 or tabs.dim() != 2 or tabs.shape[-1] != x.shape[-1]:
        raise ValueError(f"galois: x is [..., rows, N] and tabs [R, N], got "
                         f"{tuple(x.shape)} and {tuple(tabs.shape)}")
    cuda.check(x, "galois input")
    cuda.check(tabs, "galois tables")
    rows, N = x.shape[-2:]
    R = tabs.shape[0]
    if N < 2 or N & (N - 1) or R > 65535:
        raise ValueError(f"galois kernel: N={N} is not a ring degree (a power of two "
                         f">= 2), or R={R} tables exceed 65535")
    if tabs.data_ptr() % 16:
        raise ValueError("galois kernel: the tables must be 16-byte aligned")
    out = torch.empty(x.shape[:-2] + (R, rows, N), dtype=torch.int64, device=x.device)
    if out.numel() == 0:
        return out
    cuda.call("galois", cuda.ptr(out), cuda.ptr(x), cuda.ptr(tabs),
              x.numel() // (rows * N), rows, N, R)
    return out


class GaloisTool:
    """Per-degree automorphism helper (reference: galois.h).

    The fork sets the rotation generator to 5 (galois.h:169, matching the
    CKKS slot map's generator in ckks.cpp:40; upstream SEAL used 3)."""

    GENERATOR = 5

    def __init__(self, coeff_count_power: int, device):
        self.coeff_count_power = coeff_count_power
        self.coeff_count = 1 << coeff_count_power
        self.device = device
        self._ntt_tables: Dict[int, np.ndarray] = {}
        self._device_tables: Dict[tuple, torch.Tensor] = {}

    # -- element maps -----------------------------------------------------
    def get_elt_from_step(self, step: int, generator: int = None) -> int:
        """Rotation step -> Galois element gen^step mod 2N
        (reference: galois.cpp:49-91; the fork's generator is 5)."""
        n = self.coeff_count
        m = 2 * n
        if step == 0:
            return m - 1
        sign = step < 0
        pos_step = abs(step)
        if pos_step >= (n >> 1):
            raise ValueError("step count too large")
        pos_step &= m - 1
        step = (n >> 1) - pos_step if sign else pos_step
        gen = self.GENERATOR if generator is None else generator
        elt = 1
        for _ in range(step):
            elt = (elt * gen) & (m - 1)
        return elt

    def get_elts_from_steps(self, steps: Sequence[int]) -> List[int]:
        return [self.get_elt_from_step(s) for s in steps]

    def get_elts_all(self) -> List[int]:
        """Default key set: conjugation + the generator's power ladder
        (reference: galois.cpp:102-127)."""
        m = 2 * self.coeff_count
        elts = [m - 1]
        pos = self.GENERATOR
        neg = numth.try_invert_uint_mod(self.GENERATOR, m)
        for _ in range(self.coeff_count_power - 1):
            elts.append(pos)
            pos = (pos * pos) & (m - 1)
            elts.append(neg)
            neg = (neg * neg) & (m - 1)
        return elts

    # -- permutation tables ----------------------------------------------
    def _ntt_table(self, galois_elt: int) -> np.ndarray:
        """NTT-domain permutation (reference: galois.cpp:18-47), int64[N]."""
        hit = self._ntt_tables.get(galois_elt)
        if hit is not None:
            return hit
        n = self.coeff_count
        logn = self.coeff_count_power
        table = np.zeros(n, dtype=np.int64)
        for i in range(n, 2 * n):
            reversed_i = numth.reverse_bits(i, logn + 1)
            index_raw = ((galois_elt * reversed_i) >> 1) & (n - 1)
            table[i - n] = numth.reverse_bits(index_raw, logn)
        self._ntt_tables[galois_elt] = table
        return table

    def ntt_tables(self, galois_elts: Sequence[int]) -> torch.Tensor:
        """Stacked tables int64[R, N] of the given elements on the tool's
        device, uploaded once per element sequence and cached."""
        key = tuple(int(e) for e in galois_elts)
        hit = self._device_tables.get(key)
        if hit is None:
            for e in key:
                self._check_elt(e)
            tabs = np.stack([self._ntt_table(e) for e in key])
            hit = torch.from_numpy(tabs).to(self.device)
            self._device_tables[key] = hit
        return hit

    # -- application ------------------------------------------------------
    def apply_galois_ntt(self, x, galois_elt: int):
        """NTT-domain automorphism (pure permutation) over [..., L, N]: one
        ``galois`` launch for every row of x, whatever its leading axes."""
        tab = self.ntt_tables([galois_elt])
        return galois_permute(x.contiguous(), tab).reshape(x.shape)

    def _check_elt(self, galois_elt: int):
        if not (galois_elt & 1) or galois_elt >= 2 * self.coeff_count:
            raise ValueError("Galois element is not valid")
