"""Galois automorphisms x -> x^elt, NTT domain and power basis (kernel
``galois``).

Port of gemini_seal_tpu/ops/galois.py (the reference's GaloisTool,
native/src/seal/util/galois.{h,cpp}).  In the NTT domain the automorphism
is a pure permutation of each row's coefficients (a bit-reversed index map,
galois.cpp:18-47); in the power basis it is a permutation with a sign flip
where i * elt wraps past N (galois.cpp:144-186, inverted into a gather).
The element maps and the tables are host numpy, cached per element; each
table set is mirrored once as an int64 tensor on the context's device.  A
power-basis table entry carries its sign flag in bit log N, above the
index.

:func:`galois_permute` is the kernel wrapper: one launch applies R tables
to every row of a [..., rows, N] tensor and writes [..., R, rows, N] (a
ciphertext's two components, or every mod-up digit for every rotation of a
hoisted batch, move in one pass), or, paired, takes row block r of a
[..., R, rows, N] tensor through table r; signed, it negates mod p the
entries whose table entry carries the sign flag.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils import numth
from . import cuda
from .backend import is_cuda

__all__ = ["GaloisTool", "galois_permute", "galois_plain"]


def galois_plain(x, tabs, moduli=None, paired: bool = False):
    """Plain version of :func:`galois_permute`."""
    R, N = tabs.shape
    idx = tabs & (N - 1)
    if paired:
        out = torch.gather(x, -1, idx.reshape(R, 1, N).expand(x.shape))
    else:
        out = x.index_select(-1, idx.reshape(-1))             # [..., rows, R*N]
        out = out.reshape(x.shape[:-1] + (R, N)).movedim(-2, -3)
    if moduli is None:
        return out.contiguous()
    rows = x.shape[-2]
    p = moduli.reshape(-1).repeat(rows // moduli.numel()).reshape(rows, 1)
    flip = (tabs >= N).reshape(R, 1, N) & out.ne(0)          # the sign bit, neg_mod(0) = 0
    return torch.where(flip, p - out, out)


def galois_permute(x, tabs, moduli=None, paired: bool = False):
    """out[..., r, row, j] = f(x[..., row, tabs[r, j] mod N]), or with
    ``paired`` f(x[..., r, row, tabs[r, j] mod N]).

    x: int64[..., rows, N] (paired: [..., R, rows, N]); tabs: int64[R, N]
    tables of the ring, on x's device.  moduli: None (f is the identity), or
    the L moduli of the rows (row -> limb row % L; any shape of L elements):
    then f negates mod p_limb (0 stays 0) where tabs[r, j] >= N, the sign
    flag of a power-basis table.  Returns int64[..., R, rows, N].
    """
    tensors = (x, tabs) if moduli is None else (x, tabs, moduli)
    if not is_cuda(*tensors):
        return galois_plain(x, tabs, moduli, paired)
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
    L = 1
    if moduli is not None:
        cuda.check(moduli, "galois moduli")
        L = moduli.numel()
        if L < 1 or rows % L:
            raise ValueError(f"galois kernel: {rows} rows are not whole sets of {L} limbs")
    if paired:
        if x.dim() < 3 or x.shape[-3] != R:
            raise ValueError(f"galois paired: x {tuple(x.shape)} does not carry R={R}")
        out = torch.empty_like(x)
        B = x.numel() // (R * rows * N)
    else:
        out = torch.empty(x.shape[:-2] + (R, rows, N), dtype=torch.int64, device=x.device)
        B = x.numel() // (rows * N)
    if out.numel() == 0:
        return out
    mode = "_".join((["signed"] if moduli is not None else []) + (["paired"] if paired else []))
    cuda.call("galois", cuda.ptr(out), cuda.ptr(x), cuda.ptr(tabs), cuda.ptr(moduli),
              B, rows, N, R, L, int(paired), mode=mode or None)
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
        self._coeff_tables: Dict[int, tuple] = {}
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
    def _coeff_table(self, galois_elt: int):
        """Power-basis automorphism as (gather index, sign flag) per output
        position: result[(i*elt mod 2n) fold] = +-operand[i]
        (reference: galois.cpp:144-186), inverted into a gather."""
        hit = self._coeff_tables.get(galois_elt)
        if hit is not None:
            return hit
        n = self.coeff_count
        i = np.arange(n, dtype=np.int64)
        index_raw = i * galois_elt
        src = np.zeros(n, dtype=np.int64)    # result[j] reads operand[src[j]]
        neg = np.zeros(n, dtype=bool)
        src[index_raw & (n - 1)] = i
        neg[index_raw & (n - 1)] = ((index_raw >> self.coeff_count_power) & 1).astype(bool)
        entry = (src, neg)
        self._coeff_tables[galois_elt] = entry
        return entry

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

    def _tables(self, kind: str, galois_elts: Sequence[int]) -> torch.Tensor:
        """Stacked tables int64[R, N] of one kind for the given elements on
        the tool's device, uploaded once per element sequence and cached."""
        elts = tuple(int(e) for e in galois_elts)
        hit = self._device_tables.get((kind,) + elts)
        if hit is None:
            for e in elts:
                self._check_elt(e)
            if kind == "ntt":
                rows = [self._ntt_table(e) for e in elts]
            elif kind == "ntt_inverse":
                rows = [np.argsort(self._ntt_table(e)) for e in elts]
            else:  # "coeff": the sign flag in bit log N
                rows = [src | (neg.astype(np.int64) << self.coeff_count_power)
                        for src, neg in map(self._coeff_table, elts)]
            hit = torch.from_numpy(np.stack(rows)).to(self.device)
            self._device_tables[(kind,) + elts] = hit
        return hit

    def ntt_tables(self, galois_elts: Sequence[int]) -> torch.Tensor:
        """NTT-domain permutation tables int64[R, N] on the tool's device."""
        return self._tables("ntt", galois_elts)

    def ntt_inverse_tables(self, galois_elts: Sequence[int]) -> torch.Tensor:
        """The inverse permutations of :meth:`ntt_tables`, int64[R, N]: what
        counter-rotates a key (prepermute_galois_stack)."""
        return self._tables("ntt_inverse", galois_elts)

    def coeff_tables(self, galois_elts: Sequence[int]) -> torch.Tensor:
        """Power-basis tables int64[R, N] on the tool's device: entry j is
        src[j] | neg[j] << log N (:meth:`_coeff_table`)."""
        return self._tables("coeff", galois_elts)

    # -- application ------------------------------------------------------
    def apply_galois(self, x, galois_elt: int, limbs):
        """Power-basis automorphism over [..., L, N] (limbs: the rows'
        LimbConstants): one signed ``galois`` launch for every row of x,
        whatever its leading axes."""
        tab = self.coeff_tables([galois_elt])
        return galois_permute(x.contiguous(), tab, limbs.p).reshape(x.shape)

    def apply_galois_ntt(self, x, galois_elt: int):
        """NTT-domain automorphism (pure permutation) over [..., L, N]: one
        ``galois`` launch for every row of x, whatever its leading axes."""
        tab = self.ntt_tables([galois_elt])
        return galois_permute(x.contiguous(), tab).reshape(x.shape)

    def _check_elt(self, galois_elt: int):
        if not (galois_elt & 1) or galois_elt >= 2 * self.coeff_count:
            raise ValueError("Galois element is not valid")
