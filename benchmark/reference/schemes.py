"""Plain decryption and decoding of CKKS and BFV ciphertexts, and the
answers each step should give.

Worked out from the parameters, the benchmark's own secret key and its
messages alone: SEAL's NTT convention and slot order (the smallest
primitive 2N-th root, slot i at the root's power g^i mod 2N with g the
configuration's slot generator), the CRT, the CKKS canonical embedding and
the BFV scale-and-round, and their inverses, which make the inputs.  Plain
PyTorch; it imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from .rns import (bitrev, addmod, crt_centered, mulmod, ntt_forward, ntt_inverse,
                  scale_round_mod_t)


def secret_key_residues(s, primes):
    """The ternary secret s (int64 [N] in {-1, 0, 1}) as residues [L, N]."""
    p = torch.tensor([int(q) for q in primes], dtype=torch.int64, device=s.device)
    return torch.remainder(s.unsqueeze(0), p.unsqueeze(1))


def secret_key_ntt(s, primes):
    """The NTT form of the secret key at the given primes, [L, N]."""
    return ntt_forward(secret_key_residues(s, primes), primes)


def slot_positions(n: int, generator: int):
    """Odd powers of the 2N-th root that slots 0 .. N/2 - 1 sit at:
    generator^i mod 2N (the second BFV row at their negations)."""
    pos, out = 1, []
    for _ in range(n // 2):
        out.append(pos)
        pos = pos * generator % (2 * n)
    return out


def _moduli(primes, device, dims: int):
    """The primes as an int64 tensor shaped to broadcast over [..., L, N]."""
    p = torch.tensor([int(q) for q in primes], dtype=torch.int64, device=device)
    return p.reshape((len(primes),) + (1,) * (dims - 1))


def ckks_encode_ntt(values, primes, scale: float, generator: int):
    """NTT-form plaintext residues [M, L, N] of slot values [M, N/2]: the
    inverse of ckks_decrypt_decode's embedding, times the scale, rounded."""
    m, half = values.shape
    n = 2 * half
    pos = slot_positions(n, generator)
    evals = torch.zeros(m, n, dtype=torch.complex128, device=values.device)
    v = values.to(torch.complex128)
    evals[:, torch.tensor([(g - 1) // 2 for g in pos], device=values.device)] = v
    evals[:, torch.tensor([(2 * n - g - 1) // 2 for g in pos], device=values.device)] = v.conj()
    j = torch.arange(n, device=values.device, dtype=torch.float64)
    twist = torch.polar(torch.ones_like(j), j * (math.pi / n))
    coeffs = (torch.fft.fft(evals, dim=-1) / (n * twist)).real
    ints = torch.round(coeffs * scale).long()
    return ntt_forward(torch.remainder(ints.unsqueeze(-2), _moduli(primes, ints.device, 2)),
                       primes)


def bfv_encode_scaled(values, primes, t: int, generator: int):
    """Power-basis residues [M, L, N] of Delta m for slot values [M, N]
    mod t: m is the inverse of bfv_decrypt_decode's slot map, and
    Delta m = m floor(Q/t) + floor((m (Q mod t) + (t + 1) / 2) / t), SEAL's
    rounding of Q m / t (multiply_add_plain_with_scaling_variant)."""
    n = values.shape[-1]
    logn = n.bit_length() - 1
    pos = slot_positions(n, generator)
    order = ([bitrev((g - 1) // 2, logn) for g in pos]
             + [bitrev((2 * n - g - 1) // 2, logn) for g in pos])
    evals = torch.zeros_like(values)
    evals[:, torch.tensor(order, device=values.device)] = values
    m = ntt_inverse(evals.unsqueeze(-2), [t]).squeeze(-2)                  # [M, N] mod t
    Q = math.prod(int(q) for q in primes)
    fix = (m * (Q % t) + (t + 1) // 2) // t
    p = _moduli(primes, m.device, 2)
    delta = torch.tensor([(Q // t) % int(q) for q in primes], dtype=torch.int64,
                         device=m.device).reshape(-1, 1)
    mm = m.unsqueeze(-2).expand(m.shape[0], len(primes), n)
    return addmod(mulmod(mm, delta.expand_as(mm), p), torch.remainder(fix.unsqueeze(-2), p), p)


def _phase(ct, s_ntt, primes):
    """c0 + c1 s of NTT-form ciphertexts ct [M, 2, L, N], as NTT-form
    residues [M, L, N]."""
    L = len(primes)
    p = torch.tensor([int(q) for q in primes], dtype=torch.int64,
                     device=ct.device).reshape(1, L, 1)
    s = s_ntt[:L].unsqueeze(0)
    ct = torch.remainder(ct, p.unsqueeze(0))      # any residue the program wrote, mod p
    return addmod(ct[:, 0], mulmod(ct[:, 1], s.expand_as(ct[:, 1]), p), p)


def ckks_decrypt_decode(ct, s_ntt, primes, scale: float, generator: int):
    """Slot values (complex128 [M, N/2]) of NTT-form CKKS ciphertexts
    ct [M, 2, L, N] at the primes of their level."""
    n = ct.shape[-1]
    coeffs = crt_centered(ntt_inverse(_phase(ct, s_ntt, primes), primes), primes) / scale
    # m(zeta^(2k+1)) = N ifft(m_j zeta^j)[k] with zeta = exp(i pi / N)
    j = torch.arange(n, device=ct.device, dtype=torch.float64)
    twist = torch.polar(torch.ones_like(j), j * (math.pi / n))
    evals = torch.fft.ifft(coeffs.to(torch.complex128) * twist, dim=-1) * n
    idx = torch.tensor([(g - 1) // 2 for g in slot_positions(n, generator)],
                       device=ct.device)
    return evals[:, idx]


def bfv_decrypt_decode(ct, s_ntt, primes, t: int, generator: int):
    """Slot values (int64 [M, N], rows of N/2) of power-basis BFV
    ciphertexts ct [M, 2, L, N]."""
    n = ct.shape[-1]
    L = len(primes)
    p = torch.tensor([int(q) for q in primes], dtype=torch.int64,
                     device=ct.device).reshape(1, L, 1)
    ct = torch.remainder(ct, p.unsqueeze(0))      # any residue the program wrote, mod p
    c1s = ntt_inverse(mulmod(ntt_forward(ct[:, 1], primes), s_ntt[:L].unsqueeze(0).expand(
        ct.shape[0], L, n), p), primes)
    x = addmod(ct[:, 0], c1s, p)
    m = scale_round_mod_t(x, primes, t)                              # [M, N] mod t
    evals = ntt_forward(m.unsqueeze(-2), [t]).squeeze(-2)           # SEAL order
    logn = n.bit_length() - 1
    pos = slot_positions(n, generator)
    first = [bitrev((g - 1) // 2, logn) for g in pos]
    second = [bitrev((2 * n - g - 1) // 2, logn) for g in pos]
    return evals[:, torch.tensor(first + second, device=ct.device)]


def rotate_slots(values, step: int, bfv_rows: bool):
    """Slots moved left by `step`: out[i] = in[i + step] (CKKS over all N/2
    slots; BFV within each of its two rows)."""
    if not bfv_rows:
        return torch.roll(values, -step, dims=-1)
    half = values.shape[-1] // 2
    return torch.cat([torch.roll(values[..., :half], -step, dims=-1),
                      torch.roll(values[..., half:], -step, dims=-1)], dim=-1)
