"""Residue arithmetic for the plain reference: modular products, the
negacyclic NTT in SEAL's order, and the CRT.

Plain PyTorch on int64 tensors holding residues below primes under 2^52,
on whatever device the tensors are on.  Nothing here comes from the
program under test: the roots, the tables and the CRT constants are worked
out again from the primes.
"""

from __future__ import annotations

from functools import lru_cache

import torch

MAX_PRIME_BITS = 52


def mulmod(a, b, p):
    """a * b mod p, elementwise, for residues a, b in [0, p) and p < 2^52.

    The quotient is estimated in float64 (off by at most one: a * b / p is
    below 2^52 and carries a relative error under 2^-51), and the remainder
    a * b - q * p is formed in wrapping 64-bit arithmetic, where it is exact
    once brought into [0, p)."""
    q = torch.floor(a.double() * b.double() / p.double()).long()
    r = a * b - q * p
    r = torch.where(r < 0, r + p, r)
    return torch.where(r >= p, r - p, r)


def addmod(a, b, p):
    s = a + b
    return torch.where(s >= p, s - p, s)


def submod(a, b, p):
    d = a - b
    return torch.where(d < 0, d + p, d)


def _is_primitive_2n_root(r: int, p: int, two_n: int) -> bool:
    return pow(r, two_n // 2, p) == p - 1


@lru_cache(maxsize=None)
def minimal_root(p: int, two_n: int) -> int:
    """The smallest primitive 2N-th root of unity mod p (SEAL's
    try_minimal_primitive_root)."""
    if (p - 1) % two_n:
        raise ValueError(f"{p} has no primitive {two_n}-th root")
    root = None
    for g in range(2, p):
        r = pow(g, (p - 1) // two_n, p)
        if _is_primitive_2n_root(r, p, two_n):
            root = r
            break
    best, cur, step = root, root, root * root % p
    for _ in range(two_n // 2 - 1):
        cur = cur * step % p
        best = min(best, cur)
    return best


def bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


@lru_cache(maxsize=None)
def _root_powers(p: int, n: int):
    """psi^bitrev(k) for k < n (SEAL's root_powers) and their inverses."""
    logn = n.bit_length() - 1
    psi = minimal_root(p, 2 * n)
    pw = [1] * n
    for j in range(1, n):
        pw[j] = pw[j - 1] * psi % p
    # psi^-j = psi^(2N - j) = -psi^(N - j), since psi^N = -1
    inv_pw = [1] + [p - pw[n - j] for j in range(1, n)]
    rev = [bitrev(k, logn) for k in range(n)]
    return [pw[r] for r in rev], [inv_pw[r] for r in rev]


def _tables(primes, n, device):
    fwd, inv = zip(*(_root_powers(int(p), n) for p in primes))
    return (torch.tensor(fwd, dtype=torch.int64, device=device),
            torch.tensor(inv, dtype=torch.int64, device=device))


def _check(primes, n):
    if n < 2 or n & (n - 1):
        raise ValueError(f"N={n} is not a power of two")
    for p in primes:
        if int(p).bit_length() > MAX_PRIME_BITS:
            raise ValueError(f"prime {p} is wider than {MAX_PRIME_BITS} bits")


def ntt_forward(x, primes):
    """Negacyclic NTT of x [..., L, N] limb by limb (limb l mod primes[l]),
    in SEAL's output order: entry i is x(psi^(2 bitrev(i) + 1)), psi the
    smallest primitive 2N-th root (Cooley-Tukey, util/ntt.cpp)."""
    n = x.shape[-1]
    _check(primes, n)
    fwd, _ = _tables(primes, n, x.device)
    p = torch.tensor([int(q) for q in primes], dtype=torch.int64, device=x.device)
    lead = x.shape[:-2]
    L = len(primes)
    x = x.reshape(-1, L, n).clone()
    m, t = 1, n // 2
    while m < n:
        v = x.reshape(-1, L, m, 2, t)
        w = fwd[:, m:2 * m].reshape(1, L, m, 1)
        pp = p.reshape(1, L, 1, 1)
        u = v[:, :, :, 0, :]
        y = mulmod(v[:, :, :, 1, :], w.expand_as(u), pp)
        x = torch.stack([addmod(u, y, pp), submod(u, y, pp)], dim=3).reshape(-1, L, n)
        m, t = 2 * m, t // 2
    return x.reshape(lead + (L, n))


def ntt_inverse(x, primes):
    """The inverse of ntt_forward: each butterfly undone in reverse order,
    then the factor N^-1 mod p."""
    n = x.shape[-1]
    _check(primes, n)
    _, inv = _tables(primes, n, x.device)
    p = torch.tensor([int(q) for q in primes], dtype=torch.int64, device=x.device)
    lead = x.shape[:-2]
    L = len(primes)
    x = x.reshape(-1, L, n).clone()
    m, t = n // 2, 1
    while m >= 1:
        v = x.reshape(-1, L, m, 2, t)
        w = inv[:, m:2 * m].reshape(1, L, m, 1)
        pp = p.reshape(1, L, 1, 1)
        a, b = v[:, :, :, 0, :], v[:, :, :, 1, :]
        x = torch.stack([addmod(a, b, pp), mulmod(submod(a, b, pp), w.expand_as(a), pp)],
                        dim=3).reshape(-1, L, n)
        m, t = m // 2, t * 2
    n_inv = torch.tensor([pow(n, int(q) - 2, int(q)) for q in primes], dtype=torch.int64,
                         device=x.device).reshape(1, L, 1)
    x = mulmod(x, n_inv.expand_as(x), p.reshape(1, L, 1))
    return x.reshape(lead + (L, n))


def garner_digits(res, primes):
    """Mixed-radix digits v of the CRT value x in [0, Q) of residues
    res [..., L, N]: x = sum_i v_i prod_{j<i} q_j, v_i in [0, q_i)."""
    L = len(primes)
    qs = [int(q) for q in primes]
    dev = res.device
    digits = [res[..., 0, :]]
    for i in range(1, L):
        qi = qs[i]
        pi = torch.tensor(qi, dtype=torch.int64, device=dev)
        acc = torch.remainder(digits[0], pi)
        radix = 1
        for j in range(1, i):
            radix = radix * qs[j - 1] % qi
            c = torch.full_like(acc, radix)
            acc = addmod(acc, mulmod(torch.remainder(digits[j], pi), c, pi), pi)
        prod = 1
        for j in range(i):
            prod = prod * qs[j] % qi
        inv = torch.full_like(acc, pow(prod, qi - 2, qi))
        digits.append(mulmod(submod(res[..., i, :], acc, pi), inv, pi))
    return digits


def crt_centered(res, primes):
    """The CRT value of res [..., L, N] centred into (-Q/2, Q/2], as
    float64 [..., N] (exact while it is below 2^53 in magnitude)."""
    qs = [int(q) for q in primes]
    Q = 1
    for q in qs:
        Q *= q
    half = Q // 2
    h_digits = []
    rest = half
    for q in qs:
        h_digits.append(rest % q)
        rest //= q
    v = garner_digits(res, primes)
    gt = torch.zeros_like(v[0], dtype=torch.bool)
    eq = torch.ones_like(v[0], dtype=torch.bool)
    for i in reversed(range(len(qs))):
        gt |= eq & (v[i] > h_digits[i])
        eq &= v[i] == h_digits[i]
    neg = gt
    # x - Q = sum_i (v_i - (q_i - 1)) prod_{j<i} q_j - 1: the high digits of
    # a small negative value vanish just as a small positive value's do.
    # Horner from the top digit: val = (d_{L-1} q_{L-2} + d_{L-2}) q_{L-3} + ...
    val = None
    for i in reversed(range(len(qs))):
        d = torch.where(neg, v[i] - (qs[i] - 1), v[i]).double()
        val = d if i == len(qs) - 1 else val * float(qs[i]) + d
    return torch.where(neg, val - 1.0, val)


def scale_round_mod_t(res, primes, t: int):
    """round(t x / Q) mod t of the CRT value x in [0, Q) of res [..., L, N]
    (BFV decryption's last step), as int64 [..., N].  t x / Q is summed in
    float64 from the mixed-radix digits, sum_i t v_i / prod_{j>=i} q_j: its
    error is about t 2^-53, far inside the distance of a decryptable value
    from the rounding boundary."""
    qs = [int(q) for q in primes]
    v = garner_digits(res, primes)
    f = torch.zeros_like(v[0], dtype=torch.float64)
    for i in range(len(qs)):
        denom = 1.0
        for q in qs[i:]:
            denom *= float(q)
        f = f + v[i].double() / denom
    m = torch.round(f * float(t)).long()
    return torch.remainder(m, t)
