"""The comparison that decides `correct`.

The answers are the program's output ciphertexts, decrypted and decoded by
the plain reference with the benchmark's own secret key; the expected
values are worked out from the messages alone.  CKKS is held by the
largest absolute error of any slot (`max_abs_err`), BFV by the count of
slots that differ (`wrong_slots`, exact).  Every answer due is compared:
`unchecked` counts those that were not.  Each number has its own limit,
set in limits/<cell>.json from the readings kept there.
"""

from __future__ import annotations

import torch

from .reference.schemes import bfv_decrypt_decode, ckks_decrypt_decode

BLOCK_BYTES = 1 << 28


def answers(items, sk_ntt, cfg: dict, primes, scale):
    """Decrypted and decoded slots of ciphertexts items [M, 2, L, N], in
    blocks of about 256 MB of ciphertext."""
    per = items[0].numel() * 8
    block = max(1, BLOCK_BYTES // per)
    sk = sk_ntt.to(items.device)
    out = []
    for lo in range(0, items.shape[0], block):
        ct = items[lo:lo + block]
        if cfg["scheme"] == "ckks":
            out.append(ckks_decrypt_decode(ct, sk, primes, scale, cfg["slot_generator"]))
        else:
            out.append(bfv_decrypt_decode(ct, sk, primes, cfg["plain_modulus"],
                                          cfg["slot_generator"]))
    return torch.cat(out)


def numbers(scheme: str, got, want, limits: dict):
    """The compared number of one batch of answers got [M, slots] against
    want, and how many answers fail its limit (an answer's own reading: its
    largest error, or its count of wrong slots)."""
    want = torch.as_tensor(want).to(got.device)
    if scheme == "ckks":
        row = (got - want.to(torch.complex128)).abs().amax(dim=-1)
        name, value = "max_abs_err", float(row.max())
    else:
        row = (got != want.long()).sum(dim=-1)
        name, value = "wrong_slots", int(row.sum())
    return {name: value}, int((row > limits["numbers"][name]["limit"]).sum())


def merge(a: dict, b: dict) -> dict:
    """Two batches' numbers as one: the largest error, the summed counts."""
    out = dict(a)
    for k, v in b.items():
        if k not in out:
            out[k] = v
        elif k == "max_abs_err":
            out[k] = max(out[k], v)
        else:
            out[k] += v
    return out


def judge(values: dict, limits: dict):
    """(correct, checks): every number at or under its limit; checks maps
    each name to its value and limit, for the result line."""
    checks = {}
    ok = True
    for name, spec in limits["numbers"].items():
        v = values.get(name)
        lim = spec["limit"]
        checks[name] = {"value": v, "limit": lim}
        if v is None or not (v <= lim):
            ok = False
    return ok, checks
