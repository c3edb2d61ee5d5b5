"""The control of `correct`: the reference put in the program's place,
computed one precision step below what the configuration states.

CKKS at a 2^40 scale gives decoded outputs of about 16-21 bits (after a
rescale, 2^31), above float16's 11, so its control computes the step's
answers from float16 messages in float16.  BFV states exact arithmetic mod
t (20 bits): its control computes in the next machine integer too narrow
for the step, int32 for the 40-bit products of a multiply and int16 for the
20-bit slots of a rotation.  The control's answers go through the same
comparison as the program's; the limits must fail them
(tests/test_bench_control.py)."""

from __future__ import annotations

import torch


def dtype_of(cfg: dict, step) -> torch.dtype:
    if cfg["scheme"] == "ckks":
        return torch.float16
    return torch.int32 if step.OPERANDS == 2 else torch.int16


def answers(step, msgs, traffic: dict, cfg: dict):
    """The step's answers for one input batch, computed from the messages
    cast down to the control's type."""
    low = torch.as_tensor(msgs).to(dtype_of(cfg, step))
    got = torch.as_tensor(step.expected(low, traffic, cfg))
    if cfg["scheme"] == "ckks":
        return got.to(torch.float64).to(torch.complex128)
    return got.long()
