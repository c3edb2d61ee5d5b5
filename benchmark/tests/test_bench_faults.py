"""A whole run of each cell at a small ring on the CPU, the look for a card
skipped: sound, it comes out correct; with the timed step broken
underneath, `correct` comes out false, once for each fault a one-card cell
can have (it has no exchange between cards to leave out):

- the step hands back its state unchanged;
- half of the batch left out: the second half's outputs are copies of the
  first half's;
- one answer altered where it is produced: a residue of the last row's
  output moved by one;
- half of the batch left out inside the key switch: the second half of the
  rows that enter the mod-up (c2 of a product, c1 of a rotation) are copies
  of the first half's.  Only inputs whose rows differ in c1 can show it."""

import contextlib

import pytest
import torch

from benchmark import harness
from benchmark.tests.small import CELLS, overrides

SEED = (1 << 31) + 977


def _run(cell, fault=None):
    return harness.run(cell, SEED, 0.2, False, device="cpu", overrides=overrides(cell),
                       fault=fault)


def unchanged(fn, step, traffic):
    return lambda *ops: step.unchanged(ops, traffic)


def half_batch(fn, step, traffic):
    def broken(*ops):
        out = fn(*ops)
        rows = out.shape[-4]
        half = out.narrow(-4, 0, rows // 2)
        return torch.cat([half, half], dim=-4)
    return broken


def altered(fn, step, traffic):
    def broken(*ops):
        out = fn(*ops).clone()
        out[..., -1, 0, 0, 0] += 1
        return out
    return broken


@contextlib.contextmanager
def _halved_modup():
    from gemini_seal_tpu_torch.models import pipelines
    from gemini_seal_tpu_torch.ops import keyswitch

    sound = keyswitch.compute_modup_digits

    def modup(x, *args, **kwargs):
        rows = x.shape[0]
        x = x.clone()
        x[rows - rows // 2:] = x[:rows // 2]
        return sound(x, *args, **kwargs)

    keyswitch.compute_modup_digits = pipelines.compute_modup_digits = modup
    try:
        yield
    finally:
        keyswitch.compute_modup_digits = pipelines.compute_modup_digits = sound


def keyswitch_half(fn, step, traffic):
    def broken(*ops):
        with _halved_modup():
            return fn(*ops)
    return broken


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered, keyswitch_half])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, fault):
    r = _run(cell, fault)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0
