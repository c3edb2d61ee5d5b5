"""The (dp, limb) layout of HE tensors over a group of ranks.

Port of gemini_seal_tpu/parallel/mesh.py.  The parallel axes over
ciphertext tensors [batch, size, L, N]:

- ``dp``: ciphertext-batch data parallelism, independent ciphertexts on
  independent ranks;
- ``limb``: RNS limb parallelism, each rank owning a contiguous block of
  the limb rows (the key switch and the base conversions contract over
  them: keyswitch_sp.py, behz_sp.py).

The JAX module builds a ``jax.sharding.Mesh`` and NamedShardings that
place a global array.  Here a rank holds its own shard as a tensor, so the
counterparts of ``ciphertext_sharding``, ``key_sharding`` and
``replicate`` are partition specs with :func:`shard` (a rank's block of a
global tensor) and :func:`unshard` (the global tensor from every rank's
block).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["HEMesh", "make_he_mesh", "ciphertext_spec", "key_spec", "replicate_spec",
           "shard", "unshard", "limb_group"]


@dataclass(frozen=True)
class HEMesh:
    """A (dp, limb) layout of dp * limb ranks, row-major: rank r has
    dp coordinate r // limb and limb coordinate r % limb."""

    dp: int
    limb: int

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("dp", "limb")

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.limb)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "limb": self.limb}

    def coords(self, rank: int) -> dict:
        return {"dp": rank // self.limb, "limb": rank % self.limb}


def make_he_mesh(size: int, dp: Optional[int] = None, limb: Optional[int] = None) -> HEMesh:
    """A (dp, limb) layout of `size` ranks (mesh.py:29-58's split).

    With only one axis size given, the other takes the remaining factor.
    Default: the largest power-of-two dp with at most half the ranks on dp,
    the rest on limb.
    """
    n = size
    if dp is None and limb is None:
        dp = 1
        while n % (dp * 2) == 0 and dp * 2 * 2 <= n:
            dp *= 2
        limb = n // dp
    elif dp is None:
        dp = n // limb
    elif limb is None:
        limb = n // dp
    if dp * limb != n:
        raise ValueError(f"dp*limb = {dp}*{limb} != n_devices = {n}")
    return HEMesh(dp, limb)


def ciphertext_spec(batched: bool = True, ndim: Optional[int] = None) -> Tuple:
    """Partition spec of ciphertext tensors (ciphertext_sharding):
    batched [B, size, L, N]: batch over dp, limbs over limb; unbatched
    [size, L, N] (or any [..., L, N] with ``batched=False``): limbs only.
    ``ndim`` gives the spec for a tensor of that rank."""
    if ndim is None:
        ndim = 4 if batched else 3
    spec = [None] * ndim
    spec[-2] = "limb"
    if batched:
        spec[0] = "dp"
    return tuple(spec)


def key_spec(ndim: int = 4) -> Tuple:
    """Key-switching keys [n_bundles, 2, L_key, N] (key_sharding):
    replicated over dp, the key limb axis over limb."""
    spec = [None] * ndim
    spec[-2] = "limb"
    return tuple(spec)


def replicate_spec(ndim: int) -> Tuple:
    """Every rank holds the whole tensor (replicate)."""
    return (None,) * ndim


def _slices(shape, spec, mesh: HEMesh, rank: int):
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a tensor of rank {len(shape)}")
    coords = mesh.coords(rank)
    out = []
    for n, axis in zip(shape, spec):
        if axis is None:
            out.append(slice(None))
            continue
        k = mesh.shape[axis]
        if n % k:
            raise ValueError(f"an axis of {n} does not split {k} ways over {axis!r}")
        b = n // k
        out.append(slice(coords[axis] * b, (coords[axis] + 1) * b))
    return tuple(out)


def shard(x: torch.Tensor, spec: Sequence, mesh: HEMesh, rank: int) -> torch.Tensor:
    """Rank `rank`'s contiguous block of the global tensor x under `spec`
    (an axis name, or None for a replicated axis, per dimension)."""
    return x[_slices(x.shape, tuple(spec), mesh, rank)].contiguous()


def unshard(blocks: Sequence[torch.Tensor], spec: Sequence, mesh: HEMesh) -> torch.Tensor:
    """The global tensor from every rank's block (blocks indexed by rank;
    the ranks that share a block under `spec` must hold equal copies)."""
    spec = tuple(spec)
    b0 = blocks[0]
    shape = [n * (mesh.shape[a] if a is not None else 1) for n, a in zip(b0.shape, spec)]
    out = torch.empty(shape, dtype=b0.dtype, device=b0.device)
    for r, blk in enumerate(blocks):
        out[_slices(out.shape, spec, mesh, r)] = blk
    return out


def limb_group(group):
    """The ranks a schedule's limb collectives run over: the group's
    ``limb`` axis, or the whole group when it has no such axis."""
    return group.sub("limb") if "limb" in group.axis_names else group
