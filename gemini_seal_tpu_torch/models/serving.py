"""Serving runtime: wire-format ingress -> one step on the card -> egress.

Port of gemini_seal_tpu/models/serving.py.  The reference is a library:
callers write their own server loop around eager C++ ops.  Here the serving
unit is a step over batched ciphertext tensors (any builder of
models.pipelines: matvec, dense layer, MLP, CNN, matmul, the
multiply + relinearize + rescale chains), and the runtime is the glue
around it:

- INGRESS: SEAL-wire ciphertext blobs (from any SEAL client, the
  byte-compatible format being the foreign-host boundary) are read and
  checked on the host (metadata and every residue bound; seed-compressed
  blobs expand their c1 here), stacked into a [B, size, L, N] host batch and
  uploaded in one copy;
- EXECUTE: the step runs once over the whole batch, called directly (no
  compile), with the keys uploaded once at construction;
- EGRESS: the result batch comes back in one copy and leaves as wire blobs
  (optionally deflated).

Batches are padded up to the server's batch size by repeating the last
request, so that every call has one shape; only the real results are
returned.  submit_stream overlaps a batch's host work with the card's work
on its neighbours: the batch is staged in pinned host memory, uploaded with
non_blocking=True on a side stream whose event the compute stream waits
for (the uploaded tensor is marked with record_stream, so that the caching
allocator keeps it until the step has read it), and its result is copied
back non_blocking into pinned memory behind the step, with an event that
the egress waits for before it saves the blobs.  Its blobs equal submit()'s
byte for byte.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from .. import serialization as ser
from ..ciphertext import Ciphertext
from ..context import SealContext
from ..ops.backend import to_numpy, to_tensor

__all__ = ["EncryptedComputeServer"]


def _upload_keys(k, device):
    if isinstance(k, (list, tuple)):
        return type(k)(_upload_keys(x, device) for x in k)
    if isinstance(k, torch.Tensor):
        return k.to(device).contiguous()
    return to_tensor(k, device)


class EncryptedComputeServer:
    """Batched encrypted-compute endpoint around one step.

    step: fn(ct_batch, ..., *key_args) -> int64[B, 2, L_out, N], one batch
    argument per ciphertext operand (n_inputs of them).
    key_args: key tensors (Galois stacks, relin keys, ...; a tensor, a host
    u64 array or a list of them), uploaded once.
    out_parms_id / out_is_ntt / out_scale: metadata of the step's output
    ciphertexts (from the pipeline builder).
    batch_size: the step's batch; requests are padded up to it.
    device: None means the card (raises when there is none).
    """

    def __init__(self, context: SealContext, step: Callable, key_args, out_parms_id,
                 out_is_ntt: bool, out_scale: float, batch_size: int, validate: bool = True,
                 compr_mode: int = ser.COMPR_NONE, n_inputs: int = 1, device=None):
        self.device = context.check_device(device)
        self.context = context
        self.batch_size = int(batch_size)
        self.out_parms_id = out_parms_id
        self.out_is_ntt = bool(out_is_ntt)
        self.out_scale = float(out_scale)
        self.validate = validate
        self.compr_mode = compr_mode
        self.n_inputs = int(n_inputs)   # ciphertext operands per request
        self._cuda = self.device.type == "cuda"
        self._keys = [_upload_keys(k, self.device) for k in key_args]
        self._step = step
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None

    def warm(self, example_request) -> None:
        """Run one example request (a blob, or a tuple of n_inputs blobs for
        a multi-operand server) ahead of traffic: the kernels are built and
        their tables made at the first call."""
        self.submit([example_request])

    def submit(self, ct_blobs: Sequence) -> List[bytes]:
        """Run the step over a batch of wire-format ciphertexts and return
        the results as wire-format blobs, in order.

        With n_inputs == 1 each request is one blob; with n_inputs > 1 each
        request is a tuple of blobs, one per ciphertext operand (e.g. (A, B)
        pairs for the encrypted matmul), and the step receives one stacked
        batch per operand position."""
        n_real = len(ct_blobs)
        if n_real == 0:
            return []
        out = self.run(self.upload(self.stage(self.load(ct_blobs))))
        return self.save(n_real, self.download(out))

    # ---- the stages, each on its own (chip_smoke.py times them apart) --------

    def _requests(self, ct_blobs):
        n_real = len(ct_blobs)
        if n_real > self.batch_size:
            raise ValueError(f"batch of {n_real} exceeds compiled batch_size "
                             f"{self.batch_size}; split the request")
        if self.n_inputs == 1:
            return [(b,) for b in ct_blobs]
        for r in ct_blobs:
            if isinstance(r, (bytes, bytearray)):
                raise ValueError(f"this server takes {self.n_inputs} ciphertext blobs per "
                                 "request — pass tuples, not bare blobs")
        reqs = [tuple(r) for r in ct_blobs]
        for r in reqs:
            if len(r) != self.n_inputs:
                raise ValueError(f"each request needs {self.n_inputs} ciphertext blobs, "
                                 f"got {len(r)}")
        return reqs

    def load(self, ct_blobs) -> List[List[np.ndarray]]:
        """Wire blobs -> per operand, the requests' host u64[size, L, N]
        arrays, read and checked (seed-compressed blobs expanded)."""
        reqs = self._requests(ct_blobs)
        operands = []
        for j in range(self.n_inputs):
            cts = [ser.load_ciphertext_host(r[j], self.context, validate=self.validate)
                   for r in reqs]
            if any(ct.parms_id != cts[0].parms_id for ct in cts):
                raise ValueError("batch ciphertexts must share a level")
            operands.append([ct.data for ct in cts])
        return operands

    def stage(self, operands) -> List[torch.Tensor]:
        """Per operand, the padded batch in one host tensor (pinned memory
        when the server runs on the card)."""
        staged = []
        for rows in operands:
            shape = (self.batch_size,) + tuple(rows[0].shape)
            host = torch.empty(shape, dtype=torch.int64, pin_memory=self._cuda)
            view = host.numpy().view(np.uint64)
            for i in range(self.batch_size):
                view[i] = rows[min(i, len(rows) - 1)]
            staged.append(host)
        return staged

    def upload(self, staged, stream=None) -> List[torch.Tensor]:
        """The staged batches on the card: one copy each, on `stream` when
        given (the compute stream then waits for it)."""
        if not self._cuda:
            return staged
        if stream is None:
            return [h.to(self.device, non_blocking=True) for h in staged]
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            dev = [h.to(self.device, non_blocking=True) for h in staged]
        compute.wait_stream(stream)
        for t in dev:
            t.record_stream(compute)
        return dev

    def run(self, batches) -> torch.Tensor:
        return self._step(*batches, *self._keys)

    def download(self, out: torch.Tensor) -> np.ndarray:
        """The result batch on the host, as u64 (waits for the step)."""
        return to_numpy(out)

    def save(self, n_real: int, out: np.ndarray) -> List[bytes]:
        return [ser.save(Ciphertext(out[i], self.out_parms_id, self.out_is_ntt, self.out_scale),
                         self.compr_mode)
                for i in range(n_real)]

    # ---- pipelined ingress/compute overlap ------------------------------------

    def submit_stream(self, request_batches):
        """Pipelined submit: yields each batch's result blobs in order, while
        the next batch's host work (load, check, stage), upload and launches
        proceed under the previous batch's execution on the card; the
        outputs equal per-batch submit()'s.

        request_batches: an iterable of blob lists (each as submit takes);
        empty ones are skipped."""
        if not self._cuda:
            for blobs in request_batches:
                if len(blobs):
                    yield self.submit(blobs)
            return
        prev = None
        for blobs in request_batches:
            n_real = len(blobs)
            if n_real == 0:
                continue
            staged = self.stage(self.load(blobs))
            out = self.run(self.upload(staged, self._copy_stream))
            host = torch.empty(out.shape, dtype=torch.int64, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            if prev is not None:
                yield self._finish(*prev)
            # staged and out stay referenced until their batch is finished
            prev = (n_real, host, done, staged, out)
        if prev is not None:
            yield self._finish(*prev)

    def _finish(self, n_real, host, done, staged, out) -> List[bytes]:
        done.synchronize()
        return self.save(n_real, host.numpy().view(np.uint64))
