#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and check them.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # small rings on the CPU, plain versions
    python3 chip_smoke.py --nccl-only      # on four cards: only the NCCL phase

Thirty-five paths run, each driven once with every launch counter set to 0
just before it and read just after it.  Three are CKKS, on bench.py's ring
(N=8192, CoeffModulus.create(8192, [50, 40, 40, 50]), one special prime,
seed range(71, 79), scale 2^40):

- mul_relin_rescale (bench.py's step): keygen, encode of [1.001] * slots,
  public-key encrypt, broadcast to batch 128, the fused multiply +
  relinearize + rescale step, decrypt, decode (within 1e-4 of v^2);
- train_step (the flagship step of __graft_entry__.entry()): Galois keygen
  for step 1, encode of a seeded non-constant vector v, encrypt, batch 128,
  the sequential multiply + relinearize + rescale, rotate by one and add,
  decrypt, decode (within 1e-4 of v_i^2 + v_{i+1}^2);
- rotate_many (the hoisted rotations): Galois keygen for steps 1..8 and
  their counter-rotated stack, encrypt v, batch 16, eight rotations from
  one mod-up with each key form, decrypt, decode (each within 1e-4 of v
  shifted by its step; the two forms within 1e-5 of each other).

Two are BFV, on bench_all.py's rings with seed range(8) and
t = PlainModulus.batching(N, 20), each with keygen, BatchEncoder encode of
a seeded slot vector v in [0, t), public-key encrypt, batch 128, the step,
decrypt and decode (exactly v^2 mod t):

- bfv_mul_relin_chain (BASELINE config 3): N=8192,
  CoeffModulus.create(8192, [50, 40, 40, 40, 50]), SecLevelType.none; the
  BEHZ multiply + relinearize and the fused mod-switch to the last level;
- bfv_mul_relin (BASELINE config 1): N=4096, CoeffModulus.bfv_default(4096),
  SecLevelType.tc128; the BEHZ multiply + relinearize.

Five are the rest of bench_all.py's BASELINE configs and its N=65536 cell,
with its rings and seed range(8), nothing cut:

- bfv_rotate_rows (config 2): N=8192, bfv_default(8192), tc128, batch 128;
  apply_galois on both components (one signed ``galois`` launch), the
  power-basis switch_key of c1, add (bench_all.py:155-159), by one step;
  each row of the 2 x N/2 slot matrix decodes rotated by one, exactly;
- bfv_rotate_many (config 2'): the same ring, batch 16 x steps 1..8 from
  one mod-up, in both key forms; each step decodes exactly, and the
  counter-rotated form decodes equal to the default;
- ckks_mul_relin_rescale_n16384 (config 4): N=16384, [50, 40 x 4, 50],
  batch 128, the sequential step; decodes within 1e-4 of v^2;
- ckks_poly_eval_n32768 (config 5): N=32768, [59, 40 x 6, 59], scale
  2^40, batch 128, p(x) = 1 - x/2 + x^2/4 + x^3/8 + x^4/16 summed over 4
  adjacent slots ("flat" rotations, coeff_precision_bits 25), on a seeded
  non-constant v in [-1, 1]: each slot within 1e-3 of sum_{j<4} p(v_{i+j});
- n65536 (the SEAL cap): N=65536, [50, 40, 40, 50], the forward and
  inverse NTT of [16, 2, 4, 65536] random residues and the sequential
  multiply + relinearize + rescale at batch 16; decodes within 1e-4.

Two are bench_all.py's cells of the linear layers and the bootstrap, with
its rings and seed range(8):

- bootstrap_n4096 (bench_all.py:445-508): N=4096, plan_bootstrap_chain(4096,
  radix=4, nsp=3, restored=2) (24 primes, three of them special),
  linear_mode "split", EvalMod "cosine", scale 2^45; keygen of the 87
  rotation keys and the conjugation key, a seeded message (seed 13)
  encrypted and mod-switched to the last level, one refresh (mod-raise,
  three CoeffToSlot groups, the conjugation split, two Chebyshev EvalMods,
  three SlotToCoeff groups); the input and the refreshed output must have
  the sha256 digests of the JAX package's (BOOTSTRAP_N4096), so the
  decode's max error must be its 1.5640752616911192e-05;
- dense8x8_n8192 (bench_all.py:305-339): N=8192, [50, 40, 40, 50], the
  hoisted-rotation matvec (build_ckks_matvec, fused mod-down) of an 8x8
  matrix M (seed 1) on x = 0.5 at scale 2^40, batch 16; decodes within
  1e-4 of M x.

Four are the SEAL per-op API (examples/ex1-ex5 and ex8) through the port's
Evaluator, DeviceEvaluator and IntegerEncoder at the examples' own rings,
parms seed range(8), each example's own checks:

- per_op_bfv_n4096: ex1 (BFV N=4096, bfv_default, t=1024: square,
  relinearize, add_plain, multiply_plain by the monomial "4" on the
  ``negacyclic`` kernel, multiply; the result must have the JAX package's
  sha256, EX1, its noise budgets and decrypt 84), ex2's IntegerEncoder sum
  (t=512, decodes -2) and BatchEncoder square, ex5's rotate_rows(3) (the
  NAF fallback) and rotate_columns; then the rest of ops/dyadic.py on ex1's
  tensors: the shift alone, the centred norm (``infty_norm``) and the
  Barrett-64 reduction of unreduced sums (``elementwise`` reduce64);
- per_op_bfv_n8192_levels: ex3 (N=8192, [50, 30, 30, 50, 50]), two squares
  and modulus switches; budgets 132 -> 50, degree 8, EX3's sha256;
- per_op_ckks: ex2's CKKS square + rescale (N=4096), ex4's polynomial
  (N=8192, three special primes: multiply_plain, multiply, rescale,
  mod_switch_to, a forced scale, add, add_plain), ex5's rotate_vector(2)
  and complex_conjugate (N=8192, the default Galois keys);
- device_evaluator_n8192: ex8's three tiers at bench.py's ring (the
  Evaluator, the DeviceEvaluator, the train step at batch 8), equal bit for
  bit and to EX8's sha256, and DeviceEvaluator.multiply_relin_rescale.

Six are the multi-device schedules of parallel/ as C = 4 ranks of a
ThreadGroup (threads of this process) on the one card, each equal bit for
bit to the port's single-card path on the same inputs, with its
collectives per rank:

- ntt_sp4_n65536 and ntt_sp4_n16384: the coefficient-sharded NTT, both
  forms both ways, on the N=65536 cell's residues and config 4's step
  input, against K1's transform;
- ckks_mul_relin_rescale_csp4_n16384: config 4's step on the four-step
  pipeline, then one rotation at batch 16; decodes within 1e-4;
- ckks_mul_relin_rescale_limb4_n4096: the one-gather step at N=4096,
  [30] x 10, two special primes (two rows a rank), batch 128, its q_last
  row zeroed, then the hoisted rotations by 1..8 at batch 16;
- bfv_mul_relin_behz4_n8192: config 3's ring on the five-gather BEHZ,
  decoding v^2 mod t exactly;
- matvec_limb4_n4096: the limb-sharded hoisted matvec of an 8x8 matrix.

Two are tools/bench_ntt_mxu.py's shapes for the four-step int8 NTT
(ops/ntt_mxu.py, kernel ``ntt_mxu`` on the tensor cores), batch 128 x 2
polys, inputs from np.random.default_rng(0) as the tool makes them:

- ntt_mxu_n16384: config 4's ring, N=16384, CoeffModulus.create(16384,
  [50, 40, 40, 40, 40, 50]);
- ntt_mxu_n8192: the headline ring, N=8192, [50, 40, 40, 50];

each forward and inverse transform equal to K1's canonical ntt_forward and
ntt_inverse bit for bit on the whole batch, and the round trip exact; the
script then times the four transforms (MXU and K1, forward and inverse) in
turns and prints poly-limb NTTs/s, their ratio, device ms per transform
from CUDA events, the busy share and the table-build seconds (``ntt_mxu``
lines).

Six are the encrypted model zoo of models/pipelines.py at their sources'
rings, batch 16 (keygen in each source's order, parms seed range(8)):

- dense_layer8x8_n8192: examples/ex9's fused layer (M, b, x from
  default_rng(42), dim 8) at dense8x8's ring, square activation, on the
  hoisted and on the BSGS matvec; every slot within 1e-3 of (M x + b)^2;
- cnn16x16_n4096: bench_all.py's cnn cell (bench_all.py:341-398: N=4096,
  [50, 40 x 6, 50], a 3x3 conv + square, a 16-diagonal dense + square, a
  10-diagonal readout, BSGS); within 1e-2 of the numpy forward pass, and
  batch row 0 with the JAX package's digests (CNN16X16_N4096);
- bfv_matvec8x8_n8192: the hoisted BFV matvec of a seeded 8x8 integer
  matrix at config 2's ring; every slot exactly (M x) mod t;
- logreg_train_m64_f16_n8192: bench_all.py's train cell
  (bench_all.py:401-442), one encrypted gradient-descent iteration of m=64
  samples of F=16 features; within 1e-2 of the cleartext iteration, at the
  input scale;
- logreg_f16_n8192: bench_all.py's logreg cell (bench_all.py:689-723), the
  sigmoid head of 16 weights; slot 0 within 1e-2 of sigma3(w.x + b);
- inverse_ex14_n256: examples/ex14's softmax at its ring (N=256, [50, 40
  x 11, 50]); the step is build_ckks_inverse's four Goldschmidt iterations;
  within ex14's 2e-2 of softmax(x).

Four are the comparison builders, the encrypted matmul and encrypted
attention at bench_all.py's cells, batch 16, keygen in bench_all's order
(parms seed range(8), scale 2^40):

- relu_n8192 (bench_all.py:659-687): N=8192, [50, 40 x 13, 50], relin key
  only, slots from default_rng(7) in [-1, 1]; within 1e-2 of x (1 +
  sign_composite_reference(x)) / 2, batch row 0 with the JAX package's
  digests (RELU_N8192); on the same keys build_ckks_max (within 2e-2 of
  np.maximum where |a - b| >= 0.1) and build_ckks_sqrt with iters=3 (2e-3
  relative) at batch 2, checked and not timed;
- matmul_d32_n2048 (bench_all.py:510-546): N=2048, [50, 40 x 4, 50], A and
  B from default_rng(5) in [-1, 1], 93 rotation keys; within 1e-2 of A @ B;
- attention_d32_n2048 and attention_d16_n512 (bench_all.py:549-613): N =
  2 d^2 on attention_plan(d)'s chain, Q, K and V from default_rng(23) in
  [-0.5, 0.5]; within 1e-2 of the numpy softmax attention; the keygen line
  gives the rotation stack's bytes (1.9 GB at d=32); d=16 has the JAX
  package's digests (ATTENTION_D16_N512), is checked and not timed (the
  script's time budget), and runs four heads of d=8 at batch 2 with their
  own keys (within 1e-3 of each head's attention).

One is the wire-to-wire server (models/serving.py), tools/bench_serving.py's
shape on dense_layer8x8_n8192's ring, step and keys, batch 16, COMPR_NONE:

- serving_dense8x8_n8192: sixteen requests x_i from default_rng(43),
  encoded with encode_batch, served as full blobs (ser.save of a public-key
  encryption, 3 primes) and as seeded blobs (encrypt_symmetric_serializable,
  half the bytes); every served blob must equal ser.save of the step's own
  output on the same stacked input, the seeded blobs must expand to the c1
  the encryptor drew, decrypt_batch of a served batch must equal
  per-ciphertext decrypt bit for bit and decode within 1e-3 of
  (M x + b)^2; then examples/ex6's flow (N=4096, [40, 30, 30], parms seed
  range(8): parameters and ciphertext in deflate, relin keys, the server's
  square + relinearize + rescale through the Evaluator) must have the JAX
  package's sha256 digests (EX6).  With the kernels unwrapped it then times
  submit over 24 batches, submit_stream over the same, seeded submit_stream
  over 8, the step alone and each host stage of a batch (load and check,
  stack and upload, step, download, save), and prints them on a `serving`
  line with the seeded / full bytes ratio, the wire rate over the step's
  and whether the native host library was loaded.

With four cards an NCCL phase runs the csp4 and limb4 steps, one process
per card, against the single-card step; with fewer it says so.

The script

1. prints the card (nvidia-smi name and power limit, torch and CUDA);
2. builds the twelve kernels (nvcc, one process each, in parallel) and
   prints each one's -Xptxas -v summary, the count of IGMMA (wgmma, int8
   tensor-core) and IMMA (mma.sync) instructions in each ntt_mxu
   instantiation's SASS (cuobjdump -sass; it fails unless every one has
   IGMMA and none IMMA), the registers and stack bytes (cuobjdump
   -res-usage; a stack frame means spills, and it fails on one in ntt_mxu
   or infty_norm) of each instantiation of ntt_mxu (data columns a stage,
   W resident), infty_norm (cluster or not), ntt (direction, row length),
   galois (signed, paired, row mode) and contract (coefficients a unit,
   per-coefficient weights, staged inputs), behz, scale_round, mod_raise
   and negacyclic (each mode and form), the N=8192 ntt kernels' SASS
   instructions a butterfly, the contract kernels' SASS instructions a MAC
   and an output, and the behz, scale_round, mod_raise and negacyclic
   kernels' SASS instructions an output and integer divisions (``divides``);
   then the launch floor, an empty kernel timed as the kernels are at a few
   grids, among them K8's at the N=4096 refresh, K9's at ex1's
   multiply_plain and K10's at ex1's [2, 2, 4096] (in its clusters of
   eight CTAs, and as a plain launch);
3. drives the thirty-five paths; as each kernel call happens it
4. holds every distinct kernel call (function, mode, shapes) against its
   plain PyTorch version on the same inputs on the card (bit-exact; the
   launches of the check are taken off the counters), and times each call
   of a path's step both ways with CUDA events beside the least time the
   card could take for the same work (for ``galois`` counting the 32-bit
   tables that the kernel reads) and, for ``galois``, beside
   torch.index_select / torch.gather,
   for ``mod_raise`` and ``elementwise`` reduce64 beside torch.remainder,
   for ``negacyclic`` beside torch.roll + torch.where, for ``infty_norm``
   beside torch.amax, for ``ntt_mxu`` beside its digit-pair products as
   torch._int_mm calls; ntt_mxu's int8 MACs are each limb's own digit
   pairs, which the kernel computes, with the tables' 49-pair count and
   its bound beside them); in the refresh, the per-op paths and the model
   zoo's, whose steps repeat call shapes, each distinct call is timed once;
   ``scale_round``, which runs in encryption and decryption only, is timed
   at those calls; a kernel's modes (the large-ring NTT, one cluster
   launch a transform, and the sub_row NTT, the signed and paired Galois
   permutations, the broadcast contraction, K11's exchange and rows) are
   rows of their own;
5. checks batch 2 of every step form (the refresh: its one ciphertext)
   against the port's plain path on the card, bit for bit, and each one's
   decode (with BFV rotate_columns);
6. times each step at its full batch (ops/s or rotations/s, and the NTT
   rates of configs 4 and N=65536; ex14's reciprocal, max, sqrt and the
   d=16 attention are checked, not timed; the relu, matmul and d=32
   attention rates are over 10 steps), the two key forms of each hoisted rotation in turns, and
   profiles each (device time by kernel, device
   busy share), with the recorder removed; then each op of the per-op API
   (median host ms over 20 waited calls, device ms and busy share) and
   ex8's three tiers per ciphertext; the four-step int8 NTT against K1 in
   turns at both shapes; the NCCL phase, or why it did not run;
7. prints the kernels line and, last, the result line.

Any mismatch raises and the script exits non-zero; it exits non-zero with
no result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import time
import types

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 3.35 TB/s; 32-bit integer
# multiply-adds at 64 lanes per SM (half the 128 FP32 lanes behind the
# 67 TFLOP/s FP32 rate): 132 SMs * 64 * 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_IMAD_PER_S = 132 * 64 * 1.98e9
# dense int8 tensor-core multiply-adds (1,979 TOPS, two operations a MAC)
INT8_MAC_PER_S = 989.5e12

# 32-bit IMADs per 64-bit operation (the reckoning PERF.md writes out):
# low word of a 64x64 product 3, high word (__umul64hi) 4, full 128-bit 7;
# Barrett mul_mod = full product 7 + barrett_reduce_128 24 = 31;
# Shoup lazy multiply = high 4 + two low words 6 = 10.
IMAD_MULMOD = 31
IMAD_BARRETT128 = 24
IMAD_SHOUP = 10
IMAD_MAC = 7
IMAD_BARRETT64 = 7
ELEMENTWISE_MULMODS = {"add": 0, "sub": 0, "neg": 0, "mul": 1, "muladd": 1,
                       "addmul": 1, "barrett64": 0, "submul": 1, "reduce64": 0}

# the kernels (and kernel modes, "kernel:mode") each path's step must launch
PATH_KERNELS = {
    "mul_relin_rescale": ("ntt", "tensor_product", "contract", "elementwise"),
    "train_step": ("ntt", "tensor_product", "contract", "elementwise", "galois"),
    "rotate_many": ("ntt", "contract", "elementwise", "galois", "contract:broadcast",
                    "galois:paired"),
    "bfv_mul_relin_chain": ("ntt", "tensor_product", "contract", "elementwise", "behz"),
    "bfv_mul_relin": ("ntt", "tensor_product", "contract", "elementwise", "behz"),
    "bfv_rotate_rows": ("ntt", "contract", "elementwise", "galois:signed"),
    "bfv_rotate_many": ("ntt", "contract", "elementwise", "galois", "galois:signed",
                        "contract:broadcast", "galois:signed_paired"),
    "ckks_mul_relin_rescale_n16384": ("ntt", "tensor_product", "contract", "elementwise"),
    "ckks_poly_eval_n32768": ("ntt:large_ring", "tensor_product", "contract",
                              "elementwise", "galois"),
    "n65536": ("ntt:large_ring", "tensor_product", "contract", "elementwise"),
    "bootstrap_n4096": ("ntt", "tensor_product", "contract", "elementwise", "galois",
                        "mod_raise"),
    "dense8x8_n8192": ("ntt", "contract", "elementwise", "galois"),
    "per_op_bfv_n4096": ("ntt", "tensor_product", "contract", "elementwise", "behz",
                         "scale_round", "galois:signed", "negacyclic:mono_mul",
                         "negacyclic:shift", "infty_norm", "elementwise:reduce64"),
    "per_op_bfv_n8192_levels": ("ntt", "tensor_product", "contract", "elementwise", "behz"),
    "per_op_ckks": ("ntt", "tensor_product", "contract", "elementwise", "galois"),
    "device_evaluator_n8192": ("ntt", "tensor_product", "contract", "elementwise", "galois"),
    "ntt_sp4_n65536": ("ntt:sub_row", "ntt_sp:exchange", "ntt_sp:rows"),
    "ntt_sp4_n16384": ("ntt:sub_row", "ntt_sp:exchange", "ntt_sp:rows"),
    "ckks_mul_relin_rescale_csp4_n16384": ("ntt:sub_row", "ntt_sp:rows", "tensor_product",
                                           "contract", "elementwise", "galois"),
    "ckks_mul_relin_rescale_limb4_n4096": ("ntt", "tensor_product", "contract", "elementwise",
                                           "galois"),
    "bfv_mul_relin_behz4_n8192": ("ntt", "tensor_product", "contract", "elementwise", "behz"),
    "matvec_limb4_n4096": ("ntt", "contract", "elementwise", "galois"),
    "ntt_mxu_n16384": ("ntt_mxu",),
    "ntt_mxu_n8192": ("ntt_mxu",),
}
# the model zoo's paths, added apart: in the literal above they would deepen
# the module's frame, beneath every timed call (see main()'s zoo_paths)
PATH_KERNELS.update({
    "dense_layer8x8_n8192": ("ntt", "tensor_product", "contract", "elementwise", "galois",
                             "galois:paired"),
    "cnn16x16_n4096": ("ntt", "tensor_product", "contract", "elementwise", "galois",
                       "galois:paired"),
    "bfv_matvec8x8_n8192": ("ntt", "contract", "elementwise", "galois"),
    "logreg_train_m64_f16_n8192": ("ntt", "tensor_product", "contract", "elementwise",
                                   "galois", "contract:broadcast"),
    "logreg_f16_n8192": ("ntt", "tensor_product", "contract", "elementwise", "galois",
                         "contract:broadcast"),
    "inverse_ex14_n256": ("ntt", "tensor_product", "contract", "elementwise",
                          "contract:broadcast"),
})
# the comparison builders', the matmul's and attention's paths, one more
# update (a larger literal would deepen the module's frame)
PATH_KERNELS.update({
    "relu_n8192": ("ntt", "tensor_product", "contract", "elementwise", "contract:broadcast"),
    "matmul_d32_n2048": ("ntt", "contract", "elementwise", "galois", "contract:broadcast",
                         "contract:pairwise"),
    "attention_d32_n2048": ("ntt", "tensor_product", "contract", "elementwise", "galois",
                            "contract:broadcast", "contract:pairwise"),
    "attention_d16_n512": ("ntt", "tensor_product", "contract", "elementwise", "galois",
                           "contract:broadcast", "contract:pairwise"),
})
# the wire-to-wire server runs the dense layer's step on the hoisted matvec
PATH_KERNELS["serving_dense8x8_n8192"] = ("ntt", "tensor_product", "contract", "elementwise",
                                          "galois")
# paths whose step repeats a call shape many times: each distinct call is
# timed once and its time counted for every call of that shape
TIME_ONCE = ("bootstrap_n4096", "per_op_bfv_n4096", "per_op_bfv_n8192_levels", "per_op_ckks",
             "device_evaluator_n8192", "dense_layer8x8_n8192", "cnn16x16_n4096",
             "bfv_matvec8x8_n8192", "logreg_train_m64_f16_n8192", "logreg_f16_n8192",
             "inverse_ex14_n256", "relu_n8192", "matmul_d32_n2048", "attention_d32_n2048",
             "attention_d16_n512", "serving_dense8x8_n8192")

# bench_all.py's bootstrap cell (bench_all.py:445-508) run by the JAX package
# eagerly on the CPU (tests/test_torch_bootstrap.py::test_bench_all_cell_digests
# recomputes these): the sha256 of the exhausted input's and of the refreshed
# output's u64 residues, and the refresh's max decode error
BOOTSTRAP_N4096 = {
    "input_sha256": "f47972d88c9f9727cad28240bad41c211eb5e52424dd4d1202c2bd41bb0e212a",
    "output_sha256": "e8232d5c2b986c4699dd13ee8f35a7a83bedbdcbb1bad149348b3050f6d017db",
    "max_err": 1.5640752616911192e-05,
    "rotation_steps": 87,
    "levels_restored": 3,
    "levels_consumed": 18,
}
# bench_all.py's cnn cell (bench_all.py:341-398: N=4096, [50, 40 x 6, 50], a
# 3x3 conv + square, a 16-diagonal dense + square and a 10-diagonal readout on
# the BSGS matvec) run by the JAX package eagerly on the CPU
# (tests/test_torch_zoo.py::test_cnn16x16_digests recomputes these): the
# sha256 of the input's and of the output's u64 residues (one ciphertext),
# the max decode error against the numpy forward pass over the 256 pixels,
# and the rotation-key steps of each layer
CNN16X16_N4096 = {
    "input_sha256": "37726c33dd91e359a5ebf9f3abea7baaece56799f566b0e8143f8ddeec7a45d3",
    "output_sha256": "c143cc5b40e3a81c8c4a08b958bc122e00e9bb3e5bc9498eacc313b6485eecbf",
    "max_err": 3.776321932024915e-09,
    "rot_steps_lengths": [8, 6, 5],
}
# bench_all.py's relu cell (bench_all.py:659-687: N=8192, [50, 40 x 13, 50],
# relin key only, slots from default_rng(7) in [-1, 1]) and its d=16
# attention cell (bench_all.py:549-613: N=512, [50] + [40] x 19 + [50], Q, K
# and V from default_rng(23) in [-0.5, 0.5]) run by the JAX package eagerly on
# the CPU (tests/test_torch_compare.py::test_relu_n8192_digests and
# tests/test_torch_attention.py::test_attention_d16_n512_digests recompute
# these): the sha256 of the input's u64 residues (the attention's Q, K^T and V
# stacked) and of the output's (one ciphertext), the max decode error against
# x (1 + sign_composite_reference(x)) / 2 and the numpy softmax attention, and
# the count of rotation steps
RELU_N8192 = {
    "input_sha256": "fb5e741285cfecb593395c673d9f0001258795c5b90cbee530f364fe9d324077",
    "output_sha256": "104614fe48e4664417bc0387a01c95e1a63570244fd486e9554497a4dcf2547b",
    "max_err": 1.1149098970431037e-08,
    "rot_steps": 0,
}
ATTENTION_D16_N512 = {
    "input_sha256": "0141a6b9431a22e609abfae4b76a477c95414f214bb228bbcbaddc672836943a",
    "output_sha256": "22f6bce61243636189f0fb1ad1c55339d121b7d6df9a7f877a1f77798e6fd500",
    "max_err": 4.2044394527686324e-05,
    "rot_steps": 60,
}
# The SEAL per-op API's flows run by the JAX package's host Evaluator on the
# CPU (parms seed range(8)): the sha256 of the final ciphertext's u64
# residues, the noise budgets along the way and what it decrypts to.
# EX1: examples/ex1_bfv_basics.py (BFV N=4096, bfv_default, t=1024), budgets
# of x, x^2+1, (x+1)^2 and the result; EX3: examples/ex3_levels.py (N=8192,
# [50, 30, 30, 50, 50], t=1032193), budgets fresh, squared, switched, squared
# and switched again; EX8: examples/ex8_device_serving.py's chain at
# bench.py's ring (N=8192, [50, 40, 40, 50], SecLevelType.none), vals 0.1 i
# for i < 16 at 2^40, Galois keys for step 1.
EX1 = {"sha256": "6dbc391c48d4e7928573da2732e83014fb96dcd53627fa40c22ab840ef34d37c",
       "budgets": [55, 33, 33, 10], "decrypts": 84}
EX3 = {"sha256": "583f0523a09df9fa4371332e912aefe52794564b702aa2c6f1901f5b5d45cd82",
       "budgets": [132, 100, 82, 50], "degree": 8}
EX8 = {"sha256": "27c348c9e4ef004a148848d73553eb192a24255696a54f5bfd2c94edb13bdee6",
       "decodes": [0.01, 0.05, 0.13, 0.25]}
# EX6: examples/ex6_serialization.py's flow (CKKS N=4096, [40, 30, 30],
# tc128, scale 2^30) at parms seed range(8) in the JAX package
# (tests/test_torch_serialization.py::test_ex6_digests recomputes these): the
# sha256 of the parameters' and the ciphertext's deflate blobs, of the relin
# keys' blob and of the server's squared, relinearized and rescaled result,
# and the first two decoded slots
EX6 = {"parms_deflate_sha256": "7cfe6169bf19b8830bf132cda3f4a7910d71ce17a1a6b3485e3b16939c793d1a",
       "ciphertext_deflate_sha256":
           "84ffe7d06801bebd6b3240d424783c8b343737e41b61f02eac0436bb5b330bc1",
       "relin_keys_sha256": "c1aee47cc3edeaf39bad3c1f2d1a41734e0d6f1d2b1eb39b5fbd67079e3f0714",
       "result_sha256": "535c58441789bb24325f06bfdb7b6ff4eeeb80bf71c35d4a2cead09c7a6456a1"}
EX6_SQUARES = [9.859595999410143, 7.387522704063388]
# ... and the kernels each BFV path's encryption and decryption must launch
PHASE_KERNELS = {"encode_encrypt": ("scale_round",), "decrypt_decode": ("scale_round",)}
# kernels whose wrapper names its mode first: the kernels line gives each
# mode's launches and times beside the kernel's (``by_mode``)
MODE_ROWS = ("behz", "scale_round")


def conv_same(img, k):
    """SAME zero-padded 2-D convolution (correlation) of img by k, numpy."""
    import numpy as np

    h, w = img.shape
    kh, kw = k.shape
    out = np.zeros((h, w))
    for dy in range(-(kh // 2), kh // 2 + 1):
        for dx in range(-(kw // 2), kw // 2 + 1):
            src = np.zeros((h, w))
            rs, cs = slice(max(0, -dy), min(h, h - dy)), slice(max(0, -dx), min(w, w - dx))
            src[rs, cs] = img[max(0, dy):min(h, h + dy), max(0, dx):min(w, w + dx)]
            out += k[dy + kh // 2, dx + kw // 2] * src
    return out


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries the script's elapsed
    seconds, so that a run's time can be read phase by phase."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _START, 2)}
    print(json.dumps(obj), flush=True)


# (flag, library) -> cuobjdump's listing
_LISTINGS = {}


def cuobjdump(cuda, flag: str, lib_path: str) -> str:
    """cuobjdump's (beside nvcc) `flag` listing of a built kernel library.
    The first call lists every built library both ways (-sass and
    -res-usage), one process each, all started together; later calls read
    those listings."""
    tool = os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump")
    if not _LISTINGS:
        procs = {(f, r["path"]): subprocess.Popen([tool, f, r["path"]], stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True)
                 for r in cuda.BUILD_REPORT.values() for f in ("-sass", "-res-usage")}
        for (f, path), proc in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise subprocess.CalledProcessError(proc.returncode, [tool, f, path], out, err)
            _LISTINGS[f, path] = out
    if (flag, lib_path) not in _LISTINGS:
        _LISTINGS[flag, lib_path] = subprocess.run([tool, flag, lib_path], capture_output=True,
                                                   text=True, check=True, timeout=300).stdout
    return _LISTINGS[flag, lib_path]


# each kernel whose instantiations the build line lists: the mangled name's
# template arguments, and what they mean
RESOURCE_KERNELS = {
    # NT: data columns a stage (wgmma's N); resident: W in shared memory (K <=
    # 128); KS: k32 steps of W held at once
    "ntt_mxu": (r"ntt_mxu_kernelILi(\d+)ELb(\d)ELi(\d)E", ("NT", "resident", "KS")),
    # cluster: a row over a cluster of CTAs (else one CTA)
    "infty_norm": (r"(infty_norm)_kernelILb(\d)E", ("kernel", "cluster")),
    "ntt": (r"ntt_kernelILb(\d)ELi(\d+)E", ("inverse", "log2 row")),
    # mode: 0 the whole row in one CTA, 1 one slice a CTA, 2 a cluster a row
    "galois": (r"galois_kernelILb(\d)ELb(\d)ELi(\d)E", ("signed", "paired", "mode")),
    # vec: coefficients a column unit; w_has_n: per-coefficient weights (keys);
    # staged: the inputs staged in shared memory (else read directly)
    "contract": (r"contract_kernelILi(\d)ELb(\d)ELb(\d)E", ("vec", "w_has_n", "staged")),
    # mode: sm_mrq / sk_tail; vec: coefficients a column unit; shoup: Shoup
    # constants a CTA (else the Barrett mul_mod)
    "behz": (r"(sm_mrq|sk_tail)_kernelILi(\d)ELb(\d)E", ("mode", "vec", "shoup")),
    # mode: plain (sub: 0 plain_add, 1 plain_sub) / t_gamma
    "scale_round": (r"(plain|t_gamma)_kernelILi(\d)E(?:Lb(\d)E)?", ("mode", "vec", "sub")),
    "mod_raise": (r"(mod_raise)_kernel", ("kernel",)),
    # form: 0 shift, 1 Barrett by a per-limb tensor, 2 Shoup by host constants
    "negacyclic": (r"(negacyclic)_kernelILi(\d)E", ("kernel", "form")),
}


def kernel_resources(cuda, kernel: str, lib_path: str) -> dict:
    """Registers and stack bytes of each instantiation of a kernel, "a=x,b=y"
    (its template arguments) -> {REG, STACK}, from cuobjdump -res-usage (a
    stack frame means spills)."""
    import re

    pattern, names = RESOURCE_KERNELS[kernel]
    res, key = {}, None
    for line in cuobjdump(cuda, "-res-usage", lib_path).splitlines():
        m = re.search(pattern, line)
        if m:
            key = ",".join(f"{n}={v}" for n, v in zip(names, m.groups()) if v is not None)
        elif key and "REG:" in line:
            res[key] = {k: int(v) for k, v in re.findall(r"(REG|STACK):(\d+)", line)}
            key = None
    return res


def _sass_functions(sass: str):
    """{mangled name: [(address, opcode, operands)]} of a cuobjdump -sass
    listing; a branch target label (.L_x_N) is replaced by the address of
    the instruction that follows it."""
    import re

    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split(None, 1)[0]
        labels, pending, ins = {}, [], []
        for line in fn.splitlines()[1:]:
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                          line)
            if m:
                addr = int(m.group(1), 16)
                for lab in pending:
                    labels[lab] = addr
                pending = []
                ins.append((addr, m.group(2), m.group(3)))
        out[name] = [(a, op, labels.get(
            next(iter(re.findall(r"(\.L_x_\d+)", rest)), ""), rest)) for a, op, rest in ins]
    return out


def _lane_ops(ins):
    """Instructions that take a slot of the 64-lane pipes: uniform-datapath
    (U*), NOP, BRA and EXIT take none."""
    return [i for i in ins if not i[1].startswith(("U", "NOP", "BRA", "EXIT"))]


def _loops(ins):
    """(first, last) addresses of each backward branch's loop."""
    import re

    loops = []
    for addr, op, target in ins:
        if op.startswith("BRA"):
            hexes = re.findall(r"0x[0-9a-f]+", target) if isinstance(target, str) else []
            t = int(hexes[-1], 16) if hexes else target
            if isinstance(t, int) and t <= addr:
                loops.append((t, addr))
    return loops


def ntt_mxu_mma_instructions(cuda, lib_path: str) -> dict:
    """Each K12 instantiation's tensor-core instructions in its SASS:
    IGMMA (wgmma, int8) and IMMA (mma.sync, int8)."""
    import re

    out = {}
    pattern, names = RESOURCE_KERNELS["ntt_mxu"]
    for name, ins in _sass_functions(cuobjdump(cuda, "-sass", lib_path)).items():
        m = re.search(pattern, name)
        if m:
            key = ",".join(f"{n}={v}" for n, v in zip(names, m.groups()))
            out[key] = {op: sum(1 for i in ins if i[1].startswith(op + "."))
                        for op in ("IGMMA", "IMMA")}
    return out


def ntt_instructions_per_butterfly(cuda, lib_path: str) -> dict:
    """Static SASS instructions of the N=8192 ntt kernels (forward, inverse)
    over the butterflies a thread runs a row (13 stages x 4): the row loop
    runs once a row, so this is what each butterfly costs in issue slots,
    memory and index work included (``_lane_ops``)."""
    import re

    out = {}
    for name, ins in _sass_functions(cuobjdump(cuda, "-sass", lib_path)).items():
        m = re.match(r"_Z10ntt_kernelILb(\d)ELi13E", name)
        if m:
            out["inverse" if m.group(1) == "1" else "forward"] = len(_lane_ops(ins)) / 52
    return out


def contract_instructions(cuda, lib_path: str) -> dict:
    """Static SASS instructions of each contract kernel instantiation a MAC
    and an output.  The k loop (unrolled twice, ``#pragma unroll 2``) is the
    innermost backward branch whose body multiplies (IMAD.WIDE) and stages
    nothing (no STS); per MAC = its instructions / (2 x coefficients a
    unit); per output = the instructions of the item loop around it outside
    the k loop (the Barrett, the store, the item's index steps and an odd
    K's last term) / coefficients a unit.  An output at K terms issues
    about per_output + K x per_mac.  In the unstaged instantiations
    (staged=0) the k loop also holds the pre-scale's code, which runs only
    in a call that has one, so their counts are upper bounds."""
    import re

    out = {}
    for name, ins in _sass_functions(cuobjdump(cuda, "-sass", lib_path)).items():
        m = re.search(RESOURCE_KERNELS["contract"][0], name)
        if not m:
            continue
        vec = int(m.group(1))
        loops = _loops(ins)
        spans = {lp: [i for i in ins if lp[0] <= i[0] <= lp[1]] for lp in loops}
        k_loops = [lp for lp, body in spans.items()
                   if any(i[1].startswith("IMAD.WIDE") for i in body)
                   and not any(i[1].startswith(("STS", "BAR")) for i in body)]
        key = ",".join(f"{n}={v}" for n, v in zip(RESOURCE_KERNELS["contract"][1], m.groups()))
        if not k_loops:
            out[key] = {"error": "no k loop found", "loops": len(loops)}
            continue
        k_loop = min(k_loops, key=lambda lp: lp[1] - lp[0])
        outer = [lp for lp in loops if lp[0] <= k_loop[0] and lp[1] >= k_loop[1] and lp != k_loop]
        mac = len(_lane_ops(spans[k_loop])) / (2 * vec)
        entry = {"per_mac": mac, "k_loop_instructions": len(_lane_ops(spans[k_loop]))}
        if outer:
            item = min(outer, key=lambda lp: lp[1] - lp[0])
            entry["per_output"] = (len(_lane_ops(spans[item]))
                                   - len(_lane_ops(spans[k_loop]))) / vec
        out[key] = entry
    return out


def rns_instructions(cuda, kernel: str, lib_path: str) -> dict:
    """Static SASS instructions of each ``behz``, ``scale_round``,
    ``mod_raise`` and ``negacyclic`` kernel instantiation an output, and
    whether it divides.  The innermost loop that stores to global memory
    (STG) is the per-output loop (K6 the walk over one row's limbs, K7's
    plain modes the row loop, t_gamma the row loop, K8 the walk over a
    thread's primes, unrolled twice): per_output = its instructions / (its
    stores x coefficients a unit).  A kernel with no such loop (K9, one
    output a thread) counts its whole body: per_output = its instructions /
    (its stores x coefficients a unit).  outer_per_unit: the instructions of the
    loop around it beyond it, a column unit (K6 one row's r or alpha, K7
    plain one limb's inc).  divides: the function's MUFU.RCP (the start of
    a 32- or 64-bit integer division) and CALL instructions (a division
    subroutine); 0 means no index is divided anywhere in the kernel."""
    import re

    out = {}
    pattern, names = RESOURCE_KERNELS[kernel]
    for name, ins in _sass_functions(cuobjdump(cuda, "-sass", lib_path)).items():
        m = re.search(pattern, name)
        if not m:
            continue
        key = ",".join(f"{n}={v}" for n, v in zip(names, m.groups()) if v is not None)
        vec = int(dict(zip(names, m.groups())).get("vec") or 1)
        loops = _loops(ins)
        spans = {lp: [i for i in ins if lp[0] <= i[0] <= lp[1]] for lp in loops}
        entry = {"instructions": len(_lane_ops(ins)),
                 "divides": sum(1 for i in ins if i[1].startswith(("MUFU.RCP", "CALL")))}
        storing = [lp for lp, body in spans.items() if any(i[1].startswith("STG") for i in body)]
        if not storing:
            stores = sum(1 for i in ins if i[1].startswith("STG"))
            if stores:
                entry["per_output"] = entry["instructions"] / (stores * vec)
            else:
                entry["error"] = "no store found"
            out[key] = entry
            continue
        inner = min(storing, key=lambda lp: lp[1] - lp[0])
        body = _lane_ops(spans[inner])
        stores = sum(1 for i in spans[inner] if i[1].startswith("STG"))
        entry["per_output"] = len(body) / (stores * vec)
        outer = [lp for lp in loops if lp[0] <= inner[0] and lp[1] >= inner[1] and lp != inner]
        if outer:
            around = min(outer, key=lambda lp: lp[1] - lp[0])
            entry["outer_per_unit"] = len(_lane_ops(spans[around])) - len(body)
        out[key] = entry
    return out


LAUNCH_FLOOR_GRIDS = ((1, 32), (256, 128), (4096, 256))


def launch_floor_cluster(torch, lib_path: str, reps: int, grids) -> dict:
    """Device ms of an empty kernel launched as K10 launches
    (infty_norm.cu's gst_empty_cluster_launch) at each (CTAs, threads,
    CTAs a cluster) of `grids`, timed as the kernels are (``event_ms``)."""
    import ctypes

    fn = ctypes.CDLL(lib_path).gst_empty_cluster_launch
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(blocks, threads, cluster):
        rc = fn(blocks, threads, cluster, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty cluster kernel failed to launch: cudaError {rc}")

    return {f"{b}x{t}/{c}": event_ms(torch, lambda: launch(b, t, c), reps) for b, t, c in grids}


def infty_norm_grid(lead: int, L: int, N: int):
    """(CTAs, threads, CTAs a cluster) of K10's launch on [lead, L, N]."""
    from gemini_seal_tpu_torch.ops.dyadic import infty_norm_geometry

    geo = infty_norm_geometry(N, lead * L)
    return ((lead << geo["log_tiles"]) * L, geo["threads"], 1 << geo["log_tiles"])


def launch_floor(torch, cuda, lib_path: str, reps: int, grids=LAUNCH_FLOOR_GRIDS) -> dict:
    """Device ms of an empty kernel (scale_round.cu's gst_empty_launch) at
    each (CTAs, threads) of `grids`, timed as the kernels are
    (``event_ms``): the least a launch of K7-K10's small calls can take."""
    import ctypes

    fn = ctypes.CDLL(lib_path).gst_empty_launch
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(blocks, threads):
        rc = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel failed to launch: cudaError {rc}")

    return {f"{b}x{t}": event_ms(torch, lambda: launch(b, t), reps) for b, t in grids}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Recorder:
    """Wraps every kernel wrapper wherever a module of the port holds it, so
    that each kernel call of a path, keygen through decode, is handed with
    its arguments and result to ``check`` (path, phase, label, kernel,
    function, args, kwargs, result) as it happens: the inputs need not be
    kept for a later replay, which at config 5's batch would not fit on the
    card.  The label is the kernel, or "kernel:mode" when the call counted
    a launch in one of the kernel's modes (cuda.MODES).  The launches that
    ``check`` makes are taken off the counters again.
    ``remove`` puts the wrappers back, so that later phases time the steps
    as a user calls them."""

    def __init__(self, check):
        import threading

        from gemini_seal_tpu_torch.models import pipelines
        from gemini_seal_tpu_torch.ops import (cuda, dyadic, galois, modops, modraise, ntt,
                                               ntt_mxu, ntt_sp, rnsops)

        kernel_of = {ntt.ntt_forward_lazy: "ntt", ntt.ntt_forward: "ntt",
                     ntt.ntt_inverse_lazy: "ntt", ntt.ntt_inverse: "ntt",
                     ntt.ntt_sub_row: "ntt", ntt_sp.ntt_sp_exchange: "ntt_sp",
                     ntt_sp.ntt_sp_rows: "ntt_sp",
                     pipelines._tensor_product: "tensor_product",
                     modops.contract_mulmod_128: "contract",
                     modops.rns_elementwise: "elementwise",
                     galois.galois_permute: "galois",
                     rnsops.behz: "behz",
                     rnsops.scale_round: "scale_round",
                     modraise.mod_raise_lift: "mod_raise",
                     dyadic.negacyclic_shift_poly: "negacyclic",
                     dyadic.negacyclic_mono_mul_poly: "negacyclic",
                     dyadic.poly_infty_norm: "infty_norm",
                     ntt_mxu.mxu_pass: "ntt_mxu"}
        self.check = check
        self.launches = cuda.LAUNCHES
        # the one recorder of a run, for the paths that pause it
        Recorder.current = self
        self.path = None
        self.phase = None
        self._patched = []
        # the ranks of a ThreadGroup call the wrappers from threads: one call
        # (its launch, check and timing) at a time, and no exchange copy of
        # the group (ThreadGroup(lock=...)) while a call is timed
        self.lock = threading.RLock()
        wrapped = {id(fn): (fn, self._wrap(kernel, fn)) for fn, kernel in kernel_of.items()}
        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] != "gemini_seal_tpu_torch" or mod is None:
                continue
            for attr, value in list(vars(mod).items()):
                fn, wrapper = wrapped.get(id(value), (None, None))
                if fn is not None and fn is value:
                    setattr(mod, attr, wrapper)
                    self._patched.append((mod, attr, fn, wrapper))

    def remove(self):
        for mod, attr, fn, _ in self._patched:
            setattr(mod, attr, fn)
        self._patched = []

    def pause(self):
        """The kernels unwrapped for a timed run inside the paths (resume()
        wraps them again)."""
        self._paused = self._patched
        self.remove()

    def resume(self):
        for mod, attr, _, wrapper in self._paused:
            setattr(mod, attr, wrapper)
        self._patched = self._paused

    def _wrap(self, kernel, fn):
        def wrapped(*args, **kwargs):
            with self.lock:
                before = dict(self.launches)
                out = fn(*args, **kwargs)
                if self.phase is not None:
                    counts = dict(self.launches)
                    label = next((k for k in counts if ":" in k and counts[k] > before[k]),
                                 kernel)
                    self.check(self.path, self.phase, label, kernel, fn, args, kwargs, out)
                    self.launches.update(counts)
                return out
        return wrapped


def by_label(launches):
    """Launch counts per kernel label: a kernel's own entry keeps only its
    calls outside its modes."""
    out = dict(launches)
    for key, count in launches.items():
        if ":" in key:
            out[key.split(":")[0]] -= count
    return out


def signature(args, kwargs):
    """What tells two calls of one wrapper apart: the op, the tensors'
    shapes and the table sizes."""
    def sig(v):
        if hasattr(v, "data_ptr"):
            return tuple(v.shape)
        if isinstance(v, (tuple, list)):
            return tuple(sig(x) for x in v)
        if hasattr(v, "coeff_count"):  # NTTTables
            return ("tables", v.coeff_count, v.modulus.numel())
        if hasattr(v, "ndig_w"):  # MxuNttTables
            return ("mxu_tables", v.n, v.modulus.numel())
        if hasattr(v, "ratio0"):  # LimbConstants
            return ("limbs", v.p.numel())
        return v
    return tuple(sig(v) for v in args) + tuple(sorted((k, sig(v)) for k, v in kwargs.items()))


def event_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over reps launches.

    At least 10 ms of warm-up launches come first (a first call timed from
    an idle card ran up to 3x slow while its clock came up).  The timed
    launches are queued behind a 10 ms device-side sleep, so that they run
    back to back: a kernel shorter than its wrapper's host time would
    otherwise be timed at the host's launch rate.  The cyclic garbage
    collector is off while they are queued: one of its full passes over
    this process's objects outlasts the sleep, and the device then waits
    for the host inside the timed window."""
    import gc

    warm_until = time.perf_counter() + 0.01
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() < warm_until:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        torch.cuda._sleep(int(0.01 * 1.98e9))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_steps(torch, fn, steps: int, step_ms: float, all_threads: bool = False) -> dict:
    """Device time by kernel over `steps` steady steps (torch.profiler's
    device-side events only, so an operator and its kernel are not counted
    twice) and the device's busy share of the unprofiled step time.
    all_threads: record the host ranges of every thread (the ranks of a
    ThreadGroup), where this torch's profiler offers it; only then are the
    host's operators recorded too (their "gst_exchange" ranges): they read
    no device time and cost the profiler 3-4x its time
    (port_tools/profile_probe.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gemini_seal_tpu_torch import tracing

    kw = {}
    activities = [ProfilerActivity.CUDA]
    if all_threads:
        activities.insert(0, ProfilerActivity.CPU)
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
    fn()
    torch.cuda.synchronize()
    with profile(activities=activities, **kw) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the port's spans of the session (gemini_seal_tpu_torch/tracing.py; the
    # read closes its record): with every thread recorded they also come back
    # as device-side annotation rows, spanning their kernels: not a kernel
    spans = set(tracing.summary())
    rows = [{"name": e.key[:80], "calls_per_step": e.count / steps,
             "device_ms_per_step": e.self_device_time_total / 1e3 / steps}
            for e in events if e.device_type == DeviceType.CUDA and e.key not in spans]
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    device_ms = sum(r["device_ms_per_step"] for r in rows)
    out = {"steps": steps, "step_ms": step_ms, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / step_ms, "by_kernel": rows}
    # a ThreadGroup's exchange copies (parallel/comm.py's "gst_exchange"
    # ranges): the device time of the copies launched inside them, a row of
    # their own (their kernels are among the rows above too)
    ex = [e for e in events if e.key == "gst_exchange"]
    if ex:
        out["exchange_copies"] = {"calls_per_step": ex[0].count / steps,
                                  "device_ms_per_step": ex[0].device_time_total / 1e3 / steps}
    return out


def tensors_of(fn_name, args, kwargs):
    """The tensors a kernel call reads, the tables and constants included."""
    out = []
    for v in list(args) + list(kwargs.values()):
        if hasattr(v, "data_ptr"):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            out.extend(t for t in v if hasattr(t, "data_ptr"))
        elif hasattr(v, "coeff_count"):  # NTTTables: the direction's twiddles
            if fn_name.startswith("ntt_inverse"):
                out += [v.inv_root_powers, v.scaled_inv_root_powers,
                        v.inv_degree_modulo, v.scaled_inv_degree]
            else:
                out += [v.root_powers, v.scaled_root_powers]
            out.append(v.modulus)
        elif hasattr(v, "ndig_w"):  # MxuNttTables: the pass's matrix is an argument
            out += [v.modulus, v.ratio0, v.ratio1, v.neg_offset]
        elif hasattr(v, "ratio0"):  # LimbConstants
            out += [v.p, v.ratio0, v.ratio1]
    return out


def spans_of(t):
    """(start, end) byte spans of a tensor's elements: one span when it is
    contiguous, one per row (last axis, unit stride) for a view that picks
    rows out of a larger tensor."""
    es, ptr = t.element_size(), t.data_ptr()
    if t.is_contiguous():
        return [(ptr, ptr + t.numel() * es)]
    if t.stride(-1) != 1:
        raise ValueError("spans_of: last axis must have unit stride")
    offs = [0]
    for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
        offs = [o + i * stride for o in offs for i in range(size)]
    row = t.shape[-1] * es
    return [(ptr + o * es, ptr + o * es + row) for o in offs]


def bytes_once(tensors) -> int:
    """Bytes of the union of the tensors' memory: a storage that two
    arguments share (the step squares by passing one ciphertext twice) is
    read once, and a view of some rows counts only those rows."""
    spans = sorted(sp for t in tensors if t.numel() for sp in spans_of(t))
    total, end = 0, 0
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def needed_inputs(kernel, args, kwargs):
    """The call's arguments with each input cut to the rows the function
    needs: a ``contract`` input row whose weights (or pre-scale) are all 0
    adds nothing to the sum (fastbconv_sk reads the whole Bsk tensor, its
    x_sk row at weight 0), and ``behz`` sk_tail needs only the x_sk row of
    its aux tensor.  Returns (args, kwargs, the contract's needed K)."""
    if kernel == "contract":
        a, w = args[0], args[1]
        live = w.ne(0).flatten(2).any(-1).any(0)  # w [G, K, J, Nw] -> [K]
        if kwargs.get("prescale") is not None:
            live &= kwargs["prescale"][0].ne(0).any(0)  # s [G, K]
        ks = [k for k in range(w.shape[1]) if bool(live[k])]
        if len(ks) < w.shape[1]:
            rows = [a.select(-3, k) for k in ks]  # a [..., G, K, Ja, N]
            return [rows] + list(args[1:]), kwargs, len(ks)
        return args, kwargs, len(ks)
    if kernel == "behz" and args[0] == "sk_tail":
        kw = dict(kwargs)
        if "aux" in kw:
            kw["aux"] = kw["aux"][..., -1:, :]
            return args, kw, None
        return list(args[:3]) + [args[3][..., -1:, :]] + list(args[4:]), kw, None
    return args, kwargs, None


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def work(kernel, fn_name, args, kwargs, result):
    """(bytes, 32-bit IMADs) the call needs: every input read once, every
    output written once, and the integer multiplies of its arithmetic."""
    outs = result if isinstance(result, tuple) else (result,)
    if fn_name == "ntt_sub_row":
        # a chunk's stages read the chunk's twiddle slices (w and its Shoup
        # dual, chunk entries a limb), the chunk, and write it
        x = args[0]
        chunk, L = x.shape[-1], x.shape[-2]
        nbytes = bytes_once([x]) + bytes_once(outs) + 2 * L * chunk * 8
        ops = (x.numel() // 2) * (chunk.bit_length() - 1) * IMAD_SHOUP
        return nbytes, ops
    if fn_name == "ntt_sp_exchange":
        # own and partner chunk in, one chunk out, one twiddle pair a limb;
        # one Shoup product a coefficient on every rank (the upper rank's
        # product, the lower's n^-1 fold or its forward product)
        own, partner = args[0], args[1]
        nbytes = bytes_once([own]) + bytes_once([partner]) + bytes_once(outs) + 16 * own.shape[-2]
        return nbytes, own.numel() * IMAD_SHOUP
    if fn_name == "ntt_sp_rows":
        y, chunks = args[0], _arg(args, kwargs, 2, "chunks")
        inverse = _arg(args, kwargs, 3, "inverse")
        L = y.shape[-3]
        nbytes = bytes_once([y]) + bytes_once(outs) + 16 * L * (chunks - 1)
        stages = chunks.bit_length() - 1 + (1 if inverse else 0)  # + the n^-1 fold
        return nbytes, (y.numel() // 2) * stages * IMAD_SHOUP
    if kernel == "galois":
        # the kernel reads the tables' int32 copy and its block map, one
        # entry a table and 8192-coefficient slice (ops.galois.kernel_tables)
        x, tabs = args[0], args[1]
        moduli = _arg(args, kwargs, 2, "moduli")
        R, N = tabs.shape
        nbytes = (bytes_once([x] + ([moduli] if moduli is not None else []))
                  + (tabs.numel() + R * max(1, N // 8192)) * 4 + bytes_once(outs))
        return nbytes, 0  # a permutation: bytes only
    need_args, need_kwargs, live_k = needed_inputs(kernel, args, kwargs)
    nbytes = bytes_once(tensors_of(fn_name, need_args, need_kwargs)) + bytes_once(outs)
    if kernel == "ntt":
        x, tables = args
        rows = x.numel() // x.shape[-1]
        n, log_n = tables.coeff_count, tables.coeff_count_power
        inverse = fn_name.startswith("ntt_inverse")
        ops = rows * (n // 2) * (log_n + (1 if inverse else 0)) * IMAD_SHOUP
    elif kernel == "tensor_product":
        a, b = args[0], args[1]
        ops = (a.numel() // 2) * (3 if b is None else 4) * IMAD_MULMOD
    elif kernel == "contract":
        # the input is counted once however many groups read it (the two key
        # components, R counter-rotated keys): bytes_once above
        a, w = args[0], args[1]
        G, K = w.shape[0], w.shape[1]
        ops = outs[0].numel() * (live_k * IMAD_MAC + IMAD_BARRETT128)
        if kwargs.get("prescale") is not None:  # once per needed input element and group
            ops += a.numel() // K * live_k * IMAD_MULMOD * (G if a.shape[-4] == 1 else 1)
    elif kernel == "behz":
        # sm_mrq: the low-word multiply for r once per row and coefficient,
        # then per output two Shoup products (x_j * m_tilde^-1 + r * (q *
        # m_tilde^-1)); sk_tail: alpha's Shoup product once per row and
        # coefficient and one Shoup product per output (the selected branch)
        out = outs[0]
        coeffs = out.numel() // out.shape[-2]
        if args[0] == "sm_mrq":
            ops = coeffs * 3 + out.numel() * 2 * IMAD_SHOUP
        else:
            ops = (out.numel() + coeffs) * IMAD_SHOUP
    elif kernel == "scale_round":
        # plain modes: the fix once per coefficient (m * (q mod t) and the
        # divmod quotient), Delta * m and barrett_reduce_128 once per limb and
        # coefficient, only an add per output; t_gamma: three Shoup products
        # and two barrett_reduce_64 per output
        out = outs[0]
        if args[0] == "t_gamma":
            ops = out.numel() * (3 * IMAD_SHOUP + 2 * IMAD_BARRETT64)
        else:
            ops = out.shape[-1] * (1 + out.shape[-2]) * (IMAD_MAC + IMAD_BARRETT128)
    elif kernel == "mod_raise":
        ops = outs[0].numel() * IMAD_BARRETT64  # one Barrett-64 per output
    elif kernel == "negacyclic":
        # a permutation with signs; the monomial's mul_mod per output
        ops = outs[0].numel() * (IMAD_MULMOD if fn_name == "negacyclic_mono_mul_poly" else 0)
    elif kernel == "infty_norm":
        ops = 0  # compares and subtracts: bytes only
    elif kernel == "ntt_mxu":
        # one barrett_reduce_128 per output, and the twist's Shoup multiply;
        # the digit products are int8 MACs (int8_macs), the ladder adds
        twist = _arg(args, kwargs, 4, "twist") is not None
        ops = outs[0].numel() * (IMAD_BARRETT128 + (IMAD_SHOUP if twist else 0))
    elif args[0] == "reduce64":
        ops = outs[0].numel() * IMAD_BARRETT64
    else:
        ops = outs[0].numel() * ELEMENTWISE_MULMODS[args[0]] * IMAD_MULMOD
    return nbytes, ops


def int8_macs(kernel, args, kwargs, table_counts: bool = False) -> int:
    """int8 tensor-core multiply-adds of an ntt_mxu pass: K x K x (other
    axis) products a row for each of its limb's own digit pairs (dw_l x
    dx_l, ops.ntt_mxu.limb_counts: what the kernel computes),
    or with table_counts every pair of the tables' counts (DW x DX, as
    _digit_matmul defines them); 0 for the other kernels."""
    if kernel != "ntt_mxu":
        return 0
    from gemini_seal_tpu_torch.ops.ntt_mxu import limb_counts

    x, w, tables = args[0], args[1], args[2]
    side, L = w.shape[-1], w.shape[0]
    per_row = (x.numel() // (L * side)) * side * side
    if table_counts:
        return per_row * L * tables.ndig_w * tables.ndig_x
    dws, dxs = limb_counts(w, tables)
    return per_row * sum(a * b for a, b in zip(dws, dxs))


def bound_of(nbytes, ops, macs):
    """(bound ms, what bounds it): the least time of the bytes, the 32-bit
    IMADs and the int8 MACs at the card's peaks."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / INT32_IMAD_PER_S,
             "int8 operations": macs / INT8_MAC_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, "bytes" if by == "bytes" else "operations"


def mxu_library_call(torch, x, w, tables, contract_x, twist=None):
    """The digit-pair products of one ntt_mxu pass as torch._int_mm calls
    (cuBLASLt's int8 GEMM on the card): per limb and shift s one call of
    the shift's pairs side by side, W_d [K, pairs K] x X_e [pairs K, cols]
    -> int32 plane_s.  The kernel's tensor-core part only (no digit split,
    recombine or twist); the port never calls it.  Returns the call and
    limb 0's planes as a check against the plain _digit_matmul."""
    from gemini_seal_tpu_torch.ops import ntt_mxu

    dx, dw = tables.ndig_x, tables.ndig_w
    L, n1, n2 = tables.modulus.numel(), tables.n1, tables.n2
    xd = ntt_mxu._balanced_digits_dev(x, dx).reshape(dx, -1, L, n1, n2)
    # [DX, L, K, cols]: cols (batch, N2) contracting N1, (batch, N1) contracting N2
    perm = (0, 2, 3, 1, 4) if contract_x == "A" else (0, 2, 4, 1, 3)
    xm = xd.permute(*perm).reshape(dx, L, w.shape[-1], -1).contiguous()
    calls = []
    for li in range(L):
        for s in range(dw + dx - 1):
            ds = range(max(0, s - dx + 1), min(dw, s + 1))
            calls.append((torch.cat([w[li, d] for d in ds], 1).contiguous(),
                          torch.cat([xm[s - d, li] for d in ds], 0).contiguous()))
    del xd, xm

    def call():
        return [torch._int_mm(a, b) for a, b in calls]

    def planes0():
        """Limb 0's planes from the library, in _digit_matmul's layout."""
        out = []
        for a, b in calls[:dw + dx - 1]:
            pl = torch._int_mm(a, b).reshape(a.shape[0], -1, n2 if contract_x == "A" else n1)
            out.append(pl.permute(1, 0, 2) if contract_x == "A" else pl.permute(1, 2, 0))
        return out
    return call, planes0


def library_call(torch, x, tabs, moduli=None, paired=False):
    """The one PyTorch call that computes galois_permute(x, tabs) (its
    permutation part in the signed modes, which no one call computes): an
    index_select over the last axis for one table, a gather of the
    broadcast rows for several, a gather of x's own rows when paired."""
    R, N = tabs.shape
    idx = tabs & (N - 1)
    if paired:
        pidx = idx.reshape(R, 1, N).expand(x.shape)
        return lambda: torch.gather(x, -1, pidx)
    if R == 1:
        return lambda: x.index_select(-1, idx[0])
    lead, rows = x.shape[:-2], x.shape[-2]
    shape = lead + (R, rows, N)
    src = x.unsqueeze(-3).expand(shape)
    gidx = idx.reshape(R, 1, N).expand(shape)
    return lambda: torch.gather(src, -1, gidx)


def remainder_call(torch, x, p, ratio1, q0_mod_p, half):
    """The one PyTorch call nearest to mod_raise_lift: torch.remainder of
    the input broadcast over the L primes (the reduction without the sign
    fix, which no one call computes)."""
    pc = p.reshape(-1, 1)
    return lambda: torch.remainder(x, pc)


def negacyclic_call(torch, a, shift, limbs):
    """The PyTorch calls nearest to negacyclic_shift_poly: torch.roll and
    torch.where with neg_mod's p - a (the permutation and the signs; the
    monomial's multiply, which no PyTorch call computes mod p, left out)."""
    n = a.shape[-1]
    shift %= 2 * n
    rot = shift % n
    wrapped = torch.arange(n, device=a.device) < rot
    if (shift // n) % 2:
        wrapped = ~wrapped
    p = limbs.p

    def call():
        r = torch.roll(a, rot, dims=-1)
        return torch.where(wrapped & (r != 0), p - r, r)
    return call


def infty_norm_call(torch, a, limbs):
    """torch.amax of the centred magnitude (one torch.where before it)."""
    p = limbs.p
    return lambda: torch.amax(torch.where(a > (p >> 1), p - a, a), dim=-1)


def steady(torch, fn, count: int):
    """(count per second, iterations, seconds) of fn over about 3 s, or
    over fn.steps steps where fn names them."""
    fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per = time.perf_counter() - t1
    iters = getattr(fn, "steps", None) or max(5, min(200, int(3.0 / max(per, 1e-6))))
    t1 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    return count * iters / dt, iters, dt


def _nccl_context(T, job, device):
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(job["n"])
    parms.set_coeff_modulus(T.CoeffModulus.create(job["n"], job["bits"]))
    parms.set_n_special_primes(job["nsp"])
    parms.set_random_seed(tuple(job["seed"]))
    return T.SealContext(parms, sec_level=T.SecLevelType.none, device=device)


def _nccl_step(group, job):
    """One rank of the NCCL phase (a process of its own, on card `rank`):
    the csp4 or limb4 step on this rank's shard of job["a"], its first
    step's collectives, and the mean ms of job["reps"] more steps."""
    import torch
    import torch.distributed as dist

    import gemini_seal_tpu_torch as T
    from gemini_seal_tpu_torch.ops.keyswitch import KeySwitchPlan
    from gemini_seal_tpu_torch.parallel import keyswitch_sp, pipeline_csp

    dev = torch.device("cuda", torch.cuda.current_device())
    ctx = _nccl_context(T, job, dev)
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    r, C = group.rank, group.size
    a, key = job["a"], job["key"]
    if job["kind"] == "csp4":
        b = a.shape[-1] // C
        x = a[..., r * b:(r + 1) * b].contiguous().to(dev)
        k = key[..., r * b:(r + 1) * b].contiguous().to(dev)

        def step():
            return pipeline_csp.ckks_mul_relin_rescale_coeff_sharded(x, x, k, plan, group)
    else:
        b = a.shape[-2] // C
        x = a[..., r * b:(r + 1) * b, :].contiguous().to(dev)
        k = key.to(dev)

        def step():
            return keyswitch_sp.ckks_mul_relin_rescale_limb_sharded(x, x, k, plan, group)
    out = step()
    torch.cuda.synchronize()
    stats = group.stats.as_dict()
    dist.barrier()
    t1 = time.perf_counter()
    for _ in range(job["reps"]):
        step()
    torch.cuda.synchronize()
    dist.barrier()
    return {"out": out.cpu(), "step_ms": (time.perf_counter() - t1) * 1e3 / job["reps"],
            "collectives": stats, "card": torch.cuda.get_device_name(dev)}


def nccl_phase(torch, T, device, card, rehearsal) -> None:
    """The csp4 (config 4) and limb4 steps at batch 16 over NCCL, one spawned
    process per card on four cards, held bit for bit to the port's
    single-card step on card 0.  With fewer cards it says that it did not
    run, and why."""
    cards = 0 if rehearsal else torch.cuda.device_count()
    if cards < 4:
        emit({"phase": "nccl", "ran": False, "cards": cards,
              "reason": f"{cards} card(s) on this machine: the NCCL group runs one process "
                        f"per card on four cards; nothing stands in for it"})
        return
    import numpy as np

    from gemini_seal_tpu_torch.parallel.comm import spawn

    jobs = {"ckks_mul_relin_rescale_csp4_n16384": {
                "kind": "csp4", "n": 16384, "bits": [50, 40, 40, 40, 40, 50], "nsp": 1,
                "seed": list(range(8)), "scale": 2.0 ** 40},
            "ckks_mul_relin_rescale_limb4_n4096": {
                "kind": "limb4", "n": 4096, "bits": [30] * 10, "nsp": 2,
                "seed": list(range(91, 99)), "scale": 2.0 ** 28}}
    for path, job in jobs.items():
        t0 = time.perf_counter()
        ctx = _nccl_context(T, job, device)
        kg = T.KeyGenerator(ctx, device=device)
        enc = T.Encryptor(ctx, kg.public_key(), device=device)
        cod = T.CKKSEncoder(ctx, device=device)
        v = np.random.default_rng(2030).uniform(-1.0, 1.0, job["n"] // 2)
        ct = enc.encrypt(cod.encode(v.tolist(), job["scale"]))
        a = ct.data.expand((16,) + tuple(ct.data.shape)).contiguous()
        rk = kg.relin_keys().stacked(2)
        want = T.build_ckks_mul_relin_rescale(ctx, device=device)(a, a, rk)
        job.update(a=a.cpu(), key=rk.cpu(), reps=20)
        res = spawn(_nccl_step, 4, "nccl", job)
        outs = [r[0]["out"] for r in res]
        if job["kind"] == "csp4":
            got = torch.cat(outs, -1)
            equal = bool(torch.equal(got, want.cpu()))
        else:
            got = torch.cat(outs, -2)
            equal = bool(torch.equal(got[..., :-1, :], want.cpu())
                         and (got[..., -1, :] == 0).all())
        emit({"phase": "nccl", "ran": True, "path": path, "ranks": 4, "group": "nccl",
              "cards": 4, "batch": 16, "equal_to_single_card": equal,
              "step_ms_by_rank": [r[0]["step_ms"] for r in res],
              "collectives": res[0][0]["collectives"], "cards_seen": [r[0]["card"] for r in res],
              "seconds": time.perf_counter() - t0, "card": card})
        if not equal:
            raise AssertionError(f"{path} over NCCL differs from the single-card step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the same phases at N=1024 (the refresh at N=128), batch 2, "
                         "two rotations, on the CPU through the plain versions (no result "
                         "line)")
    ap.add_argument("--nccl-only", action="store_true",
                    help="on a machine with four cards: build the kernels and run only the "
                         "NCCL phase (the csp4 and limb4 steps, one process per card, against "
                         "the single-card step)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import gemini_seal_tpu_torch as T
    # the schedules' modules before the recorder wraps the kernels where
    # each module holds them
    import gemini_seal_tpu_torch.parallel.behz_sp  # noqa: F401
    import gemini_seal_tpu_torch.parallel.bootstrap_sp  # noqa: F401
    import gemini_seal_tpu_torch.parallel.pipeline_csp  # noqa: F401
    from gemini_seal_tpu_torch.ops import cuda
    from gemini_seal_tpu_torch.ops import ntt as ntt_ops
    from gemini_seal_tpu_torch.ops.backend import plain_versions, to_numpy, to_tensor
    from gemini_seal_tpu_torch.ops.dyadic import negacyclic_geometry
    from gemini_seal_tpu_torch.ops.modraise import mod_raise_geometry
    from gemini_seal_tpu_torch.utils import native

    rehearsal = args.cpu_rehearsal
    device = "cpu" if rehearsal else "cuda"
    n = 1024 if rehearsal else 8192
    batch = 2 if rehearsal else 128
    rot_batch = 2 if rehearsal else 16
    rot_steps = list(range(1, 3 if rehearsal else 9))
    reps = 1 if rehearsal else 20
    sync = torch.cuda.synchronize if not rehearsal else (lambda: None)

    # 1. the device ----------------------------------------------------------
    card = "cpu rehearsal"
    if not rehearsal:
        card = nvidia_smi_line()
        print(card, flush=True)
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0) if not rehearsal else "cpu"})

    # 2. build ---------------------------------------------------------------
    if not rehearsal:
        t0 = time.perf_counter()
        report = cuda.build()
        mxu_mma = ntt_mxu_mma_instructions(cuda, report["ntt_mxu"]["path"])
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "kernels": {k: {"seconds": v["seconds"], "ptxas": v["ptxas"]}
                          for k, v in report.items()},
              "ntt_mxu_sass_mma_instructions": mxu_mma,
              "resources": {k: kernel_resources(cuda, k, report[k]["path"])
                            for k in RESOURCE_KERNELS},
              "ntt_sass_instructions_per_butterfly": ntt_instructions_per_butterfly(
                  cuda, report["ntt"]["path"]),
              "contract_sass_instructions": contract_instructions(
                  cuda, report["contract"]["path"]),
              "behz_sass_instructions": rns_instructions(cuda, "behz", report["behz"]["path"]),
              "scale_round_sass_instructions": rns_instructions(
                  cuda, "scale_round", report["scale_round"]["path"]),
              "mod_raise_sass_instructions": rns_instructions(
                  cuda, "mod_raise", report["mod_raise"]["path"]),
              "negacyclic_sass_instructions": rns_instructions(
                  cuda, "negacyclic", report["negacyclic"]["path"])})
        # an empty kernel at K7's grid (256 x 128: one ciphertext's c0 at
        # N=8192), a large call's, K8's at the N=4096 refresh and K9's at
        # ex1's multiply_plain, timed as the kernels are
        geo8 = mod_raise_geometry(2, 21, 4096)
        geo9 = negacyclic_geometry(4096)
        grids = LAUNCH_FLOOR_GRIDS + (
            ((2 << geo8["log_tiles"]) * geo8["groups"], geo8["threads"]),
            ((2 << geo9["log_tiles"]) * 2, geo9["threads"]))
        grid10 = infty_norm_grid(2, 2, 4096)
        emit({"phase": "launch_floor", "card": card, "kernel": "empty_kernel",
              "grids": {"mod_raise [2, 1, 4096] -> [2, 21, 4096]": "x".join(map(str, grids[3])),
                        "negacyclic [2, 2, 4096]": "x".join(map(str, grids[4])),
                        "infty_norm [2, 2, 4096] (CTAs x threads / CTAs a cluster)":
                            "{}x{}/{}".format(*grid10)},
              "ms": {**launch_floor(torch, cuda, report["scale_round"]["path"], 20, grids),
                     **launch_floor_cluster(torch, report["infty_norm"]["path"], 20,
                                            (grid10, grid10[:2] + (1,)))}})
        # every instantiation of K12 runs its products as warpgroup MMAs
        # (IGMMA, int8) and none as mma.sync (IMMA); none of K10's or K12's
        # keeps a stack frame
        for key, count in mxu_mma.items():
            if not count["IGMMA"] or count["IMMA"]:
                raise AssertionError(f"ntt_mxu {key}: {count} (expected warpgroup MMAs only)")
        for k in ("ntt_mxu", "infty_norm"):
            for key, r in kernel_resources(cuda, k, report[k]["path"]).items():
                if r.get("STACK", 0):
                    raise AssertionError(f"{k} {key} keeps a stack frame of {r['STACK']} bytes")

    if args.nccl_only:
        if torch.cuda.device_count() < 4:
            print("chip_smoke: --nccl-only needs four cards", file=sys.stderr)
            return 1
        nccl_phase(torch, T, device, card, rehearsal)
        emit({"ok": True, "nccl_only": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0

    # 3. the paths, each once, with the counters from 0 ---------------------------
    # (4. checks and times each kernel call as it happens: check_call)
    paths = {}
    phase_launches = {}
    mark = {}
    rows = {}
    seen = set()
    timed_once = {}

    def check_call(path, phase, label, kernel, fn, cargs, ckw, result):
        """4. Every distinct (function, mode, shapes) call, keygen through
        decode, is run again through its plain version and compared with
        the kernel's result exactly; every call of a step is also timed both
        ways beside its bound (and galois beside its library call), and so
        is every call of scale_round, which runs outside the steps."""
        sync()
        row = rows.setdefault(label, {"checked": [], "step_calls": [], "by_path": {},
                                      "max_abs_err": 0, "tolerance": 0})
        # behz and scale_round: each mode's calls and times on their own too
        mode = cargs[0] if kernel in MODE_ROWS else None
        if mode is not None:
            by_mode = row.setdefault("by_mode", {}).setdefault(
                mode, {"launches_by_path": {}, "by_path": {}})
            by_mode["launches_by_path"][path] = by_mode["launches_by_path"].get(path, 0) + 1
        key = (label, fn.__name__, signature(cargs, ckw))
        plain_s = None
        if key not in seen:
            seen.add(key)
            t1 = time.perf_counter()
            with plain_versions():
                got_p = fn(*cargs, **ckw)
            sync()
            plain_s = time.perf_counter() - t1
            pairs = zip(result, got_p) if isinstance(result, tuple) else [(result, got_p)]
            for x, y in pairs:
                # residues are compared exactly (tolerance 0): the u64 bit patterns
                row["max_abs_err"] = max(row["max_abs_err"], int((x - y).abs().max().item()))
                if not torch.equal(x, y):
                    raise AssertionError(f"{label} ({path} {phase}, {fn.__name__}): kernel "
                                         f"differs from its plain version at {tuple(x.shape)}")
            del got_p, pairs
            row["checked"].append({"path": path, "phase": phase, "fn": fn.__name__,
                                   "signature": repr(key[2])})
        if phase != "step" and kernel != "scale_round":
            return
        nbytes, ops = work(kernel, fn.__name__, cargs, ckw, result)
        macs = int8_macs(kernel, cargs, ckw)
        macs_tables = int8_macs(kernel, cargs, ckw, table_counts=True)
        ms = plain_ms = lib_ms = lib = None
        if kernel == "ntt_mxu":
            from gemini_seal_tpu_torch.ops import ntt_mxu

            lib, planes0 = mxu_library_call(torch, *cargs, **ckw)
            x, w, tables, contract_x = cargs[:4]
            want = ntt_mxu._digit_matmul(ntt_mxu._balanced_digits_dev(
                x[..., :1, :, :], tables.ndig_x), w[:1], contract_x)
            for got_s, want_s in zip(planes0(), want):
                if not torch.equal(got_s.long(), want_s.reshape(got_s.shape)):
                    raise AssertionError(f"{label}: torch._int_mm's digit planes differ from "
                                         "the plain version's")
            del want
        if kernel == "galois":
            lib = library_call(torch, *cargs, **ckw)
            same = lib().reshape(result.shape) == result
            if (cargs[2] if len(cargs) > 2 else ckw.get("moduli")) is None:
                ok = bool(same.all())
            else:  # signed: the permutation part, equal wherever the result is 0
                ok = bool((same | result.ne(0)).all())
            del same
            if not ok:
                raise AssertionError(f"{label}: the library call differs from the kernel")
        if kernel == "mod_raise":
            lib = remainder_call(torch, *cargs, **ckw)
            # the remainder is the lift wherever the input is not negative
            if not bool(((lib() == result) | (cargs[0] > cargs[4])).all()):
                raise AssertionError(f"{label}: torch.remainder differs from the kernel")
        if kernel == "negacyclic":
            shift = cargs[2] if fn.__name__ == "negacyclic_mono_mul_poly" else cargs[1]
            lib = negacyclic_call(torch, cargs[0], shift, cargs[-1])
            if fn.__name__ == "negacyclic_shift_poly" and not torch.equal(lib(), result):
                raise AssertionError(f"{label}: torch.roll + torch.where differ from the kernel")
        if kernel == "infty_norm":
            lib = infty_norm_call(torch, *cargs)
            if not torch.equal(lib(), result):
                raise AssertionError(f"{label}: torch.amax differs from the kernel")
        if kernel == "elementwise" and cargs[0] == "reduce64":
            pc = cargs[2]
            lib = (lambda x=cargs[1]: torch.remainder(x, pc))
            if not torch.equal(lib(), result):
                raise AssertionError(f"{label}: torch.remainder differs from the kernel")
        if not rehearsal and key in timed_once:
            ms, plain_ms, lib_ms = timed_once[key]
        elif not rehearsal:
            ms = event_ms(torch, lambda: fn(*cargs, **ckw), reps)
            # a plain version slower than 20 ms is timed over one call
            plain_reps = 1 if plain_s is None or plain_s > 0.02 else max(2, reps // 4)
            with plain_versions():
                plain_ms = event_ms(torch, lambda: fn(*cargs, **ckw), plain_reps)
            if lib is not None:
                lib_ms = event_ms(torch, lib, reps)
            if path in TIME_ONCE:
                timed_once[key] = (ms, plain_ms, lib_ms)
        bound, bound_by = bound_of(nbytes, ops, macs)
        row["step_calls"].append({"path": path, "fn": fn.__name__, "signature": repr(key[2]),
                                  "mode": mode, "ms": ms, "plain_ms": plain_ms,
                                  "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
                                  "bytes": nbytes, "imads": ops, "int8_macs": macs,
                                  **({"int8_macs_at_table_counts": macs_tables,
                                      "bound_ms_at_table_counts":
                                          bound_of(nbytes, ops, macs_tables)[0]}
                                     if kernel == "ntt_mxu" else {})})
        for acc in (row["by_path"],) + ((by_mode["by_path"],) if mode is not None else ()):
            bp = acc.setdefault(path, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                       "bound_ms": 0.0, "bytes": 0, "imads": 0, "int8_macs": 0,
                                       "calls": 0})
            if not rehearsal:
                bp["ms"] += ms
                bp["plain_ms"] += plain_ms
                bp["library_ms"] += lib_ms or 0.0
            bp["bound_ms"] += bound
            bp["bytes"] += nbytes
            bp["imads"] += ops
            bp["int8_macs"] += macs
            bp["calls"] += 1

    recorder = Recorder(check_call)

    def set_phase(name):
        """Start phase `name` of the running path (None: the path is over);
        the launches of the phase that ends are kept under its name."""
        if recorder.phase is not None:
            phase_launches[recorder.phase] = {k: cuda.LAUNCHES[k] - mark[k] for k in mark}
        mark.clear()
        mark.update(cuda.LAUNCHES)
        recorder.phase = name

    def begin(path):
        recorder.path = path
        cuda.reset_launches()
        phase_launches.clear()
        if not rehearsal:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def end(path, t0, per_step, **extra):
        """per_step: the step's launches, or a list of them (one per form
        of a path that drives two)."""
        set_phase(None)
        sync()
        forms = per_step if isinstance(per_step, list) else [per_step]
        launches = by_label(cuda.LAUNCHES)
        paths[path] = {"launches": launches,
                       "launches_per_step": by_label(forms[0]),
                       "launches_by_phase": {ph: by_label(v) for ph, v in phase_launches.items()},
                       "seconds_with_checks": time.perf_counter() - t0,
                       "peak_device_bytes_with_checks": (None if rehearsal
                                                         else torch.cuda.max_memory_allocated()),
                       **extra}
        if len(forms) > 1:
            paths[path]["launches_per_step_by_form"] = [by_label(f) for f in forms]
        emit({"phase": "main_path", "path": path, **paths[path]})
        missing = [k for k in PATH_KERNELS[path]
                   if launches[k] == 0 or not any(by_label(f)[k] for f in forms)]
        if path.startswith("bfv"):
            # the sharded BEHZ path decrypts config 3's inputs, encrypted there
            phases = {ph: ks for ph, ks in PHASE_KERNELS.items()
                      if ph != "encode_encrypt" or path != "bfv_mul_relin_behz4_n8192"}
            missing += [f"{k} ({ph})" for ph, ks in phases.items() for k in ks
                        if phase_launches[ph][k] == 0]
        if not rehearsal and missing:
            raise AssertionError(f"kernels not launched on {path}: {missing}")

    def count_step(fn, *fargs):
        before = dict(cuda.LAUNCHES)
        out = fn(*fargs)
        return out, {k: cuda.LAUNCHES[k] - before[k] for k in cuda.LAUNCHES}

    def max_err(got, want):
        return max(abs(g - w) for g, w in zip(got, want))

    keygen_s = {}

    def keygen_done(path, t0):
        keygen_s[path] = time.perf_counter() - t0
        emit({"phase": "keygen", "path": path, "host_prng": "native g++ build"
              if native.available() else "pure python", "seconds": keygen_s[path]})

    # 3a. mul_relin_rescale: bench.py's fused step (as before this slice)
    t0 = begin("mul_relin_rescale")
    set_phase("keygen")
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(tuple(range(71, 79)))
    sec = T.SecLevelType.none if rehearsal else T.SecLevelType.tc128
    ctx = T.SealContext(parms, sec_level=sec, device=device)
    kg = T.KeyGenerator(ctx, device=device)
    pk = kg.public_key()
    rk = kg.relin_keys().stacked(2)
    keygen_done("mul_relin_rescale", t0)

    set_phase("encode_encrypt")
    encoder = T.CKKSEncoder(ctx, device=device)
    enc = T.Encryptor(ctx, pk, device=device)
    dec = T.Decryptor(ctx, kg.secret_key, device=device)
    scale = 2.0 ** 40
    vals = [1.001] * encoder.slot_count
    ct = enc.encrypt(encoder.encode(vals, scale))
    a = ct.data.expand((batch,) + tuple(ct.data.shape)).contiguous()

    set_phase("step")
    step = T.build_ckks_mul_relin_rescale(ctx, fused=True, device=device)
    square = T.build_ckks_mul_relin_rescale(ctx, fused=True, square=True, device=device)
    out, per_step = count_step(step, a, a, rk)

    set_phase("decrypt_decode")
    first_cd = ctx.first_context_data()
    next_cd = first_cd.next_context_data
    out_scale = scale * scale / first_cd.parms.coeff_modulus[-1].value
    got = encoder.decode(dec.decrypt(T.Ciphertext(out[0], next_cd.parms_id, True, out_scale)))
    want_sq = [v * v for v in vals]
    err = max_err(got, want_sq)
    end("mul_relin_rescale", t0, per_step, out_shape=list(out.shape), max_abs_decode_err=err)
    if not err < 1e-4:
        raise AssertionError(f"mul_relin_rescale decodes to {err} from v^2")

    # a seeded non-constant vector, so that a rotation shows in the decode
    slots = encoder.slot_count
    v = np.random.default_rng(2024).uniform(-1.0, 1.0, slots)

    # 3b. train_step: the flagship step (sequential mul + rotate + add)
    t0 = begin("train_step")
    set_phase("keygen")
    elt1 = first_cd.galois_tool.get_elt_from_step(1)
    gk1 = kg.galois_keys([elt1]).stacked(elt1)
    keygen_done("train_step", t0)
    set_phase("encode_encrypt")
    ct_v = enc.encrypt(encoder.encode(v.tolist(), scale))
    av = ct_v.data.expand((batch,) + tuple(ct_v.data.shape)).contiguous()
    set_phase("step")
    train = T.build_ckks_train_step(ctx, rotate_steps=1, device=device)
    out, per_step = count_step(train, av, av, rk, gk1)
    set_phase("decrypt_decode")
    got = encoder.decode(dec.decrypt(T.Ciphertext(out[0], next_cd.parms_id, True, out_scale)))
    want_train = v * v + np.roll(v * v, -1)
    err = max_err(got, want_train)
    end("train_step", t0, per_step, out_shape=list(out.shape), max_abs_decode_err=err)
    if not err < 1e-4:
        raise AssertionError(f"train_step decodes to {err} from v_i^2 + v_(i+1)^2")

    # 3c. rotate_many: hoisted rotations by steps 1..R from one mod-up, with
    # the plain and the counter-rotated keys
    t0 = begin("rotate_many")
    set_phase("keygen")
    gks = kg.galois_keys_from_steps(rot_steps)
    tool = first_cd.galois_tool
    elts = tool.get_elts_from_steps(rot_steps)
    keys_stack = gks.stacked(*elts)
    pkeys_stack = T.prepermute_galois_stack(tool, elts, keys_stack)
    keygen_done("rotate_many", t0)
    set_phase("encode_encrypt")
    ct_r = enc.encrypt(encoder.encode(v.tolist(), scale))
    ar = ct_r.data.expand((rot_batch,) + tuple(ct_r.data.shape)).contiguous()
    set_phase("step")
    rmany = T.build_ckks_rotate_many(ctx, rot_steps, device=device)
    rmany_pk = T.build_ckks_rotate_many(ctx, rot_steps, prepermuted_keys=True, device=device)
    out, per_step = count_step(rmany, ar, keys_stack)
    pout, per_step_pk = count_step(rmany_pk, ar, pkeys_stack)
    set_phase("decrypt_decode")
    err = form_err = 0.0
    for r, s in enumerate(rot_steps):
        got, pgot = (encoder.decode(dec.decrypt(T.Ciphertext(o[r, 0].contiguous(),
                                                              ct_r.parms_id, True,
                                                              ct_r.scale)))
                     for o in (out, pout))
        err = max(err, max_err(got, np.roll(v, -s)), max_err(pgot, np.roll(v, -s)))
        form_err = max(form_err, max_err(got, pgot))
    end("rotate_many", t0, [per_step, per_step_pk], out_shape=list(out.shape),
        max_abs_decode_err=err, max_abs_decode_diff_between_key_forms=form_err)
    if not (err < 1e-4 and form_err < 1e-5):
        raise AssertionError(f"rotate_many decodes to {err} from the shifted v, and the "
                             f"key forms {form_err} apart")

    # 3d-e. the BFV paths (BASELINE configs 3 and 1): each decodes v^2 mod t
    def bfv_context(n_bfv, coeff_modulus, sec_level):
        parms = T.EncryptionParameters(T.SchemeType.BFV)
        parms.set_poly_modulus_degree(n_bfv)
        parms.set_coeff_modulus(coeff_modulus)
        parms.set_plain_modulus(T.PlainModulus.batching(n_bfv, 20))
        parms.set_random_seed(tuple(range(8)))
        return T.SealContext(parms, sec_level=sec_level, device=device)

    def bfv_path(path, n_bfv, coeff_modulus, sec_level, chain):
        t0 = begin(path)
        set_phase("keygen")
        bctx = bfv_context(n_bfv, coeff_modulus, sec_level)
        bkg = T.KeyGenerator(bctx, device=device)
        brk = bkg.relin_keys().stacked(2)
        keygen_done(path, t0)
        set_phase("encode_encrypt")
        be = T.BatchEncoder(bctx, device=device)
        benc = T.Encryptor(bctx, bkg.public_key(), device=device)
        bdec = T.Decryptor(bctx, bkg.secret_key, device=device)
        t = bctx.first_context_data().parms.plain_modulus.value
        vb = np.random.default_rng(2025).integers(0, t, n_bfv)
        bct = benc.encrypt(be.encode(vb.tolist()))
        ab = bct.data.expand((batch,) + tuple(bct.data.shape)).contiguous()
        set_phase("step")
        if chain:
            fn = T.build_bfv_mul_relin_modswitch(bctx, fused_drop=True, device=device)
            out_id = bctx.last_parms_id
        else:
            fn = T.build_bfv_mul_relin(bctx, device=device)
            out_id = bctx.first_parms_id
        out, per_step = count_step(fn, ab, ab, brk)
        set_phase("decrypt_decode")
        want = (vb.astype(object) ** 2 % t).tolist()

        def decodes(data, parms_id=out_id):
            return be.decode(bdec.decrypt(T.Ciphertext(data, parms_id, False))) == want

        exact = decodes(out[0]) and decodes(out[-1])
        end(path, t0, per_step, out_shape=list(out.shape), n=n_bfv,
            levels_out=len(bctx.get_context_data(out_id).parms.coeff_modulus),
            decode_exact=exact)
        if not exact:
            raise AssertionError(f"{path} does not decode to v^2 mod t")
        return bctx, brk, ab, fn, decodes

    bfv_n3, bfv_n1 = (1024, 1024) if rehearsal else (8192, 4096)
    cfg3 = bfv_path("bfv_mul_relin_chain", bfv_n3,
                    T.CoeffModulus.create(bfv_n3, [50, 40, 40, 40, 50]),
                    T.SecLevelType.none, chain=True)
    cfg1 = bfv_path("bfv_mul_relin", bfv_n1,
                    T.CoeffModulus.create(bfv_n1, [36, 36, 37]) if rehearsal
                    else T.CoeffModulus.bfv_default(bfv_n1),
                    T.SecLevelType.none if rehearsal else T.SecLevelType.tc128, chain=False)

    # 3f. bfv_rotate_rows (BASELINE config 2): bench_all.py's composition
    from gemini_seal_tpu_torch.ops.dyadic import add_poly
    from gemini_seal_tpu_torch.ops.keyswitch import KeySwitchPlan, switch_key

    n2 = 1024 if rehearsal else 8192
    t0 = begin("bfv_rotate_rows")
    set_phase("keygen")
    ctx2 = bfv_context(n2, T.CoeffModulus.create(n2, [30, 30, 30]) if rehearsal
                       else T.CoeffModulus.bfv_default(n2),
                       T.SecLevelType.none if rehearsal else T.SecLevelType.tc128)
    kg2 = T.KeyGenerator(ctx2, device=device)
    cd2 = ctx2.first_context_data()
    tool2, limbs2 = cd2.galois_tool, cd2.limb_constants
    elt_r, elt_c = tool2.get_elt_from_step(1), 2 * n2 - 1
    gk2 = kg2.galois_keys([elt_r, elt_c])
    key_r, key_c = gk2.stacked(elt_r), gk2.stacked(elt_c)
    keygen_done("bfv_rotate_rows", t0)
    set_phase("encode_encrypt")
    be2 = T.BatchEncoder(ctx2, device=device)
    enc2 = T.Encryptor(ctx2, kg2.public_key(), device=device)
    dec2 = T.Decryptor(ctx2, kg2.secret_key, device=device)
    t2 = cd2.parms.plain_modulus.value
    v2 = np.random.default_rng(2026).integers(0, t2, n2)
    ct2 = enc2.encrypt(be2.encode(v2.tolist()))
    a2b = ct2.data.expand((batch,) + tuple(ct2.data.shape)).contiguous()
    set_phase("step")
    plan2 = KeySwitchPlan(ctx2, cd2.parms_id)
    tool2.coeff_tables([elt_r])
    tool2.coeff_tables([elt_c])

    def bfv_rotate(elt):
        def rotate(x, key):
            rot = tool2.apply_galois(x, elt, limbs2)                  # both components
            d0, d1 = switch_key(rot[..., 1, :, :], key, plan2, False)
            return torch.stack([add_poly(rot[..., 0, :, :].contiguous(), d0, limbs2), d1],
                               dim=-3)
        return rotate

    rot_rows, rot_cols = bfv_rotate(elt_r), bfv_rotate(elt_c)
    out, per_step = count_step(rot_rows, a2b, key_r)
    set_phase("decrypt_decode")
    half = n2 // 2

    def rows_rotated(s):
        return np.concatenate([np.roll(v2[:half], -s), np.roll(v2[half:], -s)]).tolist()

    def decodes2(data):
        return be2.decode(dec2.decrypt(T.Ciphertext(data.contiguous(), cd2.parms_id, False)))

    exact = decodes2(out[0]) == rows_rotated(1) and decodes2(out[-1]) == rows_rotated(1)
    end("bfv_rotate_rows", t0, per_step, out_shape=list(out.shape), decode_exact=exact)
    if not exact:
        raise AssertionError("bfv_rotate_rows does not decode to the rows rotated by one")

    # 3g. bfv_rotate_many (config 2'): steps 1..8 from one mod-up, both key forms
    hsteps = list(range(1, 3 if rehearsal else 9))
    t0 = begin("bfv_rotate_many")
    set_phase("keygen")
    helts = tool2.get_elts_from_steps(hsteps)
    hstack = kg2.galois_keys(helts).stacked(*helts)
    phstack = T.prepermute_galois_stack(tool2, helts, hstack)
    keygen_done("bfv_rotate_many", t0)
    set_phase("encode_encrypt")
    ct2h = enc2.encrypt(be2.encode(v2.tolist()))
    a2h = ct2h.data.expand((rot_batch,) + tuple(ct2h.data.shape)).contiguous()
    set_phase("step")
    bmany = T.build_bfv_rotate_many(ctx2, hsteps, device=device)
    bmany_pk = T.build_bfv_rotate_many(ctx2, hsteps, prepermuted_keys=True, device=device)
    out, per_step = count_step(bmany, a2h, hstack)
    pout, per_step_pk = count_step(bmany_pk, a2h, phstack)
    set_phase("decrypt_decode")
    exact = all(decodes2(o[r, b]) == rows_rotated(s) for o in (out, pout)
                for r, s in enumerate(hsteps) for b in (0, rot_batch - 1))
    end("bfv_rotate_many", t0, [per_step, per_step_pk], out_shape=list(out.shape),
        decode_exact=exact, key_forms_decode_equal=exact)
    if not exact:
        raise AssertionError("bfv_rotate_many does not decode to the rotated rows")

    def ckks_context(n_c, bits):
        parms = T.EncryptionParameters(T.SchemeType.CKKS)
        parms.set_poly_modulus_degree(n_c)
        parms.set_coeff_modulus(T.CoeffModulus.create(n_c, bits))
        parms.set_random_seed(tuple(range(8)))
        c = T.SealContext(parms, sec_level=T.SecLevelType.none, device=device)
        k = T.KeyGenerator(c, device=device)
        return (c, k, T.CKKSEncoder(c, device=device), T.Encryptor(c, k.public_key(), device=device),
                T.Decryptor(c, k.secret_key, device=device))

    # 3h. ckks_mul_relin_rescale_n16384 (BASELINE config 4): the sequential step
    n4 = 1024 if rehearsal else 16384
    t0 = begin("ckks_mul_relin_rescale_n16384")
    set_phase("keygen")
    ctx4, kg4, encoder4, enc4, dec4 = ckks_context(
        n4, [40, 30, 40] if rehearsal else [50, 40, 40, 40, 40, 50])
    rk4 = kg4.relin_keys().stacked(2)
    keygen_done("ckks_mul_relin_rescale_n16384", t0)
    set_phase("encode_encrypt")
    scale4 = 2.0 ** 30 if rehearsal else 2.0 ** 40
    v4 = np.random.default_rng(2027).uniform(-1.0, 1.0, n4 // 2)
    ct4 = enc4.encrypt(encoder4.encode(v4.tolist(), scale4))
    a4 = ct4.data.expand((batch,) + tuple(ct4.data.shape)).contiguous()
    set_phase("step")
    step4 = T.build_ckks_mul_relin_rescale(ctx4, device=device)
    out, per_step = count_step(step4, a4, a4, rk4)
    set_phase("decrypt_decode")
    cd4 = ctx4.first_context_data()
    scale4_out = scale4 * scale4 / cd4.parms.coeff_modulus[-1].value
    err = max(max_err(encoder4.decode(dec4.decrypt(T.Ciphertext(
        out[b], cd4.next_context_data.parms_id, True, scale4_out))), v4 * v4)
        for b in (0, batch - 1))
    end("ckks_mul_relin_rescale_n16384", t0, per_step, out_shape=list(out.shape),
        max_abs_decode_err=err)
    if not err < 1e-4:
        raise AssertionError(f"ckks_mul_relin_rescale_n16384 decodes to {err} from v^2")
    ntt4 = a4.contiguous()

    # 3i. ckks_poly_eval_n32768 (BASELINE config 5): the deep polynomial
    n5 = 1024 if rehearsal else 32768
    coeffs5 = [1.0, -0.5, 0.25, 0.125, 0.0625]
    t0 = begin("ckks_poly_eval_n32768")
    set_phase("keygen")
    ctx5, kg5, encoder5, enc5, dec5 = ckks_context(
        n5, [59, 30, 30, 30, 59] if rehearsal else [59] + [40] * 6 + [59])
    rk5 = kg5.relin_keys().stacked(2)
    elts5 = ctx5.first_context_data().galois_tool.get_elts_from_steps([1, 2, 3])
    gk5 = kg5.galois_keys(elts5).stacked(*elts5)
    keygen_done("ckks_poly_eval_n32768", t0)
    set_phase("encode_encrypt")
    scale5 = 2.0 ** 30 if rehearsal else 2.0 ** 40
    v5 = np.random.default_rng(2028).uniform(-1.0, 1.0, n5 // 2)
    ct5 = enc5.encrypt(encoder5.encode(v5.tolist(), scale5))
    a5 = ct5.data.expand((batch,) + tuple(ct5.data.shape)).contiguous()
    set_phase("step")
    step5, deep5, out_scale5 = T.build_ckks_poly_eval(
        ctx5, coeffs5, scale5, encoder5, rotate_sum_log2=2, coeff_precision_bits=25,
        composed=True, rotate_mode="flat", device=device)
    out, per_step = count_step(step5, a5, rk5, gk5)
    set_phase("decrypt_decode")

    def p5(x):
        return sum(c * x ** k for k, c in enumerate(coeffs5))

    want5 = sum(p5(np.roll(v5, -j)) for j in range(4))
    err = max(max_err(encoder5.decode(dec5.decrypt(T.Ciphertext(out[b], deep5, True,
                                                                 out_scale5))), want5)
              for b in (0, batch - 1))
    end("ckks_poly_eval_n32768", t0, per_step, out_shape=list(out.shape),
        max_abs_decode_err=err)
    if not err < 1e-3:
        raise AssertionError(f"ckks_poly_eval_n32768 decodes {err} from sum p(v_(i+j))")

    # 3j. n65536: SEAL's cap; the NTT both ways, then the sequential step
    n6 = 2048 if rehearsal else 65536
    b6 = 2 if rehearsal else 16
    t0 = begin("n65536")
    set_phase("keygen")
    ctx6, kg6, encoder6, enc6, dec6 = ckks_context(n6, [50, 40, 40, 50])
    rk6 = kg6.relin_keys().stacked(2)
    keygen_done("n65536", t0)
    set_phase("ntt")
    cd6 = ctx6.first_context_data()
    rng6 = np.random.default_rng(9)
    x6 = to_tensor(np.stack([rng6.integers(0, m.value, (b6, 2, n6), dtype=np.uint64)
                             for m in cd6.parms.coeff_modulus], axis=2), device)
    f6 = ntt_ops.ntt_forward(x6, cd6.ntt_tables)
    i6 = ntt_ops.ntt_inverse(f6, cd6.ntt_tables)
    ntt_round_trip = bool(torch.equal(i6, x6))
    set_phase("encode_encrypt")
    vals6 = [0.5, -1.25, 2.0]
    ct6 = enc6.encrypt(encoder6.encode(vals6, 2.0 ** 40))
    a6 = ct6.data.expand((b6,) + tuple(ct6.data.shape)).contiguous()
    set_phase("step")
    step6 = T.build_ckks_mul_relin_rescale(ctx6, device=device)
    out, per_step = count_step(step6, a6, a6, rk6)
    set_phase("decrypt_decode")
    scale6 = 2.0 ** 80 / cd6.parms.coeff_modulus[-1].value
    want6 = [x * x for x in vals6] + [0.0] * (n6 // 2 - len(vals6))
    err = max(max_err(encoder6.decode(dec6.decrypt(T.Ciphertext(
        out[b], cd6.next_context_data.parms_id, True, scale6))), want6) for b in (0, b6 - 1))
    end("n65536", t0, per_step, out_shape=list(out.shape), max_abs_decode_err=err,
        ntt_round_trip_exact=ntt_round_trip)
    if not (err < 1e-4 and ntt_round_trip):
        raise AssertionError(f"n65536 decodes {err} from v^2 (NTT round trip "
                             f"exact: {ntt_round_trip})")

    # 3k. bootstrap_n4096: bench_all.py's refresh cell, bit for bit the JAX
    # package's (the rehearsal: N=128, radix 3, two special primes)
    from gemini_seal_tpu_torch.models.bootstrap import build_ckks_bootstrap, plan_bootstrap_chain

    n7, radix7, nsp7 = (128, 3, 2) if rehearsal else (4096, 4, 3)
    t0 = begin("bootstrap_n4096")
    set_phase("keygen")
    bits7, levels7, _ = plan_bootstrap_chain(n7, radix=radix7, nsp=nsp7, restored=2)
    parms7 = T.EncryptionParameters(T.SchemeType.CKKS)
    parms7.set_poly_modulus_degree(n7)
    parms7.set_coeff_modulus(T.CoeffModulus.create(n7, bits7))
    parms7.set_n_special_primes(nsp7)
    parms7.set_random_seed(tuple(range(8)))
    ctx7 = T.SealContext(parms7, sec_level=T.SecLevelType.none, device=device)
    kg7 = T.KeyGenerator(ctx7, device=device)
    enc7 = T.Encryptor(ctx7, kg7.public_key(), device=device)
    keygen7 = time.perf_counter() - t0
    set_phase("build")
    encoder7 = T.CKKSEncoder(ctx7, device=device)
    scale7 = 2.0 ** 45
    t1 = time.perf_counter()
    boot7, out_pid7, out_scale7, rsteps7, conj7 = build_ckks_bootstrap(
        ctx7, scale7, encoder7, linear_mode="split", radix=radix7, device=device)
    build7 = time.perf_counter() - t1
    set_phase("keygen")
    t1 = time.perf_counter()
    tool7 = ctx7.first_context_data().galois_tool
    elts7 = tool7.get_elts_from_steps(rsteps7)
    gk7 = kg7.galois_keys(elts7 + [conj7])
    rot7, conjk7 = gk7.stacked(*elts7), gk7.stacked(conj7)
    rk7 = kg7.relin_keys().stacked(2)
    keygen_s["bootstrap_n4096"] = keygen7 + time.perf_counter() - t1
    emit({"phase": "keygen", "path": "bootstrap_n4096", "host_prng": "native g++ build"
          if native.available() else "pure python", "seconds": keygen_s["bootstrap_n4096"],
          "galois_keys": len(elts7) + 1, "rotation_stack_bytes": rot7.numel() * 8})
    set_phase("encode_encrypt")
    msg7 = np.random.default_rng(13).uniform(-1, 1, encoder7.slot_count)
    ev7 = T.Evaluator(ctx7, device=device)
    ct7 = enc7.encrypt(encoder7.encode(msg7.tolist(), scale7))
    while ctx7.get_context_data(ct7.parms_id).next_context_data is not None:
        ct7 = ev7.mod_switch_to_next(ct7)
    x7 = ct7.data
    set_phase("step")
    out7, per_step = count_step(boot7, x7, rot7, conjk7, rk7)
    set_phase("decrypt_decode")
    dec7 = T.Decryptor(ctx7, kg7.secret_key, device=device)
    got7 = np.asarray(encoder7.decode(dec7.decrypt(T.Ciphertext(out7, out_pid7, True,
                                                               out_scale7)), as_complex=True))
    err7 = float(np.abs(got7 - msg7).max())
    digests7 = {"input_sha256": hashlib.sha256(to_numpy(x7).tobytes()).hexdigest(),
                "output_sha256": hashlib.sha256(to_numpy(out7).tobytes()).hexdigest()}
    levels_out7 = out7.shape[-2]
    end("bootstrap_n4096", t0, per_step, out_shape=list(out7.shape), n=n7,
        max_err=err7, levels_restored=levels_out7, levels_consumed=levels7,
        rotation_steps=len(rsteps7), build_seconds=build7, **digests7)
    if rehearsal:
        if not err7 < 1e-6:
            raise AssertionError(f"bootstrap refresh decodes {err7} from the message")
    else:
        want7 = BOOTSTRAP_N4096
        if (digests7["input_sha256"] != want7["input_sha256"]
                or digests7["output_sha256"] != want7["output_sha256"] or err7 != want7["max_err"]
                or (len(rsteps7), levels_out7, levels7) != (want7["rotation_steps"],
                                                            want7["levels_restored"],
                                                            want7["levels_consumed"])):
            raise AssertionError(f"bootstrap_n4096 differs from the JAX package's refresh: "
                                 f"{digests7}, max_err {err7}")

    # 3l. dense8x8_n8192: bench_all.py's encrypted dense layer (hoisted matvec)
    n8 = 1024 if rehearsal else 8192
    t0 = begin("dense8x8_n8192")
    set_phase("keygen")
    ctx8, kg8, encoder8, enc8, dec8 = ckks_context(n8, [50, 40, 40, 50])
    M8 = np.random.default_rng(1).uniform(-0.5, 0.5, size=(8, 8))
    slots8 = encoder8.slot_count
    diag8 = {d: [M8[i % 8, (i + d) % 8] for i in range(slots8)] for d in range(8)}
    tool8 = ctx8.first_context_data().galois_tool
    elts8 = tool8.get_elts_from_steps(list(range(1, 8)))
    gk8 = kg8.galois_keys(elts8).stacked(*elts8)
    keygen_done("dense8x8_n8192", t0)
    set_phase("encode_encrypt")
    ct8 = enc8.encrypt(encoder8.encode([0.5] * slots8, 2.0 ** 40))
    b8 = max(batch // 8, 2)
    a8 = ct8.data.expand((b8,) + tuple(ct8.data.shape)).contiguous()
    set_phase("step")
    mv8 = T.build_ckks_matvec(ctx8, diag8, 2.0 ** 40, encoder8, device=device)
    out8, per_step = count_step(mv8, a8, gk8)
    set_phase("decrypt_decode")
    want8 = np.asarray([0.5 * M8[i % 8].sum() for i in range(slots8)])
    err8 = max(max_err(encoder8.decode(dec8.decrypt(T.Ciphertext(
        out8[b].contiguous(), ct8.parms_id, True, 2.0 ** 80))), want8) for b in (0, b8 - 1))
    end("dense8x8_n8192", t0, per_step, out_shape=list(out8.shape), max_abs_decode_err=err8)
    if not err8 < 1e-4:
        raise AssertionError(f"dense8x8_n8192 decodes {err8} from M x")
    # 3m-p. the SEAL per-op API: examples/ex1-ex5 and ex8 through the port's
    # Evaluator, DeviceEvaluator and IntegerEncoder, each at its example's ring
    # (the rehearsal: N=256); keygen in each example's order, parms seed range(8)
    from gemini_seal_tpu_torch.ops import dyadic as dyadic_ops

    def per_op_context(scheme, n_c, coeff_modulus, t=None, nsp=1, sec=T.SecLevelType.tc128):
        parms = T.EncryptionParameters(scheme)
        parms.set_poly_modulus_degree(n_c)
        parms.set_n_special_primes(nsp)
        parms.set_coeff_modulus(coeff_modulus)
        if t is not None:
            parms.set_plain_modulus(t)
        parms.set_random_seed(tuple(range(8)))
        return T.SealContext(parms, sec_level=T.SecLevelType.none if rehearsal else sec,
                             device=device)

    def digest(ct):
        return hashlib.sha256(to_numpy(ct.data).tobytes()).hexdigest()

    def hex_plain(h):
        return T.Plaintext.from_hex(h, device=device)

    n_e = 256 if rehearsal else 4096

    def bfv_default(n_c):
        return T.CoeffModulus.create(n_c, [40, 40, 40]) if rehearsal else T.CoeffModulus.bfv_default(n_c)

    # 3m. per_op_bfv_n4096: ex1, ex2's IntegerEncoder and BatchEncoder demos,
    # ex5's BFV rotations (ex2's batching context is ex5's: bfv_default,
    # PlainModulus.batching(4096, 20), one special prime)
    t0 = begin("per_op_bfv_n4096")
    set_phase("keygen")
    ctx_e1 = per_op_context(T.SchemeType.BFV, n_e, bfv_default(n_e), 1024)
    kg_e1 = T.KeyGenerator(ctx_e1, device=device)
    pk_e1, rk_e1 = kg_e1.public_key(), kg_e1.relin_keys()
    enc_e1 = T.Encryptor(ctx_e1, pk_e1, device=device)
    ev_e1 = T.Evaluator(ctx_e1, device=device)
    dec_e1 = T.Decryptor(ctx_e1, kg_e1.secret_key, device=device)
    ctx_ei = per_op_context(T.SchemeType.BFV, n_e, bfv_default(n_e), 512)
    kg_ei = T.KeyGenerator(ctx_ei, device=device)
    enc_ei = T.Encryptor(ctx_ei, kg_ei.public_key(), device=device)
    dec_ei = T.Decryptor(ctx_ei, kg_ei.secret_key, device=device)
    ev_ei = T.Evaluator(ctx_ei, device=device)
    int_enc = T.IntegerEncoder(ctx_ei, device=device)
    ctx_eb = per_op_context(T.SchemeType.BFV, n_e, bfv_default(n_e),
                            T.PlainModulus.batching(n_e, 20))
    kg_eb = T.KeyGenerator(ctx_eb, device=device)
    enc_eb = T.Encryptor(ctx_eb, kg_eb.public_key(), device=device)
    dec_eb = T.Decryptor(ctx_eb, kg_eb.secret_key, device=device)
    ev_eb = T.Evaluator(ctx_eb, device=device)
    be_eb = T.BatchEncoder(ctx_eb, device=device)
    rk_eb, gk_eb = kg_eb.relin_keys(), kg_eb.galois_keys()
    keygen_done("per_op_bfv_n4096", t0)
    set_phase("encode_encrypt")
    x_e1 = enc_e1.encrypt(hex_plain("6"))
    c_ei = [enc_ei.encrypt(int_enc.encode(v)) for v in (5, -7)]
    row_eb = be_eb.slot_count // 2
    mat_eb = [1, 2, 3, 4] + [0] * (be_eb.slot_count - 4)
    ct_eb = enc_eb.encrypt(be_eb.encode(mat_eb))
    limbs_e1 = ctx_e1.first_context_data().limb_constants
    set_phase("step")

    def ex1_ops(ev, x, rk):
        a = ev.add_plain(ev.relinearize(ev.square(x), rk), hex_plain("1"))
        b = ev.relinearize(ev.square(ev.add_plain(x, hex_plain("1"))), rk)
        r = ev.relinearize(ev.multiply(ev.multiply_plain(a, hex_plain("4")), b), rk)
        return a, b, r

    def per_op_bfv():
        a, b, r = ex1_ops(ev_e1, x_e1, rk_e1)
        out = {"ex1": (x_e1, a, b, r), "int_sum": ev_ei.add(*c_ei),
               "batch_square": ev_eb.relinearize(ev_eb.square(ct_eb), rk_eb),
               "rows3": ev_eb.rotate_rows(ct_eb, 3, gk_eb),
               "columns": ev_eb.rotate_columns(ct_eb, gk_eb)}
        # the rest of ops/dyadic.py on ex1's tensors: the shift alone by N + 3,
        # the centred norm of the result, Barrett-64 of the unreduced sums
        out["shifted"] = dyadic_ops.negacyclic_shift_poly(r.data, n_e + 3, limbs_e1)
        out["norm"] = dyadic_ops.poly_infty_norm(r.data, limbs_e1)
        out["reduced"] = dyadic_ops.modulo_poly_coeffs(r.data + b.data, limbs_e1)
        return out

    res_e, per_step = count_step(per_op_bfv)
    set_phase("decrypt_decode")
    x_e1, a_e1, b_e1, r_e1 = res_e["ex1"]
    budgets_e1 = [dec_e1.invariant_noise_budget(c) for c in res_e["ex1"]]
    got_e1 = int(to_numpy(dec_e1.decrypt(r_e1).data)[0])
    int_sum = int_enc.decode(dec_ei.decrypt(res_e["int_sum"]))
    sq_eb = be_eb.decode(dec_eb.decrypt(res_e["batch_square"]))
    rows3 = be_eb.decode(dec_eb.decrypt(res_e["rows3"]))
    cols = be_eb.decode(dec_eb.decrypt(res_e["columns"]))
    back = dyadic_ops.negacyclic_shift_poly(res_e["shifted"], n_e - 3, limbs_e1)
    r_np = to_numpy(r_e1.data).astype(object)
    mods_e1 = [m.value for m in ctx_e1.first_context_data().parms.coeff_modulus]
    norm_want = [[max(min(int(v), p_ - int(v)) for v in r_np[c, l]) for l, p_ in enumerate(mods_e1)]
                 for c in range(r_np.shape[0])]
    sums = (r_np + to_numpy(b_e1.data).astype(object))
    reduce_want = [[[int(v) % p_ for v in sums[c, l]] for l, p_ in enumerate(mods_e1)]
                   for c in range(sums.shape[0])]
    checks_e = {
        "ex1_decrypts": got_e1 == EX1["decrypts"],
        "ex1_budgets": budgets_e1 == EX1["budgets"] if not rehearsal else budgets_e1[-1] > 0,
        "ex1_sha256": rehearsal or digest(r_e1) == EX1["sha256"],
        "ex2_integer_sum": int_sum == -2,
        "ex2_batch_square": sq_eb[:4] == [1, 4, 9, 16],
        "ex5_rotate_rows_3": rows3[0] == 4 and rows3[row_eb - 3] == 1,
        "ex5_rotate_columns": cols[row_eb] == 1 and cols[row_eb + 1] == 2,
        "shift_round_trip": bool(torch.equal(back, r_e1.data)),
        "norm": to_numpy(res_e["norm"]).astype(object).tolist() == norm_want,
        "reduce64": to_numpy(res_e["reduced"]).astype(object).tolist() == reduce_want,
    }
    end("per_op_bfv_n4096", t0, per_step, n=n_e, ex1_budgets=budgets_e1,
        ex1_sha256=digest(r_e1), ex1_decrypts=got_e1, ex2_integer_sum=int_sum, checks=checks_e)
    if not all(checks_e.values()):
        raise AssertionError(f"per_op_bfv_n4096: {checks_e}")

    # 3n. per_op_bfv_n8192_levels: ex3, the modulus-switching chain
    n_e3 = 256 if rehearsal else 8192
    t0 = begin("per_op_bfv_n8192_levels")
    set_phase("keygen")
    ctx_e3 = per_op_context(T.SchemeType.BFV, n_e3,
                            T.CoeffModulus.create(n_e3, [50, 30, 30, 50, 50]), 1032193)
    kg_e3 = T.KeyGenerator(ctx_e3, device=device)
    enc_e3 = T.Encryptor(ctx_e3, kg_e3.public_key(), device=device)
    dec_e3 = T.Decryptor(ctx_e3, kg_e3.secret_key, device=device)
    ev_e3 = T.Evaluator(ctx_e3, device=device)
    rk_e3 = kg_e3.relin_keys()
    keygen_done("per_op_bfv_n8192_levels", t0)
    set_phase("encode_encrypt")
    ct_e3 = enc_e3.encrypt(hex_plain("5x^2 + 3x^1 + 1"))
    set_phase("step")

    def per_op_levels():
        sq = ev_e3.relinearize(ev_e3.square(ct_e3), rk_e3)
        sw = ev_e3.mod_switch_to_next(sq)
        return sq, sw, ev_e3.mod_switch_to_next(ev_e3.relinearize(ev_e3.square(sw), rk_e3))

    (sq_e3, sw_e3, sw2_e3), per_step = count_step(per_op_levels)
    set_phase("decrypt_decode")
    budgets_e3 = [dec_e3.invariant_noise_budget(c) for c in (ct_e3, sq_e3, sw_e3, sw2_e3)]
    degree_e3 = dec_e3.decrypt(sw2_e3).significant_coeff_count() - 1
    checks_e3 = {"degree": degree_e3 == EX3["degree"],
                 "budgets": budgets_e3 == EX3["budgets"] if not rehearsal else budgets_e3[-1] > 0,
                 "sha256": rehearsal or digest(sw2_e3) == EX3["sha256"]}
    end("per_op_bfv_n8192_levels", t0, per_step, n=n_e3, budgets=budgets_e3,
        sha256=digest(sw2_e3), degree=degree_e3, checks=checks_e3)
    if not all(checks_e3.values()):
        raise AssertionError(f"per_op_bfv_n8192_levels: {checks_e3}")

    # 3o. per_op_ckks: ex2's CKKS square + rescale (N=4096, [40, 30, 30], 2^30),
    # ex4's pi x^3 + 0.4 x + 1 (N=8192, three special primes, [55, 40, 40, 50,
    # 50, 50], 2^40), ex5's CKKS rotation and conjugation (N=8192, [40, 40, 40,
    # 40, 50, 50], the default Galois keys)
    n_c2, n_c8 = (256, 256) if rehearsal else (4096, 8192)
    t0 = begin("per_op_ckks")
    set_phase("keygen")

    def ckks_example(n_c, bits, nsp, sec):
        c = per_op_context(T.SchemeType.CKKS, n_c, T.CoeffModulus.create(n_c, bits), nsp=nsp,
                           sec=sec)
        k = T.KeyGenerator(c, device=device)
        return (c, k, T.Encryptor(c, k.public_key(), device=device),
                T.Decryptor(c, k.secret_key, device=device), T.Evaluator(c, device=device),
                T.CKKSEncoder(c, device=device))

    _, kg_c2, enc_c2, dec_c2, ev_c2, cod_c2 = ckks_example(n_c2, [40, 30, 30], 1,
                                                                  T.SecLevelType.tc128)
    rk_c2 = kg_c2.relin_keys()
    _, kg_c4, enc_c4, dec_c4, ev_c4, cod_c4 = ckks_example(
        n_c8, [55, 40, 40, 50, 50, 50], 3, T.SecLevelType.none)
    rk_c4 = kg_c4.relin_keys()
    _, kg_c5, enc_c5, dec_c5, ev_c5, cod_c5 = ckks_example(
        n_c8, [40, 40, 40, 40, 50, 50], 1, T.SecLevelType.none)
    gk_c5 = kg_c5.galois_keys()
    keygen_done("per_op_ckks", t0)
    set_phase("encode_encrypt")
    vals_c2 = [0.0, 1.1, 2.2, 3.3]
    ct_c2 = enc_c2.encrypt(cod_c2.encode(vals_c2, 2.0 ** 30))
    scale_c4 = 2.0 ** 40
    xs_c4 = [i / cod_c4.slot_count for i in range(cod_c4.slot_count)]
    x_c4 = enc_c4.encrypt(cod_c4.encode(xs_c4, scale_c4))
    pi_c4, coeff_c4 = cod_c4.encode(3.14159265, scale_c4), cod_c4.encode(0.4, scale_c4)
    vals_c5 = [i * 0.01 for i in range(cod_c5.slot_count)]
    ct_c5 = enc_c5.encrypt(cod_c5.encode(vals_c5, 2.0 ** 30))
    set_phase("step")

    def per_op_ckks():
        sq = ev_c2.rescale_to_next(ev_c2.relinearize(ev_c2.square(ct_c2), rk_c2))
        x_sq = ev_c4.rescale_to_next(ev_c4.relinearize(ev_c4.square(x_c4), rk_c4))
        pi_x = ev_c4.rescale_to_next(ev_c4.multiply_plain(x_c4, pi_c4))
        x3 = ev_c4.rescale_to_next(ev_c4.relinearize(ev_c4.multiply(x_sq, pi_x), rk_c4))
        c_x = ev_c4.mod_switch_to(ev_c4.rescale_to_next(ev_c4.multiply_plain(x_c4, coeff_c4)),
                                  x3.parms_id)
        forced = float(2.0 ** round(math.log2(x3.scale)))
        x3.scale = forced
        c_x.scale = forced
        one = cod_c4.encode(1.0, forced, x3.parms_id)
        total = ev_c4.add_plain(ev_c4.add(x3, c_x), one)
        return (sq, total, ev_c5.rotate_vector(ct_c5, 2, gk_c5),
                ev_c5.complex_conjugate(ct_c5, gk_c5))

    (sq_c2, total_c4, rot_c5, conj_c5), per_step = count_step(per_op_ckks)
    set_phase("decrypt_decode")
    out_c2 = cod_c2.decode(dec_c2.decrypt(sq_c2))
    err_c2 = max(abs(o - v * v) for o, v in zip(out_c2[:4], vals_c2))
    out_c4 = cod_c4.decode(dec_c4.decrypt(total_c4))
    err_c4 = max(abs(o - (3.14159265 * v ** 3 + 0.4 * v + 1.0)) for o, v in zip(out_c4, xs_c4))
    rot_out = cod_c5.decode(dec_c5.decrypt(rot_c5))
    conj_out = cod_c5.decode(dec_c5.decrypt(conj_c5))
    checks_c = {"ex2_square": err_c2 < 1e-2, "ex4_polynomial": err_c4 < 1e-2,
                "ex5_rotate_vector_2": abs(rot_out[0] - vals_c5[2]) < 1e-3,
                "ex5_conjugate": abs(conj_out[1] - vals_c5[1]) < 1e-3}
    end("per_op_ckks", t0, per_step, ex2_max_err=err_c2, ex4_max_err=err_c4,
        ex5_rotate_err=abs(rot_out[0] - vals_c5[2]), checks=checks_c)
    if not all(checks_c.values()):
        raise AssertionError(f"per_op_ckks: {checks_c}")

    # 3p. device_evaluator_n8192: ex8's three tiers at bench.py's ring, which
    # must agree bit for bit: the Evaluator's multiply, relinearize, rescale,
    # rotate by one and add; the same on the DeviceEvaluator; the train step
    # (build_ckks_train_step) at batch 8 (the rehearsal: 2)
    n_d = 256 if rehearsal else 8192
    b_d = 2 if rehearsal else 8
    t0 = begin("device_evaluator_n8192")
    set_phase("keygen")
    ctx_d = per_op_context(T.SchemeType.CKKS, n_d, T.CoeffModulus.create(n_d, [50, 40, 40, 50]),
                           sec=T.SecLevelType.none)
    kg_d = T.KeyGenerator(ctx_d, device=device)
    enc_d = T.Encryptor(ctx_d, kg_d.public_key(), device=device)
    dec_d = T.Decryptor(ctx_d, kg_d.secret_key, device=device)
    cod_d = T.CKKSEncoder(ctx_d, device=device)
    rk_d, gk_d = kg_d.relin_keys(), kg_d.galois_keys_from_steps([1])
    elt_d = ctx_d.first_context_data().galois_tool.get_elt_from_step(1)
    rk_d2, gk_d1 = rk_d.stacked(2), gk_d.stacked(elt_d)
    ev_d, dev_d = T.Evaluator(ctx_d, device=device), T.DeviceEvaluator(ctx_d, device=device)
    keygen_done("device_evaluator_n8192", t0)
    set_phase("encode_encrypt")
    vals_d = [0.1 * i for i in range(16)]
    ct_d = enc_d.encrypt(cod_d.encode(vals_d, 2.0 ** 40))
    batch_d = ct_d.data.expand((b_d,) + tuple(ct_d.data.shape)).contiguous()
    train_d = T.build_ckks_train_step(ctx_d, rotate_steps=1, device=device)
    set_phase("step")

    def ex8_chain(ev, ct):
        prod = ev.rescale_to_next(ev.relinearize(ev.multiply(ct, ct), rk_d))
        return ev.add(prod, ev.rotate_vector(prod, 1, gk_d))

    def per_op_tiers():
        return (ex8_chain(ev_d, ct_d), ex8_chain(dev_d, dev_d.put(ct_d)),
                train_d(batch_d, batch_d, rk_d2, gk_d1),
                dev_d.multiply_relin_rescale(ct_d, ct_d, rk_d))

    (host_d, dev_out_d, fused_d, mrr_d), per_step = count_step(per_op_tiers)
    set_phase("decrypt_decode")
    got_d = cod_d.decode(dec_d.decrypt(host_d))
    mrr_got = cod_d.decode(dec_d.decrypt(mrr_d))
    checks_d = {
        "device_equals_host": bool(torch.equal(dev_out_d.data, host_d.data)),
        "train_step_equals_host": all(bool(torch.equal(fused_d[b], host_d.data))
                                      for b in (0, b_d - 1)),
        "sha256": rehearsal or digest(host_d) == EX8["sha256"],
        "decodes": max_err(got_d[:4], EX8["decodes"]) < 1e-3,
        "multiply_relin_rescale": max_err(mrr_got[:16], [v * v for v in vals_d]) < 1e-4,
    }
    end("device_evaluator_n8192", t0, per_step, sha256=digest(host_d), decodes=got_d[:4],
        batch=b_d, checks=checks_d)
    if not all(checks_d.values()):
        raise AssertionError(f"device_evaluator_n8192: {checks_d}")

    # 3q-v. the multi-device schedules of parallel/: C = 4 ranks of a
    # ThreadGroup (threads of this process) on the one card, each held bit
    # for bit to the port's single-card path on the same inputs
    from gemini_seal_tpu_torch.parallel import behz_sp as pbehz
    from gemini_seal_tpu_torch.parallel import bootstrap_sp as pboot
    from gemini_seal_tpu_torch.parallel import keyswitch_sp as pks
    from gemini_seal_tpu_torch.parallel import ntt_sp as psp
    from gemini_seal_tpu_torch.parallel import pipeline_csp as pcsp
    from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd

    C4 = 4
    team = ThreadGroup(C4, device, lock=recorder.lock)
    group_of = {"ranks": C4, "group": "threads", "cards": 1}
    team_stats = {}

    def chunks_of(x):
        b = x.shape[-1] // C4
        return [x[..., r * b:(r + 1) * b].contiguous() for r in range(C4)]

    def rows_of(x):
        b = x.shape[-2] // C4
        return [x[..., r * b:(r + 1) * b, :].contiguous() for r in range(C4)]

    def spmd(body, *per_rank):
        """One sharded call on the team; its collectives (rank 0's, the
        ranks' agree) kept under the running path."""
        team.reset()
        out = run_spmd(body, team, *per_rank)
        if recorder.phase is not None:
            team_stats.setdefault(recorder.path, []).append(team.stats[0].as_dict())
        return out

    def ntt_sp_path(path, x, tables):
        """The coefficient-sharded NTT of x both ways in both forms; every
        result must equal K1's transform of the whole rows."""
        t0 = begin(path)
        set_phase("step")
        xc = chunks_of(x)

        def body(g, xl):
            return [psp.ntt_forward_sharded(xl, tables, g), psp.ntt_inverse_sharded(xl, tables, g),
                    psp.ntt_forward_sharded_4step(xl, tables, g),
                    psp.ntt_inverse_sharded_4step(xl, tables, g)]

        outs, per_step = count_step(spmd, body, xc)
        set_phase("reference")
        want_f, want_i = ntt_ops.ntt_forward(x, tables), ntt_ops.ntt_inverse(x, tables)
        equal = {name: bool(torch.equal(torch.cat([o[k] for o in outs], -1), want))
                 for k, (name, want) in enumerate((("hypercube_forward", want_f),
                                                   ("hypercube_inverse", want_i),
                                                   ("four_step_forward", want_f),
                                                   ("four_step_inverse", want_i)))}
        del outs, want_f, want_i
        end(path, t0, per_step, **group_of, input_shape=list(x.shape),
            collectives=team_stats[path][-1], equal_to_single_card=equal)
        if not all(equal.values()):
            raise AssertionError(f"{path} differs from K1's transform: {equal}")
        return lambda: spmd(body, xc)

    # 3q. ntt_sp4_n65536: the N=65536 cell's [16, 2, 4, 65536] residues
    ntt_sp_step6 = ntt_sp_path("ntt_sp4_n65536", x6, cd6.ntt_tables)
    # 3r. ntt_sp4_n16384: config 4's tables and step input
    ntt_sp_step4 = ntt_sp_path("ntt_sp4_n16384", ntt4, cd4.ntt_tables)

    # 3s. ckks_mul_relin_rescale_csp4_n16384: config 4 on the coefficient-
    # sharded pipeline (four-step NTTs), then one rotation at batch 16
    t0 = begin("ckks_mul_relin_rescale_csp4_n16384")
    set_phase("keygen")
    tool4 = cd4.galois_tool
    elt4 = tool4.get_elt_from_step(1)
    gk4 = kg4.galois_keys([elt4]).stacked(elt4)
    plan4 = KeySwitchPlan(ctx4, cd4.parms_id)
    keygen_done("ckks_mul_relin_rescale_csp4_n16384", t0)
    set_phase("step")
    b4r = max(batch // 8, 2)
    a4c, rk4c, gk4c, a4rc = chunks_of(a4), chunks_of(rk4), chunks_of(gk4), chunks_of(a4[:b4r])

    def csp_mrr(ac, kc):
        return spmd(lambda g, x, k: pcsp.ckks_mul_relin_rescale_coeff_sharded(x, x, k, plan4, g),
                    ac, kc)

    def csp_rot(ac, kc):
        return spmd(lambda g, x, k: pcsp.ckks_rotate_coeff_sharded(x, k, elt4, tool4, plan4, g),
                    ac, kc)

    outs, per_step = count_step(csp_mrr, a4c, rk4c)
    rot_outs, per_step_rot = count_step(csp_rot, a4rc, gk4c)
    got4 = torch.cat(outs, -1)
    rot4 = torch.cat(rot_outs, -1)
    del outs, rot_outs
    set_phase("reference")
    rot4_single = T.build_ckks_rotate(ctx4, 1, device=device)
    equal = {"mul_relin_rescale": bool(torch.equal(got4, step4(a4, a4, rk4))),
             "rotate": bool(torch.equal(rot4, rot4_single(a4[:b4r], gk4)))}
    set_phase("decrypt_decode")
    err = max(max_err(encoder4.decode(dec4.decrypt(T.Ciphertext(
        got4[b], cd4.next_context_data.parms_id, True, scale4_out))), v4 * v4)
        for b in (0, batch - 1))
    rot_err = max_err(encoder4.decode(dec4.decrypt(T.Ciphertext(rot4[-1].contiguous(),
                                                                cd4.parms_id, True, scale4))),
                      np.roll(v4, -1))
    end("ckks_mul_relin_rescale_csp4_n16384", t0, [per_step, per_step_rot], **group_of,
        out_shape=list(got4.shape), rotate_batch=b4r,
        collectives={"mul_relin_rescale": team_stats[recorder.path][0],
                     "rotate": team_stats[recorder.path][1]},
        equal_to_single_card=equal, max_abs_decode_err=err, rotate_max_abs_decode_err=rot_err)
    if not (all(equal.values()) and err < 1e-4 and rot_err < 1e-4):
        raise AssertionError(f"ckks_mul_relin_rescale_csp4_n16384: {equal}, decodes {err} from "
                             f"v^2 and {rot_err} from v rotated by one")
    del got4, rot4

    # 3t. ckks_mul_relin_rescale_limb4_n4096: the one-gather step at the JAX
    # package's realistic serving shape (N=4096, [30] x 10, two special
    # primes: n_ct = 8, two rows a rank; the rehearsal: N=256), batch 128,
    # then the hoisted rotations by steps 1..8 at batch 16
    n_l = 256 if rehearsal else 4096
    scale_l = 2.0 ** 28
    steps_l = list(range(1, 3 if rehearsal else 9))
    t0 = begin("ckks_mul_relin_rescale_limb4_n4096")
    set_phase("keygen")
    parms_l = T.EncryptionParameters(T.SchemeType.CKKS)
    parms_l.set_poly_modulus_degree(n_l)
    parms_l.set_coeff_modulus(T.CoeffModulus.create(n_l, [30] * 10))
    parms_l.set_n_special_primes(2)
    parms_l.set_random_seed(tuple(range(91, 99)))
    ctx_l = T.SealContext(parms_l, sec_level=T.SecLevelType.none, device=device)
    kg_l = T.KeyGenerator(ctx_l, device=device)
    cd_l = ctx_l.first_context_data()
    tool_l = cd_l.galois_tool
    elts_l = tool_l.get_elts_from_steps(sorted(set(steps_l) | set(range(1, 8))))
    gks_l = kg_l.galois_keys(elts_l)
    rk_l = kg_l.relin_keys().stacked(2)
    rot_elts_l = tool_l.get_elts_from_steps(steps_l)
    rot_keys_l = gks_l.stacked(*rot_elts_l)
    plan_l = KeySwitchPlan(ctx_l, cd_l.parms_id)
    keygen_done("ckks_mul_relin_rescale_limb4_n4096", t0)
    set_phase("encode_encrypt")
    enc_l = T.Encryptor(ctx_l, kg_l.public_key(), device=device)
    dec_l = T.Decryptor(ctx_l, kg_l.secret_key, device=device)
    cod_l = T.CKKSEncoder(ctx_l, device=device)
    v_l = np.random.default_rng(2029).uniform(-1.0, 1.0, n_l // 2)
    ct_l = enc_l.encrypt(cod_l.encode(v_l.tolist(), scale_l))
    a_l = ct_l.data.expand((batch,) + tuple(ct_l.data.shape)).contiguous()
    b_lr = rot_batch
    set_phase("step")
    a_lc, a_lrc = rows_of(a_l), rows_of(a_l[:b_lr])

    def limb_mrr(ac):
        return spmd(lambda g, x: pks.ckks_mul_relin_rescale_limb_sharded(x, x, rk_l, plan_l, g),
                    ac)

    def limb_rot(ac):
        return spmd(lambda g, x: pks.rotate_many_limb_sharded(x, rot_keys_l, rot_elts_l, tool_l,
                                                              plan_l, g), ac)

    outs, per_step = count_step(limb_mrr, a_lc)
    rot_outs, per_step_rot = count_step(limb_rot, a_lrc)
    got_l = torch.cat(outs, -2)
    rot_l = torch.cat(rot_outs, -2)                      # [b, R, 2, n_ct, N]
    del outs, rot_outs
    set_phase("reference")
    n_ct_l = plan_l.n_ct_rns
    mrr_l = T.build_ckks_mul_relin_rescale(ctx_l, device=device)
    rmany_l = T.build_ckks_rotate_many(ctx_l, steps_l, device=device)
    equal = {"mul_relin_rescale": bool(torch.equal(got_l[..., : n_ct_l - 1, :],
                                                   mrr_l(a_l, a_l, rk_l))),
             "q_last_row_zero": bool((got_l[..., n_ct_l - 1, :] == 0).all()),
             "rotate_many": bool(torch.equal(rot_l.movedim(-4, 0),
                                             rmany_l(a_l[:b_lr], rot_keys_l)))}
    set_phase("decrypt_decode")
    scale_l_out = scale_l * scale_l / cd_l.parms.coeff_modulus[-1].value
    err = max(max_err(cod_l.decode(dec_l.decrypt(T.Ciphertext(
        got_l[b, :, : n_ct_l - 1].contiguous(), cd_l.next_context_data.parms_id, True,
        scale_l_out))), v_l * v_l) for b in (0, batch - 1))
    rot_err = max(max_err(cod_l.decode(dec_l.decrypt(T.Ciphertext(
        rot_l[-1, r].contiguous(), cd_l.parms_id, True, scale_l))), np.roll(v_l, -s))
        for r, s in enumerate(steps_l))
    end("ckks_mul_relin_rescale_limb4_n4096", t0, [per_step, per_step_rot], **group_of,
        n=n_l, out_shape=list(got_l.shape), rotate_batch=b_lr, rotate_steps=steps_l,
        collectives={"mul_relin_rescale": team_stats[recorder.path][0],
                     "rotate_many": team_stats[recorder.path][1]},
        equal_to_single_card=equal, max_abs_decode_err=err, rotate_max_abs_decode_err=rot_err)
    # 30-bit primes at scale 2^28: the key switches' noise sets these bounds
    if not (all(equal.values()) and err < 1e-2 and rot_err < 1e-2):
        raise AssertionError(f"ckks_mul_relin_rescale_limb4_n4096: {equal}, decodes {err} from "
                             f"v^2 and {rot_err} from the rotated v")
    del got_l, rot_l

    # 3u. bfv_mul_relin_behz4_n8192: config 3's ring (n_ct = 4, one q row
    # and one B row a rank) through behz_sp at batch 128
    bctx3, brk3, ab3, chain3, decodes3 = cfg3
    t0 = begin("bfv_mul_relin_behz4_n8192")
    set_phase("step")
    first3 = bctx3.first_parms_id
    plan3 = KeySwitchPlan(bctx3, first3)
    ab3c = rows_of(ab3)

    def behz_mul(ac):
        return spmd(lambda g, x: pbehz.bfv_mul_relin_limb_sharded(x, x, brk3, bctx3, g,
                                                                  plan=plan3), ac)

    outs, per_step = count_step(behz_mul, ab3c)
    got3 = torch.cat(outs, -2)
    del outs
    set_phase("reference")
    equal = {"mul_relin": bool(torch.equal(got3, T.build_bfv_mul_relin(bctx3, device=device)(
        ab3, ab3, brk3)))}
    set_phase("decrypt_decode")
    exact = decodes3(got3[0], first3) and decodes3(got3[-1], first3)
    end("bfv_mul_relin_behz4_n8192", t0, per_step, **group_of, out_shape=list(got3.shape),
        collectives=team_stats[recorder.path][0], equal_to_single_card=equal,
        decode_exact=exact)
    if not (all(equal.values()) and exact):
        raise AssertionError(f"bfv_mul_relin_behz4_n8192: {equal}, decodes exactly: {exact}")
    del got3

    # 3v. matvec_limb4_n4096: the limb-sharded hoisted matvec (the
    # bootstrap's C2S/S2C group form) of an 8x8 matrix (seed 1) at the
    # limb4 ring, batch 16 (the rehearsal: 2)
    t0 = begin("matvec_limb4_n4096")
    set_phase("keygen")
    slots_l = n_l // 2
    M_l = np.random.default_rng(1).uniform(-0.5, 0.5, size=(8, 8))
    diag_l = {d: [M_l[i % 8, (i + d) % 8] for i in range(slots_l)] for d in range(8)}
    mv_keys_l = gks_l.stacked(*tool_l.get_elts_from_steps(list(range(1, 8))))
    keygen_done("matvec_limb4_n4096", t0)
    set_phase("encode_encrypt")
    ct_m = enc_l.encrypt(cod_l.encode([0.5] * slots_l, scale_l))
    a_m = ct_m.data.expand((rot_batch,) + tuple(ct_m.data.shape)).contiguous()
    mv_sharded = pboot.build_ckks_matvec_limb_sharded(ctx_l, diag_l, scale_l, cod_l, C4,
                                                      device=device)
    set_phase("step")
    a_mc = rows_of(a_m)

    def limb_matvec(ac):
        return spmd(lambda g, x: mv_sharded(g, x, mv_keys_l), ac)

    outs, per_step = count_step(limb_matvec, a_mc)
    got_m = torch.cat(outs, -2)
    del outs
    set_phase("reference")
    mv_single = T.build_ckks_matvec(ctx_l, diag_l, scale_l, cod_l, device=device)
    equal = {"matvec": bool(torch.equal(got_m, mv_single(a_m, mv_keys_l)))}
    set_phase("decrypt_decode")
    want_m = np.asarray([0.5 * M_l[i % 8].sum() for i in range(slots_l)])
    err = max(max_err(cod_l.decode(dec_l.decrypt(T.Ciphertext(
        got_m[b].contiguous(), ct_m.parms_id, True, scale_l * scale_l))), want_m)
        for b in (0, rot_batch - 1))
    end("matvec_limb4_n4096", t0, per_step, **group_of, out_shape=list(got_m.shape),
        collectives=team_stats[recorder.path][0], equal_to_single_card=equal,
        max_abs_decode_err=err)
    if not (all(equal.values()) and err < 1e-2):
        raise AssertionError(f"matvec_limb4_n4096: {equal}, decodes {err} from M x")
    del got_m

    # 3w-x. ntt_mxu_n16384, ntt_mxu_n8192: tools/bench_ntt_mxu.py's two shapes
    # of the four-step int8 NTT (batch 128 x 2 polys, inputs from
    # default_rng(0) as the tool makes them), held to K1 bit for bit; the
    # rehearsal runs both at N=1024 on two primes
    from gemini_seal_tpu_torch.ops import ntt_mxu as mxu_ops

    mxu_batch = 2 if rehearsal else 128
    mxu_runs = {}

    def mxu_path(path, n_m, bits):
        t0 = begin(path)
        set_phase("tables")
        mods = [m.value for m in T.CoeffModulus.create(n_m, bits)]
        log_m = n_m.bit_length() - 1
        t1 = time.perf_counter()
        tabs = mxu_ops.build_mxu_ntt_tables(log_m, mods, device=device)
        sync()
        build_s = time.perf_counter() - t1
        k1tabs = ntt_ops.build_ntt_tables(log_m, mods).to(device)
        rng = np.random.default_rng(0)
        xm = to_tensor(np.stack([rng.integers(0, p, (mxu_batch, 2, n_m), dtype=np.uint64)
                                 for p in mods], axis=2), device)
        set_phase("step")
        (fwd, inv), per_step = count_step(lambda v: (mxu_ops.ntt_forward_mxu(v, tabs),
                                                     mxu_ops.ntt_inverse_mxu(v, tabs)), xm)
        set_phase("reference")
        equal = {"forward": bool(torch.equal(fwd, ntt_ops.ntt_forward(xm, k1tabs))),
                 "inverse": bool(torch.equal(inv, ntt_ops.ntt_inverse(xm, k1tabs))),
                 "round_trip": bool(torch.equal(mxu_ops.ntt_inverse_mxu(fwd, tabs), xm))}
        del fwd, inv
        end(path, t0, per_step, input_shape=list(xm.shape), moduli_bits=bits,
            n1=tabs.n1, n2=tabs.n2, ndig_w=tabs.ndig_w, ndig_x=tabs.ndig_x,
            table_build_seconds=build_s, equal_to_k1=equal)
        if not all(equal.values()):
            raise AssertionError(f"{path} differs from K1's transforms: {equal}")
        mxu_runs[path] = (xm, tabs, k1tabs, build_s)

    mxu_path("ntt_mxu_n16384", 1024 if rehearsal else 16384,
             [50, 40] if rehearsal else [50, 40, 40, 40, 40, 50])
    mxu_path("ntt_mxu_n8192", 1024 if rehearsal else 8192,
             [50, 40] if rehearsal else [50, 40, 40, 50])

    # 3y. the encrypted model zoo, driven from a function of its own, whose
    # names live in its frame and not in main()'s.  main()'s frame and the
    # module's keep the sizes they had before the zoo joined (606 names and
    # a stack of 32; a stack of 10), so the frames of every path timed below
    # sit where they did: CPython keeps frames in 16 KB chunks, and a larger
    # frame beneath the refresh moved its hot calls across a chunk boundary
    # and cost it 1.7-2x its host time (PERF.md section 6)
    def zoo_paths():
        # 3y. the encrypted model zoo: models/pipelines.py's dense layer, CNN, BFV
        # matvec, logistic-regression head and training step and the Goldschmidt
        # reciprocal, each at its source's ring, batch 16 (the rehearsal: 2)
        zb = 2 if rehearsal else 16

        # dense_layer8x8_n8192: examples/ex9's fused layer (M, b, x from
        # default_rng(42), dim 8) at dense8x8's ring, square activation, with the
        # hoisted matvec and with the BSGS matvec
        t0 = begin("dense_layer8x8_n8192")
        set_phase("build")
        rng_dl = np.random.default_rng(42)
        M_dl = rng_dl.uniform(-0.5, 0.5, size=(8, 8))
        b_dl = rng_dl.uniform(-0.2, 0.2, size=8)
        x_dl = rng_dl.uniform(-1, 1, size=8)
        diag_dl = {d: [M_dl[i % 8, (i + d) % 8] for i in range(slots8)] for d in range(8)}
        bias_dl = [b_dl[i % 8] for i in range(slots8)]
        layer_dl, pid_dl, scale_dl = T.build_ckks_dense_layer(ctx8, diag_dl, bias_dl, 2.0 ** 40,
                                                              encoder8, device=device)
        layer_dlb, pid_dlb, scale_dlb = T.build_ckks_dense_layer(ctx8, diag_dl, bias_dl, 2.0 ** 40,
                                                                 encoder8, bsgs=True, device=device)
        t1 = time.perf_counter()
        set_phase("keygen")
        rk_dl = kg8.relin_keys().stacked(2)
        elts_dlb = tool8.get_elts_from_steps(layer_dlb.rot_steps)
        gk_dlb = kg8.galois_keys(elts_dlb).stacked(*elts_dlb)
        keygen_done("dense_layer8x8_n8192", t1)
        set_phase("encode_encrypt")
        ct_dl = enc8.encrypt(encoder8.encode([x_dl[i % 8] for i in range(slots8)], 2.0 ** 40))
        a_dl = ct_dl.data.expand((zb,) + tuple(ct_dl.data.shape)).contiguous()
        set_phase("step")
        out_dl, per_step_dl = count_step(layer_dl, a_dl, gk8, rk_dl)         # steps 1..7
        out_dlb, per_step_dlb = count_step(layer_dlb, a_dl, gk_dlb, rk_dl)
        set_phase("decrypt_decode")
        want_dl = np.asarray([(M_dl @ x_dl + b_dl)[i % 8] ** 2 for i in range(slots8)])

        def dense_dl_err(o, b):
            return max_err(encoder8.decode(dec8.decrypt(T.Ciphertext(o[b].contiguous(), pid_dl,
                                                                     True, scale_dl))), want_dl)

        err_dl = max(dense_dl_err(o, b) for o in (out_dl, out_dlb) for b in (0, zb - 1))
        end("dense_layer8x8_n8192", t0, [per_step_dl, per_step_dlb], out_shape=list(out_dl.shape),
            rot_steps={"hoisted": layer_dl.rot_steps, "bsgs": layer_dlb.rot_steps},
            max_abs_decode_err=err_dl)
        if not (err_dl < 1e-3 and (pid_dl, scale_dl) == (pid_dlb, scale_dlb)):
            raise AssertionError(f"dense_layer8x8_n8192 decodes {err_dl} from (M x + b)^2")

        # cnn16x16_n4096: bench_all.py's cnn cell (bench_all.py:341-398), keygen in
        # its order; row 0 must have the JAX package's digests (CNN16X16_N4096)
        n_cn = 1024 if rehearsal else 4096
        t0 = begin("cnn16x16_n4096")
        set_phase("keygen")
        ctx_cn, kg_cn, cod_cn, enc_cn, dec_cn = ckks_context(n_cn, [50] + [40] * 6 + [50])
        rk_cn = kg_cn.relin_keys().stacked(2)
        t1 = time.perf_counter()
        set_phase("build")
        rng_cn = np.random.default_rng(2)
        slots_cn, hw_cn = cod_cn.slot_count, 256
        kern_cn = rng_cn.uniform(-0.4, 0.4, size=(3, 3))
        M_cn = np.zeros((hw_cn, hw_cn))
        for d in range(16):
            for i in range(hw_cn):
                M_cn[i, (i + d) % hw_cn] = rng_cn.uniform(-0.15, 0.15)
        R_cn = np.zeros((hw_cn, hw_cn))
        for d in range(10):
            for i in range(hw_cn):
                R_cn[i, (i + d) % hw_cn] = rng_cn.uniform(-0.3, 0.3)
        dense_cn = [({d: [M_cn[i % hw_cn, (i + d) % hw_cn] for i in range(slots_cn)]
                      for d in range(16)}, [0.0] * slots_cn, "square"),
                    ({d: [R_cn[i % hw_cn, (i + d) % hw_cn] for i in range(slots_cn)]
                      for d in range(10)}, [0.0] * slots_cn, None)]
        cnn, pid_cn, scale_cn = T.build_ckks_cnn(ctx_cn, [(kern_cn, None, "square")], dense_cn, 16,
                                                 16, 2.0 ** 40, cod_cn, bsgs=True, device=device)
        build_cn = time.perf_counter() - t1
        set_phase("keygen")
        tool_cn = ctx_cn.first_context_data().galois_tool
        gk_cn = []
        for layer_steps in cnn.rot_steps:
            elts = tool_cn.get_elts_from_steps(layer_steps)
            gk_cn.append(kg_cn.galois_keys(elts).stacked(*elts))
        keygen_s["cnn16x16_n4096"] = time.perf_counter() - t0 - build_cn
        emit({"phase": "keygen", "path": "cnn16x16_n4096", "seconds": keygen_s["cnn16x16_n4096"],
              "build_seconds": build_cn})
        set_phase("encode_encrypt")
        img_cn = [rng_cn.uniform(0, 1) for _ in range(hw_cn)]
        ct_cn = enc_cn.encrypt(cod_cn.encode([img_cn[i % hw_cn] for i in range(slots_cn)],
                                             2.0 ** 40))
        a_cn = ct_cn.data.expand((zb,) + tuple(ct_cn.data.shape)).contiguous()
        set_phase("step")
        out_cn, per_step_cn = count_step(cnn, a_cn, gk_cn, rk_cn)
        set_phase("decrypt_decode")
        want_cn = R_cn @ ((M_cn @ (conv_same(np.reshape(img_cn, (16, 16)), kern_cn).reshape(-1)
                                   ** 2)) ** 2)

        def cnn_err(o):
            got = np.asarray(cod_cn.decode(dec_cn.decrypt(T.Ciphertext(o.contiguous(), pid_cn, True,
                                                                      scale_cn))))
            return float(np.abs(got[:hw_cn] - want_cn).max())

        err_cn = cnn_err(out_cn[0])
        rows_equal_cn = bool(torch.equal(out_cn[0], out_cn[-1]))
        digests_cn = {"input_sha256": hashlib.sha256(to_numpy(ct_cn.data).tobytes()).hexdigest(),
                      "output_sha256": hashlib.sha256(to_numpy(out_cn[0]).tobytes()).hexdigest()}
        steps_cn = [len(s) for s in cnn.rot_steps]
        end("cnn16x16_n4096", t0, per_step_cn, out_shape=list(out_cn.shape), n=n_cn,
            rot_steps=cnn.rot_steps, max_abs_decode_err=err_cn, rows_equal=rows_equal_cn,
            **digests_cn)
        if not (err_cn < 1e-2 and rows_equal_cn):
            raise AssertionError(f"cnn16x16_n4096 decodes {err_cn} from the numpy forward pass")
        want_cn_d = CNN16X16_N4096
        if not rehearsal and (digests_cn["input_sha256"] != want_cn_d["input_sha256"]
                              or digests_cn["output_sha256"] != want_cn_d["output_sha256"]
                              or err_cn != want_cn_d["max_err"]
                              or steps_cn != want_cn_d["rot_steps_lengths"]):
            raise AssertionError(f"cnn16x16_n4096 differs from the JAX package's: {digests_cn}, "
                                 f"max_err {err_cn}, rotation steps {steps_cn}")

        # bfv_matvec8x8_n8192: the hoisted BFV matvec of a seeded 8x8 integer
        # matrix at config 2's ring (bfv_default(8192), tc128), batch 16; every
        # slot of both rows decodes to (M x)[i % 8] mod t exactly
        t0 = begin("bfv_matvec8x8_n8192")
        set_phase("keygen")
        rng_bm = np.random.default_rng(2029)
        M_bm = rng_bm.integers(0, 1024, size=(8, 8))
        x_bm = rng_bm.integers(0, 1024, size=8)
        elts_bm = tool2.get_elts_from_steps(list(range(1, 8)))
        gk_bm = kg2.galois_keys(elts_bm).stacked(*elts_bm)
        keygen_done("bfv_matvec8x8_n8192", t0)
        set_phase("encode_encrypt")
        ct_bm = enc2.encrypt(be2.encode([int(x_bm[i % 8]) for i in range(n2)]))
        a_bm = ct_bm.data.expand((zb,) + tuple(ct_bm.data.shape)).contiguous()
        set_phase("step")
        bmv = T.build_bfv_matvec(ctx2, {d: [int(M_bm[i % 8, (i + d) % 8]) for i in range(n2)]
                                        for d in range(8)}, be2, device=device)
        out_bm, per_step_bm = count_step(bmv, a_bm, gk_bm)
        set_phase("decrypt_decode")
        want_bm = [int((M_bm @ x_bm)[i % 8]) % t2 for i in range(n2)]
        exact_bm = decodes2(out_bm[0]) == want_bm and decodes2(out_bm[-1]) == want_bm
        end("bfv_matvec8x8_n8192", t0, per_step_bm, out_shape=list(out_bm.shape),
            decode_exact=exact_bm)
        if not exact_bm:
            raise AssertionError("bfv_matvec8x8_n8192 does not decode to M x mod t")

        # logreg_train_m64_f16_n8192: bench_all.py's train cell
        # (bench_all.py:401-442): one encrypted gradient-descent iteration, m=64
        # samples of F=16 features (the rehearsal: 16 of 8 at N=1024)
        n_lt = 1024 if rehearsal else 8192
        m_lt, F_lt = (16, 8) if rehearsal else (64, 16)
        t0 = begin("logreg_train_m64_f16_n8192")
        set_phase("keygen")
        ctx_lt, kg_lt, cod_lt, enc_lt, dec_lt = ckks_context(n_lt, [50] + [40] * 7 + [50])
        rk_lt = kg_lt.relin_keys().stacked(2)
        t1 = time.perf_counter()
        set_phase("build")
        rng_lt = np.random.default_rng(4)
        y_lt = rng_lt.integers(0, 2, size=m_lt).astype(float)
        train_lt, pid_lt, scale_lt, steps_lt = T.build_ckks_logreg_train_step(
            ctx_lt, m_lt, F_lt, y_lt.tolist(), 0.1, 2.0 ** 40, cod_lt, device=device)
        t2_lt = time.perf_counter()
        set_phase("keygen")
        elts_lt = ctx_lt.first_context_data().galois_tool.get_elts_from_steps(steps_lt)
        gk_lt = kg_lt.galois_keys(elts_lt).stacked(*elts_lt)
        keygen_s["logreg_train_m64_f16_n8192"] = time.perf_counter() - t2_lt + t1 - t0
        emit({"phase": "keygen", "path": "logreg_train_m64_f16_n8192",
              "seconds": keygen_s["logreg_train_m64_f16_n8192"], "build_seconds": t2_lt - t1})
        set_phase("encode_encrypt")
        slots_lt = cod_lt.slot_count
        Bf_lt = 1 << int(np.ceil(np.log2(F_lt)))
        xs_lt = np.zeros(slots_lt)
        for i in range(m_lt):
            xs_lt[i * Bf_lt:i * Bf_lt + F_lt] = rng_lt.uniform(-1, 1, size=F_lt)
        ws_lt = np.zeros(slots_lt)
        for i in range(slots_lt // Bf_lt):
            ws_lt[i * Bf_lt:i * Bf_lt + F_lt] = rng_lt.uniform(-0.5, 0.5, size=F_lt)
        ct_lx = enc_lt.encrypt(cod_lt.encode(xs_lt.tolist(), 2.0 ** 40))
        ct_lw = enc_lt.encrypt(cod_lt.encode(ws_lt.tolist(), 2.0 ** 40))
        a_lx = ct_lx.data.expand((zb,) + tuple(ct_lx.data.shape)).contiguous()
        a_lw = ct_lw.data.expand((zb,) + tuple(ct_lw.data.shape)).contiguous()
        set_phase("step")
        out_lt, per_step_lt = count_step(train_lt, a_lx, a_lw, gk_lt, rk_lt)
        set_phase("decrypt_decode")
        # the cleartext iteration: sample i meets block i of w (bench_all.py's w
        # differs from block to block), the gradient is summed over the m samples
        X_lt = xs_lt.reshape(-1, Bf_lt)[:m_lt, :F_lt]
        W_lt = ws_lt.reshape(-1, Bf_lt)[:m_lt, :F_lt]
        z_lt = (X_lt * W_lt).sum(axis=1)
        g_lt = X_lt.T @ (0.5 + 0.197 * z_lt - 0.004 * z_lt ** 3 - y_lt)
        want_lt = W_lt - 0.1 * g_lt

        def train_err(o):
            got = np.asarray(cod_lt.decode(dec_lt.decrypt(T.Ciphertext(o.contiguous(), pid_lt, True,
                                                                      scale_lt))))
            return float(np.abs(got.reshape(-1, Bf_lt)[:m_lt, :F_lt] - want_lt).max())

        err_lt = max(train_err(out_lt[0]), train_err(out_lt[-1]))
        end("logreg_train_m64_f16_n8192", t0, per_step_lt, out_shape=list(out_lt.shape),
            rot_steps=steps_lt, max_abs_decode_err=err_lt, out_scale_is_input_scale=(
                scale_lt == 2.0 ** 40))
        if not (err_lt < 1e-2 and scale_lt == 2.0 ** 40):
            raise AssertionError(f"logreg_train_m64_f16_n8192 decodes {err_lt} from the cleartext "
                                 "iteration")

        # logreg_f16_n8192: bench_all.py's logreg cell (bench_all.py:689-723), the
        # encrypted sigmoid head of F=16 weights; slot 0 decodes to sigma3(w.x + b)
        n_lh = 1024 if rehearsal else 8192
        t0 = begin("logreg_f16_n8192")
        set_phase("keygen")
        ctx_lh, kg_lh, cod_lh, enc_lh, dec_lh = ckks_context(n_lh, [50, 40, 40, 40, 40, 50])
        rk_lh = kg_lh.relin_keys().stacked(2)
        set_phase("build")
        rng_lh = np.random.default_rng(3)
        w_lh = rng_lh.uniform(-0.4, 0.4, size=16)
        head_lh, pid_lh, scale_lh, steps_lh = T.build_ckks_logreg(ctx_lh, w_lh.tolist(), 0.25,
                                                                  2.0 ** 40, cod_lh, device=device)
        set_phase("keygen")
        elts_lh = ctx_lh.first_context_data().galois_tool.get_elts_from_steps(steps_lh)
        gk_lh = kg_lh.galois_keys(elts_lh).stacked(*elts_lh)
        keygen_done("logreg_f16_n8192", t0)
        set_phase("encode_encrypt")
        xs_lh = [0.0] * cod_lh.slot_count
        xs_lh[:16] = rng_lh.uniform(-1, 1, size=16).tolist()
        ct_lh = enc_lh.encrypt(cod_lh.encode(xs_lh, 2.0 ** 40))
        a_lh = ct_lh.data.expand((zb,) + tuple(ct_lh.data.shape)).contiguous()
        set_phase("step")
        out_lh, per_step_lh = count_step(head_lh, a_lh, gk_lh, rk_lh)
        set_phase("decrypt_decode")
        z_lh = float(w_lh @ np.asarray(xs_lh[:16]) + 0.25)
        want_lh = 0.5 + 0.197 * z_lh - 0.004 * z_lh ** 3
        err_lh = max(abs(cod_lh.decode(dec_lh.decrypt(T.Ciphertext(out_lh[b].contiguous(), pid_lh,
                                                                   True, scale_lh)))[0] - want_lh)
                     for b in (0, zb - 1))
        end("logreg_f16_n8192", t0, per_step_lh, out_shape=list(out_lh.shape), rot_steps=steps_lh,
            max_abs_decode_err=err_lh)
        if not err_lh < 1e-2:
            raise AssertionError(f"logreg_f16_n8192 decodes {err_lh} from sigma3(w.x + b)")

        # inverse_ex14_n256: examples/ex14's softmax at its ring (N=256, [50, 40 x
        # 11, 50], parms seed range(8)): exp by build_ckks_poly_eval, the slot sum
        # by the Evaluator's rotation tree, the range reduction, then the step,
        # build_ckks_inverse's four Goldschmidt iterations, and the product;
        # within ex14's 2e-2 of softmax(x)
        t0 = begin("inverse_ex14_n256")
        set_phase("keygen")
        ctx_iv = per_op_context(T.SchemeType.CKKS, 256, T.CoeffModulus.create(256, [50] + [40] * 11
                                                                              + [50]),
                                sec=T.SecLevelType.none)
        kg_iv = T.KeyGenerator(ctx_iv, device=device)
        enc_iv = T.Encryptor(ctx_iv, kg_iv.public_key(), device=device)
        dec_iv = T.Decryptor(ctx_iv, kg_iv.secret_key, device=device)
        cod_iv = T.CKKSEncoder(ctx_iv, device=device)
        ev_iv = T.Evaluator(ctx_iv, device=device)
        tool_iv = ctx_iv.first_context_data().galois_tool
        rk_iv = kg_iv.relin_keys()
        rks_iv = rk_iv.stacked(2)
        gk_iv = kg_iv.galois_keys([tool_iv.get_elt_from_step(1 << i) for i in range(3)])
        keygen_done("inverse_ex14_n256", t0)
        set_phase("encode_encrypt")
        x_iv = np.random.default_rng(41).uniform(-1, 1, 8)
        ct_iv = enc_iv.encrypt(cod_iv.encode([float(x_iv[i % 8]) for i in range(cod_iv.slot_count)],
                                             2.0 ** 40))
        set_phase("exp_sum_reduce")
        exp_iv, exp_pid_iv, exp_scale_iv = T.build_ckks_poly_eval(
            ctx_iv, [1.0, 1.0, 0.5, 1.0 / 6.0, 1.0 / 24.0], 2.0 ** 40, cod_iv, device=device)
        ct_e_iv = T.Ciphertext(exp_iv(ct_iv.data, rks_iv, None), exp_pid_iv, True, exp_scale_iv)
        ct_s_iv = ct_e_iv
        for i in range(3):
            ct_s_iv = ev_iv.add(ct_s_iv, ev_iv.rotate_vector(ct_s_iv, 1 << i, gk_iv))
        ct_r_iv = ev_iv.rescale_to_next(ev_iv.multiply_plain(
            ct_s_iv, cod_iv.encode(1.0 / 16.0, 2.0 ** 10, ct_s_iv.parms_id)))
        set_phase("build")
        inv_iv, inv_pid_iv, inv_scale_iv = T.build_ckks_inverse(
            ctx_iv, ct_r_iv.scale, cod_iv, iters=4, parms_id=ct_r_iv.parms_id, device=device)
        set_phase("step")
        d_iv, per_step_iv = count_step(inv_iv, ct_r_iv.data, rks_iv)
        set_phase("softmax_product")
        out_iv = ev_iv.rescale_to_next(ev_iv.relinearize(ev_iv.multiply(
            ev_iv.mod_switch_to(ct_e_iv, inv_pid_iv), T.Ciphertext(d_iv, inv_pid_iv, True,
                                                                   inv_scale_iv)), rk_iv))
        out_iv.scale *= 16.0
        set_phase("decrypt_decode")
        got_iv = np.asarray(cod_iv.decode(dec_iv.decrypt(out_iv)))[:8]
        err_iv = float(np.abs(got_iv - np.exp(x_iv) / np.exp(x_iv).sum()).max())
        end("inverse_ex14_n256", t0, per_step_iv, out_shape=list(d_iv.shape),
            levels_consumed=len(ct_r_iv.data[0]) - len(d_iv[0]), max_abs_decode_err=err_iv)
        if not err_iv < 2e-2:
            raise AssertionError(f"inverse_ex14_n256's softmax decodes {err_iv} from softmax(x)")

        def serving_path():
            # serving_dense8x8_n8192: tools/bench_serving.py's shape on the dense
            # layer's ring and step (layer_dl, gk8, rk_dl): the wire-to-wire
            # EncryptedComputeServer at batch zb, COMPR_NONE.  Sixteen requests
            # x_i from default_rng(43) (the rehearsal: two), served 24 times as
            # full blobs (ser.save(enc8.encrypt(pt)), 3 primes) and 8 times as
            # seeded ones (encrypt_symmetric_serializable); then ex6's flow
            from gemini_seal_tpu_torch import serialization as ser
            from gemini_seal_tpu_torch.models.serving import EncryptedComputeServer
            from gemini_seal_tpu_torch.utils import native as host_lib

            n_full, n_seeded = (2, 1) if rehearsal else (24, 8)
            wait = torch.cuda.synchronize if not rehearsal else (lambda: None)
            t0 = begin("serving_dense8x8_n8192")
            set_phase("encode_encrypt")
            xs = np.random.default_rng(43).uniform(-1, 1, size=(zb, 8))
            pts = encoder8.encode_batch([[x[i % 8] for i in range(slots8)] for x in xs], 2.0 ** 40)
            cts = [enc8.encrypt(pt) for pt in pts]
            full = [ser.save(ct) for ct in cts]
            enc_s = T.Encryptor(ctx8, secret_key=kg8.secret_key, device=device)
            scts = [enc_s.encrypt_symmetric_serializable(pt) for pt in pts]
            seeded = [s.save() for s in scts]
            set_phase("step")
            server = EncryptedComputeServer(ctx8, layer_dl, [gk8, rk_dl], pid_dl, True, scale_dl,
                                            zb, device=device)
            served, per_step = count_step(server.submit, full)
            set_phase("reference")
            # the step's own output on the same stacked input, saved
            def saved(batch):
                out = layer_dl(torch.stack(batch), gk8, rk_dl)
                return [ser.save(T.Ciphertext(out[i], pid_dl, True, scale_dl)) for i in range(zb)]

            want = saved([ct.data for ct in cts])
            want_s = saved([s.ct.data for s in scts])
            checks = {"submit_equals_step": served == want,
                      "seeded_expands_to_drawn_c1": all(
                          torch.equal(ser.load_ciphertext(b, ctx8).data[1], s.ct.data[1])
                          for b, s in zip(seeded, scts)),
                      "seeded_submit_equals_step": server.submit(seeded) == want_s}
            set_phase("decrypt_decode")
            outs = torch.stack([ser.load_ciphertext(b, ctx8).data for b in served])
            plains = dec8.decrypt_batch(outs, pid_dl, True, scale_dl)
            checks["decrypt_batch_equals_decrypt"] = all(
                torch.equal(p.data, dec8.decrypt(T.Ciphertext(outs[i], pid_dl, True,
                                                              scale_dl)).data)
                for i, p in enumerate(plains))
            err = max(max_err(row[:8], (M_dl @ x + b_dl) ** 2)
                      for row, x in zip(encoder8.decode_batch(plains), xs))
            # ex6's flow (examples/ex6_serialization.py: N=4096, [40, 30, 30],
            # tc128, scale 2^30) at parms seed range(8): the parameters and the
            # ciphertext in deflate, the relin keys and the server's square,
            # relinearize and rescale on the wire objects (the Evaluator)
            set_phase("ex6")
            parms6 = T.EncryptionParameters(T.SchemeType.CKKS)
            parms6.set_poly_modulus_degree(4096)
            parms6.set_coeff_modulus(T.CoeffModulus.create(4096, [40, 30, 30]))
            parms6.set_random_seed(tuple(range(8)))
            parms_blob = ser.save(parms6, ser.COMPR_DEFLATE)
            client_parms = ser.load_parms(parms_blob)
            client_parms.set_random_seed(tuple(range(8)))
            ctx6 = T.SealContext(client_parms, device=device)
            kg6 = T.KeyGenerator(ctx6, device=device)
            cod6 = T.CKKSEncoder(ctx6, device=device)
            ct_blob = ser.save(T.Encryptor(ctx6, kg6.public_key(), device=device).encrypt(
                cod6.encode([3.14, 2.718], 2.0 ** 30)), ser.COMPR_DEFLATE)
            rk_blob = ser.save(kg6.relin_keys())
            sctx6 = T.SealContext(ser.load_parms(parms_blob), device=device)
            ev6 = T.Evaluator(sctx6, device=device)
            result_blob = ser.save(ev6.rescale_to_next(ev6.relinearize(
                ev6.square(ser.load_ciphertext(ct_blob, sctx6)),
                ser.load_relin_keys(rk_blob, sctx6))))
            got6 = cod6.decode(T.Decryptor(ctx6, kg6.secret_key, device=device).decrypt(
                ser.load_ciphertext(result_blob, ctx6)))
            ex6 = {k: hashlib.sha256(b).hexdigest() for k, b in (
                ("parms_deflate_sha256", parms_blob), ("ciphertext_deflate_sha256", ct_blob),
                ("relin_keys_sha256", rk_blob), ("result_sha256", result_blob))}
            checks["ex6_digests"] = ex6 == EX6 and got6[:2] == EX6_SQUARES
            end("serving_dense8x8_n8192", t0, per_step, batch=zb, max_abs_decode_err=err,
                checks=checks, ex6=ex6, blob_bytes={"full": len(full[0]),
                                                     "seeded": len(seeded[0])})
            if not (all(checks.values()) and err < 1e-3):
                raise AssertionError(f"serving_dense8x8_n8192: {checks}, decodes {err} "
                                     "from (M x + b)^2")

            # the rates, with the kernels unwrapped: submit over n_full batches,
            # submit_stream over the same, seeded submit_stream over n_seeded,
            # the step alone, and the host ms of each stage of a batch
            Recorder.current.pause()
            server.warm(full[0])
            wait()
            t1 = time.perf_counter()
            got = [server.submit(full) for _ in range(n_full)]
            dt_submit = time.perf_counter() - t1
            t1 = time.perf_counter()
            got_stream = list(server.submit_stream([full] * n_full))
            dt_stream = time.perf_counter() - t1
            t1 = time.perf_counter()
            got_seeded = list(server.submit_stream([seeded] * n_seeded))
            dt_seeded = time.perf_counter() - t1
            a_sv = torch.stack([ct.data for ct in cts])
            layer_dl(a_sv, gk8, rk_dl)
            wait()
            t1 = time.perf_counter()
            for _ in range(n_full):
                layer_dl(a_sv, gk8, rk_dl)
            wait()
            dt_step = time.perf_counter() - t1
            stages = dict.fromkeys(("load_validate_seeded", "load_validate", "stack_upload",
                                    "step", "download", "save"), 0.0)
            for _ in range(n_seeded):
                t1 = time.perf_counter()
                server.load(seeded)
                t2 = time.perf_counter()
                stages["load_validate_seeded"] += (t2 - t1) * 1e3 / n_seeded
                t1 = time.perf_counter()
                rows = server.load(full)
                t2 = time.perf_counter()
                batch = server.upload(server.stage(rows))
                wait()
                t3 = time.perf_counter()
                out = server.run(batch)
                wait()
                t4 = time.perf_counter()
                host = server.download(out)
                t5 = time.perf_counter()
                server.save(zb, host)
                for k, dt in zip(list(stages)[1:], (t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                                                    time.perf_counter() - t5)):
                    stages[k] += dt * 1e3 / n_seeded
            Recorder.current.resume()
            equal = {"submit_equals_step": all(g == want for g in got),
                     "stream_equals_submit": got_stream == got,
                     "seeded_stream_equals_step": all(g == want_s for g in got_seeded)}
            step_rate = zb * n_full / dt_step
            wire = zb * n_full / dt_submit
            emit({"phase": "serving", "path": "serving_dense8x8_n8192",
                  "card": "cpu rehearsal" if rehearsal else nvidia_smi_line(),
                  "batch": zb, "batches": {"full": n_full, "seeded": n_seeded},
                  "serving_wire_to_wire_req_per_s": wire,
                  "serving_wire_to_wire_pipelined_req_per_s": zb * n_full / dt_stream,
                  "serving_seeded_pipelined_req_per_s": zb * n_seeded / dt_seeded,
                  "ingress_bytes_ratio_seeded_to_full": len(seeded[0]) / len(full[0]),
                  "host_ms_per_batch": stages,
                  "ckks_dense_layer8x8_n8192_layers_per_s_same_phase": step_rate,
                  "wire_to_compute_ratio": wire / step_rate,
                  "native_host_library": host_lib.available(), "equal": equal})
            if not all(equal.values()):
                raise AssertionError(f"serving_dense8x8_n8192 timed runs: {equal}")

        def compare_paths(record, within):
            """The comparison builders, the encrypted matmul and encrypted
            attention at bench_all.py's relu, matmul and attention cells, batch
            zb (the rehearsal: N=256, d=8 at N=128, d=4 at N=32 and d=8 at
            N=128), keygen in bench_all's order, parms seed range(8), scale
            2^40; max, sqrt and a four-head attention at batch 2, checked and
            not timed."""
            sc = 2.0 ** 40

            def keygen_line(path, seconds, **extra):
                keygen_s[path] = seconds
                emit({"phase": "keygen", "path": path, "seconds": seconds, **extra})

            def decode(cod, dec, o, pid, scale):
                return np.asarray(cod.decode(dec.decrypt(T.Ciphertext(o.contiguous(), pid, True,
                                                                      scale))))

            def sha(t):
                return hashlib.sha256(to_numpy(t).tobytes()).hexdigest()

            # relu_n8192: bench_all.py's relu cell (bench_all.py:659-687), the
            # composite sign's three stages and the gate multiply, 13 levels
            n_rl = 256 if rehearsal else 8192
            t0 = begin("relu_n8192")
            set_phase("keygen")
            ctx_rl, kg_rl, cod_rl, enc_rl, dec_rl = ckks_context(n_rl, [50] + [40] * 13 + [50])
            t1 = time.perf_counter()
            set_phase("build")
            relu, pid_rl, sc_rl = T.build_ckks_relu(ctx_rl, sc, cod_rl, device=device)
            mx, pid_mx, sc_mx = T.build_ckks_max(ctx_rl, sc, cod_rl, device=device)
            sq, pid_sq, sc_sq = T.build_ckks_sqrt(ctx_rl, sc, cod_rl, iters=3, device=device)
            set_phase("encode_encrypt")
            slots_rl = cod_rl.slot_count
            x_rl = np.random.default_rng(7).uniform(-1, 1, slots_rl)
            ct_rl = enc_rl.encrypt(cod_rl.encode(x_rl.tolist(), sc))
            a_rl = ct_rl.data.expand((zb,) + tuple(ct_rl.data.shape)).contiguous()
            rng_mx = np.random.default_rng(23)
            xa_mx, xb_mx = rng_mx.uniform(-0.5, 0.5, slots_rl), rng_mx.uniform(-0.5, 0.5, slots_rl)
            x_sq = np.random.default_rng(29).uniform(0.5, 1.5, slots_rl)
            ab_mx, bb_mx, ab_sq = (enc_rl.encrypt(cod_rl.encode(v.tolist(), sc)).data.expand(
                (2,) + tuple(ct_rl.data.shape)).contiguous() for v in (xa_mx, xb_mx, x_sq))
            t2 = time.perf_counter()
            set_phase("keygen")
            rk_rl = kg_rl.relin_keys().stacked(2)
            keygen_line("relu_n8192", time.perf_counter() - t2 + t1 - t0)
            set_phase("step")
            out_rl, per_step_rl = count_step(relu, a_rl, rk_rl)
            # max and sqrt at batch 2 on the same keys: each kernel call checked
            set_phase("forms")
            out_mx, launches_mx = count_step(mx, ab_mx, bb_mx, rk_rl)
            out_sq, launches_sq = count_step(sq, ab_sq, rk_rl)
            set_phase("decrypt_decode")
            want_rl = x_rl * (1 + T.sign_composite_reference(x_rl)) / 2
            gap_mx = np.abs(xa_mx - xb_mx) >= 0.1
            want_mx = np.maximum(xa_mx, xb_mx)[gap_mx]

            def relu_err(o):
                return float(np.abs(decode(cod_rl, dec_rl, o, pid_rl, sc_rl) - want_rl).max())

            def max_err2(o):
                return float(np.abs(decode(cod_rl, dec_rl, o, pid_mx, sc_mx)[gap_mx]
                                    - want_mx).max())

            def sqrt_err2(o):
                got = decode(cod_rl, dec_rl, o, pid_sq, sc_sq)
                return {"max_abs_decode_err": float(np.abs(got - np.sqrt(x_sq)).max()),
                        "max_rel_decode_err": float(np.abs(got / np.sqrt(x_sq) - 1.0).max())}

            err_rl = max(relu_err(out_rl[0]), relu_err(out_rl[-1]))
            err_mx = max_err2(out_mx[1])
            err_sq = sqrt_err2(out_sq[1])
            digests_rl = {"input_sha256": sha(ct_rl.data), "output_sha256": sha(out_rl[0])}
            end("relu_n8192", t0, per_step_rl, out_shape=list(out_rl.shape), n=n_rl,
                max_abs_decode_err=err_rl, rows_equal=bool(torch.equal(out_rl[0], out_rl[-1])),
                forms={"max": {"launches": sum(by_label(launches_mx).values()),
                               "max_abs_decode_err": err_mx},
                       "sqrt": {"launches": sum(by_label(launches_sq).values()), **err_sq}},
                **digests_rl)
            if not (err_rl < 1e-2 and err_mx < 2e-2 and err_sq["max_rel_decode_err"] < 2e-3):
                raise AssertionError(f"relu_n8192 decodes {err_rl} from x (1 + sign(x)) / 2, max "
                                     f"{err_mx}, sqrt {err_sq}")
            if not rehearsal and (digests_rl["input_sha256"] != RELU_N8192["input_sha256"]
                                  or digests_rl["output_sha256"] != RELU_N8192["output_sha256"]
                                  or relu_err(out_rl[0]) != RELU_N8192["max_err"]):
                raise AssertionError(f"relu_n8192 differs from the JAX package's: {digests_rl}, "
                                     f"max_err {relu_err(out_rl[0])}")
            out = [
                record("relu_n8192", "ckks_relu_n8192_ops_per_s", relu, (a_rl, rk_rl),
                       per_step_rl, lambda d: within(relu_err(d[1]), 1e-2), steps=10),
                record("max_n8192", None, mx, None, launches_mx,
                       lambda d: within(max_err2(d[1]), 2e-2), (ab_mx, bb_mx, rk_rl), False),
                record("sqrt_n8192", None, sq, None, launches_sq,
                       lambda d: ((e := sqrt_err2(d[1]))["max_rel_decode_err"] < 2e-3, e),
                       (ab_sq, rk_rl), False)]
            del out_rl, out_mx, out_sq

            # matmul_d32_n2048: bench_all.py's matmul cell (bench_all.py:510-546),
            # the JKLS product of two 32 x 32 matrices, 3 levels, 93 rotation keys
            d_mm = 8 if rehearsal else 32
            n_mm = 2 * d_mm * d_mm
            t0 = begin("matmul_d32_n2048")
            set_phase("keygen")
            ctx_mm, kg_mm, cod_mm, enc_mm, dec_mm = ckks_context(n_mm, [50, 40, 40, 40, 40, 50])
            t1 = time.perf_counter()
            set_phase("build")
            mm, pid_mm, sc_mm = T.build_ckks_matmul_square(ctx_mm, d_mm, sc, cod_mm, device=device)
            t2 = time.perf_counter()
            set_phase("keygen")
            elts_mm = ctx_mm.first_context_data().galois_tool.get_elts_from_steps(mm.rot_steps)
            gk_mm = kg_mm.galois_keys(elts_mm).stacked(*elts_mm)
            t3 = time.perf_counter()
            set_phase("encode_encrypt")
            rng_mm = np.random.default_rng(5)
            A_mm = rng_mm.uniform(-1, 1, d_mm * d_mm)
            B_mm = rng_mm.uniform(-1, 1, d_mm * d_mm)
            a_mm, b_mm = (enc_mm.encrypt(cod_mm.encode(v.tolist(), sc)).data for v in (A_mm, B_mm))
            a_mm = a_mm.expand((zb,) + tuple(a_mm.shape)).contiguous()
            b_mm = b_mm.expand((zb,) + tuple(b_mm.shape)).contiguous()
            t4 = time.perf_counter()
            set_phase("keygen")
            rk_mm = kg_mm.relin_keys().stacked(2)
            keygen_line("matmul_d32_n2048", time.perf_counter() - t4 + t3 - t2 + t1 - t0,
                      galois_keys=len(elts_mm), rotation_stack_bytes=gk_mm.numel() * 8,
                      build_seconds=t2 - t1)
            set_phase("step")
            out_mm, per_step_mm = count_step(mm, a_mm, b_mm, gk_mm, rk_mm)
            set_phase("decrypt_decode")
            want_mm = (A_mm.reshape(d_mm, d_mm) @ B_mm.reshape(d_mm, d_mm)).reshape(-1)

            def mm_err(o):
                return float(np.abs(decode(cod_mm, dec_mm, o, pid_mm, sc_mm)[:d_mm * d_mm]
                                    - want_mm).max())

            err_mm = max(mm_err(out_mm[0]), mm_err(out_mm[-1]))
            end("matmul_d32_n2048", t0, per_step_mm, out_shape=list(out_mm.shape), d=d_mm,
                n=n_mm, rot_steps=len(mm.rot_steps), max_abs_decode_err=err_mm)
            if not err_mm < 1e-2:
                raise AssertionError(f"matmul_d32_n2048 decodes {err_mm} from A @ B")
            out.append(record("matmul_d32_n2048", f"ckks_matmul_d{d_mm}_n{n_mm}_matmuls_per_s", mm,
                              (a_mm, b_mm, gk_mm, rk_mm), per_step_mm,
                              lambda d: within(mm_err(d[1]), 1e-2),
                              (a_mm[:2].contiguous(), b_mm[:2].contiguous(), gk_mm, rk_mm),
                              steps=10))
            del out_mm

            # attention_d32_n2048, attention_d16_n512: bench_all.py's attention
            # cells (bench_all.py:549-613), softmax(Q K^T / sqrt(d)) V with Q,
            # K^T and V encrypted, on attention_plan(d)'s chain; the d=16 cell
            # also runs four heads of d=8 at batch 2 with their own keys
            for path, d_at, heads_of in (("attention_d32_n2048", 4 if rehearsal else 32, None),
                                         ("attention_d16_n512", 8 if rehearsal else 16,
                                          4 if rehearsal else 8)):
                n_at = 2 * d_at * d_at
                levels_at, iters_at, _ = T.attention_plan(d_at)
                t0 = begin(path)
                set_phase("keygen")
                ctx_at, kg_at, cod_at, enc_at, dec_at = ckks_context(
                    n_at, [50] + [40] * levels_at + [50])
                t1 = time.perf_counter()
                set_phase("build")
                run_at, pid_at, sc_at, steps_at = T.build_ckks_attention(ctx_at, d_at, sc, cod_at,
                                                                         device=device)
                t2 = time.perf_counter()
                set_phase("keygen")
                tool_at = ctx_at.first_context_data().galois_tool
                elts_at = tool_at.get_elts_from_steps(steps_at)
                gk_at = kg_at.galois_keys(elts_at).stacked(*elts_at)
                rk_at = kg_at.relin_keys().stacked(2)
                keygen_line(path, time.perf_counter() - t2 + t1 - t0, galois_keys=len(elts_at),
                          rotation_stack_bytes=gk_at.numel() * 8, build_seconds=t2 - t1)
                set_phase("encode_encrypt")
                rng_at = np.random.default_rng(23)
                Q_at, K_at, V_at = (rng_at.uniform(-0.5, 0.5, (d_at, d_at)) for _ in range(3))
                cts_at = [enc_at.encrypt(cod_at.encode(M.reshape(-1).tolist(), sc)).data
                          for M in (Q_at, K_at.T, V_at)]
                qkv = [c.expand((zb,) + tuple(c.shape)).contiguous() for c in cts_at]
                # the d=16 cell is checked and not timed (the script's time
                # budget): its kernel calls are held to their plain versions
                # only
                set_phase("step" if heads_of is None else "step_checked")
                out_at, per_step_at = count_step(run_at, *qkv, gk_at, rk_at)
                extra = {}
                if heads_of is not None:
                    # four heads of d=heads_of in the slots, own rotation keys
                    set_phase("build")
                    run_mh, pid_mh, sc_mh, steps_mh = T.build_ckks_attention(
                        ctx_at, heads_of, sc, cod_at, heads=4, device=device)
                    set_phase("keygen")
                    elts_mh = tool_at.get_elts_from_steps(steps_mh)
                    gk_mh = kg_at.galois_keys(elts_mh).stacked(*elts_mh)
                    set_phase("encode_encrypt")
                    rng_mh = np.random.default_rng(31)
                    Q_mh, K_mh, V_mh = (rng_mh.uniform(-0.5, 0.5, (4, heads_of, heads_of))
                                        for _ in range(3))
                    qkv_mh = [enc_at.encrypt(cod_at.encode(M.reshape(-1).tolist(), sc)).data
                              .expand((2,) + tuple(cts_at[0].shape)).contiguous()
                              for M in (Q_mh, np.swapaxes(K_mh, 1, 2), V_mh)]
                    set_phase("forms")
                    out_mh, launches_mh = count_step(run_mh, *qkv_mh, gk_mh, rk_at)
                set_phase("decrypt_decode")

                def softmax_av(Q, K, V, d):
                    S = Q @ np.swapaxes(K, -1, -2) / np.sqrt(d)
                    P = np.exp(S) / np.exp(S).sum(axis=-1, keepdims=True)
                    return P @ V

                want_at = softmax_av(Q_at, K_at, V_at, d_at).reshape(-1)

                def at_err(o, cod=cod_at, dec=dec_at, pid=pid_at, scale=sc_at, want=want_at):
                    return float(np.abs(decode(cod, dec, o, pid, scale)[:want.size] - want).max())

                err_at = max(at_err(out_at[0]), at_err(out_at[-1]))
                if heads_of is not None:
                    want_mh = softmax_av(Q_mh, K_mh, V_mh, heads_of).reshape(-1)

                    def mh_err(o, pid=pid_mh, scale=sc_mh, want=want_mh):
                        return at_err(o, pid=pid, scale=scale, want=want)

                    err_mh = mh_err(out_mh[1])
                    extra = {"forms": {"heads4": {
                        "d": heads_of, "rot_steps": len(steps_mh),
                        "launches": sum(by_label(launches_mh).values()),
                        "max_abs_decode_err": err_mh}},
                        "input_sha256": sha(torch.stack(cts_at)),
                        "output_sha256": sha(out_at[0])}
                end(path, t0, per_step_at, out_shape=list(out_at.shape), d=d_at, n=n_at,
                    levels=levels_at, goldschmidt_iters=iters_at, rot_steps=len(steps_at),
                    max_abs_decode_err=err_at, max_err=at_err(out_at[0]), **extra)
                if not (err_at < 1e-2 and (heads_of is None or err_mh < 1e-3)):
                    raise AssertionError(f"{path} decodes {err_at} from the numpy attention "
                                         f"(four heads: {extra.get('forms')})")
                if heads_of is not None and not rehearsal and (
                        extra["input_sha256"] != ATTENTION_D16_N512["input_sha256"]
                        or extra["output_sha256"] != ATTENTION_D16_N512["output_sha256"]
                        or at_err(out_at[0]) != ATTENTION_D16_N512["max_err"]
                        or len(steps_at) != ATTENTION_D16_N512["rot_steps"]):
                    raise AssertionError(f"{path} differs from the JAX package's: {extra}")
                out.append(record(path, f"ckks_attention_d{d_at}_n{n_at}_attns_per_s", run_at,
                                  tuple(qkv) + (gk_at, rk_at), per_step_at,
                                  lambda d, f=at_err: within(f(d[1]), 1e-2),
                                  tuple(q[:2].contiguous() for q in qkv) + (gk_at, rk_at),
                                  timed=heads_of is None, steps=10))
                if heads_of is not None:
                    out.append(record(f"attention_heads4_d{heads_of}_n{n_at}", None, run_mh,
                                      None, launches_mh, lambda d, f=mh_err: within(f(d[1]), 1e-3),
                                      tuple(qkv_mh) + (gk_mh, rk_at), False))
                    del out_mh
                del out_at
            return out

        def within(err, limit):
            return err < limit, {"max_abs_decode_err": err}

        def record(name, metric, fn, args, per_step, decode2=None, args2=None, timed=True,
                   steps=None):
            """A zoo path: its step at batch zb (timed unless timed=False;
            over `steps` steps where given, else about 3 s), the launches of
            one step, and decode2(batch-2 output) -> (ok, fields) where the
            batch-2 form (args2; by default the first argument's first two
            rows) is held to the plain path."""
            if args2 is None:
                args2 = (args[0][:2].contiguous(),) + tuple(args[1:])
            z = types.SimpleNamespace(name=name, metric=metric, count=zb, fn=fn, args=args,
                                      launches=sum(by_label(per_step).values()),
                                      decode2=decode2, args2=args2, timed=timed)
            # the timed call: the parent's lambda (its frame beneath the step
            # of the size it had there; section 3y says why)
            z.call = lambda z=z: z.fn(*z.args)
            z.call.steps = steps
            return z

        zoo = [
            record("dense_layer8x8_n8192", "ckks_dense_layer8x8_n8192_layers_per_s", layer_dl,
                   (a_dl, gk8, rk_dl), per_step_dl, lambda d: within(dense_dl_err(d, 1), 1e-3)),
            record("dense_layer8x8_bsgs_n8192", "ckks_dense_layer8x8_bsgs_n8192_layers_per_s",
                   layer_dlb, (a_dl, gk_dlb, rk_dl), per_step_dlb,
                   lambda d: within(dense_dl_err(d, 1), 1e-3)),
            record("cnn16x16_n4096", "ckks_cnn16x16_n4096_images_per_s", cnn,
                   (a_cn, gk_cn, rk_cn), per_step_cn, lambda d: within(cnn_err(d[1]), 1e-2)),
            record("bfv_matvec8x8_n8192", "bfv_matvec8x8_n8192_layers_per_s", bmv, (a_bm, gk_bm),
                   per_step_bm, lambda d: (decodes2(d[1]) == want_bm, {"decode_exact": True})),
            record("logreg_train_m64_f16_n8192", "ckks_logreg_train_m64_f16_n8192_iters_per_s",
                   train_lt, (a_lx, a_lw, gk_lt, rk_lt), per_step_lt),
            record("logreg_f16_n8192", "ckks_logreg_f16_n8192_inferences_per_s", head_lh,
                   (a_lh, gk_lh, rk_lh), per_step_lh)] + compare_paths(record, within)
        serving_path()
        return zoo

    zoo = zoo_paths()
    recorder.remove()
    for kernel, row in rows.items():
        emit({"phase": "kernel_check", "kernel": kernel, "equal": True, **row})

    # 5. batch 2 of each step against the plain path on the card -----------------
    seq = T.build_ckks_mul_relin_rescale(ctx, device=device)
    a2, av2, ar2 = a[:2].contiguous(), av[:2].contiguous(), ar[:2].contiguous()
    checks = (("multiply", step, (a2, a2, rk)), ("square", square, (a2, rk)),
              ("sequential_multiply", seq, (av2, av2, rk)),
              ("train_step", train, (av2, av2, rk, gk1)),
              ("rotate_many", rmany, (ar2, keys_stack)),
              ("rotate_many_prepermuted", rmany_pk, (ar2, pkeys_stack)))
    for name, fn, fargs in checks:
        got_k = fn(*fargs)
        with plain_versions():
            got_p = fn(*fargs)
        sync()
        if not torch.equal(got_k, got_p):
            raise AssertionError(f"batch-2 {name} differs from the plain path")
        if name.startswith("rotate_many"):
            pt = dec.decrypt(T.Ciphertext(got_k[-1, 1].contiguous(), ct_r.parms_id, True,
                                          ct_r.scale))
            err = max_err(encoder.decode(pt), np.roll(v, -rot_steps[-1]))
        else:
            want = want_train if name == "train_step" else (
                v * v if name == "sequential_multiply" else want_sq)
            err = max_err(encoder.decode(dec.decrypt(
                T.Ciphertext(got_k[1], next_cd.parms_id, True, out_scale))), want)
        if not err < 1e-4:
            raise AssertionError(f"batch-2 {name} decodes {err} from its expectation")
        emit({"phase": "batch2", "form": name, "equal_to_plain": True,
              "max_abs_decode_err": err})
    bctx3, brk3, ab3, chain3, decodes3 = cfg3
    _, brk1, ab1, mul1, decodes1 = cfg1
    b3, b1 = ab3[:2].contiguous(), ab1[:2].contiguous()
    chain3_seq = T.build_bfv_mul_relin_modswitch(bctx3, fused_drop=False, device=device)
    mul3 = T.build_bfv_mul_relin(bctx3, device=device)
    sq3 = T.build_bfv_mul_relin(bctx3, square=True, device=device)
    first3 = bctx3.first_parms_id
    swapped = np.concatenate([v2[half:], v2[:half]]).tolist()
    b2r, b2h = a2b[:2].contiguous(), a2h[:2].contiguous()
    bfv_checks = (
        ("bfv_chain_fused_drop", chain3, (b3, b3, brk3), decodes3),
        ("bfv_chain_per_level_drop", chain3_seq, (b3, b3, brk3), decodes3),
        ("bfv_multiply_n8192", mul3, (b3, b3, brk3), lambda d: decodes3(d, first3)),
        ("bfv_square_n8192", sq3, (b3, brk3), lambda d: decodes3(d, first3)),
        ("bfv_multiply_n4096", mul1, (b1, b1, brk1), decodes1),
        ("bfv_rotate_rows", rot_rows, (b2r, key_r), lambda d: decodes2(d) == rows_rotated(1)),
        ("bfv_rotate_columns", rot_cols, (b2r, key_c), lambda d: decodes2(d) == swapped),
        ("bfv_rotate_many", bmany, (b2h, hstack),
         lambda d: decodes2(d[-1]) == rows_rotated(hsteps[-1])),
        ("bfv_rotate_many_prepermuted", bmany_pk, (b2h, phstack),
         lambda d: decodes2(d[-1]) == rows_rotated(hsteps[-1])),
    )
    for name, fn, fargs, decodes in bfv_checks:
        got_k = fn(*fargs)
        with plain_versions():
            got_p = fn(*fargs)
        sync()
        if not torch.equal(got_k, got_p):
            raise AssertionError(f"batch-2 {name} differs from the plain path")
        if not decodes(got_k[1] if got_k.dim() == 4 else got_k[:, 1]):
            raise AssertionError(f"batch-2 {name} does not decode to its expectation")
        emit({"phase": "batch2", "form": name, "equal_to_plain": True, "decode_exact": True})
    large_checks = (
        ("ckks_mul_relin_rescale_n16384", step4, (a4[:2].contiguous(),) * 2 + (rk4,),
         lambda d: max_err(encoder4.decode(dec4.decrypt(T.Ciphertext(
             d, cd4.next_context_data.parms_id, True, scale4_out))), v4 * v4), 1e-4),
        ("ckks_poly_eval_n32768", step5, (a5[:2].contiguous(), rk5, gk5),
         lambda d: max_err(encoder5.decode(dec5.decrypt(T.Ciphertext(
             d, deep5, True, out_scale5))), want5), 1e-3),
        ("n65536", step6, (a6[:2].contiguous(),) * 2 + (rk6,),
         lambda d: max_err(encoder6.decode(dec6.decrypt(T.Ciphertext(
             d, cd6.next_context_data.parms_id, True, scale6))), want6), 1e-4),
    )
    for name, fn, fargs, decode_err, tol in large_checks:
        got_k = fn(*fargs)
        with plain_versions():
            got_p = fn(*fargs)
        sync()
        if not torch.equal(got_k, got_p):
            raise AssertionError(f"batch-2 {name} differs from the plain path")
        err = decode_err(got_k[1])
        if not err < tol:
            raise AssertionError(f"batch-2 {name} decodes {err} from its expectation")
        emit({"phase": "batch2", "form": name, "equal_to_plain": True,
              "max_abs_decode_err": err})
        del got_k, got_p

    # the refresh (one ciphertext, no batch axis) and the dense layer (batch
    # 2) against the port's plain path on the card
    got_k = boot7(x7, rot7, conjk7, rk7)
    with plain_versions():
        got_p = boot7(x7, rot7, conjk7, rk7)
    sync()
    if not torch.equal(got_k, got_p):
        raise AssertionError("bootstrap_n4096 differs from the plain path")
    emit({"phase": "batch2", "form": "bootstrap_n4096", "equal_to_plain": True, "batch": 1,
          "output_sha256": hashlib.sha256(to_numpy(got_k).tobytes()).hexdigest()})
    a8_2 = a8[:2].contiguous()
    got_k = mv8(a8_2, gk8)
    with plain_versions():
        got_p = mv8(a8_2, gk8)
    sync()
    if not torch.equal(got_k, got_p):
        raise AssertionError("batch-2 dense8x8_n8192 differs from the plain path")
    err = max_err(encoder8.decode(dec8.decrypt(T.Ciphertext(got_k[1].contiguous(), ct8.parms_id,
                                                           True, 2.0 ** 80))), want8)
    if not err < 1e-4:
        raise AssertionError(f"batch-2 dense8x8_n8192 decodes {err} from M x")
    emit({"phase": "batch2", "form": "dense8x8_n8192", "equal_to_plain": True,
          "max_abs_decode_err": err})
    del got_k, got_p

    # the model zoo's dense layer (both forms), CNN and BFV matvec at batch 2
    for z in zoo:
        if z.decode2 is None:
            continue
        got_k = z.fn(*z.args2)
        with plain_versions():
            got_p = z.fn(*z.args2)
        sync()
        if not torch.equal(got_k, got_p):
            raise AssertionError(f"batch-2 {z.name} differs from the plain path")
        ok, fields = z.decode2(got_k)
        if not ok:
            raise AssertionError(f"batch-2 {z.name} does not decode to its expectation: {fields}")
        emit({"phase": "batch2", "form": z.name, "equal_to_plain": True, **fields})
        del got_k, got_p

    # the power-basis limb drop of config 3's per-level chain at batch 128,
    # timed as a function (its four launches together) beside its bound
    from gemini_seal_tpu_torch.ops import rnsops

    drop_in = mul3(ab3, ab3, brk3)
    tool3 = bctx3.first_context_data().device_rns_tool
    drop_out, drop_launches = count_step(rnsops.divide_and_round_q_last, drop_in, tool3)
    drop_bytes = bytes_once([drop_in]) + bytes_once([drop_out])
    drop_ops = (drop_out.numel() * (IMAD_MAC + IMAD_BARRETT128 + IMAD_MULMOD)
                + drop_out.numel() // drop_out.shape[-2] * IMAD_BARRETT64)
    drop = {"phase": "function", "function": "divide_and_round_q_last",
            "input_shape": list(drop_in.shape),
            "launches": {k: c for k, c in by_label(drop_launches).items() if c},
            "bytes": drop_bytes, "imads": drop_ops,
            "bound_ms": max(drop_bytes / HBM_BYTES_PER_S, drop_ops / INT32_IMAD_PER_S) * 1e3,
            "bound_by": "operations" if drop_ops / INT32_IMAD_PER_S
                        > drop_bytes / HBM_BYTES_PER_S else "bytes", "card": card}
    with plain_versions():
        if not torch.equal(rnsops.divide_and_round_q_last(drop_in, tool3), drop_out):
            raise AssertionError("divide_and_round_q_last differs from its plain version")
    if not rehearsal:
        drop["ms"] = event_ms(torch, lambda: rnsops.divide_and_round_q_last(drop_in, tool3),
                              reps)
        with plain_versions():
            drop["plain_ms"] = event_ms(
                torch, lambda: rnsops.divide_and_round_q_last(drop_in, tool3), 2)
    emit(drop)
    del drop_in, drop_out

    # the BSGS matvec's giant-step permutation (K5 paired, pipelines.py:957-961)
    # from one build_ckks_matvec_bsgs call at dense8x8's ring, batch 16: the
    # call is captured as it happens, then held to its plain version and to
    # torch.gather, and timed beside its bound
    from gemini_seal_tpu_torch.models import pipelines as pipes
    from gemini_seal_tpu_torch.ops.galois import galois_permute

    bsgs8, bsgs_steps8 = T.build_ckks_matvec_bsgs(ctx8, diag8, 2.0 ** 40, encoder8, device=device)
    bsgs_keys8 = kg8.galois_keys(tool8.get_elts_from_steps(bsgs_steps8)).stacked(
        *tool8.get_elts_from_steps(bsgs_steps8))
    giant_calls = []
    orig_permute = pipes.galois_permute

    def capture(x, tabs, moduli=None, paired=False):
        out = orig_permute(x, tabs, moduli, paired)
        if paired:
            giant_calls.append((x, tabs, out))
        return out

    pipes.galois_permute = capture
    try:
        bsgs_out8, bsgs_launches = count_step(bsgs8, a8, bsgs_keys8)
    finally:
        pipes.galois_permute = orig_permute
    gx, gtabs, gout = giant_calls[0]
    with plain_versions():
        if not torch.equal(galois_permute(gx, gtabs, paired=True), gout):
            raise AssertionError("the BSGS giant-step permutation differs from its plain version")
    glib = library_call(torch, gx, gtabs, paired=True)
    if not torch.equal(glib().reshape(gout.shape), gout):
        raise AssertionError("torch.gather differs from the BSGS giant-step permutation")
    g_bytes, _ = work("galois", "galois_permute", (gx, gtabs), {"paired": True}, gout)
    bsgs_err8 = max(max_err(encoder8.decode(dec8.decrypt(T.Ciphertext(
        bsgs_out8[b].contiguous(), ct8.parms_id, True, 2.0 ** 80))), want8) for b in (0, b8 - 1))
    giant = {"phase": "function", "function": "bsgs_giant_step_permutation",
             "input_shape": list(gx.shape), "tables": list(gtabs.shape),
             "rot_steps": bsgs_steps8, "calls_per_matvec": len(giant_calls),
             "matvec_launches": {k: c for k, c in by_label(bsgs_launches).items() if c},
             "matvec_max_abs_decode_err": bsgs_err8, "bytes": g_bytes,
             "bound_ms": g_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "card": card}
    if not bsgs_err8 < 1e-4:
        raise AssertionError(f"the BSGS matvec decodes {bsgs_err8} from M x")
    if not rehearsal:
        giant["ms"] = event_ms(torch, lambda: galois_permute(gx, gtabs, paired=True), reps)
        with plain_versions():
            giant["plain_ms"] = event_ms(torch, lambda: galois_permute(gx, gtabs, paired=True),
                                         reps)
        giant["library_ms"] = event_ms(torch, glib, reps)
    emit(giant)
    del giant_calls, gx, gout, bsgs_out8

    # 6. steady state at each path's full batch --------------------------------
    # (path, metric, count per call, call, batch); a pair in one tuple is
    # timed in turns: A, B, A, B
    tables4, tables6 = cd4.ntt_tables, cd6.ntt_tables
    timed = [
        ("mul_relin_rescale", "ckks_mul_relin_rescale_n8192_ops_per_s", batch,
         lambda: step(a, a, rk), batch),
        ("mul_relin_rescale_sequential", "ckks_mul_relin_rescale_sequential_n8192_ops_per_s",
         batch, lambda: seq(a, a, rk), batch),
        ("train_step", "ckks_train_step_n8192_ops_per_s", batch,
         lambda: train(av, av, rk, gk1), batch),
        (("rotate_many", "ckks_rotate_many_n8192_rotations_per_s",
          rot_batch * len(rot_steps), lambda: rmany(ar, keys_stack), rot_batch),
         ("rotate_many_prepermuted", "ckks_rotate_many_prepermuted_n8192_rotations_per_s",
          rot_batch * len(rot_steps), lambda: rmany_pk(ar, pkeys_stack), rot_batch)),
        ("bfv_mul_relin_chain", "bfv_mul_relin_chain_n8192_ops_per_s", batch,
         lambda: chain3(ab3, ab3, brk3), batch),
        ("bfv_mul_relin_n8192", "bfv_mul_relin_n8192_ops_per_s", batch,
         lambda: mul3(ab3, ab3, brk3), batch),
        ("bfv_square_relin_n8192", "bfv_square_relin_n8192_ops_per_s", batch,
         lambda: sq3(ab3, brk3), batch),
        ("bfv_mul_relin", "bfv_mul_relin_n4096_ops_per_s", batch,
         lambda: mul1(ab1, ab1, brk1), batch),
        ("bfv_rotate_rows", "bfv_rotate_rows_n8192_ops_per_s", batch,
         lambda: rot_rows(a2b, key_r), batch),
        (("bfv_rotate_many", "bfv_rotate_rows_hoisted8_n8192_rot_per_s",
          rot_batch * len(hsteps), lambda: bmany(a2h, hstack), rot_batch),
         ("bfv_rotate_many_prepermuted", "bfv_rotate_rows_hoisted8_prepermuted_n8192_rot_per_s",
          rot_batch * len(hsteps), lambda: bmany_pk(a2h, phstack), rot_batch)),
        ("ckks_mul_relin_rescale_n16384", "ckks_mul_relin_rescale_n16384_ops_per_s", batch,
         lambda: step4(a4, a4, rk4), batch),
        ("ntt_n16384", "ntt_n16384_per_s", ntt4.numel() // n4,
         lambda: ntt_ops.ntt_forward(ntt4, tables4), batch),
        ("ckks_poly_eval_n32768", "ckks_deep_poly4_rot_n32768_ops_per_s", batch,
         lambda: step5(a5, rk5, gk5), batch),
        ("ntt_fwd_n65536", "ntt_fwd_n65536_rows_per_s", x6.numel() // n6,
         lambda: ntt_ops.ntt_forward(x6, tables6), b6),
        ("ntt_inv_n65536", "ntt_inv_n65536_rows_per_s", x6.numel() // n6,
         lambda: ntt_ops.ntt_inverse(x6, tables6), b6),
        ("n65536", "ckks_mul_relin_rescale_n65536_ops_per_s", b6,
         lambda: step6(a6, a6, rk6), b6),
        ("bootstrap_n4096", "ckks_bootstrap_n4096_refreshes_per_s", 1,
         lambda: boot7(x7, rot7, conjk7, rk7), 1),
        (("dense8x8_n8192_b2", "ckks_dense8x8_hoisted_n8192_layers_per_s", 2,
          lambda: mv8(a8_2, gk8), 2),
         ("dense8x8_n8192", "ckks_dense8x8_hoisted_n8192_layers_per_s", b8,
          lambda: mv8(a8, gk8), b8)),
        # the schedules on four threads of the one card: the four transforms
        # of an ntt_sp4 step count their rows each
        ("ntt_sp4_n65536", "ntt_sp4_n65536_rows_per_s", 4 * x6.numel() // n6, ntt_sp_step6, b6),
        ("ntt_sp4_n16384", "ntt_sp4_n16384_rows_per_s", 4 * ntt4.numel() // n4, ntt_sp_step4,
         batch),
        ("ckks_mul_relin_rescale_csp4_n16384", "ckks_mul_relin_rescale_csp4_n16384_ops_per_s",
         batch, lambda: csp_mrr(a4c, rk4c), batch),
        ("ckks_rotate_csp4_n16384", "ckks_rotate_csp4_n16384_ops_per_s", b4r,
         lambda: csp_rot(a4rc, gk4c), b4r),
        ("ckks_mul_relin_rescale_limb4_n4096", "ckks_mul_relin_rescale_limb4_n4096_ops_per_s",
         batch, lambda: limb_mrr(a_lc), batch),
        ("ckks_rotate_many_limb4_n4096", "ckks_rotate_many_limb4_n4096_rotations_per_s",
         b_lr * len(steps_l), lambda: limb_rot(a_lrc), b_lr),
        ("bfv_mul_relin_behz4_n8192", "bfv_mul_relin_behz4_n8192_ops_per_s", batch,
         lambda: behz_mul(ab3c), batch),
        ("matvec_limb4_n4096", "ckks_matvec8x8_limb4_n4096_layers_per_s", rot_batch,
         lambda: limb_matvec(a_mc), rot_batch),
    ]
    timed += [(z.name, z.metric, z.count, z.call, z.count) for z in zoo if z.timed]
    keygen_of = {"mul_relin_rescale_sequential": "mul_relin_rescale",
                 "bfv_mul_relin_n8192": "bfv_mul_relin_chain",
                 "bfv_square_relin_n8192": "bfv_mul_relin_chain",
                 "rotate_many_prepermuted": "rotate_many",
                 "bfv_rotate_many_prepermuted": "bfv_rotate_many",
                 "ntt_n16384": "ckks_mul_relin_rescale_n16384",
                 "ntt_fwd_n65536": "n65536", "ntt_inv_n65536": "n65536",
                 "dense8x8_n8192_b2": "dense8x8_n8192", "ntt_sp4_n65536": "n65536",
                 "ntt_sp4_n16384": "ckks_mul_relin_rescale_n16384",
                 "ckks_rotate_csp4_n16384": "ckks_mul_relin_rescale_csp4_n16384",
                 "ckks_rotate_many_limb4_n4096": "ckks_mul_relin_rescale_limb4_n4096",
                 "bfv_mul_relin_behz4_n8192": "bfv_mul_relin_chain",
                 "dense_layer8x8_bsgs_n8192": "dense_layer8x8_n8192"}
    sharded_paths = {"ntt_sp4_n65536", "ntt_sp4_n16384", "ckks_mul_relin_rescale_csp4_n16384",
                     "ckks_rotate_csp4_n16384", "ckks_mul_relin_rescale_limb4_n4096",
                     "ckks_rotate_many_limb4_n4096", "bfv_mul_relin_behz4_n8192",
                     "matvec_limb4_n4096"}
    extra_of = {"bootstrap_n4096": {
        "max_err": err7, "levels_restored": levels_out7, "levels_consumed": levels7,
        "launches_per_refresh": sum(paths["bootstrap_n4096"]["launches_per_step"].values())}}
    for z in zoo:
        extra_of[z.name] = {"launches_per_step": z.launches}
    if not rehearsal:
        for entry in timed:
            turns = [(entry, 1)] if isinstance(entry[0], str) else [
                (entry[0], 1), (entry[1], 1), (entry[0], 2), (entry[1], 2)]
            for (path, metric, count, fn, b), turn in turns:
                torch.cuda.reset_peak_memory_stats()
                rate, iters, dt = steady(torch, fn, count)
                peak = torch.cuda.max_memory_allocated()
                prof = profile_steps(torch, fn, 10, dt * 1e3 / iters,
                                     all_threads=path in sharded_paths)
                extra = dict(extra_of.get(path, {}))
                if path in sharded_paths:
                    extra.update(group_of, exchange_copies=prof.get("exchange_copies"))
                emit({"phase": "steady_state", "path": path, "metric": metric, "value": rate,
                      "batch": b, "turn": turn, "iters": iters, "seconds": dt,
                      "device_ms_per_step": prof["device_ms_per_step"],
                      "device_busy_share": prof["device_busy_share"],
                      "keygen_seconds": keygen_s[keygen_of.get(path, path)],
                      "peak_device_bytes": peak, "card": card, **extra})
                emit({"phase": "profile", "path": path, "turn": turn, **prof})
        emit({"phase": "memory", "peak_device_bytes_with_checks_by_path":
              {p: v["peak_device_bytes_with_checks"] for p, v in paths.items()}, "card": card})

    # 6b. the per-op API, op by op, as a user calls it: median host ms over 20
    # calls, each waited for, the launches of one call, and device ms and busy
    # share from torch.profiler; then ex8's three tiers per ciphertext
    if not rehearsal:
        x_d = ct_d
        m_d = ev_d.multiply(x_d, x_d)
        r_d = ev_d.relinearize(m_d, rk_d)
        p_d = ev_d.rescale_to_next(r_d)
        four = hex_plain("4")
        m_e1 = ev_e1.multiply(a_e1, b_e1)
        per_ops = [
            ("ckks_n8192", "multiply", lambda: ev_d.multiply(x_d, x_d)),
            ("ckks_n8192", "square", lambda: ev_d.square(x_d)),
            ("ckks_n8192", "relinearize", lambda: ev_d.relinearize(m_d, rk_d)),
            ("ckks_n8192", "rescale_to_next", lambda: ev_d.rescale_to_next(r_d)),
            ("ckks_n8192", "rotate_vector", lambda: ev_d.rotate_vector(p_d, 1, gk_d)),
            ("ckks_n8192", "add", lambda: ev_d.add(p_d, p_d)),
            ("ckks_n8192", "DeviceEvaluator.multiply_relin_rescale",
             lambda: dev_d.multiply_relin_rescale(x_d, x_d, rk_d)),
            ("bfv_n4096", "multiply_plain (monomial)", lambda: ev_e1.multiply_plain(a_e1, four)),
            ("bfv_n4096", "multiply", lambda: ev_e1.multiply(a_e1, b_e1)),
            ("bfv_n4096", "square", lambda: ev_e1.square(x_e1)),
            ("bfv_n4096", "relinearize", lambda: ev_e1.relinearize(m_e1, rk_e1)),
            ("bfv_n4096", "add_plain", lambda: ev_e1.add_plain(x_e1, hex_plain("1"))),
        ]

        def median_ms(fn, calls=20):
            fn()
            sync()
            times = []
            for _ in range(calls):
                t1 = time.perf_counter()
                fn()
                sync()
                times.append((time.perf_counter() - t1) * 1e3)
            return sorted(times)[calls // 2], times

        for ring, op, fn in per_ops:
            _, launches = count_step(fn)
            host_ms, times = median_ms(fn)
            prof = profile_steps(torch, fn, 10, host_ms)
            emit({"phase": "per_op", "ring": ring, "op": op, "host_ms_median": host_ms,
                  "host_ms_min": min(times), "device_ms": prof["device_ms_per_step"],
                  "device_busy_share": prof["device_busy_share"],
                  "launches": {k: c for k, c in by_label(launches).items() if c},
                  "card": card})
            emit({"phase": "profile", "path": f"per_op {ring} {op}", **prof})
        tiers = [("host Evaluator", 1, lambda: ex8_chain(ev_d, ct_d)),
                 ("DeviceEvaluator", 1, lambda: ex8_chain(dev_d, dev_d.put(ct_d))),
                 (f"build_ckks_train_step batch {b_d}", b_d,
                  lambda: train_d(batch_d, batch_d, rk_d2, gk_d1))]
        for tier, count, fn in tiers:
            host_ms, _ = median_ms(fn)
            prof = profile_steps(torch, fn, 10, host_ms)
            emit({"phase": "ex8_tiers", "tier": tier, "batch": count,
                  "host_ms_median": host_ms, "host_ms_per_ciphertext": host_ms / count,
                  "device_ms_per_ciphertext": prof["device_ms_per_step"] / count,
                  "device_busy_share": prof["device_busy_share"], "card": card})

    # 6c. the four-step int8 NTT against K1 at the tool's two shapes: the four
    # transforms in turns (MXU forward, K1 forward, MXU inverse, K1 inverse,
    # twice), each with its poly-limb NTTs/s (host clock over about 3 s),
    # device ms a transform (CUDA events) and busy share (torch.profiler)
    if not rehearsal:
        for path, (xm, tabs, k1tabs, build_s) in mxu_runs.items():
            rows_m = xm.numel() // tabs.n
            fns = {"mxu_forward": lambda: mxu_ops.ntt_forward_mxu(xm, tabs),
                   "k1_forward": lambda: ntt_ops.ntt_forward(xm, k1tabs),
                   "mxu_inverse": lambda: mxu_ops.ntt_inverse_mxu(xm, tabs),
                   "k1_inverse": lambda: ntt_ops.ntt_inverse(xm, k1tabs)}
            turns = {name: [] for name in fns}
            for _ in range(2):
                for name, fn in fns.items():
                    rate, iters, dt = steady(torch, fn, rows_m)
                    prof = profile_steps(torch, fn, 10, dt * 1e3 / iters)
                    turns[name].append({"ntts_per_s": rate,
                                        "device_ms": event_ms(torch, fn, reps),
                                        "device_busy_share": prof["device_busy_share"]})

            def mean(name, field):
                return sum(t[field] for t in turns[name]) / len(turns[name])

            # the least time of a transform's two passes: rows x N x (N1 + N2)
            # MACs a digit pair, at each limb's pairs and at the tables'
            per_pair = (rows_m // len(tabs.moduli)) * tabs.n * (tabs.n1 + tabs.n2)
            bounds = {}
            for d in ("forward", "inverse"):
                col, row = ("fwd_col", "fwd_row") if d == "forward" else ("inv_col", "inv_row")
                for label, pairs in (
                        ("per_limb_pairs", [a * b for a, b in
                                            zip(tabs.limb_ndig_w[col], tabs.limb_ndig_x)]),
                        ("table_pairs", [tabs.ndig_w * tabs.ndig_x] * len(tabs.moduli))):
                    bounds.setdefault(label, {})[d] = (
                        max(per_pair * sum(pairs) / INT8_MAC_PER_S,
                            4 * xm.numel() * 8 / HBM_BYTES_PER_S) * 1e3)
            emit({"phase": "ntt_mxu", "path": path, "n": tabs.n, "moduli_bits":
                  [int(p).bit_length() for p in tabs.moduli], "rows": rows_m, "card": card,
                  "table_build_seconds": build_s,
                  "poly_limb_ntts_per_s": {k: [t["ntts_per_s"] for t in v]
                                           for k, v in turns.items()},
                  "mxu_over_k1": {d: mean(f"mxu_{d}", "ntts_per_s") / mean(f"k1_{d}", "ntts_per_s")
                                  for d in ("forward", "inverse")},
                  "device_ms_per_transform": {k: [t["device_ms"] for t in v]
                                              for k, v in turns.items()},
                  "device_busy_share": {k: [t["device_busy_share"] for t in v]
                                        for k, v in turns.items()},
                  "bound_ms_per_transform": bounds,
                  "share_of_bound": {label: {d: b / mean(f"mxu_{d}", "device_ms")
                                             for d, b in v.items()}
                                     for label, v in bounds.items()}})

    # 6d. the schedules over NCCL, one process per card, when the machine has
    # four cards (the one-card run above is four threads of this process)
    nccl_phase(torch, T, device, card, rehearsal)

    # 7. kernels line and result line -----------------------------------------------
    replaces = {
        "ntt": "gemini_seal_tpu/ops/ntt.py:241 ntt_forward_lazy, :322 ntt_inverse_lazy",
        "ntt:large_ring": "gemini_seal_tpu/ops/ntt.py:241 ntt_forward_lazy, :322 "
                          "ntt_inverse_lazy at N = 32768, 65536 (one cluster launch)",
        "tensor_product": "gemini_seal_tpu/models/pipelines.py:72 _convolve3, :87 _square3",
        "contract": "gemini_seal_tpu/ops/modops.py:218 accumulate_mulmod_128",
        "contract:broadcast": "gemini_seal_tpu/models/pipelines.py:318 "
                              "_shared_digit_inner_product; gemini_seal_tpu/ops/keyswitch.py:352 "
                              "keyswitch_inner_product (both key components in one launch)",
        "contract:pairwise": "gemini_seal_tpu/models/pipelines.py:2333-2342 "
                             "build_ckks_matmul_square's accumulate_mulmod_128 over the pairs "
                             "(a_k, b_k) of two batched ciphertexts",
        "elementwise": "gemini_seal_tpu/ops/keyswitch.py:438 fused_moddown mul_mod/add_mod "
                       "epilogues; gemini_seal_tpu/ops/rnsops.py:356 fast_floor, :182 "
                       "divide_and_round_q_last, :463 divide_and_round_multi",
        "galois": "gemini_seal_tpu/ops/galois.py:123 apply_galois_ntt; "
                  "gemini_seal_tpu/ops/keyswitch.py:403 the R-table digit gather",
        "galois:signed": "gemini_seal_tpu/ops/galois.py:115 apply_galois; "
                         "gemini_seal_tpu/models/pipelines.py:403 build_bfv_rotate_many's "
                         "signed gather of c0",
        "galois:paired": "gemini_seal_tpu/models/pipelines.py:483 build_ckks_rotate_many's "
                         "take_along_axis (counter-rotated keys), :291 "
                         "prepermute_galois_stack",
        "galois:signed_paired": "gemini_seal_tpu/models/pipelines.py:389 "
                                "build_bfv_rotate_many's take_along_axis and sign flip "
                                "(counter-rotated keys)",
        "behz": "gemini_seal_tpu/ops/rnsops.py:329 sm_mrq, :369 fastbconv_sk",
        "scale_round": "gemini_seal_tpu/ops/rnsops.py:256 multiply_add_plain_with_scaling_variant, "
                       ":287 multiply_sub_plain_with_scaling_variant, :145 "
                       "decrypt_scale_and_round",
        "mod_raise": "gemini_seal_tpu/models/bootstrap.py:253 mod_raise (the centred lift, "
                     ":261-264)",
        "negacyclic:mono_mul": "gemini_seal_tpu/ops/dyadic.py:128 negacyclic_mono_mul_poly "
                               "(gemini_seal_tpu/evaluator.py:272, the monomial "
                               "multiply_plain)",
        "negacyclic:shift": "gemini_seal_tpu/ops/dyadic.py:109 negacyclic_shift_poly",
        "negacyclic": "gemini_seal_tpu/ops/dyadic.py:109 negacyclic_shift_poly, :128 "
                      "negacyclic_mono_mul_poly",
        "infty_norm": "gemini_seal_tpu/ops/dyadic.py:135 poly_infty_norm",
        "elementwise:reduce64": "gemini_seal_tpu/ops/dyadic.py:102 modulo_poly_coeffs",
        "ntt:sub_row": "gemini_seal_tpu/parallel/ntt_sp.py:56 _local_forward_stages; the "
                       "inverse chunk-local stages :160-182, :336-355",
        "ntt_sp": "gemini_seal_tpu/parallel/ntt_sp.py:106-119, :185-208 the hypercube cross "
                  "stages, :259-272, :359-373 the four-step cross stages",
        "ntt_sp:exchange": "gemini_seal_tpu/parallel/ntt_sp.py:106-119 ntt_forward_sharded's "
                           "cross stages, :185-208 ntt_inverse_sharded's",
        "ntt_sp:rows": "gemini_seal_tpu/parallel/ntt_sp.py:259-272 forward_4step_local's and "
                       ":359-373 inverse_4step_local's cross stages",
        "ntt_mxu": "gemini_seal_tpu/ops/ntt_mxu.py:362 _pass (:275 _balanced_digits_dev, :289 "
                   "_digit_matmul, :321 _combine_planes) and the twist of :370 ntt_forward_mxu, "
                   ":389 ntt_inverse_mxu (gemini_seal_tpu/ops/modops.py:184 mul_mod_shoup)",
    }
    sources = {k: f"gemini_seal_tpu_torch/csrc/{v[0]}" for k, v in cuda.KERNELS.items()}
    library_calls = {
        "galois": "torch.index_select (one table) / torch.gather (R tables) over the last axis",
        "galois:paired": "torch.gather over the last axis",
        "galois:signed": "the permutation part: torch.index_select / torch.gather (no PyTorch "
                         "call flips the signs mod p)",
        "galois:signed_paired": "the permutation part: torch.gather (no PyTorch call flips "
                                "the signs mod p)",
        "mod_raise": "the reduction part: torch.remainder broadcast over the L primes (no "
                     "PyTorch call lifts the negative residues)",
        "negacyclic:shift": "torch.roll + torch.where (p - a where the coefficient wrapped)",
        "negacyclic:mono_mul": "the permutation and signs only: torch.roll + torch.where (no "
                               "PyTorch call multiplies mod p)",
        "infty_norm": "torch.amax of the centred magnitude (torch.where first)",
        "elementwise:reduce64": "torch.remainder by the per-limb primes",
        "ntt_mxu": "the digit-pair products only: torch._int_mm (cuBLASLt int8), one call per "
                   "limb and shift (no PyTorch call splits, recombines or reduces mod p)",
    }
    def totals(bp):
        return {f: sum(p[f] for p in bp.values())
                for f in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "imads",
                          "int8_macs")}

    def mode_rows(label, row):
        """Each mode's launches (all phases of each path; their sum is the
        kernel's count where ``launches_match``), and its timed calls' ms,
        plain ms and bound, summed and per path."""
        out = {}
        for mode, m in row.get("by_mode", {}).items():
            total = totals(m["by_path"])
            out[mode] = {
                "launches": sum(m["launches_by_path"].values()),
                "launches_by_path": m["launches_by_path"],
                "ms": total["ms"] if not rehearsal and m["by_path"] else None,
                "plain_ms": total["plain_ms"] if not rehearsal and m["by_path"] else None,
                "bound_ms": total["bound_ms"],
                "bound_by": bound_of(total["bytes"], total["imads"], 0)[1],
                "per_step_by_path": {p: {f: v[f] if f in ("bound_ms", "calls") or not rehearsal
                                         else None for f in ("ms", "plain_ms", "bound_ms",
                                                             "calls")}
                                     for p, v in m["by_path"].items()}}
        if out:
            counted = {p: sum(m["launches_by_path"].get(p, 0) for m in out.values())
                       for p in paths}
            out["launches_match"] = all(counted[p] == paths[p]["launches"][label] for p in paths)
        return out

    kernels = []
    for label, row in rows.items():
        bp = row["by_path"]
        total = totals(bp)
        has_lib = label.startswith(("galois", "negacyclic")) or label in (
            "mod_raise", "infty_norm", "elementwise:reduce64", "ntt_mxu")
        fields = ("ms", "plain_ms", "bound_ms") + (("library_ms",) if has_lib else ())
        kernels.append({
            "name": label, "route": "cuda", "source": sources[label.split(":")[0]],
            "replaces": replaces[label],
            "launches": sum(p["launches"][label] for p in paths.values()),
            "launches_by_path": {p: paths[p]["launches"][label] for p in paths},
            # a path with two forms (the two key forms) lists each form's
            "launches_per_step": {p: [f[label] for f in paths[p]["launches_per_step_by_form"]]
                                  if "launches_per_step_by_form" in paths[p]
                                  else paths[p]["launches_per_step"][label] for p in paths},
            "max_abs_err": row["max_abs_err"],
            "ms": total["ms"] if not rehearsal and bp else None,
            "plain_ms": total["plain_ms"] if not rehearsal and bp else None,
            "bound_ms": total["bound_ms"],
            "bound_by": bound_of(total["bytes"], total["imads"], total["int8_macs"])[1],
            "library_ms": total["library_ms"] if has_lib and not rehearsal and bp else None,
            "library_call": library_calls.get(label, "none: no PyTorch call computes u64 "
                                                     "modular arithmetic"),
            "timed_calls": ("encryption and decryption (no step launches it)"
                            if label == "scale_round" else
                            "none: no step launches it" if not bp else "each path's step"),
            "per_step_by_path": {p: {f: v[f] if f == "bound_ms" or not rehearsal else None
                                     for f in fields}
                                 for p, v in bp.items()},
            **({"by_mode": mode_rows(label, row)} if label in MODE_ROWS else {}),
        })
    emit({"kernels": kernels})
    if rehearsal:
        emit({"ok": True, "rehearsal": "cpu"})
        return 0
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
