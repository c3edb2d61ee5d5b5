"""gemini_seal_tpu_torch: the PyTorch/CUDA port of gemini_seal_tpu.

Residues are int64 tensors holding u64 values; every modular-arithmetic
stage on the card is a hand-written CUDA kernel for Hopper (sm_90a) under
``csrc/``, built with nvcc at first use, with a plain PyTorch version
beside it that runs for CPU tensors.  Entry points take ``device`` (None
means the card, and raises when none is present).

Ported so far: keygen (secret, public, relin and Galois keys, their
seed-compressed serializable forms and the powers of s), public-key,
symmetric and seeded encryption and decryption for BFV and CKKS, one
ciphertext or a batch at a time; the SEAL wire format (serialization, with
the checked loaders of valcheck), the wire-to-wire server
(models.serving.EncryptedComputeServer), the ciphertext health metrics,
BigUInt and the big-coefficient polynomial helpers; the CKKS vector,
batch, integer and scalar encode and decode, multiply + relinearize + rescale (fused and sequential),
rotate, hoisted multi-rotation (plain and counter-rotated keys), the
flagship train step (multiply + relinearize + rescale, rotate, add;
``entry()``) and the deep polynomial evaluation; the BFV BatchEncoder, the
BEHZ multiply + relinearize, its mod-switch chain, the power-basis Galois
automorphism and the hoisted row rotations; the encrypted matvecs
(hoisted diagonal method and baby-step/giant-step) and the model zoo on
them (dense layer, MLP, convolutions, CNN, BFV matvec, logistic regression
and its training step, Goldschmidt reciprocal), the Chebyshev-cosine
EvalMod and the CKKS bootstrap (models.bootstrap, whose mod-raise runs on
the ``mod_raise`` kernel); the SEAL per-op API: the whole ``Evaluator``
(its monomial multiply_plain on the ``negacyclic`` kernel),
``DeviceEvaluator``, ``IntegerEncoder``, the Plaintext and Ciphertext
helpers and the BFV noise budget, and the rest of ops/dyadic.py
(``poly_infty_norm`` on the ``infty_norm`` kernel).  Every ring degree up to
SEAL's cap, N=65536, runs on the card.
"""

from .modulus import CoeffModulus, Modulus, PlainModulus, SecLevelType
from .params import EncryptionParameters, SchemeType
from .context import SealContext
from .ciphertext import Ciphertext, Plaintext
from .keys import GaloisKeys, KSwitchKeys, PublicKey, RelinKeys, SecretKey
from .keygenerator import KeyGenerator
from .encryptor import Encryptor
from .decryptor import Decryptor
from .evaluator import Evaluator
from .encoders import BatchEncoder, CKKSEncoder, IntegerEncoder
from .biguint import BigUInt
from .serialization import SerializableCiphertext, SerializableKSwitchKeys
from .models.device_evaluator import DeviceEvaluator
from .models.pipelines import (attention_plan, build_bfv_matvec, build_bfv_mul_relin,
                               build_bfv_mul_relin_modswitch, build_bfv_rotate_many,
                               build_ckks_attention, build_ckks_cnn, build_ckks_conv2d,
                               build_ckks_conv2d_mc, build_ckks_dense_layer, build_ckks_inverse,
                               build_ckks_logreg, build_ckks_logreg_train_step,
                               build_ckks_matmul_square, build_ckks_matvec,
                               build_ckks_matvec_bsgs, build_ckks_max, build_ckks_mlp,
                               build_ckks_mul_relin_rescale, build_ckks_poly_eval,
                               build_ckks_relu, build_ckks_rotate, build_ckks_rotate_many,
                               build_ckks_rsqrt, build_ckks_sign, build_ckks_sqrt,
                               build_ckks_train_step, prepermute_galois_stack,
                               sign_composite_reference, strided_dense_diagonals)
from .entry import entry

__all__ = [
    "CoeffModulus",
    "Modulus",
    "PlainModulus",
    "SecLevelType",
    "EncryptionParameters",
    "SchemeType",
    "SealContext",
    "Ciphertext",
    "Plaintext",
    "GaloisKeys",
    "KSwitchKeys",
    "PublicKey",
    "RelinKeys",
    "SecretKey",
    "KeyGenerator",
    "Encryptor",
    "Decryptor",
    "Evaluator",
    "DeviceEvaluator",
    "BatchEncoder",
    "CKKSEncoder",
    "IntegerEncoder",
    "BigUInt",
    "SerializableCiphertext",
    "SerializableKSwitchKeys",
    "attention_plan",
    "build_bfv_matvec",
    "build_bfv_mul_relin",
    "build_bfv_mul_relin_modswitch",
    "build_bfv_rotate_many",
    "build_ckks_attention",
    "build_ckks_cnn",
    "build_ckks_conv2d",
    "build_ckks_conv2d_mc",
    "build_ckks_dense_layer",
    "build_ckks_inverse",
    "build_ckks_logreg",
    "build_ckks_logreg_train_step",
    "build_ckks_matmul_square",
    "build_ckks_matvec",
    "build_ckks_matvec_bsgs",
    "build_ckks_max",
    "build_ckks_mlp",
    "build_ckks_mul_relin_rescale",
    "build_ckks_poly_eval",
    "build_ckks_relu",
    "build_ckks_rotate",
    "build_ckks_rotate_many",
    "build_ckks_rsqrt",
    "build_ckks_sign",
    "build_ckks_sqrt",
    "build_ckks_train_step",
    "prepermute_galois_stack",
    "sign_composite_reference",
    "strided_dense_diagonals",
    "entry",
]
