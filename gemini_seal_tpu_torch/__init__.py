"""gemini_seal_tpu_torch: the PyTorch/CUDA port of gemini_seal_tpu.

Residues are int64 tensors holding u64 values; every modular-arithmetic
stage on the card is a hand-written CUDA kernel for Hopper (sm_90a) under
``csrc/``, built with nvcc at first use, with a plain PyTorch version
beside it that runs for CPU tensors.  Entry points take ``device`` (None
means the card, and raises when none is present).

Ported so far: keygen (secret, public, relin and Galois keys), public-key
encrypt and decrypt for BFV and CKKS; the CKKS vector and scalar encode
and decode, multiply + relinearize + rescale (fused and sequential),
rotate, hoisted multi-rotation (plain and counter-rotated keys), the
flagship train step (multiply + relinearize + rescale, rotate, add;
``entry()``) and the deep polynomial evaluation; the BFV BatchEncoder, the
BEHZ multiply + relinearize, its mod-switch chain, the power-basis Galois
automorphism and the hoisted row rotations.  Every ring degree up to
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
from .encoders import BatchEncoder, CKKSEncoder
from .models.pipelines import (build_bfv_mul_relin, build_bfv_mul_relin_modswitch,
                               build_bfv_rotate_many, build_ckks_mul_relin_rescale,
                               build_ckks_poly_eval, build_ckks_rotate,
                               build_ckks_rotate_many, build_ckks_train_step,
                               prepermute_galois_stack)
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
    "BatchEncoder",
    "CKKSEncoder",
    "build_bfv_mul_relin",
    "build_bfv_mul_relin_modswitch",
    "build_bfv_rotate_many",
    "build_ckks_mul_relin_rescale",
    "build_ckks_poly_eval",
    "build_ckks_rotate",
    "build_ckks_rotate_many",
    "build_ckks_train_step",
    "prepermute_galois_stack",
    "entry",
]
