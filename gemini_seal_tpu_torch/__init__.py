"""gemini_seal_tpu_torch: the PyTorch/CUDA port of gemini_seal_tpu.

Residues are int64 tensors holding u64 values; every modular-arithmetic
stage on the card is a hand-written CUDA kernel for Hopper (sm_90a) under
``csrc/``, built with nvcc at first use, with a plain PyTorch version
beside it that runs for CPU tensors.  Entry points take ``device`` (None
means the card, and raises when none is present).

This slice ports the CKKS path of bench.py: keygen, encode, public-key
encrypt, the fused multiply + relinearize + rescale step, decrypt, decode.
"""

from .modulus import CoeffModulus, Modulus, SecLevelType
from .params import EncryptionParameters, SchemeType
from .context import SealContext
from .ciphertext import Ciphertext, Plaintext
from .keys import KSwitchKeys, PublicKey, RelinKeys, SecretKey
from .keygenerator import KeyGenerator
from .encryptor import Encryptor
from .decryptor import Decryptor
from .encoders import CKKSEncoder
from .models.pipelines import build_ckks_mul_relin_rescale

__all__ = [
    "CoeffModulus",
    "Modulus",
    "SecLevelType",
    "EncryptionParameters",
    "SchemeType",
    "SealContext",
    "Ciphertext",
    "Plaintext",
    "KSwitchKeys",
    "PublicKey",
    "RelinKeys",
    "SecretKey",
    "KeyGenerator",
    "Encryptor",
    "Decryptor",
    "CKKSEncoder",
    "build_ckks_mul_relin_rescale",
]
