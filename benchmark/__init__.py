"""The benchmark of gemini_seal_tpu_torch on one CUDA card (see README.md)."""
