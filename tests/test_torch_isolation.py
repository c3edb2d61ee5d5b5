"""The PyTorch port stands alone.

No file of gemini_seal_tpu_torch/ and no part of chip_smoke.py imports jax
or gemini_seal_tpu; importing the port leaves jax out of sys.modules; with
no card present an entry point called without ``device`` raises; and
chip_smoke.py's CPU rehearsal runs end to end.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gemini_seal_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "gemini_seal_tpu"), (path, name)


def test_import_leaves_jax_out():
    code = ("import sys, gemini_seal_tpu_torch, gemini_seal_tpu_torch.convert; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gemini_seal_tpu')))")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import gemini_seal_tpu_torch as T

    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(256)
    parms.set_coeff_modulus(T.CoeffModulus.create(256, [40, 30, 40]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.SealContext(parms, sec_level=T.SecLevelType.none)
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none, device="cpu")
    for make in (lambda: T.KeyGenerator(ctx),
                 lambda: T.CKKSEncoder(ctx),
                 lambda: T.build_ckks_mul_relin_rescale(ctx),
                 lambda: T.build_ckks_rotate(ctx, 1),
                 lambda: T.build_ckks_rotate_many(ctx, [1, 2]),
                 lambda: T.build_ckks_train_step(ctx),
                 lambda: T.entry()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    kg = T.KeyGenerator(ctx, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Encryptor(ctx, kg.public_key())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Decryptor(ctx, kg.secret_key)


def test_chip_smoke_cpu_rehearsal():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "chip_smoke.py", "--cpu-rehearsal"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "rehearsal": "cpu"}
    kernels = json.loads(lines[-2])["kernels"]
    assert sorted(k["name"] for k in kernels) == ["contract", "elementwise", "galois", "ntt",
                                                  "tensor_product"]
    forms = [json.loads(l)["form"] for l in lines if '"batch2"' in l]
    assert forms == ["multiply", "square", "sequential_multiply", "train_step", "rotate_many"]
    paths = [json.loads(l)["path"] for l in lines if '"main_path"' in l]
    assert paths == ["mul_relin_rescale", "train_step", "rotate_many"]


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
