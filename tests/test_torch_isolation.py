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


def _kernel_sources():
    return sorted(f for f in os.listdir(os.path.join(PKG, "csrc")) if f.endswith(".cu"))


@pytest.mark.parametrize("source", _kernel_sources())
def test_every_kernel_source_is_built_and_documented(source):
    """Each csrc/*.cu is one registered kernel (ops/cuda.py KERNELS) that
    exports its C entry point, includes no PyTorch header, and says which
    JAX function it replaces and what bounds it on the card."""
    from gemini_seal_tpu_torch.ops import cuda

    names = [k for k, v in cuda.KERNELS.items() if v[0] == source]
    assert len(names) == 1, (source, names)
    with open(os.path.join(PKG, "csrc", source)) as fh:
        text = fh.read()
    assert f'extern "C" int {cuda.KERNELS[names[0]][1]}(' in text
    assert "torch/" not in text and "ATen" not in text
    assert "Replaces" in text and "gemini_seal_tpu/" in text
    assert "Bound on the H100" in text


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
                 lambda: T.build_ckks_rotate_many(ctx, [1, 2], prepermuted_keys=True),
                 lambda: T.build_ckks_train_step(ctx),
                 lambda: T.entry()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    kg = T.KeyGenerator(ctx, device="cpu")
    encoder = T.CKKSEncoder(ctx, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build_ckks_poly_eval(ctx, [1.0, 0.5, 0.25], 2.0 ** 20, encoder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Encryptor(ctx, kg.public_key())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Decryptor(ctx, kg.secret_key)


def test_bfv_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import gemini_seal_tpu_torch as T

    parms = T.EncryptionParameters(T.SchemeType.BFV)
    parms.set_poly_modulus_degree(256)
    parms.set_coeff_modulus(T.CoeffModulus.create(256, [40, 40, 40]))
    parms.set_plain_modulus(T.PlainModulus.batching(256, 20))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.SealContext(parms, sec_level=T.SecLevelType.none)
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none, device="cpu")
    assert ctx.parameters_set() and ctx.device.type == "cpu"
    for make in (lambda: T.BatchEncoder(ctx),
                 lambda: T.build_bfv_mul_relin(ctx),
                 lambda: T.build_bfv_mul_relin(ctx, square=True),
                 lambda: T.build_bfv_mul_relin_modswitch(ctx),
                 lambda: T.build_bfv_mul_relin_modswitch(ctx, fused_drop=False),
                 lambda: T.build_bfv_rotate_many(ctx, [1, 2]),
                 lambda: T.build_bfv_rotate_many(ctx, [1], prepermuted_keys=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_chip_smoke_cpu_rehearsal():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "chip_smoke.py", "--cpu-rehearsal"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "rehearsal": "cpu"}
    kernels = json.loads(lines[-2])["kernels"]
    assert sorted(k["name"] for k in kernels) == ["behz", "contract", "elementwise", "galois",
                                                  "ntt", "scale_round", "tensor_product"]
    forms = [json.loads(l)["form"] for l in lines if '"batch2"' in l]
    assert forms == ["multiply", "square", "sequential_multiply", "train_step", "rotate_many",
                     "rotate_many_prepermuted", "bfv_chain_fused_drop",
                     "bfv_chain_per_level_drop", "bfv_multiply_n8192", "bfv_square_n8192",
                     "bfv_multiply_n4096", "bfv_rotate_rows", "bfv_rotate_columns",
                     "bfv_rotate_many", "bfv_rotate_many_prepermuted",
                     "ckks_mul_relin_rescale_n16384", "ckks_poly_eval_n32768", "n65536"]
    paths = [json.loads(l) for l in lines if '"main_path"' in l]
    assert [p["path"] for p in paths] == ["mul_relin_rescale", "train_step", "rotate_many",
                                          "bfv_mul_relin_chain", "bfv_mul_relin",
                                          "bfv_rotate_rows", "bfv_rotate_many",
                                          "ckks_mul_relin_rescale_n16384",
                                          "ckks_poly_eval_n32768", "n65536"]
    assert all(p["decode_exact"] for p in paths[3:7])
    assert paths[6]["key_forms_decode_equal"]
    assert paths[2]["max_abs_decode_diff_between_key_forms"] < 1e-5
    assert paths[8]["max_abs_decode_err"] < 1e-3 and paths[9]["ntt_round_trip_exact"]


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
