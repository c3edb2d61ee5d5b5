"""The PyTorch port stands alone.

No file of gemini_seal_tpu_torch/ and no part of chip_smoke.py imports jax
or gemini_seal_tpu; importing the port, the bootstrap, EvalMod and the
Evaluator, the DeviceEvaluator and the rest of ops/dyadic.py included,
leaves jax out of sys.modules, and so does importing the multi-device
schedules of parallel/, K11's ops/ntt_sp.py and K12's ops/ntt_mxu.py, and
the host plane's serialization, valcheck, metrics, biguint,
utils/polyarith and the wire-to-wire server; every kernel source (K1-K12)
is registered and documented; with no card present an entry point called
without ``device`` raises (the server and the loaders without a context
included); and chip_smoke.py's CPU rehearsal runs its thirty-five paths end
to end.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch
from torch_helpers import one_torch_thread  # noqa: F401

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
    code = ("import sys, gemini_seal_tpu_torch, gemini_seal_tpu_torch.convert, "
            "gemini_seal_tpu_torch.evaluator, gemini_seal_tpu_torch.models.bootstrap, "
            "gemini_seal_tpu_torch.models.evalmod, gemini_seal_tpu_torch.ops.modraise, "
            "gemini_seal_tpu_torch.models.device_evaluator, gemini_seal_tpu_torch.ops.dyadic, "
            "gemini_seal_tpu_torch.ops.ntt_sp, gemini_seal_tpu_torch.parallel.comm, "
            "gemini_seal_tpu_torch.parallel.mesh, gemini_seal_tpu_torch.parallel.ntt_sp, "
            "gemini_seal_tpu_torch.parallel.keyswitch_sp, "
            "gemini_seal_tpu_torch.parallel.pipeline_csp, gemini_seal_tpu_torch.parallel.behz_sp, "
            "gemini_seal_tpu_torch.parallel.bootstrap_sp, gemini_seal_tpu_torch.ops.ntt_mxu, "
            "gemini_seal_tpu_torch.serialization, gemini_seal_tpu_torch.valcheck, "
            "gemini_seal_tpu_torch.metrics, gemini_seal_tpu_torch.biguint, "
            "gemini_seal_tpu_torch.utils.polyarith, gemini_seal_tpu_torch.models.serving; "
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
    from gemini_seal_tpu_torch.models.bootstrap import build_ckks_bootstrap
    from gemini_seal_tpu_torch.models.evalmod import ChebyEvalMod

    diags = {0: [0.5], 1: [0.25]}
    cds = [ctx.first_context_data()]
    for make in (lambda: T.build_ckks_matvec(ctx, diags, 2.0 ** 20, encoder),
                 lambda: T.build_ckks_matvec_bsgs(ctx, diags, 2.0 ** 20, encoder),
                 lambda: T.build_ckks_dense_layer(ctx, diags, [0.0], 2.0 ** 20, encoder,
                                                  activation=None),
                 lambda: T.build_ckks_mlp(ctx, [(diags, [0.0], None)], 2.0 ** 20, encoder),
                 lambda: T.build_ckks_conv2d(ctx, [[0.5]], 2, 2, 2.0 ** 20, encoder),
                 lambda: T.build_ckks_conv2d_mc(ctx, [[[[0.5]]]], 2, 2, 2.0 ** 20, encoder),
                 lambda: T.build_ckks_cnn(ctx, [], [(diags, [0.0], None)], 2, 2, 2.0 ** 20,
                                          encoder),
                 lambda: T.build_ckks_logreg(ctx, [0.5], 0.0, 2.0 ** 20, encoder),
                 lambda: T.build_ckks_logreg_train_step(ctx, 2, 2, [0, 1], 0.1, 2.0 ** 20,
                                                        encoder),
                 lambda: T.build_ckks_inverse(ctx, 2.0 ** 20, encoder, iters=1),
                 lambda: T.build_ckks_rsqrt(ctx, 2.0 ** 20, encoder, iters=1),
                 lambda: T.build_ckks_sqrt(ctx, 2.0 ** 20, encoder, iters=1),
                 lambda: T.build_ckks_sign(ctx, 2.0 ** 20, encoder),
                 lambda: T.build_ckks_relu(ctx, 2.0 ** 20, encoder),
                 lambda: T.build_ckks_max(ctx, 2.0 ** 20, encoder),
                 lambda: T.build_ckks_matmul_square(ctx, 2, 2.0 ** 20, encoder),
                 lambda: T.build_ckks_attention(ctx, 2, 2.0 ** 20, encoder),
                 lambda: build_ckks_bootstrap(ctx, 2.0 ** 20, encoder),
                 lambda: ChebyEvalMod(ctx, cds, [1], [None], [1], encoder, 0, 2.0 ** 20,
                                      [0.0, 1.0], 1, False),
                 lambda: T.Evaluator(ctx),
                 lambda: T.DeviceEvaluator(ctx),
                 lambda: T.Plaintext.from_hex("1x^2 + 3"),
                 lambda: T.Plaintext.from_coeffs([1, 2])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Encryptor(ctx, kg.public_key())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Encryptor(ctx, secret_key=kg.secret_key)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Decryptor(ctx, kg.secret_key)
    # the wire format: the loaders place data on the card unless a context or
    # a device says otherwise, and the server runs on the card
    from gemini_seal_tpu_torch import serialization as ser
    from gemini_seal_tpu_torch.models.serving import EncryptedComputeServer

    enc = T.Encryptor(ctx, kg.public_key(), device="cpu")
    ct = enc.encrypt(encoder.encode([0.5], 2.0 ** 20))
    blob = ser.save(ct)
    for make in (lambda: ser.load_ciphertext(blob),
                 lambda: ser.load_plaintext(ser.save(encoder.encode([0.5], 2.0 ** 20))),
                 lambda: ser.load_secret_key(ser.save(kg.secret_key)),
                 lambda: ser.load_public_key(ser.save(kg.public_key())),
                 lambda: ser.load_relin_keys(ser.save(kg.relin_keys())),
                 lambda: EncryptedComputeServer(ctx, lambda c: c, [], ct.parms_id, True, 1.0, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert ser.load_ciphertext(blob, device="cpu").data.device.type == "cpu"
    assert ser.load_ciphertext(blob, ctx).data.device.type == "cpu"
    from gemini_seal_tpu_torch.ops.ntt_mxu import build_mxu_ntt_tables
    from gemini_seal_tpu_torch.parallel.bootstrap_sp import build_ckks_matvec_limb_sharded
    from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd

    for make in (lambda: ThreadGroup(4),
                 lambda: run_spmd(lambda g: None, 4),
                 lambda: build_ckks_matvec_limb_sharded(ctx, diags, 2.0 ** 20, encoder, 1),
                 lambda: build_mxu_ntt_tables(8, ctx.first_context_data().parms.coeff_modulus)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


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
                 lambda: T.build_bfv_rotate_many(ctx, [1], prepermuted_keys=True),
                 lambda: T.build_bfv_matvec(ctx, {1: [1]}, None),
                 lambda: T.IntegerEncoder(ctx),
                 lambda: T.Evaluator(ctx),
                 lambda: T.DeviceEvaluator(ctx)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_chip_smoke_cpu_rehearsal():
    # one torch thread, as in the rest of the port's CPU tests (torch_helpers.py)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--cpu-rehearsal"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "rehearsal": "cpu"}
    kernels = json.loads(lines[-2])["kernels"]
    assert sorted(k["name"] for k in kernels) == ["behz", "contract", "elementwise", "galois",
                                                  "infty_norm", "mod_raise", "negacyclic",
                                                  "ntt", "ntt_mxu", "ntt_sp", "scale_round",
                                                  "tensor_product"]
    forms = [json.loads(l)["form"] for l in lines if '"batch2"' in l]
    assert forms == ["multiply", "square", "sequential_multiply", "train_step", "rotate_many",
                     "rotate_many_prepermuted", "bfv_chain_fused_drop",
                     "bfv_chain_per_level_drop", "bfv_multiply_n8192", "bfv_square_n8192",
                     "bfv_multiply_n4096", "bfv_rotate_rows", "bfv_rotate_columns",
                     "bfv_rotate_many", "bfv_rotate_many_prepermuted",
                     "ckks_mul_relin_rescale_n16384", "ckks_poly_eval_n32768", "n65536",
                     "bootstrap_n4096", "dense8x8_n8192", "dense_layer8x8_n8192",
                     "dense_layer8x8_bsgs_n8192", "cnn16x16_n4096", "bfv_matvec8x8_n8192",
                     "relu_n8192", "max_n8192", "sqrt_n8192", "matmul_d32_n2048",
                     "attention_d32_n2048", "attention_d16_n512", "attention_heads4_d4_n128"]
    paths = [json.loads(l) for l in lines if '"main_path"' in l]
    assert [p["path"] for p in paths] == ["mul_relin_rescale", "train_step", "rotate_many",
                                          "bfv_mul_relin_chain", "bfv_mul_relin",
                                          "bfv_rotate_rows", "bfv_rotate_many",
                                          "ckks_mul_relin_rescale_n16384",
                                          "ckks_poly_eval_n32768", "n65536",
                                          "bootstrap_n4096", "dense8x8_n8192",
                                          "per_op_bfv_n4096", "per_op_bfv_n8192_levels",
                                          "per_op_ckks", "device_evaluator_n8192",
                                          "ntt_sp4_n65536", "ntt_sp4_n16384",
                                          "ckks_mul_relin_rescale_csp4_n16384",
                                          "ckks_mul_relin_rescale_limb4_n4096",
                                          "bfv_mul_relin_behz4_n8192", "matvec_limb4_n4096",
                                          "ntt_mxu_n16384", "ntt_mxu_n8192",
                                          "dense_layer8x8_n8192", "cnn16x16_n4096",
                                          "bfv_matvec8x8_n8192", "logreg_train_m64_f16_n8192",
                                          "logreg_f16_n8192", "inverse_ex14_n256",
                                          "relu_n8192", "matmul_d32_n2048",
                                          "attention_d32_n2048", "attention_d16_n512",
                                          "serving_dense8x8_n8192"]
    assert all(p["decode_exact"] for p in paths[3:7])
    assert paths[6]["key_forms_decode_equal"]
    assert paths[2]["max_abs_decode_diff_between_key_forms"] < 1e-5
    assert paths[8]["max_abs_decode_err"] < 1e-3 and paths[9]["ntt_round_trip_exact"]
    assert paths[10]["max_err"] < 1e-6 and paths[10]["levels_restored"] == 3
    assert paths[11]["max_abs_decode_err"] < 1e-4
    # the per-op API: each example's checks (the rehearsal's rings are N=256,
    # so the digests and budgets of the examples' own rings are the card's)
    for p in paths[12:16]:
        assert p["checks"] and all(p["checks"].values()), p
    assert paths[12]["ex1_decrypts"] == 84 and paths[12]["ex2_integer_sum"] == -2
    assert paths[13]["degree"] == 8
    # the schedules on four threads: each equal to the single-card path, with
    # the JAX package's collective profile
    for p in paths[16:22]:
        assert (p["ranks"], p["group"], p["cards"]) == (4, "threads", 1)
        assert p["equal_to_single_card"] and all(p["equal_to_single_card"].values()), p
    for p in paths[16:18]:
        assert p["collectives"]["count"] == {"collective-permute": 4, "all-to-all": 4}
    assert paths[18]["collectives"]["mul_relin_rescale"]["count"] == {"all-to-all": 16}
    assert paths[19]["collectives"]["mul_relin_rescale"]["count"] == {"all-gather": 1,
                                                                      "all-reduce": 1}
    assert paths[19]["collectives"]["rotate_many"]["count"] == {"all-gather": 1}
    assert paths[20]["collectives"]["count"] == {"all-gather": 5} and paths[20]["decode_exact"]
    assert paths[21]["collectives"]["count"] == {"all-gather": 1}
    # the four-step int8 NTT at N=1024: equal to K1 both ways, exact round trip
    for p in paths[22:24]:
        assert p["equal_to_k1"] == {"forward": True, "inverse": True, "round_trip": True}, p
    # the model zoo: each decode within its source's tolerance (the CNN's
    # batch rows equal), the BFV matvec exact, the train step at the input scale
    assert paths[24]["max_abs_decode_err"] < 1e-3
    assert paths[25]["max_abs_decode_err"] < 1e-2 and paths[25]["rows_equal"]
    assert paths[26]["decode_exact"]
    assert paths[27]["max_abs_decode_err"] < 1e-2 and paths[27]["out_scale_is_input_scale"]
    assert paths[28]["max_abs_decode_err"] < 1e-2
    assert paths[29]["max_abs_decode_err"] < 2e-2 and paths[29]["levels_consumed"] == 5
    # the comparison builders, the matmul and attention: ReLU within 1e-2 of
    # x (1 + sign(x)) / 2 (its batch rows equal), max within 2e-2 of
    # np.maximum off the sign gap, sqrt within 2e-3 relative, the matmul
    # within 1e-2 of A @ B, attention within 1e-2 and four heads within 1e-3
    # of the numpy attention
    assert paths[30]["max_abs_decode_err"] < 1e-2 and paths[30]["rows_equal"]
    assert paths[30]["forms"]["max"]["max_abs_decode_err"] < 2e-2
    assert paths[30]["forms"]["sqrt"]["max_rel_decode_err"] < 2e-3
    assert paths[31]["max_abs_decode_err"] < 1e-2
    for p in paths[32:34]:
        assert p["max_abs_decode_err"] < 1e-2 and p["levels"] == 14 + p["goldschmidt_iters"], p
    assert paths[33]["forms"]["heads4"]["max_abs_decode_err"] < 1e-3
    # the wire-to-wire server: every served blob equal to the step's own output
    # saved, the seeded blobs expanded to the drawn c1, decrypt_batch equal to
    # decrypt, ex6's flow with the JAX package's digests (its ring is the
    # card's), and the timed runs' blobs equal
    assert paths[34]["max_abs_decode_err"] < 1e-3
    assert paths[34]["checks"] and all(paths[34]["checks"].values()), paths[34]
    (serving,) = [json.loads(l) for l in lines if '"phase": "serving"' in l]
    assert serving["equal"] and all(serving["equal"].values()), serving
    assert 0.45 < serving["ingress_bytes_ratio_seeded_to_full"] < 0.55
    for form in [json.loads(l) for l in lines if '"batch2"' in l][20:]:
        assert form["equal_to_plain"] and (form.get("decode_exact")
                                           or form["max_abs_decode_err"] < 1e-2), form
    assert [json.loads(l)["ran"] for l in lines if '"nccl"' in l] == [False]


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
