"""Small rings for the CPU tests: each cell's configuration and mix with the
ring cut to N=1024 (security none), a few rows and two rotations, so that a
whole run, window and check, takes a second or two on the plain versions."""

from gemini_seal_tpu_torch.modulus import CoeffModulus

CELLS = ("ckks16k.mul_relin_rescale", "bfv8k.mul_relin", "ckks16k.rotate_many8",
         "bfv8k.rotate_many8")


def overrides(cell: str) -> dict:
    if cell.startswith("ckks"):
        cfg = {"poly_modulus_degree": 1024, "security": "none",
               "coeff_modulus": [m.value for m in CoeffModulus.create(1024, [50, 40, 40, 50])]}
    else:
        cfg = {"poly_modulus_degree": 1024, "security": "none",
               "coeff_modulus": [m.value for m in CoeffModulus.create(1024, [44, 44, 44])]}
    traffic = {"batch": 4}
    if "rotate" in cell:
        traffic["steps"] = [1, 3]
    return {"config": cfg, "traffic": traffic}
