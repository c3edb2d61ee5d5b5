"""K5 galois: work of a Galois permutation (with or without the power
basis's sign flip, paired or not).  A permutation: the input rows in once,
every permuted row out once, no multiply (the index tables are constants
that an implementation may compute)."""

WRAPPERS = {"gemini_seal_tpu_torch.ops.galois": ("galois_permute",)}


def work(fn_name, args, kwargs, result):
    return 8 * (args[0].numel() + result.numel()), 0
