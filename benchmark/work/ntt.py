"""K1 ntt: work of the negacyclic NTT, forward and inverse.

Each call transforms the rows of x [..., L, N]: the rows in once and out
once (the twiddles are constants that an implementation may compute), and
N/2 log2 N butterflies a row, each one modular multiply at a Shoup
product's 10 IMADs, the cheapest form the program uses (the inverse's N^-1
factor, which can be folded into the last stage's twiddles, is not
counted)."""

WRAPPERS = {"gemini_seal_tpu_torch.ops.ntt": ("ntt_forward", "ntt_forward_lazy", "ntt_inverse",
                                               "ntt_inverse_lazy")}
IMAD_SHOUP = 10


def work(fn_name, args, kwargs, result):
    """(bytes, 32-bit IMADs) the call needs."""
    x = args[0]
    n = x.shape[-1]
    rows = x.numel() // n
    return 8 * (x.numel() + result.numel()), rows * (n // 2) * (n.bit_length() - 1) * IMAD_SHOUP
