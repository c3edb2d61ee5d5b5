"""K6 behz: work of BEHZ's two RNS steps.

sm_mrq (Montgomery reduction by m~): x [.., Bsk + 1, N] in, [.., Bsk, N] out;
r = -x_m~ q^-1 mod m~ once a coefficient (a 64-bit low-word product, 3
IMADs), then x_j m~^-1 + r (q m~^-1) a output: two Shoup products (10
each).  sk_tail (the Shenoy-Kumaresan correction): x [.., L + 1, N] and the
m_sk row of aux in, [.., L, N] out; alpha once a coefficient and one
product an output, each a Shoup product."""

WRAPPERS = {"gemini_seal_tpu_torch.ops.rnsops": ("behz",)}
IMAD_SHOUP = 10
IMAD_LOW64 = 3


def work(fn_name, args, kwargs, result):
    mode, x = args[0], args[1]
    coeffs = result.numel() // result.shape[-2]
    if mode == "sm_mrq":
        return (8 * (x.numel() + result.numel()),
                coeffs * IMAD_LOW64 + result.numel() * 2 * IMAD_SHOUP)
    return (8 * (x.numel() + coeffs + result.numel()),
            (result.numel() + coeffs) * IMAD_SHOUP)
