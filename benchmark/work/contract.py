"""K3 contract: work of out[.., g, j, n] = sum_k A'[.., g|0, k, j|0, n] W[g, k, j, n|0]
mod p_j (the key switch's mod-up and its key inner products, the fast base
conversions).

Only the input rows k that some weight (and pre-scale) keeps count: a row
whose weights are all 0 adds nothing to any output.  Bytes: those rows of
A and W in once (A once however many groups read it), the output out once.
IMADs: per output a 64 x 64 -> 128-bit multiply-add (7) a kept row and one
128-bit Barrett reduction (24); a pre-scale A' = A s mod q once per kept
input element and group, as a Shoup product (10)."""

WRAPPERS = {"gemini_seal_tpu_torch.ops.modops": ("contract_mulmod_128",)}
IMAD_MAC = 7
IMAD_BARRETT128 = 24
IMAD_SHOUP = 10


def _arg(args, kwargs, i, name):
    return args[i] if len(args) > i else kwargs.get(name)


def work(fn_name, args, kwargs, result):
    a, w = args[0], args[1]
    prescale = _arg(args, kwargs, 5, "prescale")
    G, K = w.shape[0], w.shape[1]
    live = w.reshape(G, K, -1).ne(0).any(-1).any(0)                      # [K]
    if prescale is not None:
        live &= prescale[0].reshape(G, K).ne(0).any(0)
    kept = int(live.sum())
    nbytes = 8 * ((a.numel() + w.numel()) * kept // K + result.numel())
    imads = result.numel() * (kept * IMAD_MAC + IMAD_BARRETT128)
    if prescale is not None:
        per_group = a.numel() // K * kept
        imads += per_group * IMAD_SHOUP * (G if a.shape[-4] == 1 else 1)
    return nbytes, imads
