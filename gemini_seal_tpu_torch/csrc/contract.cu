// K3: 128-bit-exact multiply-accumulate contraction with one Barrett reduction.
//
// Replaces gemini_seal_tpu/ops/modops.py accumulate_mulmod_128
// (modops.py:218-254) at its three call sites on the CKKS key-switch path:
// the mod-up CRT lift in compute_modup_digits (ops/keyswitch.py:333-340, with
// the punctured-inverse mul_mod before it folded in as the pre-scale), the key
// inner product in keyswitch_inner_product (:368-371), and _dot_mod_128
// (ops/rnsops.py:70-84, with fused_moddown's inv_hat mul_mod folded in).  XLA
// lowers these as four 32-bit digit planes summed per term, then a renormalise
// and a Barrett pass.
//
//   out[r, g, j, n] = sum_k A'[r, g|0, k, j|0, n] * W[g, k, j, n|0]  mod p_j
//   A' = A * s[g, k] mod q[g, k] when a pre-scale is given
//
// With A's group axis at size 1 (a_has_g = 0) one input is broadcast over the
// G groups with stride 0: the contraction of _shared_digit_inner_product
// (models/pipelines.py:318-336), the shared mod-up digits against R
// counter-rotated keys, reads the digits in place rather than R copies.
//
// Bound on the H100: per output K 64x64->128 products (7 IMADs each) plus
// one Barrett (24), and one pre-scale mul_mod per input; the bytes are one
// read of A and W and one write of out.  At the main path's K <= 3 the bytes
// set the bound.  This simple form recomputes the pre-scale for each of the
// J outputs of an input (PERF.md, open questions).
//
// Design: one thread per output coefficient in a grid-stride loop; the sum is
// kept exact in a register pair (hi:lo with carry), which equals the JAX
// digit-plane sum whenever that is below 2^128 (KeySwitchPlan.lazy_digits
// keeps that true), so the canonical result is bit-identical.  Constant
// weights have N stride 0 and stay in L1; key rows are read coalesced.
#include "modops.cuh"

template <bool A_HAS_G>
__global__ void contract_kernel(u64* __restrict__ out, const u64* __restrict__ A,
                                const u64* __restrict__ W,
                                const u64* __restrict__ mod, const u64* __restrict__ r0s,
                                const u64* __restrict__ r1s,
                                const u64* __restrict__ s, const u64* __restrict__ sq,
                                const u64* __restrict__ sr0, const u64* __restrict__ sr1,
                                long long total, int G, int K, int J, int a_has_j, int n,
                                int w_has_n) {
    const int ja = a_has_j ? J : 1;
    const int wn = w_has_n ? n : 1;
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int c = (int)(idx % n);
        long long t = idx / n;
        const int j = (int)(t % J);
        t /= J;
        const int g = (int)(t % G);
        const long long rg = A_HAS_G ? t : t / G;  // r * G + g, or r when broadcast
        const u64* a_row = A + (rg * K * ja + (a_has_j ? j : 0)) * (long long)n + c;
        const u64* w_row = W + ((long long)g * K * J + j) * wn + (w_has_n ? c : 0);
        u64 hi = 0, lo = 0;
        for (int k = 0; k < K; ++k) {
            u64 a = a_row[(long long)k * ja * n];
            if (s != nullptr) {
                const int gk = g * K + k;
                a = mul_mod(a, s[gk], sq[gk], sr0[gk], sr1[gk]);
            }
            mac128(hi, lo, a, w_row[(long long)k * J * wn]);
        }
        out[idx] = barrett_reduce_128(hi, lo, mod[j], r0s[j], r1s[j]);
    }
}

// out [R, G, J, N]; A [R, G or 1, K, Ja, N]; W [G, K, J, Nw]; mod/r0/r1 [J];
// s/sq/sr0/sr1 [G, K] or all NULL.
extern "C" int gst_contract(void* out, const void* A, const void* W,
                            const void* mod, const void* r0, const void* r1,
                            const void* s, const void* sq, const void* sr0, const void* sr1,
                            long long R, long long G, long long K, long long J,
                            long long a_has_j, long long a_has_g, long long n,
                            long long w_has_n, void* stream) {
    const long long total = R * G * J * n;
    const int threads = 256;
    auto kernel = a_has_g ? contract_kernel<true> : contract_kernel<false>;
    kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)A, (const u64*)W, (const u64*)mod, (const u64*)r0,
        (const u64*)r1, (const u64*)s, (const u64*)sq, (const u64*)sr0, (const u64*)sr1,
        total, (int)G, (int)K, (int)J, (int)a_has_j, (int)n, (int)w_has_n);
    return (int)cudaGetLastError();
}
