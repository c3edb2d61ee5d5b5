// K6: the two BEHZ steps of the BFV multiply that are not a base conversion.
//
// Replaces, in gemini_seal_tpu/ops/rnsops.py:
//   mode 0 sm_mrq (rnsops.py:329-353): Montgomery reduction from
//     Bsk u {m_tilde} to Bsk.  From the m_tilde row, r = -x_mt * q^-1 mod
//     m_tilde with m_tilde = 2^32 (a mask, not a Barrett), centred against
//     m_tilde/2; then (x_j + q * r) exactly in 128 bits, barrett_reduce_128,
//     times m_tilde^-1 mod p_j.  x [R, Bsk+1, N] -> out [R, Bsk, N].
//   mode 1 sk_tail (rnsops.py:378-397, the Shenoy-Kumaresan correction of
//     fastbconv_sk): conv [R, L+1, N] is the B -> q u {m_sk} conversion
//     (rows 0..L-1 onto q, row L onto m_sk, one contract launch before this
//     one) and aux [R, Bsk, N] is x_bsk, whose last row is x_sk.
//     alpha = (conv_msk - x_sk) * B^-1 mod m_sk, computed as the JAX
//     function does: the u64 conv_msk + (m_sk - x_sk), un-reduced, into
//     one full-range mul_mod; then dest_l + prod_B * (m_sk - alpha) mod q_l
//     when alpha > m_sk/2, else dest_l + (q_l - prod_B) * alpha mod q_l.
//     XLA computes both branch products and selects; this kernel computes
//     the selected one, which is the same canonical value.
//
// Bound on the H100: sm_mrq reads Bsk+1 rows and writes Bsk (at the main
// path's [128, 2, 6, 8192] input, 96 MiB in and 80 MiB out) and does one
// 128-bit product, one barrett_reduce_128 and one mul_mod (~62 32-bit IMADs)
// per output; sk_tail reads L+1 rows and the x_sk row and writes L, with two
// mul_mods per output.  The bytes set the bound in both modes.
//
// Design: one thread per output coefficient in a grid-stride loop, as K4.
// The row read by every output of a coefficient (the m_tilde row, the m_sk
// row, x_sk) is read once per output limb; the L1 cache serves the repeats.
// The constants are one packed u64 array (layout below), indexed by limb.
#include "modops.cuh"

// consts, mode 0: p[B1], r0[B1], r1[B1], prod_q_mod_Bsk[B1], inv_m_tilde[B1],
//                 inv_prod_q_mod_m_tilde            (B1 = Bsk = rows out)
__global__ void sm_mrq_kernel(u64* __restrict__ out, const u64* __restrict__ x,
                              const u64* __restrict__ k, long long total, int bsk, int n) {
    const u64 inv_q_mt = k[5 * bsk];
    const u64 m_tilde = 1ULL << 32;
    const u64 mask = m_tilde - 1;
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int c = (int)(idx % n);
        const long long t = idx / n;
        const int j = (int)(t % bsk);
        const long long r = t / bsk;
        const u64* row = x + r * (long long)(bsk + 1) * n + c;
        const u64 x_mt = row[(long long)bsk * n];
        const u64 x_j = row[(long long)j * n];
        const u64 p = k[j], r0 = k[bsk + j], r1 = k[2 * bsk + j];
        u64 rr = (x_mt * inv_q_mt) & mask;
        rr = (m_tilde - rr) & mask;
        // centred: r >= m_tilde/2 stands for r - m_tilde, i.e. r + (p - m_tilde) mod p
        if (rr >= (m_tilde >> 1)) rr += p - m_tilde;
        const u64 pq = k[3 * bsk + j];
        const u64 lo = pq * rr;
        const u64 hi = __umul64hi(pq, rr);
        const u64 s_lo = lo + x_j;
        const u64 s_hi = hi + (u64)(s_lo < lo);
        const u64 acc = barrett_reduce_128(s_hi, s_lo, p, r0, r1);
        out[idx] = mul_mod(acc, k[4 * bsk + j], p, r0, r1);
    }
}

// consts, mode 1: p[L], r0[L], r1[L], prod_B_mod_q[L], m_sk, m_sk_r0, m_sk_r1,
//                 inv_prod_B_mod_m_sk               (L = rows out)
__global__ void sk_tail_kernel(u64* __restrict__ out, const u64* __restrict__ conv,
                               const u64* __restrict__ xbsk, const u64* __restrict__ k,
                               long long total, int L, int bsk, int n) {
    const u64 m_sk = k[4 * L], ms_r0 = k[4 * L + 1], ms_r1 = k[4 * L + 2];
    const u64 inv_b = k[4 * L + 3];
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int c = (int)(idx % n);
        const long long t = idx / n;
        const int l = (int)(t % L);
        const long long r = t / L;
        const u64* crow = conv + r * (long long)(L + 1) * n + c;
        const u64 dest = crow[(long long)l * n];
        const u64 to_msk = crow[(long long)L * n];
        const u64 x_sk = xbsk[(r * bsk + (bsk - 1)) * (long long)n + c];
        const u64 alpha = mul_mod(to_msk + (m_sk - x_sk), inv_b, m_sk, ms_r0, ms_r1);
        const u64 p = k[l], r0 = k[L + l], r1 = k[2 * L + l], pb = k[3 * L + l];
        const u64 term = alpha > (m_sk >> 1) ? mul_mod(m_sk - alpha, pb, p, r0, r1)
                                             : mul_mod(alpha, p - pb, p, r0, r1);
        out[idx] = add_mod(dest, term, p);
    }
}

// out [R, I-1, N]; x [R, I, N]; aux [R, A, N] (mode 1) or NULL; consts as
// above.  Returns cudaGetLastError() after the launch.
extern "C" int gst_behz(void* out, const void* x, const void* aux, const void* consts,
                        long long R, long long I, long long A, long long n, long long mode,
                        void* stream) {
    const long long total = R * (I - 1) * n;
    const int threads = 256;
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == 0) {
        sm_mrq_kernel<<<grid_for(total, threads), threads, 0, st>>>(
            (u64*)out, (const u64*)x, (const u64*)consts, total, (int)(I - 1), (int)n);
    } else if (mode == 1) {
        sk_tail_kernel<<<grid_for(total, threads), threads, 0, st>>>(
            (u64*)out, (const u64*)x, (const u64*)aux, (const u64*)consts, total,
            (int)(I - 1), (int)A, (int)n);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
