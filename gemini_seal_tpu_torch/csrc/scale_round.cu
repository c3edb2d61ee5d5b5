// K7: the BFV plaintext scalings of encryption and decryption.
//
// Replaces, in gemini_seal_tpu/ops/rnsops.py:
//   mode 0 plain_add / mode 1 plain_sub: multiply_add_plain_with_scaling_variant
//     and multiply_sub_plain_with_scaling_variant (rnsops.py:256-310):
//     c0 +- round(q/t * m).  Per coefficient, fix = floor((m * (q mod t) +
//     ceil(t/2)) / t) with the 128/64 divmod_128 quotient correction; per
//     output, (Delta_l * m + fix) in 128 bits through barrett_reduce_128,
//     then add_mod / sub_mod onto c0.  c0 [R, L, N], m [N] -> [R, L, N].
//   mode 2 t_gamma: the tail of decrypt_scale_and_round (rnsops.py:145-179)
//     after the q -> {t, gamma} conversion (one contract launch with
//     |gamma t|_qi folded into its pre-scale): both rows times -q^-1, the
//     gamma-centred correction onto the t row, times gamma^-1 mod t.
//     tg [R, 2, N] -> [R, N].
//
// Bound on the H100: both modes read one or two u64 rows per output and
// write one; plain mode does two 128-bit products, one Barrett quotient and
// one barrett_reduce_128 per output (~62 32-bit IMADs), t_gamma three
// mul_mods and two barrett_reduce_64 (~107).  Neither runs in a timed step:
// they are the encrypt and decrypt ends of the BFV paths.
//
// Design: one thread per output coefficient in a grid-stride loop, as K4;
// plain mode recomputes the per-coefficient fix for each limb (L <= 6)
// instead of a second pass.  Constants are one packed u64 array.
#include "modops.cuh"

// consts, modes 0/1: p[L], r0[L], r1[L], delta[L], t, t_r0, t_r1, q_mod_t, thresh
__global__ void plain_kernel(u64* __restrict__ out, const u64* __restrict__ c0,
                             const u64* __restrict__ m, const u64* __restrict__ k,
                             long long total, int L, int n, int sub) {
    const u64 t = k[4 * L], t_r0 = k[4 * L + 1], t_r1 = k[4 * L + 2];
    const u64 q_mod_t = k[4 * L + 3], thresh = k[4 * L + 4];
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int c = (int)(idx % n);
        const int l = (int)((idx / n) % L);
        const u64 mv = m[c];
        const u64 prod_lo = mv * q_mod_t;
        const u64 prod_hi = __umul64hi(mv, q_mod_t);
        const u64 num_lo = prod_lo + thresh;
        const u64 num_hi = prod_hi + (u64)(num_lo < prod_lo);
        const u64 fix = divmod_128_quotient(num_hi, num_lo, t, t_r0, t_r1);
        const u64 delta = k[3 * L + l];
        const u64 dm_lo = delta * mv;
        const u64 dm_hi = __umul64hi(delta, mv);
        const u64 s_lo = dm_lo + fix;
        const u64 s_hi = dm_hi + (u64)(s_lo < dm_lo);
        const u64 p = k[l];
        const u64 inc = barrett_reduce_128(s_hi, s_lo, p, k[L + l], k[2 * L + l]);
        out[idx] = sub ? sub_mod(c0[idx], inc, p) : add_mod(c0[idx], inc, p);
    }
}

// consts, mode 2: t, t_r0, t_r1, gamma, g_r0, g_r1, -q^-1 mod t,
//                 -q^-1 mod gamma, gamma^-1 mod t
__global__ void t_gamma_kernel(u64* __restrict__ out, const u64* __restrict__ tg,
                               const u64* __restrict__ k, long long total, int n) {
    const u64 t = k[0], t_r0 = k[1], t_r1 = k[2], g = k[3], g_r0 = k[4], g_r1 = k[5];
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int c = (int)(idx % n);
        const long long r = idx / n;
        const u64* row = tg + r * 2 * (long long)n + c;
        const u64 t_part = mul_mod(row[0], k[6], t, t_r0, t_r1);
        const u64 g_part = mul_mod(row[n], k[7], g, g_r0, g_r1);
        const u64 dest = g_part > (g >> 1)
                             ? add_mod(t_part, barrett_reduce_64(g - g_part, t, t_r1), t)
                             : sub_mod(t_part, barrett_reduce_64(g_part, t, t_r1), t);
        out[idx] = mul_mod(dest, k[8], t, t_r0, t_r1);
    }
}

// modes 0/1: out, x [R, L, N], m [N]; mode 2: out [R, N], x [R, 2, N], m NULL.
// Returns cudaGetLastError() after the launch.
extern "C" int gst_scale_round(void* out, const void* x, const void* m, const void* consts,
                               long long R, long long L, long long n, long long mode,
                               void* stream) {
    const int threads = 256;
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == 0 || mode == 1) {
        const long long total = R * L * n;
        plain_kernel<<<grid_for(total, threads), threads, 0, st>>>(
            (u64*)out, (const u64*)x, (const u64*)m, (const u64*)consts, total, (int)L,
            (int)n, (int)mode);
    } else if (mode == 2) {
        const long long total = R * n;
        t_gamma_kernel<<<grid_for(total, threads), threads, 0, st>>>(
            (u64*)out, (const u64*)x, (const u64*)consts, total, (int)n);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
