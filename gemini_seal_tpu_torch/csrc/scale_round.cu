// K7: the BFV plaintext scalings of encryption and decryption.
//
// Replaces, in gemini_seal_tpu/ops/rnsops.py:
//   mode 0 plain_add / mode 1 plain_sub: multiply_add_plain_with_scaling_variant
//     and multiply_sub_plain_with_scaling_variant (rnsops.py:256-310):
//     c0 +- round(q/t * m).  Per coefficient, fix = floor((m * (q mod t) +
//     ceil(t/2)) / t) with the 128/64 divmod_128 quotient correction; per
//     limb and coefficient, inc = (Delta_l * m + fix) in 128 bits through
//     barrett_reduce_128; per output, add_mod / sub_mod of inc onto c0.
//     c0 [R, L, N], m [N] -> [R, L, N].
//   mode 2 t_gamma: the tail of decrypt_scale_and_round (rnsops.py:145-179)
//     after the q -> {t, gamma} conversion (one contract launch with
//     |gamma t|_qi folded into its pre-scale): both rows times -q^-1, the
//     gamma-centred correction onto the t row, times gamma^-1 mod t.
//     tg [R, 2, N] -> [R, N].
//
// Bound on the H100: both modes read one or two u64 rows per output and
// write one; plain mode does one 128-bit product and one Barrett quotient
// per coefficient and one 128-bit product and one barrett_reduce_128 per
// limb and coefficient, and only an add or subtract per output; t_gamma
// three Shoup products and two barrett_reduce_64 per output (~44 32-bit
// IMADs).  Neither runs in a timed step: they are the encrypt and decrypt
// ends of the BFV paths, one ciphertext at a time, so a call is a few
// microseconds and its launch a large part of them (chip_smoke.py's
// launch_floor line times gst_empty_launch below, an empty kernel, the
// same way).
//
// Design: a thread owns one column unit (VEC adjacent coefficients) of the
// rows y, y + gridDim.y, ... and, in plain mode, the limbs z, z + gridDim.z,
// ... (the geometry is the host's, ops/rnsops.py rns_geometry: two
// coefficients a unit, 16-byte loads and stores, in a call that fills the
// card; one, CTAs of 128 and the limbs over the grid in the small calls of
// an encryption or decryption).  Plain mode
// computes fix once per unit and inc once per limb, which is the same for
// every row (m is one [N] vector), and then only adds it to the rows' c0;
// it needs no set-up and no barrier.  t_gamma's three products by
// constants are Shoup products by constants that each CTA computes once
// into shared memory (shoup_constant), which with each multiplier below its
// modulus (the host checks: ops/rnsops.py check_shoup_operands) give the
// canonical value of the Barrett mul_mod for any 64-bit input; the
// thread's first inputs and its constants from global memory are loaded
// before the barrier.  No index is divided.
#include "modops.cuh"

struct ScaleParams {
    u64* out;
    const u64 *x, *m, *k;  // plain: c0 [R, L, N], m [N]; t_gamma: tg [R, 2, N]
    int R, L, n;           // rows, limbs (plain), coefficients a row
    int units;             // column units a row: n / VEC
};

// consts, modes 0/1: p[L], r0[L], r1[L], delta[L], t, t_r0, t_r1, q_mod_t, thresh
template <int VEC, bool SUB>
__global__ void __launch_bounds__(256) plain_kernel(const ScaleParams P) {
    const int unit = blockIdx.x * blockDim.x + threadIdx.x;
    if (unit >= P.units) return;
    const int L = P.L, n = P.n, col = unit * VEC;
    const u64* k = P.k;
    const u64 t = k[4 * L], t_r0 = k[4 * L + 1], t_r1 = k[4 * L + 2];
    const u64 q_mod_t = k[4 * L + 3], thresh = k[4 * L + 4];
    u64 mv[VEC], fix[VEC];
    load_cols<VEC>(mv, P.m + col);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
        u64 lo = thresh, hi = 0;
        mac128(hi, lo, mv[e], q_mod_t);
        fix[e] = divmod_128_quotient(hi, lo, t, t_r0, t_r1);
    }
    const long long row = (long long)L * n;
#pragma unroll 1
    for (int l = blockIdx.z; l < L; l += gridDim.z) {
        const u64 p = k[l], r0 = k[L + l], r1 = k[2 * L + l], delta = k[3 * L + l];
        u64 inc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            u64 lo = fix[e], hi = 0;
            mac128(hi, lo, delta, mv[e]);
            inc[e] = barrett_reduce_128(hi, lo, p, r0, r1);
        }
        const u64* xl = P.x + l * n + col;
        u64* ol = P.out + l * n + col;
#pragma unroll 1
        for (int r = blockIdx.y; r < P.R; r += gridDim.y) {
            u64 v[VEC];
            load_cols<VEC>(v, xl + r * row);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                v[e] = SUB ? sub_mod(v[e], inc[e], p) : add_mod(v[e], inc[e], p);
            store_cols<VEC>(ol + r * row, v);
        }
    }
}

// consts, mode 2: t, t_r0, t_r1, gamma, g_r0, g_r1, -q^-1 mod t,
//                 -q^-1 mod gamma, gamma^-1 mod t
// shared: the three multipliers, each beside its Shoup constant
template <int VEC>
__global__ void __launch_bounds__(256) t_gamma_kernel(const ScaleParams P) {
    __shared__ u64 cs[6];
    const u64* k = P.k;
    if (threadIdx.x < 3) {
        const int i = threadIdx.x, m = i == 1 ? 3 : 0;  // -q^-1 mod gamma is the one mod gamma
        const u64 w = k[6 + i];
        cs[2 * i] = w;
        cs[2 * i + 1] = shoup_constant(w, k[m], k[m + 1], k[m + 2]);
    }
    const u64 t = k[0], t_r1 = k[2], g = k[3];  // loaded before the barrier
    const int n = P.n;
    const int unit = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = unit < P.units;
    const int col = unit * VEC;
    int r = blockIdx.y;
    u64 a[VEC], b[VEC];
    if (live && r < P.R) {
        load_cols<VEC>(a, P.x + (long long)r * 2 * n + col);
        load_cols<VEC>(b, P.x + (long long)r * 2 * n + n + col);
    }
    __syncthreads();
    if (!live) return;
    for (; r < P.R; r += gridDim.y) {
        const u64* xr = P.x + (long long)r * 2 * n + col;
        if (r != blockIdx.y) {
            load_cols<VEC>(a, xr);
            load_cols<VEC>(b, xr + n);
        }
        u64 v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            const u64 t_part = mul_mod_shoup(a[e], cs[0], cs[1], t);
            const u64 g_part = mul_mod_shoup(b[e], cs[2], cs[3], g);
            const u64 dest = g_part > (g >> 1)
                                 ? add_mod(t_part, barrett_reduce_64(g - g_part, t, t_r1), t)
                                 : sub_mod(t_part, barrett_reduce_64(g_part, t, t_r1), t);
            v[e] = mul_mod_shoup(dest, cs[4], cs[5], t);
        }
        store_cols<VEC>(P.out + (long long)r * n + col, v);
    }
}

template <int VEC>
static void launch(long long mode, dim3 grid, unsigned threads, cudaStream_t st,
                   const ScaleParams& p) {
    if (mode == 0)
        plain_kernel<VEC, false><<<grid, threads, 0, st>>>(p);
    else if (mode == 1)
        plain_kernel<VEC, true><<<grid, threads, 0, st>>>(p);
    else
        t_gamma_kernel<VEC><<<grid, threads, 0, st>>>(p);
}

// modes 0/1: out, x [R, L, N], m [N]; mode 2: out [R, N], x [R, 2, N], m NULL.
// The geometry (vec, threads, grid_y, grid_z) is the host's rns_geometry
// (grid_z 1 in mode 2); one that does not fit the shapes returns
// cudaErrorInvalidValue without a launch.  Returns cudaGetLastError()
// after the launch.
extern "C" int gst_scale_round(void* out, const void* x, const void* m, const void* consts,
                               long long R, long long L, long long n, long long mode,
                               long long vec, long long threads, long long grid_y,
                               long long grid_z, void* stream) {
    const long long limbs = mode == 2 ? 1 : L;
    if (mode < 0 || mode > 2 || (mode == 2 && L != 2) || (mode != 2 && m == nullptr) ||
        (vec != 1 && vec != 2) || n % vec || L < 1 || R < 1 || threads < 32 ||
        threads > 256 || threads % 32 || grid_y < 1 || grid_y > R || grid_y > 65535 ||
        grid_z < 1 || grid_z > limbs || L * n >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    ScaleParams p;
    p.out = (u64*)out;
    p.x = (const u64*)x;
    p.m = (const u64*)m;
    p.k = (const u64*)consts;
    p.R = (int)R;
    p.L = (int)L;
    p.n = (int)n;
    p.units = (int)(n / vec);
    const dim3 grid((unsigned)((p.units + threads - 1) / threads), (unsigned)grid_y,
                    (unsigned)grid_z);
    cudaStream_t st = (cudaStream_t)stream;
    if (vec == 2)
        launch<2>(mode, grid, (unsigned)threads, st, p);
    else
        launch<1>(mode, grid, (unsigned)threads, st, p);
    return (int)cudaGetLastError();
}

// A measurement fixture, not part of any path: no wrapper calls it.  An
// empty kernel of `blocks` CTAs of `threads` threads on the stream, whose
// time is the launch floor that the small K7-K10 calls are read against
// (chip_smoke.py and port_tools/rns_kernels.py time it as they time the
// kernels).  It lives here because K7's calls are the ones it is read with.
__global__ void empty_kernel() {}

extern "C" int gst_empty_launch(long long blocks, long long threads, void* stream) {
    empty_kernel<<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
