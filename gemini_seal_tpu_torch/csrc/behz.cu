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
//     function does: the u64 conv_msk + (m_sk - x_sk), un-reduced, times
//     B^-1 mod m_sk; then dest_l + prod_B * (m_sk - alpha) mod q_l when
//     alpha > m_sk/2, else dest_l + (q_l - prod_B) * alpha mod q_l.
//     XLA computes both branch products and selects; this kernel computes
//     the selected one, which is the same canonical value.
//
// Bound on the H100: sm_mrq reads Bsk+1 rows and writes Bsk (at the main
// path's [128, 2, 6, 8192] input, 96 MiB in and 80 MiB out) and does two
// Shoup products per output (~20 32-bit IMADs); sk_tail reads L+1 rows and
// the x_sk row and writes L, with one Shoup product per output and one per
// coefficient.  The bytes set the bound in both modes.
//
// Design: a thread owns one column unit (VEC adjacent coefficients) of the
// rows y, y + gridDim.y, ... and computes the output limbs z, z + gridDim.z,
// ... of it.  The geometry is the host's (ops/rnsops.py rns_geometry): a
// call that fills the card takes two coefficients a unit (16-byte loads
// and stores), CTAs of 256 threads and one limb group; a smaller one (the
// per-op API's one to three ciphertexts) is bound by its latency and takes
// one coefficient a thread, its limbs spread over the grid, CTAs of 128.
// What belongs to a coefficient is done once per row and unit: the m_tilde
// row read and r and its centring computed (sm_mrq), the m_sk and x_sk rows
// read and alpha and its branch computed (sk_tail).  The thread walks its
// (row, limb) items with the next item's input loaded before the current
// one is computed; its first item's inputs and every constant it reads from
// global memory are loaded before the one barrier, which publishes the
// CTA's Shoup constants.
//
// In a call of more than half a wave of threads (SHOUP, the host's pick) every
// product by a per-limb constant is a Shoup product: each CTA first
// computes floor(w * 2^64 / p) of its constants into shared memory
// (shoup_constant), which with w < p (the host checks every packed
// multiplier: ops/rnsops.py check_shoup_operands) gives the canonical
// w * a mod p of the Barrett mul_mod for any 64-bit a.  sm_mrq's output is
// the canonical (x_j + q * r) * m_tilde^-1 mod p_j, which the plain version
// reaches through the 128-bit sum, barrett_reduce_128 and mul_mod; the
// Shoup form computes the same value as x_j * m_tilde^-1 + r * (q *
// m_tilde^-1) mod p_j, two lazy Shoup products and one reduction from
// [0, 4p), the second constant made once per CTA by mul_mod (the two
// forms timed: port_tools/rns_kernels.py --shoup).  A smaller call (the
// per-op calls at N = 4096) has one output or less a thread, so a
// constant serves few outputs and the set-up's chain of dependent
// multiplies and its barrier lengthen the call (3-7% on those calls): there
// the kernel takes the plain version's Barrett steps with the constants
// read from global memory, and no barrier.  So
// every output is bit for bit the plain version's.  No index is divided:
// rows, limbs and tiles are grid axes, offsets within a row are 32-bit
// (the host checks that they fit).
#include "modops.cuh"

struct BehzParams {
    u64* out;
    const u64 *x, *aux, *k;  // x [R, L+1, N]; aux [R, bsk, N] (sk_tail); packed constants
    int R, L, n;             // rows, output limbs, coefficients a row
    int bsk;                 // aux limbs (sk_tail)
    int units;               // column units a row: n / VEC
};

// The item after (r, j) in a thread's walk: the next limb of its group, or
// the first limb of its next row.  Returns false past the last row.
__device__ __forceinline__ bool next_item(int& r, int& j, int L, int R) {
    j += gridDim.z;
    if (j >= L) {
        j = blockIdx.z;
        r += gridDim.y;
    }
    return r < R;
}

// consts, mode 0: p[B1], r0[B1], r1[B1], prod_q_mod_Bsk[B1], inv_m_tilde[B1],
//                 inv_prod_q_mod_m_tilde            (B1 = Bsk = L, rows out)
// shared (SHOUP): p[L], w = m_tilde^-1[L], its Shoup[L], c = q * m_tilde^-1[L],
//                 its Shoup[L]
template <int VEC, bool SHOUP>
__global__ void __launch_bounds__(256) sm_mrq_kernel(const BehzParams P) {
    extern __shared__ __align__(16) u64 cs[];
    const int L = P.L, n = P.n, R = P.R;
    for (int j = threadIdx.x; j < L && SHOUP; j += blockDim.x) {
        const u64 p = P.k[j], r0 = P.k[L + j], r1 = P.k[2 * L + j], w = P.k[4 * L + j];
        const u64 c = mul_mod(P.k[3 * L + j], w, p, r0, r1);
        cs[j] = p;
        cs[L + j] = w;
        cs[2 * L + j] = shoup_constant(w, p, r0, r1);
        cs[3 * L + j] = c;
        cs[4 * L + j] = shoup_constant(c, p, r0, r1);
    }
    const u64 inv_q_mt = P.k[5 * L];
    const int unit = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = unit < P.units;
    const int col = unit * VEC;
    const long long row_in = (long long)(L + 1) * n;
    int r = blockIdx.y, j = blockIdx.z;
    u64 x_mt[VEC], v[VEC];
    if (live) {
        load_cols<VEC>(x_mt, P.x + r * row_in + L * n + col);
        load_cols<VEC>(v, P.x + r * row_in + j * n + col);
    }
    if (SHOUP) __syncthreads();
    if (!live) return;
    u64 rr[VEC];
    bool more;
    do {
#pragma unroll
        for (int e = 0; e < VEC; ++e)  // (m_tilde - x_mt * q^-1) mod m_tilde
            rr[e] = (0 - x_mt[e] * inv_q_mt) & 0xFFFFFFFFULL;
        const int row = r;
        do {
            const int jc = j;
            u64 nx[VEC];
            more = next_item(r, j, L, R);
            if (more) {
                if (r != row) load_cols<VEC>(x_mt, P.x + r * row_in + L * n + col);
                load_cols<VEC>(nx, P.x + r * row_in + j * n + col);
            }
            const u64 p = SHOUP ? cs[jc] : P.k[jc];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                // centred: r >= m_tilde/2 stands for r - m_tilde, i.e. r + (p - m_tilde) mod p
                const u64 rj = rr[e] >= (1ULL << 31) ? rr[e] + (p - (1ULL << 32)) : rr[e];
                if constexpr (SHOUP) {
                    v[e] = reduce_twice(mul_mod_shoup_lazy(v[e], cs[L + jc], cs[2 * L + jc], p) +
                                            mul_mod_shoup_lazy(rj, cs[3 * L + jc],
                                                               cs[4 * L + jc], p),
                                        p);
                } else {
                    const u64 r0 = P.k[L + jc], r1 = P.k[2 * L + jc];
                    u64 hi = 0;
                    mac128(hi, v[e], P.k[3 * L + jc], rj);
                    v[e] = mul_mod(barrett_reduce_128(hi, v[e], p, r0, r1), P.k[4 * L + jc], p,
                                   r0, r1);
                }
            }
            store_cols<VEC>(P.out + (long long)row * L * n + jc * n + col, v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[e] = nx[e];
        } while (more && r == row);
    } while (more);
}

// consts, mode 1: p[L], r0[L], r1[L], prod_B_mod_q[L], m_sk, m_sk_r0, m_sk_r1,
//                 inv_prod_B_mod_m_sk               (L = rows out)
// shared (SHOUP): p[L], prod_B[L], its Shoup[L], p - prod_B[L], its Shoup[L],
//                 then B^-1 mod m_sk's Shoup constant
template <int VEC, bool SHOUP>
__global__ void __launch_bounds__(256) sk_tail_kernel(const BehzParams P) {
    extern __shared__ __align__(16) u64 cs[];
    const int L = P.L, n = P.n, R = P.R;
    const u64 m_sk = P.k[4 * L], ms_r0 = P.k[4 * L + 1], ms_r1 = P.k[4 * L + 2];
    const u64 ib = P.k[4 * L + 3];  // B^-1 mod m_sk, loaded before the barrier
    for (int j = threadIdx.x; j <= L && SHOUP; j += blockDim.x) {
        if (j < L) {
            const u64 p = P.k[j], r0 = P.k[L + j], r1 = P.k[2 * L + j];
            const u64 wn = P.k[3 * L + j], wp = p - wn;
            cs[j] = p;
            cs[L + j] = wn;
            cs[2 * L + j] = shoup_constant(wn, p, r0, r1);
            cs[3 * L + j] = wp;
            cs[4 * L + j] = shoup_constant(wp, p, r0, r1);
        } else {
            cs[5 * L] = shoup_constant(ib, m_sk, ms_r0, ms_r1);
        }
    }
    const int unit = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = unit < P.units;
    const int col = unit * VEC;
    const long long row_in = (long long)(L + 1) * n, row_aux = (long long)P.bsk * n;
    const int sk = (P.bsk - 1) * n;
    int r = blockIdx.y, j = blockIdx.z;
    u64 to_msk[VEC], x_sk[VEC], v[VEC];
    if (live) {
        load_cols<VEC>(to_msk, P.x + r * row_in + L * n + col);
        load_cols<VEC>(x_sk, P.aux + r * row_aux + sk + col);
        load_cols<VEC>(v, P.x + r * row_in + j * n + col);
    }
    if (SHOUP) __syncthreads();
    if (!live) return;
    u64 a[VEC];
    bool neg[VEC], more;
    do {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            const u64 d = to_msk[e] + (m_sk - x_sk[e]);
            const u64 alpha = SHOUP ? mul_mod_shoup(d, ib, cs[5 * L], m_sk)
                                    : mul_mod(d, ib, m_sk, ms_r0, ms_r1);
            neg[e] = alpha > (m_sk >> 1);
            a[e] = neg[e] ? m_sk - alpha : alpha;
        }
        const int row = r;
        do {
            const int jc = j;
            u64 nx[VEC];
            more = next_item(r, j, L, R);
            if (more) {
                if (r != row) {
                    load_cols<VEC>(to_msk, P.x + r * row_in + L * n + col);
                    load_cols<VEC>(x_sk, P.aux + r * row_aux + sk + col);
                }
                load_cols<VEC>(nx, P.x + r * row_in + j * n + col);
            }
            const u64 p = SHOUP ? cs[jc] : P.k[jc];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                u64 term;
                if constexpr (SHOUP) {
                    const u64 w = neg[e] ? cs[L + jc] : cs[3 * L + jc];
                    const u64 ws = neg[e] ? cs[2 * L + jc] : cs[4 * L + jc];
                    term = mul_mod_shoup(a[e], w, ws, p);
                } else {
                    const u64 pb = P.k[3 * L + jc];
                    term = mul_mod(a[e], neg[e] ? pb : p - pb, p, P.k[L + jc], P.k[2 * L + jc]);
                }
                v[e] = add_mod(v[e], term, p);
            }
            store_cols<VEC>(P.out + (long long)row * L * n + jc * n + col, v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[e] = nx[e];
        } while (more && r == row);
    } while (more);
}

template <int VEC, bool SHOUP>
static void launch(long long mode, dim3 grid, unsigned threads, size_t smem, cudaStream_t st,
                   const BehzParams& p) {
    if (mode == 0)
        sm_mrq_kernel<VEC, SHOUP><<<grid, threads, smem, st>>>(p);
    else
        sk_tail_kernel<VEC, SHOUP><<<grid, threads, smem, st>>>(p);
}

// out [R, I-1, N]; x [R, I, N]; aux [R, A, N] (mode 1) or NULL; consts as
// above.  The geometry (vec, threads, grid_y, grid_z, shoup) is the host's
// rns_geometry; one that does not fit the shapes returns
// cudaErrorInvalidValue without a launch.  Returns cudaGetLastError() after
// the launch.
extern "C" int gst_behz(void* out, const void* x, const void* aux, const void* consts,
                        long long R, long long I, long long A, long long n, long long mode,
                        long long vec, long long threads, long long grid_y, long long grid_z,
                        long long shoup, void* stream) {
    const long long L = I - 1;
    if ((mode != 0 && mode != 1) || (vec != 1 && vec != 2) || n % vec || L < 1 || R < 1 ||
        threads < 32 || threads > 256 || threads % 32 || grid_y < 1 || grid_y > R ||
        grid_y > 65535 || grid_z < 1 || grid_z > L || grid_z > 65535 ||
        I * n >= (1LL << 31) || (mode == 1 && (A < 1 || aux == nullptr)))
        return (int)cudaErrorInvalidValue;
    BehzParams p;
    p.out = (u64*)out;
    p.x = (const u64*)x;
    p.aux = (const u64*)aux;
    p.k = (const u64*)consts;
    p.R = (int)R;
    p.L = (int)L;
    p.n = (int)n;
    p.bsk = (int)A;
    p.units = (int)(n / vec);
    const dim3 grid((unsigned)((p.units + threads - 1) / threads), (unsigned)grid_y,
                    (unsigned)grid_z);
    const size_t smem = shoup ? (size_t)(mode == 0 ? 5 * L : 5 * L + 1) * sizeof(u64) : 0;
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned t = (unsigned)threads;
    if (vec == 2)
        shoup ? launch<2, true>(mode, grid, t, smem, st, p)
              : launch<2, false>(mode, grid, t, smem, st, p);
    else
        shoup ? launch<1, true>(mode, grid, t, smem, st, p)
              : launch<1, false>(mode, grid, t, smem, st, p);
    return (int)cudaGetLastError();
}
