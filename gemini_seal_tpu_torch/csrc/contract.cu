// K3: 128-bit-exact multiply-accumulate contraction with one Barrett reduction.
//
// Replaces gemini_seal_tpu/ops/modops.py accumulate_mulmod_128
// (modops.py:218-254) at its call sites: the mod-up CRT lift in
// compute_modup_digits (with the punctured-inverse mul_mod before it folded
// in as the pre-scale), the key inner product of both key components
// (keyswitch_inner_product), the hoisted keys, _dot_mod_128 (rescale_special,
// fused_moddown, the base conversions, with their inv_hat and punctured
// mul_mods as the pre-scale) and the matvecs' weighted sums.  XLA lowers
// these as four 32-bit digit planes summed per term, then a renormalise and
// a Barrett pass.
//
//   out[r, g, j, n] = sum_k A'[r, g|0, k, j|0, n] * W[g, k, j, n|0]  mod p_j
//   A' = A * s[g, k] mod q[g, k] when a pre-scale is given
//
// With A's group axis at size 1 one input is broadcast over the G groups:
// the shared digits against R counter-rotated keys, and the digits against
// the two components of one key, read in place rather than G copies.
//
// Bound on the H100: per output K 64x64->128 products (7 IMADs each) and
// one Barrett (24), one pre-scale multiply per input; the bytes are one
// read of A and W and one write of out.  What the kernel runs up against is
// the integer instruction issue: its SASS spends about 17-20 instructions a
// MAC and 100 an output beyond its MACs (chip_smoke.py's build line), where
// the bound counts 7 and 24 IMADs.
//
// Design: a CTA owns a tile of TP column units (VEC = 2 coefficients a
// unit, 16-byte loads and stores, when N and the pointers allow) of one row
// r and one input group z; thread (slice, u) takes column unit u and every
// slices-th (g, j) output item of it.  Where an input feeds several outputs
// (Ja = 1: all J of them; broadcast mode: all G groups) the CTA first
// stages the tile's K x Ja input rows in shared memory, each input read
// from global memory once and pre-scaled once, and computes every output
// from the staged copy.  Where each input feeds one output (Ja = J without
// broadcast: the hoisted keys, the group sums) there is nothing to share
// and the items read their inputs directly (STAGED = false).  The output
// moduli and, with Nw = 1, the weights [G, K, J] are staged once per CTA.
// The geometry comes from the host (ops/modops.py contract_geometry): wide
// tiles for large calls, narrow tiles with several threads a unit for small
// ones, so that a call of one row still spreads over the card; in calls of
// several waves of CTAs the pre-scale is a Shoup multiply by constants
// computed once per CTA, in smaller ones the Barrett mul_mod, which needs
// no set-up.  Rows run on the grid's y axis, input groups on its z axis
// and tiles on its x axis: no index is divided on the per-output path (the
// one 32-bit split of a thread's first item is made once per thread);
// offsets within a row are 32-bit (the host checks that they fit).
//
// The sum is kept exact in a register pair (hi:lo with carry, mac128),
// which equals the JAX digit-plane sum whenever that is below 2^128
// (KeySwitchPlan.lazy_digits keeps that true), so the canonical result of
// the one barrett_reduce_128 is bit-identical.  Both pre-scales give the
// canonical A * s mod q of the JAX mul_mod.
#include "modops.cuh"

struct ContractParams {
    u64* out;
    const u64 *A, *W, *mod, *r0, *r1, *s, *sq, *sr0, *sr1;
    long long a_row;    // elements between rows r of A: Ga * K * Ja * n
    long long out_row;  // elements between rows r of out: G * J * n
    int a_group;        // elements between input groups z of A: K * Ja * n, 0 when broadcast
    int R, G, K, J, Ja, n, units;
    int log_tp;         // the tile: 1 << log_tp column units
    int ng;             // output groups a CTA computes (G in broadcast mode, else 1)
    int shoup;          // pre-scale by Shoup constants computed once per CTA
    int slice_div, slice_mod;  // slices / J and slices % J: the step between a thread's items
};

template <int VEC>
struct Unit {
    u64 v[VEC];
    __device__ __forceinline__ static Unit load(const u64* p) {
        Unit u;
        if constexpr (VEC == 2) {
            const ulonglong2 t = *reinterpret_cast<const ulonglong2*>(p);
            u.v[0] = t.x;
            u.v[1] = t.y;
        } else {
            u.v[0] = *p;
        }
        return u;
    }
    __device__ __forceinline__ void store_shared(u64* p) const {
        if constexpr (VEC == 2) {
            *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(v[0], v[1]);
        } else {
            *p = v[0];
        }
    }
    __device__ __forceinline__ void store_global(u64* p) const {
        if constexpr (VEC == 2) {
            asm volatile("st.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(v[0]), "l"(v[1])
                         : "memory");
        } else {
            *p = v[0];
        }
    }
};

// A * s mod q of one input unit: the Shoup multiply by the CTA's constants
// ps = [s mod q | q | floor((s mod q) * 2^64 / q)] (K each), or mul_mod
template <int VEC>
__device__ __forceinline__ void prescale(Unit<VEC>& x, const ContractParams& p, const u64* ps,
                                         int z, int k) {
    if (p.shoup) {
        const u64 sv = ps[k], qv = ps[p.K + k], sw = ps[2 * p.K + k];
#pragma unroll
        for (int e = 0; e < VEC; ++e) x.v[e] = mul_mod_shoup(x.v[e], sv, sw, qv);
    } else {
        const int gk = z * p.K + k;
        const u64 sv = p.s[gk], qv = p.sq[gk], q0 = p.sr0[gk], q1 = p.sr1[gk];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
            x.v[e] = mul_mod(x.v[e], sv, qv, q0, q1);
    }
}

template <int VEC, bool W_HAS_N, bool STAGED>
__global__ void __launch_bounds__(256) contract_kernel(const ContractParams p) {
    extern __shared__ __align__(16) u64 smem[];
    const int TP = 1 << p.log_tp;
    const int u = threadIdx.x & (TP - 1);
    const int slice = threadIdx.x >> p.log_tp;
    const int unit = blockIdx.x * TP + u;
    const bool live = unit < p.units;
    const int z = blockIdx.z;
    const int g0 = p.ng > 1 ? 0 : z;
    const int J = p.J, K = p.K, n = p.n;

    // the output moduli [3, J] and, with Nw = 1, the weights [G, K, J]: once per CTA
    u64* cm = smem;
    for (int i = threadIdx.x; i < J; i += blockDim.x) {
        cm[i] = p.mod[i];
        cm[J + i] = p.r0[i];
        cm[2 * J + i] = p.r1[i];
    }
    u64* ws = smem + 3 * J;
    const int nw = W_HAS_N ? 0 : p.G * K * J;
    for (int i = threadIdx.x; i < nw; i += blockDim.x) ws[i] = p.W[i];
    // the Shoup constants of this CTA's input group
    u64* ps = ws + nw;
    const int nps = p.shoup ? 3 * K : 0;
    for (int k = threadIdx.x; k < K && p.shoup; k += blockDim.x) {
        const int gk = z * K + k;
        const u64 q = p.sq[gk], q0 = p.sr0[gk], q1 = p.sr1[gk];
        const u64 sv = barrett_reduce_128(0, p.s[gk], q, q0, q1);
        ps[k] = sv;
        ps[K + k] = q;
        ps[2 * K + k] = shoup_constant(sv, q, q0, q1);
    }
    u64* stage = ps + ((3 * J + nw + nps) & 1) + nps;  // 16-byte aligned
    const int slices = blockDim.x >> p.log_tp;
    const int gi_first = slice / J;  // once per thread
    const int j_first = slice - gi_first * J;
    const int col = unit * VEC;
    // the constants must be in before their first use: the staged form's
    // barrier after its first stage covers them, unless the stage itself
    // reads the Shoup constants
    if (!STAGED || p.shoup) __syncthreads();

    for (int r = blockIdx.y; r < p.R; r += gridDim.y) {
        const u64* a = p.A + r * p.a_row + z * p.a_group + col;
        const u64* xs;  // this unit's input rows: the stage, or A itself
        int x_stride;   // between k
        if constexpr (STAGED) {
            // 1. stage: input rows q = k * Ja + ja of this tile, each read and pre-scaled once
            if (r != blockIdx.y) __syncthreads();  // the last row's items are done with it
            const int rows_in = K * p.Ja;
            for (int q = slice; q < rows_in && live; q += slices) {
                Unit<VEC> x = Unit<VEC>::load(a + q * n);
                if (p.s != nullptr) prescale<VEC>(x, p, ps, z, p.Ja == 1 ? q : q / p.Ja);
                x.store_shared(stage + (q * TP + u) * VEC);
            }
            __syncthreads();
            xs = stage + u * VEC;
            x_stride = p.Ja * TP * VEC;
        } else {
            xs = a;
            x_stride = p.Ja * n;
        }
        if (!live) continue;
        // 2. items (g, j): every slices-th of the ng * J outputs of column unit u
        u64* out_r = p.out + r * p.out_row + col;
        int gi = gi_first, j = j_first;
        while (gi < p.ng) {
            const int g = g0 + gi;
            const u64* xj = xs + (p.Ja > 1 ? j : 0) * (STAGED ? TP * VEC : n);
            u64 hi[VEC], lo[VEC];
#pragma unroll
            for (int e = 0; e < VEC; ++e) hi[e] = lo[e] = 0;
            const u64* wk = W_HAS_N ? p.W + (g * K * J + j) * n + col : ws + g * K * J + j;
            const int w_stride = W_HAS_N ? J * n : J;
#pragma unroll 2
            for (int k = 0; k < K; ++k) {
                Unit<VEC> x = Unit<VEC>::load(xj + k * x_stride);
                if (!STAGED && p.s != nullptr) prescale<VEC>(x, p, ps, z, k);
                if constexpr (W_HAS_N) {
                    const Unit<VEC> wv = Unit<VEC>::load(wk + k * w_stride);
#pragma unroll
                    for (int e = 0; e < VEC; ++e) mac128(hi[e], lo[e], x.v[e], wv.v[e]);
                } else {
                    const u64 wv = wk[k * w_stride];
#pragma unroll
                    for (int e = 0; e < VEC; ++e) mac128(hi[e], lo[e], x.v[e], wv);
                }
            }
            const u64 pj = cm[j], pj0 = cm[J + j], pj1 = cm[2 * J + j];
            Unit<VEC> y;
#pragma unroll
            for (int e = 0; e < VEC; ++e) y.v[e] = barrett_reduce_128(hi[e], lo[e], pj, pj0, pj1);
            y.store_global(out_r + (g * J + j) * n);
            j += p.slice_mod;
            gi += p.slice_div;
            if (j >= J) {
                j -= J;
                ++gi;
            }
        }
    }
}

template <int VEC, bool W_HAS_N>
static void launch(bool staged, dim3 grid, unsigned threads, long long smem, cudaStream_t st,
                   const ContractParams& p) {
    if (staged)
        contract_kernel<VEC, W_HAS_N, true><<<grid, threads, smem, st>>>(p);
    else
        contract_kernel<VEC, W_HAS_N, false><<<grid, threads, smem, st>>>(p);
}

// out [R, G, J, N]; A [R, Ga, K, Ja, N] (Ga in {1, G}, Ja in {1, J});
// W [G, K, J, Nw] (Nw in {1, N}); mod/r0/r1 [J]; s/sq/sr0/sr1 [G, K] or all
// NULL.  The geometry (vec, log_tp, threads, z_count, ng, grid_y, staged,
// shoup, smem bytes) is the host's contract_geometry; a geometry that does
// not fit the shapes returns cudaErrorInvalidValue without a launch.
extern "C" int gst_contract(void* out, const void* A, const void* W,
                            const void* mod, const void* r0, const void* r1,
                            const void* s, const void* sq, const void* sr0, const void* sr1,
                            long long R, long long G, long long Ga, long long K, long long J,
                            long long Ja, long long n, long long w_has_n,
                            long long vec, long long log_tp, long long threads,
                            long long z_count, long long ng, long long grid_y,
                            long long staged, long long shoup, long long smem_bytes,
                            void* stream) {
    const long long tp = 1LL << log_tp;
    const long long units = n / vec;
    const long long stage = staged ? K * Ja * tp * vec * 8 : 0;
    const long long nw = w_has_n ? 0 : G * K * J;
    const long long nps = shoup ? 3 * K : 0;
    const long long lim = 1LL << 31;
    if ((vec != 1 && vec != 2) || n % vec || threads % tp || threads > 256 || tp > threads ||
        (Ga != 1 && Ga != G) || (Ja != 1 && Ja != J) || R < 1 || K < 1 || J < 1 ||
        ng * z_count != G || (ng > 1 && (Ga != 1 || s != nullptr || !staged)) ||
        (shoup && s == nullptr) || z_count > 65535 || grid_y < 1 || grid_y > 65535 ||
        grid_y > R || smem_bytes < (3 * J + nw + nps + 1) / 2 * 16 + stage ||
        smem_bytes > 48 * 1024 || G * J * n >= lim || Ga * K * Ja * n >= lim ||
        (w_has_n && G * K * J * n >= lim))
        return (int)cudaErrorInvalidValue;
    ContractParams p;
    p.out = (u64*)out;
    p.A = (const u64*)A;
    p.W = (const u64*)W;
    p.mod = (const u64*)mod;
    p.r0 = (const u64*)r0;
    p.r1 = (const u64*)r1;
    p.s = (const u64*)s;
    p.sq = (const u64*)sq;
    p.sr0 = (const u64*)sr0;
    p.sr1 = (const u64*)sr1;
    p.a_row = Ga * K * Ja * n;
    p.out_row = G * J * n;
    p.a_group = Ga == 1 ? 0 : (int)(K * Ja * n);
    p.R = (int)R;
    p.G = (int)G;
    p.K = (int)K;
    p.J = (int)J;
    p.Ja = (int)Ja;
    p.n = (int)n;
    p.units = (int)units;
    p.log_tp = (int)log_tp;
    p.ng = (int)ng;
    p.shoup = (int)shoup;
    const long long slices = threads / tp;
    p.slice_div = (int)(slices / J);
    p.slice_mod = (int)(slices % J);
    const dim3 grid((unsigned)((units + tp - 1) / tp), (unsigned)grid_y, (unsigned)z_count);
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned t = (unsigned)threads;
    if (vec == 2) {
        if (w_has_n)
            launch<2, true>(staged, grid, t, smem_bytes, st, p);
        else
            launch<2, false>(staged, grid, t, smem_bytes, st, p);
    } else {
        if (w_has_n)
            launch<1, true>(staged, grid, t, smem_bytes, st, p);
        else
            launch<1, false>(staged, grid, t, smem_bytes, st, p);
    }
    return (int)cudaGetLastError();
}
