// K1: negacyclic NTT over the last axis, forward and inverse, lazy or canonical.
//
// Replaces gemini_seal_tpu/ops/ntt.py ntt_forward_lazy / ntt_forward
// (ntt.py:241-319) and ntt_inverse_lazy / ntt_inverse (ntt.py:322-403),
// which XLA lowers for the TPU as log N (or log N / FUSE_STAGES) full passes
// over device memory.
//
// Bound on the H100: a row is N u64 (64 KB at N=8192) that must be read and
// written once, with log N stages of N/2 Shoup butterflies in between (three
// 64-bit multiplies, ~10 32-bit IMADs, each).  At the main path's sizes the
// bytes (rows in and out plus the twiddle tables) set the bound, with the
// multiplies close behind (~0.8 of it); this simple kernel runs ~4.6x the
// bound (PERF.md).
//
// Design: one block per row, the whole row in dynamic shared memory, all log N
// stages with __syncthreads() between them, so device memory sees one read and
// one write per row; twiddles and their Shoup duals are read from global memory
// (one [L, N] table pair, resident in L2).  The butterfly sequence is the JAX
// radix-2 one exactly (FUSE_STAGES only regroups it), so the lazy outputs are
// bit-identical: forward keeps the accumulating lane in [0, 2p) and ends in
// [0, 4p); inverse folds n^-1 into the last stage and ends in [0, 2p).
//
// Large rings (N = 32768, 65536): a row no longer fits in a block's 227 KB of
// shared memory, so the first k = log2(N / 16384) forward stages (the last k
// inverse stages) run in a global-memory kernel, one thread per butterfly and
// one launch per stage.  What is left of the transform splits the row into
// 2^k independent 16384-coefficient sub-rows, each done by one block of the
// shared-memory body: at forward stage st, sub-row j's block i uses twiddle
// w[2^st + j 2^(st-k) + i]; at inverse stage st (< log N - k) it uses the
// reordered entry ofs(st) + j (S >> (st + 1)) + i.  Every value between stages
// is the one the JAX loop computes, so the result stays bit-identical.  The
// forward stages write a scratch buffer that the sub-row launch reads, so no
// launch reads and writes one buffer through restrict pointers.  A cluster
// of CTAs sharing their rows over distributed shared memory would save the k
// extra passes over device memory; not done yet.
#include "modops.cuh"

// the largest row that one block keeps in shared memory (128 KB)
#define NTT_SHARED_LOG_N 14

// The shared-memory body, one block per (sub-)row.  SPLIT = false is the
// one-launch path (the whole row of 2^log_n, k = 0, j = 0 folded in).  SPLIT =
// true does sub-row j of row (blockIdx.x >> k), 2^log_sub coefficients of a
// row of 2^log_n, k = log_n - log_sub: forward after the k global stages,
// inverse before them (so this body neither folds n^-1 nor reduces).
template <bool INVERSE, bool SPLIT>
__global__ void ntt_kernel(u64* __restrict__ out, const u64* __restrict__ in, int L, int log_n,
                           int log_sub_arg, const u64* __restrict__ w,
                           const u64* __restrict__ ws, const u64* __restrict__ mod,
                           const u64* __restrict__ inv_n, const u64* __restrict__ inv_n_s,
                           int canonical) {
    extern __shared__ u64 s[];
    const int log_sub = SPLIT ? log_sub_arg : log_n;
    const int k = log_n - log_sub;
    const int sn = 1 << log_sub;
    const int half_sn = sn >> 1;
    const int n = 1 << log_n;
    const long long sub = blockIdx.x;               // row << k | j
    const long long row = sub >> k;
    const int j = SPLIT ? (int)(sub & ((1 << k) - 1)) : 0;
    const int limb = (int)(row % L);
    const u64* src = in + sub * (long long)sn;
    u64* dst = out + sub * (long long)sn;
    const u64 p = mod[limb];
    const u64 two_p = 2 * p;
    const u64* wl = w + (long long)limb * n;
    const u64* wsl = ws + (long long)limb * n;

    for (int i = threadIdx.x; i < sn; i += blockDim.x) s[i] = src[i];
    __syncthreads();

    if (!INVERSE) {
        // local stage st (global st + k): m = 2^st blocks of 2h in the sub-row,
        // h = sn >> (st + 1); twiddle w[m (2^k + j) + i]
        for (int st = 0; st < log_sub; ++st) {
            const int m = 1 << st;
            const int tw = SPLIT ? m * ((1 << k) + j) : m;
            const int h_log = log_sub - st - 1;
            const int h = 1 << h_log;
            for (int b = threadIdx.x; b < half_sn; b += blockDim.x) {
                const int i = b >> h_log;
                const int i0 = (i << (h_log + 1)) + (b & (h - 1));
                const int i1 = i0 + h;
                u64 x0 = s[i0];
                x0 = x0 >= two_p ? x0 - two_p : x0;
                const u64 v = mul_mod_shoup_lazy(s[i1], wl[tw + i], wsl[tw + i], p);
                s[i0] = x0 + v;
                s[i1] = x0 - v + two_p;
            }
            __syncthreads();
        }
        for (int i = threadIdx.x; i < sn; i += blockDim.x)
            dst[i] = canonical ? reduce_twice(s[i], p) : s[i];
    } else {
        // stage st: n >> (st + 1) blocks of 2h over the row, h = 2^st; the
        // sub-row's share starts at j (sn >> (st + 1)); twiddle w[ofs + i]
        // walking the reordered table; the last stage multiplies by n^-1
        int ofs = 1;
        const u64 ninv = inv_n[limb];
        const u64 ninv_s = inv_n_s[limb];
        for (int st = 0; st < log_sub; ++st) {
            const int h = 1 << st;
            const bool last = !SPLIT && st == log_n - 1;
            const int tw = SPLIT ? ofs + j * (sn >> (st + 1)) : ofs;
            for (int b = threadIdx.x; b < half_sn; b += blockDim.x) {
                const int i = b >> st;
                const int i0 = (i << (st + 1)) + (b & (h - 1));
                const int i1 = i0 + h;
                const u64 a0 = s[i0];
                const u64 a1 = s[i1];
                u64 tt = a0 + a1;
                tt = tt >= two_p ? tt - two_p : tt;
                const u64 d = a0 - a1 + two_p;
                if (last) tt = mul_mod_shoup_lazy(tt, ninv, ninv_s, p);
                s[i0] = tt;
                s[i1] = mul_mod_shoup_lazy(d, wl[tw + i], wsl[tw + i], p);
            }
            ofs += n >> (st + 1);
            __syncthreads();
        }
        for (int i = threadIdx.x; i < sn; i += blockDim.x)
            dst[i] = canonical && !SPLIT ? reduce_once(s[i], p) : s[i];
    }
}

// One radix-2 stage over whole rows in global memory, one thread per
// butterfly (rows * N/2 of them): forward stage st of a large ring (st < k),
// or inverse stage st (st >= log N - k; the last folds n^-1 and, when asked,
// reduces to canonical).  In place when out == in: a thread reads and writes
// only its own two coefficients.
template <bool INVERSE>
__global__ void ntt_stage_kernel(u64* out, const u64* in, long long total, int L, int log_n,
                                 int st, const u64* __restrict__ w,
                                 const u64* __restrict__ ws, const u64* __restrict__ mod,
                                 const u64* __restrict__ inv_n,
                                 const u64* __restrict__ inv_n_s, int canonical) {
    const int n = 1 << log_n;
    const int half_n = n >> 1;
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const long long row = idx >> (log_n - 1);
        const int b = (int)(idx & (half_n - 1));
        const int limb = (int)(row % L);
        const u64 p = mod[limb];
        const u64 two_p = 2 * p;
        const u64* wl = w + (long long)limb * n;
        const u64* wsl = ws + (long long)limb * n;
        const u64* x = in + row * (long long)n;
        u64* y = out + row * (long long)n;
        if (!INVERSE) {
            const int m = 1 << st;
            const int h_log = log_n - st - 1;
            const int i = b >> h_log;
            const int i0 = (i << (h_log + 1)) + (b & ((1 << h_log) - 1));
            const int i1 = i0 + (1 << h_log);
            u64 x0 = x[i0];
            x0 = x0 >= two_p ? x0 - two_p : x0;
            const u64 v = mul_mod_shoup_lazy(x[i1], wl[m + i], wsl[m + i], p);
            y[i0] = x0 + v;
            y[i1] = x0 - v + two_p;
        } else {
            // reordered-table offset of stage st: 1 + sum_{t < st} n >> (t + 1)
            const int ofs = 1 + n - (n >> st);
            const int h = 1 << st;
            const int i = b >> st;
            const int i0 = (i << (st + 1)) + (b & (h - 1));
            const int i1 = i0 + h;
            const u64 a0 = x[i0];
            const u64 a1 = x[i1];
            u64 tt = a0 + a1;
            tt = tt >= two_p ? tt - two_p : tt;
            const u64 d = a0 - a1 + two_p;
            u64 u = mul_mod_shoup_lazy(d, wl[ofs + i], wsl[ofs + i], p);
            if (st == log_n - 1) {
                tt = mul_mod_shoup_lazy(tt, inv_n[limb], inv_n_s[limb], p);
                if (canonical) {
                    tt = reduce_once(tt, p);
                    u = reduce_once(u, p);
                }
            }
            y[i0] = tt;
            y[i1] = u;
        }
    }
}

// Launch the shared-memory body over `blocks` (sub-)rows of 2^log_sub.
template <bool INVERSE, bool SPLIT>
static cudaError_t launch_rows(u64* out, const u64* in, unsigned blocks, int L, int log_n,
                               int log_sub, const u64* w, const u64* ws, const u64* mod,
                               const u64* inv_n, const u64* inv_n_s, int canonical,
                               cudaStream_t st) {
    const int sn = 1 << log_sub;
    const size_t smem = (size_t)sn * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(ntt_kernel<INVERSE, SPLIT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    ntt_kernel<INVERSE, SPLIT><<<blocks, sn / 2 < 1024 ? sn / 2 : 1024, smem, st>>>(
        out, in, L, log_n, log_sub, w, ws, mod, inv_n, inv_n_s, canonical);
    return cudaSuccess;
}

// out, in: [rows, N] with rows = batch * L (limb = row % L); tables [L, N],
// mod / inv_n / inv_n_s [L]; 2 <= N <= 65536.  N <= 16384 is one launch; a
// larger N is log2(N / 16384) stage launches and one sub-row launch, and its
// forward transform needs tmp, scratch of out's size, for the stages (the
// sub-row launch reads it and writes out).  Returns cudaGetLastError() after
// the last launch.
extern "C" int gst_ntt(void* out, const void* in, void* tmp, long long rows, long long L,
                       long long log_n, const void* w, const void* ws,
                       const void* mod, const void* inv_n, const void* inv_n_s,
                       long long inverse, long long canonical, void* stream) {
    if (log_n < 1 || log_n > 16) return (int)cudaErrorInvalidValue;
    const int k = log_n > NTT_SHARED_LOG_N ? (int)log_n - NTT_SHARED_LOG_N : 0;
    if (k > 0 && !inverse && tmp == nullptr) return (int)cudaErrorInvalidValue;
    const int lg = (int)log_n, log_sub = lg - k;
    const unsigned blocks = (unsigned)(rows << k);
    cudaStream_t st = (cudaStream_t)stream;
    const u64 *W = (const u64*)w, *WS = (const u64*)ws, *M = (const u64*)mod;
    const u64 *NI = (const u64*)inv_n, *NIS = (const u64*)inv_n_s;
    u64 *o = (u64*)out, *t = (u64*)tmp;
    const u64* x = (const u64*)in;
    const long long bfly = rows * ((1LL << lg) / 2);
    const int sthreads = 256;
    cudaError_t err;
    if (k == 0) {
        err = inverse ? launch_rows<true, false>(o, x, blocks, (int)L, lg, lg, W, WS, M, NI,
                                                 NIS, (int)canonical, st)
                      : launch_rows<false, false>(o, x, blocks, (int)L, lg, lg, W, WS, M, NI,
                                                  NIS, (int)canonical, st);
    } else if (!inverse) {
        for (int s = 0; s < k; ++s)
            ntt_stage_kernel<false><<<grid_for(bfly, sthreads), sthreads, 0, st>>>(
                t, s == 0 ? x : t, bfly, (int)L, lg, s, W, WS, M, NI, NIS, 0);
        err = launch_rows<false, true>(o, t, blocks, (int)L, lg, log_sub, W, WS, M, NI, NIS,
                                       (int)canonical, st);
    } else {
        err = launch_rows<true, true>(o, x, blocks, (int)L, lg, log_sub, W, WS, M, NI, NIS, 0,
                                      st);
        for (int s = log_sub; s < lg && err == cudaSuccess; ++s)
            ntt_stage_kernel<true><<<grid_for(bfly, sthreads), sthreads, 0, st>>>(
                o, o, bfly, (int)L, lg, s, W, WS, M, NI, NIS, (int)canonical);
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
