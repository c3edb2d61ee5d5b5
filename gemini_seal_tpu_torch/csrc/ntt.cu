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
#include "modops.cuh"

template <bool INVERSE>
__global__ void ntt_kernel(u64* __restrict__ out, const u64* __restrict__ in,
                           int L, int log_n,
                           const u64* __restrict__ w, const u64* __restrict__ ws,
                           const u64* __restrict__ mod,
                           const u64* __restrict__ inv_n, const u64* __restrict__ inv_n_s,
                           int canonical) {
    extern __shared__ u64 s[];
    const int n = 1 << log_n;
    const int half_n = n >> 1;
    const long long row = blockIdx.x;
    const int limb = (int)(row % L);
    const u64* src = in + row * (long long)n;
    u64* dst = out + row * (long long)n;
    const u64 p = mod[limb];
    const u64 two_p = 2 * p;
    const u64* wl = w + (long long)limb * n;
    const u64* wsl = ws + (long long)limb * n;

    for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
    __syncthreads();

    if (!INVERSE) {
        // stage st: m = 2^st blocks of 2h, h = n >> (st + 1); twiddle w[m + i]
        for (int st = 0; st < log_n; ++st) {
            const int m = 1 << st;
            const int h_log = log_n - st - 1;
            const int h = 1 << h_log;
            for (int b = threadIdx.x; b < half_n; b += blockDim.x) {
                const int i = b >> h_log;
                const int i0 = (i << (h_log + 1)) + (b & (h - 1));
                const int i1 = i0 + h;
                u64 x0 = s[i0];
                x0 = x0 >= two_p ? x0 - two_p : x0;
                const u64 v = mul_mod_shoup_lazy(s[i1], wl[m + i], wsl[m + i], p);
                s[i0] = x0 + v;
                s[i1] = x0 - v + two_p;
            }
            __syncthreads();
        }
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            dst[i] = canonical ? reduce_twice(s[i], p) : s[i];
    } else {
        // stage st: n >> (st + 1) blocks of 2h, h = 2^st; twiddle w[ofs + i]
        // walking the reordered table; the last stage multiplies by n^-1
        int ofs = 1;
        const u64 ninv = inv_n[limb];
        const u64 ninv_s = inv_n_s[limb];
        for (int st = 0; st < log_n; ++st) {
            const int h = 1 << st;
            const bool last = st == log_n - 1;
            for (int b = threadIdx.x; b < half_n; b += blockDim.x) {
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
                s[i1] = mul_mod_shoup_lazy(d, wl[ofs + i], wsl[ofs + i], p);
            }
            ofs += n >> (st + 1);
            __syncthreads();
        }
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            dst[i] = canonical ? reduce_once(s[i], p) : s[i];
    }
}

// out, in: [rows, N] with rows = batch * L (limb = row % L); tables [L, N],
// mod / inv_n / inv_n_s [L].  Returns cudaGetLastError() after the launch.
extern "C" int gst_ntt(void* out, const void* in, long long rows, long long L,
                       long long log_n, const void* w, const void* ws,
                       const void* mod, const void* inv_n, const void* inv_n_s,
                       long long inverse, long long canonical, void* stream) {
    const int n = 1 << log_n;
    const size_t smem = (size_t)n * sizeof(u64);
    const int threads = n / 2 < 1024 ? n / 2 : 1024;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (inverse) {
        err = cudaFuncSetAttribute(ntt_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        ntt_kernel<true><<<(unsigned)rows, threads, smem, st>>>(
            (u64*)out, (const u64*)in, (int)L, (int)log_n, (const u64*)w,
            (const u64*)ws, (const u64*)mod, (const u64*)inv_n,
            (const u64*)inv_n_s, (int)canonical);
    } else {
        err = cudaFuncSetAttribute(ntt_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        ntt_kernel<false><<<(unsigned)rows, threads, smem, st>>>(
            (u64*)out, (const u64*)in, (int)L, (int)log_n, (const u64*)w,
            (const u64*)ws, (const u64*)mod, (const u64*)inv_n,
            (const u64*)inv_n_s, (int)canonical);
    }
    return (int)cudaGetLastError();
}
