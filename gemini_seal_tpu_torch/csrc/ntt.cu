// K1: negacyclic NTT over the last axis, forward and inverse, lazy or canonical.
//
// Replaces gemini_seal_tpu/ops/ntt.py ntt_forward_lazy / ntt_forward
// (ntt.py:241-319) and ntt_inverse_lazy / ntt_inverse (ntt.py:322-403),
// which XLA lowers for the TPU as log N (or log N / FUSE_STAGES) full passes
// over device memory, and the chunk-local stages of the coefficient-sharded
// NTT (mode sub_row: gemini_seal_tpu/parallel/ntt_sp.py _local_forward_stages
// :56-83 and the inverse local stages :160-182, :336-355).
//
// Bound on the H100: a row is N u64 (64 KB at N=8192) that must be read and
// written once, with log N stages of N/2 Shoup butterflies in between.  The
// bytes (rows in and out plus the twiddle tables) are chip_smoke.py's bound;
// the multiplies alone (~10 32-bit IMADs a butterfly) come to ~0.8 of it.
// But a butterfly costs up to about 36 SASS instructions (the 64-bit
// products, adds, compares and selects, and the index and memory work
// around them; chip_smoke.py counts them statically), and the H100 issues
// integer instructions on 64 lanes an SM a clock, so the instruction work
// comes to ~3x the byte bound at N=8192: that, not the bytes, is what this
// kernel runs up against.  Measured on the H100 (chip_smoke.py, PERF.md):
// 3.3x the byte bound on the fused step's calls (0.386 against 0.116 ms a
// step), 4.5x on config 5's.
//
// Design: radix-2^3 in registers, one launch a transform, a persistent grid.
// A row (or a sub_row chunk) of up to 8192 coefficients is one CTA; a larger
// one is one cluster of 2, 4 or 8 CTAs (16384, 32768, 65536), each holding an
// 8192-coefficient slice.  Each thread keeps E = 8 coefficients in registers
// and runs three stages on them between two exchanges through shared memory,
// so a transform is ceil(log_row / 3) passes with one barrier each instead of
// log N stages with a barrier and a shared-memory round trip each.  A
// thread's coefficients in a pass differ in the pass's three index bits; its
// stage-t butterflies take 2^t twiddle pairs.  The pass over the top index
// bits (the first forward, the last inverse) may run fewer stages, its other
// bits riding along.  A pass whose bits reach above the slice (a cross pass)
// reads and writes the peers' slices over distributed shared memory with a
// cluster barrier after it.  The grid walks the rows: while one is
// transformed, a TMA bulk copy (completing on an mbarrier) stages the next
// row's slice, and the forward's result slice leaves through a TMA bulk
// store (the inverse's top pass writes device memory coalesced).  The
// row's geometry is a template argument, so every pass's shared-memory
// offsets are constants; shared memory carries one pad word every 16 so that
// the lanes of a warp reading words 16 apart meet no bank conflict.  Each
// Shoup product adds -q p as q (2^64 - p), so the subtraction rides in the
// multiply-add.
//
// Every butterfly is the JAX radix-2 one exactly (only the order of
// independent butterflies differs), so the lazy outputs are bit-identical:
// forward keeps the accumulating lane in [0, 2p) and ends in [0, 4p); inverse
// folds n^-1 into the last stage of a whole ring and ends in [0, 2p); the
// canonical reduction happens at the store.  Twiddles follow the reference's
// tables: forward stage st of chunk d of 2^pre uses w[2^st + d 2^(st - pre) +
// i], inverse stage st uses the reordered entry ofs(st) + d (chunk >> (st +
// 1)) + i, ofs(st) = 1 + n - (n >> st) (pre = 0, d = 0 for a whole ring).
#include <cooperative_groups.h>

#include "modops.cuh"

namespace cg = cooperative_groups;

// the largest slice of a row that one CTA keeps in shared memory (8192
// coefficients: 64 KB staged and 68 KB padded working)
#define NTT_SLICE_LOG 13

struct NttArgs {
    u64* out;
    const u64* in;
    const u64* w;
    const u64* ws;
    const u64* mod;
    const u64* inv_n;
    const u64* inv_n_s;
    long long rows;
    int L, log_n, log_row, d, canonical;
};

// the shared-memory word of coefficient j of a slice: one pad word every 16
__device__ __forceinline__ int slot(int j) { return j + (j >> 4); }

// mul_mod_shoup_lazy(x, w, w_shoup, p) with neg_p = 2^64 - p: x w - q p mod
// 2^64 as x w + q neg_p, so that the product's add rides in the multiply-add
__device__ __forceinline__ u64 shoup_lazy(u64 x, u64 w, u64 w_shoup, u64 neg_p) {
    return x * w + __umul64hi(x, w_shoup) * neg_p;
}

// v >= two_p ? v - two_p : v, for v < 2^63 (every value here is below 4p <
// 2^62): the difference's sign says which
__device__ __forceinline__ u64 sub_if_ge(u64 v, u64 two_p) {
    const u64 d = v - two_p;
    return (long long)d < 0 ? v : d;
}

// R forward stages over the R bits of g in x[(g << NX) | xe], for each of the
// 2^NX riding bits xe (below the stage bits in the row's index).  The pass's
// first stage is local stage ls0; J is the index bits above the pass, so that
// stage t's butterfly block is i = (J << t) | (the top t bits of g).
template <int R, int NX>
__device__ __forceinline__ void fwd_stages(u64 (&x)[1 << (R + NX)], int bm, int ls0, int J,
                                           const u64* __restrict__ wl,
                                           const u64* __restrict__ wsl, u64 neg_p, u64 two_p) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
        const int hb = R - 1 - t;
        const int tw = (bm << (ls0 + t)) + (J << t);
#pragma unroll
        for (int q = 0; q < (1 << t); ++q) {
            const u64 w = __ldg(wl + tw + q);
            const u64 wsh = __ldg(wsl + tw + q);
#pragma unroll
            for (int low = 0; low < (1 << hb); ++low) {
#pragma unroll
                for (int xe = 0; xe < (1 << NX); ++xe) {
                    const int e0 = (((q << (hb + 1)) | low) << NX) | xe;
                    const int e1 = e0 | (1 << (hb + NX));
                    const u64 a = sub_if_ge(x[e0], two_p);
                    const u64 v = shoup_lazy(x[e1], w, wsh, neg_p);
                    x[e0] = a + v;
                    x[e1] = a - v + two_p;
                }
            }
        }
    }
}

// R inverse stages over the R bits of g (stage t on index bit lo + t); J is
// the index bits above the pass, so that stage t's block is i = (J << (R - t -
// 1)) | (the bits of g above t).  fold: the pass ends a whole ring, and its
// last stage multiplies the sum by n^-1.
template <int R, int NX>
__device__ __forceinline__ void inv_stages(u64 (&x)[1 << (R + NX)], int lo, int J, int n,
                                           int chunk, int d, bool fold,
                                           const u64* __restrict__ wl,
                                           const u64* __restrict__ wsl, u64 neg_p, u64 two_p,
                                           u64 ninv, u64 ninv_s) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
        const int st = lo + t;
        const int hq = R - 1 - t;
        const int tw = 1 + n - (n >> st) + d * (chunk >> (st + 1)) + (J << hq);
        const bool last = fold && t == R - 1;
#pragma unroll
        for (int q = 0; q < (1 << hq); ++q) {
            const u64 w = __ldg(wl + tw + q);
            const u64 wsh = __ldg(wsl + tw + q);
#pragma unroll
            for (int low = 0; low < (1 << t); ++low) {
#pragma unroll
                for (int xe = 0; xe < (1 << NX); ++xe) {
                    const int e0 = (((q << (t + 1)) | low) << NX) | xe;
                    const int e1 = e0 | (1 << (t + NX));
                    const u64 a0 = x[e0];
                    const u64 a1 = x[e1];
                    u64 tt = sub_if_ge(a0 + a1, two_p);
                    const u64 dd = a0 - a1 + two_p;
                    if (last) tt = shoup_lazy(tt, ninv, ninv_s, neg_p);
                    x[e0] = tt;
                    x[e1] = shoup_lazy(dd, w, wsh, neg_p);
                }
            }
        }
    }
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
    return (unsigned)__cvta_generic_to_shared(ptr);
}

// the next row's slice: one bulk copy into shared memory that completes on
// the mbarrier (one arrival expecting its bytes)
__device__ __forceinline__ void bulk_load(u64* dst, const u64* src, unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// a slice of the result to device memory: one bulk copy from shared memory
__device__ __forceinline__ void bulk_store(u64* dst, const u64* src, unsigned bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@!P1 bra WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// a barrier over the CTA, or over the cluster when the row spans several CTAs
__device__ __forceinline__ void sync_row(int k) {
    if (k)
        cg::this_cluster().sync();
    else
        __syncthreads();
}

// coefficient j of the row in the cluster's shared memory (slice j >> log_s)
__device__ __forceinline__ u64* peer(u64* base, int j, int log_s) {
    return cg::this_cluster().map_shared_rank(base, j >> log_s);
}

// slot(base + off) for off = e << lo and base zero in the pass's bits: the
// two have no low bits in common, so the pad words add up separately
template <int LO>
__device__ __forceinline__ constexpr int pad_off(int e) {
    return (e << LO) + ((e << LO) >> 4);
}

// the row's slice of 2^log_s coefficients for a row of 2^log_row (clusters
// of at most 8 CTAs)
__host__ __device__ constexpr int slice_log(int log_row) {
    return log_row < NTT_SLICE_LOG ? log_row
                                   : (log_row - 3 > NTT_SLICE_LOG ? log_row - 3 : NTT_SLICE_LOG);
}

// log2 of the coefficients a thread keeps in registers, for a slice of 2^log_s
__host__ __device__ constexpr int log_e_of(int log_s) { return log_s < 3 ? log_s : 3; }

// threads of a CTA for a row of 2^log_row
__host__ __device__ constexpr int threads_of(int log_row) {
    return 1 << (slice_log(log_row) - log_e_of(slice_log(log_row)));
}

// A persistent grid of CTAs (one a row) or clusters (2^K CTAs a row, CTA c
// holding slice c of 2^LOG_S coefficients) walks the rows.  Shared memory
// per CTA: the staged slice of the next row (filled by a bulk copy while
// this row is transformed), the forward's result slice (left by a bulk
// store), the working slice (padded, see slot) and the copy's mbarrier.  blockDim.x = 2^(LOG_S - LE); thread u = c 2^(LOG_S - LE)
// + threadIdx.x of the cluster takes, in a pass over index bits [lo, lo +
// LE), the coefficients whose other bits spell u.  A pass whose bits reach
// above LOG_S (a cross pass) reads and writes the peers' working slices;
// the barrier after it spans the cluster.  The row's geometry is a template
// argument, so that every pass's offsets are constants.
template <bool INVERSE, int LOG_ROW>
__global__ void __launch_bounds__(threads_of(LOG_ROW), 1) ntt_kernel(const NttArgs a) {
    extern __shared__ __align__(16) u64 smem[];
    constexpr int LOG_S = slice_log(LOG_ROW);
    constexpr int LE = log_e_of(LOG_S);
    constexpr int E = 1 << LE;
    constexpr int K = LOG_ROW - LOG_S;
    constexpr int S = 1 << LOG_S;
    constexpr int SMASK = S - 1;
    constexpr int NPASS = (LOG_ROW + LE - 1) / LE;
    constexpr int R_TOP = LOG_ROW - LE * (NPASS - 1);
    constexpr int LO_TOP = LOG_ROW - LE;  // the top pass's coefficients: u + (e << LO_TOP)
    const int c = K ? (int)cg::this_cluster().block_rank() : 0;
    u64* stage = smem;
    u64* outb = smem + S;  // the forward's result slice, stored by a bulk copy
    u64* work = smem + (INVERSE ? S : 2 * S);
    unsigned long long* bar = (unsigned long long*)(work + S + (S >> 4));
    const int n = 1 << a.log_n;
    const int u = (c << (LOG_S - LE)) | (int)threadIdx.x;
    const int pre = a.log_n - LOG_ROW;
    const int bm = (1 << pre) + a.d;
    const long long first = (long long)blockIdx.x >> K;
    const long long stride = (long long)gridDim.x >> K;
    const u64* src = a.in + (long long)c * S;
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    sync_row(K);
    if (threadIdx.x == 0 && first < a.rows)
        bulk_load(stage, src + (first << LOG_ROW), S * 8u, bar);
    int it = 0;
    for (long long row = first; row < a.rows; row += stride, ++it) {
        const int limb = (int)(row % a.L);
        const u64 p = a.mod[limb];
        const u64 two_p = 2 * p;
        const u64 neg_p = 0 - p;
        const u64* wl = a.w + (long long)limb * n;
        const u64* wsl = a.ws + (long long)limb * n;
        u64* dst = a.out + (row << LOG_ROW);
        const bool more = threadIdx.x == 0 && row + stride < a.rows;
        const u64* next = src + ((row + stride) << LOG_ROW);
        u64 x[E];
        mbar_wait(bar, it & 1);
        sync_row(K);  // the row is staged in every slice; the last row is done everywhere
        if (!INVERSE) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int j = u + (e << LO_TOP);
                x[e] = K ? peer(stage, j, LOG_S)[j & SMASK] : stage[j];
            }
            fwd_stages<R_TOP, LE - R_TOP>(x, bm, 0, 0, wl, wsl, neg_p, two_p);
            if (NPASS == 1) {  // one pass, one CTA
                __syncthreads();
                if (more) bulk_load(stage, next, S * 8u, bar);
#pragma unroll
                for (int e = 0; e < E; ++e)
                    dst[u + (e << LO_TOP)] = a.canonical ? reduce_twice(x[e], p) : x[e];
                continue;
            }
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int j = u + (e << LO_TOP);
                if (K)
                    peer(work, j, LOG_S)[slot(j & SMASK)] = x[e];
                else
                    work[slot(u) + pad_off<LO_TOP>(e)] = x[e];
            }
            // the staged row is read everywhere: refill it; the last row's
            // result slice has left the out buffer
            if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
            sync_row(K);
            if (more) bulk_load(stage, next, S * 8u, bar);
#pragma unroll
            for (int pass = 1; pass < NPASS; ++pass) {
                const int lo = LOG_ROW - R_TOP - pass * LE;
                const bool cross = lo + LE > LOG_S;
                const int base = (u & ((1 << lo) - 1)) | ((u >> lo) << (lo + LE));
                const int sb = slot(base & SMASK);
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const int j = base + (e << lo);
                    x[e] = cross ? peer(work, j, LOG_S)[slot(j & SMASK)]
                                 : work[sb + (e << lo) + ((e << lo) >> 4)];
                }
                fwd_stages<LE, 0>(x, bm, LOG_ROW - lo - LE, u >> lo, wl, wsl, neg_p, two_p);
                if (pass == NPASS - 1) {  // lo = 0: E neighbouring coefficients of the slice
                    ulonglong2* o2 = (ulonglong2*)(outb + (base & SMASK));
#pragma unroll
                    for (int e = 0; e < E; e += 2) {
                        ulonglong2 v;
                        v.x = a.canonical ? reduce_twice(x[e], p) : x[e];
                        v.y = a.canonical ? reduce_twice(x[e + 1], p) : x[e + 1];
                        o2[e >> 1] = v;
                    }
                    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                    __syncthreads();
                    if (threadIdx.x == 0) bulk_store(dst + (long long)c * S, outb, S * 8u);
                } else {
#pragma unroll
                    for (int e = 0; e < E; ++e) {
                        const int j = base + (e << lo);
                        if (cross)
                            peer(work, j, LOG_S)[slot(j & SMASK)] = x[e];
                        else
                            work[sb + (e << lo) + ((e << lo) >> 4)] = x[e];
                    }
                    sync_row(cross ? K : 0);
                }
            }
        } else {
            const int chunk = 1 << LOG_ROW;
#pragma unroll 4
            for (int i = threadIdx.x; i < S; i += blockDim.x) work[slot(i)] = stage[i];
            __syncthreads();  // the staged slice is read: refill it
            if (more) bulk_load(stage, next, S * 8u, bar);
#pragma unroll
            for (int pass = 0; pass < NPASS - 1; ++pass) {
                const int lo = pass * LE;
                const bool cross = lo + LE > LOG_S;
                const bool next_cross = pass + 2 == NPASS ? K > 0 : lo + 2 * LE > LOG_S;
                const int base = (u & ((1 << lo) - 1)) | ((u >> lo) << (lo + LE));
                const int sb = slot(base & SMASK);
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const int j = base + (e << lo);
                    x[e] = cross ? peer(work, j, LOG_S)[slot(j & SMASK)]
                                 : work[sb + (e << lo) + ((e << lo) >> 4)];
                }
                inv_stages<LE, 0>(x, lo, u >> lo, n, chunk, a.d, false, wl, wsl, neg_p, two_p,
                                  0, 0);
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const int j = base + (e << lo);
                    if (cross)
                        peer(work, j, LOG_S)[slot(j & SMASK)] = x[e];
                    else
                        work[sb + (e << lo) + ((e << lo) >> 4)] = x[e];
                }
                sync_row(next_cross ? K : 0);
            }
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int j = u + (e << LO_TOP);
                x[e] = K ? peer(work, j, LOG_S)[slot(j & SMASK)]
                         : work[slot(u) + pad_off<LO_TOP>(e)];
            }
            inv_stages<R_TOP, LE - R_TOP>(x, LOG_ROW - R_TOP, 0, n, chunk, a.d, pre == 0, wl,
                                          wsl, neg_p, two_p, a.inv_n[limb], a.inv_n_s[limb]);
#pragma unroll
            for (int e = 0; e < E; ++e)
                dst[u + (e << LO_TOP)] = a.canonical ? reduce_once(x[e], p) : x[e];
        }
    }
    if (!INVERSE && threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    if (K) cg::this_cluster().sync();  // no CTA leaves while a peer reads its slices
}

// Launch the persistent grid: as many CTAs (clusters) as fit on the card at
// once, found once per instantiation, and no more than the rows.
template <bool INVERSE, int LOG_ROW>
static cudaError_t launch(const NttArgs& a, cudaStream_t st) {
    constexpr int LOG_S = slice_log(LOG_ROW);
    constexpr int K = LOG_ROW - LOG_S;
    constexpr int S = 1 << LOG_S;
    static int fit = 0;
    auto kernel = ntt_kernel<INVERSE, LOG_ROW>;
    const int threads = threads_of(LOG_ROW);
    const size_t smem = (size_t)((INVERSE ? 2 : 3) * S + (S >> 4) + 1) * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1u << K;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    if (K) {
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
    }
    if (fit == 0) {
        int found = 0;
        if (K) {
            cfg.gridDim = dim3(1u << K);
            err = cudaOccupancyMaxActiveClusters(&found, kernel, &cfg);
        } else {
            int dev = 0, sms = 0, per_sm = 0;
            err = cudaGetDevice(&dev);
            if (err == cudaSuccess)
                err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            if (err == cudaSuccess)
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                                    smem);
            found = per_sm * sms;
        }
        if (err != cudaSuccess) return err;
        if (found == 0) return cudaErrorInvalidConfiguration;
        fit = found;
    }
    const long long groups = a.rows < fit ? a.rows : fit;
    cfg.gridDim = dim3((unsigned)(groups << K));
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <bool INVERSE, int LOG_ROW = 16>
static cudaError_t dispatch(const NttArgs& a, cudaStream_t st) {
    if (a.log_row == LOG_ROW) return launch<INVERSE, LOG_ROW>(a, st);
    if constexpr (LOG_ROW > 1) return dispatch<INVERSE, LOG_ROW - 1>(a, st);
    return cudaErrorInvalidValue;
}

// out, in: [rows, 2^log_row] with rows = batch * L (limb = row % L), 16-byte
// aligned; tables [L, N], mod / inv_n / inv_n_s [L]; 2 <= N <= 65536.
//
// log_row = log_n (sub_j = 0): the whole transform.
// log_row < log_n (mode sub_row): the chunk-local stages of chunk sub_j of
// 2^(log_n - log_row): forward stages log_n - log_row .. log_n - 1 (canonical
// or lazy), or inverse stages 0 .. log_row - 1 (lazy only).
//
// One launch of a persistent grid: one CTA a row up to 8192 coefficients,
// one cluster of 2^(log_row - 13) CTAs a row above.  Returns
// cudaErrorInvalidConfiguration when the card cannot hold one such CTA or
// cluster, else cudaGetLastError() after the launch.
extern "C" int gst_ntt(void* out, const void* in, long long rows, long long L, long long log_n,
                       long long log_row, long long sub_j, const void* w, const void* ws,
                       const void* mod, const void* inv_n, const void* inv_n_s,
                       long long inverse, long long canonical, void* stream) {
    if (log_n < 1 || log_n > 16 || log_row < 1 || log_row > log_n || L < 1)
        return (int)cudaErrorInvalidValue;
    const int pre = (int)(log_n - log_row);  // the stages that run elsewhere (cross stages)
    if (sub_j < 0 || sub_j >= (1LL << pre) || (pre > 0 && inverse && canonical))
        return (int)cudaErrorInvalidValue;
    NttArgs a;
    a.out = (u64*)out;
    a.in = (const u64*)in;
    a.w = (const u64*)w;
    a.ws = (const u64*)ws;
    a.mod = (const u64*)mod;
    a.inv_n = (const u64*)inv_n;
    a.inv_n_s = (const u64*)inv_n_s;
    a.rows = rows;
    a.L = (int)L;
    a.log_n = (int)log_n;
    a.log_row = (int)log_row;
    a.d = (int)sub_j;
    a.canonical = (int)canonical;
    if (rows < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return (int)(inverse ? dispatch<true>(a, st) : dispatch<false>(a, st));
}
