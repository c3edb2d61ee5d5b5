// K5: Galois permutation of residue rows by R tables at once, unsigned (NTT
// domain) or signed (power basis), shared or paired.
//
// Replaces gemini_seal_tpu/ops/galois.py GaloisTool.apply_galois_ntt
// (galois.py:123-127), the R-table gather of the mod-up digits in
// batched_rotated_inner_product (ops/keyswitch.py:403-405), the power-basis
// GaloisTool.apply_galois (galois.py:115-121: a gather, then neg_mod where the
// table's sign flag is set), the per-rotation output permutations of the
// counter-rotated-key forms of build_bfv_rotate_many / build_ckks_rotate_many
// (models/pipelines.py:386-392, 480-484) and prepermute_galois_stack
// (:291-316), which XLA lowers for the TPU as a gather over the last axis
// (plus a select and a moveaxis copy).
//
//   shared: out[b, r, row, j] = f(x[b,    row, tab[r, j] & (N-1)])
//   paired: out[b, r, row, j] = f(x[b, r, row, tab[r, j] & (N-1)])
//   f(v) = neg_mod(v, p[row % L]) where bit log N of tab[r, j] is set (signed
//   mode, mod given), else v
//
// Bound on the H100: bytes only.  Each input row is read once, each output
// row written once (R output rows an input row in the shared mode), and the
// tables (32-bit entries) once; the sign flip is one compare and one
// subtract.  The permutation is a bit-reversed (NTT) or strided (power basis)
// index map, so the reads of one output row are scattered over its input row.
// Measured on the H100 (chip_smoke.py, PERF.md): 1.2-1.4x the bound on the
// card-bound paths (config 5 1.16 against 0.96 ms a step, config 2'
// prepermuted 0.050 against 0.040), faster there than torch.gather; on calls
// of a few rows (the per-op API, the refresh) latency sets the time, and the
// row's copy into shared memory before its first gather makes it slower
// than a gather straight from device memory.
//
// Design: a persistent grid walks the input rows.  Each CTA copies an input
// row (up to N=8192) whole into shared memory with one TMA bulk copy
// (cp.async.bulk completing on an mbarrier), so device memory sees each
// input row once; a ring of three stages keeps the copies of the next two
// rows in flight while this one is gathered.  From the staged row the CTA
// writes all R output rows of the shared mode, gathering in shared memory,
// four pairs a thread in flight, and storing coalesced 16-byte pairs.  When
// rows are too few to fill the card twice over, a row's output pairs are
// split over several work units, each a whole number of the CTA's sweeps.
// Above N=8192 the tables say how a row is held: the NTT-domain
// permutations map each 8192-coefficient output slice to one input slice (a
// block map rides after the table entries), so a CTA stages one input slice
// and writes, for each table, the output slice that reads it, with no
// exchange; any other table (the power basis) runs on a cluster of N/8192
// CTAs (2 at 16384, 4 at 32768, 8 at 65536), one slice each, gathering across
// the slices over distributed shared memory, a cluster barrier after each
// row's copy lands.  The tables are 32-bit (index in bits 0 .. log N - 1,
// the sign in bit log N), half the bytes of the int64 tables they mirror,
// and the output is laid out [B, R, rows, N] directly, so the hoisted key
// switch needs no moveaxis copy.
#include <cooperative_groups.h>

#include "modops.cuh"

namespace cg = cooperative_groups;

// the largest slice of a row that one CTA stages (8192 words, 64 KB a stage;
// ops/galois.py KERNEL_SLICE)
#define GALOIS_SLICE_LOG 13

struct GaloisArgs {
    u64* out;
    const u64* x;
    const int* tab;
    const u64* mod;
    long long units;  // input rows x parts
    int parts;        // a row's output pairs split over this many work units
    int rows, R, L, log_n, log_s;
};

// pairs of outputs a thread has in flight: its gathers are issued together
#define GALOIS_UNROLL 4
// staged rows a CTA holds: the copies of the next GALOIS_STAGES - 1 rows
// overlap the gathers of this one
#define GALOIS_STAGES 3

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
    return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of transactions on the barrier, then
// the bulk copy that delivers them
__device__ __forceinline__ void bulk_load(u64* dst, const u64* src, unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
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

// How a CTA holds an input row: WHOLE (N <= 8192, the row in one CTA),
// SLICES (N > 8192 through block-local tables: each CTA stages one slice of
// the row and writes the output slice that reads it, no exchange) or
// CLUSTER (any other table: a cluster of CTAs holds the row, one slice each,
// and gathers across the slices over distributed shared memory).
enum { WHOLE = 0, SLICES = 1, CLUSTER = 2 };

template <bool SIGNED, bool PAIRED, int MODE>
__global__ void __launch_bounds__(1024) galois_kernel(const GaloisArgs a) {
    extern __shared__ __align__(16) u64 buf[];  // GALOIS_STAGES stages of 2^log_s words
    __shared__ __align__(8) unsigned long long bar[GALOIS_STAGES];
    const int S = 1 << a.log_s;
    const int n = 1 << a.log_n;
    const int C = n >> a.log_s;  // slices a row
    const int G = MODE == CLUSTER ? C : 1;  // CTAs a work unit
    const int rank = MODE == CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
    const long long first = blockIdx.x / G;
    const long long stride = gridDim.x / G;
    const unsigned bytes = (unsigned)S * 8u;
    // a unit is one part of an input row (WHOLE, CLUSTER) or of one of its
    // slices (SLICES): its staged slice is item * n + slice * S
    auto slice_of = [&](long long unit) -> int {
        return MODE == SLICES ? (int)(unit / a.parts % C) : rank;
    };
    auto item_of = [&](long long unit) -> long long {
        return MODE == SLICES ? unit / a.parts / C : unit / a.parts;
    };
    auto source = [&](long long unit) -> const u64* {
        return a.x + item_of(unit) * n + (long long)slice_of(unit) * S;
    };
    // the output slice that reads input slice b through table r (SLICES)
    const int* bmap = a.tab + (long long)a.R * n;
    // an input row's output pairs in this CTA's slice: R rows (shared) or
    // one (paired) of S / 2 pairs, split over a.parts units
    const int lh = a.log_s - 1;
    const int pairs = (PAIRED ? 1 : a.R) << lh;
    const int span = (pairs + a.parts - 1) / a.parts;
    if (threadIdx.x == 0) {
        for (int i = 0; i < GALOIS_STAGES; ++i) mbar_init(&bar[i]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (MODE == CLUSTER)
        cg::this_cluster().sync();
    else
        __syncthreads();
    if (threadIdx.x == 0)
        for (int i = 0; i < GALOIS_STAGES - 1 && first + i * stride < a.units; ++i)
            bulk_load(buf + i * S, source(first + i * stride), bytes, &bar[i]);
    int k = 0;
    for (long long unit = first; unit < a.units; unit += stride, ++k) {
        const int stage = k % GALOIS_STAGES;
        mbar_wait(&bar[stage], (k / GALOIS_STAGES) & 1);
        // the row is staged (in every slice of the cluster), and no CTA still
        // reads the stage that the last unit used: refill it
        if (MODE == CLUSTER)
            cg::this_cluster().sync();
        else
            __syncthreads();
        const long long ahead = unit + (GALOIS_STAGES - 1) * stride;
        const int refill = (k + GALOIS_STAGES - 1) % GALOIS_STAGES;
        if (threadIdx.x == 0 && ahead < a.units)
            bulk_load(buf + refill * S, source(ahead), bytes, &bar[refill]);
        u64* staged = buf + stage * S;
        const long long item = item_of(unit);
        const int cs = slice_of(unit);
        const int f0 = (int)(unit % a.parts) * span;
        const int f1 = f0 + span < pairs ? f0 + span : pairs;
        const long long row = item % a.rows;
        const long long b = item / a.rows;  // paired: b * R + r
        const u64 p = SIGNED ? a.mod[row % a.L] : 0;
        const int rp = PAIRED ? (int)(b % a.R) : 0;
        for (int f = f0 + (int)threadIdx.x; f < f1; f += GALOIS_UNROLL * (int)blockDim.x) {
            int2 ij[GALOIS_UNROLL];
            ulonglong2 v[GALOIS_UNROLL];
            int os[GALOIS_UNROLL];  // the output slice
#pragma unroll
            for (int i = 0; i < GALOIS_UNROLL; ++i) {
                const int fi = f + i * (int)blockDim.x;
                const int r = PAIRED ? rp : fi >> lh;
                os[i] = cs;
                if (fi < f1) {
                    if (MODE == SLICES) os[i] = __ldg(bmap + r * C + cs);
                    ij[i] = __ldg((const int2*)(a.tab + (long long)r * n + (long long)os[i] * S) +
                                  (fi & ((1 << lh) - 1)));
                }
            }
#pragma unroll
            for (int i = 0; i < GALOIS_UNROLL; ++i) {
                if (f + i * (int)blockDim.x < f1) {
                    if (MODE == CLUSTER) {
                        const int jx = ij[i].x & (n - 1), jy = ij[i].y & (n - 1);
                        cg::cluster_group cl = cg::this_cluster();
                        v[i].x = cl.map_shared_rank(staged, jx >> a.log_s)[jx & (S - 1)];
                        v[i].y = cl.map_shared_rank(staged, jy >> a.log_s)[jy & (S - 1)];
                    } else {
                        v[i].x = staged[ij[i].x & (S - 1)];
                        v[i].y = staged[ij[i].y & (S - 1)];
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < GALOIS_UNROLL; ++i) {
                const int fi = f + i * (int)blockDim.x;
                if (fi < f1) {
                    if (SIGNED) {
                        if ((ij[i].x >> a.log_n) & 1) v[i].x = neg_mod(v[i].x, p);
                        if ((ij[i].y >> a.log_n) & 1) v[i].y = neg_mod(v[i].y, p);
                    }
                    const int r = PAIRED ? rp : fi >> lh;
                    const long long orow = PAIRED ? item : (b * a.R + r) * a.rows + row;
                    ((ulonglong2*)(a.out + orow * n + (long long)os[i] * S))[fi & ((1 << lh) - 1)] =
                        v[i];
                }
            }
        }
    }
    if (MODE == CLUSTER) cg::this_cluster().sync();  // no CTA leaves while a peer reads its slice
}

// CTAs (or clusters) that fit on the card at once, per instantiation and
// slice size, found once
template <bool SIGNED, bool PAIRED, int MODE>
static cudaError_t launch(const GaloisArgs& a, cudaStream_t st) {
    static int resident[GALOIS_SLICE_LOG + 1];
    auto kernel = galois_kernel<SIGNED, PAIRED, MODE>;
    const int S = 1 << a.log_s;
    const int lc = a.log_n - a.log_s;
    const int G = MODE == CLUSTER ? 1 << lc : 1;  // CTAs a unit
    const int threads = S / 2 < 32 ? 32 : (S / 2 > 1024 ? 1024 : S / 2);
    const size_t smem = GALOIS_STAGES * (size_t)S * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = G;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    if (MODE == CLUSTER) {
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
    }
    int& fit = resident[a.log_s];
    if (fit == 0) {
        if (MODE == CLUSTER) {
            cfg.gridDim = dim3(G);
            err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
        } else {
            int dev = 0, sms = 0, per_sm = 0;
            err = cudaGetDevice(&dev);
            if (err == cudaSuccess)
                err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            if (err == cudaSuccess)
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                                    smem);
            fit = per_sm * sms;
        }
        if (err != cudaSuccess) return err;
        if (fit == 0) return cudaErrorInvalidConfiguration;
    }
    // split a row's outputs over several units when there are too few rows
    // to keep every resident CTA (cluster) busy twice over: into the fewest
    // parts that do, each a whole number of the CTA's unrolled sweeps (or
    // into one part a sweep, when no divisor reaches that many)
    GaloisArgs g = a;
    const long long staged = MODE == SLICES ? a.units << lc : a.units;  // rows or slices
    const long long sweeps = ((long long)(PAIRED ? 1 : a.R) << (a.log_s - 1)) /
                             ((long long)threads * GALOIS_UNROLL);
    long long parts = 1;
    while (parts < sweeps && (parts * staged < 2LL * fit || sweeps % parts))
        ++parts;
    g.parts = (int)parts;
    g.units = staged * parts;
    const long long groups = g.units < fit ? g.units : fit;
    cfg.gridDim = dim3((unsigned)(groups * G));
    err = cudaLaunchKernelEx(&cfg, kernel, g);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// out: [B, R, rows, N]; x: [B, rows, N] (shared) or [B, R, rows, N] (paired),
// 16-byte aligned, items = B * rows (shared) or B * R * rows (paired) input
// rows; tab: [R, N] int32 entries, index in bits 0 .. log N - 1 (masked, so
// no read leaves the row) and, in the signed mode, the sign in bit log N,
// followed by the [R, C] int32 block map of a row of C = max(1, N / 8192)
// slices (entry [r, b]: the output slice that reads input slice b through
// table r, valid when bit 1 of flags is set); 8-byte aligned; N a power of
// two, 2 <= N <= 65536.  mod: [L] moduli with rows % L == 0 (the signed
// mode), or NULL (unsigned).  flags: bit 0 paired, bit 1 every output slice
// of every table reads one input slice (the block map holds).  Returns
// cudaErrorInvalidConfiguration when the card cannot hold one CTA (cluster),
// else cudaGetLastError() after the launch.
extern "C" int gst_galois(void* out, const void* x, const void* tab, const void* mod,
                          long long items, long long rows, long long n, long long R,
                          long long L, long long flags, void* stream) {
    if (n < 2 || n > 65536 || (n & (n - 1)) || rows < 1 || R < 1 || items < 1 ||
        (mod != nullptr && (L < 1 || rows % L)))
        return (int)cudaErrorInvalidValue;
    GaloisArgs a;
    a.out = (u64*)out;
    a.x = (const u64*)x;
    a.tab = (const int*)tab;
    a.mod = (const u64*)mod;
    a.units = items;
    a.parts = 1;
    a.rows = (int)rows;
    a.R = (int)R;
    a.L = (int)(L < 1 ? 1 : L);
    a.log_n = 0;
    while ((1LL << a.log_n) < n) ++a.log_n;
    a.log_s = a.log_n < GALOIS_SLICE_LOG ? a.log_n : GALOIS_SLICE_LOG;
    const int mode = a.log_n == a.log_s ? WHOLE : (flags & 2) ? SLICES : CLUSTER;
    const bool paired = flags & 1;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
#define GALOIS_LAUNCH(SG, PD)                                 \
    (mode == WHOLE    ? launch<SG, PD, WHOLE>(a, st)          \
     : mode == SLICES ? launch<SG, PD, SLICES>(a, st)         \
                      : launch<SG, PD, CLUSTER>(a, st))
    if (mod != nullptr)
        err = paired ? GALOIS_LAUNCH(true, true) : GALOIS_LAUNCH(true, false);
    else
        err = paired ? GALOIS_LAUNCH(false, true) : GALOIS_LAUNCH(false, false);
#undef GALOIS_LAUNCH
    return (int)err;
}
