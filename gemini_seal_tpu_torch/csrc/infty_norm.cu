// K10: the infinity norm of each RNS limb under the centred lift.
//
// Replaces gemini_seal_tpu/ops/dyadic.py poly_infty_norm (:135-141: a > p>>1
// ? p - a : a, then the max over the coefficient axis), which XLA lowers for
// the TPU as a select and a reduction.
//
//   out[r, l] = max_j (a[r, l, j] > (p_l >> 1) ? p_l - a[r, l, j] : a[r, l, j])
//   for residues a in [0, p_l)
//
// Bound on the H100: bytes.  Each coefficient is read once and one word a
// row is written (ex1's ciphertext, 2 x 2 x 4096 words: 131 KB, about 0.04 us
// at 3.35 TB/s), so at the per-op API's sizes the launch and one load's
// latency set the time.
//
// Design.  A row is spread over a cluster of 2^log_tiles CTAs (at most 8,
// as many as bring the call to about two CTAs an SM; one where the rows
// alone fill the card, as bench.py's batch does): the grid's x axis holds
// the leading rows times the row's tiles, split by a shift and a mask, and
// y the limb, so nothing is divided.  Each thread reads 16 bytes (two
// coefficients) per step, `iters` steps a row apart by the cluster's
// width, and keeps the largest centred magnitude; each warp reduces with
// two warp reductions (the high words, then the low words of the lanes
// that hold the top one), and its lane 0 stores the maximum into rank 0's
// shared memory (distributed shared memory) once every CTA of the cluster
// has started (a relaxed cluster arrive at entry, its wait before the
// store); after the cluster barrier that follows, rank 0's first warp
// reduces those words and writes the row's one word.
// There is no second launch and no memset.  The moduli arrive by value in
// the parameter struct (the host copies them once, ops/dyadic.py), so the
// only global loads are the coefficients.  The host picks the geometry
// (ops/dyadic.py infty_norm_geometry: at ex1's [2, 2, 4096], 256 threads
// and a cluster of 8 CTAs a row).
#include <cooperative_groups.h>

#include "modops.cuh"

namespace cg = cooperative_groups;

#define INFTY_NORM_MAX_L 64
#define INFTY_NORM_MAX_CLUSTER 8

struct InftyNormParams {
    u64* out;
    const u64* a;
    int log_n, L;       // log2 N, limbs
    int log_tiles;      // CTAs a row (the cluster): grid x = rows << log_tiles
    int iters;          // 16-byte steps a thread
    u64 p[INFTY_NORM_MAX_L];
};

// the warp's largest value: the high words' maximum, then the largest low
// word among the lanes that hold it (two warp reductions)
__device__ __forceinline__ u64 warp_max(u64 m) {
    const unsigned hi = (unsigned)(m >> 32);
    const unsigned top = __reduce_max_sync(0xffffffffu, hi);
    const unsigned lo = __reduce_max_sync(0xffffffffu, hi == top ? (unsigned)m : 0u);
    return ((u64)top << 32) | lo;
}

template <bool CLUSTER>
__global__ void __launch_bounds__(256) infty_norm_kernel(const __grid_constant__ InftyNormParams P) {
    // rank 0's slots: one word a warp of each CTA of the cluster
    __shared__ u64 slots[INFTY_NORM_MAX_CLUSTER * 8];
    // every CTA of the cluster must have started before one writes into
    // rank 0's shared memory: arrive now, wait just before that store, so
    // the wait overlaps the coefficient loads
    if constexpr (CLUSTER) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    const int l = blockIdx.y;
    const unsigned tile = blockIdx.x & ((1u << P.log_tiles) - 1);
    const unsigned r = blockIdx.x >> P.log_tiles;
    const u64 p = P.p[l], half = p >> 1;
    const unsigned n = 1u << P.log_n;
    const u64* src = P.a + (((unsigned long long)r * P.L + l) << P.log_n);
    const unsigned step = (blockDim.x << P.log_tiles) * 2;
    unsigned j = (tile * blockDim.x + threadIdx.x) * 2;
    u64 m = 0;
    for (int it = 0; it < P.iters; ++it, j += step) {
        if (j < n) {
            const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(src + j);
            const u64 m0 = v.x > half ? p - v.x : v.x;
            const u64 m1 = v.y > half ? p - v.y : v.y;
            const u64 mm = m0 > m1 ? m0 : m1;
            m = mm > m ? mm : m;
        }
    }
    m = warp_max(m);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    if constexpr (CLUSTER) {
        cg::cluster_group cluster = cg::this_cluster();
        asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
        if (lane == 0) *cluster.map_shared_rank(slots + tile * warps + warp, 0) = m;
        cluster.sync();
        if (tile != 0 || warp != 0) return;
    } else {
        if (lane == 0) slots[warp] = m;
        __syncthreads();
        if (warp != 0) return;
    }
    const int words = warps << P.log_tiles;   // at most 64
    m = lane < words ? slots[lane] : 0;
    if (lane + 32 < words) m = slots[lane + 32] > m ? slots[lane + 32] : m;
    m = warp_max(m);
    if (lane == 0) P.out[(unsigned long long)r * P.L + l] = m;
}

// out: [R, L]; a: [R, L, N] (N = 2^log_n, at least 2); mod: L u64 in host
// memory.  The geometry (threads, log_tiles: a cluster of 2^log_tiles CTAs a
// row, iters: 16-byte steps a thread) is the host's; one that does not cover
// the row returns cudaErrorInvalidValue without a launch.  Returns
// cudaGetLastError() (or the launch's error) after the launch.
extern "C" int gst_infty_norm(void* out, const void* a, const void* mod, long long R,
                              long long L, long long log_n, long long threads,
                              long long log_tiles, long long iters, void* stream) {
    if (R < 1 || L < 1 || L > INFTY_NORM_MAX_L || log_n < 1 || log_n > 17 || threads < 32 ||
        threads > 256 || threads % 32 || log_tiles < 0 || (1 << log_tiles) > INFTY_NORM_MAX_CLUSTER ||
        iters < 1 || ((threads * iters) << log_tiles) * 2 < (1LL << log_n) ||
        (R << log_tiles) >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    InftyNormParams P;
    P.out = (u64*)out;
    P.a = (const u64*)a;
    P.log_n = (int)log_n;
    P.L = (int)L;
    P.log_tiles = (int)log_tiles;
    P.iters = (int)iters;
    const u64* h = (const u64*)mod;
    for (int l = 0; l < L; ++l) P.p[l] = h[l];
    const dim3 grid((unsigned)(R << log_tiles), (unsigned)L);
    cudaStream_t st = (cudaStream_t)stream;
    if (log_tiles == 0) {
        infty_norm_kernel<false><<<grid, (unsigned)threads, 0, st>>>(P);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3((unsigned)threads);
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1u << log_tiles;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, infty_norm_kernel<true>, P);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

__global__ void empty_cluster_kernel() {}

// An empty kernel launched as K10 launches: `blocks` CTAs of `threads` in
// clusters of `cluster` (1: a plain launch).  The launch floor of K10's
// calls (chip_smoke.py launch_floor, port_tools/small_kernels.py).
extern "C" int gst_empty_cluster_launch(long long blocks, long long threads, long long cluster,
                                        void* stream) {
    if (blocks < 1 || threads < 1 || threads > 1024 || cluster < 1 || cluster > 8 ||
        blocks % cluster)
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_cluster_kernel);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
