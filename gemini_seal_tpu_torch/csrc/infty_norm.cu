// K10: the infinity norm of each RNS limb under the centred lift.
//
// Replaces gemini_seal_tpu/ops/dyadic.py poly_infty_norm (:135-141: a > p>>1
// ? p - a : a, then the max over the coefficient axis), which XLA lowers for
// the TPU as a select and a reduction.
//
//   out[r] = max_j (a[r, j] > (p_l >> 1) ? p_l - a[r, j] : a[r, j]),
//   l = r mod L, for residues a in [0, p_l)
//
// Bound on the H100: bytes.  Each coefficient is read once and one word a
// row is written (ex1's ciphertext, 2 x 2 x 4096 words: 131 KB, about 0.04 us
// at 3.35 TB/s), so at the per-op API's sizes the launch dominates.
//
// Design: one block per (..., limb) row, 256 threads.  Each thread walks the
// row with a stride of the block, keeps the largest centred magnitude in a
// register, the warps reduce with shuffles, and the first warp reduces the
// eight warp maxima from shared memory and writes the row's one word.
#include "modops.cuh"

__global__ void infty_norm_kernel(u64* __restrict__ out, const u64* __restrict__ a,
                                  const u64* __restrict__ mod, int L, int n) {
    __shared__ u64 warp_max[32];
    const long long row = blockIdx.x;
    const u64 p = __ldg(mod + (int)(row % L));
    const u64 half = p >> 1;
    const u64* src = a + row * (long long)n;
    u64 m = 0;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const u64 x = src[j];
        const u64 mag = x > half ? p - x : x;
        m = mag > m ? mag : m;
    }
    for (int off = 16; off > 0; off >>= 1) {
        const u64 o = __shfl_down_sync(0xffffffffu, m, off);
        m = o > m ? o : m;
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (warp == 0) {
        const int warps = (blockDim.x + 31) >> 5;
        m = lane < warps ? warp_max[lane] : 0;
        for (int off = 16; off > 0; off >>= 1) {
            const u64 o = __shfl_down_sync(0xffffffffu, m, off);
            m = o > m ? o : m;
        }
        if (lane == 0) out[row] = m;
    }
}

// out: [rows]; a: [rows, N] viewed as [..., L, N]; mod: [L].  Returns
// cudaGetLastError() after the launch.
extern "C" int gst_infty_norm(void* out, const void* a, const void* mod, long long rows,
                              long long L, long long n, void* stream) {
    if (rows < 0 || L < 1 || n < 1 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    const int threads = 256;
    infty_norm_kernel<<<(unsigned)rows, threads, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)a, (const u64*)mod, (int)L, (int)n);
    return (int)cudaGetLastError();
}
