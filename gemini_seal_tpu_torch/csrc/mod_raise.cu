// K8: the centred lift of CKKS bootstrapping's mod-raise.
//
// Replaces the lift-and-reduce of gemini_seal_tpu/models/bootstrap.py
// mod_raise (bootstrap.py:261-264: c > q0/2 picks the sign, c % p for every
// top-level prime, (r + p - q0 mod p) % p where c is negative, a where), which
// XLA lowers for the TPU as a broadcast remainder, a select and a cast between
// the inverse NTT at q0 and the forward NTT on the full basis.
//
//   out[b, l, n] = r              where c <= half
//                  r + p_l - qm_l (one conditional subtract of p_l) elsewhere
//   with c = x[b, 0, n] in [0, q0), r = c mod p_l (Barrett-64, exact for
//   c < 2^63), qm_l = q0 mod p_l, half = q0 >> 1.  At l = 0 (p_0 = q0) qm is
//   0 and a negative c comes out as c itself.
//
// Bound on the H100: bytes.  One input row of N words is read and L rows are
// written: at the N=4096 refresh (2 x 1 x 4096 in, L=21 out) 64 KiB and
// 1.4 MB, about 0.43 us at 3.35 TB/s, far below a launch, so the kernel is
// launch-bound; the arithmetic is one 64-bit high multiply per output.
//
// Design: one thread per input coefficient in a grid-stride loop reads c once,
// decides the sign once and writes its column of all L rows; neighbouring
// threads write neighbouring words of each row, so every store is coalesced.
// The L moduli and their constants are read through the read-only cache.
#include "modops.cuh"

__global__ void mod_raise_kernel(u64* __restrict__ out, const u64* __restrict__ x,
                                 const u64* __restrict__ mod, const u64* __restrict__ r1s,
                                 const u64* __restrict__ qms, u64 half, long long total,
                                 int L, int n) {
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const long long b = idx / n;
        const long long k = idx % n;
        const u64 c = x[idx];
        const bool neg = c > half;
        u64* dst = out + b * (long long)L * n + k;
        for (int l = 0; l < L; ++l) {
            const u64 p = __ldg(mod + l);
            u64 r = barrett_reduce_64(c, p, __ldg(r1s + l));
            if (neg) r = reduce_once(r + (p - __ldg(qms + l)), p);
            dst[(long long)l * n] = r;
        }
    }
}

// out: [B, L, N]; x: [B, 1, N] canonical residues mod q0; mod, r1, qm: [L]
// (the primes, the high words of floor(2^128 / p), q0 mod p).  Returns
// cudaGetLastError() after the launch.
extern "C" int gst_mod_raise(void* out, const void* x, const void* mod, const void* r1,
                             const void* qm, long long half, long long B, long long L,
                             long long n, void* stream) {
    if (B < 0 || L < 1 || n < 1) return (int)cudaErrorInvalidValue;
    const long long total = B * n;
    if (total == 0) return 0;
    const int threads = 256;
    mod_raise_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)x, (const u64*)mod, (const u64*)r1, (const u64*)qm,
        (u64)half, total, (int)L, (int)n);
    return (int)cudaGetLastError();
}
