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
// 1.4 MB, about 0.43 us at 3.35 TB/s, far below a launch (an empty kernel
// takes about 2 us, chip_smoke.py's launch_floor line), so a call is
// launch- and latency-bound; the arithmetic is one 64-bit high multiply per
// output.
//
// Design: one thread a coefficient.  The grid's x axis holds the rows
// times a power of two of tiles of a row, split by a mask and a shift, and
// y the limb groups, so that the refresh's 172k outputs spread over every SM
// with no index divided and no loop over rows (with one, even one that runs
// once, the timed calls were slower).  A thread loads its c once, decides
// the sign once and writes it reduced by each of the `lpt` primes of its
// group, one store a prime.  The L primes, their Barrett r1 and p_l - qm_l
// arrive by value in the kernel's parameter struct (the host packs them,
// ops/modraise.py mod_raise_constants), so no output waits on a dependent
// load of a constant; the struct holds at most MOD_RAISE_MAX_L primes, the
// largest chain the package builds (COEFF_MOD_COUNT_MAX), and the wrapper
// refuses more.  The geometry (threads, lpt) is the host's
// (mod_raise_geometry), picked by timing (port_tools/small_kernels.py
// --sweep: two coefficients a thread with 16-byte loads and stores were
// slower at every refresh shape).
#include "modops.cuh"

#define MOD_RAISE_MAX_L 64

struct ModRaiseParams {
    u64* out;
    const u64* x;
    u64 half;
    int L, log_n;   // output limbs, log2 of the coefficients a row
    int log_tiles;  // grid x = rows << log_tiles
    int lpt;        // limbs a thread: grid y holds ceil(L / lpt) groups
    u64 p[MOD_RAISE_MAX_L], r1[MOD_RAISE_MAX_L], pq[MOD_RAISE_MAX_L];  // pq = p - q0 mod p
};

__global__ void __launch_bounds__(256) mod_raise_kernel(const __grid_constant__ ModRaiseParams P) {
    const unsigned tile = blockIdx.x & ((1u << P.log_tiles) - 1);
    const unsigned b = blockIdx.x >> P.log_tiles;
    const unsigned col = tile * blockDim.x + threadIdx.x;
    if (col >> P.log_n) return;
    const unsigned L = P.L;
    const u64 c = P.x[(b << P.log_n) + col];
    const bool neg = c > P.half;
    const unsigned l0 = blockIdx.y * P.lpt;
    const unsigned l1 = min(L, l0 + P.lpt);
    u64* dst = P.out + ((b * L + l0) << P.log_n) + col;
#pragma unroll 2
    for (unsigned l = l0; l < l1; ++l, dst += 1u << P.log_n) {
        const u64 p = P.p[l];
        const u64 r = barrett_reduce_64(c, p, P.r1[l]);
        *dst = neg ? reduce_once(r + P.pq[l], p) : r;
    }
}

// out: [B, L, N] (N = 2^log_n); x: [B, 1, N] canonical residues mod q0;
// consts: L primes, then their r1, then p - q0 mod p (host memory, copied
// into the parameter struct).  The geometry (threads, log_tiles: 2^log_tiles
// CTAs a row covering its N coefficients; lpt) is the host's; one that does
// not fit the shapes returns cudaErrorInvalidValue without a launch.
// Returns cudaGetLastError() after the launch.
extern "C" int gst_mod_raise(void* out, const void* x, const void* consts, long long half,
                             long long B, long long L, long long log_n, long long threads,
                             long long log_tiles, long long lpt, void* stream) {
    if (B < 1 || L < 1 || L > MOD_RAISE_MAX_L || log_n < 0 || log_n > 20 || threads < 32 ||
        threads > 256 || threads % 32 || log_tiles < 0 || log_tiles > 20 ||
        (threads << log_tiles) < (1LL << log_n) || lpt < 1 || lpt > L ||
        (B << log_tiles) >= (1LL << 31) || (B * L << log_n) >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    ModRaiseParams P;
    P.out = (u64*)out;
    P.x = (const u64*)x;
    P.half = (u64)half;
    P.L = (int)L;
    P.log_n = (int)log_n;
    P.log_tiles = (int)log_tiles;
    P.lpt = (int)lpt;
    const u64* k = (const u64*)consts;
    for (int l = 0; l < L; ++l) {
        P.p[l] = k[l];
        P.r1[l] = k[L + l];
        P.pq[l] = k[2 * L + l];
    }
    const dim3 grid((unsigned)(B << log_tiles), (unsigned)((L + lpt - 1) / lpt));
    mod_raise_kernel<<<grid, (unsigned)threads, 0, (cudaStream_t)stream>>>(P);
    return (int)cudaGetLastError();
}
