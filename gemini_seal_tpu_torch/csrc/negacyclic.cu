// K9: multiply by c * x^k in Z_q[X]/(X^N + 1), per RNS limb.
//
// Replaces gemini_seal_tpu/ops/dyadic.py negacyclic_shift_poly (:109-125:
// roll of the coefficient axis by k mod N, neg_mod where the coefficient
// wrapped past X^N, all of it flipped when floor(k/N) is odd) and
// negacyclic_mono_mul_poly (:128-132: multiply_poly_scalar by c first), which
// XLA lowers for the TPU as a Barrett multiply, a roll and a select: the
// monomial fast path of the Evaluator's multiply_plain
// (gemini_seal_tpu/evaluator.py:256-273).
//
//   out[r, l, j] = s * (c_l * a[r, l, i] mod p_l),  i = (j - k) mod N,
//   s = -1 where (j < k mod N) xor (floor(k / N) odd), else +1
//   FORM 0 shift: no multiply (c = 1).  FORM 1: a per-limb c_l read from a
//   tensor, by the full 128-bit Barrett mul_mod of modops.cuh (c_l may be a
//   CRT residue or the fast plain lift's p_l - t + c, which can reach 2 p_l).
//   FORM 2: one scalar c for every limb, by a Shoup product by w_l = c mod
//   p_l and floor(w_l 2^64 / p_l), both computed on the host
//   (ops/dyadic.py negacyclic_constants), which with w_l below p_l gives the
//   canonical value of the same mul_mod.
//
// Bound on the H100: bytes.  One u64 read and one written per coefficient
// (ex1's multiply_plain: 2 x 2 x 4096 words, 131 KB each way, about 0.08 us
// at 3.35 TB/s); the multiply adds one mul_mod (~31 IMADs) per
// coefficient, far under the byte time.  At every size the per-op API runs,
// the launch and one load's latency set the time (an empty kernel takes
// about 2 us, chip_smoke.py's launch_floor line).
//
// Design: one thread an output coefficient.  The grid's x axis holds the
// leading rows times a power of two of tiles of a row, split by a mask and a
// shift, and y the limb, so nothing is divided and no thread loops; offsets
// are 32-bit (the wrapper checks that the tensor has fewer than 2^31 words).
// The moduli and the product's constants arrive by value in the parameter
// struct (the host packs them), so a thread's only global load before its
// store is its source coefficient (neighbouring threads read neighbouring
// words of the rotated row, so the loads coalesce), and in FORM 1 its limb's
// c_l, issued first.  The form is a template parameter.  The host's geometry
// (ops/dyadic.py negacyclic_geometry) and the Shoup product for a scalar
// were chosen by timing (port_tools/small_kernels.py --sweep, PERF.md):
// against two coefficients a thread with 16-byte stores, a tile's source run
// staged in shared memory, the Barrett product of a scalar and a loop over
// rows, each slower at ex1's and ex3's calls.
#include "modops.cuh"

#define NEGACYCLIC_MAX_L 64

struct NegacyclicParams {
    u64* out;
    const u64* a;
    const u64* coeffs;   // FORM 1: c_l at coeffs[l]
    int log_n, L;        // log2 N, limbs
    int log_tiles;       // grid x = rows << log_tiles
    int rot, odd;        // k mod N, floor(k / N) (0 or 1)
    // shift: p; Barrett: p, ratio0, ratio1; Shoup: p, w, floor(w 2^64 / p)
    u64 k0[NEGACYCLIC_MAX_L], k1[NEGACYCLIC_MAX_L], k2[NEGACYCLIC_MAX_L];
};

template <int FORM>
__global__ void __launch_bounds__(256) negacyclic_kernel(const __grid_constant__ NegacyclicParams P) {
    const int l = blockIdx.y;
    u64 cl = 0;
    if constexpr (FORM == 1) cl = P.coeffs[l];
    const unsigned tile = blockIdx.x & ((1u << P.log_tiles) - 1);
    const unsigned r = blockIdx.x >> P.log_tiles;
    const unsigned j = tile * blockDim.x + threadIdx.x;
    const unsigned mask = (1u << P.log_n) - 1;
    if (j > mask) return;
    const unsigned base = (r * (unsigned)P.L + (unsigned)l) << P.log_n;
    const unsigned rot = (unsigned)P.rot;
    u64 x = P.a[base + ((j - rot) & mask)];
    const u64 p = P.k0[l];
    if constexpr (FORM == 1) x = mul_mod(x, cl, p, P.k1[l], P.k2[l]);
    if constexpr (FORM == 2) x = mul_mod_shoup(x, P.k1[l], P.k2[l], p);
    P.out[base + j] = ((j < rot) != (P.odd != 0)) ? neg_mod(x, p) : x;
}

// out, a: [R, L, N] (N = 2^log_n); coeffs: [L] (form 1) or NULL; consts: 3L
// u64 in host memory (k0, k1, k2 of the struct above; form 0 reads only the
// L primes); k in [0, 2N).  The geometry (threads, log_tiles: 2^log_tiles
// CTAs a row covering its N outputs) is the host's; one that does not fit
// the shapes returns cudaErrorInvalidValue without a launch.  Returns
// cudaGetLastError() after the launch.
extern "C" int gst_negacyclic(void* out, const void* a, const void* coeffs, const void* consts,
                              long long form, long long R, long long L, long long log_n,
                              long long k, long long threads, long long log_tiles,
                              void* stream) {
    const long long n = 1LL << log_n;
    if (form < 0 || form > 2 || (form == 1) != (coeffs != nullptr) || R < 1 || L < 1 ||
        L > NEGACYCLIC_MAX_L || log_n < 0 || log_n > 17 || k < 0 || k >= 2 * n ||
        threads < 32 || threads > 256 || threads % 32 || log_tiles < 0 || log_tiles > 17 ||
        (threads << log_tiles) < n || (R << log_tiles) >= (1LL << 31) ||
        R * L * n >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    NegacyclicParams P;
    P.out = (u64*)out;
    P.a = (const u64*)a;
    P.coeffs = (const u64*)coeffs;
    P.log_n = (int)log_n;
    P.L = (int)L;
    P.log_tiles = (int)log_tiles;
    P.rot = (int)(k & (n - 1));
    P.odd = (int)(k >> log_n);
    const u64* h = (const u64*)consts;
    for (int l = 0; l < L; ++l) {
        P.k0[l] = h[l];
        P.k1[l] = h[L + l];
        P.k2[l] = h[2 * L + l];
    }
    const dim3 grid((unsigned)(R << log_tiles), (unsigned)L);
    cudaStream_t st = (cudaStream_t)stream;
    if (form == 0)
        negacyclic_kernel<0><<<grid, (unsigned)threads, 0, st>>>(P);
    else if (form == 1)
        negacyclic_kernel<1><<<grid, (unsigned)threads, 0, st>>>(P);
    else
        negacyclic_kernel<2><<<grid, (unsigned)threads, 0, st>>>(P);
    return (int)cudaGetLastError();
}
