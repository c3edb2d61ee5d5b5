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
//   mode 0 shift: no multiply (c = 1); mode 1 mono_mul: the full 128-bit
//   Barrett mul_mod of modops.cuh, since c may be a CRT residue or the fast
//   plain lift's p_l - t + c, which can reach 2 p_l (Shoup needs c < p).
//   c is one scalar for every limb, or a per-limb array.
//
// Bound on the H100: bytes.  One u64 read and one written per coefficient
// (ex1's multiply_plain: 2 x 2 x 4096 words, 131 KB each way, about 0.08 us
// at 3.35 TB/s); the mono_mul mode adds one mul_mod (~31 IMADs) per
// coefficient, far under the byte time.  At every size the per-op API runs,
// the launch dominates.
//
// Design: one thread per output coefficient in a grid-stride loop reads its
// source coefficient (a shifted but contiguous run of neighbouring threads,
// so the loads coalesce except at the one wrap point of a row), multiplies,
// negates and writes; one launch replaces the multiply, roll and select.
#include "modops.cuh"

__global__ void negacyclic_kernel(u64* __restrict__ out, const u64* __restrict__ a,
                                  const u64* __restrict__ coeffs, u64 c,
                                  const u64* __restrict__ mod, const u64* __restrict__ r0s,
                                  const u64* __restrict__ r1s, long long total, int L,
                                  int log_n, long long k, int mode) {
    const long long n = 1LL << log_n;
    const long long rot = k & (n - 1);
    const bool odd = (k >> log_n) & 1;
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const long long row = idx >> log_n;
        const long long j = idx & (n - 1);
        const int l = (int)(row % L);
        const u64 p = __ldg(mod + l);
        u64 x = a[(row << log_n) + ((j - rot) & (n - 1))];
        if (mode == 1) {
            const u64 cl = coeffs != nullptr ? __ldg(coeffs + l) : c;
            x = mul_mod(x, cl, p, __ldg(r0s + l), __ldg(r1s + l));
        }
        out[idx] = ((j < rot) != odd) ? neg_mod(x, p) : x;
    }
}

// out, a: [rows, N] viewed as [..., L, N] (N = 2^log_n); coeffs: [L] or NULL
// (then the scalar c); mod, r0, r1: [L]; k in [0, 2N); mode 0 shift, 1
// mono_mul.  Returns cudaGetLastError() after the launch.
extern "C" int gst_negacyclic(void* out, const void* a, const void* coeffs, long long c,
                              const void* mod, const void* r0, const void* r1,
                              long long total, long long L, long long log_n, long long k,
                              long long mode, void* stream) {
    if (L < 1 || log_n < 0 || log_n > 17 || k < 0 || k >= (2LL << log_n) || mode < 0 ||
        mode > 1)
        return (int)cudaErrorInvalidValue;
    if (total == 0) return 0;
    const int threads = 256;
    negacyclic_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)a, (const u64*)coeffs, (u64)c, (const u64*)mod,
        (const u64*)r0, (const u64*)r1, total, (int)L, (int)log_n, k, (int)mode);
    return (int)cudaGetLastError();
}
