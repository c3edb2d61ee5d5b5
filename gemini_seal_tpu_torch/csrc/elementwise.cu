// K4: per-limb modular elementwise ops over [..., L, N] residue tensors.
//
// Replaces the mul_mod / add_mod / sub_mod / neg_mod elementwise programs
// that XLA lowers for the TPU: the epilogues of fused_moddown
// (gemini_seal_tpu/ops/keyswitch.py:438-439 c*P mod q + acc, and :452-453
// (num + temp) * Q_D^-1 mod q), and the ring ops of ops/dyadic.py
// (add_poly, sub_poly, negate_poly, multiply_poly_scalar, dyadic_product)
// and the rounding steps of ops/rnsops.py divide_and_round_q_last_ntt that
// key generation, encryption and decryption run on the card; op 7 is the
// tail of the BFV fast_floor (ops/rnsops.py:356-366, x_bsk + (p - conv)
// times q^-1 mod p) and of the power-basis limb drops.
//
//   op 0 add: a + b       1 sub: a - b        2 neg: -a        3 mul: a * b
//      4 muladd: a*s + b  5 addmul: (a + b)*s  6 barrett64: (a + b) mod p
//      7 submul: (a - b)*s, computed as the JAX function does: the u64
//        a + (p - b), un-reduced, into one full-range mul_mod (canonical
//        output, so for b < p it equals sub_mod then mul_mod)
//
// b is a tensor broadcast over a's leading axes (index idx % b_numel) or a
// per-limb constant; s is a per-limb constant.
//
// Bound on the H100: two or three u64 streams per element and at most one
// Barrett mul_mod (~31 IMADs); the muladd/addmul epilogues of the main path
// read two tensors and write one, and those 24 bytes set the bound.
//
// Design: one thread per element in a grid-stride loop; each chain is fused so
// that an epilogue makes one pass over memory instead of two.  The op code is
// uniform across the grid, so the switch does not diverge.
#include "modops.cuh"

__global__ void elementwise_kernel(u64* __restrict__ out, const u64* __restrict__ a,
                                   const u64* __restrict__ b, long long b_numel,
                                   const u64* __restrict__ bc, const u64* __restrict__ s,
                                   const u64* __restrict__ mod, const u64* __restrict__ r0s,
                                   const u64* __restrict__ r1s, long long total, int L,
                                   int n, int op) {
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int l = (int)((idx / n) % L);
        const u64 p = mod[l];
        const u64 x = a[idx];
        const u64 y = b != nullptr ? b[idx % b_numel] : (bc != nullptr ? bc[l] : 0);
        u64 r;
        switch (op) {
            case 0: r = add_mod(x, y, p); break;
            case 1: r = sub_mod(x, y, p); break;
            case 2: r = neg_mod(x, p); break;
            case 3: r = mul_mod(x, y, p, r0s[l], r1s[l]); break;
            case 4: r = add_mod(y, mul_mod(x, s[l], p, r0s[l], r1s[l]), p); break;
            case 5: r = mul_mod(add_mod(x, y, p), s[l], p, r0s[l], r1s[l]); break;
            case 6: r = barrett_reduce_64(x + y, p, r1s[l]); break;
            default: r = mul_mod(x + (p - y), s[l], p, r0s[l], r1s[l]); break;
        }
        out[idx] = r;
    }
}

// out, a: [total] viewed as [..., L, N]; b: [b_numel] or NULL; bc, s, mod,
// r0, r1: [L] (bc, s may be NULL).
extern "C" int gst_elementwise(void* out, const void* a, const void* b, long long b_numel,
                               const void* bc, const void* s, const void* mod,
                               const void* r0, const void* r1, long long total,
                               long long L, long long n, long long op, void* stream) {
    if (op < 0 || op > 7) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    elementwise_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)a, (const u64*)b, b_numel, (const u64*)bc, (const u64*)s,
        (const u64*)mod, (const u64*)r0, (const u64*)r1, total, (int)L, (int)n, (int)op);
    return (int)cudaGetLastError();
}
