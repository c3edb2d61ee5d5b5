// Scalar 64-bit modular arithmetic shared by the port's kernels.
//
// Device twins of gemini_seal_tpu/ops/modops.py (mul64_wide, mulhi64,
// barrett_reduce_128, divmod_128, barrett_reduce_64, mul_mod, mul_mod_shoup_lazy,
// mul_mod_shoup, add_mod, sub_mod, neg_mod, reduce_once, reduce_twice).  The
// TPU has no 64-bit multiplier and builds the 128-bit product from u32
// halves; here the low word is one 64-bit multiply and the high word is
// __umul64hi.  Every function follows the JAX step sequence, so results
// (lazy ranges included) are bit-identical to the plain versions.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

__device__ __forceinline__ u64 mulhi64(u64 a, u64 b) { return __umul64hi(a, b); }

// floor(x * floor(2^128/p) / 2^128) estimate, one correction: [0, 2^128) -> [0, p)
__device__ __forceinline__ u64 barrett_reduce_128(u64 hi, u64 lo, u64 p, u64 r0, u64 r1) {
    u64 carry = __umul64hi(lo, r0);
    u64 t2_lo = lo * r1;
    u64 t2_hi = __umul64hi(lo, r1);
    u64 tmp1 = t2_lo + carry;
    u64 tmp3 = t2_hi + (u64)(tmp1 < t2_lo);
    t2_lo = hi * r0;
    t2_hi = __umul64hi(hi, r0);
    u64 tmp1b = tmp1 + t2_lo;
    u64 carry2 = t2_hi + (u64)(tmp1b < tmp1);
    u64 tmp1c = hi * r1 + tmp3 + carry2;
    u64 result = lo - tmp1c * p;
    return result >= p ? result - p : result;
}

// floor((hi:lo) / p) when it fits in 64 bits: the Barrett estimate of
// barrett_reduce_128 plus its one correction (the JAX divmod_128 quotient).
__device__ __forceinline__ u64 divmod_128_quotient(u64 hi, u64 lo, u64 p, u64 r0, u64 r1) {
    u64 carry = __umul64hi(lo, r0);
    u64 t2_lo = lo * r1;
    u64 t2_hi = __umul64hi(lo, r1);
    u64 tmp1 = t2_lo + carry;
    u64 tmp3 = t2_hi + (u64)(tmp1 < t2_lo);
    t2_lo = hi * r0;
    t2_hi = __umul64hi(hi, r0);
    u64 tmp1b = tmp1 + t2_lo;
    u64 carry2 = t2_hi + (u64)(tmp1b < tmp1);
    u64 q = hi * r1 + tmp3 + carry2;
    return q + (u64)(lo - q * p >= p);
}

__device__ __forceinline__ u64 barrett_reduce_64(u64 x, u64 p, u64 r1) {
    u64 q = __umul64hi(x, r1);
    u64 result = x - q * p;
    return result >= p ? result - p : result;
}

__device__ __forceinline__ u64 mul_mod(u64 a, u64 b, u64 p, u64 r0, u64 r1) {
    return barrett_reduce_128(__umul64hi(a, b), a * b, p, r0, r1);
}

// x * w mod p in [0, 2p), w_shoup = floor(w * 2^64 / p)
__device__ __forceinline__ u64 mul_mod_shoup_lazy(u64 x, u64 w, u64 w_shoup, u64 p) {
    return x * w - __umul64hi(x, w_shoup) * p;
}

// the same product reduced once: [0, p)
__device__ __forceinline__ u64 mul_mod_shoup(u64 x, u64 w, u64 w_shoup, u64 p) {
    const u64 r = mul_mod_shoup_lazy(x, w, w_shoup, p);
    return r >= p ? r - p : r;
}

__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 p) {
    u64 s = a + b;
    return s >= p ? s - p : s;
}

__device__ __forceinline__ u64 sub_mod(u64 a, u64 b, u64 p) {
    u64 d = a - b;
    return a < b ? d + p : d;
}

__device__ __forceinline__ u64 neg_mod(u64 a, u64 p) { return a == 0 ? a : p - a; }

__device__ __forceinline__ u64 reduce_once(u64 x, u64 p) { return x >= p ? x - p : x; }

__device__ __forceinline__ u64 reduce_twice(u64 x, u64 p) {
    return reduce_once(reduce_once(x, 2 * p), p);
}

// Exact 128-bit accumulator (the reference's FMAU128, and the JAX digit-plane
// sum): hi:lo += a * b.
__device__ __forceinline__ void mac128(u64 &hi, u64 &lo, u64 a, u64 b) {
    u64 plo = a * b;
    u64 phi = __umul64hi(a, b);
    lo += plo;
    hi += phi + (u64)(lo < plo);
}

static inline unsigned grid_for(long long total, int threads) {
    long long blocks = (total + threads - 1) / threads;
    const long long cap = 132LL * 32;  // grid-stride beyond 32 blocks per SM
    return (unsigned)(blocks < cap ? blocks : cap);
}
