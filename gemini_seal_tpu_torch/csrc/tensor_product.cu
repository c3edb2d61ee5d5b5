// K2: size-2 x size-2 ciphertext tensor product -> 3 components.
//
// Replaces gemini_seal_tpu/models/pipelines.py _convolve3 / _square3
// (pipelines.py:72-99), i.e. four (or, squaring, three) dyadic_product calls
// and one add_poly (ops/dyadic.py:78-99) that XLA lowers as elementwise
// passes over [B, L, N].
//
// Bound on the H100: per coefficient four u64 loads (two when squaring),
// three u64 stores, and four (three) Barrett mul_mods of ~31 32-bit IMADs
// each.  The 56 bytes set the bound; the multiplies need about half of it.
//
// Design: one thread per (ciphertext, limb, coefficient) in a grid-stride loop;
// each reads a0, a1 (and b0, b1) once and writes c0, c1, c2, so the product
// makes one pass over memory instead of one per dyadic product.  The limb's
// modulus and Barrett ratios come from three [L] arrays (cached).  c1 is
// add_mod(a0*b1, a1*b0), or add_mod(cross, cross) with cross = a0*a1 when
// squaring, as in the JAX functions, so the output is bit-identical.
#include "modops.cuh"

__global__ void tensor_product_kernel(u64* __restrict__ out0, u64* __restrict__ out1,
                                      u64* __restrict__ out2, const u64* __restrict__ a,
                                      const u64* __restrict__ b, long long total,
                                      int L, int n, const u64* __restrict__ mod,
                                      const u64* __restrict__ r0s, const u64* __restrict__ r1s) {
    const long long plane = (long long)L * n;
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const long long ct = idx / plane;
        const long long rem = idx - ct * plane;
        const int l = (int)(rem / n);
        const u64 p = mod[l], r0 = r0s[l], r1 = r1s[l];
        const u64 a0 = a[ct * 2 * plane + rem];
        const u64 a1 = a[ct * 2 * plane + plane + rem];
        u64 c0, c1, c2;
        if (b == nullptr) {
            const u64 cross = mul_mod(a0, a1, p, r0, r1);
            c0 = mul_mod(a0, a0, p, r0, r1);
            c1 = add_mod(cross, cross, p);
            c2 = mul_mod(a1, a1, p, r0, r1);
        } else {
            const u64 b0 = b[ct * 2 * plane + rem];
            const u64 b1 = b[ct * 2 * plane + plane + rem];
            c0 = mul_mod(a0, b0, p, r0, r1);
            c1 = add_mod(mul_mod(a0, b1, p, r0, r1), mul_mod(a1, b0, p, r0, r1), p);
            c2 = mul_mod(a1, b1, p, r0, r1);
        }
        out0[idx] = c0;
        out1[idx] = c1;
        out2[idx] = c2;
    }
}

// out0, out1, out2 [B, L, N]; a, b [B, 2, L, N] (b == NULL: square a);
// mod/r0/r1 [L].
extern "C" int gst_tensor_product(void* out0, void* out1, void* out2,
                                  const void* a, const void* b,
                                  long long batch, long long L, long long n,
                                  const void* mod, const void* r0, const void* r1,
                                  void* stream) {
    const long long total = batch * L * n;
    const int threads = 256;
    tensor_product_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
        (u64*)out0, (u64*)out1, (u64*)out2, (const u64*)a, (const u64*)b, total, (int)L, (int)n,
        (const u64*)mod, (const u64*)r0, (const u64*)r1);
    return (int)cudaGetLastError();
}
