// K5: NTT-domain Galois permutation of residue rows by R tables at once.
//
// Replaces gemini_seal_tpu/ops/galois.py GaloisTool.apply_galois_ntt
// (galois.py:123-127) and the R-table gather of the mod-up digits in
// batched_rotated_inner_product (ops/keyswitch.py:403-405), which XLA lowers
// for the TPU as a gather over the last axis (plus a moveaxis copy for the
// R axis).
//
//   out[b, r, row, j] = x[b, row, tab[r, j]]     x: [B, rows, N], tab: [R, N]
//
// Bound on the H100: bytes only.  Each input row is read once and written R
// times; there is no arithmetic.  The permutation is a bit-reversed index
// map, so the reads of one output row are scattered over its input row.
//
// Design: one block per output row (b, r, row).  Each thread takes two
// neighbouring outputs: one 16-byte load of their two indices, two 8-byte
// reads of the input row through the read-only cache, one 16-byte store.
// The stores are coalesced; the scattered reads stay inside one 64 KB row
// (at N=8192), which the block pulls into L1 and the R blocks of one row
// share through L2, so device memory sees about one read of each row.  The
// output is laid out [B, R, rows, N] directly, so the hoisted key switch
// needs no moveaxis copy.  A first version that staged each row in shared
// memory and gathered from there ran 1.3x slower than this one on the H100
// (PERF.md); not yet made fast with TMA.
#include "modops.cuh"

__global__ void galois_kernel(u64* __restrict__ out, const u64* __restrict__ x,
                              const long long* __restrict__ tab, int rows, int n) {
    const long long brow = blockIdx.x;          // b * rows + row
    const long long b = brow / rows;
    const long long row = brow % rows;
    const int r = blockIdx.y;
    const int R = gridDim.y;
    const u64* src = x + brow * (long long)n;
    ulonglong2* dst = (ulonglong2*)(out + ((b * R + r) * rows + row) * (long long)n);
    const longlong2* t = (const longlong2*)(tab + (long long)r * n);
    const int mask = n - 1;
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
        const longlong2 ij = t[j];
        ulonglong2 v;
        v.x = __ldg(src + (ij.x & mask));
        v.y = __ldg(src + (ij.y & mask));
        dst[j] = v;
    }
}

// out: [B, R, rows, N]; x: [B, rows, N]; tab: [R, N] int64 indices in [0, N),
// 16-byte aligned; N a power of two >= 2 (an index is masked to N - 1, so no
// read leaves the row).  Returns cudaGetLastError() after the launch.
extern "C" int gst_galois(void* out, const void* x, const void* tab, long long B,
                          long long rows, long long n, long long R, void* stream) {
    const long long row_blocks = B * rows;
    if (row_blocks > 0x7fffffffLL || R > 65535 || n < 2) return (int)cudaErrorInvalidValue;
    // many output rows: small blocks keep more rows in flight per SM
    const int threads = row_blocks * R >= 1024 ? 128 : (n / 2 < 512 ? (int)(n / 2) : 512);
    dim3 grid((unsigned)row_blocks, (unsigned)R);
    galois_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)x, (const long long*)tab, (int)rows, (int)n);
    return (int)cudaGetLastError();
}
