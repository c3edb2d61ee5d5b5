// K5: Galois permutation of residue rows by R tables at once, unsigned (NTT
// domain) or signed (power basis), shared or paired.
//
// Replaces gemini_seal_tpu/ops/galois.py GaloisTool.apply_galois_ntt
// (galois.py:123-127), the R-table gather of the mod-up digits in
// batched_rotated_inner_product (ops/keyswitch.py:403-405), the power-basis
// GaloisTool.apply_galois (galois.py:115-121: a gather, then neg_mod where the
// table's sign flag is set) and the per-rotation output permutations of the
// counter-rotated-key forms of build_bfv_rotate_many / build_ckks_rotate_many
// (models/pipelines.py:386-392, 480-483), which XLA lowers for the TPU as a
// gather over the last axis (plus a select and a moveaxis copy).
//
//   shared: out[b, r, row, j] = f(x[b,    row, tab[r, j] & (N-1)])
//   paired: out[b, r, row, j] = f(x[b, r, row, tab[r, j] & (N-1)])
//   f(v) = neg_mod(v, p[row % L]) where bit log N of tab[r, j] is set (signed
//   mode, mod given), else v
//
// Bound on the H100: bytes only.  Each input row is read once and written R
// times (paired: once); the sign flip is one compare and one subtract.  The
// permutation is a bit-reversed (NTT) or strided (power basis) index map, so
// the reads of one output row are scattered over its input row.
//
// Design: one block per output row (b, r, row).  Each thread takes two
// neighbouring outputs: one 16-byte load of their two table entries, two
// 8-byte reads of the input row through the read-only cache, one 16-byte
// store.  The stores are coalesced; the scattered reads stay inside one row
// (64 KB at N=8192), which the block pulls into L1 and the R blocks of one row
// share through L2, so device memory sees about one read of each row.  The
// sign rides in bit log N of the int64 table entry, which the index mask
// drops, so the signed mode reads no second table.  The output is laid out
// [B, R, rows, N] directly, so the hoisted key switch needs no moveaxis copy.
// A first version that staged each row in shared memory and gathered from
// there ran 1.3x slower than this one on the H100 (PERF.md); not yet made fast
// with TMA.
#include "modops.cuh"

template <bool SIGNED, bool PAIRED>
__global__ void galois_kernel(u64* __restrict__ out, const u64* __restrict__ x,
                              const long long* __restrict__ tab,
                              const u64* __restrict__ mod, int L, int rows, int n, int log_n) {
    const long long brow = blockIdx.x;          // b * rows + row
    const long long b = brow / rows;
    const long long row = brow % rows;
    const int r = blockIdx.y;
    const int R = gridDim.y;
    const u64* src = x + (PAIRED ? (b * R + r) * rows + row : brow) * (long long)n;
    ulonglong2* dst = (ulonglong2*)(out + ((b * R + r) * rows + row) * (long long)n);
    const longlong2* t = (const longlong2*)(tab + (long long)r * n);
    const int mask = n - 1;
    const u64 p = SIGNED ? mod[row % L] : 0;
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
        const longlong2 ij = t[j];
        ulonglong2 v;
        v.x = __ldg(src + (ij.x & mask));
        v.y = __ldg(src + (ij.y & mask));
        if (SIGNED) {
            if ((ij.x >> log_n) & 1) v.x = neg_mod(v.x, p);
            if ((ij.y >> log_n) & 1) v.y = neg_mod(v.y, p);
        }
        dst[j] = v;
    }
}

// out: [B, R, rows, N]; x: [B, rows, N] (shared) or [B, R, rows, N] (paired);
// tab: [R, N] int64 entries, index in bits 0 .. log N - 1 (masked, so no read
// leaves the row) and, in the signed mode, the sign in bit log N; 16-byte
// aligned; N a power of two >= 2.  mod: [L] moduli with rows % L == 0 (the
// signed mode), or NULL (unsigned).  Returns cudaGetLastError() after the
// launch.
extern "C" int gst_galois(void* out, const void* x, const void* tab, const void* mod,
                          long long B, long long rows, long long n, long long R, long long L,
                          long long paired, void* stream) {
    const long long row_blocks = B * rows;
    if (row_blocks > 0x7fffffffLL || R > 65535 || n < 2 || (n & (n - 1)) ||
        (mod != nullptr && (L < 1 || rows % L)))
        return (int)cudaErrorInvalidValue;
    int log_n = 0;
    while ((1LL << log_n) < n) ++log_n;
    // many output rows: small blocks keep more rows in flight per SM
    const int threads = row_blocks * R >= 1024 ? 128 : (n / 2 < 512 ? (int)(n / 2) : 512);
    dim3 grid((unsigned)row_blocks, (unsigned)R);
    auto kernel = mod != nullptr ? (paired ? galois_kernel<true, true> : galois_kernel<true, false>)
                                 : (paired ? galois_kernel<false, true> : galois_kernel<false, false>);
    kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)x, (const long long*)tab, (const u64*)mod, (int)L, (int)rows,
        (int)n, log_n);
    return (int)cudaGetLastError();
}
