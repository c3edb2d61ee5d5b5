// K12: one pass of the four-step NTT as int8 digit-pair matmuls on the
// tensor cores, with wgmma.
//
// Replaces gemini_seal_tpu/ops/ntt_mxu.py:362-367 _pass (the digit split
// _balanced_digits_dev :275-286, the digit-pair matmuls _digit_matmul
// :289-318 and the recombine _combine_planes :321-359) and, in the first
// pass of each direction, the canonical Shoup twist of ntt_forward_mxu /
// ntt_inverse_mxu (:380, :399; mul_mod_shoup, gemini_seal_tpu/ops/
// modops.py:184-190).  The JAX package ran the matmuls on the TPU's matrix
// unit through XLA; here they are wgmma.mma_async m64nNk32 s8 x s8 -> s32.
//
// Per poly-limb row (a [N1, N2] matrix x of u64 in [0, 2p)), with W the
// pass's K x K matrix (K = N1 in pass A, N2 in pass B) split into balanced
// int8 digit planes W_d and x into digit planes X_e (the carry-free
// +0x80..80 lane trick: digit e is byte e of (x + 0x80..80) ^ 0x80..80):
//
//   pass A: out[m, n] = sum_k W[m, k] x[k, n]   (m, k < N1; n < N2)
//   pass B: out[n, m] = sum_k W[m, k] x[n, k]   (m, k < N2; n < N1)
//   plane_s = sum_{d + e = s, d < dw_l, e < dx_l} W_d X_e     (int32)
//   out = (sum_s plane_s * 2^(8 s)) mod p, canonical   [* twist, Shoup]
//
// The JAX package reduces the exact 128-bit value offset + sum (its offset a
// multiple of p) once by Barrett; here the sum is folded five planes at a
// time (below), each group's exact int64 partial reduced by a canonical
// Shoup product: the same residue, so every output word is the JAX
// package's.  The limb's own digit counts dw_l and dx_l (taken by value;
// ops/ntt_mxu.py) skip only pairs whose product is exactly zero:
// every weight plane at or above dw_l holds only zero bytes, and every data
// digit at or above dx_l is 0 for x in [0, 2 p_l).  |plane| < 7 * 512 *
// 2^14 < 2^26 fits in int32.
//
// Bound on the H100: the int8 tensor cores, with the bytes close behind.
// A row costs dw_l * dx_l * K * K * (other axis) MACs: at N=16384 on six
// limbs (50, 40 x 4, 50 bits) 40.3 pairs on average (49 at the tables'
// counts), 130e9 MACs a pass on 1,536 rows, 0.13 ms at 989.5e12 MACs/s
// (the dense int8 peak), against 0.12 ms for its bytes (the u64 rows read
// once and written once).
//
// Design.  A CTA serves one limb (and a block of up to 128 rows of W) and
// walks that limb's data tiles (NT columns of the other axis by all of K)
// as a persistent CTA.  Three warpgroups: a producer and two consumers;
// setmaxnreg gives the consumers 224 registers and the producer 56 (the
// branch on a warp-uniform role, so that ptxas compiles each side for its
// own budget: no instantiation spills).
// - The producer keeps the raw u64 tile in flight with TMA (a 2-D tensor
//   map of x, boxes of 16 words a row with the 128-byte swizzle, completing
//   on an mbarrier), two half-tiles in a ring, and splits each into the
//   digit planes of a ring of stages in shared memory (pass A's data is
//   transposed here): each plane in wgmma's K-major core-matrix layout (8
//   rows x 16 bytes, no swizzle), written by whole core matrices a warp,
//   read from the swizzled boxes, both without bank conflicts.
// - Each consumer warpgroup owns 64 rows of W (with K <= 64, one tile of
//   W, the consumers take the stages in turn).  With K <= 128 W's digit
//   planes stay in shared memory for the CTA's life, in the same
//   core-matrix layout, and both operands of every wgmma come from shared
//   memory (A by descriptor: no register holds W; port_tools/wgmma_probe.py
//   times the shapes).  The planes are
//   accumulated five at a time, a group's pairs issued back to back as one
//   commit group, each plane's first product overwriting its accumulator;
//   after each group the five int32 planes fold into an int64 partial
//   (|partial| < 2^58), made non-negative by a multiple of p and reduced
//   by a Shoup product by 2^(40 g) mod p into the output's running residue.
//   The two consumers run their products, folds and epilogues side by side,
//   each filling the other's gaps at the tensor cores.  Above K = 128 (N >=
//   32768) W's fragments come from device memory into registers (two
//   buffers, one k32 step a load) and the stages hold 16 columns.
// - No instruction but wgmma writes an accumulator between the fence and
//   the wait (a plane's first product overwrites it), and the shared-memory
//   path forms each descriptor inside the wgmma's asm from a 32-bit base
//   and offset, so that no descriptor stays live in registers.
// The epilogue twists (Shoup) and writes u64; the digit pairs' products are
// one launch a pass.  port_tools/ntt_mxu_variants.py times a pass with its
// products tripled, its fold and epilogue cut, and its fold tripled (where
// a pass's time goes).
#include <cuda.h>
#include <cudaTypedefs.h>

#include "modops.cuh"

namespace {

constexpr int WG = 128;                       // threads of a warpgroup
constexpr int CONSUMERS = 2;                  // consumer warpgroups
constexpr int PRODUCER_WARPS = 4;             // the producer warpgroup
constexpr int PRODUCERS = PRODUCER_WARPS * 32;
constexpr int THREADS = CONSUMERS * WG + PRODUCERS;
constexpr int CONSUMER_REGS = 224, PRODUCER_REGS = 56;
constexpr int G = 5;                          // planes a group (int64 partial: 5 x 8 bits of shift)
constexpr int GROUPS = 3;                     // groups for S <= 15 planes
constexpr int DW_MAX = 7, DX_MAX = 8;
constexpr int MAX_L = 64;
constexpr int MAX_STAGES = 8;
constexpr int ENCODE_ERROR_BASE = 100000;   // + the CUresult of a failed tensor-map encode
constexpr int SMEM_LIMIT = 232448;
// shared memory: mbarriers (full, empty, the raw halves) and the limb's
// constants, then W's planes, the stages, the raw halves
constexpr int BAR_FULL = 0, BAR_EMPTY = MAX_STAGES, BAR_RAW = 2 * MAX_STAGES;
constexpr int CONST_OFF = 160, BAR_BYTES = 256;
// the limb's constants at CONST_OFF: p, floor(2^64 / p) (the Shoup constant
// of 1), the fold's bias, 2^40 mod p and its Shoup constant, 2^80 mod p and
// its Shoup constant
enum { C_P, C_ONE_S, C_BIAS, C_W, C_COUNT = C_W + 2 * (GROUPS - 1) };
constexpr int BOX = 16;                       // u64 words a row of a TMA box (128 bytes, swizzled)

struct Params {
    CUtensorMap tmap;      // x as 2-D u64: pass A {n, R K} in boxes {16, Kp/2}; pass B {K, R n} in boxes {16, NT/2}
    u64* out;
    const signed char* w;
    const u64* tw;
    const u64* tws;
    const u64* mod;
    const u64* r1;         // floor(2^64 / p): the Shoup constant of 1
    long long items;       // data tiles of a limb: rows a limb << log_ntiles
    int K;                 // the contraction (and W's side)
    int n;                 // the data's other axis
    int mode;              // 0: pass A (x [k, n], out [m, n]); 1: pass B (x [n, k], out [n, m])
    int L, log_mblocks;    // limbs; 128-row blocks of W (grid y = L << log_mblocks)
    int mt;                // 64-row tiles of W a CTA (1 or 2)
    int Kp;                // K rounded up to 32
    int log_ntiles;        // NT-column tiles of a row, log2
    int stages;
    int dwt;               // weight planes of the table ([L, dwt, K, K])
    int plane_bytes, stage_bytes, boxes, box_bytes, raw_half;
    int w_off, st_off, raw_off;
    unsigned char dw[MAX_L], dx[MAX_L];
    // each limb's fold constants (ops/ntt_mxu.py fold_constants): a
    // multiple of p at least 2^58, and 2^(40 g) mod p with its Shoup
    // constant for the groups g = 1, 2
    u64 bias[MAX_L], cw[GROUPS - 1][MAX_L], cws[GROUPS - 1][MAX_L];
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@!P1 bra WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// one box of the tensor map into shared memory, completing on the mbarrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y),
          "r"(smem_u32(bar)) : "memory");
}

// a 32-bit word of W from device memory, issued where it stands
__device__ __forceinline__ unsigned ld_w(const signed char* p) {
    unsigned v;
    asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ void producer_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(PRODUCERS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void keep(int& v) { asm volatile("" : "+r"(v)::"memory"); }

// the B operand's descriptor, no swizzle, K-major: core matrices of 8 rows
// x 16 bytes, LBO the step between the two k16 halves of a k32 step, SBO
// the step between 8-row groups (bytes; the fields hold them >> 4)
__device__ __forceinline__ u64 desc_of(unsigned addr, unsigned lbo, unsigned sbo) {
    return (u64)((addr & 0x3FFFF) >> 4) | ((u64)(lbo >> 4) << 16) | ((u64)(sbo >> 4) << 32);
}

// d (+)= A B for m64nNk32 s8: A from four registers a thread, B by a
// descriptor register (written before the wgmma.fence that precedes it);
// accumulate 0 overwrites d (a plane's first product)
template <int N>
__device__ __forceinline__ void wgmma_rs(int (&d)[N / 2], const unsigned (&a)[4], u64 desc,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_rs<16>(int (&d)[8], const unsigned (&a)[4], u64 desc,
                                              int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (+)= A B for m64nNk32 s8 with both operands by descriptor, each formed
// inside the asm from a 32-bit base, an offset and its high word
template <int N>
__device__ __forceinline__ void wgmma_ss(int (&d)[N / 2], unsigned alo, unsigned aoff,
                                         unsigned ahi, unsigned blo, unsigned boff, unsigned bhi,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<32>(int (&d)[16], unsigned alo, unsigned aoff,
                                              unsigned ahi, unsigned blo, unsigned boff,
                                              unsigned bhi, int accumulate) {
    asm volatile("{\n.reg .pred p;\n.reg .b32 alo, blo;\n.reg .b64 da, db;\n"
                 "add.u32 alo, %16, %17;\n"
                 "mov.b64 da, {alo, %18};\n"
                 "add.u32 blo, %19, %20;\n"
                 "mov.b64 db, {blo, %21};\n"
                 "setp.ne.b32 p, %22, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, da, db, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
                 : "r"(alo), "r"(aoff), "r"(ahi), "r"(blo), "r"(boff), "r"(bhi),
                   "r"(accumulate));
}


// words w[e] = byte e of v[0..3] (byte i of w[e] from v[i]): a 4 x 4 byte transpose
__device__ __forceinline__ void transpose4(const unsigned (&v)[4], unsigned* w) {
    const unsigned a = __byte_perm(v[0], v[1], 0x5140), b = __byte_perm(v[0], v[1], 0x7362);
    const unsigned c = __byte_perm(v[2], v[3], 0x5140), d = __byte_perm(v[2], v[3], 0x7362);
    w[0] = __byte_perm(a, c, 0x5410);
    w[1] = __byte_perm(a, c, 0x7632);
    w[2] = __byte_perm(b, d, 0x5410);
    w[3] = __byte_perm(b, d, 0x7632);
}

// The producer warpgroup: item i of the CTA is data tile blockIdx.x + i *
// gridDim.x of the limb, fetched by TMA as two halves (pass A: k rows
// [0, Kp/2) and [Kp/2, Kp), in boxes of 16 columns; pass B: n rows [0,
// NT/2) and [NT/2, NT), in boxes of 16 k) into two raw slots, each split
// into the item's stage as soon as it lands; the slot is then refilled with
// the next item's half.  A box row is 128 bytes with the 128-byte swizzle:
// the 16-byte chunk c of row r sits at chunk c ^ (r & 7), so that the
// split's reads of eight rows hit distinct banks.
template <int NT>
__device__ __forceinline__ void produce(const Params& P, unsigned char* smem, int l,
                                        long long nitems) {
    unsigned long long* bars = (unsigned long long*)smem;
    unsigned long long* full = bars + BAR_FULL;
    unsigned long long* empty = bars + BAR_EMPTY;
    unsigned long long* rawfull = bars + BAR_RAW;
    const int t = threadIdx.x - CONSUMERS * WG, warp = t >> 5, lane = t & 31;
    const int dx = P.dx[l];
    const long long ntmask = (1LL << P.log_ntiles) - 1;
    // the raw halves start at a 1024-byte boundary (the swizzle's period)
    const unsigned base = smem_u32(smem);
    unsigned char* rawbase = smem + (((base + P.raw_off + 1023) & ~1023u) - base);

    auto issue = [&](long long i, int h) {   // thread 0
        const long long it = blockIdx.x + i * gridDim.x;
        const long long row = (it >> P.log_ntiles) * P.L + l;
        const int n0 = (int)(it & ntmask) * NT;
        unsigned char* dst = rawbase + h * P.raw_half;
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect(rawfull + h, (unsigned)(P.boxes * P.box_bytes));
        for (int b = 0; b < P.boxes; ++b) {
            if (P.mode == 0)
                tma_load(dst + b * P.box_bytes, &P.tmap, n0 + BOX * b,
                         (int)(row * P.K) + h * (P.Kp >> 1), rawfull + h);
            else
                tma_load(dst + b * P.box_bytes, &P.tmap, BOX * b,
                         (int)(row * P.n) + n0 + h * (NT / 2), rawfull + h);
        }
    };

    // one core matrix (8 rows n x 16 bytes k) of each digit plane a warp
    // step: lane (n_in = lane & 7, kq = lane >> 3) splits x[n][4 kq .. 4 kq + 3]
    auto split = [&](int h, unsigned char* st) {
        const unsigned char* raw = rawbase + h * P.raw_half;
        const int n_in = lane & 7, kq = lane >> 3;
        const int units = P.mode == 0 ? (NT / 8) * (P.Kp >> 5) : (NT / 16) * (P.Kp >> 4);
        for (int u = warp; u < units; u += PRODUCER_WARPS) {
            int nb, kb;
            u64 v[4];
            if (P.mode == 0) {   // box rows are k, its 16 columns n
                nb = u & (NT / 8 - 1);
                const int kbl = u / (NT / 8);
                kb = h * (P.Kp >> 5) + kbl;
                const int nl = nb * 8 + n_in, c = nl & (BOX - 1);
                const unsigned char* box = raw + (nl / BOX) * P.box_bytes + (c & 1) * 8;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int r = kbl * 16 + 4 * kq + i;
                    v[i] = *(const u64*)(box + r * 128 + (((c >> 1) ^ (r & 7)) << 4));
                }
            } else {             // box rows are n, its 16 columns k
                const int nbl = u & (NT / 16 - 1);
                kb = u / (NT / 16);
                nb = h * (NT / 16) + nbl;
                const int r = nbl * 8 + n_in;
                const unsigned char* row = raw + kb * P.box_bytes + r * 128;
                const ulonglong2 a = *(const ulonglong2*)(row + (((2 * kq) ^ (r & 7)) << 4));
                const ulonglong2 b = *(const ulonglong2*)(row + (((2 * kq + 1) ^ (r & 7)) << 4));
                v[0] = a.x;
                v[1] = a.y;
                v[2] = b.x;
                v[3] = b.y;
            }
            unsigned lo[4], hi[4], wd[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const u64 y = (v[i] + 0x8080808080808080ull) ^ 0x8080808080808080ull;
                lo[i] = (unsigned)y;
                hi[i] = (unsigned)(y >> 32);
            }
            transpose4(lo, wd);
            transpose4(hi, wd + 4);
            unsigned char* dst = st + (kb * (NT / 8) + nb) * 128 + n_in * 16 + kq * 4;
#pragma unroll
            for (int e = 0; e < DX_MAX; ++e)
                if (e < dx) *(unsigned*)(dst + e * P.plane_bytes) = wd[e];
        }
    };

    if (nitems > 0 && t == 0) {
        issue(0, 0);
        issue(0, 1);
    }
    int s = 0;
    unsigned ph = 0;
    for (long long i = 0; i < nitems; ++i) {
        mbar_wait(empty + s, ph ^ 1);
        unsigned char* st = smem + P.st_off + s * P.stage_bytes;
        for (int h = 0; h < 2; ++h) {
            mbar_wait(rawfull + h, (unsigned)(i & 1));
            split(h, st);
            // the digits reach wgmma (the async proxy); the slot is free again
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            producer_sync();
            if (t == 0 && i + 1 < nitems) issue(i + 1, h);
        }
        if (t == 0) mbar_arrive(full + s);
        if (++s == P.stages) {
            s = 0;
            ph ^= 1;
        }
    }
}

// A consumer warpgroup: 64 rows of W (m0 ..) by the stage's NT columns, the
// planes five at a time, each group folded into a residue, then the
// epilogue.  KS: k32 steps of W (all of K with W resident, K / 32; a chunk
// of four steps from device memory above K = 128).
template <int NT, bool RES, int KS>
__device__ __forceinline__ void consume(const Params& P, unsigned char* smem, int l, int mblk,
                                        long long nitems) {
    constexpr int OUT = NT / 2;   // accumulators of a plane a thread: its outputs
    unsigned long long* bars = (unsigned long long*)smem;
    unsigned long long* full = bars + BAR_FULL;
    unsigned long long* empty = bars + BAR_EMPTY;
    const u64* cst = (const u64*)(smem + CONST_OFF);
    const int c = threadIdx.x >> 7, t = threadIdx.x & (WG - 1);
    const int w = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
    const int dw = P.dw[l], dx = P.dx[l];
    const int S = dw + dx - 1;
    // W resident: its 64-row tiles a CTA and the stage's plane size are
    // fixed by K (KS k32 steps), so every offset below is a constant
    constexpr int MT = RES ? (KS == 4 ? 2 : 1) : 2;
    const int mtile = MT == 2 ? c : 0;
    const int m0 = mblk * 128 + mtile * 64;
    const int kst = RES ? KS : P.Kp >> 5;
    const int nkc = RES ? 1 : kst / KS;
    const unsigned lbo = (NT / 8) * 128;
    const u64 dhi = desc_of(0, lbo, 128);
    const unsigned sbase = smem_u32(smem + P.st_off);
    const int plane_bytes = RES ? NT * 32 * KS : P.plane_bytes;
    // W resident: its tile's core matrices (8 rows x 16 bytes) at (kb * 8 +
    // mb) * 128 in a block of 64 rows x Kp bytes a digit and tile, LBO 1024
    // along k, SBO 128 along m; the stage's planes: LBO NT / 8 x 128, SBO 128
    const u64 adesc = desc_of(smem_u32(smem + P.w_off + mtile * KS * 2048), 8 * 128, 128);
    const unsigned alo = (unsigned)adesc, ahw = (unsigned)(adesc >> 32);
    const unsigned blo = (unsigned)dhi, bhw = (unsigned)(dhi >> 32);
    const signed char* wglob =
        P.w + ((long long)l * P.dwt * P.K + m0 + 16 * w + gq) * P.K + 4 * tq;
    const long long kk = (long long)P.K * P.K;
    const long long rowsz = (long long)P.K * P.n;
    const long long ntmask = (1LL << P.log_ntiles) - 1;

    int s = 0;
    unsigned ph = 0;
    for (long long i = 0; i < nitems; ++i) {
        const int cur = s;
        const unsigned cph = ph;
        if (++s == P.stages) {
            s = 0;
            ph ^= 1;
        }
        if (MT == 1 && (int)(i & 1) != c) continue;
        mbar_wait(full + cur, cph);
        const unsigned stage = sbase + cur * P.stage_bytes;
        int acc[G][OUT];
        u64 res[OUT];
        unsigned a[2][4];   // W's fragments from device memory (K > 128), two buffers
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
            if (G * g >= S) continue;
            // only wgmma writes the accumulators from here to the wait: each
            // plane's first product overwrites it
            if constexpr (RES) {
                // both operands from shared memory, the group's products in
                // one commit group
                wgmma_fence();
#pragma unroll
                for (int d = 0; d < DW_MAX; ++d) {
                    // digit d meets e = G g + ii - d; plane s's first pair is
                    // digit max(0, s - dx + 1)
                    if (d + DX_MAX <= G * g || d >= G * g + G) continue;
                    if (d >= dw || G * g - d >= dx) continue;
#pragma unroll
                    for (int kg = 0; kg < KS; ++kg) {
#pragma unroll
                        for (int ii = 0; ii < G; ++ii) {
                            const int e = G * g + ii - d;
                            if (e < 0 || e >= DX_MAX) continue;
                            if (e < dx)
                                wgmma_ss<NT>(acc[ii], alo, ((d * MT * KS + kg) * 2048) >> 4, ahw,
                                             blo | (stage >> 4),
                                             (e * plane_bytes + kg * 2 * lbo) >> 4, bhw,
                                             kg > 0 || d > max(0, G * g + ii - dx + 1));
                        }
                    }
                }
                wgmma_commit();
            } else {
                // W's fragments from device memory, one k32 step a load, in
                // two register buffers that alternate along the group's run
                // of loads (the digits that meet some e < dx form one run);
                // each step's descriptors and first-product flags are written
                // before its fence
                for (int kc = 0; kc < nkc; ++kc) {
                    if (kc) wgmma_wait<0>();   // the fragment buffers are free
#pragma unroll
                    for (int d = 0; d < DW_MAX; ++d) {
                        if (d + DX_MAX <= G * g || d >= G * g + G) continue;
                        if (d >= dw || G * g - d >= dx) continue;
#pragma unroll
                        for (int sub = 0; sub < KS; ++sub) {
                            const int b = (d * KS + sub) & 1, kg = kc * KS + sub;
                            wgmma_wait<1>();   // the step before the last is done with a[b]
                            const signed char* q = wglob + d * kk + kg * 32;
                            a[b][0] = ld_w(q);
                            a[b][1] = ld_w(q + 8 * P.K);
                            a[b][2] = ld_w(q + 16);
                            a[b][3] = ld_w(q + 8 * P.K + 16);
                            u64 bd[G];
                            int more[G];
#pragma unroll
                            for (int ii = 0; ii < G; ++ii) {
                                const int e = G * g + ii - d;
                                bd[ii] = dhi | ((stage + e * plane_bytes + kg * 2 * lbo) >> 4);
                                more[ii] = kg > 0 || d > max(0, G * g + ii - dx + 1);
                            }
                            wgmma_fence();
#pragma unroll
                            for (int ii = 0; ii < G; ++ii) {
                                const int e = G * g + ii - d;
                                if (e < 0 || e >= DX_MAX) continue;
                                if (e < dx) wgmma_rs<NT>(acc[ii], a[b], bd[ii], more[ii]);
                            }
                            wgmma_commit();
                        }
                    }
                }
            }
            wgmma_wait<0>();
#pragma unroll
            for (int ii = 0; ii < G; ++ii)
#pragma unroll
                for (int j = 0; j < OUT; ++j) keep(acc[ii][j]);
            // the last group's products are done: the stage goes back
            if (g == (S - 1) / G && lane == 0) mbar_arrive(empty + cur);
            // fold: the group's int64 partial sum_ii plane (G g + ii) 2^(8 ii)
            // (|partial| < 2^58), made non-negative by a multiple of p, times
            // 2^(40 g) mod p by a Shoup product, into the running residue
#pragma unroll
            for (int j = 0; j < OUT; ++j) {
                long long part = (long long)acc[0][j];
#pragma unroll
                for (int ii = 1; ii < G; ++ii)
                    if (G * g + ii < S) part += (long long)acc[ii][j] * (1LL << (8 * ii));
                const u64 p = cst[C_P], u = (u64)part + cst[C_BIAS];
                if (g == 0)
                    res[j] = mul_mod_shoup(u, 1, cst[C_ONE_S], p);
                else
                    res[j] = add_mod(res[j],
                                     mul_mod_shoup(u, cst[C_W + 2 * (g - 1)], cst[C_W + 2 * g - 1], p),
                                     p);
            }
        }

        // epilogue: the twist, u64 out
        const u64 p = cst[C_P];
        const long long it = blockIdx.x + i * gridDim.x;
        u64* orow = P.out + ((it >> P.log_ntiles) * P.L + l) * rowsz;
        const int n0 = (int)(it & ntmask) * NT;
        const long long tofs = (long long)l * rowsz;
        // the twist words first, so that their loads overlap the reductions
        u64 tv[OUT], ts[OUT];
        if (P.tw) {
#pragma unroll
            for (int j8 = 0; j8 < NT / 8; ++j8) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int j = 4 * j8 + 2 * h;
                    const int m = m0 + 16 * w + gq + 8 * h, n = n0 + 8 * j8 + 2 * tq;
                    tv[j] = tv[j + 1] = ts[j] = ts[j + 1] = 0;
                    if (m >= P.K || n >= P.n) continue;
                    if (P.mode == 0) {
                        const long long idx = tofs + (long long)m * P.n + n;
                        const ulonglong2 a2 = *(const ulonglong2*)(P.tw + idx);
                        const ulonglong2 b2 = *(const ulonglong2*)(P.tws + idx);
                        tv[j] = a2.x;
                        tv[j + 1] = a2.y;
                        ts[j] = b2.x;
                        ts[j + 1] = b2.y;
                    } else {
                        const long long idx = tofs + (long long)n * P.K + m;
                        tv[j] = P.tw[idx];
                        ts[j] = P.tws[idx];
                        tv[j + 1] = P.tw[idx + P.K];
                        ts[j + 1] = P.tws[idx + P.K];
                    }
                }
            }
        }
#pragma unroll
        for (int j8 = 0; j8 < NT / 8; ++j8) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + 16 * w + gq + 8 * h;
                const int n = n0 + 8 * j8 + 2 * tq;
                u64 r[2];
#pragma unroll
                for (int c2 = 0; c2 < 2; ++c2) {
                    const int j = 4 * j8 + 2 * h + c2;
                    r[c2] = P.tw ? mul_mod_shoup(res[j], tv[j], ts[j], p) : res[j];
                }
                if (m >= P.K || n >= P.n) continue;
                if (P.mode == 0) {
                    *(ulonglong2*)(orow + (long long)m * P.n + n) = make_ulonglong2(r[0], r[1]);
                } else {
                    const long long idx = (long long)n * P.K + m;
                    orow[idx] = r[0];
                    orow[idx + P.K] = r[1];
                }
            }
        }
    }
}

template <int NT, bool RES, int KS>
__global__ void __launch_bounds__(THREADS, 1) ntt_mxu_kernel(const __grid_constant__ Params P) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const int l = blockIdx.y >> P.log_mblocks;
    const int mblk = blockIdx.y & ((1 << P.log_mblocks) - 1);
    const long long nitems =
        P.items > blockIdx.x ? (P.items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
    unsigned long long* bars = (unsigned long long*)smem;
    if (threadIdx.x == 0) {
        for (int s = 0; s < P.stages; ++s) {
            mbar_init(bars + BAR_FULL + s, 1);                            // the producer
            mbar_init(bars + BAR_EMPTY + s, (WG / 32) * (P.mt == 2 ? 2 : 1));  // consumer warps
        }
        mbar_init(bars + BAR_RAW, 1);                                     // the raw halves
        mbar_init(bars + BAR_RAW + 1, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (threadIdx.x < C_COUNT) {
        const int q = threadIdx.x, g = (q - C_W) >> 1;
        ((u64*)(smem + CONST_OFF))[q] = q == C_P ? P.mod[l] : q == C_ONE_S ? P.r1[l]
                                        : q == C_BIAS ? P.bias[l]
                                        : ((q - C_W) & 1) ? P.cws[g][l] : P.cw[g][l];
    }
    if constexpr (RES) {
        // W's rows of this CTA as wgmma's A operand: a block of 64 rows x Kp
        // bytes a digit and tile, core matrices of 8 rows x 16 bytes at
        // (kb * 8 + mb) * 128, zero outside the matrix
        const int kbs = P.Kp >> 4, dwl = P.dw[l];
        const int units = dwl * P.mt * 64 * kbs;
        for (int u = threadIdx.x; u < units; u += THREADS) {
            const int mi = u & 63, rest = u >> 6;
            const int kb = rest % kbs, tile = (rest / kbs) % P.mt, d = rest / (kbs * P.mt);
            const int m = mblk * 128 + tile * 64 + mi, k0 = kb * 16;
            const signed char* row = P.w + (((long long)l * P.dwt + d) * P.K + m) * P.K;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (m < P.K && k0 < P.K) {
                if ((P.K & 15) == 0) {
                    v = *(const uint4*)(row + k0);
                } else {
                    unsigned char bytes[16];
#pragma unroll
                    for (int b = 0; b < 16; ++b) bytes[b] = k0 + b < P.K ? row[k0 + b] : 0;
                    v = make_uint4(bytes[0] | bytes[1] << 8 | bytes[2] << 16 | (unsigned)bytes[3] << 24,
                                   bytes[4] | bytes[5] << 8 | bytes[6] << 16 | (unsigned)bytes[7] << 24,
                                   bytes[8] | bytes[9] << 8 | bytes[10] << 16 | (unsigned)bytes[11] << 24,
                                   bytes[12] | bytes[13] << 8 | bytes[14] << 16 | (unsigned)bytes[15] << 24);
                }
            }
            *(uint4*)(smem + P.w_off + (d * P.mt + tile) * kbs * 1024 + (kb * 8 + (mi >> 3)) * 128 +
                      (mi & 7) * 16) = v;
        }
    }
    __syncthreads();
    // the role, warp-uniform as the compiler can see (a shuffle from lane 0),
    // so that each branch is compiled for its own register budget
    const int role = __shfl_sync(0xffffffffu, (int)(threadIdx.x / WG), 0);
    if (role >= CONSUMERS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
        produce<NT>(P, smem, l, nitems);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
        consume<NT, RES, KS>(P, smem, l, mblk, nitems);
    }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
    static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
    if (fn == nullptr) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                             cudaEnableDefault, &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = (PFN_cuTensorMapEncodeTiled_v12000)f;
    }
    return fn;
}

template <int NT, bool RES, int KS>
int launch(Params P, const void* x, long long R, long long grid_x, long long smem,
           cudaStream_t stream) {
    // x as a 2-D tensor of u64 for TMA
    PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    cuuint64_t dims[2], strides[1];
    cuuint32_t box[2], es[2] = {1, 1};
    if (P.mode == 0) {
        dims[0] = (cuuint64_t)P.n;
        dims[1] = (cuuint64_t)(R * P.K);
        strides[0] = (cuuint64_t)P.n * 8;
        box[0] = BOX;
        box[1] = (cuuint32_t)(P.Kp / 2);
    } else {
        dims[0] = (cuuint64_t)P.K;
        dims[1] = (cuuint64_t)(R * P.n);
        strides[0] = (cuuint64_t)P.K * 8;
        box[0] = BOX;
        box[1] = NT / 2;
    }
    // the runtime calls come before cuTensorMapEncodeTiled: they make the
    // device's primary context current on the calling thread, and on a
    // thread that has made no runtime call yet (a worker's first launch) the
    // encode finds none and returns CUDA_ERROR_INVALID_CONTEXT
    auto kern = ntt_mxu_kernel<NT, RES, KS>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const CUresult enc = encode(&P.tmap, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, const_cast<void*>(x),
                                dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (enc != CUDA_SUCCESS) return ENCODE_ERROR_BASE + (int)enc;
    kern<<<dim3((unsigned)grid_x, (unsigned)(P.L << P.log_mblocks)), THREADS, smem, stream>>>(P);
    return (int)cudaGetLastError();
}

}  // namespace

// out, x: [R, N1 * N2] u64 rows (limb r % L); w: int8 [L, dwt, K, K] digit
// planes; tw, tws: [L, N1 * N2] twist and its Shoup words, or null for no
// twist; mod, r1: [L] (p and floor(2^64 / p)); fold: 5L u64 in host memory,
// each limb's bias, 2^40 mod p, its Shoup constant, 2^80 mod p and its
// (ops/ntt_mxu.py fold_constants); counts: 2L int64 in host memory, each
// limb's weight and then data digit counts (at most dwt <= 7 and dxt <= 8);
// geom: GEOM_FIELDS int64 in host memory, the launch that ops/ntt_mxu.py
// ntt_mxu_geometry picks (in that order: data columns a stage, W's 64-row
// tiles a CTA, its 128-row blocks a limb (log2), a row's column tiles
// (log2), the stages, the plane, stage, box and raw-half bytes, the boxes a
// half, the offsets of W, the stages and the raw halves, the shared-memory
// bytes and the grid's x), which is checked here against the instantiations
// and the layout they read.  mode 0 is pass A (K = N1, n = N2), mode 1
// pass B (K = N2, n = N1); K and n powers of two, 2 <= K <= 512, n >= 2.
// Returns cudaGetLastError() after the launch, or an error without one:
// ENCODE_ERROR_BASE plus the CUresult of a failed tensor-map encode.
extern "C" int gst_ntt_mxu(void* out, const void* x, const void* w, const void* tw,
                           const void* tws, const void* mod, const void* r1, const void* fold,
                           const void* counts, const void* geom, long long R, long long L,
                           long long K, long long n, long long mode, long long dwt, long long dxt,
                           void* stream) {
    if (R < 0 || L < 1 || L > MAX_L || R % L || K < 2 || K > 512 || (K & (K - 1)) || n < 2 ||
        n > (1 << 16) || (n & (n - 1)) || (mode != 0 && mode != 1) ||
        (tw == nullptr) != (tws == nullptr) || dwt < 1 || dwt > DW_MAX || dxt < 1 ||
        dxt > DX_MAX || counts == nullptr || fold == nullptr || geom == nullptr ||
        R * (K > n ? K : n) >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const void* aligned[4] = {out, x, tw, tws};
    for (const void* q : aligned)
        if ((reinterpret_cast<unsigned long long>(q) & 15) != 0) return (int)cudaErrorInvalidValue;
    if (R == 0) return 0;
    Params P;
    P.out = (u64*)out;
    P.w = (const signed char*)w;
    P.tw = (const u64*)tw;
    P.tws = (const u64*)tws;
    P.mod = (const u64*)mod;
    P.r1 = (const u64*)r1;
    P.K = (int)K;
    P.n = (int)n;
    P.mode = (int)mode;
    P.L = (int)L;
    P.Kp = K < 32 ? 32 : (int)K;
    P.dwt = (int)dwt;
    // the host's geometry, checked: an instantiation takes it (32 columns
    // with W resident up to K = 128, 16 with W from device memory above),
    // W's tiles and blocks and the column tiles cover K and n, and the
    // layout is the one the kernel reads and fits in shared memory
    const long long* g = (const long long*)geom;
    const long long nt = g[0], grid_x = g[14], smem = g[13];
    const bool res = K <= 128;
    const int ks = P.Kp >> 5;
    P.mt = (int)g[1];
    P.log_mblocks = (int)g[2];
    P.log_ntiles = (int)g[3];
    P.stages = (int)g[4];
    P.plane_bytes = (int)g[5];
    P.stage_bytes = (int)g[6];
    P.box_bytes = (int)g[7];
    P.raw_half = (int)g[8];
    P.boxes = (int)g[9];
    P.w_off = (int)g[10];
    P.st_off = (int)g[11];
    P.raw_off = (int)g[12];
    const long long kcover = n > nt ? n : nt, mcover = K > 64 * P.mt ? K : 64 * P.mt;
    if (nt != (res ? 32 : 16) || P.mt != (res && ks < 4 ? 1 : 2) || P.log_mblocks < 0 ||
        P.log_mblocks > 2 || ((64LL * P.mt) << P.log_mblocks) != mcover || P.log_ntiles < 0 ||
        P.log_ntiles > 15 || (nt << P.log_ntiles) != kcover ||
        P.plane_bytes != nt * P.Kp || P.stage_bytes != dxt * P.plane_bytes ||
        P.boxes * BOX != (mode == 0 ? nt : P.Kp) ||
        P.box_bytes != (mode == 0 ? P.Kp / 2 : nt / 2) * BOX * 8 ||
        P.raw_half != P.boxes * P.box_bytes || P.stages < 2 || P.stages > MAX_STAGES ||
        P.w_off != BAR_BYTES || P.st_off % 128 ||
        P.st_off < P.w_off + (res ? P.dwt * ks * P.mt * WG * 16 : 0) ||
        P.raw_off < P.st_off + P.stages * P.stage_bytes ||
        smem < P.raw_off + 2LL * P.raw_half + 1024 || smem > SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    P.items = (R / L) << P.log_ntiles;
    if (grid_x < 1 || grid_x > P.items) return (int)cudaErrorInvalidValue;
    const long long* cnt = (const long long*)counts;
    for (int l = 0; l < L; ++l) {
        const long long dwl = cnt[l], dxl = cnt[L + l];
        if (dwl < 1 || dwl > dwt || dxl < 1 || dxl > dxt) return (int)cudaErrorInvalidValue;
        P.dw[l] = (unsigned char)dwl;
        P.dx[l] = (unsigned char)dxl;
    }
    const u64* fc = (const u64*)fold;
    for (int l = 0; l < L; ++l) {
        P.bias[l] = fc[l];
        for (int q = 0; q < GROUPS - 1; ++q) {
            P.cw[q][l] = fc[(1 + 2 * q) * L + l];
            P.cws[q][l] = fc[(2 + 2 * q) * L + l];
        }
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (!res) return launch<16, false, 4>(P, x, R, grid_x, smem, s);
    if (ks == 4) return launch<32, true, 4>(P, x, R, grid_x, smem, s);
    if (ks == 2) return launch<32, true, 2>(P, x, R, grid_x, smem, s);
    return launch<32, true, 1>(P, x, R, grid_x, smem, s);
}
