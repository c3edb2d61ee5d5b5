// K12: one pass of the four-step NTT as int8 digit-pair matmuls on the
// tensor cores.
//
// Replaces gemini_seal_tpu/ops/ntt_mxu.py:362-367 _pass (the digit split
// _balanced_digits_dev :275-286, the digit-pair matmuls _digit_matmul
// :289-318 and the recombine _combine_planes :321-359) and, in the first
// pass of each direction, the canonical Shoup twist of ntt_forward_mxu /
// ntt_inverse_mxu (:380, :399; mul_mod_shoup, gemini_seal_tpu/ops/
// modops.py:184-190).  The JAX package ran the matmuls on the TPU's matrix
// unit through XLA; here they are mma.sync m16n8k32 s8 x s8 -> s32.
//
// Per poly-limb row (a [N1, N2] matrix x of u64 in [0, 2p)), with W the
// pass's K x K matrix (K = N1 in pass A, N2 in pass B) split into DW
// balanced int8 digit planes W_d and x split into DX digit planes X_e
// (the carry-free +0x80..80 lane trick: digit e is byte e of
// (x + 0x80..80) ^ 0x80..80):
//
//   pass A: out[m, n] = sum_k W[m, k] x[k, n]   (m, k < N1; n < N2)
//   pass B: out[n, m] = sum_k W[m, k] x[n, k]   (m, k < N2; n < N1)
//   plane_s = sum_{d + e = s} W_d X_e            (int32, s < S = DW + DX - 1)
//   out = barrett_128(offset + sum_s plane_s * 2^(8 s))   [* twist, Shoup]
//
// with the builder's 128-bit ladder offset (a multiple of p above every
// negative partial), so the 128-bit value, and with it every output word,
// is the JAX package's.  A plane sums at most 7 pairs of K <= 512 products
// of |digit| <= 128: |plane| < 7 * 512 * 2^14 < 2^26, in int32.
//
// Bound on the H100: the int8 tensor cores.  A row costs DW * DX * K * K *
// (other axis) MACs, 49 * 128^3 = 103e6 a pass at N=16384 (DW = DX = 7):
// 158e9 MACs a pass on 1,536 rows, 0.16 ms at 989.5e12 MACs/s (the dense
// int8 peak, which only wgmma reaches; mma.sync issues the same products
// at about 60% of it on this card, 0.26 ms a pass), against 0.06 ms for its
// bytes (the u64 rows read once and written once, the digit tables, the
// twist).  The recombine is adds and shifts plus one Barrett reduction a
// word (24 IMADs) and the twist (10).
//
// Design.  A block holds the pass matrix's digit planes for one (limb,
// m-tile) in shared memory, Ws[d][m][k] (row pitch KC + 16 bytes, so that
// the fragment loads of a warp hit 32 distinct banks); at K <= 128 they
// stay resident for the block's life (one load of 114 KiB at K = 128), a
// larger K is walked in chunks of KC = 128.  The block's 16 warps form two
// groups of 8; each group walks its own share of the limb's data tiles
// (BN columns of one row, BM x BN = 1024 outputs) at its own pace, behind
// its own named barrier, and the second group starts one step behind the
// first, so that one group's epilogue and digit split run beside the other
// group's mma.  The raw u64 tile of a group's next step is fetched with
// cp.async into its staging buffer (zero-filled outside the matrix, which
// also pads K < 32 to one k32 step) while its warps run the current step;
// each step splits the staged words into DX planes Xs[e][n][k] (k
// contiguous: pass A's data is transposed on the way in).  Each warp owns a
// 16 x 8 output tile and keeps all S planes of it in registers (4 S int32
// a thread); per k32 step it loads the DX B fragments once, then per weight
// digit d one A fragment and DX mma into planes d + e.  In the first pass
// each thread copies its outputs' twist words with cp.async into its own
// shared-memory slots during the mma.  The epilogue folds the planes into
// four int64 partial sums of four shifts each (|sum| < 2^51), then one
// 128-bit sum with the offset, reduces, twists and writes u64.
#include "modops.cuh"

namespace {

constexpr int GROUP_WARPS = 8; // a group's warps, each a 16 x 8 output tile
constexpr int GROUP_THREADS = GROUP_WARPS * 32;
constexpr int GROUPS = 2;      // warp groups, each walking its own items
constexpr int THREADS = GROUPS * GROUP_THREADS;
constexpr int KC_MAX = 128;    // contraction chunk in shared memory
constexpr int PAD = 16;        // bytes after each digit row

struct Geom {
    int M, N, K;          // M = K: the matrix side; N: the data's other axis
    int mode;             // 0: pass A (out [m, n], x [k, n]); 1: pass B (out [n, m], x [n, k])
    int L;
    int BM, BN, KC;       // a group's tile (BM x BN outputs) and contraction chunk
    int bn_log, kc_log;
    int mtiles, ntiles, nchunks;
    int group_bytes;      // shared memory of one group: its digit planes and staging
    long long rows_per_limb;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int bytes = valid ? 8 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes));
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

template <int DW, int DX>
__global__ void __launch_bounds__(THREADS, 1)
ntt_mxu_kernel(u64* __restrict__ out, const u64* __restrict__ x, const signed char* __restrict__ w,
               const u64* __restrict__ tw, const u64* __restrict__ tws,
               const u64* __restrict__ mod, const u64* __restrict__ r0s,
               const u64* __restrict__ r1s, const u64* __restrict__ offs, const Geom g) {
    constexpr int S = DW + DX - 1;
    extern __shared__ __align__(16) unsigned char smem[];
    const int KR = g.KC + PAD;                       // digit row pitch, bytes
    const int SR = g.KC + 1;                         // staging row pitch, words
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int grp = warp / GROUP_WARPS, gtid = tid % GROUP_THREADS;
    const int gq = lane >> 2, tq = lane & 3;
    unsigned char* ws = smem;                                     // [DW][BM][KR]
    unsigned char* xs = ws + DW * g.BM * KR + grp * g.group_bytes; // [DX][BN][KR]
    u64* stage = (u64*)(xs + DX * g.BN * KR);                      // [BN][SR]
    // per warp: the twist words of its lanes' 4 outputs, [4][2][32]
    u64* twbuf = (u64*)(ws + DW * g.BM * KR + GROUPS * g.group_bytes);

    const int wtm = g.BM / 16;
    const int wm = (warp % GROUP_WARPS) % wtm, wn = (warp % GROUP_WARPS) / wtm;
    const bool active = wn < g.BN / 8;

    const int l = blockIdx.y / g.mtiles;
    const int m0 = (blockIdx.y % g.mtiles) * g.BM;
    const long long items = g.rows_per_limb * g.ntiles;
    if (blockIdx.x >= items) return;
    const long long nb = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
    // the weights stay resident when one chunk covers K: the groups then take
    // turns over the items at their own pace (group barriers); otherwise they
    // step through the chunks together, sharing each weight chunk
    const bool resident = g.nchunks == 1;
    const long long gitems = resident ? (nb - grp + GROUPS - 1) / GROUPS
                                      : (nb + GROUPS - 1) / GROUPS;
    const long long nsteps = gitems * g.nchunks;
    const long long rowsz = (long long)g.N * g.K;

    auto gsync = [&]() {
        if (resident) asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(GROUP_THREADS));
        else __syncthreads();
    };

    // step j of this group: chunk j % nchunks of its block-local item i
    auto coords = [&](long long j, long long& row, int& n0, int& k0) {
        const long long i = (j / g.nchunks) * GROUPS + grp;
        const long long item = blockIdx.x + i * gridDim.x;
        row = (item / g.ntiles) * g.L + l;
        n0 = (int)(item % g.ntiles) * g.BN;
        k0 = (int)(j % g.nchunks) * g.KC;
        return i < nb;
    };

    auto prefetch = [&](long long j) {
        long long row;
        int n0, k0;
        if (coords(j, row, n0, k0)) {
            const u64* xr = x + row * rowsz;
            const int elems = g.BN * g.KC;
            for (int e = gtid; e < elems; e += GROUP_THREADS) {
                int n, k;
                if (g.mode == 0) { n = e & (g.BN - 1); k = e >> g.bn_log; }  // n contiguous
                else { k = e & (g.KC - 1); n = e >> g.kc_log; }            // k contiguous
                const int gn = n0 + n, gk = k0 + k;
                const bool valid = gn < g.N && gk < g.K;
                const u64* src = !valid ? xr
                                 : g.mode == 0 ? xr + (long long)gk * g.N + gn
                                               : xr + (long long)gn * g.K + gk;
                cp_async8(stage + n * SR + k, src, valid);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };

    auto load_w = [&](int k0) {
        const signed char* wl = w + (long long)l * DW * g.M * g.K;
        if (g.K % 16 == 0) {
            const int kv = g.KC / 16;
            const int units = DW * g.BM * kv;
            for (int u = tid; u < units; u += THREADS) {
                const int kq = u % kv, m = (u / kv) % g.BM, d = u / (kv * g.BM);
                const int gm = m0 + m, gk = k0 + kq * 16;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (gm < g.M && gk < g.K)
                    v = *(const uint4*)(wl + ((long long)d * g.M + gm) * g.K + gk);
                *(uint4*)(ws + (d * g.BM + m) * KR + kq * 16) = v;
            }
        } else {
            const int units = DW * g.BM * g.KC;
            for (int u = tid; u < units; u += THREADS) {
                const int k = u % g.KC, m = (u / g.KC) % g.BM, d = u / (g.KC * g.BM);
                const int gm = m0 + m, gk = k0 + k;
                ws[(d * g.BM + m) * KR + k] =
                    gm < g.M && gk < g.K ? (unsigned char)wl[((long long)d * g.M + gm) * g.K + gk]
                                         : 0;
            }
        }
    };

    auto split = [&]() {
        const int kq4 = g.KC / 4;
        const int quads = g.BN * kq4;
        for (int q = gtid; q < quads; q += GROUP_THREADS) {
            const int kq = q & (kq4 - 1), n = q >> (g.kc_log - 2);
            const u64* src = stage + n * SR + kq * 4;
            unsigned lo[4], hi[4], wd[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const u64 v = (src[i] + 0x8080808080808080ull) ^ 0x8080808080808080ull;
                lo[i] = (unsigned)v;
                hi[i] = (unsigned)(v >> 32);
            }
            transpose4(lo, wd);
            transpose4(hi, wd + 4);
#pragma unroll
            for (int e = 0; e < DX; ++e)
                *(unsigned*)(xs + (e * g.BN + n) * KR + kq * 4) = wd[e];
        }
    };

    int acc[S][4];   // [plane][fragment]
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[s][i] = 0;

    auto compute = [&]() {
        const unsigned char* xw = xs + (wn * 8 + gq) * KR + tq * 4;
        const unsigned char* ww = ws + (wm * 16 + gq) * KR + tq * 4;
        for (int kk = 0; kk < g.KC; kk += 32) {
            unsigned b[DX][2];
#pragma unroll
            for (int e = 0; e < DX; ++e) {
                const unsigned char* pb = xw + e * g.BN * KR + kk;
                b[e][0] = *(const unsigned*)pb;
                b[e][1] = *(const unsigned*)(pb + 16);
            }
#pragma unroll
            for (int d = 0; d < DW; ++d) {
                const unsigned char* pa = ww + d * g.BM * KR + kk;
                const unsigned a[4] = {*(const unsigned*)pa, *(const unsigned*)(pa + 8 * KR),
                                       *(const unsigned*)(pa + 16),
                                       *(const unsigned*)(pa + 8 * KR + 16)};
#pragma unroll
                for (int e = 0; e < DX; ++e) mma_s8(acc[d + e], a, b[e][0], b[e][1]);
            }
        }
    };

    // this thread's 4 outputs of the warp tile at column n0: their offset in
    // the row and whether they lie inside the matrix
    long long idx[4];
    bool ok[4];
    auto locate = [&](int n0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int h = i >> 1, c = i & 1;
            const int m = m0 + wm * 16 + gq + 8 * h;
            const int n = n0 + wn * 8 + 2 * tq + c;
            ok[i] = m < g.M && n < g.N;
            idx[i] = !ok[i] ? 0 : g.mode == 0 ? (long long)m * g.N + n : (long long)n * g.K + m;
        }
    };
    // the twist words of those outputs, copied by this thread into its own
    // slots (so its own cp.async wait suffices) while its warp runs the mma
    u64* tslot = twbuf + warp * 4 * 2 * 32 + lane;   // [i][w, w_shoup][lane]
    auto fetch_twist = [&](int n0) {
        locate(n0);
        const long long tofs = (long long)l * rowsz;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            cp_async8(tslot + (2 * i) * 32, tw + tofs + idx[i], ok[i]);
            cp_async8(tslot + (2 * i + 1) * 32, tws + tofs + idx[i], ok[i]);
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };

    auto epilogue = [&](long long row, int n0) {
        const u64 p = mod[l], r0 = r0s[l], r1 = r1s[l];
        const unsigned __int128 offset =
            ((unsigned __int128)offs[2 * l + 1] << 64) | (unsigned __int128)offs[2 * l];
        u64* orow = out + row * rowsz;
        locate(n0);
        if (tw) asm volatile("cp.async.wait_all;\n" ::);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            long long part[4] = {0, 0, 0, 0};
#pragma unroll
            for (int s = 0; s < S; ++s)
                part[s >> 2] += (long long)acc[s][i] * (1LL << (8 * (s & 3)));
            unsigned __int128 v = offset;
            v += (unsigned __int128)(__int128)part[0];
            v += (unsigned __int128)(__int128)part[1] << 32;
            v += (unsigned __int128)(__int128)part[2] << 64;
            v += (unsigned __int128)(__int128)part[3] << 96;
            u64 r = barrett_reduce_128((u64)(v >> 64), (u64)v, p, r0, r1);
            if (tw) r = mul_mod_shoup(r, tslot[(2 * i) * 32], tslot[(2 * i + 1) * 32], p);
            if (ok[i]) orow[idx[i]] = r;
        }
    };

    if (resident) {
        load_w(0);
        __syncthreads();
    }
    prefetch(0);
    for (long long j = 0; j < nsteps; ++j) {
        asm volatile("cp.async.wait_all;\n" ::);
        gsync();                         // stage holds step j; the group is done with Xs
        long long row;
        int n0, k0;
        const bool valid = coords(j, row, n0, k0);
        if (valid) split();
        if (!resident) load_w(k0);
        gsync();                         // Xs (and Ws) ready; the stage is free
        if (j + 1 < nsteps) prefetch(j + 1);
        const bool last = k0 + g.KC >= g.K;
        if (tw && last && valid && active) fetch_twist(n0);
        // the second group starts a step behind the first and so stays: while
        // one runs its epilogue and split, the other keeps the tensor cores busy
        if (resident && j == 0 && grp > 0)
            asm volatile("bar.sync %0, %1;\n" ::"r"(3 + grp), "n"(2 * GROUP_THREADS));
        if (valid && active) compute();
        if (resident && j == 0 && grp + 1 < GROUPS && nb > grp + 1)
            asm volatile("bar.arrive %0, %1;\n" ::"r"(4 + grp), "n"(2 * GROUP_THREADS));
        if (last) {
            if (valid && active) epilogue(row, n0);
#pragma unroll
            for (int s = 0; s < S; ++s)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[s][i] = 0;
        }
    }
}

template <int DW, int DX>
int launch(u64* out, const u64* x, const signed char* w, const u64* tw, const u64* tws,
           const u64* mod, const u64* r0, const u64* r1, const u64* off, Geom g,
           cudaStream_t stream) {
    const int kr = g.KC + PAD;
    g.group_bytes = DX * g.BN * kr + g.BN * (g.KC + 1) * 8;
    const size_t smem = (size_t)DW * g.BM * kr + GROUPS * (size_t)g.group_bytes +
                        (tw ? (size_t)THREADS * 8 * 8 : 0);
    auto kern = ntt_mxu_kernel<DW, DX>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, dev = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long groups = (long long)g.L * g.mtiles;
    const long long items = g.rows_per_limb * g.ntiles;
    long long per_group = (long long)sms * (per_sm > 0 ? per_sm : 1) / groups;
    if (per_group < 1) per_group = 1;
    if (per_group > items) per_group = items;
    if (groups > 65535) return (int)cudaErrorInvalidValue;
    kern<<<dim3((unsigned)per_group, (unsigned)groups), THREADS, smem, stream>>>(
        out, x, w, tw, tws, mod, r0, r1, off, g);
    return (int)cudaGetLastError();
}

int pow2_at_least(int v, int floor_) {
    int r = floor_;
    while (r < v) r *= 2;
    return r;
}

int log2i(int v) {
    int r = 0;
    while ((1 << r) < v) ++r;
    return r;
}

}  // namespace

// out, x: [R, N1 * N2] u64 rows (limb r % L); w: int8 [L, DW, K, K] digit
// planes; tw, tws: [L, N1 * N2] twist and its Shoup words, or null for no
// twist; mod, r0, r1: [L]; off: [L, 2] (lo, hi) ladder offsets.  mode 0 is
// pass A (K = N1, n = N2), mode 1 pass B (K = N2, n = N1).  Returns
// cudaGetLastError() after the launch.
extern "C" int gst_ntt_mxu(void* out, const void* x, const void* w, const void* tw,
                           const void* tws, const void* mod, const void* r0, const void* r1,
                           const void* off, long long R, long long L, long long K, long long n,
                           long long mode, long long dw, long long dx, void* stream) {
    if (R < 0 || L < 1 || R % L || K < 2 || n < 1 || (mode != 0 && mode != 1) ||
        (tw == nullptr) != (tws == nullptr))
        return (int)cudaErrorInvalidValue;
    if (R == 0) return 0;
    Geom g;
    g.M = g.K = (int)K;
    g.N = (int)n;
    g.mode = (int)mode;
    g.L = (int)L;
    g.KC = pow2_at_least((int)K, 32);
    if (g.KC > KC_MAX) g.KC = KC_MAX;
    g.BM = pow2_at_least((int)K, 16);
    if (g.BM > 128) g.BM = 128;
    g.BN = 8 * (GROUP_WARPS / (g.BM / 16));   // the group's warps, 16 x 8 outputs each
    const int npad = pow2_at_least((int)n, 8);
    if (g.BN > npad) g.BN = npad;
    g.bn_log = log2i(g.BN);
    g.kc_log = log2i(g.KC);
    g.mtiles = (int)((K + g.BM - 1) / g.BM);
    g.ntiles = (int)((n + g.BN - 1) / g.BN);
    g.nchunks = (int)((K + g.KC - 1) / g.KC);
    g.rows_per_limb = R / L;
    g.group_bytes = 0;
    cudaStream_t s = (cudaStream_t)stream;
    const u64 *px = (const u64*)x, *ptw = (const u64*)tw, *ptws = (const u64*)tws;
    const u64 *pm = (const u64*)mod, *pr0 = (const u64*)r0, *pr1 = (const u64*)r1;
    const u64* poff = (const u64*)off;
    const signed char* pw = (const signed char*)w;
    u64* po = (u64*)out;
#define GST_MXU_CASE(A, B)                                                      \
    if (dw == A && dx == B) return launch<A, B>(po, px, pw, ptw, ptws, pm, pr0, pr1, poff, g, s);
    GST_MXU_CASE(2, 2) GST_MXU_CASE(2, 3) GST_MXU_CASE(3, 3) GST_MXU_CASE(3, 4)
    GST_MXU_CASE(4, 4) GST_MXU_CASE(4, 5) GST_MXU_CASE(5, 5) GST_MXU_CASE(5, 6)
    GST_MXU_CASE(6, 6) GST_MXU_CASE(6, 7) GST_MXU_CASE(7, 7) GST_MXU_CASE(7, 8)
#undef GST_MXU_CASE
    return (int)cudaErrorInvalidValue;
}
