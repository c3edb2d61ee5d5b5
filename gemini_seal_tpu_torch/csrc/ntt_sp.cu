// K11: the cross-chunk stages of the coefficient-sharded negacyclic NTT.
//
// Replaces the stage loops of gemini_seal_tpu/parallel/ntt_sp.py that pair
// coefficients of two ranks' chunks, which XLA lowers for the TPU as a
// collective-permute (or an all_to_all) and a where/select pass per stage:
//
// - mode exchange, one hypercube stage: the forward cross stages of
//   ntt_forward_sharded (ntt_sp.py:106-119) and the inverse ones of
//   ntt_inverse_sharded (:185-208).  It reads the rank's chunk and its
//   partner's (the ppermute's result), takes the lower or upper half of the
//   Shoup butterfly by the rank bit, and writes the rank's chunk: forward
//   x0 = lower ? own : partner kept below 2p, v = x1 w (Shoup, lazy), out =
//   lower ? x0 + v : x0 - v + 2p; inverse t = x0 + x1 kept below 2p, d = x0 -
//   x1 + 2p, out = lower ? t (times n^-1 on the last stage) : d w, reduced
//   to [0, p) on the last stage when asked.
// - mode rows, the four-step form: all log2 C cross stages of
//   forward_4step_local / inverse_4step_local (ntt_sp.py:259-272, :359-373)
//   after the all_to_all transpose, over the row axis of [.., L, C, N/C^2]:
//   one thread owns one column, loads its C values, runs the stages in
//   registers with the twiddles of :263-264 (forward, w[2^s + g]) and
//   :362-363 (inverse, the reordered w[ofs(s) + g], n^-1 folded at the last
//   stage, reduce_once when asked), and writes them back.  C <= 8.
//
// Every value is the JAX loop's: the same lazy ranges, the same Shoup
// products, bit for bit.
//
// Bound on the H100: bytes.  An exchange stage reads the own and the
// partner chunk and writes one chunk (24 bytes a coefficient, one twiddle
// pair a limb) against one Shoup product a coefficient on each rank (10
// IMADs; the JAX schedule computes it on both partners, and so does this
// kernel); a rows launch reads and writes its block once (16 bytes a
// coefficient) against log2 C / 2 Shoup products a coefficient.  At 16.7
// IMADs per byte of the card's balance both sit far on the bytes side.
//
// Design: one thread per coefficient (exchange) or per column (rows), in a
// grid-stride loop, coalesced over the last axis; the twiddles of a stage
// are one pair per limb (exchange) or per group (rows) and stay in L1.  A
// simple kernel: it does not fuse the exchange with the next stage or with
// the chunk-local stages (K1 mode sub_row).
#include "modops.cuh"

__global__ void exchange_kernel(u64* __restrict__ out, const u64* __restrict__ own,
                                const u64* __restrict__ partner, long long total, int L,
                                int log_n, int log_chunk, int inverse, int lower, int tw,
                                int last, int canonical, const u64* __restrict__ w,
                                const u64* __restrict__ ws, const u64* __restrict__ mod,
                                const u64* __restrict__ inv_n,
                                const u64* __restrict__ inv_n_s) {
    const long long n = 1LL << log_n;
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int limb = (int)((idx >> log_chunk) % L);
        const u64 p = mod[limb];
        const u64 two_p = 2 * p;
        const u64 a = own[idx];
        const u64 b = partner[idx];
        const u64 x0 = lower ? a : b;
        const u64 x1 = lower ? b : a;
        const u64 W = w[limb * n + tw];
        const u64 WS = ws[limb * n + tw];
        u64 r;
        if (!inverse) {
            const u64 y0 = x0 >= two_p ? x0 - two_p : x0;
            const u64 v = mul_mod_shoup_lazy(x1, W, WS, p);
            r = lower ? y0 + v : y0 - v + two_p;
        } else if (lower) {
            u64 t = x0 + x1;
            t = t >= two_p ? t - two_p : t;
            r = last ? mul_mod_shoup_lazy(t, inv_n[limb], inv_n_s[limb], p) : t;
        } else {
            r = mul_mod_shoup_lazy(x0 - x1 + two_p, W, WS, p);
        }
        out[idx] = last && canonical ? reduce_once(r, p) : r;
    }
}

template <int LOG_C, bool INVERSE>
__global__ void rows_kernel(u64* __restrict__ out, const u64* __restrict__ in,
                            long long total, int L, int log_n, int log_cc, int canonical,
                            const u64* __restrict__ w, const u64* __restrict__ ws,
                            const u64* __restrict__ mod, const u64* __restrict__ inv_n,
                            const u64* __restrict__ inv_n_s) {
    constexpr int C = 1 << LOG_C;
    const long long n = 1LL << log_n;
    const long long cc = 1LL << log_cc;
    for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const long long row = idx >> log_cc;
        const long long c = idx & (cc - 1);
        const int limb = (int)(row % L);
        const u64 p = mod[limb];
        const u64 two_p = 2 * p;
        const u64* wl = w + limb * n;
        const u64* wsl = ws + limb * n;
        const u64* src = in + row * C * cc + c;
        u64* dst = out + row * C * cc + c;
        u64 v[C];
#pragma unroll
        for (int i = 0; i < C; ++i) v[i] = src[i * cc];
        if (!INVERSE) {
            // stage s: m = 2^s groups of 2 * (C >> (s + 1)) rows, twiddle w[m + g]
#pragma unroll
            for (int s = 0; s < LOG_C; ++s) {
                const int m = 1 << s;
                const int rh = C >> (s + 1);
#pragma unroll
                for (int g = 0; g < m; ++g) {
                    const u64 W = wl[m + g];
                    const u64 WS = wsl[m + g];
#pragma unroll
                    for (int r = 0; r < rh; ++r) {
                        const int i0 = g * 2 * rh + r;
                        const int i1 = i0 + rh;
                        u64 x0 = v[i0];
                        x0 = x0 >= two_p ? x0 - two_p : x0;
                        const u64 t = mul_mod_shoup_lazy(v[i1], W, WS, p);
                        v[i0] = x0 + t;
                        v[i1] = x0 - t + two_p;
                    }
                }
            }
        } else {
            // stage log N - LOG_C + s: C >> (s + 1) groups of 2^(s + 1) rows,
            // twiddle at the reordered table's offset 1 + n - (n >> stage)
            const u64 ninv = inv_n[limb];
            const u64 ninv_s = inv_n_s[limb];
#pragma unroll
            for (int s = 0; s < LOG_C; ++s) {
                const int m = C >> (s + 1);
                const int rh = 1 << s;
                const long long ofs = 1 + n - (n >> (log_n - LOG_C + s));
#pragma unroll
                for (int g = 0; g < m; ++g) {
                    const u64 W = wl[ofs + g];
                    const u64 WS = wsl[ofs + g];
#pragma unroll
                    for (int r = 0; r < rh; ++r) {
                        const int i0 = g * 2 * rh + r;
                        const int i1 = i0 + rh;
                        const u64 a0 = v[i0];
                        const u64 a1 = v[i1];
                        u64 t = a0 + a1;
                        t = t >= two_p ? t - two_p : t;
                        if (m == 1) t = mul_mod_shoup_lazy(t, ninv, ninv_s, p);
                        v[i0] = t;
                        v[i1] = mul_mod_shoup_lazy(a0 - a1 + two_p, W, WS, p);
                    }
                }
            }
            if (canonical) {
#pragma unroll
                for (int i = 0; i < C; ++i) v[i] = reduce_once(v[i], p);
            }
        }
#pragma unroll
        for (int i = 0; i < C; ++i) dst[i * cc] = v[i];
    }
}

template <bool INVERSE>
static void launch_rows(int log_c, unsigned grid, int threads, cudaStream_t st, u64* out,
                        const u64* in, long long total, int L, int log_n, int log_cc,
                        int canonical, const u64* w, const u64* ws, const u64* mod,
                        const u64* inv_n, const u64* inv_n_s) {
    if (log_c == 1)
        rows_kernel<1, INVERSE><<<grid, threads, 0, st>>>(out, in, total, L, log_n, log_cc,
                                                          canonical, w, ws, mod, inv_n, inv_n_s);
    else if (log_c == 2)
        rows_kernel<2, INVERSE><<<grid, threads, 0, st>>>(out, in, total, L, log_n, log_cc,
                                                          canonical, w, ws, mod, inv_n, inv_n_s);
    else
        rows_kernel<3, INVERSE><<<grid, threads, 0, st>>>(out, in, total, L, log_n, log_cc,
                                                          canonical, w, ws, mod, inv_n, inv_n_s);
}

// mode 0 (exchange): out, own, partner [rows, N / C] with rows = batch * L
// (limb = row % L); lower, tw (the stage's twiddle index) and last (the
// inverse's final stage: fold n^-1, and reduce when canonical) as the
// wrapper computes them from the stage and the rank.
// mode 1 (rows): out, own [rows, C, N / C^2]; partner, lower, tw, last unused.
// Tables [L, N], mod / inv_n / inv_n_s [L]; 2 <= C <= 8 for rows.
// Returns cudaGetLastError().
extern "C" int gst_ntt_sp(void* out, const void* own, const void* partner, long long rows,
                          long long L, long long log_n, long long log_c, long long mode,
                          long long inverse, long long lower, long long tw, long long last,
                          long long canonical, const void* w, const void* ws, const void* mod,
                          const void* inv_n, const void* inv_n_s, void* stream) {
    if (log_n < 2 || log_n > 16 || log_c < 1 || log_c >= log_n || L < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    const u64 *W = (const u64*)w, *WS = (const u64*)ws, *M = (const u64*)mod;
    const u64 *NI = (const u64*)inv_n, *NIS = (const u64*)inv_n_s;
    if (mode == 0) {
        if (partner == nullptr || tw < 1 || tw >= (1LL << log_n)) return (int)cudaErrorInvalidValue;
        const int log_chunk = (int)(log_n - log_c);
        const long long total = rows << log_chunk;
        exchange_kernel<<<grid_for(total, threads), threads, 0, st>>>(
            (u64*)out, (const u64*)own, (const u64*)partner, total, (int)L, (int)log_n,
            log_chunk, (int)inverse, (int)lower, (int)tw, (int)last, (int)canonical, W, WS, M,
            NI, NIS);
    } else if (mode == 1) {
        if (log_c > 3 || 2 * log_c > log_n || (!inverse && canonical))
            return (int)cudaErrorInvalidValue;
        const int log_cc = (int)(log_n - 2 * log_c);
        const long long total = rows << log_cc;
        if (inverse)
            launch_rows<true>((int)log_c, grid_for(total, threads), threads, st, (u64*)out,
                              (const u64*)own, total, (int)L, (int)log_n, log_cc,
                              (int)canonical, W, WS, M, NI, NIS);
        else
            launch_rows<false>((int)log_c, grid_for(total, threads), threads, st, (u64*)out,
                               (const u64*)own, total, (int)L, (int)log_n, log_cc, 0, W, WS,
                               M, NI, NIS);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
