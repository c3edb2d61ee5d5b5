#!/usr/bin/env python3
"""The int8 wgmma shapes on one H100: operand layouts and throughput.

    python3 port_tools/wgmma_probe.py

Writes two CUDA programs into build/wgmma_probe/ (the wgmma wrappers
generated below), builds them with nvcc for sm_90a and runs them:

- layout: one m64nNk32 s8 product (N = 16, 32, 64; A from registers, and
  at N = 32 from shared memory too), K = 64 in two k32 steps, B (and A) in
  shared memory in the K-major core-matrix layout without swizzle that
  csrc/ntt_mxu.cu uses (8 rows x 16 bytes a core matrix; LBO the step
  between the two k16 halves of a k32 step, SBO the step between 8-row
  groups), the register fragments and accumulators in the mma.m16n8k32
  order a warp; each result against the product on the host, with LBO and
  SBO as written and swapped (the swapped one must fail);
- throughput: 132 CTAs, each two warpgroups issuing P products into G
  accumulators round robin between waits, A from registers (RS) or shared
  memory (SS), at N = 16-128 (share of 989.5e12 int8 MACs/s); and at 384
  threads with setmaxnreg (the kernel's shape), SS with its descriptors
  precomputed or formed inside each product's asm as csrc/ntt_mxu.cu does.

Prints the card's name and power limit, then one JSON line a measurement.
Exits non-zero without a card or nvcc.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rs(n):
    r = n // 2
    outs = ", ".join(f"%{i}" for i in range(r))
    a = ", ".join(f"%{r + i}" for i in range(4))
    cons = ", ".join(f'"+r"(d[{i}])' for i in range(r))
    return (f"__device__ __forceinline__ void wgmma_rs_n{n}(int (&d)[{r}], const unsigned (&a)[4], "
            f"unsigned long long desc, int scale) {{\n"
            f"    asm volatile(\"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n\"\n"
            f"                 \"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{{outs}}}, "
            f"{{{a}}}, %{r + 4}, p;\\n}}\\n\"\n"
            f"                 : {cons}\n"
            f"                 : \"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), "
            f"\"l\"(desc), \"r\"(scale));\n}}\n")


def _ss(n):
    r = n // 2
    outs = ", ".join(f"%{i}" for i in range(r))
    cons = ", ".join(f'"+r"(d[{i}])' for i in range(r))
    return (f"__device__ __forceinline__ void wgmma_ss_n{n}(int (&d)[{r}], unsigned long long da, "
            f"unsigned long long db, int scale) {{\n"
            f"    asm volatile(\"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n\"\n"
            f"                 \"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{{outs}}}, "
            f"%{r}, %{r + 1}, p;\\n}}\\n\"\n"
            f"                 : {cons}\n"
            f"                 : \"l\"(da), \"l\"(db), \"r\"(scale));\n}}\n")


def _ssa(n):
    r = n // 2
    outs = ", ".join(f"%{i}" for i in range(r))
    cons = ", ".join(f'"+r"(d[{i}])' for i in range(r))
    return (f"__device__ __forceinline__ void wgmma_ssa_n{n}(int (&d)[{r}], unsigned alo, "
            f"unsigned aoff, unsigned ahi, unsigned blo, unsigned boff, unsigned bhi, int scale) {{\n"
            f"    asm volatile(\"{{\\n.reg .pred p;\\n.reg .b32 alo, blo;\\n.reg .b64 da, db;\\n\"\n"
            f"                 \"add.u32 alo, %{r}, %{r + 1};\\nmov.b64 da, {{alo, %{r + 2}}};\\n\"\n"
            f"                 \"add.u32 blo, %{r + 3}, %{r + 4};\\nmov.b64 db, {{blo, %{r + 5}}};\\n\"\n"
            f"                 \"setp.ne.b32 p, %{r + 6}, 0;\\n\"\n"
            f"                 \"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{{outs}}}, da, db, p;\\n}}\\n\"\n"
            f"                 : {cons}\n"
            f"                 : \"r\"(alo), \"r\"(aoff), \"r\"(ahi), \"r\"(blo), \"r\"(boff), "
            f"\"r\"(bhi), \"r\"(scale));\n}}\n")


PROBE = r'''#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <vector>
#include <cuda_runtime.h>
#include "wgmma_gen.h"

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ unsigned long long desc_of(const void* p, unsigned lbo, unsigned sbo) {
    unsigned long long d = 0;
    d |= (unsigned long long)((smem_u32(p) & 0x3FFFF) >> 4);
    d |= (unsigned long long)((lbo >> 4) & 0x3FFF) << 16;
    d |= (unsigned long long)((sbo >> 4) & 0x3FFF) << 32;
    return d;
}
#define FENCE() asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory")
#define COMMIT() asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory")
#define WAIT0() asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory")

template <int N> __device__ void mma_rs(int (&d)[N / 2], const unsigned (&a)[4], unsigned long long desc, int s);
template <> __device__ void mma_rs<16>(int (&d)[8], const unsigned (&a)[4], unsigned long long desc, int s) { wgmma_rs_n16(d, a, desc, s); }
template <> __device__ void mma_rs<32>(int (&d)[16], const unsigned (&a)[4], unsigned long long desc, int s) { wgmma_rs_n32(d, a, desc, s); }
template <> __device__ void mma_rs<64>(int (&d)[32], const unsigned (&a)[4], unsigned long long desc, int s) { wgmma_rs_n64(d, a, desc, s); }
template <> __device__ void mma_rs<128>(int (&d)[64], const unsigned (&a)[4], unsigned long long desc, int s) { wgmma_rs_n128(d, a, desc, s); }
template <int N> __device__ void mma_ss(int (&d)[N / 2], unsigned long long da, unsigned long long db, int s);
template <> __device__ void mma_ss<16>(int (&d)[8], unsigned long long da, unsigned long long db, int s) { wgmma_ss_n16(d, da, db, s); }
template <> __device__ void mma_ss<32>(int (&d)[16], unsigned long long da, unsigned long long db, int s) { wgmma_ss_n32(d, da, db, s); }
template <> __device__ void mma_ss<64>(int (&d)[32], unsigned long long da, unsigned long long db, int s) { wgmma_ss_n64(d, da, db, s); }
template <> __device__ void mma_ss<128>(int (&d)[64], unsigned long long da, unsigned long long db, int s) { wgmma_ss_n128(d, da, db, s); }

// B [N][K] (K-major) into core matrices: (kb * (N/8) + nb) * 128 + (n%8)*16 + k%16
template <int N>
__global__ void layout_kernel(int* out, const signed char* A, const signed char* B, int K, int swap, int ss) {
    extern __shared__ __align__(128) unsigned char sm[];
    unsigned char* sa = sm + N * K;
    const int tid = threadIdx.x;
    for (int i = tid; i < N * K; i += 128) {
        const int n = i / K, k = i % K;
        sm[((k / 16) * (N / 8) + n / 8) * 128 + (n % 8) * 16 + k % 16] = B[i];
    }
    for (int i = tid; i < 64 * K; i += 128) {
        const int m = i / K, k = i % K;
        sa[((k / 16) * 8 + m / 8) * 128 + (m % 8) * 16 + k % 16] = A[i];
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int w = tid / 32, lane = tid % 32, gq = lane >> 2, tq = lane & 3;
    int d[N / 2];
    for (int i = 0; i < N / 2; ++i) d[i] = 0;
    unsigned lbo = (N / 8) * 128, sbo = 128, lboa = 8 * 128, sboa = 128;
    if (swap) { unsigned t = lbo; lbo = sbo; sbo = t; t = lboa; lboa = sboa; sboa = t; }
    for (int ks = 0; ks < K / 32; ++ks) {
        const signed char* r0 = A + (16 * w + gq) * K + 32 * ks + 4 * tq;
        const signed char* r1 = r0 + 8 * K;
        unsigned a[4] = {*(const unsigned*)r0, *(const unsigned*)r1, *(const unsigned*)(r0 + 16),
                         *(const unsigned*)(r1 + 16)};
        FENCE();
        if (ss) mma_ss<N>(d, desc_of(sa + 2 * ks * 8 * 128, lboa, sboa), desc_of(sm + 2 * ks * (N / 8) * 128, lbo, sbo), 1);
        else mma_rs<N>(d, a, desc_of(sm + 2 * ks * (N / 8) * 128, lbo, sbo), 1);
        COMMIT();
        WAIT0();
    }
    for (int i = 0; i < N / 8; ++i) {
        const int r = 16 * w + gq, c = 8 * i + 2 * tq;
        out[r * N + c] = d[4 * i];
        out[r * N + c + 1] = d[4 * i + 1];
        out[(r + 8) * N + c] = d[4 * i + 2];
        out[(r + 8) * N + c + 1] = d[4 * i + 3];
    }
}

// throughput: 2 warpgroups a CTA, each issues P wgmmas (round robin over G
// accumulators) per group, then waits; B from 4 tiles of N x 32
template <int N, int G, bool SS>
__global__ void __launch_bounds__(256, 1) tput_kernel(int* sink, int iters, int P) {
    extern __shared__ __align__(128) unsigned char sm[];
    const int tid = threadIdx.x;
    for (int i = tid; i < 4 * N * 32 + 64 * 32 * 4; i += 256) sm[i] = (unsigned char)(i * 7);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    int d[G][N / 2];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) d[g][i] = 0;
    unsigned a[4] = {0x01020304u ^ tid, 0x05060708u, 0x090a0b0cu, 0x0d0e0f10u};
    unsigned long long db[4], da[4];
    for (int t = 0; t < 4; ++t) {
        db[t] = desc_of(sm + t * N * 32, (N / 8) * 128, 128);
        da[t] = desc_of(sm + 4 * N * 32 + t * 64 * 32, 8 * 128, 128);
    }
    for (int it = 0; it < iters; ++it) {
        FENCE();
        for (int p = 0; p < P; p += G) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
                if (SS) mma_ss<N>(d[g], da[(p + g) & 3], db[(p + g) & 3], 1);
                else mma_rs<N>(d[g], a, db[(p + g) & 3], 1);
            }
        }
        COMMIT();
        WAIT0();
    }
    int s = 0;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) s += d[g][i];
    if (s == 0x12345) sink[0] = s;
}

template <int N>
int check_layout(int ss) {
    const int K = 64;
    std::vector<signed char> A(64 * K), B(N * K);
    for (auto& v : A) v = (signed char)(rand() % 256 - 128);
    for (auto& v : B) v = (signed char)(rand() % 256 - 128);
    std::vector<int> ref(64 * N, 0);
    for (int m = 0; m < 64; ++m)
        for (int n = 0; n < N; ++n) {
            int s = 0;
            for (int k = 0; k < K; ++k) s += A[m * K + k] * B[n * K + k];
            ref[m * N + n] = s;
        }
    signed char *dA, *dB;
    int* dO;
    cudaMalloc(&dA, A.size());
    cudaMalloc(&dB, B.size());
    cudaMalloc(&dO, ref.size() * 4);
    cudaMemcpy(dA, A.data(), A.size(), cudaMemcpyHostToDevice);
    cudaMemcpy(dB, B.data(), B.size(), cudaMemcpyHostToDevice);
    for (int swap = 0; swap < 2; ++swap) {
        cudaMemset(dO, 0, ref.size() * 4);
        cudaFuncSetAttribute(layout_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
        layout_kernel<N><<<1, 128, 65536>>>(dO, dA, dB, K, swap, ss);
        cudaError_t e = cudaDeviceSynchronize();
        std::vector<int> got(ref.size());
        cudaMemcpy(got.data(), dO, got.size() * 4, cudaMemcpyDeviceToHost);
        int bad = 0;
        for (size_t i = 0; i < got.size(); ++i) bad += got[i] != ref[i];
        printf("{\"probe\": \"layout\", \"n\": %d, \"ss\": %d, \"swap_lbo_sbo\": %d, \"err\": \"%s\", \"mismatches\": %d, \"of\": %zu}\n",
               N, ss, swap, cudaGetErrorString(e), bad, got.size());
    }
    cudaFree(dA); cudaFree(dB); cudaFree(dO);
    return 0;
}

template <int N, int G, bool SS>
void tput(int P) {
    int* sink;
    cudaMalloc(&sink, 4);
    const int smem = 4 * N * 32 + 64 * 32 * 4;
    cudaFuncSetAttribute(tput_kernel<N, G, SS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const int iters = 2000;
    tput_kernel<N, G, SS><<<132, 256, smem>>>(sink, 10, P);
    cudaDeviceSynchronize();
    cudaEvent_t a, b;
    cudaEventCreate(&a); cudaEventCreate(&b);
    cudaEventRecord(a);
    tput_kernel<N, G, SS><<<132, 256, smem>>>(sink, iters, P);
    cudaEventRecord(b);
    cudaError_t e = cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b);
    const double macs = 132.0 * 2 * iters * P * 64.0 * N * 32;
    printf("{\"probe\": \"throughput\", \"n\": %d, \"g\": %d, \"ss\": %d, \"pairs_per_wait\": %d, \"ms\": %.4f, \"tmacs_per_s\": %.2f, \"share_of_989.5\": %.3f, \"err\": \"%s\"}\n",
           N, G, (int)SS, P, ms, macs / ms / 1e9, macs / ms / 1e9 / 989.5, cudaGetErrorString(e));
    cudaFree(sink);
}

int main() {
    check_layout<16>(0); check_layout<32>(0); check_layout<64>(0); check_layout<32>(1);
    tput<16, 5, false>(30); tput<32, 5, false>(30); tput<64, 3, false>(30); tput<128, 1, false>(30);
    tput<32, 5, false>(10); tput<32, 5, false>(5);
    tput<64, 1, true>(30); tput<128, 1, true>(30); tput<32, 1, true>(30);
    return 0;
}
'''

PROBE_384 = r'''#include <cstdio>
#include <cuda_runtime.h>
#include "wgmma_gen.h"
#include "wgmma_gen2.h"
__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ unsigned long long desc_of(const void* p, unsigned lbo, unsigned sbo) {
    unsigned long long d = 0;
    d |= (unsigned long long)((smem_u32(p) & 0x3FFFF) >> 4);
    d |= (unsigned long long)((lbo >> 4) & 0x3FFF) << 16;
    d |= (unsigned long long)((sbo >> 4) & 0x3FFF) << 32;
    return d;
}
template <int N> __device__ void mma_ss(int (&d)[N / 2], unsigned long long da, unsigned long long db, int s);
template <> __device__ void mma_ss<32>(int (&d)[16], unsigned long long da, unsigned long long db, int s) { wgmma_ss_n32(d, da, db, s); }
template <> __device__ void mma_ss<64>(int (&d)[32], unsigned long long da, unsigned long long db, int s) { wgmma_ss_n64(d, da, db, s); }
template <int N> __device__ void mma_ssa(int (&d)[N / 2], unsigned a, unsigned ao, unsigned ah, unsigned b, unsigned bo, unsigned bh, int s);
template <> __device__ void mma_ssa<32>(int (&d)[16], unsigned a, unsigned ao, unsigned ah, unsigned b, unsigned bo, unsigned bh, int s) { wgmma_ssa_n32(d, a, ao, ah, b, bo, bh, s); }
template <> __device__ void mma_ssa<64>(int (&d)[32], unsigned a, unsigned ao, unsigned ah, unsigned b, unsigned bo, unsigned bh, int s) { wgmma_ssa_n64(d, a, ao, ah, b, bo, bh, s); }

// 2 consumer WGs + 1 idle WG (384 threads as the kernel), P wgmmas a wait
template <int N, int G, bool ASM>
__global__ void __launch_bounds__(384, 1) tput(int* sink, int iters, int P) {
    extern __shared__ __align__(1024) unsigned char sm[];
    for (int i = threadIdx.x; i < 8 * N * 32 + 8 * 64 * 32; i += 384) sm[i] = (unsigned char)(i * 7);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int role = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
    if (role == 2) { asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n"); return; }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    int d[G][N / 2];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) d[g][i] = 0;
    const unsigned long long dbb = desc_of(sm, (N / 8) * 128, 128), dab = desc_of(sm + 8 * N * 32, 8 * 128, 128);
    const unsigned blo = (unsigned)dbb, bhi = (unsigned)(dbb >> 32), alo = (unsigned)dab, ahi = (unsigned)(dab >> 32);
    for (int it = 0; it < iters; ++it) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll 1
        for (int p = 0; p < P; p += G * 4) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int t = (k * G + g) & 7;
                if (ASM) mma_ssa<N>(d[g], alo, (k * 2048) >> 4, ahi, blo, (t * N * 32) >> 4, bhi, 1);
                else mma_ss<N>(d[g], dab + ((k * 2048) >> 4), dbb + ((t * N * 32) >> 4), 1);
            }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
    int s = 0;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) s += d[g][i];
    if (s == 0x12345) sink[0] = s;
}
template <int N, int G, bool ASM>
void run(int P) {
    int* sink; cudaMalloc(&sink, 4);
    const int smem = 8 * N * 32 + 8 * 64 * 32;
    cudaFuncSetAttribute(tput<N, G, ASM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    tput<N, G, ASM><<<132, 384, smem>>>(sink, 5, P);
    cudaDeviceSynchronize();
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    const int iters = 1000;
    cudaEventRecord(a);
    tput<N, G, ASM><<<132, 384, smem>>>(sink, iters, P);
    cudaEventRecord(b);
    cudaError_t e = cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b);
    const int per = ((P + G * 4 - 1) / (G * 4)) * G * 4;
    const double macs = 132.0 * 2 * iters * per * 64.0 * N * 32;
    printf("{\"n\": %d, \"g\": %d, \"asm\": %d, \"per_wait\": %d, \"share\": %.3f, \"err\": \"%s\"}\n", N, G, (int)ASM, per, macs / ms / 1e9 / 989.5, cudaGetErrorString(e));
}
int main() {
    run<32, 5, false>(60); run<32, 5, true>(60); run<32, 5, true>(120);
    run<64, 3, false>(60); run<64, 3, true>(60); run<64, 3, true>(120);
    run<64, 2, true>(64); run<32, 1, true>(32); run<64, 1, true>(32);
    return 0;
}
'''


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("wgmma_probe: no CUDA device is available", file=sys.stderr)
        return 1
    from gemini_seal_tpu_torch.ops import cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out = os.path.join(REPO, "build", "wgmma_probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "wgmma_gen.h"), "w") as fh:
        fh.write("".join(_rs(n) + _ss(n) for n in (16, 32, 64, 128)))
    with open(os.path.join(out, "wgmma_gen2.h"), "w") as fh:
        fh.write(_ssa(32) + _ssa(64))
    flags = [f for f in cuda.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    ok = True
    for name, src in (("probe", PROBE), ("probe_384", PROBE_384)):
        path = os.path.join(out, name + ".cu")
        with open(path, "w") as fh:
            fh.write(src)
        exe = os.path.join(out, name)
        build = subprocess.run([cuda._nvcc(), *flags, "-I", out, "-o", exe, path],
                               capture_output=True, text=True, timeout=600)
        if build.returncode:
            print(build.stderr[-3000:], file=sys.stderr)
            return 1
        run = subprocess.run([exe], capture_output=True, text=True, timeout=600)
        for line in run.stdout.splitlines():
            print(json.dumps({"program": name, **json.loads(line)}), flush=True)
            row = json.loads(line)
            if row.get("probe") == "layout":
                ok &= (row["mismatches"] == 0) == (row["swap_lbo_sbo"] == 0)
        ok &= run.returncode == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
