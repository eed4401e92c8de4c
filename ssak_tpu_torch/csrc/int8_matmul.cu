// Fused int8-weight dequantize-matmul for decode-shaped activations.
//
//   y[m, n] = scale[n] * sum_k bf16(x[m, k]) * bf16(q8[k, n])   (f32 accumulation)
//
// Replaces: ssak_tpu/ops/int8_matmul.py, `matmul_int8` (Pallas kernel `_kernel`).
//
// What bounds it on the H100: bytes. M (batch rows of one decode step) is at
// most 64, so the product does 2*M flops per weight byte — far below the
// ~295 bf16 operations per byte where the tensor cores would become the limit.
// The least time is the K*N int8 weight bytes over 3.35 TB/s (1280 x 5120:
// 6.6 MB, about 2 us).
//
// Design: one 256-thread block per tile of 64 output columns, holding every
// row of x (M <= 64). The block walks K in chunks of 32: the x chunk (bf16,
// M x 32) and the weight chunk (int8, 32 x 64, read coalesced along N as
// 8-byte words) are widened to f32 in shared memory, then each thread
// accumulates a 4 x 4 (rows x columns) tile in registers. int8 and bf16
// values are exact in f32, and so is their product, so the only difference
// from the TPU kernel is the order of the f32 sums. The per-column scale is
// applied once to the accumulator, since it commutes with the sum over k.
// Simple first: no tensor cores, no TMA, no split-K; the grid is N/64 blocks.
//
// Shapes: 1 <= M <= 64, K % 8 == 0, N % 8 == 0 (the wrapper checks). The
// last column tile may be partial (N not a multiple of 64): loads and stores
// past N are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;       // output columns per block
constexpr int BM = 64;       // max rows (decode batch)
constexpr int KC = 32;       // K chunk staged in shared memory
constexpr int THREADS = 256; // 16 column groups x 16 row groups

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q8,
                   const float* __restrict__ scale, float* __restrict__ y, int M, int K, int N) {
    __shared__ __align__(16) float xs[BM][KC + 1];  // +1: rows land in different banks
    __shared__ __align__(16) float ws[KC][BN];

    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * BN;
    const int tc = tid % 16;  // columns n0 + 4*tc .. +3
    const int tr = tid / 16;  // rows 4*tr .. +3

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
        // x chunk: BM rows x KC bf16 = 256 loads of 8 bf16 (16 bytes)
        {
            const int r = tid / 4;
            const int c = (tid % 4) * 8;
            float v[8];
            if (r < M && k0 + c < K) {
                uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)r * K + k0 + c);
                const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) xs[r][c + e] = v[e];
        }
        // weight chunk: KC rows x BN int8 = 256 loads of 8 bytes
        {
            const int r = tid / 8;
            const int c = (tid % 8) * 8;
            float v[8];
            if (k0 + r < K && n0 + c < N) {
                uint2 raw = *reinterpret_cast<const uint2*>(q8 + (size_t)(k0 + r) * N + n0 + c);
                const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = (float)b[e];
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) ws[r][c + e] = v[e];
        }
        __syncthreads();
        if (4 * tr < M) {
#pragma unroll 8
            for (int kk = 0; kk < KC; ++kk) {
                const float4 w = *reinterpret_cast<const float4*>(&ws[kk][4 * tc]);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float a = xs[4 * tr + i][kk];
                    acc[i][0] = fmaf(a, w.x, acc[i][0]);
                    acc[i][1] = fmaf(a, w.y, acc[i][1]);
                    acc[i][2] = fmaf(a, w.z, acc[i][2]);
                    acc[i][3] = fmaf(a, w.w, acc[i][3]);
                }
            }
        }
        __syncthreads();
    }

    const int n = n0 + 4 * tc;
    if (n >= N) return;  // N % 8 == 0, so a 4-column group is all in or all out
    const float4 s = *reinterpret_cast<const float4*>(scale + n);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = 4 * tr + i;
        if (m < M) {
            float4 o = make_float4(acc[i][0] * s.x, acc[i][1] * s.y, acc[i][2] * s.z, acc[i][3] * s.w);
            *reinterpret_cast<float4*>(y + (size_t)m * N + n) = o;
        }
    }
}

}  // namespace

extern "C" int ssak_int8_matmul(const void* x, const void* q8, const void* scale, void* y,
                                int M, int K, int N, void* stream) {
    dim3 grid((N + BN - 1) / BN);
    int8_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const int8_t*)q8, (const float*)scale, (float*)y, M, K, N);
    return (int)cudaGetLastError();
}
