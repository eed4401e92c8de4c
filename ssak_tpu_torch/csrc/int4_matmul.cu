// Fused int4-weight unpack-dequantize-matmul for decode-shaped activations.
//
//   y[m, n] = sum_k bf16(x[m, k]) * bf16(q[k, n] * scale[k / 64, n])   (f32 accumulation)
//
// where q[2r, n] is the low and q[2r+1, n] the high signed nibble of the
// packed byte q4[r, n] (models/quant.py layout), and one f32 scale covers 64
// weight rows (32 packed rows) of a column.
//
// Replaces: ssak_tpu/ops/int8_matmul.py, `matmul_int4` (Pallas kernel
// `_kernel4`, line 117). As on the TPU (cdt = bf16) each weight is
// dequantized in f32 and rounded to bf16 before the product, and x is
// rounded to bf16; bf16 products are exact in f32, so the only difference
// from the TPU kernel is the order of the f32 sums. The TPU kernel's
// even/odd split of the activations is not needed here: a thread reads
// x[m, 2r] and x[m, 2r+1] from shared memory directly.
//
// What bounds it on the H100: bytes. M (rows of one decode step) is at most
// 64, so the product does 4*M operations per packed weight byte, far below
// the ~295 bf16 operations per byte where the tensor cores become the limit.
// The least time is the K/2*N packed bytes plus the K/64*N f32 scales over
// 3.35 TB/s (1280 x 5120: 4.1 MB, about 1.3 us).
//
// Design: a 2-D grid, column tiles of 128 outputs times `splits` ranges of
// K (split-K), so that even a 1280-column projection runs a few hundred
// blocks on the 132 SMs instead of ten. A block walks its K range in chunks
// of 16 packed rows (32 weight rows, half a scale block): the x chunk (bf16,
// M x 32) and the weight chunk (16 x 128 bytes, read coalesced along N as
// 8-byte words, unpacked and scaled to f32 values that are exact bf16) are
// staged in shared memory; each of the 256 threads owns 4 columns and MR =
// ceil(M/8) rows in registers (one warp per row group, so the x reads are
// broadcasts). Each split writes its partial sums to a scratch (splits, M, N)
// that the wrapper allocates; a second kernel adds them in split order, so
// the result does not depend on the schedule. Simple first: SIMT f32 FMAs,
// no tensor cores, no TMA.
//
// Shapes: 1 <= M <= 64, K/2 == 32 * (number of scale blocks), N % 8 == 0
// (the wrapper checks). The last column tile may be partial: loads and
// stores past N are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;       // output columns per block
constexpr int BM = 64;        // max rows (decode batch)
constexpr int KC2 = 16;       // packed rows per chunk
constexpr int KC = 2 * KC2;   // weight rows per chunk
constexpr int SUB = 32;       // packed rows per scale block
constexpr int THREADS = 256;  // 32 column groups x 8 row groups

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16(v));  // round to nearest even, as XLA's convert
}

template <int MR>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4,
                   const float* __restrict__ scale, float* __restrict__ part,
                   int M, int K, int N, int chunks_per_split) {
    __shared__ __align__(16) float xs[BM][KC + 1];  // +1: rows land in different banks
    __shared__ __align__(16) float ws[KC][BN];

    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * BN;
    const int split = blockIdx.y;
    const int n_chunks = (K / 2) / KC2;
    const int c_begin = split * chunks_per_split;
    const int c_end = min(n_chunks, c_begin + chunks_per_split);
    const int tc = tid % 32;  // columns n0 + 4*tc .. +3
    const int tr = tid / 32;  // rows tr*MR .. +MR-1

    float acc[MR][4];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c = c_begin; c < c_end; ++c) {
        const int p0 = c * KC2;  // first packed row of the chunk
        const int k0 = 2 * p0;   // first weight row
        // x chunk: BM rows x KC bf16 = 256 loads of 8 bf16 (16 bytes)
        {
            const int r = tid / 4;
            const int cc = (tid % 4) * 8;
            float v[8];
            if (r < M) {
                const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)r * K + k0 + cc);
                const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) xs[r][cc + e] = v[e];
        }
        // weight chunk: KC2 packed rows x BN bytes = 256 loads of 8 bytes,
        // each byte unpacked into weight rows 2*pr (low) and 2*pr+1 (high)
        {
            const int pr = tid / 16;
            const int cc = (tid % 16) * 8;
            const int n = n0 + cc;
            float lo[8], hi[8];
            if (n < N) {  // N % 8 == 0: a group of 8 columns is all in or all out
                const uint2 raw = *reinterpret_cast<const uint2*>(q4 + (size_t)(p0 + pr) * N + n);
                const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
                const float* srow = scale + (size_t)((p0 + pr) / SUB) * N + n;
                const float4 s0 = *reinterpret_cast<const float4*>(srow);
                const float4 s1 = *reinterpret_cast<const float4*>(srow + 4);
                const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int v = (int)b[e];
                    const int low = (int)((unsigned)v << 28) >> 28;  // sign-extended low nibble
                    const int high = v >> 4;                          // arithmetic shift
                    lo[e] = bf16_round((float)low * s[e]);
                    hi[e] = bf16_round((float)high * s[e]);
                }
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) lo[e] = hi[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                ws[2 * pr][cc + e] = lo[e];
                ws[2 * pr + 1][cc + e] = hi[e];
            }
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
            const float4 w = *reinterpret_cast<const float4*>(&ws[kk][4 * tc]);
#pragma unroll
            for (int i = 0; i < MR; ++i) {
                const float a = xs[tr * MR + i][kk];
                acc[i][0] = fmaf(a, w.x, acc[i][0]);
                acc[i][1] = fmaf(a, w.y, acc[i][1]);
                acc[i][2] = fmaf(a, w.z, acc[i][2]);
                acc[i][3] = fmaf(a, w.w, acc[i][3]);
            }
        }
        __syncthreads();
    }

    const int n = n0 + 4 * tc;
    if (n >= N) return;  // N % 8 == 0, so a 4-column group is all in or all out
    float* out = part + (size_t)split * M * N;
#pragma unroll
    for (int i = 0; i < MR; ++i) {
        const int m = tr * MR + i;
        if (m < M) {
            *reinterpret_cast<float4*>(out + (size_t)m * N + n) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
    }
}

// y[i] = sum over s of part[s, i], in split order (deterministic).
__global__ void splitk_sum_kernel(const float* __restrict__ part, float* __restrict__ y, int MN, int splits) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= MN) return;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * MN + i];
    y[i] = s;
}

template <int MR>
void launch(dim3 grid, cudaStream_t st, const void* x, const void* q4, const void* scale, float* dst,
            int M, int K, int N, int per) {
    int4_matmul_kernel<MR><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)q4, (const float*)scale, dst, M, K, N, per);
}

}  // namespace

// part: scratch of (splits, M, N) f32 when splits > 1 (may equal y when splits == 1).
// The wrapper owns the split-K plan: split s covers chunks [s*per, (s+1)*per).
extern "C" int ssak_int4_matmul(const void* x, const void* q4, const void* scale, void* y, void* part,
                                int M, int K, int N, int splits, int per, void* stream) {
    const int n_chunks = (K / 2) / KC2;
    if (M < 1 || M > BM || splits < 1 || per < 1 || (long long)splits * per < n_chunks)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid((N + BN - 1) / BN, splits);
    float* dst = splits > 1 ? (float*)part : (float*)y;
    switch ((M + 7) / 8) {
        case 1: launch<1>(grid, st, x, q4, scale, dst, M, K, N, per); break;
        case 2: launch<2>(grid, st, x, q4, scale, dst, M, K, N, per); break;
        case 3: launch<3>(grid, st, x, q4, scale, dst, M, K, N, per); break;
        case 4: launch<4>(grid, st, x, q4, scale, dst, M, K, N, per); break;
        case 5: launch<5>(grid, st, x, q4, scale, dst, M, K, N, per); break;
        case 6: launch<6>(grid, st, x, q4, scale, dst, M, K, N, per); break;
        case 7: launch<7>(grid, st, x, q4, scale, dst, M, K, N, per); break;
        default: launch<8>(grid, st, x, q4, scale, dst, M, K, N, per); break;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const int MN = M * N;
    splitk_sum_kernel<<<(MN + 255) / 256, 256, 0, st>>>((const float*)part, (float*)y, MN, splits);
    return (int)cudaGetLastError();
}
