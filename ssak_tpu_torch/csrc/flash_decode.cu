// Fused single-query decode attention over an index range (flash-decode).
//
//   l[t] = (q . k[:, t]) [* ks[t]]            f32 accumulation; masked to -1e30 outside [lo, hi]
//   p[t] = exp(l[t] - max_t l)
//   o[d] = sum_t bf16(p[t] [* vs[t]]) * v[d, t] / sum_t p[t]
//
// Replaces: ssak_tpu/ops/flash_decode.py, `flash_decode_attention` (Pallas
// kernels `_make_kernel_plain` and `_make_kernel_int8`). One kernel,
// templated on the K/V element type: bf16, or int8 with per-position bf16
// scales ks/vs (the ssak int8 KV-cache format).
//
// What bounds it on the H100: bytes. Each (batch, head) site reads its K and
// V once, 2*Dh*T elements, and does 4*Dh*T flops on them: about one flop per
// byte (bf16) or two (int8), far under the card's ~295 flops per byte. The
// least time is the bytes of the keys in range over 3.35 TB/s (cross
// attention, T=1500, bf16, B=24, H=20: 184 MB, about 55 us).
//
// Design: one 256-thread block per (batch, head), B*H blocks (480 to 800 on
// the Whisper path, several per SM). Only keys in [lo, hi] are read: a
// masked key's weight exp(-1e30 - max) is exactly 0, so skipping it changes
// no sum, and a decode step's self-attention range [0, pos] is a small part
// of the preallocated cache. (An empty range masks every key and weights
// them uniformly, as the TPU kernel does: the block then reads all T.)
// Pass 1: each thread owns positions t = t0+tid, t0+tid+256, ... and reads
// k[d, t] for every d — neighbouring threads read neighbouring t, so every
// load is coalesced along the time-minor cache layout — then writes its
// logits to shared memory. A block reduction gives
// the max; p = exp(l - max) is written back in place and summed. Pass 2:
// each warp owns a set of d rows and sweeps t with its 32 lanes (coalesced
// again), reducing with shuffles. Keeping all T logits in shared memory
// (4*T bytes, T <= 12288) lets p use the global max, exactly as the TPU
// kernel does, so bf16(p) is the same rounding as there; the only
// differences are the order of the f32 sums. q stays unquantized, unlike
// the unfused ssak int8 attention, which quantizes q and p.
// Simple first: no split over T, no tensor cores, no asynchronous copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float load_f32(const int8_t* p, size_t i) { return (float)p[i]; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Block-wide reduction through `red` (WARPS floats); every thread gets the result.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* red) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    v = IS_MAX ? warp_max(v) : warp_sum(v);
    __syncthreads();  // `red` may still be read from the previous reduction
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < WARPS; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
    return r;
}

template <typename KV, bool QUANT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                    const __nv_bfloat16* __restrict__ ks, const __nv_bfloat16* __restrict__ vs,
                    const int* __restrict__ lo_p, const int* __restrict__ hi_p, float* __restrict__ out,
                    int H, int Dh, int T) {
    extern __shared__ float smem[];
    float* qs = smem;          // Dh
    float* p = smem + Dh;      // T logits, then probabilities (bf16-rounded, V-scaled)
    __shared__ float red[WARPS];

    const int bh = blockIdx.x;  // b * H + h
    const int b = bh / H;
    const int lo = lo_p[b], hi = hi_p[b];
    const size_t base = (size_t)bh * Dh * T;  // (B, H, Dh, T) contiguous
    const KV* kb = k + base;
    const KV* vb = v + base;

    for (int d = threadIdx.x; d < Dh; d += THREADS) qs[d] = __bfloat162float(q[(size_t)bh * Dh + d]);
    __syncthreads();

    int t0 = max(lo, 0), t1 = min(hi, T - 1);
    if (t0 > t1) {  // empty range: every key masked, uniform weights
        t0 = 0;
        t1 = T - 1;
    }
    const int n = t1 - t0 + 1;

    // pass 1: logits and their max; p[i] holds position t0 + i
    float m = NEG;
    for (int i = threadIdx.x; i < n; i += THREADS) {
        const int t = t0 + i;
        float l = 0.f;
        for (int d = 0; d < Dh; ++d) l = fmaf(qs[d], load_f32(kb, (size_t)d * T + t), l);
        if (QUANT) l *= __bfloat162float(ks[(size_t)bh * T + t]);
        l = (t >= lo && t <= hi) ? l : NEG;
        p[i] = l;
        m = fmaxf(m, l);
    }
    m = block_reduce<true>(m, red);

    // probabilities, their sum, and the bf16 operand of the PV product
    float s = 0.f;
    for (int i = threadIdx.x; i < n; i += THREADS) {
        const float e = expf(p[i] - m);
        s += e;
        const float pv = QUANT ? e * __bfloat162float(vs[(size_t)bh * T + t0 + i]) : e;
        p[i] = __bfloat162float(__float2bfloat16(pv));
    }
    s = block_reduce<false>(s, red);  // its leading barrier also publishes p[]

    // pass 2: o[d] = sum_t p[t] * v[d, t], one warp per d row at a time
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int d = warp; d < Dh; d += WARPS) {
        const KV* vr = vb + (size_t)d * T + t0;
        float acc = 0.f;
        for (int i = lane; i < n; i += 32) acc = fmaf(p[i], load_f32(vr, i), acc);
        acc = warp_sum(acc);
        if (lane == 0) out[(size_t)bh * Dh + d] = acc / s;
    }
}

template <typename KV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* lo,
           const void* hi, void* out, int B, int H, int Dh, int T, void* stream) {
    const size_t smem = sizeof(float) * (size_t)(Dh + T);
    auto kern = flash_decode_kernel<KV, QUANT>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<B * H, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const KV*)k, (const KV*)v, (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
        (const int*)lo, (const int*)hi, (float*)out, H, Dh, T);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssak_flash_decode_bf16(const void* q, const void* k, const void* v, const void* lo, const void* hi,
                                      void* out, int B, int H, int Dh, int T, void* stream) {
    return launch<__nv_bfloat16, false>(q, k, v, nullptr, nullptr, lo, hi, out, B, H, Dh, T, stream);
}

extern "C" int ssak_flash_decode_int8(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
                                      const void* lo, const void* hi, void* out, int B, int H, int Dh, int T,
                                      void* stream) {
    return launch<int8_t, true>(q, k8, v8, ks, vs, lo, hi, out, B, H, Dh, T, stream);
}
