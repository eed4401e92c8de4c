// Segment-masked flash self-attention, forward (kernel L1).
//
//   s[i, j] = (q_i . k_j) * scale  + (seg_i == seg_j ? 0 : -0.7 * FLT_MAX)    f32 products of bf16 values
//   p[i, j] = exp(s[i, j] - m_i)             m_i the running row max, p rounded to bf16 before P.V
//   o[i]    = sum_j bf16(p[i, j]) v_j / sum_j p[i, j]
//
// over the keys j of [0, Tp), Tp = ceil(T / 128) * 128; seg = 1 for a
// position below the row's length, 0 from it on; keys in [T, Tp) are zero
// (logit 0, value 0) and belong to segment 0.
//
// Replaces: ssak_tpu/models/layers.py `flash_self_attention`, which calls
// JAX's library Pallas kernel (jax/experimental/pallas/ops/tpu/
// flash_attention.py, `_flash_attention_impl`, kernel body
// `_flash_attention_kernel_single_batch`). That kernel pads T to a multiple
// of 128 with zero q/k/v, marks valid frames with segment id 1 and pad
// frames with 0, adds the mask value to the scaled logits, keeps a running
// max and sum, and rounds the unnormalised p to bf16 for the P.V product;
// this kernel computes the same function. A pad query (i >= length) thus
// attends over every pad key of [length, Tp), zero keys included; a row of
// length <= 0 is all pad and stays finite. Without lengths and with
// T % 128 == 0 there is no mask (`masked` = 0).
//
// What bounds it on the H100: operations. 4*T*T*Dh flops per (batch, head)
// on 4*T*Dh*2 bytes: at T = 7001, Dh = 64 about 3,500 flops per byte, far
// above the card's ~295. The least time is 4*B*H*T^2*Dh over the bf16
// tensor-core peak (B=6, H=16: 1.22 ms).
//
// Design (simple first; no wgmma, TMA or warp specialisation): one block of
// 4 warps per (64-query tile, head, batch), each warp owning 16 query rows.
// q/k/v are read in place through their (B, T, H, Dh) strides, so no
// transposed or padded copy is made; rows past T are zero-filled by
// cp.async. The block stages its Q tile once and walks the keys in tiles of
// BN (64, or 32 at Dh = 256) through two shared-memory stages, loading tile
// n+1 with cp.async while it computes tile n. Both products are
// mma.sync.m16n8k16 bf16 with f32 accumulation (exact products of bf16
// values summed in f32, as the TPU kernel's preferred_element_type=f32);
// fragments come from shared memory by ldmatrix (the V operand transposed),
// rows padded by 16 bytes so the eight rows of an 8x8 matrix fall in
// distinct banks. The S accumulator turns into P's A fragments in
// registers; the online softmax keeps (m, l) per row in registers and
// rescales the O accumulator by exp(m_old - m_new) per tile; O / l is
// written once, in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;            // queries per block
constexpr int WARPS = 4;          // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

template <int D>
struct Tile {
    static constexpr int BN = D <= 128 ? 64 : 32;             // keys per step
    static constexpr int LD = D + 8;                          // shared row stride in elements
    static constexpr int SMEM = (BM + 4 * BN) * LD * 2;       // Q + two stages of K and V
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
}

// R rows of D elements, starting at time t0, from a (b, h) slice whose rows
// are `st` elements apart; rows at or past T are zero-filled.
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long st, int t0, int T) {
    constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
    constexpr int LD = Tile<D>::LD;
    for (int c = threadIdx.x; c < R * CHUNKS; c += THREADS) {
        const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
        const int t = t0 + r;
        const bool ok = t < T;
        cp_async16(dst + r * LD + col, src + (ok ? (long long)t * st : 0) + col, ok);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, bf16* __restrict__ out, int T, int Tp, int H,
    long long qsb, long long qst, long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, float scale) {
    constexpr int BN = Tile<D>::BN, LD = Tile<D>::LD;
    constexpr int NT = BN / 8;   // key n-tiles of S per step
    constexpr int DT = D / 8;    // d n-tiles of O
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sK = sQ + BM * LD;
    bf16* sV = sK + 2 * BN * LD;

    const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tq = lane & 3;
    const bool masked = lengths != nullptr;
    const int len = masked ? lengths[b] : Tp;
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* kb = k + b * ksb + h * ksh;
    const bf16* vb = v + b * vsb + h * vsh;

    load_rows<D, BM>(sQ, qb, qst, q0, T);
    load_rows<D, BN>(sK, kb, kst, 0, T);
    load_rows<D, BN>(sV, vb, vst, 0, T);
    cp_async_commit();

    const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
    const bool seg0 = row0 < len, seg1 = row1 < len;
    float o[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    const int steps = Tp / BN;
    for (int it = 0; it < steps; ++it) {
        const int stage = it & 1;
        if (it + 1 < steps) {
            load_rows<D, BN>(sK + (stage ^ 1) * BN * LD, kb, kst, (it + 1) * BN, T);
            load_rows<D, BN>(sV + (stage ^ 1) * BN * LD, vb, vst, (it + 1) * BN, T);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* cK = sK + stage * BN * LD;
        const bf16* cV = sV + stage * BN * LD;

        // S = Q K^T for this warp's 16 rows and BN keys
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            unsigned a[4];
            ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                unsigned bb[4];
                ldmatrix_x4(bb, cK + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
                mma16816(s[j], a[0], a[1], a[2], a[3], bb[0], bb[1]);
                mma16816(s[j + 1], a[0], a[1], a[2], a[3], bb[2], bb[3]);
            }
        }

        // scale, mask, and the tile's row maxima (rows row0, row1)
        const int key0 = it * BN + 2 * tq;
        float bm0 = -INFINITY, bm1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * scale;
                if (masked) {
                    const bool segk = key0 + j * 8 + (e & 1) < len;
                    x += ((e < 2 ? seg0 : seg1) == segk) ? 0.f : MASK_VALUE;
                }
                s[j][e] = x;
            }
            bm0 = fmaxf(bm0, fmaxf(s[j][0], s[j][1]));
            bm1 = fmaxf(bm1, fmaxf(s[j][2], s[j][3]));
        }
        bm0 = fmaxf(bm0, __shfl_xor_sync(0xffffffffu, bm0, 1));
        bm0 = fmaxf(bm0, __shfl_xor_sync(0xffffffffu, bm0, 2));
        bm1 = fmaxf(bm1, __shfl_xor_sync(0xffffffffu, bm1, 1));
        bm1 = fmaxf(bm1, __shfl_xor_sync(0xffffffffu, bm1, 2));
        const float mn0 = fmaxf(m0, bm0), mn1 = fmaxf(m1, bm1);
        const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;

        // p = exp(s - m): f32 into the row sums, bf16 into P's A fragments
        unsigned p[NT][2];
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float p0 = __expf(s[j][0] - mn0), p1 = __expf(s[j][1] - mn0);
            const float p2 = __expf(s[j][2] - mn1), p3 = __expf(s[j][3] - mn1);
            ls0 += p0 + p1;
            ls1 += p2 + p3;
            p[j][0] = pack_bf16(p0, p1);
            p[j][1] = pack_bf16(p2, p3);
        }
        l0 = l0 * al0 + ls0;
        l1 = l1 * al1 + ls1;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
            o[j][0] *= al0;
            o[j][1] *= al0;
            o[j][2] *= al1;
            o[j][3] *= al1;
        }

        // O += P V
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int j = 0; j < DT; j += 2) {
                unsigned bb[4];
                ldmatrix_x4_trans(bb, cV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + j * 8 + (lane >> 4) * 8);
                mma16816(o[j], p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1], bb[0], bb[1]);
                mma16816(o[j + 1], p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1], bb[2], bb[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is loaded again
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    // out: contiguous (B, T, H, D)
#pragma unroll
    for (int j = 0; j < DT; ++j) {
        const int col = j * 8 + 2 * tq;
        if (row0 < T)
            *reinterpret_cast<unsigned*>(out + (((long long)b * T + row0) * H + h) * D + col) =
                pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
        if (row1 < T)
            *reinterpret_cast<unsigned*>(out + (((long long)b * T + row1) * H + h) * D + col) =
                pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out, int B, int T, int H,
           const long long* qs, const long long* ks, const long long* vs, float scale, void* stream) {
    constexpr int smem = Tile<D>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int Tp = (T + 127) / 128 * 128;
    dim3 grid((T + BM - 1) / BM, H, B);
    flash_fwd_kernel<D><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const int*>(lengths), static_cast<bf16*>(out), T, Tp, H, qs[0], qs[1], qs[2], ks[0], ks[1],
        ks[2], vs[0], vs[1], vs[2], scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (B, T, H, D) with element strides (batch, time, head) and a
// contiguous last dimension, 16-byte aligned rows; lengths: int32 (B,) or
// null (no mask); out: contiguous bf16 (B, T, H, D). Returns a cudaError_t.
extern "C" int ssak_flash_attention_fwd(const void* q, const void* k, const void* v, const void* lengths, void* out,
                                        int B, int T, int H, int D, long long qsb, long long qst, long long qsh,
                                        long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                                        long long vsh, float scale, void* stream) {
    const long long qs[3] = {qsb, qst, qsh}, ks[3] = {ksb, kst, ksh}, vs[3] = {vsb, vst, vsh};
    switch (D) {
        case 64: return launch<64>(q, k, v, lengths, out, B, T, H, qs, ks, vs, scale, stream);
        case 128: return launch<128>(q, k, v, lengths, out, B, T, H, qs, ks, vs, scale, stream);
        case 256: return launch<256>(q, k, v, lengths, out, B, T, H, qs, ks, vs, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
