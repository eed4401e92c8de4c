// Segment-masked flash self-attention, backward (kernel L1's dK/dV and dQ).
//
// From the forward's q, k, v (bf16 (B, T, H, D)), the gradient dO of its
// output, its row max m and row sum l (f32 (B, H, T), over [0, Tp), written
// by flash_attention.cu) and di = sum_d o * dO (f32 (B, H, T)):
//
//   s[i, j]  = (q_i . k_j) * scale + (seg_i == seg_j ? 0 : -0.7 * FLT_MAX)
//   p[i, j]  = exp(s[i, j] - m_i) * (1 / l_i)                        f32
//   dv_j     = sum_i bf16(p[i, j]) dO_i
//   dp[i, j] = dO_i . v_j                                             f32
//   ds[i, j] = ((dp[i, j] - di_i) * p[i, j]) * scale                  f32
//   dk_j     = sum_i bf16(ds[i, j]) q_i        dq_i = sum_j bf16(ds[i, j]) k_j
//
// with f32 sums and one bf16 rounding of dq, dk and dv at the end.
//
// Replaces: the VJP of JAX's library Pallas flash attention, which
// ssak_tpu/models/layers.py:290 `flash_self_attention` reaches under
// jax.grad (jax/experimental/pallas/ops/tpu/flash_attention.py, JAX 0.9.0):
// `_flash_attention_bwd_dkv` (:941; kernel `_flash_attention_dkv_kernel`
// :796, pallas_call :1121) and `_flash_attention_bwd_dq` (:1287; kernel
// `_flash_attention_dq_kernel` :1146, pallas_call :1456). Same arithmetic:
// p normalised against the final m with the reciprocal of l and rounded to
// bf16 for dV; ds scaled after the subtraction (:911-914) and rounded to
// bf16 for dK and dQ. The dQ call's `ds` output exists only with an
// attention bias, which ssak_tpu never passes: it is not computed.
//
// Pad queries and keys. The library pads T to Tp with zero q/k/v and slices
// the gradients back, so dO is zero on rows [T, Tp) and those queries add
// nothing to dK or dV; keys in [T, Tp) are zero and add nothing to dQ. Both
// kernels therefore walk [0, T) only. l comes from the forward, which
// counted the zero keys in every pad query's sum, as the library's l does.
// Queries in [len, T) are segment 0 and attend over [len, Tp); their
// gradients, and those of the pad keys, are computed like any other.
//
// What bounds it on the H100: operations. dK/dV does 8*B*H*T^2*D
// tensor-core flops (S, dP, dV, dK), dQ 6*B*H*T^2*D (S, dP, dQ); each also
// takes B*H*T^2 exponentials. At B=4, H=16, T=6,999, D=64 that is 1.62 ms
// and 1.22 ms at the 989 TFLOP/s bf16 peak. The 3.1e9 ex2 of each kernel
// take 0.75 ms on the SFUs (16 a clock per SM, 132 SMs, 1.98 GHz: 4.2e12/s),
// and the ~10 f32 operations per (i, j) (scale, mask, subtract, multiply,
// convert) ~0.9 ms at 67 TFLOP/s: both under the tensor-core time. The
// bytes (q, k, v, dO, m, l, di read once; dq, dk, dv written once, ~0.4 GB)
// take ~0.1 ms. So the tensor cores bound both kernels: every product runs
// on them, and no (T x T) tile leaves the registers.
//
// Design (simple first; no wgmma, TMA or warp specialisation), with the
// forward's conventions: q/k/v/dO read in place through their (B, T, H, D)
// strides, rows past T zero-filled by cp.async; mma.sync.m16n8k16 bf16 with
// f32 accumulation, fed by ldmatrix (transposed where the operand needs it)
// from shared rows padded by 16 bytes; two shared-memory stages of the
// walked operand, the next loaded by cp.async while the current is used.
// No atomics: each gradient element is summed by one thread in a fixed
// order, so the gradients are the same from run to run.
//  - dK/dV: one 4-warp block per (64-key tile, head, batch), each warp
//    owning 16 keys; at D = 256, two blocks per key tile, each with half of
//    the output columns (the f32 accumulators of all 256 would not fit in
//    registers; S and dP are computed in both). The block stages its K and V
//    once and walks the query tiles, with their m, 1/l and di staged in
//    shared memory beside the Q and dO rows. It computes the transposed
//    tiles S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out of the
//    accumulators already laid out as the A fragments of dV += P^T dO and
//    dK += dS^T Q (the forward's S -> P trick). dK and dV accumulate in f32
//    registers.
//  - dQ: one 4-warp block per (64-query tile, head, batch), each warp
//    owning 16 queries, their m, 1/l and di in registers. It walks the key
//    tiles, recomputes S and dP = dO V^T, and dS becomes the A fragments of
//    dQ += dS K, accumulated in f32 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BT = 64;            // rows of the block's own tile: keys (dK/dV) or queries (dQ)
constexpr int WARPS = 4;          // 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

template <int D>
struct Tile {
    static constexpr int LD = D + 8;                // shared row stride in elements
    static constexpr int BW = D == 64 ? 64 : 32;    // rows of the walked operand per step
    static constexpr int DO = D < 128 ? D : 128;    // dK/dV output columns per block
    static constexpr int SPLIT = D / DO;            // dK/dV blocks per key tile
    // dK/dV: K and V, two stages of Q and dO rows and of (m, 1/l, di)
    static constexpr int SMEM_DKV = (2 * BT + 4 * BW) * LD * 2 + 2 * 3 * BW * 4;
    // dQ: Q and dO, two stages of K and V rows
    static constexpr int SMEM_DQ = (2 * BT + 4 * BW) * LD * 2;
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
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// The A fragment (16x16, rows of this warp) at column block kk of a tile in
// shared memory whose rows are the M dimension.
template <int D>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* tile, int warp, int lane, int kk) {
    ldmatrix_x4(a, tile + (warp * 16 + (lane & 15)) * Tile<D>::LD + kk * 16 + (lane >> 4) * 8);
}

// B fragments of n-tiles j and j+1 at k block kk, from rows that are the N
// dimension (contiguous along K).
template <int D>
__device__ __forceinline__ void load_b(unsigned (&b)[4], const bf16* tile, int lane, int j, int kk) {
    ldmatrix_x4(b, tile + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * Tile<D>::LD + kk * 16 + ((lane >> 3) & 1) * 8);
}

// B fragments of n-tiles j and j+1 (columns from c0) at k block kk, from
// rows that are the K dimension (contiguous along N): transposed.
template <int D>
__device__ __forceinline__ void load_b_trans(unsigned (&b)[4], const bf16* tile, int lane, int j, int kk, int c0) {
    ldmatrix_x4_trans(b, tile + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * Tile<D>::LD + c0 + j * 8 + (lane >> 4) * 8);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ di, const int* __restrict__ lengths, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int T, int H, long long qsb, long long qst, long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, long long osb, long long ost, long long osh, float scale) {
    constexpr int BW = Tile<D>::BW, LD = Tile<D>::LD, DO = Tile<D>::DO;
    constexpr int NT = BW / 8;   // query n-tiles of S^T per step
    constexpr int DT = DO / 8;   // d n-tiles of this block's dK and dV columns
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sK = reinterpret_cast<bf16*>(smem);
    bf16* sV = sK + BT * LD;
    bf16* sQ = sV + BT * LD;       // two stages
    bf16* sO = sQ + 2 * BW * LD;   // dO, two stages
    float* sM = reinterpret_cast<float*>(sO + 2 * BW * LD);  // two stages each of m, 1/l, di
    float* sIL = sM + 2 * BW;
    float* sDi = sIL + 2 * BW;

    const int k0 = (blockIdx.x / Tile<D>::SPLIT) * BT;
    const int c0 = (blockIdx.x % Tile<D>::SPLIT) * DO;  // first output column
    const int h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tq = lane & 3;
    const bool masked = lengths != nullptr;
    const int len = masked ? lengths[b] : T;
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* kb = k + b * ksb + h * ksh;
    const bf16* vb = v + b * vsb + h * vsh;
    const bf16* ob = dout + b * osb + h * osh;
    const long long sr = ((long long)b * H + h) * T;  // the (b, h) row of m, l, di

    // Q and dO rows of the query tile from t0, with their m, 1/l and di
    // (0 past T, where Q and dO are zero: p and ds are then 0)
    auto load_stage = [&](int stage, int t0) {
        load_rows<D, BW>(sQ + stage * BW * LD, qb, qst, t0, T);
        load_rows<D, BW>(sO + stage * BW * LD, ob, ost, t0, T);
        for (int i = threadIdx.x; i < BW; i += THREADS) {
            const int t = t0 + i;
            const bool ok = t < T;
            sM[stage * BW + i] = ok ? m[sr + t] : 0.f;
            sIL[stage * BW + i] = ok ? 1.f / l[sr + t] : 0.f;
            sDi[stage * BW + i] = ok ? di[sr + t] : 0.f;
        }
    };

    load_rows<D, BT>(sK, kb, kst, k0, T);
    load_rows<D, BT>(sV, vb, vst, k0, T);
    load_stage(0, 0);
    cp_async_commit();

    const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this thread's two key rows
    const bool segk0 = key0 < len, segk1 = key1 < len;
    float ak[DT][4], av[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.f;

    const int steps = (T + BW - 1) / BW;
    for (int it = 0; it < steps; ++it) {
        const int stage = it & 1;
        if (it + 1 < steps) {
            load_stage(stage ^ 1, (it + 1) * BW);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* cQ = sQ + stage * BW * LD;
        const bf16* cO = sO + stage * BW * LD;
        const float* cM = sM + stage * BW;
        const float* cIL = sIL + stage * BW;
        const float* cDi = sDi + stage * BW;

        // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and BW queries
        float st[NT][4], dpt[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            unsigned ka[4], va[4];
            load_a<D>(ka, sK, warp, lane, kk);
            load_a<D>(va, sV, warp, lane, kk);
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                unsigned bq[4], bo[4];
                load_b<D>(bq, cQ, lane, j, kk);
                load_b<D>(bo, cO, lane, j, kk);
                mma16816(st[j], ka, bq[0], bq[1]);
                mma16816(st[j + 1], ka, bq[2], bq[3]);
                mma16816(dpt[j], va, bo[0], bo[1]);
                mma16816(dpt[j + 1], va, bo[2], bo[3]);
            }
        }

        // P^T and dS^T (rows: keys key0 / key1; columns: queries), packed to
        // bf16 as the A fragments of the two products below
        const int qt = it * BW;
        unsigned pa[NT][2], dsa[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            float pv[4], dsv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = j * 8 + 2 * tq + (e & 1);  // query column in the tile
                float x = st[j][e] * scale;
                if (masked) x += ((qt + c < len) == (e < 2 ? segk0 : segk1)) ? 0.f : MASK_VALUE;
                const float p = __expf(x - cM[c]) * cIL[c];
                pv[e] = p;
                dsv[e] = ((dpt[j][e] - cDi[c]) * p) * scale;
            }
            pa[j][0] = pack_bf16(pv[0], pv[1]);
            pa[j][1] = pack_bf16(pv[2], pv[3]);
            dsa[j][0] = pack_bf16(dsv[0], dsv[1]);
            dsa[j][1] = pack_bf16(dsv[2], dsv[3]);
        }

        // dV += P^T dO, dK += dS^T Q over this block's output columns
#pragma unroll
        for (int kk = 0; kk < BW / 16; ++kk) {
            const unsigned pf[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
            const unsigned df[4] = {dsa[2 * kk][0], dsa[2 * kk][1], dsa[2 * kk + 1][0], dsa[2 * kk + 1][1]};
#pragma unroll
            for (int j = 0; j < DT; j += 2) {
                unsigned bo[4], bq[4];
                load_b_trans<D>(bo, cO, lane, j, kk, c0);
                load_b_trans<D>(bq, cQ, lane, j, kk, c0);
                mma16816(av[j], pf, bo[0], bo[1]);
                mma16816(av[j + 1], pf, bo[2], bo[3]);
                mma16816(ak[j], df, bq[0], bq[1]);
                mma16816(ak[j + 1], df, bq[2], bq[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is loaded again
    }

    // dk, dv: contiguous (B, T, H, D)
#pragma unroll
    for (int j = 0; j < DT; ++j) {
        const int col = c0 + j * 8 + 2 * tq;
        if (key0 < T) {
            const long long o = (((long long)b * T + key0) * H + h) * D + col;
            *reinterpret_cast<unsigned*>(dk + o) = pack_bf16(ak[j][0], ak[j][1]);
            *reinterpret_cast<unsigned*>(dv + o) = pack_bf16(av[j][0], av[j][1]);
        }
        if (key1 < T) {
            const long long o = (((long long)b * T + key1) * H + h) * D + col;
            *reinterpret_cast<unsigned*>(dk + o) = pack_bf16(ak[j][2], ak[j][3]);
            *reinterpret_cast<unsigned*>(dv + o) = pack_bf16(av[j][2], av[j][3]);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ di, const int* __restrict__ lengths, bf16* __restrict__ dq,
    int T, int H, long long qsb, long long qst, long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, long long osb, long long ost, long long osh, float scale) {
    constexpr int BW = Tile<D>::BW, LD = Tile<D>::LD;
    constexpr int NT = BW / 8;   // key n-tiles of S per step
    constexpr int DT = D / 8;    // d n-tiles of dQ
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sO = sQ + BT * LD;
    bf16* sK = sO + BT * LD;       // two stages
    bf16* sV = sK + 2 * BW * LD;   // two stages

    const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tq = lane & 3;
    const bool masked = lengths != nullptr;
    const int len = masked ? lengths[b] : T;
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* kb = k + b * ksb + h * ksh;
    const bf16* vb = v + b * vsb + h * vsh;
    const bf16* ob = dout + b * osb + h * osh;

    load_rows<D, BT>(sQ, qb, qst, q0, T);
    load_rows<D, BT>(sO, ob, ost, q0, T);
    load_rows<D, BW>(sK, kb, kst, 0, T);
    load_rows<D, BW>(sV, vb, vst, 0, T);
    cp_async_commit();

    const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
    const bool seg0 = row0 < len, seg1 = row1 < len;
    const long long sr = ((long long)b * H + h) * T;
    const float m0 = row0 < T ? m[sr + row0] : 0.f, m1 = row1 < T ? m[sr + row1] : 0.f;
    const float il0 = row0 < T ? 1.f / l[sr + row0] : 0.f, il1 = row1 < T ? 1.f / l[sr + row1] : 0.f;
    const float di0 = row0 < T ? di[sr + row0] : 0.f, di1 = row1 < T ? di[sr + row1] : 0.f;
    float aq[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) aq[j][0] = aq[j][1] = aq[j][2] = aq[j][3] = 0.f;

    const int steps = (T + BW - 1) / BW;
    for (int it = 0; it < steps; ++it) {
        const int stage = it & 1;
        if (it + 1 < steps) {
            load_rows<D, BW>(sK + (stage ^ 1) * BW * LD, kb, kst, (it + 1) * BW, T);
            load_rows<D, BW>(sV + (stage ^ 1) * BW * LD, vb, vst, (it + 1) * BW, T);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* cK = sK + stage * BW * LD;
        const bf16* cV = sV + stage * BW * LD;

        // S = Q K^T and dP = dO V^T for this warp's 16 queries and BW keys
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            unsigned qa[4], oa[4];
            load_a<D>(qa, sQ, warp, lane, kk);
            load_a<D>(oa, sO, warp, lane, kk);
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                unsigned bk[4], bv[4];
                load_b<D>(bk, cK, lane, j, kk);
                load_b<D>(bv, cV, lane, j, kk);
                mma16816(s[j], qa, bk[0], bk[1]);
                mma16816(s[j + 1], qa, bk[2], bk[3]);
                mma16816(dp[j], oa, bv[0], bv[1]);
                mma16816(dp[j + 1], oa, bv[2], bv[3]);
            }
        }

        // dS (rows row0 / row1, columns: keys), packed to bf16 A fragments
        const int key = it * BW + 2 * tq;
        unsigned dsa[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            float dsv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool lo = e < 2;
                float x = s[j][e] * scale;
                if (masked) x += ((key + j * 8 + (e & 1) < len) == (lo ? seg0 : seg1)) ? 0.f : MASK_VALUE;
                const float p = __expf(x - (lo ? m0 : m1)) * (lo ? il0 : il1);
                dsv[e] = ((dp[j][e] - (lo ? di0 : di1)) * p) * scale;
            }
            dsa[j][0] = pack_bf16(dsv[0], dsv[1]);
            dsa[j][1] = pack_bf16(dsv[2], dsv[3]);
        }

        // dQ += dS K
#pragma unroll
        for (int kk = 0; kk < BW / 16; ++kk) {
            const unsigned df[4] = {dsa[2 * kk][0], dsa[2 * kk][1], dsa[2 * kk + 1][0], dsa[2 * kk + 1][1]};
#pragma unroll
            for (int j = 0; j < DT; j += 2) {
                unsigned bk[4];
                load_b_trans<D>(bk, cK, lane, j, kk, 0);
                mma16816(aq[j], df, bk[0], bk[1]);
                mma16816(aq[j + 1], df, bk[2], bk[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is loaded again
    }

    // dq: contiguous (B, T, H, D)
#pragma unroll
    for (int j = 0; j < DT; ++j) {
        const int col = j * 8 + 2 * tq;
        if (row0 < T)
            *reinterpret_cast<unsigned*>(dq + (((long long)b * T + row0) * H + h) * D + col) =
                pack_bf16(aq[j][0], aq[j][1]);
        if (row1 < T)
            *reinterpret_cast<unsigned*>(dq + (((long long)b * T + row1) * H + h) * D + col) =
                pack_bf16(aq[j][2], aq[j][3]);
    }
}

struct Args {
    const bf16 *q, *k, *v, *dout;
    const float *m, *l, *di;
    const int* lengths;
    int B, T, H;
    long long s[12];  // (batch, time, head) element strides of q, k, v, dO
    float scale;
    cudaStream_t stream;
};

template <int D>
int launch_dkv(const Args& a, bf16* dk, bf16* dv) {
    constexpr int smem = Tile<D>::SMEM_DKV;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.T + BT - 1) / BT * Tile<D>::SPLIT, a.H, a.B);
    flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.m, a.l, a.di, a.lengths, dk, dv, a.T, a.H, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4],
        a.s[5], a.s[6], a.s[7], a.s[8], a.s[9], a.s[10], a.s[11], a.scale);
    return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Args& a, bf16* dq) {
    constexpr int smem = Tile<D>::SMEM_DQ;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.T + BT - 1) / BT, a.H, a.B);
    flash_bwd_dq_kernel<D><<<grid, THREADS, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.m, a.l, a.di, a.lengths, dq, a.T, a.H, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4],
        a.s[5], a.s[6], a.s[7], a.s[8], a.s[9], a.s[10], a.s[11], a.scale);
    return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* m, const void* l,
               const void* di, const void* lengths, int B, int T, int H, const long long* strides, float scale,
               void* stream) {
    Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
           static_cast<const bf16*>(dout), static_cast<const float*>(m), static_cast<const float*>(l),
           static_cast<const float*>(di), static_cast<const int*>(lengths), B, T, H, {}, scale,
           static_cast<cudaStream_t>(stream)};
    for (int i = 0; i < 12; ++i) a.s[i] = strides[i];
    return a;
}

}  // namespace

// q, k, v, dout: bf16 (B, T, H, D) with element strides (batch, time, head)
// in `strides` (q's three, then k's, v's, dout's), a contiguous last
// dimension and 16-byte aligned rows; m, l, di: contiguous f32 (B, H, T);
// lengths: int32 (B,) or null (no mask); dk, dv (dkv) and dq (dq):
// contiguous bf16 (B, T, H, D). Each returns a cudaError_t.
extern "C" int ssak_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                            const void* m, const void* l, const void* di, const void* lengths,
                                            void* dk, void* dv, int B, int T, int H, int D,
                                            const long long* strides, float scale, void* stream) {
    const Args a = make_args(q, k, v, dout, m, l, di, lengths, B, T, H, strides, scale, stream);
    bf16 *k_out = static_cast<bf16*>(dk), *v_out = static_cast<bf16*>(dv);
    switch (D) {
        case 64: return launch_dkv<64>(a, k_out, v_out);
        case 128: return launch_dkv<128>(a, k_out, v_out);
        case 256: return launch_dkv<256>(a, k_out, v_out);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int ssak_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                           const void* m, const void* l, const void* di, const void* lengths,
                                           void* dq, int B, int T, int H, int D, const long long* strides,
                                           float scale, void* stream) {
    const Args a = make_args(q, k, v, dout, m, l, di, lengths, B, T, H, strides, scale, stream);
    switch (D) {
        case 64: return launch_dq<64>(a, static_cast<bf16*>(dq));
        case 128: return launch_dq<128>(a, static_cast<bf16*>(dq));
        case 256: return launch_dq<256>(a, static_cast<bf16*>(dq));
        default: return (int)cudaErrorInvalidValue;
    }
}
