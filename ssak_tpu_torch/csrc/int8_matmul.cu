// Fused int8-weight dequantize-matmul for decode-shaped activations (K2).
//
//   y[m, n] = scale[n] * sum_k bf16(x[m, k]) * bf16(q8[k, n])   (f32 accumulation)
//
// Replaces: ssak_tpu/ops/int8_matmul.py, `matmul_int8` (Pallas kernel `_kernel`).
//
// What bounds it on the H100: bytes. M (batch rows of one decode step) is at
// most 64, so the product does 2*M flops per weight byte, far below the ~295
// bf16 operations per byte where the tensor cores would set the pace. The
// least time is the K*N int8 weight bytes over 3.35 TB/s: 0.49 us for a
// 1280 x 1280 dense (1.64 MB), 1.96 us for 1280 x 5120 or 5120 x 1280.
//
// Design, against what held the first version back:
// - Enough blocks. The grid is (splits, N/64): K is cut into `splits` slices
//   of whole 128-row stages (ops/int8_matmul.py `int8_plan` chooses the
//   count: the most, at most 8, within 160 blocks, about 1.2 an SM, or the
//   fewest that reach 132): 160 blocks at K x N = 1280 x 1280, 1280 x 5120
//   and 5120 x 1280, where N/64 alone gave 20, 80 and 20.
// - Split-K summed in one launch, in a fixed order. The slices of one
//   column tile form a thread-block cluster (splits <= 8, the portable
//   size). Each block leaves its (M x 64) f32 partial in its shared memory;
//   after cluster.sync() every block sums a share of the tile's elements
//   over the cluster's ranks 0..S-1 in that order through distributed
//   shared memory, applies the scale and stores y; a second cluster.sync()
//   keeps each partial alive until the others have read it. No scratch in
//   device memory, no second launch, no atomics: repeats are bit-identical.
// - Bytes in flight. A ring of stages, each 128 k-rows of the block's 64
//   weight columns (8 KB of int8) and the same 128 columns of x (L2-resident:
//   every column tile reads it), filled by cp.async (16-byte copies, 8-byte
//   where N % 16 != 0 leaves rows 8-byte aligned; ragged rows and columns
//   zero-filled through the src-size operand) and XOR-swizzled instead of
//   padded. Little's law: 3.35 TB/s x 1-2 us of loaded latency is 3.4-6.7
//   MB in flight, as much as a whole 6.5 MB dense. So the ring holds a
//   block's whole slice where shared memory allows (up to 9, 7, 5, 4 stages
//   for 1, 2, 3, 4 groups of 16 rows, within 112 KB so that two blocks
//   share an SM): at the decoder's shapes every load is issued before the
//   first stage is used.
// - Tensor cores. mma.sync.m16n8k16 bf16 with f32 sums: x (rows padded to
//   16 by zero-fill) read with ldmatrix as A; the int8 weights become B in
//   registers, with no trip through shared memory: each lane reads one
//   4-byte word of a stage row, widens it to two bf16 pairs (exact: int8
//   values are bf16 values; integer and f32 adds at full rate, no I2F) and
//   movmatrix transposes each 8x8 block into the B fragment. The lane's
//   word covers columns 4t..4t+3, so the two n-tiles hold a permutation of
//   the warp's 16 columns, which the epilogue undoes. The products are
//   exact in f32, so the kernel differs from the plain version only in the
//   order of the f32 sums. The scale commutes with the sum over k and is
//   applied once.
// - What sets the time now (tools/torch_int8_variants.py): a fixed ~4.5 us
//   of launch, cluster syncs and epilogue with no work at all, then loads
//   and products that overlap little, since every stage of a block lands at
//   about the same time and its products then run one stage after another.
//   The products cost per stage more than per k row (one barrier and one
//   dependent chain of load, widen, transpose and mma each), hence stages
//   of 128 rows, 8 warps (two per column group, each taking alternate k
//   blocks) and two accumulator sets per warp: 64-row stages, 4 warps or
//   one accumulator set were slower at every decoder shape.
// One __syncthreads per stage: the ring's hand-over.
//
// Shapes: 1 <= M <= 64, K % 8 == 0, N % 8 == 0; the last column tile may be
// partial.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 64;         // output columns per block (the column tile)
constexpr int KSTEP = 128;     // k rows per ring stage; slices are whole stages
constexpr int KGROUPS = 2;     // warps that share a column group, each taking its share of a stage's k blocks
constexpr int WARPS = 4 * KGROUPS;  // warp % 4 owns 16 of the tile's columns
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SPLITS = 8;  // portable cluster size
constexpr int LDP = BN + 8;    // partial tile row, f32
constexpr int SMEM_BUDGET = 112 * 1024;  // per block: two blocks an SM

// One ring stage: 128 rows x 64 int8 weights, then MT*16 rows x 128 bf16 of x.
// The f32 partial tile reuses the ring once the loop is done.
template <int MT>
struct Smem {
    static constexpr int W = KSTEP * BN;                             // int8 weights of a stage
    static constexpr int SLOT = W + MT * 16 * KSTEP * 2;             // + bf16 x of a stage
    static constexpr int STAGES = SMEM_BUDGET / SLOT;                // most ring slots: 9, 7, 5, 4
    static_assert(STAGES <= 9, "cp_async_wait_dyn covers rings of up to 9 slots");
    static constexpr int P = MT * 16 * LDP * 4;                      // f32 partial sums
    static int bytes(int slots) { return slots * SLOT > P ? slots * SLOT : P; }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// VEC-byte copy global -> shared; nothing is read and zeros are written when !valid
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    if constexpr (VEC == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                     "r"(valid ? 16 : 0));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                     "r"(valid ? 8 : 0));
    }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait until at most n groups are pending (n < 9; a larger n waits for all)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
    switch (n) {
        case 8: cp_async_wait<8>(); break;
        case 7: cp_async_wait<7>(); break;
        case 6: cp_async_wait<6>(); break;
        case 5: cp_async_wait<5>(); break;
        case 4: cp_async_wait<4>(); break;
        case 3: cp_async_wait<3>(); break;
        case 2: cp_async_wait<2>(); break;
        case 1: cp_async_wait<1>(); break;
        default: cp_async_wait<0>(); break;
    }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// the transpose of an 8x8 b16 matrix held as an mma fragment (lane 4g+t: row g, columns 2t, 2t+1)
__device__ __forceinline__ unsigned movmatrix_trans(unsigned a) {
    unsigned d;
    asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
    return d;
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 packed int8 -> 2 packed bf16 pairs, exactly and at full rate (no I2F):
// each byte, offset by 128, becomes the mantissa of 2^23 (0x4B000000 | u),
// and 2^23 + 128 is subtracted; the results are integers of at most 8
// significant bits, so the upper half of each f32 is its bf16 value
__device__ __forceinline__ uint2 widen4(unsigned w) {
    const unsigned u = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
    return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// MT: 16-row groups of x (ceil(M/16)); VEC: weight copy width in bytes;
// `slots`: ring stages, min(the slice's stages, Smem<MT>::STAGES).
// grid (splits, column tiles), cluster (splits, 1, 1): blockIdx.x is the rank.
template <int MT, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q8, const float* __restrict__ scale,
                   float* __restrict__ y, int M, int K, int N, int slots) {
    using L = Smem<MT>;
    extern __shared__ __align__(128) unsigned char smem[];
    float* part = reinterpret_cast<float*>(smem);  // after the loop

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = blockIdx.x, S = gridDim.x;
    const int n0 = blockIdx.y * BN;
    // slice `rank` of S: stages [rank*T/S, (rank+1)*T/S) of the T = ceil(K/KSTEP)
    const int T = (K + KSTEP - 1) / KSTEP, s_lo = rank * T / S, s_hi = (rank + 1) * T / S;
    const int k_lo = s_lo * KSTEP, k_hi = min(K, s_hi * KSTEP);
    const int steps = s_hi - s_lo;
    const int tid = threadIdx.x, lane = tid % 32, cw = (tid / 32) % 4, kg = tid / 128;
    const int g = lane >> 2, t = lane & 3;

    // Swizzles: weight row r keeps its 16-byte chunk c at chunk c ^ ((r >> 1) & 3)
    // (a warp reads one 4-byte word of its chunk in 8 rows: 32 distinct banks);
    // x row r keeps chunk c at c ^ (r & 7) (ldmatrix reads 8 rows of one chunk).
    auto load_stage = [&](int step, int slot) {
        const int k0 = k_lo + step * KSTEP;
        unsigned char* st = smem + slot * L::SLOT;
        constexpr int WCH = BN / VEC;  // copies per weight row
#pragma unroll
        for (int c = tid; c < KSTEP * WCH; c += THREADS) {
            const int r = c / WCH, col = (c % WCH) * VEC;
            const bool ok = k0 + r < k_hi && n0 + col < N;
            const int off = r * BN + ((((col >> 4) ^ (r >> 1)) & 3) << 4) + (col & 15);
            cp_async<VEC>(st + off, ok ? q8 + (size_t)(k0 + r) * N + n0 + col : q8, ok);
        }
        unsigned char* xd = st + L::W;
#pragma unroll
        for (int c = tid; c < MT * 16 * (KSTEP / 8); c += THREADS) {
            const int r = c / (KSTEP / 8), ch = c % (KSTEP / 8);
            const bool ok = r < M && k0 + ch * 8 < k_hi;
            cp_async<16>(xd + r * KSTEP * 2 + ((ch ^ (r & 7)) << 4), ok ? x + (size_t)r * K + k0 + ch * 8 : x, ok);
        }
    };

    // two accumulator sets, for alternate k blocks, so that consecutive mma
    // of a warp do not wait for each other; added in a fixed order at the end
    float acc[2][MT][2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[u][i][j][e] = 0.f;

    // stage s travels in cp.async group s: the prologue fills every slot,
    // iteration i >= 1 refills the slot that iteration i - 1 used
    for (int s = 0; s < slots; ++s) {
        if (s < steps) load_stage(s, s);
        cp_async_commit();
    }
    for (int i = 0, slot = 0, prev = slots - 1; i < steps; ++i, prev = slot, slot = slot + 1 == slots ? 0 : slot + 1) {
        cp_async_wait_dyn(i == 0 ? slots - 1 : slots - 2);  // this thread's copies of stage i have landed
        __syncthreads();                                     // everyone's have, and stage i-1's slot is free
        if (i > 0) {
            if (i - 1 + slots < steps) load_stage(i - 1 + slots, prev);
            cp_async_commit();
        }
        const unsigned char* st = smem + slot * L::SLOT;
        const unsigned char* xa = st + L::W;
#pragma unroll
        for (int q = 0; q < KSTEP / 16 / KGROUPS; ++q) {
            const int kk = q * KGROUPS + kg;
            // B fragments of the warp's 16 columns straight from the int8 rows:
            // lane 4g+t reads columns 4t..4t+3 of row g (and g + 8), widens them
            // to two bf16 pairs and transposes each 8x8 block in registers. So
            // n-tile 0 holds columns {4t, 4t+1} and n-tile 1 {4t+2, 4t+3}: the
            // columns are permuted, and the epilogue puts them back.
            unsigned b[4];  // tile 0 rows 0-7, 8-15; tile 1 rows 0-7, 8-15 (of this k block)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = kk * 16 + h * 8 + g;
                const unsigned w = *reinterpret_cast<const unsigned*>(st + r * BN + (((cw ^ (r >> 1)) & 3) << 4) + 4 * t);
                const uint2 p = widen4(w);
                b[h] = movmatrix_trans(p.x);
                b[2 + h] = movmatrix_trans(p.y);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                unsigned a[4];
                const int r = mt * 16 + (lane & 15), ch = kk * 2 + (lane >> 4);
                ldmatrix_x4(a, xa + r * KSTEP * 2 + ((ch ^ (r & 7)) << 4));
                mma16816(acc[q & 1][mt][0], a, b[0], b[1]);
                mma16816(acc[q & 1][mt][1], a, b[2], b[3]);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the partial tile
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][i][j][e] += acc[1][i][j][e];

    // this block's partial tile, the k groups added in order: lane 4g+t holds
    // columns 4t..4t+3 of its warp's 16 in rows g and g + 8 of each 16-row group
#pragma unroll
    for (int k = 0; k < KGROUPS; ++k) {
        if (k == kg) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                float4* p = reinterpret_cast<float4*>(part + (mt * 16 + g) * LDP + cw * 16 + 4 * t);
                const float(&c)[2][4] = acc[0][mt];
                float4 lo = make_float4(c[0][0], c[0][1], c[1][0], c[1][1]);
                float4 hi = make_float4(c[0][2], c[0][3], c[1][2], c[1][3]);
                if (k > 0) {
                    const float4 a = p[0], b = p[2 * LDP];
                    lo = make_float4(a.x + lo.x, a.y + lo.y, a.z + lo.z, a.w + lo.w);
                    hi = make_float4(b.x + hi.x, b.y + hi.y, b.z + hi.z, b.w + hi.w);
                }
                p[0] = lo;
                p[2 * LDP] = hi;  // 8 rows on
            }
        }
        if (k + 1 < KGROUPS) __syncthreads();
    }
    cluster.sync();

    // rank r sums elements [r*E/S, (r+1)*E/S) of the M x 64 tile (4 at a
    // time) over ranks 0..S-1 in order, scales and stores them
    constexpr int C4 = BN / 4;
    const int E4 = M * C4;
    const int lo = rank * E4 / S, hi = (rank + 1) * E4 / S;
    for (int e = lo + tid; e < hi; e += THREADS) {
        const int row = e / C4, c = (e % C4) * 4, n = n0 + c;
        if (n >= N) continue;  // N % 8 == 0: a group of 4 columns is all in or all out
        float4 v[MAX_SPLITS];  // all remote reads in flight at once, then summed in rank order
#pragma unroll
        for (int src = 0; src < MAX_SPLITS; ++src)
            if (src < S) v[src] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, src) + row * LDP + c);
        float4 s = v[0];
#pragma unroll
        for (int src = 1; src < MAX_SPLITS; ++src) {
            if (src < S) {
                s.x += v[src].x;
                s.y += v[src].y;
                s.z += v[src].z;
                s.w += v[src].w;
            }
        }
        const float4 sc = *reinterpret_cast<const float4*>(scale + n);
        *reinterpret_cast<float4*>(y + (size_t)row * N + n) = make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w);
    }
    cluster.sync();  // the partials stay until every rank has read them
}

template <int MT, int VEC>
int launch(const void* x, const void* q8, const void* scale, void* y, int M, int K, int N, int splits, int kps,
           cudaStream_t stream) {
    using L = Smem<MT>;
    auto kernel = int8_matmul_kernel<MT, VEC>;
    const int longest = kps / KSTEP;  // stages of the longest slice
    const int slots = longest < L::STAGES ? longest : L::STAGES;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    static bool sized[64] = {};  // above 48 KB, once per device and instantiation
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!sized[dev]) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(L::STAGES));
        if (e == cudaSuccess)  // all of the SM's unified memory as shared: room for two blocks
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
        if (e != cudaSuccess) return (int)e;
        sized[dev] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, (N + BN - 1) / BN);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = L::bytes(slots);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)x, (const int8_t*)q8, (const float*)scale, (float*)y, M, K,
                           N, slots);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <int VEC>
int dispatch(const void* x, const void* q8, const void* scale, void* y, int M, int K, int N, int splits, int kps,
             cudaStream_t stream) {
    switch ((M + 15) / 16) {
        case 1: return launch<1, VEC>(x, q8, scale, y, M, K, N, splits, kps, stream);
        case 2: return launch<2, VEC>(x, q8, scale, y, M, K, N, splits, kps, stream);
        case 3: return launch<3, VEC>(x, q8, scale, y, M, K, N, splits, kps, stream);
        default: return launch<4, VEC>(x, q8, scale, y, M, K, N, splits, kps, stream);
    }
}

}  // namespace

// The plan (block_n, splits, kps) comes from ops/int8_matmul.py `int8_plan`
// (kps: the longest slice, ceil(T/splits) stages); a plan the kernel cannot
// run returns cudaErrorInvalidValue.
extern "C" int ssak_int8_matmul(const void* x, const void* q8, const void* scale, void* y, int M, int K, int N,
                                int block_n, int splits, int kps, void* stream) {
    const int T = (K + KSTEP - 1) / KSTEP;
    const bool plan_ok = block_n == BN && splits >= 1 && splits <= MAX_SPLITS && splits <= T &&
                         kps == (T + splits - 1) / splits * KSTEP;
    if (!plan_ok || M < 1 || M > 64 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
    if (N % 16 == 0 && (uintptr_t)q8 % 16 == 0)
        return dispatch<16>(x, q8, scale, y, M, K, N, splits, kps, (cudaStream_t)stream);
    return dispatch<8>(x, q8, scale, y, M, K, N, splits, kps, (cudaStream_t)stream);
}
