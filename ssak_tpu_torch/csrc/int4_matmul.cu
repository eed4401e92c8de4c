// Fused int4-weight unpack-dequantize-matmul for decode-shaped activations (K3).
//
//   y[m, n] = sum_k bf16(x[m, k]) * bf16(q[k, n] * scale[k / 64, n])   (f32 accumulation)
//
// where q[2r, n] is the low and q[2r+1, n] the high signed nibble of the
// packed byte q4[r, n] (models/quant.py layout), and one f32 scale covers 64
// weight rows (32 packed rows) of a column.
//
// Replaces: ssak_tpu/ops/int8_matmul.py, `matmul_int4` (Pallas kernel
// `_kernel4`, line 117). As on the TPU (cdt = bf16) each weight is its
// nibble times its block scale in f32, rounded to bf16 before the product,
// and x is rounded to bf16; bf16 products are exact in f32, so the only
// difference from the TPU kernel is the order of the f32 sums. The scale
// cannot leave the sum over k: bf16(q*s) is not q*bf16(s).
//
// What bounds it on the H100: bytes. M (rows of one decode step) is at most
// 64, so the product does 4*M operations per packed weight byte, far below
// the ~295 bf16 operations per byte where the tensor cores would set the
// pace. The least time is the K/2*N packed bytes plus the K/64*N f32 scales
// over 3.35 TB/s: 0.33 us for 1280 x 1280 (1.08 MB with x and y), 1.3 us
// for 1280 x 5120 or 5120 x 1280 (about 4.3 MB).
//
// Design (that of csrc/int8_matmul.cu, K2, with the nibbles and the block
// scales unpacked in registers):
// - The grid is (splits, N/64): K is cut into `splits` slices of whole
//   128-row stages. A stage is two whole 64-row scale blocks, so no scale
//   block straddles a slice. A block walks its slice stage after stage, so
//   ops/int8_matmul.py `int4_plan` takes the shortest longest slice that
//   160 blocks and clusters of 8 allow, and of those the fewest splits: at
//   K x N = 1280 x 1280, 1280 x 5120 and 5120 x 1280 the grids are 5 x 20,
//   2 x 80 and 8 x 20 (100, 160, 160 blocks), slices of 2, 5 and 5 stages.
//   At 1280 x 1280, 5 splits (100 blocks, none sharing an SM) were faster
//   than 8 (160) with the same 2-stage slices; 3, 6 or 7 splits were slower
//   everywhere (clusters of those sizes pack badly into the H100's GPCs).
// - Split-K summed in one launch, in a fixed order. The slices of one
//   column tile form a thread-block cluster (splits <= 8, the portable
//   size). Each block writes its (M x 64) f32 partial, cut into the ranks'
//   shares, into the receive buffers of the ranks that own them (remote
//   stores through distributed shared memory); after one cluster.sync()
//   each rank sums its share over the source ranks 0..S-1 in that order,
//   from its own shared memory, and stores y. No scratch in device memory,
//   no second launch, no atomics: repeats are bit-identical. One cluster
//   barrier instead of K2's two (pull, then keep alive).
// - Bytes in flight. A ring of stages, each 64 packed rows of the block's 64
//   columns (4 KB), the stage's two rows of block scales for those columns
//   (512 B) and the same 128 columns of x (L2-resident: every column tile
//   reads it), filled by cp.async (16-byte copies, 8-byte where N % 16 != 0
//   leaves rows 8-byte aligned; rows past K and columns past N zero-filled
//   through the src-size operand) and XOR-swizzled instead of padded. The
//   ring holds a block's whole slice where 112 KB allows (up to 9, 8, 6, 4
//   stages for 1, 2, 3, 4 groups of 16 rows, so that two blocks share an
//   SM): at the decoder's shapes every load is in flight before the first
//   product, and the block then waits once for all of them, with no
//   barrier between stages (the stages land at about the same time anyway).
// - Tensor cores, B built in registers from the packed bytes. mma.sync
//   .m16n8k16 bf16 with f32 sums; x (rows padded to 16 by zero-fill) read
//   with ldmatrix as A. models.quant's row interleave is the B fragment's:
//   lane (g, t) holds k rows 2t, 2t+1 of column g in b0, and those are the
//   low and high nibble of packed row 8kb + t; rows 2t+8, 2t+9 (b1) are
//   packed row 8kb + t + 4. So a lane reads one 4-byte word (4 columns) of
//   each of the two rows and has b0 and b1 of 4 n-tiles: each nibble
//   becomes an exact f32 through the mantissa of a power of two (one LOP3
//   and one FADD, no I2F), is multiplied by its column's block scale in f32
//   and each pair is rounded to bf16x2 (RN-even, as the plain version). No
//   movmatrix and no bf16 tile in shared memory. The lane's word covers
//   columns 4g..4g+3, so n-tile j holds columns 4c + j of the warp's 32,
//   a permutation the epilogue undoes.
// - Work split: 8 warps, two column groups of 32 x four k groups (each takes
//   alternate 16-row k blocks of a stage); each k group leaves its own
//   partial tile and they are added in a fixed order as they are pushed
//   (cheaper than four passes with a barrier each).
// - What sets the time (tools/torch_int8_variants.py --kernel int4): the
//   launch and the cluster's sum with no work at all, then loads and
//   products that barely overlap; at 1280 x 5120 and 5120 x 1280 the
//   products cost about as much as the loads, most of it in the mma.sync
//   chains (a wgmma version with A from these registers and x from
//   swizzled shared memory was no faster at these widths).
//
// Shapes: 1 <= M <= 64, K % 64 == 0 (one scale per 64 rows), N % 8 == 0;
// the last column tile may be partial.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 64;             // output columns per block (the column tile)
constexpr int KSTEP = 128;         // weight rows per ring stage; slices are whole stages
constexpr int SB = 64;             // weight rows per scale block
constexpr int CGROUPS = BN / 32;   // a warp owns 32 of the tile's columns
constexpr int KGROUPS = 4;         // warps that share a column group, each taking its share of a stage's k blocks
constexpr int WARPS = CGROUPS * KGROUPS;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SPLITS = 8;      // portable cluster size
constexpr int LDP = BN + 4;        // partial tile row, f32: conflict-free float4 stores
constexpr int SMEM_BUDGET = 112 * 1024;  // per block: two blocks an SM

// One ring stage: 64 packed rows x 64 columns, 2 x 64 f32 block scales,
// then MT*16 rows x 128 bf16 of x. The k groups' f32 partial tiles reuse
// the ring once the loop is done; the receive buffer of the cluster's sum
// lies after the ring, since other blocks write into it while this one
// still runs.
template <int MT>
struct Smem {
    static constexpr int W = KSTEP / 2 * BN;                    // packed weights of a stage
    static constexpr int S = KSTEP / SB * BN * 4;               // block scales of a stage
    static constexpr int SLOT = W + S + MT * 16 * KSTEP * 2;    // + bf16 x of a stage
    static constexpr int P = MT * 16 * LDP * 4;                 // f32 partial sums of one k group
    static constexpr int R = (MT * 16 * BN / 4 + MAX_SPLITS) * 16;  // receive buffer of the cluster's sum, float4s
    static constexpr int FIT = (SMEM_BUDGET - R) / SLOT;
    static constexpr int STAGES = FIT < 9 ? FIT : 9;            // most ring slots: 9, 8, 6, 4
    __host__ __device__ static int ring(int slots) { return slots * SLOT > KGROUPS * P ? slots * SLOT : KGROUPS * P; }
    static int bytes(int slots) { return ring(slots) + R; }
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

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half, each rounded to nearest even
    return *reinterpret_cast<const unsigned*>(&h);
}

// (a & b) ^ c in one instruction
__device__ __forceinline__ unsigned and_xor(unsigned a, unsigned b, unsigned c) {
    unsigned d;
    asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// 4 packed bytes (columns j = 0..3, rows 2t (low nibble) and 2t+1 (high))
// -> b[j] = bf16x2(low * s_j, high * s_j). Each nibble, its top bit flipped
// (-8..7 -> 0..15), lands in the mantissa of a power of two whose ulp is 1
// at the nibble's bit position (one LOP3: mask, flip and exponent at once);
// subtracting that power plus 8 gives the signed value exactly. The product
// with the scale rounds once in f32, as the plain version's q.float() *
// scale, then once to bf16.
__device__ __forceinline__ void dequant4(unsigned w, const float4& s, unsigned (&b)[4]) {
    const float sc[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const unsigned p = j < 2 ? w : w >> 16;  // bytes 2 and 3 where bytes 0 and 1 are
        const int sh = 8 * (j & 1);
        // the low nibble at bit sh, the high one at bit sh + 4: 2^(23-sh) and 2^(19-sh)
        const float lo = __uint_as_float(and_xor(p, 0x0Fu << sh, (150u - sh) << 23 | 0x08u << sh)) -
                         (float)((1 << (23 - sh)) + 8);
        const float hi = __uint_as_float(and_xor(p, 0xF0u << sh, (146u - sh) << 23 | 0x80u << sh)) -
                         (float)((1 << (19 - sh)) + 8);
        b[j] = bf16x2(lo * sc[j], hi * sc[j]);
    }
}

// the two halves of cluster.sync(): a relaxed arrive at the start, its wait
// before the first access to another block's shared memory (every block of
// the cluster has started by then)
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// MT: 16-row groups of x (ceil(M/16)); VEC: packed-weight copy width in
// bytes; `slots`: ring stages, min(the longest slice's stages, Smem<MT>::STAGES).
// grid (splits, column tiles), cluster (splits, 1, 1): blockIdx.x is the rank.
template <int MT, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
int4_matmul_kernel(const bf16* __restrict__ x, const unsigned char* __restrict__ q4, const float* __restrict__ scale,
                   float* __restrict__ y, int M, int K, int N, int slots) {
    using L = Smem<MT>;
    constexpr int SETS = MT <= 2 ? 2 : 1;  // accumulator sets (alternate k blocks), as registers allow
    extern __shared__ __align__(128) unsigned char smem[];
    float* part = reinterpret_cast<float*>(smem);  // after the loop: KGROUPS partial tiles
    float4* recv = reinterpret_cast<float4*>(smem + L::ring(slots));

    cg::cluster_group cluster = cg::this_cluster();
    cluster_arrive_relaxed();
    const int rank = blockIdx.x, S = gridDim.x;
    const int n0 = blockIdx.y * BN;
    // slice `rank` of S: stages [rank*T/S, (rank+1)*T/S) of the T = ceil(K/KSTEP)
    const int T = (K + KSTEP - 1) / KSTEP, s_lo = rank * T / S, s_hi = (rank + 1) * T / S;
    const int k_lo = s_lo * KSTEP, k_hi = min(K, s_hi * KSTEP);
    const int steps = s_hi - s_lo;
    const int tid = threadIdx.x, lane = tid % 32, cw = (tid / 32) % CGROUPS, kg = tid / (32 * CGROUPS);
    const int g = lane >> 2, t = lane & 3;
    const int wchunk = 2 * cw + (g >> 2);  // the 16-byte chunk of a packed row that holds the lane's word

    // Swizzles: packed row r keeps its 16-byte chunk c at c ^ (((r >> 1) & 1) << 1)
    // (a warp reads one word of its 32 columns in 4 consecutive rows: 32
    // distinct banks); x row r keeps chunk c at c ^ (r & 7) (ldmatrix reads 8
    // rows of one chunk).
    auto load_stage = [&](int step, int slot) {
        const int k0 = k_lo + step * KSTEP;
        unsigned char* st = smem + slot * L::SLOT;
        constexpr int WCH = BN / VEC;  // copies per packed row
#pragma unroll
        for (int c = tid; c < KSTEP / 2 * WCH; c += THREADS) {
            const int r = c / WCH, col = c % WCH * VEC;
            const bool ok = k0 + 2 * r < k_hi && n0 + col < N;
            const int off = r * BN + ((((col >> 4) ^ ((r >> 1) & 1) << 1)) << 4) + (col & 15);
            cp_async<VEC>(st + off, ok ? q4 + (size_t)(k0 / 2 + r) * N + n0 + col : q4, ok);
        }
        if (tid < KSTEP / SB * BN / 4) {  // the stage's scale rows, 4 columns a copy
            const int b = tid / (BN / 4), col = tid % (BN / 4) * 4;
            const bool ok = k0 + b * SB < k_hi && n0 + col < N;
            cp_async<16>(st + L::W + (b * BN + col) * 4, ok ? scale + (size_t)(k0 / SB + b) * N + n0 + col : scale,
                         ok);
        }
        unsigned char* xd = st + L::W + L::S;
#pragma unroll
        for (int c = tid; c < MT * 16 * (KSTEP / 8); c += THREADS) {
            const int r = c / (KSTEP / 8), ch = c % (KSTEP / 8);
            const bool ok = r < M && k0 + ch * 8 < k_hi;
            cp_async<16>(xd + r * KSTEP * 2 + ((ch ^ (r & 7)) << 4), ok ? x + (size_t)r * K + k0 + ch * 8 : x, ok);
        }
    };

    float acc[SETS][MT][4][4];
#pragma unroll
    for (int u = 0; u < SETS; ++u)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[u][i][j][e] = 0.f;

    // stage s travels in cp.async group s: the prologue fills every slot,
    // iteration i >= 1 refills the slot that iteration i - 1 used
    for (int s = 0; s < slots; ++s) {
        if (s < steps) load_stage(s, s);
        cp_async_commit();
    }
    // when the ring holds the whole slice, one wait for all of it and no
    // barrier between stages; otherwise a wait and a barrier per stage
    const bool whole = steps <= slots;
    for (int i = 0, slot = 0, prev = slots - 1; i < steps; ++i, prev = slot, slot = slot + 1 == slots ? 0 : slot + 1) {
        if (i == 0 || !whole) {
            cp_async_wait_dyn(whole ? 0 : i == 0 ? slots - 1 : slots - 2);  // this thread's copies of stage i have landed
            __syncthreads();  // everyone's have, and stage i-1's slot is free
        }
        if (i > 0) {
            if (i - 1 + slots < steps) load_stage(i - 1 + slots, prev);
            cp_async_commit();
        }
        const unsigned char* st = smem + slot * L::SLOT;
        const float* ss = reinterpret_cast<const float*>(st + L::W);
        const unsigned char* xa = st + L::W + L::S;
#pragma unroll
        for (int q = 0; q < KSTEP / 16 / KGROUPS; ++q) {
            const int kk = q * KGROUPS + kg;  // k block: packed rows 8kk..8kk+7, scale row kk / 4
            const float4 s = *reinterpret_cast<const float4*>(ss + kk / 4 * BN + cw * 32 + 4 * g);
            // b[h][j]: n-tile j's b0 (h = 0) and b1 (h = 1), built from one
            // word of packed row 8kk + t + 4h (columns 4g..4g+3 of the warp's 32)
            unsigned b[2][4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 8 * kk + t + 4 * h;
                const unsigned w = *reinterpret_cast<const unsigned*>(
                    st + r * BN + ((wchunk ^ ((r >> 1) & 1) << 1) << 4) + 4 * (g & 3));
                dequant4(w, s, b[h]);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                unsigned a[4];
                const int r = mt * 16 + (lane & 15), ch = kk * 2 + (lane >> 4);
                ldmatrix_x4(a, xa + r * KSTEP * 2 + ((ch ^ (r & 7)) << 4));
#pragma unroll
                for (int j = 0; j < 4; ++j) mma16816(acc[q % SETS][mt][j], a, b[0][j], b[1][j]);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the partial tile
    if constexpr (SETS == 2) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[0][i][j][e] += acc[1][i][j][e];
    }

    // this k group's partial tile: n-tile j's c0, c1 are columns 8t + j and
    // 8t + 4 + j of the warp's 32 in row g, c2, c3 the same columns in row
    // g + 8 of each 16-row group
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const float(&c)[4][4] = acc[0][mt];
        float* p = part + kg * (L::P / 4) + (mt * 16 + g) * LDP + cw * 32 + 8 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)  // e: c index -> (row g or g + 8, first or second 4 columns)
            *reinterpret_cast<float4*>(p + (e >> 1) * 8 * LDP + (e & 1) * 4) =
                make_float4(c[0][e], c[1][e], c[2][e], c[3][e]);
    }
    __syncthreads();

    // element e (4 columns) of the M x 64 tile belongs to the rank o with
    // o*E/S <= e < (o+1)*E/S; every rank adds its k groups' partials of e
    // in order and stores the sum into o's receive buffer, row `rank`, then
    // o sums rows 0..S-1 in that order
    constexpr int C4 = BN / 4;
    const int E4 = M * C4, SH = (E4 + S - 1) / S;
    cluster_wait();
    for (int e = tid; e < E4; e += THREADS) {
        const int o = ((e + 1) * S - 1) / E4;
        const float* p = part + e / C4 * LDP + e % C4 * 4;
        float4 v = *reinterpret_cast<const float4*>(p);
#pragma unroll
        for (int k = 1; k < KGROUPS; ++k) {
            const float4 u = *reinterpret_cast<const float4*>(p + k * (L::P / 4));
            v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
        }
        *(cluster.map_shared_rank(recv, o) + rank * SH + (e - o * E4 / S)) = v;
    }
    cluster.sync();  // every partial has landed; after this no block touches another's memory
    const int lo = rank * E4 / S, hi = (rank + 1) * E4 / S;
    for (int e = lo + tid; e < hi; e += THREADS) {
        const int n = n0 + e % C4 * 4;
        if (n >= N) continue;  // N % 8 == 0: a group of 4 columns is all in or all out
        float4 s = recv[e - lo];
#pragma unroll
        for (int src = 1; src < MAX_SPLITS; ++src) {
            if (src < S) {
                const float4 v = recv[src * SH + e - lo];
                s.x += v.x;
                s.y += v.y;
                s.z += v.z;
                s.w += v.w;
            }
        }
        *reinterpret_cast<float4*>(y + (size_t)(e / C4) * N + n) = s;
    }
}

template <int MT, int VEC>
int launch(const void* x, const void* q4, const void* scale, void* y, int M, int K, int N, int splits, int kps,
           cudaStream_t stream) {
    using L = Smem<MT>;
    auto kernel = int4_matmul_kernel<MT, VEC>;
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
    e = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)x, (const unsigned char*)q4, (const float*)scale, (float*)y, M,
                           K, N, slots);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <int VEC>
int dispatch(const void* x, const void* q4, const void* scale, void* y, int M, int K, int N, int splits, int kps,
             cudaStream_t stream) {
    switch ((M + 15) / 16) {
        case 1: return launch<1, VEC>(x, q4, scale, y, M, K, N, splits, kps, stream);
        case 2: return launch<2, VEC>(x, q4, scale, y, M, K, N, splits, kps, stream);
        case 3: return launch<3, VEC>(x, q4, scale, y, M, K, N, splits, kps, stream);
        default: return launch<4, VEC>(x, q4, scale, y, M, K, N, splits, kps, stream);
    }
}

}  // namespace

// x (M, K) bf16, q4 (K/2, N) packed nibbles, scale (K/64, N) f32, y (M, N)
// f32. The plan (block_n, splits, kps) comes from ops/int8_matmul.py
// `int4_plan` (kps: the longest slice, ceil(T/splits) stages of KSTEP rows);
// a plan or a shape the kernel cannot run returns cudaErrorInvalidValue.
extern "C" int ssak_int4_matmul(const void* x, const void* q4, const void* scale, void* y, int M, int K, int N,
                                int block_n, int splits, int kps, void* stream) {
    const int T = (K + KSTEP - 1) / KSTEP;
    const bool plan_ok = block_n == BN && splits >= 1 && splits <= MAX_SPLITS && splits <= T &&
                         kps == (T + splits - 1) / splits * KSTEP;
    if (!plan_ok || M < 1 || M > 64 || K < SB || K % SB || N < 8 || N % 8) return (int)cudaErrorInvalidValue;
    if (N % 16 == 0 && (uintptr_t)q4 % 16 == 0)
        return dispatch<16>(x, q4, scale, y, M, K, N, splits, kps, (cudaStream_t)stream);
    return dispatch<8>(x, q4, scale, y, M, K, N, splits, kps, (cudaStream_t)stream);
}
