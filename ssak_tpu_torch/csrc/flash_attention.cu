// Segment-masked flash self-attention, forward (kernel L1), for Hopper (sm_90a).
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
// T % 128 == 0 there is no mask. When asked (m and l not null, as the
// autograd Function asks for training), the final row max m (natural units)
// and row sum l over [0, Tp), the zero keys past T included, are written in
// f32 (B, H, T): the residuals the backward kernels (flash_attention_bwd.cu)
// take, as the library saves them (`save_residuals`).
//
// What bounds it on the H100: operations of two kinds. 4*T*Tp*Dh
// tensor-core flops per (batch, head) on 4*T*Dh*2 bytes (at T = 7,001, Dh =
// 64 about 3,500 flops per byte, far above the card's ~295): at B = 1, H =
// 16 0.203 ms at the 989 TFLOP/s bf16 peak. And T*Tp exponentials per
// (batch, head), on the SFUs at 16 a clock per SM (132 SMs, 1.98 GHz:
// 4.2e12/s): 7.9e8 at B = 1, 0.189 ms. At Dh = 64 the two are about equal,
// so the kernel can come near its bound only if each runs under the other.
//
// Design. One template, `fwd_kernel<D, BN, WGS>`. A CTA owns 64 WGS query
// rows and walks the keys of [0, Tp) in tiles of BN; it has WGS consumer
// warpgroups of 64 rows each and a producer warpgroup, whose registers
// setmaxnreg moves to the consumers. Dh = 64 takes three consumers (192
// rows, 160 registers each: S, 64; the previous tile's bf16 P, 32; O, 32):
// against two (128 rows, 224 registers) they hide more of the softmax's
// latency and read each K/V tile for more rows (on an H100 at B = 6, T =
// 7,001: 2.67 against 3.35 ms). Dh = 128 and 256 take two, whose wider O
// would not fit 160. BN is 128 at Dh = 64 and 128, 64 at 256. The plan (rows,
// stages, shared bytes, grid) comes from ops/flash_attention.py
// `flash_fwd_plan`, which the entry point checks.
//  1. Tensor cores. Both products are wgmma of a 64-row warpgroup. S = Q K^T
//     (m64nBNk16) reads Q and the K tile from shared memory through
//     descriptors of 128-byte swizzled panels (64 bf16 columns each), as TMA
//     writes them. P is packed to bf16 in registers, where the accumulator
//     layout is the A-fragment layout, and is the register A operand of
//     O += P V, whose B (the V tile: keys are the k dimension) is MN-major,
//     read with the transpose flag, in n = 64 pieces of one panel each.
//  2. Loads off the compute threads. One producer thread stages Q once and
//     keeps a ring of `stages` K/V tiles in flight by TMA, over tensor maps
//     of the (batch, time, head) strides (the fused-qkv view is read in
//     place; rows past T arrive as zeros), completing on mbarriers that the
//     consumers release per warp: no block-wide barrier in the loop.
//  3. Exponentials under products. The consumer warpgroups take turns, in a
//     ring (ping-pong on named barriers), to issue their products: this
//     tile's S, then the previous tile's P V. While one runs max, exp and
//     the row sums, the others' products run, and so does its own P V.
//     scale * log2(e) is folded into the logits (p takes one FFMA and one
//     ex2.approx); O is rescaled only where a warp's row max moved. ptxas
//     keeps the wgmmas of a batch in flight only if it sees every batch
//     reach its wait on every path: each branch of the loop retires its own
//     products before it joins the others (else ptxas serialised every
//     wgmma, each waited on at once).
//  4. Masks only where needed, and no work that gives zeros. A (64 query
//     rows, key tile) pair is, from the row's length: wholly across segments
//     (every p exactly 0): skipped, and not loaded when no warpgroup needs
//     it; wholly within one segment: no per-element mask; else masked
//     (-inf logits across segments, so p is exactly 0 there, as exp(x -
//     0.7 FLT_MAX - m) is). Keys in [T, Tp) are segment 0: within for pad
//     queries, whose l counts them, across for valid ones. Rows past T are
//     not written and do not count; a warpgroup with none below T skips
//     everything. `tile_class` is mirrored by ops/flash_attention.py
//     `flash_fwd_tile_class`. Skipping is exact: every row has a key of its
//     own segment (itself, or a pad key), so m is never a masked value; a
//     skipped tile would leave m, l and O unchanged, and one that would have
//     come first is wiped by the rescale exp(m_old - m_new) = 0 anyway.
// No atomics and no scratch: each output element is summed by one thread's
// wgmma accumulator in a fixed tile order, so repeats are bit-identical.
// What the backward taught (flash_attention_bwd.cu): O starts at the first
// P V product (scale-d 0), not at zeros written by moves, around which
// ptxas serialises the wgmmas; P V is issued at the start of the next turn
// (the order that proved right for register A operands), and P's registers
// are kept live until the wait that retires it (fence_regs); no trap path in
// the barrier waits. Tuned for Dh = 64, the head width of every model on the
// port's paths.
//
// The switches below cut the kernel down for tools/torch_flash_fwd_variants.py;
// they are all true here.

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr bool kLoads = true;     // the K/V tiles' TMA ring
constexpr bool kProducts = true;  // the wgmma products
constexpr bool kSoftmax = true;   // max, exp, the mask and the row sums
constexpr bool kPingPong = true;  // the consumer warpgroups take turns to issue their products

typedef __nv_bfloat16 bf16;

constexpr int WG_ROWS = 64;  // rows of one consumer warpgroup
constexpr int WGS_64 = 3;    // consumer warpgroups at D = 64 (at 128 and 256: 2)
constexpr float LOG2E = 1.4426950408889634f;
enum { SKIP = 0, WITHIN = 1, MASKED = 2 };

// A CTA of WGS consumer warpgroups (ROWS = 64 WGS query rows) and a producer
// warpgroup. setmaxnreg moves registers from the producer to the consumers:
// with 2 consumers the CTA starts at 168 a thread (what __launch_bounds__(384,
// 1) allows) and splits 56 / 224 (56*128 + 224*256 = 168*384); with 3 at 128
// (512 threads) and splits 24 / 160. Shared memory, from a 1024-byte aligned
// base: Q (ROWS rows, D / 64 panels of 128-byte rows), then `stages` stages of
// a K and a V tile (BN rows each), then the mbarriers (q, full[stages],
// empty[stages]).
template <int D, int BN, int WGS>
struct Cfg {
    static constexpr int ROWS = WGS * WG_ROWS;
    static constexpr int THREADS = (WGS + 1) * 128;
    static constexpr int KERNEL_REGS = WGS == 2 ? 168 : 128;
    static constexpr int PRODUCER_REGS = WGS == 2 ? 56 : 24, CONSUMER_REGS = WGS == 2 ? 224 : 160;
    static constexpr int PANELS = D / 64;
    static constexpr int QB = ROWS * D * 2;
    static constexpr int KVB = BN * D * 2;  // one K or V tile
    static constexpr int smem(int stages) { return 1024 + QB + stages * (2 * KVB + 16) + 8; }
};

struct Params {
    CUtensorMap q, k, v;  // bf16 (D, H, T, B) boxes of 64 x 1 x rows x 1
    const int* lengths;
    bf16* out;
    float *m, *l;  // (B, H, T) f32, or null
    int T, H, stages;
    float scale;
};

__device__ __forceinline__ uint32_t saddr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// the barrier's one producer arrival for its current phase, which then also waits for `bytes`
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of the given parity to complete (the poll loop stays
// inside the asm: a trap path out of it costs the consumers registers).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    asm volatile(
        "{\n\t.reg .pred p;\nWAIT:\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "\t@!p bra WAIT;\n}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
}

// rows [t, t + box rows) of head h, batch b, columns [d0, d0 + 64), into a 128-byte swizzled panel
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, int d0, int h, int t, int b,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
        "[%6];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(t), "r"(b), "r"(bar)
        : "memory");
}

// named barrier `id` (not 0, __syncthreads' own) for n threads
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving uses of wgmma results above the wait, and
// the A fragments of a wgmma in their registers until the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
        asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3])::"memory");
}

// A shared-memory matrix descriptor: 128-byte swizzle, 8-row groups 1024
// bytes apart. K-major operands (rows of 64 k values in a panel) step k by
// adding 32 bytes; an MN-major B of one panel (n = 64) steps k by 16 rows.
// The leading offset is unused by both (set to the same 1024).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
           (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, f32 accumulators: d = A B, or d += A B where scale_d is
// not 0. ss: A and B K-major from shared memory; rs_mn: A from registers, B
// MN-major. Always "+f": distinct asm outputs for a first k step would put
// register moves inside the batch, and ptxas then serialises the wgmmas.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs64_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// S (=, or += where scale_d) Q K^T over one k step, n = BN
template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
    static_assert(BN == 64 || BN == 128, "key tiles of 64 or 128");
    if constexpr (BN == 128) wgmma_ss128(d, a, b, scale_d);
    else wgmma_ss64(d, a, b, scale_d);
}

// x = d of an m64nN accumulator -> the A fragments of its N / 16 k steps
// (the accumulator's layout: d[4j + e] is row g + 8 (e >> 1), column 8j +
// 2 (lane % 4) + (e & 1) of the warp's 16 rows, which is the A layout)
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Class of the pair (query rows [r0, r0 + 64), keys [c0, c0 + bn)) for a row
// of length len: a query or key is segment 1 below len, else 0 (the keys of
// [T, Tp) among them); rows past T are not written, so only [r0, min(r0 +
// 64, T)) count.
__device__ __forceinline__ int tile_class(int r0, int c0, int bn, int len, int T) {
    const int r1 = min(r0 + WG_ROWS, T);
    if (r0 >= r1) return SKIP;
    const bool r_lo = r1 <= len, r_hi = r0 >= len, c_lo = c0 + bn <= len, c_hi = c0 >= len;
    if ((r_lo && c_hi) || (r_hi && c_lo)) return SKIP;
    return ((r_lo && c_lo) || (r_hi && c_hi)) ? WITHIN : MASKED;
}

template <int D, int BN, int WGS>
__global__ void __launch_bounds__(Cfg<D, BN, WGS>::THREADS, 1) fwd_kernel(const __grid_constant__ Params p) {
    using C = Cfg<D, BN, WGS>;
    constexpr int ROWS = C::ROWS;
    constexpr int CHUNKS = D / 64;  // n = 64 pieces of O
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t raw = saddr(smem_raw), base = (raw + 1023) & ~1023u;
    const int stages = p.stages;
    const uint32_t sq = base, skv = base + C::QB;  // stage s: K at skv + s * 2 * KVB, V KVB further
    const uint32_t bars = skv + stages * 2 * C::KVB;  // q, full[stages], empty[stages]

    const int r0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
    const int T = p.T;
    const int len = p.lengths ? p.lengths[b] : T;
    const int n_tiles = (T + 127) / 128 * 128 / BN;

    if (threadIdx.x == 0) {
        mbar_init(bars, 1);
        for (int s = 0; s < stages; ++s) {
            mbar_init(bars + 8 + 8 * s, 1);
            mbar_init(bars + 8 + 8 * (stages + s), WGS * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // a key tile is loaded when any consumer warpgroup needs it
    auto needed = [&](int c) {
        bool any = false;
#pragma unroll
        for (int w = 0; w < WGS; ++w) any = any || tile_class(r0 + w * WG_ROWS, c * BN, BN, len, T) != SKIP;
        return any;
    };
    const int wg = threadIdx.x / 128;

    if (wg == WGS) {  // producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
        if (threadIdx.x == WGS * 128) {
            mbar_expect(bars, C::QB);
#pragma unroll 1
            for (int q = 0; q < C::PANELS; ++q) tma_rows(sq + q * ROWS * 128, &p.q, q * 64, h, r0, b, bars);
            if (kLoads) {
                for (int c = 0, k = 0; c < n_tiles; ++c) {
                    if (!needed(c)) continue;
                    const int s = k % stages, r = k / stages;
                    ++k;
                    const uint32_t full = bars + 8 + 8 * s;
                    if (r > 0) mbar_wait(bars + 8 + 8 * (stages + s), (r - 1) & 1);
                    mbar_expect(full, 2 * C::KVB);
                    const uint32_t y0 = skv + s * 2 * C::KVB, y1 = y0 + C::KVB;
#pragma unroll 1
                    for (int q = 0; q < C::PANELS; ++q) {
                        tma_rows(y0 + q * BN * 128, &p.k, q * 64, h, c * BN, b, full);
                        tma_rows(y1 + q * BN * 128, &p.v, q * 64, h, c * BN, b, full);
                    }
                }
            }
        }
        return;
    }

    // consumer warpgroup wg: query rows [wr0, wr0 + 64); this thread's rows row_a and row_a + 8
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32, tq = lane % 4;
    const int wr0 = r0 + wg * WG_ROWS, row_a = wr0 + warp * 16 + lane / 4;
    const uint32_t xq = sq + wg * WG_ROWS * 128;  // panel q: + q * ROWS * 128
    const float sl2 = p.scale * LOG2E;
    // O starts at the first P V product (scale-d 0), not at zeros written by moves, which ptxas would
    // schedule into a wgmma batch and then serialise the wgmmas. A warpgroup with rows below T has at
    // least one tile that is not skipped; one without writes nothing.
    float o[CHUNKS][32];
    int o_scale = 0;
    // running max of the unscaled logits (a finite floor, so that no difference of two -inf arises),
    // and this thread's share of the row sums
    float mx[2] = {-FLT_MAX, -FLT_MAX}, ls[2] = {0.f, 0.f};

    auto release = [&](int s) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 + 8 * (stages + s));
    };
    // O += P V over the tile in stage s, from P's A fragments in pa, as one commit group
    uint32_t pa[BN / 16][4];
    auto issue_pv = [&](int s) {
        const uint32_t v0 = skv + s * 2 * C::KVB + C::KVB;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) fence_regs(o[ch]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
            for (int ch = 0; ch < CHUNKS; ++ch)
                wgmma_rs64_mn(o[ch], pa[kk], desc(v0 + ch * BN * 128 + kk * 16 * 128), kk > 0 ? 1 : o_scale);
        wgmma_commit();
        o_scale = 1;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) fence_regs(o[ch]);
    };
    auto retire_pv = [&]() {
        wgmma_wait<0>();
        fence_regs(pa);  // P's registers are live until here: nothing may take them earlier
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) fence_regs(o[ch]);
    };
    // S = Q K^T over the tile in stage s, as one commit group (made-up logits without products)
    auto issue_s = [&](float (&sp)[BN / 2], int s, int c0) {
        if (kProducts) {
            const uint32_t k0 = skv + s * 2 * C::KVB;
            fence_regs(sp);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<BN>(sp, desc(xq + (kk / 4) * ROWS * 128 + (kk % 4) * 32),
                             desc(k0 + (kk / 4) * BN * 128 + (kk % 4) * 32), kk > 0);
            wgmma_commit();
            fence_regs(sp);
        } else {
            const float x = (float)(c0 + lane) * 1e-4f;
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sp[i] = x + (float)i * 1e-3f;  // distinct: no folded exps
        }
    };
    // p = exp2(s * scale * log2(e) - m * scale * log2(e)) against the new row max, in place; the row
    // sums; alpha = exp2((m_old - m_new) * scale * log2(e)), 1 where the max did not move
    auto softmax = [&](float (&sp)[BN / 2], int cls, int c0, float (&alpha)[2]) {
        if (!kSoftmax) return;
        if (cls == MASKED) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = c0 + j * 8 + 2 * tq + (e & 1), row = row_a + 8 * (e >> 1);
                    if ((row < len) != (col < len)) sp[4 * j + e] = -INFINITY;
                }
        }
        // row maxima and sums in four independent chains a row (the few warps of an SMSP hide little latency)
        float t4[2][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float x = fmaxf(sp[4 * j + 2 * i], sp[4 * j + 2 * i + 1]);
                t4[i][j % 4] = j < 4 ? x : fmaxf(t4[i][j % 4], x);
            }
        float tm[2], m2[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            tm[i] = fmaxf(fmaxf(t4[i][0], t4[i][1]), fmaxf(t4[i][2], t4[i][3]));
            tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 1));
            tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 2));
            const float mn = fmaxf(mx[i], tm[i]);
            if (mn != mx[i]) alpha[i] = ex2((mx[i] - mn) * sl2);
            mx[i] = mn;
            m2[i] = mn * sl2;
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sp[4 * j + e] = ex2(fmaf(sp[4 * j + e], sl2, -m2[e >> 1]));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                const float x = sp[4 * j + 2 * i] + sp[4 * j + 2 * i + 1];
                t4[i][j % 4] = j < 4 ? x : t4[i][j % 4] + x;
            }
            ls[i] = ls[i] * alpha[i] + ((t4[i][0] + t4[i][1]) + (t4[i][2] + t4[i][3]));
        }
    };
    // Ping-pong: the consumer warpgroups take turns, in a ring, to issue their products (this tile's S,
    // then the previous tile's P V), so that one's softmax runs under the others' products. Each takes
    // one turn per loaded tile and one at the end.
    auto turn_begin = [&]() {
        if (kPingPong) bar_sync(1 + wg, 2 * 128);
    };
    auto turn_end = [&]() {
        if (kPingPong) bar_arrive(1 + (wg + 1) % WGS, 2 * 128);
    };
    if (kPingPong && wg == WGS - 1) bar_arrive(1, 2 * 128);  // warpgroup 0 goes first
    mbar_wait(bars, 0);                                 // Q

    // Every branch below retires its own products before it joins the others: ptxas serialises all the
    // wgmmas of a function in which it cannot see each batch reach its wait on every path.
    int pending = -1;  // the stage whose P V product is not issued yet
    for (int c = 0, k = 0; c < n_tiles; ++c) {
        if (!needed(c)) continue;
        const int s = k % stages, ph = (k / stages) & 1;
        ++k;
        const int c0 = c * BN;
        const int cls = tile_class(wr0, c0, BN, len, T);
        if (kLoads) mbar_wait(bars + 8 + 8 * s, ph);
        turn_begin();
        if (cls == SKIP) {  // the other warpgroup's tile
            if (kProducts && pending >= 0) {
                issue_pv(pending);
                turn_end();
                retire_pv();
            } else {
                turn_end();
            }
            if (kLoads) {
                if (pending >= 0) release(pending);
                release(s);
            }
            pending = -1;
            continue;
        }
        float sp[BN / 2];
        float alpha[2] = {1.f, 1.f};
        if (pending >= 0) {
            issue_s(sp, s, c0);  // this tile's S, then the previous tile's P V: two groups
            if (kProducts) issue_pv(pending);
            turn_end();
            if (kProducts) {
                wgmma_wait<1>();  // S; P V may still run
                fence_regs(sp);
            }
            softmax(sp, cls, c0, alpha);
            if (kProducts) retire_pv();
            if (kLoads) release(pending);
            // O is relative to the old max: rescale it where a row's max moved (in any row of the warp)
            if (kSoftmax && __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
                for (int ch = 0; ch < CHUNKS; ++ch)
#pragma unroll
                    for (int i = 0; i < 32; ++i) o[ch][i] *= alpha[(i >> 1) & 1];
            }
        } else {  // the first tile, or the first after a skipped one (O holds no product, or its own max)
            issue_s(sp, s, c0);
            turn_end();
            if (kProducts) {
                wgmma_wait<0>();
                fence_regs(sp);
            }
            softmax(sp, cls, c0, alpha);
            if (kSoftmax && o_scale && __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
                for (int ch = 0; ch < CHUNKS; ++ch)
#pragma unroll
                    for (int i = 0; i < 32; ++i) o[ch][i] *= alpha[(i >> 1) & 1];
            }
        }
        to_a<BN>(pa, sp);
        pending = s;
    }
    turn_begin();
    if (kProducts && pending >= 0) {
        issue_pv(pending);
        if (wg != WGS - 1) turn_end();  // the last warpgroup made one arrival ahead at the start
        retire_pv();
    } else if (wg != WGS - 1) {
        turn_end();
    }

    // l over the quad's columns, in a fixed order; then O / l, and m, l for the backward
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
    }
    const float inv[2] = {1.f / ls[0], 1.f / ls[1]};
    if (p.m != nullptr && tq == 0) {  // (B, H, T) f32
        const long long r = ((long long)b * p.H + h) * T;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = row_a + 8 * i;
            if (row < T) {
                p.m[r + row] = mx[i] * p.scale;
                p.l[r + row] = ls[i];
            }
        }
    }
    // out: contiguous (B, T, H, D)
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int row = row_a + 8 * i;
                if (row < T)
                    *reinterpret_cast<uint32_t*>(p.out + (((long long)b * T + row) * p.H + h) * D + ch * 64 + j * 8 +
                                                 2 * tq) =
                        pack_bf16(o[ch][4 * j + 2 * i] * inv[i], o[ch][4 * j + 2 * i + 1] * inv[i]);
            }
}

// --- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (the library links no libcuda)
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(f);
    }
    return fn;
}

// bf16 (B, T, H, D) through its (batch, time, head) element strides, as (D,
// H, T, B) with boxes of 64 columns x `rows` rows, 128-byte swizzled
bool map_rows(CUtensorMap* map, const void* x, int B, int T, int H, int D, const long long* s, int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2, (cuuint64_t)s[0] * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1}, one[4] = {1, 1, 1, 1};
    return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, one,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BN, int WGS>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out, void* m, void* l, int B,
           int T, int H, const long long* s, float scale, int stages, int smem, cudaStream_t stream) {
    using C = Cfg<D, BN, WGS>;
    if (stages < 2 || smem != C::smem(stages) || smem > 232448) return (int)cudaErrorInvalidValue;
    if ((m == nullptr) != (l == nullptr)) return (int)cudaErrorInvalidValue;
    if (!encoder()) return (int)cudaErrorSymbolNotFound;
    auto kernel = fwd_kernel<D, BN, WGS>;
    static bool ready = false;  // checked and configured once per instance
    if (!ready) {
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return (int)err;
        // setmaxnreg hands the producer's registers to the consumers: the CTA must start with all it may have
        if (attr.numRegs != C::KERNEL_REGS) return (int)cudaErrorInvalidDeviceFunction;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    Params p;
    memset(&p, 0, sizeof(p));
    if (!(map_rows(&p.q, q, B, T, H, D, s, C::ROWS) && map_rows(&p.k, k, B, T, H, D, s + 3, BN) &&
          map_rows(&p.v, v, B, T, H, D, s + 6, BN)))
        return (int)cudaErrorInvalidValue;
    p.lengths = lengths;
    p.out = static_cast<bf16*>(out);
    p.m = static_cast<float*>(m);
    p.l = static_cast<float*>(l);
    p.T = T;
    p.H = H;
    p.stages = stages;
    p.scale = scale;
    dim3 grid((T + C::ROWS - 1) / C::ROWS, H, B);
    kernel<<<grid, C::THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (B, T, H, D) with element strides (batch, time, head) in
// `strides` (q's three, then k's, v's), a contiguous last dimension and
// 16-byte aligned rows; lengths: int32 (B,) or null (no mask: every row is
// T long); out: contiguous bf16 (B, T, H, D); m, l: f32 (B, H, T), both null
// or both set (the row max and row sum, for the backward); rows, stages and
// smem: the kernel's plan (ops/flash_attention.py flash_fwd_plan: query rows
// per CTA, ring depth, shared bytes), checked here; the key tile follows
// from D (128 keys at D = 64 and 128, 64 at 256). Returns a cudaError_t.
extern "C" int ssak_flash_attention_fwd(const void* q, const void* k, const void* v, const void* lengths, void* out,
                                        void* m, void* l, int B, int T, int H, int D, const long long* strides,
                                        float scale, int rows, int stages, int smem, void* stream) {
    const int* lens = static_cast<const int*>(lengths);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 64 && rows == WGS_64 * WG_ROWS)
        return launch<64, 128, WGS_64>(q, k, v, lens, out, m, l, B, T, H, strides, scale, stages, smem, st);
    if (D == 128 && rows == 128)
        return launch<128, 128, 2>(q, k, v, lens, out, m, l, B, T, H, strides, scale, stages, smem, st);
    if (D == 256 && rows == 128)
        return launch<256, 64, 2>(q, k, v, lens, out, m, l, B, T, H, strides, scale, stages, smem, st);
    return (int)cudaErrorInvalidValue;
}
