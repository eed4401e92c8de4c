// Segment-masked flash self-attention, backward (kernel L1's dK/dV and dQ),
// for Hopper (sm_90a).
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
// and the ~7 f32 operations per (i, j) ~0.65 ms at 67 TFLOP/s: both under
// the tensor-core time, if they overlap it. The bytes (q, k, v, dO, m, l, di
// read once; dq, dk, dv written once, ~0.4 GB) take ~0.1 ms.
//
// Design. Both kernels are one template, `bwd_kernel<D, WALK, DQ>`. A CTA
// owns 128 rows (keys for dK/dV, queries for dQ; (k, v) or (q, dO) staged
// once) and walks the other side (q, dO, m, l, di for dK/dV; k, v for dQ)
// in tiles of WALK rows. It has 384 threads: two consumer warpgroups of 64
// own rows each, and a producer warpgroup (setmaxnreg moves registers from
// it, 56 a thread, to the consumers, 224). One producer thread keeps a ring
// of `stages` walked tiles in flight; for dK/dV two producer warps turn each
// tile's m, l, di into per-column m * log2(e), 1 / l and di. The plan
// (rows, walk, stages, shared bytes, grid) comes from
// ops/flash_attention.py `flash_bwd_plan`, which the entry points check.
// Against the four limits of the previous design (16-row mma.sync warps fed
// by ldmatrix, a 2-stage cp.async ring, every tile computed, dQ recomputing
// S and dP):
//  1. Shared-memory traffic. Every product is a wgmma m64nNk16 of a 64-row
//     warpgroup, whose shared operands are read through descriptors of
//     128-byte swizzled panels (64 bf16 columns each) as TMA writes them:
//     each B tile is read once a warpgroup, where four 16-row warps read it
//     four times. At D = 64 the own rows' A fragments are loaded once into
//     registers (ldmatrix through the swizzle), so S^T = K Q^T and dP^T =
//     V dO^T (dQ: S = Q K^T, dP = dO V^T) read only their B from shared
//     memory; at D = 128 and 256, A comes from shared memory too. P^T and
//     dS^T are packed to bf16 in registers, where the accumulator layout is
//     the A-fragment layout, and are the register A operand of dV += P^T dO
//     and dK += dS^T Q (dQ: dQ += dS K), whose B (the walked rows are the k
//     dimension) is MN-major, read with the transpose flag, as n = 64
//     pieces of one panel each.
//  2. Overlap. Loads are TMA (tensor maps over the (batch, time, head)
//     strides, so the fused-qkv view is read in place; rows past T arrive
//     as zeros) completing on mbarriers and released per warp: no
//     block-wide barrier in the loop. The two consumer warpgroups take turns
//     (ping-pong on two named barriers) to issue their products: the
//     previous tile's gradient products, then S and dP, committed as
//     separate groups; while one warpgroup runs exp and ds, the other's
//     products run, and exp runs while its own dP is still in flight.
//     scale * log2(e) is folded into the logits, so p takes one ex2.approx
//     (the plain version keeps torch.exp; the 2e-2 limit covers it).
//  3. Work that gives zero. A (own 64 rows, walked tile) pair is, from the
//     row's length: wholly across segments (p = exp(x - 0.7 FLT_MAX - m) is
//     exactly 0, so ds is too and the sums would add exact zeros): skipped,
//     and not even loaded when both warpgroups skip it; wholly within one
//     segment: no per-element mask; straddling len, or past T: masked. A
//     row of length 0 or T has no cross tiles. `tile_class` is mirrored by
//     ops/flash_attention.py `flash_bwd_tile_class`.
//  4. dQ still recomputes S and dP (14 units of T^2 D work for the pair
//     against 10 fused): the library's split, the only one that needs no
//     sum across CTAs.
// No atomics: each gradient element is summed by one thread's wgmma
// accumulator in a fixed tile order, so repeats are bit-identical. Four
// things the H100 and ptxas showed: no instruction may write an
// accumulator between the wgmmas of a batch and their wait (the gradient
// sums start by scale-d 0 on the first tile, not from zeros written by
// moves, around which ptxas serialises the wgmmas); a tile's gradient
// products are issued at the start of the warpgroup's next turn, just
// ahead of S and dP (issued at the end of the tile, in flight across the
// next tile's barrier waits, they gave wrong gradients whenever the own
// rows' A fragments were held in registers); the registers of a register A
// operand are kept live until the wait that retires its wgmma
// (fence_regs); and no trap path in the barrier waits (it made ptxas spill).
// D = 128 and 256 use the same design with WALK = 32 (dQ at 128: 64); at
// D = 256 dK/dV splits its output columns over two CTAs (the f32
// accumulators of all 256 would not fit; S and dP are computed in both).
// Tuned for D = 64, the head width of every model on the port's paths.
//
// The switches below cut the kernel down for tools/torch_flash_bwd_variants.py;
// they are all true here.

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr bool kLoads = true;        // the walked tiles' TMA ring
constexpr bool kProducts = true;     // the wgmma products
constexpr bool kElementwise = true;  // exp, ds and the mask
constexpr bool kPingPong = true;     // the consumer warpgroups take turns to issue their products

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 128;      // a CTA's own rows
constexpr int WG_ROWS = 64;    // rows of one consumer warpgroup
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // setmaxnreg; 56*128 + 224*256 = 168*384
constexpr int KERNEL_REGS = 168;                        // what __launch_bounds__(384, 1) allows
constexpr float LOG2E = 1.4426950408889634f;
enum { SKIP = 0, WITHIN = 1, MASKED = 2 };

// Shared memory, from a 1024-byte aligned base: the own operands (128 rows,
// D / 64 panels of 128-byte rows each), then `stages` walked stages (two
// operands of WALK rows), then (dK/dV) each stage's m, l, di (boxes of
// WALK + 4 values from the 16-byte aligned element at or below the tile's
// first, as TMA wants its global start) and its per-column m * log2(e),
// 1 / l and di, then the mbarriers (own, full[stages], empty[stages], and
// for dK/dV ready[stages]: the per-column values are written).
template <int D, int WALK, bool DQ>
struct Cfg {
    static constexpr int PANELS = D / 64;
    static constexpr int SPLIT = (!DQ && D == 256) ? 2 : 1;  // CTAs sharing a key tile's output columns
    static constexpr int CHUNKS = D / SPLIT / 64;             // n = 64 pieces of a CTA's output columns
    static constexpr bool OWN_REGS = D == 64;                 // the own rows' A fragments held in registers
    static constexpr int OWN = ROWS * D * 2;
    static constexpr int WALKB = WALK * D * 2;
    static constexpr int VEC = WALK + 4;                       // values of one m, l or di box
    static constexpr int VEC_BYTES = (VEC * 4 + 127) / 128 * 128;  // its shared slot
    static constexpr int STATS = DQ ? 0 : 3 * VEC_BYTES;
    static constexpr int PREP = DQ ? 0 : 3 * WALK * 4;  // per stage
    static constexpr int BARS = DQ ? 2 : 3;             // per stage
    static constexpr int smem(int stages) {
        return 1024 + 2 * OWN + stages * (2 * WALKB + STATS + PREP + 8 * BARS) + 8;
    }
};

struct Params {
    CUtensorMap own0, own1, walk0, walk1;  // bf16 (D, H, T, B) boxes of 64 x 1 x rows x 1
    CUtensorMap m, l, di;                  // f32 (B*H*T) boxes of WALK + 4 (dK/dV)
    const float *gm, *gl, *gdi;            // f32 (B, H, T) (dQ reads its own rows' directly)
    const int* lengths;
    bf16 *out0, *out1;                     // dK/dV: dk, dv; dQ: dq
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

// a box of consecutive f32 values from element x (zeros past the end)
__device__ __forceinline__ void tma_vec(uint32_t dst, const CUtensorMap* map, int x, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(bar)
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
// not 0. ss: A and B K-major from shared memory; rs: A from registers, B
// K-major (_k) or MN-major (_mn). Always "+f": distinct asm outputs for a
// first k step would put register moves inside the batch, and ptxas then
// serialises the wgmmas.
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
}

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

__device__ __forceinline__ void wgmma_rs32_k(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs64_k(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
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

// d (=, or += where scale_d) A B over the k step; A from registers where the
// own rows are held there, else from shared memory; B K-major
template <int N>
__device__ __forceinline__ void first_product(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t da, uint64_t b,
                                              int scale_d, bool a_regs) {
    static_assert(N == 32 || N == 64, "walked tiles of 32 or 64 rows");
    if (a_regs) {
        if constexpr (N == 64) wgmma_rs64_k(d, a, b, scale_d); else wgmma_rs32_k(d, a, b, scale_d);
    } else {
        if constexpr (N == 64) wgmma_ss64(d, da, b, scale_d); else wgmma_ss32(d, da, b, scale_d);
    }
}

// The A fragments of a warpgroup's 64 own rows at x (K-major 128-byte
// swizzled panels of ROWS rows), every k step, by ldmatrix
template <int D>
__device__ __forceinline__ void load_own(uint32_t (&a)[D / 16][4], uint32_t x, int warp, int lane) {
    const int row = warp * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int chunk = (kk % 4) * 2 + (lane >> 4);  // 16-byte chunk of the 128-byte row, before the swizzle
        const uint32_t addr = x + (kk / 4) * ROWS * 128 + row * 128 + ((chunk ^ (row & 7)) << 4);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                     : "r"(addr));
    }
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

// Class of the pair (own rows [r0, r0 + 64), walked rows [c0, c0 + walk))
// for a row of length len: rows past T are pad (their own gradients are not
// written; walked ones are zero), so a walked tile past T is masked.
__device__ __forceinline__ int tile_class(int r0, int c0, int walk, int len, int T) {
    const int r1 = min(r0 + WG_ROWS, T), c1 = min(c0 + walk, T);
    if (r0 >= r1) return SKIP;
    const bool r_lo = r1 <= len, r_hi = r0 >= len, c_lo = c1 <= len, c_hi = c0 >= len;
    if ((r_lo && c_hi) || (r_hi && c_lo)) return SKIP;
    if (c0 + walk > T) return MASKED;
    return ((r_lo && c_lo) || (r_hi && c_hi)) ? WITHIN : MASKED;
}

// p = exp2(s * scale * log2(e) - m * log2(e)) * (1 / l), 0 across segments
// and past T where MASKED (into registers of its own: s is a wgmma
// accumulator, written by nothing else while dP is in flight). Columns are walked rows from c0; the
// thread's rows are row_a and row_a + 8. dK/dV: rows are keys, columns
// queries, m and 1/l per column (cm, cil); dQ: rows are queries (rm, ril).
template <int WALK, bool DQ, bool MASKED_TILE>
__device__ __forceinline__ void tile_p(float (&pv)[WALK / 2], const float (&s)[WALK / 2], const float* cm,
                                       const float* cil,
                                       const float (&rm)[2], const float (&ril)[2], float sl2, int row_a, int c0,
                                       int tq, int len, int T) {
#pragma unroll
    for (int j = 0; j < WALK / 8; ++j) {
        float2 m2 = make_float2(rm[0], rm[0]), il = make_float2(ril[0], ril[0]);
        if (!DQ) {
            m2 = *reinterpret_cast<const float2*>(cm + j * 8 + 2 * tq);
            il = *reinterpret_cast<const float2*>(cil + j * 8 + 2 * tq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float mv = DQ ? rm[e >> 1] : ((e & 1) ? m2.y : m2.x);
            const float iv = DQ ? ril[e >> 1] : ((e & 1) ? il.y : il.x);
            float p = ex2(fmaf(s[4 * j + e], sl2, -mv)) * iv;
            if (MASKED_TILE) {
                const int col = c0 + j * 8 + 2 * tq + (e & 1), row = row_a + 8 * (e >> 1);
                const int qi = DQ ? row : col, kj = DQ ? col : row;
                if (!(col < T && ((qi < len) == (kj < len)))) p = 0.f;
            }
            pv[4 * j + e] = p;
        }
    }
}

// dp := ((dp - di) * p) * scale; di per column (cdi, dK/dV) or per row (rdi, dQ)
template <int WALK, bool DQ>
__device__ __forceinline__ void tile_ds(float (&dp)[WALK / 2], const float (&p)[WALK / 2], const float* cdi,
                                        const float (&rdi)[2], float scale, int tq) {
#pragma unroll
    for (int j = 0; j < WALK / 8; ++j) {
        float2 d2 = make_float2(rdi[0], rdi[0]);
        if (!DQ) d2 = *reinterpret_cast<const float2*>(cdi + j * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float dv = DQ ? rdi[e >> 1] : ((e & 1) ? d2.y : d2.x);
            dp[4 * j + e] = ((dp[4 * j + e] - dv) * p[4 * j + e]) * scale;
        }
    }
}

template <int D, int WALK, bool DQ>
__global__ void __launch_bounds__(THREADS, 1) bwd_kernel(const __grid_constant__ Params p) {
    using C = Cfg<D, WALK, DQ>;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t raw = saddr(smem_raw), base = (raw + 1023) & ~1023u;
    unsigned char* const sbase = smem_raw + (base - raw);
    const int stages = p.stages;
    const uint32_t sx0 = base, sx1 = base + C::OWN, sy = base + 2 * C::OWN;  // stage s: sy + s * 2 * WALKB
    const uint32_t sst = sy + stages * 2 * C::WALKB;                       // stage s: m, l, di at sst + s * STATS
    float* const prep = reinterpret_cast<float*>(sbase + (sst - base) + stages * C::STATS);  // stage s: + s * 3 * WALK
    const uint32_t bars = sst + stages * (C::STATS + C::PREP);  // own, full[stages], empty[stages], ready[stages]
    const uint32_t own_full = bars;

    const int tile = blockIdx.x / C::SPLIT, col0 = (blockIdx.x % C::SPLIT) * (D / C::SPLIT);
    const int r0 = tile * ROWS, h = blockIdx.y, b = blockIdx.z;
    const int T = p.T;
    const int len = p.lengths ? p.lengths[b] : T;
    const int n_walk = (T + WALK - 1) / WALK;

    if (threadIdx.x == 0) {
        mbar_init(own_full, 1);
        for (int s = 0; s < stages; ++s) {
            mbar_init(bars + 8 + 8 * s, 1);
            mbar_init(bars + 8 + 8 * (stages + s), CONSUMERS * 4);
            if (!DQ) mbar_init(bars + 8 + 8 * (2 * stages + s), 2);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // a walked tile is loaded when either consumer warpgroup needs it
    auto needed = [&](int c) {
        return tile_class(r0, c * WALK, WALK, len, T) != SKIP ||
               tile_class(r0 + WG_ROWS, c * WALK, WALK, len, T) != SKIP;
    };
    const int wg = threadIdx.x / 128;

    if (wg == CONSUMERS) {  // producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        const int pt = threadIdx.x - CONSUMERS * 128;
        if (!DQ && kElementwise && kLoads && pt >= 32 && pt < 96) {
            // warps 1-2: each loaded tile's per-column m * log2(e), 1 / l and di, from its m, l, di boxes
            const int row0 = (b * p.H + h) * T;
            for (int c = 0, k = 0; c < n_walk; ++c) {
                if (!needed(c)) continue;
                const int s = k % stages, ph = (k / stages) & 1;
                ++k;
                mbar_wait(bars + 8 + 8 * s, ph);
                const float* st = reinterpret_cast<const float*>(sbase + (sst - base) + s * C::STATS);
                float* w = prep + s * 3 * WALK;
                const int off = (row0 + c * WALK) & 3;  // the tile's first column in the aligned boxes
                for (int i = pt - 32; i < WALK; i += 64) {
                    w[i] = st[off + i] * LOG2E;
                    w[WALK + i] = 1.f / st[C::VEC_BYTES / 4 + off + i];
                    w[2 * WALK + i] = st[C::VEC_BYTES / 2 + off + i];
                }
                __syncwarp();
                if (pt % 32 == 0) mbar_arrive(bars + 8 + 8 * (2 * stages + s));
            }
        }
        if (threadIdx.x == CONSUMERS * 128) {
            mbar_expect(own_full, 2 * C::OWN);
#pragma unroll 1
            for (int q = 0; q < C::PANELS; ++q) {
                tma_rows(sx0 + q * ROWS * 128, &p.own0, q * 64, h, r0, b, own_full);
                tma_rows(sx1 + q * ROWS * 128, &p.own1, q * 64, h, r0, b, own_full);
            }
            if (kLoads) {
                const int row0 = (b * p.H + h) * T;
                for (int c = 0, k = 0; c < n_walk; ++c) {
                    if (!needed(c)) continue;
                    const int s = k % stages, r = k / stages;
                    ++k;
                    const uint32_t full = bars + 8 + 8 * s;
                    if (r > 0) mbar_wait(bars + 8 + 8 * (stages + s), (r - 1) & 1);
                    mbar_expect(full, 2 * C::WALKB + (DQ ? 0 : 3 * C::VEC * 4));
                    const uint32_t y0 = sy + s * 2 * C::WALKB, y1 = y0 + C::WALKB;
#pragma unroll 1
                    for (int q = 0; q < C::PANELS; ++q) {
                        tma_rows(y0 + q * WALK * 128, &p.walk0, q * 64, h, c * WALK, b, full);
                        tma_rows(y1 + q * WALK * 128, &p.walk1, q * 64, h, c * WALK, b, full);
                    }
                    if (!DQ) {
                        const uint32_t st = sst + s * C::STATS;
                        const int x = (row0 + c * WALK) & ~3;
                        tma_vec(st, &p.m, x, full);
                        tma_vec(st + C::VEC_BYTES, &p.l, x, full);
                        tma_vec(st + 2 * C::VEC_BYTES, &p.di, x, full);
                    }
                }
            }
        }
        return;
    }

    // consumer warpgroup wg: own rows [wr0, wr0 + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32, tq = lane % 4;
    const int wr0 = r0 + wg * WG_ROWS, row_a = wr0 + warp * 16 + lane / 4;
    const uint32_t x0 = sx0 + wg * WG_ROWS * 128, x1 = sx1 + wg * WG_ROWS * 128;  // panel q: + q * ROWS * 128
    const float sl2 = p.scale * LOG2E;
    float rm[2] = {0.f, 0.f}, ril[2] = {0.f, 0.f}, rdi[2] = {0.f, 0.f};  // dQ: the thread's two rows (0 past T)
    if (DQ) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = row_a + 8 * i;
            if (row < T) {
                const long long o = ((long long)b * p.H + h) * T + row;
                rm[i] = p.gm[o] * LOG2E;
                ril[i] = 1.f / p.gl[o];
                rdi[i] = p.gdi[o];
            }
        }
    }
    // acc0: dS.Y0 (dK/dV: dK += dS^T Q; dQ: dQ += dS K); acc1: dV += P^T dO (dK/dV). They start at the
    // first tile's products (scale-d 0), not at zeros written by moves, which ptxas would schedule into a
    // wgmma batch and then serialise the wgmmas. A warpgroup with rows below T has at least one tile that
    // is not skipped; one without writes nothing.
    float acc0[C::CHUNKS][32], acc1[DQ ? 1 : C::CHUNKS][32];
    int acc_scale = 0;

    auto release = [&](int s) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 + 8 * (stages + s));
    };
    mbar_wait(own_full, 0);
    uint32_t xa0[C::OWN_REGS ? D / 16 : 1][4], xa1[C::OWN_REGS ? D / 16 : 1][4];
    if constexpr (C::OWN_REGS) {
        load_own<D>(xa0, x0, warp, lane);
        load_own<D>(xa1, x1, warp, lane);
    }
    // The previous tile's dK/dV (dQ) products, from its P and dS fragments in pa and da
    uint32_t pa[WALK / 16][4], da[WALK / 16][4];
    auto issue_grads = [&](int s) {
        const uint32_t y0 = sy + s * 2 * C::WALKB, y1 = y0 + C::WALKB;
#pragma unroll
        for (int ch = 0; ch < C::CHUNKS; ++ch) {
            fence_regs(acc0[ch]);
            if (!DQ) fence_regs(acc1[DQ ? 0 : ch]);
        }
        wgmma_fence();
        // dK/dV: dK += dS^T Q, dV += P^T dO; dQ: dQ += dS K; B MN-major, one panel per n = 64 piece
#pragma unroll
        for (int kk = 0; kk < WALK / 16; ++kk)
#pragma unroll
            for (int ch = 0; ch < C::CHUNKS; ++ch) {
                const uint32_t off = (col0 / 64 + ch) * WALK * 128 + kk * 16 * 128;
                wgmma_rs64_mn(acc0[ch], da[kk], desc(y0 + off), kk > 0 ? 1 : acc_scale);
                if (!DQ) wgmma_rs64_mn(acc1[DQ ? 0 : ch], pa[kk], desc(y1 + off), kk > 0 ? 1 : acc_scale);
            }
        wgmma_commit();
        acc_scale = 1;
#pragma unroll
        for (int ch = 0; ch < C::CHUNKS; ++ch) {
            fence_regs(acc0[ch]);
            if (!DQ) fence_regs(acc1[DQ ? 0 : ch]);
        }
    };
    // Ping-pong: the two consumer warpgroups take turns to issue their products (the previous tile's
    // gradient products, then S and dP), so that one's exp and ds run under the other's products.
    // Both take one turn per loaded tile and one at the end.
    auto turn_begin = [&]() {
        if (kPingPong) bar_sync(1 + wg, 2 * 128);
    };
    auto turn_end = [&]() {
        if (kPingPong) bar_arrive(1 + (wg ^ 1), 2 * 128);
    };
    if (kPingPong && wg == 1) bar_arrive(1, 2 * 128);  // warpgroup 0 goes first

    int pending = -1;  // the stage whose gradient products are not issued yet
    for (int c = 0, k = 0; c < n_walk; ++c) {
        if (!needed(c)) continue;
        const int s = k % stages, ph = (k / stages) & 1;
        ++k;
        const int c0 = c * WALK;
        const int cls = tile_class(wr0, c0, WALK, len, T);
        if (kLoads) mbar_wait(bars + 8 + 8 * s, ph);
        if (!DQ && kElementwise && kLoads) mbar_wait(bars + 8 + 8 * (2 * stages + s), ph);  // its column values
        turn_begin();
        if (kProducts && pending >= 0) issue_grads(pending);
        if (cls == SKIP) {  // the other warpgroup's tile
            turn_end();
            if (kProducts) {
                wgmma_wait<0>();
                fence_regs(pa);
                fence_regs(da);
            }
            if (kLoads) {
                if (pending >= 0) release(pending);
                release(s);
            }
            pending = -1;
            continue;
        }
        const uint32_t y0 = sy + s * 2 * C::WALKB, y1 = y0 + C::WALKB;
        const float* cm = prep + s * 3 * WALK;  // dK/dV: the tile's m * log2(e), 1 / l, di per column

        // S = X0 Y0^T and dP = X1 Y1^T (dK/dV: S^T = K Q^T, dP^T = V dO^T), two groups
        float sp[WALK / 2], dp[WALK / 2];
        if (kProducts) {
            fence_regs(sp);
            fence_regs(dp);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                first_product<WALK>(sp, xa0[C::OWN_REGS ? kk : 0], desc(x0 + (kk / 4) * ROWS * 128 + (kk % 4) * 32),
                                    desc(y0 + (kk / 4) * WALK * 128 + (kk % 4) * 32), kk > 0, C::OWN_REGS);
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                first_product<WALK>(dp, xa1[C::OWN_REGS ? kk : 0], desc(x1 + (kk / 4) * ROWS * 128 + (kk % 4) * 32),
                                    desc(y1 + (kk / 4) * WALK * 128 + (kk % 4) * 32), kk > 0, C::OWN_REGS);
            wgmma_commit();
            fence_regs(sp);
            fence_regs(dp);
        } else {
#pragma unroll
            for (int i = 0; i < WALK / 2; ++i) sp[i] = dp[i] = 0.f;
        }
        turn_end();
        if (kProducts) {
            wgmma_wait<1>();  // the previous tile's gradient products, and S
            fence_regs(sp);
            fence_regs(pa);  // their A fragments are live until here: nothing may take their registers earlier
            fence_regs(da);
        }
        if (kLoads && pending >= 0) release(pending);

        float pv[WALK / 2];
        if (kElementwise) {
            if (cls == MASKED)
                tile_p<WALK, DQ, true>(pv, sp, cm, cm + WALK, rm, ril, sl2, row_a, c0, tq, len, T);
            else
                tile_p<WALK, DQ, false>(pv, sp, cm, cm + WALK, rm, ril, sl2, row_a, c0, tq, len, T);
        } else {
#pragma unroll
            for (int i = 0; i < WALK / 2; ++i) pv[i] = sp[i];
        }
        if (!DQ) to_a<WALK>(pa, pv);
        if (kProducts) {
            wgmma_wait<0>();  // dP
            fence_regs(dp);
        }
        if (kElementwise) tile_ds<WALK, DQ>(dp, pv, cm + 2 * WALK, rdi, p.scale, tq);
        to_a<WALK>(da, dp);
        pending = s;
    }
    turn_begin();
    if (kProducts && pending >= 0) issue_grads(pending);
    if (wg == 0) turn_end();  // warpgroup 1 made one arrival ahead at the start
    if (kProducts) {
        wgmma_wait<0>();
        fence_regs(pa);
        fence_regs(da);
    }
#pragma unroll
    for (int ch = 0; ch < C::CHUNKS; ++ch) {
        fence_regs(acc0[ch]);
        if (!DQ) fence_regs(acc1[DQ ? 0 : ch]);
    }

    // dk, dv (dK/dV) or dq: contiguous (B, T, H, D)
#pragma unroll
    for (int ch = 0; ch < C::CHUNKS; ++ch)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int row = row_a + 8 * i;
                if (row < T) {
                    const long long o = (((long long)b * T + row) * p.H + h) * D + col0 + ch * 64 + j * 8 + 2 * tq;
                    *reinterpret_cast<uint32_t*>(p.out0 + o) =
                        pack_bf16(acc0[ch][4 * j + 2 * i], acc0[ch][4 * j + 2 * i + 1]);
                    if (!DQ)
                        *reinterpret_cast<uint32_t*>(p.out1 + o) =
                            pack_bf16(acc1[DQ ? 0 : ch][4 * j + 2 * i], acc1[DQ ? 0 : ch][4 * j + 2 * i + 1]);
                }
            }
}

// --- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (the library links no libcuda)
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

// f32 vector of n values with boxes of `box`
bool map_vec(CUtensorMap* map, const void* x, long long n, int box) {
    const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {4};
    const cuuint32_t boxd[1] = {(cuuint32_t)box}, one[1] = {1};
    return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(x), dims, strides, boxd, one,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
    const void *q, *k, *v, *dout, *m, *l, *di;
    const int* lengths;
    int B, T, H, D;
    const long long* s;  // (batch, time, head) element strides of q, k, v, dO
    float scale;
    int walk, stages, smem;
    cudaStream_t stream;
};

template <int D, int WALK, bool DQ>
int launch(const Args& a, void* out0, void* out1) {
    using C = Cfg<D, WALK, DQ>;
    const int smem = C::smem(a.stages);
    if (a.stages < 2 || smem != a.smem || smem > 232448) return (int)cudaErrorInvalidValue;
    if (!encoder()) return (int)cudaErrorSymbolNotFound;
    auto kernel = bwd_kernel<D, WALK, DQ>;
    static bool ready = false;  // checked and configured once per instance
    if (!ready) {
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return (int)err;
        // setmaxnreg hands the producer's registers to the consumers: the CTA must start with 168 a thread
        if (attr.numRegs != KERNEL_REGS) return (int)cudaErrorInvalidDeviceFunction;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    Params p;
    memset(&p, 0, sizeof(p));
    // own rows: k, v (dK/dV) or q, dO (dQ); walked: q, dO or k, v
    const void* own[2] = {DQ ? a.q : a.k, DQ ? a.dout : a.v};
    const void* walk[2] = {DQ ? a.k : a.q, DQ ? a.v : a.dout};
    const long long* own_s[2] = {DQ ? a.s : a.s + 3, DQ ? a.s + 9 : a.s + 6};
    const long long* walk_s[2] = {DQ ? a.s + 3 : a.s, DQ ? a.s + 6 : a.s + 9};
    bool ok = map_rows(&p.own0, own[0], a.B, a.T, a.H, D, own_s[0], ROWS) &&
              map_rows(&p.own1, own[1], a.B, a.T, a.H, D, own_s[1], ROWS) &&
              map_rows(&p.walk0, walk[0], a.B, a.T, a.H, D, walk_s[0], WALK) &&
              map_rows(&p.walk1, walk[1], a.B, a.T, a.H, D, walk_s[1], WALK);
    const long long n = (long long)a.B * a.H * a.T;
    if (!DQ)
        ok = ok && map_vec(&p.m, a.m, n, C::VEC) && map_vec(&p.l, a.l, n, C::VEC) && map_vec(&p.di, a.di, n, C::VEC);
    if (!ok) return (int)cudaErrorInvalidValue;
    p.gm = static_cast<const float*>(a.m);
    p.gl = static_cast<const float*>(a.l);
    p.gdi = static_cast<const float*>(a.di);
    p.lengths = a.lengths;
    p.out0 = static_cast<bf16*>(out0);
    p.out1 = static_cast<bf16*>(out1);
    p.T = a.T;
    p.H = a.H;
    p.stages = a.stages;
    p.scale = a.scale;
    dim3 grid((a.T + ROWS - 1) / ROWS * C::SPLIT, a.H, a.B);
    kernel<<<grid, THREADS, smem, a.stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout: bf16 (B, T, H, D) with element strides (batch, time, head)
// in `strides` (q's three, then k's, v's, dout's), a contiguous last
// dimension and 16-byte aligned rows; m, l, di: contiguous f32 (B, H, T);
// lengths: int32 (B,) or null (no mask); dk, dv (dkv) and dq (dq):
// contiguous bf16 (B, T, H, D); walk, stages and smem: the kernel's plan
// (ops/flash_attention.py flash_bwd_plan), checked here. Each returns a
// cudaError_t.
extern "C" int ssak_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                            const void* m, const void* l, const void* di, const void* lengths,
                                            void* dk, void* dv, int B, int T, int H, int D,
                                            const long long* strides, float scale, int walk, int stages, int smem,
                                            void* stream) {
    const Args a{q, k, v, dout, m, l, di, static_cast<const int*>(lengths), B, T, H, D, strides, scale,
                 walk, stages, smem, static_cast<cudaStream_t>(stream)};
    if (D == 64 && walk == 64) return launch<64, 64, false>(a, dk, dv);
    if (D == 64 && walk == 32) return launch<64, 32, false>(a, dk, dv);
    if (D == 128 && walk == 32) return launch<128, 32, false>(a, dk, dv);
    if (D == 256 && walk == 32) return launch<256, 32, false>(a, dk, dv);
    return (int)cudaErrorInvalidValue;
}

extern "C" int ssak_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                           const void* m, const void* l, const void* di, const void* lengths,
                                           void* dq, int B, int T, int H, int D, const long long* strides,
                                           float scale, int walk, int stages, int smem, void* stream) {
    const Args a{q, k, v, dout, m, l, di, static_cast<const int*>(lengths), B, T, H, D, strides, scale,
                 walk, stages, smem, static_cast<cudaStream_t>(stream)};
    if (D == 64 && walk == 64) return launch<64, 64, true>(a, dq, nullptr);
    if (D == 64 && walk == 32) return launch<64, 32, true>(a, dq, nullptr);
    if (D == 128 && walk == 64) return launch<128, 64, true>(a, dq, nullptr);
    if (D == 256 && walk == 32) return launch<256, 32, true>(a, dq, nullptr);
    return (int)cudaErrorInvalidValue;
}
