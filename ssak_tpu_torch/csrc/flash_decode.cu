// Fused single-query decode attention over an index range (flash-decode, K4).
//
//   l[t] = (q . k[:, t]) [* ks[t]]            f32 sums; masked to -1e30 outside [lo, hi]
//   p[t] = exp(l[t] - max_t l)
//   o[d] = sum_t bf16(p[t] [* vs[t]]) * v[d, t] / sum_t p[t]
//
// Replaces: ssak_tpu/ops/flash_decode.py, `flash_decode_attention` (Pallas
// kernels `_make_kernel_plain` and `_make_kernel_int8`). One template for
// both: K/V in bf16, or int8 with per-position bf16 scales ks/vs (the ssak
// int8 KV-cache format).
//
// What bounds it on the H100: bytes. A (batch, head) site reads K and V
// once, 2*Dh*n elements for the n keys in range, and does 4*Dh*n flops on
// them: one flop a byte in bf16, two in int8, far under the ~295 of the
// tensor cores' balance point. The least time is those bytes over 3.35
// TB/s (cross attention, B=24, H=20, T=1500, bf16: 184 MB, 55 us); by
// Little's law that needs ~20 KB in flight on every SM. A decode step's
// self-attention site reads a few keys of its 448-slot cache and is bound
// by its chain of latencies instead.
//
// Design (tools/torch_flash_decode_variants.py times its parts):
// - Persistent CTAs, a producer warp and 2 or 8 consumer warps each. The
//   grid holds as many clusters as the card keeps resident (ops/
//   flash_decode.py `flash_decode_plan`); cluster c takes sites c, c + G,
//   ... The producer warp copies a site's rows of K and V, a row a lane, by
//   TMA bulk copies (cp.async.bulk, completing on an mbarrier) into a ring of
//   S slots, running ahead of the consumers by the ring's depth, across
//   sites: while one site's softmax runs, its V and the next site's K are
//   landing. A slot holds g rows of all T keys, or more rows of a shorter
//   range (a short self-attention range takes one slot for all its K rows).
//   Caches of 1,024 slots or more get 8 consumer warps, two CTAs an SM and
//   ~100 KB rings (bytes in flight); shorter ones (the decoder's 448-slot
//   self-attention caches, read over [lo, pos]) 2 warps and seven CTAs an
//   SM, so that a decode step's sites run side by side in one wave.
// - One exact maximum a site. Where the card has fewer sites than two CTAs
//   an SM, a site is split over a thread-block cluster of C CTAs (C <= 8)
//   by rows of d: rank r owns R = Dh/C rows of K and V over the whole range
//   and sums its rows' partial logits into P; each rank signals every rank's
//   `ready` mbarrier, and then adds the C partials through distributed
//   shared memory in rank order, so every rank holds the same logits bit for
//   bit, takes the same maximum and the same sum, and p is rounded to bf16
//   against the site's global maximum, as on the TPU and in the plain
//   version (no per-chunk maxima, no rescaling). A `done` mbarrier keeps P
//   until every rank has read it. Each rank writes o for its own rows: no
//   combine, no scratch in device memory, no atomics; repeats are
//   bit-identical. Only the consumers take part; the producer runs on.
// - Alignment. A row of a (B, H, Dh, T) cache is T*2 (bf16) or T bytes; at
//   T = 1500 neither is a multiple of 16, which a bulk copy needs. Each copy
//   starts at the 16-byte boundary at or below the first key in range and
//   ends at the one at or above the last, never outside the tensor (bytes
//   between a tensor's end and the boundary past it are read with plain
//   loads). So a key's place in shared memory has its alignment in device
//   memory, and the consumers read vectors of VE keys (W = VE * element
//   bytes: the largest power of two <= 16, <= 8 in int8, dividing the row
//   bytes and the base addresses; 8 bytes in bf16 and 4 in int8 at T = 1500)
//   in groups aligned in absolute key positions. A group's padding is never
//   weighed: its p is 0, and bf16 garbage there (NaN too) is zeroed first;
//   int8 garbage is finite and needs nothing.
// - Only keys in [lo, hi] are read. An empty range masks every key and
//   weights all T alike, as the TPU kernel does.
// - Consumers. Logits: a thread takes groups of VE keys over a slot's rows
//   (with few groups, lanes split the rows and add by shuffles); int8 keys
//   are widened exactly without I2F (a byte under the exponent of 2^23).
//   PV: warps take rows, RPT at a time, lanes spread over the keys, sums
//   added by shuffles; below 4 * 32 groups a warp's lanes split over rows
//   and keys so that a lane walks about PV_GROUPS groups and a row's sum
//   takes few shuffles, its RPT rows' shuffles side by side (a 32-lane sum
//   a row cost a self-attention site more than its loads); no block
//   barrier.
// - What holds it back now: the loads alone reach 80-85% of the byte bound
//   at T = 1,500 (a CTA's first bytes wait for lo/hi and the first copies;
//   480 sites do not split evenly over 132 SMs), and int8's widening and
//   FMAs overlap the loads only in part. A self-attention site is a chain
//   of latencies: launch, lo/hi, copies, two block reductions, the PV pass.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_WARPS = 8;        // consumer warps of a CTA: 2 or 8 (the plan's), and one producer warp
constexpr int RPT = 4;              // V rows a thread holds in the PV pass
constexpr int PV_GROUPS = 4;        // about as many groups of keys a lane walks in a short PV pass
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one block may use on the H100
constexpr float NEG = -1e30f;

// tools/torch_flash_decode_variants.py turns these off to time cut-down copies
constexpr bool kCopies = true;   // issue the bulk copies of K, V and the scales, and wait for them
constexpr bool kLogits = true;   // the logits pass's arithmetic
constexpr bool kSoftmax = true;  // the exchange's and the softmax's arithmetic
constexpr bool kPV = true;       // the PV pass's arithmetic
constexpr bool kV = true;        // V's copies and the PV pass

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of one CTA, in bytes from the dynamic base (ops/flash_decode.py
// `flash_decode_smem` computes the same): the ring of S stages of g row
// buffers; the rank's partial logits P and the logits L (f32, then bf16 p);
// two site buffers (a site's lo and hi, q of the rank's rows, and in int8 its
// scale rows), one for each parity of the CTA's sites; the reduction slots;
// the mbarriers: the ring's full and empty ones, the site buffers' full and
// empty ones, and the cluster's ready (partials written) and done (partials
// read) ones.
struct Layout {
    int pitch, np, qpitch, spitch, site, P, L, sites, red, bars, total;
};

__host__ __device__ inline Layout layout(int T, int elt, bool quant, int R, int g, int S) {
    Layout l;
    l.pitch = round_up(T * elt, 16) + 32;
    l.np = round_up(T + 32, 4);
    l.qpitch = round_up(2 * R, 16) + 32;
    l.spitch = quant ? round_up(2 * T, 16) + 32 : 0;
    l.site = 16 + l.qpitch + 2 * l.spitch;
    l.P = S * g * l.pitch;
    l.L = l.P + 4 * l.np;
    l.sites = l.L + 4 * l.np;
    l.red = l.sites + 2 * l.site;
    l.bars = l.red + 4 * MAX_WARPS * RPT;
    l.total = l.bars + 8 * (2 * S + 6);
    return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n\t.reg .pred p;\n"
        "WAIT:\n\tmbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%0], %1;\n\t@!p bra WAIT;\n}\n" ::"r"(
            smem_addr(bar)),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one arrival on the mbarrier at `bar` in CTA `rank` of the cluster, releasing this thread's view at cluster scope
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
    unsigned r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(bar)), "r"(rank));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(r) : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
    asm volatile(
        "{\n\t.reg .pred p;\n"
        "WAIT:\n\tmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n\t@!p bra WAIT;\n}\n" ::"r"(
            smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// The bytes [src, src + n) of a tensor at [tb, te) into the row buffer dst
// (16-aligned), which holds device byte x at dst + (x - floor16(src)): one
// bulk copy of the part between 16-byte boundaries inside the tensor, plain
// loads for what lies before the tensor's first boundary or after its last
// (ops/flash_decode.py `flash_decode_row_copy` gives the same ranges).
__device__ __forceinline__ uintptr_t umax(uintptr_t a, uintptr_t b) { return a > b ? a : b; }
__device__ __forceinline__ uintptr_t umin(uintptr_t a, uintptr_t b) { return a < b ? a : b; }

__device__ __forceinline__ void row_copy(unsigned char* dst, uintptr_t src, uintptr_t n, uintptr_t tb, uintptr_t te, uint64_t* bar) {
    const uintptr_t e = src + n, a0 = src & ~(uintptr_t)15;
    const uintptr_t A = umax(a0, (tb + 15) & ~(uintptr_t)15), E = umin((e + 15) & ~(uintptr_t)15, te & ~(uintptr_t)15);
    uintptr_t p0 = src;  // plain loads: [src, e) when nothing is bulk, else [src, A) and [E, e)
    if (A < E) {
        mbar_expect_tx(bar, (unsigned)(E - A));
        bulk_copy(dst + (A - a0), (const void*)A, (unsigned)(E - A), bar);
        for (uintptr_t x = src; x < umin(A, e); ++x) dst[x - a0] = *(const unsigned char*)x;
        p0 = umax(E, src);
    }
    for (uintptr_t x = p0; x < e; ++x) dst[x - a0] = *(const unsigned char*)x;
}

// VE keys from shared memory at p (aligned to VE * sizeof(KV)) as f32
template <int VE>
__device__ __forceinline__ void load_keys(const unsigned char* p, const bf16*, float* x) {
    if constexpr (VE == 8) {
        const uint4 w = *reinterpret_cast<const uint4*>(p);
        const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x[2 * i] = __uint_as_float(u[i] << 16);
            x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
    } else if constexpr (VE == 4) {
        const uint2 w = *reinterpret_cast<const uint2*>(p);
        x[0] = __uint_as_float(w.x << 16);
        x[1] = __uint_as_float(w.x & 0xffff0000u);
        x[2] = __uint_as_float(w.y << 16);
        x[3] = __uint_as_float(w.y & 0xffff0000u);
    } else if constexpr (VE == 2) {
        const unsigned w = *reinterpret_cast<const unsigned*>(p);
        x[0] = __uint_as_float(w << 16);
        x[1] = __uint_as_float(w & 0xffff0000u);
    } else {
        x[0] = __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
    }
}

// four int8 in a word as f32, exactly and without I2F (a quarter-rate unit):
// each byte, its sign bit flipped, becomes the low mantissa byte of 2^23,
// and 2^23 + 128 comes off
__device__ __forceinline__ void i8x4_to_f32(unsigned u, float* x) {
    const unsigned b = u ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

template <int VE>
__device__ __forceinline__ void load_keys(const unsigned char* p, const int8_t*, float* x) {
    if constexpr (VE == 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(p);
        i8x4_to_f32(w.x, x);
        i8x4_to_f32(w.y, x + 4);
        i8x4_to_f32(w.z, x + 8);
        i8x4_to_f32(w.w, x + 12);
    } else if constexpr (VE == 8) {
        const uint2 w = *reinterpret_cast<const uint2*>(p);
        i8x4_to_f32(w.x, x);
        i8x4_to_f32(w.y, x + 4);
    } else if constexpr (VE == 4) {
        i8x4_to_f32(*reinterpret_cast<const unsigned*>(p), x);
    } else if constexpr (VE == 2) {
        const unsigned short w = *reinterpret_cast<const unsigned short*>(p);
        x[0] = (float)(int8_t)(w & 0xff);
        x[1] = (float)(int8_t)(w >> 8);
    } else {
        x[0] = (float)*reinterpret_cast<const int8_t*>(p);
    }
}

// VE probabilities from L (16-byte aligned where VE >= 4)
template <int VE>
__device__ __forceinline__ void load_p(const float* L, float* p) {
    if constexpr (VE >= 4) {
#pragma unroll
        for (int e = 0; e < VE; e += 4) {
            const float4 w = *reinterpret_cast<const float4*>(L + e);
            p[e] = w.x, p[e + 1] = w.y, p[e + 2] = w.z, p[e + 3] = w.w;
        }
    } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) p[e] = L[e];
    }
}

// keys a conversion step holds: int8 keys are widened 4 at a time, so that fewer are live at once
template <typename KV, int VE>
__host__ __device__ constexpr int step_keys() {
    return sizeof(KV) == 1 && VE > 4 ? 4 : VE;
}

// acc[e] += w * key e, for the VE keys at `row`
template <int VE, typename KV>
__device__ __forceinline__ void qk_keys(const unsigned char* row, const KV* tag, float w, float* acc) {
    constexpr int VH = step_keys<KV, VE>();
#pragma unroll
    for (int h = 0; h < VE; h += VH) {
        float x[VH];
        load_keys<VH>(row + h * sizeof(KV), tag, x);
#pragma unroll
        for (int e = 0; e < VH; ++e) acc[h + e] = fmaf(w, x[e], acc[h + e]);
    }
}

// acc += the VE keys at `row` times p; at the edges of the range, bf16 keys outside [t0, t1] (t: the first's
// position) are zeroed first: the padding may hold any bits, NaN too (p is 0 there, and int8 keys are finite)
template <int VE, typename KV>
__device__ __forceinline__ void pv_row(const unsigned char* row, const KV* tag, const float* p, bool edge, int t, int t0,
                                       int t1, float& acc) {
    constexpr int VH = step_keys<KV, VE>();
#pragma unroll
    for (int h = 0; h < VE; h += VH) {
        float x[VH];
        load_keys<VH>(row + h * sizeof(KV), tag, x);
        if (sizeof(KV) == 2 && edge) {
#pragma unroll
            for (int e = 0; e < VH; ++e)
                if (t + h + e < t0 || t + h + e > t1) x[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VH; ++e) acc = fmaf(p[h + e], x[e], acc);
    }
}

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

// the consumer warps' own barrier (the producer warp never joins it)
template <int WARPS>
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory"); }

// Reduction over the consumer warps through `red` (WARPS floats), warps in order; every consumer gets the result.
template <bool IS_MAX, int WARPS>
__device__ float block_reduce(float v, float* red) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    v = IS_MAX ? warp_max(v) : warp_sum(v);
    consumers_sync<WARPS>();  // `red` may still be read
    if (lane == 0) red[warp] = v;
    consumers_sync<WARPS>();
    float r = red[0];
    for (int w = 1; w < WARPS; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
    return r;
}

// grid (C * G), cluster (C, 1, 1): cluster c = blockIdx.x / C takes the
// sites c, c + G, c + 2G, ...; its CTA of rank blockIdx.x % C owns rows
// [rank * R, (rank + 1) * R) of each. Warp PRODUCER issues every copy; the
// other 8 warps consume.
template <typename KV, int VE, int WARPS>
__global__ void __launch_bounds__(32 * WARPS + 32, WARPS == 2 ? 7 : 2)
flash_decode_kernel(const bf16* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                    const bf16* __restrict__ ks, const bf16* __restrict__ vs, const int* __restrict__ lo_p,
                    const int* __restrict__ hi_p, float* __restrict__ out, int B, int H, int Dh, int T, int C, int g,
                    int S, int G) {
    constexpr bool QUANT = sizeof(KV) == 1;
    constexpr int ELT = sizeof(KV);
    constexpr int W = VE * ELT;  // bytes of one vector of keys
    constexpr int THREADS = 32 * WARPS, PRODUCER = WARPS;  // consumer threads; the warp that issues the copies
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int rank = blockIdx.x % C, cid = blockIdx.x / C, BH = B * H;
    const int R = Dh / C, d0 = rank * R;
    const Layout Lo = layout(T, ELT, QUANT, R, g, S);
    const int slot_bytes = g * Lo.pitch;  // a ring slot: g rows of all T keys, or more rows of fewer keys
    float* P = reinterpret_cast<float*>(smem + Lo.P);
    float* L = reinterpret_cast<float*>(smem + Lo.L);
    float* red = reinterpret_cast<float*>(smem + Lo.red);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lo.bars);
    uint64_t* empty = full + S;
    uint64_t* sfull = empty + S;
    uint64_t* sempty = sfull + 2;
    uint64_t* ready = sempty + 2;
    uint64_t* done = ready + 1;
    const int rstep = (T * ELT) & 15;  // a row's byte phase step (mod 16) from one row to the next

    if (tid == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], WARPS);
        }
        for (int s = 0; s < 2; ++s) {
            mbar_init(&sfull[s], 1);
            mbar_init(&sempty[s], WARPS);
        }
        mbar_init(ready, C);
        mbar_init(done, C);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (C > 1)
        cluster_barrier();  // every rank's barriers are set before anyone arrives on them
    else
        __syncthreads();

    if (warp == PRODUCER) {
        if (!kCopies) return;
        const uintptr_t kb = (uintptr_t)k, vb = (uintptr_t)v, ke = kb + (uintptr_t)BH * Dh * T * ELT;
        const uintptr_t ve = vb + (ke - kb), qb = (uintptr_t)q, qe = qb + (uintptr_t)BH * Dh * 2;
        const uintptr_t kst = (uintptr_t)ks, vst = (uintptr_t)vs, se = (uintptr_t)BH * T * 2;
        int i = 0;
        for (int site = cid, n_site = 0; site < BH; site += G, ++n_site) {
            const int b = site / H, lo = lo_p[b], hi = hi_p[b];
            int t0 = max(lo, 0), t1 = min(hi, T - 1);
            if (t0 > t1) t0 = 0, t1 = T - 1;
            const uintptr_t n = (uintptr_t)(t1 - t0 + 1);
            const size_t row0 = (size_t)site * Dh + d0;
            // this site's segments: gs rows of pitch bytes (the keys in range), K's then V's
            const int pitch = round_up((int)n * ELT, 16) + 32, gs = min(R, slot_bytes / pitch);
            const int nk = (R + gs - 1) / gs, nseg = kV ? 2 * nk : nk;
            // the site buffer: lo and hi, q of the rank's rows, the scale rows
            const int sb = n_site & 1;
            mbar_wait(&sempty[sb], ((n_site >> 1) & 1) ^ 1);
            unsigned char* buf = smem + Lo.sites + sb * Lo.site;
            if (lane == 0) {
                reinterpret_cast<int*>(buf)[0] = lo;
                reinterpret_cast<int*>(buf)[1] = hi;
                row_copy(buf + 16, qb + row0 * 2, (uintptr_t)R * 2, qb, qe, &sfull[sb]);
            }
            if (QUANT && lane == 1) row_copy(buf + 16 + Lo.qpitch, kst + ((size_t)site * T + t0) * 2, n * 2, kst, kst + se, &sfull[sb]);
            if (QUANT && lane == 2)
                row_copy(buf + 16 + Lo.qpitch + Lo.spitch, vst + ((size_t)site * T + t0) * 2, n * 2, vst, vst + se, &sfull[sb]);
            __syncwarp();
            if (lane == 0) mbar_arrive(&sfull[sb]);
            // the ring: K's segments, then V's
            for (int s = 0; s < nseg; ++s, ++i) {
                const int slot = i % S;
                mbar_wait(&empty[slot], ((i / S) & 1) ^ 1);
                const bool is_k = s < nk;
                const uintptr_t tb = is_k ? kb : vb, te = is_k ? ke : ve;
                const int first = (is_k ? s : s - nk) * gs, rows = min(gs, R - first);
                unsigned char* dst = smem + (size_t)slot * slot_bytes;
                for (int rr = lane; rr < rows; rr += 32)
                    row_copy(dst + (size_t)rr * pitch, tb + ((row0 + first + rr) * T + t0) * ELT, n * ELT, tb, te,
                             &full[slot]);
                __syncwarp();
                if (lane == 0) mbar_arrive(&full[slot]);
            }
        }
        return;
    }

    // the consumers
    int i = 0, n_site = 0;
    for (int site = cid; site < BH; site += G, ++n_site) {
        const int sb = n_site & 1;
        const unsigned char* buf = smem + Lo.sites + sb * Lo.site;
        if (kCopies) mbar_wait(&sfull[sb], (n_site >> 1) & 1);
        const int lo = kCopies ? reinterpret_cast<const int*>(buf)[0] : lo_p[site / H];
        const int hi = kCopies ? reinterpret_cast<const int*>(buf)[1] : hi_p[site / H];
        int t0 = max(lo, 0), t1 = min(hi, T - 1);
        if (t0 > t1) t0 = 0, t1 = T - 1;  // empty range: every key masked, weighted alike over all T
        const int t0a = t0 / VE * VE;          // local key i is position t0a + i
        const int ng = t1 / VE - t0 / VE + 1;  // groups of VE keys
        const int pitch = round_up((t1 - t0 + 1) * ELT, 16) + 32, gs = min(R, slot_bytes / pitch);
        const int nk = (R + gs - 1) / gs, nseg = kV ? 2 * nk : nk;  // the producer's segments of this site
        const size_t row0 = (size_t)site * Dh + d0;
        // byte phases (mod 16) of key t0 in the rank's first rows of K and V, of q's slice and of the scale rows
        const int kph = (int)(((uintptr_t)k + (row0 * T + t0) * ELT) & 15);
        const int vph = (int)(((uintptr_t)v + (row0 * T + t0) * ELT) & 15);
        const int lead = (t0 - t0a) * ELT;  // bytes from the first group's start to key t0
        const bf16* qs = reinterpret_cast<const bf16*>(buf + 16 + (((uintptr_t)q + row0 * 2) & 15));
        const bf16* ksm = reinterpret_cast<const bf16*>(buf + 16 + Lo.qpitch + (((uintptr_t)ks + ((size_t)site * T + t0) * 2) & 15));
        const bf16* vsm = reinterpret_cast<const bf16*>(buf + 16 + Lo.qpitch + Lo.spitch +
                                                        (((uintptr_t)vs + ((size_t)site * T + t0) * 2) & 15));
        if (C > 1 && n_site > 0) mbar_wait_cluster(done, (n_site - 1) & 1);  // every rank has read P of the last site

        // the logits pass: P[i] = sum over the rank's rows of q[d] * k[d, t0a + i]. A thread takes
        // groups of VE keys over the segment's rows; where there are few groups, RL lanes of a warp
        // share a group's rows and add their sums by shuffles
        const int RL = 1 << (31 - __clz(max(1, min(min(32, gs), THREADS / ng))));  // a power of two
        const int rl = lane % RL, gl = warp * (32 / RL) + lane / RL, GL = THREADS / RL;
        for (int s = 0; s < nk; ++s, ++i) {
            const int slot = i % S;
            if (kCopies) mbar_wait(&full[slot], (i / S) & 1);
            if (kLogits) {
                const unsigned char* rows = smem + (size_t)slot * slot_bytes;
                const int nr = min(gs, R - s * gs);
                for (int j0 = 0; j0 < ng; j0 += GL) {  // warp-uniform trip count: the shuffles need every lane
                    const int j = j0 + gl;
                    float acc[VE] = {};
                    if (j < ng) {
                        for (int rr = rl; rr < nr; rr += RL) {
                            const int r = s * gs + rr;
                            const int off = ((kph + r * rstep) & 15) - lead;  // the first group's byte in the row buffer
                            qk_keys<VE>(rows + (size_t)rr * pitch + off + j * W, k, __bfloat162float(qs[r]), acc);
                        }
                    }
                    for (int o = RL / 2; o > 0; o >>= 1)
#pragma unroll
                        for (int e = 0; e < VE; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
                    if (j < ng && rl == 0) {
#pragma unroll
                        for (int e = 0; e < VE; ++e) P[j * VE + e] = s == 0 ? acc[e] : P[j * VE + e] + acc[e];
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[slot]);
        }
        consumers_sync<WARPS>();  // P is whole

        // the exchange: every rank adds the C partials in rank order; mask; max
        if (C > 1) {
            if (tid == 0)
                for (int r = 0; r < C; ++r) mbar_arrive_remote(ready, r);
            mbar_wait_cluster(ready, n_site & 1);
        }
        const int nq = (ng * VE + 3) / 4;
        float m = NEG;
        if (kSoftmax) {
            for (int c4 = tid; c4 < nq; c4 += THREADS) {
                float4 l = *reinterpret_cast<const float4*>(P + 4 * c4);
                if (C > 1) {  // the ranks' partials, added in rank order
                    l = *reinterpret_cast<const float4*>(cg::this_cluster().map_shared_rank(P, 0) + 4 * c4);
                    for (int r = 1; r < C; ++r) {
                        const float4 o = *reinterpret_cast<const float4*>(cg::this_cluster().map_shared_rank(P, r) + 4 * c4);
                        l.x += o.x;
                        l.y += o.y;
                        l.z += o.z;
                        l.w += o.w;
                    }
                }
                float x[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int t = t0a + 4 * c4 + e;
                    if (t < t0 || t > t1) continue;  // a group's padding: never weighed
                    if (QUANT) x[e] *= __bfloat162float(ksm[t - t0]);
                    x[e] = (t >= lo && t <= hi) ? x[e] : NEG;
                    m = fmaxf(m, x[e]);
                }
                *reinterpret_cast<float4*>(L + 4 * c4) = make_float4(x[0], x[1], x[2], x[3]);
            }
        }
        m = block_reduce<true, WARPS>(m, red);  // its barriers also close this CTA's reads of the partials
        if (C > 1 && tid == 0)
            for (int r = 0; r < C; ++r) mbar_arrive_remote(done, r);

        // p, its sum, and the bf16 operand of the PV product (0 on padding)
        float sum = 0.f;
        if (kSoftmax) {
            for (int c4 = tid; c4 < nq; c4 += THREADS) {
                float4 l = *reinterpret_cast<const float4*>(L + 4 * c4);
                float x[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int t = t0a + 4 * c4 + e;
                    if (t < t0 || t > t1) {
                        x[e] = 0.f;
                        continue;
                    }
                    const float p = expf(x[e] - m);
                    sum += p;
                    const float pv = QUANT ? p * __bfloat162float(vsm[t - t0]) : p;
                    x[e] = __bfloat162float(__float2bfloat16(pv));
                }
                *reinterpret_cast<float4*>(L + 4 * c4) = make_float4(x[0], x[1], x[2], x[3]);
            }
        }
        sum = block_reduce<false, WARPS>(sum, red);  // its barriers also publish L
        if (!kSoftmax) sum = 1.f;
        const float inv_sum = 1.f / sum;  // o / sum as o * (1 / sum): within an ulp, one division a site
        __syncwarp();
        if (lane == 0) mbar_arrive(&sempty[sb]);  // the site buffer is free

        // the PV pass. With 4 * 32 groups or more, warp w takes rows w, w + WARPS, ..., RPT at a time, its
        // lanes spread over the keys, and a row's sum is added by shuffles. With fewer, a warp's lanes are RLP
        // row lanes of GLP group lanes (GLP: the groups over PV_GROUPS, rounded down to a power of two), so a
        // lane walks about PV_GROUPS groups; a lane takes RPT rows RSTR apart, and the GLP lanes of a row add
        // their sums, the RPT rows side by side
        const int GLP = min(32, 1 << (31 - __clz(max(1, ng / PV_GROUPS)))), RLP = 32 / GLP;
        const int glp = lane % GLP, rlp = lane / GLP, RSTR = WARPS * RLP;
        for (int s = nk; s < nseg; ++s, ++i) {
            const int slot = i % S, r0 = (s - nk) * gs, nr = min(gs, R - r0);
            if (kCopies) mbar_wait(&full[slot], (i / S) & 1);
            const unsigned char* rows = smem + (size_t)slot * slot_bytes;
            if (GLP == 32) {
                for (int m0 = 0; warp + WARPS * m0 < nr; m0 += RPT) {
                    float acc[RPT] = {};
                    int off[RPT];
#pragma unroll
                    for (int rr = 0; rr < RPT; ++rr)
                        off[rr] = ((vph + (r0 + warp + WARPS * (m0 + rr)) * rstep) & 15) - lead;
                    for (int j = lane; kPV && j < ng; j += 32) {
                        float p[VE];
                        load_p<VE>(L + j * VE, p);
                        const bool edge = j == 0 || j == ng - 1;
#pragma unroll
                        for (int rr = 0; rr < RPT; ++rr) {
                            const int row = warp + WARPS * (m0 + rr);
                            if (row >= nr) break;
                            pv_row<VE>(rows + (size_t)row * pitch + off[rr] + j * W, v, p, edge, t0a + j * VE, t0, t1,
                                       acc[rr]);
                        }
                    }
#pragma unroll
                    for (int rr = 0; rr < RPT; ++rr) {
                        const int row = warp + WARPS * (m0 + rr);
                        const float o = warp_sum(acc[rr]);
                        if (lane == 0 && row < nr) out[row0 + r0 + row] = o * inv_sum;
                    }
                }
            } else {
                for (int m0 = 0; warp * RLP + RSTR * m0 < nr; m0 += RPT) {  // warp-uniform: the shuffles need every lane
                    float acc[RPT] = {};
                    for (int j = glp; kPV && j < ng; j += GLP) {
                        float p[VE];
                        load_p<VE>(L + j * VE, p);
                        const bool edge = j == 0 || j == ng - 1;
#pragma unroll
                        for (int rr = 0; rr < RPT; ++rr) {
                            const int row = warp * RLP + rlp + RSTR * (m0 + rr);
                            if (row >= nr) break;
                            const int off = ((vph + (r0 + row) * rstep) & 15) - lead;
                            pv_row<VE>(rows + (size_t)row * pitch + off + j * W, v, p, edge, t0a + j * VE, t0, t1, acc[rr]);
                        }
                    }
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1) {
                        if (o < GLP) {
#pragma unroll
                            for (int rr = 0; rr < RPT; ++rr) acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], o);
                        }
                    }
#pragma unroll
                    for (int rr = 0; rr < RPT; ++rr) {
                        const int row = warp * RLP + rlp + RSTR * (m0 + rr);
                        if (glp == 0 && row < nr) out[row0 + r0 + row] = acc[rr] * inv_sum;
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[slot]);
        }
        if (!kV && tid < R) out[row0 + tid] = sum;  // the cut-down copy without V stores its sums
    }
    if (C > 1 && n_site > 0) mbar_wait_cluster(done, (n_site - 1) & 1);  // no rank leaves while another reads its P
}

template <typename KV, int VE, int WARPS>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* lo,
           const void* hi, void* out, int B, int H, int Dh, int T, int C, int g, int S, int G, int smem,
           cudaStream_t stream) {
    auto kernel = flash_decode_kernel<KV, VE, WARPS>;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    static bool sized[64] = {};  // once per device and instantiation
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!sized[dev]) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
        if (e != cudaSuccess) return (int)e;
        sized[dev] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(C * G));
    cfg.blockDim = dim3(32 * WARPS + 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = C > 1 ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)q, (const KV*)k, (const KV*)v, (const bf16*)ks,
                           (const bf16*)vs, (const int*)lo, (const int*)hi, (float*)out, B, H, Dh, T, C, g, S, G);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// W: the widest vector of keys (bytes, a power of two <= 16, <= 8 in int8,
// where 16 keys a thread cost registers and gained nothing) that divides a
// row's bytes and both base addresses, so a key group's place is aligned in
// every row of K and V
inline int vector_bytes(int row_bytes, const void* k, const void* v, int elt) {
    int w = elt == 1 ? 8 : 16;
    while (w > elt && (row_bytes % w || (uintptr_t)k % w || (uintptr_t)v % w)) w >>= 1;
    return w;
}

template <typename KV, int VE>
int by_warps(const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* lo,
             const void* hi, void* out, int B, int H, int Dh, int T, int C, int g, int S, int G, int warps, int smem,
             cudaStream_t st) {
    if (warps == 8) return launch<KV, VE, 8>(q, k, v, ks, vs, lo, hi, out, B, H, Dh, T, C, g, S, G, smem, st);
    return launch<KV, VE, 2>(q, k, v, ks, vs, lo, hi, out, B, H, Dh, T, C, g, S, G, smem, st);
}

template <typename KV>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* lo,
             const void* hi, void* out, int B, int H, int Dh, int T, int C, int g, int S, int G, int warps, int smem,
             void* stream) {
    constexpr int ELT = sizeof(KV);
    constexpr bool quant = ELT == 1;
    const bool plan_ok = (C == 1 || C == 2 || C == 4 || C == 8) && Dh % C == 0 && g >= 1 && (Dh / C) % g == 0 &&
                         S >= 1 && G >= 1 && (warps == 2 || warps == 8) &&
                         smem == layout(T, ELT, quant, Dh / C, g, S).total && smem <= SMEM_LIMIT;
    if (!plan_ok || B < 1 || H < 1 || T < 1 || Dh < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (vector_bytes(T * ELT, k, v, ELT) / ELT) {
        case 8: return by_warps<KV, 8>(q, k, v, ks, vs, lo, hi, out, B, H, Dh, T, C, g, S, G, warps, smem, st);
        case 4: return by_warps<KV, 4>(q, k, v, ks, vs, lo, hi, out, B, H, Dh, T, C, g, S, G, warps, smem, st);
        case 2: return by_warps<KV, 2>(q, k, v, ks, vs, lo, hi, out, B, H, Dh, T, C, g, S, G, warps, smem, st);
        default: return by_warps<KV, 1>(q, k, v, ks, vs, lo, hi, out, B, H, Dh, T, C, g, S, G, warps, smem, st);
    }
}

}  // namespace

// The plan (cluster C, rows a ring segment g, ring stages S, clusters G,
// consumer warps, shared bytes) comes from ops/flash_decode.py
// `flash_decode_plan`; a plan the kernel cannot run returns
// cudaErrorInvalidValue, a refused launch its own error.
extern "C" int ssak_flash_decode_bf16(const void* q, const void* k, const void* v, const void* lo, const void* hi,
                                      void* out, int B, int H, int Dh, int T, int C, int g, int S, int G, int warps,
                                      int smem, void* stream) {
    return dispatch<bf16>(q, k, v, nullptr, nullptr, lo, hi, out, B, H, Dh, T, C, g, S, G, warps, smem, stream);
}

extern "C" int ssak_flash_decode_int8(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
                                      const void* lo, const void* hi, void* out, int B, int H, int Dh, int T, int C,
                                      int g, int S, int G, int warps, int smem, void* stream) {
    return dispatch<int8_t>(q, k8, v8, ks, vs, lo, hi, out, B, H, Dh, T, C, g, S, G, warps, smem, stream);
}
