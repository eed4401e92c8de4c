// Fused CTC forward-backward (K1): per-row loss and d loss / d log_probs.
//
//   alpha[t, s] = logsumexp(alpha[t-1, s], alpha[t-1, s-1], allow[s] ? alpha[t-1, s-2])
//                 + lp[t, ext[s]]                       (frozen for t >= t_len)
//   ll          = logsumexp(alpha[last, 2L], alpha[last, max(2L-1, 0)]),  loss = -ll
//   beta[t-1]   = logsumexp over s, s+1, s+2 (allowed) of beta[t] + lp[t, ext[.]]
//   g[t, s]     = exp(alpha[t, s] + beta[t, s] - ll)
//   grad[t, v]  = -sum_{s : ext[s] = v} g[t, s] / sum_s g[t, s]   (t < t_len; 0 past it)
//
// The denominator is 1 in exact arithmetic (the posteriors of a frame sum to
// one), and the TPU kernel leaves it out. In f32 it is not 1 at long T:
// alpha and beta reach about -1e4 at T = 5,000-7,000, where one ulp is 1e-3,
// so the rounding of alpha + beta - ll gives each frame its own scale error
// of up to about 1% (against the same recursion in f64). Dividing each frame
// by its own sum removes that scale error; the sum runs over every live
// state, those of labels outside the vocabulary included.
//
// Replaces: ssak_tpu/ops/ctc_pallas.py:29 `_ctc_kernel` (launched by `_run_kernel`).
// Same sentinel semantics: NEG = -1e30 (never -inf), a merge whose maximum is
// <= NEG/2 stays NEG, states past 2L are NEG, alpha is frozen past t_len and
// beta is updated only for t < t_len. Rows with t_len <= 0 (batch-pad dummies)
// and L = 0 read no state past row 0 and get all-zero gradient rows. A label
// outside [0, V) emits 0 and receives no gradient, as a one-hot column of
// zeros does in the TPU kernel (and nothing is read out of the row).
//
// What bounds it on the H100: neither bytes nor operations but the serial
// chain. The bytes the function must move (lp read once, grad written once)
// are about 6.2 MB at B = 32, T = 749, V = 32, i.e. 1.8 us at 3.35 TB/s, and
// its ~32 f32 operations per live (t, s) state take 3.9 us at 67 TFLOP/s
// (chip_smoke.py's bound_ms, kept as the card's floor for the same work).
// The recursion is T - 1 dependent steps, each a merge of every state of a
// row and a barrier: that chain, not the card's rates, sets the time, and
// the design below shortens it and takes everything else off it.
//
// Design. One call launches two kernels (ops/ctc_fused.py counts it as one
// launch):
// - ctc_sweep_kernel runs the 2B recursions at once: the alpha sweep of each
//   row forward and its beta sweep backward (beta needs nothing of alpha),
//   so the chain is T - 1 steps, not 2T - 1. A sweep of up to 1,024 states
//   runs on one CTA, a longer one on a thread-block cluster of up to 8 CTAs
//   that split the states into contiguous ranges (ops/ctc_fused.py
//   `ctc_plan`: CTA r takes [r*S/C, (r+1)*S/C), about one state a thread; 8
//   CTAs of 512 states at the 140 s bucket). A CTA keeps this step's and the
//   last step's values of its range in shared memory, each with two halo
//   slots a side. Beta's shared values are beta + lp[t, ext] (the plain
//   version's `be`), so a state's emission is added once, by its owner, and
//   beta's allow[s+2] is read for the neighbour's state at the range's edge.
//   The sweeps write alpha and beta rows to two (B, T, S) f32 scratches
//   (live states only), after the step's arrive, off the chain.
// - The halo: the two threads that own the states at a range's edge send
//   them to the neighbour's halo slots with st.async (alpha to the right,
//   for s-1 and s-2; beta to the left, for s+1 and s+2), each completing 4
//   bytes on an mbarrier of the neighbour's; the neighbour's threads that
//   read the halo wait on it (acquire at cluster scope). No fence: a release
//   at cluster scope (barrier.cluster.arrive's default, or fence.acq_rel)
//   waits for the thread's stores to device memory, about 0.5 us a step
//   (tools/torch_ctc_variants.py's no_work chain took 5.1 ms at the 140 s
//   bucket with it, 1.6 without). A relaxed cluster barrier a step, after a
//   block barrier that orders the CTA's own row, keeps the CTAs in lockstep,
//   so a halo slot is written again only after its reader is past it.
// - Nothing on the chain waits for device memory: a ring of 8 lp rows in
//   shared memory, filled a half (4 rows) at a time by TMA bulk copies that
//   complete on one mbarrier a half, gives each step its emissions (a 4 KB
//   row at V = 1024). Where V % 4 != 0 the emissions are read from device
//   memory instead. (A cp.async ring stalled the issuing warp's shared loads
//   behind its copies, about 0.2 us a step.)
// - The merge keeps the maximum's own term as 1: two exps and one log a
//   state (ex2.approx / lg2.approx through __expf / __logf; the f64 witness
//   of chip_smoke.py phase 2 holds them to the same limits as accurate
//   expf / logf, since alpha's own rounding, 1e-3 at 1e4, dominates).
// - ctc_collect_kernel then forms the gradient off the chain, over (frame
//   tiles, rows): g = exp(alpha + beta - ll) (the plain version's order),
//   the frame's mass z as a fixed-order block sum, and the class sums
//   without atomics: each block groups its row's live in-vocabulary states
//   by class once (a stable counting sort), cuts each class into pieces of
//   PIECE states, sums each piece serially and then each class's pieces in
//   order. Repeats are bit-identical. It also writes the loss and zeros the
//   rows t >= t_len.
//
// Shared memory (ops/ctc_fused.py `sweep_smem_bytes`, `collect_smem_bytes`):
// a sweep CTA 32 bytes of mbarriers and 2 W + RING VP words (W = ceil(S/C) +
// 4 rounded up to 4, VP = V rounded up to 4); a collect block 6 S + 8 (V +
// 1) + 6 NP + 128 bytes (NP = ceil(S / PIECE) + V pieces).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_CLUSTER = 8;         // portable cluster size
constexpr int MAX_THREADS = 1024;
constexpr int RING = 8;                // lp rows in the ring: two halves, each refilled whole
constexpr int HALF = RING / 2;
constexpr int PIECE = 32;              // states per piece of a class sum
constexpr int COLLECT_THREADS = 256;
constexpr int COLLECT_FRAMES = 32;     // frames per collect block
constexpr int SMEM_LIMIT = 232448;     // bytes of shared memory one block may use on the H100
// a sweep CTA's shared memory ahead of its float arrays: two mbarriers for
// the ring's halves and two for the halo of each buffer
constexpr int SWEEP_HEAD = 32;

// tools/torch_ctc_variants.py turns these off to time cut-down copies
constexpr bool kSweeps = true;         // launch the sweeps
constexpr bool kCollect = true;        // launch the collect pass
constexpr bool kEmissions = true;      // read emissions (the lp ring)
constexpr bool kMerge = true;          // the merge and the scratch stores (off: barriers and exchanges only)

__device__ __forceinline__ float lse3(float a, float b, float c) {
    const float hi = fmaxf(a, b), lo = fminf(a, b);
    const float m = fmaxf(hi, c), x = fminf(hi, c);  // {x, lo}: the two terms below the maximum
    const float r = m + __logf(1.f + __expf(x - m) + __expf(lo - m));
    return (m <= NEG / 2) ? NEG : r;
}

__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a step's arrive orders nothing: a release at cluster scope would wait for
// the thread's stores to device memory. The block barrier before it orders
// the CTA's own row, and the halo travels by st.async to an mbarrier.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// the shared::cluster address of p in CTA `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
    unsigned r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
    return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// the barrier's one arrival for its current phase, which then also waits for `bytes`
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n\t.reg .pred p;\n"
        "WAIT:\n\tmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n\t@!p bra WAIT;\n}\n" ::"r"(
            smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// one lp row into the ring by a TMA bulk copy, completing on `bar`
__device__ __forceinline__ void fetch_row(float* dst, const float* src, int bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

// a halo value into the neighbour's shared memory, completing 4 bytes on its mbarrier
__device__ __forceinline__ void send_edge(unsigned raddr, float v, unsigned rbar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(raddr),
                 "r"(__float_as_uint(v)), "r"(rbar)
                 : "memory");
}

// lp[t, e] for a label in the vocabulary (code = e + 1 > 0), else 0
__device__ __forceinline__ float emission(const float* row, int code) {
    return (kEmissions && code > 0) ? row[code - 1] : 0.f;
}

__device__ __forceinline__ int row_labels(const int* lab_lens, int b, int S) {
    return max(0, min(lab_lens[b], (S - 1) / 2));
}

// the extended labels of a row (ops/ctc_fused.py `_prepare`): the blank at
// even s, label (s-1)/2 at odd s; the s-2 -> s skip is allowed at a label
// that is neither the blank nor the label before it
__device__ __forceinline__ int ext_at(const int* lab, int s, int blank) { return (s & 1) ? lab[s >> 1] : blank; }

__device__ __forceinline__ bool allow_at(const int* lab, int s, int blank) {
    if (!(s & 1)) return false;
    const int e = lab[s >> 1];
    return e != blank && (s < 2 || e != lab[(s >> 1) - 1]);
}

// One sweep: the CTA `rank` of a cluster of C takes states [lo, hi); state
// k of a thread is lo + tid + k*nt. BWD: beta backward from t_len - 1, else
// alpha forward from 0. RINGED: the lp rows come through the shared ring
// (V % 4 == 0, lp 16-byte aligned), else each emission is read from device
// memory. CLUSTERED: C > 1. A buffer holds the range at [2, n + 2) and two
// halo slots a side.
template <int KPT, bool BWD, bool RINGED, bool CLUSTERED>
__device__ __forceinline__ void sweep(const float* __restrict__ lp, const int* __restrict__ lab, int blank,
                                      int t_len, int L, float* __restrict__ out, int b, int T, int S, int V, int W,
                                      unsigned char* smem) {
    const int C = CLUSTERED ? (int)gridDim.x : 1, rank = CLUSTERED ? (int)blockIdx.x : 0;
    const int lo = rank * S / C, hi = (rank + 1) * S / C, n = hi - lo;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int n_valid = 2 * L + 1;
    const int t_end = max(0, min(t_len, T));
    const int t_first = BWD ? t_end - 1 : 0;             // the row the sweep starts from
    if (t_first < 0) return;                              // beta of a row with no frame: nothing to do
    const int nsteps = BWD ? t_first : max(1, t_end) - 1;  // alpha is frozen after row t_last = nsteps
    const int VP = (V + 3) & ~3;
    uint64_t* rbar = reinterpret_cast<uint64_t*>(smem);  // the ring's halves
    uint64_t* hbar = rbar + 2;                            // the halo of buffer 0 and of buffer 1
    float* buf0 = reinterpret_cast<float*>(smem + SWEEP_HEAD);
    float* buf1 = buf0 + W;
    float* ring = buf0 + 2 * W;
    const float* lpb = lp + (size_t)b * T * V;
    float* ob = out + (size_t)b * T * S;
    auto frame = [&](int i) { return BWD ? t_first - 1 - i : 1 + i; };
    const int row_bytes = V * (int)sizeof(float);
    // the ring: steps [4q, 4q + 4) read half q & 1, which completes on rbar[q & 1]
    auto refill = [&](int q) {
        const int first = q * HALF, rows = min(HALF, nsteps - first);
        if (!kEmissions || rows <= 0) return;
        uint64_t* bar = rbar + (q & 1);
        mbar_expect(bar, rows * row_bytes);
        for (int j = 0; j < rows; ++j)
            fetch_row(ring + ((first + j) & (RING - 1)) * VP, lpb + (size_t)frame(first + j) * V, row_bytes, bar);
    };

    // per state: code = (emission class + 1, or 0) << 1 | skip
    int code[KPT];
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
        const int s = lo + tid + k * nt;
        code[k] = 0;
        if (s < hi) {
            const int e = ext_at(lab, s, blank);
            const bool skip = BWD ? (s + 2 < S && allow_at(lab, s + 2, blank)) : allow_at(lab, s, blank);
            code[k] = (((unsigned)e < (unsigned)V ? e + 1 : 0) << 1) | (skip ? 1 : 0);
        }
    }
    // the neighbour this CTA feeds (its halo) and the one that feeds it
    const int to = BWD ? rank - 1 : rank + 1, from = BWD ? rank + 1 : rank - 1;
    const bool feeds = CLUSTERED && to >= 0 && to < C, fed = CLUSTERED && from >= 0 && from < C;
    if (tid < 2) {  // halo slots: NEG unless a neighbour fills them
        buf0[tid] = buf1[tid] = NEG;
        buf0[n + 2 + tid] = buf1[n + 2 + tid] = NEG;
    }
    if (tid == 0) {
        if (RINGED) {
            mbar_init(rbar);
            mbar_init(rbar + 1);
        }
        if (fed) {  // rows 0 and 1 of the halo, two 4-byte values each
            mbar_init(hbar);
            mbar_init(hbar + 1);
            if (0 < nsteps) mbar_expect(hbar, 8);
            if (1 < nsteps) mbar_expect(hbar + 1, 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (CLUSTERED) cluster_barrier();  // every CTA has started and set its halos and barriers
    // the threads whose states read the halo (alpha: lo, lo + 1; beta: hi - 1, hi - 2) wait on it
    const int near_off = BWD ? n - 1 : 0;  // offset in the range of the state next to the halo
    const bool reads_halo = fed && (tid == near_off % nt || tid == (BWD ? near_off - 1 : 1) % nt);
    const bool arms = fed && tid == near_off % nt;  // a reader re-arms the halo barrier it has just waited on
    // this CTA's states next to its fed edge: the neighbour's halo slot (in bytes) of state s, or -1
    const int to_lo = to * S / C, to_n = (to + 1) * S / C - to_lo;
    auto halo_slot = [&](int s) {
        if (!feeds) return -1;
        if (BWD) return s < lo + 2 ? 4 * (to_n + 2 + (s - lo)) : -1;
        return s >= hi - 2 ? 4 * (s - (hi - 2)) : -1;
    };
    unsigned rbuf[2] = {0u, 0u}, rhb[2] = {0u, 0u};
    if (feeds) {
        rbuf[0] = cluster_addr(buf0, to);
        rbuf[1] = cluster_addr(buf1, to);
        rhb[0] = cluster_addr(hbar, to);
        rhb[1] = cluster_addr(hbar + 1, to);
    }

    if (RINGED && tid == 0) {
        refill(0);
        refill(1);
    }
    // the first row: alpha[0] or beta[t_len - 1] (+ its emission)
    {
        const float* row = lpb + (size_t)t_first * V;
        const int e1 = 2 * L, e2 = max(2 * L - 1, 0);
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
            const int s = lo + tid + k * nt;
            if (s >= hi) continue;
            const bool valid = s < n_valid;
            const int c = code[k] >> 1;
            float v;
            if (BWD) {
                const float be = (s == e1 || s == e2) ? 0.f : NEG;
                if (valid) ob[(size_t)t_first * S + s] = be;
                v = valid ? be + (c > 0 ? __ldg(row + c - 1) : 0.f) : NEG;
            } else {
                v = (s < 2 && valid) ? (c > 0 ? __ldg(row + c - 1) : 0.f) : NEG;
                if (valid) ob[s] = v;
            }
            buf0[s - lo + 2] = v;
            const int h = halo_slot(s);
            if (h >= 0 && 0 < nsteps) send_edge(rbuf[0] + h, v, rhb[0]);
        }
    }
    if (RINGED && kEmissions && nsteps > 0) mbar_wait(rbar, 0);
    if (reads_halo && 0 < nsteps) mbar_wait(hbar, 0);
    if (arms && 2 < nsteps) mbar_expect(hbar, 8);  // row 2
    __syncthreads();
    if (CLUSTERED) {
        cluster_arrive_relaxed();
        cluster_wait();
    }

    for (int i = 0; i < nsteps; ++i) {
        const float* prev = (i & 1) ? buf1 : buf0;
        float* cur = (i & 1) ? buf0 : buf1;
        const int nb = (i + 1) & 1;  // the buffer of row i + 1
        const float* em = ring + (i & (RING - 1)) * VP;
        const float* grow = lpb + (size_t)frame(i) * V;  // the row itself, where there is no ring
        float* orow = ob + (size_t)frame(i) * S;
        float keep[KPT];  // the row's values, stored to the scratch after the barrier's arrive
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
            const int s = lo + tid + k * nt;
            keep[k] = NEG;
            if (s >= hi) continue;
            const int l = s - lo + 2;
            const bool valid = s < n_valid;
            const int c = code[k] >> 1;
            const float e = RINGED ? emission(em, c) : (kEmissions && c > 0 ? __ldg(grow + c - 1) : 0.f);
            float v;
            if (!kMerge) {
                v = prev[l];
            } else if (BWD) {
                const float n0 = prev[l], n1 = prev[l + 1], n2 = (code[k] & 1) ? prev[l + 2] : NEG;
                const float nb_ = valid ? lse3(n0, n1, n2) : NEG;
                keep[k] = nb_;
                v = valid ? nb_ + e : NEG;
            } else {
                const float p0 = prev[l], p1 = prev[l - 1], p2 = (code[k] & 1) ? prev[l - 2] : NEG;
                v = valid ? lse3(p0, p1, p2) + e : NEG;
                keep[k] = v;
            }
            cur[l] = v;
            if (CLUSTERED) {
                const int h = halo_slot(s);
                if (h >= 0 && i + 1 < nsteps) send_edge(rbuf[nb] + h, v, rhb[nb]);
            }
        }
        if (CLUSTERED) {
            __syncthreads();
            cluster_arrive_relaxed();
        }
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
            const int s = lo + tid + k * nt;
            if (kMerge && s < hi && s < n_valid) orow[s] = keep[k];
        }
        if (i + 1 < nsteps) {
            if (RINGED && kEmissions && (i + 1) % HALF == 0) mbar_wait(rbar + (((i + 1) / HALF) & 1), ((i + 1) / RING) & 1);
            if (reads_halo) mbar_wait(hbar + nb, ((i + 1) >> 1) & 1);
            if (arms && i + 3 < nsteps) mbar_expect(hbar + nb, 8);  // row i + 3
        }
        if (CLUSTERED) cluster_wait(); else __syncthreads();
        if (RINGED && tid == 0 && (i + 1) % HALF == 0) refill((i + 1) / HALF + 1);  // the half read in steps i-3..i
    }
    if (CLUSTERED) cluster_barrier();  // no CTA leaves while a neighbour may still write to it
}

// grid (C, 2B), cluster (C, 1, 1) when C > 1: blockIdx.x is the rank,
// blockIdx.y = 2b (alpha of row b) or 2b + 1 (beta of row b)
template <int KPT, bool RINGED, bool CLUSTERED>
__global__ void __launch_bounds__(MAX_THREADS)
ctc_sweep_kernel(const float* __restrict__ lp, const int* __restrict__ labels, const int* __restrict__ t_lens,
                 const int* __restrict__ lab_lens, float* __restrict__ alpha, float* __restrict__ beta, int T, int S,
                 int V, int W, int blank) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.y >> 1;
    const int L = row_labels(lab_lens, b, S);
    const int* lab = labels + (size_t)b * ((S - 1) / 2);
    if (blockIdx.y & 1)
        sweep<KPT, true, RINGED, CLUSTERED>(lp, lab, blank, t_lens[b], L, beta, b, T, S, V, W, smem);
    else
        sweep<KPT, false, RINGED, CLUSTERED>(lp, lab, blank, t_lens[b], L, alpha, b, T, S, V, W, smem);
}

// grid (ceil(T / COLLECT_FRAMES), B). zero_inf: a row that cannot be
// aligned (t_len < its label length, or no label) or whose loss is not
// finite gets loss 0 and a zero gradient (ops/ctc_fused.py `_zero_infinity`)
__global__ void __launch_bounds__(COLLECT_THREADS)
ctc_collect_kernel(const int* __restrict__ labels, const int* __restrict__ t_lens, const int* __restrict__ lab_lens,
                   const float* __restrict__ alpha, const float* __restrict__ beta, float* __restrict__ loss,
                   float* __restrict__ grad, int T, int S, int V, int blank, int zero_inf) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int NP = (S + PIECE - 1) / PIECE + V;  // pieces: at most sum_v ceil(n_v / PIECE)
    float* g = reinterpret_cast<float*>(smem_raw);  // g of the frame; before the first frame, each state's rank in its class
    int* off = reinterpret_cast<int*>(g + S);        // class counts, then the first sorted position of each class
    int* pb = off + V + 1;                           // the first piece of each class
    float* part = reinterpret_cast<float*>(pb + V + 1);
    float* zw = part + NP;                           // the frame's mass, one partial a warp
    unsigned short* order = reinterpret_cast<unsigned short*>(zw + 32);  // live in-vocabulary states, by class
    unsigned short* pcls = order + S;                // the class of each piece

    const int b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
    const int t_len = t_lens[b];
    const int L = row_labels(lab_lens, b, S);
    const int n_valid = 2 * L + 1;
    const int t_end = max(0, min(t_len, T));
    const int t_last = max(1, t_end) - 1;
    const float* ab = alpha + (size_t)b * T * S;
    const float* bb = beta + (size_t)b * T * S;
    const int* lab = labels + (size_t)b * ((S - 1) / 2);
    float ll;
    {
        const float* fin = ab + (size_t)t_last * S;
        const float a1 = fin[2 * L], a2 = fin[max(2 * L - 1, 0)];
        const float m = fmaxf(a1, a2);
        ll = m + logf(expf(a1 - m) + expf(a2 - m));
    }
    const float nll = -ll;
    const bool ok = !zero_inf || (t_len >= lab_lens[b] && lab_lens[b] > 0 && isfinite(nll) && nll < -NEG / 2);
    if (blockIdx.x == 0 && tid == 0) loss[b] = ok ? nll : 0.f;
    const int t0 = blockIdx.x * COLLECT_FRAMES, t1 = min(T, t0 + COLLECT_FRAMES);
    float* gb = grad + (size_t)b * T * V;
    if (!ok || t0 >= t_end) {  // rows past the valid length (or of a row zero_inf drops) get a zero gradient
        for (size_t i = (size_t)t0 * V + tid; i < (size_t)t1 * V; i += nt) gb[i] = 0.f;
        return;
    }

    // group the live in-vocabulary states by class, in order of s (a stable
    // counting sort by one warp; ranks from __match_any_sync, no atomics)
    int* rank_of = reinterpret_cast<int*>(g);
    auto key = [&](int s) {
        const int e = s < n_valid ? ext_at(lab, s, blank) : -1;
        return (unsigned)e < (unsigned)V ? e : V;
    };
    if (warp == 0) {
        for (int v = lane; v <= V; v += 32) off[v] = 0;
        __syncwarp();
        for (int c0 = 0; c0 < n_valid; c0 += 32) {
            const int s = c0 + lane;
            const int k = key(s);
            const unsigned peers = __match_any_sync(0xffffffffu, k);
            const int r = __popc(peers & ((1u << lane) - 1u));
            const int base = k < V ? off[k] : 0;
            __syncwarp();
            if (k < V) {
                rank_of[s] = base + r;
                if (r == 0) off[k] = base + __popc(peers);
            }
            __syncwarp();
        }
        // exclusive scans of the counts (off) and of the pieces (pb), each
        // lane over a run of classes, then across the warp
        const int per = (V + 31) / 32, v0 = min(V, lane * per), v1 = min(V, v0 + per);
        int so = 0, sp = 0;
        for (int v = v0; v < v1; ++v) {
            so += off[v];
            sp += (off[v] + PIECE - 1) / PIECE;
        }
        int io = so, ip = sp;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int xo = __shfl_up_sync(0xffffffffu, io, d), xp = __shfl_up_sync(0xffffffffu, ip, d);
            if (lane >= d) {
                io += xo;
                ip += xp;
            }
        }
        io -= so;
        ip -= sp;
        __syncwarp();
        for (int v = v0; v < v1; ++v) {
            const int c = off[v];
            off[v] = io;
            pb[v] = ip;
            io += c;
            ip += (c + PIECE - 1) / PIECE;
        }
        if (lane == 31) {
            off[V] = io;
            pb[V] = ip;
        }
    }
    __syncthreads();
    for (int s = tid; s < n_valid; s += nt) {
        const int k = key(s);
        if (k < V) order[off[k] + rank_of[s]] = (unsigned short)s;
    }
    for (int v = tid; v < V; v += nt)
        for (int q = pb[v]; q < pb[v + 1]; ++q) pcls[q] = (unsigned short)v;
    const int np = pb[V];
    __syncthreads();

    for (int t = t0; t < t1; ++t) {
        float* out = gb + (size_t)t * V;
        if (t >= t_end) {
            for (int v = tid; v < V; v += nt) out[v] = 0.f;
            continue;
        }
        const float* ar = ab + (size_t)t * S;
        const float* br = bb + (size_t)t * S;
        float z = 0.f;
        for (int s = tid; s < n_valid; s += nt) {
            const float gv = expf(ar[s] + br[s] - ll);
            g[s] = gv;
            z += gv;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
        if (lane == 0) zw[warp] = z;
        __syncthreads();
        float zt = 0.f;
        for (int w = 0; w < nt / 32; ++w) zt += zw[w];
        for (int q = tid; q < np; q += nt) {
            const int v = pcls[q];
            const int j0 = off[v] + (q - pb[v]) * PIECE, j1 = min(j0 + PIECE, off[v + 1]);
            float acc = 0.f;
#pragma unroll 8
            for (int j = j0; j < j1; ++j) acc += g[order[j]];
            part[q] = acc;
        }
        __syncthreads();
        for (int v = tid; v < V; v += nt) {
            float acc = 0.f;
#pragma unroll 8
            for (int q = pb[v]; q < pb[v + 1]; ++q) acc += part[q];
            out[v] = zt > 0.f ? -acc / zt : 0.f;
        }
    }
}

int sweep_width(int S, int C) { return (((S + C - 1) / C) + 4 + 3) & ~3; }

int sweep_bytes(int S, int V, int C) {
    return SWEEP_HEAD + (2 * sweep_width(S, C) + RING * ((V + 3) & ~3)) * (int)sizeof(float);
}

int collect_bytes(int S, int V) { return 6 * S + 8 * (V + 1) + 6 * ((S + PIECE - 1) / PIECE + V) + 128; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int KPT, bool RINGED, bool CLUSTERED>
int launch_sweep(const float* lp, const int* labels, const int* t_lens, const int* lab_lens, float* alpha,
                 float* beta, int B, int T, int S, int V, int blank, int C, int threads, cudaStream_t stream) {
    auto kernel = ctc_sweep_kernel<KPT, RINGED, CLUSTERED>;
    const int smem = sweep_bytes(S, V, C);
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 2 * B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = CLUSTERED ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, kernel, lp, labels, t_lens, lab_lens, alpha, beta, T, S, V, sweep_width(S, C), blank);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <bool RINGED, bool CLUSTERED>
int dispatch_sweep(const float* lp, const int* labels, const int* t_lens, const int* lab_lens, float* alpha,
                   float* beta, int B, int T, int S, int V, int blank, int C, int threads, int kpt, cudaStream_t st) {
    switch (kpt) {
        case 1: return launch_sweep<1, RINGED, CLUSTERED>(lp, labels, t_lens, lab_lens, alpha, beta, B, T, S, V, blank, C, threads, st);
        case 2: return launch_sweep<2, RINGED, CLUSTERED>(lp, labels, t_lens, lab_lens, alpha, beta, B, T, S, V, blank, C, threads, st);
        case 4: return launch_sweep<4, RINGED, CLUSTERED>(lp, labels, t_lens, lab_lens, alpha, beta, B, T, S, V, blank, C, threads, st);
        default: return launch_sweep<8, RINGED, CLUSTERED>(lp, labels, t_lens, lab_lens, alpha, beta, B, T, S, V, blank, C, threads, st);
    }
}

}  // namespace

// lp (B, T, V) f32, labels (B, (S-1)/2) int32, t_lens and lab_lens (B,)
// int32; loss (B,), grad (B, T, V), and the scratches alpha and beta (B, T,
// S), f32. The plan (cluster C, threads a CTA, states a thread KPT) comes from
// ops/ctc_fused.py `ctc_plan`; a plan or a shape the kernels cannot run
// returns cudaErrorInvalidValue, a refused launch its own error.
extern "C" int ssak_ctc_fused(const void* lp, const void* labels, const void* t_lens, const void* lab_lens,
                              void* loss, void* grad, void* alpha, void* beta, int B, int T, int S, int V, int blank,
                              int zero_inf, int C, int threads, int kpt, void* stream) {
    const int widest = (S + C - 1) / C;
    const bool plan_ok = C >= 1 && C <= MAX_CLUSTER && threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0 &&
                         (kpt == 1 || kpt == 2 || kpt == 4 || kpt == 8) && threads * kpt >= widest &&
                         (C == 1 || S / C >= 2);
    if (!plan_ok || B < 1 || T < 1 || S < 1 || S % 2 == 0 || S > 65535 || V < 1 || blank < 0 || blank >= V ||
        sweep_bytes(S, V, C) > SMEM_LIMIT || collect_bytes(S, V) > SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float* lpf = (const float*)lp;
    const int *lab = (const int*)labels, *tl = (const int*)t_lens, *ll = (const int*)lab_lens;
    float *al = (float*)alpha, *be = (float*)beta;
    if (kSweeps) {
        // the ring's bulk copies want 16-byte rows at 16-byte addresses
        const bool ringed = V % 4 == 0 && (uintptr_t)lp % 16 == 0;
        const int rc = ringed ? (C > 1 ? dispatch_sweep<true, true>(lpf, lab, tl, ll, al, be, B, T, S, V, blank, C, threads, kpt, st)
                                       : dispatch_sweep<true, false>(lpf, lab, tl, ll, al, be, B, T, S, V, blank, C, threads, kpt, st))
                              : (C > 1 ? dispatch_sweep<false, true>(lpf, lab, tl, ll, al, be, B, T, S, V, blank, C, threads, kpt, st)
                                       : dispatch_sweep<false, false>(lpf, lab, tl, ll, al, be, B, T, S, V, blank, C, threads, kpt, st));
        if (rc != 0) return rc;
    }
    if (kCollect) {
        const int smem = collect_bytes(S, V);
        cudaError_t err = allow_smem(ctc_collect_kernel, smem);
        if (err != cudaSuccess) return (int)err;
        ctc_collect_kernel<<<dim3((T + COLLECT_FRAMES - 1) / COLLECT_FRAMES, B), COLLECT_THREADS, smem, st>>>(
            lab, tl, ll, al, be, (float*)loss, (float*)grad, T, S, V, blank, zero_inf);
        return (int)cudaGetLastError();
    }
    return 0;
}
