// Fused CTC forward-backward: per-row loss and d loss / d log_probs in one launch.
//
//   alpha[t, s] = logsumexp(alpha[t-1, s], alpha[t-1, s-1], allow[s] ? alpha[t-1, s-2])
//                 + lp[t, ext[s]]                       (frozen for t >= t_len)
//   ll          = logsumexp(alpha[last, 2L], alpha[last, max(2L-1, 0)]),  loss = -ll
//   beta[t-1]   = logsumexp over s, s+1, s+2 (allowed) of beta[t] + lp[t, ext[.]]
//   grad[t, v]  = -sum_{s : ext[s] = v} exp(alpha[t, s] + beta[t, s] - ll)   (t < t_len; 0 past it)
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
// chain. The forward is T-1 dependent steps and the backward T more, each a
// block-wide barrier plus a few expf/logf per state: 1,497 steps at T = 749.
// The bytes the function must move (lp read once, grad written once) are
// about 6.2 MB at B = 32, T = 749, V = 32, i.e. 1.8 us at 3.35 TB/s, and its
// ~32 f32 operations per live (t, s) state take 3.9 us at 67 TFLOP/s; the
// kernel sits orders of magnitude above both, on latency.
//
// Design: one block per batch row, threads looping over the S = 2U+1 states.
// The (T, S) alpha table does not fit in shared memory (1.5 MB per row at
// T = 749, S = 513), so alpha lives in a global scratch (B, T, S) f32 that the
// wrapper allocates; only the previous and current rows are kept in shared
// memory, double-buffered, so each time step costs exactly one barrier. The
// TPU kernel's one-hot (V, S) matmuls become an indexed load lp[t, ext[s]]
// (a 128-byte row at V = 32, served from L1) and a shared-memory atomicAdd
// into V bins per time step; the bins are double-buffered too, so a row of
// grad is flushed (and its bins cleared) in the step after it was summed,
// under the same single barrier. Rows t >= t_len are written as zeros up
// front. Later work: split S across a cluster, run alpha and beta
// concurrently, keep only every k-th alpha row.
//
// Shared memory: 4 S + 2 V words (alpha/beta rows x 2, ext, allow, bins x 2);
// the wrapper raises where that exceeds what a block may use.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
    const float m = fmaxf(a, fmaxf(b, c));
    const float r = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
    return (m <= NEG / 2) ? NEG : r;
}

// lp[t, e] for a label e in the vocabulary, else 0 (the TPU kernel's one-hot product)
__device__ __forceinline__ float emission(const float* row, int e, int V) {
    return (unsigned)e < (unsigned)V ? __ldg(row + e) : 0.f;
}

__global__ void ctc_fused_kernel(const float* __restrict__ lp, const int* __restrict__ ext,
                                 const int* __restrict__ allow, const int* __restrict__ t_lens,
                                 const int* __restrict__ lab_lens, float* __restrict__ loss,
                                 float* __restrict__ grad, float* __restrict__ alpha,
                                 int T, int S, int V) {
    extern __shared__ float smem[];
    float* buf0 = smem;                       // alpha rows, then beta rows (ping-pong)
    float* buf1 = smem + S;
    int* ext_s = reinterpret_cast<int*>(smem + 2 * S);
    int* allow_s = ext_s + S;
    float* bins0 = smem + 4 * S;              // gradient bins (ping-pong)
    float* bins1 = bins0 + V;
    __shared__ float ll_s;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const float* lpb = lp + (size_t)b * T * V;
    float* gb = grad + (size_t)b * T * V;
    float* ab = alpha + (size_t)b * T * S;
    const int t_len = t_lens[b];
    const int L = max(0, min(lab_lens[b], (S - 1) / 2));
    const int n_valid = 2 * L + 1;

    for (int s = tid; s < S; s += nt) {
        ext_s[s] = ext[(size_t)b * S + s];
        allow_s[s] = allow[(size_t)b * S + s];
    }
    for (int v = tid; v < V; v += nt) {
        bins0[v] = 0.f;
        bins1[v] = 0.f;
    }
    // rows past the valid length get a zero gradient
    const int t_end = max(0, min(t_len, T));
    for (size_t i = (size_t)t_end * V + tid; i < (size_t)T * V; i += nt) gb[i] = 0.f;
    __syncthreads();

    // --- forward alpha ---------------------------------------------------------
    for (int s = tid; s < S; s += nt) {
        const float a = (s < 2 && s < n_valid) ? emission(lpb, ext_s[s], V) : NEG;
        buf0[s] = a;
        ab[s] = a;
    }
    __syncthreads();
    const int t_last = max(1, min(t_len, T)) - 1;  // alpha is frozen after this row
    for (int t = 1; t <= t_last; ++t) {
        const float* prev = (t & 1) ? buf0 : buf1;
        float* cur = (t & 1) ? buf1 : buf0;
        const float* row = lpb + (size_t)t * V;
        float* arow = ab + (size_t)t * S;
        for (int s = tid; s < S; s += nt) {
            const float p0 = prev[s];
            const float p1 = s >= 1 ? prev[s - 1] : NEG;
            const float p2 = (s >= 2 && allow_s[s]) ? prev[s - 2] : NEG;
            const float a = s < n_valid ? lse3(p0, p1, p2) + emission(row, ext_s[s], V) : NEG;
            cur[s] = a;
            arow[s] = a;
        }
        __syncthreads();
    }

    // --- log-likelihood ----------------------------------------------------------
    if (tid == 0) {
        const float* fin = (t_last & 1) ? buf1 : buf0;
        const float a1 = fin[2 * L];
        const float a2 = fin[max(2 * L - 1, 0)];
        const float m = fmaxf(a1, a2);
        const float ll = m + logf(expf(a1 - m) + expf(a2 - m));
        loss[b] = -ll;
        ll_s = ll;
    }
    __syncthreads();
    const float ll = ll_s;

    // --- backward beta + gradient ---------------------------------------------------
    const int t_start = t_end - 1;  // last row with t < t_len; -1: no row is valid
    if (t_start < 0) return;
    {
        float* init = (t_start & 1) ? buf1 : buf0;
        const int e1 = 2 * L, e2 = max(2 * L - 1, 0);
        for (int s = tid; s < S; s += nt) init[s] = (s < n_valid && (s == e1 || s == e2)) ? 0.f : NEG;
    }
    __syncthreads();
    for (int t = t_start; t >= 0; --t) {
        const float* bcur = (t & 1) ? buf1 : buf0;
        float* bnext = (t & 1) ? buf0 : buf1;
        float* bins = (t & 1) ? bins1 : bins0;
        float* done = (t & 1) ? bins0 : bins1;  // row t+1, summed in the previous step
        if (t < t_start) {
            float* out = gb + (size_t)(t + 1) * V;
            for (int v = tid; v < V; v += nt) {
                out[v] = done[v];
                done[v] = 0.f;
            }
        }
        const float* row = lpb + (size_t)t * V;
        const float* arow = ab + (size_t)t * S;
        for (int s = tid; s < S; s += nt) {
            if (s >= n_valid) {  // alpha = beta = NEG there: exp(...) is exactly 0
                bnext[s] = NEG;
                continue;
            }
            const float be = bcur[s];
            if ((unsigned)ext_s[s] < (unsigned)V) atomicAdd(&bins[ext_s[s]], -expf(arow[s] + be - ll));
            if (t > 0) {
                const float n0 = be + emission(row, ext_s[s], V);
                const float n1 = s + 1 < S ? bcur[s + 1] + emission(row, ext_s[s + 1], V) : NEG;
                const float n2 = (s + 2 < S && allow_s[s + 2]) ? bcur[s + 2] + emission(row, ext_s[s + 2], V) : NEG;
                bnext[s] = lse3(n0, n1, n2);
            }
        }
        __syncthreads();
    }
    for (int v = tid; v < V; v += nt) gb[v] = bins0[v];
}

}  // namespace

extern "C" int ssak_ctc_fused_smem_bytes(int S, int V) { return (4 * S + 2 * V) * (int)sizeof(float); }

extern "C" int ssak_ctc_fused(const void* lp, const void* ext, const void* allow, const void* t_lens,
                              const void* lab_lens, void* loss, void* grad, void* alpha,
                              int B, int T, int S, int V, void* stream) {
    const int smem = ssak_ctc_fused_smem_bytes(S, V);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(ctc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    int threads = ((S + 31) / 32) * 32;
    threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
    ctc_fused_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)lp, (const int*)ext, (const int*)allow, (const int*)t_lens, (const int*)lab_lens,
        (float*)loss, (float*)grad, (float*)alpha, T, S, V);
    return (int)cudaGetLastError();
}
