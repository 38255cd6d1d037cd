// Batched affine candidate scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel `affine_scores_pallas` of the JAX package
// (src/repro/kernels/candidate_score/kernel.py:34, body `_score_kernel` at
// :26).  The AirTune sweep engine ranks every candidate layer of a search
// vertex by its mean read cost under an affine storage tier
// T(delta) = ell + delta * inv_bw.  Given the (C, S) float32 matrix W of
// per-query prediction widths (one row per candidate, all at the same S
// sampled keys) and the (S,) float32 key weights wt, one launch writes
//
//   out[c] = sum_s (ell + W[c, s] * inv_bw) * wt[s] / sum_s wt[s]
//
// for every c, in float32.  The scores only rank candidates; the exact
// Eq. (6) costs of the selected ones stay float64 on the host.  Any C >= 1
// and S >= 1 is taken; the caller pads nothing (the TPU kernel needed C
// padded to 8 and S to 128).
//
// Bound.  The work reads W once (4CS bytes), wt once (4S) and writes 4C
// bytes; it does 3CS float32 operations.  At the tuner's shape (C = 39,
// S = 65,654) that is 10,504,796 B, 3.136 us at the H100's 3.35 TB/s: it is
// bound by bytes, and a row alone (256 KB) is far too little for one SM to
// stream at the card's rate.
//
// Design.  The grid is (C, n_split): S is cut across n_split blocks a row,
// n_split a pure function of (C, S, SM count) that the wrapper computes
// (kernel.py `split_count`: about two blocks an SM in all), so at C = 39 the
// 273 blocks cover every SM instead of 39 of them.  Each block of 512 threads
// streams its share of the row with 16-byte loads, UNROLL of them issued
// together a thread before any is used
// (W with the evict-first hint, wt through the read-only path: it is read
// again by every row, from L2).  Row c starts at element c * S, so when
// S % 4 != 0 the row is off 16-byte alignment by A = (-c * S) mod 4 elements
// while wt is not: the A leading elements (the head) and the elements past
// the last whole vector (the tail, at most 7) are read in scalar by split 0;
// the body's vector j covers elements A + 4j .. A + 4j + 3, whose weights
// straddle wt's aligned vectors j and j + 1.  The kernel is instantiated for
// each A (a block's A is uniform), loads both aligned wt vectors and picks
// the four it needs in registers, so no misaligned vector load is issued.
//
// Combine, in the same launch and with no float atomics.  Each block sums
// its (num, den) pair (warp shuffles, then across the 16 warps in shared
// memory) and writes it to a (C, n_split) workspace; after __threadfence()
// thread 0 takes a ticket from the row's counter (atomicAdd on an int).
// The block that draws the last ticket sums the row's partials in split
// order, writes out[c] = num / den and sets the counter back to 0 for the
// next launch.  Every sum runs in a fixed order, so two launches on the
// same input give bit-equal scores and rankings do not flicker.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 512          // threads a block
#define UNROLL 4           // 16-byte loads of W a thread issues at once
#define WARPS (BLOCK / 32)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// the weights of elements 4j + A .. 4j + A + 3 from wt's aligned vectors
// j (a) and j + 1 (b)
template <int A>
__device__ __forceinline__ float4 pick(const float4& a, const float4& b) {
    if (A == 1) return make_float4(a.y, a.z, a.w, b.x);
    if (A == 2) return make_float4(a.z, a.w, b.x, b.y);
    return make_float4(a.w, b.x, b.y, b.z);
}

// Vectors [j0, j1) of a row whose body starts A elements in (w4: the
// row's first aligned vector; wt4: wt's).
template <int A>
__device__ __forceinline__ void stream_body(const float4* __restrict__ w4,
                                            const float4* __restrict__ wt4,
                                            int j0, int j1, float ell,
                                            float inv_bw, float& num,
                                            float& den) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = j0 + (int)threadIdx.x; j < j1; j += UNROLL * BLOCK) {
        float4 w[UNROLL], t[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {        // every load first ...
            const int k = j + u * BLOCK;
            w[u] = zero;                          // weight 0: adds nothing
            t[u] = zero;
            if (k < j1) {
                w[u] = __ldcs(w4 + k);
                t[u] = A == 0 ? __ldg(wt4 + k)
                              : pick<A>(__ldg(wt4 + k), __ldg(wt4 + k + 1));
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {        // ... then the sums
            num += (ell + w[u].x * inv_bw) * t[u].x
                   + (ell + w[u].y * inv_bw) * t[u].y
                   + (ell + w[u].z * inv_bw) * t[u].z
                   + (ell + w[u].w * inv_bw) * t[u].w;
            den += (t[u].x + t[u].y) + (t[u].z + t[u].w);
        }
    }
}

__global__ void __launch_bounds__(BLOCK)
candidate_score_kernel(const float* __restrict__ widths,
                       const float* __restrict__ weights, int S,
                       float ell, float inv_bw, float2* __restrict__ part,
                       unsigned* __restrict__ tickets,
                       float* __restrict__ out) {
    __shared__ float s_num[WARPS];
    __shared__ float s_den[WARPS];
    const int c = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
    const size_t row0 = (size_t)c * (size_t)S;
    const float* row = widths + row0;
    const int A = (int)((4 - (row0 & 3)) & 3);     // elements before alignment
    // whole vectors: W's in the row, and for A > 0 wt's vector j + 1 too
    int nv = S >= A ? (S - A) / 4 : 0;
    if (A > 0) nv = min(nv, S >= 4 ? (S - 4) / 4 : 0);
    const int per = (nv + n_split - 1) / n_split;
    const int j0 = min(split * per, nv), j1 = min(j0 + per, nv);

    float num = 0.0f, den = 0.0f;
    if (split == 0) {                   // the scalar head and tail
        const int head = min(A, S), tail0 = head + 4 * nv;
        for (int e = threadIdx.x; e < S - 4 * nv; e += BLOCK) {
            const int s = e < head ? e : tail0 + (e - head);
            const float w = __ldg(weights + s);
            num += (ell + row[s] * inv_bw) * w;
            den += w;
        }
    }
    const float4* w4 = reinterpret_cast<const float4*>(row + A);
    const float4* wt4 = reinterpret_cast<const float4*>(weights);
    switch (A) {
    case 0: stream_body<0>(w4, wt4, j0, j1, ell, inv_bw, num, den); break;
    case 1: stream_body<1>(w4, wt4, j0, j1, ell, inv_bw, num, den); break;
    case 2: stream_body<2>(w4, wt4, j0, j1, ell, inv_bw, num, den); break;
    default: stream_body<3>(w4, wt4, j0, j1, ell, inv_bw, num, den); break;
    }

    num = warp_sum(num);
    den = warp_sum(den);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        s_num[warp] = num;
        s_den[warp] = den;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    num = 0.0f;
    den = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        num += s_num[w];
        den += s_den[w];
    }
    if (n_split == 1) {
        out[c] = num / den;
        return;
    }
    part[(size_t)c * n_split + split] = make_float2(num, den);
    __threadfence();                    // the partial is visible first
    if (atomicAdd(tickets + c, 1u) != (unsigned)(n_split - 1)) return;
    __threadfence();                    // ... then the others' partials
    num = 0.0f;
    den = 0.0f;
    for (int i = 0; i < n_split; ++i) {
        const float2 p = __ldcg(part + (size_t)c * n_split + i);
        num += p.x;
        den += p.y;
    }
    out[c] = num / den;
    tickets[c] = 0u;                    // ready for the next launch
}

// C entry point, bound with ctypes.  All pointers are device pointers on the
// stream's device; the wrapper (kernels/candidate_score/kernel.py) has
// checked dtype, shape, contiguity, 16-byte alignment and device, and gives
// a (C, n_split) float2 workspace and C ticket counters that are 0 (each
// launch leaves them 0).  Returns cudaGetLastError().
extern "C" int candidate_score_launch(const void* widths, const void* weights,
                                      int C, int S, float ell, float inv_bw,
                                      int n_split, void* part, void* tickets,
                                      void* out, void* stream) {
    if (C < 1 || S < 1 || n_split < 1 || n_split > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    candidate_score_kernel<<<dim3(C, n_split), BLOCK, 0,
                             (cudaStream_t)stream>>>(
        (const float*)widths, (const float*)weights, S, ell, inv_bw,
        (float2*)part, (unsigned*)tickets, (float*)out);
    return (int)cudaGetLastError();
}

extern "C" const char* candidate_score_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
