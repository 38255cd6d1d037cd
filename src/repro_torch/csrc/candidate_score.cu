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
// Eq. (6) costs of the selected ones stay float64 on the host.
//
// Design.  One block of 512 threads per candidate row.  Threads stride over
// S (neighbouring threads on neighbouring addresses, so loads coalesce),
// accumulating the numerator and sum(wt) in float32 registers; the loop is
// unrolled four times so several loads are in flight per thread.  The two
// sums are reduced with warp shuffles, then across the 16 warps through
// shared memory, and thread 0 writes num / den.  Any C >= 1 and S >= 1 is
// taken: the ragged edge of S is masked by the loop bound, so the caller
// pads nothing (the TPU kernel needed C padded to 8 and S to 128).
//
// Bound.  The work reads W once (4CS bytes), wt once (4S) and writes 4C
// bytes; it does 3CS float32 operations.  At the tuner's shape
// (C <= 39, S ~ 65.5k) that is about 10 MB, about 3 us at the H100's
// 3.35 TB/s, so it is bound by bytes.  With one block per row, C <= 39
// blocks occupy at most 39 of the 132 SMs and each SM streams its row
// alone, so this simple design stays well short of the bound; splitting
// S across blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 512
#define WARPS (BLOCK / 32)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

__global__ void __launch_bounds__(BLOCK)
candidate_score_kernel(const float* __restrict__ widths,
                       const float* __restrict__ weights,
                       int S, float ell, float inv_bw,
                       float* __restrict__ out) {
    __shared__ float s_num[WARPS];
    __shared__ float s_den[WARPS];
    const float* row = widths + (size_t)blockIdx.x * (size_t)S;
    float num = 0.0f, den = 0.0f;
#pragma unroll 4
    for (int s = threadIdx.x; s < S; s += BLOCK) {
        const float w = weights[s];
        num += (ell + row[s] * inv_bw) * w;
        den += w;
    }
    num = warp_sum(num);
    den = warp_sum(den);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        s_num[warp] = num;
        s_den[warp] = den;
    }
    __syncthreads();
    if (warp == 0) {
        num = lane < WARPS ? s_num[lane] : 0.0f;
        den = lane < WARPS ? s_den[lane] : 0.0f;
        num = warp_sum(num);
        den = warp_sum(den);
        if (lane == 0) out[blockIdx.x] = num / den;
    }
}

// C entry point, bound with ctypes.  All pointers are device pointers on the
// stream's device; the wrapper (kernels/candidate_score/kernel.py) has
// checked dtype, shape, contiguity and device.  Returns cudaGetLastError().
extern "C" int candidate_score_launch(const void* widths, const void* weights,
                                      int C, int S, float ell, float inv_bw,
                                      void* out, void* stream) {
    candidate_score_kernel<<<C, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)widths, (const float*)weights, S, ell, inv_bw,
        (float*)out);
    return (int)cudaGetLastError();
}

extern "C" const char* candidate_score_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
