// Segmented step-layer lookup for Hopper (sm_90a): level 2 of the
// two-level scheme for step layers wider than one plane.
//
// Replaces the TPU kernel `segmented_step_lookup_pallas` of the JAX package
// (src/repro/kernels/index_lookup/kernel.py:136, body `_seg_step_kernel`
// :124).  There the host gathers, for every query, its own 128-wide segment
// of the layer's keys, pos_lo and pos_hi into (Q, 128) int32 arrays
// (ops.py:56-77; 1.5 KB per query, about 1.6 GB at Q = 2^20) and the
// kernel counts `seg_keys <= q` per row.  Here the kernel takes each
// query's segment base g*128 (from a search over the sampled grid, outside
// the kernel as in the reference) and reads the segment straight from the
// layer's arrays, entry base + t clipped at P - 1 as the reference's gather
// clips it:
//
//   k_t = keys[min(base + t, P - 1)],  t = 0 .. SEG - 1
//   i   = max(#{t : k_t <= q} - 1, 0)
//   (lo, hi) = (pos_lo[min(base + i, P - 1)], pos_hi[min(base + i, P - 1)])
//
// Design.  One thread per query.  The clipped segment is non-decreasing, so
// an upper-bound binary search over t (log2(128) + 1 = 8 probes) gives the
// same count as the compare-count; its loads hit the layer's arrays in
// global memory (an ~81 k-entry layer is 325 KB of keys, resident in the
// 50 MB L2 after the first batch).  Queries are read and lo/hi written
// coalesced.
//
// Bound.  4Q (queries) + 4Q (bases) + 8Q (lo, hi) bytes, plus the layer
// entries the queries' segments hold (each read once: 4 B of key per entry
// of a touched segment and 8 B of positions per distinct entry chosen),
// and eight compares per query.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK_Q 256
#ifndef SEG
#error "build with -DSEG=<segment width> (kernel.py passes it)"
#endif

__global__ void __launch_bounds__(BLOCK_Q)
segmented_step_lookup_kernel(const int32_t* __restrict__ queries,
                             const int32_t* __restrict__ seg_base, int Q,
                             const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ pos_lo,
                             const int32_t* __restrict__ pos_hi, int P,
                             int32_t* __restrict__ lo_out,
                             int32_t* __restrict__ hi_out) {
    const int qi = blockIdx.x * BLOCK_Q + threadIdx.x;
    if (qi >= Q) {
        return;
    }
    const int32_t q = queries[qi];
    const int base = seg_base[qi];
    const int last = P - 1;
    int a = 0, b = SEG;
    while (a < b) {
        const int mid = (a + b) >> 1;
        if (keys[min(base + mid, last)] <= q) {
            a = mid + 1;
        } else {
            b = mid;
        }
    }
    const int i = min(base + (a > 0 ? a - 1 : 0), last);
    lo_out[qi] = pos_lo[i];
    hi_out[qi] = pos_hi[i];
}

extern "C" int segmented_step_lookup_launch(const void* queries,
                                            const void* seg_base, int Q,
                                            const void* keys,
                                            const void* pos_lo,
                                            const void* pos_hi, int P,
                                            void* lo_out, void* hi_out,
                                            void* stream) {
    if (Q <= 0 || P <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int blocks = (Q + BLOCK_Q - 1) / BLOCK_Q;
    segmented_step_lookup_kernel<<<blocks, BLOCK_Q, 0,
                                   (cudaStream_t)stream>>>(
        (const int32_t*)queries, (const int32_t*)seg_base, Q,
        (const int32_t*)keys, (const int32_t*)pos_lo, (const int32_t*)pos_hi,
        P, (int32_t*)lo_out, (int32_t*)hi_out);
    return (int)cudaGetLastError();
}

extern "C" const char* segmented_step_lookup_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
