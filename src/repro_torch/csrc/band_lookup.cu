// Batched band-layer lookup for Hopper (sm_90a): one layer of the in-memory
// Alg. 1.
//
// Replaces the TPU kernel `band_lookup_pallas` of the JAX package
// (src/repro/kernels/index_lookup/kernel.py:104, body `_band_kernel` :87).
// For Q int32 query keys against one band layer of P <= MAX_P nodes (node
// keys sorted, strictly increasing; x1, y1, m and the slack-widened delta
// in float32):
//
//   j   = max(#{node_keys <= q} - 1, 0)
//   mid = y1[j] + m[j] * (f32(q) - x1[j])
//   lo  = floor(mid - delta[j]),  hi = max(ceil(mid + delta[j]), lo + 1)
//
// Design.  As step_lookup.cu: the node keys (at most 16 KB) are staged in
// shared memory once per block, a capped grid walks the queries one thread
// each, and an upper-bound binary search over the unpadded keys gives the
// TPU kernel's compare-count rank.  The node's four parameters are read
// from global memory at j.  The line is evaluated with __fsub_rn /
// __fmul_rn / __fadd_rn, which forbids FMA contraction, so the result is
// bit-identical to the plain PyTorch version (separately rounded f32 ops).
//
// Bound.  4Q (queries) + 20P (keys, x1, y1, m, delta) + 8Q (lo, hi) bytes
// and ceil(log2(P+1)) compares plus seven f32 operations per query.  At a
// serving batch (Q = 4096, P = 4096) that is 131,072 B, about 0.04 us at
// 3.35 TB/s: one launch is bound by launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK_Q 256
#define BLOCKS_PER_SM 8
#ifndef MAX_P
#error "build with -DMAX_P=<layer width cap> (kernel.py passes it)"
#endif

__global__ void __launch_bounds__(BLOCK_Q)
band_lookup_kernel(const int32_t* __restrict__ queries, int Q,
                   const int32_t* __restrict__ keys,
                   const float* __restrict__ x1,
                   const float* __restrict__ y1,
                   const float* __restrict__ m,
                   const float* __restrict__ delta, int P,
                   int32_t* __restrict__ lo_out,
                   int32_t* __restrict__ hi_out) {
    __shared__ int32_t s_keys[MAX_P];
    for (int j = threadIdx.x; j < P; j += BLOCK_Q) {
        s_keys[j] = keys[j];
    }
    __syncthreads();
    for (int qi = blockIdx.x * BLOCK_Q + threadIdx.x; qi < Q;
         qi += gridDim.x * BLOCK_Q) {
        const int32_t q = queries[qi];
        int a = 0, b = P;
        while (a < b) {
            const int mid = (a + b) >> 1;
            if (s_keys[mid] <= q) {
                a = mid + 1;
            } else {
                b = mid;
            }
        }
        const int j = a > 0 ? a - 1 : 0;
        const float mid = __fadd_rn(
            y1[j], __fmul_rn(m[j], __fsub_rn(__int2float_rn(q), x1[j])));
        const float d = delta[j];
        const int32_t lo = (int32_t)floorf(__fsub_rn(mid, d));
        const int32_t hi = (int32_t)ceilf(__fadd_rn(mid, d));
        lo_out[qi] = lo;
        hi_out[qi] = max(hi, lo + 1);
    }
}

extern "C" int band_lookup_launch(const void* queries, int Q,
                                  const void* keys, const void* x1,
                                  const void* y1, const void* m,
                                  const void* delta, int P,
                                  void* lo_out, void* hi_out, void* stream) {
    if (Q <= 0 || P <= 0 || P > MAX_P) {
        return (int)cudaErrorInvalidValue;
    }
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int blocks = (Q + BLOCK_Q - 1) / BLOCK_Q;
    if (sms > 0 && blocks > sms * BLOCKS_PER_SM) {
        blocks = sms * BLOCKS_PER_SM;
    }
    band_lookup_kernel<<<blocks, BLOCK_Q, 0, (cudaStream_t)stream>>>(
        (const int32_t*)queries, Q, (const int32_t*)keys, (const float*)x1,
        (const float*)y1, (const float*)m, (const float*)delta, P,
        (int32_t*)lo_out, (int32_t*)hi_out);
    return (int)cudaGetLastError();
}

extern "C" const char* band_lookup_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
