// Batched step-layer lookup for Hopper (sm_90a): one layer of the in-memory
// Alg. 1.
//
// Replaces the TPU kernel `step_lookup_pallas` of the JAX package
// (src/repro/kernels/index_lookup/kernel.py:67, body `_step_kernel` :57).
// For Q int32 query keys against one step layer of P <= MAX_P piece keys
// (sorted, strictly increasing) and their int32 positions:
//
//   i = max(#{keys <= q} - 1, 0);   (lo, hi) = (pos_lo[i], pos_hi[i])
//
// Design.  The TPU kernel pads the layer to 128 lanes with KEY_PAD and
// counts `keys <= q` over the whole plane, then gathers with a one-hot row
// sum.  Here each block stages the layer's keys (at most 16 KB) in shared
// memory once and walks a grid-stride loop over the queries, one thread per
// query: an upper-bound binary search over the unpadded keys gives the same
// rank for every int32 query (the padding is never <= a query below
// KEY_PAD, and a query equal to KEY_PAD sees P in both), and the two
// positions are read from global memory at i.  The grid is capped at 8
// blocks per SM so the staging is paid about a thousand times, not once
// per 256 queries.
//
// Bound.  Each input read once and each output written once: 4Q (queries)
// + 12P (keys, pos_lo, pos_hi) + 8Q (lo, hi) bytes, and ceil(log2(P+1))
// compares per query.  At a serving batch (Q = 4096, P = 4096) that is
// 81,920 B, about 0.024 us at 3.35 TB/s: one launch is bound by launch
// latency, not by the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define BLOCK_Q 256
#define BLOCKS_PER_SM 8
#define MAX_DEVICES 64
#ifndef MAX_P
#error "build with -DMAX_P=<layer width cap> (kernel.py passes it)"
#endif

__global__ void __launch_bounds__(BLOCK_Q)
step_lookup_kernel(const int32_t* __restrict__ queries, int Q,
                   const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ pos_lo,
                   const int32_t* __restrict__ pos_hi, int P,
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
        // upper bound: first index whose key is > q
        int a = 0, b = P;
        while (a < b) {
            const int mid = (a + b) >> 1;
            if (s_keys[mid] <= q) {
                a = mid + 1;
            } else {
                b = mid;
            }
        }
        const int i = a > 0 ? a - 1 : 0;
        lo_out[qi] = pos_lo[i];
        hi_out[qi] = pos_hi[i];
    }
}

// The multiprocessor count of the current device, read once per device.
static int sm_count() {
    static std::atomic<int> cached[MAX_DEVICES];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= MAX_DEVICES) dev = 0;
    int n = cached[dev].load(std::memory_order_relaxed);
    if (n == 0) {
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        n = n > 0 ? n : 1;
        cached[dev].store(n, std::memory_order_relaxed);
    }
    return n;
}

extern "C" int step_lookup_launch(const void* queries, int Q,
                                  const void* keys, const void* pos_lo,
                                  const void* pos_hi, int P,
                                  void* lo_out, void* hi_out, void* stream) {
    if (Q <= 0 || P <= 0 || P > MAX_P) {
        return (int)cudaErrorInvalidValue;
    }
    const int sms = sm_count();
    int blocks = (Q + BLOCK_Q - 1) / BLOCK_Q;
    if (blocks > sms * BLOCKS_PER_SM) {
        blocks = sms * BLOCKS_PER_SM;
    }
    step_lookup_kernel<<<blocks, BLOCK_Q, 0, (cudaStream_t)stream>>>(
        (const int32_t*)queries, Q, (const int32_t*)keys,
        (const int32_t*)pos_lo, (const int32_t*)pos_hi, P,
        (int32_t*)lo_out, (int32_t*)hi_out);
    return (int)cudaGetLastError();
}

extern "C" const char* step_lookup_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
