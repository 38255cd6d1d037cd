// Batched band-layer lookup for Hopper (sm_90a): one layer of the in-memory
// Alg. 1.
//
// Replaces the TPU kernel `band_lookup_pallas` of the JAX package
// (src/repro/kernels/index_lookup/kernel.py:104, body `_band_kernel` :87).
// For Q int32 query keys against one band layer of P <= MAX_P nodes (node
// keys sorted, strictly increasing; x1, y1, m and the slack-widened delta
// in float32), into one (2, Q) int32 buffer (lo at [0, q], hi at [1, q]):
//
//   j   = max(#{node_keys <= q} - 1, 0)
//   mid = y1[j] + m[j] * (f32(q) - x1[j])
//   lo  = floor(mid - delta[j]),  hi = max(ceil(mid + delta[j]), lo + 1)
//
// Design.  At a serving batch a launch costs the chain of dependent global
// round trips each query waits for, so a query makes one: its own load.
// Each block copies the node keys and, for a layer of at most
// STAGE_PARAMS_MAX nodes (16 KB of parameters), x1, y1, m and delta into
// shared memory with 4-byte cp.async copies, and loads its first queries
// while those are in flight.  The keys are padded to a power of two np with
// KEY_PAD and each key's bank is XORed with its 32-key row: the probes of
// one step of a power-of-two search are equal modulo 32, and unswizzled
// they would queue on one bank.  Every thread runs the same log2(np) steps
// of a branch-free search for the last key <= q from slot 0.  Padded
// entries never count for an int32 query below KEY_PAD; a query equal to
// KEY_PAD counts them all, and the slot is clipped at P - 1, which is what
// the plain version's search over the unpadded keys returns.  The four
// parameters of a node lie together as one float4, read in one shared load
// (a wider layer reads them from global memory, as one wave).  Where the
// capped grid covers the batch (4,096 keys: 16 blocks) a thread takes one
// query; a larger batch runs a persistent grid of BLOCKS_PER_SM blocks a
// multiprocessor whose threads carry DEEP_ITEMS queries a pass, strided by
// the grid's width so loads and stores stay coalesced, with the next pass's
// queries loaded before this pass's search.  The line is evaluated with
// __fsub_rn / __fmul_rn / __fadd_rn, which forbids FMA contraction, so the
// result is bit-identical to the plain PyTorch version (separately rounded
// f32 ops).
//
// Bound.  4Q (queries) + 20P (keys, x1, y1, m, delta) + 8Q (lo, hi) bytes
// and ceil(log2(P+1)) compares plus seven f32 operations per query.  At a
// serving batch (Q = 4096, P = 171) that is 52,572 B, about 0.016 us at
// 3.35 TB/s: one launch is bound by launch latency.  At Q = 2^20 it is
// 12.6 MB, about 3.76 us.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// the launch geometry (`probes/lookup_kernels.py --sweep` times others)
#define BLOCK_Q 256
#define BLOCKS_PER_SM 4
#define DEEP_ITEMS 4
#define STAGE_PARAMS_MAX 1024
#define KEY_PAD 2147483647
#define MAX_DEVICES 64
#ifndef MAX_P
#error "build with -DMAX_P=<layer width cap> (kernel.py passes it)"
#endif
// a staged block holds at most 4 * 1024 + 16 * 1024 bytes, an unstaged one
// 4 * MAX_P: BLOCKS_PER_SM of either fit the 228 KB of a multiprocessor
static_assert(BLOCKS_PER_SM * 4 * (MAX_P > 5 * STAGE_PARAMS_MAX
                                       ? MAX_P : 5 * STAGE_PARAMS_MAX)
                  <= 200 * 1024,
              "shared memory of BLOCKS_PER_SM blocks exceeds a multiprocessor");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

// The shared-memory slot of key i: its bank XORed with its 32-key row, so
// the probes of one search step (all equal modulo 32 on a power-of-two
// array) fall in different banks.
__device__ __forceinline__ int slot(int i) { return i ^ ((i >> 5) & 31); }

// The queries of the pass at `first`: item i is query first + i * stride,
// 0 past the end (its window is never stored).
template <int ITEMS>
__device__ __forceinline__ void load_queries(int32_t (&q)[ITEMS],
                                             const int32_t* queries,
                                             long long first,
                                             long long stride, int Q) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const long long k = first + i * stride;
        q[i] = k < Q ? queries[k] : 0;
    }
}

template <bool STAGED, int ITEMS>
__global__ void __launch_bounds__(BLOCK_Q, BLOCKS_PER_SM)
band_lookup_kernel(const int32_t* __restrict__ queries, int Q,
                   const int32_t* __restrict__ keys,
                   const float* __restrict__ x1,
                   const float* __restrict__ y1,
                   const float* __restrict__ m,
                   const float* __restrict__ delta, int P, int np,
                   int32_t* __restrict__ out) {
    // np swizzled keys (P of them, then KEY_PAD; at least 4 slots), then,
    // staged, one float4 (x1, y1, m, delta) a node
    extern __shared__ __align__(16) int32_t smem[];
    int32_t* s_keys = smem;
    float4* s_par = reinterpret_cast<float4*>(smem + max(np, 4));
    for (int j = threadIdx.x; j < P; j += BLOCK_Q) {
        cp_async4(s_keys + slot(j), keys + j);
        if (STAGED) {
            float* par = reinterpret_cast<float*>(s_par + j);
            cp_async4(par, x1 + j);
            cp_async4(par + 1, y1 + j);
            cp_async4(par + 2, m + j);
            cp_async4(par + 3, delta + j);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int j = P + threadIdx.x; j < np; j += BLOCK_Q) {
        s_keys[slot(j)] = KEY_PAD;
    }
    const long long stride = (long long)gridDim.x * BLOCK_Q;
    long long first = (long long)blockIdx.x * BLOCK_Q + threadIdx.x;
    int32_t q[ITEMS];
    load_queries(q, queries, first, stride, Q);     // under the staging
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    while (first < Q) {
        const long long next = first + ITEMS * stride;
        int32_t qn[ITEMS];
        load_queries(qn, queries, next, stride, Q); // under this pass
        // j = the last slot whose key <= q, 0 where none is: log2(np)
        // halving steps from 0; clipped at P - 1 (KEY_PAD counts the pads)
        int j[ITEMS];
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) j[i] = 0;
        for (int step = np >> 1; step > 0; step >>= 1) {
#pragma unroll
            for (int i = 0; i < ITEMS; ++i) {
                j[i] += s_keys[slot(j[i] + step)] <= q[i] ? step : 0;
            }
        }
        float4 p[ITEMS];
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
            const int n = min(j[i], P - 1);
            p[i] = STAGED ? s_par[n]
                          : make_float4(x1[n], y1[n], m[n], delta[n]);
        }
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
            const float mid = __fadd_rn(
                p[i].y, __fmul_rn(p[i].z, __fsub_rn(__int2float_rn(q[i]),
                                                    p[i].x)));
            const int32_t lo = (int32_t)floorf(__fsub_rn(mid, p[i].w));
            const int32_t hi = (int32_t)ceilf(__fadd_rn(mid, p[i].w));
            const long long k = first + i * stride;
            if (k < Q) {
                out[k] = lo;
                out[Q + k] = max(hi, lo + 1);
            }
            q[i] = qn[i];
        }
        first = next;
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

template <bool STAGED, int ITEMS>
static void launch(int blocks, size_t smem, cudaStream_t st,
                   const void* queries, int Q, const void* keys,
                   const void* x1, const void* y1, const void* m,
                   const void* delta, int P, int np, void* out) {
    band_lookup_kernel<STAGED, ITEMS><<<blocks, BLOCK_Q, smem, st>>>(
        (const int32_t*)queries, Q, (const int32_t*)keys, (const float*)x1,
        (const float*)y1, (const float*)m, (const float*)delta, P, np,
        (int32_t*)out);
}

// C entry point, bound with ctypes.  All pointers are device pointers on the
// stream's device; the wrapper (kernels/index_lookup/kernel.py) has checked
// dtype, shape, contiguity and device.  out is the (2, Q) int32 buffer.
// Returns cudaGetLastError().
extern "C" int band_lookup_launch(const void* queries, int Q,
                                  const void* keys, const void* x1,
                                  const void* y1, const void* m,
                                  const void* delta, int P, void* out,
                                  void* stream) {
    if (Q <= 0 || P <= 0 || P > MAX_P) {
        return (int)cudaErrorInvalidValue;
    }
    int np = 1;                         // the least power of two >= P
    while (np < P) np *= 2;
    const bool staged = P <= STAGE_PARAMS_MAX;
    const size_t smem = sizeof(int32_t) * max(np, 4)
                        + (staged ? sizeof(float4) * P : 0);
    // one pass of one query a thread where the capped grid covers the
    // batch, else a persistent grid of DEEP_ITEMS queries a thread a pass
    const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
    const long long blocks = ((long long)Q + BLOCK_Q - 1) / BLOCK_Q;
    const cudaStream_t st = (cudaStream_t)stream;
    if (blocks <= cap) {
        (staged ? launch<true, 1> : launch<false, 1>)(
            (int)blocks, smem, st, queries, Q, keys, x1, y1, m, delta, P, np,
            out);
    } else {
        (staged ? launch<true, DEEP_ITEMS> : launch<false, DEEP_ITEMS>)(
            (int)cap, smem, st, queries, Q, keys, x1, y1, m, delta, P, np,
            out);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* band_lookup_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
