// Batched step-layer lookup for Hopper (sm_90a): one layer of the in-memory
// Alg. 1.
//
// Replaces the TPU kernel `step_lookup_pallas` of the JAX package
// (src/repro/kernels/index_lookup/kernel.py:67, body `_step_kernel` :57).
// For Q int32 query keys against one step layer of P <= MAX_P piece keys
// (sorted, strictly increasing) and their int32 positions, into one (2, Q)
// int32 buffer (lo at [0, q], hi at [1, q]):
//
//   i = max(#{keys <= q} - 1, 0);   (lo, hi) = (pos_lo[i], pos_hi[i])
//
// Design.  At a serving batch a launch costs the chain of dependent global
// round trips each query waits for, so a query makes one: its own load.
// Each block copies the layer into shared memory with 4-byte cp.async
// copies and loads its first queries while those are in flight: the keys,
// padded to a power of two np with KEY_PAD and each key's bank XORed with
// its 32-key row (the probes of one step of a power-of-two search are equal
// modulo 32, and unswizzled they would queue on one bank), and the
// positions.  Where pos_hi is pos_lo + 1 (both views of one piece_pos
// array, as every layer call passes them) the block stages those P + 1
// words once; else one int2 (pos_lo[i], pos_hi[i]) an entry.  At P = MAX_P
// that is 16 KB + 16 KB (or 32 KB) of dynamic shared memory a block.
// Every thread runs the same log2(np) steps of a branch-free search for the
// last key <= q from slot 0.  Padded entries never count for an int32 query
// below KEY_PAD; a query equal to KEY_PAD counts them all, and the slot is
// clipped at P - 1, which is what the plain version's search over the
// unpadded keys returns.  Then shared loads give both positions, and each
// output row is one coalesced store.  The launch takes one of two forms, by
// the batch:
//   * where at most WIDE_UP_TO blocks of WIDE_BLOCK queries a
//     multiprocessor cover it (a 4,096-key serving batch is 16 blocks), a
//     thread takes one query;
//   * a larger batch runs a persistent grid of DEEP_PER_SM blocks of
//     DEEP_BLOCK threads a multiprocessor (the layer staged a few hundred
//     times, not once per 256 queries), whose threads carry DEEP_ITEMS
//     queries a pass, strided by the grid's width so loads and stores stay
//     coalesced, with the next pass's queries loaded before this pass's
//     search.
//
// Bound.  4Q (queries) + 4P (keys) + 8Q (lo, hi) bytes, and the positions:
// 4(P + 1) where pos_lo and pos_hi are the two views of one piece_pos
// array (as every layer call passes them), else 8P; ceil(log2(P+1))
// compares per query.  At a serving batch (Q = 4096) that is 49,172 B at
// P = 2 and 81,924 B at P = 4096, about 0.015 and 0.024 us at 3.35 TB/s:
// one launch is bound by launch latency.  At Q = 2^20 and P = 4096 it is
// 12,615,684 B, about 3.77 us.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// the launch geometry (`probes/lookup_kernels.py --sweep` times others)
#define WIDE_BLOCK 256
#define WIDE_PER_SM 4
#define WIDE_UP_TO WIDE_PER_SM
#define DEEP_BLOCK 512
#define DEEP_PER_SM 2
#define DEEP_ITEMS 4
#define KEY_PAD 2147483647
#define MAX_DEVICES 64
#ifndef MAX_P
#error "build with -DMAX_P=<layer width cap> (kernel.py passes it)"
#endif
// a block holds at most 4 * MAX_P bytes of keys and 8 * MAX_P of positions;
// the blocks a multiprocessor runs of either form, each with the 1 KB the
// system reserves, fit its 228 KB
#define SMEM_MAX (12 * MAX_P)
static_assert((WIDE_PER_SM > DEEP_PER_SM ? WIDE_PER_SM : DEEP_PER_SM)
                  * (SMEM_MAX + 1024) <= 228 * 1024,
              "shared memory of the blocks of one multiprocessor exceeds "
              "228 KB");

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

template <int BLOCK, int MIN_BLOCKS, int ITEMS, bool ADJ>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
step_lookup_kernel(const int32_t* __restrict__ queries, int Q,
                   const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ pos_lo,
                   const int32_t* __restrict__ pos_hi, int P, int np,
                   int32_t* __restrict__ out) {
    // np swizzled keys (P of them, then KEY_PAD; at least 2 slots, so the
    // pairs start 8-byte aligned), then the positions: ADJ (pos_hi is
    // pos_lo + 1, one piece_pos array) its P + 1 words, else one int2
    // (pos_lo, pos_hi) an entry
    extern __shared__ __align__(16) int32_t smem[];
    int32_t* s_keys = smem;
    int32_t* s_w = smem + max(np, 2);
    int2* s_pos = reinterpret_cast<int2*>(s_w);
    for (int j = threadIdx.x; j < P; j += BLOCK) {
        cp_async4(s_keys + slot(j), keys + j);
        if (ADJ) {
            cp_async4(s_w + j, pos_lo + j);
        } else {
            cp_async4(&s_pos[j].x, pos_lo + j);
            cp_async4(&s_pos[j].y, pos_hi + j);
        }
    }
    if (ADJ && threadIdx.x == 0) cp_async4(s_w + P, pos_hi + P - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int j = P + threadIdx.x; j < np; j += BLOCK) {
        s_keys[slot(j)] = KEY_PAD;
    }
    const long long stride = (long long)gridDim.x * BLOCK;
    long long first = (long long)blockIdx.x * BLOCK + threadIdx.x;
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
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
            const int e = min(j[i], P - 1);
            const int2 p = ADJ ? make_int2(s_w[e], s_w[e + 1]) : s_pos[e];
            const long long k = first + i * stride;
            if (k < Q) {
                out[k] = p.x;
                out[Q + k] = p.y;
            }
            q[i] = qn[i];
        }
        first = next;
    }
}

#define WIDE_KERNEL(ADJ) step_lookup_kernel<WIDE_BLOCK, WIDE_PER_SM, 1, ADJ>
#define DEEP_KERNEL(ADJ) \
    step_lookup_kernel<DEEP_BLOCK, DEEP_PER_SM, DEEP_ITEMS, ADJ>

// The multiprocessor count of the current device, read once per device,
// when the shared-memory opt-in is set on both forms.
static int sm_count() {
    static std::atomic<int> cached[MAX_DEVICES];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= MAX_DEVICES) dev = 0;
    int n = cached[dev].load(std::memory_order_acquire);
    if (n == 0) {
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        n = n > 0 ? n : 1;
        const cudaFuncAttribute attr =
            cudaFuncAttributeMaxDynamicSharedMemorySize;
        cudaFuncSetAttribute(WIDE_KERNEL(false), attr, SMEM_MAX);
        cudaFuncSetAttribute(DEEP_KERNEL(false), attr, SMEM_MAX);
        cudaFuncSetAttribute(WIDE_KERNEL(true), attr, SMEM_MAX);
        cudaFuncSetAttribute(DEEP_KERNEL(true), attr, SMEM_MAX);
        cached[dev].store(n, std::memory_order_release);
    }
    return n;
}

// C entry point, bound with ctypes.  All pointers are device pointers on the
// stream's device; the wrapper (kernels/index_lookup/kernel.py) has checked
// dtype, shape, contiguity and device.  out is the (2, Q) int32 buffer.
// Returns cudaGetLastError().
extern "C" int step_lookup_launch(const void* queries, int Q,
                                  const void* keys, const void* pos_lo,
                                  const void* pos_hi, int P, void* out,
                                  void* stream) {
    if (Q <= 0 || P <= 0 || P > MAX_P) {
        return (int)cudaErrorInvalidValue;
    }
    int np = 1;                         // the least power of two >= P
    while (np < P) np *= 2;
    // pos_hi one word past pos_lo: both views of one piece_pos array
    const bool adj = (const int32_t*)pos_hi == (const int32_t*)pos_lo + 1;
    const size_t smem = sizeof(int32_t) * max(np, 2)
                        + (adj ? sizeof(int32_t) * (P + 1) : sizeof(int2) * P);
    const long long sms = sm_count();
    const cudaStream_t st = (cudaStream_t)stream;
    const long long wide = ((long long)Q + WIDE_BLOCK - 1) / WIDE_BLOCK;
    const int32_t* q = (const int32_t*)queries;
    const int32_t* k = (const int32_t*)keys;
    const int32_t* lo = (const int32_t*)pos_lo;
    const int32_t* hi = (const int32_t*)pos_hi;
    int32_t* o = (int32_t*)out;
    if (wide <= sms * WIDE_UP_TO) {
        if (adj) {
            WIDE_KERNEL(true)<<<(int)wide, WIDE_BLOCK, smem, st>>>(
                q, Q, k, lo, hi, P, np, o);
        } else {
            WIDE_KERNEL(false)<<<(int)wide, WIDE_BLOCK, smem, st>>>(
                q, Q, k, lo, hi, P, np, o);
        }
    } else {
        long long blocks = ((long long)Q + DEEP_BLOCK - 1) / DEEP_BLOCK;
        if (blocks > sms * DEEP_PER_SM) blocks = sms * DEEP_PER_SM;
        if (adj) {
            DEEP_KERNEL(true)<<<(int)blocks, DEEP_BLOCK, smem, st>>>(
                q, Q, k, lo, hi, P, np, o);
        } else {
            DEEP_KERNEL(false)<<<(int)blocks, DEEP_BLOCK, smem, st>>>(
                q, Q, k, lo, hi, P, np, o);
        }
    }
    return (int)cudaGetLastError();
}

extern "C" const char* step_lookup_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
