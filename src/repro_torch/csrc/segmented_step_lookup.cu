// Two-level step-layer lookup for Hopper (sm_90a): step layers wider than
// one plane, both levels of the two-level scheme in one launch.
//
// Replaces the TPU kernel `segmented_step_lookup_pallas` of the JAX package
// (src/repro/kernels/index_lookup/kernel.py:136, body `_seg_step_kernel`
// :124) and the level-1 search before it (ops.py:56-77).  There the host
// searches the sampled grid keys[g * SEG] for each query's segment, gathers
// that segment of the layer's keys, pos_lo and pos_hi into (Q, SEG) int32
// arrays (1.5 KB per query, about 1.6 GB at Q = 2^20), and the kernel
// counts `seg_keys <= q` per row.  For Q int32 queries against one step
// layer of P piece keys (sorted, strictly increasing) and their positions,
// into one (2, Q) int32 buffer (lo at [0, q], hi at [1, q]):
//
//   g = max(#{t : keys[t * SEG] <= q} - 1, 0)           (level 1)
//   i = max(#{t : keys[min(g * SEG + t, P - 1)] <= q} - 1, 0),
//       entry min(g * SEG + i, P - 1)                    (level 2)
//   (lo, hi) = (pos_lo[entry], pos_hi[entry])
//
// Because the keys strictly increase, the entry is max(R - 1, 0) with
// R = #{keys <= q} over the whole layer, the last segment's clipped
// repeats included; each search below counts R exactly.
//
// Design.  Level 1: each block copies the grid's G = ceil(P / SEG) keys
// (strided, one 4-byte cp.async each) into shared memory while it loads its
// first queries, each key's bank XORed with its 32-key row so that the
// probes of one search step fall in different banks, and every thread runs
// the same ceil(log2(G + 1)) steps of an upper-bound search there.  A
// layer whose grid does not fit a block's shared memory (the device's
// opt-in maximum, 58,112 entries: P above 7,438,336 on an H100) searches
// the grid in global memory in the same kernel, one dependent load a step.
// Level 2 takes one of two forms, by the batch:
//   * a batch of at most WIDE_PER_SM blocks of WIDE_BLOCK queries a
//     multiprocessor (a 4,096-key serving batch is 64 blocks) is bound by
//     the chain of dependent round trips each query waits for, so a thread
//     makes three after its own load: the segment's three line heads
//     keys[g * SEG + 32 h] as one wave (c = the heads <= q; a head past the
//     end never counts), the chosen 128-byte line as eight 16-byte loads
//     (r = its keys <= q, R = g * SEG + 32 c + r), and the positions;
//   * a larger batch is bound by the memory system's throughput, so a
//     persistent grid of DEEP_PER_SM blocks of DEEP_BLOCK threads a
//     multiprocessor (the grid staged a few hundred times, not once per
//     64 queries) runs the search that reads the fewest 32-byte sectors:
//     four probes over the segment's sector heads keys[g * SEG + 8 m],
//     then the found sector's 32 bytes, then the positions.
// The layer's last line or sector, or keys that are not 16-byte aligned,
// are read entry by entry up to P - 1.  Queries are read and windows
// written coalesced; each thread loads its next query before it searches.
//
// Bound.  4Q (queries) + 8Q (lo, hi) bytes, plus the layer entries this
// batch needs, each read once: 4 B of key for each entry of a segment a
// query falls in and 8 B of positions for each distinct entry chosen; and
// ceil(log2(P + 1)) compares per query.  At Q = 4096 and P = 81,298 (635
// segments touched) that is about 0.39 MB; at Q = 2^20 about 13.6 MB,
// 4.05 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// the launch geometry (`probes/lookup_kernels.py --sweep` times others)
#define WIDE_BLOCK 64
#define WIDE_PER_SM 4
#define DEEP_BLOCK 1024
#define DEEP_PER_SM 2
#define LINE 32
#define MAX_DEVICES 64
#ifndef SEG
#error "build with -DSEG=<segment width> (kernel.py passes it)"
#endif
static_assert(SEG == 4 * LINE, "a segment is four 128-byte lines");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

// The shared-memory slot of grid entry i: its bank XORed with its 32-entry
// row, so the probes of one search step fall in different banks.
__device__ __forceinline__ int slot(int i) { return i ^ ((i >> 5) & 31); }

__device__ __forceinline__ int count_le(int4 v, int32_t q) {
    return (v.x <= q) + (v.y <= q) + (v.z <= q) + (v.w <= q);
}

// #{keys[line .. line + LINE) <= q}, entries past P - 1 left out: eight
// 16-byte loads where the line lies whole in a 16-byte-aligned layer.
__device__ __forceinline__ int count_line(const int32_t* keys, int line,
                                          int P, int vec, int32_t q) {
    int r = 0;
    if (vec && line + LINE <= P) {
        const int4* p = reinterpret_cast<const int4*>(keys + line);
        int4 v[LINE / 4];
#pragma unroll
        for (int j = 0; j < LINE / 4; ++j) v[j] = __ldg(p + j);
#pragma unroll
        for (int j = 0; j < LINE / 4; ++j) r += count_le(v[j], q);
    } else {
        for (int j = 0; j < LINE && line + j < P; ++j) {
            r += keys[line + j] <= q ? 1 : 0;
        }
    }
    return r;
}

// #{keys[e .. e + 8) <= q}, entries past P - 1 left out: one 32-byte
// sector as two 16-byte loads where it lies whole in a 16-byte-aligned
// layer.
__device__ __forceinline__ int count_sector(const int32_t* keys, int e,
                                            int P, int vec, int32_t q) {
    if (vec && e + 8 <= P) {
        const int4* p = reinterpret_cast<const int4*>(keys + e);
        return count_le(__ldg(p), q) + count_le(__ldg(p + 1), q);
    }
    int r = 0;
    for (int j = 0; j < 8 && e + j < P; ++j) r += keys[e + j] <= q ? 1 : 0;
    return r;
}

template <int BLOCK, bool GRID_IN_SHARED, bool WIDE>
__global__ void __launch_bounds__(BLOCK)
segmented_step_lookup_kernel(const int32_t* __restrict__ queries, int Q,
                             const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ pos_lo,
                             const int32_t* __restrict__ pos_hi, int P,
                             int G, int top, int vec,
                             int32_t* __restrict__ out) {
    extern __shared__ __align__(16) int32_t s_grid[];
    if (GRID_IN_SHARED) {
        for (int g = threadIdx.x; g < G; g += BLOCK) {
            cp_async4(s_grid + slot(g), keys + (long long)g * SEG);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const long long stride = (long long)gridDim.x * BLOCK;
    long long k = (long long)blockIdx.x * BLOCK + threadIdx.x;
    int32_t q = k < Q ? queries[k] : 0;             // under the staging
    if (GRID_IN_SHARED) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
    }
    while (k < Q) {
        const long long next = k + stride;
        const int32_t qn = next < Q ? queries[next] : 0;  // under this one
        // level 1: a = #{grid keys <= q}, the segment g = max(a - 1, 0)
        int a = 0;
        for (int step = top; step > 0; step >>= 1) {
            const int t = a + step;
            if (t <= G) {
                const int32_t gk = GRID_IN_SHARED
                                       ? s_grid[slot(t - 1)]
                                       : keys[(long long)(t - 1) * SEG];
                a = gk <= q ? t : a;
            }
        }
        const int base = max(a - 1, 0) * SEG;
        // level 2: R = #{keys <= q}
        int R;
        if (WIDE) {
            int c = 0;
#pragma unroll
            for (int h = 1; h < 4; ++h) {
                const int e = base + h * LINE;
                const int32_t head = e < P ? keys[e] : 0;
                c += (e < P && head <= q) ? 1 : 0;
            }
            const int line = base + c * LINE;
            R = line + count_line(keys, line, P, vec, q);
        } else {
            // the last sector head <= q (head 0 is grid key g, <= q where
            // a > 0; where a == 0 no key is)
            const int M = min(SEG, P - base + 7) / 8;
            int m = 0;
#pragma unroll
            for (int step = SEG / 16; step > 0; step >>= 1) {
                const int t = m + step;
                if (t < M) m = keys[base + 8 * t] <= q ? t : m;
            }
            const int e = base + 8 * m;
            R = a == 0 ? 0 : e + count_sector(keys, e, P, vec, q);
        }
        const int entry = max(R - 1, 0);
        const int32_t lo = pos_lo[entry];
        const int32_t hi = pos_hi[entry];
        out[k] = lo;
        out[Q + k] = hi;
        k = next;
        q = qn;
    }
}

// What the current device offers, read once per device: its multiprocessor
// count, the shared memory of a multiprocessor and the most one block may
// opt in to; the opt-in is set on the kernels that stage the grid.
struct DeviceInfo {
    int sms, smem_per_sm, smem_optin;
};

static DeviceInfo device_info() {
    static std::atomic<int> ready[MAX_DEVICES];
    static DeviceInfo info[MAX_DEVICES];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= MAX_DEVICES) dev = 0;
    if (ready[dev].load(std::memory_order_acquire) == 0) {
        DeviceInfo d{1, 48 * 1024, 48 * 1024};
        cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
        cudaDeviceGetAttribute(&d.smem_per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev);
        cudaDeviceGetAttribute(&d.smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        const cudaFuncAttribute attr =
            cudaFuncAttributeMaxDynamicSharedMemorySize;
        cudaFuncSetAttribute(
            segmented_step_lookup_kernel<WIDE_BLOCK, true, true>, attr,
            d.smem_optin);
        cudaFuncSetAttribute(
            segmented_step_lookup_kernel<DEEP_BLOCK, true, false>, attr,
            d.smem_optin);
        info[dev] = d;
        ready[dev].store(1, std::memory_order_release);
    }
    return info[dev];
}

// The most grid entries one block stages in shared memory on the current
// device (whole rows of 32): a layer of more segments searches its grid in
// global memory.
extern "C" int segmented_step_lookup_grid_cap(void) {
    return device_info().smem_optin / (32 * (int)sizeof(int32_t)) * 32;
}

template <int BLOCK, bool GRID_IN_SHARED, bool WIDE>
static void launch(int blocks, size_t smem, cudaStream_t st,
                   const void* queries, int Q, const void* keys,
                   const void* pos_lo, const void* pos_hi, int P, int G,
                   int top, int vec, void* out) {
    segmented_step_lookup_kernel<BLOCK, GRID_IN_SHARED, WIDE>
        <<<blocks, BLOCK, smem, st>>>(
            (const int32_t*)queries, Q, (const int32_t*)keys,
            (const int32_t*)pos_lo, (const int32_t*)pos_hi, P, G, top, vec,
            (int32_t*)out);
}

// C entry point, bound with ctypes.  All pointers are device pointers on the
// stream's device; the wrapper (kernels/index_lookup/kernel.py) has checked
// dtype, shape, contiguity and device.  out is the (2, Q) int32 buffer.
// Returns cudaGetLastError().
extern "C" int segmented_step_lookup_launch(const void* queries, int Q,
                                            const void* keys,
                                            const void* pos_lo,
                                            const void* pos_hi, int P,
                                            void* out, void* stream) {
    if (Q <= 0 || P <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const DeviceInfo d = device_info();
    const int G = (int)(((long long)P + SEG - 1) / SEG);
    int top = 1;                        // the largest power of two <= G
    while (2LL * top <= G) top *= 2;
    // the swizzled grid takes whole rows of 32 entries
    const long long rows = ((long long)G + 31) / 32 * 32;
    const bool in_shared = rows * (long long)sizeof(int32_t) <= d.smem_optin;
    const size_t smem = in_shared ? sizeof(int32_t) * rows : 0;
    const int vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
    const cudaStream_t st = (cudaStream_t)stream;
    // the latency form where the batch is at most WIDE_PER_SM blocks of
    // WIDE_BLOCK a multiprocessor, else the persistent throughput form
    const long long wide = ((long long)Q + WIDE_BLOCK - 1) / WIDE_BLOCK;
    if (wide <= (long long)d.sms * WIDE_PER_SM) {
        (in_shared ? launch<WIDE_BLOCK, true, true>
                   : launch<WIDE_BLOCK, false, true>)(
            (int)wide, smem, st, queries, Q, keys, pos_lo, pos_hi, P, G,
            top, vec, out);
    } else {
        // blocks a multiprocessor holds (1 KB of each block's shared memory
        // is the system's)
        const long long fit = d.smem_per_sm / (long long)(smem + 1024);
        const long long per_sm = fit < 1 ? 1
                                 : fit > DEEP_PER_SM ? DEEP_PER_SM : fit;
        long long blocks = ((long long)Q + DEEP_BLOCK - 1) / DEEP_BLOCK;
        if (blocks > d.sms * per_sm) blocks = d.sms * per_sm;
        (in_shared ? launch<DEEP_BLOCK, true, false>
                   : launch<DEEP_BLOCK, false, false>)(
            (int)blocks, smem, st, queries, Q, keys, pos_lo, pos_hi, P, G,
            top, vec, out);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* segmented_step_lookup_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
