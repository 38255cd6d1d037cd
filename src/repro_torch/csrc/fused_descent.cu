// Fused multi-layer index descent for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_descent_pallas` of the JAX package
// (src/repro/kernels/fused_descent/kernel.py:96): one launch walks a batch of
// Q int32 query keys through the whole resident layer prefix of L packed
// planes (each P <= 4096 entries wide, padded with KEY_PAD = INT32_MAX) and
// writes the (2, L, Q) int32 windows: lo at [0, l, q], hi at [1, l, q].  Per
// layer l and query q:
//
//   i = max(#{keys[l] <= q} - 1, 0)
//   step row: (pos_lo[l, i], pos_hi[l, i])
//   band row: mid = y1 + m * (f32(q) - x1);  lo = floor(mid - delta),
//             hi = max(ceil(mid + delta), lo + 1)
//
// Each layer's window depends on the query alone (the JAX kernel's grid is
// (query blocks, L) for that reason), so the layers run in parallel.
//
// Design.  The grid is (ceil(Q / 128), L): block (b, l) takes queries
// 128b .. 128b + 127 through layer l, one thread a query; the ragged edge is
// masked here, so the caller does not pad the queries.  The block stages
// only its own layer's keys[l, :P] (at most 16 KB) into shared memory with
// 16-byte cp.async copies, and loads its queries while they are in flight.
// It reads kinds[l] once, as a value uniform over the block, and then
// touches only that kind's planes.  Every thread runs the same number of
// steps of a branch-free upper-bound search over the staged keys.  Within
// a layer the keys strictly increase and the KEY_PAD tail is greater than
// every query the host-side guard admits, so the search returns the same
// rank as the TPU kernel's compare-count.  The thread then reads its row's
// parameters at i from global memory and writes lo and hi coalesced.  The
// band line is evaluated with __fsub_rn / __fmul_rn / __fadd_rn, which
// forbids FMA contraction, so the result is bit-identical to the plain
// PyTorch version (separately rounded f32 ops).
//
// Bound.  The work moves 4Q (queries) + 4L (kinds) + 4LP (keys) + 8P per
// step layer (pos_lo, pos_hi) + 16P per band layer (x1, y1, m, delta)
// + 8LQ (two outputs) bytes; a row never reads the other kind's planes.  At
// the serving shape (Q = 4096, one step and one band layer, P = 640) that is
// 102,408 B, about 0.03 us at the H100's 3.35 TB/s, so a launch is bound by
// launch latency, not by the card: the (Q/128) x L grid halves the chain a
// block runs (one layer, one barrier) and puts 64 blocks on the card at the
// serving shape instead of 16.
//
// The serving engine's batch (fused_descent_serve).  What a batch costs is
// the host's part: the engine descends in two threads (its prefetch worker
// too) beside a numpy disk walk that holds the GIL, so every step that
// releases the GIL (each torch call, each numpy cast of a few thousand
// elements, each ctypes call) can wait up to the interpreter's switch
// interval to get it back.  One C call, which touches no Python object and
// runs with the GIL released, therefore does the whole batch: it checks the
// uint64 queries against
// the int32 domain (declining the batch, with nothing queued, if one is
// out of it) while casting them into a pinned staging buffer, queues one
// copy in, the kernel and one copy out on the stream, waits for the
// stream, and widens the (2, L, Q) windows to the caller's float64 array.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK_Q 128
#ifndef MAX_P
#error "build with -DMAX_P=<plane width cap> (kernel.py passes it)"
#endif

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__global__ void __launch_bounds__(BLOCK_Q)
fused_descent_kernel(const int32_t* __restrict__ queries, int Q,
                     const int32_t* __restrict__ kinds,
                     const int32_t* __restrict__ keys,
                     const int32_t* __restrict__ pos_lo,
                     const int32_t* __restrict__ pos_hi,
                     const float* __restrict__ x1,
                     const float* __restrict__ y1,
                     const float* __restrict__ m,
                     const float* __restrict__ delta, int P, int top,
                     int32_t* __restrict__ out) {
    __shared__ __align__(16) int32_t s_keys[MAX_P];
    const int l = blockIdx.y, L = gridDim.y;
    const size_t plane = (size_t)l * P;
    const int4* row = reinterpret_cast<const int4*>(keys + plane);
    for (int j = threadIdx.x; j < P / 4; j += BLOCK_Q) {
        cp_async16(s_keys + 4 * j, row + j);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int qi = blockIdx.x * BLOCK_Q + threadIdx.x;
    const bool active = qi < Q;
    const int32_t q = active ? queries[qi] : 0;
    const int band = kinds[l];                    // uniform over the block
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (!active) return;

    // upper bound in a fixed number of steps: a = #{keys <= q}
    int a = 0;
    for (int step = top; step > 0; step >>= 1) {
        if (a + step <= P && s_keys[a + step - 1] <= q) a += step;
    }
    const size_t off = plane + (a > 0 ? a - 1 : 0);
    int32_t olo, ohi;
    if (band) {
        const float qf = __int2float_rn(q);
        const float mid = __fadd_rn(y1[off],
                                    __fmul_rn(m[off], __fsub_rn(qf, x1[off])));
        const float d = delta[off];
        olo = (int32_t)floorf(__fsub_rn(mid, d));
        ohi = (int32_t)ceilf(__fadd_rn(mid, d));
        ohi = max(ohi, olo + 1);
    } else {
        olo = pos_lo[off];
        ohi = pos_hi[off];
    }
    const size_t o = (size_t)l * Q + qi;
    out[o] = olo;
    out[(size_t)L * Q + o] = ohi;
}

// C entry point, bound with ctypes.  All pointers are device pointers on the
// stream's device; the wrapper (kernels/fused_descent/kernel.py) has checked
// dtype, shape, contiguity and device.  out is the (2, L, Q) int32 buffer.
// Returns cudaGetLastError().
extern "C" int fused_descent_launch(const void* queries, int Q,
                                    const void* kinds, const void* keys,
                                    const void* pos_lo, const void* pos_hi,
                                    const void* x1, const void* y1,
                                    const void* m, const void* delta,
                                    int L, int P, void* out, void* stream) {
    if (Q <= 0 || L <= 0 || L > 65535 || P <= 0 || P > MAX_P || P % 4) {
        return (int)cudaErrorInvalidValue;
    }
    int top = 1;                        // the largest power of two <= P
    while (2 * top <= P) top *= 2;
    const dim3 grid((Q + BLOCK_Q - 1) / BLOCK_Q, L);
    fused_descent_kernel<<<grid, BLOCK_Q, 0, (cudaStream_t)stream>>>(
        (const int32_t*)queries, Q, (const int32_t*)kinds,
        (const int32_t*)keys, (const int32_t*)pos_lo, (const int32_t*)pos_hi,
        (const float*)x1, (const float*)y1, (const float*)m,
        (const float*)delta, P, top, (int32_t*)out);
    return (int)cudaGetLastError();
}

// The host-side batch: uint64 queries q_host (Q of them) -> float64 (2, L, Q)
// windows, through the pinned q_pinned / out_pinned and the device q_dev /
// out_dev buffers (each of at least Q, 2LQ int32).  Returns
// FUSED_DESCENT_DECLINED, having queued nothing, when a query is not below
// INT32_MAX; else cudaGetLastError() after the stream's synchronisation.
#define FUSED_DESCENT_DECLINED (-1)
extern "C" int fused_descent_serve(const uint64_t* q_host, int Q,
                                   int32_t* q_pinned, void* q_dev,
                                   const void* kinds, const void* keys,
                                   const void* pos_lo, const void* pos_hi,
                                   const void* x1, const void* y1,
                                   const void* m, const void* delta,
                                   int L, int P, void* out_dev,
                                   const int32_t* out_pinned, double* windows,
                                   void* stream) {
    for (int i = 0; i < Q; ++i) {
        const uint64_t v = q_host[i];
        if (v >= 2147483647ull) return FUSED_DESCENT_DECLINED;
        q_pinned[i] = (int32_t)v;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemcpyAsync(q_dev, q_pinned, sizeof(int32_t) * Q,
                                      cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return (int)err;
    const int rc = fused_descent_launch(q_dev, Q, kinds, keys, pos_lo, pos_hi,
                                        x1, y1, m, delta, L, P, out_dev,
                                        stream);
    if (rc != 0) return rc;
    const size_t n = (size_t)2 * L * Q;
    err = cudaMemcpyAsync((void*)out_pinned, out_dev, sizeof(int32_t) * n,
                          cudaMemcpyDeviceToHost, st);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamSynchronize(st);
    if (err != cudaSuccess) return (int)err;
    for (size_t i = 0; i < n; ++i) windows[i] = (double)out_pinned[i];
    return (int)cudaGetLastError();
}

extern "C" const char* fused_descent_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
