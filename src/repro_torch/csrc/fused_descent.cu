// Fused multi-layer index descent for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_descent_pallas` of the JAX package
// (src/repro/kernels/fused_descent/kernel.py:96): one launch walks a batch of
// Q int32 query keys through the whole resident layer prefix of L packed
// planes (each P <= 4096 entries wide, padded with KEY_PAD = INT32_MAX) and
// writes the (L, Q) int32 windows lo/hi.  Per layer l and query q:
//
//   i = max(#{keys[l] <= q} - 1, 0)
//   step row: (pos_lo[l, i], pos_hi[l, i])
//   band row: mid = y1 + m * (f32(q) - x1);  lo = floor(mid - delta),
//             hi = max(ceil(mid + delta), lo + 1)
//
// Design.  One thread per query in blocks of 256; the ragged edge is masked
// here, so the caller does not pad the queries.  For each layer the block
// stages keys[l, :P] (at most 16 KB) in static shared memory and every
// thread runs an upper-bound binary search over it.  Within a layer the keys
// strictly increase and the KEY_PAD tail is greater than every query the
// host-side guard admits, so the search returns the same rank as the TPU
// kernel's compare-count.  The thread then reads its row's parameters at i
// from global memory and writes lo[l, q], hi[l, q] coalesced.  The band line
// is evaluated with __fsub_rn / __fmul_rn / __fadd_rn, which forbids FMA
// contraction, so the result is bit-identical to the plain PyTorch version
// (separately rounded f32 ops).
//
// Bound.  The work moves 4Q (queries) + 4L (kinds) + 4LP (keys) + 8P per
// step layer (pos_lo, pos_hi) + 16P per band layer (x1, y1, m, delta)
// + 8LQ (two outputs) bytes; a row never reads the other kind's planes.  At
// the serving shape (Q = 4096, one step and one band layer, P = 640) that is
// 102,408 B, about 0.03 us at the H100's 3.35 TB/s, so a single launch is
// bound by launch latency, not by the card.  Later work may batch launches
// across query batches or capture them in CUDA graphs.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK_Q 256
#ifndef MAX_P
#error "build with -DMAX_P=<plane width cap> (kernel.py passes it)"
#endif

__global__ void __launch_bounds__(BLOCK_Q)
fused_descent_kernel(const int32_t* __restrict__ queries, int Q,
                     const int32_t* __restrict__ kinds,
                     const int32_t* __restrict__ keys,
                     const int32_t* __restrict__ pos_lo,
                     const int32_t* __restrict__ pos_hi,
                     const float* __restrict__ x1,
                     const float* __restrict__ y1,
                     const float* __restrict__ m,
                     const float* __restrict__ delta,
                     int L, int P,
                     int32_t* __restrict__ lo_out,
                     int32_t* __restrict__ hi_out) {
    __shared__ int32_t s_keys[MAX_P];
    const int qi = blockIdx.x * BLOCK_Q + threadIdx.x;
    const bool active = qi < Q;
    const int32_t q = active ? queries[qi] : 0;
    const float qf = __int2float_rn(q);

    for (int l = 0; l < L; ++l) {
        const int32_t* row = keys + (size_t)l * P;
        for (int j = threadIdx.x; j < P; j += BLOCK_Q) {
            s_keys[j] = row[j];
        }
        __syncthreads();
        if (active) {
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
            const size_t off = (size_t)l * P + i;
            int32_t olo, ohi;
            if (kinds[l] == 1) {
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
            lo_out[o] = olo;
            hi_out[o] = ohi;
        }
        __syncthreads();  // the next layer overwrites s_keys
    }
}

extern "C" int fused_descent_launch(const void* queries, int Q,
                                    const void* kinds, const void* keys,
                                    const void* pos_lo, const void* pos_hi,
                                    const void* x1, const void* y1,
                                    const void* m, const void* delta,
                                    int L, int P,
                                    void* lo_out, void* hi_out,
                                    void* stream) {
    if (Q <= 0 || L <= 0 || P <= 0 || P > MAX_P) {
        return (int)cudaErrorInvalidValue;
    }
    const dim3 grid((Q + BLOCK_Q - 1) / BLOCK_Q);
    fused_descent_kernel<<<grid, BLOCK_Q, 0, (cudaStream_t)stream>>>(
        (const int32_t*)queries, Q, (const int32_t*)kinds,
        (const int32_t*)keys, (const int32_t*)pos_lo, (const int32_t*)pos_hi,
        (const float*)x1, (const float*)y1, (const float*)m,
        (const float*)delta, L, P, (int32_t*)lo_out, (int32_t*)hi_out);
    return (int)cudaGetLastError();
}

extern "C" const char* fused_descent_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
