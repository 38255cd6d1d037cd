// Decode attention for Hopper (sm_90a): one new token per sequence against
// its KV cache, returning the partial-softmax triple (o, m, l).
//
// Replaces the TPU kernel `decode_attention_pallas` of the JAX package
// (src/repro/kernels/decode_attention/kernel.py:73, body `_decode_kernel`
// at :28).  The caller folds GQA into rows as ops.py does there: row r is
// one (batch, kv head) pair with its `group` query heads, so
//
//   q (R, group, D)   k, v (R, S, D)   kv_length (R,) int32
//   o (R, group, D) f32   m, l (R, group) f32
//
// with s_j = (q · k_j) * scale for j < kv_length[r], m = max_j s_j,
// l = sum_j exp(s_j - m), o = sum_j exp(s_j - m) v_j / max(l, 1e-30).
// Arithmetic is float32 whatever the storage type (bf16 or f32, for q and
// for k/v independently).  A row of length 0 gives o = 0, m = -1e30, l = 0,
// as the TPU kernel does (it skips every block); such a row weighs 0 in a
// combination of partials.
//
// Design.  Flash-decoding: the grid is (n_split, R).  Block (i, r) takes
// the i-th of n_split equal chunks of [0, kv_length[r]) (rounded up to the
// 64-key tile), so every split carries work whatever the length, and the
// blocks fill the card even at R = B * Hkv = 32 rows.  A block of 128
// threads holds the row's query heads, pre-scaled, in shared memory and
// streams its chunk in 64-key K/V tiles: the next tile's raw bytes are
// loaded into registers (16-byte loads, neighbouring threads on
// neighbouring addresses) while the current tile, converted to float32 in
// shared memory, is consumed, so loads stay in flight during the
// arithmetic.  Keys past the chunk's end are zero-filled, never read.
// Scores: thread (j, h) computes key j's dot product for heads h, h+2, ...;
// the tile maximum per head is reduced with warp shuffles; the online
// softmax rescales with exp(m_prev - m_new).  P·V: thread (d, g0) owns
// output column d for heads g0, g0 + 128/D, ...  Masked scores are -1e30,
// not -inf, and their probabilities are set to 0, so no NaN can arise.
// With n_split > 1 each block writes its partial triple to scratch and a
// second kernel of the same launch combines them per row with the
// combine_partials math (M = max m_i, L = sum l_i e^(m_i - M),
// O = sum o_i l_i e^(m_i - M) / L).  One call of decode_attention_launch
// is one launch of this kernel for the wrapper's count.
//
// Bound.  Bytes: each row's K and V up to its length, plus q and the
// outputs; the FLOPs (4 * group * D per key) are 10-40x below the float32
// rate's share, so it is bound by device memory (3.35 TB/s on the H100
// SXM).  At short caches (the serving loop's) launch latency sets its
// time.  This simple design converts every tile to float32 in shared
// memory (2 blocks per SM at D = 128) and overlaps one tile of loads
// with the arithmetic; a deeper cp.async / TMA pipeline is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 128
#define TK 64
#define MAXG 16
#define NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// 16 raw bytes = VEC elements of T, widened into dst[0..VEC)
template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* dst) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

template <typename TQ, typename TKV, int D>
struct DecodeSmem {
    static constexpr int KS = D + 4;                 // padded K row stride
    static constexpr int BYTES =
        (MAXG * D + TK * KS + TK * D + MAXG * TK + 4 * (MAXG / 2)
         + 2 * MAXG) * 4;
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ kv_length, int group, int S,
                        int n_split, float scale, float* __restrict__ o_out,
                        float* __restrict__ m_out, float* __restrict__ l_out) {
    constexpr int KS = D + 4;
    constexpr int VEC = 16 / sizeof(TKV);            // elements per 16 B
    constexpr int NV = TK * D / VEC / THREADS;       // 16 B loads / thread
    constexpr int GSTEP = THREADS / D;               // P·V head stride
    constexpr int NGP = (MAXG + GSTEP - 1) / GSTEP;  // heads per thread (P·V)
    static_assert(NV >= 1 && THREADS % D == 0, "unsupported head dim");

    extern __shared__ float4 smem4[];
    float* q_s = reinterpret_cast<float*>(smem4);    // (MAXG, D)
    float* k_s = q_s + MAXG * D;                     // (TK, KS)
    float* v_s = k_s + TK * KS;                      // (TK, D)
    float* p_s = v_s + TK * D;                       // (MAXG, TK)
    float* red_s = p_s + MAXG * TK;                  // (4 warps, MAXG/2)
    float* m_s = red_s + 4 * (MAXG / 2);             // (MAXG,)
    float* alpha_s = m_s + MAXG;

    const int t = threadIdx.x;
    const int split = blockIdx.x;
    const int r = blockIdx.y;
    const int R = gridDim.y;
    const int len = kv_length[r];
    int chunk = (len + n_split - 1) / n_split;
    chunk = (chunk + TK - 1) / TK * TK;
    const int start = split * chunk;
    const int end = min(start + chunk, len);

    // output slot: the final arrays when unsplit, else this split's partial
    const size_t orow = (size_t)split * R + r;
    float* o_dst = o_out + orow * group * D;
    float* m_dst = m_out + orow * group;
    float* l_dst = l_out + orow * group;

    const int d_own = t % D;
    const int g0 = t / D;
    if (start >= end) {                  // nothing live: the skipped row
        for (int gi = 0; gi < NGP; ++gi) {
            const int g = g0 + gi * GSTEP;
            if (g < group) {
                o_dst[g * D + d_own] = 0.0f;
                if (d_own == 0) {
                    m_dst[g] = NEG_INF;
                    l_dst[g] = 0.0f;
                }
            }
        }
        return;
    }

    const TQ* qr = q + (size_t)r * group * D;
    for (int i = t; i < group * D; i += THREADS)
        q_s[i] = to_f(qr[i]) * scale;
    if (t < MAXG) m_s[t] = NEG_INF;

    const TKV* kr = k + (size_t)r * S * D;
    const TKV* vr = v + (size_t)r * S * D;
    uint4 kraw[NV], vraw[NV];
    auto load_tile = [&](int base) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const int e = (i * THREADS + t) * VEC;   // element in the tile
            const int j = e / D;
            if (base + j < end) {
                const size_t off = (size_t)(base + j) * D + e % D;
                kraw[i] = *reinterpret_cast<const uint4*>(kr + off);
                vraw[i] = *reinterpret_cast<const uint4*>(vr + off);
            } else {
                kraw[i] = make_uint4(0u, 0u, 0u, 0u);
                vraw[i] = make_uint4(0u, 0u, 0u, 0u);
            }
        }
    };

    float acc[NGP], lsum[NGP];
#pragma unroll
    for (int gi = 0; gi < NGP; ++gi) acc[gi] = lsum[gi] = 0.0f;

    const int j_own = t & (TK - 1);      // score phase: key of the tile
    const int h_own = t / TK;            // ... and head parity
    const int warp = t >> 5, lane = t & 31;

    load_tile(start);
    for (int base = start; base < end; base += TK) {
        __syncthreads();                 // the previous tile is consumed
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const int e = (i * THREADS + t) * VEC;
            const int j = e / D, c = e % D;
            widen<TKV>(kraw[i], k_s + j * KS + c);
            widen<TKV>(vraw[i], v_s + j * D + c);
        }
        __syncthreads();
        if (base + TK < end) load_tile(base + TK);  // in flight meanwhile

        // scores for key j_own, heads h_own, h_own + 2, ...
        const bool live = base + j_own < end;
        float s[MAXG / 2];
#pragma unroll
        for (int gi = 0; gi < MAXG / 2; ++gi) s[gi] = 0.0f;
        const float4* k4 = reinterpret_cast<const float4*>(k_s + j_own * KS);
#pragma unroll 4
        for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kk = k4[d4];
#pragma unroll
            for (int gi = 0; gi < MAXG / 2; ++gi) {
                const int g = h_own + 2 * gi;
                if (g < group) {
                    const float4 qq =
                        reinterpret_cast<const float4*>(q_s + g * D)[d4];
                    s[gi] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z
                             + qq.w * kk.w;
                }
            }
        }
#pragma unroll
        for (int gi = 0; gi < MAXG / 2; ++gi) {
            s[gi] = live ? s[gi] : NEG_INF;
            const float mx = warp_max(s[gi]);
            if (lane == 0) red_s[warp * (MAXG / 2) + gi] = mx;
        }
        __syncthreads();
        if (t < group) {                 // head t: the new running max
            const int gi = t >> 1, w0 = 2 * (t & 1);
            const float tm = fmaxf(red_s[w0 * (MAXG / 2) + gi],
                                   red_s[(w0 + 1) * (MAXG / 2) + gi]);
            const float m_new = fmaxf(m_s[t], tm);
            alpha_s[t] = expf(m_s[t] - m_new);
            m_s[t] = m_new;
        }
        __syncthreads();
#pragma unroll
        for (int gi = 0; gi < MAXG / 2; ++gi) {
            const int g = h_own + 2 * gi;
            if (g < group)
                p_s[g * TK + j_own] = live ? expf(s[gi] - m_s[g]) : 0.0f;
        }
        __syncthreads();

        // P·V for column d_own, heads g0, g0 + GSTEP, ...
#pragma unroll
        for (int gi = 0; gi < NGP; ++gi) {
            const int g = g0 + gi * GSTEP;
            if (g < group) {
                const float a = alpha_s[g];
                acc[gi] *= a;
                lsum[gi] *= a;
            }
        }
#pragma unroll 4
        for (int j = 0; j < TK; ++j) {
            const float vv = v_s[j * D + d_own];
#pragma unroll
            for (int gi = 0; gi < NGP; ++gi) {
                const int g = g0 + gi * GSTEP;
                if (g < group) {
                    const float p = p_s[g * TK + j];
                    acc[gi] += p * vv;
                    lsum[gi] += p;
                }
            }
        }
    }

#pragma unroll
    for (int gi = 0; gi < NGP; ++gi) {
        const int g = g0 + gi * GSTEP;
        if (g < group) {
            o_dst[g * D + d_own] = acc[gi] / fmaxf(lsum[gi], 1e-30f);
            if (d_own == 0) {
                m_dst[g] = m_s[g];
                l_dst[g] = lsum[gi];
            }
        }
    }
}

// Combine n_split partial triples per row (the combine_partials math).
__global__ void __launch_bounds__(THREADS)
combine_partials_kernel(const float* __restrict__ o_part,
                        const float* __restrict__ m_part,
                        const float* __restrict__ l_part, int R, int group,
                        int D, int n_split, float* __restrict__ o,
                        float* __restrict__ m, float* __restrict__ l) {
    const int r = blockIdx.x;
    for (int idx = threadIdx.x; idx < group * D; idx += THREADS) {
        const int g = idx / D, d = idx % D;
        float M = NEG_INF;
        for (int i = 0; i < n_split; ++i)
            M = fmaxf(M, m_part[((size_t)i * R + r) * group + g]);
        float L = 0.0f, O = 0.0f;
        for (int i = 0; i < n_split; ++i) {
            const size_t pr = ((size_t)i * R + r) * group + g;
            const float w = l_part[pr] * expf(m_part[pr] - M);
            L += w;
            O += o_part[pr * D + d] * w;
        }
        const size_t out = ((size_t)r * group + g);
        o[out * D + d] = O / fmaxf(L, 1e-30f);
        if (d == 0) {
            m[out] = M;
            l[out] = L;
        }
    }
}

template <typename TQ, typename TKV, int D>
static int launch_typed(const void* q, const void* k, const void* v,
                        const int* kv_length, int R, int group, int S,
                        int n_split, float scale, float* o, float* m,
                        float* l, float* o_part, float* m_part,
                        float* l_part, cudaStream_t stream) {
    auto kern = decode_attention_kernel<TQ, TKV, D>;
    const int smem = DecodeSmem<TQ, TKV, D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const bool split = n_split > 1;
    kern<<<dim3(n_split, R), THREADS, smem, stream>>>(
        (const TQ*)q, (const TKV*)k, (const TKV*)v, kv_length, group, S,
        n_split, scale, split ? o_part : o, split ? m_part : m,
        split ? l_part : l);
    err = cudaGetLastError();
    if (err != cudaSuccess || !split) return (int)err;
    combine_partials_kernel<<<R, THREADS, 0, stream>>>(
        o_part, m_part, l_part, R, group, D, n_split, o, m, l);
    return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
static int launch_dim(int D, const void* q, const void* k, const void* v,
                      const int* kv_length, int R, int group, int S,
                      int n_split, float scale, float* o, float* m, float* l,
                      float* o_part, float* m_part, float* l_part,
                      cudaStream_t stream) {
    switch (D) {
    case 32:
        return launch_typed<TQ, TKV, 32>(q, k, v, kv_length, R, group, S,
                                         n_split, scale, o, m, l, o_part,
                                         m_part, l_part, stream);
    case 64:
        return launch_typed<TQ, TKV, 64>(q, k, v, kv_length, R, group, S,
                                         n_split, scale, o, m, l, o_part,
                                         m_part, l_part, stream);
    case 128:
        return launch_typed<TQ, TKV, 128>(q, k, v, kv_length, R, group, S,
                                          n_split, scale, o, m, l, o_part,
                                          m_part, l_part, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// C entry point, bound with ctypes.  All pointers are device pointers on
// the stream's device; the wrapper (kernels/decode_attention/kernel.py) has
// checked shapes, types (q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32),
// contiguity, 16-byte alignment, group <= 16 and D in {32, 64, 128}.  The
// partial buffers hold n_split * R rows and are read only when
// n_split > 1.  Returns cudaGetLastError().
extern "C" int decode_attention_launch(
        const void* q, const void* k, const void* v, const void* kv_length,
        int R, int group, int S, int D, int n_split, float scale, int q_bf16,
        int kv_bf16, void* o, void* m, void* l, void* o_part, void* m_part,
        void* l_part, void* stream) {
    const int* len = (const int*)kv_length;
    float *fo = (float*)o, *fm = (float*)m, *fl = (float*)l;
    float *po = (float*)o_part, *pm = (float*)m_part, *pl = (float*)l_part;
    cudaStream_t st = (cudaStream_t)stream;
    if (q_bf16 && kv_bf16)
        return launch_dim<__nv_bfloat16, __nv_bfloat16>(
            D, q, k, v, len, R, group, S, n_split, scale, fo, fm, fl, po, pm,
            pl, st);
    if (q_bf16)
        return launch_dim<__nv_bfloat16, float>(
            D, q, k, v, len, R, group, S, n_split, scale, fo, fm, fl, po, pm,
            pl, st);
    if (kv_bf16)
        return launch_dim<float, __nv_bfloat16>(
            D, q, k, v, len, R, group, S, n_split, scale, fo, fm, fl, po, pm,
            pl, st);
    return launch_dim<float, float>(D, q, k, v, len, R, group, S, n_split,
                                    scale, fo, fm, fl, po, pm, pl, st);
}

extern "C" const char* decode_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
