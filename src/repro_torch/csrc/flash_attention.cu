// Flash attention for Hopper (sm_90a): blockwise online-softmax attention
// with causal masking, GQA, a sliding window and tanh logit softcap.
//
// Replaces the TPU kernel `flash_attention_pallas` of the JAX package
// (src/repro/kernels/flash_attention/kernel.py:90, body `_attn_kernel` at
// :30).  With q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), group = Hq / Hkv and
// query i at position q_pos = q_offset + i (the caller passes
// q_offset = Skv - Sq: queries end-aligned to the keys, prefill with a
// cache), head h attends to kv head h / group with
//
//   s = (q * scale) · k;  s = softcap * tanh(s / softcap)  (if softcap);
//   key live iff k_pos < Skv, and k_pos <= q_pos (causal), and
//                q_pos - window < k_pos (window);
//   out = softmax over live keys of s, times v, in float32, stored in
//   q's type.
//
// The softcap applies before the mask, as at kernel.py:62-70.
//
// Design.  One block of 128 threads per (64-query tile, head, batch); the
// grid's x axis runs the query tiles last to first, so the causal tiles
// with the most keys start first.  The block stages its query tile,
// pre-scaled, transposed in shared memory (float32), then walks only the
// 64-key tiles that hold a live key for some of its rows (the TPU kernel's
// block skip at kernel.py:46-55): from the window's first key to the
// causal bound.  Per key tile: K is staged transposed and V row-major,
// both float32; each thread computes a 4 x 8 block of the 64 x 64 scores
// (three 16-byte shared loads per 32 FMAs), applies scale, softcap and
// mask, and keeps its rows' running max and sum, reduced over the 8
// threads of a row group with shuffles.  P goes through shared memory,
// transposed, and each thread accumulates a 4 x D/8 block of the output
// in registers.  The ragged edges of Sq and Skv are masked in the kernel
// (rows past Sq are not stored, keys past Skv are zero-filled and masked),
// so the caller pads nothing.  Tensors are addressed through their batch,
// head and sequence strides (the head dimension contiguous), so the
// model's (B, S, H, D) projections need no copy.
//
// Bound.  FLOPs 4 * D per live (query, key) pair over the card's 989
// TFLOP/s dense bf16 rate, or the bytes of q, k, v and the output over
// 3.35 TB/s, whichever is larger: at prefill lengths it is bound by
// operations.  This first kernel runs on the CUDA cores in float32 (67
// TFLOP/s peak), so it stays well above that bound; tensor cores
// (mma.sync / wgmma on bf16) are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 128
#define BQ 64
#define BK 64
#define NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) {
    *dst = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* dst) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = to_f(e[i]);
}

struct Strides {                 // in elements; the last dimension is 1
    long long b, h, s;
};

template <int D>
struct FlashSmem {
    static constexpr int BYTES = (D * BQ + D * BK + BK * D + BK * BQ) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int group, int q_offset, int causal,
                       int window, float softcap, float scale, Strides qs,
                       Strides ks, Strides vs, Strides os) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int NH = D / 32;           // output float4 columns / thread
    extern __shared__ float4 smem4[];
    float* q_t = reinterpret_cast<float*>(smem4);   // (D, BQ), transposed
    float* k_t = q_t + D * BQ;                       // (D, BK), transposed
    float* v_s = k_t + D * BK;                       // (BK, D)
    float* p_t = v_s + BK * D;                       // (BK, BQ), transposed

    const int t = threadIdx.x;
    const int n_qt = gridDim.x;
    const int qt = n_qt - 1 - blockIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / group;
    const int q0 = qt * BQ;
    const int rows = min(BQ, Sq - q0);
    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + kvh * ks.h;
    const T* vb = v + b * vs.b + kvh * vs.h;
    T* ob = o + b * os.b + h * os.h;

    // the query tile, scaled, transposed; rows past Sq are zero
    for (int vi = t; vi < BQ * D / VEC; vi += THREADS) {
        const int r = vi / (D / VEC), c = (vi % (D / VEC)) * VEC;
        float f[VEC];
        if (r < rows) {
            widen<T>(*reinterpret_cast<const uint4*>(qb + (q0 + r) * qs.s + c),
                     f);
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) f[i] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) q_t[(c + i) * BQ + r] = f[i] * scale;
    }

    // the key tiles holding a live key for one of the rows
    const int qpos_lo = q_offset + q0;
    const int qpos_hi = q_offset + q0 + rows - 1;
    int k_end = Skv;
    if (causal) k_end = min(k_end, qpos_hi + 1);
    int k_begin = 0;
    if (window > 0) k_begin = max(0, qpos_lo - window + 1);
    const int kt_begin = k_begin / BK;
    const int kt_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

    const int rg = t >> 3, cg = t & 7;   // rows rg*4.., columns of cg
    float m_r[4], l_r[4], acc[4][4 * NH];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_r[i] = NEG_INF;
        l_r[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < 4 * NH; ++c) acc[i][c] = 0.0f;
    }

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                 // previous tile consumed
        for (int vi = t; vi < BK * D / VEC; vi += THREADS) {
            const int j = vi / (D / VEC), c = (vi % (D / VEC)) * VEC;
            float fk[VEC], fv[VEC];
            if (k0 + j < Skv) {
                widen<T>(*reinterpret_cast<const uint4*>(
                             kb + (k0 + j) * ks.s + c), fk);
                widen<T>(*reinterpret_cast<const uint4*>(
                             vb + (k0 + j) * vs.s + c), fv);
            } else {
#pragma unroll
                for (int i = 0; i < VEC; ++i) fk[i] = fv[i] = 0.0f;
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                k_t[(c + i) * BK + j] = fk[i];
                v_s[j * D + c + i] = fv[i];
            }
        }
        __syncthreads();

        // scores: rows rg*4 + i, columns cg*4 + jj and 32 + cg*4 + jj
        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float4 qa = reinterpret_cast<const float4*>(q_t + d * BQ)[rg];
            const float4 ka = reinterpret_cast<const float4*>(k_t + d * BK)[cg];
            const float4 kb4 =
                reinterpret_cast<const float4*>(k_t + d * BK)[8 + cg];
            const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
            const float kv[8] = {ka.x, ka.y, ka.z, ka.w,
                                 kb4.x, kb4.y, kb4.z, kb4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) s[i][jj] += qv[i] * kv[jj];
        }

        float alpha[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q_offset + q0 + rg * 4 + i;
            float mx = NEG_INF;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                const int kpos = k0 + (jj < 4 ? cg * 4 + jj
                                              : 32 + cg * 4 + jj - 4);
                float x = s[i][jj];
                if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
                bool live = kpos < Skv;
                if (causal) live = live && kpos <= qpos;
                if (window > 0) live = live && kpos > qpos - window;
                s[i][jj] = live ? x : NEG_INF;
                mx = fmaxf(mx, s[i][jj]);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            const float m_new = fmaxf(m_r[i], mx);
            alpha[i] = expf(m_r[i] - m_new);
            float sum = 0.0f;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                const float p = s[i][jj] > 0.5f * NEG_INF
                                    ? expf(s[i][jj] - m_new) : 0.0f;
                s[i][jj] = p;
                sum += p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            sum += __shfl_xor_sync(0xffffffffu, sum, 4);
            l_r[i] = l_r[i] * alpha[i] + sum;
            m_r[i] = m_new;
        }
        // P, transposed: p_t[key][row]
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const int c = jj < 4 ? cg * 4 + jj : 32 + cg * 4 + jj - 4;
            reinterpret_cast<float4*>(p_t + c * BQ)[rg] =
                make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
        }
        __syncthreads();

        // output: rows rg*4 + i, columns 32*hh + cg*4 + jj
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4 * NH; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            const float4 pa = reinterpret_cast<const float4*>(p_t + j * BQ)[rg];
            const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
                const float4 vv =
                    reinterpret_cast<const float4*>(v_s + j * D + 32 * hh)[cg];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[i][4 * hh + 0] += pv[i] * vv.x;
                    acc[i][4 * hh + 1] += pv[i] * vv.y;
                    acc[i][4 * hh + 2] += pv[i] * vv.z;
                    acc[i][4 * hh + 3] += pv[i] * vv.w;
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        if (r >= rows) continue;
        const float inv = 1.0f / fmaxf(l_r[i], 1e-30f);
        T* orow = ob + (q0 + r) * os.s;
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
                from_f(acc[i][4 * hh + jj] * inv,
                       orow + 32 * hh + cg * 4 + jj);
    }
}

template <typename T, int D>
static int launch_typed(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Sq, int Skv, int Hkv, int q_offset,
                        int causal, int window, float softcap, float scale,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        cudaStream_t stream) {
    auto kern = flash_attention_kernel<T, D>;
    const int smem = FlashSmem<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    kern<<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, Hq / Hkv,
        q_offset, causal, window, softcap, scale, qs, ks, vs, os);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_dim(int D, const void* q, const void* k, const void* v,
                      void* o, int B, int Hq, int Sq, int Skv, int Hkv,
                      int q_offset, int causal, int window, float softcap,
                      float scale, Strides qs, Strides ks, Strides vs,
                      Strides os, cudaStream_t stream) {
    switch (D) {
    case 32:
        return launch_typed<T, 32>(q, k, v, o, B, Hq, Sq, Skv, Hkv, q_offset,
                                   causal, window, softcap, scale, qs, ks, vs,
                                   os, stream);
    case 64:
        return launch_typed<T, 64>(q, k, v, o, B, Hq, Sq, Skv, Hkv, q_offset,
                                   causal, window, softcap, scale, qs, ks, vs,
                                   os, stream);
    case 128:
        return launch_typed<T, 128>(q, k, v, o, B, Hq, Sq, Skv, Hkv,
                                    q_offset, causal, window, softcap, scale,
                                    qs, ks, vs, os, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// C entry point, bound with ctypes.  All pointers are device pointers on
// the stream's device; the wrapper (kernels/flash_attention/kernel.py) has
// checked shapes, one type for q, k, v and o (bf16 = 1 for bfloat16, 0 for
// float32), a contiguous head dimension, 16-byte aligned rows,
// D in {32, 64, 128}, Hq % Hkv == 0 and 1 <= Sq <= Skv.  window <= 0 and
// softcap <= 0 mean none.  Strides are in elements, (batch, head,
// sequence) for q, k, v and o in turn.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(
        const void* q, const void* k, const void* v, void* o, int B, int Hq,
        int Sq, int Skv, int Hkv, int D, int q_offset, int causal, int window,
        float softcap, float scale, int bf16, long long qsb, long long qsh,
        long long qss, long long ksb, long long ksh, long long kss,
        long long vsb, long long vsh, long long vss, long long osb,
        long long osh, long long oss, void* stream) {
    const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
        os{osb, osh, oss};
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        return launch_dim<__nv_bfloat16>(D, q, k, v, o, B, Hq, Sq, Skv, Hkv,
                                         q_offset, causal, window, softcap,
                                         scale, qs, ks, vs, os, st);
    return launch_dim<float>(D, q, k, v, o, B, Hq, Sq, Skv, Hkv, q_offset,
                             causal, window, softcap, scale, qs, ks, vs, os,
                             st);
}

extern "C" const char* flash_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
