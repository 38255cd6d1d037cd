// Flash attention for Hopper (sm_90a): blockwise online-softmax attention
// with causal masking, GQA, a sliding window and tanh logit softcap.
//
// Replaces the TPU kernel `flash_attention_pallas` of the JAX package
// (src/repro/kernels/flash_attention/kernel.py:90, body `_attn_kernel` at
// :30), and the masks the JAX package's jnp blocked_attention adds beyond
// it (src/repro/models/layers.py:38).  With q (B, Hq, Sq, D), k/v
// (B, Hkv, Skv, D), group = Hq / Hkv, query i at position
// q_pos = q_offset + i (any q_offset: Skv - Sq end-aligns the queries, a
// chunked prefill places them inside a longer cache) and batch row b's
// length len_b = min(kv_len[b], Skv) (Skv when kv_len is null: a padded
// cache, prompts of several lengths in one batch), head h attends to kv
// head h / group with
//
//   s = (q * scale) · k;  s = softcap * tanh(s / softcap)  (if softcap);
//   key live iff k_pos < len_b, and k_pos <= q_pos (causal), and
//                q_pos - window < k_pos (window);
//   out = softmax over live keys of s, times v, in float32, stored in
//   q's type; 0 for a query with no live key.
//
// The softcap applies before the mask, as at kernel.py:62-70; a masked
// score is -1e30 and its probability 0, so a query with no live key ends
// with l = 0 and o = 0 (the jnp reference returns a block_k-dependent
// mean of zero-padded values there instead).  Each block derives its key
// range from len_b, from q_offset under causal (the end) and under a
// window (the start): a short row's blocks stream only its own keys, and
// a block whose range is empty stores zeros and issues no load.
//
// Two kernels, one per storage type.
//
// bfloat16 (the model's path): tensor cores fed by TMA.  One block of 288
// threads per (128-query tile, query head, batch): two consumer
// warpgroups, each owning 64 query rows, and one producer warp.  The
// grid's x axis runs the query tiles last to first, so the causal tiles
// with the most keys start first, and the block walks only the 96-key
// tiles that hold a live key for one of its rows (the TPU kernel's block
// skip at kernel.py:46-55): from the window's first key to the causal
// end.  The producer's one elected thread loads the Q tile once and the
// K and V tiles into a four-stage ring in shared memory with TMA
// (cp.async.bulk.tensor, 128-byte swizzle; 64-byte at D = 32), each stage
// reported to a full mbarrier and handed back through an empty one.  The
// tensor maps are encoded on the host for each call over the strided
// (B, H, S, D) views, so the model's (B, S, H, D) projections need no
// copy, and TMA's zero fill at Skv's and Sq's edges stands in for masked
// loads.  cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint,
// so the library needs no -lcuda.
//
// Each consumer warpgroup computes S = Q·Kᵀ as wgmma m64n96k16 (bf16 ->
// f32, both operands in shared memory), applies scale, softcap and the
// causal and window masks to the f32 accumulator fragments in the JAX
// kernel's order, and runs the online softmax on them, each row's max
// reduced over the four threads that hold the row (the sum l stays per
// thread until the end, taken from the f32 P before rounding).  A tile
// with every score live and no softcap takes a short path: the raw row
// max, and the scale folded into one FMA before ex2.approx.  P is rounded
// to bf16 in registers and fed as the register A operand of a second
// wgmma (O += P·V, m64n{D}k16, V read transposed through its
// descriptor); O stays in f32 registers.  The two warpgroups take the
// tensor cores in turns (named barriers 1 and 2): in its turn a group
// issues P·V of tile i and S of tile i + 1 back to back, then runs tile
// i + 1's softmax while the other group's products run.  The epilogue
// divides by max(l, 1e-30) and stores through the output strides; rows
// past Sq are not stored.
//
// Why 96 keys a tile.  S (48 registers), P (24) and O (64) are live
// together while a turn's products run; nine warps a block put three on
// one of the SM's four schedulers, which caps a thread at 168 registers,
// and at 112 or 128 keys ptxas then serializes every wgmma (measured by
// chip_smoke.py's build log and SASS: one WARPGROUP.DEPBAR per HGMMA).
// setmaxnreg with a producer warpgroup did not lift the cap in this
// toolchain.
//
// float32 (tests only): the CUDA-core kernel of the first port, kept as
// it was: tensor cores have no float32 path that holds the JAX tests'
// 2e-5 (TF32 keeps about 1e-3).  One block of 128 threads per (64-query
// tile, head, batch); Q, K, V and P widened to float32 in shared memory;
// scalar FMAs for the scores and P·V.
//
// Bound.  FLOPs 4 * D per live (query, key) pair over the card's 989
// TFLOP/s dense bf16 rate, or the bytes of q, k, v and the output over
// 3.35 TB/s, whichever is larger: at prefill lengths it is bound by
// operations, 1.718e11 FLOP at B = 1 x 4,096 (qwen3-14b's 40/8 heads of
// 128, causal) = 173.8 us.  What a later PR would add: overlap of one
// tile's softmax with the next tile's Q·Kᵀ inside a warpgroup (two S
// buffers, which needs the registers above), a persistent grid that
// overlaps one tile's epilogue with the next one's loads, and sharing the
// K/V tiles of one kv head across its query heads (each query head's
// blocks read them from L2 again today).

#include <cuda.h>
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
flash_attention_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int group, int q_offset, int causal,
                       int window, float softcap, float scale, Strides qs,
                       Strides ks, Strides vs, Strides os,
                       const int* __restrict__ kv_len) {
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

    // the key tiles holding a live key for one of the rows (none when
    // the range is empty: the rows then store 0)
    const int len = kv_len ? max(0, min(Skv, kv_len[b])) : Skv;
    const int qpos_lo = q_offset + q0;
    const int qpos_hi = q_offset + q0 + rows - 1;
    int k_end = len;
    if (causal) k_end = min(k_end, qpos_hi + 1);
    int k_begin = 0;
    if (window > 0) k_begin = max(0, qpos_lo - window + 1);
    const int kt_begin = k_begin / BK;
    const int kt_end = k_end > k_begin ? (k_end + BK - 1) / BK : 0;

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
                bool live = kpos < len;
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


// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA
// ---------------------------------------------------------------------------
#define WG_BQ 128                  // query rows a block (two warpgroups)
#define WG_BK 96                   // keys a tile
#define WG_STAGES 4                // K/V ring depth
#define WG_THREADS 288             // two consumer warpgroups + a producer
#define LOG2E 1.4426950408889634f

typedef __nv_bfloat16 bf16;

// the swizzle span of a D-wide bf16 row: 128 bytes, 64 at D = 32
template <int D>
struct WgLayout {
    static constexpr int SW = D >= 64 ? 128 : 64;     // bytes of an atom row
    static constexpr int SWE = SW / 2;                 // elements of one
    static constexpr int NATOM = D / SWE;              // atoms across D
    static constexpr int Q_BYTES = WG_BQ * D * 2;
    static constexpr int KV_BYTES = WG_BK * D * 2;     // one K or V tile
    static constexpr int BAR_BYTES = (1 + 2 * WG_STAGES) * 8;
    // 1024: slack to align the tiles to 1024 bytes, the swizzle's period
    static constexpr int BYTES =
        1024 + Q_BYTES + 2 * WG_STAGES * KV_BYTES + BAR_BYTES;
    static constexpr int DESC_LAYOUT = SW == 128 ? 1 : 2;   // B128 / B64
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)), "r"(n) : "memory");
}

// one arrival, from the threads where `pred` is set (a predicated
// instruction, not a branch)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, int pred) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
            smem_u32(bar)), "r"(pred) : "memory");
}

// wait for the phase of the given parity to complete; a wait that cannot
// end (a lost arrival) traps, so it fails the launch instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    for (uint32_t spins = 0;; ++spins) {
        uint32_t done;
        asm volatile(
            "{\n"
            ".reg .pred P1;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
            "selp.b32 %0, 1, 0, P1;\n"
            "}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
        if (spins == (1u << 24)) __trap();
    }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        ::"r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
           | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
           | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching accumulators across the async product
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}

// D (m64 x N, f32) = A (smem) · B (smem), or += when acc != 0
template <int N> struct WgmmaSS;
// D (m64 x N, f32) += A (registers, bf16) · B (smem, MN-major)
template <int N> struct WgmmaRS;

template <> struct WgmmaSS<96> {
    static __device__ __forceinline__ void run(float* d, uint64_t a,
                                               uint64_t b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
            "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
            "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
            "%48, %49, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
            : "l"(a), "l"(b), "r"(acc));
    }
};

template <> struct WgmmaRS<32> {
    static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                               uint64_t b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
            "%12, %13, %14, %15}, "
            "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(acc));
    }
};

template <> struct WgmmaRS<64> {
    static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                               uint64_t b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(acc));
    }
};

template <> struct WgmmaRS<128> {
    static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                               uint64_t b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
            "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
            "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
            "%60, %61, %62, %63}, "
            "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(acc));
    }
};


template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             bf16* __restrict__ o, int Sq, int Skv, int group,
                             int q_offset, int causal, int window,
                             float softcap, float scale, Strides os,
                             const int* __restrict__ kv_len) {
    using L = WgLayout<D>;
    constexpr int SW = L::SW, SWE = L::SWE, NATOM = L::NATOM;
    constexpr int NS = WG_BK / 2;          // S accumulators a thread
    constexpr int NO = D / 2;              // O accumulators a thread
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* q_s = base;                                   // NATOM x (BQ, SW)
    uint8_t* kv_s = q_s + L::Q_BYTES;                      // stages: K, V
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        kv_s + 2 * WG_STAGES * L::KV_BYTES);
    uint64_t* q_bar = bars;
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + WG_STAGES;

    const int t = threadIdx.x;
    const int qt = gridDim.x - 1 - blockIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / group;
    const int q0 = qt * WG_BQ;
    const int rows = min(WG_BQ, Sq - q0);

    // the key tiles holding a live key for one of the rows
    const int len = kv_len ? max(0, min(Skv, kv_len[b])) : Skv;
    const int qpos_lo = q_offset + q0;
    const int qpos_hi = q_offset + q0 + rows - 1;
    int k_end = len;
    if (causal) k_end = min(k_end, qpos_hi + 1);
    int k_begin = 0;
    if (window > 0) k_begin = max(0, qpos_lo - window + 1);
    const long long ob = (long long)b * os.b + (long long)h * os.h;
    if (k_end <= k_begin) {            // no row has a live key: store 0
        for (int i = t; i < rows * (D / 8); i += WG_THREADS) {
            const int r = i / (D / 8), c = (i % (D / 8)) * 8;
            *reinterpret_cast<uint4*>(o + ob + (long long)(q0 + r) * os.s
                                      + c) = make_uint4(0u, 0u, 0u, 0u);
        }
        return;
    }
    const int kt_begin = k_begin / WG_BK;
    const int n_tiles = (k_end + WG_BK - 1) / WG_BK - kt_begin;

    if (t == 0) {
        mbar_init(q_bar, 1);
        for (int s = 0; s < WG_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 2);   // one arrival a consumer group
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    auto load_tile = [&](int i) {      // tile i's K and V into its stage
        const int st = i % WG_STAGES;
        uint8_t* ks = kv_s + (2 * st) * L::KV_BYTES;
        uint8_t* vs = ks + L::KV_BYTES;
        const int k0 = (kt_begin + i) * WG_BK;
        mbar_expect_tx(&full[st], 2 * L::KV_BYTES);
        for (int a = 0; a < NATOM; ++a) {
            tma_load_4d(ks + a * WG_BK * SW, &tk, &full[st], a * SWE, k0, kvh,
                        b);
            tma_load_4d(vs + a * WG_BK * SW, &tv, &full[st], a * SWE, k0, kvh,
                        b);
        }
    };
    auto load_q = [&]() {
        mbar_expect_tx(q_bar, L::Q_BYTES);
        for (int a = 0; a < NATOM; ++a)
            tma_load_4d(q_s + a * WG_BQ * SW, &tq, q_bar, a * SWE, q0, h, b);
    };

    // the warpgroup, broadcast from lane 0 so the compiler sees it is
    // uniform across each warp (the products are issued under no branch
    // it takes for divergent)
    const int wg = __shfl_sync(0xffffffffu, t >> 7, 0);
    if (wg == 2) {                     // the producer warp
        if (t == 256) {                // one elected thread issues the TMA
            load_q();
            for (int i = 0; i < n_tiles; ++i) {
                if (i >= WG_STAGES)
                    mbar_wait(&empty[i % WG_STAGES],
                              ((i / WG_STAGES) & 1) ^ 1);
                load_tile(i);
            }
        }
        return;
    }

    // a consumer warpgroup: rows g*64 .. g*64+63 of the tile
    const int g = wg, tw = t & 127;
    const int warp = tw >> 5, lane = tw & 31;
    const int r0 = warp * 16 + (lane >> 2);          // and r0 + 8
    const int c2 = 2 * (lane & 3);                   // column pair in an 8
    const int qp0 = q_offset + q0 + g * 64 + r0;     // query positions
    const int qp1 = qp0 + 8;
    const int wg_lo = q_offset + q0 + g * 64;        // this group's rows
    const int wg_hi = wg_lo + 63;
    const float scale2 = scale * LOG2E;
    const bool plain = softcap <= 0.0f && scale > 0.0f;

    float acc_o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc_o[i] = 0.0f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;   // log2 units
    float s[NS];                       // S of the tile in hand
    uint32_t pa[WG_BK / 16][4];        // its P, bf16 A fragments

    const uint32_t q_addr = smem_u32(q_s) + g * 64 * SW;
    auto issue_s = [&](int i) {        // S = Q · Kᵀ over D, k-steps of 16
        const uint32_t k_addr =
            smem_u32(kv_s + (2 * (i % WG_STAGES)) * L::KV_BYTES);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
            const int a = ks / (SW / 32), off = (ks % (SW / 32)) * 32;
            const uint64_t da = gmma_desc(q_addr + a * WG_BQ * SW + off, 16,
                                          8 * SW, L::DESC_LAYOUT);
            const uint64_t db = gmma_desc(k_addr + a * WG_BK * SW + off, 16,
                                          8 * SW, L::DESC_LAYOUT);
            WgmmaSS<WG_BK>::run(s, da, db, ks > 0);
        }
    };
    auto issue_pv = [&](int i) {       // O += P · V over the keys, k-steps
        const uint32_t v_addr =
            smem_u32(kv_s + (2 * (i % WG_STAGES) + 1) * L::KV_BYTES);
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
            const uint64_t db = gmma_desc(v_addr + kk * 16 * SW, WG_BK * SW,
                                          8 * SW, L::DESC_LAYOUT);
            WgmmaRS<D>::run(acc_o, pa[kk], db, 1);
        }
    };
    // the online softmax of tile i's S: scale, softcap and mask (in that
    // order), the new row max, P into pa, l and O rescaled
    auto softmax = [&](int i) {
        const int k0 = (kt_begin + i) * WG_BK;
        const bool masked = k0 + WG_BK > len
                            || (causal && k0 + WG_BK - 1 > wg_lo)
                            || (window > 0 && k0 <= wg_hi - window);
        float mn0, mn1;
        float ps0 = 0.0f, ps1 = 0.0f;
        if (plain && !masked) {
            // every score live: the max of the raw scores, and the scale
            // folded into the exponent (scale > 0 keeps the order)
            float mx0 = s[0], mx1 = s[2];
#pragma unroll
            for (int n = 0; n < WG_BK / 8; ++n) {
                mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
                mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            mn0 = fmaxf(m0, mx0 * scale2);
            mn1 = fmaxf(m1, mx1 * scale2);
#pragma unroll
            for (int n = 0; n < WG_BK / 8; ++n) {
                float p[4];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    p[j] = fast_exp2(fmaf(s[4 * n + j], scale2, -mn0));
                    p[2 + j] = fast_exp2(fmaf(s[4 * n + 2 + j], scale2, -mn1));
                }
                ps0 += p[0] + p[1];
                ps1 += p[2] + p[3];
                pa[n / 2][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
                pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
            }
        } else {
            float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
            for (int n = 0; n < WG_BK / 8; ++n) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    float x0 = s[4 * n + j], x1 = s[4 * n + 2 + j];
                    if (softcap > 0.0f) {
                        x0 = softcap * tanhf(x0 * scale / softcap) * LOG2E;
                        x1 = softcap * tanhf(x1 * scale / softcap) * LOG2E;
                    } else {
                        x0 *= scale2;
                        x1 *= scale2;
                    }
                    const int kp = k0 + 8 * n + c2 + j;
                    bool live0 = kp < len, live1 = kp < len;
                    if (causal) {
                        live0 = live0 && kp <= qp0;
                        live1 = live1 && kp <= qp1;
                    }
                    if (window > 0) {
                        live0 = live0 && kp > qp0 - window;
                        live1 = live1 && kp > qp1 - window;
                    }
                    x0 = live0 ? x0 : NEG_INF;
                    x1 = live1 ? x1 : NEG_INF;
                    s[4 * n + j] = x0;
                    s[4 * n + 2 + j] = x1;
                    mx0 = fmaxf(mx0, x0);
                    mx1 = fmaxf(mx1, x1);
                }
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            mn0 = fmaxf(m0, mx0);
            mn1 = fmaxf(m1, mx1);
#pragma unroll
            for (int n = 0; n < WG_BK / 8; ++n) {
                float p[4];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const float x0 = s[4 * n + j], x1 = s[4 * n + 2 + j];
                    p[j] = x0 > 0.5f * NEG_INF ? fast_exp2(x0 - mn0) : 0.0f;
                    p[2 + j] = x1 > 0.5f * NEG_INF ? fast_exp2(x1 - mn1)
                                                   : 0.0f;
                }
                ps0 += p[0] + p[1];
                ps1 += p[2] + p[3];
                pa[n / 2][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
                pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
            }
        }
        const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            acc_o[4 * n + 0] *= al0;
            acc_o[4 * n + 1] *= al0;
            acc_o[4 * n + 2] *= al1;
            acc_o[4 * n + 3] *= al1;
        }
    };

    // tile 0's S and softmax; then per tile i, with the tensor cores taken
    // in turns by the two groups (named barriers 1 and 2): P·V of tile i
    // and S of tile i + 1 issued back to back, and tile i + 1's softmax
    // while the other group's products run.  The last tile's P·V is
    // peeled off, so no product is issued under a branch.
    auto take_turn = [&]() {
        asm volatile("bar.sync %0, 256;\n" ::"r"(1 + g) : "memory");
    };
    auto pass_turn = [&](int pass) {   // hand the other group its turn
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
            "@p bar.arrive %0, 256;\n}\n" ::"r"(2 - g), "r"(pass)
            : "memory");
    };
    auto finish = [&](int i) {         // the products issued, then done
        wgmma_wait0();
        fence_regs<NS>(s);
        fence_regs<NO>(acc_o);
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(pa[kk][x]));
        // the group's products are done: one thread hands the stage back
        mbar_arrive_if(&empty[i % WG_STAGES], tw == 0);
    };
    mbar_wait(q_bar, 0);
    mbar_wait(&full[0], 0);
    __syncwarp();
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<NS>(s);
    softmax(0);
    asm volatile(                      // group 0 takes the first turn
        "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
        "@p bar.arrive 1, 256;\n}\n" ::"r"(g) : "memory");
    for (int i = 0; i + 1 < n_tiles; ++i) {
        mbar_wait(&full[(i + 1) % WG_STAGES], ((i + 1) / WG_STAGES) & 1);
        __syncwarp();
        take_turn();
        wgmma_fence();
        issue_pv(i);
        issue_s(i + 1);
        wgmma_commit();
        pass_turn(1);
        finish(i);
        softmax(i + 1);
    }
    take_turn();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    pass_turn(g == 0);                 // group 1 is the last to go
    finish(n_tiles - 1);

    // epilogue: the row sums over the four threads of a row, then store
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
    const int row0 = q0 + g * 64 + r0, row1 = row0 + 8;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + c2;
        if (row0 < Sq)
            *reinterpret_cast<uint32_t*>(o + ob + row0 * os.s + col) =
                pack_bf16(acc_o[4 * n + 0] * inv0, acc_o[4 * n + 1] * inv0);
        if (row1 < Sq)
            *reinterpret_cast<uint32_t*>(o + ob + row1 * os.s + col) =
                pack_bf16(acc_o[4 * n + 2] * inv1, acc_o[4 * n + 3] * inv1);
    }
}

// cuTensorMapEncodeTiled, found through the runtime: no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = (EncodeTiledFn)p;
    }
    return fn;
}

// a 4-d map (D, S, H, B) over a bf16 view, boxes of (SWE, rows, 1, 1);
// reads past S are zero-filled.  Returns 0 or a CUDA error code.
template <int D>
static int encode_map(CUtensorMap* map, const void* ptr, int S, int H, int B,
                      Strides st, int rows) {
    using L = WgLayout<D>;
    EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return (int)cudaErrorNotSupported;
    cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                          (cuuint64_t)B};
    cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                             (cuuint64_t)st.b * 2};
    // a dimension of size 1 is never stepped: give it a stride TMA takes
    if (S == 1) strides[0] = (cuuint64_t)D * 2;
    if (H == 1) strides[1] = strides[0] * (cuuint64_t)S;
    if (B == 1) strides[2] = strides[1] * (cuuint64_t)H;
    cuuint32_t box[4] = {(cuuint32_t)L::SWE, (cuuint32_t)rows, 1, 1};
    cuuint32_t estr[4] = {1, 1, 1, 1};
    CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(ptr), dims, strides, box, estr,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_64B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
static int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Sq, int Skv, int Hkv, int q_offset,
                        int causal, int window, float softcap, float scale,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        const int* kv_len, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    int err = encode_map<D>(&tq, q, Sq, Hq, B, qs, WG_BQ);
    if (err == 0) err = encode_map<D>(&tk, k, Skv, Hkv, B, ks, WG_BK);
    if (err == 0) err = encode_map<D>(&tv, v, Skv, Hkv, B, vs, WG_BK);
    if (err != 0) return err;
    auto kern = flash_attention_wgmma_kernel<D>;
    const int smem = WgLayout<D>::BYTES;
    cudaError_t cerr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (cerr != cudaSuccess) return (int)cerr;
    const dim3 grid((Sq + WG_BQ - 1) / WG_BQ, Hq, B);
    kern<<<grid, WG_THREADS, smem, stream>>>(
        tq, tk, tv, (bf16*)o, Sq, Skv, Hq / Hkv, q_offset, causal, window,
        softcap, scale, os, kv_len);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------
template <int D>
static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Sq, int Skv, int Hkv, int q_offset,
                      int causal, int window, float softcap, float scale,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      const int* kv_len, cudaStream_t stream) {
    auto kern = flash_attention_f32_kernel<float, D>;
    const int smem = FlashSmem<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    kern<<<grid, THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Skv,
        Hq / Hkv, q_offset, causal, window, softcap, scale, qs, ks, vs, os,
        kv_len);
    return (int)cudaGetLastError();
}

template <int D>
static int launch_typed(int bf16, const void* q, const void* k, const void* v,
                        void* o, int B, int Hq, int Sq, int Skv, int Hkv,
                        int q_offset, int causal, int window, float softcap,
                        float scale, Strides qs, Strides ks, Strides vs,
                        Strides os, const int* kv_len, cudaStream_t stream) {
    if (bf16)
        return launch_wgmma<D>(q, k, v, o, B, Hq, Sq, Skv, Hkv, q_offset,
                               causal, window, softcap, scale, qs, ks, vs, os,
                               kv_len, stream);
    return launch_f32<D>(q, k, v, o, B, Hq, Sq, Skv, Hkv, q_offset, causal,
                         window, softcap, scale, qs, ks, vs, os, kv_len,
                         stream);
}

// C entry point, bound with ctypes.  All pointers are device pointers on
// the stream's device; the wrapper (kernels/flash_attention/kernel.py) has
// checked shapes, one type for q, k, v and o (bf16 = 1 for bfloat16, 0 for
// float32), a contiguous head dimension, 16-byte aligned rows,
// D in {32, 64, 128}, Hq % Hkv == 0, Sq >= 1 and Skv >= 1; q_offset is any
// placement of the queries.  window <= 0 and softcap <= 0 mean none.
// Strides are in elements, (batch, head, sequence) for q, k, v and o in
// turn.  kv_len is null or B int32 row lengths on the device.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue where a tensor map cannot
// be encoded.
extern "C" int flash_attention_launch(
        const void* q, const void* k, const void* v, void* o, int B, int Hq,
        int Sq, int Skv, int Hkv, int D, int q_offset, int causal, int window,
        float softcap, float scale, int bf16, long long qsb, long long qsh,
        long long qss, long long ksb, long long ksh, long long kss,
        long long vsb, long long vsh, long long vss, long long osb,
        long long osh, long long oss, const int* kv_len, void* stream) {
    const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
        os{osb, osh, oss};
    cudaStream_t st = (cudaStream_t)stream;
    switch (D) {
    case 32:
        return launch_typed<32>(bf16, q, k, v, o, B, Hq, Sq, Skv, Hkv,
                                q_offset, causal, window, softcap, scale, qs,
                                ks, vs, os, kv_len, st);
    case 64:
        return launch_typed<64>(bf16, q, k, v, o, B, Hq, Sq, Skv, Hkv,
                                q_offset, causal, window, softcap, scale, qs,
                                ks, vs, os, kv_len, st);
    case 128:
        return launch_typed<128>(bf16, q, k, v, o, B, Hq, Sq, Skv, Hkv,
                                 q_offset, causal, window, softcap, scale, qs,
                                 ks, vs, os, kv_len, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// Dynamic shared memory of one block of each kernel (bf16 = 1: the wgmma
// kernel) at head dimension D, or -1 for a D the kernels do not take.
extern "C" int flash_attention_smem_bytes(int D, int bf16) {
    switch (D) {
    case 32: return bf16 ? WgLayout<32>::BYTES : FlashSmem<32>::BYTES;
    case 64: return bf16 ? WgLayout<64>::BYTES : FlashSmem<64>::BYTES;
    case 128: return bf16 ? WgLayout<128>::BYTES : FlashSmem<128>::BYTES;
    default: return -1;
    }
}

extern "C" const char* flash_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
