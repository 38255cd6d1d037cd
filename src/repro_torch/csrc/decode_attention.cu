// Decode attention for Hopper (sm_90a): the new tokens of each sequence
// against its KV cache, returning the partial-softmax triple (o, m, l).
//
// Replaces the TPU kernel `decode_attention_pallas` of the JAX package
// (src/repro/kernels/decode_attention/kernel.py:73, body `_decode_kernel`
// at :28).  The caller folds GQA into rows as ops.py does there: row r is
// one (batch, kv head) pair with its `group` query rows (its query heads
// times the new tokens, with no mask among them, as decode_attention_jnp
// folds them), so
//
//   q (R, group, D)   k, v (R, S, D)   kv_length (R,) int32
//   o (R, group, D) f32   m, l (R, group) f32
//
// with s_j = (q · k_j) * scale for j < kv_length[r], m = max_j s_j,
// l = sum_j exp(s_j - m), o = sum_j exp(s_j - m) v_j / max(l, 1e-30).
// Arithmetic is float32 whatever the storage type (bf16 or f32, for q and
// for k/v independently).  Two options of the JAX package's
// decode_attention_jnp (gemma2's local layers and attention logit cap):
// softcap > 0 replaces each scaled score by softcap * tanh(s / softcap)
// before the softmax, and window >= 0 keeps only the keys
// j > kv_length - 1 - window live (window < 0: none).  A windowed row's
// live keys are [max(kv_length - window, 0), kv_length): its splits and
// first tile start there, so the kernel streams those keys and no others.
// A row of length 0 gives o = 0, m = -1e30, l = 0,
// as the TPU kernel does (it skips every block); such a row weighs 0 in a
// combination of partials.  Masked scores are -1e30, not -inf, and their
// probabilities 0, so no NaN can arise.
//
// Any number of query rows: a block takes a tile of up to 64 of them (TR),
// and a third grid dimension walks the tiles when a row has more, each tile
// reading K and V again.  Flash-decoding, both kernels: the grid is
// (n_split, R, row tiles).  Block (i, r, t) takes the i-th of n_split
// equal chunks of the row's live keys (rounded
// up to the 64-key tile), so every split carries work whatever the length; a
// split that starts past the row's length writes the empty triple and
// exits at once.  With n_split > 1 each block writes its partial triple
// to scratch and a second kernel of the same launch combines them per row
// with the combine_partials math (M = max m_i, L = sum l_i e^(m_i - M),
// O = sum o_i l_i e^(m_i - M) / L).  One call of decode_attention_launch
// is one launch for the wrapper's count.
//
// bf16 q with bf16 k/v (the model's path): tensor-core tiles over a
// cp.async ring.  Four warps a block; each 64-key tile gives every warp a
// slice of 16 keys, which that warp copies itself with 16-byte
// cp.async.cg into its own three-stage ring in shared memory (bf16, each
// chunk at an XOR-swizzled address so that ldmatrix reads its eight rows
// from eight bank groups); keys past the chunk's end are zero-filled by
// the copy's source size and never read.  The row's query heads are
// padded to the 16 rows of mma.sync.m16n8k16 (bf16 -> f32) and held as A
// fragments in registers, loaded once.  A tile of more than 16 rows is MT
// (2 or 4) such m-tiles: warp w holds m-tile w % MT and takes every
// (4 / MT)-th slice of each key tile, so every slice serves every m-tile
// and K and V are still read once; the slices are then shared across
// warps, and each stage wait below gains a block barrier.  Per slice:
// S (16 heads x 16 keys) = Q · Kᵀ from ldmatrix'd K
// fragments, then scale, the length mask and the online softmax on the
// accumulators (row max over the four lanes of a row; O rescaled only
// when some row's max moved); P is re-packed from the S accumulators into
// the A fragment of O += P · V (V through ldmatrix.trans), so it never
// goes through shared memory.  Each warp keeps its own m, l and O; the
// only waits inside the loop are its ring's stage waits (cp.async.wait_group
// and __syncwarp, one m-tile).  The warps' partials of each m-tile are
// merged once, at the end of the block's chunk, through shared memory.  At D = 128 a block holds
// 96 KB of ring, two blocks an SM, with up to 64 KB of K/V in flight per
// block (Little's law wants ~25 KB an SM: 3.35 TB/s x ~1 us / 132 SMs).
//
// Other type pairs (tests only): the first port's kernel on CUDA cores:
// tiles widened to float32 in shared memory, one tile of loads in flight
// in registers, TR = 64 head slots (each loaded tile serves every slot,
// so K and V are read once; slots past the tile's rows are masked).
//
// Bound.  Bytes: each row's K and V up to its length, plus q and the
// outputs; the FLOPs (4 * group * D per key) are far below the tensor
// cores' share, so it is bound by device memory (3.35 TB/s on the H100
// SXM): 320.6 us at B = 8 x 32,768 (qwen3-14b's 8 kv heads of 128).  At
// short caches (the serving loop's) launch latency sets its time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

typedef __nv_bfloat16 bf16;

#define THREADS 128
#define TK 64
#define TR 64                          // query rows a block (a row tile)
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

// the keys [start, end) of split `split` of a row of length len: the live
// span [max(len - window, 0), len) (all of [0, len) for window < 0) cut into
// n_split chunks of whole 64-key tiles
__device__ __forceinline__ void split_span(int len, int window, int n_split,
                                           int split, int& start, int& end) {
    const int lo = window >= 0 ? max(len - window, 0) : 0;
    int chunk = (len - lo + n_split - 1) / n_split;
    chunk = (chunk + TK - 1) / TK * TK;
    start = lo + split * chunk;
    end = min(start + chunk, len);
}

__device__ __forceinline__ float cap_score(float s, float softcap) {
    return softcap > 0.0f ? softcap * tanhf(s / softcap) : s;
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
        (TR * D + TK * KS + TK * D + TR * TK + 4 * (TR / 2)
         + 2 * TR) * 4;
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_fma_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ kv_length, int group, int S,
                        int n_split, float scale, int window, float softcap,
                        float* __restrict__ o_out,
                        float* __restrict__ m_out, float* __restrict__ l_out) {
    constexpr int KS = D + 4;
    constexpr int VEC = 16 / sizeof(TKV);            // elements per 16 B
    constexpr int NV = TK * D / VEC / THREADS;       // 16 B loads / thread
    constexpr int GSTEP = THREADS / D;               // P·V head stride
    constexpr int NGP = (TR + GSTEP - 1) / GSTEP;  // heads per thread (P·V)
    static_assert(NV >= 1 && THREADS % D == 0, "unsupported head dim");

    extern __shared__ float4 smem4[];
    float* q_s = reinterpret_cast<float*>(smem4);    // (TR, D)
    float* k_s = q_s + TR * D;                     // (TK, KS)
    float* v_s = k_s + TK * KS;                      // (TK, D)
    float* p_s = v_s + TK * D;                       // (TR, TK)
    float* red_s = p_s + TR * TK;                  // (4 warps, TR/2)
    float* m_s = red_s + 4 * (TR / 2);             // (TR,)
    float* alpha_s = m_s + TR;

    const int t = threadIdx.x;
    const int split = blockIdx.x;
    const int r = blockIdx.y;
    const int R = gridDim.y;
    const int row0 = blockIdx.z * TR;            // this tile's first row
    const int rows = min(group - row0, TR);      // ... and its rows
    int start, end;
    split_span(kv_length[r], window, n_split, split, start, end);

    // output slot: the final arrays when unsplit, else this split's partial
    const size_t orow = (size_t)split * R + r;
    float* o_dst = o_out + (orow * group + row0) * D;
    float* m_dst = m_out + orow * group + row0;
    float* l_dst = l_out + orow * group + row0;

    const int d_own = t % D;
    const int g0 = t / D;
    if (start >= end) {                  // nothing live: the skipped row
        for (int gi = 0; gi < NGP; ++gi) {
            const int g = g0 + gi * GSTEP;
            if (g < rows) {
                o_dst[g * D + d_own] = 0.0f;
                if (d_own == 0) {
                    m_dst[g] = NEG_INF;
                    l_dst[g] = 0.0f;
                }
            }
        }
        return;
    }

    const TQ* qr = q + ((size_t)r * group + row0) * D;
    for (int i = t; i < rows * D; i += THREADS)
        q_s[i] = to_f(qr[i]) * scale;
    if (t < TR) m_s[t] = NEG_INF;

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
        float s[TR / 2];
#pragma unroll
        for (int gi = 0; gi < TR / 2; ++gi) s[gi] = 0.0f;
        const float4* k4 = reinterpret_cast<const float4*>(k_s + j_own * KS);
#pragma unroll 4
        for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kk = k4[d4];
#pragma unroll
            for (int gi = 0; gi < TR / 2; ++gi) {
                const int g = h_own + 2 * gi;
                if (g < rows) {
                    const float4 qq =
                        reinterpret_cast<const float4*>(q_s + g * D)[d4];
                    s[gi] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z
                             + qq.w * kk.w;
                }
            }
        }
#pragma unroll
        for (int gi = 0; gi < TR / 2; ++gi) {
            s[gi] = live ? cap_score(s[gi], softcap) : NEG_INF;
            const float mx = warp_max(s[gi]);
            if (lane == 0) red_s[warp * (TR / 2) + gi] = mx;
        }
        __syncthreads();
        if (t < rows) {                  // head t: the new running max
            const int gi = t >> 1, w0 = 2 * (t & 1);
            const float tm = fmaxf(red_s[w0 * (TR / 2) + gi],
                                   red_s[(w0 + 1) * (TR / 2) + gi]);
            const float m_new = fmaxf(m_s[t], tm);
            alpha_s[t] = expf(m_s[t] - m_new);
            m_s[t] = m_new;
        }
        __syncthreads();
#pragma unroll
        for (int gi = 0; gi < TR / 2; ++gi) {
            const int g = h_own + 2 * gi;
            if (g < rows)
                p_s[g * TK + j_own] = live ? expf(s[gi] - m_s[g]) : 0.0f;
        }
        __syncthreads();

        // P·V for column d_own, heads g0, g0 + GSTEP, ...
#pragma unroll
        for (int gi = 0; gi < NGP; ++gi) {
            const int g = g0 + gi * GSTEP;
            if (g < rows) {
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
                if (g < rows) {
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
        if (g < rows) {
            o_dst[g * D + d_own] = acc[gi] / fmaxf(lsum[gi], 1e-30f);
            if (d_own == 0) {
                m_dst[g] = m_s[g];
                l_dst[g] = lsum[gi];
            }
        }
    }
}

// Combine n_split partial triples per row (the combine_partials math):
// one thread per (row, head, column), the splits in order.
__global__ void __launch_bounds__(THREADS)
combine_partials_kernel(const float* __restrict__ o_part,
                        const float* __restrict__ m_part,
                        const float* __restrict__ l_part, int R, int group,
                        int D, int n_split, float* __restrict__ o,
                        float* __restrict__ m, float* __restrict__ l) {
    const int r = blockIdx.y;
    const int idx = blockIdx.x * THREADS + threadIdx.x;
    if (idx >= group * D) return;
    const int g = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll 4
    for (int i = 0; i < n_split; ++i)
        M = fmaxf(M, m_part[((size_t)i * R + r) * group + g]);
    float L = 0.0f, O = 0.0f;
#pragma unroll 4
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


// ---------------------------------------------------------------------------
// bf16 x bf16: mma.sync over a cp.async ring
// ---------------------------------------------------------------------------
#define MMA_WARPS 4
#define MMA_KW 16                      // keys of a warp's slice of a tile
#define MMA_TK (MMA_WARPS * MMA_KW)    // keys a tile (= TK)
#define MMA_STAGES 3
#define LOG2E 1.4426950408889634f

template <int D>
struct MmaSmem {
    static constexpr int SLICE = MMA_KW * D * 2;    // one K or V slice
    static constexpr int RING = MMA_WARPS * MMA_STAGES * 2 * SLICE;
    static constexpr int MERGE = MMA_WARPS * (16 * D + 2 * 16) * 4;
    static constexpr int BYTES = RING > MERGE ? RING : MERGE;
};

// the 16-byte unit of chunk c of key row j of a slice: chunks XOR-swizzled
// so that the eight rows one ldmatrix reads fall in eight bank groups
template <int D>
__device__ __forceinline__ int swz(int j, int c) {
    constexpr int CPR = D / 8;                       // chunks a row
    constexpr int RPL = CPR >= 8 ? 1 : 8 / CPR;      // rows a 128-byte line
    constexpr int MASK = CPR >= 8 ? 7 : CPR - 1;
    return j * CPR + (c ^ ((j / RPL) & MASK));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16) · b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}

// MT: the m-tiles of 16 query rows a block holds (1, 2 or 4; see the head)
template <int D, int MT>
__global__ void __launch_bounds__(MMA_WARPS * 32, 2)
decode_attention_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int* __restrict__ kv_length, int group,
                            int S, int n_split, float scale, int window,
                            float softcap, float* __restrict__ o_out,
                            float* __restrict__ m_out,
                            float* __restrict__ l_out) {
    using L = MmaSmem<D>;
    constexpr int CPR = D / 8;         // 16-byte chunks of a key row
    constexpr int NB = D / 8;          // n-blocks of 8 output columns
    constexpr int THR = MMA_WARPS * 32;
    constexpr int KG = MMA_WARPS / MT; // warps sharing an m-tile
    static_assert(KG * MT == MMA_WARPS, "MT divides the warps");
    extern __shared__ uint4 smem16[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(smem16);

    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int split = blockIdx.x, r = blockIdx.y, R = gridDim.y;
    const int row0 = blockIdx.z * TR;            // this tile's first row
    const int rows = min(group - row0, TR);      // ... and its rows
    int start, end;
    split_span(kv_length[r], window, n_split, split, start, end);

    // output slot: the final arrays when unsplit, else this split's partial
    const size_t orow = (size_t)split * R + r;
    float* o_dst = o_out + (orow * group + row0) * D;
    float* m_dst = m_out + orow * group + row0;
    float* l_dst = l_out + orow * group + row0;
    if (start >= end) {                  // nothing live: the empty triple
        for (int i = t; i < rows * D; i += THR) o_dst[i] = 0.0f;
        for (int i = t; i < rows; i += THR) {
            m_dst[i] = NEG_INF;
            l_dst[i] = 0.0f;
        }
        return;
    }

    // Q as A fragments: rows h0 and h0 + 8 of this warp's m-tile (zero past
    // the tile's rows)
    const int mt = warp % MT, kg = warp / MT;
    const int h0 = lane >> 2, c2 = 2 * (lane & 3);
    const bf16* qr = q + ((size_t)r * group + row0 + 16 * mt) * D;
    const int mrows = rows - 16 * mt;            // live rows of the m-tile
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int hh = h0 + 8 * (x & 1);
            const int d = 16 * ks + 8 * (x >> 1) + c2;
            qa[ks][x] = hh < mrows
                ? *reinterpret_cast<const uint32_t*>(qr + hh * D + d) : 0u;
        }
    }

    // each warp copies slice `warp` of every tile into its own ring; it
    // reads slices kg, kg + KG, ... (its own alone when MT = 1)
    const bf16* kr = k + (size_t)r * S * D;
    const bf16* vr = v + (size_t)r * S * D;
    const int n_tiles = (end - start + MMA_TK - 1) / MMA_TK;
    auto stage = [&](int slice, int tile) {
        return smem_u32(smem + (slice * MMA_STAGES + tile % MMA_STAGES) * 2
                        * L::SLICE);
    };
    auto issue = [&](int tile) {
        const uint32_t ks_ = stage(warp, tile);
        const uint32_t vs_ = ks_ + L::SLICE;
        const int key0 = start + tile * MMA_TK + warp * MMA_KW;
#pragma unroll
        for (int i = lane; i < MMA_KW * CPR; i += 32) {
            const int j = i / CPR, c = i % CPR;
            const int key = key0 + j;
            const bool live = key < end;
            const size_t off = (size_t)(live ? key : start) * D + c * 8;
            const uint32_t so = swz<D>(j, c) * 16;
            cp_async16(ks_ + so, kr + off, live ? 16 : 0);
            cp_async16(vs_ + so, vr + off, live ? 16 : 0);
        }
    };
    auto wait_all = [&]() {              // slices shared: a block barrier
        if constexpr (MT > 1) __syncthreads(); else __syncwarp();
    };

    float acc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[nb][x] = 0.0f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

    // ldmatrix lanes: the row and chunk half each lane addresses
    const int mi = lane >> 3;
    const int jk = (mi >> 1) * 8 + (lane & 7), ck = mi & 1;    // K
    const int jv = (mi & 1) * 8 + (lane & 7), cv = mi >> 1;    // V (trans)

#pragma unroll
    for (int s = 0; s < MMA_STAGES - 1; ++s) {
        if (s < n_tiles) issue(s);
        cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
        if (i + MMA_STAGES - 1 < n_tiles) issue(i + MMA_STAGES - 1);
        cp_async_commit();
        cp_async_wait<MMA_STAGES - 1>();
        wait_all();
#pragma unroll
        for (int sj = 0; sj < MT; ++sj) {
            const int slice = kg + KG * sj;
            const uint32_t ks_ = stage(slice, i);
            const uint32_t vs_ = ks_ + L::SLICE;

            // S = Q · Kᵀ: keys 0-7 in s0, 8-15 in s1
            float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
                uint32_t b[4];
                ldsm_x4(b, ks_ + swz<D>(jk, 2 * ks + ck) * 16);
                mma16816(s0, qa[ks], b[0], b[1]);
                mma16816(s1, qa[ks], b[2], b[3]);
            }

            // scale, the cap, the length mask, the online softmax (rows
            // h0, h0 + 8)
            const int kb = start + i * MMA_TK + slice * MMA_KW + c2;
            const bool lv[4] = {kb < end, kb + 1 < end, kb + 8 < end,
                                kb + 9 < end};
            float x[8];                   // (row, key) in s0/s1 order
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                x[e] = lv[(e & 1)] ? cap_score(s0[e] * scale, softcap)
                                   : NEG_INF;
                x[4 + e] = lv[2 + (e & 1)]
                    ? cap_score(s1[e] * scale, softcap) : NEG_INF;
            }
            float mx0 = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[4], x[5]));
            float mx1 = fmaxf(fmaxf(x[2], x[3]), fmaxf(x[6], x[7]));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
            const float al0 = exp2f((m0 - mn0) * LOG2E);
            const float al1 = exp2f((m1 - mn1) * LOG2E);
            m0 = mn0;
            m1 = mn1;
            float p[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float mn = (e & 2) ? mn1 : mn0;
                p[e] = x[e] > 0.5f * NEG_INF ? exp2f((x[e] - mn) * LOG2E)
                                             : 0.0f;
            }
            l0 = l0 * al0 + (p[0] + p[1] + p[4] + p[5]);
            l1 = l1 * al1 + (p[2] + p[3] + p[6] + p[7]);
            if (__any_sync(0xffffffffu, al0 != 1.0f || al1 != 1.0f)) {
#pragma unroll
                for (int nb = 0; nb < NB; ++nb) {
                    acc[nb][0] *= al0;
                    acc[nb][1] *= al0;
                    acc[nb][2] *= al1;
                    acc[nb][3] *= al1;
                }
            }
            // P from the S accumulators straight into an A fragment
            const uint32_t pa[4] = {pack_bf16(p[0], p[1]),
                                    pack_bf16(p[2], p[3]),
                                    pack_bf16(p[4], p[5]),
                                    pack_bf16(p[6], p[7])};

            // O += P · V
#pragma unroll
            for (int np = 0; np < D / 16; ++np) {
                uint32_t b[4];
                ldsm_x4_t(b, vs_ + swz<D>(jv, 2 * np + cv) * 16);
                mma16816(acc[2 * np], pa, b[0], b[1]);
                mma16816(acc[2 * np + 1], pa, b[2], b[3]);
            }
        }
        wait_all();                      // the stage is free for a copy
    }
    cp_async_wait<0>();

    // merge the partials of the KG warps of each m-tile once
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    __syncthreads();                     // every warp is done with its ring
    float* mo = reinterpret_cast<float*>(smem);         // (warps, 16, D)
    float* mm = mo + MMA_WARPS * 16 * D;                // (warps, 16)
    float* ml = mm + MMA_WARPS * 16;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
        float* row0_ = mo + (warp * 16 + h0) * D + 8 * nb + c2;
        float* row1_ = row0_ + 8 * D;
        row0_[0] = acc[nb][0];
        row0_[1] = acc[nb][1];
        row1_[0] = acc[nb][2];
        row1_[1] = acc[nb][3];
    }
    if ((lane & 3) == 0) {
        mm[warp * 16 + h0] = m0;
        mm[warp * 16 + h0 + 8] = m1;
        ml[warp * 16 + h0] = l0;
        ml[warp * 16 + h0 + 8] = l1;
    }
    __syncthreads();
    for (int i = t; i < rows * D; i += THR) {
        const int gh = i / D, d = i % D;
        const int w0 = gh / 16, h = gh % 16;     // m-tile w0: warps w0 + MT·j
        float M = NEG_INF;
#pragma unroll
        for (int j = 0; j < KG; ++j)
            M = fmaxf(M, mm[(w0 + MT * j) * 16 + h]);
        float Lsum = 0.0f, O = 0.0f;
#pragma unroll
        for (int j = 0; j < KG; ++j) {
            const int w = w0 + MT * j;
            const float e = expf(mm[w * 16 + h] - M);
            Lsum += ml[w * 16 + h] * e;
            O += mo[(w * 16 + h) * D + d] * e;
        }
        o_dst[i] = O / fmaxf(Lsum, 1e-30f);
        if (d == 0) {
            m_dst[gh] = M;
            l_dst[gh] = Lsum;
        }
    }
}

static_assert(MMA_WARPS * 32 == THREADS, "one block size for both kernels");

// query rows of one block's tile -> m-tiles of the tensor-core kernel
static int mma_tiles(int group) {
    const int rows = group < TR ? group : TR;
    return rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
}

template <typename TQ, typename TKV, int D>
struct KernelSmem {              // the CUDA-core kernel's
    static constexpr int BYTES = DecodeSmem<TQ, TKV, D>::BYTES;
};
template <int D>
struct KernelSmem<bf16, bf16, D> {      // the tensor-core kernel's
    static constexpr int BYTES = MmaSmem<D>::BYTES;
};

template <typename TQ, typename TKV, int D, typename Kern>
static int launch_kernel(Kern kern, const void* q, const void* k,
                         const void* v, const int* kv_length, int R,
                         int group, int S, int n_split, float scale,
                         int window, float softcap,
                         float* o, float* m, float* l, float* o_part,
                         float* m_part, float* l_part, cudaStream_t stream) {
    const int smem = KernelSmem<TQ, TKV, D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const bool split = n_split > 1;
    const int row_tiles = (group + TR - 1) / TR;
    kern<<<dim3(n_split, R, row_tiles), THREADS, smem, stream>>>(
        (const TQ*)q, (const TKV*)k, (const TKV*)v, kv_length, group, S,
        n_split, scale, window, softcap, split ? o_part : o,
        split ? m_part : m,
        split ? l_part : l);
    err = cudaGetLastError();
    if (err != cudaSuccess || !split) return (int)err;
    const dim3 cgrid((group * D + THREADS - 1) / THREADS, R);
    combine_partials_kernel<<<cgrid, THREADS, 0, stream>>>(
        o_part, m_part, l_part, R, group, D, n_split, o, m, l);
    return (int)cudaGetLastError();
}

#define DECODE_ARGS q, k, v, kv_length, R, group, S, n_split, scale, window, \
    softcap, o, m, l, o_part, m_part, l_part, stream

template <typename TQ, typename TKV, int D>
static int launch_typed(const void* q, const void* k, const void* v,
                        const int* kv_length, int R, int group, int S,
                        int n_split, float scale, int window, float softcap,
                        float* o, float* m,
                        float* l, float* o_part, float* m_part,
                        float* l_part, cudaStream_t stream) {
    if constexpr (std::is_same<TQ, bf16>::value
                  && std::is_same<TKV, bf16>::value) {
        switch (mma_tiles(group)) {
        case 1:
            return launch_kernel<TQ, TKV, D>(
                decode_attention_mma_kernel<D, 1>, DECODE_ARGS);
        case 2:
            return launch_kernel<TQ, TKV, D>(
                decode_attention_mma_kernel<D, 2>, DECODE_ARGS);
        default:
            return launch_kernel<TQ, TKV, D>(
                decode_attention_mma_kernel<D, 4>, DECODE_ARGS);
        }
    } else {
        return launch_kernel<TQ, TKV, D>(
            decode_attention_fma_kernel<TQ, TKV, D>, DECODE_ARGS);
    }
}

template <typename TQ, typename TKV>
static int launch_dim(int D, const void* q, const void* k, const void* v,
                      const int* kv_length, int R, int group, int S,
                      int n_split, float scale, int window, float softcap,
                      float* o, float* m, float* l,
                      float* o_part, float* m_part, float* l_part,
                      cudaStream_t stream) {
    switch (D) {
    case 32:
        return launch_typed<TQ, TKV, 32>(q, k, v, kv_length, R, group, S,
                                         n_split, scale, window, softcap, o,
                                         m, l, o_part,
                                         m_part, l_part, stream);
    case 64:
        return launch_typed<TQ, TKV, 64>(q, k, v, kv_length, R, group, S,
                                         n_split, scale, window, softcap, o,
                                         m, l, o_part,
                                         m_part, l_part, stream);
    case 128:
        return launch_typed<TQ, TKV, 128>(q, k, v, kv_length, R, group, S,
                                          n_split, scale, window, softcap, o,
                                          m, l, o_part,
                                          m_part, l_part, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// C entry point, bound with ctypes.  All pointers are device pointers on
// the stream's device; the wrapper (kernels/decode_attention/kernel.py) has
// checked shapes, types (q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32),
// contiguity, 16-byte alignment, group >= 1 and D in {32, 64, 128}
// (window < 0 and softcap <= 0 mean none).  The
// partial buffers hold n_split * R rows and are read only when
// n_split > 1.  Returns cudaGetLastError().
extern "C" int decode_attention_launch(
        const void* q, const void* k, const void* v, const void* kv_length,
        int R, int group, int S, int D, int n_split, float scale, int window,
        float softcap, int q_bf16, int kv_bf16, void* o, void* m, void* l,
        void* o_part, void* m_part,
        void* l_part, void* stream) {
    const int* len = (const int*)kv_length;
    float *fo = (float*)o, *fm = (float*)m, *fl = (float*)l;
    float *po = (float*)o_part, *pm = (float*)m_part, *pl = (float*)l_part;
    cudaStream_t st = (cudaStream_t)stream;
    if (q_bf16 && kv_bf16)
        return launch_dim<__nv_bfloat16, __nv_bfloat16>(
            D, q, k, v, len, R, group, S, n_split, scale, window, softcap, fo,
            fm, fl, po, pm, pl, st);
    if (q_bf16)
        return launch_dim<__nv_bfloat16, float>(
            D, q, k, v, len, R, group, S, n_split, scale, window, softcap, fo,
            fm, fl, po, pm, pl, st);
    if (kv_bf16)
        return launch_dim<float, __nv_bfloat16>(
            D, q, k, v, len, R, group, S, n_split, scale, window, softcap, fo,
            fm, fl, po, pm, pl, st);
    return launch_dim<float, float>(D, q, k, v, len, R, group, S, n_split,
                                    scale, window, softcap, fo, fm, fl, po,
                                    pm, pl, st);
}

// Dynamic shared memory of one block of the kernel a type pair takes at
// head dimension D, or -1 for a D the kernels do not take.
template <typename TQ, typename TKV>
static int smem_dim(int D) {
    switch (D) {
    case 32: return KernelSmem<TQ, TKV, 32>::BYTES;
    case 64: return KernelSmem<TQ, TKV, 64>::BYTES;
    case 128: return KernelSmem<TQ, TKV, 128>::BYTES;
    default: return -1;
    }
}

extern "C" int decode_attention_smem_bytes(int D, int q_bf16, int kv_bf16) {
    if (q_bf16 && kv_bf16) return smem_dim<bf16, bf16>(D);
    if (q_bf16) return smem_dim<bf16, float>(D);
    if (kv_bf16) return smem_dim<float, bf16>(D);
    return smem_dim<float, float>(D);
}

extern "C" const char* decode_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
