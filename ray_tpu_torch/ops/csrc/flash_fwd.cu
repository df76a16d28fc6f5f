// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces ray_tpu/ops/flash_pallas.py::_flash_kernel (the TPU Pallas
// forward). It computes the same function: softmax(scale * q k^T) v over the
// causal / sliding-window band, tanh softcap applied BEFORE the mask, GQA by
// reading kv head h / group, and the per-row log-sum-exp
// lse = m + log(l) as the residual the backward needs.
//
// Layouts are the JAX ones, read through strides: q [B, Lq, H, D],
// k/v [B, Lk, Hk, D] (last dim contiguous), out [B, Lq, H, D] in q's dtype,
// lse [B, H, Lq] float32. Rows and columns both count from 0 (no q offset).
//
// What bounds it on an H100: at the model's shapes (L = 2048, D = 128) the
// two matrix products do ~L/2 multiply-adds per byte of q/k/v, far above the
// card's ~295 FLOP/byte ridge, so the kernel is bound by tensor-core
// operations. The design keeps everything between the two products on chip
// and keeps the tensor cores fed: one CTA owns one (batch, q head, 64-row q
// tile); Q stays in registers as mma fragments; K and V tiles of 64 rows
// stream through a two-stage shared-memory ring filled by cp.async, so the
// next tile's copy overlaps this tile's products; the running max m, sum l
// and the 64 x D accumulator stay in float32 registers (online softmax), so
// the [Lq, Lk] scores never reach device memory. Tiles wholly outside the
// causal / window band are never loaded (the same predicate as the TPU
// kernel's _block_band), and tiles wholly inside it skip the per-element
// mask. The products run on the tensor cores through mma.sync m16n8k16 (bf16
// in, f32 accumulate) with ldmatrix fragment loads; wgmma, TMA and warp
// specialisation are later work.
//
// float32 inputs take a CUDA-core path (exact f32 FMAs) so the float32 model
// configurations keep float32 attention; it exists for parity, not speed.
//
// NEG_INF is the finite -1e30, never -inf: a live tile that is fully masked
// for some rows gives them fake mass exp(NEG_INF - NEG_INF) = 1, which the
// first in-band tile removes through alpha = exp(NEG_INF - m_finite) = 0.
// With -inf that rescale would be NaN.
//
// The host function launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

struct FwdParams {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;
    int64_t q_sb, q_sl, q_sh;  // element strides: batch, position, head
    int64_t k_sb, k_sl, k_sh;
    int64_t v_sb, v_sl, v_sh;
    int64_t o_sb, o_sl, o_sh;
    int B, Lq, Lk, H, Hk;
    int causal;
    int window;  // 0 = no window
    float softcap;  // 0 = off
    float scale;
};

// The band: one definition for both paths. Columns past Lk do not exist.
__device__ __forceinline__ bool visible(const FwdParams& p, int row, int col) {
    if (col >= p.Lk) return false;
    if (p.causal && row < col) return false;
    if (p.window > 0 && row - col >= p.window) return false;
    return true;
}

// scale, softcap (before the mask), mask; ``inside``: the whole tile is in
// the band, so no element needs the mask
__device__ __forceinline__ float score(const FwdParams& p, float acc, int row, int col,
                                       bool inside) {
    float s = acc * p.scale;
    if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
    return inside || visible(p, row, col) ? s : NEG_INF;
}

// kv tiles [begin, end) that intersect the band of q rows [q0, q0 + bm).
__device__ __forceinline__ void live_tiles(const FwdParams& p, int q0, int bm, int bn,
                                           int* begin, int* end) {
    int nk = (p.Lk + bn - 1) / bn;
    int b = 0, e = nk;
    if (p.causal) e = min(nk, (q0 + bm - 1) / bn + 1);
    if (p.window > 0) {
        int lo = q0 - p.window + 1;  // first column row q0 can see
        b = lo > 0 ? lo / bn : 0;
    }
    *begin = b;
    *end = e;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
    return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) ~= hi + lo, each a bf16 pair: 16 significant bits for P in the PV
// product, as against 8 for a single bf16
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* ptr) {
    uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* ptr) {
    uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// 16-byte global -> shared copy that bypasses registers; pred false zero-fills
// the destination and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kBM = 64;       // q rows per CTA (16 per warp)
constexpr int kBN = 64;       // kv rows per tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;       // row padding (elements): conflict-free fragment loads

template <int D>
constexpr size_t bf16_smem_bytes() {  // Q tile + two stages of K and V tiles
    return size_t(kBM + 4 * kBN) * (D + kPad) * sizeof(__nv_bfloat16);
}

// start copying a ROWS x D tile of a [.., L, .., D] tensor into shared memory
// (zeros past L); completes at the matching cp_async_wait
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int64_t row_stride, int row0, int L) {
    constexpr int LD = D + kPad;
    constexpr int CH = D / 8;  // 16-byte chunks per row
    static_assert(ROWS * CH % kThreads == 0, "tile does not split evenly over the threads");
#pragma unroll
    for (int it = 0; it < ROWS * CH / kThreads; ++it) {
        const int i = threadIdx.x + it * kThreads;
        const int r = i / CH, c = i % CH;
        const bool in = row0 + r < L;
        cp_async16(dst + r * LD + c * 8, src + (in ? int64_t(row0 + r) * row_stride + c * 8 : 0),
                   in);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(const __grid_constant__ FwdParams p) {
    constexpr int LD = D + kPad;
    constexpr int KS = D / 16;    // k-steps of the QK^T product
    constexpr int NT = kBN / 8;   // 8-column tiles of S
    constexpr int OT = D / 8;     // 8-column tiles of O
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* sK = sQ + kBM * LD;      // two stages
    __nv_bfloat16* sV = sK + 2 * kBN * LD;  // two stages

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (p.H / p.Hk);
    const int q0 = blockIdx.x * kBM;
    const __nv_bfloat16* Q =
        static_cast<const __nv_bfloat16*>(p.q) + int64_t(b) * p.q_sb + int64_t(h) * p.q_sh;
    const __nv_bfloat16* K =
        static_cast<const __nv_bfloat16*>(p.k) + int64_t(b) * p.k_sb + int64_t(hk) * p.k_sh;
    const __nv_bfloat16* V =
        static_cast<const __nv_bfloat16*>(p.v) + int64_t(b) * p.v_sb + int64_t(hk) * p.v_sh;

    int kt_begin, kt_end;
    live_tiles(p, q0, kBM, kBN, &kt_begin, &kt_end);
    load_tile_async<D, kBM>(sQ, Q, p.q_sl, q0, p.Lq);
    if (kt_begin < kt_end) {
        load_tile_async<D, kBN>(sK, K, p.k_sl, kt_begin * kBN, p.Lk);
        load_tile_async<D, kBN>(sV, V, p.v_sl, kt_begin * kBN, p.Lk);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // this thread's rows in the tile: r0 and r0 + 8; its column pair: cq, cq + 1
    const int r0 = warp * 16 + lane / 4;
    const int cq = (lane % 4) * 2;
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        qf[ks][0] = ld32(sQ + r0 * LD + ks * 16 + cq);
        qf[ks][1] = ld32(sQ + (r0 + 8) * LD + ks * 16 + cq);
        qf[ks][2] = ld32(sQ + r0 * LD + ks * 16 + cq + 8);
        qf[ks][3] = ld32(sQ + (r0 + 8) * LD + ks * 16 + cq + 8);
    }

    float o[OT][4];
#pragma unroll
    for (int t = 0; t < OT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's partial row sums
    const int rows[2] = {q0 + r0, q0 + r0 + 8};
    // ldmatrix.x4 row address of this lane: matrix lane / 8, row lane % 8
    const int mtx = lane / 8;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * kBN;
        const int stage = (kt - kt_begin) & 1;
        const __nv_bfloat16* cK = sK + stage * kBN * LD;
        const __nv_bfloat16* cV = sV + stage * kBN * LD;
        if (kt + 1 < kt_end) {  // prefetch the next tile into the other stage
            load_tile_async<D, kBN>(sK + (stage ^ 1) * kBN * LD, K, p.k_sl, k0 + kBN, p.Lk);
            load_tile_async<D, kBN>(sV + (stage ^ 1) * kBN * LD, V, p.v_sl, k0 + kBN, p.Lk);
        }
        cp_async_commit();
        cp_async_wait<1>();  // this tile has landed; the prefetch may still fly
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 columns; one ldmatrix.x4
        // gives the B fragments of two 8-column tiles
        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t kb[4];
                ldmatrix_x4(kb, cK + (np * 16 + (mtx >> 1) * 8 + lane % 8) * LD + ks * 16 +
                                    (mtx & 1) * 8);
                mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
                mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
            }
        }

        // scale, softcap, mask; then the online-softmax update in f32
        const bool inside = k0 + kBN <= p.Lk && (!p.causal || k0 + kBN - 1 <= q0) &&
                            (p.window <= 0 || q0 + kBM - 1 - k0 < p.window);
        float mt[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = k0 + nt * 8 + cq + (e & 1);
                s[nt][e] = score(p, s[nt][e], rows[e >> 1], col, inside);
                mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
            }
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
            mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
            alpha[i] = __expf(m[i] - mt[i]);
            m[i] = mt[i];
            l[i] *= alpha[i];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
                l[e >> 1] += s[nt][e];
            }
        }
#pragma unroll
        for (int t = 0; t < OT; ++t) {
            o[t][0] *= alpha[0];
            o[t][1] *= alpha[0];
            o[t][2] *= alpha[1];
            o[t][3] *= alpha[1];
        }

        // O += P V: the S accumulators of column tiles 2j, 2j+1 are exactly
        // the A fragment of k-step j; V^T fragments come from ldmatrix.trans.
        // P enters as a bf16 hi + lo pair (two products), so the output
        // matches the f32 softmax of the plain version to ~2^-16 instead of
        // ~2^-9: the paged engine (plain attention) and the kernel-backed
        // forward then round the same values, and greedy decoding agrees.
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) {
            uint32_t a[4], a_lo[4];
            split_bf16(s[2 * j][0], s[2 * j][1], a[0], a_lo[0]);
            split_bf16(s[2 * j][2], s[2 * j][3], a[1], a_lo[1]);
            split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], a[2], a_lo[2]);
            split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], a[3], a_lo[3]);
            const __nv_bfloat16* vrow =
                cV + (j * 16 + (mtx & 1) * 8 + lane % 8) * LD + (mtx >> 1) * 8;
#pragma unroll
            for (int dt = 0; dt < D / 16; ++dt) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, vrow + dt * 16);
                mma_bf16(o[2 * dt], a, bv[0], bv[1]);
                mma_bf16(o[2 * dt], a_lo, bv[0], bv[1]);
                mma_bf16(o[2 * dt + 1], a, bv[2], bv[3]);
                mma_bf16(o[2 * dt + 1], a_lo, bv[2], bv[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    // finish: full row sums across the quad, normalise, write out and lse
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + int64_t(b) * p.o_sb + int64_t(h) * p.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (rows[i] >= p.Lq) continue;
        const float li = l[i] == 0.f ? 1.f : l[i];  // rows that saw nothing -> 0
        const float inv = 1.f / li;
        __nv_bfloat16* orow = O + int64_t(rows[i]) * p.o_sl;
#pragma unroll
        for (int t = 0; t < OT; ++t) {
            *reinterpret_cast<uint32_t*>(orow + t * 8 + cq) =
                pack_bf16(o[t][2 * i] * inv, o[t][2 * i + 1] * inv);
        }
        if (lane % 4 == 0)
            p.lse[(int64_t(b) * p.H + h) * p.Lq + rows[i]] = m[i] + logf(li);
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, exact f32 arithmetic (the parity configurations)
// ---------------------------------------------------------------------------

constexpr int kF32BM = 16;  // q rows per CTA (4 per warp)
constexpr int kF32BN = 32;  // kv rows per tile: one per lane

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const __grid_constant__ FwdParams p) {
    constexpr int RPW = kF32BM / 4;  // rows per warp
    constexpr int DPL = D / 32;      // output columns per lane
    __shared__ float sQ[kF32BM][D];
    __shared__ float sK[kF32BN][D + 1];  // +1: lanes read different rows conflict-free
    __shared__ float sV[kF32BN][D];

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (p.H / p.Hk);
    const int q0 = blockIdx.x * kF32BM;
    const float* Q = static_cast<const float*>(p.q) + int64_t(b) * p.q_sb + int64_t(h) * p.q_sh;
    const float* K = static_cast<const float*>(p.k) + int64_t(b) * p.k_sb + int64_t(hk) * p.k_sh;
    const float* V = static_cast<const float*>(p.v) + int64_t(b) * p.v_sb + int64_t(hk) * p.v_sh;

    for (int i = threadIdx.x; i < kF32BM * D; i += kThreads) {
        int r = i / D, c = i % D;
        sQ[r][c] = q0 + r < p.Lq ? Q[int64_t(q0 + r) * p.q_sl + c] : 0.f;
    }

    float acc[RPW][DPL];
    float m[RPW], l[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
    }

    int kt_begin, kt_end;
    live_tiles(p, q0, kF32BM, kF32BN, &kt_begin, &kt_end);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * kF32BN;
        // all of this thread's loads are issued before any store
        float kr[kF32BN * D / kThreads], vr[kF32BN * D / kThreads];
#pragma unroll
        for (int it = 0; it < kF32BN * D / kThreads; ++it) {
            const int i = threadIdx.x + it * kThreads, r = i / D, c = i % D;
            const bool in = k0 + r < p.Lk;
            kr[it] = in ? K[int64_t(k0 + r) * p.k_sl + c] : 0.f;
            vr[it] = in ? V[int64_t(k0 + r) * p.v_sl + c] : 0.f;
        }
        __syncthreads();  // every warp is done with the previous tile
#pragma unroll
        for (int it = 0; it < kF32BN * D / kThreads; ++it) {
            const int i = threadIdx.x + it * kThreads, r = i / D, c = i % D;
            sK[r][c] = kr[it];
            sV[r][c] = vr[it];
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int tr = warp * RPW + r;
            float dot = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) dot = fmaf(sQ[tr][d], sK[lane][d], dot);
            const float s = score(p, dot, q0 + tr, k0 + lane, false);
            float mt = s;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
            const float m_new = fmaxf(m[r], mt);
            const float alpha = expf(m[r] - m_new);
            const float pj = expf(s - m_new);
            float ps = pj;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
            l[r] = l[r] * alpha + ps;
            m[r] = m_new;
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
            for (int j = 0; j < kF32BN; ++j) {
                const float pjj = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
                for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pjj, sV[j][lane + 32 * i], acc[r][i]);
            }
        }
    }

    float* O = static_cast<float*>(p.o) + int64_t(b) * p.o_sb + int64_t(h) * p.o_sh;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int row = q0 + warp * RPW + r;
        if (row >= p.Lq) continue;
        const float li = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
        for (int i = 0; i < DPL; ++i) O[int64_t(row) * p.o_sl + lane + 32 * i] = acc[r][i] / li;
        if (lane == 0) p.lse[(int64_t(b) * p.H + h) * p.Lq + row] = m[r] + logf(li);
    }
}

// ---------------------------------------------------------------------------
// host entry point
// ---------------------------------------------------------------------------

template <int D>
static cudaError_t launch_bf16(const FwdParams& p, cudaStream_t stream) {
    const size_t smem = bf16_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((p.Lq + kBM - 1) / kBM, p.H, p.B);
    flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
static cudaError_t launch_f32(const FwdParams& p, cudaStream_t stream) {
    dim3 grid((p.Lq + kF32BM - 1) / kF32BM, p.H, p.B);
    flash_fwd_f32_kernel<D><<<grid, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
}

// dtype: 0 = bfloat16, 1 = float32. Returns a cudaError_t (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int64_t q_sb, int64_t q_sl, int64_t q_sh,
                                   int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
                                   int64_t v_sl, int64_t v_sh, int64_t o_sb, int64_t o_sl,
                                   int64_t o_sh, int B, int Lq, int Lk, int H, int Hk, int D,
                                   int dtype, int causal, int window, float softcap,
                                   float scale, void* stream) {
    FwdParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.lse = static_cast<float*>(lse);
    p.q_sb = q_sb;
    p.q_sl = q_sl;
    p.q_sh = q_sh;
    p.k_sb = k_sb;
    p.k_sl = k_sl;
    p.k_sh = k_sh;
    p.v_sb = v_sb;
    p.v_sl = v_sl;
    p.v_sh = v_sh;
    p.o_sb = o_sb;
    p.o_sl = o_sl;
    p.o_sh = o_sh;
    p.B = B;
    p.Lq = Lq;
    p.Lk = Lk;
    p.H = H;
    p.Hk = Hk;
    p.causal = causal;
    p.window = window;
    p.softcap = softcap;
    p.scale = scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        if (D == 64) return int(launch_bf16<64>(p, st));
        if (D == 128) return int(launch_bf16<128>(p, st));
    } else if (dtype == 1) {
        if (D == 64) return int(launch_f32<64>(p, st));
        if (D == 128) return int(launch_f32<128>(p, st));
    }
    return int(cudaErrorInvalidValue);
}
