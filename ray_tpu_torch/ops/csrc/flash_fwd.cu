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
// operations, which only wgmma reaches at full rate. The bf16 design keeps
// the tensor cores fed and everything between the two products on chip:
// - one CTA owns one (batch, q head, 128-row q tile): warpgroups 0 and 1
//   consume 64 rows each, warpgroup 2 is the producer (setmaxnreg moves the
//   producer's registers to the consumers);
// - one thread of the producer issues the TMA copies: Q once, then K and V tiles of 128
//   rows into a two-stage ring (128-byte swizzled slabs, hopper.cuh), each
//   stage with a full and an empty mbarrier for K and for V, so K of the next
//   tile loads while this tile's softmax and PV product run;
// - S = Q K^T and O += P V run as wgmma m64nNk16 (bf16 in, f32 accumulate):
//   Q, K and V straight from the swizzled slabs, P from registers in bf16;
//   the two consumer warpgroups run independently, so one's softmax can
//   overlap the other's products;
// - the running max, row sums and the 64 x D accumulator stay in f32
//   registers (online softmax), so the [Lq, Lk] scores never reach device
//   memory; only tiles the band's edge or the ragged end cut take the
//   per-element mask, and tiles wholly outside the band are never loaded
//   (the TPU kernel's _block_band predicate, live_tiles here);
// - the q tiles with the most causal work are launched first.
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
// returns cudaGetLastError(); for bf16 it first encodes the three tensor
// maps (pointers change every call).

#include "flash_common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed tiles; a producer and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kBM = 64 * kConsumers;  // q rows per CTA: 64 per consumer warpgroup
constexpr int kBN = 128;          // kv rows per tile
constexpr int kBf16Threads = 128 * (kConsumers + 1);  // the last warpgroup produces
constexpr int kStages = 2;        // K and V tiles in flight
// setmaxnreg: 24 * 128 + 240 * 256 = 64512 <= 65536 registers. (ptxas still
// compiles the consumers within the launch bound of 168 a thread.)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// dynamic shared memory, in bytes from a 1024-aligned base: Q (D / 64
// swizzled slabs of kBM rows), the K and V rings (each tile D / 64 slabs of
// kBN rows), the mbarriers
template <int D>
struct FwdSmem {
    static constexpr int kQSlabBytes = kBM * 128;
    static constexpr int kSlabBytes = kBN * 128;
    static constexpr int kQBytes = kBM * D * 2;
    static constexpr int kTileBytes = kBN * D * 2;
    static constexpr int kQ = 0;
    static constexpr int kK = kQ + kQBytes;
    static constexpr int kV = kK + kStages * kTileBytes;
    static constexpr int kBars = kV + kStages * kTileBytes;
    static constexpr int kNumBars = 1 + 4 * kStages;  // Q full; K, V full and empty
    static constexpr size_t kBytes = kBars + 8 * kNumBars + 1024;  // + alignment slack
};

// --- the consumer warpgroup's steps. Stage and phase of kv tile i: stage
// i % kStages, phase parity (i / kStages) & 1.

// issue S = Q K^T (64 x 128) for the K tile at ``k_tile``: Q and K K-major
// in shared memory
template <int D>
__device__ __forceinline__ void issue_qk(float (&acc)[kBN / 2], uint32_t q_addr, uint32_t k_tile) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;  // k-steps 4..7 in the second slab
        wgmma_m64n128k16_ss(
            acc, wgmma_desc_b128(q_addr + (ks / 4) * FwdSmem<D>::kQSlabBytes + col, 16, 1024),
            wgmma_desc_b128(k_tile + (ks / 4) * FwdSmem<D>::kSlabBytes + col, 16, 1024), ks > 0);
    }
    wgmma_commit();
}

// issue O += P V for the V tile at ``v_tile``: P from registers, V MN-major
// in shared memory
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t v_tile) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t vd = wgmma_desc_b128(v_tile + kk * 16 * 128, FwdSmem<D>::kSlabBytes, 1024);
        if constexpr (D == 128)
            wgmma_m64n128k16_rs_tb(o, pa[kk], vd);
        else
            wgmma_m64n64k16_rs_tb(o, pa[kk], vd);
    }
    wgmma_commit();
}

// this warp is done with stage i % kStages of a ring (after the wgmma_wait
// of the product that read it): one arrival a warp
__device__ __forceinline__ void release(uint64_t* empty, int i, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % kStages);
}

// One tile of the online softmax for this thread's rows ``rows``: turns the
// raw products in ``acc`` (kv columns k0..k0 + 127) into unnormalised f32
// probabilities in place, updates the running max ``m2`` (log2 units) and
// the row sums ``l``, and returns in ``alpha`` the factor by which the
// accumulator rows must be rescaled. Only a tile that the band's edge or the
// ragged end cuts for these 64 rows (from qw) takes the per-element mask.
template <class P>
__device__ __forceinline__ void softmax_tile(const P& p, float (&acc)[kBN / 2], float (&m2)[2],
                                             float (&l)[2], float (&alpha)[2], int k0, int qw,
                                             const int (&rows)[2], int cq) {
    const bool inside = k0 + kBN <= p.Lk && (!p.causal || k0 + kBN - 1 <= qw) &&
                        (p.window <= 0 || qw + 63 - k0 < p.window);
    float to_log2 = p.scale * kLog2e;  // from acc to log2 units
    if (p.softcap > 0.f || !inside) {
        // scores in log2 units: scale, softcap (before the mask), mask
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) {
            acc[j] = capped(p, acc[j]) * kLog2e;
            if (!inside && !visible(p, rows[(j >> 1) & 1], k0 + 8 * (j / 4) + cq + (j & 1)))
                acc[j] = NEG_INF;
        }
        to_log2 = 1.f;
    }
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) mt[(j >> 1) & 1] = fmaxf(mt[(j >> 1) & 1], acc[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m2[r], mt[r] * to_log2);
        alpha[r] = ex2(m2[r] - m_new);
        m2[r] = m_new;
        l[r] *= alpha[r];
    }
    // with to_log2 = 1 the fma is exact: masked scores give
    // NEG_INF - NEG_INF = 0 (fake mass, see above), never NaN
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) {
        acc[j] = ex2(fmaf(acc[j], to_log2, -m2[(j >> 1) & 1]));
        l[(j >> 1) & 1] += acc[j];
    }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] *= alpha[(j >> 1) & 1];
}

// P in bf16 as the register A operand: the probabilities of columns
// 16kk..16kk+15 are acc[8kk..8kk+7]
__device__ __forceinline__ void pack_p(const float (&acc)[kBN / 2], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
    }
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ FwdParams p,
                          const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv) {
    using S = FwdSmem<D>;
    constexpr int kSlabs = D / 64;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBars);
    uint64_t* k_full = q_full + 1;
    uint64_t* v_full = k_full + kStages;
    uint64_t* k_empty = v_full + kStages;
    uint64_t* v_empty = k_empty + kStages;

    // heaviest causal q tiles first: blockIdx.x counts down the q tiles
    const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (p.H / p.Hk);
    int kt_begin, kt_end;
    live_tiles(p, q0, kBM, kBN, &kt_begin, &kt_end);
    const int n_tiles = max(kt_end - kt_begin, 0);

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(k_full + s, 1);
            mbar_init(v_full + s, 1);
            mbar_init(k_empty + s, 4 * kConsumers);  // one arrival a consumer warp
            mbar_init(v_empty + s, 4 * kConsumers);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == kConsumers) {
        // producer: one thread issues every TMA copy; the rest of the
        // warpgroup only gives its registers back
        warpgroup_reg_dealloc<kProducerRegs>();
        if (threadIdx.x == 128 * kConsumers && n_tiles > 0) {
            mbar_arrive_expect_tx(q_full, S::kQBytes);
            for (int c = 0; c < kSlabs; ++c)
                tma_load_4d(smem + S::kQ + c * S::kQSlabBytes, &tq, q_full, c * 64, h, q0, b);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % kStages;
                const uint32_t parity = ((i / kStages) & 1) ^ 1;  // the first round passes
                const int k0 = (kt_begin + i) * kBN;
                unsigned char* sk = smem + S::kK + s * S::kTileBytes;
                unsigned char* sv = smem + S::kV + s * S::kTileBytes;
                mbar_wait(k_empty + s, parity);
                mbar_arrive_expect_tx(k_full + s, S::kTileBytes);
                for (int c = 0; c < kSlabs; ++c)
                    tma_load_4d(sk + c * S::kSlabBytes, &tk, k_full + s, c * 64, hk, k0, b);
                mbar_wait(v_empty + s, parity);
                mbar_arrive_expect_tx(v_full + s, S::kTileBytes);
                for (int c = 0; c < kSlabs; ++c)
                    tma_load_4d(sv + c * S::kSlabBytes, &tv, v_full + s, c * 64, hk, k0, b);
            }
        }
    } else {
        warpgroup_reg_alloc<kConsumerRegs>();
        const int cw = wg;  // this warpgroup's rows: q0 + 64 cw ..
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
        const int qw = q0 + 64 * cw;
        const int r0 = 16 * warp + lane / 4;  // rows r0 and r0 + 8 of the 64
        const int cq = (lane % 4) * 2;        // columns cq, cq + 1 of each 8
        const int rows[2] = {qw + r0, qw + r0 + 8};
        const uint32_t q_addr = smem_u32(smem + S::kQ) + cw * 64 * 128;
        const uint32_t k_addr = smem_u32(smem + S::kK);
        const uint32_t v_addr = smem_u32(smem + S::kV);

        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        // running max of the scores in log2 units (score * log2 e) and the
        // running row sums (this thread's partials)
        float m2[2] = {NEG_INF, NEG_INF};
        float l[2] = {0.f, 0.f};

        // Each warpgroup runs S = Q K^T, the softmax and O += P V of a tile in
        // turn. The producer keeps the next tiles in flight, and the two
        // warpgroups share the tensor cores: one's softmax can run while the
        // other's products do.
        if (n_tiles > 0) {
            float acc[kBN / 2];
#pragma unroll
            for (int j = 0; j < kBN / 2; ++j) acc[j] = 0.f;
            float alpha[2];
            mbar_wait(q_full, 0);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % kStages;
                const uint32_t parity = (i / kStages) & 1;
                mbar_wait(k_full + s, parity);
                issue_qk<D>(acc, q_addr, k_addr + s * S::kTileBytes);
                wgmma_wait<0>();
                fence_regs(acc);
                release(k_empty, i, lane);
                softmax_tile(p, acc, m2, l, alpha, (kt_begin + i) * kBN, qw, rows, cq);
                rescale(o, alpha);
                uint32_t pa[kBN / 16][4];
                pack_p(acc, pa);
                mbar_wait(v_full + s, parity);
                issue_pv<D>(o, pa, v_addr + s * S::kTileBytes);
                wgmma_wait<0>();
                fence_regs(o);
                release(v_empty, i, lane);
            }
        }

        // finish: full row sums across the quad, normalise, write out and lse
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
        __nv_bfloat16* O =
            static_cast<__nv_bfloat16*>(p.o) + int64_t(b) * p.o_sb + int64_t(h) * p.o_sh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            if (rows[r] >= p.Lq) continue;
            const float lr = l[r] == 0.f ? 1.f : l[r];  // rows that saw nothing -> 0
            const float inv = 1.f / lr;
            __nv_bfloat16* orow = O + int64_t(rows[r]) * p.o_sl;
#pragma unroll
            for (int i = 0; i < D / 8; ++i)
                *reinterpret_cast<uint32_t*>(orow + 8 * i + cq) =
                    pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
            // the max is kept in log2 units; a row that saw only masked
            // scores keeps NEG_INF, as the plain version does
            if (lane % 4 == 0)
                p.lse[(int64_t(b) * p.H + h) * p.Lq + rows[r]] =
                    m2[r] == NEG_INF ? NEG_INF : m2[r] / kLog2e + logf(lr);
        }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, exact f32 arithmetic (the parity configurations)
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // 4 warps
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

// The runtime call comes first: in a thread where no CUDA context is
// current yet (an autograd worker thread, say), it makes the device's
// context current, which cuTensorMapEncodeTiled needs.
template <int D>
static cudaError_t launch_bf16(const FwdParams& p, cudaStream_t stream) {
    const size_t smem = FwdSmem<D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    CUtensorMap tq, tk, tv;
    if (err == cudaSuccess)
        err = make_bf16_tile_map(&tq, p.q, p.B, p.Lq, p.H, D, p.q_sb, p.q_sl, p.q_sh, kBM);
    if (err == cudaSuccess)
        err = make_bf16_tile_map(&tk, p.k, p.B, p.Lk, p.Hk, D, p.k_sb, p.k_sl, p.k_sh, kBN);
    if (err == cudaSuccess)
        err = make_bf16_tile_map(&tv, p.v, p.B, p.Lk, p.Hk, D, p.v_sb, p.v_sl, p.v_sh, kBN);
    if (err != cudaSuccess) return err;
    dim3 grid((p.Lq + kBM - 1) / kBM, p.H, p.B);
    flash_fwd_bf16_kernel<D><<<grid, kBf16Threads, smem, stream>>>(p, tq, tk, tv);
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
