// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes:
// two kernels, dQ and dK/dV, with no atomics, so the gradients are
// deterministic.
//
// Replaces ray_tpu/ops/flash_pallas.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (the TPU Pallas backward). Both recompute the
// scores of a (q tile, kv tile) pair from Q K^T, apply the softcap before
// the mask (finite NEG_INF, so a masked p = exp(NEG_INF - lse) is exactly
// 0), and form
//     p  = exp(s - lse),   dP = dO V^T,   dS = p * (dP - D) * (1 - (s_hat/cap)^2)
//     dQ = scale * dS K,   dK = scale * dS^T Q,   dV = p^T dO
// with D = rowsum(dO * O) and the softcap chain factor only under a softcap.
// The band is the forward's (flash_common.cuh): causal, sliding window,
// columns past Lk masked, rows and columns counted from 0.
//
// Layouts are the JAX ones, read through strides: q, o, dout, dq
// [B, Lq, H, D]; k, v, dk, dv [B, Lk, Hk, D] (last dim contiguous); lse and
// D [B, H, Lq] float32. GQA stays native: q head h reads kv head
// h / (H / Hk), and dk/dv come out at Hk heads.
//
// What bounds them on an H100: 7 matrix products per (q tile, kv tile) pair
// between them (dQ: Q K^T, dO V^T, dS K; dK/dV: K Q^T, V dO^T, P^T dO,
// dS^T Q), ~L/2 multiply-adds per byte of input at L = 4096: tensor-core
// operations, which only wgmma reaches at full rate. FlashAttention-2/3
// fuse dQ into the dK/dV sweep (5 products) with f32 atomics; the split
// here, as in the TPU reference, keeps the sums in one fixed order. The bf16
// design, shared by the two kernels, keeps every [q, kv] intermediate in
// registers and the tensor cores fed from shared memory:
//
// - a CTA owns 128 rows of one (batch, head) and is two warpgroups of 64
//   rows each, with up to 255 registers a thread: enough for two 64 x D f32
//   accumulators beside two score tiles. A separate producer warp or
//   warpgroup would cut that to 168 (see kBf16Threads), so warp 0 also
//   issues the copies: TMA (128-byte swizzled slabs, hopper.cuh), and
//   cp.async for the dK/dV kernel's lse and D rows;
// - the owned rows stay resident in shared memory; the other side streams
//   through a ring of stages, each with a full and an empty mbarrier;
// - scores and their gradients are wgmma accumulators (ss: both operands
//   K-major from the slabs); P and dS are rounded to bf16 in registers and
//   feed the accumulating products as the register A operand, with the
//   streamed tile read MN-major through the transpose bit (as V in the
//   forward's P V);
// - accumulators stay in f32 registers and are rounded once, at the end;
// - a tile that the band's edge or the ragged end cuts takes the
//   per-element mask; a tile wholly outside one warpgroup's band is skipped
//   by that warpgroup; tiles wholly outside the CTA's band are never loaded.
//
// - dQ (flash_bwd_dq_*): a CTA owns (batch, q head, 128-row q tile): Q and
//   dO resident, K and V tiles of DqSmem<D>::kBN rows streaming. Per tile:
//   S = Q K^T and dP = dO V^T (ss), P (times the softcap factor) computed
//   while dP is in flight, dS = P (dP - D), dQ += dS K (K MN-major). It also
//   computes D = rowsum(dO * O) for its rows while the first tiles load and
//   writes it out (the TPU wrapper computes it in XLA before the two
//   sweeps), so it runs first.
// - dK/dV (flash_bwd_dkv_*): a CTA owns (batch, kv head, 128-row kv tile):
//   K and V resident; Q and dO tiles of kDkvBM rows stream, with their lse
//   and D rows, which warp 0's lanes copy into the same stage.
//   The ring walks every q head of the group and, for each, the q tiles
//   that intersect the band (the TPU grid's sequential t = g * nq + qi axis
//   becomes this loop). Per step: S^T = K Q^T and dP^T = V dO^T (ss), P^T
//   and dS^T in registers, dV += P^T dO and dK += dS^T Q (dO, Q MN-major).
// - head dim 256 (Gemma-2) keeps that design within the same 255
//   registers and 227 KB: the streamed tiles are 32 rows (DqSmem,
//   DkvSmem), and a 64 x 256 f32 accumulator is 128 registers a thread, so
//   the dK/dV kernel holds one at a time and sweeps its q tiles twice, dV
//   first, then dK, its warps refilling the ring (flash_bwd_dkv_sweeps_*).
// - order: the tiles with the most causal work launch first. The dK/dV
//   kernel takes them first across every (batch, kv head): the kv tile is
//   the grid's slowest axis, so no late head's heavy tiles are left for a
//   last, half-empty wave. The dQ kernel takes them first within each
//   (batch, head), whose CTAs then run side by side on the same K and V;
//   each order measured faster for its own kernel
//   (experiments/torch_flash_bwd_variants.py).
//
// P and dS enter their products as plain bf16 (8 significant bits), as in
// FlashAttention-2/3 and the forward; the gradients are held to 2e-2 of their
// largest magnitude against the float32 plain version. Products accumulate
// in f32 and each output is rounded to the input dtype once, at the end.
//
// float32 inputs take CUDA-core paths with exact f32 FMAs (parity, not
// speed), as the forward does. The host functions launch on the caller's
// stream, allocate nothing and return cudaGetLastError(); for bf16 they
// first encode the four tensor maps (pointers change every call).

#include "flash_common.cuh"
#include "hopper.cuh"

struct BwdParams {
    const void* q;
    const void* k;
    const void* v;
    const void* o;
    const void* dout;
    const float* lse;
    float* delta;  // [B, H, Lq]: written by the dQ kernel, read by the dK/dV kernel
    void* dq;
    void* dk;
    void* dv;
    int64_t q_sb, q_sl, q_sh;  // element strides: batch, position, head
    int64_t k_sb, k_sl, k_sh;
    int64_t v_sb, v_sl, v_sh;
    int64_t o_sb, o_sl, o_sh;
    int64_t do_sb, do_sl, do_sh;
    int64_t dq_sb, dq_sl, dq_sh;
    int64_t dk_sb, dk_sl, dk_sh;
    int64_t dv_sb, dv_sl, dv_sh;
    int B, Lq, Lk, H, Hk;
    int causal;
    int window;     // 0 = no window
    float softcap;  // 0 = off
    float scale;
};

// d(capped score)/d(raw score) = 1 - (s_hat / cap)^2; 1 without a softcap
__device__ __forceinline__ float cap_factor(const BwdParams& p, float s_hat) {
    if (p.softcap > 0.f) {
        const float t = s_hat / p.softcap;
        return 1.f - t * t;
    }
    return 1.f;
}

// q tiles [begin, end) with a row that sees a column of kv rows [k0, k0 + bn)
__device__ __forceinline__ void live_q_tiles(const BwdParams& p, int k0, int bn, int bm,
                                             int* begin, int* end) {
    const int nq = (p.Lq + bm - 1) / bm;
    int b = 0, e = nq;
    if (p.causal) b = min(nq, k0 / bm);  // rows >= k0
    if (p.window > 0) e = min(nq, (k0 + bn + p.window - 2) / bm + 1);  // rows < k0+bn-1+window
    *begin = b;
    *end = e;
}

constexpr int kThreads = 128;  // the f32 kernels: 4 warps

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed tiles; two warpgroups, whose warp 0 also loads
// ---------------------------------------------------------------------------

constexpr int kWarpgroups = 2;
constexpr int kRows = 64 * kWarpgroups;  // rows a CTA owns: 64 a warpgroup
// The SM's 65,536 registers are four quadrants of 16,384, and a CTA's warps
// are dealt over them in turn. With 9 to 12 warps a quadrant holds 3, and
// ptxas compiles every thread within 168 registers (setmaxnreg does not
// lift that), so a producer warp costs as much as a producer warpgroup. The
// kernels hold a 64 x D f32 accumulator or two beside two score tiles: more
// than 168 at D = 128. So a CTA is the two warpgroups alone (2 warps a
// quadrant: up to 255 registers), and warp 0 also loads: the first round
// of the ring up front, then at the end of step i step i + stages into
// the stage of step i, once both warpgroups have released it. The refill
// stays out of the span in which a wgmma is in flight: warp-divergent code
// there makes ptxas serialise the wgmma (C7518).
constexpr int kBf16Threads = 128 * kWarpgroups;
constexpr int kDqBN = 128;     // dQ: kv rows of a streamed K / V tile (D <= 128)
constexpr int kDqStages = 2;   // dQ: K and V tiles in flight
constexpr int kDkvBM = 64;     // dK/dV: q rows of a streamed Q / dO tile (D <= 128)
constexpr int kDkvStages = 2;  // dK/dV: Q and dO tiles in flight
// At D = 256 the owned rows alone take 128 KB (Q and dO, or K and V), so a
// streamed tile is 32 rows in both kernels: two stages of two 16 KB tiles
// bring a CTA to 192 KB of the 227 KB (64-row tiles: 256 KB). The score
// tiles are then m64n32 products, four 64-column slabs deep, and the
// accumulating products one m64n256k16 a 16-row k-step.
constexpr int kWideRows = 32;

// Dynamic shared memory of the dQ kernel, in bytes from a 1024-aligned
// base: Q and dO (D / 64 slabs of kRows rows each), the K and V rings (each
// tile D / 64 slabs of kBN rows), D of the CTA's rows, the mbarriers.
template <int D>
struct DqSmem {
    static constexpr int kBN = D <= 128 ? kDqBN : kWideRows;  // kv rows of a streamed tile
    static constexpr int kResSlab = kRows * 128;
    static constexpr int kTileSlab = kBN * 128;
    static constexpr int kResBytes = kRows * D * 2;
    static constexpr int kTileBytes = kBN * D * 2;
    static constexpr int kQ = 0;
    static constexpr int kDO = kQ + kResBytes;
    static constexpr int kK = kDO + kResBytes;
    static constexpr int kV = kK + kDqStages * kTileBytes;
    static constexpr int kDelta = kV + kDqStages * kTileBytes;
    static constexpr int kBars = kDelta + kRows * 4;
    static constexpr int kNumBars = 1 + 2 * kDqStages;  // Q + dO full; stage full and empty
    static constexpr size_t kBytes = kBars + 8 * kNumBars + 1024;  // + alignment slack
};

// Dynamic shared memory of the dK/dV kernels: K and V (D / 64 slabs of
// kRows rows each), the Q and dO rings (each tile D / 64 slabs of kBM
// rows), the lse and D rings (kBM floats a stage), the mbarriers. At
// D = 256 the ring carries each step twice, once a sweep (kSweeps).
template <int D>
struct DkvSmem {
    static constexpr int kBM = D <= 128 ? kDkvBM : kWideRows;  // q rows of a streamed tile
    static constexpr int kSweeps = D <= 128 ? 1 : 2;
    static constexpr int kResSlab = kRows * 128;
    static constexpr int kTileSlab = kBM * 128;
    static constexpr int kResBytes = kRows * D * 2;
    static constexpr int kTileBytes = kBM * D * 2;
    static constexpr int kK = 0;
    static constexpr int kV = kK + kResBytes;
    static constexpr int kQ = kV + kResBytes;
    static constexpr int kDO = kQ + kDkvStages * kTileBytes;
    static constexpr int kL = kDO + kDkvStages * kTileBytes;
    static constexpr int kD = kL + kDkvStages * kBM * 4;
    static constexpr int kBars = kD + kDkvStages * kBM * 4;
    static constexpr int kNumBars = 1 + 2 * kDkvStages;  // K + V full; stage full and empty
    static constexpr size_t kBytes = kBars + 8 * kNumBars + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                            ~uintptr_t(1023));
}

// issue acc = A B^T (64 x N) over D columns: A the 64 rows at ``a``, B the
// N rows at ``b``, both K-major, their 64-column slabs ``a_slab`` and
// ``b_slab`` bytes apart
template <int N, int D>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a, int a_slab, uint32_t b,
                                         int b_slab) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;  // k-steps 4..7 in the second slab
        wgmma_ss<N>(acc, wgmma_desc_b128(a + (ks / 4) * a_slab + col, 16, 1024),
                    wgmma_desc_b128(b + (ks / 4) * b_slab + col, 16, 1024), ks > 0);
    }
    wgmma_commit();
}

// issue acc += A T (64 x D): A (64 x K) bf16 in registers, T the K x D tile
// at ``t`` read MN-major, its 64-column slabs ``t_slab`` bytes apart
template <int K, int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                         uint32_t t, int t_slab) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
        wgmma_rs_tb<D>(acc, a[kk], wgmma_desc_b128(t + kk * 16 * 128, t_slab, 1024));
}

// this warp is done with stage i % STAGES of a ring (after the wgmma_wait
// of the product that read it): one arrival a warp
template <int STAGES>
__device__ __forceinline__ void release(uint64_t* empty, int i, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % STAGES);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// write rows ``rows`` (this thread's two) of a 64 x D f32 accumulator,
// times ``scale``, as bf16 to ``out`` (row stride ``ld``); rows >= n skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t ld, const float (&acc)[D / 2],
                                           const int (&rows)[2], int n, int cq, float scale) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (rows[r] >= n) continue;
        __nv_bfloat16* row = out + int64_t(rows[r]) * ld;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
            *reinterpret_cast<uint32_t*>(row + 8 * i + cq) =
                pack_bf16(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
    }
}

// D = rowsum(dO * O) of the 16 q rows from ``row0``, by one warp: each row's
// 16-byte chunks spread over D / 8 lanes and summed by shuffles. Written to
// ``out`` (16 floats, shared) and, for rows < Lq, to ``delta``.
template <int D>
__device__ __forceinline__ void delta_rows(const BwdParams& p, const __nv_bfloat16* dO,
                                           const __nv_bfloat16* O, int row0, float* out,
                                           float* delta, int lane) {
    constexpr int CH = D / 8;     // 16-byte chunks a row
    constexpr int RPI = 32 / CH;  // rows an iteration
#pragma unroll
    for (int it = 0; it < 16 / RPI; ++it) {
        const int r = it * RPI + lane / CH, row = row0 + r, c = (lane % CH) * 8;
        float acc = 0.f;
        if (row < p.Lq) {
            const uint4 x = *reinterpret_cast<const uint4*>(dO + int64_t(row) * p.do_sl + c);
            const uint4 y = *reinterpret_cast<const uint4*>(O + int64_t(row) * p.o_sl + c);
            const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
            const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 a = __bfloat1622float2(xs[e]), b = __bfloat1622float2(ys[e]);
                acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
            }
        }
#pragma unroll
        for (int off = 1; off < CH; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane % CH == 0) {
            out[r] = acc;
            if (row < p.Lq) delta[row] = acc;
        }
    }
    __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ BwdParams p,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv) {
    using S = DqSmem<D>;
    constexpr int kBN = S::kBN;
    constexpr int kSlabs = D / 64;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align1024(smem_raw);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBars);  // Q and dO
    uint64_t* full = q_full + 1;  // K and V of a stage
    uint64_t* empty = full + kDqStages;

    // heaviest causal q tiles first: blockIdx.x counts down the q tiles
    const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (p.H / p.Hk);
    int kt_begin, kt_end;
    live_tiles(p, q0, kRows, kBN, &kt_begin, &kt_end);
    const int n_tiles = max(kt_end - kt_begin, 0);

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < kDqStages; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 4 * kWarpgroups);  // one arrival a warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    // issue tile i's K and V copies into stage i % kDqStages (one thread)
    auto load_tile = [&](int i) {
        const int s = i % kDqStages, k0 = (kt_begin + i) * kBN;
        unsigned char* sk = smem + S::kK + s * S::kTileBytes;
        unsigned char* sv = smem + S::kV + s * S::kTileBytes;
        mbar_arrive_expect_tx(full + s, 2 * S::kTileBytes);
        for (int c = 0; c < kSlabs; ++c) {
            tma_load_4d(sk + c * S::kTileSlab, &tk, full + s, c * 64, hk, k0, b);
            tma_load_4d(sv + c * S::kTileSlab, &tv, full + s, c * 64, hk, k0, b);
        }
    };
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0 && n_tiles > 0) {  // Q, dO and the first round of the ring
        mbar_arrive_expect_tx(q_full, 2 * S::kResBytes);
        for (int c = 0; c < kSlabs; ++c) {
            tma_load_4d(smem + S::kQ + c * S::kResSlab, &tq, q_full, c * 64, h, q0, b);
            tma_load_4d(smem + S::kDO + c * S::kResSlab, &tdo, q_full, c * 64, h, q0, b);
        }
        for (int i = 0; i < min(kDqStages, n_tiles); ++i) load_tile(i);
    }

    const int cw = warp / 4;  // this warpgroup's rows: q0 + 64 cw ..
    const int qw = q0 + 64 * cw;
    const int r0 = 16 * (warp % 4) + lane / 4;  // rows r0 and r0 + 8 of the 64
    const int cq = (lane % 4) * 2;              // columns cq, cq + 1 of each 8
    const int rows[2] = {qw + r0, qw + r0 + 8};
    const int64_t row_base = (int64_t(b) * p.H + h) * p.Lq;  // into lse and D

    // D of this warp's 16 rows, from global memory while the tiles load
    float* sdelta = reinterpret_cast<float*>(smem + S::kDelta) + 16 * warp;
    delta_rows<D>(p,
                  static_cast<const __nv_bfloat16*>(p.dout) + int64_t(b) * p.do_sb +
                      int64_t(h) * p.do_sh,
                  static_cast<const __nv_bfloat16*>(p.o) + int64_t(b) * p.o_sb + int64_t(h) * p.o_sh,
                  qw + 16 * (warp % 4), sdelta, p.delta + row_base, lane);
    const float dl[2] = {sdelta[lane / 4], sdelta[lane / 4 + 8]};
    float lse[2], lse2[2];  // natural and log2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        lse[r] = rows[r] < p.Lq ? p.lse[row_base + rows[r]] : 0.f;
        lse2[r] = lse[r] * kLog2e;
    }
    const float scale_log2 = p.scale * kLog2e;

    float dq[D / 2];
    zero(dq);
    if (n_tiles > 0) {
        const uint32_t q_addr = smem_u32(smem + S::kQ) + cw * 64 * 128;
        const uint32_t do_addr = smem_u32(smem + S::kDO) + cw * 64 * 128;
        const uint32_t k_addr = smem_u32(smem + S::kK);
        const uint32_t v_addr = smem_u32(smem + S::kV);
        float sc[kBN / 2], dp[kBN / 2];  // S (then P) and dP of a tile
        zero(sc);
        zero(dp);
        mbar_wait(q_full, 0);
        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % kDqStages;
            const uint32_t parity = (i / kDqStages) & 1;
            const int k0 = (kt_begin + i) * kBN;
            const uint32_t k_tile = k_addr + s * S::kTileBytes;
            const uint32_t v_tile = v_addr + s * S::kTileBytes;
            mbar_wait(full + s, parity);
            // a tile wholly outside this warpgroup's band adds nothing
            if (!((p.causal && k0 > qw + 63) ||
                  (p.window > 0 && qw - (k0 + kBN - 1) >= p.window))) {
                issue_ss<kBN, D>(sc, q_addr, S::kResSlab, k_tile, S::kTileSlab);  // S = Q K^T
                issue_ss<kBN, D>(dp, do_addr, S::kResSlab, v_tile, S::kTileSlab);  // dP = dO V^T
                wgmma_wait<1>();
                fence_regs(sc);
                // P times the softcap factor, in place of S, while dP is in flight
                const bool inside = k0 + kBN <= p.Lk && (!p.causal || k0 + kBN - 1 <= qw) &&
                                    (p.window <= 0 || qw + 63 - k0 < p.window);
                if (inside && p.softcap <= 0.f) {
#pragma unroll
                    for (int j = 0; j < kBN / 2; ++j)
                        sc[j] = ex2(fmaf(sc[j], scale_log2, -lse2[(j >> 1) & 1]));
                } else {
#pragma unroll
                    for (int j = 0; j < kBN / 2; ++j) {
                        const int r = (j >> 1) & 1, col = k0 + 8 * (j / 4) + cq + (j & 1);
                        const float s_hat = capped(p, sc[j]);
                        const float sm = inside || visible(p, rows[r], col) ? s_hat : NEG_INF;
                        sc[j] = ex2((sm - lse[r]) * kLog2e) * cap_factor(p, s_hat);
                    }
                }
                wgmma_wait<0>();
                fence_regs(dp);
                // dS = P (dP - D) in bf16, the A operand of dQ += dS K
                uint32_t da[kBN / 16][4];
#pragma unroll
                for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int j = 8 * kk + 2 * e;
                        da[kk][e] = pack_bf16(sc[j] * (dp[j] - dl[e & 1]),
                                              sc[j + 1] * (dp[j + 1] - dl[e & 1]));
                    }
                }
                wgmma_fence();
                issue_rs<kBN, D>(dq, da, k_tile, S::kTileSlab);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(dq);
            }
            release<kDqStages>(empty, i, lane);
            // warp 0 refills the stage once both warpgroups have released it
            if (warp == 0 && i + kDqStages < n_tiles) {
                mbar_wait(empty + s, parity);
                if (lane == 0) load_tile(i + kDqStages);
                __syncwarp();
            }
        }
    }
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dq) + int64_t(b) * p.dq_sb + int64_t(h) * p.dq_sh,
                  p.dq_sl, dq, rows, p.Lq, cq, p.scale);
}

// Start loading step ``it`` of the dK/dV ring into stage it % kDkvStages, by
// one warp: Q and dO by TMA (lane 0), lse and D by cp.async (every lane,
// which arrives on the stage's full barrier once its copies land), so the
// warp goes on at once. A sweep walks group * n_live steps; with two
// sweeps, step it and step it + group * n_live load the same tiles.
template <int D>
__device__ __forceinline__ void load_dkv_step(const BwdParams& p, unsigned char* smem,
                                              const CUtensorMap* tq, const CUtensorMap* tdo,
                                              uint64_t* full, int it, int b, int hk, int group,
                                              int n_live, int qt_begin, int lane) {
    using S = DkvSmem<D>;
    const int s = it % kDkvStages;
    const int j = S::kSweeps > 1 ? it % (group * n_live) : it;
    const int h = hk * group + j / n_live;
    const int q0 = (qt_begin + j % n_live) * S::kBM;
    const int64_t base = (int64_t(b) * p.H + h) * p.Lq;
    float* sl = reinterpret_cast<float*>(smem + S::kL) + s * S::kBM;
    float* sd = reinterpret_cast<float*>(smem + S::kD) + s * S::kBM;
    for (int r = lane; r < S::kBM; r += 32) {
        const bool in = q0 + r < p.Lq;
        const int64_t at = base + (in ? q0 + r : 0);
        cp_async4(sl + r, p.lse + at, in);
        cp_async4(sd + r, p.delta + at, in);
    }
    cp_async_mbar_arrive(full + s);
    if (lane == 0) {
        mbar_arrive_expect_tx(full + s, 2 * S::kTileBytes);
        unsigned char* sq = smem + S::kQ + s * S::kTileBytes;
        unsigned char* sdo = smem + S::kDO + s * S::kTileBytes;
        for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sq + c * S::kTileSlab, tq, full + s, c * 64, h, q0, b);
            tma_load_4d(sdo + c * S::kTileSlab, tdo, full + s, c * 64, h, q0, b);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ BwdParams p,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo) {
    using S = DkvSmem<D>;
    constexpr int kSlabs = D / 64;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align1024(smem_raw);
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::kBars);  // K and V
    uint64_t* full = kv_full + 1;              // Q, dO, lse, D of a stage
    uint64_t* empty = full + kDkvStages;
    const float* ring_lse = reinterpret_cast<const float*>(smem + S::kL);
    const float* ring_delta = reinterpret_cast<const float*>(smem + S::kD);

    // the low kv tiles, the heaviest, first across every (batch, kv head):
    // the kv tile is the grid's slowest axis
    const int k0 = blockIdx.z * kRows;
    const int hk = blockIdx.x, b = blockIdx.y;
    const int group = p.H / p.Hk;
    int qt_begin, qt_end;
    live_q_tiles(p, k0, kRows, kDkvBM, &qt_begin, &qt_end);
    const int n_live = max(qt_end - qt_begin, 0);
    const int n_steps = group * n_live;  // (q head of the group, q tile) pairs

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < kDkvStages; ++s) {
            mbar_init(full + s, 33);  // warp 0's lanes' copies and lane 0's TMA
            mbar_init(empty + s, 4 * kWarpgroups);  // one arrival a warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && n_steps > 0) {  // K, V and the first round of the ring
        if (lane == 0) {
            mbar_arrive_expect_tx(kv_full, 2 * S::kResBytes);
            for (int c = 0; c < kSlabs; ++c) {
                tma_load_4d(smem + S::kK + c * S::kResSlab, &tk, kv_full, c * 64, hk, k0, b);
                tma_load_4d(smem + S::kV + c * S::kResSlab, &tv, kv_full, c * 64, hk, k0, b);
            }
        }
        for (int it = 0; it < min(kDkvStages, n_steps); ++it)
            load_dkv_step<D>(p, smem, &tq, &tdo, full, it, b, hk, group, n_live, qt_begin, lane);
    }

    const int cw = warp / 4;  // this warpgroup's kv rows: k0 + 64 cw ..
    const int kw = k0 + 64 * cw;
    const int r0 = 16 * (warp % 4) + lane / 4;  // kv rows r0 and r0 + 8 of the 64
    const int cq = (lane % 4) * 2;              // q columns cq, cq + 1 of each 8
    const int kv_rows[2] = {kw + r0, kw + r0 + 8};
    const float scale_log2 = p.scale * kLog2e;

    float dk[D / 2], dv[D / 2];
    zero(dk);
    zero(dv);
    if (n_steps > 0) {
        const uint32_t k_addr = smem_u32(smem + S::kK) + cw * 64 * 128;
        const uint32_t v_addr = smem_u32(smem + S::kV) + cw * 64 * 128;
        const uint32_t q_ring = smem_u32(smem + S::kQ);
        const uint32_t do_ring = smem_u32(smem + S::kDO);
        float st[kDkvBM / 2], dpt[kDkvBM / 2];  // S^T and dP^T of a step
        zero(st);
        zero(dpt);
        mbar_wait(kv_full, 0);
        for (int it = 0; it < n_steps; ++it) {
            const int s = it % kDkvStages;
            const int q0 = (qt_begin + it % n_live) * kDkvBM;
            mbar_wait(full + s, (it / kDkvStages) & 1);
            // a q tile wholly outside this warpgroup's band adds nothing
            if (!((p.causal && q0 + kDkvBM - 1 < kw) ||
                  (p.window > 0 && q0 - (kw + 63) >= p.window))) {
                const uint32_t q_tile = q_ring + s * S::kTileBytes;
                const uint32_t do_tile = do_ring + s * S::kTileBytes;
                // S^T = K Q^T and dP^T = V dO^T: kv rows x q columns
                issue_ss<kDkvBM, D>(st, k_addr, S::kResSlab, q_tile, S::kTileSlab);
                issue_ss<kDkvBM, D>(dpt, v_addr, S::kResSlab, do_tile, S::kTileSlab);
                wgmma_wait<0>();
                fence_regs(st);
                fence_regs(dpt);
                // P^T and dS^T in bf16, the A operands of the two products; a
                // score's row is the q position (the column here), its column
                // the kv position
                const float* cl = ring_lse + s * kDkvBM;
                const float* cd = ring_delta + s * kDkvBM;
                const bool inside = q0 + kDkvBM <= p.Lq && kw + 64 <= p.Lk &&
                                    (!p.causal || kw + 63 <= q0) &&
                                    (p.window <= 0 || q0 + kDkvBM - 1 - kw < p.window);
                uint32_t pa[kDkvBM / 16][4], da[kDkvBM / 16][4];
                if (inside && p.softcap <= 0.f) {
#pragma unroll
                    for (int kk = 0; kk < kDkvBM / 16; ++kk) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int j = 8 * kk + 2 * e, c = 16 * kk + 8 * (e >> 1) + cq;
                            const float2 l2 = *reinterpret_cast<const float2*>(cl + c);
                            const float2 d2 = *reinterpret_cast<const float2*>(cd + c);
                            const float p0 = ex2(fmaf(st[j], scale_log2, -l2.x * kLog2e));
                            const float p1 = ex2(fmaf(st[j + 1], scale_log2, -l2.y * kLog2e));
                            pa[kk][e] = pack_bf16(p0, p1);
                            da[kk][e] = pack_bf16(p0 * (dpt[j] - d2.x), p1 * (dpt[j + 1] - d2.y));
                        }
                    }
                } else {
#pragma unroll
                    for (int kk = 0; kk < kDkvBM / 16; ++kk) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int j = 8 * kk + 2 * e, c = 16 * kk + 8 * (e >> 1) + cq;
                            float pr[2], g[2];
#pragma unroll
                            for (int u = 0; u < 2; ++u) {
                                const int q_row = q0 + c + u;
                                const float s_hat = capped(p, st[j + u]);
                                const bool in =
                                    inside || (q_row < p.Lq && visible(p, q_row, kv_rows[e & 1]));
                                pr[u] = ex2(((in ? s_hat : NEG_INF) - cl[c + u]) * kLog2e);
                                g[u] = pr[u] * (dpt[j + u] - cd[c + u]) * cap_factor(p, s_hat);
                            }
                            pa[kk][e] = pack_bf16(pr[0], pr[1]);
                            da[kk][e] = pack_bf16(g[0], g[1]);
                        }
                    }
                }
                // dV += P^T dO and dK += dS^T Q
                wgmma_fence();
                issue_rs<kDkvBM, D>(dv, pa, do_tile, S::kTileSlab);
                issue_rs<kDkvBM, D>(dk, da, q_tile, S::kTileSlab);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(dv);
                fence_regs(dk);
            }
            release<kDkvStages>(empty, it, lane);
            // warp 0 refills the stage once both warpgroups have released it
            if (warp == 0 && it + kDkvStages < n_steps) {
                mbar_wait(empty + s, (it / kDkvStages) & 1);
                load_dkv_step<D>(p, smem, &tq, &tdo, full, it + kDkvStages, b, hk, group, n_live,
                                 qt_begin, lane);
                __syncwarp();
            }
        }
    }
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dk) + int64_t(b) * p.dk_sb + int64_t(hk) * p.dk_sh,
                  p.dk_sl, dk, kv_rows, p.Lk, cq, p.scale);
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dv) + int64_t(b) * p.dv_sb + int64_t(hk) * p.dv_sh,
                  p.dv_sl, dv, kv_rows, p.Lk, cq, 1.f);
}

// One step of a dK/dV sweep at D = 256 for this warpgroup's 64 kv rows
// (from kw) against the q tile at q0 (addresses q_tile and do_tile, its lse
// and D rows cl and cd): S^T = K Q^T (ss) and, in the dK sweep (kDk),
// dP^T = V dO^T; then P^T (dV sweep) or dS^T (dK sweep) in bf16 as the A
// operand of acc += P^T dO or acc += dS^T Q (dO, Q MN-major). A score's row
// is the q position (the column here), its column the kv position.
template <int D, bool kDk>
__device__ __forceinline__ void dkv_sweep_step(const BwdParams& p, float (&acc)[D / 2],
                                               float (&st)[kWideRows / 2],
                                               float (&dpt)[kWideRows / 2], uint32_t k_addr,
                                               uint32_t v_addr, uint32_t q_tile, uint32_t do_tile,
                                               const float* cl, const float* cd, int q0, int kw,
                                               const int (&kv_rows)[2], int cq) {
    using S = DkvSmem<D>;
    constexpr int kBM = S::kBM;
    issue_ss<kBM, D>(st, k_addr, S::kResSlab, q_tile, S::kTileSlab);  // S^T = K Q^T
    if constexpr (kDk)
        issue_ss<kBM, D>(dpt, v_addr, S::kResSlab, do_tile, S::kTileSlab);  // dP^T = V dO^T
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const bool inside = q0 + kBM <= p.Lq && kw + 64 <= p.Lk && (!p.causal || kw + 63 <= q0) &&
                        (p.window <= 0 || q0 + kBM - 1 - kw < p.window);
    const float scale_log2 = p.scale * kLog2e;
    uint32_t a[kBM / 16][4];
    if (inside && p.softcap <= 0.f) {
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = 8 * kk + 2 * e, c = 16 * kk + 8 * (e >> 1) + cq;
                const float2 l2 = *reinterpret_cast<const float2*>(cl + c);
                const float p0 = ex2(fmaf(st[j], scale_log2, -l2.x * kLog2e));
                const float p1 = ex2(fmaf(st[j + 1], scale_log2, -l2.y * kLog2e));
                if constexpr (kDk) {
                    const float2 d2 = *reinterpret_cast<const float2*>(cd + c);
                    a[kk][e] = pack_bf16(p0 * (dpt[j] - d2.x), p1 * (dpt[j + 1] - d2.y));
                } else {
                    a[kk][e] = pack_bf16(p0, p1);
                }
            }
        }
    } else {
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = 8 * kk + 2 * e, c = 16 * kk + 8 * (e >> 1) + cq;
                float g[2];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int q_row = q0 + c + u;
                    const float s_hat = capped(p, st[j + u]);
                    const bool in = inside || (q_row < p.Lq && visible(p, q_row, kv_rows[e & 1]));
                    g[u] = ex2(((in ? s_hat : NEG_INF) - cl[c + u]) * kLog2e);
                    if constexpr (kDk) g[u] *= (dpt[j + u] - cd[c + u]) * cap_factor(p, s_hat);
                }
                a[kk][e] = pack_bf16(g[0], g[1]);
            }
        }
    }
    wgmma_fence();
    issue_rs<kBM, D>(acc, a, kDk ? q_tile : do_tile, S::kTileSlab);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
}

// dK/dV at D = 256 (DkvSmem<256>): one 64 x 256 f32 accumulator is 128
// registers a thread, so dK and dV together (256) do not fit the 255 a
// thread can have, before any score tile. This kernel keeps K and V
// resident as the fused one does and walks its (q head, q tile) steps
// twice through one ring, holding one accumulator at a time: the dV sweep
// (S^T = K Q^T, then dV += P^T dO), which stores dV when it ends, then the
// dK sweep (S^T = K Q^T and dP^T = V dO^T, then dK += dS^T Q). That is five
// products a step pair against the fused sweep's four; splitting D's
// columns instead would recompute both score tiles for each half (six).
// The ring runs on from one sweep into the next. Warp 0 loads the first
// round; after that the last warp to release a stage, elected by a shared
// counter as in the forward kernel at D = 256, refills it, so neither
// warpgroup waits for the other: 9-10% faster here than warp 0 waiting for
// both (PERF.md, bwd variants).
template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bwd_dkv_sweeps_bf16_kernel(const __grid_constant__ BwdParams p,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tdo) {
    using S = DkvSmem<D>;
    static_assert(S::kBM == kWideRows, "the sweeps take kWideRows-row q tiles");
    constexpr int kSlabs = D / 64;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align1024(smem_raw);
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::kBars);  // K and V
    uint64_t* full = kv_full + 1;              // Q, dO, lse, D of a stage
    uint64_t* empty = full + kDkvStages;
    const float* ring_lse = reinterpret_cast<const float*>(smem + S::kL);
    const float* ring_delta = reinterpret_cast<const float*>(smem + S::kD);

    // the low kv tiles, the heaviest, first across every (batch, kv head)
    const int k0 = blockIdx.z * kRows, hk = blockIdx.x, b = blockIdx.y;
    const int group = p.H / p.Hk;
    int qt_begin, qt_end;
    live_q_tiles(p, k0, kRows, S::kBM, &qt_begin, &qt_end);
    const int n_live = max(qt_end - qt_begin, 0);
    const int n_sweep = group * n_live;  // (q head of the group, q tile) pairs
    const int n_steps = 2 * n_sweep;     // the dV sweep, then the dK sweep
    __shared__ uint32_t releases[kDkvStages];  // warps done with a stage, all uses

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < kDkvStages; ++s) {
            mbar_init(full + s, 33);  // one warp's lanes' copies and its lane 0's TMA
            mbar_init(empty + s, 4 * kWarpgroups);  // one arrival a warp
            releases[s] = 0;
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && n_steps > 0) {  // K, V and the first round of the ring
        if (lane == 0) {
            mbar_arrive_expect_tx(kv_full, 2 * S::kResBytes);
            for (int c = 0; c < kSlabs; ++c) {
                tma_load_4d(smem + S::kK + c * S::kResSlab, &tk, kv_full, c * 64, hk, k0, b);
                tma_load_4d(smem + S::kV + c * S::kResSlab, &tv, kv_full, c * 64, hk, k0, b);
            }
        }
        for (int first = 0; first < min(kDkvStages, n_steps); ++first)
            load_dkv_step<D>(p, smem, &tq, &tdo, full, first, b, hk, group, n_live, qt_begin, lane);
    }

    const int cw = warp / 4;  // this warpgroup's kv rows: k0 + 64 cw ..
    const int kw = k0 + 64 * cw;
    const int r0 = 16 * (warp % 4) + lane / 4;  // kv rows r0 and r0 + 8 of the 64
    const int cq = (lane % 4) * 2;              // q columns cq, cq + 1 of each 8
    const int kv_rows[2] = {kw + r0, kw + r0 + 8};
    const uint32_t k_addr = smem_u32(smem + S::kK) + cw * 64 * 128;
    const uint32_t v_addr = smem_u32(smem + S::kV) + cw * 64 * 128;
    const uint32_t q_ring = smem_u32(smem + S::kQ);
    const uint32_t do_ring = smem_u32(smem + S::kDO);

    float acc[D / 2];                                 // dV, then dK
    float st[kWideRows / 2], dpt[kWideRows / 2];      // S^T and dP^T of a step
    zero(acc);
    zero(st);
    zero(dpt);
    if (n_steps > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_steps; ++it) {
        if (it == n_sweep) {  // the dV sweep is done
            store_rows<D>(static_cast<__nv_bfloat16*>(p.dv) + int64_t(b) * p.dv_sb +
                              int64_t(hk) * p.dv_sh,
                          p.dv_sl, acc, kv_rows, p.Lk, cq, 1.f);
            zero(acc);
        }
        const int s = it % kDkvStages;
        const int q0 = (qt_begin + (it % n_sweep) % n_live) * S::kBM;
        mbar_wait(full + s, (it / kDkvStages) & 1);
        // a q tile wholly outside this warpgroup's band adds nothing
        if (!((p.causal && q0 + S::kBM - 1 < kw) ||
              (p.window > 0 && q0 - (kw + 63) >= p.window))) {
            const uint32_t q_tile = q_ring + s * S::kTileBytes;
            const uint32_t do_tile = do_ring + s * S::kTileBytes;
            const float* cl = ring_lse + s * S::kBM;
            const float* cd = ring_delta + s * S::kBM;
            if (it < n_sweep)
                dkv_sweep_step<D, false>(p, acc, st, dpt, k_addr, v_addr, q_tile, do_tile, cl, cd,
                                         q0, kw, kv_rows, cq);
            else
                dkv_sweep_step<D, true>(p, acc, st, dpt, k_addr, v_addr, q_tile, do_tile, cl, cd,
                                        q0, kw, kv_rows, cq);
        }
        // release the stage; the last of the 8 warps to do so refills it
        // (the counter grows by 8 a use of the stage, and a use starts only
        // after the last one's refill)
        __syncwarp();
        uint32_t last = 0;
        if (lane == 0) {
            mbar_arrive(empty + s);
            if (it + kDkvStages < n_steps)
                last = atomicAdd(releases + s, 1u) % (4 * kWarpgroups) == 4 * kWarpgroups - 1;
        }
        if (__shfl_sync(0xffffffffu, last, 0)) {
            mbar_wait(empty + s, (it / kDkvStages) & 1);  // every warp's arrival is visible
            load_dkv_step<D>(p, smem, &tq, &tdo, full, it + kDkvStages, b, hk, group, n_live,
                             qt_begin, lane);
        }
        __syncwarp();
    }
    if (n_steps == 0)  // no q row sees these kv rows: dV is 0 too
        store_rows<D>(static_cast<__nv_bfloat16*>(p.dv) + int64_t(b) * p.dv_sb +
                          int64_t(hk) * p.dv_sh,
                      p.dv_sl, acc, kv_rows, p.Lk, cq, 1.f);
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dk) + int64_t(b) * p.dk_sb + int64_t(hk) * p.dk_sh,
                  p.dk_sl, acc, kv_rows, p.Lk, cq, p.scale);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, exact f32 arithmetic (the parity configurations)
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 16;  // rows a CTA owns: q rows (dQ) or kv rows (dK/dV), 4 per warp
constexpr int kF32Cols = 32;  // rows of the other side per step, one per lane

template <int D>
constexpr size_t f32_smem_bytes() {  // two tiles of owned rows, two lane-indexed tiles, lse, D
    return (2 * kF32Rows * D + 2 * kF32Cols * (D + 1) + 2 * kF32Cols) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const __grid_constant__ BwdParams p) {
    constexpr int RPW = kF32Rows / 4;  // rows per warp
    constexpr int DPL = D / 32;        // output columns per lane
    extern __shared__ float smem_f32[];
    float* sQ = smem_f32;              // [16][D]
    float* sdO = sQ + kF32Rows * D;    // [16][D]
    float* sK = sdO + kF32Rows * D;    // [32][D + 1]: lanes read different rows conflict-free
    float* sV = sK + kF32Cols * (D + 1);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (p.H / p.Hk);
    const int q0 = blockIdx.x * kF32Rows;
    const float* Q = static_cast<const float*>(p.q) + int64_t(b) * p.q_sb + int64_t(h) * p.q_sh;
    const float* dO =
        static_cast<const float*>(p.dout) + int64_t(b) * p.do_sb + int64_t(h) * p.do_sh;
    const float* O = static_cast<const float*>(p.o) + int64_t(b) * p.o_sb + int64_t(h) * p.o_sh;
    const float* K = static_cast<const float*>(p.k) + int64_t(b) * p.k_sb + int64_t(hk) * p.k_sh;
    const float* V = static_cast<const float*>(p.v) + int64_t(b) * p.v_sb + int64_t(hk) * p.v_sh;
    const int64_t row_base = (int64_t(b) * p.H + h) * p.Lq;

    for (int i = threadIdx.x; i < kF32Rows * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const bool in = q0 + r < p.Lq;
        sQ[i] = in ? Q[int64_t(q0 + r) * p.q_sl + c] : 0.f;
        sdO[i] = in ? dO[int64_t(q0 + r) * p.do_sl + c] : 0.f;
    }

    // D = rowsum(dO * O) and lse of the warp's rows; D is written out
    float dl[RPW], ll[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int row = q0 + warp * RPW + r;
        float acc = 0.f;
        if (row < p.Lq) {
#pragma unroll
            for (int i = 0; i < DPL; ++i)
                acc = fmaf(dO[int64_t(row) * p.do_sl + lane + 32 * i],
                           O[int64_t(row) * p.o_sl + lane + 32 * i], acc);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        dl[r] = acc;
        ll[r] = row < p.Lq ? p.lse[row_base + row] : 0.f;
        if (lane == 0 && row < p.Lq) p.delta[row_base + row] = acc;
    }

    float acc[RPW][DPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;

    int kt_begin, kt_end;
    live_tiles(p, q0, kF32Rows, kF32Cols, &kt_begin, &kt_end);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * kF32Cols;
        __syncthreads();  // every warp is done with the previous tile
        for (int i = threadIdx.x; i < kF32Cols * D; i += kThreads) {
            const int r = i / D, c = i % D;
            const bool in = k0 + r < p.Lk;
            sK[r * (D + 1) + c] = in ? K[int64_t(k0 + r) * p.k_sl + c] : 0.f;
            sV[r * (D + 1) + c] = in ? V[int64_t(k0 + r) * p.v_sl + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int tr = warp * RPW + r;
            float dot = 0.f, dpv = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) {
                dot = fmaf(sQ[tr * D + d], sK[lane * (D + 1) + d], dot);
                dpv = fmaf(sdO[tr * D + d], sV[lane * (D + 1) + d], dpv);
            }
            const float s_hat = capped(p, dot);
            const float sm = visible(p, q0 + tr, k0 + lane) ? s_hat : NEG_INF;
            const float ds = expf(sm - ll[r]) * (dpv - dl[r]) * cap_factor(p, s_hat);
            for (int j = 0; j < kF32Cols; ++j) {
                const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
                for (int i = 0; i < DPL; ++i)
                    acc[r][i] = fmaf(dsj, sK[j * (D + 1) + lane + 32 * i], acc[r][i]);
            }
        }
    }

    float* dQ = static_cast<float*>(p.dq) + int64_t(b) * p.dq_sb + int64_t(h) * p.dq_sh;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int row = q0 + warp * RPW + r;
        if (row >= p.Lq) continue;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
            dQ[int64_t(row) * p.dq_sl + lane + 32 * i] = acc[r][i] * p.scale;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const __grid_constant__ BwdParams p) {
    constexpr int RPW = kF32Rows / 4;  // kv rows per warp
    constexpr int DPL = D / 32;        // output columns per lane
    extern __shared__ float smem_f32[];
    float* sK = smem_f32;               // [16][D]
    float* sV = sK + kF32Rows * D;      // [16][D]
    float* sQ = sV + kF32Rows * D;      // [32][D + 1]
    float* sdO = sQ + kF32Cols * (D + 1);
    float* sL = sdO + kF32Cols * (D + 1);  // [32]
    float* sD = sL + kF32Cols;             // [32]

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int hk = blockIdx.y, b = blockIdx.z;
    const int group = p.H / p.Hk;
    const int k0 = blockIdx.x * kF32Rows;
    const float* K = static_cast<const float*>(p.k) + int64_t(b) * p.k_sb + int64_t(hk) * p.k_sh;
    const float* V = static_cast<const float*>(p.v) + int64_t(b) * p.v_sb + int64_t(hk) * p.v_sh;

    for (int i = threadIdx.x; i < kF32Rows * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const bool in = k0 + r < p.Lk;
        sK[i] = in ? K[int64_t(k0 + r) * p.k_sl + c] : 0.f;
        sV[i] = in ? V[int64_t(k0 + r) * p.v_sl + c] : 0.f;
    }

    float dk[RPW][DPL], dv[RPW][DPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int i = 0; i < DPL; ++i) dk[r][i] = dv[r][i] = 0.f;

    int qt_begin, qt_end;
    live_q_tiles(p, k0, kF32Rows, kF32Cols, &qt_begin, &qt_end);
    const int n_live = qt_end - qt_begin;
    for (int it = 0; it < group * n_live; ++it) {
        const int h = hk * group + it / n_live;
        const int q0 = (qt_begin + it % n_live) * kF32Cols;
        const float* Q = static_cast<const float*>(p.q) + int64_t(b) * p.q_sb + int64_t(h) * p.q_sh;
        const float* dO =
            static_cast<const float*>(p.dout) + int64_t(b) * p.do_sb + int64_t(h) * p.do_sh;
        const int64_t row_base = (int64_t(b) * p.H + h) * p.Lq;
        __syncthreads();  // every warp is done with the previous tiles
        for (int i = threadIdx.x; i < kF32Cols * D; i += kThreads) {
            const int r = i / D, c = i % D;
            const bool in = q0 + r < p.Lq;
            sQ[r * (D + 1) + c] = in ? Q[int64_t(q0 + r) * p.q_sl + c] : 0.f;
            sdO[r * (D + 1) + c] = in ? dO[int64_t(q0 + r) * p.do_sl + c] : 0.f;
        }
        if (threadIdx.x < kF32Cols) {
            const int row = q0 + threadIdx.x;
            sL[threadIdx.x] = row < p.Lq ? p.lse[row_base + row] : 0.f;
            sD[threadIdx.x] = row < p.Lq ? p.delta[row_base + row] : 0.f;
        }
        __syncthreads();
        const int q_row = q0 + lane;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int tr = warp * RPW + r;
            float dot = 0.f, dpv = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) {
                dot = fmaf(sK[tr * D + d], sQ[lane * (D + 1) + d], dot);
                dpv = fmaf(sV[tr * D + d], sdO[lane * (D + 1) + d], dpv);
            }
            const float s_hat = capped(p, dot);
            const bool in = q_row < p.Lq && visible(p, q_row, k0 + tr);
            const float pr = expf((in ? s_hat : NEG_INF) - sL[lane]);
            const float ds = pr * (dpv - sD[lane]) * cap_factor(p, s_hat);
            for (int j = 0; j < kF32Cols; ++j) {
                const float pj = __shfl_sync(0xffffffffu, pr, j);
                const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
                for (int i = 0; i < DPL; ++i) {
                    dv[r][i] = fmaf(pj, sdO[j * (D + 1) + lane + 32 * i], dv[r][i]);
                    dk[r][i] = fmaf(dsj, sQ[j * (D + 1) + lane + 32 * i], dk[r][i]);
                }
            }
        }
    }

    float* dK = static_cast<float*>(p.dk) + int64_t(b) * p.dk_sb + int64_t(hk) * p.dk_sh;
    float* dV = static_cast<float*>(p.dv) + int64_t(b) * p.dv_sb + int64_t(hk) * p.dv_sh;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int row = k0 + warp * RPW + r;
        if (row >= p.Lk) continue;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
            dK[int64_t(row) * p.dk_sl + lane + 32 * i] = dk[r][i] * p.scale;
            dV[int64_t(row) * p.dv_sl + lane + 32 * i] = dv[r][i];
        }
    }
}

// ---------------------------------------------------------------------------
// host entry points
// ---------------------------------------------------------------------------

// what make_bf16_tile_map needs of one [B, L, H, D] operand (B from the
// params), with the rows of its box
struct MapSpec {
    const void* base;
    int L, H, D;
    int64_t sb, sl, sh;
    int rows;
};

template <class Kernel>
static cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const BwdParams& p,
                          cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

// The bf16 kernels take four tensor maps by value (two of the owned side,
// two of the streamed side), encoded for this call's pointers. The runtime
// call comes first: in a thread where no CUDA context is current yet (an
// autograd worker thread, say), it makes the device's context current,
// which cuTensorMapEncodeTiled needs.
template <class Kernel>
static cudaError_t launch_bf16(Kernel kernel, dim3 grid, int threads, size_t smem,
                               const BwdParams& p, const MapSpec (&specs)[4],
                               cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    CUtensorMap maps[4];
    for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
        const MapSpec& m = specs[i];
        err = make_bf16_tile_map(&maps[i], m.base, p.B, m.L, m.H, m.D, m.sb, m.sl, m.sh, m.rows);
    }
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(p, maps[0], maps[1], maps[2], maps[3]);
    return cudaGetLastError();
}

template <int D>
static cudaError_t launch_dq(const BwdParams& p, int dtype, cudaStream_t st) {
    if (dtype == 0) {
        const MapSpec specs[4] = {  // Q, dO (resident); K, V (streamed)
            {p.q, p.Lq, p.H, D, p.q_sb, p.q_sl, p.q_sh, kRows},
            {p.dout, p.Lq, p.H, D, p.do_sb, p.do_sl, p.do_sh, kRows},
            {p.k, p.Lk, p.Hk, D, p.k_sb, p.k_sl, p.k_sh, DqSmem<D>::kBN},
            {p.v, p.Lk, p.Hk, D, p.v_sb, p.v_sl, p.v_sh, DqSmem<D>::kBN}};
        return launch_bf16(flash_bwd_dq_bf16_kernel<D>, dim3((p.Lq + kRows - 1) / kRows, p.H, p.B),
                           kBf16Threads, DqSmem<D>::kBytes, p, specs, st);
    }
    return launch(flash_bwd_dq_f32_kernel<D>, dim3((p.Lq + kF32Rows - 1) / kF32Rows, p.H, p.B),
                  f32_smem_bytes<D>(), p, st);
}

template <int D>
static cudaError_t launch_dkv(const BwdParams& p, int dtype, cudaStream_t st) {
    if (dtype == 0) {
        const MapSpec specs[4] = {  // K, V (resident); Q, dO (streamed)
            {p.k, p.Lk, p.Hk, D, p.k_sb, p.k_sl, p.k_sh, kRows},
            {p.v, p.Lk, p.Hk, D, p.v_sb, p.v_sl, p.v_sh, kRows},
            {p.q, p.Lq, p.H, D, p.q_sb, p.q_sl, p.q_sh, DkvSmem<D>::kBM},
            {p.dout, p.Lq, p.H, D, p.do_sb, p.do_sl, p.do_sh, DkvSmem<D>::kBM}};
        const dim3 grid = dim3(p.Hk, p.B, (p.Lk + kRows - 1) / kRows);
        if constexpr (DkvSmem<D>::kSweeps > 1)
            return launch_bf16(flash_bwd_dkv_sweeps_bf16_kernel<D>, grid, kBf16Threads,
                               DkvSmem<D>::kBytes, p, specs, st);
        else
            return launch_bf16(flash_bwd_dkv_bf16_kernel<D>, grid, kBf16Threads,
                               DkvSmem<D>::kBytes, p, specs, st);
    }
    return launch(flash_bwd_dkv_f32_kernel<D>,
                  dim3((p.Lk + kF32Rows - 1) / kF32Rows, p.Hk, p.B), f32_smem_bytes<D>(), p, st);
}

// ptrs: q, k, v, o, dout, lse, delta, dq, dk, dv. strides: (batch, position,
// head) element strides of q, k, v, o, dout, dq, dk, dv, in that order.
static BwdParams make_params(void* const* ptrs, const int64_t* st, int B, int Lq, int Lk, int H,
                             int Hk, int causal, int window, float softcap, float scale) {
    BwdParams p;
    p.q = ptrs[0];
    p.k = ptrs[1];
    p.v = ptrs[2];
    p.o = ptrs[3];
    p.dout = ptrs[4];
    p.lse = static_cast<const float*>(ptrs[5]);
    p.delta = static_cast<float*>(ptrs[6]);
    p.dq = ptrs[7];
    p.dk = ptrs[8];
    p.dv = ptrs[9];
    int64_t* fields[24] = {&p.q_sb,  &p.q_sl,  &p.q_sh,  &p.k_sb,  &p.k_sl,  &p.k_sh,
                           &p.v_sb,  &p.v_sl,  &p.v_sh,  &p.o_sb,  &p.o_sl,  &p.o_sh,
                           &p.do_sb, &p.do_sl, &p.do_sh, &p.dq_sb, &p.dq_sl, &p.dq_sh,
                           &p.dk_sb, &p.dk_sl, &p.dk_sh, &p.dv_sb, &p.dv_sl, &p.dv_sh};
    for (int i = 0; i < 24; ++i) *fields[i] = st[i];
    p.B = B;
    p.Lq = Lq;
    p.Lk = Lk;
    p.H = H;
    p.Hk = Hk;
    p.causal = causal;
    p.window = window;
    p.softcap = softcap;
    p.scale = scale;
    return p;
}

// dQ and D = rowsum(dO * O); launch before flash_attention_bwd_dkv on the
// same stream. dtype: 0 = bfloat16, 1 = float32. Returns a cudaError_t.
extern "C" int flash_attention_bwd_dq(void* const* ptrs, const int64_t* strides, int B, int Lq,
                                      int Lk, int H, int Hk, int D, int dtype, int causal,
                                      int window, float softcap, float scale, void* stream) {
    const BwdParams p = make_params(ptrs, strides, B, Lq, Lk, H, Hk, causal, window, softcap, scale);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
    if (D == 64) return int(launch_dq<64>(p, dtype, st));
    if (D == 128) return int(launch_dq<128>(p, dtype, st));
    if (D == 256) return int(launch_dq<256>(p, dtype, st));
    return int(cudaErrorInvalidValue);
}

// dK and dV at the native kv-head count, from the D that
// flash_attention_bwd_dq wrote.
extern "C" int flash_attention_bwd_dkv(void* const* ptrs, const int64_t* strides, int B, int Lq,
                                       int Lk, int H, int Hk, int D, int dtype, int causal,
                                       int window, float softcap, float scale, void* stream) {
    const BwdParams p = make_params(ptrs, strides, B, Lq, Lk, H, Hk, causal, window, softcap, scale);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
    if (D == 64) return int(launch_dkv<64>(p, dtype, st));
    if (D == 128) return int(launch_dkv<128>(p, dtype, st));
    if (D == 256) return int(launch_dkv<256>(p, dtype, st));
    return int(cudaErrorInvalidValue);
}
