// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the causal / sliding-window band, mma.sync and ldmatrix fragment access,
// and cp.async tile copies into shared memory (the backward kernels). The
// Hopper pieces (TMA, mbarriers, wgmma) are in hopper.cuh.
//
// Fragment layouts of mma.sync m16n8k16 (bf16 in, f32 accumulate), for a
// lane l with r0 = l / 4 and cq = (l % 4) * 2:
//   A (16 x 16, row-major): a[0] = A[r0][cq..cq+1], a[1] = A[r0+8][cq..],
//     a[2] = A[r0][cq+8..], a[3] = A[r0+8][cq+8..];
//   B (16 x 8, "col"): b0 = B[cq..cq+1][r0], b1 = B[cq+8..cq+9][r0];
//   C (16 x 8): c[0..1] = C[r0][cq..cq+1], c[2..3] = C[r0+8][cq..cq+1].
// So the accumulators of two neighbouring 8-column tiles 2j, 2j+1 are
// exactly the A fragment of k-step j of a following product: a score tile
// feeds the next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

constexpr int kPad = 8;  // row padding (elements): conflict-free fragment loads

// ---------------------------------------------------------------------------
// the band: one definition for every kernel. P is any parameter struct with
// Lk, causal, window (0 = none), softcap (0 = off) and scale.
// ---------------------------------------------------------------------------

// Columns past Lk do not exist; rows and columns both count from 0.
template <class P>
__device__ __forceinline__ bool visible(const P& p, int row, int col) {
    if (col >= p.Lk) return false;
    if (p.causal && row < col) return false;
    if (p.window > 0 && row - col >= p.window) return false;
    return true;
}

// raw product -> scaled, soft-capped score (before the mask)
template <class P>
__device__ __forceinline__ float capped(const P& p, float acc) {
    float s = acc * p.scale;
    if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
    return s;
}

// scale, softcap (before the mask), mask; ``inside``: the whole tile is in
// the band, so no element needs the mask
template <class P>
__device__ __forceinline__ float score(const P& p, float acc, int row, int col, bool inside) {
    const float s = capped(p, acc);
    return inside || visible(p, row, col) ? s : NEG_INF;
}

// kv tiles [begin, end) that intersect the band of q rows [q0, q0 + bm).
template <class P>
__device__ __forceinline__ void live_tiles(const P& p, int q0, int bm, int bn, int* begin,
                                           int* end) {
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
// tensor-core fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<uint32_t*>(&v);
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

// ---------------------------------------------------------------------------
// cp.async tile copies
// ---------------------------------------------------------------------------

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

// start copying a ROWS x D bf16 tile of a [.., L, .., D] tensor into shared
// memory with row pitch D + kPad (zeros past L), spread over THREADS
// threads; completes at the matching cp_async_wait
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int64_t row_stride, int row0, int L) {
    constexpr int LD = D + kPad;
    constexpr int CH = D / 8;  // 16-byte chunks per row
    static_assert(ROWS * CH % THREADS == 0, "tile does not split evenly over the threads");
#pragma unroll
    for (int it = 0; it < ROWS * CH / THREADS; ++it) {
        const int i = threadIdx.x + it * THREADS;
        const int r = i / CH, c = i % CH;
        const bool in = row0 + r < L;
        cp_async16(dst + r * LD + c * 8, src + (in ? int64_t(row0 + r) * row_stride + c * 8 : 0),
                   in);
    }
}

// A fragment (16 x 16) of a row-major bf16 tile in shared memory (row pitch
// LD), rows m0.., columns k0..
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int LD,
                                           int m0, int k0) {
    const int lane = threadIdx.x % 32, mtx = lane / 8;
    ldmatrix_x4(a, tile + (m0 + (mtx & 1) * 8 + lane % 8) * LD + k0 + (mtx >> 1) * 8);
}

// B fragments of two 8-column tiles n0.., n0+8.. (k-step k0) for B = X^T,
// X a row-major [n][k] tile in shared memory: (b[0], b[1]) for n0,
// (b[2], b[3]) for n0 + 8
__device__ __forceinline__ void ldmatrix_bt(uint32_t (&b)[4], const __nv_bfloat16* X, int LD,
                                            int n0, int k0) {
    const int lane = threadIdx.x % 32, mtx = lane / 8;
    ldmatrix_x4(b, X + (n0 + (mtx >> 1) * 8 + lane % 8) * LD + k0 + (mtx & 1) * 8);
}

// B fragments of two 8-column tiles n0.., n0+8.. (k-step k0) for B = X, a
// row-major [k][n] tile in shared memory: (b[0], b[1]) for n0, (b[2], b[3])
// for n0 + 8
__device__ __forceinline__ void ldmatrix_b(uint32_t (&b)[4], const __nv_bfloat16* X, int LD,
                                           int k0, int n0) {
    const int lane = threadIdx.x % 32, mtx = lane / 8;
    ldmatrix_x4_trans(b, X + (k0 + (mtx & 1) * 8 + lane % 8) * LD + n0 + (mtx >> 1) * 8);
}
