// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the causal / sliding-window band, the score transform, base-2 exponent,
// and bf16 packing. The Hopper pieces (TMA, mbarriers, wgmma) are in
// hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

constexpr float kLog2e = 1.4426950408889634f;

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
// arithmetic
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<uint32_t*>(&v);
}
