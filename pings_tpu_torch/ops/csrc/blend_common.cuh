// Shared by blend_fwd.cu, blend_bwd.cu and blend_contrib.cu: the pixel
// layout of a block, the staging of a chunk of attribute rows into shared
// memory, the conservative test by which a warp skips a slot, the slot's
// gate, and (backward and contributions) the butterfly that sums 8 or 16
// columns over a warp.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace blend {

constexpr int NCH = 16;   // attribute columns per Gaussian
constexpr int NOUT = 8;   // blended output rows
constexpr int CH = 32;    // most slots staged per chunk: one per lane of a
                          // warp, which culls the chunk with one ballot
// floats between two staged rows in shared memory: 80 bytes keep every
// float4 of a row 16-byte aligned and spread the rows that the lanes of a
// quarter warp read at once (one row per lane) over all 32 banks
constexpr int RS = 20;

// the cull's margins: the conic must be positive definite with
// det >= DET_MIN * A * C, which bounds the float32 error of
// q = A dx^2 + C dy^2 + 2 B dx dy (and of det itself) by about 1e-3 of q;
// lengths are then widened by EXT_SCALE (2% in q) and the warp's rectangle
// by EXT_PIXELS. raster_blend has the same numbers.
constexpr float DET_MIN = 1e-3f;
constexpr float EXT_SCALE = 1.01f;
constexpr float EXT_PIXELS = 1.0f;
constexpr float EXT_LOG_SLACK = 0.01f;

// The pixels of a block. A warp owns an 8 x 4 block of pixels of the tile
// (warps side by side along x, then down), so that its rectangle of pixel
// centres is compact; `pix` is the pixel's row-major index in the tile, the
// position of its value in the (T, C, P) outputs. `t` is the tile's global
// index in the image (a sharded table adds its offset).
struct Pixels {
  float px, py;            // this lane's pixel centre, global
  float wx0, wx1, wy0, wy1;  // the warp's pixel centres span these
  int pix;
};

__device__ __forceinline__ Pixels block_pixels(int t, int ntx, int tile) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int wpr = tile >> 3;               // warps per row of blocks
  const int bx = (warp % wpr) * 8, by = (warp / wpr) * 4;
  const int lx = bx + (wl & 7), ly = by + (wl >> 3);
  const int tx0 = (t % ntx) * tile, ty0 = (t / ntx) * tile;
  Pixels p;
  p.px = (float)(tx0 + lx) + 0.5f;
  p.py = (float)(ty0 + ly) + 0.5f;
  p.wx0 = (float)(tx0 + bx) + 0.5f;
  p.wx1 = p.wx0 + 7.0f;
  p.wy0 = (float)(ty0 + by) + 0.5f;
  p.wy1 = p.wy0 + 3.0f;
  p.pix = ly * tile + lx;
  return p;
}

// True where no pixel centre in [wx0, wx1] x [wy0, wy1] can have alpha > 0
// for the slot (mu, conic A B C, opacity). alpha > 0 needs q < 9 and
// opa * exp(-q/2) >= 1/255, that is q <= qc = min(9, 2 ln(255 opa)). The
// test takes the least q over the warp's rectangle widened by EXT_PIXELS:
// q is convex with its minimum 0 at the centre, so off the rectangle the
// least value lies on an edge that faces the centre, x = cx or y = cy with
// (cx, cy) the rectangle's nearest point per axis, and on such an edge q is
// a parabola in the other offset. The slot is skipped where that value
// exceeds qc by EXT_SCALE^2. A conic that is not positive definite and well
// conditioned (a NaN in it included) is never skipped; a NaN in the centre,
// where alpha is 0 at every pixel, may go either way.
// raster_blend.warp_culled is the plain version.
__device__ __forceinline__ bool slot_outside(float mx, float my, float A,
                                             float B, float C, float opa,
                                             const Pixels& p) {
  const float ac = A * C;
  const float det = ac - B * B;
  if (!(A > 0.f && ac > 0.f && ac < CUDART_INF_F && det >= DET_MIN * ac))
    return false;
  const float qc = fminf(9.0f, 2.0f * logf(opa * 255.0f) + EXT_LOG_SLACK);
  if (qc < 0.f) return true;             // below 1/255 everywhere
  // the widened rectangle as offsets from the centre
  const float x0 = (p.wx0 - EXT_PIXELS) - mx, x1 = (p.wx1 + EXT_PIXELS) - mx;
  const float y0 = (p.wy0 - EXT_PIXELS) - my, y1 = (p.wy1 + EXT_PIXELS) - my;
  const float cx = fminf(fmaxf(0.f, x0), x1);
  const float cy = fminf(fmaxf(0.f, y0), y1);
  float q1 = CUDART_INF_F, q2 = CUDART_INF_F;
  if (cx != 0.f) {                       // the edge x = cx
    const float dy = fminf(fmaxf(-B * cx / C, y0), y1);
    q1 = A * cx * cx + C * dy * dy + 2.0f * B * cx * dy;
  }
  if (cy != 0.f) {                       // the edge y = cy
    const float dx = fminf(fmaxf(-B * cy / A, x0), x1);
    q2 = A * dx * dx + C * cy * cy + 2.0f * B * dx * cy;
  }
  if (cx == 0.f && cy == 0.f) return false;   // the centre is inside
  const float lim = qc * (EXT_SCALE * EXT_SCALE);
  return q1 > lim && q2 > lim;
}

// One slot at one pixel: alpha after every gate, the plane depth's inverse
// s (surfel mode; z = 1/s is left to the caller, who needs it only where
// alpha > 0) and e = exp(-q/2), operation for operation as
// raster_blend.slot_terms (and so as the other kernel: forward and
// backward must agree on every alpha). alpha < 0.999 tells that the clamp
// did not act. `row` is a staged attribute row in shared memory.
struct Gate { float alpha, s, e; };

template <bool SURFEL>
__device__ __forceinline__ Gate slot_gate(const float* row, float px,
                                          float py) {
  // constants rounded from double as PyTorch rounds a Python float
  const float alpha_floor = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  const float s_min = (float)1e-6;
  const float4* r = (const float4*)row;
  float mx, my, A, B, C, opa;
  if (SURFEL) {
    const float4 r1 = r[1], r2 = r[2];
    mx = r1.z; my = r1.w; A = r2.x; B = r2.y; C = r2.z; opa = r2.w;
  } else {
    const float4 r2 = r[2], r3 = r[3];
    mx = r2.x; my = r2.y; A = r2.z; B = r2.w; C = r3.x; opa = r3.y;
  }
  const float dx = px - mx;
  const float dy = py - my;
  const float q = A * dx * dx + C * dy * dy + 2.0f * B * dx * dy;
  Gate g;
  g.e = expf(-0.5f * q);
  float araw = opa * g.e;
  if (!(q < 9.0f && araw >= alpha_floor)) araw = 0.f;
  g.alpha = fminf(araw, alpha_max);
  g.s = 1.f;
  if (SURFEL) {
    const float4 r3 = r[3];
    g.s = r3.x * px + r3.y * py + r3.z;
    if (!(g.s > s_min && g.s < 100.0f)) g.alpha = 0.f;
  }
  return g;
}

// Stage the rows of slots k0 .. k0 + ch - 1 of a tile into `rows`: thread
// tid < 4 ch copies 16 bytes, quarter tid & 3 of slot tid >> 2, straight
// from attr16 (N, 16) through the tile's id list (no packed (T, Kmax, 16)
// table exists). `id` holds this thread's id for the chunk, read from the
// table while the previous chunk was blended, and leaves with the next
// chunk's; ids are clamped to [0, n - 1]. Returns the clamped id. The
// caller puts a barrier before (the previous chunk is consumed) and after.
__device__ __forceinline__ int stage_chunk(float* rows,
                                           const float* __restrict__ attr16,
                                           const int* __restrict__ tbl,
                                           int k0, int ch, int cnt, int n,
                                           int& id) {
  const int slot = threadIdx.x >> 2, quar = threadIdx.x & 3;
  int g = 0;
  if (threadIdx.x < ch * 4) {
    if (k0 + slot < cnt) {
      g = max(0, min(id, n - 1));
      *(float4*)(rows + slot * RS + quar * 4) =
          *(const float4*)(attr16 + (size_t)g * NCH + quar * 4);
    }
    if (k0 + ch + slot < cnt) id = tbl[k0 + ch + slot];
  }
  return g;
}

// The slots of a staged chunk that the warp has to walk, one bit each:
// lane j tests slot j against the warp's rectangle, one ballot collects.
template <bool SURFEL>
__device__ __forceinline__ unsigned chunk_live(const float* rows, int nrows,
                                               const Pixels& p) {
  const int wl = threadIdx.x & 31;
  bool keep = false;
  if (wl < nrows) {
    const float4* r = (const float4*)(rows + wl * RS);
    const float4 r2 = r[2];
    if (SURFEL) {
      const float4 r1 = r[1];
      keep = !slot_outside(r1.z, r1.w, r2.x, r2.y, r2.z, r2.w, p);
    } else {
      const float4 r3 = r[3];
      keep = !slot_outside(r2.x, r2.y, r2.z, r2.w, r3.x, r3.y, p);
    }
  }
  return __ballot_sync(0xffffffffu, keep);
}

// Sum the N columns v[0..N-1] (N = 8 or 16) over the 32 lanes of a warp;
// lane l returns column l & (N - 1). Step `bit` pairs lane l with l ^ bit:
// the lane whose bit is clear keeps the lower half of its columns and sends
// the upper half, its partner the reverse, and each adds what it receives;
// after bits N/2 ... 1 one column is left per lane, and the exchanges with
// l ^ N ... l ^ 16 complete it. N - 1 + log2(32 / N) shuffles where a tree
// per column takes 5 N. Unrolled by templates: the columns stay in
// registers only where every index is a constant.
template <int HALF, int N>
__device__ __forceinline__ void transpose_steps(float (&v)[N], int wl) {
  if constexpr (HALF > 0) {
    const bool up = (wl & HALF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = up ? v[i] : v[i + HALF];
      const float keep = up ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
    }
    transpose_steps<HALF / 2>(v, wl);
  }
}

template <int N>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[N], int wl) {
  static_assert(N == 8 || N == 16, "8 or 16 columns");
  transpose_steps<N / 2>(v, wl);
  float x = v[0];
#pragma unroll
  for (int bit = N; bit < 32; bit <<= 1)
    x = x + __shfl_xor_sync(0xffffffffu, x, bit);
  return x;
}

}  // namespace blend
