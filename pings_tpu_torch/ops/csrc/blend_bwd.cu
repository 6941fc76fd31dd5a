// Backward of the alpha blend of depth-sorted Gaussians per image tile.
//
// Replaces the Pallas TPU kernels of pings_tpu/ops/raster_pallas.py:
//   SURFEL = true   _bwd_kernel_surfel (:533, with _geom_grads :446)
//   SURFEL = false  _bwd_kernel_3dgs   (:470)
// both launched by _blend_bwd_call (:660), and the per-Gaussian sum
// _unpack_grads (:171) that follows them. It computes what they compute,
// in float32: one front-to-back pass that carries the transmittance T and
// the running sum sigma = sum_j w_j phi_j and uses the suffix identity
//   dL/da_i = phi_i T_i - (rho - sigma_i + g_T T_final) / max(1 - a_i, 1e-3)
// with phi_i = sum_c g_c attr_c (3dgs: c < 8; surfel: c < 6, plus
// g_6 z + g_7 for the plane-depth and alpha rows), rho = sum_c g_c O_c and
// T_final from the saved forward outputs. da is zero where alpha is zero;
// dq and dexp are zero where alpha was clamped at 0.999. Column gradients:
//   blended columns c: sum_p w g_c          opacity: sum_p exp(-q/2) da
//   mu_x: sum_p dq (-2A dx - 2B dy)         mu_y: sum_p dq (-2C dy - 2B dx)
//   A: sum_p dq dx^2   B: sum_p 2 dq dx dy  C: sum_p dq dy^2
//   surfel (ndx, ndy, nd0): sum_p ds (px, py, 1), ds = -z^2 g_6 w.
// Slots at or past counts[t] and, in surfel mode, pixels whose plane depth
// fails its gate have alpha = 0. The early stop is the forward kernel's:
// at the start of every superblock of `sb` slots the block stops once no
// pixel of the tile has T > 1e-4, so forward and backward stop at the same
// slot; the slots it skips get no gradient. `tile0` offsets the pixels of
// block t to tile t + tile0, as in the forward kernel.
//
// What bounds it. As the forward (see blend_fwd.cu for the rates): fp32
// issue, not bytes and not matrix work. A slot-pixel with alpha > 0 costs
// the gate, about 55 more instructions and one division; a slot with a
// hit needs its 15 (3dgs: 14) column terms summed over the tile's pixels;
// the bytes are the referenced rows, the table, 11 floats per pixel of
// cotangents and saved maps and 64 bytes of atomics per slot with a hit.
// Tensor cores and wgmma are not used: everything up to alpha, T and z
// must round as in the forward kernel and the plain version (both kernels
// must agree on which slot-pixels are active and where a block stops), and
// a TF32 or bf16 product would flip the gates q < 9, alpha >= 1/255 and
// s > 1e-6. That part, with phi and sigma (whose difference from rho
// cancels), keeps separate multiplies and adds (-fmad=false) in the order
// of raster_blend.blend_bwd_ref; the gradient terms after it are held by a
// tolerance and use explicit fused multiply-adds.
//
// What the design does about it (one block per tile, one thread per pixel,
// 32 slots staged at a time as in the forward kernel).
// - Cull before the gate, as the forward kernel: a warp owns an 8 x 4
//   block of pixels, lane j tests whether slot j can reach the warp's
//   rectangle, one ballot per chunk gives the slots the warp walks. A
//   walked slot without a hit in the warp is dropped after the gate.
// - The 16 column terms of a warp's 32 pixels are summed by a transposing
//   butterfly: four steps in which a lane keeps half of its values and adds
//   its partner's (8 + 4 + 2 + 1 shuffles) and one last exchange, 16
//   shuffles and 30 selects where a tree per column takes 75 shuffles. This
//   is the largest gain (1.7x on the whole kernel). Lane c then holds
//   column c's sum, and lanes 0-15 store the warp's row as one 64-byte
//   write.
// - The warps' rows of a chunk are summed in warp order (deterministic
//   within a tile) while the next chunk is blended (partial rows, ids and
//   hit masks are double buffered), and added into d_attr16 (N, 16) with
//   four float4 atomics per slot with a hit: no (T, Kmax, 16) table goes
//   through device memory and no second kernel reduces it. The order in
//   which tiles that share a Gaussian add to its row varies, so two runs
//   differ by float32 rounding of that last sum. (float4 atomics measured
//   the same as 15 scalar ones: the atomics are not what the kernel waits
//   for.)
// - The gates of two slots are worked out together before the slots are
//   taken in order: they do not depend on T, so their chains overlap.
// - One division per hit: both quotients of the identity share a divisor.
// - Staging as the forward kernel. cp.async staging measured no better;
//   blocks that draw tiles from a counter measured worse; taking the tiles
//   longest first gained 6% where a launch needs several waves (replica)
//   and lost at kitti, and was left out as not worth a second launch.

#include "blend_common.cuh"

namespace {

using namespace blend;

// slots whose gates are worked out together
constexpr int BATCH = 2;

// One tile, by the whole block. `smem`: rows [ch][RS], partial rows
// [2][NW][ch][NCH], ids [2][ch], hit masks [2][NW].
template <bool SURFEL>
__device__ __forceinline__ void blend_bwd_tile(
    int t, float* smem, const float* __restrict__ attr16,
    const int* __restrict__ gauss_tbl, const int* __restrict__ counts,
    const float* __restrict__ g_out, const float* __restrict__ g_trans,
    const float* __restrict__ rho_in, const float* __restrict__ trans_final,
    float* __restrict__ d_attr16, int n, int kmax, int ntx, int tile, int sb,
    int ch, int tile0) {
  const int P = blockDim.x;
  const int NW = P >> 5;
  float* rows = smem;
  float* part = rows + ch * RS;
  int* gid = (int*)(part + 2 * NW * ch * NCH);
  unsigned* hitm = (unsigned*)(gid + 2 * ch);   // slots of the chunk that
                                                // the warp hit, one bit each
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const Pixels pp = block_pixels(t + tile0, ntx, tile);
  const float px = pp.px, py = pp.py;
  // constants rounded from double as PyTorch rounds a Python float
  const float alpha_max = (float)0.999;
  const float trans_eps = (float)1e-4;
  const float om_min = (float)1e-3;

  constexpr int MX = SURFEL ? 6 : 8;
  constexpr int MY = MX + 1, CA = MX + 2, CB = MX + 3, CC = MX + 4;
  constexpr int OP = MX + 5;
  constexpr int NBLEND = SURFEL ? 6 : NOUT;   // columns blended as they are

  float g[NOUT];
  const size_t gbase = (size_t)t * NOUT * P + pp.pix;
#pragma unroll
  for (int c = 0; c < NOUT; ++c) g[c] = g_out[gbase + (size_t)c * P];
  const float rho = rho_in[(size_t)t * P + pp.pix];
  const float gtf = g_trans[(size_t)t * P + pp.pix]
                    * trans_final[(size_t)t * P + pp.pix];

  const int cnt = min(counts[t], kmax);
  const int* tbl = gauss_tbl + (size_t)t * kmax;
  int id = (tid < ch * 4 && (tid >> 2) < cnt) ? tbl[tid >> 2] : 0;
  float T = 1.f;
  float sigma = 0.f;
  int pend_rows = 0, pend_buf = 0;   // a chunk whose partial rows wait

  // the block's sum of a chunk's partial rows over its warps, in warp
  // order, and one float4 atomic per quarter row of a slot with a hit
  auto flush = [&](int b, int nr) {
    for (int i = tid; i < nr * 4; i += P) {
      const int j = i >> 2, c4 = i & 3;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int wp = 0; wp < NW; ++wp) {
        if ((hitm[b * NW + wp] >> j) & 1u) {
          const float4 p = *(const float4*)(
              part + ((size_t)(b * NW + wp) * ch + j) * NCH + c4 * 4);
          a.x = a.x + p.x; a.y = a.y + p.y;
          a.z = a.z + p.z; a.w = a.w + p.w;
        }
      }
      if (a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f) {
        float* dst = d_attr16 + (size_t)gid[b * ch + j] * NCH + c4 * 4;
        atomicAdd((float4*)dst, a);
      }
    }
  };

  for (int k0 = 0, c = 0; k0 < cnt; k0 += ch, ++c) {
    const int b = c & 1;
    // barrier: the previous chunk's rows are consumed before the reload,
    // and its partial rows are stored
    if (k0 % sb == 0) {
      if (!__syncthreads_or(T > trans_eps)) break;
    } else {
      __syncthreads();
    }
    // the ids go where the previous chunk but one had its own: that
    // chunk's flush ended before the barrier above
    const int gi = stage_chunk(rows, attr16, tbl, k0, ch, cnt, n, id);
    if (tid < ch * 4 && (tid & 3) == 0) gid[b * ch + (tid >> 2)] = gi;
    __syncthreads();
    // the previous chunk's partial rows, while the warps blend this one
    if (pend_rows) flush(pend_buf, pend_rows);
    const int nrows = min(ch, cnt - k0);
    unsigned live = chunk_live<SURFEL>(rows, nrows, pp);
    unsigned hits = 0u;
    float* wpart = part + (size_t)(b * NW + warp) * ch * NCH;

    while (live) {
      // the gates of BATCH slots together (they do not depend on T,
      // so their long chains overlap), then the slots in order
      int js[BATCH];
      Gate gt[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        js[i] = __ffs(live) - 1;          // -1 once the list is empty
        live &= live - 1;
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        gt[i] = slot_gate<SURFEL>(rows + max(js[i], 0) * RS, px, py);
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int j = js[i];
        if (j < 0) break;
        const float alpha = gt[i].alpha, e = gt[i].e;
        const bool active = alpha > 0.f;
        if (__ballot_sync(0xffffffffu, active) == 0u) continue;

        float v[NCH];
#pragma unroll
        for (int c2 = 0; c2 < NCH; ++c2) v[c2] = 0.f;
        if (active) {
          float s[NCH];
          const float4* r = (const float4*)(rows + j * RS);
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2) {
            const float4 v4 = r[c2];
            s[4 * c2] = v4.x; s[4 * c2 + 1] = v4.y;
            s[4 * c2 + 2] = v4.z; s[4 * c2 + 3] = v4.w;
          }
          const float dx = px - s[MX];
          const float dy = py - s[MY];
          const float z = SURFEL ? 1.0f / gt[i].s : 0.f;
          const bool unclamped = alpha < alpha_max;
          const float one_m = 1.0f - alpha;
          const float one_m_safe = fmaxf(one_m, om_min);
          const float w = alpha * T;
          float phi = s[0] * g[0];
#pragma unroll
          for (int c2 = 1; c2 < NBLEND; ++c2) phi = phi + s[c2] * g[c2];
          if (SURFEL) phi = phi + g[6] * z + g[7];
          // phi and sigma round as the plain version's: rho - sigma_i
          // cancels, and a last-bit difference would come back magnified
          const float sigma_i = sigma + w * phi;
          const float da = __fmaf_rn(
              phi, T, -(((rho - sigma_i) + gtf) / one_m_safe));
          const float dq = unclamped ? -0.5f * alpha * da : 0.f;
#pragma unroll
          for (int c2 = 0; c2 < NBLEND; ++c2) v[c2] = w * g[c2];
          const float m2dq = -2.0f * dq;
          v[MX] = m2dq * __fmaf_rn(s[CA], dx, s[CB] * dy);
          v[MY] = m2dq * __fmaf_rn(s[CC], dy, s[CB] * dx);
          const float dqdx = dq * dx;
          v[CA] = dqdx * dx;
          v[CB] = 2.0f * dqdx * dy;
          v[CC] = dq * dy * dy;
          v[OP] = unclamped ? e * da : 0.f;
          if (SURFEL) {
            const float ds = -(z * z) * g[6] * w;
            v[12] = ds * px;
            v[13] = ds * py;
            v[14] = ds;
          }
          sigma = sigma_i;
          T = T * one_m;      // as the forward kernel rounds it
        }
        const float mine = warp_transpose_sum(v, wl);
        if (wl < NCH) wpart[j * NCH + wl] = mine;
        hits |= 1u << j;
      }
    }
    if (wl == 0) hitm[b * NW + warp] = hits;
    pend_rows = nrows;
    pend_buf = b;
  }

  __syncthreads();
  if (pend_rows) flush(pend_buf, pend_rows);
}

template <bool SURFEL, int MAXT>
__global__ void __launch_bounds__(MAXT)
blend_bwd_kernel(const float* __restrict__ attr16,
                 const int* __restrict__ gauss_tbl,
                 const int* __restrict__ counts,
                 const float* __restrict__ g_out,
                 const float* __restrict__ g_trans,
                 const float* __restrict__ rho_in,
                 const float* __restrict__ trans_final,
                 float* __restrict__ d_attr16, int n, int kmax, int ntx,
                 int tile, int sb, int ch, int tile0) {
  extern __shared__ __align__(16) float smem[];
  blend_bwd_tile<SURFEL>(blockIdx.x, smem, attr16, gauss_tbl, counts, g_out,
                         g_trans, rho_in, trans_final, d_attr16, n, kmax, ntx,
                         tile, sb, ch, tile0);
}

template <bool SURFEL, int MAXT>
int launch_as(const void* attr16, const void* gauss_tbl, const void* counts,
              const void* g_out, const void* g_trans, const void* rho,
              const void* trans_final, void* d_attr16, int n, int T,
              int kmax, int ntx, int tile, int sb, int ch, int tile0,
              size_t bytes, cudaStream_t stream) {
  auto kernel = blend_bwd_kernel<SURFEL, MAXT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<T, tile * tile, bytes, stream>>>(
      (const float*)attr16, (const int*)gauss_tbl, (const int*)counts,
      (const float*)g_out, (const float*)g_trans, (const float*)rho,
      (const float*)trans_final, (float*)d_attr16, n, kmax, ntx, tile, sb,
      ch, tile0);
  return (int)cudaGetLastError();
}

template <bool SURFEL>
int launch(const void* attr16, const void* gauss_tbl, const void* counts,
           const void* g_out, const void* g_trans, const void* rho,
           const void* trans_final, void* d_attr16, int n, int T, int kmax,
           int ntx, int tile, int sb, int tile0, void* stream) {
  const int P = tile * tile;
  const int NW = P / 32;
  // a chunk: at most one slot per lane, one superblock, and one 16-byte
  // copy per thread (sb is a power of two >= 8, P / 4 >= 16)
  const int ch = min(min(CH, sb), P / 4);
  const size_t bytes = (size_t)ch * RS * sizeof(float)
                       + (size_t)2 * NW * ch * NCH * sizeof(float)
                       + (size_t)2 * ch * sizeof(int)
                       + (size_t)2 * NW * sizeof(unsigned);
  if (T <= 0) return 0;
  if (P <= 256)
    return launch_as<SURFEL, 256>(attr16, gauss_tbl, counts, g_out, g_trans,
                                  rho, trans_final, d_attr16, n, T,
                                  kmax, ntx, tile, sb, ch, tile0, bytes,
                                  (cudaStream_t)stream);
  return launch_as<SURFEL, 1024>(attr16, gauss_tbl, counts, g_out, g_trans,
                                 rho, trans_final, d_attr16, n, T,
                                 kmax, ntx, tile, sb, ch, tile0, bytes,
                                 (cudaStream_t)stream);
}

}  // namespace

extern "C" int blend_bwd_surfel(const void* attr16, const void* gauss_tbl,
                                const void* counts, const void* g_out,
                                const void* g_trans, const void* rho,
                                const void* trans_final, void* d_attr16,
                                int n, int T, int kmax, int ntx, int tile,
                                int sb, int tile0, void* stream) {
  return launch<true>(attr16, gauss_tbl, counts, g_out, g_trans, rho,
                      trans_final, d_attr16, n, T, kmax, ntx, tile, sb,
                      tile0, stream);
}

extern "C" int blend_bwd_3dgs(const void* attr16, const void* gauss_tbl,
                              const void* counts, const void* g_out,
                              const void* g_trans, const void* rho,
                              const void* trans_final, void* d_attr16,
                              int n, int T, int kmax, int ntx, int tile,
                              int sb, int tile0, void* stream) {
  return launch<false>(attr16, gauss_tbl, counts, g_out, g_trans, rho,
                       trans_final, d_attr16, n, T, kmax, ntx, tile, sb,
                       tile0, stream);
}
