// Backward of the alpha blend of depth-sorted Gaussians per image tile.
//
// Replaces the Pallas TPU kernels of pings_tpu/ops/raster_pallas.py:
//   SURFEL = true   _bwd_kernel_surfel (:533, with _geom_grads :446)
//   SURFEL = false  _bwd_kernel_3dgs   (:470)
// both launched by _blend_bwd_call (:660), and the per-Gaussian sum
// _unpack_grads (:171) that follows them. It computes what they compute,
// in float32: one front-to-back pass that carries the transmittance T and
// the running sum sigma = sum_j w_j phi_j and uses the suffix identity
//   dL/da_i = phi_i T_i - (rho - sigma_i) / max(1 - a_i, 1e-3)
//             - g_T T_final / max(1 - a_i, 1e-3)
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
// slot; the slots it skips get no gradient.
//
// Design. One block per tile, one thread per pixel, `ch` slots staged at a
// time into shared memory through gauss_tbl as the forward kernel does.
// Each thread forms its pixel's 16 column terms for a slot; a warp that
// holds no pixel with alpha > 0 skips the slot, otherwise it reduces the
// terms with shuffles and lane 0 stores the warp's partial row. After the
// chunk the block sums the warps' partials in a fixed order and adds each
// non-zero row into d_attr16 (N, 16) with atomicAdd: no (T, Kmax, 16)
// table goes through device memory and no second kernel reduces it. The
// sum within a tile is deterministic; the order in which the tiles that
// share a Gaussian add to its row is not, so two runs differ by float32
// rounding of that last sum.
//
// Operations are written in the order of raster_blend.blend_bwd_ref and
// the library is built with -fmad=false, so the per-pixel terms round as
// the plain version's do; only the order of the sums over pixels differs.
//
// Bound on an H100 SXM (see blend_fwd.cu for the rates: 33.5 T/s plain
// fp32 instructions without FMA contraction, 1/8 of that for expf, 1/s and
// the divisions, 3.35 TB/s). Every evaluated slot-pixel costs the forward
// gate (about 24 instructions in surfel mode, 16 in 3dgs, and expf, 1/s);
// where alpha > 0 it adds 62 (surfel) or 57 (3dgs) instructions and two
// divisions for da and the column terms; reducing a slot with a hit over
// its 256 pixels needs 256 adds per column (15 or 14 columns). Bytes: the
// referenced attr16 rows, the table, the four cotangent and saved maps
// (11 floats per pixel), and 64 bytes of atomics per slot with a hit.
// At the kitti checkpoint's 640x240 (T = 600, Kmax = 128) the first view's
// table needs 0.47 G instructions (14 us) against 8.4 MB (2.5 us): bound
// by operations, as the forward. chip_smoke.py counts both from each
// run's data. What the design does about it: it skips all gradient
// arithmetic and the reduction where a whole warp has alpha = 0, keeps
// every operand in registers or shared memory, and reads each slot row
// once per tile. What it does not do yet: reduce 16 columns with fewer
// shuffles (a transposing butterfly needs 31 instead of 80), or overlap
// the next chunk's gather with this chunk's arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int NCH = 16;   // attribute columns per Gaussian
constexpr int NOUT = 8;   // blended output rows
constexpr int CH = 32;    // most slots staged per chunk

template <bool SURFEL>
__global__ void blend_bwd_kernel(const float* __restrict__ attr16,
                                 const int* __restrict__ gauss_tbl,
                                 const int* __restrict__ counts,
                                 const float* __restrict__ g_out,
                                 const float* __restrict__ g_trans,
                                 const float* __restrict__ rho_in,
                                 const float* __restrict__ trans_final,
                                 float* __restrict__ d_attr16,
                                 int n, int kmax, int ntx, int tile, int sb,
                                 int ch) {
  extern __shared__ float smem[];
  const int P = blockDim.x;
  const int NW = P / 32;
  float* rows = smem;                          // ch * NCH
  float* part = rows + ch * NCH;               // ch * NW * NCH
  int* gid = (int*)(part + ch * NW * NCH);     // ch
  int* hit = gid + ch;                         // ch * NW: warp had a hit

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const float px = (float)((t % ntx) * tile + lane % tile) + 0.5f;
  const float py = (float)((t / ntx) * tile + lane / tile) + 0.5f;
  // constants rounded from double as PyTorch rounds a Python float
  const float alpha_floor = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  const float trans_eps = (float)1e-4;
  const float s_min = (float)1e-6;
  const float om_min = (float)1e-3;

  constexpr int MX = SURFEL ? 6 : 8;
  constexpr int MY = MX + 1, CA = MX + 2, CB = MX + 3, CC = MX + 4;
  constexpr int OP = MX + 5;
  constexpr int NBLEND = SURFEL ? 6 : NOUT;   // columns blended as they are
  constexpr int NCOL = SURFEL ? 15 : 14;      // columns with a gradient

  float g[NOUT];
  const size_t gbase = (size_t)t * NOUT * P + lane;
#pragma unroll
  for (int c = 0; c < NOUT; ++c) g[c] = g_out[gbase + (size_t)c * P];
  const float gt = g_trans[(size_t)t * P + lane];
  const float rho = rho_in[(size_t)t * P + lane];
  const float tf = trans_final[(size_t)t * P + lane];

  const int cnt = min(counts[t], kmax);
  const int* tbl = gauss_tbl + (size_t)t * kmax;
  float T = 1.f;
  float sigma = 0.f;

  for (int k0 = 0; k0 < cnt; k0 += ch) {
    // barrier: the previous chunk's rows and partials are consumed
    if (k0 % sb == 0) {
      if (!__syncthreads_or(T > trans_eps)) break;
    } else {
      __syncthreads();
    }
    const int nrows = min(ch, cnt - k0);
    for (int i = lane; i < nrows * NCH; i += P) {
      const int gi = max(0, min(tbl[k0 + i / NCH], n - 1));
      rows[i] = attr16[(size_t)gi * NCH + i % NCH];
      if (i % NCH == 0) gid[i / NCH] = gi;
    }
    __syncthreads();

    for (int j = 0; j < nrows; ++j) {
      const float* s = rows + j * NCH;
      const float dx = px - s[MX];
      const float dy = py - s[MY];
      const float q = s[CA] * dx * dx + s[CC] * dy * dy
                      + 2.0f * s[CB] * dx * dy;
      const float e = expf(-0.5f * q);
      float araw = s[OP] * e;
      if (!(q < 9.0f && araw >= alpha_floor)) araw = 0.f;
      float alpha = fminf(araw, alpha_max);
      const bool unclamped = araw < alpha_max;
      float z = 0.f;
      if (SURFEL) {
        const float sd = s[12] * px + s[13] * py + s[14];
        const bool z_ok = sd > s_min && sd < 100.0f;
        z = z_ok ? 1.0f / sd : 0.f;
        if (!z_ok) alpha = 0.f;
      }
      const bool active = alpha > 0.f;
      const unsigned any = __ballot_sync(0xffffffffu, active);
      if (any == 0u) {
        if (wl == 0) hit[j * NW + warp] = 0;
        continue;
      }
      float v[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) v[c] = 0.f;
      if (active) {
        const float one_m = 1.0f - alpha;
        const float one_m_safe = fmaxf(one_m, om_min);
        const float w = alpha * T;
        float phi = s[0] * g[0];
#pragma unroll
        for (int c = 1; c < NBLEND; ++c) phi = phi + s[c] * g[c];
        if (SURFEL) phi = phi + g[6] * z + g[7];
        const float sigma_i = sigma + w * phi;
        const float da = phi * T - (rho - sigma_i) / one_m_safe
                         - gt * tf / one_m_safe;
        const float dq = unclamped ? -0.5f * alpha * da : 0.f;
        const float dexp = unclamped ? e * da : 0.f;
#pragma unroll
        for (int c = 0; c < NBLEND; ++c) v[c] = w * g[c];
        v[MX] = dq * (-2.0f * s[CA] * dx - 2.0f * s[CB] * dy);
        v[MY] = dq * (-2.0f * s[CC] * dy - 2.0f * s[CB] * dx);
        v[CA] = dq * dx * dx;
        v[CB] = 2.0f * dq * dx * dy;
        v[CC] = dq * dy * dy;
        v[OP] = dexp;
        if (SURFEL) {
          const float ds = -(z * z) * g[6] * w;
          v[12] = ds * px;
          v[13] = ds * py;
          v[14] = ds;
        }
        sigma = sigma_i;
        T = T * one_m;
      }
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        float x = v[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x = x + __shfl_down_sync(0xffffffffu, x, off);
        v[c] = x;
      }
      if (wl == 0) {
        hit[j * NW + warp] = 1;
        float* dst = part + (j * NW + warp) * NCH;
#pragma unroll
        for (int c = 0; c < NCOL; ++c) dst[c] = v[c];
      }
    }
    __syncthreads();

    // the block's sum over its warps, in warp order, then one atomic per
    // column of every slot that had a hit
    for (int i = lane; i < nrows * NCH; i += P) {
      const int j = i / NCH, c = i % NCH;
      if (c >= NCOL) continue;
      float acc = 0.f;
      bool any_hit = false;
      for (int wp = 0; wp < NW; ++wp) {
        if (hit[j * NW + wp]) {
          acc = acc + part[(j * NW + wp) * NCH + c];
          any_hit = true;
        }
      }
      if (any_hit && acc != 0.f)
        atomicAdd(d_attr16 + (size_t)gid[j] * NCH + c, acc);
    }
  }
}

// the largest chunk (a power of two, at most CH and sb) whose shared
// memory fits the 48 KB a block gets without opting in
int chunk_for(int P, int sb, size_t* bytes) {
  const int NW = P / 32;
  int ch = sb < CH ? sb : CH;
  for (;;) {
    *bytes = (size_t)ch * NCH * 4 + (size_t)ch * NW * NCH * 4
             + (size_t)ch * 4 + (size_t)ch * NW * 4;
    if (*bytes <= 48 * 1024 || ch == 1) return ch;
    ch /= 2;
  }
}

template <bool SURFEL>
int launch(const void* attr16, const void* gauss_tbl, const void* counts,
           const void* g_out, const void* g_trans, const void* rho,
           const void* trans_final, void* d_attr16, int n, int T, int kmax,
           int ntx, int tile, int sb, void* stream) {
  const int P = tile * tile;
  size_t bytes = 0;
  const int ch = chunk_for(P, sb, &bytes);
  if (T > 0) {
    blend_bwd_kernel<SURFEL><<<T, P, bytes, (cudaStream_t)stream>>>(
        (const float*)attr16, (const int*)gauss_tbl, (const int*)counts,
        (const float*)g_out, (const float*)g_trans, (const float*)rho,
        (const float*)trans_final, (float*)d_attr16, n, kmax, ntx, tile, sb,
        ch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blend_bwd_surfel(const void* attr16, const void* gauss_tbl,
                                const void* counts, const void* g_out,
                                const void* g_trans, const void* rho,
                                const void* trans_final, void* d_attr16,
                                int n, int T, int kmax, int ntx, int tile,
                                int sb, void* stream) {
  return launch<true>(attr16, gauss_tbl, counts, g_out, g_trans, rho,
                      trans_final, d_attr16, n, T, kmax, ntx, tile, sb,
                      stream);
}

extern "C" int blend_bwd_3dgs(const void* attr16, const void* gauss_tbl,
                              const void* counts, const void* g_out,
                              const void* g_trans, const void* rho,
                              const void* trans_final, void* d_attr16,
                              int n, int T, int kmax, int ntx, int tile,
                              int sb, void* stream) {
  return launch<false>(attr16, gauss_tbl, counts, g_out, g_trans, rho,
                       trans_final, d_attr16, n, T, kmax, ntx, tile, sb,
                       stream);
}
