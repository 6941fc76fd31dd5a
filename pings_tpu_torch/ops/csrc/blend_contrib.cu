// Per-Gaussian blend contributions: sum over pixels of w = alpha * T.
//
// Replaces the Pallas TPU kernel _contrib_kernel
// (pings_tpu/ops/raster_pallas.py:734), launched by blend_contributions
// (:777), and the per-Gaussian scatter-add that follows it (:810-812). It
// is the forward scan of blend_fwd.cu again (same gates, same early stop
// per superblock of `sb` slots, SURFEL adding the plane-depth gate),
// keeping only each slot's blend weight summed over the tile's pixels;
// the slots that `mask` marks are then added to their Gaussian's entry of
// contrib (N,). Forward only. The Pallas kernel scans in its bf16 "fast"
// mode; this one computes in float32.
//
// Design. One block per tile, one thread per pixel, `ch` slots staged at a
// time through gauss_tbl. A warp without a pixel of alpha > 0 skips the
// slot; otherwise it reduces w with shuffles. After the chunk the block
// sums the warps' partials in warp order and adds one atomicAdd per slot
// with a hit: the sum within a tile is deterministic, the order across
// the tiles that share a Gaussian is not.
//
// Bound on an H100 SXM (rates as in blend_fwd.cu): the gate of every
// evaluated slot-pixel (about 24 fp32 instructions in surfel mode, 16 in
// 3dgs, and expf; the plane depth needs no 1/s here), 3 more where
// alpha > 0, and 10 per warp-slot with a hit; bytes are the referenced
// attr16 rows, the table, its mask and 4 bytes per table entry with a
// hit. Operations bound it; chip_smoke.py counts both from the run's data.

#include <cuda_runtime.h>

namespace {

constexpr int NCH = 16;   // attribute columns per Gaussian
constexpr int CH = 32;    // most slots staged per chunk
constexpr int MAXW = 32;  // most warps per block (tile^2 <= 1024)

template <bool SURFEL>
__global__ void blend_contrib_kernel(const float* __restrict__ attr16,
                                     const int* __restrict__ gauss_tbl,
                                     const int* __restrict__ counts,
                                     const unsigned char* __restrict__ mask,
                                     float* __restrict__ contrib,
                                     int n, int kmax, int ntx, int tile,
                                     int sb, int ch) {
  __shared__ float rows[CH * NCH];
  __shared__ float part[CH * MAXW];
  __shared__ int gid[CH];

  const int P = blockDim.x;
  const int NW = P / 32;
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const float px = (float)((t % ntx) * tile + lane % tile) + 0.5f;
  const float py = (float)((t / ntx) * tile + lane / tile) + 0.5f;
  const float alpha_floor = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  const float trans_eps = (float)1e-4;
  const float s_min = (float)1e-6;

  constexpr int MX = SURFEL ? 6 : 8;
  constexpr int MY = MX + 1, CA = MX + 2, CB = MX + 3, CC = MX + 4;
  constexpr int OP = MX + 5;

  const int cnt = min(counts[t], kmax);
  const int* tbl = gauss_tbl + (size_t)t * kmax;
  const unsigned char* msk = mask + (size_t)t * kmax;
  float T = 1.f;

  for (int k0 = 0; k0 < cnt; k0 += ch) {
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
      const float araw = s[OP] * expf(-0.5f * q);
      float alpha = (q < 9.0f && araw >= alpha_floor)
                        ? fminf(araw, alpha_max) : 0.f;
      if (SURFEL) {
        const float sd = s[12] * px + s[13] * py + s[14];
        if (!(sd > s_min && sd < 100.0f)) alpha = 0.f;
      }
      const bool active = alpha > 0.f;
      float w = 0.f;
      if (active) {
        w = alpha * T;
        T = T * (1.0f - alpha);
      }
      if (__ballot_sync(0xffffffffu, active) != 0u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          w = w + __shfl_down_sync(0xffffffffu, w, off);
      }
      if (wl == 0) part[j * NW + warp] = w;
    }
    __syncthreads();

    for (int j = lane; j < nrows; j += P) {
      float acc = 0.f;
      for (int wp = 0; wp < NW; ++wp) acc = acc + part[j * NW + wp];
      if (acc != 0.f && msk[k0 + j]) atomicAdd(contrib + gid[j], acc);
    }
  }
}

template <bool SURFEL>
int launch(const void* attr16, const void* gauss_tbl, const void* counts,
           const void* mask, void* contrib, int n, int T, int kmax, int ntx,
           int tile, int sb, void* stream) {
  const int P = tile * tile;
  const int ch = sb < CH ? sb : CH;
  if (T > 0) {
    blend_contrib_kernel<SURFEL><<<T, P, 0, (cudaStream_t)stream>>>(
        (const float*)attr16, (const int*)gauss_tbl, (const int*)counts,
        (const unsigned char*)mask, (float*)contrib, n, kmax, ntx, tile, sb,
        ch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blend_contrib_surfel(const void* attr16,
                                    const void* gauss_tbl,
                                    const void* counts, const void* mask,
                                    void* contrib, int n, int T, int kmax,
                                    int ntx, int tile, int sb,
                                    void* stream) {
  return launch<true>(attr16, gauss_tbl, counts, mask, contrib, n, T, kmax,
                      ntx, tile, sb, stream);
}

extern "C" int blend_contrib_3dgs(const void* attr16, const void* gauss_tbl,
                                  const void* counts, const void* mask,
                                  void* contrib, int n, int T, int kmax,
                                  int ntx, int tile, int sb, void* stream) {
  return launch<false>(attr16, gauss_tbl, counts, mask, contrib, n, T, kmax,
                       ntx, tile, sb, stream);
}
