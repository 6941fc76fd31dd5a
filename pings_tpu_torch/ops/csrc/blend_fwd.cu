// Forward alpha blend of depth-sorted Gaussians per image tile.
//
// Replaces the Pallas TPU kernels of pings_tpu/ops/raster_pallas.py:
//   SURFEL = true   _fwd_kernel_surfel  (:377), launched by _blend_fwd_call
//   SURFEL = false  _fwd_kernel_3dgs    (:329), launched by _blend_fwd_call
// and computes what they compute, in float32 (the TPU's bf16 "fast"
// matmul mode has no counterpart here):
//   alpha = min(opa * exp(-q/2), 0.999), zeroed where q >= 9,
//           alpha < 1/255, or slot >= counts[t];
//   surfel: alpha is also zeroed where the plane depth
//           s = ndx px + ndy py + nd0 is outside (1e-6, 100); z = 1/s;
//           rows 0-5 = sum w (rgb, normal), row 6 = sum w z, row 7 = sum w,
//           median depth = z at the slot where transmittance crosses 0.5;
//   3dgs:   rows 0-7 = sum w attr[0..7] (column 7 is the constant 1);
// with w = alpha * T and T the running transmittance, front to back.
// Attribute column layouts: pings_tpu/ops/raster_pallas.py:50-74.
// The early stop follows the Pallas rule: at the start of every superblock
// of `sb` slots the block stops once no pixel of the tile has T > 1e-4 (one
// __syncthreads_or); no pixel stops on its own. Outputs use the Pallas
// kernels' layout: out (T, 8, P), trans (T, 1, P), med (T, 1, P), P =
// tile^2, row-major in the tile. `tile0` is the global index of the
// table's first tile (tile0_ref of the Pallas kernels): 0 for a whole
// image, the shard's offset when the table is a slice of the image's tiles
// (parallel.mesh.blend_gaussians_tile_sharded). Block t reads row t of the
// table and writes row t of the outputs; its pixels are those of tile
// t + tile0.
//
// What bounds it. An H100 SXM issues 33.5 T plain fp32 lane instructions a
// second (67 TFLOP/s counts an FMA as two; this file is built with
// -fmad=false), an eighth of that for expf and 1/s, and moves 3.35 TB/s.
// A slot-pixel costs the gate (about 24 instructions in surfel mode, 16 in
// 3dgs, plus expf), and about 20 more and, in surfel mode, 1/s where
// alpha > 0. The kitti checkpoint's first view (600 tiles x 128 slots,
// 640x240) holds 9.7 M slot-pixels below the tiles' counts, of which 2.6 M
// have alpha > 0: 0.29 G instructions against 6.5 MB, so the kernel is
// bound by fp32 issue, not by bytes and not by matrix work (chip_smoke.py
// counts both sides from each run's data). Tensor cores and wgmma are not
// used: the gates (q < 9, alpha >= 1/255, s > 1e-6) make the blend
// discontinuous, so q and s must be the plain version's float32 values bit
// for bit, and a TF32 or bf16 product would flip gates. For the same
// reason expf and 1/s stay the correctly rounded library versions and the
// operations keep the order of raster_blend.blend_fwd_ref.
//
// What the design does about it (one block per tile, one thread per pixel,
// 32 slots staged at a time).
// - Three quarters of the slot-pixels have alpha = 0, so slots are culled
//   per warp before the gate: a warp owns an 8 x 4 block of pixels, and
//   for each staged chunk lane j tests whether slot j can reach the warp's
//   rectangle (blend_common.cuh: slot_outside, the least q over the
//   rectangle against the cutoff, with margins that make it conservative);
//   one ballot gives the slots the warp walks, and it reads no column of
//   the others. At the kitti view 63% of the warp-slots go, of the 66%
//   that hold no pixel with alpha > 0. The cull skips only where every
//   lane's alpha is 0, so the result is unchanged.
// - Rows are gathered from attr16 (N, 16) through gauss_tbl[t, k] (no
//   packed (T, Kmax, 16) table exists) as 16-byte loads, one per thread,
//   and read back as broadcast float4 loads; the id a thread needs for the
//   next chunk is read while this one is blended. A two-stage ring filled
//   with cp.async, one barrier per chunk, measured 4-7% slower than this
//   (the tables sit in L2 and enough warps are resident to hide the
//   loads), so it is not used; TMA does not fit a gather through an index
//   table.
// - 1/s is taken only where alpha > 0.
// - Block i takes tile i. Blocks that draw tiles from a counter measured
//   slower at every table; taking the tiles longest first (a counting sort
//   in a launch of its own) gained 4% where a launch needs several waves
//   (replica) and lost at kitti, and was left out as not worth the code.

#include "blend_common.cuh"

namespace {

using namespace blend;

// One tile, by the whole block.
template <bool SURFEL>
__device__ __forceinline__ void blend_fwd_tile(
    int t, float* rows, const float* __restrict__ attr16,
    const int* __restrict__ gauss_tbl, const int* __restrict__ counts,
    float* __restrict__ out, float* __restrict__ trans_out,
    float* __restrict__ med_out, int n, int kmax, int ntx, int tile, int sb,
    int ch, int tile0) {
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const Pixels pp = block_pixels(t + tile0, ntx, tile);
  const float px = pp.px, py = pp.py;
  const float trans_eps = (float)1e-4;   // rounded from double, as PyTorch

  const int cnt = min(counts[t], kmax);
  const int* tbl = gauss_tbl + (size_t)t * kmax;
  int id = (tid < ch * 4 && (tid >> 2) < cnt) ? tbl[tid >> 2] : 0;

  float acc[NOUT];
#pragma unroll
  for (int c = 0; c < NOUT; ++c) acc[c] = 0.f;
  float T = 1.f;
  float med = 0.f;
  bool med_set = false;

  for (int k0 = 0; k0 < cnt; k0 += ch) {
    // barrier: the previous chunk's rows are consumed before the reload
    if (k0 % sb == 0) {
      if (!__syncthreads_or(T > trans_eps)) break;
    } else {
      __syncthreads();
    }
    stage_chunk(rows, attr16, tbl, k0, ch, cnt, n, id);
    __syncthreads();
    unsigned live = chunk_live<SURFEL>(rows, min(ch, cnt - k0), pp);

    while (live) {
      const int j = __ffs(live) - 1;
      live &= live - 1;
      const Gate gt = slot_gate<SURFEL>(rows + j * RS, px, py);
      const float alpha = gt.alpha;
      if (alpha > 0.f) {
        const float4* r = (const float4*)(rows + j * RS);
        const float4 r0 = r[0], r1 = r[1];
        const float w = alpha * T;
        const float z = SURFEL ? 1.0f / gt.s : 0.f;
        acc[0] = acc[0] + w * r0.x;
        acc[1] = acc[1] + w * r0.y;
        acc[2] = acc[2] + w * r0.z;
        acc[3] = acc[3] + w * r0.w;
        acc[4] = acc[4] + w * r1.x;
        acc[5] = acc[5] + w * r1.y;
        if (SURFEL) {
          acc[6] = acc[6] + w * z;
          acc[7] = acc[7] + w;
        } else {
          acc[6] = acc[6] + w * r1.z;
          acc[7] = acc[7] + w * r1.w;
        }
        const float T_out = T * (1.0f - alpha);
        if (SURFEL && !med_set && T > 0.5f && T_out <= 0.5f) {
          med = z;
          med_set = true;
        }
        T = T_out;
      }
    }
  }

  const size_t base = (size_t)t * NOUT * P + pp.pix;
#pragma unroll
  for (int c = 0; c < NOUT; ++c) out[base + (size_t)c * P] = acc[c];
  trans_out[(size_t)t * P + pp.pix] = T;
  if (SURFEL) med_out[(size_t)t * P + pp.pix] = med;
}

template <bool SURFEL, int MAXT>
__global__ void __launch_bounds__(MAXT)
blend_fwd_kernel(const float* __restrict__ attr16,
                 const int* __restrict__ gauss_tbl,
                 const int* __restrict__ counts, float* __restrict__ out,
                 float* __restrict__ trans_out, float* __restrict__ med_out,
                 int n, int kmax, int ntx, int tile, int sb, int ch,
                 int tile0) {
  extern __shared__ __align__(16) float rows[];   // ch staged rows
  blend_fwd_tile<SURFEL>(blockIdx.x, rows, attr16, gauss_tbl, counts, out,
                         trans_out, med_out, n, kmax, ntx, tile, sb, ch,
                         tile0);
}

template <bool SURFEL, int MAXT>
int launch_as(const void* attr16, const void* gauss_tbl, const void* counts,
              void* out, void* trans, void* med, int n, int T,
              int kmax, int ntx, int tile, int sb, int ch, int tile0,
              size_t bytes, cudaStream_t stream) {
  auto kernel = blend_fwd_kernel<SURFEL, MAXT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<T, tile * tile, bytes, stream>>>(
      (const float*)attr16, (const int*)gauss_tbl, (const int*)counts,
      (float*)out, (float*)trans, (float*)med, n, kmax, ntx, tile, sb, ch,
      tile0);
  return (int)cudaGetLastError();
}

template <bool SURFEL>
int launch(const void* attr16, const void* gauss_tbl, const void* counts,
           void* out, void* trans, void* med, int n, int T, int kmax,
           int ntx, int tile, int sb, int tile0, void* stream) {
  const int P = tile * tile;
  // a chunk: at most one slot per lane, one superblock, and one 16-byte
  // copy per thread (sb is a power of two >= 8, P / 4 >= 16)
  const int ch = min(min(CH, sb), P / 4);
  const size_t bytes = (size_t)ch * RS * sizeof(float);
  if (T <= 0) return 0;
  if (P <= 256)
    return launch_as<SURFEL, 256>(attr16, gauss_tbl, counts, out, trans, med,
                                  n, T, kmax, ntx, tile, sb, ch, tile0,
                                  bytes, (cudaStream_t)stream);
  return launch_as<SURFEL, 1024>(attr16, gauss_tbl, counts, out, trans, med,
                                 n, T, kmax, ntx, tile, sb, ch, tile0, bytes,
                                 (cudaStream_t)stream);
}

}  // namespace

extern "C" int blend_fwd_surfel(const void* attr16, const void* gauss_tbl,
                                const void* counts, void* out, void* trans,
                                void* med, int n, int T, int kmax, int ntx,
                                int tile, int sb, int tile0, void* stream) {
  return launch<true>(attr16, gauss_tbl, counts, out, trans, med, n, T,
                      kmax, ntx, tile, sb, tile0, stream);
}

extern "C" int blend_fwd_3dgs(const void* attr16, const void* gauss_tbl,
                              const void* counts, void* out, void* trans,
                              int n, int T, int kmax, int ntx, int tile,
                              int sb, int tile0, void* stream) {
  return launch<false>(attr16, gauss_tbl, counts, out, trans, nullptr, n, T,
                       kmax, ntx, tile, sb, tile0, stream);
}
