// Forward alpha blend of depth-sorted Gaussians per 16x16 image tile.
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
//
// Design. One block per tile, one thread per pixel (tile^2 = 256 threads).
// The block stages 32 slots at a time into shared memory, gathering each
// slot's 16-float row straight from the per-Gaussian table attr16 (N, 16)
// through gauss_tbl[t, k]; no packed (T, Kmax, 16) table is written. Each
// thread then blends its pixel sequentially over the staged slots. Slots
// past counts[t] are never read. The early stop follows the Pallas rule:
// at the start of every superblock of `sb` slots the block stops once no
// pixel of the tile has T > 1e-4 (one __syncthreads_or); no pixel stops on
// its own. Pixel centres are global: ((t % ntx) * tile + lane % tile + 0.5,
// (t / ntx) * tile + lane / tile + 0.5). Outputs use the Pallas kernels'
// layout: out (T, 8, P), trans (T, 1, P), med (T, 1, P), P = tile^2.
//
// The operations are written in the order of the plain PyTorch version
// (raster_blend.blend_fwd_ref) and the library is built with -fmad=false,
// so the gate tests round identically in both.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores counts an FMA
// as two; built with -fmad=false, every add, multiply, compare and select
// is one lane instruction, 33.5 T/s; expf and 1/s go to the special-function
// units, 1/8 of that rate; 3.35 TB/s). Each evaluated slot-pixel costs the
// gate (about 24 fp32 instructions in surfel mode, 16 in 3dgs, plus expf
// and, in surfel mode, 1/s); where alpha > 0 the blend adds about 20
// (surfel) or 19 (3dgs). At most 600 * 128 * 256 = 19.7 M slot-pixels at
// the kitti checkpoint's 640x240 (T = 600, Kmax = 128); its real first-view
// table needs 9.7 M evaluated and 2.6 M blended, about 0.29 G fp32
// instructions or 8.5 us, against 6.5 MB of bytes (the referenced attr16
// rows, the table and the outputs) or 1.9 us. The replica checkpoint's
// 1200x680 (T = 3,225) is about 7x that. So the kernel is bound by
// operations (chip_smoke.py counts both sides from each run's data). The
// design keeps every operand in registers or shared memory, reads each slot
// row once per tile, and skips the blend arithmetic where alpha is zero.
// What it does not do yet: overlap the next chunk's gather with the blend,
// or balance the sequential per-pixel scan against the latency it exposes.

#include <cuda_runtime.h>

namespace {

constexpr int NCH = 16;   // attribute columns per Gaussian
constexpr int NOUT = 8;   // blended output rows
constexpr int CH = 32;    // slots staged per chunk

template <bool SURFEL>
__global__ void blend_fwd_kernel(const float* __restrict__ attr16,
                                 const int* __restrict__ gauss_tbl,
                                 const int* __restrict__ counts,
                                 float* __restrict__ out,
                                 float* __restrict__ trans_out,
                                 float* __restrict__ med_out,
                                 int n, int kmax, int ntx, int tile, int sb,
                                 int ch) {
  __shared__ float rows[CH * NCH];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int P = blockDim.x;
  const float px = (float)((t % ntx) * tile + lane % tile) + 0.5f;
  const float py = (float)((t / ntx) * tile + lane / tile) + 0.5f;
  // constants rounded from double as PyTorch rounds a Python float
  const float alpha_floor = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  const float trans_eps = (float)1e-4;
  const float s_min = (float)1e-6;

  // column indices: mu_x, mu_y, conic a, b, c, opacity
  constexpr int MX = SURFEL ? 6 : 8;
  constexpr int MY = MX + 1, CA = MX + 2, CB = MX + 3, CC = MX + 4;
  constexpr int OP = MX + 5;

  const int cnt = min(counts[t], kmax);
  const int* tbl = gauss_tbl + (size_t)t * kmax;
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
    const int nrows = min(ch, cnt - k0);
    for (int i = lane; i < nrows * NCH; i += P) {
      const int g = max(0, min(tbl[k0 + i / NCH], n - 1));
      rows[i] = attr16[(size_t)g * NCH + i % NCH];
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
      float z = 0.f;
      if (SURFEL) {
        const float sd = s[12] * px + s[13] * py + s[14];
        const bool z_ok = sd > s_min && sd < 100.0f;
        z = z_ok ? 1.0f / sd : 0.f;
        if (!z_ok) alpha = 0.f;
      }
      if (alpha > 0.f) {
        const float w = alpha * T;
        if (SURFEL) {
#pragma unroll
          for (int c = 0; c < 6; ++c) acc[c] = acc[c] + w * s[c];
          acc[6] = acc[6] + w * z;
          acc[7] = acc[7] + w;
        } else {
#pragma unroll
          for (int c = 0; c < NOUT; ++c) acc[c] = acc[c] + w * s[c];
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

  const size_t base = (size_t)t * NOUT * P + lane;
#pragma unroll
  for (int c = 0; c < NOUT; ++c) out[base + (size_t)c * P] = acc[c];
  trans_out[(size_t)t * P + lane] = T;
  if (SURFEL) med_out[(size_t)t * P + lane] = med;
}

template <bool SURFEL>
int launch(const void* attr16, const void* gauss_tbl, const void* counts,
           void* out, void* trans, void* med, int n, int T, int kmax,
           int ntx, int tile, int sb, void* stream) {
  const int P = tile * tile;
  const int ch = sb < CH ? sb : CH;
  if (T > 0) {
    blend_fwd_kernel<SURFEL><<<T, P, 0, (cudaStream_t)stream>>>(
        (const float*)attr16, (const int*)gauss_tbl, (const int*)counts,
        (float*)out, (float*)trans, (float*)med, n, kmax, ntx, tile, sb, ch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blend_fwd_surfel(const void* attr16, const void* gauss_tbl,
                                const void* counts, void* out, void* trans,
                                void* med, int n, int T, int kmax, int ntx,
                                int tile, int sb, void* stream) {
  return launch<true>(attr16, gauss_tbl, counts, out, trans, med, n, T,
                      kmax, ntx, tile, sb, stream);
}

extern "C" int blend_fwd_3dgs(const void* attr16, const void* gauss_tbl,
                              const void* counts, void* out, void* trans,
                              int n, int T, int kmax, int ntx, int tile,
                              int sb, void* stream) {
  return launch<false>(attr16, gauss_tbl, counts, out, trans, nullptr, n, T,
                       kmax, ntx, tile, sb, stream);
}
