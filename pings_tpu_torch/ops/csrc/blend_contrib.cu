// Per-Gaussian blend contributions: sum over pixels of w = alpha * T.
//
// Replaces the Pallas TPU kernel _contrib_kernel
// (pings_tpu/ops/raster_pallas.py:734), launched by blend_contributions
// (:777), and the per-Gaussian scatter-add that follows it (:810-812). It
// is the forward scan of blend_fwd.cu again (same gates, same early stop
// per superblock of `sb` slots, SURFEL adding the plane-depth gate),
// keeping only each slot's blend weight summed over the tile's pixels;
// the slots that `mask` marks are then added to their Gaussian's entry of
// contrib (N,). A slot below counts[t] that `mask` leaves out still
// occludes the slots behind it: the mask acts only at that last sum.
// Forward only. The Pallas kernel scans in its bf16 "fast" mode; this one
// computes in float32.
//
// What bounds it. As the forward (see blend_fwd.cu for the card's rates:
// 33.5 T plain fp32 lane instructions a second without fused multiply-adds,
// an eighth of that for expf, 3.35 TB/s): the gate of every evaluated
// slot-pixel (about 24 fp32 instructions in surfel mode, 16 in 3dgs, and
// expf; the plane depth needs no 1/s here), 3 more where alpha > 0, and
// the sum of a slot's 256 weights; bytes are the referenced attr16 rows,
// the table, its mask and 4 bytes per table entry with a hit. The fp32
// rate bounds it, not bytes and not matrix work; chip_smoke.py counts both
// sides from the run's data. Tensor cores and wgmma are not used: the
// gates need the plain version's float32 q and s bit for bit, and a TF32
// or bf16 product would flip them. TMA does not fit a gather through an
// id table, and cp.async staging measured slower than plain 16-byte loads
// on these tables (they sit in L2) in the forward kernel.
//
// What the design does about it (one block per tile, one thread per pixel,
// 32 slots staged at a time, all as in the forward kernel).
// - Cull before the gate (blend_common.cuh): a warp owns an 8 x 4 block of
//   pixels, lane j tests whether slot j can reach the warp's rectangle,
//   one ballot per chunk gives the slots the warp walks. The cull skips
//   only where every lane's alpha is 0, where w is 0 too.
// - The weights are summed over the warp in batches. The w of the next
//   slots that had a hit in some lane, up to BATCH of them, go into
//   registers, one column per slot (a walked slot without a hit spends no
//   column), and one transposing butterfly sums all the columns: 9
//   shuffles for 8 slots where a tree per slot takes 40. Lane j then
//   fetches the column that stood for slot j (one more shuffle) and
//   stores it in the warp's partials. 8 columns measured 4-6% faster than
//   16 (a warp finds about 11 slots with a hit in a chunk, so the second
//   batch of 16 runs mostly empty) and than 4; 32 were 20% slower.
// - Each warp keeps its partials of a chunk with a 32-bit mask of the
//   slots it wrote, so nothing is zero-filled. Partials, ids and masks are
//   double buffered: thread j adds the warps' partials of slot j in warp
//   order (deterministic within a tile; partials lie as [warp][slot], so
//   the 32 reads fall in 32 banks) and does one atomicAdd per slot with a
//   hit, after the staging barrier of the next chunk, while the other
//   warps blend it. Two barriers per chunk. The order in which tiles that
//   share a Gaussian add to its entry varies from run to run.

#include "blend_common.cuh"

namespace {

using namespace blend;

// slots whose weights one butterfly sums
constexpr int BATCH = 8;

// One tile, by the whole block. `smem`: rows [ch][RS], partials
// [2][NW][ch], ids [2][ch], hit masks [2][NW].
template <bool SURFEL>
__device__ __forceinline__ void blend_contrib_tile(
    int t, float* smem, const float* __restrict__ attr16,
    const int* __restrict__ gauss_tbl, const int* __restrict__ counts,
    const unsigned char* __restrict__ mask, float* __restrict__ contrib,
    int n, int kmax, int ntx, int tile, int sb, int ch) {
  const int P = blockDim.x;
  const int NW = P >> 5;
  float* rows = smem;
  float* part = rows + ch * RS;
  int* gid = (int*)(part + 2 * NW * ch);
  unsigned* hitm = (unsigned*)(gid + 2 * ch);   // slots of the chunk that
                                                // the warp hit, one bit each
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const Pixels pp = block_pixels(t, ntx, tile);
  const float px = pp.px, py = pp.py;
  const float trans_eps = (float)1e-4;   // rounded from double, as PyTorch

  const int cnt = min(counts[t], kmax);
  const int* tbl = gauss_tbl + (size_t)t * kmax;
  const unsigned char* msk = mask + (size_t)t * kmax;
  int id = (tid < ch * 4 && (tid >> 2) < cnt) ? tbl[tid >> 2] : 0;
  float T = 1.f;
  int pend_rows = 0, pend_buf = 0, pend_k0 = 0;   // a chunk whose partials
                                                  // wait

  // the block's sum of a chunk's partials over its warps, in warp order,
  // and one atomic per slot that had a hit and that the mask keeps
  auto flush = [&](int b, int nr, int k0) {
    if (tid < nr) {
      float a = 0.f;
      for (int wp = 0; wp < NW; ++wp)
        if ((hitm[b * NW + wp] >> tid) & 1u)
          a = a + part[(b * NW + wp) * ch + tid];
      if (a != 0.f && msk[k0 + tid]) atomicAdd(contrib + gid[b * ch + tid], a);
    }
  };

  for (int k0 = 0, c = 0; k0 < cnt; k0 += ch, ++c) {
    const int b = c & 1;
    // barrier: the previous chunk's rows are consumed before the reload,
    // and its partials are stored
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
    // the previous chunk's partials, while the warps blend this one
    if (pend_rows) flush(pend_buf, pend_rows, pend_k0);
    const int nrows = min(ch, cnt - k0);
    unsigned live = chunk_live<SURFEL>(rows, nrows, pp);
    unsigned hits = 0u;
    float* wpart = part + (b * NW + warp) * ch;

    while (live) {
      // the next slots with a hit, one column each, in slot order
      float v[BATCH];
      unsigned batch = 0u;
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        v[i] = 0.f;
        while (live) {
          const int j = __ffs(live) - 1;
          live &= live - 1;
          const float alpha = slot_gate<SURFEL>(rows + j * RS, px, py).alpha;
          const bool active = alpha > 0.f;
          if (__any_sync(0xffffffffu, active)) {
            if (active) {
              v[i] = alpha * T;
              T = T * (1.0f - alpha);
            }
            batch |= 1u << j;
            break;
          }
        }
      }
      if (batch == 0u) break;       // the walked slots had no hit
      const float mine = warp_transpose_sum(v, wl);
      // slot wl's column is its rank among the batch's slots, and column
      // r's sum lies on lane r
      const int r = __popc(batch & ((1u << wl) - 1u));
      const float sum = __shfl_sync(0xffffffffu, mine, r);
      if ((batch >> wl) & 1u) wpart[wl] = sum;
      hits |= batch;
    }
    if (wl == 0) hitm[b * NW + warp] = hits;
    pend_rows = nrows;
    pend_buf = b;
    pend_k0 = k0;
  }

  __syncthreads();
  if (pend_rows) flush(pend_buf, pend_rows, pend_k0);
}

// At 1,024 threads the compiler is told that one block per SM will do:
// left to itself it halves the registers to fit two, and spills. At 256
// threads it is left to itself (0: no such request).
template <bool SURFEL, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT > 256 ? 1 : 0)
blend_contrib_kernel(const float* __restrict__ attr16,
                     const int* __restrict__ gauss_tbl,
                     const int* __restrict__ counts,
                     const unsigned char* __restrict__ mask,
                     float* __restrict__ contrib, int n, int kmax, int ntx,
                     int tile, int sb, int ch) {
  extern __shared__ __align__(16) float smem[];
  blend_contrib_tile<SURFEL>(blockIdx.x, smem, attr16, gauss_tbl, counts,
                             mask, contrib, n, kmax, ntx, tile, sb, ch);
}

template <bool SURFEL>
int launch(const void* attr16, const void* gauss_tbl, const void* counts,
           const void* mask, void* contrib, int n, int T, int kmax, int ntx,
           int tile, int sb, void* stream) {
  const int P = tile * tile;
  const int NW = P / 32;
  // a chunk: at most one slot per lane, one superblock, and one 16-byte
  // copy per thread (sb is a power of two >= 8, P / 4 >= 16)
  const int ch = min(min(CH, sb), P / 4);
  // at most 11 KB (1,024 threads): under the 48 KB a launch may take unasked
  const size_t bytes = (size_t)ch * RS * sizeof(float)
                       + (size_t)2 * NW * ch * sizeof(float)
                       + (size_t)2 * ch * sizeof(int)
                       + (size_t)2 * NW * sizeof(unsigned);
  if (T <= 0) return 0;
  if (P <= 256)
    blend_contrib_kernel<SURFEL, 256><<<T, P, bytes, (cudaStream_t)stream>>>(
        (const float*)attr16, (const int*)gauss_tbl, (const int*)counts,
        (const unsigned char*)mask, (float*)contrib, n, kmax, ntx, tile, sb,
        ch);
  else
    blend_contrib_kernel<SURFEL, 1024><<<T, P, bytes, (cudaStream_t)stream>>>(
        (const float*)attr16, (const int*)gauss_tbl, (const int*)counts,
        (const unsigned char*)mask, (float*)contrib, n, kmax, ntx, tile, sb,
        ch);
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
