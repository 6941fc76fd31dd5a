// Row scatter: the gradient of a row gather from the map's feature tables.
//
// Replaces no TPU kernel. The JAX package differentiates `table[idx]`
// through XLA, whose scatter-add on the TPU sums the cotangent rows into
// the table with no sequential run to walk. PyTorch's own gradient of a
// gather on the card (IndexBackward0 -> index_put_ with accumulate) sorts
// the indices and gives each run of equal indices to one warp, which walks
// the run entry by entry. The map sends every invalid neighbour and every
// padded row of the local window to one dump row, so a call holds runs of
// tens of thousands of equal indices, and that one serial walk took most
// of a GS iteration's device time. This kernel's cost does not depend on
// how often an index repeats.
//
// What it computes. `keys` are the gather's row indices sorted (stable),
// `perm` their positions in the gather: entry e of the sorted order adds
// cotangent row perm[e] of each table into row keys[e] of that table's
// dense gradient, which the caller zero-fills. Up to two tables share one
// index (the map's geo_feat and color_feat).
//
// What bounds it: bytes. Each call reads the cotangent rows (4 f bytes an
// entry and table), the keys and the permutation (12 bytes an entry), and
// writes the rows it touches; the dense zero fill of the (rows, f)
// gradients, which the caller issues, is most of the bytes at the map's
// 2^20 rows (32 MB a table at f = 8). There is no arithmetic to speak of:
// one add per entry and column.
//
// What the design does about it.
// - Chunk pass: one block per CHUNK sorted entries, one thread per entry,
//   which loads its cotangent row a slab of 8 columns at a time (two
//   16-byte loads where the widths allow). The runs inside the chunk are
//   reduced in parallel by a segmented scan: five shuffle steps inside each
//   warp, then each run's last thread adds the sums of the earlier warps
//   that hold the same run. A run that begins and ends in the chunk is
//   written straight into its row (no other block holds that row). The
//   part of a run that crosses the chunk's end goes to the chunk's `tail`
//   partial, the part of a run that came from an earlier chunk and ends
//   here to its `head` partial.
// - Carry pass: the block of the chunk where such a run ends finds the
//   chunk where it began (a binary search of the sorted keys) and sums the
//   tails of the chunks in between and its own head, 32 partials at a time
//   per column, then a fixed tree over the 32. No thread walks more than
//   one entry in the chunk pass and ceil(E / (CHUNK * 32)) partials in the
//   carry pass, however many entries share a row.
// - Every sum is taken in an order fixed by the sorted keys alone, so the
//   same inputs give the same bits on every run (no atomics). A row whose
//   entries are all zero (the dump row under the callers' masks) sums to an
//   exact zero, so the optimizer's row mask sees the rows it saw before.

#include <cuda_runtime.h>

#include <cassert>

namespace {

constexpr int CHUNK = 256;       // sorted entries of a chunk-pass block
constexpr int NWARP = CHUNK / 32;
constexpr int SLAB = 8;          // columns a thread holds at a time
constexpr int CARRY_ROWS = 32;   // partials summed side by side per column
constexpr int CARRY_COLS = 8;    // columns of a carry-pass block at a time
constexpr unsigned FULL = 0xffffffffu;

struct Tables {
  const float* g[2];   // (E, f[t]) cotangent rows, in gather order
  float* d[2];         // (rows, f[t]) dense gradients, zero-filled
  int f[2];            // columns; f[1] = 0 where one table is given
};

template <bool V4>
__device__ __forceinline__ void load_slab(float (&v)[SLAB],
                                          const float* __restrict__ src,
                                          int c0, int f, bool live) {
  if (V4) {
#pragma unroll
    for (int q = 0; q < SLAB / 4; ++q) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && c0 + 4 * q < f)
        x = *reinterpret_cast<const float4*>(src + c0 + 4 * q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < SLAB; ++k)
      v[k] = (live && c0 + k < f) ? src[c0 + k] : 0.f;
  }
}

template <bool V4>
__device__ __forceinline__ void store_slab(float* __restrict__ dst,
                                           const float (&v)[SLAB], int c0,
                                           int f) {
  if (V4) {
#pragma unroll
    for (int q = 0; q < SLAB / 4; ++q)
      if (c0 + 4 * q < f)
        *reinterpret_cast<float4*>(dst + 4 * q) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < SLAB; ++k)
      if (c0 + k < f) dst[k] = v[k];
  }
}

// `tail`, `head`: (chunks, ftot) partials, table 0's columns first.
template <bool V4>
__global__ void __launch_bounds__(CHUNK) row_scatter_chunks(
    const int* __restrict__ keys, const long long* __restrict__ perm,
    Tables tb, float* __restrict__ tail, float* __restrict__ head, int E,
    int rows, int ftot) {
  __shared__ int sk[CHUNK + 2];   // keys[b - 1 .. b + n], -1 beyond
  __shared__ float wsum[NWARP][SLAB];
  __shared__ int wfirst[NWARP], wlast[NWARP];
  const int c = blockIdx.x;
  const int b = c * CHUNK;
  const int n = min(CHUNK, E - b);
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int w = i >> 5;
  for (int j = i; j < CHUNK + 2; j += CHUNK) {
    const int e = b - 1 + j;
    sk[j] = (e >= 0 && e < E && j <= n + 1) ? keys[e] : -1;
  }
  __syncthreads();
  const bool live = i < n;
  const int key = sk[i + 1];     // -1 past the last entry: no row is < 0
  assert(!live || (key >= 0 && key < rows));
  if (lane == 0) wfirst[w] = key;
  if (lane == 31) wlast[w] = key;
  // bit s: the entry 2^s lanes back lies in the same run
  unsigned same = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int up = __shfl_up_sync(FULL, key, 1 << s);
    if (lane >= (1 << s) && up == key) same |= 1u << s;
  }
  // the run's last entry in this chunk holds the run's sum over the chunk
  const bool ends = live && (i == n - 1 || sk[i + 2] != key);
  const bool from_before = b > 0 && sk[0] == key && sk[1] == key;
  const bool to_after = i == n - 1 && sk[n + 1] == key;
  const long long row = live ? perm[b + i] : 0;
  __syncthreads();               // wfirst, wlast
  for (int t = 0; t < 2; ++t) {
    // the table's fields by selection: indexing the struct by t would
    // copy it to local memory
    const int f = t == 0 ? tb.f[0] : tb.f[1];
    const int off = t == 0 ? 0 : tb.f[0];   // its first column in a partial
    const float* g = t == 0 ? tb.g[0] : tb.g[1];
    float* d = t == 0 ? tb.d[0] : tb.d[1];
    for (int c0 = 0; c0 < f; c0 += SLAB) {
      float v[SLAB];
      load_slab<V4>(v, g + row * f, c0, f, live);
#pragma unroll
      for (int s = 0; s < 5; ++s) {
#pragma unroll
        for (int k = 0; k < SLAB; ++k) {
          const float u = __shfl_up_sync(FULL, v[k], 1 << s);
          if (same & (1u << s)) v[k] += u;
        }
      }
      if (lane == 31) {
#pragma unroll
        for (int k = 0; k < SLAB; ++k) wsum[w][k] = v[k];
      }
      __syncthreads();
      if (ends) {
        // the run began in an earlier warp: add those warps' sums of it,
        // nearest first
        if (wfirst[w] == key) {
          for (int u = w - 1; u >= 0 && wlast[u] == key; --u) {
#pragma unroll
            for (int k = 0; k < SLAB; ++k) v[k] += wsum[u][k];
            if (wfirst[u] != key) break;
          }
        }
        float* dst;
        if (to_after)
          dst = tail + (size_t)c * ftot + off + c0;
        else if (from_before)
          dst = head + (size_t)c * ftot + off + c0;
        else
          dst = d + (size_t)key * f + c0;
        store_slab<V4>(dst, v, c0, f);
      }
      __syncthreads();           // wsum is rewritten by the next slab
    }
  }
}

// One block per chunk; the block whose chunk holds the end of a run that
// began in an earlier chunk finishes that run's row.
__global__ void __launch_bounds__(CARRY_ROWS * CARRY_COLS) row_scatter_carry(
    const int* __restrict__ keys, Tables tb, const float* __restrict__ tail,
    const float* __restrict__ head, int E, int ftot) {
  __shared__ float red[CARRY_ROWS][CARRY_COLS];
  const int c = blockIdx.x;
  const int b = c * CHUNK;
  const int n = min(CHUNK, E - b);
  const int key = keys[b];
  if (b == 0 || keys[b - 1] != key) return;
  if (keys[b + n - 1] == key && b + n < E && keys[b + n] == key) return;
  int lo = 0, hi = b;            // the run's first entry: lower bound
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  const int c_first = lo / CHUNK;
  const int m = c - c_first;     // tails of chunks c_first .. c - 1
  const int col = threadIdx.x % CARRY_COLS;
  const int r = threadIdx.x / CARRY_COLS;
  for (int j0 = 0; j0 < ftot; j0 += CARRY_COLS) {
    const int j = j0 + col;
    float s = 0.f;
    if (j < ftot)
      for (int p = r; p < m; p += CARRY_ROWS)
        s += tail[(size_t)(c_first + p) * ftot + j];
    red[r][col] = s;
    __syncthreads();
#pragma unroll
    for (int h = CARRY_ROWS / 2; h >= 1; h >>= 1) {
      if (r < h) red[r][col] += red[r + h][col];
      __syncthreads();
    }
    if (r == 0 && j < ftot) {
      const float total = red[0][col] + head[(size_t)c * ftot + j];
      if (j < tb.f[0])
        tb.d[0][(size_t)key * tb.f[0] + j] = total;
      else
        tb.d[1][(size_t)key * tb.f[1] + (j - tb.f[0])] = total;
    }
    __syncthreads();             // red is rewritten by the next columns
  }
}

}  // namespace

// keys: (E,) int32 sorted rows; perm: (E,) int64 their gather positions;
// g0, g1: (E, f0), (E, f1) float32 cotangents; d0, d1: (rows, f0),
// (rows, f1) zero-filled gradients (g1, d1 null where f1 = 0); tail, head:
// 2 x (ceil(E / 256), f0 + f1) float32 scratch; vec4: every width a
// multiple of 4 and every pointer 16-byte aligned. Returns the CUDA error
// of the launches (0 when both were taken).
extern "C" int row_scatter(const void* keys, const void* perm,
                           const void* g0, const void* g1, void* d0,
                           void* d1, void* tail, void* head, int E, int rows,
                           int f0, int f1, int vec4, void* stream) {
  if (E <= 0) return 0;
  Tables tb;
  tb.g[0] = (const float*)g0;
  tb.g[1] = (const float*)g1;
  tb.d[0] = (float*)d0;
  tb.d[1] = (float*)d1;
  tb.f[0] = f0;
  tb.f[1] = f1;
  const int chunks = (E + CHUNK - 1) / CHUNK;
  const int ftot = f0 + f1;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4)
    row_scatter_chunks<true><<<chunks, CHUNK, 0, st>>>(
        (const int*)keys, (const long long*)perm, tb, (float*)tail,
        (float*)head, E, rows, ftot);
  else
    row_scatter_chunks<false><<<chunks, CHUNK, 0, st>>>(
        (const int*)keys, (const long long*)perm, tb, (float*)tail,
        (float*)head, E, rows, ftot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_scatter_carry<<<chunks, CARRY_ROWS * CARRY_COLS, 0, st>>>(
      (const int*)keys, tb, (const float*)tail, (const float*)head, E, ftot);
  return (int)cudaGetLastError();
}
