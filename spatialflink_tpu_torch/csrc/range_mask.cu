// K1: range-query mask and pruning counts over one window batch, for all
// of a launch's queries in one pass over the points.
//
// Replaces the XLA-fused range kernels of spatialflink_tpu/ops/range.py:
// range_filter_point_stats (:72-96, point query, Chebyshev layers) and
// range_filter_masks_stats (:196-217, dense GN/CN cell masks plus
// precomputed distances), and their Q-row forms
// (range_filter_point_multi_masks, :136, and the vmapped
// range_filter_masks_stats of ops/geom.py range_points_to_geom_queries,
// :236). One kernel serves both through `mode`. Plain PyTorch versions:
// spatialflink_tpu_torch/ops/range.py, whose operation order this file
// follows step for step; each row of a Q-query launch equals the
// single-query launch bit for bit.
//
// What bounds it on an H100: bytes. Per point it reads x, y, cell and valid
// (13 bytes; the mask mode reads cell and valid, 5 bytes, plus the CN
// points' distances and L2-resident n*n cell-mask gathers) and writes one
// mask byte per query (plus, on request, a distance in the single-query
// point mode), against ~15 operations per point and query.
//
// What the design does about it:
// - Each point is read once for all Q queries: a thread owns kVec = 4
//   consecutive points, loads them as a float4 of x, of y, an int4 of cell
//   and a 32-bit word of valid, takes the cell's (ax, ay) once (integer
//   division by a runtime n runs once per point, not per query), and then
//   loops over the queries, whose parameters (qx, qy and the query cell's
//   (bx, by)) sit in shared memory.
// - Each mask row is written as 32-bit words (a warp stores 128 bytes per
//   row); distances as float4. n that is not a multiple of 4, or an
//   unaligned pointer, takes the same code with scalar loads and stores.
// - In mask mode a point's distance is read only for CN points (a float4
//   when any of a thread's 4 points is CN), as the plain version consults
//   it only there.
// - The counts: per query and warp a __reduce_add_sync of the warp's
//   packed counts, added into 2*Q shared counters, and one atomicAdd per
//   block and counter into `counts` (zeroed by a memset before the
//   kernel) at the end. Integer sums are exact in any order. Zeroing them
//   inside the launch instead (block 0 zeroes, the other blocks wait for
//   it) needs every block resident at once, i.e. a cooperative launch, and
//   measured no faster than the memset on an H100.
// - The radius test: sqrtf is correctly rounded and monotone, so
//   sqrtf(d2) <= r exactly when d2 <= d2_limit(r), the largest f32 whose
//   root is <= r (found on the host); a root is taken only where a
//   distance is written.
// - Mask mode from 12 queries on: one 1,024-thread block per SM first
//   packs every cell's GN/CN bits of 16 queries into one shared word
//   (10,000 cells x 16 queries: 40 KB), so a point reads one word instead
//   of gathering two mask bytes per query; fewer queries gather.
// - Grid: one resident wave (SMs x blocks per SM), a grid-stride loop
//   beyond; 8 queries per unrolled step from 8 queries on.
//
// Built with --fmad=false (no FMA contraction), so the point-mode distance
// rounds exactly as the plain version's separate PyTorch ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;              // consecutive points per thread
// queries per unrolled step: 8 from 8 queries on (the counts of a tile are
// reduced together), else 1, which keeps registers few and occupancy high
constexpr int kQueryTile = 8;
// staged mask mode: one 1,024-thread block per SM holds the GN/CN codes of
// every cell (10,000 cells x 16 queries: 40 KB) when they fit in
// kStagedSmem and the launch has kStagedMinQueries queries or more (on an
// H100 the staging costs more than it saves at few queries; the crossover
// lies between 8 and 16)
constexpr int kStagedThreads = 1024;
constexpr size_t kStagedSmem = 96 * 1024;
constexpr int kStagedMinQueries = 12;
constexpr int kModePoint = 0;
constexpr int kNoLayer = 1 << 30;    // uniform_grid.cheb_layers sentinel
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int mode, approximate, n, q;
  const float* x;
  const float* y;
  const int32_t* cell;
  const uint8_t* valid;
  float qx, qy;
  int q_cell;
  const float* qxs;
  const float* qys;
  const int32_t* q_cells;
  int grid_n, gn_layers, cn_layers;
  const uint8_t* gn_mask;
  const uint8_t* cn_mask;
  const float* dists_in;
  int num_cells;
  float radius;
  float d2_limit;  // the largest f32 d2 with sqrtf(d2) <= radius
  uint8_t* mask_out;
  float* dists_out;
  int32_t* counts;
};

// The two counts of a query travel packed: gn + (ev << 16), at most 4 * 32
// each per warp. Every lane of the block reaches this call for every query
// (the point loop is uniform), so the full-mask reduction is safe.
__device__ __forceinline__ void add_counts(int* s_cnt, int q, unsigned packed) {
  const unsigned sum = __reduce_add_sync(kFull, packed);
  if ((threadIdx.x & 31) == 0 && sum) {
    atomicAdd(&s_cnt[2 * q], static_cast<int>(sum & 0xffffu));
    atomicAdd(&s_cnt[2 * q + 1], static_cast<int>(sum >> 16));
  }
}

// Store the 4 mask bytes of one query row (word: byte k = point i0 + k).
template <bool kVecIO>
__device__ __forceinline__ void store_mask(uint8_t* row, int i0, int n,
                                           uint32_t word) {
  if (kVecIO) {
    if (i0 < n) *reinterpret_cast<uint32_t*>(row + i0) = word;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (i0 + k < n) row[i0 + k] = static_cast<uint8_t>(word >> (8 * k));
    }
  }
}

template <bool kVecIO, int kTile>
__device__ __forceinline__ void point_rows(const Args& a, const int4* s_q,
                                           int* s_cnt, int i0,
                                           const float (&x)[kVec],
                                           const float (&y)[kVec],
                                           const int (&c)[kVec],
                                           const bool (&v)[kVec]) {
  int ax[kVec], ay[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    ax[k] = c[k] >= 0 ? c[k] / a.grid_n : 0;
    ay[k] = c[k] - ax[k] * a.grid_n;
  }
  for (int q0 = 0; q0 < a.q; q0 += kTile) {
    unsigned cnt[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int q = q0 + t;
      cnt[t] = 0;
      if (q >= a.q) continue;
      const int4 sq = s_q[q];
      const float qx = __int_as_float(sq.x), qy = __int_as_float(sq.y);
      uint32_t word = 0;
      float d[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        int layers = kNoLayer;
        if (c[k] >= 0 && sq.z >= 0) {
          layers = max(abs(ax[k] - sq.z), abs(ay[k] - sq.w));
        }
        const bool in_gn = layers <= a.gn_layers;  // -1: no GN cells
        const bool in_cn = (layers <= a.cn_layers) && !in_gn;
        bool keep;
        d[k] = INFINITY;
        if (a.approximate) {
          keep = in_gn || in_cn;
        } else {
          float d2 = 0.0f;
          if (in_cn) {
            const float dx = qx - x[k];
            const float dy = qy - y[k];
            d2 = dx * dx + dy * dy;
            if (a.dists_out != nullptr) d[k] = sqrtf(d2);
          }
          // d2 <= d2_limit is sqrtf(d2) <= radius, exactly (d2_limit)
          keep = in_gn || (in_cn && d2 <= a.d2_limit);
        }
        word |= static_cast<uint32_t>(v[k] && keep) << (8 * k);
        cnt[t] += (v[k] && in_gn) ? 1u : 0u;
        cnt[t] += (!a.approximate && v[k] && in_cn) ? 1u << 16 : 0u;
      }
      store_mask<kVecIO>(a.mask_out + static_cast<size_t>(q) * a.n, i0, a.n,
                         word);
      if (a.dists_out != nullptr) {  // single-query point mode only
        if (kVecIO) {
          if (i0 < a.n) {
            *reinterpret_cast<float4*>(a.dists_out + i0) =
                make_float4(d[0], d[1], d[2], d[3]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            if (i0 + k < a.n) a.dists_out[i0 + k] = d[k];
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      if (q0 + t < a.q) add_counts(s_cnt, q0 + t, cnt[t]);
    }
  }
}

// Mask mode. Staged: the GN/CN bits of 16 queries per cell sit in shared
// memory as one word (bit j: GN of query 16 g + j, bit 16 + j: its CN), so a
// point reads one word per 16 queries; else each query gathers its two mask
// bytes from device memory (L2).
template <bool kVecIO, bool kStaged, int kTile>
__device__ __forceinline__ void mask_rows(const Args& a, int* s_cnt,
                                          const uint32_t* s_codes, int i0,
                                          const int (&c)[kVec],
                                          const bool (&v)[kVec]) {
  const int groups = (a.q + 15) / 16;
  bool ok[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    // the cell >= 0 guard: a -1 pad must never index the masks
    ok[k] = c[k] >= 0 && c[k] < a.num_cells;
  }
  for (int q0 = 0; q0 < a.q; q0 += kTile) {
    uint32_t code[kVec];
    if (kStaged) {  // a tile lies inside one group of 16 queries
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        code[k] = ok[k] ? s_codes[c[k] * groups + q0 / 16] : 0u;
      }
    }
    unsigned cnt[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int q = q0 + t;
      cnt[t] = 0;
      if (q >= a.q) continue;
      const size_t mrow = static_cast<size_t>(q) * a.num_cells;
      const size_t row = static_cast<size_t>(q) * a.n;
      bool in_gn[kVec], in_cn[kVec];
      bool any_cn = false;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (kStaged) {
          in_gn[k] = (code[k] >> (q & 15)) & 1u;
          in_cn[k] = !in_gn[k] && ((code[k] >> (16 + (q & 15))) & 1u);
        } else {
          in_gn[k] = ok[k] && a.gn_mask[mrow + c[k]] != 0;
          in_cn[k] = ok[k] && !in_gn[k] && a.cn_mask[mrow + c[k]] != 0;
        }
        any_cn = any_cn || in_cn[k];
      }
      float d[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (!a.approximate && any_cn) {
        const float* drow = a.dists_in + row;
        if (kVecIO) {
          const float4 dv = *reinterpret_cast<const float4*>(drow + i0);
          d[0] = dv.x;
          d[1] = dv.y;
          d[2] = dv.z;
          d[3] = dv.w;
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            if (in_cn[k]) d[k] = drow[i0 + k];
          }
        }
      }
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const bool keep =
            in_gn[k] || (in_cn[k] && (a.approximate || d[k] <= a.radius));
        word |= static_cast<uint32_t>(v[k] && keep) << (8 * k);
        cnt[t] += (v[k] && in_gn[k]) ? 1u : 0u;
        cnt[t] += (!a.approximate && v[k] && in_cn[k]) ? 1u << 16 : 0u;
      }
      store_mask<kVecIO>(a.mask_out + row, i0, a.n, word);
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      if (q0 + t < a.q) add_counts(s_cnt, q0 + t, cnt[t]);
    }
  }
}

// Dynamic shared memory: point mode's Q query entries {qx, qy (f32 bits),
// bx, by (-1: query outside the grid)}, then 2 * Q counters, then (staged
// mask mode) num_cells * ceil(Q / 16) GN/CN code words.
template <int kBlock, bool kVecIO, bool kStaged, int kTile>
__global__ void __launch_bounds__(kBlock) range_mask_kernel(const Args a) {
  extern __shared__ int4 s_raw[];
  const int4* s_q = s_raw;
  int* s_cnt =
      reinterpret_cast<int*>(s_raw + (a.mode == kModePoint ? a.q : 0));
  uint32_t* s_codes = reinterpret_cast<uint32_t*>(s_cnt + 2 * a.q);
  for (int t = threadIdx.x; t < 2 * a.q; t += kBlock) s_cnt[t] = 0;
  if (a.mode == kModePoint) {
    for (int t = threadIdx.x; t < a.q; t += kBlock) {
      const bool many = a.qxs != nullptr;
      const float qx = many ? a.qxs[t] : a.qx;
      const float qy = many ? a.qys[t] : a.qy;
      const int qc = many ? a.q_cells[t] : a.q_cell;
      s_raw[t] = make_int4(__float_as_int(qx), __float_as_int(qy),
                           qc >= 0 ? qc / a.grid_n : -1,
                           qc >= 0 ? qc % a.grid_n : 0);
    }
  }
  if (kStaged) {
    const int groups = (a.q + 15) / 16;
    for (int idx = threadIdx.x; idx < a.num_cells * groups; idx += kBlock) {
      const int cell = idx / groups, g = idx - cell * groups;
      uint8_t gn[16], cn[16];  // all 32 loads in flight before the pack
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const size_t at = static_cast<size_t>(16 * g + j) * a.num_cells + cell;
        const bool in = 16 * g + j < a.q;
        gn[j] = in ? a.gn_mask[at] : 0;
        cn[j] = in ? a.cn_mask[at] : 0;
      }
      uint32_t w = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        w |= static_cast<uint32_t>(gn[j] != 0) << j;
        w |= static_cast<uint32_t>(cn[j] != 0) << (16 + j);
      }
      s_codes[idx] = w;
    }
  }
  __syncthreads();

  const int groups = (a.n + kVec - 1) / kVec;
  // uniform trip count for the whole block (the warp reductions need
  // every lane); lanes past the end carry invalid points and store nothing
  for (int base = blockIdx.x * kBlock; base < groups;
       base += gridDim.x * kBlock) {
    const int i0 = (base + threadIdx.x) * kVec;
    float x[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
    float y[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
    int c[kVec] = {-1, -1, -1, -1};
    bool v[kVec] = {false, false, false, false};
    if (kVecIO) {
      if (i0 < a.n) {  // n % 4 == 0: all four points exist
        const int4 cv = *reinterpret_cast<const int4*>(a.cell + i0);
        const uint32_t vw = *reinterpret_cast<const uint32_t*>(a.valid + i0);
        c[0] = cv.x;
        c[1] = cv.y;
        c[2] = cv.z;
        c[3] = cv.w;
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[k] = ((vw >> (8 * k)) & 0xffu) != 0;
        if (a.mode == kModePoint) {
          const float4 xv = *reinterpret_cast<const float4*>(a.x + i0);
          const float4 yv = *reinterpret_cast<const float4*>(a.y + i0);
          x[0] = xv.x;
          x[1] = xv.y;
          x[2] = xv.z;
          x[3] = xv.w;
          y[0] = yv.x;
          y[1] = yv.y;
          y[2] = yv.z;
          y[3] = yv.w;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int i = i0 + k;
        if (i < a.n) {
          c[k] = a.cell[i];
          v[k] = a.valid[i] != 0;
          if (a.mode == kModePoint) {
            x[k] = a.x[i];
            y[k] = a.y[i];
          }
        }
      }
    }
    if (a.mode == kModePoint) {
      point_rows<kVecIO, kTile>(a, s_q, s_cnt, i0, x, y, c, v);
    } else {
      mask_rows<kVecIO, kStaged, kTile>(a, s_cnt, s_codes, i0, c, v);
    }
  }

  __syncthreads();  // the block's counters into the counts
  for (int t = threadIdx.x; t < 2 * a.q; t += kBlock) {
    if (s_cnt[t]) atomicAdd(&a.counts[t], s_cnt[t]);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The largest f32 d2 whose correctly rounded square root is <= radius
// (-1 when none is: a negative or NaN radius). sqrtf is monotone, so for
// every f32 d2, sqrtf(d2) <= radius exactly when d2 <= this limit; the
// kernel then takes a square root only where it writes a distance. The
// host's sqrtf is IEEE (correctly rounded), as the kernel's and PyTorch's.
float d2_limit(float radius) {
  uint32_t lo = 0, hi = 0x7f800000u;  // +0 .. +inf
  const auto ok = [radius](uint32_t b) {
    float f;
    memcpy(&f, &b, sizeof f);
    return sqrtf(f) <= radius;
  };
  if (!ok(lo)) return -1.0f;
  while (lo < hi) {  // ok(lo) holds; find the last b with ok(b)
    const uint32_t mid = lo + (hi - lo + 1) / 2;
    if (ok(mid)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  float f;
  memcpy(&f, &lo, sizeof f);
  return f;
}

// One resident wave: blocks = SMs x resident blocks per SM (a grid-stride
// loop covers the rest).
template <int kBlock, bool kVecIO, bool kStaged, int kTile>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t s) {
  const auto kernel = range_mask_kernel<kBlock, kVecIO, kStaged, kTile>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, smem);
  }
  if (err != cudaSuccess) return err;
  const int groups = (a.n + kVec - 1) / kVec;
  const int blocks = max(1, min((groups + kBlock - 1) / kBlock,
                                max(1, sms * per_sm)));
  kernel<<<blocks, kBlock, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// num_queries = Q rows. mode 0 (point query): reads x, y, cell, valid and
// the query points/layers — (qx, qy, q_cell) by value when qxs is null
// (Q = 1), else qxs, qys (Q,) f32 and q_cells (Q,) int32 — and writes mask
// (Q, n) bool and, unless dists_out is null (always null for Q > 1),
// dists_out (Q, n) f32. mode 1 (dense cell masks): reads cell, valid,
// gn_mask/cn_mask (Q, num_cells) bool and dists_in (Q, n) f32, writes
// mask. counts (Q, 2) int32 = [gn_bypassed, dist_evals] per query is
// zeroed (memset) and summed. Does not synchronise; returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int range_mask_stats_launch(
    int mode, int approximate, int n, int num_queries, const float* x,
    const float* y, const int32_t* cell, const uint8_t* valid, float qx,
    float qy, int q_cell, const float* qxs, const float* qys,
    const int32_t* q_cells, int grid_n, int gn_layers, int cn_layers,
    const uint8_t* gn_mask, const uint8_t* cn_mask, const float* dists_in,
    int num_cells, float radius, uint8_t* mask_out, float* dists_out,
    int32_t* counts, void* stream) {
  if (num_queries <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{mode,      approximate, n,         num_queries, x,
               y,         cell,        valid,     qx,          qy,
               q_cell,    qxs,         qys,       q_cells,     grid_n,
               gn_layers, cn_layers,   gn_mask,   cn_mask,     dists_in,
               num_cells, radius,      d2_limit(radius),       mask_out,
               dists_out, counts};
  size_t smem =
      (mode == kModePoint ? sizeof(int4) * num_queries : 0) +
      sizeof(int) * 2 * static_cast<size_t>(num_queries);
  const size_t codes = sizeof(uint32_t) * static_cast<size_t>(num_cells) *
                       ((num_queries + 15) / 16);
  const bool staged = mode != kModePoint &&
                      num_queries >= kStagedMinQueries &&
                      smem + codes <= kStagedSmem;
  const bool vec = n % kVec == 0 && aligned(x, 16) && aligned(y, 16) &&
                   aligned(cell, 16) && aligned(valid, 4) &&
                   aligned(mask_out, 4) && aligned(dists_in, 16) &&
                   aligned(dists_out, 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, sizeof(int32_t) * 2 * static_cast<size_t>(num_queries), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool tiled = num_queries >= kQueryTile;
  static_assert(kStagedMinQueries >= kQueryTile,
                "the staged form runs only tiled");
  if (staged) {
    smem += codes;
    err = vec ? launch<kStagedThreads, true, true, kQueryTile>(a, smem, s)
              : launch<kStagedThreads, false, true, kQueryTile>(a, smem, s);
  } else if (tiled) {
    err = vec ? launch<kThreads, true, false, kQueryTile>(a, smem, s)
              : launch<kThreads, false, false, kQueryTile>(a, smem, s);
  } else {
    err = vec ? launch<kThreads, true, false, 1>(a, smem, s)
              : launch<kThreads, false, false, 1>(a, smem, s);
  }
  return static_cast<int>(err);
}
