// K1: range-query mask and pruning counts over one window batch, in one
// grid-stride pass.
//
// Replaces the XLA-fused range kernels of spatialflink_tpu/ops/range.py:
// range_filter_point_stats (:72-96, point query, Chebyshev layers) and
// range_filter_masks_stats (:196-217, dense GN/CN cell masks plus
// precomputed distances). One kernel serves both through `mode`. Plain
// PyTorch versions: spatialflink_tpu_torch/ops/range.py, whose operation
// order this file follows step for step.
//
// Query axis: blockIdx.y = query. The Q-row forms
// (range_filter_point_multi_masks, :136, and the vmapped
// range_filter_masks_stats of ops/geom.py range_points_to_geom_queries,
// :236) run all Q queries in one launch; row q reads query q's point and
// layers (point mode) or its cell masks and distance row (mask mode) and
// writes mask row q and counts[2q:2q+2]. The arithmetic of a row is that of
// the single-query launch, so each row equals it bit for bit.
//
// What bounds it on an H100: bytes. Per point it reads x, y, cell and valid
// (13 bytes; the mask mode reads cell, valid and a distance, 9 bytes, plus
// two L2-resident n*n cell-mask gathers) and writes a bool mask (and, in
// point mode, a distance: 5 bytes), against ~15 operations.
//
// What the design does about it: one pass, each input read once with
// neighbouring threads on neighbouring addresses; GN/CN membership is index
// arithmetic (point mode) or one byte gather (mask mode), never a
// materialised mask; the two counts are summed in registers, reduced per
// block with warp shuffles, and added with one atomicAdd per block and
// counter (integer sums are exact in any order).
//
// Built with --fmad=false (no FMA contraction), so the point-mode distance
// rounds exactly as the plain version's separate PyTorch ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs
constexpr int kModePoint = 0;
constexpr int kNoLayer = 1 << 30;  // uniform_grid.cheb_layers sentinel

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
range_mask_kernel(int mode, int approximate, int n,
                  const float* __restrict__ x, const float* __restrict__ y,
                  const int32_t* __restrict__ cell,
                  const uint8_t* __restrict__ valid, float qx, float qy,
                  int q_cell, const float* __restrict__ qxs,
                  const float* __restrict__ qys,
                  const int32_t* __restrict__ q_cells, int grid_n,
                  int gn_layers, int cn_layers,
                  const uint8_t* __restrict__ gn_mask,
                  const uint8_t* __restrict__ cn_mask,
                  const float* __restrict__ dists_in, int num_cells,
                  float radius, uint8_t* __restrict__ mask_out,
                  float* __restrict__ dists_out, int32_t* __restrict__ counts) {
  // row q of the query axis (q = 0 for a single query given by value)
  const int q = blockIdx.y;
  const size_t row = static_cast<size_t>(q) * n;
  if (qxs != nullptr) {
    qx = qxs[q];
    qy = qys[q];
    q_cell = q_cells[q];
  }
  mask_out += row;
  counts += 2 * q;
  if (mode == kModePoint) {
    if (dists_out != nullptr) dists_out += row;
  } else {
    gn_mask += static_cast<size_t>(q) * num_cells;
    cn_mask += static_cast<size_t>(q) * num_cells;
    dists_in += row;
  }
  int gn_count = 0;
  int eval_count = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int c = cell[i];
    const bool v = valid[i] != 0;
    bool in_gn, in_cn, keep;
    if (mode == kModePoint) {
      int layers = kNoLayer;
      if (c >= 0 && q_cell >= 0) {
        const int ax = c / grid_n, ay = c % grid_n;
        const int bx = q_cell / grid_n, by = q_cell % grid_n;
        layers = max(abs(ax - bx), abs(ay - by));
      }
      in_gn = layers <= gn_layers;  // gn_layers == -1: no GN cells
      in_cn = (layers <= cn_layers) && !in_gn;
      if (approximate) {
        keep = in_gn || in_cn;
        if (dists_out != nullptr) dists_out[i] = INFINITY;
      } else {
        const float dx = qx - x[i];
        const float dy = qy - y[i];
        const float d = sqrtf(dx * dx + dy * dy);
        keep = in_gn || (in_cn && d <= radius);
        if (dists_out != nullptr) dists_out[i] = in_cn ? d : INFINITY;
      }
    } else {
      // the cell >= 0 guard: a -1 pad must never index the masks
      const bool ok = c >= 0 && c < num_cells;
      in_gn = ok && gn_mask[c] != 0;
      in_cn = ok && cn_mask[c] != 0 && !in_gn;
      keep = in_gn || (in_cn && (approximate || dists_in[i] <= radius));
    }
    mask_out[i] = (v && keep) ? 1 : 0;
    gn_count += (v && in_gn) ? 1 : 0;
    eval_count += (!approximate && v && in_cn) ? 1 : 0;
  }

  __shared__ int s_gn[kThreads / 32];
  __shared__ int s_eval[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  gn_count = warp_sum(gn_count);
  eval_count = warp_sum(eval_count);
  if (lane == 0) {
    s_gn[warp] = gn_count;
    s_eval[warp] = eval_count;
  }
  __syncthreads();
  if (warp == 0) {
    gn_count = lane < kThreads / 32 ? s_gn[lane] : 0;
    eval_count = lane < kThreads / 32 ? s_eval[lane] : 0;
    gn_count = warp_sum(gn_count);
    eval_count = warp_sum(eval_count);
    if (lane == 0) {
      if (gn_count) atomicAdd(&counts[0], gn_count);
      if (eval_count) atomicAdd(&counts[1], eval_count);
    }
  }
}

}  // namespace

// num_queries = Q rows. mode 0 (point query): reads x, y, cell, valid and
// the query points/layers — (qx, qy, q_cell) by value when qxs is null
// (Q = 1), else qxs, qys (Q,) f32 and q_cells (Q,) int32 — and writes mask
// (Q, n) bool and, unless dists_out is null, dists_out (Q, n) f32. mode 1 (dense cell masks): reads
// cell, valid, gn_mask/cn_mask (Q, num_cells) bool and dists_in (Q, n) f32,
// writes mask. counts (Q, 2) int32 = [gn_bypassed, dist_evals] per query is
// zeroed here on `stream` before the kernel runs. Does not synchronise;
// returns cudaGetLastError() (0 when both the memset and the launch were
// accepted).
extern "C" int range_mask_stats_launch(
    int mode, int approximate, int n, int num_queries, const float* x,
    const float* y, const int32_t* cell, const uint8_t* valid, float qx,
    float qy, int q_cell, const float* qxs, const float* qys,
    const int32_t* q_cells, int grid_n, int gn_layers, int cn_layers,
    const uint8_t* gn_mask, const uint8_t* cn_mask, const float* dists_in,
    int num_cells, float radius, uint8_t* mask_out, float* dists_out,
    int32_t* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, 2 * sizeof(int32_t) * static_cast<size_t>(num_queries), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && num_queries > 0) {
    // about kMaxBlocks resident blocks in all, shared by the Q rows
    const int per_row = max(1, kMaxBlocks / num_queries);
    const dim3 grid(min((n + kThreads - 1) / kThreads, per_row),
                    num_queries);
    range_mask_kernel<<<grid, kThreads, 0, s>>>(
        mode, approximate, n, x, y, cell, valid, qx, qy, q_cell, qxs, qys,
        q_cells, grid_n, gn_layers, cn_layers, gn_mask, cn_mask, dists_in,
        num_cells, radius, mask_out, dists_out, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
