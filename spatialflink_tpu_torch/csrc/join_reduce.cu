// K7: per-left-point join reduction against a whole right batch: for each
// a point, the count of b partners, the least squared distance among them
// and its b index.
//
// Replaces join_reduce / _join_reduce_impl
// (spatialflink_tpu/ops/pallas_kernels.py:248-309), an XLA lax.scan over
// b tiles of 4,096 that holds an (Na, tile) block per step. Plain PyTorch
// version: spatialflink_tpu_torch/ops/join.py join_reduce_plain, whose
// arithmetic this file follows step for step. A pair is a hit when both
// points are valid, max(|acx - bcx|, |acy - bcy|) <= layers over
// (cx, cy) = (cell // n, cell % n) with floor division and no sentinel for
// a cell of -1 (the scan's own cell test, unlike cheb_layers), and the
// uncentred d2 = dx*dx + dy*dy <= r2. Outputs per a point: the hit count,
// the least hit d2 (3.4e38 without a hit) and its b index (-1 without
// one). The scan keeps the earliest tile on ties (strict <) and argmin the
// earliest index within a tile, so the index is the smallest b index among
// equal minima: here each thread walks b in ascending order and replaces
// its minimum only on a strictly smaller d2, which gives the same index.
//
// What bounds it on an H100: operations. Every (a, b) pair costs the cell
// test (~7 integer operations); the ~1 in 1,000 pairs inside the cell
// layers at the join's radius add the distance and the running min (9).
// At 262,144 x 8,192 that is ~15 G operations (~0.2 ms at 67 TFLOP/s)
// against 2.6 MB read and 3 MB written (~2 us at 3.35 TB/s).
//
// Design: one thread per a point, its count, minimum and index kept in
// registers for the whole b batch; a block of 256 a points stages the b
// batch through shared memory in chunks of kStage points (x, y and the
// cell's (cx, cy), with an invalid b point's cx moved far outside any
// layer bound), and all threads of a warp read the same b point at the
// same time (a shared-memory broadcast). Nothing of size (Na, tile) is
// ever written. Built with --fmad=false so that dx*dx + dy*dy is not
// contracted into an FMA: each operation rounds once, exactly as the plain
// version's separate PyTorch ops do, and the outputs equal the plain
// version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 2048;  // b points per shared-memory chunk (32 KB)
constexpr float kBig = 3.4e38f;
// cx of an invalid b point: farther than any layer bound the wrapper
// passes can reach from a cx in [-1, 2^15) (layers are clamped below)
constexpr int kFar = 3 << 29;
constexpr int kMaxLayers = 1 << 29;

__device__ __forceinline__ int floor_div(int a, int n) {
  int q = a / n;
  if ((a % n != 0) && ((a < 0) != (n < 0))) --q;
  return q;
}

__global__ void __launch_bounds__(kThreads)
join_reduce_kernel(const float* __restrict__ ax, const float* __restrict__ ay,
                   const int32_t* __restrict__ acell,
                   const uint8_t* __restrict__ avalid, int na,
                   const float* __restrict__ bx, const float* __restrict__ by,
                   const int32_t* __restrict__ bcell,
                   const uint8_t* __restrict__ bvalid, int nb, float r2,
                   int layers, int n, int32_t* __restrict__ cnt_out,
                   float* __restrict__ mind2_out,
                   int32_t* __restrict__ amin_out) {
  __shared__ float2 s_xy[kStage];
  __shared__ int2 s_cell[kStage];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < na && avalid[i] != 0;
  float x = 0.0f, y = 0.0f;
  int cx = 0, cy = 0;
  if (live) {
    x = ax[i];
    y = ay[i];
    const int c = acell[i];
    cx = floor_div(c, n);
    cy = c - cx * n;
  }
  int cnt = 0;
  float best = kBig;
  int arg = -1;
  for (int base = 0; base < nb; base += kStage) {
    const int m = min(kStage, nb - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += kThreads) {
      const int j = base + k;
      const int c = bcell[j];
      const int q = floor_div(c, n);
      s_xy[k] = make_float2(bx[j], by[j]);
      s_cell[k] = make_int2(bvalid[j] != 0 ? q : kFar, c - q * n);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const int2 bc = s_cell[k];
      if (abs(cx - bc.x) > layers || abs(cy - bc.y) > layers) continue;
      const float2 b = s_xy[k];
      const float dx = x - b.x;
      const float dy = y - b.y;
      const float d2 = dx * dx + dy * dy;
      if (d2 <= r2) {
        ++cnt;
        if (d2 < best) {
          best = d2;
          arg = base + k;
        }
      }
    }
  }
  if (i < na) {
    cnt_out[i] = cnt;
    mind2_out[i] = best;
    amin_out[i] = arg;
  }
}

}  // namespace

// a*, b*: (na,) / (nb,) x, y f32, cell int32, valid bool of the two point
// batches; r2 = r * r in f32; layers the cell-layer bound (>= 0; clamped
// here, which keeps every cell test of cells inside an n x n grid the
// same); n the grid's cells per side. Writes cnt (na,) int32, mind2 (na,)
// f32 and amin (na,) int32. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int join_reduce_launch(const float* ax, const float* ay,
                                  const int32_t* acell, const uint8_t* avalid,
                                  int na, const float* bx, const float* by,
                                  const int32_t* bcell, const uint8_t* bvalid,
                                  int nb, float r2, int layers, int n,
                                  int32_t* cnt, float* mind2, int32_t* amin,
                                  void* stream) {
  if (n < 1 || n >= (1 << 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layers > kMaxLayers) layers = kMaxLayers;
  if (na > 0) {
    const int blocks = (na + kThreads - 1) / kThreads;
    join_reduce_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        ax, ay, acell, avalid, na, bx, by, bcell, bvalid, nb, r2, layers, n,
        cnt, mind2, amin);
  }
  return static_cast<int>(cudaGetLastError());
}
