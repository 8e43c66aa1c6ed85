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
// a cell of -1 (the scan's own cell test, unlike cheb_layers: a cell of -1
// is (-1, n - 1)), and the uncentred d2 = dx*dx + dy*dy <= r2. Outputs per
// a point: the hit count, the least hit d2 (3.4e38 without a hit) and its
// b index (-1 without one), the smallest b index among equal minima (the
// scan keeps the earliest tile on ties and argmin the earliest index
// within one).
//
// The walk: b comes as the window's join index (join_walk.cuh: sorted by
// (b tile, bucket), built once per window by cell_order.cu and shared with
// K6). One thread per a point visits, in each tile's section, the 2L + 1
// runs of the grid's cells within the layers of its cell (grid_runs; no
// cell test inside them; their ends from the index's start table, or by
// binary search above its cap), then the bucket of cells < 0 when
// acx - L <= -1 and the bucket of cells >= n * n when acx + L >= n, each
// pair of those two with the cell test above. Invalid b points sit in a
// bucket of their own that no walk visits. The runs do not come in b order, so the running
// minimum replaces on d2 < best, or on d2 == best at a smaller b index:
// the plain version's index. A layer bound of L >= n visits every run;
// layers are clamped to 2^29, which keeps every cell test of cells within
// [-2^30, 2^30) the same.
//
// What bounds it on an H100: bytes and latency. The work is the distance
// and the running min (9 operations) on the pairs inside the cell layers
// (~2.7 M of 2.1 G at option 101's window of 262,144 x 8,192, radius
// 0.002) and 2 (2L + 1) start-table loads per a point and tile (binary
// searches of ~12 steps each without the table), against (na + nb) x 13
// bytes read, the index's 16 bytes per b point and na x 12 written (~7 MB,
// ~2 us at 3.35 TB/s). Those loads are scattered: an a point's cell is
// random within its warp.
// Built with --fmad=false so that dx*dx + dy*dy is not contracted into an
// FMA: each operation rounds once, exactly as the plain version's separate
// PyTorch ops do, and the outputs equal the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "join_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.4e38f;
constexpr int kMaxLayers = 1 << 29;

__device__ __forceinline__ int floor_div(int a, int n) {
  int q = a / n;
  if ((a % n != 0) && ((a < 0) != (n < 0))) --q;
  return q;
}

struct Args {
  const float* ax;
  const float* ay;
  const int32_t* acell;
  const uint8_t* avalid;
  int na;
  const int32_t* bcell;  // original b order (the per-pair tested buckets)
  int nb;
  const int32_t* perm;   // the join index
  const int32_t* key;
  const int32_t* starts;  // nullptr: no start table
  const float* sx;
  const float* sy;
  int tile;
  int stride;
  float r2;
  int layers;
  int n;
};

__global__ void __launch_bounds__(kThreads)
join_reduce_kernel(Args p, int32_t* __restrict__ cnt_out,
                   float* __restrict__ mind2_out,
                   int32_t* __restrict__ amin_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.na) return;
  int cnt = 0;
  float best = kBig;
  int arg = -1;
  if (p.avalid[i] != 0) {
    const float x = p.ax[i];
    const float y = p.ay[i];
    const int c = p.acell[i];
    const int acx = floor_div(c, p.n);
    const int acy = c - acx * p.n;
    const int layers = p.layers;
    const int cells = p.n * p.n;
    auto visit = [&](int k) {
      const float dx = x - __ldg(p.sx + k);
      const float dy = y - __ldg(p.sy + k);
      const float d2 = dx * dx + dy * dy;
      if (d2 <= p.r2) {
        ++cnt;
        if (d2 <= best) {
          const int j = __ldg(p.perm + k);
          if (d2 < best || j < arg) {
            best = d2;
            arg = j;
          }
        }
      }
    };
    auto tested = [&](int2 run) {
      for (int k = run.x; k < run.y; ++k) {
        const int bc = __ldg(p.bcell + __ldg(p.perm + k));
        const int q = floor_div(bc, p.n);
        if (abs(acx - q) <= layers && abs(acy - (bc - q * p.n)) <= layers) {
          visit(k);
        }
      }
    };
    const bool neg = static_cast<long long>(acx) - layers <= -1;
    const bool high = static_cast<long long>(acx) + layers >= p.n;
    for (int lo = 0, t = 0; lo < p.nb; lo += p.tile, ++t) {
      const join_walk::Section sec{p.key, p.starts, lo,
                                   min(p.nb, lo + p.tile), t * p.stride};
      join_walk::grid_runs(sec, acx, acy, layers, p.n, [&](int s, int e) {
        for (int k = s; k < e; ++k) visit(k);
      });
      if (neg) tested(join_walk::bucket_run(sec, join_walk::kNegBucket));
      if (high) {
        tested(join_walk::bucket_run(sec, join_walk::high_bucket(cells)));
      }
    }
  }
  cnt_out[i] = cnt;
  mind2_out[i] = best;
  amin_out[i] = arg;
}

}  // namespace

// a*: (na,) x, y f32, cell int32, valid bool of the a batch; bcell: (nb,)
// int32, the b batch's cells in their own order; perm, key, sx, sy: (nb,)
// the window's join index of b (join_walk.cuh) with its start table
// (nullptr: none), tile and stride;
// r2 = r * r in f32; layers the cell-layer bound (clamped here to 2^29;
// below 0 admits nothing); n the grid's cells per side. Writes cnt (na,)
// int32, mind2 (na,) f32 and amin (na,) int32. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int join_reduce_launch(const float* ax, const float* ay,
                                  const int32_t* acell, const uint8_t* avalid,
                                  int na, const int32_t* bcell, int nb,
                                  const int32_t* perm, const int32_t* key,
                                  const int32_t* starts, const float* sx,
                                  const float* sy, int tile, int stride,
                                  float r2, int layers, int n, int32_t* cnt,
                                  float* mind2, int32_t* amin, void* stream) {
  if (n < 1 || n >= (1 << 15) || tile < 1 || stride < 0 || na < 0 ||
      nb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layers > kMaxLayers) layers = kMaxLayers;
  const Args p{ax, ay, acell, avalid, na, bcell, nb, perm, key, starts,
               sx, sy, tile, stride, r2, layers, n};
  if (na > 0) {
    const int blocks = (na + kThreads - 1) / kThreads;
    join_reduce_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, cnt, mind2,
                                                              amin);
  }
  return static_cast<int>(cudaGetLastError());
}
