// Grouped f64 sums over packed group ids, for sm_90a (H100).
//
// Replaces the Pallas TPU kernel trino_tpu/ops/pallas_groupby.py
// (`_kernel` / `_grouped_sums_impl`, the one pl.pallas_call, reached through
// `grouped_sums`): for each of K f64 lanes, the per-group sum over rows whose
// int32 group id lies in [0, nseg), nseg <= 64. Rows with any other id
// contribute nothing. Counts are 0/1 lanes and come out exact.
//
// Bound on this card: bytes. The function reads K f64 lanes and one int32
// id lane once and writes K*nseg doubles: for TPC-H q1's splits (K = 19,
// 2^17-2^18 rows) 20-41 MB, 0.006-0.012 ms at the H100 SXM's 3.35 TB/s. The
// adds are K*cap f64 operations, far below the FP64 rate.
//
// Design:
// - The lanes arrive as one [K, ld] f64 buffer (ld even, so every row
//   starts 16-byte aligned), as the TPU kernel takes vals [K8, cap]: a base
//   pointer and a row stride, no pointer array, no limit on K.
// - One launch a call. A block owns tiles of kTile rows. It loads a tile's
//   ids once, with 16-byte int4 loads, into shared memory. Its warps take
//   the K lanes in turn (lane k to warp k % 8), a quarter tile at a time,
//   each thread reading 8 rows with 16-byte double2 loads; a warp keeps
//   kDepth quarters in flight, loading the next as it sums one.
// - Each thread adds its rows into nseg accumulators of its own in shared
//   memory (hist[warp][group][thread], so the warp's adds never share a
//   bank and never race): an add a row, whatever nseg, where a compare
//   against every group would cost nseg. When a lane's tile is summed,
//   thread j adds group j's 32 accumulators in a fixed order into the
//   block's [K, nseg] partial and the warp zeroes its accumulators.
// - The layout is a function of (cap, K, nseg) alone and this file owns it
//   (grouped_sums_scratch_rows): ceil(cap / kTile) tiles over
//   min(tiles, kMaxBlocks) blocks, block b taking tiles b, b + P, ...; a
//   call whose rows fit one tile (a fold of partials) is one block that
//   writes `out` itself. The call's one allocation holds the [K, nseg]
//   result, then the blocks' partials, the groups' sums and the tickets.
// - The blocks' partials reduce in the same launch, in a fixed order: the
//   last block of each group of kGroup blocks to draw an integer ticket
//   (atomicAdd after a __threadfence) sums the group's partials in block
//   order; the last group to finish sums the group sums in group order.
//   The tickets live in the call's own allocation and are zeroed by a
//   cudaMemsetAsync before the launch (a memset node under graph capture),
//   so no two calls, streams or graph replays share one, and a launch that
//   died midway leaves nothing behind.
//
// Determinism: no floating-point atomics. The sum order depends only on
// cap, so two launches on the same input give bit-identical results (the
// result cache and the ragged batcher promise rows identical to solo runs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4 * kThreads;    // rows per tile: one int4 of ids a thread
constexpr int kQuarter = kTile / 4;    // rows of one item (a lane's quarter tile)
constexpr int kLoads = kQuarter / 64;  // double2 loads a thread, per item
constexpr int kDepth = 4;              // items in flight a warp
constexpr int kMaxBlocks = 264;        // two blocks on each of 132 SMs
constexpr int kGroup = 16;             // blocks whose partials one block sums
constexpr int kMaxGroups = (kMaxBlocks + kGroup - 1) / kGroup;

// A call's layout: its blocks, its groups of blocks, and the doubles of its
// one allocation ([K, nseg] result; past one block, P partials, G group
// sums and 1 + G uint32 tickets).
struct Layout {
  long long blocks, groups, doubles;
};

Layout layout_of(long long cap, long long K, long long nseg) {
  const long long ntiles = (cap + kTile - 1) / kTile;
  const long long P = ntiles < kMaxBlocks ? ntiles : kMaxBlocks;
  const long long M = K * nseg;
  if (P <= 1) return {1, 0, M};
  const long long G = (P + kGroup - 1) / kGroup;
  return {P, G, (1 + P + G) * M + (1 + G + 1) / 2};
}

__device__ __forceinline__ void load_item(double2 (&x)[kLoads],
                                          const double* __restrict__ v,
                                          long long row0, long long cap,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const long long row = row0 + i * 64 + 2 * lane;
    // row + 1 may be the pad column at cap (ld >= cap rounded up to
    // even), whose id is -1: loaded, never summed
    x[i] = row < cap ? __ldg(reinterpret_cast<const double2*>(v + row))
                     : make_double2(0.0, 0.0);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
grouped_sums_kernel(const int32_t* __restrict__ gid,
                    const double* __restrict__ vals, long long ld,
                    long long cap, int K, int nseg,
                    double* __restrict__ out,
                    unsigned int* __restrict__ tickets) {
  __shared__ __align__(16) int32_t sid[kTile];
  __shared__ bool last;
  // per warp, per thread, nseg accumulators: hist[warp][j][lane]
  extern __shared__ double hist[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int P = gridDim.x;
  const long long M = (long long)K * nseg;
  const long long ntiles = (cap + kTile - 1) / kTile;
  double* scratch = out + M;  // the blocks' partials, then the group sums
  double* mine = P == 1 ? out : scratch + blockIdx.x * M;
  double* h = hist + warp * nseg * 32;
  // the lanes k = warp, warp + kWarps, ... are this warp's; an item is
  // one lane's quarter tile, item n = lane n / 4, quarter n % 4
  const int nitems = warp < K ? (K - warp + kWarps - 1) / kWarps * 4 : 0;
  for (int j = 0; j < nseg; ++j) h[j * 32 + lane] = 0.0;

  bool first = true;
  for (long long t = blockIdx.x; t < ntiles; t += P) {
    const long long base = t * kTile;
    __syncthreads();  // every warp is done with the last tile's ids
    // kDepth items in flight (the first issued before the ids arrive):
    // item n + kDepth is loaded once item n is summed
    double2 x[kDepth][kLoads];
#pragma unroll
    for (int d = 0; d < kDepth; ++d)
      if (d < nitems)
        load_item(x[d], vals + (warp + kWarps * (d / 4)) * ld,
                  base + (d % 4) * kQuarter, cap, lane);
    {
      const long long r = base + 4 * threadIdx.x;
      int4 g;
      if (r + 4 <= cap) {
        g = __ldg(reinterpret_cast<const int4*>(gid + r));
      } else {
        g.x = r < cap ? gid[r] : -1;
        g.y = r + 1 < cap ? gid[r + 1] : -1;
        g.z = r + 2 < cap ? gid[r + 2] : -1;
        g.w = r + 3 < cap ? gid[r + 3] : -1;
      }
      reinterpret_cast<int4*>(sid)[threadIdx.x] = g;
    }
    __syncthreads();
    for (int n0 = 0; n0 < nitems; n0 += kDepth) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int n = n0 + d;
        const int k = warp + kWarps * (n / 4);
        const int q0 = (n % 4) * kQuarter;
        if (base + q0 < cap) {
          // every thread adds its rows into its own accumulators
#pragma unroll
          for (int i = 0; i < kLoads; ++i) {
            const int2 g = reinterpret_cast<const int2*>(
                sid)[(q0 + i * 64) / 2 + lane];
            if ((unsigned)g.x < (unsigned)nseg)
              h[g.x * 32 + lane] += x[d][i].x;
            if ((unsigned)g.y < (unsigned)nseg)
              h[g.y * 32 + lane] += x[d][i].y;
          }
        }
        const int next = n + kDepth;
        if (next < nitems)
          load_item(x[d], vals + (warp + kWarps * (next / 4)) * ld,
                    base + (next % 4) * kQuarter, cap, lane);
        if (n % 4 == 3) {
          // lane k of this tile is summed: thread j adds group j's 32
          // accumulators in a fixed order (four runs of 8, each rotated by
          // j, so that the warp's reads fall in distinct banks) into the
          // block's partial
          __syncwarp();
          for (int j = lane; j < nseg; j += 32) {
            double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
            for (int u = 0; u < 32; ++u)
              s[u / 8] += h[j * 32 + ((u + j) & 31)];
            const double sum = (s[0] + s[1]) + (s[2] + s[3]);
            double* o = mine + k * nseg + j;
            *o = first ? sum : *o + sum;
          }
          __syncwarp();
          for (int j = 0; j < nseg; ++j) h[j * 32 + lane] = 0.0;
          __syncwarp();
        }
      }
    }
    first = false;
  }
  if (P == 1) return;

  // the last block of this group sums the group's partials in block order
  const int q = blockIdx.x / kGroup;
  const int q0 = q * kGroup;
  const int qn = min(kGroup, P - q0);
  const int ngroups = (P + kGroup - 1) / kGroup;
  double* gsum = scratch + (long long)P * M;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[1 + q], 1u) == qn - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double* dst = ngroups == 1 ? out : gsum + q * M;
  for (long long m = threadIdx.x; m < M; m += kThreads) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i < qn) s += __ldcg(scratch + (q0 + i) * M + m);
    dst[m] = s;
  }
  if (ngroups == 1) return;

  // the last group to finish sums the group sums in group order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[0], 1u) == ngroups - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (long long m = threadIdx.x; m < M; m += kThreads) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < kMaxGroups; ++i)
      if (i < ngroups) s += __ldcg(gsum + i * M + m);
    out[m] = s;
  }
}

}  // namespace

extern "C" {

// Rows of nseg doubles in the one allocation a call of cap rows and K lanes
// takes (see Layout).
long long grouped_sums_scratch_rows(long long cap, int K, int nseg) {
  return (layout_of(cap, K, nseg).doubles + nseg - 1) / nseg;
}

// gid: int32 [cap], 16-byte aligned; vals: f64 [K, ld] rows, 16-byte
// aligned, ld even and >= cap; buf: f64 [rows, nseg], rows at least
// grouped_sums_scratch_rows(cap, K, nseg), the result in its first K rows.
// Zeroes the call's tickets (past one block) and launches the kernel, on
// `stream`. Returns cudaGetLastError().
int grouped_sums_launch(const void* gid, const void* vals, long long ld,
                        long long cap, int K, int nseg, void* buf,
                        long long rows, void* stream) {
  if (K < 1 || nseg < 1 || nseg > 64 || cap < 1 || ld < cap || ld % 2 ||
      reinterpret_cast<uintptr_t>(gid) % 16 ||
      reinterpret_cast<uintptr_t>(vals) % 16 ||
      reinterpret_cast<uintptr_t>(buf) % 8)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(cap, K, nseg);
  if (rows * nseg < L.doubles) return (int)cudaErrorInvalidValue;
  double* o = static_cast<double*>(buf);
  const long long M = (long long)K * nseg;
  unsigned int* t = reinterpret_cast<unsigned int*>(
      o + (1 + L.blocks + L.groups) * M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L.blocks > 1) {
    const cudaError_t e =
        cudaMemsetAsync(t, 0, sizeof(unsigned int) * (1 + L.groups), s);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem = sizeof(double) * kWarps * 32 * nseg;
  if (smem + sizeof(int32_t) * kTile + 16 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        grouped_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  grouped_sums_kernel<<<(int)L.blocks, kThreads, smem, s>>>(
      static_cast<const int32_t*>(gid), static_cast<const double*>(vals), ld,
      cap, K, nseg, o, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
