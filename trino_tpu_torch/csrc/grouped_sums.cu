// Grouped f64 sums over packed group ids, for sm_90a (H100).
//
// Replaces the Pallas TPU kernel trino_tpu/ops/pallas_groupby.py
// (`_kernel` / `_grouped_sums_impl`, the one pl.pallas_call, reached through
// `grouped_sums`): for each of K f64 lanes, the per-group sum over rows whose
// int32 group id lies in [0, nseg). Rows with any other id contribute
// nothing. Counts are 0/1 lanes and come out exact.
//
// Bound on this card: bytes. The function reads K f64 lanes and one int32
// id lane once and writes K*nseg doubles, so for TPC-H q1 at sf10
// (K = 19, cap = 2^26) it moves 19 * 2^26 * 8 + 2^26 * 4 ~= 10.5 GB, about
// 3.1 ms at the H100 SXM's 3.35 TB/s. The adds are K*cap f64 operations,
// far below the FP64 rate.
//
// What the design does about that bound:
// - Hopper has native FP64, so each lane is read once as f64. The TPU
//   kernel's split of each f64 lane into three f32 digit lanes (the MXU has
//   no f64) is gone: 8 bytes a row per lane instead of 12.
// - The grid is (lane, row chunk), lane fastest, so the K blocks that share a
//   row chunk run together and the id chunk is re-read from L2, not from
//   device memory.
// - Each thread keeps G >= nseg f64 accumulators in registers and adds each of
//   its rows by an unrolled compare-select on the id: no shared-memory
//   histogram, no atomics.
//
// Determinism: there are no floating-point atomics. Within a block the
// accumulators reduce by a fixed warp-shuffle tree and then over warps in
// index order; a second pass sums the per-block partials [P, K, nseg] in
// block-index order. The partition depends only on cap, so two launches on
// the same input give bit-identical results (the result cache and the ragged
// batcher promise rows identical to solo runs).
//
// Later work, not done here: read the id lane once for all lanes, one-hot
// products on the FP64 tensor cores, TMA loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 64;   // lanes per launch (the kernel parameter)
constexpr int kThreads = 256;   // threads per block
constexpr int kWarps = kThreads / 32;

struct LanePtrs {
  const double* p[kMaxLanes];
};

template <int G>
__global__ void __launch_bounds__(kThreads)
grouped_sums_partial(const int32_t* __restrict__ gid, LanePtrs lanes,
                     long long cap, long long chunk, int nseg,
                     double* __restrict__ partial) {
  const int k = blockIdx.x;             // lane
  const long long b = blockIdx.y;       // row chunk
  const int K = gridDim.x;
  const double* __restrict__ v = lanes.p[k];

  double acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.0;

  const long long lo = b * chunk;
  const long long hi = lo + chunk < cap ? lo + chunk : cap;
#pragma unroll 4
  for (long long r = lo + threadIdx.x; r < hi; r += kThreads) {
    const int g = __ldg(gid + r);
    const double x = __ldg(v + r);
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] += (g == j) ? x : 0.0;
  }

  __shared__ double red[kWarps][G];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    double s = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < nseg) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partial[(b * K + k) * nseg + threadIdx.x] = s;
  }
}

// out[k, j] = sum over blocks b, in order, of partial[b, k, j].
__global__ void grouped_sums_finish(const double* __restrict__ partial,
                                    int P, int K, int nseg,
                                    double* __restrict__ out) {
  const int k = blockIdx.x;
  const int j = threadIdx.x;
  if (j >= nseg) return;
  double s = 0.0;
  for (int b = 0; b < P; ++b) s += partial[((long long)b * K + k) * nseg + j];
  out[k * nseg + j] = s;
}

template <int G>
void launch(const int32_t* gid, const LanePtrs& lanes, int K,
            long long cap, long long chunk, int P, int nseg,
            double* partial, double* out, cudaStream_t stream) {
  grouped_sums_partial<G><<<dim3(K, P), kThreads, 0, stream>>>(
      gid, lanes, cap, chunk, nseg, partial);
  grouped_sums_finish<<<K, 64, 0, stream>>>(partial, P, K, nseg, out);
}

}  // namespace

extern "C" {

int grouped_sums_max_lanes() { return kMaxLanes; }

// gid: int32 [cap]; lanes: host array of K device pointers to f64 [cap];
// partial: f64 [P, K, nseg] scratch; out: f64 [K, nseg]. Rows are cut into
// P chunks of `chunk` rows (P * chunk >= cap). Returns cudaGetLastError().
int grouped_sums_launch(const void* gid, const void* const* lanes, int K,
                        long long cap, long long chunk, int P, int nseg,
                        void* partial, void* out, void* stream) {
  if (K < 1 || K > kMaxLanes || nseg < 1 || nseg > 64 || P < 1 ||
      P > 65535 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  LanePtrs ptrs;
  for (int k = 0; k < K; ++k) ptrs.p[k] = static_cast<const double*>(lanes[k]);
  const int32_t* g = static_cast<const int32_t*>(gid);
  double* pa = static_cast<double*>(partial);
  double* o = static_cast<double*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nseg <= 16)
    launch<16>(g, ptrs, K, cap, chunk, P, nseg, pa, o, s);
  else if (nseg <= 32)
    launch<32>(g, ptrs, K, cap, chunk, P, nseg, pa, o, s);
  else
    launch<64>(g, ptrs, K, cap, chunk, P, nseg, pa, o, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
