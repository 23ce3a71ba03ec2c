// window_reduce: per-segment count / sum / sum of squares / max over a flat
// event array, the alerts stage's batch reduction (log replay and cold-range
// queries).  A segment is one flattened (key, window) slot.
//
// Replaces the TPU kernel window_reduce_fwd in src/repro/kernels/window_reduce.py.
// That kernel compares every event block with every segment block (a one-hot
// of block_s x block_n), which is O(N * S) work: tolerable for the 1,152
// slots of a channel-keyed day, hopeless for the ~10^6 slots of a
// source-keyed one.  This version does O(N) work per radix pass and gives
// the same bytes on every launch over the same input:
//
//   1. A stable LSD radix sort of the (segment id, value) pairs by segment
//      id, 8 bits a pass, ceil(bits(S) / 8) passes.  A pass is three
//      kernels: per-tile digit histograms (integer counts, so the
//      shared-memory atomics are exact), one exclusive scan per digit over
//      the tiles, and a stable scatter whose in-tile ranks come from
//      __match_any_sync and per-warp counts, never from scheduling order.
//   2. Segment bounds, read off the sorted ids (one thread per position).
//   3. One warp per segment: lane l folds events l, l + 32, ... in order,
//      then a fixed shuffle tree.  The order of every float addition
//      depends only on the segment's own events, so the sums are
//      reproducible from run to run.  Count is an integer; max is exact
//      and, like the reference's, NaN as soon as one of the values is.
//
// Ids outside [0, S), the -1 padding included, are ignored, as the JAX
// reference drops them: they sort under the sentinel key S, which no
// segment reads.
//
// Bound on this card: bytes.  The function reads 8 bytes per event and
// writes 16 per segment (8N + 16S); its few flops per event are far below
// the f32 rate.  The sort moves about 20 bytes per event per pass (the
// histogram reads the key, the scatter reads and writes key and value) and
// the reduction runs one warp per segment, so this simple design sits well
// above that bound; tiled loads and a single-pass path for small S are
// later work.
//
// window_reduce_launch runs everything on the caller's stream, allocates
// nothing (the wrapper hands it every buffer) and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;                 // one thread per radix digit
constexpr int kRadix = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 32;                   // rounds of kThreads events per tile
constexpr int kTile = kThreads * kRounds;     // events per tile
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int clamp_key(int k, int s) {
  return (k >= 0 && k < s) ? k : s;
}

// max that propagates NaN, as the reference's scatter max does (fmaxf
// would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Inclusive scan of one int per thread over the block; `total` gets the
// block's sum.  blockDim.x is a multiple of 32, at most 1024.
__device__ int block_inclusive_scan(int x, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_sums[warp - 1];
  total = warp_sums[nwarps - 1];
  __syncthreads();                            // warp_sums is reused next call
  return x;
}

// hist[d * num_tiles + tile] = events of `tile` whose digit is d.
__global__ void radix_hist(const int* __restrict__ keys, int n, int s,
                           int shift, int num_tiles, int* __restrict__ hist) {
  __shared__ int counts[kRadix];
  const int t = threadIdx.x;
  counts[t] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const int i = base + r * kThreads + t;
    if (i < n) {
      atomicAdd(&counts[(clamp_key(keys[i], s) >> shift) & (kRadix - 1)], 1);
    }
  }
  __syncthreads();
  hist[(long long)t * num_tiles + blockIdx.x] = counts[t];
}

// Block d turns hist[d][0, num_tiles) into exclusive offsets within digit d
// and writes digit d's total.
__global__ void radix_digit_scan(int* __restrict__ hist, int num_tiles,
                                 int* __restrict__ digit_totals) {
  __shared__ int warp_sums[32];
  int* row = hist + (long long)blockIdx.x * num_tiles;
  int carry = 0;
  for (int first = 0; first < num_tiles; first += blockDim.x) {
    const int i = first + threadIdx.x;
    const int x = i < num_tiles ? row[i] : 0;
    int total;
    const int inclusive = block_inclusive_scan(x, warp_sums, total);
    if (i < num_tiles) row[i] = carry + inclusive - x;
    carry += total;
  }
  if (threadIdx.x == 0) digit_totals[blockIdx.x] = carry;
}

// Stable scatter of one tile into digit order.  Thread t owns digit t in
// the bookkeeping steps.
__global__ void radix_scatter(const int* __restrict__ keys_in,
                              const float* __restrict__ vals_in,
                              int* __restrict__ keys_out,
                              float* __restrict__ vals_out,
                              const int* __restrict__ hist,
                              const int* __restrict__ digit_totals,
                              int n, int s, int shift, int num_tiles) {
  __shared__ int next[kRadix];                // next output slot per digit
  __shared__ int prefix[kRadix];
  __shared__ int warp_counts[kWarps][kRadix];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // digit t's events start after every smaller digit's events
  const int own = digit_totals[t];
  prefix[t] = own;
  __syncthreads();
  for (int o = 1; o < kRadix; o <<= 1) {
    const int y = t >= o ? prefix[t - o] : 0;
    __syncthreads();
    prefix[t] += y;
    __syncthreads();
  }
  next[t] = prefix[t] - own + hist[(long long)t * num_tiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) warp_counts[w][t] = 0;
  __syncthreads();

  const int base = blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const int first = base + r * kThreads;
    if (first >= n) break;                    // the same for the whole block
    const int i = first + t;
    const bool valid = i < n;
    int key = 0;
    float v = 0.f;
    int d = kRadix;                           // no digit: past the end
    if (valid) {
      key = clamp_key(keys_in[i], s);
      v = vals_in[i];
      d = (key >> shift) & (kRadix - 1);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (valid && rank == 0) warp_counts[warp][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      int pos = next[d] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_counts[w][d];
      keys_out[pos] = key;
      vals_out[pos] = v;
    }
    __syncthreads();
    int add = 0;
    for (int w = 0; w < kWarps; ++w) {
      add += warp_counts[w][t];
      warp_counts[w][t] = 0;
    }
    next[t] += add;
    __syncthreads();
  }
}

// start[k], end[k]: the run of segment k in the sorted keys (both stay 0
// for an empty segment).
__global__ void segment_bounds(const int* __restrict__ keys, int n, int s,
                               int* __restrict__ start,
                               int* __restrict__ end) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = keys[i];
  if (k >= s) return;                         // the sentinel: ignored ids
  if (i == 0 || keys[i - 1] != k) start[k] = i;
  if (i == n - 1 || keys[i + 1] != k) end[k] = i + 1;
}

// One warp per segment; out[seg] = (count, sum, sumsq, max).
__global__ void segment_reduce(const float* __restrict__ vals,
                               const int* __restrict__ start,
                               const int* __restrict__ end, int s,
                               float* __restrict__ out) {
  const long long seg =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (seg >= s) return;                       // the whole warp leaves
  const int b = start[seg];
  const int e = end[seg];
  float sum = 0.f;
  float sumsq = 0.f;
  float mx = -INFINITY;
#pragma unroll 4
  for (int i = b + lane; i < e; i += 32) {
    const float v = vals[i];
    sum += v;
    sumsq += __fmul_rn(v, v);                 // v*v rounded, as the reference
    mx = nan_max(mx, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    sumsq += __shfl_down_sync(0xffffffffu, sumsq, o);
    mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    reinterpret_cast<float4*>(out)[seg] =
        make_float4(static_cast<float>(e - b), sum, sumsq, mx);
  }
}

}  // namespace

// Events per tile: the wrapper sizes the histogram scratch from it.
extern "C" int window_reduce_tile(void) { return kTile; }

// values (n) f32, seg_ids (n) i32 -> out (s, 4) f32.  Scratch, all device
// memory from the caller: keys_scratch 2n i32, vals_scratch 2n f32,
// hist_scratch kRadix * ceil(n / kTile) + kRadix i32, bounds_scratch 2s i32.
// Needs n >= 1 and 1 <= s < 2^31 - 1.
extern "C" int window_reduce_launch(const float* values, const int* seg_ids,
                                    int n, int s, int* keys_scratch,
                                    float* vals_scratch, int* hist_scratch,
                                    int* bounds_scratch, float* out,
                                    void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int num_tiles = (n + kTile - 1) / kTile;
  const int bits = 32 - __builtin_clz(static_cast<unsigned>(s));  // keys lie in [0, s]
  const int passes = (bits + 7) / 8;
  int* start = bounds_scratch;
  int* end = bounds_scratch + s;
  int* digit_totals = hist_scratch + (long long)kRadix * num_tiles;
  int* key_buf[2] = {keys_scratch, keys_scratch + n};
  float* val_buf[2] = {vals_scratch, vals_scratch + n};

  cudaError_t err = cudaMemsetAsync(bounds_scratch, 0,
                                    sizeof(int) * 2 * (size_t)s, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int* keys_in = seg_ids;
  const float* vals_in = values;
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    radix_hist<<<num_tiles, kThreads, 0, stream>>>(keys_in, n, s, shift,
                                                   num_tiles, hist_scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    radix_digit_scan<<<kRadix, kScanThreads, 0, stream>>>(
        hist_scratch, num_tiles, digit_totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    radix_scatter<<<num_tiles, kThreads, 0, stream>>>(
        keys_in, vals_in, key_buf[p & 1], val_buf[p & 1], hist_scratch,
        digit_totals, n, s, shift, num_tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    keys_in = key_buf[p & 1];
    vals_in = val_buf[p & 1];
  }
  segment_bounds<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      keys_in, n, s, start, end);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long reduce_blocks = ((long long)s * 32 + kThreads - 1) / kThreads;
  segment_reduce<<<static_cast<unsigned>(reduce_blocks), kThreads, 0, stream>>>(
      vals_in, start, end, s, out);
  return static_cast<int>(cudaGetLastError());
}
