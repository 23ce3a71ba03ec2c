// flash_attention: online-softmax attention over (B, S, H, D) tensors with
// causal and sliding-window masks, zero-copy grouped-query attention and f32
// accumulation; the prefill attention of every dense transformer layer.
//
// Replaces the TPU kernel flash_attention_fwd in
// src/repro/kernels/flash_attention.py.  It computes the same function, not
// the same blocks:
//
//   * One CTA per (query tile of 64 rows, query head, batch row).  The TPU
//     walks the kv blocks as the sequential last grid axis and carries
//     (m, l, acc) in VMEM scratch; here a loop inside the CTA walks them and
//     the carry lives in registers: each of the 256 threads owns 4 query
//     rows (ty, ty + 16, ...) and 4 keys (tx, tx + 16, ...) of a 64 x 64
//     score tile, and ceil(D / 16) output columns of its 4 rows.  A row's
//     16 threads are 16 lanes of one warp, so its max and sum are shuffles.
//   * K and V tiles of 64 positions are staged in shared memory as f32 (Q
//     once per CTA), rows padded to D + 1 floats so that the 16 keys a warp
//     reads at one depth fall in 16 banks.  P goes through shared memory
//     for the P.V product.
//   * Zero-copy GQA as in the TPU kernel's kv_map: query head h reads kv
//     head h / (Hq / Hkv), the order repeat_kv gives.
//   * The kv loop starts and ends at the first and last 64-key tile that
//     the causal and window masks leave live (the TPU kernel's pl.when
//     skip).  Masked scores are -1e30 (not -inf, so exp(m_prev - m_new)
//     stays finite) and their p is 0; l is clamped at 1e-30 before the
//     divide.  As in the TPU kernel, p is rounded to V's type before P.V
//     (a no-op for f32) while l sums the unrounded p.
//   * Any S >= 1: tail rows and keys past S are masked, not asserted away
//     as the TPU kernel's S % block == 0 is; the serve engine prefills at
//     the exact prompt length.  Any D that is a multiple of 8, up to 128.
//   * No atomics: every output element is written once by one thread, in a
//     fixed order of operations, so a relaunch gives identical bytes.
//
// Bound on this card: operations for long S.  A causal pass does
// 4 * Hq * D * S(S + 1) / 2 flops against 2 bytes per element of q, k, v
// and o in bf16; at Qwen2.5-3B's 16 query and 2 kv heads that is about
// 0.44 * S flops per byte, past the H100's bf16 tensor-core line of ~295
// flops per byte from S = 670 on.  This first version does its products as
// f32 FMAs on the CUDA cores from shared memory, so it sits far above that
// bound; wgmma, TMA and pipelining are later work.
//
// flash_attention_launch runs on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;                 // 16 x 16: ty rows, tx keys
constexpr int kRows = kBlockQ / 16;           // query rows per thread
constexpr int kKeys = kBlockK / 16;           // keys per thread per tile
constexpr int kPld = kBlockK + 1;             // padded row of P
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);                 // round to nearest even
}

// p as the P.V product sees it: rounded to V's type, like p.astype(v.dtype)
template <typename T> __device__ __forceinline__ float round_like(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         (size_t)(kBlockQ * (d + 1) + kBlockK * (d + 1) + kBlockK * d +
                  kBlockQ * kPld);
}

// NC = ceil(D / 16): output columns per thread, fixed at compile time so
// that acc stays in registers.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Hq, int Hkv,
          int D, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;                           // kBlockQ x ld
  float* Ks = Qs + kBlockQ * ld;              // kBlockK x ld
  float* Vs = Ks + kBlockK * ld;              // kBlockK x D
  float* Ps = Vs + kBlockK * D;               // kBlockQ x kPld

  // the longest causal tiles first, so that the last wave is short
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const long long q_step = (long long)Hq * D;     // between positions
  const long long kv_step = (long long)Hkv * D;
  const T* qb = q + (long long)b * S * q_step + (long long)h * D;
  const T* kb = k + (long long)b * S * kv_step + (long long)kvh * D;
  const T* vb = v + (long long)b * S * kv_step + (long long)kvh * D;
  T* ob = o + (long long)b * S * q_step + (long long)h * D;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int s = q0 + r;
    Qs[r * ld + c] = s < S ? to_f32(qb[s * q_step + c]) : 0.f;
  }

  // kv tiles the masks leave live
  const int q_last = min(S - 1, q0 + kBlockQ - 1);
  const int k_last = causal ? q_last : S - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_first / kBlockK;
  const int t_hi = k_last / kBlockK;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();                          // last tile's Ks/Vs/Ps reads
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const int s = k0 + r;
      const bool in = s < S;
      Ks[r * ld + c] = in ? to_f32(kb[s * kv_step + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[s * kv_step + c]) : 0.f;
    }
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool live[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < S && (!causal || kpos <= qpos) &&
                  (window <= 0 || qpos - kpos < window);
        sc[i][j] = live[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = live[j] ? expf(sc[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty + 16 * i) * kPld + tx + 16 * j] = round_like<T>(p);
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * kPld + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < D ? Vs[j * D + col] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) ob[s * q_step + col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int batch, int seq, int hq, int hkv, int d, int causal,
                 int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, hq, batch);
  flash_fwd<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, hq, hkv, d, causal,
      window, 1.0f / sqrtf((float)d));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o,
                 int batch, int seq, int hq, int hkv, int d, int causal,
                 int window, cudaStream_t stream) {
  switch ((d + 15) / 16) {
#define FLASH_CASE(nc)                                                     \
  case nc:                                                                 \
    return launch_typed<T, nc>(q, k, v, o, batch, seq, hq, hkv, d, causal, \
                               window, stream);
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
#undef FLASH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o (batch, seq, hq, d); k, v (batch, seq, hkv, d); all contiguous, of
// one type: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).  window <= 0 means no
// window.  Needs batch, seq >= 1, hq a multiple of hkv, d a multiple of 8 in
// [8, 128].
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int seq, int hq, int hkv, int d,
                                      int causal, int window, int is_bf16,
                                      void* stream_handle) {
  if (batch < 1 || seq < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      d < 8 || d > 128 || d % 8 != 0 || batch > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (is_bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, batch, seq, hq, hkv, d,
                                       causal, window, stream);
  return launch_dtype<float>(q, k, v, o, batch, seq, hq, hkv, d, causal,
                             window, stream);
}
