// SpecAugment 4-view emitter for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel audio_few_shot_learning_tpu/ops/specaugment.py::
// _views_pallas. From one read of each spectrogram x[F, T] it writes the
// four views [original, time warp, time mask, freq mask] of
// _views_xla / views_reference:
//   view 0 = x
//   view 1 = bilinear two-tap gather of x along T at the Hermite positions ys
//            (grid_sample, align_corners=True, taps outside [0, T-1] add 0),
//            computed in f32 and rounded once to the output type
//   view 2 = mask_value where tmask[t], else x
//   view 3 = mask_value where fmask[f], else x
// The TPU kernel applied the warp as x @ M with a dense [T, T] two-tap
// matrix, which kept the MXU busy; here that would be T times the work of
// the gather for the same result, so the warp index and weights are
// computed in-kernel from ys instead.
//
// Bound on this card: pure bandwidth. Per item it must read F*T inputs and
// write 4*F*T outputs (plus T floats of ys). At the flagship eval batch
// (E=16 episodes x B=25 items, F=128, T=157, f32) that is 32.2 MB read and
// 128.6 MB written, ~48 us at 3.35 TB/s.
//
// Design: one block per (F-row tile, item, episode). Threads run along T so
// every global read and write is coalesced; the row tile is staged once in
// shared memory, so the two warp taps are shared-memory reads and x is read
// from device memory exactly once. Each thread computes its warp taps once
// and reuses them for every row of the tile. The warp arithmetic uses
// explicitly rounded operations (__fmul_rn / __fadd_rn) so the compiler
// cannot contract it into FMAs: the result then matches the plain PyTorch
// version's separately rounded ops bit for bit, in f32 and after bf16
// rounding. T=157 is not a multiple of the warp width; the block is the next
// multiple of 32 and the tail threads idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 8;
constexpr int kMaxThreads = 256;
constexpr int kSmemBytes = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void views_kernel(const T* __restrict__ spec, const float* __restrict__ ys,
                             const uint8_t* __restrict__ tmask,
                             const uint8_t* __restrict__ fmask, T* __restrict__ out, int n_items,
                             int n_freq, int n_time, int rows_per_block, float mask_value) {
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [rows_per_block, n_time]

  const int episode = blockIdx.z;
  const size_t item = (size_t)episode * n_items + blockIdx.y;
  const int f0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n_freq - f0);
  const size_t plane = (size_t)n_freq * n_time;

  const T* x = spec + item * plane + (size_t)f0 * n_time;
  for (int i = threadIdx.x; i < rows * n_time; i += blockDim.x) tile[i] = x[i];
  __syncthreads();

  const float* y = ys + item * n_time;
  const uint8_t* tm = tmask + (size_t)episode * n_time;
  const uint8_t* fm = fmask + (size_t)episode * n_freq + f0;
  const T masked = from_f32<T>(mask_value);
  const float last = (float)(n_time - 1);
  T* o = out + item * 4 * plane + (size_t)f0 * n_time;

  for (int t = threadIdx.x; t < n_time; t += blockDim.x) {
    const float src = __fmul_rn(__fmul_rn(__fadd_rn(y[t], 1.0f), 0.5f), last);
    const float s0 = floorf(src);
    const float s1 = __fadd_rn(s0, 1.0f);
    const float w1_raw = __fsub_rn(src, s0);
    const float w0_raw = __fsub_rn(1.0f, w1_raw);
    const float w0 = (s0 >= 0.0f && s0 <= last) ? w0_raw : 0.0f;
    const float w1 = (s1 >= 0.0f && s1 <= last) ? w1_raw : 0.0f;
    const int i0 = (int)fminf(fmaxf(s0, 0.0f), last);
    const int i1 = (int)fminf(fmaxf(s1, 0.0f), last);
    const bool t_masked = tm[t] != 0;
    for (int r = 0; r < rows; ++r) {
      const T* row = tile + r * n_time;
      const T v = row[t];
      const float warped =
          __fadd_rn(__fmul_rn(w0, to_f32(row[i0])), __fmul_rn(w1, to_f32(row[i1])));
      const size_t off = (size_t)r * n_time + t;
      o[off] = v;
      o[plane + off] = from_f32<T>(warped);
      o[2 * plane + off] = t_masked ? masked : v;
      o[3 * plane + off] = fm[r] ? masked : v;
    }
  }
}

template <typename T>
int launch(const void* spec, const void* ys, const void* tmask, const void* fmask, void* out,
           int n_episodes, int n_items, int n_freq, int n_time, float mask_value, void* stream) {
  if (n_episodes <= 0 || n_items <= 0 || n_freq <= 0 || n_time <= 0) return 0;
  int rows = kSmemBytes / (n_time * (int)sizeof(T));
  if (rows < 1) return (int)cudaErrorInvalidValue;
  rows = rows < kMaxRows ? rows : kMaxRows;
  int threads = ((n_time + 31) / 32) * 32;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  const dim3 grid((n_freq + rows - 1) / rows, n_items, n_episodes);
  const size_t smem = (size_t)rows * n_time * sizeof(T);
  views_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)spec, (const float*)ys, (const uint8_t*)tmask, (const uint8_t*)fmask, (T*)out,
      n_items, n_freq, n_time, rows, mask_value);
  return (int)cudaGetLastError();
}

}  // namespace

// spec [E, B, F, T], ys [E, B, T] f32, tmask [E, T] u8, fmask [E, F] u8,
// out [E, B, 4, F, T]; all contiguous, all on the device of `stream`.
extern "C" int afsl_specaugment_views_f32(const void* spec, const void* ys, const void* tmask,
                                          const void* fmask, void* out, int n_episodes,
                                          int n_items, int n_freq, int n_time, float mask_value,
                                          void* stream) {
  return launch<float>(spec, ys, tmask, fmask, out, n_episodes, n_items, n_freq, n_time,
                       mask_value, stream);
}

extern "C" int afsl_specaugment_views_bf16(const void* spec, const void* ys, const void* tmask,
                                           const void* fmask, void* out, int n_episodes,
                                           int n_items, int n_freq, int n_time, float mask_value,
                                           void* stream) {
  return launch<__nv_bfloat16>(spec, ys, tmask, fmask, out, n_episodes, n_items, n_freq, n_time,
                               mask_value, stream);
}
