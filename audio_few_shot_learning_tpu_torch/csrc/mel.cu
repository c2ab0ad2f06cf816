// Mel filterbank projection + log for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel audio_few_shot_learning_tpu/ops/mel.py::
// _mel_log_pallas. For power-spectrogram rows pspec [M, K] (M = clips x T
// frames, K = n_fft/2 + 1 = 513) and a triangular filterbank fb [K, N]:
//   out[b, n, t] = log_mult * log10(sum_k pspec[b*T + t, k] * fb[k, n] + eps)
// in float32, written in the [..., n_mels, frames] layout MelSpec returns
// (mel_log_reference with its last two axes swapped).
//
// Bound on this card: bytes. The flagship eval batch (M = 16 x 50 x 157 =
// 125 600) reads 257.7 MB of pspec and writes 64.3 MB: 0.096 ms at
// 3.35 TB/s. The TPU kernel did the dense [M, 640] @ [640, 128] product on
// its matrix unit (16.5 GFLOP, 0.246 ms of f32 FMA here), but each band's
// nonzero weights are one contiguous range of 1-24 bins, about 1 000 of the
// 65 664 entries, so the needed work is ~65x smaller and far below the
// byte bound. No tensor cores: the result stays at f32 accuracy.
//
// Design: one block per 32 consecutive rows. The block copies its rows,
// which are contiguous in memory, into shared memory once (16-byte loads
// when aligned, which they are for a 256-byte aligned base: 32 rows x 2052
// bytes is a multiple of 16). Lane r of every warp owns row r; warp w
// computes bands w, w+8, ... over each band's range [lo, lo+len) from a
// packed weight table (BandTable in ops/mel.py). A row's stride in shared
// memory, 513 floats, is 1 mod 32, so the 32 lanes read 32 different banks;
// every lane reads the same weight, a broadcast. The loop trip count is the
// band's width, the same for the whole warp. The log is applied in the same
// pass, and lanes write consecutive frames of one band: coalesced in the
// [..., N, T] layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;  // rows per block, one per lane (ops/mel.py TILE_ROWS)
constexpr int kWarps = 8;  // warp w takes bands w, w + kWarps, ...
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
    mel_log_kernel(const float* __restrict__ pspec, const float* __restrict__ weights,
                   const int* __restrict__ band_lo, const int* __restrict__ band_len,
                   const int* __restrict__ band_off, float* __restrict__ out, int m, int k,
                   int n_mels, int frames, float log_mult, float eps) {
  extern __shared__ __align__(16) float tile[];  // [kRows, k]

  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)m - row0);
  const float* src = pspec + row0 * k;
  const int count = rows * k;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(tile);
    for (int i = threadIdx.x; i < n4; i += kThreads) dst4[i] = __ldg(src4 + i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) tile[i] = __ldg(src + i);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane >= rows) return;  // ragged last block; no barrier follows
  const float* x = tile + lane * k;
  const long long row = row0 + lane;
  const long long b = row / frames;
  const long long t = row - b * frames;
  float* o = out + b * n_mels * (long long)frames + t;
  for (int n = warp; n < n_mels; n += kWarps) {
    const int lo = __ldg(band_lo + n);
    const int len = __ldg(band_len + n);
    const float* w = weights + __ldg(band_off + n);
    const float* xs = x + lo;
    float acc = 0.0f;
    for (int j = 0; j < len; ++j) acc = fmaf(xs[j], __ldg(w + j), acc);
    o[(long long)n * frames] = log_mult * log10f(acc + eps);
  }
}

constexpr int kMaxDevices = 64;
int g_smem_set[kMaxDevices] = {};  // dynamic shared memory allowed so far, per device

}  // namespace

// pspec [m, k] f32 (rows b*frames + t), weights/band_lo/band_len/band_off the
// packed filterbank (f32 / int32 / int32 / int32), out [m / frames, n_mels,
// frames] f32; all contiguous, on the device of `stream`. The wrapper checks
// shapes, types and the shared-memory size first and says why; these guards
// only keep a bad call from launching.
extern "C" int afsl_mel_log(const void* pspec, const void* weights, const void* band_lo,
                            const void* band_len, const void* band_off, void* out, int m, int k,
                            int n_mels, int frames, float log_mult, float eps, void* stream) {
  if (m <= 0 || n_mels <= 0) return 0;
  if (k <= 0 || frames <= 0 || m % frames != 0) return (int)cudaErrorInvalidValue;
  const int smem = kRows * k * (int)sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > g_smem_set[dev]) {  // once per device, before any graph capture
    err = cudaFuncSetAttribute(mel_log_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_set[dev] = smem;
  }
  const int blocks = (m + kRows - 1) / kRows;
  mel_log_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pspec, (const float*)weights, (const int*)band_lo, (const int*)band_len,
      (const int*)band_off, (float*)out, m, k, n_mels, frames, log_mult, eps);
  return (int)cudaGetLastError();
}
