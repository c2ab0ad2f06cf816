// K1 variant for measurement only: scripts/torch_port_k1_ab.py times it
// against csrc/specaugment.cu, which the package builds and runs.
//
//     python3 scripts/torch_port_k1_ab.py --parent scripts/k1_variants/specaugment_bulk_store.cu
//
// The same kernel but for its stores on the vector path: each view is
// staged in an unpadded shared buffer and written to device memory by one
// TMA bulk copy a view (cp.async.bulk.global.shared::cta), issued by one
// thread after a proxy fence and the block's barrier, instead of one
// 16-byte store per thread and view. Views 0, 2 and 3 go out after the
// first barrier, view 1 after a second; the issuing thread waits for the
// copies' reads of shared memory before the block exits. The scalar path
// keeps plain stores. Same C interface and launch plan; the shared memory
// it needs beyond the plan's (four staging buffers) it adds itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;
bool g_smem_set[2][2][kMaxDevices];  // [bf16][vector][device]

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

// VEC elements moved as one access (16 bytes on the vector path).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// Shared buffers carry one 4-byte word of padding after every 128 bytes,
// so the 32 lanes of a warp, whose accesses are one vector (16 bytes)
// apart, fall in 32 distinct banks.
__host__ __device__ constexpr int padded_bytes(int bytes) { return bytes + 4 * (bytes / 128 + 1); }
__device__ __forceinline__ int pad_word(int w) { return w + (w >> 5); }
template <typename T>
__device__ __forceinline__ int pad_elem(int p) {
  return p + (4 / (int)sizeof(T)) * ((p * (int)sizeof(T)) >> 7);
}

// Stage the loaded elements i.. of the tile: a 16-byte vector as four word
// stores (its four words stay adjacent: a vector never crosses 128 bytes).
template <typename T, int VEC>
__device__ __forceinline__ void stage(unsigned char* tile, int i, const Pack<T, VEC>& v) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile) + pad_word(i * (int)sizeof(T) / 4);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = src[k];
  } else {
    static_assert(VEC == 1, "K1 moves 16 bytes or one element per access");
    reinterpret_cast<T*>(tile)[pad_elem<T>(i)] = v.v[0];
  }
}

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(gmem),
               "r"((uint32_t)__cvta_generic_to_shared(smem)), "r"(bytes)
               : "memory");
}

__host__ __device__ constexpr int stage_bytes(int rows, int n_time, int elem) {
  return round16(rows * n_time * elem);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    views_kernel(const T* __restrict__ spec, const float* __restrict__ ys,
                 const uint8_t* __restrict__ tmask, const uint8_t* __restrict__ fmask,
                 T* __restrict__ out, int n_items, int n_freq, int n_time, int rows,
                 int tiles_per_item, float mask_value) {
  using P = Pack<T, VEC>;
  constexpr bool kBulk = VEC > 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys_s = reinterpret_cast<float*>(smem_raw);  // [n_time], padded
  unsigned char* tile = smem_raw + round16(padded_bytes(n_time * 4));  // [rows, n_time] of T, padded
  T* stg = reinterpret_cast<T*>(tile + round16(padded_bytes(rows * n_time * (int)sizeof(T))));
  const int stg_elems = stage_bytes(rows, n_time, sizeof(T)) / (int)sizeof(T);  // per view

  const int64_t item = blockIdx.x / tiles_per_item;  // episode * n_items + b
  const int f0 = (int)(blockIdx.x - item * tiles_per_item) * rows;
  const int episode = (int)(item / n_items);
  const int n = min(rows, n_freq - f0) * n_time;  // a multiple of VEC on the vector path
  const int64_t plane = (int64_t)n_freq * n_time;
  const T* x = spec + item * plane + (int64_t)f0 * n_time;
  T* o = out + item * 4 * plane + (int64_t)f0 * n_time;
  const uint8_t* tm = tmask + (int64_t)episode * n_time;
  const uint8_t* fm = fmask + (int64_t)episode * n_freq + f0;
  const float* y = ys + item * n_time;
  const T masked = from_f32<T>(mask_value);
  // where view v's elements go: the staging buffer on the bulk path
  auto dst = [&](int v) { return kBulk ? stg + v * stg_elems : o + v * plane; };

  for (int t = threadIdx.x; t < n_time; t += blockDim.x) ys_s[pad_word(t)] = y[t];

  for (int i = threadIdx.x * VEC; i < n; i += blockDim.x * VEC) {
    const P v = *reinterpret_cast<const P*>(x + i);
    stage(tile, i, v);
    *reinterpret_cast<P*>(dst(0) + i) = v;
    P tv, fv;
    int f = i / n_time, t = i - f * n_time;
    bool f_masked = fm[f];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      tv.v[j] = tm[t] ? masked : v.v[j];
      fv.v[j] = f_masked ? masked : v.v[j];
      if (++t == n_time) {
        t = 0, ++f;
        if (j + 1 < VEC) f_masked = fm[f];
      }
    }
    *reinterpret_cast<P*>(dst(2) + i) = tv;
    *reinterpret_cast<P*>(dst(3) + i) = fv;
  }
  if (kBulk) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (kBulk && threadIdx.x == 0) {
    bulk_store(o, stg, n * (int)sizeof(T));
    bulk_store(o + 2 * plane, stg + 2 * stg_elems, n * (int)sizeof(T));
    bulk_store(o + 3 * plane, stg + 3 * stg_elems, n * (int)sizeof(T));
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }

  const float last = (float)(n_time - 1);
  for (int i = threadIdx.x * VEC; i < n; i += blockDim.x * VEC) {
    P wv;
    int f = i / n_time, t = i - f * n_time;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float src = __fmul_rn(__fmul_rn(__fadd_rn(ys_s[pad_word(t)], 1.0f), 0.5f), last);
      const float s0 = floorf(src);
      const float s1 = __fadd_rn(s0, 1.0f);
      const float w1_raw = __fsub_rn(src, s0);
      const float w0_raw = __fsub_rn(1.0f, w1_raw);
      const float w0 = (s0 >= 0.0f && s0 <= last) ? w0_raw : 0.0f;
      const float w1 = (s1 >= 0.0f && s1 <= last) ? w1_raw : 0.0f;
      const T* tile_t = reinterpret_cast<const T*>(tile);
      const int row = f * n_time;
      const float g0 = to_f32(tile_t[pad_elem<T>(row + (int)fminf(fmaxf(s0, 0.0f), last))]);
      const float g1 = to_f32(tile_t[pad_elem<T>(row + (int)fminf(fmaxf(s1, 0.0f), last))]);
      wv.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(w0, g0), __fmul_rn(w1, g1)));
      if (++t == n_time) t = 0, ++f;
    }
    *reinterpret_cast<P*>(dst(1) + i) = wv;
  }
  if (kBulk) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(o + plane, stg + stg_elems, n * (int)sizeof(T));
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // before the block's smem is freed
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int VEC>
int launch(const void* spec, const void* ys, const void* tmask, const void* fmask, void* out,
           int n_episodes, int n_items, int n_freq, int n_time, float mask_value, int rows,
           int tiles_per_item, int threads, int smem, void* stream) {
  const int64_t elem = sizeof(T);
  const int64_t blocks = (int64_t)n_episodes * n_items * tiles_per_item;
  if (rows < 1 || tiles_per_item != (n_freq + rows - 1) / rows || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || blocks > 0x7fffffff ||
      smem < round16(padded_bytes(n_time * 4)) + padded_bytes(rows * n_time * (int)elem) ||
      smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (VEC > 1)
    smem = round16(padded_bytes(n_time * 4)) + round16(padded_bytes(rows * n_time * (int)elem)) +
           4 * stage_bytes(rows, n_time, (int)elem);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (VEC > 1 && (!aligned16(spec) || !aligned16(out) || (int64_t)n_freq * n_time * elem % 16 ||
                  (rows < n_freq && (int64_t)rows * n_time * elem % 16)))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  bool& set = g_smem_set[sizeof(T) == 2][VEC > 1][dev];
  if (!set) {  // once per device, at the first call (before any graph capture)
    err = cudaFuncSetAttribute(views_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    set = true;
  }
  views_kernel<T, VEC><<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)spec, (const float*)ys, (const uint8_t*)tmask, (const uint8_t*)fmask, (T*)out,
      n_items, n_freq, n_time, rows, tiles_per_item, mask_value);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* spec, const void* ys, const void* tmask, const void* fmask, void* out,
             int n_episodes, int n_items, int n_freq, int n_time, float mask_value, int rows,
             int tiles_per_item, int threads, int vec, int smem, void* stream) {
  if (n_episodes <= 0 || n_items <= 0 || n_freq <= 0 || n_time <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return launch<T, kVec>(spec, ys, tmask, fmask, out, n_episodes, n_items, n_freq, n_time,
                           mask_value, rows, tiles_per_item, threads, smem, stream);
  if (vec == 1)
    return launch<T, 1>(spec, ys, tmask, fmask, out, n_episodes, n_items, n_freq, n_time,
                        mask_value, rows, tiles_per_item, threads, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// spec [E, B, F, T], ys [E, B, T] f32, tmask [E, T] u8 (a bool tensor's
// bytes), fmask [E, F] u8, out [E, B, 4, F, T]; all contiguous, all on the
// device of `stream`. rows, tiles_per_item, threads, vec and smem are the
// wrapper's plan (ops/specaugment.py::views_plan).
extern "C" int afsl_specaugment_views_f32(const void* spec, const void* ys, const void* tmask,
                                          const void* fmask, void* out, int n_episodes,
                                          int n_items, int n_freq, int n_time, float mask_value,
                                          int rows, int tiles_per_item, int threads, int vec,
                                          int smem, void* stream) {
  return dispatch<float>(spec, ys, tmask, fmask, out, n_episodes, n_items, n_freq, n_time,
                         mask_value, rows, tiles_per_item, threads, vec, smem, stream);
}

extern "C" int afsl_specaugment_views_bf16(const void* spec, const void* ys, const void* tmask,
                                           const void* fmask, void* out, int n_episodes,
                                           int n_items, int n_freq, int n_time, float mask_value,
                                           int rows, int tiles_per_item, int threads, int vec,
                                           int smem, void* stream) {
  return dispatch<__nv_bfloat16>(spec, ys, tmask, fmask, out, n_episodes, n_items, n_freq,
                                 n_time, mask_value, rows, tiles_per_item, threads, vec, smem,
                                 stream);
}
