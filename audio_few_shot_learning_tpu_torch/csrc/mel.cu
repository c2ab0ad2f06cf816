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
// Design: persistent blocks (one per SM, the grid from ops/mel.py mel_plan)
// walk the 32-row tiles t = blockIdx.x, + gridDim.x, ... A tile's rows are
// one contiguous run of 32 * K * 4 bytes (a multiple of 16), so a TMA 1-D
// bulk copy (cp.async.bulk completing on an mbarrier) brings it into a ring
// of `stages` tile buffers in shared memory. One producer thread keeps the
// next tiles in flight while 16 consumer warps compute on the tile that has
// arrived and then release its buffer (one arrive per warp on the stage's
// empty barrier). The packed band table (BandTable in ops/mel.py: ~1 000
// weights and lo, length, offset per band) is staged in shared memory once
// per block, beside the ring, when it fits.
//
// The arithmetic on a tile: lane r of every consumer warp owns row r; warp w
// computes bands w, w+16, ... over each band's range [lo, lo+len) in
// ascending fmaf order. A row's stride in shared
// memory, K = 513 floats, is 1 mod 32, so the 32 lanes read 32 different
// banks; every lane reads the same weight, a broadcast. The log is applied
// in the same pass, and lanes write consecutive frames of one band:
// coalesced in the [..., N, T] layout.
//
// Tiles the bulk copy cannot take, the ragged last tile (M % 32 rows) and
// every tile when pspec's base is not 16-byte aligned, are loaded by the
// consumer warps with plain loads after the pipelined tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // rows per tile, one per lane (ops/mel.py TILE_ROWS)
constexpr int kWarps = 16;     // consumer warps: warp w takes bands w, w + kWarps, ...
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxStages = 3;
constexpr int kHeaderBytes = 128;  // the mbarriers, ahead of the tile ring
constexpr int kSmemLimit = 227 * 1024;

__host__ __device__ constexpr long long round4(long long x) { return (x + 3) & ~3LL; }

// Shared memory of one block; ops/mel.py mel_plan mirrors it.
long long mel_smem_bytes(int k, int n_mels, int n_weights, int stages, bool table_in_smem) {
  long long bytes = kHeaderBytes + (long long)stages * kRows * k * 4;
  if (table_in_smem) bytes += 4 * (round4(n_weights) + 3LL * n_mels);
  return bytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory; completes `bytes` of transactions on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Bands of one tile of `rows` rows (starting at row0) held in shared memory.
__device__ __forceinline__ void mel_tile(const float* tile, int rows, long long row0,
                                         const float* weights, const int* band_lo,
                                         const int* band_len, const int* band_off,
                                         float* __restrict__ out, int k, int n_mels, int frames,
                                         float log_mult, float eps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane >= rows) return;
  const float* x = tile + lane * k;
  const long long row = row0 + lane;
  const long long b = row / frames;
  const long long t = row - b * frames;
  float* o = out + b * n_mels * (long long)frames + t;
  for (int n = warp; n < n_mels; n += kWarps) {
    const int lo = band_lo[n];
    const int len = band_len[n];
    const float* w = weights + band_off[n];
    const float* xs = x + lo;
    float acc = 0.0f;
    for (int j = 0; j < len; ++j) acc = fmaf(xs[j], w[j], acc);
    o[(long long)n * frames] = log_mult * log10f(acc + eps);
  }
}

template <bool kTableInSmem>
__global__ void __launch_bounds__(kThreads, 1)
    mel_log_kernel(const float* __restrict__ pspec, const float* __restrict__ weights,
                   const int* __restrict__ band_lo, const int* __restrict__ band_len,
                   const int* __restrict__ band_off, float* __restrict__ out, int m, int k,
                   int n_mels, int frames, float log_mult, float eps, int n_weights, int stages,
                   int n_bulk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [kMaxStages]: tile arrived
  uint64_t* empty = full + kMaxStages;                      // [kMaxStages]: buffer released
  float* tiles = reinterpret_cast<float*>(smem_raw + kHeaderBytes);  // [stages, kRows, k]
  const int tile_floats = kRows * k;
  float* w_s = tiles + (long long)stages * tile_floats;  // [n_weights], then lo, len, off [n_mels]
  int* lo_s = reinterpret_cast<int*>(w_s + round4(n_weights));
  int* len_s = lo_s + n_mels;
  int* off_s = len_s + n_mels;

  const int n_tiles = (m + kRows - 1) / kRows;
  const uint32_t tile_bytes = (uint32_t)tile_floats * 4u;
  const bool producer = threadIdx.x == kConsumers;

  // The producer sets up the barriers and fills the ring at once, while the
  // consumers stage the band table.
  int next = blockIdx.x;  // producer: next tile to issue
  int issued = 0;
  if (producer) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (; issued < stages && next < n_bulk; ++issued, next += gridDim.x) {
      mbar_arrive_expect_tx(&full[issued], tile_bytes);
      bulk_load(tiles + (long long)issued * tile_floats, pspec + (long long)next * tile_floats,
                tile_bytes, &full[issued]);
    }
  }
  if (kTableInSmem && threadIdx.x < kConsumers) {
    for (int i = threadIdx.x; i < n_weights; i += kConsumers) w_s[i] = weights[i];
    for (int i = threadIdx.x; i < n_mels; i += kConsumers) {
      lo_s[i] = band_lo[i];
      len_s[i] = band_len[i];
      off_s[i] = band_off[i];
    }
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (!producer) return;
    int stage = issued % stages;
    uint32_t phase = (uint32_t)(issued / stages) & 1u;
    for (; next < n_bulk; next += gridDim.x) {
      mbar_wait(&empty[stage], phase ^ 1u);  // the buffer's previous tile is consumed
      mbar_arrive_expect_tx(&full[stage], tile_bytes);
      bulk_load(tiles + (long long)stage * tile_floats, pspec + (long long)next * tile_floats,
                tile_bytes, &full[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    return;
  }

  const float* w_t = kTableInSmem ? w_s : weights;
  const int* lo_t = kTableInSmem ? lo_s : band_lo;
  const int* len_t = kTableInSmem ? len_s : band_len;
  const int* off_t = kTableInSmem ? off_s : band_off;
  const int lane = threadIdx.x & 31;

  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < n_bulk; t += gridDim.x) {
    mbar_wait(&full[stage], phase);
    mel_tile(tiles + (long long)stage * tile_floats, kRows, (long long)t * kRows, w_t, lo_t, len_t,
             off_t, out, k, n_mels, frames, log_mult, eps);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }

  // The rest (tile t goes to block t % gridDim.x, as above) by plain loads
  // into buffer 0, which no bulk copy writes any more.
  const int g = (int)gridDim.x;
  for (int t = n_bulk + ((int)blockIdx.x + g - n_bulk % g) % g; t < n_tiles; t += g) {
    consumer_sync();  // every consumer warp is done with buffer 0
    const long long row0 = (long long)t * kRows;
    const int rows = (int)min((long long)kRows, (long long)m - row0);
    const float* src = pspec + row0 * k;
    const int count = rows * k;
    for (int i = threadIdx.x; i < count; i += kConsumers) tiles[i] = __ldg(src + i);
    consumer_sync();
    mel_tile(tiles, rows, row0, w_t, lo_t, len_t, off_t, out, k, n_mels, frames, log_mult, eps);
  }
}

constexpr int kMaxDevices = 64;
bool g_smem_set[2][kMaxDevices] = {};  // large dynamic shared memory allowed, per instantiation

template <bool kTableInSmem>
int launch(const float* pspec, const float* weights, const int* band_lo, const int* band_len,
           const int* band_off, float* out, int m, int k, int n_mels, int frames, float log_mult,
           float eps, int n_weights, int stages, int grid, int n_bulk, int smem,
           cudaStream_t stream) {
  auto kernel = mel_log_kernel<kTableInSmem>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  bool& set = g_smem_set[kTableInSmem][dev];
  if (!set) {  // once per device, at the first call (before any graph capture)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    set = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(pspec, weights, band_lo, band_len, band_off, out, m, k,
                                           n_mels, frames, log_mult, eps, n_weights, stages,
                                           n_bulk);
  return (int)cudaGetLastError();
}

}  // namespace

// pspec [m, k] f32 (rows b*frames + t), weights [n_weights] / band_lo /
// band_len / band_off the packed filterbank (f32 / int32 / int32 / int32),
// out [m / frames, n_mels, frames] f32; all contiguous, on the device of
// `stream`. stages (1-3), table_in_smem, grid and n_bulk (the tiles the bulk
// copies take: every full tile when pspec is 16-byte aligned, else 0) come
// from the wrapper's launch plan, which checks shapes, types and the
// shared-memory size first and says why; these guards only keep a bad call
// from launching.
extern "C" int afsl_mel_log(const void* pspec, const void* weights, const void* band_lo,
                            const void* band_len, const void* band_off, void* out, int m, int k,
                            int n_mels, int frames, float log_mult, float eps, int n_weights,
                            int stages, int table_in_smem, int grid, int n_bulk, void* stream) {
  if (m <= 0 || n_mels <= 0) return 0;
  if (k <= 0 || frames <= 0 || m % frames != 0 || n_weights < 0 || stages < 1 ||
      stages > kMaxStages || grid < 1 || n_bulk < 0 || n_bulk > m / kRows ||
      (n_bulk > 0 && (reinterpret_cast<uintptr_t>(pspec) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const long long smem = mel_smem_bytes(k, n_mels, n_weights, stages, table_in_smem != 0);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* x = (const float*)pspec;
  const float* w = (const float*)weights;
  const int* lo = (const int*)band_lo;
  const int* len = (const int*)band_len;
  const int* off = (const int*)band_off;
  if (table_in_smem)
    return launch<true>(x, w, lo, len, off, (float*)out, m, k, n_mels, frames, log_mult, eps,
                        n_weights, stages, grid, n_bulk, (int)smem, st);
  return launch<false>(x, w, lo, len, off, (float*)out, m, k, n_mels, frames, log_mult, eps,
                       n_weights, stages, grid, n_bulk, (int)smem, st);
}
