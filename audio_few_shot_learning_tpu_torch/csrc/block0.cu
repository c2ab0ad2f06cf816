// Eval-mode block 0 of the conv encoder for Hopper (sm_90a), bound with ctypes.
//
// Replaces no TPU kernel: the JAX package leaves block 0 to XLA, which fuses
// it. On the card the plain path (models/encoders.py::ConvBlock._block, and
// ops/convblock.py::block0_reference) runs four device ops per call: cuDNN's
// 3x3 conv over the one input channel, ATen's separate bias add_ over the
// full-resolution [B, C, H, W] map, max_pool2d and relu. At the flagship's
// 128x157 maps and C = 64 that map is 2.57 MB a map in bf16, written by the
// conv, read and written by the add_, read by the pool: most of an eval
// batch's device time. This kernel computes, from the folded eval weights
// (BatchNorm folded into weight [C, 1, 3, 3] and bias [C]),
//   out[b, k, i, j] = relu(max over the (ph, pw) window of
//                          conv3x3(x[b, 0], weight[k], padding 1) + bias[k])
// in floor mode, and writes only the pooled [B, C, H / ph, W / pw] map,
// channels-last (NHWC: the layout the kernel of blocks 1-3, convblocks.cu,
// reads with 16-byte copies). The conv rows and columns that floor mode drops
// are never computed.
//
// Arithmetic: products and sums in float32 (fmaf, taps in row-major order),
// the bias added in float32 after the max (max commutes with adding a
// constant, and rounding is monotone), one rounding to the output type. The
// plain path in bf16 rounds twice: cuDNN's conv output, then the add_. Max
// and ReLU propagate NaN as max_pool2d and relu do (max.NaN; a bare fmaxf
// would drop it).
//
// Bound on this card: float32 FMAs. Each pooled value needs ph * pw conv
// outputs of 9 taps: 81 FMAs a channel at pool 3. At [200, 1, 128, 157] and
// C = 64 that is 2.26 G FMA (4.5 GFLOP), 0.068 ms at 67 TFLOP/s, against 64
// MB of input and pooled output, 0.019 ms at 3.35 TB/s. So the design keeps
// the FMA pipe fed and spends few other instructions:
// - A block computes a tile of `tile_rows` pooled rows of one map (the grid
//   runs over maps x tiles, so 200 maps make ~1 400 blocks on 132 SMs). It
//   first stages the tile's input rows (tile_rows * ph + 2, with the zero
//   padding written in as a border) in shared memory as float32, one warp a
//   row, and every channel's 9 weights and bias as three float4s.
// - A thread computes one pooled pixel, or two neighbouring pooled columns
//   where the pooled width is even (`PAIR`), for all C channels. At pool
//   3x3, every shipped config's, it keeps its 5 x (3 * PAIR + 2) input
//   patch in registers for the whole channel loop; a channel costs three
//   broadcast shared loads for its weights, 81 (162 with PAIR) FMAs and the
//   maxima, ~190 instructions for 162 FMAs at pool 3. The FMAs go tap by
//   tap over all the thread's conv outputs (18 independent accumulators,
//   the tap's weight in one register), the window's maximum is a tree
//   (4 deep for 9, not a chain of 8), and the channel loop runs 8 channels
//   unrolled, so one channel's maxima overlap the next one's FMAs: together
//   these took [200, 1, 128, 157] from 45% to 53% of the FMA bound on the
//   card. Any other pool reads the patch from shared memory each tap, one
//   pixel a thread.
// - A thread keeps the values of those 8 channels of its pixels and stores
//   them as one 16-byte vector a pixel (bf16; two in float32), into the
//   pixel's contiguous channels; a channel count that is not a multiple of 8
//   stores channel by channel. A warp's stores then fall on 32 different
//   128-byte lines: with 97 registers a thread, 4 blocks of 160 threads an
//   SM, that cost ~7% at 3 700 maps against channel planes. So a block of
//   more than 128 threads runs a build bounded to 80 registers
//   (__launch_bounds__(256, 3)), which fits 5 blocks of 160: at the
//   flagship's 128x157 (160 threads) 2.06 ms against 2.20 at 3 700 maps, 4%
//   slower at 200; blocks of 128 (NSynth's 128x126) fit 5 with 97 registers
//   and ran 11-13% slower bounded. Staging the tile's output in shared
//   memory to store whole lines, or giving a pixel's channel groups to
//   neighbouring threads, was slower.
// The input rows are read with 2-byte (bf16) or 4-byte loads, each warp's
// contiguous: a 128x157 bf16 row is 314 bytes, so rows do not start on
// 16-byte boundaries, and the whole fill is 8 MB an episode against the
// FMAs' 0.068 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBoundThreads = 128;  // larger blocks run the register-bounded build
constexpr int kMaxChannels = 256;
constexpr int kWeightStride = 12;  // floats a channel: 9 taps, the bias, 2 zeros
constexpr int kVec = 8;            // channels a thread stores at once
constexpr int kFill = 8;           // columns a lane loads before it stores them
constexpr int kSmemLimit = 227 * 1024;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// max(a, b), NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void store1(float* o, int64_t i, float v) { o[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, int64_t i, float v) {
  o[i] = __float2bfloat16_rn(v);
}
// n channels of one pixel at o[0 .. n): with `vector` (o 16-byte aligned) and
// n == kVec one 16-byte store (two in float32), else n scalar stores
__device__ __forceinline__ void store_vec(float* o, const float (&v)[kVec], int n, bool vector) {
  if (vector && n == kVec) {
    reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int i = 0; i < n; ++i) o[i] = v[i];
  }
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* o, const float (&v)[kVec], int n, bool vector) {
  if (vector && n == kVec) {
    uint4 p;
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&p);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) q[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(o) = p;
  } else {
    for (int i = 0; i < n; ++i) o[i] = __float2bfloat16_rn(v[i]);
  }
}

int round_channels(int c) { return (c + kVec - 1) / kVec * kVec; }

// Shared-memory bytes of one block (the weights of the channels rounded up to
// kVec, the padding zeros); ops/convblock.py block0_smem_bytes mirrors it.
int64_t block0_smem_bytes(int c, int tile_rows, int ph, int pw, int wp) {
  return 4 * ((int64_t)round_channels(c) * kWeightStride + (int64_t)(tile_rows * ph + 2) * (wp * pw + 2));
}

// PH = PW = 0: the pool (ph, pw) is read at run time and the patch from
// shared memory; PAIR 2 needs an even pooled width.
template <typename T, int PH, int PW, int PAIR, int MIN_BLOCKS>
__global__ void __launch_bounds__(kMaxThreads, MIN_BLOCKS)
    block0_conv_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                       const T* __restrict__ bias, T* __restrict__ out, int h, int w, int c,
                       int ph_arg, int pw_arg, int tile_rows, int tiles_per_map) {
  const int ph = PH > 0 ? PH : ph_arg;
  const int pw = PW > 0 ? PW : pw_arg;
  const int hp = h / ph, wp = w / pw;
  const int map = blockIdx.x / tiles_per_map;
  const int r0 = (blockIdx.x - map * tiles_per_map) * tile_rows;  // the tile's first pooled row
  const int rows = min(tile_rows, hp - r0);
  const int sw = wp * pw + 2;  // tile width: input columns -1 .. wp * pw
  const int in_rows = rows * ph + 2;

  extern __shared__ float4 smem[];
  const int cr = (c + kVec - 1) / kVec * kVec;
  float* ws = reinterpret_cast<float*>(smem);  // [cr][kWeightStride], zeros past c
  float* tile = ws + cr * kWeightStride;       // [in_rows][sw]: input rows r0 * ph - 1 ..
  for (int i = threadIdx.x; i < cr * kWeightStride; i += blockDim.x) {
    const int k = i / kWeightStride, e = i - k * kWeightStride;
    ws[i] = k >= c ? 0.f : e < 9 ? to_f32(weight[k * 9 + e]) : e == 9 ? to_f32(bias[k]) : 0.f;
  }
  const T* xm = x + (int64_t)map * h * w;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < in_rows; t += warps) {
    const int ir = r0 * ph - 1 + t;
    const bool row_in = ir >= 0 && ir < h;
    const T* xr = xm + (int64_t)ir * w;
    for (int s0 = 0; s0 < sw; s0 += 32 * kFill) {
      float v[kFill];
#pragma unroll
      for (int u = 0; u < kFill; ++u) {
        const int ic = s0 + lane + 32 * u - 1;
        v[u] = row_in && ic >= 0 && ic < w ? to_f32(xr[ic]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFill; ++u) {
        const int s = s0 + lane + 32 * u;
        if (s < sw) tile[t * sw + s] = v[u];
      }
    }
  }
  __syncthreads();

  const int per_row = wp / PAIR;
  const int items = rows * per_row;
  T* om = out + (int64_t)map * hp * wp * c;  // the map's [hp][wp][c]
  for (int p = threadIdx.x; p < items; p += blockDim.x) {
    const int r = p / per_row;
    const int col = (p - r * per_row) * PAIR;           // the thread's first pooled column
    const float* src = tile + r * ph * sw + col * pw;   // its patch's top left
    const int64_t o = ((int64_t)(r0 + r) * wp + col) * c;  // its first pixel's channels
    if constexpr (PH > 0) {
      constexpr int kRows = PH + 2, kCols = PAIR * PW + 2;
      float patch[kRows][kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int b = 0; b < kCols; ++b) patch[a][b] = src[a * sw + b];
      // kVec channels at a time, then one vector store a pixel (vector
      // stores need every pixel's channels 16-byte aligned: c % kVec == 0)
      const bool vector = c % kVec == 0;
      for (int k0 = 0; k0 < c; k0 += kVec) {
        float vals[PAIR][kVec];
#pragma unroll
        for (int kk = 0; kk < kVec; ++kk) {
          const int k = k0 + kk;  // past c: zero weights and bias, not stored
          const float4 q0 = smem[3 * k], q1 = smem[3 * k + 1], q2 = smem[3 * k + 2];
          const float wk[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
          // tap by tap over all PAIR * PH * PW conv outputs: independent FMAs
          // back to back, each tap's weight read from one register; each
          // output still sums its taps in row-major order
          float acc[PAIR][PH][PW];
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
#pragma unroll
            for (int u = 0; u < PAIR; ++u)
#pragma unroll
              for (int dy = 0; dy < PH; ++dy)
#pragma unroll
                for (int dx = 0; dx < PW; ++dx) {
                  const float v = patch[dy + tap / 3][u * PW + dx + tap % 3];
                  acc[u][dy][dx] = tap == 0 ? v * wk[0] : fmaf(v, wk[tap], acc[u][dy][dx]);
                }
#pragma unroll
          for (int u = 0; u < PAIR; ++u) {
            // the window's maximum as a tree: PH * PW - 1 maxima, log2 deep
            float m[PH * PW];
#pragma unroll
            for (int i = 0; i < PH * PW; ++i) m[i] = acc[u][i / PW][i % PW];
#pragma unroll
            for (int step = 1; step < PH * PW; step *= 2)
#pragma unroll
              for (int i = 0; i + step < PH * PW; i += 2 * step) m[i] = max_nan(m[i], m[i + step]);
            vals[u][kk] = max_nan(m[0] + q2.y, 0.f);
          }
        }
        const int n = min(kVec, c - k0);
#pragma unroll
        for (int u = 0; u < PAIR; ++u) store_vec(om + o + u * c + k0, vals[u], n, vector);
      }
    } else {
      for (int k = 0; k < c; ++k) {
        const float4 q0 = smem[3 * k], q1 = smem[3 * k + 1], q2 = smem[3 * k + 2];
        const float wk[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
        float m = 0.f;
        for (int dy = 0; dy < ph; ++dy)
          for (int dx = 0; dx < pw; ++dx) {
            const float* s = src + dy * sw + dx;
            float acc = s[0] * wk[0];
#pragma unroll
            for (int tap = 1; tap < 9; ++tap) acc = fmaf(s[(tap / 3) * sw + tap % 3], wk[tap], acc);
            m = dy == 0 && dx == 0 ? acc : max_nan(m, acc);
          }
        store1(om, o + k, max_nan(m + q2.y, 0.f));
      }
    }
  }
}

template <typename T, int PH, int PW, int PAIR, int MIN_BLOCKS>
int launch(const void* x, const void* weight, const void* bias, void* out, int n_maps, int h,
           int w, int c, int ph, int pw, int tile_rows, int tiles_per_map, int threads, int smem,
           void* stream) {
  const int hp = h / ph, wp = w / pw;
  const int64_t blocks = (int64_t)n_maps * tiles_per_map;
  if (tile_rows < 1 || tiles_per_map != (hp + tile_rows - 1) / tile_rows || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || blocks > 0x7fffffff ||
      smem != block0_smem_bytes(c, tile_rows, ph, pw, wp) || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if ((PAIR == 2 && wp % 2 != 0) || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static bool smem_set[kMaxDevices];  // one per instantiation and device
  if (smem > kDefaultSmem && !smem_set[dev]) {
    err = cudaFuncSetAttribute(block0_conv_kernel<T, PH, PW, PAIR, MIN_BLOCKS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  block0_conv_kernel<T, PH, PW, PAIR, MIN_BLOCKS><<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)weight, (const T*)bias, (T*)out, h, w, c, ph, pw, tile_rows,
      tiles_per_map);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* weight, const void* bias, void* out, int n_maps, int h,
             int w, int c, int ph, int pw, int tile_rows, int tiles_per_map, int threads, int pair,
             int smem, void* stream) {
  if (n_maps <= 0 || h <= 0 || w <= 0 || c <= 0 || c > kMaxChannels || ph <= 0 || pw <= 0 ||
      ph > h || pw > w || (pair != 1 && pair != 2))
    return (int)cudaErrorInvalidValue;
#define AFSL_BLOCK0_LAUNCH(PH, PW, PAIR, MIN_BLOCKS)                                        \
  launch<T, PH, PW, PAIR, MIN_BLOCKS>(x, weight, bias, out, n_maps, h, w, c, ph, pw, tile_rows, \
                                      tiles_per_map, threads, smem, stream)
  // blocks of more than kBoundThreads threads: the build that fits 5 of 160 an SM
  if (ph == 3 && pw == 3 && threads > kBoundThreads)
    return pair == 2 ? AFSL_BLOCK0_LAUNCH(3, 3, 2, 3) : AFSL_BLOCK0_LAUNCH(3, 3, 1, 3);
  if (ph == 3 && pw == 3) return pair == 2 ? AFSL_BLOCK0_LAUNCH(3, 3, 2, 1) : AFSL_BLOCK0_LAUNCH(3, 3, 1, 1);
  if (pair != 1) return (int)cudaErrorInvalidValue;
  return AFSL_BLOCK0_LAUNCH(0, 0, 1, 1);
#undef AFSL_BLOCK0_LAUNCH
}

}  // namespace

// x [B, 1, H, W], weight [C, 1, 3, 3], bias [C], all of one type and
// contiguous, and out [B, H / ph, W / pw, C] (a channels-last
// [B, C, H / ph, W / pw]), on the device of `stream`. tile_rows,
// tiles_per_map, threads, pair and smem are the wrapper's plan
// (ops/convblock.py::block0_plan).
extern "C" int afsl_block0_f32(const void* x, const void* weight, const void* bias, void* out,
                               int n_maps, int h, int w, int c, int ph, int pw, int tile_rows,
                               int tiles_per_map, int threads, int pair, int smem, void* stream) {
  return dispatch<float>(x, weight, bias, out, n_maps, h, w, c, ph, pw, tile_rows, tiles_per_map,
                         threads, pair, smem, stream);
}

extern "C" int afsl_block0_bf16(const void* x, const void* weight, const void* bias, void* out,
                                int n_maps, int h, int w, int c, int ph, int pw, int tile_rows,
                                int tiles_per_map, int threads, int pair, int smem, void* stream) {
  return dispatch<__nv_bfloat16>(x, weight, bias, out, n_maps, h, w, c, ph, pw, tile_rows,
                                 tiles_per_map, threads, pair, smem, stream);
}
