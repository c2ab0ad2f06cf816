// Eval-mode conv blocks 1-3 of the conv encoder for Hopper (sm_90a), bound with ctypes.
//
// Replaces no TPU kernel: the JAX package leaves these blocks to XLA, which
// fuses them. On the card the plain path (models/encoders.py::ConvBlock._block,
// and ops/convblock.py::blocks_reference) runs, per block, cuDNN's NCHW -> NHWC
// transpose, its implicit-GEMM conv, the transpose back, ATen's separate bias
// add_, max_pool2d and relu, each writing or reading the full-resolution
// [B, C, H, W] map (280 KB a map at the flagship's 42x52 in bf16). This kernel
// computes, from the folded eval weights (BatchNorm folded into weight
// [C, C, 3, 3] and bias [C]),
//   out[b, k, i, j] = relu(max over the (ph, pw) window of
//                          conv3x3(x[b], weight[k], padding 1) + bias[k])
// in floor mode, and writes only the pooled map. The conv rows and columns
// that floor mode drops are never computed. Activations are bf16 and
// channels-last in device memory (NHWC: ops/convblock.py allocates them with
// torch.channels_last), its input as block 0's kernel (block0.cu) or this
// kernel wrote it, its output as this kernel's next launch reads it.
//
// Arithmetic: bf16 products summed in float32 on the tensor cores
// (mma.sync m16n8k16), the bias added in float32 after the max, one rounding
// to bf16. The plain path in bf16 rounds twice: cuDNN's conv output, then
// the add_. Max and ReLU propagate NaN as max_pool2d and relu do (max.NaN).
//
// Bound on this card: the tensor cores. As a GEMM, M is the conv outputs the
// pool reads, N = C output channels, K = 9 taps x C input channels (576 at
// C = 64). At the flagship's 42x52 (block 1) a map is 2 x 576 x 64 x 2 184
// = 161 MFLOP against 280 KB read and 30.5 KB written: ~520 FLOP a byte,
// above the card's ~295. mma.sync (m16n8k16) reaches 635 TFLOP/s on this
// card with 8 or more warps an SM, 556 with 4 (a register-only loop), 64%
// of the 989.4 that wgmma can reach; the design keeps two warps a scheduler
// on products and the copies off their path:
// - The folded weights, 576 x 64 bf16 (72 KB), stay in shared memory for the
//   life of a block; blocks are persistent (one per SM), so the weights are
//   read once a block and not once a tile. Each row of 576 is stored with
//   its 16-byte chunks XOR-swizzled by the row, so the ldmatrix reads of 8
//   rows hit 8 different banks.
// - A block holds two teams of four warps, which take its tiles in turn.
//   A tile is at most 32 pooled pixels: for the flagship's maps a rectangle
//   of 2 pooled rows x 16 columns within a map, and a strip of the 17th
//   column (ops/convblock.py::blocks_plan cuts them; small maps go as runs
//   of pixels across maps). Its input is held as slots, one per input row
//   it reads, each its columns' input pixels of 64 channels (128 bytes;
//   fewer channels arrive as zeros).
// - Tiles pass through a ring of three stages (51 KB each at 42x52) beside
//   the weights. The team that finishes a tile refills its stage with the
//   tile three ahead, which the other team computes: one lane issues one
//   tensor-memory-accelerator copy for a rectangle's slots (a run: a copy a
//   slot, shared by a warp's lanes), which zero-fills the padding and
//   completes on the stage's mbarrier. So a tile's copy starts one and a
//   half of a team's tiles before it is needed and no thread waits on it.
//   (Per-thread cp.async copies, 16 bytes each, stalled the issuing warps
//   for as long as the copies took: the copies and the products then added
//   up; a copy a slot cost its lane ~500 cycles, so a rectangle is one box.)
// - The copies' 128-byte swizzle puts 16-byte chunk j of the stage's pixel
//   p at chunk j ^ (p & 7). An ldmatrix reads 8 consecutive pooled pixels
//   of a tile at one window position, pixels p, p + pw, ..: 8 banks while
//   pw is odd and the 8 lie in one pooled row (the plan's slot pitch keeps
//   them so where a run's rows wrap).
// - A warp computes 16 pooled pixels x 32 output channels. Its M rows are
//   ordered window position major: m-tile i holds window position i of the
//   16 pixels, so after the K loop a thread holds every window position of
//   its two pixels (rows g and g + 8 of each m-tile) and the max-pool is
//   ph * pw - 1 register maxima, with no shuffle and no shared memory. Per
//   k-step of 16 the warp reads 9 + 2 ldmatrix.x4 for 36 mma at pool 3x3.
// - The epilogue adds the bias, applies ReLU, rounds once and stores bf16
//   pairs (two output channels of a pixel) to the NHWC output.

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types; the function comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCP = 64;                        // channels computed (C <= 64, padded with zeros)
constexpr int kPixelBytes = kCP * 2;           // 128: one bank row
constexpr int kWeightRowBytes = 9 * kCP * 2;   // 1 152 bytes of K a output channel
constexpr int kWeightBytes = kCP * kWeightRowBytes;  // 73 728
constexpr int kTeamThreads = 128;
constexpr int kThreads = 2 * kTeamThreads;
constexpr int kMaxTilePx = 32;
constexpr int kMaxStages = 3;
constexpr int kRingHeader = 1024;  // the stages' barriers and fill counts; stages 1024-byte aligned (the swizzle)
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(kTeamThreads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Shape {
  int h, w, c, hp, wp;
  int64_t hwp;    // pooled pixels a map
  int64_t total;  // pooled pixels of all maps
  int mode;       // 0: runs of tile_px pixels across maps; 1: rectangles within a map
  int tile_px;
  int rr, rc;     // mode 1: main rectangles of rr pooled rows x rc pooled columns
  int sr, sw;     // mode 1: the right strip's rectangles, sr rows x sw = wp % rc columns
  int pitch;      // mode 0: input pixels from one slot to the next in shared memory (>= the width)
  int stage_bytes, stages;
};

// One tile and the input it reads: pooled pixels [q0, q0 + n) of the
// concatenated maps (mode 0), or the rectangle of `cols` pooled columns from
// col_lo and n / cols rows from lo0 of map m0 (mode 1). Its slots hold input
// rows: the first map's rows0 from pooled row lo0, each later map's
// ph * hp + 2 from input row -1; each slot `width` input pixels from pooled
// column col_lo, `pitch` apart in the stage. ops/convblock.py::tile_geometry
// mirrors it.
struct Tile {
  int64_t q0, m0;
  int n, cols, lo0, rows0, col_lo, width, pitch, slots;
};

template <int PH, int PW>
__device__ __forceinline__ Tile tile_of(int64_t t, const Shape& s) {
  Tile g;
  if (s.mode == 1) {
    const int n_mc = s.wp / s.rc, n_main = (s.hp + s.rr - 1) / s.rr * n_mc;
    const int per_map = n_main + (s.sw > 0 ? (s.hp + s.sr - 1) / s.sr : 0);
    g.m0 = t / per_map;
    int k = (int)(t - g.m0 * per_map), rows;
    if (k < n_main) {
      const int bi = k / n_mc;
      g.lo0 = bi * s.rr;
      g.col_lo = (k - bi * n_mc) * s.rc;
      g.cols = s.rc;
      rows = min(s.rr, s.hp - g.lo0);
    } else {
      k -= n_main;
      g.lo0 = k * s.sr;
      g.col_lo = n_mc * s.rc;
      g.cols = s.sw;
      rows = min(s.sr, s.hp - g.lo0);
    }
    g.n = rows * g.cols;
    g.q0 = g.m0 * s.hwp;
    g.width = g.pitch = PW * g.cols + 2;
    g.rows0 = g.slots = PH * rows + 2;
    return g;
  }
  const int64_t q0 = t * s.tile_px;
  const int n = (int)min((int64_t)s.tile_px, s.total - q0);
  g.q0 = q0;
  g.n = n;
  g.cols = 0;
  g.m0 = q0 / s.hwp;
  const int r0 = (int)(q0 - g.m0 * s.hwp);
  const int64_t qe = q0 + n - 1;
  const int64_t m1 = qe / s.hwp;
  const int r1 = (int)(qe - m1 * s.hwp);
  g.lo0 = r0 / s.wp;
  const int hi1 = r1 / s.wp;
  g.col_lo = 0;
  g.width = PW * s.wp + 2;
  g.pitch = s.pitch;
  if (m1 == g.m0) {
    g.rows0 = g.slots = PH * (hi1 - g.lo0 + 1) + 2;
  } else {
    g.rows0 = PH * (s.hp - g.lo0) + 2;
    g.slots = g.rows0 + (int)(m1 - g.m0 - 1) * (PH * s.hp + 2) + PH * (hi1 + 1) + 2;
  }
  return g;
}

// Pixel r of tile g: its map, pooled row and column.
__device__ __forceinline__ void pixel_of(const Tile& g, int r, const Shape& s, int64_t& m, int& py, int& px) {
  if (g.cols > 0) {
    m = g.m0;
    py = r / g.cols;
    px = g.col_lo + (r - py * g.cols);
    py += g.lo0;
  } else {
    const int64_t q = g.q0 + r;
    m = q / s.hwp;
    const int rem = (int)(q - m * s.hwp);
    py = rem / s.wp;
    px = rem - py * s.wp;
  }
}

// Copy the tile's slots into a stage with the tensor memory accelerator,
// issued by the 32 lanes of one warp; channels, rows and columns outside the
// map arrive as zeros, and the 128-byte swizzle puts 16-byte chunk j of the
// stage's pixel p at chunk j ^ (p & 7). A rectangle is one copy, its slots'
// box of 64 channels x `width` pixels x its slots' rows of one map from
// column PW * col_lo - 1 and row PH * lo0 - 1 (the padding). A run takes a
// copy a slot (each lane some), the box of one row of one map. The stage's
// barrier expects the bytes, which complete its phase.
template <int PH, int PW>
__device__ __forceinline__ void load_tile(const CUtensorMap* tmap, uint32_t buf, uint32_t bar, const Tile& g,
                                          const Shape& s, int lane) {
  const int col0 = PW * g.col_lo - 1;
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"((g.cols > 0 ? (g.cols == s.rc ? PH * s.rr + 2 : PH * s.sr + 2) : g.slots) * g.width * kPixelBytes)
                 : "memory");
  __syncwarp();
  const int rows_map = PH * s.hp + 2;
  for (int slot = g.cols > 0 ? 0 : lane; slot < (g.cols > 0 ? (lane == 0) : g.slots); slot += 32) {
    int map, row;
    if (slot < g.rows0) {
      map = (int)g.m0;
      row = PH * g.lo0 - 1 + slot;
    } else {
      const int k = (slot - g.rows0) / rows_map;
      map = (int)g.m0 + 1 + k;
      row = slot - g.rows0 - k * rows_map - 1;
    }
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
        "[%6];" ::"r"(buf + (uint32_t)(slot * g.pitch) * kPixelBytes),
        "l"(reinterpret_cast<uint64_t>(tmap)), "r"(0), "r"(col0), "r"(row), "r"(map), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

template <int PH, int PW>
__global__ void __launch_bounds__(kThreads, 1)
    blocks_conv_kernel(const __grid_constant__ CUtensorMap x_main, const __grid_constant__ CUtensorMap x_strip,
                       const __nv_bfloat16* __restrict__ weight, const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, Shape s, int64_t tiles) {
  constexpr int kWin = PH * PW;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ws = smem_u32(smem);
  const int c = s.c;
  // after the weights: a full barrier and a fill count a stage, then the stages
  const uint32_t bars = ws + kWeightBytes;
  volatile int* fills = reinterpret_cast<volatile int*>(smem + kWeightBytes + 8 * kMaxStages);
  const uint32_t stage0 = ws + kWeightBytes + kRingHeader;

  // weights: [n][k = tap * 64 + ci] bf16, chunk kk of row n at (kk & ~7) | ((kk ^ n) & 7)
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < kWeightBytes / 16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
    if (threadIdx.x < s.stages) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bars + 8 * threadIdx.x) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      fills[threadIdx.x] = -1;
    }
    __syncthreads();
    const int per_n = c * 9;
    for (int i = threadIdx.x; i < c * per_n; i += kThreads) {  // in the tensor's own order: coalesced
      const int n = i / per_n, rem = i - n * per_n;
      const int ci = rem / 9, tap = rem - ci * 9;
      const int k = tap * kCP + ci, kk = k >> 3;
      const int phys = (kk & ~7) | ((kk ^ n) & 7);
      reinterpret_cast<__nv_bfloat16*>(smem + n * kWeightRowBytes + phys * 16)[k & 7] = weight[i];
    }
    __syncthreads();
  }

  const int team = threadIdx.x / kTeamThreads, tt = threadIdx.x % kTeamThreads;
  const int warp = tt >> 5, lane = tt & 31;
  const int gi = warp >> 1, nh = warp & 1;  // the warp's 16 pixels of the tile, its 32 channels
  const int g8 = lane >> 2, t4 = lane & 3;
  const int kc_steps = (c + 15) / 16;

  // B fragments: x4 number b covers output channels nh * 32 + 16 b .. + 15;
  // lane l addresses row n = .. + (l & 7) + 8 (l >> 4), k half (l >> 3) & 1.
  // kc (16 input channels) flips bits 5-6: address = bbase[b] ^ (kc << 5) + tap * 128
  uint32_t bbase[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int n = nh * 32 + 16 * b + (lane & 7) + 8 * (lane >> 4);
    bbase[b] = ws + n * kWeightRowBytes + (((((lane >> 3) & 1) ^ n) & 7) << 4);
  }
  float bias_v[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = nh * 32 + 8 * j + 2 * t4 + e;
      bias_v[j][e] = n < c ? __bfloat162float(bias[n]) : 0.f;
    }

  // The block's tiles i = 0, 1, .. (tile blockIdx.x + i * gridDim.x) go to
  // the teams in turn (team i % 2) and through the stages in a ring (stage
  // i % stages). The team that finishes tile i refills its stage with tile
  // i + stages, one thread issuing the copies: with 3 stages a tile's copy
  // starts one and a half of the team's own tiles before the team that
  // computes it needs it. The fill count, set once a fill is issued, keeps
  // a waiter from reading the stage barrier's previous phase.
  const auto fill = [&](int64_t i) {
    const int64_t t = blockIdx.x + i * gridDim.x;
    if (t >= tiles || warp != 0) return;
    const int b = (int)(i % s.stages);
    const Tile g = tile_of<PH, PW>(t, s);
    load_tile<PH, PW>(g.cols > 0 && g.cols != s.rc ? &x_strip : &x_main, stage0 + b * s.stage_bytes, bars + 8 * b,
                      g, s, lane);
    __syncwarp();
    if (lane == 0) fills[b] = (int)(i / s.stages);
  };
  if (tt == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&x_main)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&x_strip)) : "memory");
  }
  for (int64_t i = team; i < s.stages; i += 2) fill(i);

  for (int64_t i = team;; i += 2) {
    const int64_t t = blockIdx.x + i * gridDim.x;
    if (t >= tiles) break;
    const Tile g = tile_of<PH, PW>(t, s);
    const int b = (int)(i % s.stages), phase = (int)(i / s.stages);
    while (fills[b] < phase) {
    }
    mbar_wait(bars + 8 * b, phase & 1);
    const uint32_t buf = stage0 + b * s.stage_bytes;

    if (gi * 16 < g.n && nh * 32 < c) {
      // the pixel this lane addresses for ldmatrix: row (l & 7) + 8 ((l >> 3) & 1)
      // of each m-tile; rows past the tile read its last pixel (the same
      // address as a row of their 8, or as all 8: no bank conflict)
      int r = gi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      if (r >= g.n) r = g.n - 1;
      int64_t m;
      int py, px;
      pixel_of(g, r, s, m, py, px);
      const int srow = m == g.m0 ? PH * (py - g.lo0)
                                 : g.rows0 + (int)(m - g.m0 - 1) * (PH * s.hp + 2) + PH * py;
      const int scol = PW * (px - g.col_lo);
      const int ahalf = lane >> 4;

      float acc[kWin][4][4];
#pragma unroll
      for (int i2 = 0; i2 < kWin; ++i2)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i2][j][e] = 0.f;

#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ty = tap / 3, tx = tap % 3;
        // each m-tile's row address for this tap: pixel (srow + dy + ty, scol + dx + tx)
        // of the stage, its chunk (2 kc + ahalf) ^ (pixel & 7)
        uint32_t arow[kWin];
#pragma unroll
        for (int i2 = 0; i2 < kWin; ++i2) {
          const int pix = (srow + i2 / PW + ty) * g.pitch + scol + i2 % PW + tx;
          arow[i2] = buf + (uint32_t)pix * kPixelBytes + (uint32_t)((ahalf ^ (pix & 7)) << 4);
        }
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          if (kc < kc_steps) {
            uint32_t bf[4][2];
            ldmatrix_x4((bbase[0] ^ (kc << 5)) + tap * 128, bf[0][0], bf[0][1], bf[1][0], bf[1][1]);
            ldmatrix_x4((bbase[1] ^ (kc << 5)) + tap * 128, bf[2][0], bf[2][1], bf[3][0], bf[3][1]);
#pragma unroll
            for (int i2 = 0; i2 < kWin; ++i2) {
              uint32_t a[4];
              ldmatrix_x4(arow[i2] ^ (kc << 5), a[0], a[1], a[2], a[3]);
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_bf16(acc[i2][j], a, bf[j][0], bf[j][1]);
            }
          }
        }
      }

      // pool over the window positions, bias, ReLU, one rounding; rows g8 and g8 + 8
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = gi * 16 + g8 + 8 * h;
        if (rr >= g.n) continue;
        pixel_of(g, rr, s, m, py, px);
        __nv_bfloat16* o = out + ((m * s.hp + py) * s.wp + px) * c + nh * 32 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nh * 32 + 8 * j + 2 * t4 >= c) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float mx[kWin];
#pragma unroll
            for (int i2 = 0; i2 < kWin; ++i2) mx[i2] = acc[i2][j][2 * h + e];
#pragma unroll
            for (int step = 1; step < kWin; step *= 2)
#pragma unroll
              for (int i2 = 0; i2 + step < kWin; i2 += 2 * step) mx[i2] = max_nan(mx[i2], mx[i2 + step]);
            v[e] = max_nan(mx[0] + bias_v[j][e], 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
    team_sync(team);  // the team has read the stage: refill it
    fill(i + s.stages);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// x [B, H, W, C] as a 4-d tensor for the tensor memory accelerator, boxes of
// 64 channels (past C: zeros) x `width` pixels x `rows` rows of one map,
// swizzled by 128 bytes.
int encode_input(CUtensorMap* map, const void* x, int n_maps, int h, int w, int c, int width, int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n_maps};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2, (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kCP, (cuuint32_t)width, (cuuint32_t)rows, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int PH, int PW>
int launch(const void* x, const void* weight, const void* bias, void* out, const Shape& s, int n_maps,
           int64_t tiles, int ctas, int smem, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  CUtensorMap x_main, x_strip;
  // a rectangle's box holds its slots' rows, a run's one row
  const bool rects = s.mode == 1;
  const int main_width = PW * (rects ? s.rc : s.wp) + 2, main_rows = rects ? PH * s.rr + 2 : 1;
  int status = encode_input(&x_main, x, n_maps, s.h, s.w, s.c, main_width, main_rows);
  if (status == 0)
    status = s.sw > 0 ? encode_input(&x_strip, x, n_maps, s.h, s.w, s.c, PW * s.sw + 2, PH * s.sr + 2)
                      : encode_input(&x_strip, x, n_maps, s.h, s.w, s.c, main_width, main_rows);
  if (status != 0) return status;
  static bool smem_set[kMaxDevices];  // one per instantiation and device
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(blocks_conv_kernel<PH, PW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  blocks_conv_kernel<PH, PW><<<ctas, kThreads, smem, (cudaStream_t)stream>>>(
      x_main, x_strip, (const __nv_bfloat16*)weight, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, s, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] (a channels-last [B, C, H, W]), weight [C, C, 3, 3], bias [C],
// out [B, H / ph, W / pw, C] (channels-last), all bf16 and 16-byte aligned,
// on the device of `stream`; 8 <= C <= 64, C a multiple of 8, 1 <= ph, pw
// <= 3. The tiles (mode, tile_px, rr, rc, sr), a run's slot pitch, stages,
// stage_bytes, tiles and ctas are the wrapper's plan (ops/convblock.py::
// blocks_plan); smem is the weights' 73 728 bytes, the ring's 1 024 and the
// stages'.
extern "C" int afsl_blocks_bf16(const void* x, const void* weight, const void* bias, void* out, int n_maps,
                                int h, int w, int c, int ph, int pw, int mode, int tile_px, int rr, int rc,
                                int sr, int pitch, int stages, int stage_bytes, long long tiles, int ctas, int smem,
                                void* stream) {
  if (n_maps <= 0 || h <= 0 || w <= 0 || c < 8 || c > kCP || c % 8 != 0 || ph < 1 || ph > 3 || pw < 1 ||
      pw > 3 || ph > h || pw > w || mode < 0 || mode > 1 || stages < 2 || stages > kMaxStages ||
      stage_bytes <= 0 || stage_bytes % 1024 != 0 || tiles <= 0 || ctas <= 0 ||
      smem != kWeightBytes + kRingHeader + stages * stage_bytes || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int hp = h / ph, wp = w / pw;
  if (mode == 0 ? (tile_px < 1 || tile_px > kMaxTilePx || pw * wp + 2 > 256 || pitch < pw * wp + 2)
                : (rr < 1 || rc < 1 || rc > wp || rr * rc > kMaxTilePx ||
                   (wp % rc > 0 && (sr < 1 || sr * (wp % rc) > kMaxTilePx))))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(weight) |
       reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.h = h;
  s.w = w;
  s.c = c;
  s.hp = hp;
  s.wp = wp;
  s.hwp = (int64_t)hp * wp;
  s.total = s.hwp * n_maps;
  s.mode = mode;
  s.tile_px = tile_px;
  s.rr = rr;
  s.rc = rc;
  s.sr = sr;
  s.sw = mode == 1 ? wp % rc : 0;
  s.pitch = pitch;
  s.stage_bytes = stage_bytes;
  s.stages = stages;
#define AFSL_BLOCKS_LAUNCH(PH, PW) \
  if (ph == PH && pw == PW) return launch<PH, PW>(x, weight, bias, out, s, n_maps, tiles, ctas, smem, stream)
  AFSL_BLOCKS_LAUNCH(3, 3);
  AFSL_BLOCKS_LAUNCH(2, 2);
  AFSL_BLOCKS_LAUNCH(3, 2);
  AFSL_BLOCKS_LAUNCH(2, 3);
  AFSL_BLOCKS_LAUNCH(1, 1);
  AFSL_BLOCKS_LAUNCH(1, 2);
  AFSL_BLOCKS_LAUNCH(2, 1);
  AFSL_BLOCKS_LAUNCH(1, 3);
  AFSL_BLOCKS_LAUNCH(3, 1);
#undef AFSL_BLOCKS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
