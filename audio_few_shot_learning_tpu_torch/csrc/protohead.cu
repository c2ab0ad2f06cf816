// Batched prototypical episode head for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel audio_few_shot_learning_tpu/ops/protohead.py::
// _batched_episode_scores_pallas. Per episode e:
//   protos[n]   = sum_{s: label[s]==n} support[s] / max(count[n], 1)
//   scores[q,n] = -sqrt(max(|q|^2 + |p_n|^2 - 2 q.p_n, 0) + 1e-24)
// the expansion form of batched_episode_scores_reference, with empty classes
// (count 0) giving an all-zero prototype and labels outside [0, N) ignored,
// as the one-hot matmul does.
//
// Bound on this card: the inputs are tiny. At the flagship eval batch
// (E=16, S=Q=25, D=256, N=5) support + queries + labels + scores are about
// 0.83 MB, ~0.25 us at 3.35 TB/s, and ~0.8 MFLOP; a launch alone costs a few
// microseconds. The kernel is launch-latency bound, so the design cuts the
// chain of dependent steps inside a block:
//
// - One memory round. A block (episode e, a tile of up to q_tile queries)
//   issues every global read at once with cp.async (16 bytes a thread where
//   aligned): its query rows and its episode's support rows into shared
//   memory, the labels by plain loads issued ahead of them. Warp 0 stages the
//   labels and counts the classes by ballot while the copies fly, from the
//   same registers. Blocks of one episode rebuild the same
//   prototypes from the support, which the first of them brings into L2.
// - Prototypes from shared memory: each thread owns feature columns and walks
//   the support rows once, 8 rows' loads in flight at a time, keeping a
//   running sum in a register while the label repeats. The score pass scales
//   each class sum by 1 / count as it reads it (within an ulp of the plain
//   version's division), so no pass of its own divides.
// - One pass per query row: warp w takes query rows w, w+8, ...; each lane
//   reads its columns of the row once per group of 7 classes and accumulates
//   |q|^2, the 7 cross products and the 7 prototype norms together; one
//   butterfly reduce-scatter (16 shuffles over 5 steps) reduces all 15 sums.
//
// Support, queries and labels are read through their episode strides (rows
// within an episode contiguous), so the eval path's slices of the attention
// output and its expanded int64 labels go in without a copy. A support set
// larger than the shared memory the launch plan allows is staged in chunks of
// s_chunk rows (ops/protohead.py head_plan).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kClassGroup = 7;  // classes per reduction: 7 + 7 + 1 sums in 16 slots
constexpr int kUnroll = 8;      // support rows whose loads are issued together
constexpr int kSmemLimit = 227 * 1024;

__host__ __device__ constexpr long long round4(long long x) { return (x + 3) & ~3LL; }

// Shared-memory floats of one block; ops/protohead.py head_plan mirrors it.
long long head_smem_bytes(int n_way, int dim, int q_tile, int s_chunk) {
  return 4 * (round4((long long)n_way * dim) + round4((long long)q_tile * dim) +
              round4((long long)s_chunk * dim) + round4(n_way) + s_chunk);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Issue the copy of n floats from src to 16-byte aligned shared dst with
// cp.async: 16 bytes a thread when src is 16-byte aligned and n % 4 == 0,
// else 4 bytes. The caller waits with cp_async_wait_all().
__device__ __forceinline__ void stage_async(float* dst, const float* src, int n) {
  if (((reinterpret_cast<uintptr_t>(src) & 15) | (n & 3)) == 0) {
    for (int i = threadIdx.x; i < (n >> 2); i += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + 4 * i)),
                   "l"(src + 4 * i)
                   : "memory");
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst + i)),
                   "l"(src + i)
                   : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename Label>
__device__ __forceinline__ int class_of(Label v, int n_way) {
  return (v >= 0 && v < n_way) ? (int)v : -1;
}

// Adds support value v of class c (-1: ignored) to column d's running sum of
// class cur, first flushing the sum to protos when the class changes.
__device__ __forceinline__ void add_row(float* protos, int dim, int d, int c, float v, int& cur,
                                        float& acc) {
  if (c != cur) {
    if (cur >= 0) protos[cur * dim + d] += acc;
    acc = 0.0f;
    cur = c;
  }
  acc += v;
}

// One step of the butterfly: lanes whose bit `Off` is set keep the upper
// half of their H pairs of values, the others the lower half, and each adds
// the half its partner lane gives up.
template <int H, int Off>
__device__ __forceinline__ void butterfly_step(float (&v)[16], int lane) {
  const bool upper = (lane & Off) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, Off);
  }
}

// Warp sum of 16 values at once; lanes 2i and 2i+1 get the sum of slot i.
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
  butterfly_step<8, 16>(v, lane);
  butterfly_step<4, 8>(v, lane);
  butterfly_step<2, 4>(v, lane);
  butterfly_step<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <typename Label>
__global__ void __launch_bounds__(kThreads)
    episode_scores_kernel(const float* __restrict__ support, long long sup_stride,
                          const Label* __restrict__ labels, long long lab_stride_e,
                          long long lab_stride_s, const float* __restrict__ queries,
                          long long qry_stride, float* __restrict__ out, int n_support,
                          int n_query, int dim, int n_way, int q_tile, int s_chunk) {
  extern __shared__ __align__(16) float smem[];
  float* protos = smem;                                   // [n_way, dim]
  float* qtile = protos + round4((long long)n_way * dim);  // [q_tile, dim]
  float* sup = qtile + round4((long long)q_tile * dim);    // [s_chunk, dim]
  float* inv_counts = sup + round4((long long)s_chunk * dim);   // [n_way]
  int* lab = reinterpret_cast<int*>(inv_counts + round4(n_way));  // [s_chunk]

  const int tiles = (n_query + q_tile - 1) / q_tile;
  const int e = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - e * tiles) * q_tile;
  const int nq = min(q_tile, n_query - q0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* sup_e = support + e * sup_stride;
  const Label* lab_e = labels + e * lab_stride_e;

  // --- one memory round: the first 32 labels (warp 0, into registers), the
  // query tile and the first support chunk (cp.async), all issued before
  // anything waits ---
  Label first = -1;
  if (warp == 0 && lane < n_support) first = lab_e[lane * lab_stride_s];
  stage_async(qtile, queries + e * qry_stride + (long long)q0 * dim, nq * dim);
  int rows = min(s_chunk, n_support);
  stage_async(sup, sup_e, rows * dim);
  for (int d = threadIdx.x; d < dim; d += kThreads)  // own columns, see below
    for (int n = 0; n < n_way; ++n) protos[n * dim + d] = 0.0f;
  if (warp == 0) {  // stage the chunk's labels, count every class by ballot
    for (int n0 = 0; n0 < n_way; n0 += 32) {
      const int n1 = min(n0 + 32, n_way);
      int mine = 0;
      for (int s0 = 0; s0 < n_support; s0 += 32) {
        const int s = s0 + lane;
        const int c = s0 == 0 ? class_of(first, n_way)
                    : s < n_support ? class_of(lab_e[s * lab_stride_s], n_way) : -1;
        if (n0 == 0 && s < rows) lab[s] = c;
        for (int n = n0; n < n1; ++n) {
          const int k = __popc(__ballot_sync(0xffffffffu, c == n));
          if (lane == n - n0) mine += k;
        }
      }
      if (n0 + lane < n_way) inv_counts[n0 + lane] = 1.0f / fmaxf((float)mine, 1.0f);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // --- class sums: thread t owns columns t, t + kThreads, ... ---
  for (int r0 = 0;;) {
    for (int d = threadIdx.x; d < dim; d += kThreads) {
      float acc = 0.0f;
      int cur = -1;
      int s = 0;
      // kUnroll rows at a time, every load ahead of any store, so the loads
      // of a group are in flight together
      for (; s + kUnroll <= rows; s += kUnroll) {
        int c[kUnroll];
        float v[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          c[i] = lab[s + i];
          v[i] = sup[(s + i) * dim + d];
        }
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) add_row(protos, dim, d, c[i], v[i], cur, acc);
      }
      for (; s < rows; ++s) add_row(protos, dim, d, lab[s], sup[s * dim + d], cur, acc);
      if (cur >= 0) protos[cur * dim + d] += acc;
    }
    r0 += rows;
    if (r0 >= n_support) break;
    __syncthreads();  // every thread is done with this chunk
    rows = min(s_chunk, n_support - r0);
    stage_async(sup, sup_e + (long long)r0 * dim, rows * dim);
    for (int s = threadIdx.x; s < rows; s += kThreads)
      lab[s] = class_of(lab_e[(r0 + s) * lab_stride_s], n_way);
    cp_async_wait_all();
    __syncthreads();
  }
  __syncthreads();

  // --- scores: one warp per query row, one pass per group of 7 classes ---
  // prototype p_j = class sum * (1 / count), scaled as it is read
  for (int ql = warp; ql < nq; ql += kWarps) {
    const float* x = qtile + ql * dim;
    float* o = out + ((long long)e * n_query + q0 + ql) * n_way;
    for (int c0 = 0; c0 < n_way; c0 += kClassGroup) {
      const int g = min(kClassGroup, n_way - c0);
      const float* p = protos + c0 * dim;
      float inv[kClassGroup];
#pragma unroll
      for (int j = 0; j < kClassGroup; ++j) inv[j] = j < g ? inv_counts[c0 + j] : 0.0f;
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = 0.0f;
#pragma unroll 4
      for (int d = lane; d < dim; d += 32) {
        const float xd = x[d];
        v[2 * kClassGroup] = fmaf(xd, xd, v[2 * kClassGroup]);  // |q|^2
#pragma unroll
        for (int j = 0; j < kClassGroup; ++j) {
          if (j < g) {
            const float pd = p[j * dim + d] * inv[j];
            v[j] = fmaf(xd, pd, v[j]);                              // q . p_j
            v[kClassGroup + j] = fmaf(pd, pd, v[kClassGroup + j]);  // |p_j|^2
          }
        }
      }
      const float r = reduce_scatter16(v, lane);
      const int slot = (lane >> 1) & 15;
      const float p2 = __shfl_sync(0xffffffffu, r, (2 * (slot + kClassGroup)) & 31);
      const float qq = __shfl_sync(0xffffffffu, r, 4 * kClassGroup);
      if ((lane & 1) == 0 && slot < g)
        o[c0 + slot] = -sqrtf(fmaxf(qq + p2 - 2.0f * r, 0.0f) + 1e-24f);
    }
  }
}

constexpr int kMaxDevices = 64;
bool g_smem_set[2][kMaxDevices] = {};  // large dynamic shared memory allowed, per label width

template <typename Label>
int launch(const float* support, long long sup_stride, const void* labels, long long lab_stride_e,
           long long lab_stride_s, const float* queries, long long qry_stride, float* out,
           int n_episodes, int n_support, int n_query, int dim, int n_way, int q_tile,
           int s_chunk, int smem, cudaStream_t stream) {
  auto kernel = episode_scores_kernel<Label>;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    bool& set = g_smem_set[sizeof(Label) == 8][dev];
    if (!set) {  // once per device, at the first large call (before any graph capture)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return (int)err;
      set = true;
    }
  }
  const long long blocks = (long long)n_episodes * ((n_query + q_tile - 1) / q_tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      support, sup_stride, (const Label*)labels, lab_stride_e, lab_stride_s, queries, qry_stride,
      out, n_support, n_query, dim, n_way, q_tile, s_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// support [E, S, D] f32 and queries [E, Q, D] f32 with contiguous rows and
// episode strides sup_stride / qry_stride (elements); labels [E, S] int32
// (label_bytes 4) or int64 (8) at element strides lab_stride_e / lab_stride_s
// (0 for labels expanded over episodes); out [E, Q, N] f32 contiguous. All on
// the device of `stream`. q_tile and s_chunk come from the wrapper's launch
// plan, which checks the shared-memory size first and says why; these guards
// only keep a bad call from launching.
extern "C" int afsl_protohead_scores(const void* support, long long sup_stride, const void* labels,
                                     int label_bytes, long long lab_stride_e,
                                     long long lab_stride_s, const void* queries,
                                     long long qry_stride, void* out, int n_episodes,
                                     int n_support, int n_query, int dim, int n_way, int q_tile,
                                     int s_chunk, void* stream) {
  if (n_episodes <= 0 || n_query <= 0 || n_way <= 0) return 0;
  if (dim < 0 || n_support < 0 || q_tile <= 0 || s_chunk < 0 || (n_support > 0 && s_chunk == 0))
    return (int)cudaErrorInvalidValue;
  const long long smem = head_smem_bytes(n_way, dim, q_tile, s_chunk);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const float* sup = (const float*)support;
  const float* qry = (const float*)queries;
  cudaStream_t st = (cudaStream_t)stream;
  if (label_bytes == 8)
    return launch<long long>(sup, sup_stride, labels, lab_stride_e, lab_stride_s, qry, qry_stride,
                             (float*)out, n_episodes, n_support, n_query, dim, n_way, q_tile,
                             s_chunk, (int)smem, st);
  if (label_bytes == 4)
    return launch<int>(sup, sup_stride, labels, lab_stride_e, lab_stride_s, qry, qry_stride,
                       (float*)out, n_episodes, n_support, n_query, dim, n_way, q_tile, s_chunk,
                       (int)smem, st);
  return (int)cudaErrorInvalidValue;
}
