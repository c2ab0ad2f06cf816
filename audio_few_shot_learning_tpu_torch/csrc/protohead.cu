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
// microseconds. The kernel is launch-latency bound, so the design keeps it to
// one launch per eval batch with no intermediate in device memory, and is
// otherwise simple.
//
// Design: one block per episode. Labels, class counts, the prototypes
// (N*D floats, 5 KB at the flagship) and their squared norms live in shared
// memory; one warp per query row reduces over D with shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void episode_scores_kernel(const float* __restrict__ support,
                                      const int* __restrict__ labels,
                                      const float* __restrict__ queries, float* __restrict__ out,
                                      int n_support, int n_query, int dim, int n_way) {
  extern __shared__ float smem[];
  float* protos = smem;                    // [n_way, dim]
  float* p2 = protos + n_way * dim;        // [n_way]
  float* counts = p2 + n_way;              // [n_way]
  int* lab = reinterpret_cast<int*>(counts + n_way);  // [n_support]

  const int e = blockIdx.x;
  const float* sup = support + (size_t)e * n_support * dim;
  const float* qry = queries + (size_t)e * n_query * dim;

  for (int s = threadIdx.x; s < n_support; s += blockDim.x)
    lab[s] = labels[(size_t)e * n_support + s];
  __syncthreads();

  for (int n = threadIdx.x; n < n_way; n += blockDim.x) {
    int c = 0;
    for (int s = 0; s < n_support; ++s) c += (lab[s] == n);
    counts[n] = fmaxf((float)c, 1.0f);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_way * dim; i += blockDim.x) {
    const int n = i / dim;
    const int d = i - n * dim;
    float acc = 0.0f;
    for (int s = 0; s < n_support; ++s)
      if (lab[s] == n) acc += sup[(size_t)s * dim + d];
    protos[i] = acc / counts[n];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int n = warp; n < n_way; n += n_warps) {
    float acc = 0.0f;
    for (int d = lane; d < dim; d += 32) acc += protos[n * dim + d] * protos[n * dim + d];
    acc = warp_sum(acc);
    if (lane == 0) p2[n] = acc;
  }
  __syncthreads();

  for (int q = warp; q < n_query; q += n_warps) {
    const float* row = qry + (size_t)q * dim;
    float q2 = 0.0f;
    for (int d = lane; d < dim; d += 32) q2 += row[d] * row[d];
    q2 = warp_sum(q2);
    float* o = out + ((size_t)e * n_query + q) * n_way;
    for (int n = 0; n < n_way; ++n) {
      float cross = 0.0f;
      for (int d = lane; d < dim; d += 32) cross += row[d] * protos[n * dim + d];
      cross = warp_sum(cross);
      if (lane == 0) o[n] = -sqrtf(fmaxf(q2 + p2[n] - 2.0f * cross, 0.0f) + 1e-24f);
    }
  }
}

}  // namespace

// support [E, S, D] f32, labels [E, S] int32, queries [E, Q, D] f32,
// out [E, Q, N] f32; all contiguous, all on the device of `stream`. The
// wrapper checks the shared-memory size first and says why; this guard only
// keeps a bad call from launching.
extern "C" int afsl_protohead_scores(const void* support, const void* labels, const void* queries,
                                     void* out, int n_episodes, int n_support, int n_query,
                                     int dim, int n_way, void* stream) {
  if (n_episodes <= 0 || n_query <= 0 || n_way <= 0) return 0;
  const int smem = (n_way * dim + 2 * n_way) * (int)sizeof(float) + n_support * (int)sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  episode_scores_kernel<<<n_episodes, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)support, (const int*)labels, (const float*)queries, (float*)out, n_support,
      n_query, dim, n_way);
  return (int)cudaGetLastError();
}
