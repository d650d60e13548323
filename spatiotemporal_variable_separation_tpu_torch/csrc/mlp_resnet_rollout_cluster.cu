// Forward Euler rollout of the MLP-ResNet temporal integrator, f32, in one launch,
// with every weight resident in the shared memory of a thread-block cluster.
//
// Replaces the TPU kernel `mlp_resnet_rollout` of the JAX package
// (spatiotemporal_variable_separation_tpu/ops/pallas/rollout.py:91-127; its body
// `_rollout_kernel` :72-88 and step `_block_step` :49-58).  Each step updates every
// block of the MLP-ResNet in turn,
//     t <- t + relu(relu(t W1 + b1) W2 + b2) W3 + b3,
// and out[k] holds t after step k, out[0] = t0.  Weights are in the JAX (in, out)
// layout, row-major, f32; t0 is (batch, code), out is (n_steps, batch, code).
//
// What bounds it on an H100.  At the serving shapes (batch 64, code 20, hidden 512,
// 1 block, 100 steps) the rollout does 3.6 GFLOP on 1.6 MB, so the card's f32 rate
// outside the tensor cores bounds it: about 54 us at 67 TFLOP/s.  The weights stay
// f32 and every product runs as FMAs on the CUDA cores: the dynamics grow about 1e8x
// over 99 steps at random init, and TF32 or bf16 in one pass would not hold the
// 1e-4 per-step tolerance.
//
// What this design does about it.  The TPU kernel keeps every weight resident in
// VMEM for the whole rollout.  One SM's 227 KB cannot hold them (W2 alone is 1 MiB
// at hidden 512), but a cluster of C CTAs can: the CTA of rank j owns the hidden
// columns [j*S, j*S + S), S = ceil(hidden / C), and loads W1[:, cols], b1[cols],
// W2[:, cols], b2[cols], W3[cols, :] and b3 of every block into its shared memory
// once, at kernel start (138.6 KB at C 8).  The cluster serves a tile of R batch
// rows; every CTA keeps its own copy of the tile's t.  One block-step:
//   1. h1[:, cols] = relu(t W1[:, cols] + b1[cols]), stored through distributed
//      shared memory (DSMEM) into the full-width h1 of every CTA of the cluster;
//   2. cluster barrier;
//   3. h2[:, cols] = relu(h1 W2[:, cols] + b2[cols]) from the local full h1, split
//      over pairs of columns and groups of the reduction dimension, whose sums
//      meet in shared memory;
//   4. the partial residual h2[:, cols] W3[cols, :] (R x code), split the same way
//      over output columns, stored into slot j of every CTA's partials;
//   5. cluster barrier;
//   6. every CTA sums the C partials in rank order 0..C-1, adds b3 and updates its
//      t.  One fixed order keeps the C copies of t bitwise equal: the dynamics
//      expand, so copies that drifted by one bit would part.
// out[k] is written after the last block of step k, the tile's elements split
// across the cluster's CTAs.  Single buffers suffice with these two barriers: a
// CTA reads its full h1 (phase 3) before it arrives at the barrier of phase 5, the
// earliest point after which a peer writes h1 again, and reads its partials
// (phase 6) before the barrier of the next phase 2, after which peers write them.
// cg::cluster_group::sync() has the release/acquire semantics that make the DSMEM
// stores visible.  Padded hidden columns (S rounded up to 4, and the ragged last
// slice when C does not divide hidden) carry zero weights and are never stored
// into a peer's h1.  The ragged last row tile runs on zeros and is never written.
//
// ops/rollout.py:rollout_plan chooses C (the smallest of 1, 2, 4, 8, 16 whose
// slices fit) and R from the shapes; shapes that fit no cluster take the streaming
// kernel of mlp_resnet_rollout.cu.  make_layout below and rollout_plan compute the
// same shared-memory size.
//
// Where the time goes (tools/torch_rollout_phases.py on an H100 80GB HBM3 at
// 700 W, serving shapes, C 8, R 8): about 12.6K SM clocks a block-step, 6.4 us.
// The W2 product takes about 40% of it at 51-54 FMAs a clock; the two cluster
// barriers take 23%, most of it the release/acquire that publishes the DSMEM
// stores; the rest are short phases whose dependent shared-memory loads do not
// overlap.  At hidden 32, where the products are tiny, a block-step still takes
// 6.3K clocks.  Tensor cores (3xTF32 at f32 accuracy), mbarrier-signalled
// st.async in place of the barriers, and fewer phases are the next steps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // threads per CTA
constexpr int kMaxBlocks = 16;         // MLP-ResNet blocks whose pointers fit the argument
constexpr int kSmemLimit = 232448;     // dynamic shared memory one CTA may use on sm_90
constexpr int kNoClusterFits = -1;     // error code: cudaOccupancyMaxActiveClusters gave 0

struct BlockParams {
  const float* p[6 * kMaxBlocks];  // w1 b1 w2 b2 w3 b3 of each block
};

// Built with -DROLLOUT_PHASE_CLOCKS (tools/torch_rollout_phases.py), thread 0 of
// CTA 0 sums in registers the SM clocks it spends in each phase of a block-step
// and adds the sums to g_phase_clocks at the end, which
// mlp_resnet_rollout_cluster_phase_clocks reads and clears.  The normal build has
// no such code.
#ifdef ROLLOUT_PHASE_CLOCKS
constexpr int kPhases = 10;
__device__ unsigned long long g_phase_clocks[kPhases];
#define PHASE_START()                                        \
  unsigned long long phase_t = clock64();                    \
  unsigned long long phase_sum[kPhases] = {};
#define PHASE_MARK(i)                                        \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                 \
    const unsigned long long phase_now = clock64();          \
    phase_sum[i] += phase_now - phase_t;                     \
    phase_t = phase_now;                                     \
  }
#define PHASE_END()                                          \
  if (blockIdx.x == 0 && threadIdx.x == 0)                   \
    for (int i = 0; i < kPhases; ++i) g_phase_clocks[i] += phase_sum[i];
#else
#define PHASE_START()
#define PHASE_MARK(i)
#define PHASE_END()
#endif

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int round_up4(int x) { return (x + 3) & ~3; }

// Shared-memory layout of one CTA, in floats; every region starts on 16 bytes.
struct Layout {
  int slice;      // S: hidden columns per rank
  int slice_pad;  // S rounded up to 4
  int k_groups;   // groups of the hidden (reduction) dimension in the W2 product
  int k3_groups;  // groups of the slice (reduction) dimension in the W3 product
  // Offsets within one block's weights, and the size of one block's weights.
  int w1, b1, w2, b2, w3, b3, per_block;
  // Offsets of the activations, and the total.
  int t, h1, h2, red, part, total;
};

__host__ __device__ inline Layout make_layout(int code, int hidden, int n_blocks,
                                              int cluster, int rows) {
  Layout L;
  L.slice = (hidden + cluster - 1) / cluster;
  L.slice_pad = round_up4(L.slice);
  const int sp = L.slice_pad;
  L.k_groups = imin(imax(1, kThreads / (sp / 2)), hidden);
  L.k3_groups = imin(imax(1, kThreads / code), sp);
  L.w1 = 0;                        // [code][sp]   W1[c, lo + s]
  L.b1 = L.w1 + code * sp;         // [sp]
  L.w2 = L.b1 + sp;                // [hidden][sp] W2[k, lo + s]
  L.b2 = L.w2 + hidden * sp;       // [sp]
  L.w3 = L.b2 + sp;                // [sp][code]   W3[lo + s, c]
  L.b3 = L.w3 + sp * code;         // [code]
  L.per_block = L.b3 + round_up4(code);
  L.t = n_blocks * L.per_block;            // [code][rows]
  L.h1 = L.t + code * rows;                // [hidden][rows], every rank's columns
  L.h2 = L.h1 + hidden * rows;             // [sp][rows]
  // Split-K sums of the W2 and W3 products, in turn: [k_groups][sp][rows] and
  // [k3_groups][code][rows].
  L.red = L.h2 + sp * rows;
  L.part = L.red + imax(L.k_groups * sp, L.k3_groups * code) * rows;  // [cluster][code][rows]
  L.total = L.part + cluster * code * rows;
  return L;
}

template <int R>
__device__ __forceinline__ void load_rows(const float* s, float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(s)[i];
    v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
  }
}

template <int R>
__device__ __forceinline__ void store_rows(float* s, const float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R / 4; ++i)
    reinterpret_cast<float4*>(s)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// dst[i][j] = src[i * stride_i + j] for i < valid_i and j < valid_j, else 0; dst is
// n_i x n_j.  Asynchronous copies keep many loads in flight; cp.async.wait_all
// ends them.
__device__ void load_window(float* dst, int n_i, int n_j, int valid_i, int valid_j,
                            const float* __restrict__ src, int stride_i) {
  for (int e = threadIdx.x; e < n_i * n_j; e += kThreads) {
    const int i = e / n_j;
    const int j = e - i * n_j;
    if (i < valid_i && j < valid_j)
      copy_async(dst + e, src + static_cast<size_t>(i) * stride_i + j);
    else
      dst[e] = 0.f;
  }
}

// This rank's share of the tile's out[k] rows: elements [rank*share, ...) of the
// tile's rows * code contiguous outputs.
template <int R>
__device__ __forceinline__ void write_tile(float* __restrict__ out_k, const float* t_s,
                                           int row0, int rows, int code, int cluster,
                                           int rank) {
  const int n = rows * code;
  const int share = (n + cluster - 1) / cluster;
  const int e1 = imin(n, (rank + 1) * share);
  for (int e = rank * share + threadIdx.x; e < e1; e += kThreads) {
    const int r = e / code;
    const int c = e - r * code;
    out_k[static_cast<size_t>(row0 + r) * code + c] = t_s[c * R + r];
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
cluster_rollout_kernel(const float* __restrict__ t0,
                       const __grid_constant__ BlockParams params,  // indexed in place
                       int n_blocks, float* __restrict__ out, int batch, int code,
                       int hidden, int n_steps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L = make_layout(code, hidden, n_blocks, n_ranks, R);
  const int sp = L.slice_pad;
  const int tid = threadIdx.x;
  const int row0 = static_cast<int>(blockIdx.x) / n_ranks * R;
  const int rows = imin(R, batch - row0);
  const int lo = imin(hidden, rank * L.slice);
  const int width = imin(hidden, lo + L.slice) - lo;  // this rank's hidden columns
  float* t_s = smem + L.t;
  float* h1_s = smem + L.h1;
  float* h2_s = smem + L.h2;
  float* red_s = smem + L.red;
  float* part_s = smem + L.part;

  // Weights, once for the whole rollout.
  for (int b = 0; b < n_blocks; ++b) {
    const float* const* p = params.p + 6 * b;
    float* wb = smem + b * L.per_block;
    load_window(wb + L.w1, code, sp, code, width, p[0] + lo, hidden);
    load_window(wb + L.b1, 1, sp, 1, width, p[1] + lo, 0);
    load_window(wb + L.w2, hidden, sp, hidden, width, p[2] + lo, hidden);
    load_window(wb + L.b2, 1, sp, 1, width, p[3] + lo, 0);
    load_window(wb + L.w3, sp, code, width, code, p[4] + static_cast<size_t>(lo) * code, code);
    load_window(wb + L.b3, 1, code, 1, code, p[5], 0);
  }
  for (int i = tid; i < code * R; i += kThreads) {
    const int c = i / R;
    const int r = i - c * R;
    t_s[i] = r < rows ? t0[static_cast<size_t>(row0 + r) * code + c] : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  write_tile<R>(out, t_s, row0, rows, code, n_ranks, rank);
  // Every CTA of the cluster runs before any writes into a peer's shared memory.
  cluster.sync();

  const int col_groups = sp / 2;
  const int k_chunk = (hidden + L.k_groups - 1) / L.k_groups;
  const int k3_chunk = (sp + L.k3_groups - 1) / L.k3_groups;
  PHASE_START()
  for (int k = 1; k < n_steps; ++k) {
    for (int b = 0; b < n_blocks; ++b) {
      const float* wb = smem + b * L.per_block;

      // 1. h1[:, lo + s] = relu(t W1 + b1), into the full h1 of every rank.
      for (int s = tid; s < width; s += kThreads) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int c = 0; c < code; ++c) {
          const float w = wb[L.w1 + c * sp + s];
          float x[R];
          load_rows<R>(t_s + c * R, x);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(x[r], w, acc[r]);
        }
        const float bias = wb[L.b1 + s];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaxf(acc[r] + bias, 0.f);
        PHASE_MARK(0)
        for (int q = 0; q < n_ranks; ++q)
          store_rows<R>(cluster.map_shared_rank(h1_s, q) + (lo + s) * R, acc);
        PHASE_MARK(1)
      }
      cluster.sync();
      PHASE_MARK(2)

      // 2. h2[:, s] = relu(h1 W2[:, s] + b2): thread (g, cgi) sums rows
      //    [g*k_chunk, ...) of W2 for columns 2*cgi, 2*cgi+1 and all R rows.  At
      //    the serving shapes a warp is one g, so its h1 loads are broadcasts.
      if (tid < col_groups * L.k_groups) {
        const int g = tid / col_groups;
        const int cgi = tid - g * col_groups;
        const int k0 = g * k_chunk;
        const int k1 = imin(hidden, k0 + k_chunk);
        float acc[R][2];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
        const float* w2 = wb + L.w2 + cgi * 2;
#pragma unroll 4
        for (int kk = k0; kk < k1; ++kk) {
          const float2 w = *reinterpret_cast<const float2*>(w2 + kk * sp);
          float x[R];
          load_rows<R>(h1_s + kk * R, x);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][0] = fmaf(x[r], w.x, acc[r][0]);
            acc[r][1] = fmaf(x[r], w.y, acc[r][1]);
          }
        }
        float* red = red_s + (g * sp + cgi * 2) * R;  // [g][s][r]
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v[R];
#pragma unroll
          for (int r = 0; r < R; ++r) v[r] = acc[r][i];
          store_rows<R>(red + i * R, v);
        }
      }
      PHASE_MARK(3)
      __syncthreads();
      for (int o = tid; o < sp * R; o += kThreads) {
        float sum = red_s[o];
#pragma unroll 4
        for (int g = 1; g < L.k_groups; ++g) sum += red_s[g * sp * R + o];
        h2_s[o] = fmaxf(sum + wb[L.b2 + o / R], 0.f);
      }
      __syncthreads();
      PHASE_MARK(4)

      // 3. partial residual h2[:, cols] W3[cols, :] (R x code): thread (g, c)
      //    sums slice rows [g*k3_chunk, ...) for column c; then each output sums
      //    the groups in order and goes to slot `rank` of every rank's partials.
      for (int idx = tid; idx < code * L.k3_groups; idx += kThreads) {
        const int g = idx / code;
        const int c = idx - g * code;
        const int s1 = imin(sp, (g + 1) * k3_chunk);
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int s = g * k3_chunk; s < s1; ++s) {
          const float w = wb[L.w3 + s * code + c];
          float x[R];
          load_rows<R>(h2_s + s * R, x);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(x[r], w, acc[r]);
        }
        store_rows<R>(red_s + idx * R, acc);  // [g][c][r]
      }
      __syncthreads();
      for (int o = tid; o < code * R; o += kThreads) {
        float v = red_s[o];
#pragma unroll 4
        for (int g = 1; g < L.k3_groups; ++g) v += red_s[g * code * R + o];
        const int idx = rank * code * R + o;
        PHASE_MARK(5)
        for (int q = 0; q < n_ranks; ++q) cluster.map_shared_rank(part_s, q)[idx] = v;
        PHASE_MARK(6)
      }
      cluster.sync();
      PHASE_MARK(7)

      // 4. t += (partials of ranks 0, 1, ..., C-1) + b3, the same order in every rank.
      for (int i = tid; i < code * R; i += kThreads) {
        float sum = part_s[i];
#pragma unroll 4
        for (int q = 1; q < n_ranks; ++q) sum += part_s[q * code * R + i];
        t_s[i] += sum + wb[L.b3 + i / R];
      }
      __syncthreads();
      PHASE_MARK(8)
    }
    // Reads t_s only; the next write to t_s is two cluster barriers away.
    write_tile<R>(out + static_cast<size_t>(k) * batch * code, t_s, row0, rows, code,
                  n_ranks, rank);
    PHASE_MARK(9)
  }
  PHASE_END()
  // No CTA leaves while a peer may still address its shared memory.
  cluster.sync();
}

// Sets the kernel's attributes and fills `cfg` for a launch of `cluster`-CTA
// clusters over `batch` rows.  `attr` must outlive `cfg`.
template <int R>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int batch,
                      int code, int hidden, int n_blocks, int cluster, cudaStream_t stream) {
  const size_t smem = sizeof(float) * make_layout(code, hidden, n_blocks, cluster, R).total;
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cluster_rollout_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(cluster_rollout_kernel<R>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((batch + R - 1) / R * cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int R>
int max_active_clusters(int batch, int code, int hidden, int n_blocks, int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<R>(&cfg, &attr, batch, code, hidden, n_blocks, cluster, nullptr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, cluster_rollout_kernel<R>, &cfg);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

template <int R>
int launch(const float* t0, const BlockParams& bp, int n_blocks, float* out, int batch,
           int code, int hidden, int n_steps, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<R>(&cfg, &attr, batch, code, hidden, n_blocks, cluster, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, cluster_rollout_kernel<R>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return kNoClusterFits;
  err = cudaLaunchKernelEx(&cfg, cluster_rollout_kernel<R>, t0, bp, n_blocks, out, batch,
                           code, hidden, n_steps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int code, int hidden, int n_blocks, int cluster) {
  return n_blocks >= 1 && n_blocks <= kMaxBlocks && code >= 1 && hidden >= 1 &&
         (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16);
}

}  // namespace

// Launches the rollout on `stream` in clusters of `cluster` CTAs over tiles of
// `rows` (4 or 8) batch rows.  `params` is a host array of 6 * n_blocks device
// pointers (w1 b1 w2 b2 w3 b3 per block).  Returns a cudaError_t (0 when the
// launch was accepted), or -1 when no such cluster fits on the device.  Faults
// during the run surface at the caller's next synchronisation.
extern "C" int mlp_resnet_rollout_cluster_f32(const float* t0, const void* const* params,
                                              int n_blocks, float* out, int batch, int code,
                                              int hidden, int n_steps, int cluster, int rows,
                                              void* stream) {
  if (!valid_shape(code, hidden, n_blocks, cluster) || batch < 1 || n_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockParams bp{};
  for (int i = 0; i < 6 * n_blocks; ++i) bp.p[i] = static_cast<const float*>(params[i]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 4) return launch<4>(t0, bp, n_blocks, out, batch, code, hidden, n_steps, cluster, s);
  if (rows == 8) return launch<8>(t0, bp, n_blocks, out, batch, code, hidden, n_steps, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one CTA in bytes (what rollout_plan computes), or -1.
extern "C" int mlp_resnet_rollout_cluster_smem_bytes(int code, int hidden, int n_blocks,
                                                     int cluster, int rows) {
  if (!valid_shape(code, hidden, n_blocks, cluster) || (rows != 4 && rows != 8)) return -1;
  return static_cast<int>(sizeof(float)) *
         make_layout(code, hidden, n_blocks, cluster, rows).total;
}

// cudaOccupancyMaxActiveClusters for this launch, or minus a cudaError_t.
extern "C" int mlp_resnet_rollout_cluster_max_active(int batch, int code, int hidden,
                                                     int n_blocks, int cluster, int rows) {
  if (!valid_shape(code, hidden, n_blocks, cluster) || batch < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (rows == 4) return max_active_clusters<4>(batch, code, hidden, n_blocks, cluster);
  if (rows == 8) return max_active_clusters<8>(batch, code, hidden, n_blocks, cluster);
  return -static_cast<int>(cudaErrorInvalidValue);
}

#ifdef ROLLOUT_PHASE_CLOCKS
// Copies the per-phase clock totals of the launches since the last call into
// `host` (kPhases values) and clears them; returns a cudaError_t.
extern "C" int mlp_resnet_rollout_cluster_phase_clocks(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_clocks, sizeof(g_phase_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zeros[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clocks, zeros, sizeof(zeros)));
}
#endif

extern "C" const char* mlp_resnet_rollout_cluster_error_string(int err) {
  if (err == kNoClusterFits)
    return "no cluster of this size and shared memory fits on the device "
           "(cudaOccupancyMaxActiveClusters gave 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
