// Forward Euler rollout of the MLP-ResNet temporal integrator, f32, in one launch,
// for weights that no thread-block cluster holds: a cluster whose W2 slices stream
// from L2 through a ring in shared memory fed by TMA bulk copies.
//
// Replaces the TPU kernel `mlp_resnet_rollout` of the JAX package
// (spatiotemporal_variable_separation_tpu/ops/pallas/rollout.py:91-127; its body
// `_rollout_kernel` :72-88 and step `_block_step` :49-58).  Each step updates every
// block of the MLP-ResNet in turn,
//     t <- t + relu(relu(t W1 + b1) W2 + b2) W3 + b3,
// and out[k] holds t after step k, out[0] = t0.  Weights are in the JAX (in, out)
// layout, row-major, f32; t0 is (batch, code), out is (n_steps, batch, code).
//
// What bounds it on an H100.  At the WaveEq eval's shape (batch 256, code 32, hidden
// 512, 3 blocks, 45 steps) the rollout does 20.0 GFLOP on 3.6 MB, so the card's f32
// rate outside the tensor cores bounds it: 0.30 ms at 67 TFLOP/s.  The weights stay
// f32 and every product runs as FMAs on the CUDA cores: the dynamics grow about 1e8x
// over 99 steps at random init, and TF32 or bf16 in one pass would not hold the 1e-4
// per-step tolerance.  W2 is 98% of the weights (3 MiB of 3.4 MB at WaveEq) and 89%
// of the FMAs.
//
// What this design does about it.  mlp_resnet_rollout_cluster.cu keeps every weight
// resident in a cluster's shared memory; that fails here only because every block's
// W2 slice must be resident (273,536 B a CTA at C 16 for WaveEq, over 232,448).  This
// kernel keeps that kernel's column split and streams only W2:
//   * the CTA of rank j of a cluster of C owns the hidden columns [j*S, j*S + S),
//     S = ceil(hidden / C), and keeps W1[:, cols], b1[cols], b2[cols], W3[cols, :] and
//     b3 of every block resident, loaded once at kernel start;
//   * W2[:, cols] of every block is packed once per call by the wrapper
//     (ops/rollout.py:pack_w2) into [n_blocks][C][hidden_pad][S_pad] f32, zero-padded,
//     and streams in chunks of kc rows x S_pad columns through a ring of kStages
//     slots in shared memory.  The W2 product's threads form k_groups row groups; group
//     g reads rows [g*16, g*16 + 16) of every chunk, one contiguous, 16-byte-aligned
//     run of the packed W2, so each group streams its own rows: the group's first
//     thread issues a cp.async.bulk copy that completes on the group's `full` mbarrier
//     of the slot, and each warp of the group arrives on the group's `empty` mbarrier
//     once it has read them.  No group waits for another.  The stream wraps across
//     blocks and steps (block n-1's last chunk is followed by block 0's first chunk of
//     the next step): before it consumes chunk q, a group refills the slot of chunk
//     q-1 with chunk q + kStages - 1, so the first chunk of each product is in flight
//     during the W1 product and the barriers before it.  A refill waits for the last
//     readers of its slot, whichever block or step they were in.
// Where even these slices of every block do not fit beside the ring and the
// activations at any cluster size and row tile (many blocks, wide hidden or code:
// 8 blocks at code 64, hidden 512), the kernel is launched with kResident false: W1,
// b1, b2, W3 and b3 are then read from global memory (L2) every block-step, a 1/C
// slice a CTA, and only W2 goes through the ring.  rollout_plan takes that mode only
// when no resident one fits.  There the W1 product, one global load a weight and 4
// rows, is the largest phase: 6.7K of 23.5K SM clocks a block-step at that shape
// (C 16, R 12; tools/torch_rollout_phases.py, H100 80GB HBM3 at 700 W).
// The cluster serves a tile of R batch rows (4 to 32, a multiple of 4); every CTA keeps
// its own copy of the tile's t.  One block-step:
//   1. h1[:, cols] = relu(t W1[:, cols] + b1[cols]), one (column, 4 rows) item a
//      thread, stored through distributed shared memory (DSMEM) into the full-width h1
//      of every CTA of the cluster;
//   2. cluster barrier;
//   3. h2[:, cols] = relu(h1 W2[:, cols] + b2[cols]) from the local full h1 and the
//      streamed chunks: thread (g, p) takes columns 2p, 2p+1 and group g's rows of
//      every chunk, accumulating in registers over the chunks in stream order; the
//      k_groups sums then meet in shared memory, in order g = 0, 1, ...;
//   4. the partial residual h2[:, cols] W3[cols, :] (R x code), split over groups of
//      the slice, stored into slot j of every CTA's partials;
//   5. cluster barrier;
//   6. every CTA sums the C partials in rank order 0..C-1, adds b3 and updates its t.
//      One fixed order keeps the C copies of t bitwise equal: the dynamics expand, so
//      copies that drifted by one bit would part.
// Single buffers of h1 and the partials suffice with these two barriers, as in the
// cluster kernel: a CTA reads its full h1 (3) before it arrives at the barrier of 5,
// the earliest point after which a peer writes h1 again, and reads its partials (6)
// before the barrier of the next 2, after which peers write them.  Padded hidden
// columns (S rounded up to 4, the ragged last slice) carry zero weights and are never
// stored into a peer's h1; padded W2 rows meet h1 rows that stay zero.  The ragged
// last row tile runs on zeros and is never written.  L2 traffic for W2 is
// ceil(batch / R) x hidden x hidden floats a block-step: each CTA reads its 1/C.
//
// Chunks of 16 rows a group (32 KB at S_pad 64) in 2 slots: the copies measured a
// fixed ~900 SM clocks a chunk for the issuing warp whatever their size, so fewer,
// larger chunks won -- at WaveEq (C 8, R 20) 1.75 ms against 1.95 ms with 4 slots of
// 8-row groups -- and 3 slots of 32 KB do not fit beside 20 rows.
// (tools/torch_rollout_phases.py, H100 80GB HBM3 at 700 W.)  A WaveEq block-step takes
// about 25.5K SM clocks, 13 us: the W2 product 8.4K at about 39 FMAs a clock (a warp's
// float4 load of h1 returns 512 bytes to registers, so the 2-column tile is bound by
// shared memory to registers, not by the FMA units), the refills 3.6K, the W1 product
// and its DSMEM stores 3.7K, the split-K sums and the W3 product 4.5K, the two
// cluster barriers 2.6K.  Wider tiles (4 columns measured slower here: their sums
// need twice the scratch), 3xTF32 mma for W2, and fewer phases are the next steps.
//
// ops/rollout.py:rollout_plan chooses the mode (resident if any C and R fit), then C
// and R for the fewest waves of clusters (from cudaOccupancyMaxActiveClusters of the
// same launch, mlp_resnet_rollout_max_active), then the least work a CTA;
// stream_smem_bytes there and make_layout below compute the same shared-memory size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // threads per CTA
constexpr int kMaxBlocks = 16;         // MLP-ResNet blocks whose pointers fit the argument
constexpr int kStages = 2;             // slots of the W2 ring (ops/rollout.py:STREAM_STAGES)
constexpr int kGroupRows = 16;         // W2 rows a thread group takes from one chunk
constexpr int kGroupCols = 2;          // W2 columns a thread of the W2 product takes
constexpr int kSmemLimit = 232448;     // dynamic shared memory one CTA may use on sm_90
constexpr int kNoClusterFits = -1;     // error code: cudaOccupancyMaxActiveClusters gave 0

struct BlockParams {
  const float* p[6 * kMaxBlocks];  // w1 b1 w2 b2 w3 b3 of each block (w2 unused)
};

// Built with -DROLLOUT_PHASE_CLOCKS (tools/torch_rollout_phases.py), thread 0 of
// CTA 0 sums in registers the SM clocks it spends in each phase of a block-step
// and adds the sums to g_phase_clocks at the end, which
// mlp_resnet_rollout_phase_clocks reads and clears.  The normal build has no such
// code.
#ifdef ROLLOUT_PHASE_CLOCKS
constexpr int kPhases = 12;
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
  int slice;       // S: hidden columns per rank
  int slice_pad;   // S rounded up to 4
  int k_groups;    // groups of the hidden (reduction) dimension in the W2 product
  int chunk_rows;  // kc = kGroupRows * k_groups: W2 rows a chunk holds
  int n_chunks;    // chunks of one block's W2 slice
  int hidden_pad;  // n_chunks * kc
  int k3_groups;   // groups of the slice (reduction) dimension in the W3 product
  // Offsets within one block's resident weights, and their size.
  int w1, b1, b2, w3, b3, per_block;
  // The ring, its chunk size, the activations, the mbarriers and the total.
  int ring, chunk, t, h1, h2, red, part, bars, total;
};

// `resident`: every block's W1, b1, b2, W3 and b3 slices are held in shared memory;
// otherwise the kernel reads them from global memory and the region is empty.
__host__ __device__ inline Layout make_layout(int code, int hidden, int n_blocks,
                                              int cluster, int rows, bool resident) {
  Layout L;
  L.slice = (hidden + cluster - 1) / cluster;
  L.slice_pad = round_up4(L.slice);
  const int sp = L.slice_pad;
  const int col_groups = sp / kGroupCols;
  L.k_groups = imax(1, imin(kThreads / col_groups, (hidden + kGroupRows - 1) / kGroupRows));
  L.chunk_rows = kGroupRows * L.k_groups;
  L.n_chunks = (hidden + L.chunk_rows - 1) / L.chunk_rows;
  L.hidden_pad = L.n_chunks * L.chunk_rows;
  L.k3_groups = imin(imax(1, kThreads / code), sp);
  L.w1 = 0;                        // [code][sp]   W1[c, lo + s]
  L.b1 = L.w1 + code * sp;         // [sp]
  L.b2 = L.b1 + sp;                // [sp]
  L.w3 = L.b2 + sp;                // [sp][code]   W3[lo + s, c]
  L.b3 = L.w3 + sp * code;         // [code]
  L.per_block = L.b3 + round_up4(code);
  L.ring = resident ? n_blocks * L.per_block : 0;  // [kStages][k_groups][kGroupRows][sp]
  L.chunk = L.chunk_rows * sp;
  L.t = L.ring + kStages * L.chunk;         // [code][rows]
  L.h1 = L.t + code * rows;                 // [hidden_pad][rows], every rank's columns
  L.h2 = L.h1 + L.hidden_pad * rows;        // [sp][rows]
  // Split-K sums of the W2 and W3 products, in turn: [k_groups][sp][rows] and
  // [k3_groups][code][rows].
  L.red = L.h2 + sp * rows;
  L.part = L.red + imax(L.k_groups * sp, L.k3_groups * code) * rows;  // [cluster][code][rows]
  // full[kStages][k_groups], empty[kStages][k_groups]: 8 bytes each.
  L.bars = L.part + cluster * code * rows;
  L.total = L.bars + 4 * kStages * L.k_groups;
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

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_address(dst)),
               "l"(src) : "memory");
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

__device__ __forceinline__ void mbarrier_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbarrier_arrive(unsigned bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbarrier_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbarrier_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The W2 stream of one row group g of a CTA: rows [g*kGroupRows, (g+1)*kGroupRows)
// of every chunk, a contiguous run of the packed W2.  Chunk p is chunk p % n_chunks of
// block (p / n_chunks) % n_blocks, in ring slot p % kStages, the slot's use
// p / kStages.
// Each group has its own slots and mbarriers, so no group waits for another.
struct Ring {
  const float* w2;     // this rank's slice of block 0 in the packed W2
  size_t block_step;   // floats from one block's slices to the next block's
  unsigned slots;      // shared address of slot 0
  unsigned full;       // shared address of full[0][0]
  unsigned empty;      // shared address of empty[0][0]
  int n_chunks, n_blocks, k_groups, chunk, part, total;  // part: a group's floats

  __device__ __forceinline__ unsigned full_bar(int s, int g) const {
    return full + 8 * (s * k_groups + g);
  }
  __device__ __forceinline__ unsigned empty_bar(int s, int g) const {
    return empty + 8 * (s * k_groups + g);
  }

  // The group's first thread only: copy group g's rows of chunk p into its slot
  // once the group's warps have released the slot's previous chunk (p - kStages).
  __device__ __forceinline__ void issue(int g, int p) const {
    if (p >= total) return;
    const int s = p % kStages;
    if (p >= kStages) mbarrier_wait(empty_bar(s, g), ((p / kStages) - 1) & 1);
    const int c = p % n_chunks;
    const int b = (p / n_chunks) % n_blocks;
    const unsigned bytes = static_cast<unsigned>(sizeof(float)) * part;
    const unsigned dst = slots + static_cast<unsigned>(sizeof(float)) * (s * chunk + g * part);
    mbarrier_arrive_expect_tx(full_bar(s, g), bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(w2 + b * block_step + static_cast<size_t>(c) * chunk + g * part), "r"(bytes),
        "r"(full_bar(s, g))
        : "memory");
  }
};

// One block's W1, b1, b2, W3 and b3 for this rank: its slices in shared memory
// (kResident) or the weights themselves in global memory, read through the read-only
// cache.  w1 is indexed [c * w1_stride + s], w3 [s * code + c], b1 and b2 [s], b3 [c],
// s < the rank's width.
struct BlockWeights {
  const float *w1, *b1, *b2, *w3, *b3;
  int w1_stride;
};

template <bool kResident>
__device__ __forceinline__ float weight(const float* p, int i) {
  if constexpr (kResident)
    return p[i];
  else
    return __ldg(p + i);
}

template <int R, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
stream_rollout_kernel(const float* __restrict__ t0,
                      const __grid_constant__ BlockParams params,  // indexed in place
                      const float* __restrict__ w2_packed, int n_blocks,
                      float* __restrict__ out, int batch, int code, int hidden,
                      int n_steps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L = make_layout(code, hidden, n_blocks, n_ranks, R, kResident);
  const int sp = L.slice_pad;
  const int tid = threadIdx.x;
  const int row0 = static_cast<int>(blockIdx.x) / n_ranks * R;
  const int rows = imin(R, batch - row0);
  const int lo = imin(hidden, rank * L.slice);
  const int width = imin(hidden, lo + L.slice) - lo;  // this rank's hidden columns
  float* ring_s = smem + L.ring;
  float* t_s = smem + L.t;
  float* h1_s = smem + L.h1;
  float* h2_s = smem + L.h2;
  float* red_s = smem + L.red;
  float* part_s = smem + L.part;

  const int col_groups = sp / kGroupCols;
  const bool w2_thread = tid < col_groups * L.k_groups;
  const int g = tid / col_groups;           // W2 product: this thread's row group
  const int cgi = tid - g * col_groups;     // and column pair
  // The first thread of the group in each warp arrives for the warp.
  const bool arrives = w2_thread && ((tid & 31) == 0 || cgi == 0);

  Ring ring;
  ring.w2 = w2_packed + static_cast<size_t>(rank) * L.hidden_pad * sp;
  ring.block_step = static_cast<size_t>(n_ranks) * L.hidden_pad * sp;
  ring.slots = shared_address(ring_s);
  ring.full = shared_address(smem + L.bars);
  ring.empty = ring.full + 8 * kStages * L.k_groups;
  ring.n_chunks = L.n_chunks;
  ring.n_blocks = n_blocks;
  ring.k_groups = L.k_groups;
  ring.chunk = L.chunk;
  ring.part = kGroupRows * sp;
  ring.total = (n_steps - 1) * n_blocks * L.n_chunks;

  if (tid == 0) {
    for (int gg = 0; gg < L.k_groups; ++gg) {
      // The warps that hold threads of group gg.
      const int warps = ((gg + 1) * col_groups - 1) / 32 - gg * col_groups / 32 + 1;
      for (int s = 0; s < kStages; ++s) {
        mbarrier_init(ring.full_bar(s, gg), 1);
        mbarrier_init(ring.empty_bar(s, gg), warps);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Resident weights, once for the whole rollout.
  if constexpr (kResident) {
    for (int b = 0; b < n_blocks; ++b) {
      const float* const* p = params.p + 6 * b;
      float* wb = smem + b * L.per_block;
      load_window(wb + L.w1, code, sp, code, width, p[0] + lo, hidden);
      load_window(wb + L.b1, 1, sp, 1, width, p[1] + lo, 0);
      load_window(wb + L.b2, 1, sp, 1, width, p[3] + lo, 0);
      load_window(wb + L.w3, sp, code, width, code, p[4] + static_cast<size_t>(lo) * code,
                  code);
      load_window(wb + L.b3, 1, code, 1, code, p[5], 0);
    }
  }
  for (int i = tid; i < code * R; i += kThreads) {
    const int c = i / R;
    const int r = i - c * R;
    t_s[i] = r < rows ? t0[static_cast<size_t>(row0 + r) * code + c] : 0.f;
  }
  // The padded rows of h1 meet zero rows of W2; they stay zero, never NaN.
  for (int i = hidden * R + tid; i < L.hidden_pad * R; i += kThreads) h1_s[i] = 0.f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (w2_thread && cgi == 0)
    for (int p = 0; p < kStages - 1; ++p) ring.issue(g, p);
  write_tile<R>(out, t_s, row0, rows, code, n_ranks, rank);
  // Every CTA of the cluster runs before any writes into a peer's shared memory.
  cluster.sync();

  // The W3 product sums the rank's real columns: padded ones hold zero weights when
  // resident and lie past the slice (or the matrix) in global memory.
  const int w3_rows = kResident ? sp : width;
  const int k3_chunk = (sp + L.k3_groups - 1) / L.k3_groups;
  int q = 0;  // the next chunk of the stream to consume
  PHASE_START()
  for (int k = 1; k < n_steps; ++k) {
    for (int b = 0; b < n_blocks; ++b) {
      BlockWeights wb;
      if constexpr (kResident) {
        const float* base = smem + b * L.per_block;
        wb = {base + L.w1, base + L.b1, base + L.b2, base + L.w3, base + L.b3, sp};
      } else {
        const float* const* p = params.p + 6 * b;
        wb = {p[0] + lo, p[1] + lo, p[3] + lo, p[4] + static_cast<size_t>(lo) * code, p[5],
              hidden};
      }

      // 1. h1[:, lo + s] = relu(t W1 + b1), into the full h1 of every rank: item
      //    (s, i) is column s for rows [4i, 4i + 4).
      for (int item = tid; item < width * (R / 4); item += kThreads) {
        const int s = item / (R / 4);
        const int i = item - s * (R / 4);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int c = 0; c < code; ++c) {
          const float w = weight<kResident>(wb.w1, c * wb.w1_stride + s);
          const float4 x = reinterpret_cast<const float4*>(t_s + c * R)[i];
          acc.x = fmaf(x.x, w, acc.x);
          acc.y = fmaf(x.y, w, acc.y);
          acc.z = fmaf(x.z, w, acc.z);
          acc.w = fmaf(x.w, w, acc.w);
        }
        const float bias = weight<kResident>(wb.b1, s);
        acc = make_float4(fmaxf(acc.x + bias, 0.f), fmaxf(acc.y + bias, 0.f),
                          fmaxf(acc.z + bias, 0.f), fmaxf(acc.w + bias, 0.f));
        PHASE_MARK(0)
        for (int q2 = 0; q2 < n_ranks; ++q2)
          reinterpret_cast<float4*>(cluster.map_shared_rank(h1_s, q2) + (lo + s) * R)[i] = acc;
        PHASE_MARK(1)
      }
      cluster.sync();
      PHASE_MARK(2)

      // 2. h2[:, s] = relu(h1 W2[:, s] + b2), W2 from the ring, chunk by chunk.
      float acc[R][kGroupCols];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < kGroupCols; ++i) acc[r][i] = 0.f;
      for (int c = 0; c < L.n_chunks; ++c, ++q) {
        const int slot = q % kStages;
        if (w2_thread && cgi == 0) ring.issue(g, q + kStages - 1);
        __syncwarp();  // the warp enters the product together, its issuing lane too
        PHASE_MARK(3)
        if (w2_thread) {
          mbarrier_wait(ring.full_bar(slot, g), (q / kStages) & 1);
          PHASE_MARK(4)
          const float* w2 = ring_s + slot * L.chunk + g * ring.part + cgi * kGroupCols;
          const float* x1 = h1_s + (c * L.chunk_rows + g * kGroupRows) * R;
#pragma unroll
          for (int kk = 0; kk < kGroupRows; ++kk) {
            const float2 w = *reinterpret_cast<const float2*>(w2 + kk * sp);
            float x[R];
            load_rows<R>(x1 + kk * R, x);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][0] = fmaf(x[r], w.x, acc[r][0]);
              acc[r][1] = fmaf(x[r], w.y, acc[r][1]);
            }
          }
        }
        __syncwarp();
        if (arrives) mbarrier_arrive(ring.empty_bar(slot, g));
        PHASE_MARK(5)
      }
      if (w2_thread) {
        float* red = red_s + (g * sp + cgi * kGroupCols) * R;  // [g][s][r]
#pragma unroll
        for (int i = 0; i < kGroupCols; ++i) {
          float v[R];
#pragma unroll
          for (int r = 0; r < R; ++r) v[r] = acc[r][i];
          store_rows<R>(red + i * R, v);
        }
      }
      __syncthreads();
      for (int o = tid; o < sp * R; o += kThreads) {
        const int s = o / R;
        float sum = red_s[o];
#pragma unroll 4
        for (int gg = 1; gg < L.k_groups; ++gg) sum += red_s[gg * sp * R + o];
        // Padded columns: zero in shared memory, past the slice in global memory.
        const float bias = (kResident || s < width) ? weight<kResident>(wb.b2, s) : 0.f;
        h2_s[o] = fmaxf(sum + bias, 0.f);
      }
      __syncthreads();
      PHASE_MARK(6)

      // 3. partial residual h2[:, cols] W3[cols, :] (R x code): thread (g3, c)
      //    sums slice rows [g3*k3_chunk, ...) for column c; then each output sums
      //    the groups in order and goes to slot `rank` of every rank's partials.
      for (int idx = tid; idx < code * L.k3_groups; idx += kThreads) {
        const int g3 = idx / code;
        const int c = idx - g3 * code;
        const int s1 = imin(w3_rows, (g3 + 1) * k3_chunk);
        float a3[R];
#pragma unroll
        for (int r = 0; r < R; ++r) a3[r] = 0.f;
#pragma unroll 4
        for (int s = g3 * k3_chunk; s < s1; ++s) {
          const float w = weight<kResident>(wb.w3, s * code + c);
          float x[R];
          load_rows<R>(h2_s + s * R, x);
#pragma unroll
          for (int r = 0; r < R; ++r) a3[r] = fmaf(x[r], w, a3[r]);
        }
        store_rows<R>(red_s + idx * R, a3);  // [g3][c][r]
      }
      __syncthreads();
      for (int o = tid; o < code * R; o += kThreads) {
        float v = red_s[o];
#pragma unroll 4
        for (int g3 = 1; g3 < L.k3_groups; ++g3) v += red_s[g3 * code * R + o];
        const int idx = rank * code * R + o;
        PHASE_MARK(7)
        for (int q2 = 0; q2 < n_ranks; ++q2) cluster.map_shared_rank(part_s, q2)[idx] = v;
        PHASE_MARK(8)
      }
      cluster.sync();
      PHASE_MARK(9)

      // 4. t += (partials of ranks 0, 1, ..., C-1) + b3, the same order in every rank.
      for (int i = tid; i < code * R; i += kThreads) {
        float sum = part_s[i];
#pragma unroll 4
        for (int q2 = 1; q2 < n_ranks; ++q2) sum += part_s[q2 * code * R + i];
        t_s[i] += sum + weight<kResident>(wb.b3, i / R);
      }
      __syncthreads();
      PHASE_MARK(10)
    }
    // Reads t_s only; the next write to t_s is two cluster barriers away.
    write_tile<R>(out + static_cast<size_t>(k) * batch * code, t_s, row0, rows, code,
                  n_ranks, rank);
    PHASE_MARK(11)
  }
  PHASE_END()
  // Every chunk issued was consumed above.  No CTA leaves while a peer may still
  // address its shared memory.
  cluster.sync();
}

template <int R, bool kResident>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int batch,
                      int code, int hidden, int n_blocks, int cluster, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * make_layout(code, hidden, n_blocks, cluster, R, kResident).total;
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stream_rollout_kernel<R, kResident>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(stream_rollout_kernel<R, kResident>,
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

template <int R, bool kResident>
int max_active_clusters(int batch, int code, int hidden, int n_blocks, int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure<R, kResident>(&cfg, &attr, batch, code, hidden, n_blocks, cluster, nullptr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, stream_rollout_kernel<R, kResident>, &cfg);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

template <int R, bool kResident>
int launch(const float* t0, const BlockParams& bp, const float* w2_packed, int n_blocks,
           float* out, int batch, int code, int hidden, int n_steps, int cluster,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure<R, kResident>(&cfg, &attr, batch, code, hidden, n_blocks, cluster, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, stream_rollout_kernel<R, kResident>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return kNoClusterFits;
  err = cudaLaunchKernelEx(&cfg, stream_rollout_kernel<R, kResident>, t0, bp, w2_packed,
                           n_blocks, out, batch, code, hidden, n_steps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int code, int hidden, int n_blocks, int cluster) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || code < 1 || hidden < 1) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16)
    return false;
  // Every column pair of a slice needs a thread of the W2 product.
  return round_up4((hidden + cluster - 1) / cluster) <= kGroupCols * kThreads;
}

// Returns CALL with the row tile R and the mode kResident as constants, or `bad`
// when the kernel is not built for that row tile.
#define ROLLOUT_DISPATCH_ROWS(rows, resident, bad, CALL)               \
  switch ((rows) * 2 + ((resident) ? 1 : 0)) {                         \
    case 9: { constexpr int R = 4; constexpr bool kResident = true; return CALL; }    \
    case 8: { constexpr int R = 4; constexpr bool kResident = false; return CALL; }   \
    case 17: { constexpr int R = 8; constexpr bool kResident = true; return CALL; }   \
    case 16: { constexpr int R = 8; constexpr bool kResident = false; return CALL; }  \
    case 25: { constexpr int R = 12; constexpr bool kResident = true; return CALL; }  \
    case 24: { constexpr int R = 12; constexpr bool kResident = false; return CALL; } \
    case 33: { constexpr int R = 16; constexpr bool kResident = true; return CALL; }  \
    case 32: { constexpr int R = 16; constexpr bool kResident = false; return CALL; } \
    case 41: { constexpr int R = 20; constexpr bool kResident = true; return CALL; }  \
    case 40: { constexpr int R = 20; constexpr bool kResident = false; return CALL; } \
    case 49: { constexpr int R = 24; constexpr bool kResident = true; return CALL; }  \
    case 48: { constexpr int R = 24; constexpr bool kResident = false; return CALL; } \
    case 57: { constexpr int R = 28; constexpr bool kResident = true; return CALL; }  \
    case 56: { constexpr int R = 28; constexpr bool kResident = false; return CALL; } \
    case 65: { constexpr int R = 32; constexpr bool kResident = true; return CALL; }  \
    case 64: { constexpr int R = 32; constexpr bool kResident = false; return CALL; } \
    default: return bad;                                               \
  }

}  // namespace

// Launches the rollout on `stream` in clusters of `cluster` CTAs over tiles of
// `rows` (4 to 32, a multiple of 4) batch rows; `resident` (0 or 1) holds every
// block's W1, b1, b2, W3 and b3 slices in shared memory, else they are read from
// global memory.  `params` is a host array of 6 * n_blocks device pointers (w1 b1 w2
// b2 w3 b3 per block; w2 is read from `w2_packed` instead,
// [n_blocks][cluster][hidden_pad][S_pad] as ops/rollout.py:pack_w2 lays it out).
// Returns a cudaError_t (0 when the launch was accepted), or -1 when no such cluster
// fits on the device.  Faults during the run surface at the caller's next
// synchronisation.
extern "C" int mlp_resnet_rollout_f32(const float* t0, const void* const* params,
                                      const float* w2_packed, int n_blocks, float* out,
                                      int batch, int code, int hidden, int n_steps,
                                      int cluster, int rows, int resident, void* stream) {
  if (!valid_shape(code, hidden, n_blocks, cluster) || batch < 1 || n_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockParams bp{};
  for (int i = 0; i < 6 * n_blocks; ++i) bp.p[i] = static_cast<const float*>(params[i]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ROLLOUT_DISPATCH_ROWS(rows, resident, static_cast<int>(cudaErrorInvalidValue),
                        (launch<R, kResident>(t0, bp, w2_packed, n_blocks, out, batch, code,
                                              hidden, n_steps, cluster, s)))
}

// Dynamic shared memory of one CTA in bytes (what rollout_plan computes), or -1.
extern "C" int mlp_resnet_rollout_smem_bytes(int code, int hidden, int n_blocks, int cluster,
                                             int rows, int resident) {
  if (!valid_shape(code, hidden, n_blocks, cluster) || rows < 4 || rows > 32 || rows % 4)
    return -1;
  return static_cast<int>(sizeof(float)) *
         make_layout(code, hidden, n_blocks, cluster, rows, resident != 0).total;
}

// cudaOccupancyMaxActiveClusters for this launch, or minus a cudaError_t.
extern "C" int mlp_resnet_rollout_max_active(int batch, int code, int hidden, int n_blocks,
                                             int cluster, int rows, int resident) {
  if (!valid_shape(code, hidden, n_blocks, cluster) || batch < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  ROLLOUT_DISPATCH_ROWS(rows, resident, -static_cast<int>(cudaErrorInvalidValue),
                        (max_active_clusters<R, kResident>(batch, code, hidden, n_blocks,
                                                           cluster)))
}

#ifdef ROLLOUT_PHASE_CLOCKS
// Copies the per-phase clock totals of the launches since the last call into
// `host` (kPhases values) and clears them; returns a cudaError_t.
extern "C" int mlp_resnet_rollout_phase_clocks(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_clocks, sizeof(g_phase_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zeros[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clocks, zeros, sizeof(zeros)));
}
#endif

extern "C" const char* mlp_resnet_rollout_error_string(int err) {
  if (err == kNoClusterFits)
    return "no cluster of this size and shared memory fits on the device "
           "(cudaOccupancyMaxActiveClusters gave 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
