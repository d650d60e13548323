// Transposed 4x4 convolutions of the DCGAN decoder in f32: implicit GEMMs on the tensor
// cores in 3xTF32, with the conv bias, eval-mode BatchNorm and the activation in the
// epilogue; one launch a decoder stage, each stage's output written once.
//
// It replaces no TPU kernel: XLA computed these convolutions for the JAX package
// (models/conv.py:DCGAN64Decoder there).  On the card the port called
// F.conv_transpose2d, whose f32 path is cuDNN's `dgrad_engine` on the CUDA cores at
// about 18 TFLOP/s, followed by cuDNN's inference BatchNorm and two elementwise passes.
//
// What bounds it on an H100.  At the serving shape (B 64 x 100 = 6,400 frames, nz 148,
// nf 64, nc 1) the decoder does 1.317 TFLOP.  3xTF32 takes three TF32 products for one
// f32 product, so at 494.7 TFLOP/s of dense TF32 the bound is 165 TFLOP/s, 8.0 ms;
// every stage's output written and read once is about 6 GB, 1.8 ms at 3.35 TB/s.  So
// the products bound every stage but the frame (64 -> nc), which reads 1.68 GB for
// 13 GFLOP.
//
// What the design does about it.
// * Sub-pixel phases.  A k4 s2 p1 transposed conv writes output row oy = 2 qy + py
//   from input rows qy (tap ky = 1 + py) and qy - 1 (ky = 3, py = 0) or qy + 1
//   (ky = 0, py = 1); the same in x.  So each of the four output phases (py, px) is a
//   dense GEMM: M = N H W rows (input pixels), N = C_out, K = 4 C_in (2 x 2 taps x
//   channels), with no zero multiplied and no atomics.  A 1x1 input (the first stage)
//   is one GEMM, M = N, N = 16 C_out (the 4x4 outputs and channels), K = C_in.
// * 3xTF32.  Each operand x is split on its way from shared memory into registers into
//   big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big); the product takes
//   small*big + big*small + big*big on mma.sync m16n8k8, summed in f32.  Each K tile's
//   products are summed apart and added to the running sums in f32 (the tensor cores
//   truncate the sums they return).  Nothing is split ahead of the call: the weights
//   may change between calls.
// * A 128 x 64 tile a CTA, two CTAs an SM: a ring of 4 slots of A (128 rows x 32 of K)
//   and B (64 columns x 32 of K, K contiguous) fed by cp.async (16 bytes where rows
//   allow, else 4, zero-filled past every edge), 8 warps of 32 x 32 sums in registers.
//   Rows are padded so that the fragment loads hit 32 distinct banks.  The grid walks
//   each M tile's phases and N tiles together, so the input rows a tile reads stay in
//   L2 across them.  Measured on an H100 at 6,400 frames, the products take about
//   two thirds of a stage's time, splitting and loading the rest.  Warpgroup products
//   (wgmma) from split planes in shared memory, pipelined or warp-specialized, came
//   out no faster: the split has to be written to shared memory before they read
//   it, and their three products read both operands from there three times.
// * The frame stage (C_out <= 4) takes a kernel of its own: the phase GEMM of so few
//   columns reads each input pixel 16 times through L2.  A CTA holds a band of input
//   rows with their halo in shared memory, and each thread computes the 2 x 2 outputs
//   of one input pixel from its 3 x 3 neighbours with f32 FMAs.
// * Epilogue: acc + bias, then (acc - mean) * (gamma / sqrt(var + eps)) + beta with
//   the running statistics, then the activation, stored NHWC (or NCHW for the frame).
//
// Layouts: x is NHWC (n, h, w, cin), f32.  The packed weight is W[ci, co, ky, kx] as
// (ky, kx, co, ci): for the k4 s2 p1 conv the C_out rows of each tap, for the 1x1
// input the 16 C_out columns of the GEMM.  The output is NHWC (n, 2h, 2w, cout) or
// NCHW (n, cout, 2h, 2w); for the 1x1 input, NHWC (n, 4, 4, cout).
// ops/transposed_conv.py packs and checks them; its plain version computes the same
// with F.conv2d.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kMaxSide = 32767;     // qy and qx share one int
constexpr int kFrameKC = 16;        // channels a stage of the frame kernel holds
// The frame kernel's pixel stride: 16-byte loads of 8 pixels hit distinct banks.
constexpr int kFrameLdx = kFrameKC + 4;
constexpr int kFrameMaxCout = 4;
constexpr int kFrameMaxWidth = kThreads;

enum Act : int { kIdentity = 0, kRelu = 1, kLeakyRelu = 2, kSigmoid = 3, kTanh = 4, kElu = 5,
                 kNumActs = 6 };

struct Args {
  const float* x;          // NHWC input
  const float* w;          // packed weight
  const float* bias;       // (cch)
  const float* bn_mean;    // (cch) each, or all null: no BatchNorm
  const float* bn_var;
  const float* bn_weight;
  const float* bn_bias;
  float* out;
  float eps;
  int n, h, w_in, cin;     // input batch, height, width, channels
  int ncols;               // GEMM columns: cout (k4 s2 p1) or 16 cout (1x1 input)
  int cch;                 // output channels: a column's channel is col % cch
  int rows;                // GEMM rows a phase: n h w
  int up;                  // 1: k4 s2 p1, four phases; 0: 1x1 input, one GEMM
  int act;
  int out_nchw;
  int vec_a, vec_b, vec_out;  // 16-byte loads of x and of the weight, 8-byte stores
};

// The phase GEMM's tile: 128 rows x 64 columns a CTA, K in steps of 32 through a ring
// of 4 slots, 8 warps of 32 x 32 sums, two CTAs an SM.
struct Tile {
  static constexpr int BM = 128, BN = 64, WM = 32, WN = 32, BK = 32;
  static constexpr int kStages = 4, kMinBlocks = 2;
  // A as [BM][BK] and B as [BN][BK], K contiguous, rows padded to 4 g + t (mod 32)
  // over the banks for the fragment loads.
  static constexpr int kLda = BK + 4;
  static constexpr int kA = BM * kLda;
  static constexpr int kB = BN * kLda;
  static constexpr int kStage = kA + kB;
  static constexpr int kBytes = kStages * kStage * 4;
  static constexpr int kChunksRow = BK / 4;               // 16-byte chunks of an A row
  static constexpr int kRowsPass = kThreads / kChunksRow;  // A rows the CTA copies a pass
  static constexpr int kARows = BM / kRowsPass;            // A rows a thread copies
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kMT = WM / 16;  // m16 tiles a warp
  static constexpr int kNT = WN / 8;   // n8 tiles a warp
  static_assert((BM / WM) * kWarpsN * 32 == kThreads, "the warps tile the CTA");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BM % kRowsPass == 0, "whole fragments");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies 16 (4) bytes, or writes zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to about 2^-22 of |x|, each a TF32 value.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product with f32 sums.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The kernel row and input offset of tap t (0 or 1) of output phase p (0 or 1).
__host__ __device__ __forceinline__ constexpr int tap_k(int p, int t) {
  return p ? (t ? 0 : 2) : (t ? 3 : 1);
}
__host__ __device__ __forceinline__ constexpr int tap_d(int p, int t) {
  return t ? (p ? 1 : -1) : 0;
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return v > 0.f ? v : 0.f;
    case kLeakyRelu: return v > 0.f ? v : 0.2f * v;
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kTanh: return tanhf(v);
    case kElu: return v > 0.f ? v : expm1f(v);
    default: return v;
  }
}

// A channel's epilogue, y = act(((acc + bias) - mean) * scale + shift) with scale =
// gamma / sqrt(var + eps) of the running statistics; without BatchNorm act(acc + bias).
struct Affine {
  float bias, mean, scale, shift;
};

__device__ __forceinline__ Affine channel_affine(const Args& a, int ch) {
  Affine f{a.bias[ch], 0.f, 1.f, 0.f};
  if (a.bn_mean != nullptr) {
    f.mean = a.bn_mean[ch];
    f.scale = a.bn_weight[ch] / sqrtf(a.bn_var[ch] + a.eps);
    f.shift = a.bn_bias[ch];
  }
  return f;
}

__device__ __forceinline__ float finish(const Args& a, const Affine& f, float acc) {
  float y = acc + f.bias;
  if (a.bn_mean != nullptr) y = (y - f.mean) * f.scale + f.shift;
  return activate(y, a.act);
}

// Issues the cp.async copies of K tile kt (tap kt / kc, channels (kt % kc) BK on) of
// this CTA's A rows and B columns into ring slot `slot`, zeros past every edge.
__device__ __forceinline__ void load_tile(const Args& a, int kt, int slot, int kc, int py,
                                          int px, int n0, const int (&a_pix)[Tile::kARows],
                                          const int (&a_qyx)[Tile::kARows]) {
  constexpr int kBChunks = Tile::BK * Tile::BN / 4;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int a_col = (tid % Tile::kChunksRow) * 4;
  const int tap = kt / kc, c0 = (kt - tap * kc) * Tile::BK;
  int dy = 0, dx = 0, widx = 0;
  if (a.up) {
    const int ty = tap >> 1, tx = tap & 1;
    dy = tap_d(py, ty);
    dx = tap_d(px, tx);
    widx = tap_k(py, ty) * 4 + tap_k(px, tx);
  }
  float* as = reinterpret_cast<float*>(smem4) + slot * Tile::kStage;
  float* bs = as + Tile::kA;
  const int ca = c0 + a_col;
#pragma unroll
  for (int i = 0; i < Tile::kARows; ++i) {
    const int qy = (a_qyx[i] >> 16) + dy, qx = (a_qyx[i] & 0xffff) + dx;
    const bool row_ok = a_pix[i] >= 0 && static_cast<unsigned>(qy) < static_cast<unsigned>(a.h) &&
                        static_cast<unsigned>(qx) < static_cast<unsigned>(a.w_in);
    const float* src =
        row_ok ? a.x + static_cast<long long>(a_pix[i] + dy * a.w_in + dx) * a.cin + ca : a.x;
    float* dst = as + (tid / Tile::kChunksRow + Tile::kRowsPass * i) * Tile::kLda + a_col;
    if (a.vec_a) {
      const bool ok = row_ok && ca < a.cin;
      cp_async16(dst, ok ? src : a.x, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && ca + j < a.cin;
        cp_async4(dst + j, ok ? src + j : a.x, ok);
      }
    }
  }
  // B row n is column n0 + n of the packed weight's tap slice: (C_out rows, C_in).
  const float* wt = a.w + static_cast<long long>(widx) * a.ncols * a.cin;
  for (int idx = tid; idx < kBChunks; idx += kThreads) {
    const int n = idx / Tile::kChunksRow, kb = c0 + (idx % Tile::kChunksRow) * 4;
    const bool col_ok = n0 + n < a.ncols;
    const float* src = col_ok ? wt + static_cast<long long>(n0 + n) * a.cin + kb : a.w;
    float* dst = bs + n * Tile::kLda + (idx % Tile::kChunksRow) * 4;
    if (a.vec_b) {
      const bool ok = col_ok && kb < a.cin;
      cp_async16(dst, ok ? src : a.w, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = col_ok && kb + j < a.cin;
        cp_async4(dst + j, ok ? src + j : a.w, ok);
      }
    }
  }
}

// d += this warp's products over one K tile: as and bs point at the warp's first A row
// and first B column (row g of each) of the slot, at K column t.
__device__ __forceinline__ void tile_products(const float* as, const float* bs,
                                              float (&d)[Tile::kMT][Tile::kNT][4]) {
  constexpr int kMT = Tile::kMT, kNT = Tile::kNT;
#pragma unroll
  for (int kk = 0; kk < Tile::BK; kk += 8) {
    uint32_t a_big[kMT][4], a_small[kMT][4], b_big[kNT][2], b_small[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* p = as + mt * 16 * Tile::kLda + kk;
      split(p[0], a_big[mt][0], a_small[mt][0]);                  // (g, t)
      split(p[8 * Tile::kLda], a_big[mt][1], a_small[mt][1]);        // (g + 8, t)
      split(p[4], a_big[mt][2], a_small[mt][2]);                  // (g, t + 4)
      split(p[8 * Tile::kLda + 4], a_big[mt][3], a_small[mt][3]);    // (g + 8, t + 4)
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float* q = bs + nt * 8 * Tile::kLda + kk;
      split(q[0], b_big[nt][0], b_small[nt][0]);                  // (k t, n g)
      split(q[4], b_big[nt][1], b_small[nt][1]);                  // (k t + 4, n g)
    }
    // The small products first; the products of one tile of sums follow each other
    // kMT kNT products apart.
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_tf32(d[mt][nt], a_small[mt], b_big[nt]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_tf32(d[mt][nt], a_big[mt], b_small[nt]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_tf32(d[mt][nt], a_big[mt], b_big[nt]);
  }
}

// The epilogue: bias, BatchNorm and activation on this thread's sums, stored to the
// output pixels of phase (py, px).
__device__ __forceinline__ void store_outputs(const Args& a,
                                              const float (&acc)[Tile::kMT][Tile::kNT][4],
                                              int m0, int n0, int py, int px, int warp_m,
                                              int warp_n, int g, int t4) {
  constexpr int kMT = Tile::kMT, kNT = Tile::kNT;
  const int hw = a.h * a.w_in;
  Affine col_f[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + warp_n * Tile::WN + nt * 8 + 2 * t4 + j;
      col_f[nt][j] = channel_affine(a, (col < a.ncols ? col : 0) % a.cch);
    }
  const int ho = a.up ? 2 * a.h : 1, wo = a.up ? 2 * a.w_in : 1;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * Tile::WM + mt * 16 + g + 8 * half;
      if (m >= a.rows) continue;
      const int n = m / hw, rem = m - n * hw, qy = rem / a.w_in, qx = rem - qy * a.w_in;
      const int oy = 2 * qy + py, ox = 2 * qx + px;  // (0, 0) for the 1x1 input
      const long long pix = (static_cast<long long>(n) * ho + oy) * wo + ox;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + warp_n * Tile::WN + nt * 8 + 2 * t4;
        if (col >= a.ncols) continue;
        const bool pair = col + 1 < a.ncols;
        const float v0 = finish(a, col_f[nt][0], acc[mt][nt][2 * half]);
        const float v1 = finish(a, col_f[nt][1], acc[mt][nt][2 * half + 1]);
        if (a.out_nchw) {
          const long long plane = static_cast<long long>(ho) * wo;
          a.out[(static_cast<long long>(n) * a.ncols + col) * plane + oy * wo + ox] = v0;
          if (pair)
            a.out[(static_cast<long long>(n) * a.ncols + col + 1) * plane + oy * wo + ox] = v1;
        } else if (a.vec_out && pair) {
          *reinterpret_cast<float2*>(a.out + pix * a.ncols + col) = make_float2(v0, v1);
        } else {
          a.out[pix * a.ncols + col] = v0;
          if (pair) a.out[pix * a.ncols + col + 1] = v1;
        }
      }
    }
}

__global__ void __launch_bounds__(kThreads, Tile::kMinBlocks)
    transposed_conv_kernel(const Args a) {
  constexpr int kMT = Tile::kMT, kNT = Tile::kNT, kStages = Tile::kStages;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int warp_m = warp / Tile::kWarpsN, warp_n = warp % Tile::kWarpsN;

  // blockIdx.x walks (M tile, phase, N tile), the N tile fastest, so that the CTAs
  // that read the same input rows run together.
  const int phases = a.up ? 4 : 1;
  const int n_tiles = (a.ncols + Tile::BN - 1) / Tile::BN;
  int bid = blockIdx.x;
  const int n_tile = bid % n_tiles;
  bid /= n_tiles;
  const int phase = bid % phases;
  const int m_tile = bid / phases;
  const int py = phase >> 1, px = phase & 1;
  const int m0 = m_tile * Tile::BM, n0 = n_tile * Tile::BN;
  const int hw = a.h * a.w_in;

  // A row m is input pixel m in NHW order.  The rows this thread copies, with their
  // (qy, qx), or -1 past the last row.
  int a_pix[Tile::kARows], a_qyx[Tile::kARows];
#pragma unroll
  for (int i = 0; i < Tile::kARows; ++i) {
    const int m = m0 + tid / Tile::kChunksRow + Tile::kRowsPass * i;
    a_pix[i] = m < a.rows ? m : -1;
    const int rem = m % hw, qy = rem / a.w_in;
    a_qyx[i] = (qy << 16) | (rem - qy * a.w_in);
  }

  const int kc = (a.cin + Tile::BK - 1) / Tile::BK;  // K tiles a tap
  const int k_tiles = (a.up ? 4 : 1) * kc;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_tile(a, s, s, kc, py, px, n0, a_pix, a_qyx);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed, and every warp is done with slot kt - 1
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_tile(a, next, next % kStages, kc, py, px, n0, a_pix, a_qyx);
    cp_async_commit();

    const float* slot = smem + (kt % kStages) * Tile::kStage;
    const float* as = slot + (warp_m * Tile::WM + g) * Tile::kLda + t4;
    const float* bs = slot + Tile::kA + (warp_n * Tile::WN + g) * Tile::kLda + t4;
    // Each K tile's products are summed in registers of their own and added to the
    // running sums by an f32 add: the tensor cores truncate every sum they return, and
    // the truncations of all 3 K / 8 products of a long K would pile up in one
    // direction (1.5e-5 of the largest output at K 2,048, against 5e-7 so).
    float part[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
    tile_products(as, bs, part);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }
  cp_async_wait<0>();

  store_outputs(a, acc, m0, n0, py, px, warp_m, warp_n, g, t4);
}


// The frame stage: a k4 s2 p1 transposed conv to at most kFrameMaxCout channels.  A
// phase GEMM of so few columns reads each input pixel 16 times through L2; here a CTA
// holds `rows` input rows and their halo in shared memory, kFrameKC channels at a time,
// and each thread computes the 2 x 2 outputs of one input pixel from its 3 x 3
// neighbours with f32 FMAs on the CUDA cores, which are not the limit at C_out <= 4.
__host__ __device__ inline int frame_rows(int h, int w) {
  const int r = kThreads / w;
  return r < 1 ? 1 : (r > h ? h : r);
}

__host__ __device__ inline int frame_stage_floats(int w, int rows, int cout) {
  return (rows + 2) * (w + 2) * kFrameLdx + 16 * cout * kFrameKC;
}

template <int kCout>
__device__ __forceinline__ void load_frame_chunk(const Args& a, int chunk, float* xs, int n,
                                                 int r0, int rows) {
  const int h = a.h, w = a.w_in, cin = a.cin, pw = w + 2;
  const int npix = (rows + 2) * pw;
  float* ws = xs + npix * kFrameLdx;
  const int c0 = chunk * kFrameKC;
  for (int idx = threadIdx.x; idx < npix * (kFrameKC / 4); idx += kThreads) {
    const int p = idx / (kFrameKC / 4), c4 = (idx % (kFrameKC / 4)) * 4;
    const int iy = r0 - 1 + p / pw, ix = p % pw - 1;
    const bool pix_ok =
        static_cast<unsigned>(iy) < static_cast<unsigned>(h) &&
        static_cast<unsigned>(ix) < static_cast<unsigned>(w);
    const float* src =
        pix_ok ? a.x + ((static_cast<long long>(n) * h + iy) * w + ix) * cin + c0 + c4 : a.x;
    float* dst = xs + p * kFrameLdx + c4;
    if (a.vec_a) {
      const bool ok = pix_ok && c0 + c4 < cin;
      cp_async16(dst, ok ? src : a.x, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = pix_ok && c0 + c4 + j < cin;
        cp_async4(dst + j, ok ? src + j : a.x, ok);
      }
    }
  }
  // ws[tap][co][ci] from the packed (ky, kx, co, ci) weight
  for (int idx = threadIdx.x; idx < 16 * kCout * kFrameKC; idx += kThreads) {
    const int ci = idx % kFrameKC, row = idx / kFrameKC;  // row = tap kCout + co
    const bool ok = c0 + ci < cin;
    const float* src = a.w + static_cast<long long>(row) * cin + c0 + ci;
    cp_async4(ws + idx, ok ? src : a.w, ok);
  }
}

template <int kCout>
__global__ void __launch_bounds__(kThreads) frame_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = a.h, w = a.w_in, pw = w + 2;
  const int rows = frame_rows(h, w);
  const int row_blocks = (h + rows - 1) / rows;
  const int n = blockIdx.x / row_blocks, r0 = (blockIdx.x % row_blocks) * rows;
  const int npix = (rows + 2) * pw;
  const int stage = frame_stage_floats(w, rows, kCout);
  const int chunks = (a.cin + kFrameKC - 1) / kFrameKC;
  const int ly = threadIdx.x / w, lx = threadIdx.x % w;
  const bool active = ly < rows && r0 + ly < h;

  float acc[4][kCout];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int co = 0; co < kCout; ++co) acc[p][co] = 0.f;

  load_frame_chunk<kCout>(a, 0, smem, n, r0, rows);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)
      load_frame_chunk<kCout>(a, c + 1, smem + ((c + 1) & 1) * stage, n, r0, rows);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c has landed
    if (active) {
      const float* xs = smem + (c & 1) * stage;
      const float* ws = xs + npix * kFrameLdx;
      const float* xc = xs + ((ly + 1) * pw + lx + 1) * kFrameLdx;
#pragma unroll
      for (int k4 = 0; k4 < kFrameKC; k4 += 4) {
        float4 xv[3][3];
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx)
            xv[dy + 1][dx + 1] =
                *reinterpret_cast<const float4*>(xc + (dy * pw + dx) * kFrameLdx + k4);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int py = p >> 1, px = p & 1, ty = t >> 1, tx = t & 1;
            const float4 xq = xv[tap_d(py, ty) + 1][tap_d(px, tx) + 1];
            const int tap = tap_k(py, ty) * 4 + tap_k(px, tx);
#pragma unroll
            for (int co = 0; co < kCout; ++co) {
              const float4 wv =
                  *reinterpret_cast<const float4*>(ws + (tap * kCout + co) * kFrameKC + k4);
              float s = acc[p][co];
              s = fmaf(xq.x, wv.x, s);
              s = fmaf(xq.y, wv.y, s);
              s = fmaf(xq.z, wv.z, s);
              acc[p][co] = fmaf(xq.w, wv.w, s);
            }
          }
      }
    }
    __syncthreads();  // every thread is done with slot c & 1 before chunk c + 2 lands in it
  }
  cp_async_wait<0>();
  if (!active) return;
  const int qy = r0 + ly, ho = 2 * h, wo = 2 * w;
  Affine f[kCout];
#pragma unroll
  for (int co = 0; co < kCout; ++co) f[co] = channel_affine(a, co);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int oy = 2 * qy + (p >> 1), ox = 2 * lx + (p & 1);
#pragma unroll
    for (int co = 0; co < kCout; ++co) {
      const float v = finish(a, f[co], acc[p][co]);
      if (a.out_nchw)
        a.out[((static_cast<long long>(n) * kCout + co) * ho + oy) * wo + ox] = v;
      else
        a.out[((static_cast<long long>(n) * ho + oy) * wo + ox) * kCout + co] = v;
    }
  }
}

int launch_gemm(const Args& a, cudaStream_t stream) {
  auto kernel = transposed_conv_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m_tiles = (static_cast<long long>(a.rows) + Tile::BM - 1) / Tile::BM;
  const long long grid = m_tiles * (a.up ? 4 : 1) * ((a.ncols + Tile::BN - 1) / Tile::BN);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(grid), kThreads, Tile::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kCout>
int launch_frame(const Args& a, cudaStream_t stream) {
  auto kernel = frame_kernel<kCout>;
  const int rows = frame_rows(a.h, a.w_in);
  const int bytes = 2 * frame_stage_floats(a.w_in, rows, kCout) * 4;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(a.n) * ((a.h + rows - 1) / rows);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(grid), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}


bool frame_path(const Args& a) {
  return a.up && a.ncols <= kFrameMaxCout && a.w_in <= kFrameMaxWidth;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Fills `a` from the C entry's arguments; false where the kernel takes no such call.
bool make_args(const float* x, const float* w, const float* bias, const float* bn_mean,
               const float* bn_var, const float* bn_weight, const float* bn_bias, float eps,
               float* out, int n, int h, int w_in, int cin, int cout, int up, int act,
               int out_nchw, Args* a) {
  const bool bn_all = bn_mean && bn_var && bn_weight && bn_bias;
  const bool bn_none = !bn_mean && !bn_var && !bn_weight && !bn_bias;
  if (!x || !w || !bias || !out || !(bn_all || bn_none) || n < 1 || h < 1 || w_in < 1 ||
      cin < 1 || cout < 1 || h > kMaxSide || w_in > kMaxSide || (up != 0 && up != 1) ||
      act < 0 || act >= kNumActs || (!up && (h != 1 || w_in != 1 || out_nchw)))
    return false;
  const long long rows = static_cast<long long>(n) * h * w_in;
  const long long ncols = up ? cout : 16LL * cout;
  if (rows + 256 > 0x7fffffffLL || ncols > 0x7fffffffLL) return false;
  a->x = x;
  a->w = w;
  a->bias = bias;
  a->bn_mean = bn_mean;
  a->bn_var = bn_var;
  a->bn_weight = bn_weight;
  a->bn_bias = bn_bias;
  a->out = out;
  a->eps = eps;
  a->n = n;
  a->h = h;
  a->w_in = w_in;
  a->cin = cin;
  a->ncols = static_cast<int>(ncols);
  a->cch = cout;
  a->rows = static_cast<int>(rows);
  a->up = up;
  a->act = act;
  a->out_nchw = out_nchw;
  a->vec_a = cin % 4 == 0 && aligned(x, 16);
  a->vec_b = cin % 4 == 0 && aligned(w, 16);
  a->vec_out = a->ncols % 2 == 0 && aligned(out, 8);
  return true;
}

}  // namespace

// Launches one stage on `stream`: x (NHWC, n x h x w x cin) through the packed weight
// (see the note at the top), + bias, BatchNorm with the running statistics when
// bn_mean is not null (then every bn_* is given), then activation `act` (0 identity,
// 1 relu, 2 leaky relu 0.2, 3 sigmoid, 4 tanh, 5 elu).  up = 1: k4 s2 p1 into
// (n, 2h, 2w, cout), NCHW if out_nchw; up = 0: a 1x1 input (h = w = 1) into
// (n, 4, 4, cout) NHWC.  Returns a cudaError_t, 0 when the launch was accepted; faults
// during the run surface at the caller's next synchronisation.
extern "C" int transposed_conv_f32(const float* x, const float* w, const float* bias,
                                   const float* bn_mean, const float* bn_var,
                                   const float* bn_weight, const float* bn_bias, float eps,
                                   float* out, int n, int h, int w_in, int cin, int cout,
                                   int up, int act, int out_nchw, void* stream) {
  Args a;
  if (!make_args(x, w, bias, bn_mean, bn_var, bn_weight, bn_bias, eps, out, n, h, w_in, cin,
                 cout, up, act, out_nchw, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frame_path(a)) {
    switch (a.ncols) {
      case 1: return launch_frame<1>(a, s);
      case 2: return launch_frame<2>(a, s);
      case 3: return launch_frame<3>(a, s);
      default: return launch_frame<4>(a, s);
    }
  }
  return launch_gemm(a, s);
}

extern "C" const char* transposed_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
