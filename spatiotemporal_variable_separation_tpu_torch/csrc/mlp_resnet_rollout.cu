// Forward Euler rollout of the MLP-ResNet temporal integrator, f32, in one launch.
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
// 1 block, 100 steps) the rollout does 2*B*(code*H + H*H + H*code)*(n-1) = 3.6 GFLOP
// on about 1.6 MB of data (1.13 MB of weights, 0.5 MB of output), so the card's
// bound is its f32 rate outside the tensor cores: about 53 us at 67 TFLOP/s.  The
// steps are sequential, and every step needs all the weights, which are more than
// one SM's 227 KB of shared memory (W2 alone is 1 MiB).
//
// This is the streaming variant.  mlp_resnet_rollout_cluster.cu holds the weights
// resident in a thread-block cluster's shared memory, as the TPU kernel holds them
// in VMEM, and serves every shape whose weights a cluster of up to 16 CTAs can
// hold; ops/rollout.py:rollout_plan sends the rest here (e.g. 4 blocks at hidden
// 512).  One thread block owns a tile of kRows batch rows and loops over every
// step and every block of the MLP itself.  The tile's activations (t, h1, h2: kRows*(code + 2H) floats,
// 33 KB at the serving shapes) live in shared memory, stored row-index-fastest so
// a thread reads one column's kRows values as two broadcast float4 loads.  The
// weights stream from device memory every step and stay resident in the 50 MB L2.
// The two hidden layers give one thread per hidden column, which reuses each
// weight it loads for all kRows rows; the code-wide output layer gives one warp
// per output column and reduces over the hidden dimension with shuffles.  A
// ragged last tile is masked, not padded by the caller.  At batch 64 only 8 of the
// 132 SMs work, each limited by pulling 1.13 MB per step out of L2, so the kernel
// sits far above the bound.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 8;        // batch rows per thread block
constexpr int kThreads = 512;   // one thread per hidden column (loops past 512)
constexpr int kMaxBlocks = 16;  // MLP-ResNet blocks whose pointers fit the argument

struct BlockParams {
  const float* p[6 * kMaxBlocks];  // w1 b1 w2 b2 w3 b3 of each block
};

__device__ __forceinline__ void load_rows(const float* s, float (&v)[kRows]) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store_rows(float* s, const float (&v)[kRows]) {
  reinterpret_cast<float4*>(s)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(s)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// out_s[j][r] = relu(bias[j] + sum_k in_s[k][r] * w[k][j]) for j < n_out.
// The relu belongs to the next layer's pre-activation (reference MLP).
__device__ __forceinline__ void dense_relu(const float* __restrict__ in_s, int n_in,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out_s, int n_out) {
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    float acc[kRows];
    const float b = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < n_in; ++k) {
      const float wk = __ldg(w + static_cast<size_t>(k) * n_out + j);
      float x[kRows];
      load_rows(in_s + k * kRows, x);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(x[r], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaxf(acc[r] + b, 0.f);
    store_rows(out_s + j * kRows, acc);
  }
}

// t_s[c][r] += b3[c] + sum_k h_s[k][r] * w3[k][c]: one warp per output column.
__device__ __forceinline__ void dense_residual(const float* __restrict__ h_s, int hidden,
                                               const float* __restrict__ w3,
                                               const float* __restrict__ b3,
                                               float* __restrict__ t_s, int code) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int c = threadIdx.x >> 5; c < code; c += n_warps) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = lane; k < hidden; k += 32) {
      const float wk = __ldg(w3 + static_cast<size_t>(k) * code + c);
      float x[kRows];
      load_rows(h_s + k * kRows, x);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(x[r], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane < kRows) {  // lane r owns row r
      float v = acc[0];
#pragma unroll
      for (int r = 1; r < kRows; ++r)
        if (lane == r) v = acc[r];
      t_s[c * kRows + lane] += v + __ldg(b3 + c);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rollout_kernel(const float* __restrict__ t0,
               const __grid_constant__ BlockParams params,  // indexed in place, no local copy
               int n_blocks,
               float* __restrict__ out, int batch, int code, int hidden, int n_steps) {
  extern __shared__ float4 smem[];  // float4 for the 16-byte alignment of load_rows
  float* t_s = reinterpret_cast<float*>(smem);  // [code][kRows]
  float* h1_s = t_s + code * kRows;             // [hidden][kRows]
  float* h2_s = h1_s + hidden * kRows;          // [hidden][kRows]
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - row0);

  for (int i = threadIdx.x; i < code * kRows; i += blockDim.x) {
    const int c = i / kRows;
    const int r = i % kRows;
    float v = 0.f;  // masked rows run on zeros and are never written
    if (r < rows) {
      const size_t idx = static_cast<size_t>(row0 + r) * code + c;
      v = t0[idx];
      out[idx] = v;
    }
    t_s[i] = v;
  }
  __syncthreads();

  for (int k = 1; k < n_steps; ++k) {
    for (int b = 0; b < n_blocks; ++b) {
      const float* const* p = params.p + 6 * b;
      dense_relu(t_s, code, p[0], p[1], h1_s, hidden);
      __syncthreads();
      dense_relu(h1_s, hidden, p[2], p[3], h2_s, hidden);
      __syncthreads();
      dense_residual(h2_s, hidden, p[4], p[5], t_s, code);
      __syncthreads();
    }
    // Reads t_s only; the next write to t_s is two barriers away.
    float* out_k = out + static_cast<size_t>(k) * batch * code;
    for (int i = threadIdx.x; i < rows * code; i += blockDim.x) {
      const int r = i / code;
      const int c = i % code;
      out_k[static_cast<size_t>(row0 + r) * code + c] = t_s[c * kRows + r];
    }
  }
}

}  // namespace

// Launches the rollout on `stream`.  `params` is a host array of 6 * n_blocks device
// pointers (w1 b1 w2 b2 w3 b3 per block).  Returns a cudaError_t: 0 when the launch
// was accepted.  Faults during the run surface at the caller's next synchronisation.
extern "C" int mlp_resnet_rollout_f32(const float* t0, const void* const* params,
                                      int n_blocks, float* out, int batch, int code,
                                      int hidden, int n_steps, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || batch < 1 || code < 1 || hidden < 1 ||
      n_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockParams bp{};
  for (int i = 0; i < 6 * n_blocks; ++i) bp.p[i] = static_cast<const float*>(params[i]);
  const size_t smem = sizeof(float) * kRows * (static_cast<size_t>(code) + 2 * hidden);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (batch + kRows - 1) / kRows;
  rollout_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      t0, bp, n_blocks, out, batch, code, hidden, n_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mlp_resnet_rollout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
