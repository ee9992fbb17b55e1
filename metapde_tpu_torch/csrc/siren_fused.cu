// Fused SIREN field inference for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (metapde_tpu_torch/ops/siren_fused.py).
//
// Replaces metapde_tpu/ops/pallas_siren.py::siren_apply_fused, the TPU
// kernel that runs the whole SIREN layer chain per point block:
//   h = x * in_scale
//   h = sin(omega * (h W_l + b_l))        for each hidden layer l
//   out = (h W_out + b_out) * out_scale
//
// What bounds it on this card: f32 FMA throughput. A 3x64 SIREN does
// 2 * (in*H + (L-1)*H^2 + H*out) ~ 16.8 kFLOP per point against 12 bytes
// of input and 4 of output, so the reads of x and writes of out are tiny
// next to the arithmetic.
//
// Design: one block owns a tile of kTile points. It keeps the tile's
// activations in shared memory (two ping-pong buffers) and streams one
// layer's W and b at a time into shared memory, so no activation ever goes
// back to device memory; only the final output is written. Each thread
// computes outputs of the current layer with IEEE f32 FMAs and sinf (the
// arguments reach |omega * a| ~ 30, where __sinf loses accuracy), so the
// result matches the plain PyTorch chain to ~1e-6. The ragged last tile is
// zero-filled on load and masked on store. No tensor cores, TMA or wgmma yet.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // points per block
constexpr int kThreads = 256;    // threads per block
constexpr int kMaxWidth = 128;   // largest in_dim, hidden and out_dim taken

__global__ void __launch_bounds__(kThreads)
siren_fused_kernel(const float* __restrict__ x, const float* __restrict__ ws,
                   const float* __restrict__ bs, const float* __restrict__ wout,
                   const float* __restrict__ bout,
                   const float* __restrict__ in_scale,
                   const float* __restrict__ out_scale,
                   float* __restrict__ out, int n, int in_dim, int hidden,
                   int n_hidden, int out_dim, float omega, int act_stride) {
  // shared layout: act0 [kTile, act_stride] | act1 [kTile, act_stride] |
  //                b_s [kMaxWidth] | w_s [k_dim, width] of the current layer
  extern __shared__ float smem[];
  float* h_in = smem;
  float* h_out = h_in + kTile * act_stride;
  float* b_s = h_out + kTile * act_stride;
  float* w_s = b_s + kMaxWidth;

  const int tile0 = blockIdx.x * kTile;
  const int rows = min(kTile, n - tile0);

  // the tile's inputs, scaled; rows past n are zero and never stored
  for (int i = threadIdx.x; i < kTile * in_dim; i += blockDim.x) {
    const int p = i / in_dim, c = i - p * in_dim;
    float v = 0.f;
    if (p < rows) v = x[(size_t)(tile0 + p) * in_dim + c] * in_scale[c];
    h_in[p * act_stride + c] = v;
  }

  const float* w_layer = ws;
  int k_dim = in_dim;
  for (int l = 0; l < n_hidden; ++l) {
    for (int i = threadIdx.x; i < k_dim * hidden; i += blockDim.x)
      w_s[i] = w_layer[i];
    for (int i = threadIdx.x; i < hidden; i += blockDim.x)
      b_s[i] = bs[l * hidden + i];
    __syncthreads();
    // neighbouring threads share a point (broadcast read of h) and take
    // neighbouring columns (conflict-free read of W)
    for (int i = threadIdx.x; i < kTile * hidden; i += blockDim.x) {
      const int p = i / hidden, j = i - p * hidden;
      const float* hp = h_in + p * act_stride;
      float acc = 0.f;
      for (int k = 0; k < k_dim; ++k) acc = fmaf(hp[k], w_s[k * hidden + j], acc);
      h_out[p * act_stride + j] = sinf(omega * (acc + b_s[j]));
    }
    __syncthreads();  // h_out complete, w_s free for the next layer
    w_layer += k_dim * hidden;
    k_dim = hidden;
    float* t = h_in;
    h_in = h_out;
    h_out = t;
  }

  for (int i = threadIdx.x; i < hidden * out_dim; i += blockDim.x) w_s[i] = wout[i];
  for (int i = threadIdx.x; i < out_dim; i += blockDim.x) b_s[i] = bout[i];
  __syncthreads();
  for (int i = threadIdx.x; i < rows * out_dim; i += blockDim.x) {
    const int p = i / out_dim, o = i - p * out_dim;
    const float* hp = h_in + p * act_stride;
    float acc = 0.f;
    for (int k = 0; k < hidden; ++k) acc = fmaf(hp[k], w_s[k * out_dim + o], acc);
    out[(size_t)(tile0 + p) * out_dim + o] = (acc + b_s[o]) * out_scale[o];
  }
}

}  // namespace

// x [n, in_dim]; ws = W_0 [in_dim, hidden] then W_1.. [hidden, hidden],
// concatenated row-major; bs [n_hidden, hidden]; wout [hidden, out_dim];
// bout, out_scale [out_dim]; in_scale [in_dim]; out [n, out_dim]. All f32,
// contiguous, on the current device. Launches on `stream`, does not
// synchronise, allocates nothing. Returns a cudaError_t value (0 = launched).
extern "C" int siren_fused_forward(const float* x, const float* ws,
                                   const float* bs, const float* wout,
                                   const float* bout, const float* in_scale,
                                   const float* out_scale, float* out, int n,
                                   int in_dim, int hidden, int n_hidden,
                                   int out_dim, float omega, void* stream) {
  if (n < 0 || in_dim < 1 || in_dim > kMaxWidth || hidden < 1 ||
      hidden > kMaxWidth || n_hidden < 1 || out_dim < 1 || out_dim > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int act_stride = in_dim > hidden ? in_dim : hidden;
  const int w_rows = act_stride;
  const int w_cols = hidden > out_dim ? hidden : out_dim;
  const size_t smem =
      (size_t)(2 * kTile * act_stride + kMaxWidth + w_rows * w_cols) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      siren_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kTile - 1) / kTile);
  siren_fused_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, ws, bs, wout, bout, in_scale, out_scale, out, n, in_dim, hidden,
      n_hidden, out_dim, omega, act_stride);
  return (int)cudaGetLastError();
}
