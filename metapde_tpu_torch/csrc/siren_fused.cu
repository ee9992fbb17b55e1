// Task-batched fused SIREN field inference for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (metapde_tpu_torch/ops/siren_fused.py).
//
// Replaces metapde_tpu/ops/pallas_siren.py::siren_apply_fused (the
// pallas_call at pallas_siren.py:91, body _kernel), which the JAX package
// vmaps over the eval tasks (metapde_tpu/train/validation.py:148). For each
// task t and point n:
//   h = x[t, n] * in_scale[t]
//   h = sin(omega * (h W_l[t] + b_l[t]))        for each hidden layer l
//   out[t, n] = (h W_out[t] + b_out[t]) * out_scale[t]
// A 2-D call is the T = 1 case; shared weights (k = 0 deployment, every task
// on the meta-learned init) are a task stride of 0.
//
// What bounds it on this card: operations. A 3x64 SIREN does 8,384
// multiply-adds and 192 sines per point against 12 bytes of input and 4 of
// output. 97% of the multiply-adds are in the hidden x hidden layers, which
// run on the tensor cores; the sines, the first layer (k = in_dim) and the
// output layer run on the CUDA cores and the SFU. Measured (PERF.md), the
// kernel is bound by the latency of each warp's chain of dependent shared
// loads, tensor-core products and sines, at 2 blocks (16 warps) per SM.
//
// Design, limit by limit:
// 1. Shared-memory issue rate (a plain loop does two 32-bit loads per FMA).
//    The hidden x hidden layers are 3xTF32 tensor-core products (mma.sync
//    m16n8k8: a = a_hi + a_lo, and a_hi b_hi + a_hi b_lo + a_lo b_hi keeps
//    f32 accuracy where one TF32 product keeps ~3 digits): one 32-bit
//    shared load feeds 16 or 32 multiply-adds. Activations are stored k-major ([k][point]) and
//    weights row-major, rows padded by 8 floats so that each fragment load
//    hits 32 banks. The first and output layers give each lane one point,
//    so their weight reads are broadcasts and their activation accesses are
//    rows of 32 consecutive points.
// 2. Weights reloaded per tile. The grid is persistent (blocks from the
//    occupancy calculator, one contiguous run of (task, tile) items each,
//    task-major). Where the whole network fits in shared memory it is loaded
//    once per block per task; a block reloads only when its task changes
//    (never, for shared weights). The copy is cp.async, one commit group per
//    layer, so layer 0 starts while later layers are still arriving. Where
//    it does not fit (e.g. 8 layers at width 128), layers stream through two
//    slots: layer l+1's copy is issued before layer l computes. A tile's
//    points are fetched with cp.async while the previous tile computes.
// 3. An empty card at the deployment shape. All tasks go in one launch: 8
//    tasks x 1024 points are 128 tiles of 64 points, one per SM, where a
//    launch per task would fill 16 of the 132 SMs.
// 4. The sine. Each argument is reduced to [-pi, pi] (a two-part 2 pi,
//    exact for |x| <= 8192) and goes to the SFU sine: ~8 instructions where
//    IEEE sinf takes ~25, with an absolute error of ~4e-7 (the arguments
//    reach |omega a| ~ 30, where the SFU sine without the reduction loses
//    accuracy). Wider arguments take IEEE sinf.
// Padded columns (widths rounded up to 32) carry zero weights and bias, so
// they hold sin(0) = 0 and cost no accuracy. The ragged last tile is
// zero-filled on load and masked on store.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                 // points per tile
constexpr int kThreads = 256;             // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 128;            // largest in_dim, hidden and out_dim taken
// floats per activation row: 16-byte aligned, and 8 more than the tile so
// that the 32 lanes' fragment loads (8 points x 4 k rows) hit 32 banks
constexpr int kActStride = kTile + 8;
constexpr int kColBlock = 32;             // a warp tile is 16 points x 32 columns

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The network's shape, in floats: where each layer sits in one task's packed
// parameters and in shared memory. Layers 0..n_hidden-1 are hidden; layer
// n_hidden is the output layer.
struct Net {
  int in_dim, hidden, hidden_pad, n_hidden, out_dim;
  int resident;      // 1: every layer has its own slot; 0: two streaming slots
  int slot_floats;   // size of one streaming slot

  __host__ __device__ int k_dim(int l) const { return l == 0 ? in_dim : hidden; }
  __host__ __device__ int cols(int l) const { return l < n_hidden ? hidden : out_dim; }
  __host__ __device__ int cols_pad(int l) const { return l < n_hidden ? hidden_pad : out_dim; }
  // rows of a layer's weights in shared memory: the tensor-core layers take
  // k in steps of 8 (rows past hidden are zero)
  __host__ __device__ int k_rows(int l) const {
    return l > 0 && l < n_hidden ? round_up(hidden, 8) : k_dim(l);
  }
  // floats per weight row in shared memory: hidden layers are padded by 8
  // so that the fragment loads of 4 k rows hit 32 banks
  __host__ __device__ int w_stride(int l) const {
    return l < n_hidden ? hidden_pad + 8 : out_dim;
  }
  // the first slot also holds in_scale, the output layer's out_scale
  __host__ __device__ int extra(int l) const {
    return l == 0 ? in_dim : l == n_hidden ? out_dim : 0;
  }
  // packed layout per task: W_0 b_0 W_1 b_1 ... W_out b_out in_scale out_scale
  __host__ __device__ long long w_off(int l) const {
    return l == 0 ? 0
                  : (long long)in_dim * hidden + hidden +
                        (long long)(l - 1) * (hidden * hidden + hidden);
  }
  __host__ __device__ long long b_off(int l) const {
    return w_off(l) + (long long)k_dim(l) * cols(l);
  }
  __host__ __device__ long long extra_off(int l) const {
    return b_off(n_hidden) + out_dim + (l == 0 ? 0 : in_dim);
  }
  __host__ __device__ long long task_floats() const {
    return b_off(n_hidden) + out_dim + in_dim + out_dim;
  }
  // a slot holds W [k_rows][w_stride], b [cols_pad], then the extra scales
  __host__ __device__ int bias_at(int l) const { return k_rows(l) * w_stride(l); }
  __host__ __device__ int extra_at(int l) const { return bias_at(l) + cols_pad(l); }
  __host__ __device__ int slot_size(int l) const { return round_up(extra_at(l) + extra(l), 4); }
  __host__ __device__ int resident_off(int l) const {
    return l == 0 ? 0 : slot_size(0) + (l - 1) * slot_size(1);
  }
  __host__ __device__ int act_buf() const { return hidden_pad * kActStride; }
  __host__ __device__ int act_floats() const { return 2 * act_buf(); }
  __host__ __device__ int x_floats() const { return round_up(kTile * in_dim, 4); }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's commit groups are pending (n is
// clamped to 7, which waits for more and is therefore still correct).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Issue the copy of layer l of one task's parameters into a slot, padding
// the rows past k_dim(l) and the columns past cols(l) with zeros (src-size 0
// makes cp.async zero-fill).
__device__ __forceinline__ void issue_layer(const Net& net, const float* __restrict__ task_params,
                                            int l, float* slot) {
  const int K = net.k_dim(l), J = net.cols(l), ws = net.w_stride(l);
  const int nw = net.bias_at(l);
  const float* w = task_params + net.w_off(l);
  // (k, j) of element i = k * ws + j, advanced by kThreads without dividing
  const int dk = kThreads / ws, dj = kThreads - dk * ws;
  int k = threadIdx.x / ws, j = threadIdx.x - k * ws;
  for (int i = threadIdx.x; i < nw; i += kThreads) {
    const bool real = k < K && j < J;
    cp_async4(slot + i, real ? w + (long long)k * J + j : w, real ? 4 : 0);
    k += dk;
    j += dj;
    if (j >= ws) {
      j -= ws;
      ++k;
    }
  }
  const float* b = task_params + net.b_off(l);
  for (int i = threadIdx.x; i < net.cols_pad(l); i += kThreads)
    cp_async4(slot + nw + i, i < J ? b + i : b, i < J ? 4 : 0);
  const float* e = task_params + net.extra_off(l);
  for (int i = threadIdx.x; i < net.extra(l); i += kThreads)
    cp_async4(slot + net.extra_at(l) + i, e + i, 4);
}

// Issue the copy of one tile's points ([kTile][in_dim], rows past `rows`
// zero) into the staging buffer.
__device__ __forceinline__ void issue_points(const float* __restrict__ src, int rows, int in_dim,
                                             float* xs) {
  const int real = rows * in_dim;
  for (int i = threadIdx.x; i < kTile * in_dim; i += kThreads)
    cp_async4(xs + i, i < real ? src + i : src, i < real ? 4 : 0);
}

// sin(x) for the activations: x - 2 pi n with n = rint(x / 2 pi) in two
// parts (exact for |x| <= 8192), then the SFU sine, whose absolute error on
// [-pi, pi] is about 2^-21; wider arguments take IEEE sinf.
__device__ __noinline__ float sin_wide(float x) { return sinf(x); }

__device__ __forceinline__ float sin_reduced(float x) {
  if (fabsf(x) > 8192.f) return sin_wide(x);
  const float n = rintf(x * 0.159154943091895336f);
  const float r = fmaf(n, 1.74845553e-07f, fmaf(n, -6.28318548202514648f, x));
  return __sinf(r);
}

// x = hi + lo, hi rounded to TF32 (to nearest, ties away) and lo exact in
// f32; the tensor cores read the top 19 bits of lo
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b for a 16 x 8 (row) by 8 x 8 (col) TF32 product, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A hidden x hidden layer on the tensor cores (3xTF32 mma.sync.m16n8k8):
// act_out[j][p] = sin(omega (sum_k act_in[k][p] w[k][j] + b[j])) for j < Jp.
// A warp tile is 16 points x 32 columns (4 products of 8 columns); the A
// fragment (points x k) is read from the k-major activations, the B fragment
// (k x columns) from the row-major weights.
__device__ __forceinline__ void hidden_layer(const float* __restrict__ act_in,
                                             float* __restrict__ act_out,
                                             const float* __restrict__ w,
                                             const float* __restrict__ b, int Kp, int Jp, int ws,
                                             float omega) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column
  const int n_warp_tiles = (kTile / 16) * (Jp / kColBlock);
  for (int wt = warp; wt < n_warp_tiles; wt += kWarps) {
    const int p0 = (wt % (kTile / 16)) * 16;
    const int j0 = (wt / (kTile / 16)) * kColBlock;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float* a_ptr = act_in + t * kActStride + p0 + g;
    const float* b_ptr = w + t * ws + j0 + g;
#pragma unroll 2
    for (int k0 = 0; k0 < Kp; k0 += 8) {
      const float* ak = a_ptr + k0 * kActStride;
      unsigned a_hi[4], a_lo[4];
      split_tf32(ak[0], a_hi[0], a_lo[0]);                       // point g,     k t
      split_tf32(ak[8], a_hi[1], a_lo[1]);                       // point g + 8, k t
      split_tf32(ak[4 * kActStride], a_hi[2], a_lo[2]);          // point g,     k t + 4
      split_tf32(ak[4 * kActStride + 8], a_hi[3], a_lo[3]);      // point g + 8, k t + 4
      const float* bk = b_ptr + k0 * ws;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        unsigned b_hi[2], b_lo[2];
        split_tf32(bk[nt * 8], b_hi[0], b_lo[0]);                // k t,     column g
        split_tf32(bk[4 * ws + nt * 8], b_hi[1], b_lo[1]);       // k t + 4, column g
        mma_tf32(acc[nt], a_lo, b_hi[0], b_hi[1]);
        mma_tf32(acc[nt], a_hi, b_lo[0], b_lo[1]);
        mma_tf32(acc[nt], a_hi, b_hi[0], b_hi[1]);
      }
    }
    // accumulator fragment: points g (d0, d1) and g + 8 (d2, d3); columns
    // 2t (d0, d2) and 2t + 1 (d1, d3) of each 8-column product
    float* o = act_out + p0 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = j0 + nt * 8 + 2 * t;
      const float b0 = b[j], b1 = b[j + 1];
      o[j * kActStride] = sin_reduced(omega * (acc[nt][0] + b0));
      o[(j + 1) * kActStride] = sin_reduced(omega * (acc[nt][1] + b1));
      o[j * kActStride + 8] = sin_reduced(omega * (acc[nt][2] + b0));
      o[(j + 1) * kActStride + 8] = sin_reduced(omega * (acc[nt][3] + b1));
    }
  }
}

// The first layer (k = in_dim, usually 2) on the CUDA cores, from the staged
// points xs [kTile][in_dim]: act_out[j][p] = sin(omega (sum_k (xs[p][k]
// in_scale[k]) w[k][j] + b[j])) for j < Jp. A lane owns one point and 16
// columns: the weights are warp-wide broadcasts and each store is one row
// of 32 consecutive points, free of bank conflicts.
__device__ __forceinline__ void first_layer(const float* __restrict__ xs,
                                            const float* __restrict__ in_scale,
                                            float* __restrict__ act_out,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b, int K, int Jp, int ws,
                                            float omega) {
  constexpr int kCols = 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warp_tiles = (kTile / 32) * (Jp / kCols);
  for (int wt = warp; wt < n_warp_tiles; wt += kWarps) {
    const int p = (wt % (kTile / 32)) * 32 + lane;
    const int j0 = (wt / (kTile / 32)) * kCols;
    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float h = xs[p * K + k] * in_scale[k];
      const float4* wk = reinterpret_cast<const float4*>(w + k * ws + j0);
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const float4 v = wk[q];
        acc[4 * q] = fmaf(h, v.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(h, v.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(h, v.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(h, v.w, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      act_out[(j0 + j) * kActStride + p] = sin_reduced(omega * (acc[j] + b[j0 + j]));
  }
}

// The output layer on a tile, written to device memory. A lane owns one
// point and one column and sums k in four interleaved partial sums.
__device__ __forceinline__ void output_layer(const float* __restrict__ act_in,
                                             const float* __restrict__ w,
                                             const float* __restrict__ b,
                                             const float* __restrict__ out_scale,
                                             float* __restrict__ out, int K, int J, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int wt = warp; wt < (kTile / 32) * J; wt += kWarps) {
    const int p = (wt % (kTile / 32)) * 32 + lane, o = wt / (kTile / 32);
    const float* a = act_in + p;
    const float* wo = w + o;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      s0 = fmaf(a[k * kActStride], wo[k * J], s0);
      s1 = fmaf(a[(k + 1) * kActStride], wo[(k + 1) * J], s1);
      s2 = fmaf(a[(k + 2) * kActStride], wo[(k + 2) * J], s2);
      s3 = fmaf(a[(k + 3) * kActStride], wo[(k + 3) * J], s3);
    }
    for (; k < K; ++k) s0 = fmaf(a[k * kActStride], wo[k * J], s0);
    if (p < rows) out[(long long)p * J + o] = ((s0 + s1) + (s2 + s3) + b[o]) * out_scale[o];
  }
}

// One (task, tile) work item.
struct Item {
  long long task;
  int tile;
};

__global__ void __launch_bounds__(kThreads, 2)
siren_fused_kernel(const float* __restrict__ x, const float* __restrict__ params,
                   long long task_stride, float* __restrict__ out, int n_tasks, int n,
                   Net net, float omega) {
  extern __shared__ __align__(16) float smem[];
  // activation buffer i (0 or 1) at smem + i * act_buf, then the staged
  // points, then the weight slots
  const int act_buf = net.act_buf();
  float* xs = smem + net.act_floats();
  float* wsm = xs + net.x_floats();
  const int L = net.n_hidden, in_dim = net.in_dim;

  const int tiles_per_task = (n + kTile - 1) / kTile;
  const long long items = (long long)n_tasks * tiles_per_task;
  const long long begin = items * blockIdx.x / gridDim.x;
  const long long end = items * (blockIdx.x + 1) / gridDim.x;
  if (begin >= end) return;
  auto rows_of = [&](const Item& it) { return min(kTile, n - it.tile * kTile); };
  auto points_of = [&](const Item& it) {
    return x + (it.task * n + (long long)it.tile * kTile) * in_dim;
  };
  auto advance = [&](Item it) {  // the next item, without dividing
    if (++it.tile == tiles_per_task) {
      it.tile = 0;
      ++it.task;
    }
    return it;
  };

  Item it{begin / tiles_per_task, (int)(begin % tiles_per_task)};
  issue_points(points_of(it), rows_of(it), in_dim, xs);
  if (!net.resident) issue_layer(net, params + it.task * task_stride, 0, wsm);
  cp_async_commit();

  long long loaded = -1;  // task whose weights the resident slots hold
  int step = 0;           // streaming: layers computed so far; slot = step & 1
  for (long long item = begin; item < end; ++item, it = advance(it)) {
    const Item next = advance(it);
    const bool has_next = item + 1 < end;
    const float* tp = params + it.task * task_stride;
    const long long weights_of = task_stride ? it.task : 0;
    const bool reload = net.resident && weights_of != loaded;
    if (reload) {
      __syncthreads();  // the previous item is done with the slots
      for (int l = 0; l <= L; ++l) {
        issue_layer(net, tp, l, wsm + net.resident_off(l));
        cp_async_commit();
      }
      loaded = weights_of;
    }

    for (int l = 0; l <= L; ++l, ++step) {
      // groups committed after the one layer l needs: the later layers of a
      // reload, and from layer 2 on the next tile's points
      if (net.resident)
        cp_async_wait_upto((reload ? L - l : 0) + (l >= 2 ? 1 : 0));
      else
        cp_async_wait_upto(0);
      __syncthreads();  // layer l's weights, inputs and activations are in place
      float* slot = net.resident ? wsm + net.resident_off(l) : wsm + (step & 1) * net.slot_floats;
      if (!net.resident) {  // fetch the next layer while this one computes
        float* next_slot = wsm + ((step + 1) & 1) * net.slot_floats;
        if (l < L)
          issue_layer(net, tp, l + 1, next_slot);
        else if (has_next)
          issue_layer(net, params + next.task * task_stride, 0, next_slot);
      }
      if (l == 1 && has_next)  // the first layer is done with the staged points
        issue_points(points_of(next), rows_of(next), in_dim, xs);
      if (!net.resident || l == 1) cp_async_commit();

      const float* act_in = smem + (l & 1) * act_buf;
      float* act_out = smem + ((l + 1) & 1) * act_buf;
      const int ws = net.w_stride(l), Jp = net.cols_pad(l);
      const float* bias = slot + net.bias_at(l);
      if (l == 0)
        first_layer(xs, slot + net.extra_at(0), act_out, slot, bias, in_dim, Jp, ws, omega);
      else if (l < L)
        hidden_layer(act_in, act_out, slot, bias, net.k_rows(l), Jp, ws, omega);
      else
        output_layer(act_in, slot, bias, slot + net.extra_at(L),
                     out + (it.task * n + (long long)it.tile * kTile) * net.out_dim, net.hidden,
                     net.out_dim, rows_of(it));
    }
  }
  cp_async_wait_upto(0);
}

// The device's limits, the shared-memory attribute set so far and the
// occupancy at the last shared-memory size, kept across calls: each query
// costs microseconds of host time.
struct Launch {
  int dev = -1, n_sm = 0, smem_optin = 0, per_sm = 0;
  size_t attr_bytes = 0, occupancy_bytes = 0;
};

// Fill `net` for the shape and size its shared memory on the current
// device: every layer resident when that fits the opt-in limit, else two
// streaming slots. Raises the kernel's dynamic shared-memory attribute
// when needed and queries the blocks an SM holds at that size.
int plan(int in_dim, int hidden, int n_hidden, int out_dim, Net* net, size_t* smem,
         Launch** out) {
  if (in_dim < 1 || in_dim > kMaxWidth || hidden < 1 || hidden > kMaxWidth || n_hidden < 1 ||
      out_dim < 1 || out_dim > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  net->in_dim = in_dim;
  net->hidden = hidden;
  net->hidden_pad = round_up(hidden, kColBlock);
  net->n_hidden = n_hidden;
  net->out_dim = out_dim;

  static Launch l;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != l.dev) {
    err = cudaDeviceGetAttribute(&l.n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&l.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    l.dev = dev;
    l.attr_bytes = l.occupancy_bytes = 0;
  }

  const size_t fixed = (size_t)net->act_floats() + net->x_floats();
  const size_t resident_bytes =
      sizeof(float) * (fixed + net->resident_off(n_hidden) + net->slot_size(n_hidden));
  // layers 1..n_hidden-1 share one size, so the largest slot is one of these
  int slot = net->slot_size(0);
  if (net->slot_size(1) > slot) slot = net->slot_size(1);
  if (net->slot_size(n_hidden) > slot) slot = net->slot_size(n_hidden);
  net->resident = resident_bytes <= (size_t)l.smem_optin;
  net->slot_floats = slot;
  *smem = net->resident ? resident_bytes : sizeof(float) * (fixed + 2 * (size_t)slot);
  if (*smem > (size_t)l.smem_optin) return (int)cudaErrorInvalidValue;

  if (*smem > l.attr_bytes) {
    err = cudaFuncSetAttribute(siren_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)*smem);
    if (err != cudaSuccess) return (int)err;
    l.attr_bytes = *smem;
  }
  if (*smem != l.occupancy_bytes) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.per_sm, siren_fused_kernel, kThreads,
                                                        *smem);
    if (err != cudaSuccess) return (int)err;
    l.occupancy_bytes = *smem;
  }
  *out = &l;
  return (int)cudaSuccess;
}

}  // namespace

// x [n_tasks, n, in_dim]; params [n_tasks or 1, task_floats]: per task W_0
// [in_dim, hidden], b_0 [hidden], W_l [hidden, hidden] and b_l for the other
// hidden layers, W_out [hidden, out_dim], b_out [out_dim], in_scale [in_dim],
// out_scale [out_dim], row-major; task_stride is task_floats, or 0 when every
// task shares one set. out [n_tasks, n, out_dim]. All f32, contiguous, on the
// current device. Launches on `stream`, does not synchronise, allocates
// nothing. Returns a cudaError_t value (0 = launched).
extern "C" int siren_fused_forward(const float* x, const float* params,
                                   long long task_stride, float* out, int n_tasks, int n,
                                   int in_dim, int hidden, int n_hidden, int out_dim,
                                   float omega, void* stream) {
  if (n_tasks < 0 || n < 0) return (int)cudaErrorInvalidValue;
  Net net;
  size_t smem = 0;
  Launch* l = nullptr;
  const int rc = plan(in_dim, hidden, n_hidden, out_dim, &net, &smem, &l);
  if (rc != (int)cudaSuccess) return rc;
  if (task_stride != 0 && task_stride != net.task_floats()) return (int)cudaErrorInvalidValue;
  if (n_tasks == 0 || n == 0) return (int)cudaSuccess;
  const long long items = (long long)n_tasks * ((n + kTile - 1) / kTile);
  const long long cap = (long long)(l->per_sm > 0 ? l->per_sm : 1) * l->n_sm;
  const unsigned grid = (unsigned)(items < cap ? items : cap);
  siren_fused_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, params, task_stride, out, n_tasks, n, net, omega);
  return (int)cudaGetLastError();
}

// What siren_fused_forward launches for this shape on the current device,
// without launching: resident (1: every layer's weights stay in shared
// memory; 0: streamed through two slots), the dynamic shared memory of a
// block, the blocks an SM holds at that size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the SM count.
// Returns a cudaError_t value.
extern "C" int siren_fused_plan(int in_dim, int hidden, int n_hidden, int out_dim,
                                int* resident, long long* smem_bytes, int* blocks_per_sm,
                                int* n_sm) {
  Net net;
  size_t smem = 0;
  Launch* l = nullptr;
  const int rc = plan(in_dim, hidden, n_hidden, out_dim, &net, &smem, &l);
  if (rc != (int)cudaSuccess) return rc;
  *resident = net.resident;
  *smem_bytes = (long long)smem;
  *blocks_per_sm = l->per_sm;
  *n_sm = l->n_sm;
  return (int)cudaSuccess;
}
