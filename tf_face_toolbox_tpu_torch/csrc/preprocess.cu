// Fused eval input stage: u8 -> bilinear resize -> optional flip ->
// tf.image per-image standardization -> f32 or bf16.
//
// Replaces the TPU kernel tf_face_toolbox_tpu/ops/pallas_preprocess.py
// (_kernel, launched by fused_preprocess). That kernel resizes with two
// dense matrix products on the MXU and bakes the flip into a second
// width matrix. Here each output value is two 2-tap interpolations
// (height, then width), read straight from the u8 source.
//
// What bounds it on an H100: device memory. Per image it reads 43 KB
// of u8 and writes 75 KB (bf16) at 112x112x3; the arithmetic is a few
// FMAs per output value. Design: one CTA per image, three passes over
// the output (sum -> mean, squared deviations -> variance, write), each
// recomputing the interpolated value from the source. The source stays
// in L1/L2 after the first pass, so device memory sees one read and one
// write per image, nothing is staged in shared memory, and no image
// size is too large (the TPU kernel falls back to XLA above 12 MB).
//
// Numerics follow the TPU kernel: the tap weights are the nonzeros of
// the same _bilinear_matrix rows (built by the Python wrapper, so they
// are bit-identical), height is interpolated before width, mean and
// variance use the two-pass population form, and the std is floored
// at 1/sqrt(out_h*out_w*C) (passed in, computed in double on the host).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read by the previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads >> 5) ? scratch[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

struct PreParams {
  const uint8_t* images;
  const int* flips;
  const int* h_idx;    // (out_h, 2) source rows
  const float* h_wt;   // (out_h, 2) weights
  const int* w_idx;    // (out_w, 2) source columns
  const float* w_wt;   // (out_w, 2)
  void* out;
  int in_h, in_w, ch, out_h, out_w, out_bf16;
  float inv_sqrt_n;
};

__device__ __forceinline__ float resized(const PreParams& p, const uint8_t* src,
                                         bool flip, int e) {
  const int c = e % p.ch;
  const int t = e / p.ch;
  const int wo = t % p.out_w;
  const int ho = t / p.out_w;
  const int ws = flip ? p.out_w - 1 - wo : wo;
  const int r0 = p.h_idx[2 * ho], r1 = p.h_idx[2 * ho + 1];
  const float a0 = p.h_wt[2 * ho], a1 = p.h_wt[2 * ho + 1];
  const int c0 = p.w_idx[2 * ws], c1 = p.w_idx[2 * ws + 1];
  const float b0 = p.w_wt[2 * ws], b1 = p.w_wt[2 * ws + 1];
  const int row = p.in_w * p.ch;
  const float y0 = a0 * float(src[r0 * row + c0 * p.ch + c]) +
                   a1 * float(src[r1 * row + c0 * p.ch + c]);
  const float y1 = a0 * float(src[r0 * row + c1 * p.ch + c]) +
                   a1 * float(src[r1 * row + c1 * p.ch + c]);
  return b0 * y0 + b1 * y1;
}

__global__ void __launch_bounds__(kThreads) preprocess_kernel(const PreParams p) {
  __shared__ float scratch[kThreads / 32];
  const int img = blockIdx.x;
  const uint8_t* src = p.images + (size_t)img * p.in_h * p.in_w * p.ch;
  const bool flip = p.flips[img] != 0;
  const int total = p.out_h * p.out_w * p.ch;

  float s = 0.f;
  for (int e = threadIdx.x; e < total; e += kThreads) s += resized(p, src, flip, e);
  const float mean = block_sum(s, scratch) / float(total);

  float q = 0.f;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const float d = resized(p, src, flip, e) - mean;
    q += d * d;
  }
  const float var = block_sum(q, scratch) / float(total);
  const float adjusted = fmaxf(sqrtf(var), p.inv_sqrt_n);

  const size_t base = (size_t)img * total;
  if (p.out_bf16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + base;
    for (int e = threadIdx.x; e < total; e += kThreads)
      out[e] = __float2bfloat16_rn((resized(p, src, flip, e) - mean) / adjusted);
  } else {
    float* out = static_cast<float*>(p.out) + base;
    for (int e = threadIdx.x; e < total; e += kThreads)
      out[e] = (resized(p, src, flip, e) - mean) / adjusted;
  }
}

}  // namespace

extern "C" int tfft_preprocess(const void* images, const void* flips, const void* h_idx,
                               const void* h_wt, const void* w_idx, const void* w_wt,
                               void* out, int n, int in_h, int in_w, int ch, int out_h,
                               int out_w, int out_bf16, float inv_sqrt_n, int device,
                               void* stream) {
  if (n <= 0 || in_h <= 0 || in_w <= 0 || ch <= 0 || out_h <= 0 || out_w <= 0) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  PreParams p;
  p.images = static_cast<const uint8_t*>(images);
  p.flips = static_cast<const int*>(flips);
  p.h_idx = static_cast<const int*>(h_idx);
  p.h_wt = static_cast<const float*>(h_wt);
  p.w_idx = static_cast<const int*>(w_idx);
  p.w_wt = static_cast<const float*>(w_wt);
  p.out = out;
  p.in_h = in_h;
  p.in_w = in_w;
  p.ch = ch;
  p.out_h = out_h;
  p.out_w = out_w;
  p.out_bf16 = out_bf16;
  p.inv_sqrt_n = inv_sqrt_n;
  preprocess_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Message for a status returned by any entry point of this library.
extern "C" const char* tfft_error_string(int status) {
  if (status == -2) return "tile does not fit in shared memory";
  if (status < 0) return "invalid arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
