// One BN-folded stride-1 bottleneck block in one launch, bf16 in and
// out, f32 accumulation:
//
//   y1  = bf16(relu(x . W1 + b1))                 1x1 reduce, on the halo
//   y2  = bf16(relu(sum_taps y1_shift . W2_tap + b2))   3x3 SAME
//   y3  = y2 . W3 + b3                            1x1 expand
//   out = bf16(relu(bf16(y3) + x))                identity block
//   out = bf16(relu(bf16(y3) + bf16(x . Wp + bp)))   entry (projection)
//
// Replaces the TPU kernel tf_face_toolbox_tpu/serving/fused_block.py
// (_kernel, launched by fused_bottleneck_stack), which runs a whole
// stage's run of blocks with G whole images resident in VMEM. On the
// H100 a 28x28x256 bf16 map is 400 KB per image, past the 227 KB of
// shared memory a CTA may hold, so the Python wrapper launches this
// kernel once per block and each CTA owns an output tile of th x tw
// pixels of G images. The rounding points are the TPU kernel's code
// (fused_block.py:133-147), not its docstring: the residual add happens
// in the compute dtype.
//
// What bounds it on an H100: at the main path's shapes the three GEMMs
// are compute-bound once y1 and y2 stay on chip (a stage-0 block at 28x28
// does ~0.6 GFLOP for 0.8 MB of device traffic per image); the weights
// (up to 4.5 MB bf16 per block) are re-read from L2 by every CTA.
// Design, simple first: y1 on the (th+2)x(tw+2) halo tile and y2 on
// the th x tw tile live in shared memory; y3 goes through registers to
// device memory in the epilogue. Every product is an mma.sync
// m16n8k16 bf16 tile with f32 accumulators. A fragments come from
// shared memory (y1, y2) or device memory (x); B fragments come
// straight from device memory, with the weights stored output-major
// (Cout, K) so each lane reads two consecutive K values in one word.
// Halo pixels outside the image are 0 in y1 (SAME zero-pads y1, it
// does not pad x). wgmma, TMA pipelines and fusing several blocks per
// launch are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int MT = 2;    // 16-row m tiles per warp item
constexpr int NT = 4;    // 8-column n tiles per warp item
constexpr int kPad = 8;  // shared-memory row padding (bf16), avoids bank conflicts
constexpr int kSmemBudget = 160 * 1024;  // when packing several images per CTA
constexpr int kSmemMax = 227 * 1024;

typedef __nv_bfloat16 bf16;

struct BlockParams {
  const bf16* x;
  bf16* out;
  const bf16* w1;  // (B, Cin)
  const bf16* w2;  // (B, 9, B): [n][tap][k]
  const bf16* w3;  // (C, B)
  const bf16* wp;  // (C, Cin) or null (identity block)
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bp;
  int n, h, w, cin, b, c;
  int th, tw, g;  // tile rows, tile columns, images per CTA
  int tiles_y, tiles_x;
};

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  __nv_bfloat162 t;
  t.x = __float2bfloat16_rn(v0);
  t.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = t;
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// acc += A[rows, 0:K] . B[cols, 0:K]^T for one warp's 32x32 item.
// arow[i][hf]: this lane's A row (m tile i, half hf = rows grp / grp+8),
// pointing at k = 0. bcol[j]: this lane's B row (n = n0 + 8j + grp).
// kGlobalA: A lives in device memory (read through the read-only path).
template <bool kGlobalA>
__device__ __forceinline__ void gemm(float (&acc)[MT][NT][4], const bf16* const (&arow)[MT][2],
                                     const bf16* const (&bcol)[NT], int K, int t2) {
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    uint32_t a[MT][4], bf[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (kGlobalA) {
        a[i][0] = ldg32(arow[i][0] + k + t2);
        a[i][1] = ldg32(arow[i][1] + k + t2);
        a[i][2] = ldg32(arow[i][0] + k + 8 + t2);
        a[i][3] = ldg32(arow[i][1] + k + 8 + t2);
      } else {
        a[i][0] = lds32(arow[i][0] + k + t2);
        a[i][1] = lds32(arow[i][1] + k + t2);
        a[i][2] = lds32(arow[i][0] + k + 8 + t2);
        a[i][3] = lds32(arow[i][1] + k + 8 + t2);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bf[j][0] = ldg32(bcol[j] + k + t2);
      bf[j][1] = ldg32(bcol[j] + k + 8 + t2);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma16816(acc[i][j], a[i], bf[j]);
  }
}

// Pixel of row r of the output tile (r < g*th*tw): image, y, x.
struct Pix {
  int img, y, x;
  bool valid;
};

__device__ __forceinline__ Pix tile_pixel(const BlockParams& p, int r, int n0, int ty0, int tx0) {
  const int per = p.th * p.tw;
  const int g = r / per, rem = r % per;
  Pix q;
  q.img = n0 + g;
  q.y = ty0 + rem / p.tw;
  q.x = tx0 + rem % p.tw;
  q.valid = q.img < p.n && q.y < p.h && q.x < p.w;
  return q;
}

__device__ __forceinline__ const bf16* x_row(const BlockParams& p, int img, int y, int x) {
  img = min(img, p.n - 1);
  y = min(max(y, 0), p.h - 1);
  x = min(max(x, 0), p.w - 1);
  return p.x + ((size_t)(img * p.h + y) * p.w + x) * p.cin;
}

__global__ void __launch_bounds__(kThreads) bottleneck_kernel(const BlockParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = p.b + kPad;
  const int hh = p.th + 2, hw = p.tw + 2;
  const int m1 = p.g * hh * hw;     // halo rows (y1)
  const int m2 = p.g * p.th * p.tw;  // tile rows (y2, output)
  bf16* y1s = reinterpret_cast<bf16*>(smem_raw);
  bf16* y2s = y1s + (size_t)m1 * ld;

  int blk = blockIdx.x;
  const int tx0 = (blk % p.tiles_x) * p.tw;
  blk /= p.tiles_x;
  const int ty0 = (blk % p.tiles_y) * p.th;
  const int n0 = (blk / p.tiles_y) * p.g;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t2 = (lane & 3) * 2;

  // ---- y1 = bf16(relu(x . W1 + b1)) on the halo tile, 0 outside the image
  {
    const int nb_count = (p.b + 31) / 32;
    const int items = ((m1 + 31) / 32) * nb_count;
    for (int item = warp; item < items; item += kWarps) {
      const int m0 = (item / nb_count) * 32, n0c = (item % nb_count) * 32;
      const bf16* arow[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = min(m0 + i * 16 + hf * 8 + grp, m1 - 1);
          const int g = r / (hh * hw), rem = r % (hh * hw);
          arow[i][hf] = x_row(p, n0 + g, ty0 - 1 + rem / hw, tx0 - 1 + rem % hw);
        }
      const bf16* bcol[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        bcol[j] = p.w1 + (size_t)min(n0c + j * 8 + grp, p.b - 1) * p.cin;
      float acc[MT][NT][4];
      zero(acc);
      gemm<true>(acc, arow, bcol, p.cin, t2);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0 + i * 16 + hf * 8 + grp;
          if (r >= m1) continue;
          const int g = r / (hh * hw), rem = r % (hh * hw);
          const int y = ty0 - 1 + rem / hw, x = tx0 - 1 + rem % hw;
          const bool inside = n0 + g < p.n && y >= 0 && y < p.h && x >= 0 && x < p.w;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = n0c + j * 8 + t2;
            if (col >= p.b) continue;
            const float v0 = inside ? fmaxf(acc[i][j][2 * hf] + p.b1[col], 0.f) : 0.f;
            const float v1 = inside ? fmaxf(acc[i][j][2 * hf + 1] + p.b1[col + 1], 0.f) : 0.f;
            store2(y1s + (size_t)r * ld + col, v0, v1);
          }
        }
    }
  }
  __syncthreads();

  // ---- y2 = bf16(relu(conv3x3(y1) + b2)) on the tile: nine tap GEMMs
  {
    const int nb_count = (p.b + 31) / 32;
    const int items = ((m2 + 31) / 32) * nb_count;
    for (int item = warp; item < items; item += kWarps) {
      const int m0 = (item / nb_count) * 32, n0c = (item % nb_count) * 32;
      int hrow[MT][2];  // halo row of tap (0, 0) for this lane's rows
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = min(m0 + i * 16 + hf * 8 + grp, m2 - 1);
          const int per = p.th * p.tw;
          const int g = r / per, rem = r % per;
          hrow[i][hf] = g * hh * hw + (rem / p.tw) * hw + rem % p.tw;
        }
      int ncol[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) ncol[j] = min(n0c + j * 8 + grp, p.b - 1);
      float acc[MT][NT][4];
      zero(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = (tap / 3) * hw + tap % 3;
        const bf16* arow[MT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) arow[i][hf] = y1s + (size_t)(hrow[i][hf] + shift) * ld;
        const bf16* bcol[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) bcol[j] = p.w2 + ((size_t)ncol[j] * 9 + tap) * p.b;
        gemm<false>(acc, arow, bcol, p.b, t2);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0 + i * 16 + hf * 8 + grp;
          if (r >= m2) continue;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = n0c + j * 8 + t2;
            if (col >= p.b) continue;
            store2(y2s + (size_t)r * ld + col, fmaxf(acc[i][j][2 * hf] + p.b2[col], 0.f),
                   fmaxf(acc[i][j][2 * hf + 1] + p.b2[col + 1], 0.f));
          }
        }
    }
  }
  __syncthreads();

  // ---- out = bf16(relu(bf16(y2 . W3 + b3) + shortcut)), straight to device memory
  {
    const int nb_count = (p.c + 31) / 32;
    const int items = ((m2 + 31) / 32) * nb_count;
    for (int item = warp; item < items; item += kWarps) {
      const int m0 = (item / nb_count) * 32, n0c = (item % nb_count) * 32;
      const bf16* arow[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          arow[i][hf] = y2s + (size_t)min(m0 + i * 16 + hf * 8 + grp, m2 - 1) * ld;
      const bf16* bcol[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        bcol[j] = p.w3 + (size_t)min(n0c + j * 8 + grp, p.c - 1) * p.b;
      float acc[MT][NT][4];
      zero(acc);
      gemm<false>(acc, arow, bcol, p.b, t2);

      float accp[MT][NT][4];
      zero(accp);
      if (p.wp != nullptr) {
        const bf16* xrow[MT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const Pix q = tile_pixel(p, min(m0 + i * 16 + hf * 8 + grp, m2 - 1), n0, ty0, tx0);
            xrow[i][hf] = x_row(p, q.img, q.y, q.x);
          }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          bcol[j] = p.wp + (size_t)min(n0c + j * 8 + grp, p.c - 1) * p.cin;
        gemm<true>(accp, xrow, bcol, p.cin, t2);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0 + i * 16 + hf * 8 + grp;
          if (r >= m2) continue;
          const Pix q = tile_pixel(p, r, n0, ty0, tx0);
          if (!q.valid) continue;
          const size_t pix = (size_t)(q.img * p.h + q.y) * p.w + q.x;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = n0c + j * 8 + t2;
            if (col >= p.c) continue;
            const float t0 = round_bf16(acc[i][j][2 * hf] + p.b3[col]);
            const float t1 = round_bf16(acc[i][j][2 * hf + 1] + p.b3[col + 1]);
            float s0, s1;
            if (p.wp != nullptr) {
              s0 = round_bf16(accp[i][j][2 * hf] + p.bp[col]);
              s1 = round_bf16(accp[i][j][2 * hf + 1] + p.bp[col + 1]);
            } else {
              const __nv_bfloat162 xv =
                  *reinterpret_cast<const __nv_bfloat162*>(p.x + pix * p.cin + col);
              s0 = __bfloat162float(xv.x);
              s1 = __bfloat162float(xv.y);
            }
            store2(p.out + pix * p.c + col, fmaxf(t0 + s0, 0.f), fmaxf(t1 + s1, 0.f));
          }
        }
    }
  }
}

size_t smem_bytes(int th, int tw, int g, int b) {
  return (size_t)g * ((th + 2) * (tw + 2) + th * tw) * (b + kPad) * sizeof(bf16);
}

}  // namespace

extern "C" int tfft_bottleneck_block(const void* x, void* out, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* w3,
                                     const void* b3, const void* wp, const void* bp, int n,
                                     int h, int w, int cin, int b, int c, int device,
                                     void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin % 16 || b % 16 || c % 16 || cin <= 0 || b <= 0 ||
      c <= 0)
    return -1;
  if (wp == nullptr && cin != c) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  BlockParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2);
  p.w3 = static_cast<const bf16*>(w3);
  p.wp = static_cast<const bf16*>(wp);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.bp = static_cast<const float*>(bp);
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.b = b;
  p.c = c;
  // Maps up to 16 wide are one tile; larger ones are cut into 14-wide
  // tiles (28 and 56 divide evenly), ragged edges masked. Wide
  // bottlenecks halve the tile until y1 and y2 fit in shared memory.
  p.th = h <= 16 ? h : 14;
  p.tw = w <= 16 ? w : 14;
  while (smem_bytes(p.th, p.tw, 1, b) > (size_t)kSmemMax && (p.th > 1 || p.tw > 1)) {
    if (p.th >= p.tw)
      p.th = (p.th + 1) / 2;
    else
      p.tw = (p.tw + 1) / 2;
  }
  p.g = 1;
  if (p.th == h && p.tw == w) {
    while (p.g * 2 <= 8 && p.g * 2 <= n && smem_bytes(p.th, p.tw, p.g * 2, b) <= kSmemBudget)
      p.g *= 2;
  }
  const size_t smem = smem_bytes(p.th, p.tw, p.g, b);
  if (smem > (size_t)kSmemMax) return -2;
  p.tiles_y = (h + p.th - 1) / p.th;
  p.tiles_x = (w + p.tw - 1) / p.tw;
  const long long grid = (long long)((n + p.g - 1) / p.g) * p.tiles_y * p.tiles_x;
  if (grid > 0x7fffffffLL) return -1;

  err = cudaFuncSetAttribute(bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  bottleneck_kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
