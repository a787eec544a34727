// Checkerboard corner response + local-max (NMS) mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel detect/pallas_kernels.py::corner_response_nms of
// the JAX package (the pl.pallas_call at :184; its tap table _tap_tables
// :42-61). For a frame img (H x W, fp32) it writes
//   resp[y, x] = max over the 2 corner prototypes of
//                max(min(min(a,b) - mu, mu - max(c,d)),
//                    min(mu - max(a,b), min(c,d) - mu)),  clamped at >= 0,
//   with a, b, c, d the zero-padded ("SAME") correlations of img with the
//   prototype's 4 quadrant kernels (13x13 at radius 6, 36 nonzero taps
//   each) and mu = (a + b + c + d) / 4;
//   keep[y, x] = 1 where resp equals the max of resp over the
//   (2n+1) x (2n+1) window around (y, x) (n = 4), everything outside the
//   image counting as the lowest float; else 0.
//
// Design (what differs from the TPU kernel): the TPU kernel walks row bands
// in order, DMAs each band with its halo into VMEM and shifts it with
// pltpu.roll. Here each thread block owns one 32x32 output tile and works
// in shared memory only:
//   1. stage the input tile plus a halo of r + n (52x52 fp32, 10.8 KB),
//      zero outside the image (the SAME padding);
//   2. compute the response on the 40x40 region the NMS needs (the tile
//      plus n on every side), writing the lowest float at pixels outside
//      the image, on rows and on columns alike (reduce_window pads all four
//      sides with -inf);
//   3. the (2n+1)^2 max, separably: 9-wide along rows into a 40x32 buffer,
//      then 9-tall along columns; write resp and keep for the tile.
// The tap table (8 quadrants x kmax (dy, dx, w), zero-weight padded) is a
// small device array staged once per block in shared memory; every thread
// reads the same tap at the same time, so each read is a broadcast. The
// sums are plain fp32 FMAs in tap-table order: cuDNN and XLA sum in other
// orders, which moves resp by a few ulp and keep only at exact plateaus.
//
// Bound on an H100 SXM at 960x540 (3.35 TB/s HBM, 67 TFLOP/s fp32):
// bytes 4 read + 8 written per pixel = 6.2 MB -> ~1.9 us; operations
// 8 * 36 * 2 + ~40 ~= 620 fp32 operations per pixel = 0.32 GFLOP -> ~4.8 us,
// so the kernel is bound by its operations. The 40x40-per-32x32 halo
// recompute of step 2 does 1.56x the response operations the frame needs.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;       // output tile edge
constexpr int THREADS = 256;   // 8 warps; loops stride over each buffer
constexpr int QUADS = 8;       // 2 prototypes x 4 quadrant kernels

__global__ void __launch_bounds__(THREADS)
corner_nms_kernel(const float* __restrict__ img, const int* __restrict__ dys,
                  const int* __restrict__ dxs, const float* __restrict__ ws,
                  float* __restrict__ resp, float* __restrict__ keep,
                  int H, int W, int kmax, int radius, int nms) {
  extern __shared__ float smem[];
  const int halo = radius + nms;
  const int TI = TILE + 2 * halo;  // staged input edge
  const int TE = TILE + 2 * nms;   // response region edge
  float* in_s = smem;               // TI x TI
  float* rs = in_s + TI * TI;       // TE x TE
  float* rm = rs + TE * TE;         // TE x TILE (row-wise max)
  float* tw = rm + TE * TILE;       // QUADS * kmax tap weights
  int* toff = reinterpret_cast<int*>(tw + QUADS * kmax);  // tap offsets in in_s

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;

  for (int i = tid; i < QUADS * kmax; i += THREADS) {
    toff[i] = dys[i] * TI + dxs[i];
    tw[i] = ws[i];
  }
  for (int i = tid; i < TI * TI; i += THREADS) {
    const int gy = y0 - halo + i / TI, gx = x0 - halo + i % TI;
    in_s[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  // Response at region pixel (a, b) = image pixel (y0 - n + a, x0 - n + b);
  // its tap (dy, dx) reads in_s[a + dy][b + dx].
  for (int i = tid; i < TE * TE; i += THREADS) {
    const int a = i / TE, b = i % TE;
    const int gy = y0 - nms + a, gx = x0 - nms + b;
    float out = -FLT_MAX;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* base = in_s + a * TI + b;
      float best = 0.f;
      for (int p = 0; p < 2; ++p) {
        float q[4];
        for (int k = 0; k < 4; ++k) {
          const int* off = toff + (4 * p + k) * kmax;
          const float* w = tw + (4 * p + k) * kmax;
          float s = 0.f;
          for (int t = 0; t < kmax; ++t) s = fmaf(w[t], base[off[t]], s);
          q[k] = s;
        }
        const float mu = 0.25f * (q[0] + q[1] + q[2] + q[3]);
        const float r1 = fminf(fminf(q[0], q[1]) - mu, mu - fmaxf(q[2], q[3]));
        const float r2 = fminf(mu - fmaxf(q[0], q[1]), fminf(q[2], q[3]) - mu);
        const float rr = fmaxf(r1, r2);
        best = (p == 0) ? rr : fmaxf(best, rr);
      }
      out = fmaxf(best, 0.f);
    }
    rs[i] = out;
  }
  __syncthreads();

  const int win = 2 * nms + 1;
  for (int i = tid; i < TE * TILE; i += THREADS) {
    const int a = i / TILE, j = i % TILE;
    const float* row = rs + a * TE + j;
    float m = row[0];
    for (int d = 1; d < win; ++d) m = fmaxf(m, row[d]);
    rm[i] = m;
  }
  __syncthreads();

  for (int i = tid; i < TILE * TILE; i += THREADS) {
    const int ii = i / TILE, j = i % TILE;
    const int gy = y0 + ii, gx = x0 + j;
    if (gy < H && gx < W) {
      float m = rm[ii * TILE + j];
      for (int d = 1; d < win; ++d) m = fmaxf(m, rm[(ii + d) * TILE + j]);
      const float v = rs[(ii + nms) * TE + (j + nms)];
      resp[(size_t)gy * W + gx] = v;
      keep[(size_t)gy * W + gx] = (v >= m) ? 1.f : 0.f;
    }
  }
}

size_t smem_bytes(int kmax, int radius, int nms) {
  const size_t TI = TILE + 2 * (radius + nms), TE = TILE + 2 * nms;
  return (TI * TI + TE * TE + TE * TILE + QUADS * (size_t)kmax) * sizeof(float)
         + QUADS * (size_t)kmax * sizeof(int);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for these tap and window sizes.
long long oicc_corner_nms_smem_bytes(int kmax, int radius, int nms) {
  return (long long)smem_bytes(kmax, radius, nms);
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int oicc_corner_nms_f32(const float* img, const int* dys, const int* dxs, const float* ws,
                        float* resp, float* keep, int H, int W, int kmax, int radius,
                        int nms, void* stream) {
  if (H <= 0 || W <= 0 || kmax <= 0 || radius < 0 || nms < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kmax, radius, nms);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        corner_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE);
  const dim3 block(32, THREADS / 32);
  corner_nms_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      img, dys, dxs, ws, resp, keep, H, W, kmax, radius, nms);
  return (int)cudaGetLastError();
}

const char* oicc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
