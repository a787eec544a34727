// Checkerboard corner response + local-max (NMS) mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel detect/pallas_kernels.py::corner_response_nms of
// the JAX package (the pl.pallas_call at :184; its tap table _tap_tables
// :42-61). For a frame img (H x W, fp32) it writes
//   resp[y, x] = max over the 2 corner prototypes of
//                max(min(min(a,b) - mu, mu - max(c,d)),
//                    min(mu - max(a,b), min(c,d) - mu)),  clamped at >= 0,
//   with a, b, c, d the zero-padded ("SAME") correlations of img with the
//   prototype's 4 quadrant kernels ((2r+1)^2 at radius r, r^2 nonzero taps
//   each: 36 at r = 6) and mu = (a + b + c + d) / 4;
//   keep[y, x] = 1 where resp equals the max of resp over the
//   (2n+1) x (2n+1) window around (y, x), everything outside the image
//   counting as the lowest float; else 0.
//
// Which taps of the 13x13 window a quadrant kernel uses does not depend on
// the weights: image._prototype_bank masks a Gaussian by two half-planes
// through the centre, at angle 0 (quadrants of dy, dx) and at pi/4
// (quadrants of dy - dx, dx + dy). in_quad() below is that rule; the
// wrapper checks that it reproduces the bank's nonzero pattern and packs
// the 8 r^2 weights in the kernel's loop order (dx, then quadrant, then dy).
//
// Design. Each block owns one 64x32 output tile:
//   1. stage the input tile plus a halo of r + n, zero outside the image
//      (the SAME padding), in shared memory;
//   2. compute the response on the (64 + 2n) x (32 + 2n) region the NMS
//      needs, writing the lowest float at pixels outside the image (as
//      reduce_window pads all four sides with -inf);
//   3. the (2n+1)^2 max, separably, and write resp and keep for the tile.
// Step 2 is where the operations are. At (r, n) = (6, 4), which every
// caller uses, the kernel is compiled for those sizes: every tap offset is
// an immediate, and the 288 weights travel by value in the kernel's
// argument block, so each FFMA reads its weight from the constant bank.
// Each thread computes a vertical strip of STRIP response pixels and, per
// tap column dx, loads the STRIP + 2r input values it slides over into
// registers once: one shared-memory load feeds ~6.5 FMAs, where reading tap
// offset, weight and pixel per tap costs three loads per FMA. Any other
// (r, n) runs the generic instantiation of the same kernel: runtime loops,
// one pixel per thread, weights read from a device copy of the same packed
// table.
// The sums are plain fp32 FMAs in the packed order: cuDNN and XLA sum in
// other orders, which moves resp by a few ulp and keep only at exact
// plateaus.
//
// Block mode (response only). The video path wants the response of a block
// of F frames and no mask (the JAX package's video.py:119 vmaps the
// response over the block): oicc_corner_response_block_f32 runs the same
// kernel with a frame axis (grid z = frame) and KEEP = false, which drops
// the NMS halo (n = 0, so no 1.41x recomputation), the shared-memory
// response region and the max passes: each thread writes its strip of
// response pixels straight to device memory. At r = 6 it is compiled for
// that radius (strips of 4 rows, since 32 rows do not split into 5s); any
// other radius runs the generic instantiation.
//
// Bound on an H100 SXM at 960x540 (3.35 TB/s HBM, 67 TFLOP/s fp32):
// bytes 4 read + 8 written per pixel = 6.2 MB -> ~1.9 us; operations
// 8 * 36 * 2 + ~46 = 622 fp32 operations per pixel = 0.32 GFLOP ->
// ~4.8 us, so the kernel is bound by its operations. Step 2 recomputes the
// NMS halo: (72 * 40) / (64 * 32) = 1.41x the response work the frame needs.

#include <cfloat>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 64;         // output tile width
constexpr int TH = 32;         // output tile height
constexpr int THREADS = 288;   // 9 warps
constexpr int QUADS = 8;       // 2 prototypes x 4 quadrant kernels
constexpr int SPEC_R = 6;      // the (radius, nms radius) every caller passes
constexpr int SPEC_N = 4;

// Response pixels per strip of the specialised kernel: 5 when the response
// region's TH + 2n rows split into 5s (n = 4: 40 rows), else 4.
__host__ __device__ constexpr int strip_rows(int nc) {
  return (TH + 2 * nc) % 5 == 0 ? 5 : 4;
}

// Tap (dy, dx) belongs to quadrant kernel q = 4 * prototype + {a, b, c, d}.
// Prototype 0 (angle 0): d1 = dy, d2 = -dx; prototype 1 (angle pi/4):
// d1 ~ dy - dx, d2 ~ -(dx + dy); a: d1 < 0, d2 < 0; b: d1 > 0, d2 > 0;
// c: d1 < 0, d2 > 0; d: d1 > 0, d2 < 0 (image._corner_prototype's +-0.1
// thresholds never fall between integer taps).
__host__ __device__ constexpr bool in_quad(int q, int dy, int dx) {
  const int d1 = q < 4 ? dy : dy - dx;
  const int d2 = q < 4 ? -dx : -(dx + dy);
  const int k = q & 3;
  return k == 0 ? (d1 < 0 && d2 < 0)
       : k == 1 ? (d1 > 0 && d2 > 0)
       : k == 2 ? (d1 < 0 && d2 > 0)
                : (d1 > 0 && d2 < 0);
}

// The packed weights passed by value (8 r^2 floats; 1,152 bytes at r = 6).
template <int R>
struct Taps {
  float w[R > 0 ? QUADS * R * R : 1];
};

__device__ __forceinline__ float quad_response(const float* q) {
  const float mu = 0.25f * (q[0] + q[1] + q[2] + q[3]);
  const float r1 = fminf(fminf(q[0], q[1]) - mu, mu - fmaxf(q[2], q[3]));
  const float r2 = fminf(mu - fmaxf(q[0], q[1]), fminf(q[2], q[3]) - mu);
  return fmaxf(r1, r2);
}

__device__ __forceinline__ float pixel_response(const float* acc) {
  return fmaxf(fmaxf(quad_response(acc), quad_response(acc + 4)), 0.f);
}

// RC = NC = 0: the generic instantiation (radius and nms from the
// arguments); otherwise compiled for (RC, NC). KEEP = false is the block
// mode: response only, no NMS halo (n = 0), frame blockIdx.z of the block.
template <int RC, int NC, bool KEEP>
__global__ void __launch_bounds__(THREADS, 2)
corner_nms_kernel(const float* __restrict__ img, const Taps<RC> taps,
                  const float* __restrict__ wdev, float* __restrict__ resp,
                  float* __restrict__ keep, int H, int W, int radius, int nms) {
  extern __shared__ float smem[];
  const int R = RC > 0 ? RC : radius;
  const int N = RC > 0 ? NC : (KEEP ? nms : 0);
  const int IW = TW + 2 * (R + N), IH = TH + 2 * (R + N);  // staged input
  const int RW = TW + 2 * N, RH = TH + 2 * N;              // response region
  float* in_s = smem;             // IH x IW
  float* rs = in_s + IH * IW;     // RH x RW (KEEP only)
  float* rm = rs + RH * RW;       // RH x TW (row-wise max; KEEP only)

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)blockIdx.z * H * W;
  img += plane;
  resp += plane;

  for (int i = tid; i < IH * IW; i += THREADS) {
    const int gy = y0 - R - N + i / IW, gx = x0 - R - N + i % IW;
    in_s[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  // Response at region pixel (a, b) = image pixel (y0 - N + a, x0 - N + b);
  // its tap (dy, dx) reads in_s[a + R + dy][b + R + dx].
  if constexpr (RC > 0) {
    constexpr int STRIP = strip_rows(NC);
    static_assert((TH + 2 * NC) % STRIP == 0, "strips must tile the response region");
    constexpr int RWc = TW + 2 * NC, IWc = TW + 2 * (RC + NC);
    constexpr int ITEMS = RWc * ((TH + 2 * NC) / STRIP);
    for (int it = tid; it < ITEMS; it += THREADS) {
      const int b = it % RWc, a0 = (it / RWc) * STRIP;
      const float* col = in_s + a0 * IWc + b;
      float acc[STRIP][QUADS];
#pragma unroll
      for (int p = 0; p < STRIP; ++p)
#pragma unroll
        for (int q = 0; q < QUADS; ++q) acc[p][q] = 0.f;
      int t = 0;  // packed tap index: a constant once the loops are unrolled
#pragma unroll
      for (int dx = -RC; dx <= RC; ++dx) {
        float v[STRIP + 2 * RC];
#pragma unroll
        for (int j = 0; j < STRIP + 2 * RC; ++j) v[j] = col[j * IWc + RC + dx];
#pragma unroll
        for (int q = 0; q < QUADS; ++q) {
#pragma unroll
          for (int dy = -RC; dy <= RC; ++dy) {
            if (in_quad(q, dy, dx)) {
              const float w = taps.w[t++];
#pragma unroll
              for (int p = 0; p < STRIP; ++p)
                acc[p][q] = fmaf(w, v[p + dy + RC], acc[p][q]);
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < STRIP; ++p) {
        const int gy = y0 - NC + a0 + p, gx = x0 - NC + b;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        if constexpr (KEEP) {
          rs[(a0 + p) * RWc + b] = inside ? pixel_response(acc[p]) : -FLT_MAX;
        } else if (inside) {
          resp[(size_t)gy * W + gx] = pixel_response(acc[p]);
        }
      }
    }
  } else {
    for (int i = tid; i < RH * RW; i += THREADS) {
      const int a = i / RW, b = i % RW;
      const int gy = y0 - N + a, gx = x0 - N + b;
      float out = -FLT_MAX;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float acc[QUADS] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        int t = 0;
        for (int dx = -R; dx <= R; ++dx)
          for (int q = 0; q < QUADS; ++q)
            for (int dy = -R; dy <= R; ++dy)
              if (in_quad(q, dy, dx))
                acc[q] = fmaf(__ldg(wdev + t++), in_s[(a + R + dy) * IW + b + R + dx], acc[q]);
        out = pixel_response(acc);
        if (!KEEP) resp[(size_t)gy * W + gx] = out;
      }
      if (KEEP) rs[i] = out;
    }
  }
  if constexpr (!KEEP) return;
  __syncthreads();

  const int win = 2 * N + 1;
  for (int i = tid; i < RH * TW; i += THREADS) {
    const int a = i / TW, j = i % TW;
    const float* row = rs + a * RW + j;
    float m = row[0];
    for (int d = 1; d < win; ++d) m = fmaxf(m, row[d]);
    rm[i] = m;
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += THREADS) {
    const int ii = i / TW, j = i % TW;
    const int gy = y0 + ii, gx = x0 + j;
    if (gy < H && gx < W) {
      float m = rm[ii * TW + j];
      for (int d = 1; d < win; ++d) m = fmaxf(m, rm[(ii + d) * TW + j]);
      const float v = rs[(ii + N) * RW + (j + N)];
      resp[(size_t)gy * W + gx] = v;
      keep[plane + (size_t)gy * W + gx] = (v >= m) ? 1.f : 0.f;
    }
  }
}

// keep = false: the block mode, which stages only the input (n = 0).
size_t smem_bytes(int radius, int nms, bool keep) {
  if (!keep) nms = 0;
  const size_t IW = TW + 2 * (radius + nms), IH = TH + 2 * (radius + nms);
  const size_t RW = TW + 2 * nms, RH = TH + 2 * nms;
  return (IW * IH + (keep ? RW * RH + RH * TW : 0)) * sizeof(float);
}

template <int RC, int NC, bool KEEP>
int launch(const float* img, const Taps<RC>& taps, const float* wdev, float* resp,
           float* keep, int F, int H, int W, int radius, int nms, cudaStream_t stream) {
  const size_t smem = smem_bytes(radius, nms, KEEP);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        corner_nms_kernel<RC, NC, KEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, F);
  corner_nms_kernel<RC, NC, KEEP><<<grid, THREADS, smem, stream>>>(
      img, taps, wdev, resp, keep, H, W, radius, nms);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for these radii.
long long oicc_corner_nms_smem_bytes(int radius, int nms) {
  return (long long)smem_bytes(radius, nms, true);
}

// The same for the block mode (response only).
long long oicc_corner_response_smem_bytes(int radius) {
  return (long long)smem_bytes(radius, 0, false);
}

// 1 when (radius, nms) runs the kernel compiled for those sizes, 0 when it
// runs the generic instantiation.
int oicc_corner_nms_specialised(int radius, int nms) {
  return radius == SPEC_R && nms == SPEC_N;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// w_host and w_dev hold the same 8 * radius^2 packed weights, on the host
// (copied into the argument block of the specialised kernel) and on the
// device (read by the generic one).
int oicc_corner_nms_f32(const float* img, const float* w_host, const float* w_dev,
                        float* resp, float* keep, int H, int W, int radius, int nms,
                        void* stream) {
  if (H <= 0 || W <= 0 || radius <= 0 || nms < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (oicc_corner_nms_specialised(radius, nms)) {
    Taps<SPEC_R> taps;
    std::memcpy(taps.w, w_host, sizeof(taps.w));
    return launch<SPEC_R, SPEC_N, true>(img, taps, w_dev, resp, keep, 1, H, W, radius, nms, s);
  }
  return launch<0, 0, true>(img, Taps<0>{}, w_dev, resp, keep, 1, H, W, radius, nms, s);
}

// The block mode: the response of each of F contiguous H x W frames of img
// into resp (F x H x W), no mask; one launch for the block. radius 6 runs
// the instantiation compiled for it, any other the generic one.
int oicc_corner_response_block_f32(const float* img, const float* w_host, const float* w_dev,
                                   float* resp, int F, int H, int W, int radius,
                                   void* stream) {
  if (F <= 0 || F > 65535 || H <= 0 || W <= 0 || radius <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (radius == SPEC_R) {
    Taps<SPEC_R> taps;
    std::memcpy(taps.w, w_host, sizeof(taps.w));
    return launch<SPEC_R, 0, false>(img, taps, w_dev, resp, nullptr, F, H, W, radius, 0, s);
  }
  return launch<0, 0, false>(img, Taps<0>{}, w_dev, resp, nullptr, F, H, W, radius, 0, s);
}

const char* oicc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
