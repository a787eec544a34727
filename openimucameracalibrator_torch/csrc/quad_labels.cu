// Marker quad candidates of a block of dark masks on the card (kernel K3):
// connected components, the largest components' per-row extremes and the
// quad fit, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs this stage on the host
// (detect/video.py::_host_quads -> detect/quads.py::find_quad_candidates:
// scipy.ndimage.label, a numpy group-by over (label, row), the batched quad
// fit _fit_quads), because labelling is irregular and the TPU has no cheap
// atomics. On the card it was what held each 32-frame detection block: the
// mask fetched to the host, unpacked, labelled frame by frame and the quads
// copied back, ~15 ms of host time a 960x540 frame while the device idled.
// Here the block's chain pixel stage -> K3 -> decode is enqueued whole.
//
// For each frame f of mask (F x h x w, one byte a pixel, nonzero = dark) it
// writes what _host_quads writes, exactly:
//   quads[f, k] (Q x 4 x 2 f32) and qvalid[f, k], the valid quads first in
//   the host's order, then zeros; n_kept[f], the number of components that
//   pass the area filter (more than Q: the cut acted).
// Steps, one kernel each (all on one stream, no host synchronisation):
//   1. init: union-find parents, 4-connectivity (ndimage.label's default).
//      A foreground pixel links to the first pixel of its run within its
//      32-pixel warp segment, or to the pixel left of the segment. Every
//      link points to a smaller index, so a root is its component's smallest
//      raster index: its first pixel, whose order is scipy's label order.
//      Also zeroes the area table and the frame's candidate count.
//   2. merge: union with the pixel above (Playne & Hawick's atomicMin union,
//      the larger root linked under the smaller one), skipped where the left
//      and upper-left pixels already join the two.
//   3. compress: each pixel's parent set to its root; areas summed per root
//      (one atomic per run of equal roots in a warp).
//   4. candidates: roots with min_area <= area <= max_area appended to the
//      frame's list as the key (INT_MAX - area) << 32 | root.
//   5. select (one block a frame): each candidate's rank among the frame's
//      keys (area descending, then root ascending: quads.py's stable
//      argsort); the first Q take a slot, which is marked in the area table,
//      and their per-row extreme tables are reset.
//   6. rows: every pixel of a kept component takes its row's x min and max
//      and the component's last row with atomics (one a warp run); a
//      4-connected component's rows are contiguous from its root's row, so
//      slot y - y_root of an (F, Q, h) table holds them.
//   7. fit (one block of P = 128 threads a (frame, slot)): _fit_quads as the
//      host writes it: the same P points (row stride ceil(2R/P), padding by
//      the first point), the diameter pair (first flat index of the P x P
//      table wins a tie), the cross-product extremes (first index wins), the
//      clockwise order from the top-left corner, and the area, fill, side and
//      aspect gates.
//   8. compact (one block a frame): the valid quads to the front, scaled by
//      down and shifted by (down - 1) / 2.
// Every coordinate is an integer pixel index, so the diameter, the cross
// products and the shoelace area are computed in integers here; the host's
// float32 versions of them are exact while they stay below 2^24, which
// holds for masks up to 1920x1080. The corner angles are float32 (atan2 in
// double, rounded), the side lengths float32 square roots and the aspect
// gate a float32 division, as numpy computes them; the fill gate is double,
// as numpy promotes it.
//
// Bound on an H100 SXM (3.35 TB/s HBM) for a (32, 540, 960) block: the mask
// read once (16.6 MB) and the int32 parent table written and read back in
// steps 1-3 and read in 4 and 6 (66 MB a pass), about 0.4 GB in all, ~0.12
// ms. Steps 5, 7 and 8 touch kilobytes. The atomics of the union step sit in
// the L2 cache; the warp-level aggregation of steps 3 and 6 keeps one atomic
// per run of a row segment.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SEG = 32;          // pixels of a row segment: one warp
constexpr int ROWS = 8;          // rows of a pixel-kernel block
constexpr int P = 128;           // points a component (quads._fit_quads)
constexpr int SEL_THREADS = 512;
constexpr int TILE = 2048;       // keys staged in shared memory by select
constexpr int COMPACT_THREADS = 128;

__device__ __forceinline__ int ld(const int* p) { return *(const volatile int*)p; }

__device__ __forceinline__ int find_root(const int* L, int i) {
  int p = ld(L + i);
  while (p != i) {
    i = p;
    p = ld(L + i);
  }
  return i;
}

// Playne & Hawick's union: link the larger root under the smaller one;
// if another thread relinked it meanwhile, carry on from its new parent.
__device__ void unite(int* L, int a, int b) {
  while (true) {
    a = find_root(L, a);
    b = find_root(L, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(L + b, a);
    if (old == b) return;
    b = old;
  }
}

struct Pixel {
  int x, y, f;
  bool inb;
  size_t plane;
};

__device__ __forceinline__ Pixel pixel(int h, int w) {
  Pixel p;
  p.x = blockIdx.x * SEG + threadIdx.x;
  p.y = blockIdx.y * ROWS + threadIdx.y;
  p.f = blockIdx.z;
  p.inb = p.x < w && p.y < h;
  p.plane = (size_t)p.f * h * w;
  return p;
}

__global__ void quad_init_kernel(const uint8_t* __restrict__ mask, int* __restrict__ L,
                                 int* __restrict__ area, int* __restrict__ count, int h, int w) {
  const Pixel p = pixel(h, w);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && threadIdx.y == 0)
    count[p.f] = 0;
  const int i = p.y * w + p.x;
  const bool fg = p.inb && mask[p.plane + i];
  const unsigned bits = __ballot_sync(0xffffffffu, fg);
  if (!p.inb) return;
  area[p.plane + i] = 0;
  if (!fg) {
    L[p.plane + i] = -1;
    return;
  }
  const int lane = threadIdx.x;
  const unsigned gaps = ~bits & ((1u << lane) - 1u);  // background lanes below this one
  int parent;
  if (gaps) {
    parent = i - lane + (32 - __clz(gaps));  // the run's first pixel in the segment
  } else {
    const int x0 = blockIdx.x * SEG;
    parent = (x0 > 0 && mask[p.plane + i - lane - 1]) ? i - lane - 1 : i - lane;
  }
  L[p.plane + i] = parent;
}

__global__ void quad_merge_kernel(const uint8_t* __restrict__ mask, int* L, int h, int w) {
  const Pixel p = pixel(h, w);
  if (!p.inb || p.y == 0) return;
  const uint8_t* m = mask + p.plane;
  const int i = p.y * w + p.x;
  if (!m[i] || !m[i - w]) return;
  if (p.x > 0 && m[i - 1] && m[i - w - 1]) return;  // left and upper left join them already
  unite(L + p.plane, i, i - w);
}

__global__ void quad_compress_kernel(int* L, int* __restrict__ area, int h, int w) {
  const Pixel p = pixel(h, w);
  const int i = p.y * w + p.x;
  int* Lf = L + p.plane;
  const bool fg = p.inb && Lf[i] >= 0;
  const int root = fg ? find_root(Lf, i) : -1;
  const unsigned group = __match_any_sync(0xffffffffu, root);
  if (!fg) return;
  Lf[i] = root;
  if ((int)threadIdx.x == __ffs(group) - 1) atomicAdd(area + p.plane + root, __popc(group));
}

__global__ void quad_candidates_kernel(
    const int* __restrict__ L, const int* __restrict__ area, int* __restrict__ count,
    unsigned long long* __restrict__ keys, int h, int w, int cap, int lo, int hi) {
  const Pixel p = pixel(h, w);
  if (!p.inb) return;
  const int i = p.y * w + p.x;
  if (L[p.plane + i] != i) return;
  const int a = area[p.plane + i];
  if (a < lo || a > hi) return;
  const int k = atomicAdd(count + p.f, 1);
  if (k < cap)
    keys[(size_t)p.f * cap + k] =
        ((unsigned long long)(unsigned)(INT_MAX - a) << 32) | (unsigned)i;
}

__global__ void quad_select_kernel(const int* __restrict__ count,
                                   const unsigned long long* __restrict__ keys,
                                   int* __restrict__ area,
                                   int* __restrict__ slot_root, int* __restrict__ slot_area,
                                   int* __restrict__ rowmax, int* __restrict__ xmin,
                                   int* __restrict__ xmax, int h, int w, int cap, int Q) {
  __shared__ unsigned long long tile[TILE];
  const int f = blockIdx.x;
  const int n = min(count[f], cap);
  const int nsel = min(n, Q);
  const unsigned long long* kf = keys + (size_t)f * cap;
  for (int kb = 0; kb < n; kb += blockDim.x) {
    const int k = kb + threadIdx.x;
    const unsigned long long mine = k < n ? kf[k] : ~0ull;
    int rank = 0;
    for (int tb = 0; tb < n; tb += TILE) {
      const int tn = min(TILE, n - tb);
      for (int j = threadIdx.x; j < tn; j += blockDim.x) tile[j] = kf[tb + j];
      __syncthreads();
      if (k < n)
        for (int j = 0; j < tn; ++j) rank += tile[j] < mine;
      __syncthreads();
    }
    if (k < n && rank < Q) {
      const int root = (int)(unsigned)(mine & 0xffffffffull);
      const int s = f * Q + rank;
      slot_root[s] = root;
      slot_area[s] = INT_MAX - (int)(mine >> 32);
      rowmax[s] = -1;
      area[(size_t)f * h * w + root] = -1 - rank;
    }
  }
  const size_t base = (size_t)f * Q * h;
  for (size_t e = threadIdx.x; e < (size_t)nsel * h; e += blockDim.x) {
    xmin[base + e] = INT_MAX;
    xmax[base + e] = -1;
  }
}

__global__ void quad_rows_kernel(const int* __restrict__ L, const int* __restrict__ area,
                                 const int* __restrict__ slot_root, int* __restrict__ rowmax,
                                 int* __restrict__ xmin, int* __restrict__ xmax, int h, int w,
                                 int Q) {
  const Pixel p = pixel(h, w);
  const int i = p.y * w + p.x;
  int slot = -1;
  if (p.inb) {
    const int root = L[p.plane + i];
    if (root >= 0) {
      const int v = area[p.plane + root];
      if (v < 0) slot = -1 - v;
    }
  }
  const unsigned group = __match_any_sync(0xffffffffu, slot);
  const int lo = __reduce_min_sync(group, p.x);
  const int hi = __reduce_max_sync(group, p.x);
  if (slot < 0 || (int)threadIdx.x != __ffs(group) - 1) return;
  const int s = p.f * Q + slot;
  const int row = p.y - slot_root[s] / w;
  const size_t t = (size_t)s * h + row;
  atomicMin(xmin + t, lo);
  atomicMax(xmax + t, hi);
  atomicMax(rowmax + s, p.y);
}

struct Best {
  long long v;
  int i;
};

__device__ __forceinline__ bool beats(long long v, int i, long long u, int j, bool largest) {
  return (largest ? v > u : v < u) || (v == u && i < j);
}

// The best (value, index) over the block's P threads, the smaller index
// winning a tie; every thread gets it.
__device__ Best block_best(long long v, int i, bool largest, Best* sh) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_down_sync(0xffffffffu, v, o);
    const int j = __shfl_down_sync(0xffffffffu, i, o);
    if (beats(u, j, v, i, largest)) {
      v = u;
      i = j;
    }
  }
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = Best{v, i};
  __syncthreads();
  Best b = sh[0];
  for (int k = 1; k < P / 32; ++k)
    if (beats(sh[k].v, sh[k].i, b.v, b.i, largest)) b = sh[k];
  __syncthreads();
  return b;
}

__global__ void __launch_bounds__(P) quad_fit_kernel(
    const int* __restrict__ count, const int* __restrict__ slot_root,
    const int* __restrict__ slot_area, const int* __restrict__ rowmax,
    const int* __restrict__ xmin, const int* __restrict__ xmax, float* __restrict__ res_quad,
    int* __restrict__ res_ok, int h, int w, int Q, double min_fill, int down) {
  __shared__ int px[P], py[P];
  __shared__ Best sh[P / 32];
  const int slot = blockIdx.x, f = blockIdx.y, t = threadIdx.x;
  if (slot >= min(count[f], Q)) return;
  const int s = f * Q + slot;
  const int y0 = slot_root[s] / w;
  const int R = rowmax[s] - y0 + 1;
  const int stride = max(1, (2 * R + P - 1) / P);
  const int m = (R + stride - 1) / stride;
  const int* xl = xmin + (size_t)s * h;
  const int* xr = xmax + (size_t)s * h;
  int x, y;
  if (t < m) {
    x = xl[t * stride];
    y = y0 + t * stride;
  } else if (t < 2 * m) {
    x = xr[(t - m) * stride];
    y = y0 + (t - m) * stride;
  } else {
    x = xl[0];
    y = y0;
  }
  px[t] = x;
  py[t] = y;
  __syncthreads();

  // Diameter pair: row t of the P x P squared-distance table.
  long long best = -1;
  int bj = 0;
  for (int j = 0; j < P; ++j) {
    const long long dx = x - px[j], dy = y - py[j];
    const long long d = dx * dx + dy * dy;
    if (d > best) {
      best = d;
      bj = j;
    }
  }
  const Best diam = block_best(best, t * P + bj, true, sh);
  const int ia = diam.i / P, ib = diam.i % P;
  const long long ax = px[ia], ay = py[ia];
  const long long abx = px[ib] - ax, aby = py[ib] - ay;
  const long long cross = (x - ax) * aby - (y - ay) * abx;
  const Best cmax = block_best(cross, t, true, sh);
  const Best cmin = block_best(cross, t, false, sh);
  if (t != 0) return;

  int qx[4] = {px[ia], px[cmax.i], px[ib], px[cmin.i]};
  int qy[4] = {py[ia], py[cmax.i], py[ib], py[cmin.i]};
  bool ok = cmax.v > 0 && cmin.v < 0;
  // clockwise in image coordinates: a stable sort by the angle about the
  // centroid (the mean of four integers, exact in float32)
  const float cx = (float)(qx[0] + qx[1] + qx[2] + qx[3]) / 4.0f;
  const float cy = (float)(qy[0] + qy[1] + qy[2] + qy[3]) / 4.0f;
  float ang[4];
  int ord[4];
  for (int k = 0; k < 4; ++k) {
    ang[k] = (float)atan2((double)((float)qy[k] - cy), (double)((float)qx[k] - cx));
    ord[k] = k;
  }
  for (int k = 1; k < 4; ++k)
    for (int j = k; j > 0 && ang[ord[j]] < ang[ord[j - 1]]; --j) {
      const int tmp = ord[j];
      ord[j] = ord[j - 1];
      ord[j - 1] = tmp;
    }
  int start = 0;
  for (int k = 1; k < 4; ++k)
    if (qx[ord[k]] + qy[ord[k]] < qx[ord[start]] + qy[ord[start]]) start = k;
  int ox[4], oy[4];
  for (int k = 0; k < 4; ++k) {
    ox[k] = qx[ord[(start + k) & 3]];
    oy[k] = qy[ord[(start + k) & 3]];
  }
  long long shoe = 0;
  float smin = 0.f, smax = 0.f;
  for (int k = 0; k < 4; ++k) {
    const int n = (k + 1) & 3;
    shoe += (long long)ox[k] * oy[n] - (long long)oy[k] * ox[n];
    const long long dx = ox[n] - ox[k], dy = oy[n] - oy[k];
    const float side = __fsqrt_rn((float)(dx * dx + dy * dy));
    smin = k ? fminf(smin, side) : side;
    smax = k ? fmaxf(smax, side) : side;
  }
  const double qa = 0.5 * (double)(shoe < 0 ? -shoe : shoe);
  ok = ok && qa > 0.0 && (double)slot_area[s] / fmax(qa, 1.0) >= min_fill;
  ok = ok && smin >= 2.0f && __fdiv_rn(smax, fmaxf(smin, 1e-9f)) <= 5.0f;
  const float scale = (float)down, shift = (float)((down - 1) / 2.0);
  for (int k = 0; k < 4; ++k) {
    res_quad[(size_t)s * 8 + 2 * k] = __fadd_rn(__fmul_rn((float)ox[k], scale), shift);
    res_quad[(size_t)s * 8 + 2 * k + 1] = __fadd_rn(__fmul_rn((float)oy[k], scale), shift);
  }
  res_ok[s] = ok;
}

__global__ void quad_compact_kernel(const int* __restrict__ count,
                                    const float* __restrict__ res_quad,
                                    const int* __restrict__ res_ok, float* __restrict__ quads,
                                    uint8_t* __restrict__ qvalid, int Q) {
  extern __shared__ int pos[];
  __shared__ int nvalid;
  const int f = blockIdx.x;
  const int nsel = min(count[f], Q);
  if (threadIdx.x == 0) {
    int k = 0;
    for (int s = 0; s < nsel; ++s) pos[s] = res_ok[f * Q + s] ? k++ : -1;
    nvalid = k;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Q * 8; e += blockDim.x) {
    const int s = e / 8;
    if (s < nsel && pos[s] >= 0)
      quads[((size_t)f * Q + pos[s]) * 8 + e % 8] = res_quad[((size_t)f * Q + s) * 8 + e % 8];
    const int k = e / 8;
    if (k >= nvalid) quads[((size_t)f * Q + k) * 8 + e % 8] = 0.f;
  }
  for (int k = threadIdx.x; k < Q; k += blockDim.x) qvalid[(size_t)f * Q + k] = k < nvalid;
}

size_t align(size_t n) { return (n + 255) / 256 * 256; }

// Workspace layout: offsets of each table, in bytes.
struct Layout {
  size_t L, area, keys, slot_root, slot_area, rowmax, xmin, xmax, res_quad, res_ok, total;
};

Layout layout(int F, int h, int w, int Q, int cap) {
  Layout o;
  const size_t px = (size_t)F * h * w, fq = (size_t)F * Q;
  size_t at = 0;
  o.L = at;          at += align(px * 4);
  o.area = at;       at += align(px * 4);
  o.keys = at;       at += align((size_t)F * cap * 8);
  o.slot_root = at;  at += align(fq * 4);
  o.slot_area = at;  at += align(fq * 4);
  o.rowmax = at;     at += align(fq * 4);
  o.xmin = at;       at += align(fq * h * 4);
  o.xmax = at;       at += align(fq * h * 4);
  o.res_quad = at;   at += align(fq * 8 * 4);
  o.res_ok = at;     at += align(fq * 4);
  o.total = at;
  return o;
}

}  // namespace

extern "C" {

// Bytes of device workspace oicc_quad_candidates_block needs.
long long oicc_quad_workspace_bytes(int F, int h, int w, int Q, int cap) {
  return (long long)layout(F, h, w, Q, cap).total;
}

// Launches the eight kernels on `stream`; returns the first
// cudaGetLastError() that is not 0, else 0. mask is F x h x w bytes;
// quads F x Q x 4 x 2 f32, qvalid F x Q bytes, n_kept F int32. cap bounds
// the candidates of a frame: (h * w) / lo, since components are disjoint.
int oicc_quad_candidates_block(const uint8_t* mask, void* workspace, int F, int h, int w, int Q,
                               int cap, int lo, int hi, double min_fill, int down, float* quads,
                               uint8_t* qvalid, int* n_kept, void* stream) {
  if (F <= 0 || F > 65535 || h <= 0 || w <= 0 || (long long)h * w > INT_MAX || Q <= 0 ||
      cap <= 0 || lo < 1 || down < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Layout o = layout(F, h, w, Q, cap);
  char* ws = (char*)workspace;
  int* L = (int*)(ws + o.L);
  int* area = (int*)(ws + o.area);
  unsigned long long* keys = (unsigned long long*)(ws + o.keys);
  int* slot_root = (int*)(ws + o.slot_root);
  int* slot_area = (int*)(ws + o.slot_area);
  int* rowmax = (int*)(ws + o.rowmax);
  int* xmin = (int*)(ws + o.xmin);
  int* xmax = (int*)(ws + o.xmax);
  float* res_quad = (float*)(ws + o.res_quad);
  int* res_ok = (int*)(ws + o.res_ok);
  const dim3 block(SEG, ROWS), grid((w + SEG - 1) / SEG, (h + ROWS - 1) / ROWS, F);
  cudaError_t e;
#define OICC_CHECK() if ((e = cudaGetLastError()) != cudaSuccess) return (int)e
  quad_init_kernel<<<grid, block, 0, st>>>(mask, L, area, n_kept, h, w);
  OICC_CHECK();
  quad_merge_kernel<<<grid, block, 0, st>>>(mask, L, h, w);
  OICC_CHECK();
  quad_compress_kernel<<<grid, block, 0, st>>>(L, area, h, w);
  OICC_CHECK();
  quad_candidates_kernel<<<grid, block, 0, st>>>(L, area, n_kept, keys, h, w, cap, lo, hi);
  OICC_CHECK();
  quad_select_kernel<<<F, SEL_THREADS, 0, st>>>(n_kept, keys, area, slot_root, slot_area, rowmax,
                                                 xmin, xmax, h, w, cap, Q);
  OICC_CHECK();
  quad_rows_kernel<<<grid, block, 0, st>>>(L, area, slot_root, rowmax, xmin, xmax, h, w, Q);
  OICC_CHECK();
  quad_fit_kernel<<<dim3(Q, F), P, 0, st>>>(n_kept, slot_root, slot_area, rowmax, xmin, xmax,
                                            res_quad, res_ok, h, w, Q, min_fill, down);
  OICC_CHECK();
  quad_compact_kernel<<<F, COMPACT_THREADS, Q * sizeof(int), st>>>(n_kept, res_quad, res_ok, quads,
                                                                   qvalid, Q);
  OICC_CHECK();
#undef OICC_CHECK
  return 0;
}

const char* oicc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
