// Fused densify + Gram for the chunk-local linearizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel solver/pallas_gram.py::make_fused_gram of the JAX
// package (the pl.pallas_call in its batched_call). For every chunk k it
// builds H[k] = D^T D and g[k] = D^T r, where D (R x L) is the dense
// chunk-local Jacobian assembled from the compact Jacobian J (R x F) by a
// static segment list:
//   ("run",   col0, nblk, td, wblk, out_off): nblk td-wide blocks of J land
//             at block idx[row] + kk of a wblk-block region at out_off;
//   ("fixed", col0, ncols, out_off): columns shared by all rows.
// The host flattens the list into one entry per output column c (coltab):
//   {run, base, b, nblk, td}; run = -1 for a fixed column (then
//   D[row, c] = J[row, base]); for a run column D[row, c] =
//   J[row, base - i*td] when 0 <= b - i < nblk with i = idx[run][row],
//   else 0. Every J read stays inside [col0, col0 + nblk*td) whatever idx
//   holds.
//
// Design. Each thread block owns one (chunk, upper-triangular 32x32 tile
// of H, slab of 16 row tiles of 64 rows) triple. Blocks that share a
// (chunk, tile) write their partial tiles to scratch and a second kernel
// adds the slabs in a fixed order; a chunk of at most 16 row tiles is
// written directly. There are no atomics, so every run gives the same
// result bit for bit. Off-diagonal tiles are mirrored into the lower
// triangle on the way out; the diagonal tiles also produce g. IEEE fp32
// FMAs, no TF32.
//
// Skipping D's zero blocks. A row of D has only F nonzeros out of L. The
// linearizer's measurements are time-sorted, so the rows of one 64-row
// tile share one or two knot indices per run and reach only a few
// columns. A first kernel writes, per (run, chunk, row tile), the min and
// max of idx over the tile's rows; the host table tilereach holds, per
// 16-column half-tile of H and per run, the interval of idx values that
// reach one of its columns, and whether it holds a fixed column. From
// these a block marks, per row tile of its slab, which of its four half
// tiles the rows can reach. It skips a row tile that reaches no
// (row half, column half) pair, builds only the reached halves of the two
// 64x32 panels of D, and each of its 4 warps, which owns one 16x16 quarter
// of the H tile, skips its FMAs unless both of its halves are reached. The
// test is conservative (min/max over the rows), so any idx, sorted or not,
// gives the exact result; sortedness only buys speed.
//
// The row tile of J (contiguous, 64 x F), its indices and residuals are
// loaded into registers one visited row tile ahead, with independent
// loads, and stored to shared memory at the top of the next step; the two
// panels are then built from shared memory (one branch-free select per
// element). In the product each lane owns a 2x4 patch of its warp's
// quarter: one float2 and one float4 shared-memory load feed 8 FMAs.
// Splitting the rows into slabs keeps the longest chain of row tiles one
// block walks at 16, and fills the card with blocks.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 on the CUDA cores):
// bytes K*R*(F+1+n_run)*4 + K*(L*L+L)*4; the operations the data needs
// are K*R*(F*(F+1) + 2F) (F nonzeros per row of D). At the 60 s DS3
// reprojection family (K=56, R=8192, F=44, L=173) that is ~0.09 GB ->
// ~0.03 ms against ~0.95 GFLOP -> ~0.014 ms: bound by the bytes. The
// dense Gram would be 2*K*R*L^2 = 27.5 GFLOP; the skip leaves the
// quarters a row tile reaches, and within each quarter the panels still
// hold zeros. wgmma/TMA and a compact F x F form are later work.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;        // H tile edge
constexpr int HALF = TILE / 2;  // skip granularity: 16 columns
constexpr int ROWS = 64;        // rows of D per row tile
constexpr int SLAB = 16;        // row tiles per block
constexpr int THREADS = 128;    // warp w owns quarter (w / 2, w % 2) of the H tile
constexpr int MAX_F = 64;       // widest compact Jacobian (accel: 54)
constexpr int MAX_RUN = 4;      // most run segments in one family
constexpr int PSTRIDE = TILE + 4;  // panel row stride: float4-aligned rows
constexpr int CT = 5;           // coltab entries per column
constexpr int TR = 2 * MAX_RUN + 1;  // tilereach entries per half tile
constexpr int PART = TILE * TILE + TILE;  // floats of one partial tile (H, then g)
constexpr int JPT = ROWS * MAX_F / THREADS;  // J values each thread prefetches
constexpr int IPT = MAX_RUN * ROWS / THREADS;  // indices each thread prefetches

// One warp per (run, chunk, row tile): min and max of idx over its rows.
__global__ void row_tile_ranges_kernel(const int* __restrict__ idx, int2* __restrict__ ranges,
                                       int R, int n_items, int n_rt) {
  const int item = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (item >= n_items) return;  // the whole warp leaves together
  const int t = item % n_rt;
  const int* src = idx + (size_t)(item / n_rt) * R + (size_t)t * ROWS;
  const int n = min(ROWS, R - t * ROWS);
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = lane; i < n; i += 32) {
    const int v = src[i];
    lo = min(lo, v);
    hi = max(hi, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) ranges[item] = make_int2(lo, hi);
}

// D[row, c] for the column entry ct = {run, base, b, nblk, td}, from the
// row's J values jrow and the tile's indices is (both in shared memory);
// run -2 marks a column past L.
__device__ __forceinline__ float dense_value(const float* jrow, const int* is, const int* ct,
                                             int rr) {
  if (ct[0] == -1) return jrow[ct[1]];
  if (ct[0] < 0) return 0.f;
  const int i = is[ct[0] * ROWS + rr];
  const bool in = (unsigned)(ct[2] - i) < (unsigned)ct[3];
  const float v = jrow[in ? ct[1] - i * ct[4] : 0];
  return in ? v : 0.f;
}

// Whether rows with the index ranges rng[q * stride] can reach half tile h.
__device__ bool reaches(const int* __restrict__ tilereach, int h, int n_halves,
                        const int2* __restrict__ rng, int n_run, size_t stride) {
  if (h >= n_halves) return false;
  const int* tr = tilereach + h * TR;
  bool hit = tr[2 * MAX_RUN] != 0;
  for (int q = 0; q < n_run; ++q) {
    const int2 v = rng[q * stride];
    hit |= max(v.x, tr[2 * q]) <= min(v.y, tr[2 * q + 1]);
  }
  return hit;
}

__device__ __forceinline__ void decode_pair(int p, int n_tiles, int& ti, int& tj) {
  int rem = n_tiles;
  ti = 0;
  while (p >= rem) { p -= rem; ++ti; --rem; }
  tj = ti + p;
}

__global__ void __launch_bounds__(THREADS)
fused_gram_kernel(const float* __restrict__ J, const float* __restrict__ r,
                  const int* __restrict__ idx, const int* __restrict__ coltab,
                  const int* __restrict__ tilereach, const int2* __restrict__ ranges,
                  float* __restrict__ part, float* __restrict__ H, float* __restrict__ g,
                  int K, int R, int F, int L, int n_run, int n_tiles, int n_rt) {
  __shared__ float js[ROWS * MAX_F];  // the row tile of J, row stride F
  __shared__ __align__(16) float pa[ROWS][PSTRIDE];
  __shared__ __align__(16) float pb[ROWS][PSTRIDE];
  __shared__ float rs[ROWS];
  __shared__ int is[MAX_RUN * ROWS];
  __shared__ int masks[SLAB];

  const int k = blockIdx.y;
  int ti, tj;
  decode_pair(blockIdx.x, n_tiles, ti, tj);
  const bool diag = (ti == tj);
  const int t0 = blockIdx.z * SLAB, t1 = min(n_rt, t0 + SLAB);

  const int tid = threadIdx.x;
  const int c = tid % TILE;                   // panel build: column c, rows tid/TILE + 4m
  const int w = tid / 32, lane = tid % 32;
  const int wa = w / 2, wb = w % 2;           // this warp's quarter of the H tile
  const int ly = lane / 4, lx = lane % 4;     // rows 16wa + 2ly.., columns 16wb + 4lx..

  // Per row tile of the slab: bits 0-1 the reached row halves (2ti, 2ti+1),
  // bits 2-3 the reached column halves (2tj, 2tj+1).
  if (tid < t1 - t0) {
    const int n_halves = (L + HALF - 1) / HALF;
    const int2* rng = ranges + (size_t)k * n_rt + t0 + tid;
    const size_t stride = (size_t)K * n_rt;
    int m = 0;
    for (int h = 0; h < 2; ++h) {
      m |= reaches(tilereach, 2 * ti + h, n_halves, rng, n_run, stride) << h;
      m |= reaches(tilereach, 2 * tj + h, n_halves, rng, n_run, stride) << (2 + h);
    }
    masks[tid] = m;
  }

  int cta[CT], ctb[CT];
  const int ca = ti * TILE + c, cb = tj * TILE + c;
#pragma unroll
  for (int q = 0; q < CT; ++q) {
    cta[q] = ca < L ? coltab[ca * CT + q] : (q == 0 ? -2 : 0);
    ctb[q] = cb < L ? coltab[cb * CT + q] : (q == 0 ? -2 : 0);
  }
  __syncthreads();

  float acc[2][4] = {};
  float gacc = 0.f;
  const float* Jk = J + (size_t)k * R * F;
  const float* rk = r + (size_t)k * R;
  float (*pbp)[PSTRIDE] = diag ? pa : pb;

  // The next row tile that reaches one (row half, column half) pair.
  auto next = [&](int t) {
    for (; t < t1; ++t) {
      const int m = masks[t - t0];
      if ((m & 3) && (m >> 2)) break;
    }
    return t;
  };
  // Row tile t into registers: independent loads, all in flight at once.
  float jn[JPT];
  int in_[IPT];
  float rn = 0.f;
  auto load = [&](int t) {
    const int row0 = t * ROWS;
    const int nrow = min(ROWS, R - row0);
    const float* src = Jk + (size_t)row0 * F;
#pragma unroll
    for (int m = 0; m < JPT; ++m) {
      const int e = tid + m * THREADS;
      jn[m] = e < nrow * F ? __ldg(src + e) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < IPT; ++m) {
      const int e = tid + m * THREADS, q = e / ROWS, rr = e % ROWS;
      in_[m] = (q < n_run && rr < nrow) ? __ldg(idx + ((size_t)q * K + k) * R + row0 + rr) : 0;
    }
    if (diag && tid < ROWS) rn = tid < nrow ? __ldg(rk + row0 + tid) : 0.f;
  };

  int t = next(t0);
  if (t < t1) load(t);
  while (t < t1) {
    const int m = masks[t - t0];
    const int ma = m & 3, mb = (m >> 2) & 3;
#pragma unroll
    for (int i = 0; i < JPT; ++i) js[tid + i * THREADS] = jn[i];
#pragma unroll
    for (int i = 0; i < IPT; ++i) is[tid + i * THREADS] = in_[i];
    if (diag && tid < ROWS) rs[tid] = rn;
    __syncthreads();
    const int tn = next(t + 1);
    if (tn < t1) load(tn);  // in flight while this tile is used
    // Rows past R hold zeros in js, so they add nothing.
    const bool build_a = (ma >> (c / HALF)) & 1;
    const bool build_b = !diag && ((mb >> (c / HALF)) & 1);
#pragma unroll 4
    for (int rr = tid / TILE; rr < ROWS; rr += THREADS / TILE) {
      const float* jrow = js + rr * F;
      if (build_a) pa[rr][c] = dense_value(jrow, is, cta, rr);
      if (build_b) pb[rr][c] = dense_value(jrow, is, ctb, rr);
    }
    __syncthreads();
    if (((ma >> wa) & 1) && ((mb >> wb) & 1)) {  // warp-uniform
      const int ia = HALF * wa + 2 * ly, jb = HALF * wb + 4 * lx;
#pragma unroll 8
      for (int rr = 0; rr < ROWS; ++rr) {
        const float2 a = *reinterpret_cast<const float2*>(&pa[rr][ia]);
        const float4 b = *reinterpret_cast<const float4*>(&pbp[rr][jb]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[0][v] = fmaf(a.x, bv[v], acc[0][v]);
          acc[1][v] = fmaf(a.y, bv[v], acc[1][v]);
        }
      }
    }
    if (diag && tid < TILE && ((ma >> (tid / HALF)) & 1)) {
      for (int rr = 0; rr < ROWS; ++rr) gacc = fmaf(pa[rr][tid], rs[rr], gacc);
    }
    __syncthreads();
    t = tn;
  }

  if (gridDim.z > 1) {  // partial tile of this slab, tile-local layout
    float* P = part + ((size_t)(k * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z) * PART;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        P[(HALF * wa + 2 * ly + u) * TILE + HALF * wb + 4 * lx + v] = acc[u][v];
    if (diag && tid < TILE) P[TILE * TILE + tid] = gacc;
    return;
  }
  float* Hk = H + (size_t)k * L * L;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = ti * TILE + HALF * wa + 2 * ly + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = tj * TILE + HALF * wb + 4 * lx + v;
      if (i < L && j < L) {
        Hk[(size_t)i * L + j] = acc[u][v];
        if (!diag) Hk[(size_t)j * L + i] = acc[u][v];
      }
    }
  }
  if (diag && tid < TILE && ti * TILE + tid < L) g[(size_t)k * L + ti * TILE + tid] = gacc;
}

// Adds the slabs' partial tiles in slab order and writes H (mirrored) and g.
__global__ void __launch_bounds__(256)
reduce_slabs_kernel(const float* __restrict__ part, float* __restrict__ H,
                    float* __restrict__ g, int L, int n_tiles, int n_slab) {
  const int k = blockIdx.y;
  int ti, tj;
  decode_pair(blockIdx.x, n_tiles, ti, tj);
  const bool diag = (ti == tj);
  const float* P = part + (size_t)(k * gridDim.x + blockIdx.x) * n_slab * PART;
  float* Hk = H + (size_t)k * L * L;
  for (int e = threadIdx.x; e < TILE * TILE; e += blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < n_slab; ++z) s += P[(size_t)z * PART + e];
    const int i = ti * TILE + e / TILE, j = tj * TILE + e % TILE;
    if (i < L && j < L) {
      Hk[(size_t)i * L + j] = s;
      if (!diag) Hk[(size_t)j * L + i] = s;
    }
  }
  if (diag && threadIdx.x < TILE) {
    float s = 0.f;
    for (int z = 0; z < n_slab; ++z) s += P[(size_t)z * PART + TILE * TILE + threadIdx.x];
    const int j = ti * TILE + threadIdx.x;
    if (j < L) g[(size_t)k * L + j] = s;
  }
}

int n_slabs(int R) { return max(1, ((R + ROWS - 1) / ROWS + SLAB - 1) / SLAB); }

}  // namespace

extern "C" {

// Floats of scratch `part` that oicc_fused_gram_f32 needs (0: none).
long long oicc_gram_scratch_floats(int K, int R, int L) {
  const int n_tiles = (L + TILE - 1) / TILE;
  const int S = n_slabs(R);
  return S > 1 ? (long long)K * (n_tiles * (n_tiles + 1) / 2) * S * PART : 0;
}

// Launches the kernels on `stream`; returns cudaGetLastError() (0 =
// launched). tilereach is the (ceil(L / HALF), TR) host-built table (see
// solver/gram._tile_reach, which takes its width from oicc_gram_max_run);
// ranges is scratch of n_run * K * ceil(R / 64) int2, part of
// oicc_gram_scratch_floats(K, R, L) floats.
int oicc_fused_gram_f32(const float* J, const float* r, const int* idx,
                        const int* coltab, const int* tilereach, int* ranges, float* part,
                        float* H, float* g, int K, int R, int F, int L, int n_run,
                        void* stream) {
  if (F > MAX_F || n_run > MAX_RUN || n_run < 0 || K <= 0 || L <= 0 || R < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (L + TILE - 1) / TILE;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int n_rt = (R + ROWS - 1) / ROWS;
  const int n_items = n_run * K * n_rt;
  const int S = n_slabs(R);
  int2* rng = reinterpret_cast<int2*>(ranges);
  if (n_items > 0) {
    row_tile_ranges_kernel<<<(n_items + 7) / 8, 256, 0, s>>>(idx, rng, R, n_items, n_rt);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  fused_gram_kernel<<<dim3(n_pairs, K, S), THREADS, 0, s>>>(
      J, r, idx, coltab, tilereach, rng, part, H, g, K, R, F, L, n_run, n_tiles, n_rt);
  if (S > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    reduce_slabs_kernel<<<dim3(n_pairs, K), 256, 0, s>>>(part, H, g, L, n_tiles, S);
  }
  return (int)cudaGetLastError();
}

const char* oicc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int oicc_gram_max_f() { return MAX_F; }
int oicc_gram_max_run() { return MAX_RUN; }
int oicc_gram_reach_tile() { return HALF; }
int oicc_gram_row_tile() { return ROWS; }

}  // extern "C"
