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
// Design (what differs from the TPU kernel): the TPU grid runs in order and
// carries H across the row-tile axis in VMEM. Here each thread block owns
// one (chunk, upper-triangular 32x32 tile of H) pair and loops over all R
// rows of its chunk itself, so there is no carried accumulator, no atomics,
// and the result is the same on every run. Per 64-row tile the block stages
// J, r and the per-row block indices in shared memory, builds the two
// 64x32 panels of D it needs (the tile's row and column ranges), and
// accumulates with plain fp32 FMAs (IEEE fp32, no TF32). Off-diagonal tiles
// are mirrored into the lower triangle on the way out; the diagonal tiles
// also produce g. Rows past R are masked in the kernel, not padded.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 on the CUDA cores):
// bytes K*R*(F+1+n_run)*4 + K*(L*L+L)*4; dense operations 2*K*R*L^2 (the
// full Gram of the dense D; this kernel does about half, the upper
// triangle of tiles). At the 60 s DS3 reprojection family (K~56, R=8192,
// F=44, L~190) that is ~0.1 GB -> ~0.03 ms of traffic against ~33 GFLOP ->
// ~0.5 ms of dense fp32 work, so the dense form is operation-bound; D has
// only F nonzeros per row, so the work the data needs is K*R*F*(F+1)
// (~0.9 GFLOP), and a kernel that skips the structural zeros would be
// bound by the bytes. This first kernel does the dense work on the CUDA
// cores; wgmma/TMA and skipping the zero blocks of D are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;        // H tile edge
constexpr int ROWS = 64;        // rows of D per staged tile
constexpr int THREADS = 256;    // 8 warps: warp w owns H rows 4w..4w+3 of the tile
constexpr int MAX_F = 64;       // widest compact Jacobian (accel: 54)
constexpr int MAX_RUN = 4;      // most run segments in one family
constexpr int PSTRIDE = TILE + 4;  // panel row stride: float4-aligned rows
constexpr int CT = 5;           // coltab entries per column

__device__ __forceinline__ float dense_value(const float (*js)[MAX_F + 1],
                                             const int (*is)[ROWS],
                                             const int* ct, int rr) {
  const int run = ct[0];
  if (run == -2) return 0.0f;             // column past L
  if (run < 0) return js[rr][ct[1]];      // fixed column
  const int i = is[run][rr];
  const int kk = ct[2] - i;
  if (kk < 0 || kk >= ct[3]) return 0.0f;
  return js[rr][ct[1] - i * ct[4]];
}

__global__ void __launch_bounds__(THREADS)
fused_gram_kernel(const float* __restrict__ J, const float* __restrict__ r,
                  const int* __restrict__ idx, const int* __restrict__ coltab,
                  float* __restrict__ H, float* __restrict__ g,
                  int K, int R, int F, int L, int n_run, int n_tiles) {
  __shared__ float js[ROWS][MAX_F + 1];
  __shared__ __align__(16) float pa[ROWS][PSTRIDE];
  __shared__ __align__(16) float pb[ROWS][PSTRIDE];
  __shared__ float rs[ROWS];
  __shared__ int is[MAX_RUN][ROWS];
  __shared__ int cta[TILE][CT];
  __shared__ int ctb[TILE][CT];

  const int k = blockIdx.y;
  // Decode the upper-triangular tile pair (ti <= tj) from blockIdx.x.
  int p = blockIdx.x, ti = 0, rem = n_tiles;
  while (p >= rem) { p -= rem; ++ti; --rem; }
  const int tj = ti + p;
  const bool diag = (ti == tj);

  const int tid = threadIdx.x;
  const int tx = tid % TILE;   // H column within the tile
  const int ty = tid / TILE;   // warp: H rows 4*ty .. 4*ty+3

  for (int e = tid; e < TILE * CT; e += THREADS) {
    const int c = e / CT, q = e % CT;
    const int ca = ti * TILE + c, cb = tj * TILE + c;
    cta[c][q] = ca < L ? coltab[ca * CT + q] : (q == 0 ? -2 : 0);
    ctb[c][q] = cb < L ? coltab[cb * CT + q] : (q == 0 ? -2 : 0);
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float gacc = 0.f;
  const float* Jk = J + (size_t)k * R * F;
  const float* rk = r + (size_t)k * R;
  float (*pbp)[PSTRIDE] = diag ? pa : pb;

  for (int row0 = 0; row0 < R; row0 += ROWS) {
    const int nrow = min(ROWS, R - row0);
    // Stage J rows (coalesced: the tile is one contiguous span of J).
    const float* src = Jk + (size_t)row0 * F;
    for (int e = tid; e < ROWS * F; e += THREADS) {
      const int rr = e / F, c = e % F;
      js[rr][c] = rr < nrow ? src[e] : 0.0f;
    }
    for (int e = tid; e < ROWS; e += THREADS) rs[e] = e < nrow ? rk[row0 + e] : 0.0f;
    for (int e = tid; e < n_run * ROWS; e += THREADS) {
      const int q = e / ROWS, rr = e % ROWS;
      is[q][rr] = rr < nrow ? idx[((size_t)q * K + k) * R + row0 + rr] : 0;
    }
    __syncthreads();
    // Build the panels of D for the tile's row (ti) and column (tj) ranges.
    for (int e = tid; e < ROWS * TILE; e += THREADS) {
      const int rr = e / TILE, c = e % TILE;
      pa[rr][c] = dense_value(js, is, cta[c], rr);
      if (!diag) pb[rr][c] = dense_value(js, is, ctb[c], rr);
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < ROWS; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&pa[rr][4 * ty]);
      const float b = pbp[rr][tx];
      acc[0] = fmaf(a.x, b, acc[0]);
      acc[1] = fmaf(a.y, b, acc[1]);
      acc[2] = fmaf(a.z, b, acc[2]);
      acc[3] = fmaf(a.w, b, acc[3]);
    }
    if (diag && ty == 0) {
      for (int rr = 0; rr < ROWS; ++rr) gacc = fmaf(pa[rr][tx], rs[rr], gacc);
    }
    __syncthreads();
  }

  float* Hk = H + (size_t)k * L * L;
  const int j = tj * TILE + tx;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = ti * TILE + 4 * ty + q;
    if (i < L && j < L) {
      Hk[(size_t)i * L + j] = acc[q];
      if (!diag) Hk[(size_t)j * L + i] = acc[q];
    }
  }
  if (diag && ty == 0 && j < L) g[(size_t)k * L + j] = gacc;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int oicc_fused_gram_f32(const float* J, const float* r, const int* idx,
                        const int* coltab, float* H, float* g, int K, int R,
                        int F, int L, int n_run, void* stream) {
  if (F > MAX_F || n_run > MAX_RUN || K <= 0 || L <= 0 || R < 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (L + TILE - 1) / TILE;
  const dim3 grid(n_tiles * (n_tiles + 1) / 2, K);
  fused_gram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      J, r, idx, coltab, H, g, K, R, F, L, n_run, n_tiles);
  return (int)cudaGetLastError();
}

const char* oicc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int oicc_gram_max_f() { return MAX_F; }
int oicc_gram_max_run() { return MAX_RUN; }

}  // extern "C"
