// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a); plain C interface
// for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:_ssd_kernel
// (entered through ssd_scan_fwd, pallas_call at :108).
//
// Computes, per (batch b, head h), tile by tile along the sequence, from a
// zero state H (p x n, fp32):
//   cum = cumsum(dt * A)                           (inclusive, within a tile)
//   y   = (C B^T . exp(seg) . dt_j) X + exp(cum) . (C H^T)
//   H   = exp(total) H + (X . w)^T B,     w = exp(total - cum) . dt
// where seg_ij = cum_i - cum_j is masked below the diagonal before the exp
// (the exp is never taken above it, where it would overflow) and total is
// the tile's last cum.  Grouped B and C are read at group h / (H / G).  y is
// written in x's type; the final state, when asked for, in fp32.
//
// The tile is 64 rows, whatever the caller's chunk: the chunked form equals
// the recurrence for any chunk length, so the tile is the kernel's choice
// (it sizes shared memory), and rows past the sequence's end are zero-filled
// with dt = 0, which leaves the state and cum unchanged.
//
// Bound on an H100 SXM: per (b, h) and 64-row tile, q(q+1)/2 (2n + 2p) +
// 4 q p n FLOPs against reading x, B, C, dt and writing y (and the state)
// once.  At mamba2-2.7b prefill (p 64, n 128, bf16) that is ~210 FLOPs per
// byte, under the card's ~295 bf16 FLOPs per byte: bound by bytes.
//
// What this first design does about it: each element of x, B, C and dt is
// read from device memory once, the q x q score tile and the state never
// leave shared memory, and the final state is written by the same launch
// that writes y (prefill needs no second scan).  It computes on the fp32
// CUDA cores, with 4 x 4 (to 4 x 8) register micro-tiles over shared
// memory: one block per (h, b) runs the chunks in order, so at b 2 the grid
// is only 2H blocks deep and far from the bound.  Splitting the state over
// p, and the products onto the tensor cores, is the work of a later change.
//
// Layout: 256 threads (16 x 16).  x, dt, B and C are read in place through
// their strides, so slices of one projection need no copy.  Shared memory
// holds, in fp32 with rows padded by one word, the C and B tiles (64 x 129),
// the x tile (64 x PMAX+1), the masked score tile (64 x 65), the state
// (PMAX x 129) and cum, dt and w: ~133 KB at PMAX 64, above the default
// 48 KB, hence cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;        // sequence rows per tile
constexpr int PMAX = 64;      // largest head dim p (mamba2 and zamba2: 64)
constexpr int NMAX = 128;     // largest state size n
constexpr int LDN = NMAX + 1; // padded row stride of the C, B and state tiles
constexpr int LDQ = TQ + 1;   // padded row stride of the score tile
constexpr int THREADS = 256;  // 16 x 16 threads

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;  // null: the final state is not written
  int b, l, h, g, p, n;
  long long x_sb, x_sl, x_sh, x_sp;
  long long dt_sb, dt_sl, dt_sh;
  long long B_sb, B_sl, B_sg, B_sn;
  long long C_sb, C_sl, C_sg, C_sn;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory of one block, in floats.
constexpr int smem_floats(int pmax) {
  return 2 * TQ * LDN + TQ * (pmax + 1) + TQ * LDQ + pmax * LDN + 3 * TQ;
}

// Rows [t0, t0 + TQ) x [0, cols_pad) of one head into a padded fp32 tile,
// zero-filling rows >= l and columns >= cols.
template <typename T, int COLS_PAD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int t0, int l, int cols,
                                          long long s_row, long long s_col) {
  constexpr int LD = COLS_PAD + 1;
  for (int i = threadIdx.x; i < TQ * COLS_PAD; i += THREADS) {
    const int r = i / COLS_PAD, c = i % COLS_PAD;
    const int row = t0 + r;
    float v = 0.f;
    if (row < l && c < cols) v = to_float(src[row * s_row + c * s_col]);
    dst[r * LD + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_kernel(const Params p) {
  constexpr int PC = PMAX / 16;  // y columns / state rows per thread
  constexpr int NC = NMAX / 16;  // state columns per thread
  constexpr int LDP = PMAX + 1;  // padded row stride of the x tile
  extern __shared__ float smem[];
  float* sC = smem;               // TQ x LDN
  float* sB = sC + TQ * LDN;      // TQ x LDN
  float* sX = sB + TQ * LDN;      // TQ x LDP
  float* sM = sX + TQ * LDP;      // TQ x LDQ: masked, decayed C B^T
  float* sH = sM + TQ * LDQ;      // PMAX x LDN: the state, rows c, columns n
  float* sCum = sH + PMAX * LDN;  // TQ
  float* sDt = sCum + TQ;         // TQ
  float* sW = sDt + TQ;           // TQ

  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int gi = hi / (p.h / p.g);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float a = p.A[hi];

  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb + hi * p.x_sh;
  const float* dt = p.dt + bi * p.dt_sb + hi * p.dt_sh;
  const T* Bg = static_cast<const T*>(p.B) + bi * p.B_sb + gi * p.B_sg;
  const T* Cg = static_cast<const T*>(p.C) + bi * p.C_sb + gi * p.C_sg;
  T* y = static_cast<T*>(p.y);

  // Rows >= p and columns >= n of the state stay zero throughout: their x
  // columns and B columns are zero-filled.
  for (int i = tid; i < PMAX * LDN; i += THREADS) sH[i] = 0.f;

  for (int t0 = 0; t0 < p.l; t0 += TQ) {
    __syncthreads();  // the previous tile's reads are done; sH is current
    load_tile<T, NMAX>(sC, Cg, t0, p.l, p.n, p.C_sl, p.C_sn);
    load_tile<T, NMAX>(sB, Bg, t0, p.l, p.n, p.B_sl, p.B_sn);
    load_tile<T, PMAX>(sX, x, t0, p.l, p.p, p.x_sl, p.x_sp);
    if (tid < TQ) sDt[tid] = t0 + tid < p.l ? dt[(t0 + tid) * p.dt_sl] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int i = 0; i < TQ; ++i) {
        c += sDt[i] * a;
        sCum[i] = c;
      }
    }
    __syncthreads();
    const float total = sCum[TQ - 1];
    if (tid < TQ) sW[tid] = expf(total - sCum[tid]) * sDt[tid];

    // y = exp(cum_i) (C H^T)_ic: rows ty + 16 i, columns tx + 16 j
    float acc[4][PC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < p.n; ++k) {
      float cv[4], hv[PC];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LDN + k];
#pragma unroll
      for (int j = 0; j < PC; ++j) hv[j] = sH[(tx + 16 * j) * LDN + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = expf(sCum[ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < PC; ++j) acc[i][j] *= e;
    }

    // M_ij = (C B^T)_ij exp(cum_i - cum_j) dt_j for j <= i, else 0
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int k = 0; k < p.n; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LDN + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * LDN + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          sM[r * LDQ + c] = c <= r ? s[i][j] * (expf(sCum[r] - sCum[c]) * sDt[c]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y += M X; write the rows inside the sequence
#pragma unroll 4
    for (int k = 0; k < TQ; ++k) {
      float mv[4], xv[PC];
#pragma unroll
      for (int i = 0; i < 4; ++i) mv[i] = sM[(ty + 16 * i) * LDQ + k];
#pragma unroll
      for (int j = 0; j < PC; ++j) xv[j] = sX[k * LDP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= p.l) continue;
      T* yrow = y + ((static_cast<long long>(bi) * p.l + t) * p.h + hi) * p.p;
#pragma unroll
      for (int j = 0; j < PC; ++j) {
        const int c = tx + 16 * j;
        if (c < p.p) yrow[c] = from_float<T>(acc[i][j]);
      }
    }

    // H = exp(total) H + (X w)^T B: state rows ty + 16 i, columns tx + 16 j.
    // Every thread read sH (C H^T) before the barrier above.
    {
      float hs[PC][NC];
#pragma unroll
      for (int i = 0; i < PC; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) hs[i][j] = 0.f;
#pragma unroll 2
      for (int k = 0; k < TQ; ++k) {
        const float w = sW[k];
        float xv[PC], bv[NC];
#pragma unroll
        for (int i = 0; i < PC; ++i) xv[i] = sX[k * LDP + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < NC; ++j) bv[j] = sB[k * LDN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PC; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) hs[i][j] = fmaf(xv[i], bv[j], hs[i][j]);
      }
      const float decay = expf(total);
#pragma unroll
      for (int i = 0; i < PC; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          float* h = &sH[(ty + 16 * i) * LDN + tx + 16 * j];
          *h = fmaf(decay, *h, hs[i][j]);
        }
    }
  }

  if (p.state != nullptr) {
    __syncthreads();
    float* out = p.state + (static_cast<long long>(bi) * p.h + hi) * p.p * p.n;
    for (int i = tid; i < p.p * p.n; i += THREADS) {
      out[i] = sH[(i / p.n) * LDN + i % p.n];
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats(PMAX) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.h, p.b);
  ssd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt and A are float32.
// Strides are in elements.  y is a contiguous (b, l, h, p) buffer and state,
// unless null, a contiguous fp32 (b, h, p, n) buffer, both allocated by the
// caller.  Returns the launch's cudaError_t (0 on success); nothing is
// synchronised or allocated.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    void* y, void* state, int dtype, int b, int l, int h, int g, int p, int n,
    long long x_sb, long long x_sl, long long x_sh, long long x_sp,
    long long dt_sb, long long dt_sl, long long dt_sh,
    long long B_sb, long long B_sl, long long B_sg, long long B_sn,
    long long C_sb, long long C_sl, long long C_sg, long long C_sn,
    void* stream) {
  Params prm{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C, y,
             static_cast<float*>(state), b, l, h, g, p, n,
             x_sb, x_sl, x_sh, x_sp, dt_sb, dt_sl, dt_sh,
             B_sb, B_sl, B_sg, B_sn, C_sb, C_sl, C_sg, C_sn};
  if (b < 1 || l < 1 || g < 1 || h % g != 0 || p < 1 || p > PMAX || n < 1 || n > NMAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch<__nv_bfloat16>(prm, s)
                  : dtype == 0 ? launch<float>(prm, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
