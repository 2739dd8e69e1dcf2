// One ring-attention step for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ring_attention/kernel.py:
// _step_kernel (entered through ring_step_fwd, pallas_call at :179).
//
// Folds one KV shard into the online-softmax carry that travels across the
// ring's steps, per (batch b, query head h):
//   s = mask(scale * Q K^T)        masked logits are the finite -1e30
//   m' = max(m, rowmax(s));  p = exp(s - m');  c = exp(m - m')
//   l' = l * c + rowsum(p);  acc' = acc * c + p V
// with GQA (K/V head = h / (H / Hk)).  The carry (m, l: (b, h, sq, 1); acc:
// (b, h, sq, d), all fp32, acc unnormalised) is read from device memory
// before the first K tile and written back, in place, after the last:
// there is no division by l here, the ring divides once after its last
// step.  A column is admitted when k < kv_len and, causal, when
// q_offset + q >= k_offset + k.  The three scalars q_offset, k_offset and
// kv_len are read from an int32 device array, never passed from the host,
// so a step needs no host sync and one captured graph serves every step.
//
// Tile skipping: a K tile that lies wholly at or beyond kv_len, or (causal)
// wholly after the Q tile's last row in global positions, is not read and
// leaves the carry untouched (the predicate of kernel.py:88-92).  A
// non-skipped tile folds every one of its columns below sk, masked ones as
// exp(-1e30 - m'), exactly as the plain twin does; columns at or beyond sk
// (the tile's ragged edge) are not columns of the shard and fold nothing.
// So the carry equals the plain twin's wherever m is above -1e30 before the
// step; a row that is wholly masked so far differs only in the exp(0) terms
// of skipped tiles, which the first admitted column's correction zeroes.
//
// Bound on an H100 SXM: 4*d FLOPs per admitted (q, k) pair, against reading
// Q, K and V once and the fp32 carry in and out once.  At phi4-mini's ring
// of one (b 2, S 8192, h 24, d 128, causal) that is 8.25e11 FLOPs against
// ~0.5 GB: bound by operations (989 TFLOP/s on the tensor cores).
//
// What this first design does about it: the flash-attention body of this
// port (64 x 64 tiles in shared memory, every loaded element reused across
// a tile, the score matrix never written to device memory, skipped tiles
// never loaded) on the fp32 CUDA cores, not on the tensor cores, so it runs
// far from the bound: moving the two products onto wgmma is later work.
//
// Layout: one block of 256 threads per (64-row query tile, h, b).  Q, K and
// V are read in place through their four strides; the carry must be
// contiguous.  Shared memory holds the Q tile, one K and one V tile (fp32,
// rows padded by one word) and the 64 x 64 score tile: ~110 KB at d = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* m;
  float* l;
  float* acc;
  const int* info;  // q_offset, k_offset, kv_len
  int b, sq, sk, h, hk, d;
  long long q_sb, q_sh, q_ss, q_sd;
  long long k_sb, k_sh, k_ss, k_sd;
  long long v_sb, v_sh, v_ss, v_sd;
  float scale;
  int causal;
};

// -inf: the exp of a column past sk is exactly 0 whatever the running max
__device__ __forceinline__ float no_column() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Shared memory of one block, in floats.
constexpr int smem_floats(int hd) {
  return (BQ + 2 * BK) * (hd + 1) + BQ * (BK + 1) + 3 * BQ;
}

// Load rows [row0, row0 + rows) x [0, HD) of one head into a padded fp32
// tile, zero-filling rows >= n and columns >= d.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int rows,
                                          int n, int d, long long s_row, long long s_col) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < rows * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n && c < d) x = to_float(src[row * s_row + c * s_col]);
    dst[r * LD + c] = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) step_kernel(const Params p) {
  constexpr int LD = HD + 1;    // padded row stride of the Q/K/V tiles
  constexpr int LDS = BK + 1;   // padded row stride of the score tile
  constexpr int CPT = HD / 16;  // carry columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;
  float* sM = sS + BQ * LDS;  // running max per row
  float* sL = sM + BQ;        // running sum per row
  float* sC = sL + BQ;        // this tile's rescale factor per row

  const int q0 = blockIdx.x * BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int kh = hi / (p.h / p.hk);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q_off = p.info[0], k_off = p.info[1], kv_len = p.info[2];

  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + kh * p.v_sh;
  // the carry rows of this (b, h): contiguous (sq, 1) and (sq, d)
  const long long row_base = (static_cast<long long>(bi) * p.h + hi) * p.sq;
  float* m = p.m + row_base;
  float* l = p.l + row_base;
  float* acc_g = p.acc + row_base * p.d;

  // K tiles at or beyond k_end lie wholly at or beyond kv_len, or (causal)
  // wholly after this Q tile's last row; with none left, the carry stays
  // as it was and is not touched
  const int q_last = min(q0 + BQ, p.sq) - 1;
  int k_end = min(p.sk, kv_len);
  if (p.causal) k_end = min(k_end, q_off + q_last - k_off + 1);
  if (k_end <= 0) return;

  if (tid < BQ) {
    const int row = q0 + tid;
    sM[tid] = row < p.sq ? m[row] : NEG_INF;
    sL[tid] = row < p.sq ? l[row] : 0.f;
  }
  float acc[4][CPT];  // rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = tx + 16 * j;
      acc[i][j] = (row < p.sq && col < p.d) ? acc_g[static_cast<long long>(row) * p.d + col]
                                            : 0.f;
    }
  }
  load_tile<T, HD>(sQ, q, q0, BQ, p.sq, p.d, p.q_ss, p.q_sd);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sS are done
    load_tile<T, HD>(sK, k, k0, BK, p.sk, p.d, p.k_ss, p.k_sd);
    load_tile<T, HD>(sV, v, k0, BK, p.sk, p.d, p.v_ss, p.v_sd);
    __syncthreads();

    // S = Q K^T on a 4 x 4 micro-tile per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = sK[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

    // scale and mask: masked columns of the shard are -1e30, as in the
    // plain twin; columns past sk are no columns at all (-inf folds 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q_off + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int kl = k0 + col;
        bool ok = kl < kv_len;
        if (p.causal) ok = ok && (qp >= k_off + kl);
        float x = ok ? s[i][j] * p.scale : NEG_INF;
        if (kl >= p.sk) x = no_column();
        sS[r * LDS + col] = x;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring threads (one warp) share a row
    {
      const int r = tid >> 2, part = tid & 3;
      const float m_prev = sM[r];
      float mx = NEG_INF;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, sS[r * LDS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float e = expf(sS[r * LDS + c] - m_new);
        sS[r * LDS + c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every part has read m_prev before part 0 replaces it
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sS[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = sV[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

  if (tid < BQ && q0 + tid < p.sq) {
    m[q0 + tid] = sM[tid];
    l[q0 + tid] = sL[tid];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d) acc_g[static_cast<long long>(row) * p.d + col] = acc[i][j];
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats(HD) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      step_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, p.b);
  step_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32>(p, stream);
  if (p.d <= 64) return launch<T, 64>(p, stream);
  if (p.d <= 128) return launch<T, 128>(p, stream);
  if (p.d <= 256) return launch<T, 256>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of q, k, v: 0 = float32, 1 = bfloat16.  Strides are in elements, in
// the order (batch, head, sequence, feature).  m, l and acc are contiguous
// fp32 (b, h, sq, 1) / (b, h, sq, d) buffers, updated in place; info is an
// int32 device array (q_offset, k_offset, kv_len).  Returns the launch's
// cudaError_t (0 on success); nothing is synchronised or allocated.
extern "C" int ring_step_fwd(
    const void* q, const void* k, const void* v, float* m, float* l, float* acc,
    const int* info, int dtype, int b, int sq, int sk, int h, int hk, int d,
    long long q_sb, long long q_sh, long long q_ss, long long q_sd,
    long long k_sb, long long k_sh, long long k_ss, long long k_sd,
    long long v_sb, long long v_sh, long long v_ss, long long v_sd,
    float scale, int causal, void* stream) {
  Params p{q, k, v, m, l, acc, info, b, sq, sk, h, hk, d,
           q_sb, q_sh, q_ss, q_sd, k_sb, k_sh, k_ss, k_sd, v_sb, v_sh, v_ss, v_sd,
           scale, causal};
  if (b < 1 || sq < 1 || sk < 1 || hk < 1 || h % hk != 0 || d < 1 || d > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(p, s)
                  : dtype == 0 ? dispatch<float>(p, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
