// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _fwd_kernel (entered through flash_attention_fwd, pallas_call at :182).
//
// Computes, per (batch b, query head h):
//   out = softmax(mask(softcap(scale * Q K^T))) V
// with GQA (K/V head = h / (H / Hk)), an fp32 online softmax (running max m,
// running sum l, accumulator acc; masked logits are the finite -1e30) and
// out = acc / max(l, 1e-30) in the input's type.  The mask is causal AND
// (q - k < window), OR (k < prefix_len), and finally AND (k < sk).
//
// Bound on an H100 SXM: 4*d FLOPs per admitted (q, k) pair against reading
// Q, K, V and writing O once.  At gemma2-9b prefill (d 256, S 4608) that is
// ~1k FLOPs per byte, far above the card's ~295 bf16 FLOPs per byte, so the
// kernel is bound by operations (989 TFLOP/s on the tensor cores).
//
// What this first design does about it: it reuses every loaded Q, K and V
// element across a 64 x 64 tile from shared memory and never writes the
// S x S score matrix to device memory; it skips K tiles wholly past the
// causal diagonal (unless they hold prefix columns), wholly before the
// sliding window (idem) and wholly beyond sk.  It computes on the fp32 CUDA
// cores, not on the tensor cores, so it runs far from the bound: moving the
// two products onto wgmma is the work of a later change.
//
// Layout: one block of 256 threads per (64-row query tile, h, b).  Q, K and V
// are read in place through their four strides, so (b, s, h, d) views need no
// transpose or padding; ragged edges are masked by bounds.  Shared memory
// holds the Q tile, one K and one V tile (fp32, rows padded by one word so
// column walks hit distinct banks) and the 64 x 64 score tile: ~210 KB at
// d = 256, above the default 48 KB, hence cudaFuncSetAttribute.
//
// Deviation from the TPU kernel (ROADMAP C1): kernel.py:70-72 skips a K tile
// past the diagonal even when it holds prefix columns; here a tile is skipped
// only when it lies wholly past the diagonal AND at or after prefix_len.

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
  void* o;
  int b, sq, sk, h, hk, d;
  long long q_sb, q_ss, q_sh, q_sd;
  long long k_sb, k_ss, k_sh, k_sd;
  long long v_sb, v_ss, v_sh, v_sd;
  float scale;
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
  int prefix;     // < 0: none
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
__global__ void __launch_bounds__(THREADS) fwd_kernel(const Params p) {
  constexpr int LD = HD + 1;    // padded row stride of the Q/K/V tiles
  constexpr int LDS = BK + 1;   // padded row stride of the score tile
  constexpr int CPT = HD / 16;  // output columns per thread
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

  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + kh * p.v_sh;

  load_tile<T, HD>(sQ, q, q0, BQ, p.sq, p.d, p.q_ss, p.q_sd);
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  float acc[4][CPT];  // rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // K tiles at or beyond k_end are wholly past the diagonal and hold no
  // prefix column (causal), or lie beyond sk.
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int prefix = p.prefix > 0 ? p.prefix : 0;
  const int k_end = p.causal ? min(p.sk, max(q_last + 1, prefix)) : p.sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // wholly before the sliding window of every row, and no prefix column
    if (p.window > 0 && k0 + BK - 1 <= q0 - p.window && k0 >= prefix) continue;

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

    // scale, softcap, mask
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int kp = k0 + col;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = true;
        if (p.causal) ok = qp >= kp;
        if (p.window > 0) ok = ok && (qp - kp < p.window);
        if (p.prefix >= 0) ok = ok || (kp < p.prefix);
        ok = ok && (kp < p.sk);
        sS[r * LDS + col] = ok ? x : NEG_INF;
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

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= p.sq) continue;
    // a division per element, as the TPU kernel and the ring's finalize do:
    // the ring of one then equals this kernel bit for bit
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = o + ((static_cast<long long>(bi) * p.sq + qp) * p.h + hi) * p.d;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d) orow[col] = from_float<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats(HD) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, p.b);
  fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  The output is
// a contiguous (b, sq, h, d) buffer that the caller allocated.  Returns the
// launch's cudaError_t (0 on success); nothing is synchronised or allocated.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int b, int sq, int sk, int h, int hk, int d,
    long long q_sb, long long q_ss, long long q_sh, long long q_sd,
    long long k_sb, long long k_ss, long long k_sh, long long k_sd,
    long long v_sb, long long v_ss, long long v_sh, long long v_sd,
    float scale, float softcap, int causal, int window, int prefix, void* stream) {
  Params p{q, k, v, o, b, sq, sk, h, hk, d,
           q_sb, q_ss, q_sh, q_sd, k_sb, k_ss, k_sh, k_sd, v_sb, v_ss, v_sh, v_sd,
           scale, softcap, causal, window, prefix};
  if (b < 1 || sq < 1 || sk < 1 || hk < 1 || h % hk != 0 || d < 1 || d > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(p, s)
                  : dtype == 0 ? dispatch<float>(p, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
