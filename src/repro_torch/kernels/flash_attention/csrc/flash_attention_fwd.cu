// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _fwd_kernel (entered through flash_attention_fwd, pallas_call at :182).
//
// Computes, per (batch b, query head h):
//   out = softmax(mask(softcap(scale * Q K^T))) V
// with Q and K of width d and V (and out) of width dv <= d (MLA's values are
// narrower than its keys), with GQA (K/V head = h / (H / Hk)), an fp32 online
// softmax (running max m, running sum l, accumulator acc; masked logits are
// the finite -1e30) and out = acc / max(l, 1e-30) per element, in the
// input's type.  The mask is causal AND (q - k < window), OR (k < prefix_len),
// and finally AND (k < sk).
//
// Bound on an H100 SXM: 2*(d + dv) FLOPs per admitted (q, k) pair against reading
// Q, K, V and writing O once.  At gemma2-9b prefill (d 256, S 4608) that is
// ~1k FLOPs per byte, far above the card's ~295 bf16 FLOPs per byte, so the
// kernel is bound by operations (989 TFLOP/s on the tensor cores).
//
// bf16 inputs run the tensor-core tile body of flash_tile.cuh, which the
// ring-attention step shares: both products on wgmma, K/V tiles copied by
// TMA two stages deep, one block of two warpgroups per
// (128-row query tile, h, b).  The grid runs heads fastest, so the query
// heads of one KV head run in neighbouring blocks and share K/V through L2,
// and causal query tiles run heaviest (last) first.  fp32 inputs keep the
// CUDA-core body below (64 x 64 fp32 tiles, 256 threads), since TF32 would
// not hold an fp32 result.  Both skip K tiles wholly past the causal
// diagonal (unless they hold prefix columns), wholly before the sliding
// window (idem) and wholly beyond sk, and never write the S x S scores to
// device memory.
//
// Deviation from the TPU kernel (ROADMAP C1): kernel.py:70-72 skips a K tile
// past the diagonal even when it holds prefix columns; here a tile is skipped
// only when it lies wholly past the diagonal AND at or after prefix_len.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tile.cuh"

namespace {

using flash_tile::bf16;

constexpr int BQ = 64;        // fp32 body: query rows per block
constexpr int BK = 64;        // fp32 body: key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads (fp32), two warpgroups (bf16)
static_assert(THREADS == flash_tile::THREADS, "one block size for both bodies");
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, sk, h, hk, d, dv;
  long long q_sb, q_ss, q_sh, q_sd;
  long long k_sb, k_ss, k_sh, k_sd;
  long long v_sb, v_ss, v_sh, v_sd;
  float scale;
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
  int prefix;     // < 0: none
  // bf16: the TMA maps of K and V, filled by the launch
  CUtensorMap tk, tv;
};

// Shared memory of one fp32 block, in floats.
constexpr int smem_floats(int hd) {
  return (BQ + 2 * BK) * (hd + 1) + BQ * (BK + 1) + 3 * BQ;
}

// Load rows [row0, row0 + rows) x [0, HD) of one head into a padded fp32
// tile, zero-filling rows >= n and columns >= d.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int rows,
                                          int n, int d, long long s_row, long long s_col) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < rows * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n && c < d) x = src[row * s_row + c * s_col];
    dst[r * LD + c] = x;
  }
}

// The CUDA-core body, for fp32 inputs.
template <int HD>
__device__ __forceinline__ void fp32_body(const Params& p, float* smem) {
  constexpr int LD = HD + 1;    // padded row stride of the Q/K/V tiles
  constexpr int LDS = BK + 1;   // padded row stride of the score tile
  constexpr int CPT = HD / 16;  // output columns per thread
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

  const float* q = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + bi * p.k_sb + kh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bi * p.v_sb + kh * p.v_sh;

  load_tile<HD>(sQ, q, q0, BQ, p.sq, p.d, p.q_ss, p.q_sd);
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
    load_tile<HD>(sK, k, k0, BK, p.sk, p.d, p.k_ss, p.k_sd);
    load_tile<HD>(sV, v, k0, BK, p.sk, p.dv, p.v_ss, p.v_sd);
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

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= p.sq) continue;
    // a division per element, as the TPU kernel and the ring's finalize do:
    // the ring of one then equals this kernel bit for bit
    const float l = fmaxf(sL[r], 1e-30f);
    float* orow = o + ((static_cast<long long>(bi) * p.sq + qp) * p.h + hi) * p.dv;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = tx + 16 * j;
      if (col < p.dv) orow[col] = acc[i][j] / l;
    }
  }
}

// The mask and skips of this kernel, for the tensor-core body.
struct FlashMask {
  float scale, softcap;
  int causal, window, prefix, sk;
  int q0, bk;        // the block's first query row; key rows per tile
  float inv_softcap;  // 1 / softcap, as the argument of tanh

  // wholly before the sliding window of every row of the block, and no
  // prefix column
  __device__ bool skip(int k0) const {
    return window > 0 && k0 + bk - 1 <= q0 - window && k0 >= (prefix > 0 ? prefix : 0);
  }
  template <int N>
  __device__ void values(float (&s)[N]) const {
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = softcap * tanhf(s[i] * scale * inv_softcap);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] *= scale;
    }
  }
  __device__ float masked(float x, int qp, int kp) const {
    bool ok = true;
    if (causal) ok = qp >= kp;
    if (window > 0) ok = ok && (qp - kp < window);
    if (prefix >= 0) ok = ok || (kp < prefix);
    ok = ok && (kp < sk);
    return ok ? x : NEG_INF;
  }
  // rows [r0, r1] x keys [k0, k1) all admitted
  __device__ bool full(int r0, int r1, int k0, int k1) const {
    if (k1 > sk) return false;
    if (k1 <= prefix) return true;
    return (!causal || k1 - 1 <= r0) && (window <= 0 || r1 - k0 < window);
  }
};

// The tensor-core body, for bf16 inputs: one block per (128-row query tile,
// h, b), heads fastest, query tiles last first.
template <int HD>
__device__ __forceinline__ void bf16_body(const Params& p, unsigned char* smem) {
  namespace ft = flash_tile;
  constexpr int BQ = ft::BQ;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int hi = blockIdx.x;
  const int bi = blockIdx.z;
  const int kh = hi / (p.h / p.hk);
  const bf16* q = static_cast<const bf16*>(p.q) + bi * p.q_sb + hi * p.q_sh;

  // K tiles at or beyond k_end are wholly past the diagonal and hold no
  // prefix column (causal), or lie beyond sk
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int prefix = p.prefix > 0 ? p.prefix : 0;
  const int k_end = p.causal ? min(p.sk, max(q_last + 1, prefix)) : p.sk;

  ft::State<HD> st;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) st.o[i] = 0.f;
  st.m[0] = st.m[1] = NEG_INF;
  st.l[0] = st.l[1] = 0.f;
  const FlashMask mask{p.scale, p.softcap, p.causal, p.window, p.prefix, p.sk, q0,
                       ft::Shape<HD>::BK, p.softcap > 0.f ? 1.f / p.softcap : 0.f};
  ft::fold_tiles<HD>(smem, st, mask, q, p.q_ss, p.sq, p.d, p.dv, &p.tk, &p.tv, kh, bi, q0,
                     k_end);

  bf16* o = static_cast<bf16*>(p.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + ft::frag_row(h);
    if (qp >= p.sq) continue;
    // a division per element, as the TPU kernel and the ring's finalize do:
    // the ring of one then equals this kernel bit for bit
    const float l = fmaxf(st.l[h], 1e-30f);
    bf16* orow = o + ((static_cast<long long>(bi) * p.sq + qp) * p.h + hi) * p.dv;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int i = 4 * j + 2 * h;  // columns frag_col(i) and the one after it
      const int col = ft::frag_col(i);
      if (col < p.dv) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(st.o[i] / l, st.o[i + 1] / l);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (sizeof(T) == 4) {
    fp32_body<HD>(p, reinterpret_cast<float*>(smem));
  } else {
    bf16_body<HD>(p, smem);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  Params pp = p;
  int smem;
  dim3 grid;
  if constexpr (sizeof(T) == 2) {
    constexpr int BK = flash_tile::Shape<HD>::BK;
    if (!flash_tile::make_tile_map(&pp.tk, p.k, p.d, p.sk, p.hk, p.b, p.k_ss, p.k_sh, p.k_sb, BK) ||
        !flash_tile::make_tile_map(&pp.tv, p.v, p.dv, p.sk, p.hk, p.b, p.v_ss, p.v_sh, p.v_sb,
                                   BK)) {
      return cudaErrorInvalidValue;
    }
    smem = flash_tile::Shape<HD>::SMEM_BYTES;
    grid = dim3(p.h, (p.sq + flash_tile::BQ - 1) / flash_tile::BQ, p.b);
  } else {
    smem = smem_floats(HD) * static_cast<int>(sizeof(float));
    grid = dim3((p.sq + BQ - 1) / BQ, p.h, p.b);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(pp);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch<float, 32>(p, stream);
  if (p.d <= 64) return launch<float, 64>(p, stream);
  if (p.d <= 128) return launch<float, 128>(p, stream);
  if (p.d <= 256) return launch<float, 256>(p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_bf16(const Params& p, cudaStream_t stream) {
  if (p.d <= 64) return launch<bf16, 64>(p, stream);
  if (p.d <= 128) return launch<bf16, 128>(p, stream);
  if (p.d <= 256) return launch<bf16, 256>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  The output is
// a contiguous (b, sq, h, dv) buffer that the caller allocated.  Returns the
// launch's cudaError_t (0 on success); nothing is synchronised or allocated.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int b, int sq, int sk, int h, int hk, int d, int dv,
    long long q_sb, long long q_ss, long long q_sh, long long q_sd,
    long long k_sb, long long k_ss, long long k_sh, long long k_sd,
    long long v_sb, long long v_ss, long long v_sh, long long v_sd,
    float scale, float softcap, int causal, int window, int prefix, void* stream) {
  Params p{q, k, v, o, b, sq, sk, h, hk, d, dv,
           q_sb, q_ss, q_sh, q_sd, k_sb, k_ss, k_sh, k_sd, v_sb, v_ss, v_sh, v_sd,
           scale, softcap, causal, window, prefix};
  if (b < 1 || sq < 1 || sk < 1 || hk < 1 || h % hk != 0 || d < 1 || d > 256 || dv < 1 ||
      dv > d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch_bf16(p, s)
                  : dtype == 0 ? dispatch_fp32(p, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
