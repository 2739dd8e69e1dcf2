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
// bf16 inputs run the flash-attention kernel's tensor-core tile body
// (flash_attention/csrc/flash_tile.cuh): both products on wgmma, K/V tiles
// copied by TMA two stages deep, one block of two warpgroups per
// (128-row query tile, h, b), heads fastest (the query heads of one KV head
// in neighbouring blocks, sharing K/V through L2), causal query tiles
// heaviest first.  The body is the flash kernel's, so the ring of one does
// its arithmetic in its order, and the two agree bit for bit.  fp32 inputs
// keep the CUDA-core body below (64 x 64 fp32 tiles, 256 threads; ~110 KB
// of shared memory at d = 128).  Both read Q, K and V in place: fp32
// through any four strides, bf16 with contiguous rows on 16-byte
// boundaries (the wrapper checks); the carry must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../flash_attention/csrc/flash_tile.cuh"

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
  // bf16: the TMA maps of K and V, filled by the launch
  CUtensorMap tk, tv;
};

// -inf: the exp of a column past sk is exactly 0 whatever the running max
__device__ __forceinline__ float no_column() { return __int_as_float(0xff800000); }

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
  constexpr int CPT = HD / 16;  // carry columns per thread
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

  const float* q = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + bi * p.k_sb + kh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bi * p.v_sb + kh * p.v_sh;
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
  load_tile<HD>(sQ, q, q0, BQ, p.sq, p.d, p.q_ss, p.q_sd);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sS are done
    load_tile<HD>(sK, k, k0, BK, p.sk, p.d, p.k_ss, p.k_sd);
    load_tile<HD>(sV, v, k0, BK, p.sk, p.d, p.v_ss, p.v_sd);
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

// The masks of one step, for the tensor-core body: q and k are the
// shards' local indices.
struct RingMask {
  float scale;
  int causal, q_off, k_off, kv_len, sk;

  __device__ bool skip(int) const { return false; }
  template <int N>
  __device__ void values(float (&s)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= scale;
  }
  // masked columns of the shard are -1e30, as in the plain twin; columns
  // past sk are no columns at all (-inf folds 0)
  __device__ float masked(float x, int ql, int kl) const {
    bool ok = kl < kv_len;
    if (causal) ok = ok && (q_off + ql >= k_off + kl);
    if (!ok) x = NEG_INF;
    if (kl >= sk) x = no_column();
    return x;
  }
  // rows [r0, r1] x keys [k0, k1) all admitted
  __device__ bool full(int r0, int, int, int k1) const {
    return k1 <= kv_len && k1 <= sk && (!causal || q_off + r0 >= k_off + k1 - 1);
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
  const int q_off = p.info[0], k_off = p.info[1], kv_len = p.info[2];

  // K tiles at or beyond k_end lie wholly at or beyond kv_len, or (causal)
  // wholly after this Q tile's last row; with none left, the carry stays
  // as it was and is not touched
  const int q_last = min(q0 + BQ, p.sq) - 1;
  int k_end = min(p.sk, kv_len);
  if (p.causal) k_end = min(k_end, q_off + q_last - k_off + 1);
  if (k_end <= 0) return;

  const bf16* q = static_cast<const bf16*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const long long row_base = (static_cast<long long>(bi) * p.h + hi) * p.sq;
  float* m = p.m + row_base;
  float* l = p.l + row_base;
  float* acc = p.acc + row_base * p.d;

  ft::State<HD> st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + ft::frag_row(h);
    st.m[h] = row < p.sq ? m[row] : NEG_INF;
    st.l[h] = row < p.sq ? l[row] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    const int row = q0 + ft::frag_row(ft::frag_half(i)), col = ft::frag_col(i);
    st.o[i] = (row < p.sq && col < p.d) ? acc[static_cast<long long>(row) * p.d + col] : 0.f;
  }
  const RingMask mask{p.scale, p.causal, q_off, k_off, kv_len, p.sk};
  ft::fold_tiles<HD>(smem, st, mask, q, p.q_ss, p.sq, p.d, p.d, &p.tk, &p.tv, kh, bi, q0,
                     k_end);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + ft::frag_row(h);
    if (row < p.sq && (threadIdx.x & 3) == 0) {
      m[row] = st.m[h];
      l[row] = st.l[h];
    }
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    const int row = q0 + ft::frag_row(ft::frag_half(i)), col = ft::frag_col(i);
    if (row < p.sq && col < p.d) acc[static_cast<long long>(row) * p.d + col] = st.o[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) step_kernel(const __grid_constant__ Params p) {
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
        !flash_tile::make_tile_map(&pp.tv, p.v, p.d, p.sk, p.hk, p.b, p.v_ss, p.v_sh, p.v_sb, BK)) {
      return cudaErrorInvalidValue;
    }
    smem = flash_tile::Shape<HD>::SMEM_BYTES;
    grid = dim3(p.h, (p.sq + flash_tile::BQ - 1) / flash_tile::BQ, p.b);
  } else {
    smem = smem_floats(HD) * static_cast<int>(sizeof(float));
    grid = dim3((p.sq + BQ - 1) / BQ, p.h, p.b);
  }
  cudaError_t err = cudaFuncSetAttribute(
      step_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  step_kernel<T, HD><<<grid, THREADS, smem, stream>>>(pp);
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
  cudaError_t err = dtype == 1 ? dispatch_bf16(p, s)
                  : dtype == 0 ? dispatch_fp32(p, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
