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
// the recurrence for any chunk length, so the tile is the kernel's choice,
// and rows past the sequence's end are zero-filled with dt = 0, which
// leaves the state and cum unchanged.
//
// Bound on an H100 SXM: per (b, h) and 64-row tile, q(q+1)/2 (2n + 2p) +
// 4 q p n FLOPs against reading x, B, C, dt and writing y (and the state)
// once.  At mamba2-2.7b prefill (p 64, n 128, bf16) that is ~210 FLOPs per
// byte, under the card's ~295 bf16 FLOPs per byte: bound by bytes.  The
// chunks of one head are a chain, though, so what the card can do is set
// by how many chains run at once and how short one tile's step is.
//
// bf16 (the serving path), on the tensor cores.  The state is split over p:
// one block of one warpgroup (128 threads) per (p tile of PT = 16 columns,
// head, batch), so mamba2's b 2 x h 80 gives 4 x 160 = 640 blocks, not 160.
// Each block walks its head's tiles in order and recomputes C B^T, the mask
// and the cumsum, which every p tile of the head needs (a few GFLOP per
// prefill).  Per tile, all on wgmma (bf16 in, fp32 accumulate):
//   [S | Y] = C [B | H_in]^T      one m64n80k16 product, K = n: H_in's PT
//                                 bf16 rows sit under B's 64 in each panel
//   y   = exp(cum_i) Y + M X      M = S exp(seg) dt_j as bf16 A fragments
//                                 from S's registers (as flash's P), X^T
//                                 K-major, m64n16k16
//   H^T = exp(total) H^T + B^T [hi(Xw) | lo(Xw)]
//                                 m64n32k16 per 64 rows of n, B^T through the
//                                 transpose bit; the state lives in the
//                                 accumulator's registers all along
// Each chain of tiles is serial, so a tile's step is kept short.  Its
// inputs arrive by TMA, issued by one thread a tile ahead: B and x into a
// second stage, C once C B^T has read the first (per-thread cp.async copies
// cost a third of a step in issue stalls).  Rows past the sequence, columns
// past n and past p are the boxes' zero fill.  Warp 0 takes the next
// tile's cumsum (a warp scan) while the state product runs, and X^T and X w
// are built at the end of the step, so one proxy fence a tile covers every
// operand that threads write.  Inputs whose strides or bases TMA cannot
// take (16-byte rows) are loaded element by element into the same layouts:
// a second load path, slower, not a second kernel.  Shared memory is sized
// to the call's n (templates NS 64 and 128): 69 KB at NS 128, 41 KB at 64.
//
// Precision.  C, B and X are bf16 already, so S and M X's X are exact.  y
// rounds two fp32 operands to bf16 once each: M (after the mask and decay)
// and H_in for C H_in^T, each by at most 2^-8 of itself; since every decay
// factor is non-negative, y moves by at most 2^-8 ssd(|x|, dt, A, |B|, |C|)
// beyond fp32 rounding (chip_smoke.py adds that term to the bf16 y limit).
// The state may not round once: decode steps on from it.  X w is split into
// hi = bf16(Xw) and lo = bf16(Xw - hi), the two halves of one product's B
// operand, summed into two accumulators, so each term keeps 2^-16 of itself
// and the state stays at the fp32 limits.
//
// fp32 (the correctness path) keeps the CUDA cores and runs no wgmma: one
// block of 256 threads per (h, b), 4 x 4 (to 4 x 8) register micro-tiles
// over padded fp32 tiles in shared memory (C, B 64 x 129, x 64 x PMAX+1,
// the masked score tile 64 x 65, the state PMAX x 129: ~133 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../flash_attention/csrc/flash_tile.cuh"

namespace {

namespace ft = flash_tile;
using bf16 = __nv_bfloat16;

constexpr int TQ = 64;        // sequence rows per tile
constexpr int PMAX = 64;      // largest head dim p (mamba2 and zamba2: 64)
constexpr int NMAX = 128;     // largest state size n
constexpr int LDN = NMAX + 1; // padded row stride of the C, B and state tiles
constexpr int LDQ = TQ + 1;   // padded row stride of the score tile
constexpr int THREADS = 256;  // fp32 body: 16 x 16 threads
constexpr int PT = 16;        // bf16 body: state rows (y columns) per block
constexpr int TC_THREADS = 128;  // bf16 body: one warpgroup

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
  int copy16;  // bf16: x, B and C allow TMA boxes (16-byte aligned rows)
  // bf16 with copy16: the maps of C and B (64-column boxes, 128-byte
  // swizzle) and of x (PT-column boxes, no swizzle), 64 rows a box
  CUtensorMap tmC, tmB, tmX;
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

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void fp32_body(const Params& p, float* smem) {
  constexpr int PC = PMAX / 16;  // y columns / state rows per thread
  constexpr int NC = NMAX / 16;  // state columns per thread
  constexpr int LDP = PMAX + 1;  // padded row stride of the x tile
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int NS>
struct TcShape {
  static_assert(NS == 64 || NS == 128, "state size template");
  static constexpr int BROWS = TQ + PT;  // a B panel: TQ rows of B, then PT rows of H_in
  // swizzled operand tiles (64-column panels of 128-byte rows, as flash_tile)
  static constexpr int C_BYTES = TQ * NS * 2;      // the C tile: TQ rows x NS
  static constexpr int BH_BYTES = BROWS * NS * 2;  // a stage of B and H_in: BROWS rows x NS
  static constexpr int KT_BYTES = PT * TQ * 2;     // X^T, hi(X w), lo(X w): PT rows x TQ each
  // plain row-major buffers
  static constexpr int XS_BYTES = TQ * PT * 2;     // the block's x (or y) columns of a tile
  static constexpr int VEC_BYTES = TQ * 4;         // one vector of a tile
  static constexpr int C_OFF = 0;
  static constexpr int B_OFF = C_OFF + C_BYTES;    // + s BH_BYTES
  static constexpr int XT_OFF = B_OFF + 2 * BH_BYTES;
  static constexpr int XW_OFF = XT_OFF + KT_BYTES;  // hi rows 0 .. PT - 1, lo rows PT .. 2 PT - 1
  static constexpr int XS_OFF = XW_OFF + 2 * KT_BYTES;
  static constexpr int YS_OFF = XS_OFF + XS_BYTES;
  // per tile parity: cum, cum log2 e, cum log2 e - log2 dt, w
  static constexpr int VEC_OFF = YS_OFF + XS_BYTES;  // + (4 parity + k) VEC_BYTES
  static constexpr int BAR_OFF = VEC_OFF + 8 * VEC_BYTES;  // B/x stages 0, 1, then C
  // + 1 KB: the tiles start on a 1024-byte boundary, the swizzle's period
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + 3 * 8;
};

// 2^x by the special-function unit (relative error ~2^-22, flushes
// subnormal results to 0): for the masked score, which is rounded to bf16
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 bf16 matrices from the accumulator-shaped fragments of a warp
// (a[q]: this lane's pair of matrix q) to shared memory, transposed: lane L
// gives the address of row L % 8 of matrix L / 8, which receives that
// matrix's column L % 8.
__device__ __forceinline__ void stmatrix_trans(uint32_t addr, const uint32_t (&a)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

// wgmma, bf16 in, fp32 accumulate, B K-major from shared memory.
// wgmma80_ss: m64n80k16, A K-major from shared memory (S and C H_in^T in
// one product).  wgmma16_rs: m64n16k16, A from registers; accumulates.
// wgmma32_ss_mn: m64n32k16, A M-major from shared memory through the
// transpose bit (B^T); accumulates.
__device__ __forceinline__ void wgmma80_ss(float (&d)[40], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma32_ss_mn(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// Accumulator fragments (m64nN): element i of this thread lies at row
// 16 warp + lane / 4 + 8 half(i), column 8 (i / 4) + 2 (lane % 4) + i % 2.
__device__ __forceinline__ int frag_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// Element (r, c) of a swizzled bf16 tile of ROWS rows: its byte offset.
template <int ROWS>
__device__ __forceinline__ uint32_t elem(int r, int c) {
  return ft::swizzled<ROWS>(r, c >> 3) + 2 * (c & 7);
}

template <int NS>
__device__ __forceinline__ void bf16_body(const Params& p, unsigned char* smem) {
  using Sh = TcShape<NS>;
  constexpr int BROWS = Sh::BROWS;
  constexpr float LOG2E = 1.4426950408889634f;
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = smem + (base - raw);  // the same bytes, for plain loads and stores
  const uint32_t sC = base + Sh::C_OFF, sXT = base + Sh::XT_OFF, sXW = base + Sh::XW_OFF;
  const uint32_t sXS = base + Sh::XS_OFF, bars = base + Sh::BAR_OFF;
  auto sB = [&](int s) { return base + Sh::B_OFF + s * Sh::BH_BYTES; };
  bf16* xs = reinterpret_cast<bf16*>(gen + Sh::XS_OFF);
  bf16* ys = reinterpret_cast<bf16*>(gen + Sh::YS_OFF);
  // vector k (0 cum, 1 cum log2 e, 2 cum log2 e - log2 dt, 3 w) of parity s
  auto vec = [&](int s, int k) {
    return reinterpret_cast<float*>(gen + Sh::VEC_OFF + (4 * s + k) * Sh::VEC_BYTES);
  };

  const int c0 = blockIdx.x * PT;  // the block's first y column / state row
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int gi = hi / (p.h / p.g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cols = min(PT, p.p - c0);  // of the block's columns, those inside p
  const float a = p.A[hi];

  const bf16* x = static_cast<const bf16*>(p.x) + bi * p.x_sb + hi * p.x_sh + c0 * p.x_sp;
  const float* dt = p.dt + bi * p.dt_sb + hi * p.dt_sh;
  const bf16* Bg = static_cast<const bf16*>(p.B) + bi * p.B_sb + gi * p.B_sg;
  const bf16* Cg = static_cast<const bf16*>(p.C) + bi * p.C_sb + gi * p.C_sg;
  const int ntiles = (p.l + TQ - 1) / TQ;

  // Tile t's inputs, rows past l, columns past n and past p zero-filled.
  // With copy16, TMA boxes issued by one thread of warp 3 (warp 0 takes the
  // cumsums): B into rows 0 .. TQ - 1 of stage s's panels and the x columns
  // into their buffer, completing on stage s's barrier (tma_bx); C on the C
  // barrier (tma_c).  Otherwise element by element by every thread
  // (load_bx, load_c).
  auto tma_bx = [&](int t, int s) {
    const uint32_t bar = bars + 8 * s;
    ft::mbar_expect(bar, NS * TQ * 2 + TQ * PT * 2);  // out-of-bounds boxes count in full
#pragma unroll
    for (int panel = 0; panel < NS / 64; ++panel) {
      ft::tma_load(sB(s) + panel * BROWS * 128, &p.tmB, bar, 64 * panel, t * TQ, gi, bi);
    }
    ft::tma_load(sXS, &p.tmX, bar, c0, t * TQ, hi, bi);
  };
  auto tma_c = [&](int t) {
    const uint32_t bar = bars + 16;
    ft::mbar_expect(bar, NS * TQ * 2);
#pragma unroll
    for (int panel = 0; panel < NS / 64; ++panel) {
      ft::tma_load(sC + panel * TQ * 128, &p.tmC, bar, 64 * panel, t * TQ, gi, bi);
    }
  };
  auto load_bx = [&](int t, int s) {
    const int t0 = t * TQ;
    bf16* b_tile = reinterpret_cast<bf16*>(gen + (sB(s) - base));
    for (int i = tid; i < TQ * NS; i += TC_THREADS) {
      const int r = i / NS, c = i % NS, row = t0 + r;
      b_tile[elem<BROWS>(r, c) / 2] =
          row < p.l && c < p.n ? Bg[row * p.B_sl + c * p.B_sn] : __float2bfloat16(0.f);
    }
    for (int i = tid; i < TQ * PT; i += TC_THREADS) {
      const int r = i / PT, c = i % PT, row = t0 + r;
      xs[i] = row < p.l && c < cols ? x[row * p.x_sl + c * p.x_sp] : __float2bfloat16(0.f);
    }
  };
  auto load_c = [&](int t) {
    const int t0 = t * TQ;
    bf16* c_tile = reinterpret_cast<bf16*>(gen + (sC - base));
    for (int i = tid; i < TQ * NS; i += TC_THREADS) {
      const int r = i / NS, c = i % NS, row = t0 + r;
      c_tile[elem<TQ>(r, c) / 2] =
          row < p.l && c < p.n ? Cg[row * p.C_sl + c * p.C_sn] : __float2bfloat16(0.f);
    }
  };
  // dt of this lane's rows 2 lane and 2 lane + 1 of tile t (warp 0)
  auto load_dt = [&](int t, float (&d)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = t * TQ + 2 * lane + e;
      d[e] = row < p.l ? dt[row * p.dt_sl] : 0.f;
    }
  };
  // Warp 0: the tile's inclusive cumsum of dt A, a warp scan over pairs of
  // rows, into parity s's vectors: cum; cum log2 e; cum log2 e - log2 dt,
  // the masked score's exponent with dt folded in (a zero dt gives +inf
  // there, so the score is 0); w = exp(total - cum) dt.
  auto scan = [&](const float (&d)[2], int s) {
    const float v0 = d[0] * a, v1 = d[1] * a;
    float incl = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float cm[2] = {excl + v0, excl + v0 + v1};
    const float total = __shfl_sync(0xffffffffu, cm[1], 31);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * lane + e;
      vec(s, 0)[j] = cm[e];
      vec(s, 1)[j] = cm[e] * LOG2E;
      vec(s, 2)[j] = cm[e] * LOG2E - log2f(d[e]);
      vec(s, 3)[j] = expf(total - cm[e]) * d[e];
    }
  };
  // X^T, hi(X w) and lo(X w) of the tile whose x columns are in their
  // buffer and whose w is parity s's, as K-major tiles: column pp of rows
  // 2 jj and 2 jj + 1 per element pair
  auto build = [&](int s) {
    const float* w = vec(s, 3);
#pragma unroll
    for (int k = 0; k < PT * TQ / 2 / TC_THREADS; ++k) {
      const int i = tid + k * TC_THREADS, pp = i % PT, jj = i / PT;
      const float x0 = __bfloat162float(xs[2 * jj * PT + pp]);
      const float x1 = __bfloat162float(xs[(2 * jj + 1) * PT + pp]);
      const float v0 = x0 * w[2 * jj], v1 = x1 * w[2 * jj + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      const uint32_t off = elem<PT>(pp, 2 * jj);
      *reinterpret_cast<uint32_t*>(gen + Sh::XT_OFF + off) = ft::pack_bf16(x0, x1);
      *reinterpret_cast<__nv_bfloat162*>(gen + Sh::XW_OFF + off) = h;
      *reinterpret_cast<uint32_t*>(gen + Sh::XW_OFF + PT * 128 + off) =
          ft::pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
    }
  };

  // The state H^T (n x PT) as NS / 64 m64n32 accumulators: columns
  // 0 .. PT - 1 sum B^T hi(X w), columns PT .. 2 PT - 1 B^T lo(X w); both
  // decay alike, and H^T is their sum.  H_in of the first tile is zero.
  float hacc[NS / 64][16];
#pragma unroll
  for (int m = 0; m < NS / 64; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) hacc[m][i] = 0.f;
  for (int i = tid; i < NS / 64 * PT * 128 / 4; i += TC_THREADS) {
    const int panel = i / (PT * 32), w = i % (PT * 32);
    reinterpret_cast<uint32_t*>(gen + Sh::B_OFF + panel * BROWS * 128 + TQ * 128)[w] = 0u;
  }
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) ft::mbar_init(bars + 8 * i, 1);  // the loader's arrival, then bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile 0.  A tile's inputs and its cumsum, X^T and X w are in place before
  // its step; one proxy fence a tile then covers X^T, X w and H_in (the
  // thread-written operands) and waits for no copy in flight.
  float dn[2];
  const bool loader = tid == 96;
  if (p.copy16) {
    if (loader) {
      tma_bx(0, 0);
      tma_c(0);
    }
  } else {
    load_bx(0, 0);
    load_c(0);
  }
  if (warp == 0) {
    load_dt(0, dn);
    scan(dn, 0);
  }
  if (p.copy16) ft::mbar_wait(bars, 0);
  __syncthreads();  // tile 0's x columns and vectors are visible to every thread
  build(0);
  ft::fence_proxy_async();  // stores through the generic proxy, wgmma reads async
  __syncthreads();

  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  for (int t = 0; t < ntiles; ++t) {
    const int s = t & 1;
    const int t0 = t * TQ;
    const bool next = t + 1 < ntiles;
    // tile t + 1's B and x columns, in flight through this tile: stage
    // s ^ 1's B rows held tile t - 1, whose products are done, and the x
    // columns were read when tile t was built; its dt into warp 0's registers
    if (p.copy16 && next && loader) tma_bx(t + 1, s ^ 1);
    if (warp == 0 && next) load_dt(t + 1, dn);
    if (p.copy16) ft::mbar_wait(bars + 16, t & 1);  // C of tile t

    // [S | Y] = C [B | H_in]^T: one m64n80 product over NS / 16 slices of 16
    // state columns; S is elements 0 .. 31, C H_in^T elements 32 .. 39
    float sy[40];
    ft::fence_regs(sy);
    ft::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
      const uint32_t panel = kk >> 2, step = (kk & 3) * 32;  // 16 columns are 32 bytes
      wgmma80_ss(sy, ft::smem_desc(sC + panel * TQ * 128 + step, 1, 64),
                 ft::smem_desc(sB(s) + panel * BROWS * 128 + step, 1, 64), kk > 0);
    }
    ft::wgmma_commit();

    // while it runs: the exponents of this thread's 16 columns (slot c is
    // column group c / 2) and of its two rows, exp(cum) of its rows, the
    // tile's decay
    float ej[16];
    const float* cl2 = vec(s, 2);
#pragma unroll
    for (int c = 0; c < 16; ++c) ej[c] = cl2[frag_col(4 * (c >> 1) + (c & 1), lane)];
    const float er2[2] = {vec(s, 1)[r0], vec(s, 1)[r0 + 8]};
    const float er[2] = {exp2f(er2[0]), exp2f(er2[1])};
    const float decay = expf(vec(s, 0)[TQ - 1]);

    ft::wgmma_wait();
    ft::fence_regs(sy);
    __syncthreads();  // every warp's share of the product has read C
    if (p.copy16 && next && loader) tma_c(t + 1);

    // y = exp(cum_i) C H_in^T, then M = S exp(cum_i - cum_j) dt_j with the
    // exponent masked to -1e30 above the diagonal (exp gives 0 there), as
    // bf16 A fragments: slice kk of 16 columns is elements 8 kk .. 8 kk + 7
    float yacc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) yacc[i] = sy[32 + i] * er[frag_half(i)];
    uint32_t ma[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float m2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * kk + 2 * q + e;
          const int hf = frag_half(i);
          const float ex = frag_col(i, lane) <= r0 + 8 * hf ? er2[hf] - ej[2 * (i >> 2) + e]
                                                            : ft::NEG_INF;
          m2[e] = sy[i] * fast_exp2(ex);
        }
        ma[kk][q] = ft::pack_bf16(m2[0], m2[1]);
      }
    }
#pragma unroll
    for (int m = 0; m < NS / 64; ++m)
#pragma unroll
      for (int i = 0; i < 16; ++i) hacc[m][i] *= decay;

    // y += M X; H^T += B^T [hi(X w) | lo(X w)].  B^T is stage s's B rows
    // read M-major: rows m of H^T are B panel m, 16 sequence rows (2 KB) a
    // slice, 8-row groups 1 KB apart.
    ft::fence_regs(yacc);
    ft::fence_regs(ma);
#pragma unroll
    for (int m = 0; m < NS / 64; ++m) ft::fence_regs(hacc[m]);
    ft::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma16_rs(yacc, ma[kk], ft::smem_desc(sXT + kk * 32, 1, 64));
#pragma unroll
    for (int m = 0; m < NS / 64; ++m) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma32_ss_mn(hacc[m],
                      ft::smem_desc(sB(s) + m * BROWS * 128 + kk * 16 * 128, BROWS * 128 / 16, 64),
                      ft::smem_desc(sXW + kk * 32, 1, 64));
      }
    }
    ft::wgmma_commit();
    // while it runs, warp 0 takes the next tile's cumsum
    if (warp == 0 && next) scan(dn, s ^ 1);
    ft::wgmma_wait();
    ft::fence_regs(yacc);
    ft::fence_regs(ma);  // the A registers are read until the wait
#pragma unroll
    for (int m = 0; m < NS / 64; ++m) ft::fence_regs(hacc[m]);
    // y into its buffer (bf16 pairs), stored 16 bytes a thread below
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      *reinterpret_cast<uint32_t*>(ys + (r0 + 8 * frag_half(i)) * PT + frag_col(i, lane)) =
          ft::pack_bf16(yacc[i], yacc[i + 1]);
    }
    __syncthreads();  // every product of this tile is done: its buffers may be rewritten

    // the next tile's H_in: bf16 H^T, stored transposed (K-major, as H)
    // into rows TQ .. TQ + PT - 1 of stage s ^ 1's panels (its B fills the
    // others).  Per 64 rows of n, a warp's 16 x 16 share of H^T is four 8 x 8
    // matrices, matrix q = 2 (column group) + half, whose fragments are
    // accumulator elements 2 q and 2 q + 1; lane L names row L % 8 of matrix
    // L / 8 of the transposed store: H row 8 (q / 2) + L % 8, columns
    // 16 warp + 8 (q % 2) .. + 7 of panel m.
#pragma unroll
    for (int m = 0; m < NS / 64; ++m) {
      uint32_t hv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hv[q] = ft::pack_bf16(hacc[m][2 * q] + hacc[m][2 * q + 8],
                              hacc[m][2 * q + 1] + hacc[m][2 * q + 9]);
      }
      const int q = lane >> 3;
      stmatrix_trans(sB(s ^ 1) + elem<BROWS>(TQ + 8 * (q >> 1) + (lane & 7),
                                             64 * m + 16 * warp + 8 * (q & 1)), hv);
    }
    if (next) {
      if (p.copy16) {
        ft::mbar_wait(bars + 8 * (s ^ 1), ((t + 1) >> 1) & 1);
      } else {
        load_bx(t + 1, s ^ 1);
        load_c(t + 1);
        __syncthreads();  // tile t + 1's x columns are visible to every thread
      }
      build(s ^ 1);
    }
    ft::fence_proxy_async();
    __syncthreads();  // tile t + 1's operands and its H_in are in place

    // y: 16 bytes of a row a thread, the rows inside the sequence and the
    // block's columns inside p (after the fence, so it waits for no store)
    {
      const int r = tid / (PT / 8), c = 8 * (tid % (PT / 8)), row = t0 + r;
      if (r < TQ && row < p.l && c < cols) {
        bf16* yrow = static_cast<bf16*>(p.y) +
                     ((static_cast<long long>(bi) * p.l + row) * p.h + hi) * p.p + c0 + c;
        const bf16* src = ys + r * PT + c;
        if (c + 8 <= cols && p.p % 8 == 0) {
          *reinterpret_cast<uint4*>(yrow) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && c + k < cols; ++k) yrow[k] = src[k];
        }
      }
    }
  }

  if (p.state != nullptr) {
    float* out = p.state + (static_cast<long long>(bi) * p.h + hi) * p.p * p.n;
#pragma unroll
    for (int m = 0; m < NS / 64; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = frag_col(i, lane), row = 64 * m + r0 + 8 * frag_half(i);
        if (col < cols && row < p.n) {
          out[static_cast<long long>(c0 + col) * p.n + row] = hacc[m][i] + hacc[m][i + 8];
        }
      }
  }
}

template <typename T, int NS>
__global__ void __launch_bounds__(sizeof(T) == 4 ? THREADS : TC_THREADS)
    ssd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (sizeof(T) == 4) {
    fp32_body<T>(p, reinterpret_cast<float*>(smem));
  } else {
    bf16_body<NS>(p, smem);
  }
}

template <typename T, int NS>
void launch_config(dim3* grid, int* threads, int* smem, const Params& p) {
  if constexpr (sizeof(T) == 4) {
    *grid = dim3(p.h, p.b);
    *threads = THREADS;
    *smem = smem_floats(PMAX) * static_cast<int>(sizeof(float));
  } else {
    *grid = dim3((p.p + PT - 1) / PT, p.h, p.b);
    *threads = TC_THREADS;
    *smem = TcShape<NS>::SMEM_BYTES;
  }
}

template <typename T, int NS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  Params pp = p;
  if (sizeof(T) == 2 && p.copy16) {
    if (!ft::make_tile_map(&pp.tmC, p.C, p.n, p.l, p.g, p.b, p.C_sl, p.C_sg, p.C_sb, TQ) ||
        !ft::make_tile_map(&pp.tmB, p.B, p.n, p.l, p.g, p.b, p.B_sl, p.B_sg, p.B_sb, TQ) ||
        !ft::make_tile_map(&pp.tmX, p.x, p.p, p.l, p.h, p.b, p.x_sl, p.x_sh, p.x_sb, TQ, PT,
                           CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return cudaErrorInvalidValue;
    }
  }
  dim3 grid;
  int threads, smem;
  launch_config<T, NS>(&grid, &threads, &smem, p);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T, NS><<<grid, threads, smem, stream>>>(pp);
  return cudaGetLastError();
}

// p tile, threads, shared bytes and resident blocks per SM of one instantiation
template <typename T, int NS>
cudaError_t occupancy(int* out) {
  Params p{};
  p.p = PMAX;
  p.h = p.b = 1;
  dim3 grid;
  int threads, smem, blocks = 0;
  launch_config<T, NS>(&grid, &threads, &smem, p);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_kernel<T, NS>, threads, smem);
  }
  out[0] = sizeof(T) == 4 ? PMAX : PT;
  out[1] = threads;
  out[2] = smem;
  out[3] = blocks;
  return err;
}

bool copy16_ok(const void* ptr, long long s_inner, const long long (&strides)[3],
               const int (&sizes)[3]) {
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) != 0 || s_inner != 1) return false;
  for (int i = 0; i < 3; ++i) {
    if (sizes[i] > 1 && strides[i] % 8 != 0) return false;
  }
  return true;
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
  if (b < 1 || l < 1 || g < 1 || h % g != 0 || p < 1 || p > PMAX || n < 1 || n > NMAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool copy16 =
      copy16_ok(x, x_sp, {x_sb, x_sl, x_sh}, {b, l, h}) &&
      copy16_ok(B, B_sn, {B_sb, B_sl, B_sg}, {b, l, g}) &&
      copy16_ok(C, C_sn, {C_sb, C_sl, C_sg}, {b, l, g});
  Params prm{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C, y,
             static_cast<float*>(state), b, l, h, g, p, n,
             x_sb, x_sl, x_sh, x_sp, dt_sb, dt_sl, dt_sh,
             B_sb, B_sl, B_sg, B_sn, C_sb, C_sl, C_sg, C_sn, copy16 ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch<float, NMAX>(prm, s)
                  : dtype != 1 ? cudaErrorInvalidValue
                  : n <= 64    ? launch<bf16, 64>(prm, s)
                               : launch<bf16, 128>(prm, s);
  return static_cast<int>(err);
}

// The launch shape of the instantiation a call of this dtype and state size
// takes: out[0..3] = p tile (state rows per block), threads per block,
// dynamic shared bytes and resident blocks per SM (cudaOccupancy...).
// Returns the cudaError_t of the query.
extern "C" int ssd_scan_occupancy(int dtype, int n, void* out) {
  int* o = static_cast<int*>(out);
  cudaError_t err = dtype == 0 ? occupancy<float, NMAX>(o)
                  : dtype != 1 || n < 1 || n > NMAX ? cudaErrorInvalidValue
                  : n <= 64    ? occupancy<bf16, 64>(o)
                               : occupancy<bf16, 128>(o);
  return static_cast<int>(err);
}
