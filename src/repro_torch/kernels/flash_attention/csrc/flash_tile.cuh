// The flash-attention tile body on Hopper's tensor cores (sm_90a), shared by
// the flash-attention forward kernel (flash_attention_fwd.cu) and the
// ring-attention step (ring_attention/csrc/ring_step_fwd.cu), so a ring of
// one does the flash kernel's arithmetic in the flash kernel's order.
//
// For bf16 q, k, v.  One block of two warpgroups (256 threads) owns BQ = 128
// query rows of one (batch, head); each warpgroup owns 64 of them and folds
// key tiles of BK rows into an fp32 online-softmax state held in registers:
//   S = Q K^T          wgmma m64nBKk16, Q and K from shared memory
//   x = mask(logit(S)) per fragment element, from its (row, column)
//   m' = max(m, rowmax x);  p = exp(x - m');  c = exp(m - m')
//   l' = l c + rowsum p   (p in fp32)
//   O' = O c + bf16(p) V  wgmma m64nHDk16, P from registers, V from shared
//                          memory through the transpose bit
// The S accumulator's fragment is P's A-operand fragment, so P never goes
// through shared memory; a row of the fragment lies in a quad of threads, so
// its max and sum take two shuffles each.  P is rounded to bf16 once for
// the second product, as production flash kernels do: each p moves by at
// most 2^-8 p, so an output moves by at most 2^-8 (sum_k p_k |v_k|) / l
// beyond fp32 rounding.  Q and K are bf16, so every product of S is exact in
// fp32 and S differs from an fp32 reference only in the order of its sum.
// exp is exp2f of x log2(e) and a softcap's tanh the accurate tanhf: no
// tanh.approx, no fast math (an approximate tanh at softcap 50 moves a
// logit by ~0.02).
//
// Shared memory: the Q tile and two stages of K and V tiles, each stored as
// 64-column panels of 128-byte rows in the 128-byte swizzle that the wgmma
// descriptors name (16-byte chunk c of row r at chunk c ^ (r % 8)).  Q is
// copied by cp.async 16-byte copies, K and V by TMA boxes; both zero-fill
// past the last row and past column d, so padded head dimensions are exact.
// V may be narrower than Q and K (dv <= d, MLA's values): its columns past
// dv read as zeros and give output columns that are never stored.  A panel
// that lies wholly past K's d or V's dv is never copied: it is zeroed once
// in both stages before the first tile, so no TMA box starts out of bounds.
// The next key tile's copy is in flight while the current one is computed,
// and a key tile the caller's mask skips is never loaded.
//
// Tiles: HD in {64, 128, 256} (d <= HD), BK 128 up to HD 128 and 64 at
// HD 256.  At HD 256: Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tile {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;       // query rows per block, 64 per warpgroup
constexpr int THREADS = 256;  // two warpgroups
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Shape {
  static_assert(HD == 64 || HD == 128 || HD == 256, "head width template");
  static constexpr int BK = HD > 128 ? 64 : 128;  // key rows per tile
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;    // one K or one V tile
  static constexpr int STAGES = 2;
  // + 1 KB: the tiles start on a 1024-byte boundary, the swizzle's period;
  // then a full and an empty mbarrier per stage
  static constexpr int SMEM_BYTES = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + STAGES * 16;
};

// ---------------------------------------------------------------------------
// PTX building blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// an arrival that also expects `bytes` of asynchronous copies to land
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// TMA: one box of a 4-d tensor map to shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}
// a barrier of the 128 threads of one warpgroup
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across its issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

// Byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r in a tile of
// ROWS rows: 64-column panels of ROWS x 128 bytes, chunks swizzled by r % 8.
template <int ROWS>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Copy tile rows [r0, r0 + NR) x [0, HD) of a tile of ROWS rows whose row 0
// is row row0 of one head into the swizzled tile at shared address dst,
// spread over NT threads (this one is tid); rows >= n and columns >= d are
// zero-filled.  Row r of the head starts at src + r * s_row (16-byte
// aligned, checked by the wrapper), its columns are contiguous.
template <int HD, int ROWS, int NR, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, int row0, int r0,
                                          int n, int d, long long s_row, int tid) {
  constexpr int CH = HD / 8;
#pragma unroll 4
  for (int i = tid; i < NR * CH; i += NT) {
    const int r = r0 + i / CH, c = i % CH;
    const int row = row0 + r;
    const int left = d - 8 * c;
    int bytes = 0;
    const bf16* g = src;
    if (row < n && left > 0) {
      bytes = left >= 8 ? 16 : 2 * left;
      g = src + row * s_row + 8 * c;
    }
    cp_async16(dst + swizzled<ROWS>(r, c), g, bytes);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma, bf16 in, fp32 accumulate.  wgmma_ss: A and B from shared memory, both
// K-major (S = Q K^T).  wgmma_rs: A from registers, B from shared memory
// through the transpose bit (O += P V, V stored key-major); always accumulates.

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// Host: the TMA maps of K and V
// ---------------------------------------------------------------------------

// The map of a bf16 tensor of (batch, heads, rows) x d elements, strides in
// elements (columns contiguous): boxes of box_cols columns x box_rows rows of
// one head, 128-byte swizzled as the descriptors name it (or as `swizzle`
// says); reads past the last row or column fill zeros.  The encoder is
// fetched at run time (cudaGetDriverEntryPoint), so nothing links against
// it.  False when the map is refused.
inline bool make_tile_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
                          int batch, long long s_row, long long s_head, long long s_batch,
                          int box_rows, int box_cols = 64,
                          CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      fn = nullptr;
    }
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return false;
  // a dimension of length 1 is never stepped over: give it the extent so far
  const int n[3] = {rows, heads, batch};
  const long long st[3] = {s_row, s_head, s_batch};
  cuuint64_t strides[3];
  cuuint64_t extent = (2ull * d + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i) {
    strides[i] = n[i] > 1 ? 2ull * st[i] : extent;
    extent = strides[i] * n[i] > extent ? strides[i] * n[i] : extent;
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// The body
// ---------------------------------------------------------------------------

// The online-softmax state of one thread: rows (16 warp + lane / 4) and 8
// below it of its warpgroup's 64; o in the wgmma accumulator layout, element
// i at row + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
template <int HD>
struct State {
  float o[HD / 2];
  float m[2];
  float l[2];
};

// Column of fragment element i of this thread, and which of its two rows.
__device__ __forceinline__ int frag_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1); }
__device__ __forceinline__ int frag_half(int i) { return (i >> 1) & 1; }
// Row of half h of this thread within the block's BQ rows.
__device__ __forceinline__ int frag_row(int h) {
  const int t = threadIdx.x;
  return 64 * (t >> 7) + 16 * ((t >> 5) & 3) + ((t & 31) >> 2) + 8 * h;
}

// Fold key tiles into st for the block's query rows [q0, q0 + BQ) of one
// head.  Tiles start at 0 and step by BK up to k_end; a tile with
// mask.skip(k0) is neither loaded nor folded.  Mask supplies
//   skip(k0)                 the tile is wholly skipped (block-uniform);
//   full(r0, r1, k0, k1)     every (row, key) of the rows [r0, r1] and keys
//                            [k0, k1) is admitted (then no element is masked);
//   values(s)                the scaled, capped logits of a fragment, in place
//                            (its branches outside the loop over elements);
//   masked(x, row, key)      the logit x of element (row, key), masked.
// Rows and keys are the caller's local indices.  Q is read through q (row r
// at q + r q_ss); K and V through their TMA maps (make_tile_map with BK-row
// boxes, K's d columns wide and V's dv), at head kh of batch bi.  Must be
// called by all THREADS threads;
// smem holds Shape<HD>::SMEM_BYTES bytes.
//
// The two warpgroups run apart, so one's softmax overlaps the other's
// products: each copies and waits for its own 64 Q rows (cp.async), and the
// K/V stages are handed over through mbarriers, not block barriers.  One
// thread of warpgroup 1 is the loader: when its warpgroup has folded a
// tile and both have released its stage (the empty barrier), it refills the
// stage with the tile two ahead by TMA, landing on the stage's full
// barrier.  The loader's warpgroup so settles behind the other, which finds
// its next tile landed.
template <int HD, class Mask>
__device__ __forceinline__ void fold_tiles(unsigned char* smem, State<HD>& st, const Mask& mask,
                                           const bf16* q, long long q_ss, int sq, int d,
                                           int dv, const CUtensorMap* tk, const CUtensorMap* tv,
                                           int kh, int bi, int q0, int k_end) {
  using Sh = Shape<HD>;
  constexpr int BK = Sh::BK;
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sKV = sQ + Sh::Q_BYTES;  // stage s: K at + 2 s KV_BYTES, V after it
  const uint32_t full = sKV + Sh::STAGES * 2 * Sh::KV_BYTES;  // + 8 s
  const uint32_t empty = full + 8 * Sh::STAGES;               // + 8 s
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const bool loader = threadIdx.x == 128;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first row
  // 64-column panels that hold a column of K (of d) and of V (of dv)
  const int k_panels = (d + 63) / 64, v_panels = (dv + 63) / 64;

  auto next = [&](int k0) {
    k0 += BK;
    while (k0 < k_end && mask.skip(k0)) k0 += BK;
    return k0;
  };
  auto load_kv = [&](int k0, int stage) {  // by the loader thread
    const uint32_t dst = sKV + stage * 2 * Sh::KV_BYTES;
    const uint32_t bar = full + 8 * stage;
    // boxes partly out of bounds count in full
    mbar_expect(bar, static_cast<uint32_t>((k_panels + v_panels) * BK * 128));
#pragma unroll
    for (int panel = 0; panel < HD / 64; ++panel) {
      if (panel < k_panels) tma_load(dst + panel * BK * 128, tk, bar, 64 * panel, k0, kh, bi);
      if (panel < v_panels) {
        tma_load(dst + Sh::KV_BYTES + panel * BK * 128, tv, bar, 64 * panel, k0, kh, bi);
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < Sh::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);         // the loader's arrival, then the bytes
      mbar_init(empty + 8 * s, THREADS);  // every thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the panels no TMA box fills: zeros, read by wgmma through the async proxy
  if (k_panels < HD / 64 || v_panels < HD / 64) {
    constexpr int PANEL_WORDS = BK * 128 / 16;  // 16-byte words a panel
    for (int s = 0; s < Sh::STAGES; ++s) {
      for (int panel = 0; panel < HD / 64; ++panel) {
        for (int half = 0; half < 2; ++half) {  // K, then V
          if (panel < (half ? v_panels : k_panels)) continue;
          uint4* w = reinterpret_cast<uint4*>(
              smem + (sKV - raw) + s * 2 * Sh::KV_BYTES + half * Sh::KV_BYTES + panel * BK * 128);
          for (int i = threadIdx.x; i < PANEL_WORDS; i += THREADS) w[i] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    fence_proxy_async();
  }
  __syncthreads();

  int k0 = 0;
  while (k0 < k_end && mask.skip(k0)) k0 += BK;
  if (loader) {
    for (int s = 0, kt = k0; s < Sh::STAGES && kt < k_end; ++s, kt = next(kt)) load_kv(kt, s);
  }
  load_rows<HD, BQ, 64, 128>(sQ, q, q0, 64 * wg, sq, d, q_ss, tid);
  cp_commit();
  cp_wait<0>();
  fence_proxy_async();  // cp.async writes through the generic proxy, wgmma reads async
  warpgroup_sync(wg);

  for (int it = 0; k0 < k_end; ++it) {
    const int stage = it & 1;
    const uint32_t phase = (it >> 1) & 1;
    const uint32_t sK = sKV + stage * 2 * Sh::KV_BYTES;
    const uint32_t sV = sK + Sh::KV_BYTES;
    mbar_wait(full + 8 * stage, phase);

    // S = Q K^T over HD / 16 slices of 16 columns
    float s[BK / 2];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t panel = kk >> 2, step = (kk & 3) * 32;  // 16 columns are 32 bytes
      const uint64_t da = smem_desc(sQ + panel * BQ * 128 + wg * 64 * 128 + step, 1, 64);
      const uint64_t db = smem_desc(sK + panel * BK * 128 + step, 1, 64);
      wgmma_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // logits, masked where the tile is not wholly admitted, and the row max
    mask.values(s);
    if (!mask.full(r0, r0 + 63, k0, k0 + BK)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = mask.masked(s[i], q0 + frag_row(frag_half(i)), k0 + frag_col(i));
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[frag_half(i)] = fmaxf(mx[frag_half(i)], s[i]);
    // exp(x) as exp2(x log2 e): the product rounds once, a relative error
    // of |x| 2^-24 ln 2 in p
    constexpr float LOG2E = 1.4426950408889634f;
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(st.m[h], mx[h]);
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = exp2f((s[i] - mx[frag_half(i)]) * LOG2E);
      sum[frag_half(i)] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      corr[h] = exp2f((st.m[h] - mx[h]) * LOG2E);
      st.l[h] = st.l[h] * corr[h] + sum[h];
      st.m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) st.o[i] *= corr[frag_half(i)];

    // P as bf16 A fragments: slice kk of 16 keys is accumulator elements
    // 8 kk .. 8 kk + 7, in the A operand's register order
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O += P V over BK / 16 slices of 16 keys; V's 64-column panels are
    // BK x 128 bytes apart (the leading offset), its 8-key groups 1 KB
    fence_regs(st.o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs(st.o, pa[kk], smem_desc(sV + kk * 16 * 128, BK * 128 / 16, 64));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(st.o);
    fence_regs(pa);  // the A registers are read until the wait

    mbar_arrive(empty + 8 * stage);
    const int kn = next(k0);
    if (loader) {
      const int k2 = next(kn);
      if (k2 < k_end) {
        mbar_wait(empty + 8 * stage, phase);  // both warpgroups are done with it
        load_kv(k2, stage);
      }
    }
    k0 = kn;
  }
}

}  // namespace flash_tile
