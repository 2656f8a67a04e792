// Tensor-core building blocks shared by the bf16 attention kernels
// (axial_attention.cu, axial_attention_bwd.cu): the warp-level
// mma.sync.m16n8k16 bf16 -> fp32 product, ldmatrix loads of its operands
// from shared memory, cp.async copies, and the bf16 rotation of one rope
// element.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same
//     cols), a2 (row g, cols 8+2t, 9+2t), a3 (row g+8, cols 8+2t, 9+2t);
//   B (16 x 8): b0 (k rows 2t, 2t+1, col g), b1 (k rows 8+2t, 9+2t, col g);
//   C (16 x 8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
// Two C tiles side by side (16 x 16) are, rounded to bf16 and packed in
// pairs, exactly one A fragment: a score or probability tile feeds the next
// product from registers without a trip through shared memory.
//
// Every bf16 tile in shared memory has a row stride of (width + 8) elements,
// width a multiple of 16: the stride in 16-byte units is then odd, so the
// eight row addresses of an ldmatrix phase fall in eight different bank
// groups (no conflicts, no swizzle).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tcore {

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }
// Row stride (elements) of a padded bf16 tile of `width` columns.
__host__ __device__ constexpr int ld_bf16(int width) { return pad16(width) + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment of rows [0,16) x cols [k0, k0+16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int k0, int lane) {
  ldsm4(a, tile + (lane & 15) * ld + k0 + (lane >> 4) * 8);
}

// A fragment of the transpose: the tile is stored [k][m] and the fragment
// is rows m in [m0, m0+16) x k in [k0, k0+16).
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* tile,
                                         int ld, int k0, int m0, int lane) {
  ldsm4t(a, tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles (n0..n0+7 -> b[0], b[1]; n0+8.. -> b[2], b[3])
// over k in [k0, k0+16), from a tile stored [n][k] (k contiguous).
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int n0, int k0, int lane) {
  ldsm4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
               ((lane >> 3) & 1) * 8);
}

// The same two n-tiles from a tile stored [k][n] (n contiguous).
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int n0, int k0, int lane) {
  ldsm4t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of two side-by-side C tiles, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

__device__ __forceinline__ float bround(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [0, n_rows) x cols [col0, col0 + width) of a bf16 matrix (row
// stride `src_ld` elements, both multiples of 8) into dst (row stride ld),
// 16 bytes per cp.async; rows at or past `live_rows` become zeros.
__device__ __forceinline__ void copy_tile(bf16* dst, int ld, const bf16* src,
                                          size_t src_ld, int n_rows,
                                          int live_rows, int col0, int width,
                                          int tid, int nthreads) {
  const int chunks = width / 8;
  for (int idx = tid; idx < n_rows * chunks; idx += nthreads) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    bf16* d = dst + r * ld + c;
    if (r < live_rows)
      cp_async16(d, src + r * src_ld + col0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// Element e of row s of a rope half, rotated: rounds like the plain version
// in bf16, round(round(x*cos) + round(rot(x)*sin)), tables rounded first.
__device__ __forceinline__ float rot_elem(const bf16* rr, const float* cs,
                                          const float* sn, int s, int e,
                                          int Dr) {
  const int half = Dr / 2;
  const float x = __bfloat162float(rr[e]);
  const float xr = e < half ? -__bfloat162float(rr[e + half])
                            : __bfloat162float(rr[e - half]);
  const float cv = bround(cs[s * Dr + e]);
  const float sv = bround(sn[s * Dr + e]);
  return bround(bround(x * cv) + bround(xr * sv));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tcore
