// Shared by conv3d_fwd.cu and conv3d_dw.cu: the output brick, its haloed
// input brick in shared memory, and the PTX wrappers (cp.async, ldmatrix,
// mma.sync, wgmma's fences and descriptors) of the bf16 tensor-core paths and
// the 3xTF32 split and mma.sync of the f32 paths.
//
// A brick is BD x BH x BW output voxels (d, h, w). Its input brick is one
// voxel larger on every side, HD x HH x HW voxels, staged once in shared
// memory: the tap (kz, ky, kx) of brick voxel (d, h, w) is halo voxel
// (d + kz, h + ky, w + kx), so a tap is only an offset into the staged brick.
//
// Rows in shared memory are one voxel's channels, VPR 16-byte vectors of 8
// bf16. ldmatrix reads 8 rows of 16 bytes at a time; with rows of 32 or 64
// bytes, rows 4 or 2 apart fall into the same banks. The vector index is
// therefore XOR-swizzled by the row index (swz): any 8 consecutive rows, which
// is what every ldmatrix here reads whatever the tap's shift, land in 8
// distinct 16-byte bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace brick {

constexpr int BD = 4, BH = 8, BW = 8;  // output brick
constexpr int M = BD * BH * BW;        // 256 voxels
constexpr int HD = BD + 2, HH = BH + 2, HW = BW + 2;
constexpr int NH = HD * HH * HW;  // 600 halo voxels
static_assert(BW == 8, "an ldmatrix row group is one brick row");

// byte offset of vector j of row v, rows of VPR vectors (VPR = 2 or 4)
template <int VPR>
__device__ __forceinline__ int swz(int v, int j) {
  static_assert(VPR == 2 || VPR == 4, "rows of 32 or 64 bytes");
  const int x = VPR == 2 ? (v >> 2) & 1 : (v >> 1) & 3;
  return v * (VPR * 16) + ((j ^ x) << 4);
}

__device__ __forceinline__ int halo_index(int d, int h, int w) { return (d * HH + h) * HW + w; }

// Which of an input row's coordinates s (one of -1 .. n when the output is
// in range) the brick may read: wrapped under circular padding, else
// inside [0, n); -1 when the row is not read (zero-filled).
__device__ __forceinline__ int in_plane(int s, int n, bool circular) {
  if (circular) {
    if (s < -1 || s > n) return -1;
    return s < 0 ? s + n : (s >= n ? s - n : s);
  }
  return (s >= 0 && s < n) ? s : -1;
}

// The input plane of halo plane s for output plane count D: zmode 0 wraps
// under circular padding like H and W; zmodes 1 and 2 (input of D + 2 and
// D - 2 planes, s already shifted by zoff) read planes [0, Din) only.
__device__ __forceinline__ int in_depth(int s, int D, int Din, bool circular, int zmode) {
  if (zmode == 0) return in_plane(s, D, circular);
  return (s >= 0 && s < Din) ? s : -1;
}

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Volatile without a "memory" clobber: the fragment loads keep their order
// against the other asm (cp.async waits, MMAs) and barriers, while the
// compiler may still move the address arithmetic around them.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- 3xTF32 (the f32 paths): f = hi + lo with hi = tf32(f) and lo =
// tf32(f - hi), both rounded to nearest, ties away (cvt.rna); f - hi is exact
// in f32, and hi + lo holds f to about 2^-22 of |f|. A product is taken as
// lo a * hi b + hi a * lo b + hi a * hi b (the small terms first), dropping
// lo a * lo b (2^-22 of it): f32 accuracy on the TF32 tensor cores.
__device__ __forceinline__ uint32_t tf32_rna(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}
__device__ __forceinline__ void split_tf32(float f, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}
// D += A (16 x 8, row) B (8 x 8, col), TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- wgmma (sm_90a) synchronisation and shared-memory descriptors
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes (cp.async lands them through the
// generic proxy) visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (multiples of 16), swizzle mode (0 none, 2 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int lbo, int sbo, int swizzle) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace brick
