// SAME 3x3x3 stride-1 convolution, forward, channels-last (B, D, H, W, C).
//
// Replaces the Pallas TPU kernel vdm4cdm_tpu/ops/pallas/conv3d.py::_fwd_kernel
// (reached through _conv_pallas_raw_packed): the same function of x, with
// circular or zero padding on all three spatial dims, f32 accumulation, the
// bias added in-kernel and, on request, the per-(batch, channel) sums
// (sum y, sum y^2) of the f32 output before it is cast (the GroupNorm
// statistics that the following norm would otherwise read y again for).
//
// Bound on the H100: 2 * 27 * Cin * Cout operations per voxel over
// (Cin + 2 Cout) * 2 bytes (x, the residual and y). At 32 -> 32 channels
// that is 290 operations a byte, at the card's balance point (989 TFLOP/s
// over 3.35 TB/s): about 0.48 ms for (4, 128^3, 32 -> 32) bf16 either way,
// and the tensor cores bound every wider site.
//
// Design of the bf16 path (conv3d_k3s1_bf16_kernel). The earlier version
// was an implicit GEMM over 128-voxel runs that gathered one tap's A tile
// from global memory per K chunk: every input voxel crossed L2 27 times per
// Cout tile, and weights were reloaded per chunk. Now the work is cut in
// output bricks (conv3d_brick.cuh: 4 x 8 x 8 voxels) x BN output channels
// (64 where Cout is a multiple of 64, else 32), a CTA of 4 warps a brick,
// warp w the 64 voxels of brick plane w:
//   - the CTA stages the brick's haloed input (6 x 10 x 10 voxels) once per
//     16-channel chunk with cp.async, the wrap / zero / halo-plane index
//     math done once per CTA into a table of row offsets, and all 27 taps
//     read their A fragments from that one staging by ldmatrix at shifted
//     row addresses (the swizzle keeps every shift conflict-free);
//   - the weights stream beside it one kz plane (9 taps x BN x 16) at a
//     time, double-buffered, so the loads of the next plane (and, with its
//     first plane, of the next chunk) are in flight under the plane's MMAs;
//     the small buffers let 3 CTAs (BN = 32) or 2 (BN = 64) share an SM,
//     whose other CTAs' MMAs hide one CTA's first loads and epilogue;
//   - the tensor cores: at BN = 32 each warp runs mma.sync m16n8k16 on its
//     64 voxels (A and B by ldmatrix); at BN = 64 the four warps' A
//     fragments make the m64 operand of wgmma m64n64k16 (A from registers:
//     the shifted gather rules out a shared-memory descriptor for it; B,
//     the weights, from shared memory in the canonical K-major layout), and
//     the halo rows a warp loads for one kx serve all three ky taps (5
//     ldmatrix.x4 instead of 12). Measured on the H100, each path is the
//     faster one at its width (wgmma 10% ahead at 64 channels, mma.sync 4%
//     at 32);
//   - the epilogue goes through shared memory: bias, the residual (staged
//     by cp.async beside the first chunk, 16-byte vectors) and the sums in
//     f32, the output written as 16-byte vectors, the sums reduced per CTA
//     and added with one atomicAdd per channel and CTA.
// Each input byte crosses L2 about 2.3 times (the halo) per Cout tile,
// instead of 27 times.
//
// The f32 path (conv3d_k3s1_f32_kernel) serves the parity checks only (the
// main path runs bf16): the earlier implicit GEMM on plain FMAs, so that its
// products stay in full f32.
//
// The optional residual (same shape as the output) is added in f32 before the
// cast and before the sums. It carries the second half of a split pair conv
// (conv(concat(a, b), W) = conv(a, W_a) + conv(b, W_b)) and the ResBlock's
// skip connection, so neither needs a pass of its own.
//
// The sums are added to the (B, 2, Cout) f32 output with atomicAdd: their
// order changes from run to run, so two runs agree to f32 rounding of a sum
// over D*H*W terms, not bitwise.
//
// z modes. zmode 0 is the SAME conv above (the input has the output's D
// planes, z wraps or zero-fills like H and W). The spatially sharded path
// (vdm4cdm_torch/parallel) splits D over ranks and exchanges one halo plane
// on each side before the conv, so it needs two more entries, both with H and
// W gathered exactly as in zmode 0:
//   zmode 1 (halo): the input has D + 2 planes, the first and last being the
//     neighbours' halo planes, and the output has D: output plane d reads
//     input planes d .. d + 2, valid in z, never wrapped or zero-filled
//     (replaces _fwd_kernel under zmode="halo", conv3d.py:339, reached through
//     conv3d_pallas_zhalo and its packed entries). The sums are the slab's
//     own; the GroupNorm that takes them all-reduces them over the ranks.
//   zmode 2 (full): the input has D - 2 planes and the output D: output plane
//     p reads input planes p - 2 .. p, zero outside. With flipped, transposed
//     weights this is the input gradient of zmode 1 (the transpose of valid
//     in z is full in z), computed without writing a zero-padded copy of the
//     output gradient as the TPU package's _bwd_zh does.
// Only the row gather changes: Din = D + 2 (zmode 1) or D - 2 (zmode 2) is the
// input's plane count, the tap's input plane is d + kz - 1 + zoff with zoff =
// 1 or -1, and a plane outside [0, Din) is zero-filled by the copy.
//
// The launch plan (tile, grid, threads, shared memory) is exported as
// conv3d_k3s1_fwd_plan and mirrored by ops/kernels/conv3d.py::fwd_plan.

#include "conv3d_brick.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16 path

// ---- wgmma (sm_90a) m64n64k16: A (64 voxels x 16 channels) from the four
// warps' registers (warp w rows 16w .. 16w + 15, the mma.sync A fragment
// layout), B (64 x 16 weights) from shared memory through a descriptor, f32
// accumulators in the mma.sync C fragment layout (32 a thread).
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
constexpr int KC = 16;                     // input channels per chunk
constexpr int WARPS = brick::BD;           // warp w owns brick plane w
constexpr int THREADS = WARPS * 32;
constexpr int XS = brick::NH * KC * 2;     // haloed input chunk, bytes

// Shared memory of a CTA with BN output channels: two input chunks, two
// slices of weights (one kz plane: 9 taps x BN x KC), the row-offset table,
// the residual's brick; the f32 epilogue tile reuses the chunks and slices.
template <int BN> struct Fwd {
  static constexpr int WS_TAP = BN * KC * 2;       // one tap's weights
  static constexpr int WSL = 9 * WS_TAP;           // one kz plane's
  static constexpr int WBUF = 2 * XS;
  static constexpr int OFF = WBUF + 2 * WSL;
  static constexpr int RES = OFF + brick::NH * 4;
  static constexpr int SMEM = RES + brick::M * BN * 2;
  static constexpr int CLD = BN + 4;              // f32 epilogue row stride
  static constexpr int CTAS_PER_SM = BN == 32 ? 3 : 2;
  static_assert(brick::M * CLD * 4 + 2 * BN * 4 <= OFF, "epilogue fits in the buffers");
  static_assert(CTAS_PER_SM * (SMEM + 1024) <= 233472, "CTAs an SM fit its shared memory");
};
static_assert(brick::BH * brick::BW == 64, "a warp's plane is 4 m16 tiles");

template <int BN>
__global__ void __launch_bounds__(THREADS, Fwd<BN>::CTAS_PER_SM)
conv3d_k3s1_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        const float* __restrict__ bias, const bf16* __restrict__ res,
                        bf16* __restrict__ out, float* __restrict__ sums, int D, int H, int W,
                        int Cin, int Cout, int circular, int zmode, int nbh, int nbw,
                        int ntiles) {
  using namespace brick;
  using L = Fwd<BN>;
  constexpr bool WG = BN == 64;  // wgmma at 64 output channels, else mma.sync
  constexpr int NT = BN / 8;     // n8 tiles of a warp
  constexpr int CG = BN / 8;   // 16-byte channel groups of an output row
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int tile = blockIdx.x % ntiles, br = blockIdx.x / ntiles;
  const int d0 = br / (nbw * nbh) * BD, h0 = (br / nbw) % nbh * BH, w0 = br % nbw * BW;
  const int n0 = tile * BN;
  const int zoff = zmode == 1 ? 1 : (zmode == 2 ? -1 : 0);
  const int Din = D + 2 * zoff;
  const bool circ = circular != 0;
  const bf16* xb = x + (long long)b * Din * H * W * Cin;
  int* s_off = reinterpret_cast<int*>(smem + L::OFF);
  const uint32_t sbase = smem_u32(smem);

  // each halo voxel's input row (voxels, not channels) or -1 (zero-filled)
  for (int v = tid; v < NH; v += THREADS) {
    const int hd = v / (HH * HW), hh = v / HW % HH, hw = v % HW;
    const int sd = in_depth(d0 - 1 + hd + zoff, D, Din, circ, zmode);
    const int sh = in_plane(h0 - 1 + hh, H, circ);
    const int sw = in_plane(w0 - 1 + hw, W, circ);
    s_off[v] = (sd < 0 || sh < 0 || sw < 0) ? -1 : (sd * H + sh) * W + sw;
  }
  __syncthreads();

  // input chunk c (16 channels of the haloed brick) into buffer buf
  auto load_x = [&](int c, int buf) {
    const int c0 = c * KC;
    const uint32_t xs = sbase + buf * XS;
    for (int e = tid; e < NH * 2; e += THREADS) {
      const int v = e >> 1, j = e & 1, ch = c0 + 8 * j;
      const int off = s_off[v];
      const bool ok = off >= 0 && ch < Cin;
      cp_async16(xs + swz<2>(v, j), ok ? xb + (long long)off * Cin + ch : x, ok);
    }
  };
  // the weights of chunk c for the 9 taps of plane kz into slice buf
  auto load_w = [&](int c, int kz, int buf) {
    const int c0 = c * KC;
    const uint32_t ws = sbase + L::WBUF + buf * L::WSL;
    for (int e = tid; e < 9 * BN * 2; e += THREADS) {
      const int t9 = e / (BN * 2), n = (e >> 1) % BN, j = e & 1, ch = c0 + 8 * j;
      const bool ok = n0 + n < Cout && ch < Cin;
      const long long row = (long long)(kz * 9 + t9) * Cout + n0 + n;
      // wgmma: the canonical K-major layout; mma.sync: swizzled rows
      const int at = WG ? ((n >> 3) * 2 + j) * 128 + (n & 7) * 16 : swz<2>(n, j);
      cp_async16(ws + t9 * L::WS_TAP + at, ok ? wt + row * Cin + ch : wt, ok);
    }
  };

  // ldmatrix rows: lane l addresses row l % 8 of matrix l / 8. A (voxels x
  // channels) m16 tile i of this warp is brick rows 2i, 2i + 1 of plane
  // `warp`; matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
  // 8-15). B (channels out x in, stored n-major) pairs n8 tiles 2p, 2p + 1:
  // matrices (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15).
  const int q = lane >> 3, r = lane & 7;
  int a_hv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a_hv[i] = halo_index(warp, 2 * i + (q & 1), r);
  const int a_j = q >> 1, b_n = r + (q >> 1) * 8, b_j = q & 1;

  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the residual's brick comes in with the first chunk, so that the
  // epilogue waits on no global load
  if (res) {
    for (int e = tid; e < M * CG; e += THREADS) {
      const int m = e / CG, cg = e % CG;
      const int d = d0 + m / (BH * BW), h = h0 + m / BW % BH, w = w0 + m % BW;
      const bool ok = n0 + cg * 8 < Cout && d < D && h < H && w < W;
      const long long o = ((((long long)b * D + d) * H + h) * W + w) * Cout + n0 + cg * 8;
      cp_async16(sbase + L::RES + e * 16, ok ? res + o : res, ok);
    }
  }
  // steps s = 3 c + kz: input chunk c (loaded with kz = 0) against the
  // weights of plane kz; each step's loads are in flight under the last
  const int n_steps = 3 * cdiv(Cin, KC);
  load_x(0, 0);
  load_w(0, 0, 0);
  cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      const int c1 = (s + 1) / 3, kz1 = (s + 1) % 3;
      if (kz1 == 0) load_x(c1, c1 & 1);
      load_w(c1, kz1, (s + 1) & 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    if constexpr (WG) fence_proxy_async();
    __syncthreads();
    const int kz = s % 3;
    const uint32_t xs = sbase + (s / 3 & 1) * XS, ws = sbase + L::WBUF + (s & 1) * L::WSL;
    if constexpr (WG) {
      // For each kx, the 10 halo rows (w + kz, 0 .. 9) of columns kx ..
      // kx + 7 are loaded once (hr[h] = {channels 0-7, 8-15}); m16 tile i
      // under tap (kz, ky, kx) is halo rows 2i + ky (its rows 0-7) and
      // 2i + ky + 1 (rows 8-15), so the three ky taps share them: 5
      // ldmatrix.x4 per kx instead of 12. The 4 warps' fragments of tile i
      // make one m64 operand: 12 wgmma per kx, whose registers stay
      // untouched until they are done (two kx in flight).
      uint32_t hr[2][10][2];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int k = kx & 1;
#pragma unroll
        for (int hp = 0; hp < 5; ++hp) {
          uint32_t t[4];
          ldsm_x4(t, xs + swz<2>(halo_index(warp + kz, 2 * hp + (q & 1), r + kx), q >> 1));
          hr[k][2 * hp][0] = t[0];
          hr[k][2 * hp + 1][0] = t[1];
          hr[k][2 * hp][1] = t[2];
          hr[k][2 * hp + 1][1] = t[3];
        }
        wgmma_fence();
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          // K-major, no swizzle: core matrices of 8 rows x 16 bytes, the next
          // one in K 128 bytes on, the next 8 rows 256
          const uint64_t desc = smem_desc(ws + (ky * 3 + kx) * L::WS_TAP, 128, 256, 0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t afr[4] = {hr[k][2 * i + ky][0], hr[k][2 * i + ky + 1][0],
                                     hr[k][2 * i + ky][1], hr[k][2 * i + ky + 1][1]};
            wgmma_m64n64k16(&acc[i][0][0], afr, desc);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
    } else {
      // mma.sync, a warp's 64 voxels tap by tap
#pragma unroll
      for (int t9 = 0; t9 < 9; ++t9) {
        const int shift = halo_index(kz, t9 / 3, t9 % 3);
        uint32_t bfr[NT / 2][4];
#pragma unroll
        for (int p = 0; p < NT / 2; ++p)
          ldsm_x4(bfr[p], ws + t9 * L::WS_TAP + swz<2>(16 * p + b_n, b_j));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t afr[4];
          ldsm_x4(afr, xs + swz<2>(a_hv[i] + shift, a_j));
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            mma_bf16(acc[i][2 * p], afr, &bfr[p][0]);
            mma_bf16(acc[i][2 * p + 1], afr, &bfr[p][2]);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: the f32 tile through shared memory (C fragment: rows g,
  // g + 8 of m16 tile i, columns t4 * 2, t4 * 2 + 1 of n8 tile j)
  float* cs = reinterpret_cast<float*>(smem);
  float* s_sum = cs + M * L::CLD;
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = warp * 64 + (2 * i + h) * 8 + g;
          *reinterpret_cast<float2*>(&cs[m * L::CLD + j * 8 + t4 * 2]) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  }
  if (tid < 2 * BN) s_sum[tid] = 0.f;
  __syncthreads();

  // each thread: one 16-byte group of 8 channels (the same for all its
  // items, THREADS being a multiple of CG) of every (THREADS / CG)-th voxel
  const int cg = tid % CG, n = n0 + cg * 8;
  const bool col_ok = n < Cout;
  float bv[8], s1[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    bv[k] = (bias && col_ok) ? bias[n + k] : 0.f;
    s1[k] = s2[k] = 0.f;
  }
  for (int e = tid; e < M * CG; e += THREADS) {
    const int m = e / CG;
    const int d = d0 + m / (BH * BW), h = h0 + m / BW % BH, w = w0 + m % BW;
    if (!col_ok || d >= D || h >= H || w >= W) continue;
    const long long o = ((((long long)b * D + d) * H + h) * W + w) * Cout + n;
    const float4 lo = *reinterpret_cast<const float4*>(&cs[m * L::CLD + cg * 8]);
    const float4 hi = *reinterpret_cast<const float4*>(&cs[m * L::CLD + cg * 8 + 4]);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint4 rv = make_uint4(0u, 0u, 0u, 0u);
    if (res) rv = *reinterpret_cast<const uint4*>(smem + L::RES + e * 16);
    const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
    uint32_t ow[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float a = v[2 * k] + bv[2 * k], c = v[2 * k + 1] + bv[2 * k + 1];
      if (res) {
        const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rw[k]));
        a += rf.x;
        c += rf.y;
      }
      const __nv_bfloat162 pk = __floats2bfloat162_rn(a, c);
      ow[k] = *reinterpret_cast<const uint32_t*>(&pk);
      s1[2 * k] += a;
      s2[2 * k] += a * a;
      s1[2 * k + 1] += c;
      s2[2 * k + 1] += c * c;
    }
    *reinterpret_cast<uint4*>(out + o) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
  }
  if (sums) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int off = CG; off < 32; off <<= 1) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], off);
      }
    }
    if (lane < CG) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        atomicAdd(&s_sum[cg * 8 + k], s1[k]);
        atomicAdd(&s_sum[BN + cg * 8 + k], s2[k]);
      }
    }
    __syncthreads();
    if (tid < BN && n0 + tid < Cout) {
      atomicAdd(&sums[((long long)b * 2 + 0) * Cout + n0 + tid], s_sum[tid]);
      atomicAdd(&sums[((long long)b * 2 + 1) * Cout + n0 + tid], s_sum[BN + tid]);
    }
  }
}

template <int BN>
int launch_bf16(const void* x, const void* wt, const float* bias, const void* res, void* out,
                float* sums, int B, int D, int H, int W, int Cin, int Cout, int circular,
                int zmode, const dim3& grid, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3d_k3s1_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<BN>::SMEM);
  if (e != cudaSuccess) return (int)e;
  conv3d_k3s1_bf16_kernel<BN><<<grid, THREADS, Fwd<BN>::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), bias,
      static_cast<const bf16*>(res), static_cast<bf16*>(out), sums, D, H, W, Cin, Cout,
      circular, zmode, brick::cdiv(H, brick::BH), brick::cdiv(W, brick::BW),
      brick::cdiv(Cout, BN));
  return 0;
}

// ----------------------------------------------------------------- f32 path

constexpr int F_BM = 128, F_BK = 16, F_VEC = 4, F_THREADS = 256;

template <int FBN>
__global__ void __launch_bounds__(F_THREADS)
conv3d_k3s1_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                       const float* __restrict__ bias, const float* __restrict__ res,
                       float* __restrict__ out, float* __restrict__ sums, int D, int H, int W,
                       int Cin, int Cout, int circular, int zmode) {
  constexpr int LD = F_BK + F_VEC;
  static_assert(F_BK / F_VEC == 4, "four 16-byte vectors per tile row");
  __shared__ __align__(16) float As[2][F_BM][LD];
  __shared__ __align__(16) float Bs[2][FBN][LD];
  __shared__ float s_sum[2][FBN];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const long long S = (long long)D * H * W;
  const long long m0 = (long long)blockIdx.x * F_BM;
  const int n0 = blockIdx.y * FBN;
  const int zoff = zmode == 1 ? 1 : (zmode == 2 ? -1 : 0);
  const int Din = D + 2 * zoff;
  const float* xb = x + (long long)b * Din * H * W * Cin;
  const long long obase = (long long)b * S * Cout;

  for (int i = tid; i < 2 * FBN; i += F_THREADS) (&s_sum[0][0])[i] = 0.f;

  // Each thread gathers two 16-byte vectors of every A tile: rows v / 4,
  // channel segment v % 4, for v = tid and tid + F_THREADS.
  int a_row[2], a_seg[2], a_d[2], a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = tid + i * F_THREADS;
    a_row[i] = v >> 2;
    a_seg[i] = v & 3;
    const long long m = m0 + a_row[i];
    a_ok[i] = m < S;
    const long long mm = a_ok[i] ? m : 0;
    a_w[i] = (int)(mm % W);
    a_h[i] = (int)((mm / W) % H);
    a_d[i] = (int)(mm / ((long long)W * H));
  }

  const int n_cc = (Cin + F_BK - 1) / F_BK;
  const int n_chunks = 27 * n_cc;

  auto load_chunk = [&](int kc, int stage) {
    const int tap = kc / n_cc;
    const int c0 = (kc - tap * n_cc) * F_BK;
    const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c0 + a_seg[i] * F_VEC;
      const int sd = brick::in_depth(a_d[i] + kz - 1 + zoff, D, Din, circular, zmode);
      const int sh = brick::in_plane(a_h[i] + ky - 1, H, circular);
      const int sw = brick::in_plane(a_w[i] + kx - 1, W, circular);
      const bool ok = a_ok[i] && c < Cin && sd >= 0 && sh >= 0 && sw >= 0;
      const float* src = ok ? xb + (((long long)sd * H + sh) * W + sw) * Cin + c : x;
      brick::cp_async16(brick::smem_u32(&As[stage][a_row[i]][a_seg[i] * F_VEC]), src, ok);
    }
    for (int v = tid; v < FBN * 4; v += F_THREADS) {
      const int n = v >> 2, seg = v & 3;
      const int c = c0 + seg * F_VEC;
      const bool ok = (n0 + n) < Cout && c < Cin;
      const float* src = ok ? wt + ((long long)tap * Cout + n0 + n) * Cin + c : wt;
      brick::cp_async16(brick::smem_u32(&Bs[stage][n][seg * F_VEC]), src, ok);
    }
  };

  // each thread a TM x 4 register tile (rows and columns strided so that a
  // warp's shared-memory reads broadcast)
  constexpr int TNT = FBN / 4, TMT = F_THREADS / TNT, TM = F_BM / TMT;
  const int tn = tid % TNT, tm = tid / TNT;
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_chunk(0, 0);
  brick::cp_async_commit();
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < n_chunks) load_chunk(kc + 1, st ^ 1);
    brick::cp_async_commit();
    brick::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      float a[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[st][tm + i * TMT][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[st][tn + j * TNT][k];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int lc = tn + j * TNT, col = n0 + lc;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + tm + i * TMT;
      if (m >= S || col >= Cout) continue;
      const long long o = obase + m * Cout + col;
      float v = acc[i][j];
      if (bias) v += bias[col];
      if (res) v += res[o];
      out[o] = v;
      s1 += v;
      s2 += v * v;
    }
    if (sums) {
      atomicAdd(&s_sum[0][lc], s1);
      atomicAdd(&s_sum[1][lc], s2);
    }
  }

  if (sums) {
    __syncthreads();
    for (int i = tid; i < FBN; i += F_THREADS) {
      if (n0 + i < Cout) {
        atomicAdd(&sums[((long long)b * 2 + 0) * Cout + n0 + i], s_sum[0][i]);
        atomicAdd(&sums[((long long)b * 2 + 1) * Cout + n0 + i], s_sum[1][i]);
      }
    }
  }
}

// The launch plan: {kind (1 = bricks, 0 = runs of the flattened voxels),
// tile d, h, w (kind 0: 0, 0, run length), output channels per CTA, grid x,
// y, z, threads, dynamic shared-memory bytes}.
constexpr int PLAN_LEN = 10;

void make_plan(int dtype, int B, int D, int H, int W, int Cout, int* p) {
  if (dtype == 1) {
    const int nb = brick::cdiv(D, brick::BD) * brick::cdiv(H, brick::BH) *
                   brick::cdiv(W, brick::BW);
    const int bn = Cout % 64 == 0 ? 64 : 32;  // output channels per CTA
    const int v[PLAN_LEN] = {1, brick::BD, brick::BH, brick::BW, bn,
                             nb * brick::cdiv(Cout, bn), B, 1, THREADS,
                             bn == 64 ? Fwd<64>::SMEM : Fwd<32>::SMEM};
    for (int i = 0; i < PLAN_LEN; ++i) p[i] = v[i];
  } else {
    const long long S = (long long)D * H * W;
    const int fbn = Cout <= 32 ? 32 : 64;
    const int v[PLAN_LEN] = {0, 0, 0, F_BM, fbn, (int)((S + F_BM - 1) / F_BM),
                             brick::cdiv(Cout, fbn), B, F_THREADS, 0};
    for (int i = 0; i < PLAN_LEN; ++i) p[i] = v[i];
  }
}

}  // namespace

// The launch plan of conv3d_k3s1_fwd at these sizes (see make_plan), for
// the check against ops/kernels/conv3d.py::fwd_plan. Returns 0.
extern "C" int conv3d_k3s1_fwd_plan(int dtype, int B, int D, int H, int W, int Cout,
                                    int* plan) {
  make_plan(dtype, B, D, H, W, Cout, plan);
  return 0;
}

// x (B, Din, H, W, Cin) with Din = D, D + 2 or D - 2 for zmode 0, 1 or 2,
// wt (27, Cout, Cin) in the same dtype (0 = f32, 1 = bf16), bias (Cout) f32
// or null, res (B, D, H, W, Cout) or null, out (B, D, H, W, Cout), sums
// (B, 2, Cout) f32 zero-filled or null. Cin and Cout are multiples of 8;
// every pointer is 16-byte aligned. Returns cudaGetLastError() after the
// launch.
extern "C" int conv3d_k3s1_fwd(int dtype, const void* x, const void* wt, const float* bias,
                               const void* res, void* out, float* sums, int B, int D, int H,
                               int W, int Cin, int Cout, int circular, int zmode,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zmode < 0 || zmode > 2 || (zmode == 2 && D < 3)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  int p[PLAN_LEN];
  make_plan(dtype, B, D, H, W, Cout, p);
  const dim3 grid((unsigned)p[5], (unsigned)p[6], (unsigned)p[7]);
  if (dtype == 1) {
    const int err = p[4] == 64 ? launch_bf16<64>(x, wt, bias, res, out, sums, B, D, H, W, Cin,
                                                 Cout, circular, zmode, grid, st)
                               : launch_bf16<32>(x, wt, bias, res, out, sums, B, D, H, W, Cin,
                                                 Cout, circular, zmode, grid, st);
    if (err) return err;
  } else {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(wt);
    const float* rf = static_cast<const float*>(res);
    float* of = static_cast<float*>(out);
    if (p[4] == 32)
      conv3d_k3s1_f32_kernel<32><<<grid, F_THREADS, 0, st>>>(xf, wf, bias, rf, of, sums, D, H,
                                                             W, Cin, Cout, circular, zmode);
    else
      conv3d_k3s1_f32_kernel<64><<<grid, F_THREADS, 0, st>>>(xf, wf, bias, rf, of, sums, D, H,
                                                             W, Cin, Cout, circular, zmode);
  }
  return (int)cudaGetLastError();
}
