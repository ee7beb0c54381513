// SAME 3x3x3 stride-1 convolution, forward, channels-last (B, D, H, W, C).
//
// Replaces the Pallas TPU kernel vdm4cdm_tpu/ops/pallas/conv3d.py::_fwd_kernel
// (reached through _conv_pallas_raw_packed): the same function of x, with
// circular or zero padding on all three spatial dims, f32 accumulation, the
// bias added in-kernel and, on request, the per-(batch, channel) sums
// (sum y, sum y^2) of the f32 output before it is cast (the GroupNorm
// statistics that the following norm would otherwise read y again for).
//
// Design: an implicit GEMM with M = output voxels, N = Cout, K = 27 * Cin.
// A block owns a 128-voxel run of the flattened (d, h, w) index and BN output
// channels; it walks K as (tap, 32-channel chunk) and stages each A tile
// (128 voxels x BK channels, gathered with wrap or zero index math) and each
// B tile (BN x BK weights) in shared memory with cp.async, two stages deep.
// Out-of-range taps and channel tails are zero-filled by the copy itself
// (src-size 0), so the inner loop has no branches. bf16 runs on the tensor
// cores through mma.sync m16n8k16 with f32 accumulators; f32 runs on plain
// FMAs so that its products stay in full f32.
//
// Bound on the H100: at the flagship widths the conv does 2 * 27 * Cin * Cout
// operations per voxel over (Cin + Cout) * 2 bytes, far above the card's
// ~295 operations per byte, so the tensor cores bound it. This first version
// uses mma.sync, not wgmma/TMA, and re-reads each input voxel from L2 once per
// tap; the shared-memory tiles keep those re-reads off device memory.
//
// The optional residual (same shape as the output) is added in f32 before the
// cast and before the sums. It carries the second half of a split pair conv
// (conv(concat(a, b), W) = conv(a, W_a) + conv(b, W_b)) and the ResBlock's
// skip connection, so neither needs a pass of its own.
//
// The sums are reduced per block in shared memory and then added to the
// (B, 2, Cout) f32 output with atomicAdd: their order changes from run to run,
// so two runs agree to f32 rounding of a sum over D*H*W terms, not bitwise.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int THREADS = 256;

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int VEC = 8, BK = 32; };
template <> struct Tile<float> { static constexpr int VEC = 4, BK = 16; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One output value's epilogue: bias and residual in f32, store, and the
// running per-column sums. Returns the f32 value (0 when out of range).
template <typename T>
__device__ __forceinline__ float finish(float v, long long m, int col, long long S, int Cout,
                                        long long obase, const float* bias, const T* res,
                                        T* out) {
  if (m >= S || col >= Cout) return 0.f;
  long long o = obase + m * Cout + col;
  if (bias) v += bias[col];
  if (res) v += to_f32(res[o]);
  out[o] = from_f32<T>(v);
  return v;
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
conv3d_k3s1_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                   const float* __restrict__ bias, const T* __restrict__ res,
                   T* __restrict__ out, float* __restrict__ sums, int D, int H, int W,
                   int Cin, int Cout, int circular, int zmode) {
  constexpr int VEC = Tile<T>::VEC, BK = Tile<T>::BK, LD = BK + VEC;
  static_assert(BK / VEC == 4, "four 16-byte vectors per tile row");
  __shared__ __align__(16) T As[2][BM][LD];
  __shared__ __align__(16) T Bs[2][BN][LD];
  __shared__ float s_sum[2][BN];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const long long S = (long long)D * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // input planes and the tap's plane offset of this z mode (see the top)
  const int zoff = zmode == 1 ? 1 : (zmode == 2 ? -1 : 0);
  const int Din = D + 2 * zoff;
  const T* xb = x + (long long)b * Din * H * W * Cin;
  const long long obase = (long long)b * S * Cout;

  for (int i = tid; i < 2 * BN; i += THREADS) (&s_sum[0][0])[i] = 0.f;

  // Each thread gathers two 16-byte vectors of every A tile: rows v / 4,
  // channel segment v % 4, for v = tid and tid + THREADS.
  int a_row[2], a_seg[2], a_d[2], a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = tid + i * THREADS;
    a_row[i] = v >> 2;
    a_seg[i] = v & 3;
    const long long m = m0 + a_row[i];
    a_ok[i] = m < S;
    const long long mm = a_ok[i] ? m : 0;
    a_w[i] = (int)(mm % W);
    a_h[i] = (int)((mm / W) % H);
    a_d[i] = (int)(mm / ((long long)W * H));
  }

  const int n_cc = (Cin + BK - 1) / BK;
  const int n_chunks = 27 * n_cc;

  auto load_chunk = [&](int kc, int stage) {
    const int tap = kc / n_cc;
    const int c0 = (kc - tap * n_cc) * BK;
    const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c0 + a_seg[i] * VEC;
      int sd = a_d[i] + kz - 1 + zoff, sh = a_h[i] + ky - 1, sw = a_w[i] + kx - 1;
      bool ok = a_ok[i] && c < Cin;
      if (circular) {
        if (zmode == 0) sd = wrap(sd, D);
        sh = wrap(sh, H);
        sw = wrap(sw, W);
      } else {
        ok = ok && sh >= 0 && sh < H && sw >= 0 && sw < W;
      }
      ok = ok && sd >= 0 && sd < Din;
      const T* src = ok ? xb + (((long long)sd * H + sh) * W + sw) * Cin + c : x;
      cp_async16(&As[stage][a_row[i]][a_seg[i] * VEC], src, ok);
    }
    for (int v = tid; v < BN * 4; v += THREADS) {
      const int n = v >> 2, seg = v & 3;
      const int c = c0 + seg * VEC;
      const bool ok = (n0 + n) < Cout && c < Cin;
      const T* src = ok ? wt + ((long long)tap * Cout + n0 + n) * Cin + c : wt;
      cp_async16(&Bs[stage][n][seg * VEC], src, ok);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;

  if constexpr (sizeof(T) == 2) {
    // ---- bf16: tensor cores, warps tiled WARPS_M x WARPS_N, 32 columns each
    constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
    constexpr int WM = BM / WARPS_M, MT = WM / 16, NT = 4;
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    load_chunk(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int st = kc & 1;
      if (kc + 1 < n_chunks) load_chunk(kc + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[MT][4], bf[NT][2];
        const int k = ks + t4 * 2;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = wm * WM + i * 16 + g;
          af[i][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][k]);
          af[i][1] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][k]);
          af[i][2] = *reinterpret_cast<const uint32_t*>(&As[st][r][k + 8]);
          af[i][3] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][k + 8]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wn * 32 + j * 8 + g;
          bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[st][n][k]);
          bf[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[st][n][k + 8]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
      }
      __syncthreads();
    }

    // epilogue: C fragment (row g / g + 8, columns t4 * 2, t4 * 2 + 1)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int lc = wn * 32 + j * 8 + t4 * 2;
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm * WM + i * 16 + g + h * 8;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = finish<T>(acc[i][j][h * 2 + e], m, n0 + lc + e, S, Cout, obase,
                                      bias, res, out);
            s1[e] += v;
            s2[e] += v * v;
          }
        }
      if (sums) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
            s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
          }
          if (g == 0) {
            atomicAdd(&s_sum[0][lc + e], s1[e]);
            atomicAdd(&s_sum[1][lc + e], s2[e]);
          }
        }
      }
    }
  } else {
    // ---- f32: FMAs, each thread a TM x 4 register tile (rows and columns
    // strided so that a warp's shared-memory reads broadcast)
    constexpr int TNT = BN / 4, TMT = THREADS / TNT, TM = BM / TMT;
    const int tn = tid % TNT, tm = tid / TNT;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    load_chunk(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int st = kc & 1;
      if (kc + 1 < n_chunks) load_chunk(kc + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], bv[4];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = to_f32(As[st][tm + i * TMT][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_f32(Bs[st][tn + j * TNT][k]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lc = tn + j * TNT;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float v = finish<T>(acc[i][j], m0 + tm + i * TMT, n0 + lc, S, Cout, obase, bias,
                                  res, out);
        s1 += v;
        s2 += v * v;
      }
      if (sums) {
        atomicAdd(&s_sum[0][lc], s1);
        atomicAdd(&s_sum[1][lc], s2);
      }
    }
  }

  if (sums) {
    __syncthreads();
    for (int i = tid; i < BN; i += THREADS) {
      if (n0 + i < Cout) {
        atomicAdd(&sums[((long long)b * 2 + 0) * Cout + n0 + i], s_sum[0][i]);
        atomicAdd(&sums[((long long)b * 2 + 1) * Cout + n0 + i], s_sum[1][i]);
      }
    }
  }
}

template <typename T, int BN>
void launch(const void* x, const void* wt, const float* bias, const void* res, void* out,
            float* sums, int B, int D, int H, int W, int Cin, int Cout, int circular,
            int zmode, cudaStream_t stream) {
  const long long S = (long long)D * H * W;
  dim3 grid((unsigned)((S + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN), (unsigned)B);
  conv3d_k3s1_kernel<T, BN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), bias, static_cast<const T*>(res),
      static_cast<T*>(out), sums, D, H, W, Cin, Cout, circular, zmode);
}

}  // namespace

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
  const bool narrow = Cout <= 32;
  if (zmode < 0 || zmode > 2 || (zmode == 2 && D < 3)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (narrow)
      launch<__nv_bfloat16, 32>(x, wt, bias, res, out, sums, B, D, H, W, Cin, Cout, circular,
                                zmode, st);
    else
      launch<__nv_bfloat16, 64>(x, wt, bias, res, out, sums, B, D, H, W, Cin, Cout, circular,
                                zmode, st);
  } else if (dtype == 0) {
    if (narrow)
      launch<float, 32>(x, wt, bias, res, out, sums, B, D, H, W, Cin, Cout, circular, zmode,
                        st);
    else
      launch<float, 64>(x, wt, bias, res, out, sums, B, D, H, W, Cin, Cout, circular, zmode,
                        st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
