// Weight and bias gradient of the SAME 3x3x3 stride-1 convolution,
// channels-last: dw[kz, ky, kx, ci, co] = sum over (b, d, h, w) of
// x[b, d + kz - 1, h + ky - 1, w + kx - 1, ci] * ct[b, d, h, w, co] with x
// read through circular or zero padding, and db[co] = sum of ct[..., co].
//
// Replaces the Pallas TPU kernel vdm4cdm_tpu/ops/pallas/conv3d.py::_dw_kernel
// (reached through _conv_pallas_dw): the same function of (x, ct), f32
// results, the bias gradient riding along.
//
// Design: a GEMM per tap with M = Cin, N = Cout and the voxels as the
// contraction (K = B * D * H * W, thousands to millions, against an output
// of at most 27 * 256 * 256 values). So K is split: a block owns one
// (tap, BM x BN tile of (ci, co)) and one run of consecutive voxels, walks
// the run in chunks of 32 voxels staged in shared memory with cp.async (two
// stages; x gathered with the forward's wrap or zero index math, out-of-range
// taps, channel tails and the run's end zero-filled by the copy itself), and
// adds its f32 tile to the zeroed output with atomicAdd. The order of those
// additions changes from run to run, so two runs agree to f32 rounding of a
// sum over K terms, not bitwise.
//
// zmode 1 (halo) is the weight gradient of the sharded path's valid-in-z conv
// (replaces _dw_kernel under zmode="halo", reached through
// _conv_pallas_dw(..., zmode="halo") from conv3d_pallas_zhalo's backward): x
// has D + 2 planes, the slab and its two exchanged halo planes, ct has D, and
// tap kz of output plane d reads x plane d + kz, never wrapped or
// zero-filled. H and W are gathered as in zmode 0. The sums are the slab's
// own; the train step averages every gradient over the ranks.
//
// Both operands lie voxel-major with channels contiguous, so K is the outer
// dimension of both shared-memory tiles. bf16 runs on the tensor cores
// through mma.sync m16n8k16 with f32 accumulators; its fragments want pairs
// along K, which ldmatrix.trans delivers from the K-major tiles. f32 runs on
// plain FMAs (a 4 x 4 register tile per thread) so that its products stay in
// full f32. The blocks of tap 0 and the first ci tile also sum their ct
// tiles' columns into db.
//
// Bound on the H100: 2 * 27 * Cin * Cout operations per voxel over
// (Cin + Cout) * 2 bytes, above the card's ~295 operations per byte from 32
// channels up, so the tensor cores bound it. This first version re-reads x
// and ct from L2 once per tap and tile (the shared-memory tiles keep those
// re-reads off device memory) and uses mma.sync, not wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;  // voxels per chunk

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

// Four 8x8 b16 matrices, each transposed on the way into the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int BM, int BN>
__global__ void __launch_bounds__((BM / 16) * (BN / 32) * 32)
conv3d_dw_kernel(const T* __restrict__ x, const T* __restrict__ ct, float* __restrict__ dw,
                 float* __restrict__ db, int B, int D, int H, int W, int Cin, int Cout,
                 int circular, int zmode, long long run) {
  constexpr int THREADS = (BM / 16) * (BN / 32) * 32;
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int SEGX = BM / VEC, SEGC = BN / VEC;
  constexpr int NX = BK * SEGX / THREADS, NC = BK * SEGC / THREADS;
  constexpr int LDX = BM + VEC, LDC = BN + VEC;
  static_assert(NX >= 1 && NC >= 1 && BK * SEGX % THREADS == 0 && BK * SEGC % THREADS == 0,
                "whole vectors per thread");
  __shared__ __align__(16) T Xs[2][BK][LDX];
  __shared__ __align__(16) T Cs[2][BK][LDC];

  const int tid = threadIdx.x;
  const long long S = (long long)D * H * W;
  const long long total = S * B;
  const int tiles_m = (Cin + BM - 1) / BM, tiles_n = (Cout + BN - 1) / BN;
  const int tile = blockIdx.y;
  const int tap = tile / (tiles_m * tiles_n);
  const int rem = tile - tap * tiles_m * tiles_n;
  const int ci0 = (rem / tiles_n) * BM, co0 = (rem % tiles_n) * BN;
  const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
  const long long v0 = (long long)blockIdx.x * run;
  const long long v1 = (v0 + run < total) ? v0 + run : total;
  if (v0 >= v1) return;
  const int n_chunks = (int)((v1 - v0 + BK - 1) / BK);
  const bool do_db = db != nullptr && tap == 0 && ci0 == 0;
  // x's planes: D, or D + 2 with the halo planes in zmode 1 (see the top)
  const int zoff = zmode == 1 ? 1 : 0;
  const int Dx = D + 2 * zoff;

  // Each thread gathers the same NX rows of every x tile; it keeps those
  // voxels' (b, d, h, w) and steps them by BK from chunk to chunk.
  long long xv[NX];
  int xb[NX], xd[NX], xh[NX], xw[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const int row = (tid + i * THREADS) / SEGX;
    xv[i] = v0 + row;
    const long long m = xv[i] % S;
    xb[i] = (int)(xv[i] / S);
    xw[i] = (int)(m % W);
    xh[i] = (int)((m / W) % H);
    xd[i] = (int)(m / ((long long)W * H));
  }

  // Chunks are loaded in order, so the x voxels advance inside the loader.
  auto load_chunk = [&](int kc, int stage) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / SEGX, seg = v % SEGX;
      const int c = ci0 + seg * VEC;
      int sd = xd[i] + kz - 1 + zoff, sh = xh[i] + ky - 1, sw = xw[i] + kx - 1;
      bool ok = xv[i] < v1 && c < Cin;
      if (circular) {
        if (zmode == 0) sd = wrap(sd, D);
        sh = wrap(sh, H);
        sw = wrap(sw, W);
      } else {
        ok = ok && sh >= 0 && sh < H && sw >= 0 && sw < W;
      }
      ok = ok && sd >= 0 && sd < Dx;
      const T* src =
          ok ? x + ((((long long)xb[i] * Dx + sd) * H + sh) * W + sw) * Cin + c : x;
      cp_async16(&Xs[stage][row][seg * VEC], src, ok);
      xv[i] += BK;
      xw[i] += BK;
      while (xw[i] >= W) {
        xw[i] -= W;
        if (++xh[i] == H) {
          xh[i] = 0;
          if (++xd[i] == D) {
            xd[i] = 0;
            ++xb[i];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / SEGC, seg = v % SEGC;
      const int c = co0 + seg * VEC;
      const long long vv = v0 + (long long)kc * BK + row;
      const bool ok = vv < v1 && c < Cout;
      const T* src = ok ? ct + vv * Cout + c : ct;
      cp_async16(&Cs[stage][row][seg * VEC], src, ok);
    }
  };

  float db_acc = 0.f;
  const int lane = tid & 31, warp = tid >> 5;

  if constexpr (sizeof(T) == 2) {
    // ---- bf16: each warp a 16 (ci) x 32 (co) tile on the tensor cores
    constexpr int WARPS_N = BN / 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int g = lane >> 2, t4 = lane & 3;
    // ldmatrix source rows: lane l addresses row l % 8 of matrix l / 8
    const int lr = lane & 7, lb3 = (lane >> 3) & 1, lb4 = (lane >> 4) & 1;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

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
        uint32_t af[4], bf[2][4];
        // A[m][k] = Xs[k][m]: matrices (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8)
        ldmatrix_x4_trans(af, &Xs[st][ks + lr + lb4 * 8][wm * 16 + lb3 * 8]);
        // B[k][n] = Cs[k][n]: matrices (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          ldmatrix_x4_trans(bf[q], &Cs[st][ks + lr + lb3 * 8][wn * 32 + q * 16 + lb4 * 8]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma_bf16(acc[2 * q], af, &bf[q][0]);
          mma_bf16(acc[2 * q + 1], af, &bf[q][2]);
        }
      }
      if (do_db && tid < BN) {
#pragma unroll 8
        for (int k = 0; k < BK; ++k) db_acc += to_f32(Cs[st][k][tid]);
      }
      __syncthreads();
    }

    // C fragment: rows g and g + 8, columns t4 * 2 and t4 * 2 + 1
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = ci0 + wm * 16 + g + (r >> 1) * 8;
        const int n = co0 + wn * 32 + j * 8 + t4 * 2 + (r & 1);
        if (m < Cin && n < Cout) atomicAdd(&dw[((long long)tap * Cin + m) * Cout + n], acc[j][r]);
      }
  } else {
    // ---- f32: FMAs, each thread a 4 (ci) x 4 (co) register tile
    constexpr int TNT = BN / 4;
    const int tn = tid % TNT, tm = tid / TNT;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
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
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&Xs[st][k][tm * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Cs[st][k][tn * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (do_db && tid < BN) {
#pragma unroll 8
        for (int k = 0; k < BK; ++k) db_acc += to_f32(Cs[st][k][tid]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = ci0 + tm * 4 + i, n = co0 + tn * 4 + j;
        if (m < Cin && n < Cout) atomicAdd(&dw[((long long)tap * Cin + m) * Cout + n], acc[i][j]);
      }
  }

  if (do_db && tid < BN && co0 + tid < Cout) atomicAdd(&db[co0 + tid], db_acc);
}

// Blocks aimed at per launch: enough to fill the card's 132 SMs several
// times over, few enough that a run stays long against its atomics.
constexpr int TARGET_BLOCKS = 2048;
constexpr int MIN_CHUNKS_PER_RUN = 8;

template <typename T, int BM, int BN>
void launch(const void* x, const void* ct, float* dw, float* db, int B, int D, int H, int W,
            int Cin, int Cout, int circular, int zmode, cudaStream_t stream) {
  const long long total = (long long)B * D * H * W;
  const long long chunks = (total + BK - 1) / BK;
  const int tiles = 27 * ((Cin + BM - 1) / BM) * ((Cout + BN - 1) / BN);
  long long splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  const long long most = chunks / MIN_CHUNKS_PER_RUN;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  const long long run = ((chunks + splits - 1) / splits) * BK;
  splits = (total + run - 1) / run;
  dim3 grid((unsigned)splits, (unsigned)tiles, 1);
  conv3d_dw_kernel<T, BM, BN><<<grid, (BM / 16) * (BN / 32) * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ct), dw, db, B, D, H, W, Cin, Cout,
      circular, zmode, run);
}

template <typename T>
void dispatch(const void* x, const void* ct, float* dw, float* db, int B, int D, int H, int W,
              int Cin, int Cout, int circular, int zmode, cudaStream_t st) {
  const bool wide_m = Cin >= 64, wide_n = Cout >= 64;
  if (wide_m && wide_n)
    launch<T, 64, 64>(x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
  else if (wide_m)
    launch<T, 64, 32>(x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
  else if (wide_n)
    launch<T, 32, 64>(x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
  else
    launch<T, 32, 32>(x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
}

}  // namespace

// x (B, Dx, H, W, Cin) with Dx = D (zmode 0) or D + 2 (zmode 1) and ct
// (B, D, H, W, Cout) in the same dtype (0 = f32, 1 = bf16); dw (27, Cin,
// Cout) f32 and db (Cout) f32 (or null), both zero-filled by the caller. Cin
// and Cout are multiples of 8; every pointer is 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int conv3d_k3s1_dw(int dtype, const void* x, const void* ct, float* dw, float* db,
                              int B, int D, int H, int W, int Cin, int Cout, int circular,
                              int zmode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zmode < 0 || zmode > 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    dispatch<__nv_bfloat16>(x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
  else if (dtype == 0)
    dispatch<float>(x, ct, dw, db, B, D, H, W, Cin, Cout, circular, zmode, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
