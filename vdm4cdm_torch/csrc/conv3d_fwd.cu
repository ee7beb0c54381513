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
//     (each warp's into a slot of its own, the slots added in warp order)
//     into the CTA's row of the sums workspace (below).
// Each input byte crosses L2 about 2.3 times (the halo) per Cout tile,
// instead of 27 times.
//
// Design of the f32 path (conv3d_k3s1_f32_kernel), the forward and dx pass
// of the trained model (VDM_GRF_c_c_32: chs 16-64, f32). The same bricks, on
// the TF32 tensor cores with the 3xTF32 split of conv3d_brick.cuh: f = hi +
// lo, a product lo hi + hi lo + hi hi in f32, its error about 2^-21 (one TF32
// pass, 2^-11, would miss the parity checks' 1e-4). Bound: 3 x 2 x 27 Cin
// Cout operations a voxel at 495 TFLOP/s (7.4 times the 67 TFLOP/s of the
// FMA units), 0.92 ms for the 151.8 GFLOP of one blessed forward at (12,
// 32^3) against 2.27 ms on FMAs.
//   - a CTA is a brick x BN output channels, BN = 64, 48 or 32 where it
//     divides Cout, else 16: no thrown-away columns at Cout = 16 or 48; one
//     warpgroup, warp w the 64 voxels of brick plane w;
//   - per 8-channel chunk the haloed input comes in with cp.async (the next
//     chunk in flight under this one's 27 taps), is split once into hi and
//     lo in shared memory, and every tap reads it by ldmatrix.x4 at shifted
//     row addresses (one x4 gives a row's hi and lo fragments; the ten halo
//     rows of one (kz, kx) serve its three ky taps);
//   - the products are wgmma m64nBNk8.tf32, A from the four warps'
//     registers (the shifted gather rules out a descriptor for it), B, the
//     weights, from shared memory: split once a call
//     (conv3d_k3s1_f32_wsplit_kernel) and streamed three taps at a time,
//     three steps deep. (mma.sync m16n8k8 ran at about 150 TFLOP/s TF32 on
//     the H100 even with its shared-memory loads taken out.)
//   - where bricks x Cout tiles give fewer CTAs than the card has SMs (the
//     8^3 and 4^3 levels, 16^3 at small batches; Cout <= 1024), the K steps
//     (8-channel chunk x (kz, kx)) are split over CTAs; a second kernel adds
//     their partial sums in split order, then bias, residual and the sums:
//     y is the same bit for bit from run to run.
// An f32 call launches two kernels (the weight split and the conv), three
// where K is split; a call that takes the sums (either dtype) adds their
// fold; ops/kernels/conv3d.py counts them beside the calls.

// The optional residual (same shape as the output) is added in f32 before the
// cast and before the sums. It carries the second half of a split pair conv
// (conv(concat(a, b), W) = conv(a, W_a) + conv(b, W_b)) and the ResBlock's
// skip connection, so neither needs a pass of its own.
//
// The sums are folded in a fixed order, so they, like y, are the same bits
// from run to run. Each CTA of the conv (or of the K splits' reduce) writes
// its (sum y, sum y^2) per channel into row t of a workspace (B, T, 2, Cout)
// f32, t its spatial tile (its brick, or the reduce kernel's run of R_VOX
// voxels); inside the CTA each warp's partials go to a slot of its own and
// the slots are added in warp order. conv3d_k3s1_sums_fold_kernel then adds
// the T rows (make_fold_plan): CTA (column group, segment, b) takes a
// contiguous segment of the rows, its warp w a contiguous run of that
// segment in index order, each lane a float4 of 4 columns; the warps' totals
// are added in warp order; the last CTA of a (column group, b) to take a
// ticket adds the segments' partials in segment order, writes the (B, 2,
// Cout) result and resets its ticket for the next launch. No float atomics:
// the order of every addition is fixed by the shapes (and the card's SM
// count). The workspace, the segments' partials and the tickets (0 between
// launches) come from the wrapper, which keeps them per device and stream
// (ops/kernels/conv3d.py::sums_plan mirrors the plan and the order).
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

// The CTA's GroupNorm sums into its row of the workspace (B, T, 2, Cout):
// thread k * BN + c adds the NW warps' slots s_sum[(w * 2 + k) * BN + c] in
// warp order for channel n0 + c of tile row t.
template <int NW, int BN>
__device__ __forceinline__ void store_tile_sums(const float* s_sum, float* __restrict__ ws,
                                                int tid, int b, int t, int T, int n0, int Cout) {
  if (tid >= 2 * BN) return;
  const int k = tid / BN, c = tid % BN;
  if (n0 + c >= Cout) return;
  float v = s_sum[k * BN + c];
#pragma unroll
  for (int w = 1; w < NW; ++w) v += s_sum[(w * 2 + k) * BN + c];
  ws[(((long long)b * T + t) * 2 + k) * Cout + n0 + c] = v;
}

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
  static_assert(brick::M * CLD * 4 + WARPS * 2 * BN * 4 <= OFF, "epilogue fits in the buffers");
  static_assert(CTAS_PER_SM * (SMEM + 1024) <= 233472, "CTAs an SM fit its shared memory");
};
static_assert(brick::BH * brick::BW == 64, "a warp's plane is 4 m16 tiles");

template <int BN>
__global__ void __launch_bounds__(THREADS, Fwd<BN>::CTAS_PER_SM)
conv3d_k3s1_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        const float* __restrict__ bias, const bf16* __restrict__ res,
                        bf16* __restrict__ out, float* __restrict__ tsums, int D, int H, int W,
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
  float* s_sum = cs + M * L::CLD;  // WARPS x (sum y, sum y^2) x BN
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
  if (tsums) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int off = CG; off < 32; off <<= 1) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], off);
      }
    }
    if (lane < CG) {  // lane cg holds the warp's sums of its 8 channels
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s_sum[(warp * 2 + 0) * BN + cg * 8 + k] = s1[k];
        s_sum[(warp * 2 + 1) * BN + cg * 8 + k] = s2[k];
      }
    }
    __syncthreads();
    store_tile_sums<WARPS, BN>(s_sum, tsums, tid, b, br, gridDim.x / ntiles, n0, Cout);
  }
}

template <int BN>
int launch_bf16(const void* x, const void* wt, const float* bias, const void* res, void* out,
                float* tsums, int D, int H, int W, int Cin, int Cout, int circular, int zmode,
                const dim3& grid, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv3d_k3s1_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<BN>::SMEM);
  if (e != cudaSuccess) return (int)e;
  conv3d_k3s1_bf16_kernel<BN><<<grid, THREADS, Fwd<BN>::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), bias,
      static_cast<const bf16*>(res), static_cast<bf16*>(out), tsums, D, H, W, Cin, Cout,
      circular, zmode, brick::cdiv(H, brick::BH), brick::cdiv(W, brick::BW),
      brick::cdiv(Cout, BN));
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path

constexpr int F_KC = 8;                      // input channels a chunk: one k8 step
constexpr int F_RAW = brick::NH * F_KC * 4;  // the chunk as copied in (32-byte rows)
constexpr int F_HL = brick::NH * F_KC * 8;   // its hi and lo parts (64-byte rows)
constexpr int F_WSTAGES = 3;                 // steps of weights in shared memory

// Output channels a CTA: a tile that divides Cout where one of 64, 48, 32
// does, else 16 (the columns past Cout masked).
__host__ __device__ constexpr int f32_bn(int Cout) {
  return Cout % 64 == 0 ? 64 : (Cout % 48 == 0 ? 48 : (Cout % 32 == 0 ? 32 : 16));
}

// wgmma (sm_90a) m64nNk8, TF32: A (64 voxels x 8 channels) from the four
// warps' registers (warp w rows 16w .. 16w + 15, the mma.sync m16n8k8 A
// fragment layout), B (N x 8 weights, K-major) from shared memory through a
// descriptor, f32 accumulators in the mma.sync C fragment layout (N / 2 a
// thread).
template <int N>
__device__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<48>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A CTA of BN output channels: one warpgroup, warp w the 64 voxels of brick
// plane w (4 m16 tiles) x BN. Shared memory: the raw chunk, its hi / lo
// split (a voxel's row: hi of channels 0-3, 4-7, lo of 0-3, 4-7,
// swizzled), F_WSTAGES steps of weights, the row-offset table and the
// warps' column sums. A step is the three ky taps of one (kz, kx), a tap its
// hi, then its lo weights, each BN x 8 in wgmma's canonical K-major layout.
template <int BN> struct F32 {
  static constexpr int THREADS = WARPS * 32;
  static constexpr int NT = BN / 8;
  static constexpr int WBLK = BN * 32;  // one tap's hi or lo weights
  static constexpr int WTAP = 2 * WBLK;
  static constexpr int WSTEP = 3 * WTAP;
  static constexpr int HL = F_RAW;
  static constexpr int WB = HL + F_HL;
  static constexpr int OFF = WB + F_WSTAGES * WSTEP;
  static constexpr int SUM = OFF + brick::NH * 4;
  static constexpr int SMEM = SUM + WARPS * 2 * BN * 4;
  static constexpr int MINB = BN == 16 ? 3 : 2;  // CTAs an SM
  static_assert(NT * 8 == BN, "whole n8 tiles");
  static_assert(MINB * (SMEM + 1024) <= 233472, "CTAs an SM fit its shared memory");
};

// The weights (27, Cout, Cin) split once a call into ws (27, Cout, Cin / 8,
// 16): for each 8-channel chunk its hi parts, then its lo parts.
__global__ void conv3d_k3s1_f32_wsplit_kernel(const float* __restrict__ wt,
                                              float* __restrict__ ws, int n, int Cin) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ci = i % Cin;
  uint32_t hi, lo;
  brick::split_tf32(wt[i], hi, lo);
  const long long o = ((long long)(i / Cin) * (Cin / F_KC) + ci / F_KC) * 16 + ci % F_KC;
  ws[o] = __uint_as_float(hi);
  ws[o + 8] = __uint_as_float(lo);
}

// The conv over steps [s0, s1) of this CTA's K split (a step is one 8-channel
// chunk against one (kz, kx): its three ky taps). With one split the
// epilogue adds bias and residual and writes the CTA's GroupNorm sums to
// its row of the workspace tsums (B, bricks, 2, Cout); with more, the CTA
// writes its partial products to part[split] for
// conv3d_k3s1_f32_reduce_kernel.
template <int BN>
__global__ void __launch_bounds__(F32<BN>::THREADS, F32<BN>::MINB)
conv3d_k3s1_f32_kernel(const float* __restrict__ x, const float* __restrict__ ws,
                       const float* __restrict__ bias, const float* __restrict__ res,
                       float* __restrict__ out, float* __restrict__ part,
                       float* __restrict__ tsums, int D, int H, int W, int Cin, int Cout,
                       int circular, int zmode, int nbh, int nbw, int ntiles, int ksplit) {
  using namespace brick;
  using L = F32<BN>;
  constexpr int NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int split = blockIdx.x % ksplit, rest = blockIdx.x / ksplit;
  const int tile = rest % ntiles, br = rest / ntiles;
  const int d0 = br / (nbw * nbh) * BD, h0 = (br / nbw) % nbh * BH, w0 = br % nbw * BW;
  const int n0 = tile * BN;
  const int zoff = zmode == 1 ? 1 : (zmode == 2 ? -1 : 0);
  const int Din = D + 2 * zoff;
  const bool circ = circular != 0;
  const float* xb = x + (long long)b * Din * H * W * Cin;
  int* s_off = reinterpret_cast<int*>(smem + L::OFF);
  float* s_sum = reinterpret_cast<float*>(smem + L::SUM);
  const uint32_t sbase = smem_u32(smem);
  const int nck = Cin / F_KC;
  const int n_steps = 9 * nck;
  const int s0 = n_steps * split / ksplit, s1 = n_steps * (split + 1) / ksplit;

  for (int v = tid; v < NH; v += L::THREADS) {
    const int hd = v / (HH * HW), hh = v / HW % HH, hw = v % HW;
    const int sd = in_depth(d0 - 1 + hd + zoff, D, Din, circ, zmode);
    const int sh = in_plane(h0 - 1 + hh, H, circ);
    const int sw = in_plane(w0 - 1 + hw, W, circ);
    s_off[v] = (sd < 0 || sh < 0 || sw < 0) ? -1 : (sd * H + sh) * W + sw;
  }
  __syncthreads();

  // chunk c of the haloed brick, as it is, into the raw buffer
  auto load_x = [&](int c) {
    for (int e = tid; e < NH * 2; e += L::THREADS) {
      const int off = s_off[e >> 1];
      const bool ok = off >= 0;
      cp_async16(sbase + e * 16, ok ? xb + (long long)off * Cin + c * F_KC + 4 * (e & 1) : x, ok);
    }
  };
  // the split weights of step s's three taps into weight stage buf
  auto load_w = [&](int s, int buf) {
    const int c = s / 9, kz = s % 9 / 3, kx = s % 3;
    const uint32_t wsb = sbase + L::WB + buf * L::WSTEP;
    for (int e = tid; e < 3 * BN * 4; e += L::THREADS) {
      const int ky = e / (BN * 4), n = e / 4 % BN, j = e & 3;
      const bool ok = n0 + n < Cout;
      const long long row = (long long)((kz * 3 + ky) * 3 + kx) * Cout + n0 + n;
      const float* src = ok ? ws + (row * nck + c) * 16 + 4 * j : ws;
      // vector j: hi (j < 2) or lo of channels 4 (j % 2) ..; core matrices
      // of 8 rows x 16 bytes, the next in K 128 bytes on, the next 8 rows 256
      cp_async16(wsb + ky * L::WTAP + (j >> 1) * L::WBLK + ((n >> 3) * 2 + (j & 1)) * 128 +
                     (n & 7) * 16,
                 src, ok);
    }
  };
  // the raw chunk split once into hi and lo, for all 27 taps
  auto split_x = [&]() {
    for (int e = tid; e < NH * 2; e += L::THREADS) {
      const int v = e >> 1, j = e & 1;
      const float4 f = *reinterpret_cast<const float4*>(smem + e * 16);
      uint32_t hi[4], lo[4];
      split_tf32(f.x, hi[0], lo[0]);
      split_tf32(f.y, hi[1], lo[1]);
      split_tf32(f.z, hi[2], lo[2]);
      split_tf32(f.w, hi[3], lo[3]);
      *reinterpret_cast<uint4*>(smem + L::HL + swz<4>(v, j)) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(smem + L::HL + swz<4>(v, j + 2)) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  // ldmatrix rows: lane l addresses row l % 8 of matrix l / 8, and a voxel's
  // four vectors are the four matrices, so one x4 gives the A fragment's hi
  // and lo parts: a row's hi of channels t4, t4 + 4 and lo of the same.
  const int q = lane >> 3, r = lane & 7;
  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Groups: {x chunk, w(s0)}, {w(s0 + 1)}, then one a step: {w(s + 2)} and,
  // at a chunk's first step, the next chunk. A step waits for all but the
  // newest group: the weights have two steps to land, and so has a chunk
  // issued at a chunk's first step, nine steps before it is split. A chunk
  // issued at step s0 is split at s0 + 1 where the split starts on a chunk's
  // last step (s0 % 9 == 8), while it is still the newest group: that step
  // waits for every group.
  load_x(s0 / 9);
  load_w(s0, 0);
  cp_async_commit();
  if (s0 + 1 < s1) load_w(s0 + 1, 1);
  cp_async_commit();
  for (int s = s0; s < s1; ++s) {
    const int it = s - s0;
    const bool fresh = it == 0 || s % 9 == 0;  // a chunk to split
    if (it == 1 && fresh)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (fresh) {
      split_x();
      __syncthreads();
      const int c1 = s / 9 + 1;
      if (c1 * 9 < s1) load_x(c1);
    }
    if (s + 2 < s1) load_w(s + 2, (it + 2) % F_WSTAGES);
    cp_async_commit();
    const int kz = s % 9 / 3, kx = s % 3;
    const uint32_t wsb = sbase + L::WB + it % F_WSTAGES * L::WSTEP;
    // The 10 halo rows (warp + kz, 0 .. 9) of columns kx .. kx + 7, loaded
    // once for the three ky taps: m16 tile i under tap ky is halo rows
    // 2i + ky (its rows 0-7) and 2i + ky + 1 (rows 8-15).
    // The four warps' fragments of m16 tile i make one m64 operand (tile i
    // under tap ky: halo rows 2i + ky, 2i + ky + 1). Three wgmma a tile and
    // tap into its accumulators, the small terms first: lo A hi B, hi A lo
    // B, hi A hi B (36 a step), waited for before the next step loads new
    // rows into hr.
    uint32_t hr[10][4];
#pragma unroll
    for (int h = 0; h < 10; ++h)
      ldsm_x4(hr[h], sbase + L::HL + swz<4>(halo_index(warp + kz, h, r + kx), q));
    wgmma_fence();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const uint32_t wt0 = wsb + ky * L::WTAP;
      const uint64_t d0 = smem_desc(wt0, 128, 256, 0);            // hi
      const uint64_t d1 = smem_desc(wt0 + L::WBLK, 128, 256, 0);  // lo
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t* u = hr[2 * i + ky];
        const uint32_t* v = hr[2 * i + ky + 1];
        const uint32_t ah[4] = {u[0], v[0], u[1], v[1]};
        const uint32_t al[4] = {u[2], v[2], u[3], v[3]};
        wgmma_tf32<BN>(&acc[i][0][0], al, d0);
        wgmma_tf32<BN>(&acc[i][0][0], ah, d1);
        wgmma_tf32<BN>(&acc[i][0][0], ah, d0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
  }

  // ---- epilogue, from the C fragments: rows g, g + 8 of m16 tile i are
  // brick rows 2i, 2i + 1 of plane warp at w = g, columns 2 t4, 2 t4 + 1 of
  // n8 tile j; 8-byte stores, 32-byte sectors filled
  const int g = lane >> 2, t4 = lane & 3;
  const int d = d0 + warp;
  const long long S = (long long)D * H * W;
  if (ksplit > 1) {
    float* pb = part + ((long long)split * gridDim.y + b) * S * Cout;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = h0 + 2 * i + hh, w = w0 + g;
        if (d >= D || h >= H || w >= W) continue;
        const long long o = ((long long)(d * H + h) * W + w) * Cout;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + 8 * j + 2 * t4;
          if (col < Cout)
            *reinterpret_cast<float2*>(pb + o + col) =
                make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
    return;
  }
  float bv[NT][2], q1[NT][2], q2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int col = n0 + 8 * j + 2 * t4 + k;
      bv[j][k] = (bias && col < Cout) ? bias[col] : 0.f;
      q1[j][k] = q2[j][k] = 0.f;
    }
  float* ob = out + (long long)b * S * Cout;
  const float* rb = res ? res + (long long)b * S * Cout : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int h = h0 + 2 * i + hh, w = w0 + g;
      if (d >= D || h >= H || w >= W) continue;
      const long long o = ((long long)(d * H + h) * W + w) * Cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + 8 * j + 2 * t4;
        if (col >= Cout) continue;
        float v0 = acc[i][j][2 * hh] + bv[j][0], v1 = acc[i][j][2 * hh + 1] + bv[j][1];
        if (rb) {
          const float2 rv = *reinterpret_cast<const float2*>(rb + o + col);
          v0 += rv.x;
          v1 += rv.y;
        }
        *reinterpret_cast<float2*>(ob + o + col) = make_float2(v0, v1);
        q1[j][0] += v0;
        q2[j][0] += v0 * v0;
        q1[j][1] += v1;
        q2[j][1] += v1 * v1;
      }
    }
  if (tsums) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          q1[j][k] += __shfl_xor_sync(0xffffffffu, q1[j][k], off);
          q2[j][k] += __shfl_xor_sync(0xffffffffu, q2[j][k], off);
        }
    if (g == 0) {  // lanes 0-3 hold the warp's sums of their columns
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int cl = 8 * j + 2 * t4 + k;
          s_sum[(warp * 2 + 0) * BN + cl] = q1[j][k];
          s_sum[(warp * 2 + 1) * BN + cl] = q2[j][k];
        }
    }
    __syncthreads();
    store_tile_sums<WARPS, BN>(s_sum, tsums, tid, b, br, gridDim.x / ntiles, n0, Cout);
  }
}

// The K splits' partial sums added in split order (so y is the same bit for
// bit from run to run), then bias and residual, the output and its sums:
// the CTA's (sum y, sum y^2), its threads' partials added in thread order,
// go to row blockIdx.x of the workspace tsums (B, cdiv(S, R_VOX), 2, Cout).
// A thread takes one 4-channel group of every (R_THREADS / (Cout / 4))-th
// voxel of the CTA's R_VOX, so Cout is at most R_MAX_COUT (make_plan splits
// K only there).
constexpr int R_THREADS = 256, R_VOX = 64, R_MAX_COUT = 4 * R_THREADS;

__global__ void __launch_bounds__(R_THREADS)
conv3d_k3s1_f32_reduce_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                              const float* __restrict__ res, float* __restrict__ out,
                              float* __restrict__ tsums, long long S, int Cout, int ksplit) {
  extern __shared__ float r_sum[];  // lanes x (sum y, sum y^2) x Cout
  const int tid = threadIdx.x, b = blockIdx.y;
  const int CG = Cout / 4, lanes = R_THREADS / CG;
  const int cg = tid % CG, vi = tid / CG;
  const long long pstride = (long long)gridDim.y * S * Cout;
  const long long v0 = (long long)blockIdx.x * R_VOX;
  const long long v1 = v0 + R_VOX < S ? v0 + R_VOX : S;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  if (vi < lanes) {
    const float4 bv = bias ? *reinterpret_cast<const float4*>(bias + 4 * cg)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long v = v0 + vi; v < v1; v += lanes) {
      const long long o = ((long long)b * S + v) * Cout + 4 * cg;
      float4 a = *reinterpret_cast<const float4*>(part + o);
      for (int k = 1; k < ksplit; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(part + k * pstride + o);
        a.x += p.x;
        a.y += p.y;
        a.z += p.z;
        a.w += p.w;
      }
      float y[4] = {a.x + bv.x, a.y + bv.y, a.z + bv.z, a.w + bv.w};
      if (res) {
        const float4 rv = *reinterpret_cast<const float4*>(res + o);
        y[0] += rv.x;
        y[1] += rv.y;
        y[2] += rv.z;
        y[3] += rv.w;
      }
      *reinterpret_cast<float4*>(out + o) = make_float4(y[0], y[1], y[2], y[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s1[k] += y[k];
        s2[k] += y[k] * y[k];
      }
    }
  }
  if (tsums) {
    if (vi < lanes) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r_sum[(vi * 2 + 0) * Cout + 4 * cg + k] = s1[k];
        r_sum[(vi * 2 + 1) * Cout + 4 * cg + k] = s2[k];
      }
    }
    __syncthreads();
    float* row = tsums + ((long long)b * gridDim.x + blockIdx.x) * 2 * Cout;
    for (int i = tid; i < 2 * Cout; i += R_THREADS) {
      float v = r_sum[i];
      for (int l = 1; l < lanes; ++l) v += r_sum[l * 2 * Cout + i];
      row[i] = v;
    }
  }
}

// reduce kernel's shared memory: each thread group's (sum y, sum y^2) x Cout
int reduce_smem(int Cout) { return R_THREADS / (Cout / 4) * 2 * Cout * 4; }

// ------------------------------------------------------- the sums' fold

// The rows of the sums workspace (B, T, 2, Cout) added in index order into
// the (B, 2, Cout) output. CTA (column group, segment, b): 128 columns of the
// row (a float4 a lane), rows [T seg / segs, T (seg + 1) / segs), warp w the
// w-th of FOLD_WARPS contiguous runs of them, each run added in index order,
// the runs' totals in warp order. With one segment that is the result; with
// more, each CTA writes its segment's partial to part (B, column groups,
// segs, 128) and the last CTA of its (column group, b) to take a ticket adds
// the partials in segment order and resets the ticket.
constexpr int FOLD_THREADS = 256, FOLD_WARPS = FOLD_THREADS / 32;
constexpr int FOLD_COLS = 128;     // columns of a CTA (2 Cout a row)
constexpr int FOLD_MIN_ROWS = 64;  // the fewest rows of a segment
constexpr int FOLD_MAX_SEGS = 64;  // the most segments a last CTA adds

__global__ void __launch_bounds__(FOLD_THREADS)
conv3d_k3s1_sums_fold_kernel(const float* __restrict__ ws, float* __restrict__ part,
                             int* __restrict__ tickets, float* __restrict__ sums, int T,
                             int C2) {
  __shared__ float4 s_run[FOLD_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cgrp = blockIdx.x, seg = blockIdx.y, b = blockIdx.z, segs = gridDim.y;
  const int col = cgrp * FOLD_COLS + 4 * lane;
  const bool ok = col < C2;  // C2 is a multiple of 16: whole float4s
  const int r0 = (int)((long long)T * seg / segs), n = (int)((long long)T * (seg + 1) / segs) - r0;
  const int t0 = r0 + n * warp / FOLD_WARPS, t1 = r0 + n * (warp + 1) / FOLD_WARPS;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) {
    const float* p = ws + (long long)b * T * C2 + col;
    for (int t = t0; t < t1; ++t) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + (long long)t * C2));
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
  }
  s_run[warp][lane] = a;
  __syncthreads();
  if (warp != 0) return;
  float4 c = s_run[0][lane];
#pragma unroll
  for (int w = 1; w < FOLD_WARPS; ++w) {
    c.x += s_run[w][lane].x;
    c.y += s_run[w][lane].y;
    c.z += s_run[w][lane].z;
    c.w += s_run[w][lane].w;
  }
  float4* out = reinterpret_cast<float4*>(sums + (long long)b * C2 + col);
  if (segs == 1) {
    if (ok) *out = c;
    return;
  }
  const int slot = b * gridDim.x + cgrp;
  float* pp = part + (long long)slot * segs * FOLD_COLS + 4 * lane;
  *reinterpret_cast<float4*>(pp + seg * FOLD_COLS) = c;
  __threadfence();  // the partial is visible before the ticket is taken
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(&tickets[slot], 1) == segs - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  float4 d = __ldcg(reinterpret_cast<const float4*>(pp));
  for (int s = 1; s < segs; ++s) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(pp + s * FOLD_COLS));
    d.x += v.x;
    d.y += v.y;
    d.z += v.z;
    d.w += v.w;
  }
  if (ok) *out = d;
  if (lane == 0) tickets[slot] = 0;  // ready for the next launch
}

// The fold's plan: {workspace rows T, column groups, segments, threads}.
constexpr int FOLD_PLAN_LEN = 4;

void make_fold_plan(int T, int Cout, int B, int sms, int* p) {
  const int groups = brick::cdiv(2 * Cout, FOLD_COLS);
  int segs = brick::cdiv(2 * sms, groups * B);  // two waves of CTAs
  const int most = brick::cdiv(T, FOLD_MIN_ROWS);
  if (segs > most) segs = most;
  if (segs > FOLD_MAX_SEGS) segs = FOLD_MAX_SEGS;
  if (segs < 1) segs = 1;
  p[0] = T;
  p[1] = groups;
  p[2] = segs;
  p[3] = FOLD_THREADS;
}

int launch_fold(const float* ws, float* part, int* tickets, float* sums, int B, int T, int Cout,
                int sms, cudaStream_t st) {
  int f[FOLD_PLAN_LEN];
  make_fold_plan(T, Cout, B, sms, f);
  conv3d_k3s1_sums_fold_kernel<<<dim3((unsigned)f[1], (unsigned)f[2], (unsigned)B),
                                 FOLD_THREADS, 0, st>>>(ws, part, tickets, sums, T, 2 * Cout);
  return (int)cudaGetLastError();
}

// The launch plan: {kind (1 = bricks), tile d, h, w, output channels a CTA,
// grid x, y, z, threads, dynamic shared-memory bytes, K splits}.
constexpr int PLAN_LEN = 11;

int f32_smem(int bn) {
  switch (bn) {
    case 64: return F32<64>::SMEM;
    case 48: return F32<48>::SMEM;
    case 32: return F32<32>::SMEM;
    default: return F32<16>::SMEM;
  }
}

// sms: the card's SMs, the CTAs below which the f32 path splits K.
void make_plan(int dtype, int B, int D, int H, int W, int Cin, int Cout, int sms, int* p) {
  const int nb = brick::cdiv(D, brick::BD) * brick::cdiv(H, brick::BH) *
                 brick::cdiv(W, brick::BW);
  if (dtype == 1) {
    const int bn = Cout % 64 == 0 ? 64 : 32;  // output channels per CTA
    const int v[PLAN_LEN] = {1, brick::BD, brick::BH, brick::BW, bn,
                             nb * brick::cdiv(Cout, bn), B, 1, THREADS,
                             bn == 64 ? Fwd<64>::SMEM : Fwd<32>::SMEM, 1};
    for (int i = 0; i < PLAN_LEN; ++i) p[i] = v[i];
  } else {
    // split the K steps where the output tiles leave SMs empty
    const int bn = f32_bn(Cout);
    const int base = nb * brick::cdiv(Cout, bn) * B;
    const int steps = 9 * (Cin / F_KC);
    int ks = 1;
    if (base < sms && Cout <= R_MAX_COUT) {
      ks = brick::cdiv(sms, base);
      if (ks > steps) ks = steps;
    }
    const int v[PLAN_LEN] = {1, brick::BD, brick::BH, brick::BW, bn,
                             nb * brick::cdiv(Cout, bn) * ks, B, 1, WARPS * 32, f32_smem(bn),
                             ks};
    for (int i = 0; i < PLAN_LEN; ++i) p[i] = v[i];
  }
}

template <int BN>
int launch_f32(const float* x, const float* wt, const float* bias, const float* res, float* out,
               float* tsums, float* scratch, int B, int D, int H, int W, int Cin, int Cout,
               int circular, int zmode, const int* p, cudaStream_t st) {
  using L = F32<BN>;
  const int n = 27 * Cout * Cin;
  float* ws = scratch;
  float* part = scratch + 2 * (long long)n;
  const int ksplit = p[10];
  conv3d_k3s1_f32_wsplit_kernel<<<brick::cdiv(n, 256), 256, 0, st>>>(wt, ws, n, Cin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(conv3d_k3s1_f32_kernel<BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return (int)e;
  conv3d_k3s1_f32_kernel<BN><<<dim3((unsigned)p[5], (unsigned)p[6], (unsigned)p[7]), L::THREADS,
                               L::SMEM, st>>>(
      x, ws, bias, res, out, ksplit > 1 ? part : nullptr, ksplit > 1 ? nullptr : tsums, D, H,
      W, Cin, Cout, circular, zmode, brick::cdiv(H, brick::BH), brick::cdiv(W, brick::BW),
      brick::cdiv(Cout, BN), ksplit);
  e = cudaGetLastError();
  if (e != cudaSuccess || ksplit == 1) return (int)e;
  const long long S = (long long)D * H * W;
  conv3d_k3s1_f32_reduce_kernel<<<dim3((unsigned)((S + R_VOX - 1) / R_VOX), (unsigned)B),
                                  R_THREADS, reduce_smem(Cout), st>>>(part, bias, res, out, tsums,
                                                                      S, Cout, ksplit);
  return (int)cudaGetLastError();
}

// Rows of the sums workspace: the conv's bricks, or the reduce kernel's
// runs of R_VOX voxels where the plan splits K (f32).
int sums_rows(const int* p, int D, int H, int W) {
  if (p[10] > 1) return (int)(((long long)D * H * W + R_VOX - 1) / R_VOX);
  return brick::cdiv(D, brick::BD) * brick::cdiv(H, brick::BH) * brick::cdiv(W, brick::BW);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

}  // namespace

// The launch plan of conv3d_k3s1_fwd at these sizes on a card of sms SMs
// (0: the current device's; see make_plan), for the check against
// ops/kernels/conv3d.py::fwd_plan. Returns 0.
extern "C" int conv3d_k3s1_fwd_plan(int dtype, int B, int D, int H, int W, int Cin, int Cout,
                                    int sms, int* plan) {
  make_plan(dtype, B, D, H, W, Cin, Cout, sms > 0 ? sms : sm_count(), plan);
  return 0;
}

// The plan of the sums' fold after conv3d_k3s1_fwd at these sizes on a card
// of sms SMs (0: the current device's), for the check against
// ops/kernels/conv3d.py::sums_plan. Returns 0.
extern "C" int conv3d_k3s1_sums_plan(int dtype, int B, int D, int H, int W, int Cin, int Cout,
                                     int sms, int* plan) {
  if (sms <= 0) sms = sm_count();
  int p[PLAN_LEN];
  make_plan(dtype, B, D, H, W, Cin, Cout, sms, p);
  make_fold_plan(sums_rows(p, D, H, W), Cout, B, sms, plan);
  return 0;
}

// x (B, Din, H, W, Cin) with Din = D, D + 2 or D - 2 for zmode 0, 1 or 2,
// wt (27, Cout, Cin) in the same dtype (0 = f32, 1 = bf16), bias (Cout) f32
// or null, res (B, D, H, W, Cout) or null, out (B, D, H, W, Cout), sums
// (B, 2, Cout) f32 or null (written whole, never read). f32 also takes
// scratch: 54 Cout Cin floats for the split weights, then, where the plan
// splits K into ks > 1, ks B D H W Cout for the partial sums
// (ops/kernels/conv3d.py::fwd_scratch_floats); bf16 none. With sums, fold
// takes the sums workspace, B T 2 Cout floats, then B groups segs 128 for
// the segments' partials, and tickets B groups int32, 0 on entry and on
// return (conv3d_k3s1_sums_plan: T, groups, segs). The plans are made for
// sms SMs, which the caller's scratch and workspace were sized at. Cin and
// Cout are multiples of 8; every pointer is 16-byte aligned. Returns
// cudaGetLastError() after the launches.
extern "C" int conv3d_k3s1_fwd(int dtype, const void* x, const void* wt, const float* bias,
                               const void* res, void* out, float* sums, float* scratch,
                               float* fold, int* tickets, int B, int D, int H, int W, int Cin,
                               int Cout, int circular, int zmode, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zmode < 0 || zmode > 2 || (zmode == 2 && D < 3)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (sms <= 0 || (dtype == 0 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  if (sums && (fold == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  int p[PLAN_LEN];
  make_plan(dtype, B, D, H, W, Cin, Cout, sms, p);
  const int T = sums_rows(p, D, H, W);
  float* tsums = sums ? fold : nullptr;
  const dim3 grid((unsigned)p[5], (unsigned)p[6], (unsigned)p[7]);
  int err;
  if (dtype == 1) {
    err = p[4] == 64 ? launch_bf16<64>(x, wt, bias, res, out, tsums, D, H, W, Cin, Cout,
                                       circular, zmode, grid, st)
                     : launch_bf16<32>(x, wt, bias, res, out, tsums, D, H, W, Cin, Cout,
                                       circular, zmode, grid, st);
  } else {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(wt);
    const float* rf = static_cast<const float*>(res);
    float* of = static_cast<float*>(out);
    switch (p[4]) {
      case 64:
        err = launch_f32<64>(xf, wf, bias, rf, of, tsums, scratch, B, D, H, W, Cin, Cout,
                             circular, zmode, p, st);
        break;
      case 48:
        err = launch_f32<48>(xf, wf, bias, rf, of, tsums, scratch, B, D, H, W, Cin, Cout,
                             circular, zmode, p, st);
        break;
      case 32:
        err = launch_f32<32>(xf, wf, bias, rf, of, tsums, scratch, B, D, H, W, Cin, Cout,
                             circular, zmode, p, st);
        break;
      default:
        err = launch_f32<16>(xf, wf, bias, rf, of, tsums, scratch, B, D, H, W, Cin, Cout,
                             circular, zmode, p, st);
    }
  }
  if (err || !sums) return err;
  return launch_fold(tsums, tsums + (long long)B * T * 2 * Cout, tickets, sums, B, T, Cout, sms,
                     st);
}
