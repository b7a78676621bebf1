// Half-pel motion search + motion compensation for one P frame on Hopper
// (sm_90a): a per-frame half-pel prepass and a packed-byte SAD search.
//
// Replaces the TPU kernel thinvids_tpu/codecs/h264/jaxme.py::_me_kernel
// (launched by _me_pallas). Together the two kernels compute exactly what
// the plain version torchme.me_search_ref (a twin of jaxme.me_search_xla)
// computes:
//   - 227 candidates of OFFSET_TABLE (table order) around 3 even-pel
//     centres, |c| <= 12; cost = luma SAD + lam * (|mvy| + |mvx|) in
//     half-pel units; the first strictly lower cost wins, i.e. the
//     lexicographic min of (cost, table index);
//   - luma prediction from the H.264 6-tap b/h/j planes (§8.4.2.2.1; j
//     from the unrounded horizontal intermediates), chroma from the
//     eighth-pel bilinear (§8.4.2.2.2), fractions (w & 3) * 2.
// Reads outside the frame use clamped coordinates: that equals the plain
// version's edge-replicated padding, because no candidate reaches the
// pad's far edge.
//
// Precondition (shared with the TPU kernel, which casts to bf16, exact
// only up to 256): every luma sample of cur and ref lies in [0, 255].
// The search packs four samples into a 32-bit word; a value outside that
// range gives a wrong SAD, not an error.
//
// What bounds it on an H100: at 1080p the search is 227 candidates x
// 1088*1920 pixel differences per P frame, ~119 M four-byte SAD
// instructions against ~21 MB of inputs and outputs; it is bound by
// operations, and in practice by the shared-memory words that feed them.
// The design:
//   1. halfpel_kernel (the prepass) builds the reference's full-pel, b, h
//      and j planes once per frame as uint8, over the frame plus a margin
//      of kHalo samples on every side (clamped reads), into scratch the
//      wrapper allocates (~8.7 MB at 1088x1920, so it stays in the 50 MB
//      L2); no MB rebuilds them. A block stages a 16x64 tile; each thread
//      then takes one column and four rows, so neighbouring lanes read
//      neighbouring shared words and the vertical taps share their loads.
//   2. search_kernel: one block per horizontal strip of kMbs MBs, one warp
//      per MB. The block copies its strip's windows of the planes it
//      needs (all four around centres 0 and 2, the full-pel one around
//      centre 1) with 16-byte loads, and its current MBs packed 4 bytes a
//      word, into shared memory, with one barrier in all. Each lane then
//      owns every 32nd candidate and walks the 16 rows with the current MB
//      in registers: five shared words, four funnel shifts to align the
//      candidate row, four vabsdiff4.add (the instruction __vsadu4 emits,
//      with its accumulator operand used; one VABSDIFF4 each on sm_90a).
//      Sums stay in registers; one shuffle reduction per MB takes the
//      (cost, index) argmin.
//   3. The winner's luma prediction is read from the staged window; the
//      chroma prediction is the bilinear of the winner only.
//
// Bands: both kernels take a stack of B planes of one shape (a frame is
// B = 1; split-frame encoding passes its B halo-extended MB-row bands,
// each (Hb + 2 halo) x W) and run them in one launch, blockIdx.z being
// the band. Every pointer moves to its band's slab first and every read
// clamps to that band's own plane, so a band never reads its neighbour's
// memory in the stack: the clamp equals the plain version's edge
// replication of each band plane, as for a frame. All bands share the
// centres and lam.
//
// C interface (loaded with ctypes): me_search_set_table copies the
// candidate table to the current device; me_search_halo returns kHalo
// (the wrapper checks it against its own constant); me_halfpel_launch and
// me_search_launch enqueue one kernel each, over all B planes, on the
// given stream and return cudaGetLastError(). Centres and lam are device
// pointers, read by the kernel, so no launch synchronizes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCand = 227;     // len(OFFSET_TABLE)
constexpr int kClim = 12;      // |centre| <= kClim pel (torchme._CLIM)
constexpr int kReach = 4;      // |my|, |mx| <= kReach pel (torchme._WR)
constexpr int kHalo = kClim + kReach;   // plane margin (torchme.ME_HALO)

// ---- prepass ------------------------------------------------------------

constexpr int kPreRows = 16;   // output tile of one prepass block
constexpr int kPreCols = 64;
constexpr int kPreThreads = 256;
constexpr int kPreRowsEach = kPreRows * kPreCols / kPreThreads;   // 4

// ---- search -------------------------------------------------------------

constexpr int kMbs = 4;                      // MBs per block, one warp each
constexpr int kThreads = 32 * kMbs;
constexpr int kWinRows = 16 + 2 * kReach;    // rows of a staged window
// A window row starts at the 16-byte boundary at or before the strip's
// reach, align_off(cx) = (cx + kHalo - kReach) & 15 bytes ahead of it, so
// it is copied with 16-byte loads. Byte j = 16m + mx + kReach +
// align_off(cx) of a candidate row is at most 16 (kMbs - 1) + 2 kReach +
// 15, and the row takes five words from j / 4: 4 kMbs + 6 words, rounded
// up to whole 16-byte chunks.
constexpr int kWinWords = 4 * kMbs + 8;
constexpr int kWinChunks = kWinWords / 4;
// row pitch in words: a multiple of 4 (16-byte rows) that is 8 mod 16,
// so that the rows my = -4..-1 of a lane group fall on disjoint banks
constexpr int kPitch = kWinWords % 16 == 0 ? kWinWords + 8 : kWinWords;
constexpr int kWinStride = kWinRows * kPitch + 4;   // skew between windows
// windows: centre 0 planes 0..3, centre 1 plane 0, centre 2 planes 0..3
constexpr int kWins = 9;
static_assert(kPitch % 16 == 8 && kWinStride % 4 == 0, "16-byte rows");

// (centre, wy, wx) per candidate, in selection order
__device__ int8_t d_tab[kCand][3];

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int clip255(int v) { return clampi(v, 0, 255); }

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

// acc + sum over the four bytes of |a - b|
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b,
                                         unsigned acc) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

__device__ __forceinline__ int window_of(int ci, int p) {
  return ci == 0 ? p : (ci == 1 ? 4 : 5 + p);
}

// bytes from a window row's first byte to the strip's reach, centre cx
__device__ __forceinline__ int align_off(int cx) {
  return (cx + kHalo - kReach) & 15;
}

// Planes of band z: 4 x (H + 2 kHalo) x (W + 2 kHalo) bytes, plane p at
// row r, col c holds the value at pel (r - kHalo, c - kHalo) of the band:
// p = 0 full pel, 1 = b (horizontal half), 2 = h (vertical half), 3 = j
// (diagonal).
__global__ void __launch_bounds__(kPreThreads)
halfpel_kernel(const int16_t* __restrict__ ref, int H, int W,
               uint32_t* __restrict__ planes) {
  __shared__ int s_ref[kPreRows + 5][kPreCols + 5];
  __shared__ int s_hb[kPreRows + 5][kPreCols];
  __shared__ __align__(4) uint8_t s_out[4][kPreRows][kPreCols];
  const int t = threadIdx.x;
  const int Hp = H + 2 * kHalo, Wp = W + 2 * kHalo;
  ref += (size_t)blockIdx.z * H * W;
  planes += (size_t)blockIdx.z * 4 * Hp * (Wp / 4);
  const int r0 = blockIdx.y * kPreRows, c0 = blockIdx.x * kPreCols;
  // s_ref[i][j] = ref at plane (r0 - 2 + i, c0 - 2 + j), clamped
  for (int i = t; i < (kPreRows + 5) * (kPreCols + 5); i += kPreThreads) {
    const int r = i / (kPreCols + 5), c = i % (kPreCols + 5);
    const int y = clampi(r0 - 2 + r - kHalo, 0, H - 1);
    const int x = clampi(c0 - 2 + c - kHalo, 0, W - 1);
    s_ref[r][c] = ref[(size_t)y * W + x];
  }
  __syncthreads();
  // s_hb[i][j] = unrounded horizontal 6-tap at plane (r0 - 2 + i, c0 + j)
  for (int i = t; i < (kPreRows + 5) * kPreCols; i += kPreThreads) {
    const int r = i / kPreCols, c = i % kPreCols;
    const int* R = s_ref[r];
    s_hb[r][c] = tap6(R[c], R[c + 1], R[c + 2], R[c + 3], R[c + 4], R[c + 5]);
  }
  __syncthreads();
  // thread -> column cc, rows ty0 .. ty0 + 3: lanes on neighbouring
  // columns read shared memory without bank conflicts, and the vertical
  // taps of four rows share nine loads
  {
    const int cc = t % kPreCols, ty0 = (t / kPreCols) * kPreRowsEach;
    int v[kPreRowsEach + 5], hb[kPreRowsEach + 5];
#pragma unroll
    for (int i = 0; i < kPreRowsEach + 5; ++i) {
      v[i] = s_ref[ty0 + i][cc + 2];
      hb[i] = s_hb[ty0 + i][cc];
    }
#pragma unroll
    for (int i = 0; i < kPreRowsEach; ++i) {
      s_out[0][ty0 + i][cc] = (uint8_t)v[i + 2];
      s_out[1][ty0 + i][cc] = (uint8_t)clip255((hb[i + 2] + 16) >> 5);
      s_out[2][ty0 + i][cc] = (uint8_t)clip255(
          (tap6(v[i], v[i + 1], v[i + 2], v[i + 3], v[i + 4], v[i + 5]) + 16)
          >> 5);
      s_out[3][ty0 + i][cc] = (uint8_t)clip255(
          (tap6(hb[i], hb[i + 1], hb[i + 2], hb[i + 3], hb[i + 4], hb[i + 5])
           + 512) >> 10);
    }
  }
  __syncthreads();
  // store the tile a word (four columns) at a time
  const size_t plane = (size_t)Hp * (Wp / 4);
  for (int i = t; i < 4 * kPreRows * (kPreCols / 4); i += kPreThreads) {
    const int p = i / (kPreRows * (kPreCols / 4));
    const int r = (i / (kPreCols / 4)) % kPreRows, k = i % (kPreCols / 4);
    if (c0 + 4 * k < Wp)
      planes[p * plane + (size_t)(r0 + r) * (Wp / 4) + c0 / 4 + k] =
          *reinterpret_cast<const uint32_t*>(&s_out[p][r][4 * k]);
  }
}

__global__ void __launch_bounds__(kThreads)
search_kernel(const int16_t* __restrict__ cur,
              const uint32_t* __restrict__ planes,
              const int16_t* __restrict__ ru, const int16_t* __restrict__ rv,
              const int32_t* __restrict__ centers,
              const int32_t* __restrict__ lam_p, int H, int W,
              int32_t* __restrict__ mv, int16_t* __restrict__ py,
              int16_t* __restrict__ pu, int16_t* __restrict__ pv) {
  __shared__ __align__(16) uint32_t s_win[kWins * kWinStride];
  __shared__ __align__(16) uint32_t s_cur[16][4 * kMbs];
  __shared__ int s_cent[6];

  const int t = threadIdx.x;
  const int mbw = W >> 4;
  const int x0 = blockIdx.x * kMbs * 16, y0 = blockIdx.y * 16;
  const int Wq = (W + 2 * kHalo) >> 2;                 // words a plane row
  const size_t plane = (size_t)(H + 2 * kHalo) * Wq;
  {  // band z's slab of every input and output
    const size_t z = blockIdx.z, hw = (size_t)H * W, hw4 = hw / 4;
    cur += z * hw;
    planes += z * 4 * plane;
    ru += z * hw4;
    rv += z * hw4;
    mv += z * (hw / 128);            // (H / 16) (W / 16) MBs, 2 words each
    py += z * hw;
    pu += z * hw4;
    pv += z * hw4;
  }

  // ---- stage: windows of the planes around each centre, current MBs ----
  // window row i, chunk k <- plane row y0 + cy - kReach + kHalo + i, 16-byte
  // chunk (x0 + cx - kReach + kHalo) / 16 + k (clamped to the row: only
  // strips that run past the frame read there, for MBs that are skipped)
  int cy[3], cx[3];
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    cy[ci] = centers[2 * ci];
    cx[ci] = centers[2 * ci + 1];
  }
  if (t < 6) s_cent[t] = centers[t];
  const int Wc = Wq >> 2;                              // chunks a plane row
  const uint4* __restrict__ chunks = reinterpret_cast<const uint4*>(planes);
  for (int i = t; i < kWins * kWinRows * kWinChunks; i += kThreads) {
    const int w = i / (kWinRows * kWinChunks);
    const int rem = i % (kWinRows * kWinChunks);
    const int row = rem / kWinChunks, k = rem % kWinChunks;
    const int ci = w < 4 ? 0 : (w == 4 ? 1 : 2);
    const int p = w < 4 ? w : (w == 4 ? 0 : w - 5);
    const int ccy = ci == 0 ? cy[0] : (ci == 1 ? cy[1] : cy[2]);
    const int ccx = ci == 0 ? cx[0] : (ci == 1 ? cx[1] : cx[2]);
    const int gy = y0 + ccy - kReach + kHalo + row;
    const int gk = min(((x0 + ccx - kReach + kHalo) >> 4) + k, Wc - 1);
    *reinterpret_cast<uint4*>(&s_win[w * kWinStride + row * kPitch + 4 * k]) =
        chunks[(p * plane) / 4 + (size_t)gy * Wc + gk];
  }
  for (int i = t; i < 16 * 4 * kMbs; i += kThreads) {
    const int row = i / (4 * kMbs), k = i % (4 * kMbs);
    const int x = x0 + 4 * k;
    uint32_t packed = 0;
    if (x < W) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          cur + (size_t)(y0 + row) * W + x);
      packed = __byte_perm(v.x, v.y, 0x6420);   // low bytes of 4 int16
    }
    s_cur[row][k] = packed;
  }
  __syncthreads();

  const int m = t >> 5, lane = t & 31;
  const int mbx = blockIdx.x * kMbs + m;
  if (mbx >= mbw) return;          // no barrier below this line

  uint32_t c[16][4];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const uint4 v = *reinterpret_cast<const uint4*>(&s_cur[r][4 * m]);
    c[r][0] = v.x; c[r][1] = v.y; c[r][2] = v.z; c[r][3] = v.w;
  }

  // ---- search: lane owns candidates lane, lane + 32, ... -----------------
  const int lam = *lam_p;
  int best_cost = 0x7fffffff, best_k = kCand;
  for (int k = lane; k < kCand; k += 32) {
    const int ci = d_tab[k][0], wy = d_tab[k][1], wx = d_tab[k][2];
    const int ccy = s_cent[2 * ci], ccx = s_cent[2 * ci + 1];
    const int p = ((wy & 1) << 1) | (wx & 1);
    const int off = ((wy >> 1) + kReach) * kPitch * 4 + 16 * m + (wx >> 1)
                    + kReach + align_off(ccx);
    const uint32_t* src = s_win + window_of(ci, p) * kWinStride + (off >> 2);
    const unsigned sh = (off & 3) * 8;
    unsigned s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const uint32_t* q = src + r * kPitch;
      const uint32_t a0 = q[0], a1 = q[1], a2 = q[2], a3 = q[3], a4 = q[4];
      s0 = sad4(c[r][0], __funnelshift_r(a0, a1, sh), s0);
      s1 = sad4(c[r][1], __funnelshift_r(a1, a2, sh), s1);
      s2 = sad4(c[r][2], __funnelshift_r(a2, a3, sh), s2);
      s3 = sad4(c[r][3], __funnelshift_r(a3, a4, sh), s3);
    }
    const int mvy = 2 * ccy + wy, mvx = 2 * ccx + wx;
    const int cost = (int)(s0 + s1 + s2 + s3)
                     + lam * ((mvy < 0 ? -mvy : mvy) + (mvx < 0 ? -mvx : mvx));
    if (cost < best_cost) { best_cost = cost; best_k = k; }
  }
  // first strictly lower cost in table order = lexicographic min of
  // (cost, k); after the xor butterfly every lane holds it
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int oc = __shfl_xor_sync(0xffffffffu, best_cost, o);
    const int ok = __shfl_xor_sync(0xffffffffu, best_k, o);
    if (oc < best_cost || (oc == best_cost && ok < best_k)) {
      best_cost = oc;
      best_k = ok;
    }
  }

  const int k = best_k;
  const int ci = d_tab[k][0], wy = d_tab[k][1], wx = d_tab[k][2];
  const int ccy = s_cent[2 * ci], ccx = s_cent[2 * ci + 1];
  const int mx0 = mbx * 16;

  // luma prediction: lane -> row lane / 2, 8 pixels from (lane & 1) * 8
  {
    const int row = lane >> 1, half = lane & 1;
    const int p = ((wy & 1) << 1) | (wx & 1);
    const int off = (row + (wy >> 1) + kReach) * kPitch * 4 + 16 * m
                    + (wx >> 1) + kReach + align_off(ccx) + 8 * half;
    const uint32_t* src = s_win + window_of(ci, p) * kWinStride + (off >> 2);
    const unsigned sh = (off & 3) * 8;
    const uint32_t lo = __funnelshift_r(src[0], src[1], sh);
    const uint32_t hi = __funnelshift_r(src[1], src[2], sh);
    // zero-extend 8 bytes to 8 int16
    const uint4 out = make_uint4(__byte_perm(lo, 0, 0x4140),
                                 __byte_perm(lo, 0, 0x4342),
                                 __byte_perm(hi, 0, 0x4140),
                                 __byte_perm(hi, 0, 0x4342));
    *reinterpret_cast<uint4*>(py + (size_t)(y0 + row) * W + mx0 + 8 * half) =
        out;
  }

  // chroma prediction: lane -> row lane / 4, columns 2 (lane & 3) + {0, 1}
  // of the MB's 8x8 Cb and Cr blocks
  {
    const int H2 = H >> 1, W2 = W >> 1;
    const int yy = lane >> 2;
    const int ey = (wy & 3) * 2, ex = (wx & 3) * 2;
    const int yc = blockIdx.y * 8 + yy + (ccy >> 1) + (wy >> 2);
    const int r0 = clampi(yc, 0, H2 - 1), r1 = clampi(yc + 1, 0, H2 - 1);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int xx = 2 * (lane & 3) + q;
      const int xc = mbx * 8 + xx + (ccx >> 1) + (wx >> 2);
      const int c0 = clampi(xc, 0, W2 - 1), c1 = clampi(xc + 1, 0, W2 - 1);
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        const int16_t* __restrict__ src = pl == 0 ? ru : rv;
        int16_t* __restrict__ dst = pl == 0 ? pu : pv;
        const int a = src[(size_t)r0 * W2 + c0];
        const int b = src[(size_t)r0 * W2 + c1];
        const int cc = src[(size_t)r1 * W2 + c0];
        const int d = src[(size_t)r1 * W2 + c1];
        dst[(size_t)(blockIdx.y * 8 + yy) * W2 + mbx * 8 + xx] = (int16_t)(
            ((8 - ex) * (8 - ey) * a + ex * (8 - ey) * b
             + (8 - ex) * ey * cc + ex * ey * d + 32) >> 6);
      }
    }
  }
  if (lane == 0) {
    const size_t mb = (size_t)blockIdx.y * mbw + mbx;
    mv[2 * mb] = 2 * ccy + wy;
    mv[2 * mb + 1] = 2 * ccx + wx;
  }
}

}  // namespace

extern "C" int me_search_set_table(const void* tab, int n) {
  if (n != kCand) return -1;
  return (int)cudaMemcpyToSymbol(d_tab, tab, sizeof(int8_t) * 3 * kCand);
}

extern "C" int me_search_halo() { return kHalo; }

extern "C" int me_halfpel_launch(const void* ref, int B, int H, int W,
                                 void* planes, void* stream) {
  const dim3 grid((W + 2 * kHalo + kPreCols - 1) / kPreCols,
                  (H + 2 * kHalo) / kPreRows, B);
  halfpel_kernel<<<grid, kPreThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)ref, H, W, (uint32_t*)planes);
  return (int)cudaGetLastError();
}

extern "C" int me_search_launch(const void* cur, const void* planes,
                                const void* ru, const void* rv,
                                const void* centers, const void* lam, int B,
                                int H, int W, void* mv, void* py, void* pu,
                                void* pv, void* stream) {
  const dim3 grid((W / 16 + kMbs - 1) / kMbs, H / 16, B);
  search_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)cur, (const uint32_t*)planes, (const int16_t*)ru,
      (const int16_t*)rv, (const int32_t*)centers, (const int32_t*)lam, H, W,
      (int32_t*)mv, (int16_t*)py, (int16_t*)pu, (int16_t*)pv);
  return (int)cudaGetLastError();
}
