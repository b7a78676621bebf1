// Half-pel motion search + motion compensation for one P frame, one
// thread block per 16x16 macroblock.
//
// Replaces the TPU kernel thinvids_tpu/codecs/h264/jaxme.py::_me_kernel
// (launched by _me_pallas). It computes exactly what the plain version
// torchme.me_search_ref (a twin of jaxme.me_search_xla) computes:
//   - 227 candidates of OFFSET_TABLE (constant memory, table order) around
//     3 even-pel centres; cost = luma SAD + lam * (|mvy| + |mvx|) in
//     half-pel units; the first strictly lower cost wins;
//   - luma prediction from the H.264 6-tap b/h/j planes (§8.4.2.2.1; j
//     from the unrounded horizontal intermediates), chroma from the
//     eighth-pel bilinear (§8.4.2.2.2), fractions (w & 3) * 2.
// Reads outside the frame use clamped coordinates: that equals the plain
// version's edge-replicated padding, because no candidate reaches the
// pad's far edge.
//
// What bounds it on an H100: at 1080p, 227 candidates x 1088*1920 pixels
// x (sub, abs, add) is ~1.4 G int32 operations per P frame against
// ~17 MB of inputs and outputs, so it is bound by operations, not bytes.
// This first version is simple on purpose: one thread per luma pixel, an
// integer SAD per candidate reduced with warp shuffles into shared
// memory, and one argmin over the 227 per-candidate sums at the end (no
// block-wide barrier inside the candidate loop). Packed SADs
// (__vsadu4 / dp4a style) and a tile of several MBs per block are later
// work.
//
// C interface (loaded with ctypes): me_search_set_table copies the
// candidate table into constant memory of the current device;
// me_search_launch enqueues the kernel on the given stream and returns
// cudaGetLastError(). Centres and lam are device pointers, read by the
// kernel, so the launch never synchronizes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCand = 227;      // len(OFFSET_TABLE)
constexpr int kTile = 32;       // staged luma window edge
constexpr int kOrg = 8;         // tile index i <-> pel (i - kOrg) from MB+centre
constexpr int kThreads = 256;   // one per luma pixel of the MB

// (centre, wy, wx) per candidate, in selection order
__constant__ int8_t c_tab[kCand][3];

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int clip255(int v) { return clampi(v, 0, 255); }

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

// Stage the full-pel window whose top-left pel is (oy, ox) (clamped reads)
// and build the b, h, j half-pel planes over it. Plane 0 = full pel,
// 1 = b (horizontal half), 2 = h (vertical half), 3 = j (diagonal).
// Candidates read rows/cols [4, 28) of plane 0 and [6, 25) of planes
// 1..3, all inside the region each plane is valid on.
__device__ void stage_window(const int16_t* __restrict__ ref, int H, int W,
                             int oy, int ox, int16_t (*pl)[kTile][kTile],
                             int (*hb1)[kTile]) {
  const int t = threadIdx.x;
  __syncthreads();              // earlier readers of the planes are done
  for (int i = t; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int y = clampi(oy + r, 0, H - 1), x = clampi(ox + c, 0, W - 1);
    pl[0][r][c] = ref[(size_t)y * W + x];
  }
  __syncthreads();
  for (int i = t; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    if (c >= 2 && c <= kTile - 4) {
      const int16_t* R = pl[0][r];
      const int h1 = tap6(R[c - 2], R[c - 1], R[c], R[c + 1], R[c + 2],
                          R[c + 3]);
      hb1[r][c] = h1;
      pl[1][r][c] = (int16_t)clip255((h1 + 16) >> 5);
    }
    if (r >= 2 && r <= kTile - 4) {
      const int v1 = tap6(pl[0][r - 2][c], pl[0][r - 1][c], pl[0][r][c],
                          pl[0][r + 1][c], pl[0][r + 2][c], pl[0][r + 3][c]);
      pl[2][r][c] = (int16_t)clip255((v1 + 16) >> 5);
    }
  }
  __syncthreads();
  for (int i = t; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    if (r >= 2 && r <= kTile - 4 && c >= 2 && c <= kTile - 4) {
      const int j1 = tap6(hb1[r - 2][c], hb1[r - 1][c], hb1[r][c],
                          hb1[r + 1][c], hb1[r + 2][c], hb1[r + 3][c]);
      pl[3][r][c] = (int16_t)clip255((j1 + 512) >> 10);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
me_kernel(const int16_t* __restrict__ cur, const int16_t* __restrict__ ry,
          const int16_t* __restrict__ ru, const int16_t* __restrict__ rv,
          const int32_t* __restrict__ centers, const int32_t* __restrict__ lam_p,
          int H, int W, int32_t* __restrict__ mv, int16_t* __restrict__ py,
          int16_t* __restrict__ pu, int16_t* __restrict__ pv) {
  __shared__ int16_t pl[4][kTile][kTile];
  __shared__ int hb1[kTile][kTile];
  __shared__ int part[kCand][kThreads / 32];   // per-warp partial SADs
  __shared__ int s_best;

  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int warp = t >> 5, lane = t & 31;
  const int mbx = blockIdx.x, mby = blockIdx.y, mbw = gridDim.x;
  const int y0 = mby * 16, x0 = mbx * 16;
  const int c = cur[(size_t)(y0 + ty) * W + x0 + tx];

  // candidates of centre ci are table entries [first[ci], first[ci + 1])
  const int first[4] = {0, 121, 202, kCand};
  for (int ci = 0; ci < 3; ++ci) {
    const int cy = centers[2 * ci], cx = centers[2 * ci + 1];
    stage_window(ry, H, W, y0 + cy - kOrg, x0 + cx - kOrg, pl, hb1);
    for (int k = first[ci]; k < first[ci + 1]; ++k) {
      const int wy = c_tab[k][1], wx = c_tab[k][2];
      const int p = ((wy & 1) << 1) | (wx & 1);
      int d = c - pl[p][ty + kOrg + (wy >> 1)][tx + kOrg + (wx >> 1)];
      d = d < 0 ? -d : d;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) part[k][warp] = d;
    }
  }
  __syncthreads();

  // first strictly lower cost in table order = lexicographic min of
  // (cost, k)
  if (warp == 0) {
    const int lam = *lam_p;
    int best_cost = 0x7fffffff, best_k = kCand;
    for (int k = lane; k < kCand; k += 32) {
      int sad = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) sad += part[k][w];
      const int ci = c_tab[k][0];
      const int mvy = 2 * centers[2 * ci] + c_tab[k][1];
      const int mvx = 2 * centers[2 * ci + 1] + c_tab[k][2];
      const int cost = sad + lam * ((mvy < 0 ? -mvy : mvy)
                                    + (mvx < 0 ? -mvx : mvx));
      if (cost < best_cost) { best_cost = cost; best_k = k; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int oc = __shfl_down_sync(0xffffffffu, best_cost, off);
      const int ok = __shfl_down_sync(0xffffffffu, best_k, off);
      if (oc < best_cost || (oc == best_cost && ok < best_k)) {
        best_cost = oc;
        best_k = ok;
      }
    }
    if (lane == 0) s_best = best_k;
  }
  __syncthreads();

  const int k = s_best;
  const int ci = c_tab[k][0], wy = c_tab[k][1], wx = c_tab[k][2];
  const int cy = centers[2 * ci], cx = centers[2 * ci + 1];

  // luma prediction: re-stage the winner's centre and read its plane
  stage_window(ry, H, W, y0 + cy - kOrg, x0 + cx - kOrg, pl, hb1);
  const int p = ((wy & 1) << 1) | (wx & 1);
  py[(size_t)(y0 + ty) * W + x0 + tx] =
      pl[p][ty + kOrg + (wy >> 1)][tx + kOrg + (wx >> 1)];

  // chroma prediction: threads 0..63 Cb, 64..127 Cr, one 8x8 block each
  if (t < 128) {
    const int16_t* __restrict__ src = t < 64 ? ru : rv;
    int16_t* __restrict__ dst = t < 64 ? pu : pv;
    const int H2 = H >> 1, W2 = W >> 1;
    const int i = t & 63, yy = i >> 3, xx = i & 7;
    const int yc = mby * 8 + yy + (cy >> 1) + (wy >> 2);
    const int xc = mbx * 8 + xx + (cx >> 1) + (wx >> 2);
    const int ey = (wy & 3) * 2, ex = (wx & 3) * 2;
    const int r0 = clampi(yc, 0, H2 - 1), r1 = clampi(yc + 1, 0, H2 - 1);
    const int c0 = clampi(xc, 0, W2 - 1), c1 = clampi(xc + 1, 0, W2 - 1);
    const int a = src[(size_t)r0 * W2 + c0], b = src[(size_t)r0 * W2 + c1];
    const int cc = src[(size_t)r1 * W2 + c0], d = src[(size_t)r1 * W2 + c1];
    dst[(size_t)(mby * 8 + yy) * W2 + mbx * 8 + xx] = (int16_t)(
        ((8 - ex) * (8 - ey) * a + ex * (8 - ey) * b + (8 - ex) * ey * cc
         + ex * ey * d + 32) >> 6);
  }
  if (t == 0) {
    const size_t m = (size_t)mby * mbw + mbx;
    mv[2 * m] = 2 * cy + wy;
    mv[2 * m + 1] = 2 * cx + wx;
  }
}

}  // namespace

extern "C" int me_search_set_table(const void* tab, int n) {
  if (n != kCand) return -1;
  return (int)cudaMemcpyToSymbol(c_tab, tab, sizeof(int8_t) * 3 * kCand);
}

extern "C" int me_search_launch(const void* cur, const void* ry,
                                const void* ru, const void* rv,
                                const void* centers, const void* lam, int H,
                                int W, void* mv, void* py, void* pu, void* pv,
                                void* stream) {
  const dim3 grid(W / 16, H / 16);
  me_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)cur, (const int16_t*)ry, (const int16_t*)ru,
      (const int16_t*)rv, (const int32_t*)centers, (const int32_t*)lam, H, W,
      (int32_t*)mv, (int16_t*)py, (int16_t*)pu, (int16_t*)pv);
  return (int)cudaGetLastError();
}
