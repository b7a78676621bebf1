// Native CAVLC slice packer — the sequential hot path of the encoder.
//
// The device produces quantized level arrays (codecs/h264/torchcore.py); this
// translation unit turns them into a conformant I-slice EBSP payload at
// native speed. It is the C++ analog of codecs/h264/encoder.pack_slice and
// is tested bit-for-bit against it. VLC tables are NOT duplicated here —
// Python passes the arrays from codecs/h264/tables.py via cavlc_init_tables
// so there is a single source of truth.
//
// Built at first use by thinvids_tpu_torch/native/__init__.py (g++ -O2 -shared).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// --- shared VLC tables, set once from Python -------------------------------
// coeff_token[ctx][tc][t1] -> (len, bits); len 0 = invalid combo
static int32_t g_coeff_token[4][17][4][2];
static int32_t g_chroma_dc_token[5][4][2];
static int32_t g_total_zeros[16][16][2];    // [total_coeff][total_zeros]
static int32_t g_tz_chroma[4][4][2];        // [total_coeff][total_zeros]
static int32_t g_run_before[8][15][2];      // [min(zeros_left,7)][run]
static bool g_tables_ready = false;

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nbits = 0;  // bits pending in acc; < 32 between writes

  // n <= 32 (enforced by all call sites); acc holds < 32 bits on entry,
  // so the shift never exceeds 63 bits. Flushing whole 32-bit words
  // takes the buffer-append branch once per 4 output bytes instead of
  // once per byte — this writer is the innermost loop of the pack.
  inline void write(uint32_t value, int n) {
    acc = (acc << n) | value;
    nbits += n;
    if (nbits >= 32) {
      nbits -= 32;
      const uint32_t w = static_cast<uint32_t>(acc >> nbits);
      const size_t o = buf.size();
      buf.resize(o + 4);
      buf[o] = static_cast<uint8_t>(w >> 24);
      buf[o + 1] = static_cast<uint8_t>(w >> 16);
      buf[o + 2] = static_cast<uint8_t>(w >> 8);
      buf[o + 3] = static_cast<uint8_t>(w);
      acc &= (1ULL << nbits) - 1;
    }
  }
  void ue(uint32_t v) {
    uint32_t code = v + 1;
    int n = 32 - __builtin_clz(code);
    write(0, n - 1);
    write(code, n);
  }
  void se(int32_t v) { ue(v > 0 ? 2 * (uint32_t)v - 1 : (uint32_t)(-2 * v)); }
  void trailing() {
    write(1, 1);
    if (nbits % 8) write(0, 8 - (nbits % 8));
    while (nbits >= 8) {  // drain the word accumulator (byte-aligned now)
      nbits -= 8;
      buf.push_back(static_cast<uint8_t>(acc >> nbits));
    }
    acc = 0;
  }
};

// Precomputed level codes: g_lev_{len,bits}[suffix_len][level_code] for
// level_code < 64 (covers every level the quantizer emits at practical
// QPs) fold the prefix/suffix branch cascade into one table write.
static uint32_t g_lev_bits[7][64];
static uint8_t g_lev_len[7][64];

static void build_level_table() {
  for (int s = 0; s < 7; s++) {
    for (uint32_t lc = 0; lc < 64; lc++) {
      uint32_t bits;
      int len;
      if (s == 0) {
        if (lc < 14) {
          bits = 1;
          len = (int)lc + 1;
        } else if (lc < 30) {
          bits = (1u << 4) | (lc - 14);
          len = 19;
        } else {
          bits = (1u << 12) | (lc - 30);
          len = 28;
        }
      } else {
        const uint32_t prefix = lc >> s;
        if (prefix < 15) {
          bits = (1u << s) | (lc & ((1u << s) - 1));
          len = (int)prefix + 1 + s;
        } else {
          bits = (1u << 12) | (lc - (15u << s));
          len = 28;
        }
      }
      g_lev_bits[s][lc] = bits;
      g_lev_len[s][lc] = (uint8_t)len;
    }
  }
}

// Returns total_coeff; writes the residual block. coeffs: zig-zag order.
// Templated over the level dtype so the int16 transfer layout packs
// without a widening copy (cavlc_pack_islice16 / the plane packers).
template <typename T>
static int encode_residual(BitWriter& bw, const T* coeffs, int n, int nc) {
  int positions[16];
  int total = 0;
  for (int i = 0; i < n; i++)
    if (coeffs[i]) positions[total++] = i;

  int trailing = 0;
  for (int k = total - 1; k >= 0 && trailing < 3; k--) {
    int32_t c = coeffs[positions[k]];
    if (c != 1 && c != -1) break;
    trailing++;
  }

  const int32_t* tok;
  if (nc == -1) {
    tok = g_chroma_dc_token[total][trailing];
  } else {
    int ctx = nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
    tok = g_coeff_token[ctx][total][trailing];
  }
  bw.write((uint32_t)tok[1], tok[0]);
  if (total == 0) return 0;

  for (int k = total - 1; k >= total - trailing; k--)
    bw.write(coeffs[positions[k]] < 0 ? 1u : 0u, 1);

  int suffix_len = (total > 10 && trailing < 3) ? 1 : 0;
  bool first = true;
  for (int k = total - trailing - 1; k >= 0; k--) {
    const int32_t level = coeffs[positions[k]];
    const int32_t mag = level < 0 ? -level : level;
    uint32_t level_code = (uint32_t)(mag - 1) * 2 + (level < 0 ? 1 : 0);
    if (first && trailing < 3) level_code -= 2;
    first = false;
    if (level_code < 64) {  // precomputed: single branch + single write
      bw.write(g_lev_bits[suffix_len][level_code],
               g_lev_len[suffix_len][level_code]);
    } else if (suffix_len == 0) {
      if (level_code - 30 >= (1u << 12)) return -3;  // exceeds baseline
      bw.write((1u << 12) | (level_code - 30), 28);
    } else {
      const uint32_t prefix = level_code >> suffix_len;
      if (prefix < 15) {
        bw.write((1u << suffix_len)
                     | (level_code & ((1u << suffix_len) - 1)),
                 (int)prefix + 1 + suffix_len);
      } else {
        if (level_code - (15u << suffix_len) >= (1u << 12)) return -3;
        bw.write((1u << 12) | (level_code - (15u << suffix_len)), 28);
      }
    }
    if (suffix_len == 0) suffix_len = 1;
    if (mag > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
  }

  int total_zeros = positions[total - 1] + 1 - total;
  if (total < n) {
    const int32_t* tz = (nc == -1) ? g_tz_chroma[total][total_zeros]
                                   : g_total_zeros[total][total_zeros];
    bw.write((uint32_t)tz[1], tz[0]);
  }
  int zeros_left = total_zeros;
  for (int k = total - 1; k >= 1 && zeros_left > 0; k--) {
    int run = positions[k] - positions[k - 1] - 1;
    const int32_t* rb = g_run_before[zeros_left < 7 ? zeros_left : 7][run];
    bw.write((uint32_t)rb[1], rb[0]);
    zeros_left -= run;
  }
  return total;
}


// Neighbor-average nC lookup over a counts grid (width w); A=left, B=top.
static inline int nc_from_counts(const int32_t* cnt, int w, int gy, int gx) {
  bool a = gx > 0, b = gy > 0;
  int na = a ? cnt[(size_t)gy * w + gx - 1] : 0;
  int nb = b ? cnt[(size_t)(gy - 1) * w + gx] : 0;
  if (a && b) return (na + nb + 1) >> 1;
  if (a) return na;
  if (b) return nb;
  return 0;
}

// Emulation prevention: rbsp -> ebsp into `out`. Returns byte length or -2.
static int64_t emit_ebsp(const BitWriter& bw, uint8_t* out, int64_t out_cap) {
  int64_t o = 0;
  int zeros = 0;
  for (uint8_t b : bw.buf) {
    if (zeros >= 2 && b <= 3) {
      if (o >= out_cap) return -2;
      out[o++] = 3;
      zeros = 0;
    }
    if (o >= out_cap) return -2;
    out[o++] = b;
    zeros = (b == 0) ? zeros + 1 : 0;
  }
  return o;
}

// Packs slice-header bits + all MB data + rbsp trailing, applies emulation
// prevention. Returns EBSP byte length, or -1 on error / -2 if out_cap is
// too small. Templated over the level dtype: the sharded transfer hands
// the host int16 views (cavlc_pack_islice16) and packing them directly
// kills the ~4-array astype(int32) copy chain that used to run per GOP.
template <typename T>
static int64_t pack_islice_impl(
    const uint8_t* header_bytes, int32_t header_bit_len,
    const int32_t* luma_mode, const int32_t* chroma_mode,
    const T* luma_dc,    // nmb*16
    const T* luma_ac,    // nmb*16*15
    const T* chroma_dc,  // nmb*2*4
    const T* chroma_ac,  // nmb*2*4*15
    int32_t mbw, int32_t mbh, uint8_t* out, int64_t out_cap,
    const int8_t* qp_delta /* nmb per-MB qp offsets vs slice qp, or
                              nullptr = flat QP (se(0) per MB) */) {
  if (!g_tables_ready || mbw <= 0 || mbh <= 0) return -1;
  // z-scan order of 4x4 luma blocks within a MB: (bx, by)
  static const int BX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
  static const int BY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
  static const int CBX[4] = {0, 1, 0, 1};
  static const int CBY[4] = {0, 0, 1, 1};

  BitWriter bw;
  bw.buf.reserve((size_t)mbw * mbh * 64);
  // splice in the slice header bit string
  for (int i = 0; i < header_bit_len / 8; i++) bw.write(header_bytes[i], 8);
  if (int rem = header_bit_len % 8)
    bw.write(header_bytes[header_bit_len / 8] >> (8 - rem), rem);

  const int lw = 4 * mbw, lh = 4 * mbh;
  const int cw = 2 * mbw, ch = 2 * mbh;
  std::vector<int32_t> lcnt((size_t)lw * lh, 0);
  std::vector<int32_t> ccnt((size_t)2 * cw * ch, 0);

  auto luma_nc = [&](int gy, int gx) {
    return nc_from_counts(lcnt.data(), lw, gy, gx);
  };
  auto chroma_nc = [&](int ci, int gy, int gx) {
    return nc_from_counts(ccnt.data() + (size_t)ci * ch * cw, cw, gy, gx);
  };

  int32_t prev_qp_off = 0;
  for (int my = 0; my < mbh; my++) {
    for (int mx = 0; mx < mbw; mx++) {
      const int mi = my * mbw + mx;
      const T* lac = luma_ac + (size_t)mi * 16 * 15;
      const T* cac = chroma_ac + (size_t)mi * 2 * 4 * 15;
      const T* cdc = chroma_dc + (size_t)mi * 2 * 4;

      int cbp_luma = 0;
      for (int i = 0; i < 16 * 15 && !cbp_luma; i++)
        if (lac[i]) cbp_luma = 15;
      int cbp_chroma = 0;
      for (int i = 0; i < 2 * 4 * 15 && cbp_chroma < 2; i++)
        if (cac[i]) cbp_chroma = 2;
      if (cbp_chroma == 0)
        for (int i = 0; i < 8 && !cbp_chroma; i++)
          if (cdc[i]) cbp_chroma = 1;

      int mb_type = 1 + luma_mode[mi] + 4 * cbp_chroma + (cbp_luma ? 12 : 0);
      bw.ue((uint32_t)mb_type);
      bw.ue((uint32_t)chroma_mode[mi]);
      if (qp_delta) {
        // mb_qp_delta chains vs the previous MB's qp (§7.4.5);
        // qp_delta[] holds offsets vs the slice qp.
        bw.se((int32_t)qp_delta[mi] - prev_qp_off);
        prev_qp_off = qp_delta[mi];
      } else {
        bw.se(0);  // mb_qp_delta
      }

      const int by0 = 4 * my, bx0 = 4 * mx;
      if (encode_residual(bw, luma_dc + (size_t)mi * 16, 16,
                          luma_nc(by0, bx0)) < 0)
        return -3;

      for (int bi = 0; bi < 16; bi++) {
        int gy = by0 + BY[bi], gx = bx0 + BX[bi];
        if (cbp_luma) {
          int tc = encode_residual(bw, lac + (size_t)bi * 15, 15, luma_nc(gy, gx));
          if (tc < 0) return -3;
          lcnt[(size_t)gy * lw + gx] = tc;
        } else {
          lcnt[(size_t)gy * lw + gx] = 0;
        }
      }
      if (cbp_chroma > 0)
        for (int ci = 0; ci < 2; ci++)
          if (encode_residual(bw, cdc + (size_t)ci * 4, 4, -1) < 0)
            return -3;
      const int cy0 = 2 * my, cx0 = 2 * mx;
      for (int ci = 0; ci < 2; ci++) {
        for (int bi = 0; bi < 4; bi++) {
          int gy = cy0 + CBY[bi], gx = cx0 + CBX[bi];
          if (cbp_chroma == 2) {
            int tc = encode_residual(bw, cac + ((size_t)ci * 4 + bi) * 15, 15,
                                     chroma_nc(ci, gy, gx));
            if (tc < 0) return -3;
            ccnt[((size_t)ci * ch + gy) * cw + gx] = tc;
          } else {
            ccnt[((size_t)ci * ch + gy) * cw + gx] = 0;
          }
        }
      }
    }
  }
  bw.trailing();

  // Emulation prevention: rbsp -> ebsp into `out`.
  return emit_ebsp(bw, out, out_cap);
}

// Shared scatter core of the two sparse-stream unpack entries: bitmap
// (1 bit/16-coeff block, big-endian within bytes) + per-live-block
// uint16 lane masks (via `mask_at(i)` — aligned uint16 reads for the
// array entry, byte-pair reads for the compact payload) + the packed
// nonzero values -> flat int16 levels in `out` (L coeffs; the caller
// allocates ceil(L/16)*16 so the tail block never lands out of
// bounds). One O(nval) scatter instead of numpy's three boolean index
// passes over the full vector (~25 M coeffs per 1080p GOP). `out` MUST
// arrive zeroed — the Python wrappers hand a fresh np.zeros (calloc)
// buffer, so the zero fill is lazy OS zero-pages instead of a 50 MB
// memset per GOP. Returns 0, or -1 when the streams disagree with the
// counts (corrupt transfer).
template <typename MaskAt>
static int64_t sparse_unpack2_core(int32_t nblk, int32_t nval,
                                   const uint8_t* bitmap, MaskAt mask_at,
                                   const int8_t* vals, int16_t* out,
                                   int64_t L) {
  const int64_t NB = (L + 15) / 16;
  int32_t bi = 0, vi = 0;
  int64_t b = 0;
  for (; b < NB && bi < nblk; b++) {
    if (!(bitmap[b >> 3] & (0x80u >> (b & 7)))) continue;
    uint32_t m = mask_at(bi++);
    if (vi + __builtin_popcount(m) > nval) return -1;
    int16_t* o = out + b * 16;
    while (m) {
      const int k = __builtin_ctz(m);
      m &= m - 1;
      o[k] = vals[vi++];
    }
  }
  if (bi != nblk || vi != nval) return -1;
  // Any set bit AFTER the nblk-th live block is a corrupt bitmap too —
  // it must fail loudly like the numpy reference, not decode those
  // blocks as silent zeros. Byte-granular tail scan.
  const int64_t nbytes = (NB + 7) / 8;
  int64_t byte = b >> 3;
  if (byte < nbytes) {
    if (bitmap[byte] & (0xFFu >> (b & 7))) return -1;
    for (byte++; byte < nbytes; byte++)
      if (bitmap[byte]) return -1;
  }
  return 0;
}

}  // namespace

extern "C" {

void cavlc_init_tables(const int32_t* coeff_token, const int32_t* chroma_dc,
                       const int32_t* total_zeros, const int32_t* tz_chroma,
                       const int32_t* run_before) {
  std::memcpy(g_coeff_token, coeff_token, sizeof(g_coeff_token));
  std::memcpy(g_chroma_dc_token, chroma_dc, sizeof(g_chroma_dc_token));
  std::memcpy(g_total_zeros, total_zeros, sizeof(g_total_zeros));
  std::memcpy(g_tz_chroma, tz_chroma, sizeof(g_tz_chroma));
  std::memcpy(g_run_before, run_before, sizeof(g_run_before));
  build_level_table();
  g_tables_ready = true;
}

int64_t cavlc_pack_islice(
    const uint8_t* header_bytes, int32_t header_bit_len,
    const int32_t* luma_mode, const int32_t* chroma_mode,
    const int32_t* luma_dc, const int32_t* luma_ac,
    const int32_t* chroma_dc, const int32_t* chroma_ac,
    int32_t mbw, int32_t mbh, uint8_t* out, int64_t out_cap,
    const int8_t* qp_delta) {
  return pack_islice_impl(header_bytes, header_bit_len, luma_mode,
                          chroma_mode, luma_dc, luma_ac, chroma_dc,
                          chroma_ac, mbw, mbh, out, out_cap, qp_delta);
}

// int16 entry: packs the flat transfer layout's level views directly.
int64_t cavlc_pack_islice16(
    const uint8_t* header_bytes, int32_t header_bit_len,
    const int32_t* luma_mode, const int32_t* chroma_mode,
    const int16_t* luma_dc, const int16_t* luma_ac,
    const int16_t* chroma_dc, const int16_t* chroma_ac,
    int32_t mbw, int32_t mbh, uint8_t* out, int64_t out_cap,
    const int8_t* qp_delta) {
  return pack_islice_impl(header_bytes, header_bit_len, luma_mode,
                          chroma_mode, luma_dc, luma_ac, chroma_dc,
                          chroma_ac, mbw, mbh, out, out_cap, qp_delta);
}

// Host inverse of torchcore._block_sparse_pack2 over the three separate
// budget-padded arrays (the non-compact transfer path).
int64_t cavlc_sparse_unpack2(
    int32_t nblk, int32_t nval,
    const uint8_t* bitmap, const uint16_t* bmask16, const int8_t* vals,
    int16_t* out, int64_t L) {
  return sparse_unpack2_core(
      nblk, nval, bitmap,
      [bmask16](int32_t i) { return (uint32_t)bmask16[i]; }, vals, out, L);
}

// Host inverse of torchcore._compact_stream: ONE contiguous payload
// (bitmap | bmask16 little-endian byte pairs | int8 vals — see
// codecs/h264/layout.py for the format) -> flat int16 levels, no
// intermediate stream views or copies. The lane masks are read as byte
// pairs because the vals section's start (nb8 + 2*nblk) gives the
// payload no alignment guarantee. Returns 0, -1 on count/stream
// disagreement, -2 when the payload is shorter than the counts demand.
int64_t cavlc_unpack_compact(
    int32_t nblk, int32_t nval,
    const uint8_t* payload, int64_t payload_len,
    int16_t* out, int64_t L) {
  const int64_t NB = (L + 15) / 16;
  const int64_t nb8 = (NB + 7) / 8;
  if (payload_len < nb8 + 2 * (int64_t)nblk + nval) return -2;
  const uint8_t* mb = payload + nb8;
  const int8_t* vals =
      (const int8_t*)(payload + nb8 + 2 * (int64_t)nblk);
  return sparse_unpack2_core(
      nblk, nval, payload,
      [mb](int32_t i) {
        return (uint32_t)mb[2 * i] | ((uint32_t)mb[2 * i + 1] << 8);
      },
      vals, out, L);
}

// ---- P-slice support -------------------------------------------------------

static int32_t g_cbp_inter[48];   // coded_block_pattern -> codeNum (Table 9-4)
static bool g_inter_ready = false;

void cavlc_init_inter(const int32_t* cbp_inter_to_code) {
  std::memcpy(g_cbp_inter, cbp_inter_to_code, sizeof(g_cbp_inter));
  g_inter_ready = true;
}

static inline int32_t median3(int32_t a, int32_t b, int32_t c) {
  int32_t mn = a < b ? a : b, mx = a < b ? b : a;
  return c < mn ? mn : (c > mx ? mx : c);
}

// MV prediction (median, C->D fallback) + P_Skip predictor, §8.4.1.3/1.1.
// Shared by the blocked and plane-layout P-slice packers — their
// bit-identity contract rides on this being the single implementation.
static void compute_mv_pred(const int32_t* mv, int mbw, int mbh,
                            std::vector<int32_t>& mvp,
                            std::vector<int32_t>& skipmv) {
  const int nmb = mbw * mbh;
  mvp.resize((size_t)nmb * 2);
  skipmv.resize((size_t)nmb * 2);
  for (int my = 0; my < mbh; my++) {
    for (int mx = 0; mx < mbw; mx++) {
      const int mi = my * mbw + mx;
      const bool avail_a = mx > 0, avail_b = my > 0;
      int32_t mva[2] = {avail_a ? mv[(size_t)(mi - 1) * 2] : 0,
                        avail_a ? mv[(size_t)(mi - 1) * 2 + 1] : 0};
      int32_t mvb[2] = {avail_b ? mv[(size_t)(mi - mbw) * 2] : 0,
                        avail_b ? mv[(size_t)(mi - mbw) * 2 + 1] : 0};
      int32_t mvc[2] = {0, 0};
      bool avail_c = false;
      if (my > 0 && mx + 1 < mbw) {
        avail_c = true;
        mvc[0] = mv[(size_t)(mi - mbw + 1) * 2];
        mvc[1] = mv[(size_t)(mi - mbw + 1) * 2 + 1];
      } else if (my > 0 && mx > 0) {
        avail_c = true;
        mvc[0] = mv[(size_t)(mi - mbw - 1) * 2];
        mvc[1] = mv[(size_t)(mi - mbw - 1) * 2 + 1];
      }
      const int n_avail = (int)avail_a + (int)avail_b + (int)avail_c;
      int32_t p[2];
      if (!avail_b && !avail_c && avail_a) {
        p[0] = mva[0]; p[1] = mva[1];
      } else if (n_avail == 1) {
        if (avail_a)      { p[0] = mva[0]; p[1] = mva[1]; }
        else if (avail_b) { p[0] = mvb[0]; p[1] = mvb[1]; }
        else              { p[0] = mvc[0]; p[1] = mvc[1]; }
      } else {
        p[0] = median3(mva[0], mvb[0], mvc[0]);
        p[1] = median3(mva[1], mvb[1], mvc[1]);
      }
      mvp[(size_t)mi * 2] = p[0];
      mvp[(size_t)mi * 2 + 1] = p[1];
      if (!avail_a || !avail_b || (mva[0] == 0 && mva[1] == 0)
          || (mvb[0] == 0 && mvb[1] == 0)) {
        skipmv[(size_t)mi * 2] = 0;
        skipmv[(size_t)mi * 2 + 1] = 0;
      } else {
        skipmv[(size_t)mi * 2] = p[0];
        skipmv[(size_t)mi * 2 + 1] = p[1];
      }
    }
  }
}

// Packs one P picture (all-inter, P_L0_16x16 / P_Skip, single reference,
// half-pel MVs). mv: nmb*2 as (dy, dx); luma16: nmb*16*16 z-scan blocks
// of 16 zig-zag coeffs. Mirrors codecs/h264/inter.pack_p_slice bit-for-bit.
int64_t cavlc_pack_pslice(
    const uint8_t* header_bytes, int32_t header_bit_len,
    const int32_t* mv,
    const int32_t* luma16,
    const int32_t* chroma_dc,
    const int32_t* chroma_ac,
    int32_t mbw, int32_t mbh, uint8_t* out, int64_t out_cap) {
  if (!g_tables_ready || !g_inter_ready || mbw <= 0 || mbh <= 0) return -1;
  static const int BX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
  static const int BY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
  static const int CBX[4] = {0, 1, 0, 1};
  static const int CBY[4] = {0, 0, 1, 1};

  const int nmb = mbw * mbh;
  BitWriter bw;
  bw.buf.reserve((size_t)nmb * 16);
  for (int i = 0; i < header_bit_len / 8; i++) bw.write(header_bytes[i], 8);
  if (int rem = header_bit_len % 8)
    bw.write(header_bytes[header_bit_len / 8] >> (8 - rem), rem);

  std::vector<int32_t> mvp, skipmv;
  compute_mv_pred(mv, mbw, mbh, mvp, skipmv);

  const int lw = 4 * mbw, lh = 4 * mbh;
  const int cw = 2 * mbw, ch = 2 * mbh;
  std::vector<int32_t> lcnt((size_t)lw * lh, 0);
  std::vector<int32_t> ccnt((size_t)2 * cw * ch, 0);
  auto luma_nc = [&](int gy, int gx) {
    return nc_from_counts(lcnt.data(), lw, gy, gx);
  };
  auto chroma_nc = [&](int ci, int gy, int gx) {
    return nc_from_counts(ccnt.data() + (size_t)ci * ch * cw, cw, gy, gx);
  };

  uint32_t skip_run = 0;
  for (int my = 0; my < mbh; my++) {
    for (int mx = 0; mx < mbw; mx++) {
      const int mi = my * mbw + mx;
      const int32_t* l16 = luma16 + (size_t)mi * 16 * 16;
      const int32_t* cdc = chroma_dc + (size_t)mi * 2 * 4;
      const int32_t* cac = chroma_ac + (size_t)mi * 2 * 4 * 15;

      int cbp_luma = 0;
      for (int g = 0; g < 4; g++)
        for (int i = 0; i < 4 * 16 && !(cbp_luma & (1 << g)); i++)
          if (l16[g * 4 * 16 + i]) cbp_luma |= 1 << g;
      int cbp_chroma = 0;
      for (int i = 0; i < 2 * 4 * 15 && cbp_chroma < 2; i++)
        if (cac[i]) cbp_chroma = 2;
      if (cbp_chroma == 0)
        for (int i = 0; i < 8 && !cbp_chroma; i++)
          if (cdc[i]) cbp_chroma = 1;
      const int cbp = cbp_luma | (cbp_chroma << 4);

      const bool is_skip = cbp == 0
          && mv[(size_t)mi * 2] == skipmv[(size_t)mi * 2]
          && mv[(size_t)mi * 2 + 1] == skipmv[(size_t)mi * 2 + 1];
      if (is_skip) {
        skip_run++;
        continue;   // neighbor counts stay 0
      }
      bw.ue(skip_run);
      skip_run = 0;
      bw.ue(0);   // mb_type = P_L0_16x16
      // mvd: horizontal first (§7.3.5.1); layout is (dy, dx). mv is in
      // half-pel units, mvd is coded in quarter-pel units.
      bw.se(2 * (mv[(size_t)mi * 2 + 1] - mvp[(size_t)mi * 2 + 1]));
      bw.se(2 * (mv[(size_t)mi * 2] - mvp[(size_t)mi * 2]));
      bw.ue((uint32_t)g_cbp_inter[cbp]);
      if (cbp) bw.se(0);   // mb_qp_delta

      const int by0 = 4 * my, bx0 = 4 * mx;
      for (int bi = 0; bi < 16; bi++) {
        int gy = by0 + BY[bi], gx = bx0 + BX[bi];
        if (cbp_luma & (1 << (bi / 4))) {
          int tc = encode_residual(bw, l16 + (size_t)bi * 16, 16,
                                   luma_nc(gy, gx));
          if (tc < 0) return -3;
          lcnt[(size_t)gy * lw + gx] = tc;
        } else {
          lcnt[(size_t)gy * lw + gx] = 0;
        }
      }
      if (cbp_chroma > 0)
        for (int ci = 0; ci < 2; ci++)
          if (encode_residual(bw, cdc + (size_t)ci * 4, 4, -1) < 0)
            return -3;
      const int cy0 = 2 * my, cx0 = 2 * mx;
      for (int ci = 0; ci < 2; ci++) {
        for (int bi = 0; bi < 4; bi++) {
          int gy = cy0 + CBY[bi], gx = cx0 + CBX[bi];
          if (cbp_chroma == 2) {
            int tc = encode_residual(bw, cac + ((size_t)ci * 4 + bi) * 15, 15,
                                     chroma_nc(ci, gy, gx));
            if (tc < 0) return -3;
            ccnt[((size_t)ci * ch + gy) * cw + gx] = tc;
          } else {
            ccnt[((size_t)ci * ch + gy) * cw + gx] = 0;
          }
        }
      }
    }
  }
  if (skip_run) bw.ue(skip_run);
  bw.trailing();

  return emit_ebsp(bw, out, out_cap);
}

// ---- plane-layout P-slice packer -------------------------------------------
//
// The sharded transfer path ships raw quantized coefficient PLANES (the
// device-side blocked relayout measured ~0.5 s/GOP on the reference device, and the host
// numpy equivalent ~0.2 s/GOP on the 1-core host — parallel/dispatch.py).
// This variant reads coefficients straight from the planes through the
// zig-zag offset table, so no relayout pass exists anywhere.

static int32_t g_zz[16];      // zigzag position -> raster index in a 4x4
static bool g_scan_ready = false;

void cavlc_init_scan_impl(const int32_t* zz) {
  std::memcpy(g_zz, zz, sizeof(g_zz));
  g_scan_ready = true;
}

// Packs one P picture from plane-layout levels. mv: nmb*2 int8 (dy, dx);
// luma_plane: (16*mbh)x(16*mbw) int16; u_dc/v_dc: nmb*4 int16 (hadamard
// domain); u_ac/v_ac: (8*mbh)x(8*mbw) int16 with DC positions zero.
// Bit-identical to cavlc_pack_pslice on the equivalent blocked arrays.
int64_t cavlc_pack_pslice_plane_impl(
    const uint8_t* header_bytes, int32_t header_bit_len,
    const int8_t* mv8,
    const int16_t* luma_plane,
    const int16_t* u_dc, const int16_t* v_dc,
    const int16_t* u_ac, const int16_t* v_ac,
    int32_t mbw, int32_t mbh, uint8_t* out, int64_t out_cap) {
  if (!g_tables_ready || !g_inter_ready || !g_scan_ready
      || mbw <= 0 || mbh <= 0)
    return -1;
  static const int BX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
  static const int BY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
  static const int CBX[4] = {0, 1, 0, 1};
  static const int CBY[4] = {0, 0, 1, 1};

  const int nmb = mbw * mbh;
  const int W = 16 * mbw;
  const int CW = 8 * mbw;
  BitWriter bw;
  bw.buf.reserve((size_t)nmb * 16);
  for (int i = 0; i < header_bit_len / 8; i++) bw.write(header_bytes[i], 8);
  if (int rem = header_bit_len % 8)
    bw.write(header_bytes[header_bit_len / 8] >> (8 - rem), rem);

  std::vector<int32_t> mv((size_t)nmb * 2);
  for (size_t i = 0; i < (size_t)nmb * 2; i++) mv[i] = mv8[i];

  std::vector<int32_t> mvp, skipmv;
  compute_mv_pred(mv.data(), mbw, mbh, mvp, skipmv);

  const int lw = 4 * mbw, lh = 4 * mbh;
  const int cw = 2 * mbw, ch = 2 * mbh;
  std::vector<int32_t> lcnt((size_t)lw * lh, 0);
  std::vector<int32_t> ccnt((size_t)2 * cw * ch, 0);
  auto luma_nc = [&](int gy, int gx) {
    return nc_from_counts(lcnt.data(), lw, gy, gx);
  };
  auto chroma_nc = [&](int ci, int gy, int gx) {
    return nc_from_counts(ccnt.data() + (size_t)ci * ch * cw, cw, gy, gx);
  };

  uint32_t skip_run = 0;
  int32_t l16[16][16];       // per-MB luma blocks, zigzag order
  int32_t cacl[2][4][15];    // per-MB chroma AC blocks, zigzag[1:]
  int32_t cdcl[2][4];
  for (int my = 0; my < mbh; my++) {
    for (int mx = 0; mx < mbw; mx++) {
      const int mi = my * mbw + mx;

      // gather this MB's coefficients from the planes (zigzag order)
      for (int bi = 0; bi < 16; bi++) {
        const int r0 = my * 16 + BY[bi] * 4;
        const int c0 = mx * 16 + BX[bi] * 4;
        for (int k = 0; k < 16; k++) {
          const int zz = g_zz[k];
          l16[bi][k] = luma_plane[(size_t)(r0 + (zz >> 2)) * W + c0 + (zz & 3)];
        }
      }
      for (int ci = 0; ci < 2; ci++) {
        const int16_t* plane = ci == 0 ? u_ac : v_ac;
        const int16_t* dc = ci == 0 ? u_dc : v_dc;
        for (int bi = 0; bi < 4; bi++) {
          const int r0 = my * 8 + CBY[bi] * 4;
          const int c0 = mx * 8 + CBX[bi] * 4;
          for (int k = 1; k < 16; k++) {
            const int zz = g_zz[k];
            cacl[ci][bi][k - 1] =
                plane[(size_t)(r0 + (zz >> 2)) * CW + c0 + (zz & 3)];
          }
        }
        for (int j = 0; j < 4; j++) cdcl[ci][j] = dc[(size_t)mi * 4 + j];
      }

      int cbp_luma = 0;
      for (int g = 0; g < 4; g++)
        for (int bi = g * 4; bi < g * 4 + 4 && !(cbp_luma & (1 << g)); bi++)
          for (int k = 0; k < 16; k++)
            if (l16[bi][k]) { cbp_luma |= 1 << g; break; }
      int cbp_chroma = 0;
      for (int ci = 0; ci < 2 && cbp_chroma < 2; ci++)
        for (int bi = 0; bi < 4 && cbp_chroma < 2; bi++)
          for (int k = 0; k < 15; k++)
            if (cacl[ci][bi][k]) { cbp_chroma = 2; break; }
      if (cbp_chroma == 0)
        for (int ci = 0; ci < 2 && !cbp_chroma; ci++)
          for (int j = 0; j < 4; j++)
            if (cdcl[ci][j]) { cbp_chroma = 1; break; }
      const int cbp = cbp_luma | (cbp_chroma << 4);

      const bool is_skip = cbp == 0
          && mv[(size_t)mi * 2] == skipmv[(size_t)mi * 2]
          && mv[(size_t)mi * 2 + 1] == skipmv[(size_t)mi * 2 + 1];
      if (is_skip) {
        skip_run++;
        continue;
      }
      bw.ue(skip_run);
      skip_run = 0;
      bw.ue(0);   // mb_type = P_L0_16x16
      // mv half-pel -> mvd quarter-pel (see above).
      bw.se(2 * (mv[(size_t)mi * 2 + 1] - mvp[(size_t)mi * 2 + 1]));
      bw.se(2 * (mv[(size_t)mi * 2] - mvp[(size_t)mi * 2]));
      bw.ue((uint32_t)g_cbp_inter[cbp]);
      if (cbp) bw.se(0);   // mb_qp_delta

      const int by0 = 4 * my, bx0 = 4 * mx;
      for (int bi = 0; bi < 16; bi++) {
        int gy = by0 + BY[bi], gx = bx0 + BX[bi];
        if (cbp_luma & (1 << (bi / 4))) {
          int tc = encode_residual(bw, l16[bi], 16, luma_nc(gy, gx));
          if (tc < 0) return -3;
          lcnt[(size_t)gy * lw + gx] = tc;
        } else {
          lcnt[(size_t)gy * lw + gx] = 0;
        }
      }
      if (cbp_chroma > 0)
        for (int ci = 0; ci < 2; ci++)
          if (encode_residual(bw, cdcl[ci], 4, -1) < 0)
            return -3;
      const int cy0 = 2 * my, cx0 = 2 * mx;
      for (int ci = 0; ci < 2; ci++) {
        for (int bi = 0; bi < 4; bi++) {
          int gy = cy0 + CBY[bi], gx = cx0 + CBX[bi];
          if (cbp_chroma == 2) {
            int tc = encode_residual(bw, cacl[ci][bi], 15,
                                     chroma_nc(ci, gy, gx));
            if (tc < 0) return -3;
            ccnt[((size_t)ci * ch + gy) * cw + gx] = tc;
          } else {
            ccnt[((size_t)ci * ch + gy) * cw + gx] = 0;
          }
        }
      }
    }
  }
  if (skip_run) bw.ue(skip_run);
  bw.trailing();

  return emit_ebsp(bw, out, out_cap);
}

void cavlc_init_scan(const int32_t* zz) { cavlc_init_scan_impl(zz); }

int64_t cavlc_pack_pslice_plane(
    const uint8_t* header_bytes, int32_t header_bit_len,
    const int8_t* mv8,
    const int16_t* luma_plane,
    const int16_t* u_dc, const int16_t* v_dc,
    const int16_t* u_ac, const int16_t* v_ac,
    int32_t mbw, int32_t mbh, uint8_t* out, int64_t out_cap) {
  return cavlc_pack_pslice_plane_impl(
      header_bytes, header_bit_len, mv8, luma_plane, u_dc, v_dc, u_ac,
      v_ac, mbw, mbh, out, out_cap);
}

}  // extern "C"
