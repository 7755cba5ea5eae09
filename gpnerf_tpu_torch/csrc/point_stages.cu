// Point-stage megakernel of the progressive renderer, for Hopper (sm_90a).
//
// Replaces the TPU kernel gpnerf_tpu/ops/pallas_point.py::_point_kernel
// (called through fused_point_stages_from_tables). Each thread fetches its
// own rows: it takes the point (world and dhw voxel coordinates), the
// cameras KE (V, 4, 4) and the tables themselves: each projection quad
// table (V, Ht+1, Wt+1, 4Ct) flat, each geometry table's flat rows with its
// row strides and valid extent (`Fetch`). Per view it projects the point,
// normalises the pixel, and per projection table computes the quad row and
// the 4 tap weights with the in-bounds masks folded in, and the view mask
// (ops/projection.py compute_projections, normalize_pixels, inbound_mask;
// ops/grid_sample.py _quad_base, _quad_tap_weights); per geometry table the
// octet row and its 8 corner weights or the nearest row and its weight,
// zeros outside the extent (octet_rows_and_weights,
// nearest_row_and_weight). Float32 in the torch code's order of
// operations, each rounding explicit (the projection's sum over j = 0..3 in
// order, fused multiply-adds as the card's float32 matrix product), integer
// indices in 64 bits, row offsets in size_t. The (P, F) feature input of
// form (b) is read by point.
// One source, one instantiation per compilation, chosen by four macros
// (ops/point_stages.py derives them from the key of a call and builds each
// key at its first use):
//   PS_ROW_A, PS_ROW_B  the element type of each projection table's quad
//               rows (enum Row: 1 int8, 2 uint8, 3 int4 split-packed, 4
//               bf16, 5 float32); PS_ROW_B 0 means one table.
//               One table: the merged [rgb|feat] table, C = 35 channels, 4
//               bilinear taps per row: int8 codes with per-channel dequant
//               (the fast mode, form (a)), or bf16 / float32 rows with a
//               unit scale (merge_src_feat, or quantize_proj off).
//               Two tables, form (c): the source rgb rows (3 channels: the
//               raw u8 pixels with a 1/255 dequant, or bf16 / float32
//               values) and the feature-grid rows (32 channels: int8 codes,
//               int4 codes (form (d)), or bf16 / float32 values), each with
//               its own tap weights, lerped and concatenated to the same
//               [rgb 3 | feat 32] channel order. int4 rows are 64 bytes: tap
//               k in bytes [16k, 16k+16), byte j = channel j (low nibble)
//               and channel j + 16 (high nibble), two's complement,
//               sign-extended as (n ^ 8) - 8;
//   PS_G0 .. PS_G3  the geometry tables, in the order their lerped channel
//               blocks join into the F-channel geometry feature (the TPU
//               kernel's geom_specs (Tg, Cg) with each table's row type),
//               each as row type * 10000 + taps * 1000 + channels, 0 = no
//               table: taps 8 = octet rows (the 8 corners of a trilinear
//               cell, corner k's channels at [k * Cg, (k + 1) * Cg)), taps
//               1 = nearest rows (any count from 1 to 8 is summed alike);
//               row types 1 int8, 2 uint8, 4 bf16, 5 float32, each with a
//               per-channel dequant scale (unit for float rows); channels a
//               multiple of 32. The shipped default
//               is 28032, 11064: the u8 level-1 octet table and the int8
//               folded-coarse nearest table, F = 96. Row type 6, PS_G0 =
//               61000 + F, is form (b): the (P, F) float32 geometry feature
//               is an input, queried outside; row type 7, PS_G0 = 71000 +
//               F, the same feature as bf16 (queried in bf16, as under
//               tpu.matmul_dtype bfloat16);
//   PS_V        the source views V (1-8), default 3;
//   PS_OCC   1  form (e), occ_geom: sigma is also zeroed where the
//               dequantized channel sum of the lerped level-1 block (table
//               0, 32 channels) is <= 0 (the trilinear occupancy), and that
//               0/1 verdict is written to a third output. All terms of the
//               sum are non-negative, so the verdict does not depend on the
//               order of the sum.
// Float rows are rounded to bf16 before the tap sum, as the TPU kernel casts
// every row (pallas_point.py _to_bf16); bf16 rows are used as they are.
//
// Per point p it computes what the TPU kernel computes on the rows it
// fetched:
//   rgbfeat[v][c] = (sum_k row_v[k*Ct+c] * w4_v[k]) * scale[c] per
//     projection table (row_v the point's quad row in view v, w4_v its tap
//     weights), channel blocks concatenated
//   mean/var over the V views
//   f[g] = (sum_k row_g[k * Cg + c] * wg[k]) * gscale_g[c] per geometry
//     table g, blocks joined: F = 96 (folded coarse tables) or 128
//   sigma_feat = ELU(W_sf f + b)  (folded: W_sf = [W[:32] | I_64]; else W)
//   density MLP 134 -> 64 -> 32 -> 16 -> 1 (ELU, ELU, ELU, ReLU) on
//     [sigma_feat, mean, var]; sigma = 0 where no view sees the point
//     (the view masks sum to < 1) or !sig_ok;
//     alpha = 1 - exp(-sigma)
//   color: per view base_fc 105 -> 64 -> 32 (ELU) on [mean, var, rgbfeat[v]],
//     vis_fc residual on h/V (32 -> 32 -> 32, ELU), rgb_fc V * 32 -> 32 ->
//     16 -> 3 (ELU, ELU, sigmoid); rgb = 0 unless alpha > 1e-14 and sig_ok.
// Every dot input (weight and activation) is rounded to bf16 and the dot
// accumulates in f32, as on the TPU; ELU is x > 0 ? x : exp(min(x, 0)) - 1.
// Taps, mean and variance are summed with explicit roundings (no FMA
// contraction) in the order the plain version uses.
//
// Bounds, bytes of input and output per point (ops/point_stages.py
// cost_from_tables: each row read once per point that fetches it, so an
// upper bound, as neighbouring points share quad and octet rows):
//   forms (a) and (c) at the default geometry: 420 quad-row bytes (3 views
//     of a 140-byte merged row, or of a 12-byte source and a 128-byte
//     feature row), 256 + 64 geometry-row bytes, 24 bytes of point
//     coordinates, 1 cull byte, 16 output bytes (20 with the occupancy
//     verdict) = 781 -> 0.25 GB per frame at the fast-mode shape (P = 13 *
//     24576 = 319,488), 74 us at 3.35 TB/s, and 2.9 GB at the
//     reference-mode shape (P = 64 * 57344 = 3,670,016), 0.86 ms. Other
//     rows change their part: bf16 merged rows 840 bytes, float32 ones
//     1,680; int4 feature rows 64; an int8 coarse octet row 512, an
//     unfolded u8 coarse octet 768, four u8 level octets 4 x 256, a u8
//     level-1 nearest row 32; the (P, 96) feature input 384 bytes in place
//     of the geometry rows and the dhw coordinates.
// About 1.1e5 flop per point: 35 us (fast shape) and 0.40 ms (reference
// shape) at the 989 TFLOP/s bf16 tensor-core rate. So every form's bound is
// its bytes once the MLPs run on tensor cores, which they do here; the
// kernel itself stays far above that bound (see the end of this note).
//
// Design: 8 warps of 32 points per block (fewer where more views' rgb_fc
// weights leave no room for 8), one point per thread in the front end (the
// quad lerps, mean/var, the geometry lerp, the masks and the occupancy
// verdict, all in registers; the V views' lerped rows are held at once, so
// at V = 8 about 1.2 KB a thread spills to local memory). The twelve
// layers' padded bf16 weights (33,280 values, 65 KB at V = 3; 35,328 at F =
// 128), their float32 biases and the dequant scales are staged once per
// block in dynamic shared memory. The front end writes each layer input,
// rounded to bf16, into its warp's shared-memory tiles, one row per point,
// padding columns zeroed: the
// geometry feature f (a 96-column tile) and X = [sigma_feat | mean | var |
// rf_v | 0] (176 columns),
// which is layer 1's input in columns 0-143 and view v's color input in
// columns 64-175; rf_v waits in registers as bf16 pairs until its view.
// Each warp then runs every layer on its 32 points with nvcuda::wmma
// 16 x 16 x 16 bf16 fragments: per 16-wide N tile two f32 accumulators (the
// warp's two 16-row M tiles) are summed over the K tiles from shared memory
// (A row-major, ld = the tile's width; B = W^T column-major straight from
// the row-major (Cout, Cin) weight, ld = padded Cin), stored to a 2 KB f32
// scratch, and a per-thread epilogue adds the bias, applies the activation
// and writes the next layer's bf16 input (or keeps the f32 value: hv for
// the vis_fc residual, in registers). rgb_fc's first layer accumulates view
// by view, so the view concat is never stored. 19 KB per warp, 219 KB per
// block at V = 3 (223 KB at F = 128): one block per SM.
// The geometry tables are lerped 32 channels at a time, corner by corner
// (each corner's channels summed before the next corner is read, as float
// projection rows are), and each 32-column chunk goes to the f tile at
// once, so no table's whole row or block waits in registers. At F = 128
// the tile holds the first 96 columns; layer 0 then accumulates in K
// slices, as rgb_fc's first layer accumulates over views: the first
// slice's products go into eight f32 accumulator fragments (the 4 N tiles
// of both M tiles), the last 32 columns are lerped into the tile's first
// columns and added, and only then does the epilogue run. The K tiles are
// summed in the order of one whole-layer walk. Lanes past P take part in every mma_sync on zero
// rows, and skip their loads and their stores of outputs. Each thread reads
// its own rows: in 16-byte words where they are 16-byte aligned (octet,
// coarse and split int8 feature rows), else in 32-bit words (the 140-byte
// merged and 12-byte source rows); bytes or nibbles are extracted with
// shifts. Float rows (280 to 560 bytes) are streamed tap by tap, each tap's
// channels summed into the lerp accumulators before the next tap is read,
// so no whole row waits in registers: bf16 rows in 32-bit words (a merged
// bf16 row is 280 bytes, so every other row sits 8 bytes off a 16-byte
// boundary), float32 rows element by element.
// Every offset is size_t: the feature rows of one reference-mode launch span
// 1.4e9 bytes.
//
// What bounds it (tools/probe_point_stages.py, H100): each warp runs one
// long dependent chain, so the time fell with the warps per SM (2, 3, 4, 8
// measured) and not with padding the shared-memory rows against bank
// conflicts. The tensor-core products are a small part of the chain; the
// front end (per-thread row loads, the mean/variance divisions) and the
// per-tile store / epilogue / reload round trips are most of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

#ifndef PS_ROW_A
#define PS_ROW_A 1
#endif
#ifndef PS_ROW_B
#define PS_ROW_B 0
#endif
#ifndef PS_G0
#define PS_G0 28032
#define PS_G1 11064
#endif
#ifndef PS_G1
#define PS_G1 0
#endif
#ifndef PS_G2
#define PS_G2 0
#endif
#ifndef PS_G3
#define PS_G3 0
#endif
#ifndef PS_OCC
#define PS_OCC 0
#endif
#ifndef PS_V
#define PS_V 3
#endif

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

enum Row { NONE = 0, I8 = 1, U8 = 2, I4 = 3, BF16 = 4, F32 = 5, FEAT = 6, FEAT_BF16 = 7 };

constexpr int V = PS_V;  // source views
static_assert(V >= 1 && V <= 8, "1 to 8 source views");
constexpr int CS = 3;    // source rgb channels
constexpr int CF = 32;   // encoder feature channels
constexpr int C = CS + CF;  // [rgb | feat] channels, merged or concatenated
constexpr int T = 4;     // bilinear taps per quad row
constexpr int NL = 12;   // MLP layers

// The geometry tables (PS_G0 .. PS_G3): row type, taps, channels.
struct Geom {
  int row, taps, ch;
};
constexpr int GCODE[4] = {PS_G0, PS_G1, PS_G2, PS_G3};
constexpr Geom GEO[4] = {{GCODE[0] / 10000, GCODE[0] / 1000 % 10, GCODE[0] % 1000},
                         {GCODE[1] / 10000, GCODE[1] / 1000 % 10, GCODE[1] % 1000},
                         {GCODE[2] / 10000, GCODE[2] / 1000 % 10, GCODE[2] % 1000},
                         {GCODE[3] / 10000, GCODE[3] / 1000 % 10, GCODE[3] % 1000}};
__host__ __device__ constexpr int geo_count(int g = 0) { return g < 4 && GCODE[g] != 0 ? geo_count(g + 1) : g; }
constexpr int NG = geo_count();
// first feature column of table g; FT = the geometry feature's width F
__host__ __device__ constexpr int geo_col(int g) { return g == 0 ? 0 : geo_col(g - 1) + GEO[g - 1].ch; }
constexpr int FT = geo_col(NG);
// the table holding feature column `col`
__host__ __device__ constexpr int geo_table(int col, int g = 0) {
  return col < geo_col(g + 1) ? g : geo_table(col, g + 1);
}
__host__ __device__ constexpr bool geo_ok(int g = 0) {
  return g == NG ||
         (GEO[g].ch % 32 == 0 && GEO[g].ch > 0 &&
          (GEO[g].row >= FEAT ? GEO[g].row <= FEAT_BF16 && NG == 1 && GEO[g].taps == 1
                              : GEO[g].taps >= 1 && GEO[g].taps <= 8 &&
                                    (GEO[g].row == I8 || GEO[g].row == U8 || GEO[g].row == BF16 ||
                                     GEO[g].row == F32)) &&
          geo_ok(g + 1));
}
constexpr bool FEATS = GEO[0].row == FEAT || GEO[0].row == FEAT_BF16;  // form (b)
static_assert(NG >= 1 && geo_ok(), "geometry tables: 1-4 of 1-8 taps, 32k channels");
static_assert((NG > 1 || GCODE[1] == 0) && (NG > 2 || GCODE[2] == 0) && (NG > 3 || GCODE[3] == 0),
              "geometry tables are PS_G0 .. PS_G<NG - 1>");
static_assert(!PS_OCC || (!FEATS && GEO[0].ch == 32), "occ_geom reads table 0's 32 level-1 channels");
// layer order: sigma-feat, density d0..d3, base b0 b1, vis v0 v1, rgb r0..r2
constexpr int CIN[NL] = {FT, 64 + 2 * C, 64, 32, 16, 3 * C, 64, 32, 32, V * 32, 32, 16};
constexpr int COUT[NL] = {64, 64, 32, 16, 1, 64, 32, 32, 32, 32, 16, 3};

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int kp(int l) { return pad16(CIN[l]); }
__host__ __device__ constexpr int np(int l) { return pad16(COUT[l]); }
// bf16 offset of layer l's (np, kp) row-major weight; float offset of its bias
__host__ __device__ constexpr int woff(int l) { return l == 0 ? 0 : woff(l - 1) + np(l - 1) * kp(l - 1); }
__host__ __device__ constexpr int boff(int l) { return l == 0 ? 0 : boff(l - 1) + COUT[l - 1]; }

// Shared memory, in bytes: the packed weight buffer (bf16 weights, then
// float32 biases) as the wrapper passes it, the dequant scales, then one
// set of tiles per warp (19 KB): 8 warps where they fit, else as many as
// fit (rgb_fc's weights grow by 2 KB per view: at F = 96 8 warps hold V <=
// 6, at F = 128 V <= 4).
constexpr int WELEMS = woff(NL);                        // 33,280 bf16
constexpr int WBUF_BYTES = WELEMS * 2 + boff(NL) * 4;   // 68,112 (72,208 at F = 128)
constexpr int SCALE_OFF = WBUF_BYTES;                   // pscale (C), the geometry scales (FT)
constexpr int WARP_OFF = (SCALE_OFF + (C + FT) * 4 + 127) / 128 * 128;
// A warp's tiles, 32 rows each. X = [sigma_feat | mean | var | rf_v | 0]
// (bf16): layer 1 reads columns 0-143 (the density input; rf_v's first ten
// columns meet layer 1's zero padding columns), layer 5 columns 64-175 (view
// v's color input, rf_v rewritten per view). F = the geometry feature
// (bf16; at F = 128 its K slices in turn), later the hidden layers' tiles.
// Then the f32 scratch of one N tile.
constexpr int KX = 64 + kp(5), KF = 96;                // 176, 96
constexpr int NT0 = np(0) / 16;                        // layer 0's N tiles
static_assert(FT <= 2 * KF && KF % 32 == 0, "layer 0 takes at most two K slices");
constexpr int WARP_BYTES = (32 * KX + 32 * KF) * 2 + 32 * 16 * 4;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have
constexpr int WARPS_FIT = (SMEM_LIMIT - WARP_OFF) / WARP_BYTES;
constexpr int WARPS = WARPS_FIT < 8 ? WARPS_FIT : 8;
constexpr int BLOCK = 32 * WARPS;  // one point per thread
constexpr int SMEM_BYTES = WARP_OFF + WARPS * WARP_BYTES;
static_assert(WBUF_BYTES % 16 == 0, "weight buffer staged in 16-byte words");
static_assert(WARPS >= 1 && SMEM_BYTES <= SMEM_LIMIT, "more shared memory than a block may have");
static_assert(kp(1) <= KX && CIN[1] == 64 + 2 * C && CIN[5] == 3 * C, "X holds both inputs");
static_assert(64 + 32 <= KF, "hb and hvs share F");

enum Act { ELU = 0, RELU = 1, SIGMOID = 2 };

// ELU(x) = x > 0 ? x : exp(x) - 1, written without a branch: for x > 0 it
// adds exp(0) - 1 = 0, for x <= 0 it adds the exp term to fmax(x, 0) = 0, so
// the value is the same bit for bit. The select compiles to a branch around
// each exp, which keeps a tile's 16 epilogue elements from overlapping.
template <int ACT>
__device__ __forceinline__ float act(float x) {
  if (ACT == ELU) return fmaxf(x, 0.f) + (expf(fminf(x, 0.f)) - 1.f);
  if (ACT == RELU) return fmaxf(x, 0.f);
  return 1.f / (1.f + expf(-x));
}

// N tile n of one layer on a warp's 32 rows: x (32 x kp(L) bf16, row stride
// ldx, padding columns 0) times W^T. The two 16-row M tiles accumulate in
// f32 over the K tiles and land in the scratch s (32 x 16 f32, row-major),
// which every lane may read on return.
template <int L>
__device__ __forceinline__ void mma_tile(const bf16* w, const bf16* x, int ldx, int n, float* s) {
  constexpr int K = kp(L), WO = woff(L);
  const bf16* wn = w + WO + n * 16 * K;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
  wmma::fill_fragment(acc0, 0.f);
  wmma::fill_fragment(acc1, 0.f);
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
    wmma::load_matrix_sync(b, wn + k * 16, K);
    wmma::load_matrix_sync(a0, x + k * 16, ldx);
    wmma::load_matrix_sync(a1, x + 16 * ldx + k * 16, ldx);
    wmma::mma_sync(acc0, a0, b, acc0);
    wmma::mma_sync(acc1, a1, b, acc1);
  }
  wmma::store_matrix_sync(s, acc0, 16, wmma::mem_row_major);
  wmma::store_matrix_sync(s + 16 * 16, acc1, 16, wmma::mem_row_major);
  __syncwarp();
}

// A whole layer: every N tile, each followed by epi(n, s) on every lane.
template <int L, class Epi>
__device__ __forceinline__ void layer(const bf16* w, const bf16* x, int ldx, float* s, Epi epi) {
  constexpr int NT = np(L) / 16;
#pragma unroll 1
  for (int n = 0; n < NT; ++n) {
    mma_tile<L>(w, x, ldx, n, s);
    epi(n, s);
    __syncwarp();
  }
}

// Epilogue: out[r][16n + c] = bf16(act(s[r][c] + bias)). Lane l owns column
// c = l % 16 and rows 2j + l / 16, so s[r][c] = s[32j + l]. All 16 loads come
// before the first store: s and out may alias as far as the compiler knows, so
// a load after a store would wait for it, one element at a time.
template <int L, int ACT>
__device__ __forceinline__ auto to_tile(const float* bias, bf16* out, int ldo) {
  static_assert(COUT[L] % 16 == 0, "a padded output needs its own epilogue");
  return [=](int n, const float* s) {
    constexpr int BO = boff(L);
    const int lane = threadIdx.x & 31, col = n * 16 + (lane & 15);
    const float b = bias[BO + col];
    float y[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) y[j] = s[32 * j + lane];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      out[(2 * j + (lane >> 4)) * ldo + col] = __float2bfloat16_rn(act<ACT>(y[j] + b));
  };
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// dst[i] = bf16(get(i)) for i < N (N a multiple of 8), in 16-byte stores
template <int N, class Get>
__device__ __forceinline__ void put_row(bf16* dst, Get get) {
#pragma unroll
  for (int g = 0; g < N / 8; ++g)
    reinterpret_cast<uint4*>(dst)[g] = make_uint4(
        bf16x2(get(8 * g), get(8 * g + 1)), bf16x2(get(8 * g + 2), get(8 * g + 3)),
        bf16x2(get(8 * g + 4), get(8 * g + 5)), bf16x2(get(8 * g + 6), get(8 * g + 7)));
}

__device__ __forceinline__ float sbyte(uint32_t word, int s) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * s)) & 0xffu));
}
__device__ __forceinline__ float ubyte(uint32_t word, int s) {
  return static_cast<float>((word >> (8 * s)) & 0xffu);
}
// nibble `n` (0..7, low nibble of byte 0 first) of a word, sign-extended
__device__ __forceinline__ float snibble(uint32_t word, int n) {
  return static_cast<float>(static_cast<int>(((word >> (4 * n)) & 0xfu) ^ 8u) - 8);
}

// What the kernel fetches from, beside the tables: the points, the cameras
// and every table's grid. Filled on the host (the
// wrapper's ctypes structure of the same layout) and passed by value.
struct Fetch {
  const float* pts;  // (P, 3) world points
  const float* dhw;  // (P, 3) the same in level-0 voxel units, d h w
  const float* ke;   // (V, 4, 4) the source cameras, K [R | t]
  int neg;           // THuman's convention: in front where the depth is < 0
  int src_h, src_w;  // the source images' size, the pixel frame of ke
  int quad_h[2], quad_w[2];  // each projection table's grid (Ht, Wt)
  int out_sh[3];             // the frame's level-0 extent
  int geo_dims[4][3];        // each geometry table's row strides (Dp, Hp, Wp) or (D, H, W)
  int geo_size[4][3];        // each geometry table's valid extent
};

// Device pointers of one launch; tables a form does not read are null.
struct Args {
  const uint8_t* rows_a;  // the merged quad table's flat rows, or the source rgb table's
  const float* scale_a;
  const uint8_t* rows_b;  // two tables: the feature table's flat rows
  const float* scale_b;
  const uint8_t* g_rows[4];  // geometry table g's flat rows (the (P, F) float input for form (b))
  const float* g_scale[4];    // its dequant scale (channels)
  const uint8_t* sig_ok;
  const uint4* wbuf;
  float* alpha_out;
  float* rgb_out;
  float* occm_out;
  Fetch f;
};

static_assert(FEATS || ((NG < 1 || GEO[0].taps == 8 || GEO[0].taps == 1) &&
                                  (NG < 2 || GEO[1].taps == 8 || GEO[1].taps == 1) &&
                                  (NG < 3 || GEO[2].taps == 8 || GEO[2].taps == 1) &&
                                  (NG < 4 || GEO[3].taps == 8 || GEO[3].taps == 1)),
              "the kernel fetches octet (8 taps) and nearest (1 tap) rows");

// The point's pixel in view v (ops/projection.py compute_projections and
// normalize_pixels): proj = KE[v] [x y z 1]^T summed over j = 0..3 in order
// as fused multiply-adds from the first product, as the card's float32
// matrix product (cuBLAS) evaluates the einsum, the pixel proj[:2] /
// proj[2] clamped to +-1e6 (NaN kept, as torch's clamp keeps it),
// normalised to [-1, 1] by the source size; vm the view mask (in bounds of
// the source image and in front of the camera).
struct Pixel {
  float nx, ny, vm;
};
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ Pixel project(const Fetch& f, int v, float x, float y, float z) {
  const float* k = f.ke + 16 * v;
  float pr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pr[i] = __fadd_rn(__fmaf_rn(__ldg(k + 4 * i + 2), z, __fmaf_rn(__ldg(k + 4 * i + 1), y, __fmul_rn(__ldg(k + 4 * i), x))),
                      __ldg(k + 4 * i + 3));  // the fma with the homogeneous 1: one rounded add
  const float px = clamp_keep_nan(__fdiv_rn(pr[0], pr[2]), -1e6f, 1e6f);
  const float py = clamp_keep_nan(__fdiv_rn(pr[1], pr[2]), -1e6f, 1e6f);
  const bool front = f.neg ? pr[2] < 0.f : pr[2] > 0.f;
  const float wm1 = static_cast<float>(f.src_w) - 1.f, hm1 = static_cast<float>(f.src_h) - 1.f;
  const bool inb = px <= wm1 && px >= 0.f && py <= hm1 && py >= 0.f;
  return {__fsub_rn(__fdiv_rn(__fmul_rn(2.f, px), wm1), 1.f),
          __fsub_rn(__fdiv_rn(__fmul_rn(2.f, py), hm1), 1.f), inb && front ? 1.f : 0.f};
}

// Quad row of view v and its 4 tap weights on projection table t's (h, w)
// grid (ops/grid_sample.py _quad_base and _quad_tap_weights): the
// unnormalised footprint, the base clipped into the table's [-1, size - 1]
// coverage, each tap's bilinear weight times its in-bounds mask. Returns
// the row's index among the table's V * (h + 1) * (w + 1) rows.
__device__ __forceinline__ size_t quad_fetch(const Fetch& f, int t, int v, const Pixel& px, float (&tw)[T]) {
  const int h = f.quad_h[t], w = f.quad_w[t];
  const float x = __fmul_rn(__fmul_rn(__fadd_rn(px.nx, 1.f), 0.5f), static_cast<float>(w - 1));
  const float y = __fmul_rn(__fmul_rn(__fadd_rn(px.ny, 1.f), 0.5f), static_cast<float>(h - 1));
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx1 = __fsub_rn(x, x0), wy1 = __fsub_rn(y, y0);
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  const long long xi = static_cast<long long>(x0), yi = static_cast<long long>(y0);
  const auto in = [&](long long xa, long long ya) { return xa >= 0 && xa <= w - 1 && ya >= 0 && ya <= h - 1 ? 1.f : 0.f; };
  tw[0] = __fmul_rn(__fmul_rn(wx0, wy0), in(xi, yi));
  tw[1] = __fmul_rn(__fmul_rn(wx1, wy0), in(xi + 1, yi));
  tw[2] = __fmul_rn(__fmul_rn(wx0, wy1), in(xi, yi + 1));
  tw[3] = __fmul_rn(__fmul_rn(wx1, wy1), in(xi + 1, yi + 1));
  const long long xc = xi < -1 ? -1 : xi > w - 1 ? w - 1 : xi;
  const long long yc = yi < -1 ? -1 : yi > h - 1 ? h - 1 : yi;
  return static_cast<size_t>(v) * (static_cast<size_t>(h + 1) * (w + 1)) +
         static_cast<size_t>((yc + 1) * (w + 1) + xc + 1);
}

// Row of geometry table G at the point and its tap weights
// (ops/grid_sample.py octet_rows_and_weights, nearest_row_and_weight), at
// pos = (dhw / out_sh) * (size - 1) per axis. Octet tables (8 taps): the
// cell's base floored, clipped into [-1, dims - 2] + 1, the 8 corner weights
// in (dz, dy, dx) order, each product rounded as the torch code rounds it,
// times the corner's in-extent mask. Nearest tables (1 tap): the position
// rounded half to even, clipped into [0, dims - 1], weight 1 inside the
// extent, else 0. Returns the row's index.
template <int G>
__device__ __forceinline__ size_t geom_fetch(const Fetch& f, int p, float (&w)[8]) {
  constexpr int TAPS = GEO[G].taps;
  const int* dims = f.geo_dims[G];
  const int* size = f.geo_size[G];
  float pos[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
    pos[ax] = __fmul_rn(__fdiv_rn(__ldg(f.dhw + 3 * static_cast<size_t>(p) + ax), static_cast<float>(f.out_sh[ax])),
                        static_cast<float>(size[ax] - 1));
  if constexpr (TAPS == 8) {
    float w0[3], w1[3];
    long long b[3], bc[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float fl = floorf(pos[ax]);
      b[ax] = static_cast<long long>(fl);
      w1[ax] = __fsub_rn(pos[ax], fl);
      w0[ax] = __fsub_rn(1.f, w1[ax]);
      bc[ax] = (b[ax] < -1 ? -1 : b[ax]) + 1;
      bc[ax] = bc[ax] < dims[ax] - 1 ? bc[ax] : dims[ax] - 1;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s0 = k >> 2, s1 = (k >> 1) & 1, s2 = k & 1;
      const bool in = b[0] + s0 >= 0 && b[0] + s0 < size[0] && b[1] + s1 >= 0 && b[1] + s1 < size[1] &&
                      b[2] + s2 >= 0 && b[2] + s2 < size[2];
      w[k] = __fmul_rn(__fmul_rn(__fmul_rn(s0 ? w1[0] : w0[0], s1 ? w1[1] : w0[1]), s2 ? w1[2] : w0[2]),
                       in ? 1.f : 0.f);
    }
    return (static_cast<size_t>(bc[0]) * dims[1] + static_cast<size_t>(bc[1])) * dims[2] + static_cast<size_t>(bc[2]);
  } else {
    static_assert(TAPS == 1, "octet or nearest rows");
    long long c[3], cc[3];
    bool in = true;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      c[ax] = static_cast<long long>(rintf(pos[ax]));
      in = in && c[ax] >= 0 && c[ax] < size[ax];
      cc[ax] = c[ax] < 0 ? 0 : c[ax];
      cc[ax] = cc[ax] < dims[ax] - 1 ? cc[ax] : dims[ax] - 1;
    }
    w[0] = in ? 1.f : 0.f;
    return (static_cast<size_t>(cc[0]) * dims[1] + static_cast<size_t>(cc[1])) * dims[2] + static_cast<size_t>(cc[2]);
  }
}

// acc = sum_k byte(k * CT + c) * tw[k], taps in order, explicit roundings
template <int CT, bool SIGNED, int NW>
__device__ __forceinline__ float lerp_bytes(const uint32_t (&wd)[NW], const float (&tw)[T], int c) {
  float acc = __fmul_rn(SIGNED ? sbyte(wd[c >> 2], c & 3) : ubyte(wd[c >> 2], c & 3), tw[0]);
#pragma unroll
  for (int k = 1; k < T; ++k) {
    const int b = k * CT + c;
    acc = __fadd_rn(acc, __fmul_rn(SIGNED ? sbyte(wd[b >> 2], b & 3) : ubyte(wd[b >> 2], b & 3), tw[k]));
  }
  return acc;
}

// bytes of one quad row of CT channels stored as `row`
__host__ __device__ constexpr int row_bytes(int row, int ct) {
  return T * (row == I4 ? ct / 2 : row == BF16 ? 2 * ct : row == F32 ? 4 * ct : ct);
}

// bf16 bits -> float (exact)
__device__ __forceinline__ float bf16_bits(uint32_t h) { return __uint_as_float(h << 16); }

// One table's quad lerp + dequant for the point's row `vp`:
// rf[off + c] = (sum_k row[k * CT + c] * tw[k]) * scale[c], c < CT, taps in
// order with explicit roundings (the plain version's order). `off` is a
// constant once the caller's view loop is unrolled, so rf stays in registers.
template <int ROW, int CT>
__device__ __forceinline__ void lerp_table(const uint8_t* rows, size_t vp, const float (&tw)[T],
                                           const float* scale, float (&rf)[V * C], int off) {
  constexpr int NB = row_bytes(ROW, CT);
  const uint8_t* const base = rows + vp * NB;
  if constexpr (ROW == I8 || ROW == U8 || ROW == I4) {
    // the whole row in registers: 16-byte words where every row is 16-byte
    // aligned, else 32-bit words
    uint32_t wd[NB / 4];
    if constexpr (NB % 16 == 0) {
      const uint4* row = reinterpret_cast<const uint4*>(base);
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) {
        const uint4 q = __ldg(row + j);
        wd[4 * j] = q.x, wd[4 * j + 1] = q.y, wd[4 * j + 2] = q.z, wd[4 * j + 3] = q.w;
      }
    } else {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(base);
#pragma unroll
      for (int j = 0; j < NB / 4; ++j) wd[j] = __ldg(row + j);
    }
    if constexpr (ROW == I4) {
      constexpr int HB = CT / 2;  // bytes per tap
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        // channel c: byte c % HB of each tap, low nibble for c < HB
        const int n0 = 2 * (c % HB) + c / HB;  // nibble index within the tap
        float acc = __fmul_rn(snibble(wd[n0 >> 3], n0 & 7), tw[0]);
#pragma unroll
        for (int k = 1; k < T; ++k) {
          const int n = 2 * k * HB + n0;
          acc = __fadd_rn(acc, __fmul_rn(snibble(wd[n >> 3], n & 7), tw[k]));
        }
        rf[off + c] = __fmul_rn(acc, scale[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c)
        rf[off + c] = __fmul_rn(lerp_bytes<CT, ROW == I8>(wd, tw, c), scale[c]);
    }
  } else {
    // float rows, tap by tap: element e = k * CT + c
    static_assert(ROW == BF16 || ROW == F32, "row type");
#pragma unroll
    for (int k = 0; k < T; ++k) {
      float x[CT];
      if constexpr (ROW == BF16) {
        // the 32-bit words holding elements k * CT .. k * CT + CT - 1 (every
        // row starts on a 4-byte boundary: 8 * CT bytes)
        constexpr int NWT = CT / 2 + 1;
        const uint32_t* row = reinterpret_cast<const uint32_t*>(base);
        const int w0 = (k * CT) >> 1, nw = ((k * CT + CT - 1) >> 1) - w0 + 1;
        uint32_t wd[NWT];
#pragma unroll
        for (int j = 0; j < NWT; ++j) wd[j] = j < nw ? __ldg(row + w0 + j) : 0u;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int e = k * CT + c;
          x[c] = bf16_bits((wd[(e >> 1) - w0] >> (16 * (e & 1))) & 0xffffu);
        }
      } else {
        const float* row = reinterpret_cast<const float*>(base);
#pragma unroll
        for (int c = 0; c < CT; ++c) x[c] = __bfloat162float(__float2bfloat16_rn(__ldg(row + k * CT + c)));
      }
#pragma unroll
      for (int c = 0; c < CT; ++c)
        rf[off + c] = k == 0 ? __fmul_rn(x[c], tw[0]) : __fadd_rn(rf[off + c], __fmul_rn(x[c], tw[k]));
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) rf[off + c] = __fmul_rn(rf[off + c], scale[c]);
  }
}

// Table g's dequant scales into gs[geo_col(g) ...], every table in turn.
template <int G>
__device__ __forceinline__ void load_geom_scales(const Args& a, float* gs) {
  if constexpr (G < NG) {
    if constexpr (GEO[G].row < FEAT) {
      for (int i = threadIdx.x; i < GEO[G].ch; i += BLOCK)
        gs[geo_col(G) + i] = a.g_scale[G] != nullptr ? a.g_scale[G][i] : 1.f;
    }
    load_geom_scales<G + 1>(a, gs);
  }
}

// Channels 32J .. 32J + 31 of geometry table G at point p:
// f[c] = (sum_k row[k * Cg + 32J + c] * w[k]) * scale[32J + c], taps in
// order with explicit roundings (the plain version's order), one corner's
// 32 channels loaded at a time in 16-byte words (every row and every
// corner's 32-channel run is 16-byte aligned); float rows rounded to bf16
// first. The feature input (form (b)) is read as it is, float32 or bf16.
template <int G, int J>
__device__ __forceinline__ void geom_chunk(const Args& a, int p, const float* gs, float (&f)[32]) {
  constexpr Geom g = GEO[G];
  constexpr int col = 32 * J;
  if constexpr (g.row == FEAT) {
    const float4* fr = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(a.g_rows[G]) + static_cast<size_t>(p) * g.ch + col);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 t = __ldg(fr + j);
      f[4 * j] = t.x, f[4 * j + 1] = t.y, f[4 * j + 2] = t.z, f[4 * j + 3] = t.w;
    }
  } else if constexpr (g.row == FEAT_BF16) {
    const uint4* fr = reinterpret_cast<const uint4*>(
        a.g_rows[G] + (static_cast<size_t>(p) * g.ch + col) * 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 q = __ldg(fr + j);
      const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) f[8 * j + c] = bf16_bits((wd[c >> 1] >> (16 * (c & 1))) & 0xffffu);
    }
  } else {
    constexpr int EB = g.row == BF16 ? 2 : g.row == F32 ? 4 : 1;  // bytes per channel
    constexpr int NQ = 32 * EB / 16;                               // 16-byte words per run
    // the point's row of the table and its tap weights
    float tw[8];
    const size_t r = geom_fetch<G>(a.f, p, tw);
    const uint8_t* const row = a.g_rows[G] + r * (g.taps * g.ch * EB);
#pragma unroll
    for (int k = 0; k < g.taps; ++k) {
      const float w = tw[k];
      const uint4* src = reinterpret_cast<const uint4*>(row + (k * g.ch + col) * EB);
      uint32_t wd[4 * NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const uint4 q = __ldg(src + j);
        wd[4 * j] = q.x, wd[4 * j + 1] = q.y, wd[4 * j + 2] = q.z, wd[4 * j + 3] = q.w;
      }
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        float x;
        if constexpr (g.row == U8) x = ubyte(wd[c >> 2], c & 3);
        else if constexpr (g.row == I8) x = sbyte(wd[c >> 2], c & 3);
        else if constexpr (g.row == BF16) x = bf16_bits((wd[c >> 1] >> (16 * (c & 1))) & 0xffffu);
        else x = __bfloat162float(__float2bfloat16_rn(__uint_as_float(wd[c])));
        f[c] = k == 0 ? __fmul_rn(x, w) : __fadd_rn(f[c], __fmul_rn(x, w));
      }
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) f[c] = __fmul_rn(f[c], gs[geo_col(G) + col + c]);
  }
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Layer 0's products over K slice S (feature columns [S * KF, (S + 1) * KF)
// as they stand in the f tile x) added into every N tile's accumulators.
template <int S>
__device__ __forceinline__ void layer0_slice(const bf16* w, const bf16* x, Acc (&acc)[NT0][2]) {
  constexpr int K = kp(0), k0 = S * KF / 16, k1 = (K < (S + 1) * KF ? K : (S + 1) * KF) / 16;
#pragma unroll
  for (int n = 0; n < NT0; ++n) {
#pragma unroll
    for (int k = k0; k < k1; ++k) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(b, w + woff(0) + n * 16 * K + k * 16, K);
      wmma::load_matrix_sync(a0, x + (k - k0) * 16, KF);
      wmma::load_matrix_sync(a1, x + 16 * KF + (k - k0) * 16, KF);
      wmma::mma_sync(acc[n][0], a0, b, acc[n][0]);
      wmma::mma_sync(acc[n][1], a1, b, acc[n][1]);
    }
  }
}

// The geometry feature's 32-column chunks N, N + 1, ... into this lane's
// row of the f tile (zeros for a lane past P). When a chunk starts a new K
// slice, the full tile first goes through layer0_slice. occ: the channel
// sum of chunk 0 (table 0's level-1 block), in channel order.
template <int N>
__device__ __forceinline__ void geom_front(const Args& a, int p, bool live, const float* gs,
                                           bf16* xf, const bf16* W, Acc (&acc)[NT0][2], float& occ) {
  if constexpr (N < FT / 32) {
    constexpr int col = 32 * N, G = geo_table(col), J = (col - geo_col(G)) / 32;
    if constexpr (col > 0 && col % KF == 0) {
      __syncwarp();
      layer0_slice<col / KF - 1>(W, xf, acc);
      __syncwarp();
    }
    float f[32];
    if (live) {
      geom_chunk<G, J>(a, p, gs, f);
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c) f[c] = 0.f;
    }
    if constexpr (N == 0) {
      occ = f[0];
#pragma unroll
      for (int c = 1; c < 32; ++c) occ = __fadd_rn(occ, f[c]);
    }
    put_row<32>(xf + (threadIdx.x & 31) * KF + col % KF, [&](int i) { return f[i]; });
    geom_front<N + 1>(a, p, live, gs, xf, W, acc, occ);
  }
}

template <int RA, int RB, bool OCC>
__global__ void __launch_bounds__(BLOCK) point_stages_kernel(const Args a, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CA = RB == NONE ? C : CS;  // channels of table a
  static_assert(RA != NONE && RA != I4, "table a is int8, uint8, bf16 or float32 rows");
  constexpr int NW16 = WBUF_BYTES / 16;
#pragma unroll
  for (int j = 0; j < (NW16 + BLOCK - 1) / BLOCK; ++j) {  // all loads in flight at once
    const int i = threadIdx.x + j * BLOCK;
    if (i < NW16) reinterpret_cast<uint4*>(smem)[i] = a.wbuf[i];
  }
  float* const ps = reinterpret_cast<float*>(smem + SCALE_OFF);
  for (int i = threadIdx.x; i < C; i += BLOCK) ps[i] = i < CA ? a.scale_a[i] : a.scale_b[i - CA];
  load_geom_scales<0>(a, ps + C);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * BLOCK + warp * 32;
  if (p0 >= P) return;  // the whole warp is past P
  const int p = p0 + lane;
  const bool live = p < P;
  const float* const gs = ps + C;
  const bf16* const W = reinterpret_cast<const bf16*>(smem);
  const float* const B = reinterpret_cast<const float*>(smem + WELEMS * 2);
  bf16* const xx = reinterpret_cast<bf16*>(smem + WARP_OFF + warp * WARP_BYTES);  // (32, KX)
  bf16* const xf = xx + 32 * KX;  // (32, KF)
  float* const sc = reinterpret_cast<float*>(xf + 32 * KF);  // (32, 16) f32
  constexpr int RW = (C + 1) / 2;
  uint32_t rfp[V][RW];  // rf_v as bf16 pairs, until its view's color input is written

  // ---- front end, one point per thread; a lane past P loads nothing and
  // writes zero rows ----
  bool ok = false;
  float nv = 0.f;  // the views that see the point (the view mask's sum)
  {
    float rf[V * C];
    if (live) {
      // the point projected into each view; each table's quad row and tap
      // weights fetched, then lerped and dequantized
      const float x = __ldg(a.f.pts + 3 * static_cast<size_t>(p));
      const float y = __ldg(a.f.pts + 3 * static_cast<size_t>(p) + 1);
      const float z = __ldg(a.f.pts + 3 * static_cast<size_t>(p) + 2);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const Pixel px = project(a.f, v, x, y, z);
        nv = __fadd_rn(nv, px.vm);
        float tw[T];
        const size_t ra = quad_fetch(a.f, 0, v, px, tw);
        lerp_table<RA, CA>(a.rows_a, ra, tw, ps, rf, v * C);
        if constexpr (RB != NONE) {
          const size_t rb = quad_fetch(a.f, 1, v, px, tw);
          lerp_table<RB, CF>(a.rows_b, rb, tw, ps + CS, rf, v * C + CS);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < V * C; ++i) rf[i] = 0.f;
    }

    // mean / variance over the views; the density input [sf | mean | var]
    // (sf written by layer 0) and per view the color input [mean | var | rf_v]
    float mv[2 * C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float s = rf[c];
#pragma unroll
      for (int v = 1; v < V; ++v) s = __fadd_rn(s, rf[v * C + c]);
      const float m = s / static_cast<float>(V);
      float q = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = __fadd_rn(rf[v * C + c], -m);
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
      mv[c] = m;
      mv[C + c] = q / static_cast<float>(V);
    }
    put_row<kp(1) - 64>(xx + lane * KX + 64, [&](int i) { return i < 2 * C ? mv[i] : 0.f; });
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int i = 0; i < RW; ++i)
        rfp[v][i] = bf16x2(rf[v * C + 2 * i], 2 * i + 1 < C ? rf[v * C + 2 * i + 1] : 0.f);
    }
  }
  // ---- geometry: each table's dequantized lerp (or the (P, F) feature
  // input), chunk by chunk into the f tile; at F = 128 layer 0's first K
  // slice runs as the tile fills ----
  Acc acc0[NT0][2];
  if constexpr (FT > KF) {
#pragma unroll
    for (int n = 0; n < NT0; ++n) {
      wmma::fill_fragment(acc0[n][0], 0.f);
      wmma::fill_fragment(acc0[n][1], 0.f);
    }
  }
  {
    float occ = 0.f;
    geom_front<0>(a, p, live, gs, xf, W, acc0, occ);
    if (live) {
      ok = a.sig_ok[p] != 0;
      if (OCC) {
        // trilinear level-1 occupancy: channel sum of the dequantized lerp
        a.occm_out[p] = occ > 0.f ? 1.f : 0.f;
        ok = ok && occ > 0.f;
      }
    }
  }
  __syncwarp();

  // ---- sigma-feat linear + density MLP, on tensor cores ----
  if constexpr (FT <= KF) {
    layer<0>(W, xf, KF, sc, to_tile<0, ELU>(B, xx, KX));  // sigma_feat -> X[:, 0:64]
  } else {
    // the last K slice, then the epilogue of every N tile
    layer0_slice<(FT - 1) / KF>(W, xf, acc0);
    const auto epi0 = to_tile<0, ELU>(B, xx, KX);
#pragma unroll
    for (int n = 0; n < NT0; ++n) {
      wmma::store_matrix_sync(sc, acc0[n][0], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(sc + 16 * 16, acc0[n][1], 16, wmma::mem_row_major);
      __syncwarp();
      epi0(n, sc);
      __syncwarp();
    }
  }
  bf16* const h1 = xf;  // the feature tile is dead after layer 0
  layer<1>(W, xx, KX, sc, to_tile<1, ELU>(B, h1, 64));
  layer<2>(W, h1, 64, sc, to_tile<2, ELU>(B, xx, KX));  // -> X[:, 0:32]
  bf16* const h3 = xf;
  layer<3>(W, xx, KX, sc, to_tile<3, ELU>(B, h3, 16));
  mma_tile<4>(W, h3, 16, 0, sc);
  constexpr int B4 = boff(4), B6 = boff(6), B8 = boff(8), B11 = boff(11);
  const float sg = act<RELU>(sc[lane * 16] + B[B4]);  // row lane, column 0
  __syncwarp();
  const float sigma = (nv < 1.f || !ok) ? 0.f : sg;
  const float alpha = 1.f - expf(-sigma);
  if (live) a.alpha_out[p] = alpha;

  // ---- color MLP: per-view base/vis, then rgb over the view concat ----
  // rgb_fc's first layer runs per view on K tiles 2v, 2v + 1 (that view's 32
  // columns of [hc_0 | hc_1 | hc_2]) into accumulators kept across the views:
  // the K tiles are summed in the order of one whole-layer walk.
  bf16* const hb = xf;            // (32, 64)
  bf16* const hvs = xf + 32 * 64; // (32, 32): bf16(hv / V)
  bf16* const t = xf;             // (32, 32), after hb dies
  constexpr int NT = np(6) / 16, K9 = kp(9), W9 = woff(9);
  static_assert(np(8) / 16 == NT && np(9) / 16 == 2 && K9 == V * 32, "rgb_fc's input is the view concat");
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc9[2][2];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    wmma::fill_fragment(acc9[n][0], 0.f);
    wmma::fill_fragment(acc9[n][1], 0.f);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    // X[:, 134:176] = [rf_v | 0]: bf16 pairs from column 134 (4-byte aligned)
    uint32_t* const xr = reinterpret_cast<uint32_t*>(xx + lane * KX + 64 + 2 * C);
#pragma unroll
    for (int i = 0; i < (KX - 64 - 2 * C) / 2; ++i) xr[i] = i < RW ? rfp[v][i] : 0u;
    __syncwarp();
    layer<5>(W, xx + 64, KX, sc, to_tile<5, ELU>(B, hb, 64));
    float hv[NT][16];  // the f32 vis_fc residual, this lane's epilogue elements
    // Lane l's epilogue elements of an N tile: column 16n + l % 16, rows
    // 2j + l / 16, at s[32j + l].
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma_tile<6>(W, hb, 64, n, sc);
      const int col = n * 16 + (lane & 15);
      const float b = B[B6 + col];
#pragma unroll
      for (int j = 0; j < 16; ++j) hv[n][j] = sc[32 * j + lane];  // loads before stores (to_tile)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        hv[n][j] = act<ELU>(hv[n][j] + b);
        hvs[(2 * j + (lane >> 4)) * 32 + col] = __float2bfloat16_rn(hv[n][j] / static_cast<float>(V));
      }
      __syncwarp();
    }
    layer<7>(W, hvs, 32, sc, to_tile<7, ELU>(B, t, 32));
#pragma unroll
    for (int n = 0; n < NT; ++n) {  // hc_v = hv + u -> X[:, 0:32]
      mma_tile<8>(W, t, 32, n, sc);
      const int col = n * 16 + (lane & 15);
      const float b = B[B8 + col];
      float y[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) y[j] = sc[32 * j + lane];  // loads before stores (to_tile)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float u = act<ELU>(y[j] + b);
        xx[(2 * j + (lane >> 4)) * KX + col] = __float2bfloat16_rn(__fadd_rn(hv[n][j], u));
      }
      __syncwarp();
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
        wmma::load_matrix_sync(b, W + W9 + n * 16 * K9 + (2 * v + k) * 16, K9);
        wmma::load_matrix_sync(a0, xx + k * 16, KX);
        wmma::load_matrix_sync(a1, xx + 16 * KX + k * 16, KX);
        wmma::mma_sync(acc9[n][0], a0, b, acc9[n][0]);
        wmma::mma_sync(acc9[n][1], a1, b, acc9[n][1]);
      }
    }
    __syncwarp();
  }
  bf16* const r1 = xf;
  const auto epi9 = to_tile<9, ELU>(B, r1, 32);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    wmma::store_matrix_sync(sc, acc9[n][0], 16, wmma::mem_row_major);
    wmma::store_matrix_sync(sc + 16 * 16, acc9[n][1], 16, wmma::mem_row_major);
    __syncwarp();
    epi9(n, sc);
    __syncwarp();
  }
  layer<10>(W, r1, 32, sc, to_tile<10, ELU>(B, xx, KX));  // -> X[:, 0:16]
  mma_tile<11>(W, xx, KX, 0, sc);
  float rgb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = act<SIGMOID>(sc[lane * 16 + c] + B[B11 + c]);
  const bool alive = alpha > 1e-14f && ok;
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.rgb_out[static_cast<size_t>(p) * 3 + c] = alive ? rgb[c] : 0.f;
  }
}

// the instantiation this library holds
#define PS_KERNEL point_stages_kernel<PS_ROW_A, PS_ROW_B, PS_OCC != 0>

// Lets the kernel ask for SMEM_BYTES of dynamic shared memory (once).
cudaError_t configure() {
  static const cudaError_t e = cudaFuncSetAttribute(
      PS_KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  return e;
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its packed weight buffer against.
int point_stages_wbuf_bytes() { return WBUF_BYTES; }

// Dynamic shared memory of one block, in bytes.
int point_stages_smem_bytes() { return SMEM_BYTES; }

// Threads of one block (32 per warp, one point each).
int point_stages_block() { return BLOCK; }

// Blocks resident per SM on the current device (a negative CUDA error code
// if the shared-memory request or the query is refused).
int point_stages_blocks_per_sm() {
  cudaError_t e = configure();
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, PS_KERNEL, BLOCK, SMEM_BYTES);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The instantiation this library holds: the values of PS_ROW_A PS_ROW_B
// PS_OCC PS_G0 PS_G1 PS_G2 PS_G3 PS_V, separated by spaces.
#define PS_STR_(x) #x
#define PS_STR(x) PS_STR_(x)
const char* point_stages_key() {
  return PS_STR(PS_ROW_A) " " PS_STR(PS_ROW_B) " " PS_STR(PS_OCC) " " PS_STR(PS_G0) " " PS_STR(
      PS_G1) " " PS_STR(PS_G2) " " PS_STR(PS_G3) " " PS_STR(PS_V);
}

// Bytes of the Fetch structure, which the wrapper's ctypes copy must match.
int point_stages_fetch_bytes() { return static_cast<int>(sizeof(Fetch)); }

// rows_a, rows_b: the projection quad tables' flat rows; g_rows, g_scale:
// arrays of 4 pointers, table g's at index g (null past the library's
// tables, and the scale of a feature input; a null scale of a geometry
// table is a unit one); fetch: the host Fetch of the launch.
int point_stages_launch(const void* rows_a, const void* scale_a, const void* rows_b,
                        const void* scale_b, const void* const* g_rows,
                        const void* const* g_scale, const void* sig_ok, const void* wbuf,
                        void* alpha, void* rgb, void* occm, int P, void* stream,
                        const void* fetch) {
  const cudaError_t e = configure();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (P > 0) {
    Args a = {
        static_cast<const uint8_t*>(rows_a), static_cast<const float*>(scale_a),
        static_cast<const uint8_t*>(rows_b), static_cast<const float*>(scale_b),
        {}, {},
        static_cast<const uint8_t*>(sig_ok), static_cast<const uint4*>(wbuf),
        static_cast<float*>(alpha), static_cast<float*>(rgb), static_cast<float*>(occm),
        *static_cast<const Fetch*>(fetch)};
    for (int g = 0; g < 4; ++g) {
      a.g_rows[g] = static_cast<const uint8_t*>(g_rows[g]);
      a.g_scale[g] = static_cast<const float*>(g_scale[g]);
    }
    const int grid = (P + BLOCK - 1) / BLOCK;
    PS_KERNEL<<<grid, BLOCK, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
