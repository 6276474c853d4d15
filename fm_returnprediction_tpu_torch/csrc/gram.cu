// Masked per-month Gram contraction for a batch of specs: float operands on
// the CUDA cores (plain IEEE float32), double operands on the FP64 tensor
// cores (DMMA), bf16 operands on the tensor cores with float sums.
//
// Replaces the Pallas TPU kernel
//   fm_returnprediction_tpu/ops/gram_pallas.py::gram_contract_pallas
//   (body _gram_kernel), every branch of it: the unweighted contraction, the
//   row-weighted one (has_rw) and bf16 operands with f32 accumulation.
//
// For every spec s and month t it forms
//   G_s[t] = sum_n w_s[t,n] * a[t,n,:] a[t,n,:]^T,  a = [1 | x - c_t | y]
// a (QE, QE) block with QE = P + 2, where the weight is
//   w_s[t,n] = rw[t,n] if valid[s,t,n] and finite(y[t,n]) and no SELECTED
//              column of x[t,n,:] is non-finite, else 0
// (rw = 1 without row weights, so n = sum w is then an exact count).
// Non-finite x entries of unselected columns and a non-finite y enter as 0.
// The caller splits the block into gram, moment, n, sum y and sum y^2.
//
// What bounds it on an H100: at Table 2's shape (T=600, N=22,000, P=14,
// S=9) it reads ~0.9 GB (x, y and the uint8 mask) and does
// S*T*N*QE*(QE+1)/2 ~ 1.6e10 multiply-adds, so in plain FP32 the arithmetic
// (~0.5 ms at 67 TFLOP/s) outweighs the bytes (~0.27 ms at 3.35 TB/s). At
// the figure grid's shape (P=5, S=3) the bytes bound it (~0.1 ms). With bf16
// operands the same work reads ~0.52 GB (~0.16 ms) and its products, on the
// tensor cores, take ~0.06 ms even at full 16x16 blocks: the bytes bound it.
// In float64 (67 TFLOP/s on DMMA) the bytes bound it up to about P = 14
// (Table 2's shape: 1.7 GB, 0.51 ms, against 0.48 ms of products) and the
// products past it (P = 40: 3.2 ms against 0.8 ms of bytes); in float32 the
// products past P = 14 as well (P = 40 at N = 22,000 and P = 100 at 4,096
// firms, S = 9: 3.2 and 3.5 ms of FP32 FMAs).
//
// Design, float up to 32 columns (gram_kernel). One block per month t walks
// the firm axis in tiles; x is read in its native (T, N, P) layout, where a
// tile is tile*P contiguous values.
// - Register tiles of the output: the (QE x QE) upper triangle is padded to
//   a multiple of 4 and cut into 4x4 tiles (10 at P=14, 3 at P=5). A thread
//   owns one (spec, tile) pair and keeps its 16 sums in registers. Per firm
//   it reads 4 + 4 row values as two 16-byte shared-memory loads and the
//   spec's weight as one, forms w*a_i once and does 16 FMAs: 3 loads per 16
//   FMAs, where one thread per output entry would spend 3 loads per FMA.
//   The lanes of a warp read one firm's row, so those loads are broadcasts,
//   free of bank conflicts.
// - Firm groups: the (spec, tile) owners are replicated G times so that a
//   block has up to 192 threads; group g sums firms g, g+G, ... of each
//   tile. Blocks are kept small (<= 192 threads, <= 64 registers, <= 44 KB
//   of shared memory, the row weights' tile included) so that five share an
//   SM and all 600 months of the main path are resident at once: no tail
//   wave, and one block's barriers overlap the others' arithmetic. Each
//   thread adds a per-tile partial into a running
//   total (two-level sum), and at the end the groups' totals are added in
//   group order through shared memory: no atomics, so the result is the same
//   from run to run and the counts are exact.
// - Asynchronous double-buffered tiles: the next tile of x, y, the row
//   weights and the block's valid rows is copied with cp.async in 16-byte
//   chunks (a ragged first or last chunk byte by byte) while this tile is
//   summed.
// - The build is spread over the block: each thread keeps one column of
//   the centred augmented rows for a stride of firms (row stride QE rounded
//   up to 4, so a warp writes consecutive words: no bank conflict), and one
//   thread per firm finds the firm's non-finite columns once, as a bit mask,
//   then writes every spec's weight from the staged valid byte and row
//   weight: a (firm, spec) weight costs one byte load and one mask test.
// - When S * tiles exceeds one block's threads (large S, not on the main
//   path), the (spec, tile) pairs are split over gridDim.y blocks, each
//   staging only the valid rows of its own specs.
// - One 64-bit non-finite mask a firm (y in bit 32) and one column of the
//   rows a thread, whose registers the main path's speed depends on; past
//   32 columns gram_f32_wide_kernel (below) takes the union.
// Tensor cores are not used for float: TF32 keeps ~10 mantissa bits and
// would break the 1e-5 parity with the plain version; a split-TF32 or
// split-bf16 scheme is left for later work.
//
// Design, bf16 operands (gram_tc_kernel). One block per month, as above.
// - Tiles by the copy engine: each row of a tile (x, y, the row weights,
//   the block's valid rows) goes by one bulk copy (cp.async.bulk, 1-D TMA)
//   of its 16-byte-aligned interior that completes on the stage's mbarrier;
//   a ragged head or tail goes byte by byte. Double-buffered: the next tile
//   is in flight while this one is summed.
// - Products on the tensor cores: per 16 firms one spec's block is
//   (w o A)^T A with mma.sync m16n8k16 (bf16 operands, f32 sums), A the
//   16-firm tile of augmented rows [1 | x - c | y]. The build writes A
//   transposed, one shared-memory row of firm pairs per column (row stride
//   padded by 16 bytes: 4 banks mod 32, so the fragment loads are free of
//   bank conflicts), and the same four words a thread loads per 16 rows are
//   the A fragment of rows 16m.. and the B fragments of columns 16m.. and
//   16m+8... QE is padded to 16 rows (MT m-tiles) and 8 columns (NT
//   n-tiles); an n-tile wholly below the diagonal is skipped. At P=14 that
//   is 2 MMAs per spec per 16 firms, at P=5 one.
// - Weights as masks: one thread per firm pair finds the pair's non-finite
//   columns once and writes a 0xFFFF/0 half per (spec, firm); a warp ANDs
//   the packed bf16x2 halves of its A fragment with its firms' masks. Both
//   operands are exact bf16 and the tensor core forms the exact products,
//   so 0/1 weights lose nothing before the sums.
// - Row weights split exactly: w*a_i (a bf16 times a bf16) has up to 16
//   significant bits, in float. The build writes hi = bf16_rn(w*a_i) and
//   lo = bf16_rn(w*a_i - hi), so hi + lo == w*a_i exactly (the remainder
//   has at most 8 significant bits; exact wherever |w*a_i| is 0 or at least
//   2^-118, far below any panel value), and one MMA on hi and one on lo go
//   into the same sums. The weighted copy does not depend on the spec; the
//   spec's mask is applied to its fragments as above. The unweighted kernel
//   carries none of this (a template flag).
// - Work split: the block's specs are cut into groups of at most SPW (by the
//   register budget of QE's class), one warp per group, and when there are
//   fewer than four groups the warps also split each tile's 16-firm steps
//   (wk warps a group). A warp starts a fresh accumulator per tile and adds
//   it into its running float sums in shared memory (two-level sum; the
//   registers stay with the accumulators); at the end the wk sums of a spec
//   are added in a fixed order. No atomics: two calls give the same bits,
//   and counts (entry (0,0) under 0/1 weights) are sums of integers below
//   2^24, exact.
// - The bf16 rounding point is the CUDA-core kernel's and the reference's:
//   x - c is formed in float and rounded to bf16; products and sums are
//   float. Blocks take at most 128 threads and 44 KB of shared memory, so
//   five months share an SM (600 months on 132 SMs: one wave); a tile holds
//   two firms per thread (192 at Table 2's 96 threads).
// What bounds it now (H100, Table 2's shape, PERF.md): not the bytes. Each
// block runs its phases one after another between barriers (issue the next
// tile's copies, build, MMAs), and with ~3 warps a scheduler each phase
// waits on its own latencies; a later design overlaps them (producer and
// consumer warps).
//
// Design, float64 (gram_dmma_kernel). Products on the FP64 tensor cores:
// mma.sync m16n8k8 (on an H100 the m16n8k* shapes that sm_90 adds run at
// the full 67 TFLOP/s, m8n8k4 at half of it). A spec's block is cut into
// 16-row strips of 8-column tiles, strip mi keeping tiles nj >= 2 mi (a
// diagonal tile computes its whole 16x8 and keeps the entries on or above
// the diagonal); per 8 firms one MMA a tile, A the strip's rows times the
// spec's weights (w o a, the weight applied as the fragment is formed), B
// the tile's unweighted rows.
// - Tasks: strips mi and mt - 1 - mi together hold the same number of
//   tiles whatever mi, so a consumer warp's task is a chunk of at most 8
//   tiles of one such pair for one spec, and the warp forms the chunk's A
//   fragments once a step for all of its tiles.
// - One read of x a month for the whole call: one launch takes the whole
//   spec batch (no 8192-entry cap); a month's tasks go to as few blocks as
//   their running sums allow (one at Table 2's shape), consecutive (the
//   split index fastest), so that split blocks are resident together and
//   all but the first read the month's tiles from L2.
// - Warp specialization: 4 producer warps stage each tile by the copy
//   engine (one bulk copy, 1-D TMA, a raw row, into a ring of two stages,
//   each completing on its mbarrier) and build it into one of two built
//   buffers, while up to 12 consumer warps sum the products of the other;
//   named barriers hand a buffer over (full, empty). One block of up to 16
//   warps an SM.
// - The build: lane c of 32-column word wd writes column 32 wd + c + 1 of
//   the row-major augmented rows [1 | x - c | y | 0 pad] (x column 32 wd +
//   c, y as column p; row stride 16 mt + 4 doubles, 4 mod 16, so the
//   fragment loads are free of bank conflicts) and one ballot a firm gives
//   the word's non-finite bits; then a thread a firm writes the firm's
//   weight for each spec of the block (rw, or 1, where the valid byte is set
//   and no selected column, y included, is non-finite; else 0).
// - Sums: a fresh sum a slot per staged tile, added into the task's running
//   sums in shared memory (two-level; DMMA is IEEE double). Each entry has
//   one owner; no atomics: two calls give the same bits, and under 0/1
//   weights n is an exact count.
// What bounds it now (H100, PERF.md): not the tensor cores. A DMMA's
// latency is long (~500 cycles: a warp's few tiles in flight keep the
// pipe only partly busy), each MMA loads its B fragment (512 bytes) from
// shared memory, and the build and the fragment loads share the SM's
// shared-memory bandwidth and issue slots, so producers and consumers only
// partly overlap.
//
// Design, bf16 operands past 32 columns (gram_tc_wide_kernel). The kernel
// above keeps a warp's whole output class in registers, which stops at
// QE = 34. Past P = 32 a spec's block is cut and dealt as the float64
// kernel's (16-row strips of 8-column tiles, a task a chunk of a strip
// pair for one spec, one launch for the whole spec batch, warp-specialized
// blocks of producers and consumers), into gram_tc_kernel's transposed
// rows and masks (hi and lo parts with row weights), built as the float64
// rows are (a warp a 32-column word of firm pairs, the non-finite bits by
// ballot; then a thread a firm pair writes its masks). Per 16 firms a
// consumer loads each of its task's strips' A fragment once (ldmatrix.x4,
// the spec's masks ANDed in) and each tile's B fragment (ldmatrix.x2), one
// mma.sync m16n8k16 a tile (two with row weights), into a fresh sum per
// staged tile (at most 256 firms) that is added into running sums in
// shared memory: no atomics. What bounds it now: the build (the
// transposition, a 32-bit store per column and firm pair) past P = 64,
// where the consumers wait on the producers.
//
// Design, float past 32 columns (gram_f32_wide_kernel). The float64
// kernel's blocks (one launch for the whole spec batch, the fewest blocks a
// month, warp-specialized producers and consumers, running sums in shared
// memory) with products on the CUDA cores in plain float32 FMAs:
// - The build (shared with the float64 kernel: produce_tiles) stages each
//   tile by 1-D TMA and builds it once for every spec of the block: the
//   rows [1 | x - c | y | 0 pad] in float32, QE padded to 8 columns, each
//   8-column segment's two 4-column halves planar (first halves of every
//   segment, then second halves), the non-finite bits a 32-column word at a
//   time by ballot, then one weight a (spec, firm).
// - Products: a spec's upper triangle is cut into 8x8 tiles (21 at P = 40,
//   91 at P = 100: a plain triangle walk, row by row), a lane owns one tile
//   for one spec and a consumer warp's task is 32 consecutive (spec, tile)
//   pairs of the month. Per firm a lane loads its row segment and column
//   segment (four 16-byte loads) and its spec's weight, forms w * a_i once
//   (8 multiplies) and does 64 FMAs. The lanes of a warp read one firm's
//   row, so a load touches at most as many 16-byte words as the warp has
//   distinct segments, and the planar halves put eight consecutive
//   segments in eight different bank groups (up to P = 62 no two words of a
//   load share one): 5 loads for 72 FP32 instructions, where the 4x4 kernel
//   spent 3 for 16.
// - The plan: a warp's FMAs run on its SM sub-partition's FP32 pipes, so a
//   block takes about ceil(units / 4) units' time; where that balances
//   better, a task is summed as two parts (each half of every staged tile,
//   its own running sums, added in part order at the end): P = 40 at
//   S = 9 runs 6 tasks as 12 units on 12 consumer warps. A fresh sum a unit
//   per staged tile is added into its running sums: no atomics, two calls
//   give the same bits, and under 0/1 weights n is an exact count.
// What bounds it now (H100 at 700 W; k2_probe.py times the kernel with
// parts cut out, PERF.md): without the producers' build and the
// consumers' loads it runs at about the rate of a register-only 8x8 outer
// product (two thirds of 67 TFLOP/s); the loads add 17-18% and the build
// 2-5% at 4,096 firms and 28% at P = 40 over 22,000, together 1.4-1.7x
// (the producers' ballots and stores and the consumers' loads share the
// SM's issue slots and shared memory with the FMAs); and the padding of
// QE to 8 and the weight's multiplies do 1.25-1.7x the bound's operations.
//
// The float and bf16 kernels up to 32 columns take at most 8192 block
// entries S * QE * (QE + 1) / 2 a launch (60 specs at P = 14): the wrapper
// cuts a larger spec batch into consecutive chunks, one launch each. The
// float64 kernel, and the float and bf16 kernels past 32 columns, take up
// to 65,536 specs in one launch, at any P whose smallest firm tile (16
// firms) fits in shared memory (227 KB): 424 columns in float64 (423 with
// row weights), 848 in float (850 at S = 1, 847 with row weights), 1,367
// in bf16 (622 with row weights); the wrapper sends every operand type to
// the tile-pair kernel before those reaches.
//
// Design, wide unions of every operand type (gram_f32_tiles_kernel,
// gram_dmma_tiles_kernel, gram_tc_tiles_kernel: the tile-pair kernel). It
// ports the same Pallas kernel body
// (fm_returnprediction_tpu/ops/gram_pallas.py::_gram_kernel, :56) from
// GRAM_TILE_FROM columns (specgrid/grams.py, the crossover of each operand
// type timed on an H100), at any P in one launch. At 920 columns (T = 60,
// N = 22,000, S = 3) the products bound it (~3.4e12 operations: 50 ms of
// FP32 FMAs or of DMMA, 3.4 ms of bf16 tensor cores, against 0.8-1.5 GB of
// bytes, under 0.5 ms), and the kernels past 32 columns above stage and
// build a month's whole rows in every block (tile 16 a block at that
// width).
// - The augmented columns [1 | x - c | y] are cut into tiles of 64; a
//   block owns one tile pair (I <= J) for one month and a group of up to 3
//   specs (the pure-Python plan gram_tile_plan gives the pairs, passed as
//   an int32 array, and the group size), walks the firms in chunks of 64
//   and writes its (I, J) rectangle and the mirror straight into the
//   output; a diagonal pair keeps the entries on or above the diagonal.
//   Each entry has one writer and no atomics: two calls give the same
//   bits, and under 0/1 weights n is an exact count. The blocks of a pair's
//   spec groups, then of a month's pairs, run together, so the month's
//   firms are read from L2 (a block reads 2 x 64 columns of every firm).
// - Staging from x itself, so any P and any alignment of x (no 16-byte row
//   stride is needed, as a TMA tensor map would need): float32 and float64
//   copy every value by a cp.async of its own size (4 or 8 bytes, a warp's
//   lanes on consecutive columns), bf16 every 16-byte-aligned chunk that
//   holds a byte of the tile's columns, with a per-firm misalignment; y,
//   the row weights and the spec's rows of the folded mask as 1-D spans;
//   three stages, chunks k + 1 and k + 2 in flight while chunk k is built
//   and summed. No gathered copy: the only scratch is the pre-pass's (S, T,
//   N) uint8 mask.
// - Validity: the pre-pass (gram_fold_kernel, below) folds finite(y) and
//   every selected column's finiteness into the mask once; a block reads
//   the folded bytes, not the firm's whole row.
// - bf16: the build, all threads, writes each chunk's two tiles as
//   firm-major augmented rows (non-finite entries 0, x - c formed in float
//   and rounded to bf16 as the plain version rounds it) and each (spec,
//   firm) mask; products by mma.sync m16n8k16, both fragments loaded from
//   the firm-major rows by ldmatrix.trans (k = the firm), four warps of
//   32 x 32 outputs; each spec ANDs its 0xFFFF/0 masks into the A fragment,
//   and row weights split w * a exactly into hi + lo (two MMAs, as
//   gram_tc_kernel). Each step's product starts from a zero sum and is
//   added into the running sums in float registers, so the tensor core's
//   own sum never spans more than 16 firms.
// - float64: mma.sync m16n8k8 (the full DMMA rate), eight warps of 16 x 32
//   outputs, a lane forming its fragments straight from the staged rows and
//   the weight applied as each spec forms its A fragment, straight into
//   running sums in registers (DMMA is IEEE double).
// - float32, on the CUDA cores in plain IEEE float32 FMAs (no TF32: the
//   1e-5 pins of a block's max against the plain version). At 64 x 64
//   outputs a block and 3 specs a block, a chunk's FMAs take ~3.1 us on one
//   SM at the FP32 peak; they outweigh the loads only if every value is
//   formed once a chunk and the inner loop holds nothing else, and the
//   staging and the build (~2.5 us a chunk when nothing overlaps them) must
//   run beside the FMAs, not between them. So the block is warp-specialized:
//   four producer warps stage chunk k + 2 (a ring of two raw stages) and
//   build chunk k into one of two built buffers (side 0's rows as they are,
//   side 1's times the row weight, once for every spec of the block, and
//   for each spec the list of the chunk's firms it takes), while eight
//   consumer warps sum the other buffer; a lane owns a 4 x 4 tile of each
//   spec's outputs and, spec by spec, per listed firm does one 16-byte load
//   of each side and 16 FMAs. A (spec, firm) of weight 0 (outside the
//   universe, a non-finite selected column, a coreset weight of 0) adds
//   nothing and is not listed: the products follow the rows the data
//   weights, and the loop has no branch (a per-firm test of each spec's
//   bit inside the firm loop ran slower than the products it skipped).
//   A tile of 8 x 8 a lane at 3 specs would hold 192 sums, past the
//   registers a lane has room for; 4 x 4 keeps 64 (a chunk's sums and the
//   running sums). One block an SM (136 KB of shared memory, 384 threads).
//   k2_probe.py --tiles times the parts (PERF.md): the consumers' loop
//   alone is most of the time, at ~60% of the FP32 issue rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr long long kMaxEntries = 8192;  // S * QE * (QE + 1) / 2
constexpr int kMaxP = 32;                // the register-class bf16 kernel's widest P
constexpr int kMaxTile = 1024;
constexpr int kMinTile = 16;
constexpr size_t kSmemMax = 227 * 1024;

// Threads a block has at most, blocks that must fit on one SM (registers:
// 64 a thread) and the shared memory each may take. Five blocks of ~180
// threads fit on an SM, so all 600 months of the main path are resident at
// once: no tail wave, and one block's barriers overlap the others'
// arithmetic.
template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static constexpr int kThreads = 192;
  static constexpr int kMinBlocks = 5;
  static constexpr size_t kSmemBudget = 44 * 1024;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ __forceinline__ size_t up16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Byte offsets of one block's dynamic shared memory: two stages of raw
// tiles (x, y, the row weights when there are any, one valid row per spec
// of the block), then the augmented rows and the weights. Raw tiles are in
// the operand type In, rows and weights in the accumulation type T.
struct Layout {
  int qp;              // row stride: QE rounded up to 4
  size_t x_bytes, y_bytes, rw_bytes, v_row, stage;
  size_t rows_off, w_off, total;
};

template <typename In, typename T>
__host__ __device__ Layout make_layout(int tile, int p, int nsb, bool has_rw) {
  Layout L;
  L.qp = ((p + 2 + 3) / 4) * 4;
  // each raw row keeps room for a 16-byte misalignment of its source
  L.x_bytes = up16((size_t)tile * p * sizeof(In) + 16);
  L.y_bytes = up16((size_t)tile * sizeof(In) + 16);
  L.rw_bytes = has_rw ? L.y_bytes : 0;
  L.v_row = up16((size_t)tile + 16);
  L.stage = L.x_bytes + L.y_bytes + L.rw_bytes + L.v_row * nsb;
  L.rows_off = 2 * L.stage;
  L.w_off = L.rows_off + up16((size_t)tile * L.qp * sizeof(T));
  L.total = L.w_off + up16((size_t)tile * nsb * sizeof(T));
  return L;
}

// Stage `nrows` rows of `row_bytes` global bytes each (row r starts at
// src + r * src_stride) into shared memory at dst + r * dst_stride. Row r's
// byte e lands at dst + r * dst_stride + (address of its first byte & 15) + e:
// whole 16-byte chunks go by cp.async, a ragged first or last chunk byte by
// byte with plain loads.
__device__ void stage_rows(unsigned char* dst, int dst_stride,
                           const unsigned char* src, long long src_stride,
                           int nrows, int row_bytes, int tid, int nthreads) {
  const int cpr = row_bytes / 16 + 2;  // chunks a row can touch
  for (int k = tid; k < nrows * cpr; k += nthreads) {
    const int r = nrows == 1 ? 0 : k / cpr;
    const int ch = k - r * cpr;
    const unsigned char* lo = src + r * src_stride;
    const unsigned char* hi = lo + row_bytes;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(lo) & ~uintptr_t(15);
    const unsigned char* c0 = reinterpret_cast<const unsigned char*>(a0) + ch * 16;
    if (c0 >= hi) continue;
    unsigned char* d = dst + r * dst_stride + ch * 16;
    if (c0 >= lo && c0 + 16 <= hi) {
      cp_async16(d, c0);
    } else {
      for (int b = 0; b < 16; ++b)
        if (c0 + b >= lo && c0 + b < hi) d[b] = c0[b];
    }
  }
}

__device__ __forceinline__ int misalign(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// An operand widened to the accumulation type, and a centred value rounded
// as the operand type holds it: identities for the float kernel (double and
// bf16 operands have their own kernels).
__device__ __forceinline__ float widen(float v) { return v; }
template <typename In, typename T>
__device__ __forceinline__ T as_operand(T v) {
  return v;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// (spec, 4x4 tile) of pair index `pr`: tiles of the upper triangle of an
// nt4 x nt4 tile grid, row by row.
__device__ __forceinline__ void decode_pair(int pr, int ntiles, int nt4,
                                            int& s, int& ti, int& tj) {
  s = pr / ntiles;
  int r = pr - s * ntiles;
  int i = 0;
  while (r >= nt4 - i) {
    r -= nt4 - i;
    ++i;
  }
  ti = i;
  tj = i + r;
}

// kRw: whether there are row weights, a template argument so that the
// unweighted kernel carries no register or instruction for them. P <= 32:
// one 64-bit non-finite mask a firm (y in bit 32) and one column of the rows
// a thread (wider unions go to gram_f32_wide_kernel).
template <typename In, typename T, bool kRw>
__global__ void __launch_bounds__(Limits<T>::kThreads, Limits<T>::kMinBlocks)
gram_kernel(const In* __restrict__ x, const In* __restrict__ y,
            const In* __restrict__ rw, const unsigned char* __restrict__ valid,
            const unsigned int* __restrict__ sel_bits,
            const In* __restrict__ center, T* __restrict__ out, int t_len,
            long long n, int p, int s_specs, int tile, int pairs_per_block,
            int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool has_rw = kRw;
  const int qe = p + 2;
  const int nt4 = (qe + 3) / 4;
  const int ntiles = nt4 * (nt4 + 1) / 2;
  const int npairs = s_specs * ntiles;
  const int t = blockIdx.x;
  const int p0 = blockIdx.y * pairs_per_block;
  const int p1 = min(p0 + pairs_per_block, npairs);
  const int s_lo = p0 / ntiles;
  const int nsb = (p1 - 1) / ntiles - s_lo + 1;
  const Layout L = make_layout<In, T>(tile, p, nsb, has_rw);
  const int qp = L.qp;
  T* rows = reinterpret_cast<T*>(smem + L.rows_off);
  T* wts = reinterpret_cast<T*>(smem + L.w_off);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // this thread's (spec, tile) pair and firm group
  const int lp = tid % pairs_per_block;
  const int g = tid / pairs_per_block;
  const bool owner = p0 + lp < p1;
  int sl = 0, ti = 0, tj = 0;
  if (owner) {
    decode_pair(p0 + lp, ntiles, nt4, sl, ti, tj);
    sl -= s_lo;
  }
  // this thread's column of the augmented rows (firms rf0, rf0 + rstep,
  // ...): the launch has more threads than columns
  const int rc = tid % qp;
  const int rf0 = tid / qp;
  const int rstep = nthreads / qp;
  const T shift = (rc >= 1 && rc <= p) ? widen(center[(size_t)t * p + rc - 1]) : T(0);

  const long long n_tiles = (n + tile - 1) / tile;
  const long long row_t = (long long)t * n;
  const unsigned char* v_first = valid + ((long long)s_lo * t_len + t) * n;
  const long long v_stride = (long long)t_len * n;
  // tiles start at multiples of 16 firms, so each source's misalignment is
  // the same for every tile of the month
  const int x_mis = misalign(x + row_t * p);
  const int y_mis = misalign(y + row_t);
  const int rw_mis = has_rw ? misalign(rw + row_t) : 0;
  const size_t rw_off = L.x_bytes + L.y_bytes;
  const size_t v_off = rw_off + L.rw_bytes;

  auto stage_tile = [&](long long n0, int buf) {
    const int cnt = (int)min((long long)tile, n - n0);
    unsigned char* st = smem + buf * L.stage;
    stage_rows(st, 0, reinterpret_cast<const unsigned char*>(x + (row_t + n0) * p), 0,
               1, cnt * p * (int)sizeof(In), tid, nthreads);
    stage_rows(st + L.x_bytes, 0,
               reinterpret_cast<const unsigned char*>(y + row_t + n0), 0, 1,
               cnt * (int)sizeof(In), tid, nthreads);
    if (has_rw)
      stage_rows(st + rw_off, 0,
                 reinterpret_cast<const unsigned char*>(rw + row_t + n0), 0, 1,
                 cnt * (int)sizeof(In), tid, nthreads);
    stage_rows(st + v_off, (int)L.v_row, v_first + n0, v_stride, nsb, cnt, tid,
               nthreads);
    cp_async_commit();
  };

  T acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = T(0);

  stage_tile(0, 0);
  for (long long k = 0; k < n_tiles; ++k) {
    const long long n0 = k * tile;
    const int cnt = (int)min((long long)tile, n - n0);
    const int buf = (int)(k & 1);
    cp_async_wait_all();
    __syncthreads();  // tile k staged; the previous tile's sums are done
    if (k + 1 < n_tiles) stage_tile(n0 + tile, buf ^ 1);

    const unsigned char* st = smem + buf * L.stage;
    const In* xr = reinterpret_cast<const In*>(st + x_mis);
    const In* yr = reinterpret_cast<const In*>(st + L.x_bytes + y_mis);
    const In* rwr = reinterpret_cast<const In*>(st + rw_off + rw_mis);
    const unsigned char* vr = st + v_off;
    // augmented rows [1 | x - c | y | 0 pad]: a fixed column per thread, so
    // a warp writes consecutive words
    if (rf0 < rstep) {
      for (int f = rf0; f < cnt; f += rstep) {
        T v = T(0);
        if (rc == 0) {
          v = T(1);
        } else if (rc <= p) {
          const T xv = widen(xr[f * p + rc - 1]);
          v = isfinite(xv) ? as_operand<In, T>(xv - shift) : T(0);
        } else if (rc == qe - 1) {
          const T yv = widen(yr[f]);
          v = isfinite(yv) ? yv : T(0);
        }
        rows[f * qp + rc] = v;
      }
    }
    // weights: one thread per firm finds its non-finite columns once (bit
    // 32: y) and writes every spec's weight from the staged valid bytes
    // and the firm's row weight
    for (int f = tid; f < cnt; f += nthreads) {
      unsigned long long bad = isfinite(widen(yr[f])) ? 0ull : (1ull << 32);
      const In* xf = xr + f * p;
      for (int c = 0; c < p; ++c)
        if (!isfinite(widen(xf[c]))) bad |= 1ull << c;
      const T wf = has_rw ? widen(rwr[f]) : T(1);
      for (int s = 0; s < nsb; ++s) {
        const unsigned char* vs = vr + s * L.v_row + misalign(v_first + s * v_stride);
        const unsigned long long need = (unsigned long long)__ldg(sel_bits + s_lo + s) |
                                        (1ull << 32);
        wts[f * nsb + s] = (vs[f] != 0 && (bad & need) == 0ull) ? wf : T(0);
      }
    }
    __syncthreads();

    if (owner) {
      T part[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) part[e] = T(0);
#pragma unroll 2
      for (int f = g; f < cnt; f += groups) {
        const T* row = rows + f * qp;
        T ai[4], aj[4];
        load4(row + 4 * ti, ai);
        load4(row + 4 * tj, aj);
        const T w = wts[f * nsb + sl];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T wa = w * ai[i];
#pragma unroll
          for (int j = 0; j < 4; ++j) part[4 * i + j] = fma(wa, aj[j], part[4 * i + j]);
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] += part[e];
    }
  }

  // the groups' totals, added in group order
  __syncthreads();
  T* red = reinterpret_cast<T*>(smem);
  if (owner) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      red[((size_t)g * pairs_per_block + lp) * 16 + e] = acc[e];
  }
  __syncthreads();
  for (int idx = tid; idx < (p1 - p0) * 16; idx += nthreads) {
    const int lpi = idx / 16;
    const int e = idx - lpi * 16;
    T sum = T(0);
    for (int gg = 0; gg < groups; ++gg)
      sum += red[((size_t)gg * pairs_per_block + lpi) * 16 + e];
    int s, a, b;
    decode_pair(p0 + lpi, ntiles, nt4, s, a, b);
    const int i = e / 4, j = e % 4;
    const int r = 4 * a + i, c = 4 * b + j;
    if (r < qe && c < qe && (a < b || i <= j)) {
      T* blk = out + ((size_t)s * t_len + t) * qe * qe;
      blk[r * qe + c] = sum;
      blk[c * qe + r] = sum;
    }
  }
}

template <typename In, typename T, bool kRw>
int launch(const void* x, const void* y, const void* rw,
           const unsigned char* valid, const unsigned int* sel_bits,
           const void* center, void* out, int t_len, long long n, int p,
           int s_specs, cudaStream_t stream) {
  const int qe = p + 2;
  if (s_specs > 1 && (long long)s_specs * qe * (qe + 1) / 2 > kMaxEntries) return -1;
  constexpr bool has_rw = kRw;
  const int nt4 = (qe + 3) / 4;
  const int ntiles = nt4 * (nt4 + 1) / 2;
  const int npairs = s_specs * ntiles;
  const int max_threads = Limits<T>::kThreads;
  const int n_blocks_y = (npairs + max_threads - 1) / max_threads;
  const int pb = (npairs + n_blocks_y - 1) / n_blocks_y;  // pairs a block
  const int groups = max_threads / pb > 1 ? max_threads / pb : 1;
  const int threads = groups * pb;
  int nsb_max = 0;  // the most specs one block covers
  for (int b = 0; b < n_blocks_y; ++b) {
    const int lo = b * pb;
    const int hi = std::min(lo + pb, npairs);
    nsb_max = std::max(nsb_max, (hi - 1) / ntiles - lo / ntiles + 1);
  }
  const size_t red = (size_t)threads * 16 * sizeof(T);
  int tile = kMaxTile;
  auto smem_for = [&](int tl) {
    const size_t s = make_layout<In, T>(tl, p, nsb_max, has_rw).total;
    return s > red ? s : red;
  };
  while (tile > kMinTile && smem_for(tile) > Limits<T>::kSmemBudget) tile /= 2;
  const size_t smem = smem_for(tile);
  if (smem > kSmemMax || n_blocks_y > 65535) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<In, T, kRw>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)t_len, (unsigned)n_blocks_y);
  gram_kernel<In, T, kRw><<<grid, threads, smem, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(y),
      static_cast<const In*>(rw), valid, sel_bits, static_cast<const In*>(center),
      static_cast<T*>(out), t_len, n, p, s_specs, tile, pb, groups);
  return (int)cudaGetLastError();
}



// --- bf16 operands on the tensor cores ---------------------------------------

constexpr int kTcThreads = 128;    // threads a block has at most
constexpr int kTcMaxTile = 256;    // firms a staged tile holds: 16 MMA steps
constexpr size_t kTcSmemBudget = 44 * 1024;

// Output tiles of one spec's block: MT m-tiles of 16 rows by NT n-tiles of 8
// columns; tile (mi, nj) is kept when nj >= 2 mi (it holds an entry on or
// above the diagonal), so an m-row keeps NT - 2 mi tiles.
__host__ __device__ constexpr int tc_tiles(int mt, int nt) {
  int c = 0;
  for (int m = 0; m < mt; ++m) c += nt - 2 * m;
  return c;
}
__host__ __device__ constexpr int tc_tile_index(int mi, int nj, int nt) {
  return tc_tiles(mi, nt) + nj - 2 * mi;
}

// Byte offsets of one block's dynamic shared memory: two stages of raw
// tiles (as the float kernel's) and their two mbarriers, the month's center
// in float, each spec's selected columns and valid row offset, the
// transposed augmented rows (kMp rows of `tile` bf16 firms, stride padded
// by 16 bytes), with row weights their hi and lo parts, a 16-bit mask per
// (spec, firm), and each thread's running sums (`run` floats,
// lane-interleaved).
struct TcLayout {
  int rstride;  // bytes of one transposed row
  size_t x_bytes, y_bytes, rw_bytes, v_row, stage;
  size_t bar_off, cen_off, spec_off, rows_off, hi_off, lo_off, mask_off, run_off, total;
};

__host__ __device__ inline TcLayout make_tc_layout(int tile, int p, int nsb, int mp,
                                                   bool has_rw, int warps, int run) {
  TcLayout L;
  L.rstride = tile * 2 + 16;
  L.x_bytes = up16((size_t)tile * p * 2 + 16);
  L.y_bytes = up16((size_t)tile * 2 + 16);
  L.rw_bytes = has_rw ? L.y_bytes : 0;
  L.v_row = up16((size_t)tile + 16);
  L.stage = L.x_bytes + L.y_bytes + L.rw_bytes + L.v_row * nsb;
  L.bar_off = 2 * L.stage;
  L.cen_off = L.bar_off + 16;
  L.spec_off = L.cen_off + up16((size_t)kMaxP * sizeof(float));
  L.rows_off = L.spec_off + up16((size_t)kMaxP * 2 * sizeof(int));
  const size_t rows = (size_t)mp * L.rstride;
  L.hi_off = L.rows_off + rows;
  L.lo_off = L.hi_off + (has_rw ? rows : 0);
  L.mask_off = L.lo_off + (has_rw ? rows : 0);
  L.run_off = L.mask_off + up16((size_t)nsb * tile * 2);
  L.total = L.run_off + (size_t)warps * 32 * run * sizeof(float);
  return L;
}

// An mbarrier in shared memory, and the bulk (TMA) copy that completes on it.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of the given parity to complete; a wait of ~seconds
// traps (a launch error) where a protocol fault would otherwise hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (long long i = 0; !done; ++i) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (i > (1ll << 26)) __trap();
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// d += a b: a 16x16 row-major, b 16x8 column-major, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to a packed bf16 pair (a in the low half), and back.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}
__device__ __forceinline__ float lo_float(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_float(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t halves(bool lo, bool hi) {
  return (lo ? 0xFFFFu : 0u) | (hi ? 0xFFFF0000u : 0u);
}

// MT, NT: the output class of QE (above); SPW: the most specs one warp sums;
// kRw: whether there are row weights.
template <int MT, int NT, int SPW, bool kRw>
__global__ void __launch_bounds__(kTcThreads, MT == 1 ? 5 : 3)
gram_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
               const __nv_bfloat16* __restrict__ rw, const unsigned char* __restrict__ valid,
               const unsigned int* __restrict__ sel_bits,
               const __nv_bfloat16* __restrict__ center, float* __restrict__ out,
               int t_len, long long n, int p, int s_specs, int tile, int spg, int ws,
               int wk) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kMp = 16 * MT;  // transposed rows: the A side's padded QE
  constexpr int kTiles = tc_tiles(MT, NT);
  constexpr int kMaxPc = 8 * NT - 2 < kMaxP ? 8 * NT - 2 : kMaxP;  // the class's columns
  constexpr int kMaxSb = 4 * SPW;                                  // a block's specs
  constexpr int kRun = SPW * kTiles * 4;  // a thread's running sums
  const int qe = p + 2;
  const int t = blockIdx.x;
  const int s_lo = blockIdx.y * ws * spg;
  const int nsb = min(ws * spg, s_specs - s_lo);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const TcLayout L = make_tc_layout(tile, p, nsb, kMp, kRw, nthreads / 32, kRun);
  const int rs2 = L.rstride / 4;  // row stride in firm pairs
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // one a stage
  float* cen = reinterpret_cast<float*>(smem + L.cen_off);
  unsigned* spec_sel = reinterpret_cast<unsigned*>(smem + L.spec_off);
  int* spec_voff = reinterpret_cast<int*>(smem + L.spec_off) + kMaxP;
  // the transposed rows, a 32-bit word per firm pair (firm 2u low, 2u + 1 high)
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem + L.rows_off);
  uint32_t* rows_hi = reinterpret_cast<uint32_t*>(smem + L.hi_off);
  uint32_t* rows_lo = reinterpret_cast<uint32_t*>(smem + L.lo_off);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L.mask_off);  // (spec, pair)

  // this warp's specs (local w_lo .. w_lo + spg - 1, those below nsb) and
  // its share of each tile's 16-firm steps (kg, kg + wk, ...)
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sg = warp / wk;
  const int kg = warp - sg * wk;
  const int w_lo = sg * spg;
  float* run = reinterpret_cast<float*>(smem + L.run_off) + warp * 32 * kRun + lane;
  static_assert(kMaxSb <= kMaxP, "the spec arrays hold kMaxP entries");

  const unsigned char* v_first = valid + ((long long)s_lo * t_len + t) * n;
  const long long v_stride = (long long)t_len * n;
  if (tid < kMaxP) cen[tid] = tid < p ? __bfloat162float(center[(size_t)t * p + tid]) : 0.f;
  // past the block's specs: no column selected, the first valid row
  if (tid < kMaxSb) {
    spec_sel[tid] = tid < nsb ? sel_bits[s_lo + tid] : 0u;
    spec_voff[tid] = tid < nsb ? tid * (int)L.v_row + misalign(v_first + tid * v_stride) : 0;
  }
  for (int e = 0; e < kRun; ++e) run[e * 32] = 0.f;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
  }
  __syncthreads();

  const long long n_tiles = (n + tile - 1) / tile;
  const long long row_t = (long long)t * n;
  // tiles start at multiples of 16 firms, so each source's misalignment is
  // the same for every tile of the month
  const int x_mis = misalign(x + row_t * p);
  const int y_mis = misalign(y + row_t);
  const int rw_mis = kRw ? misalign(rw + row_t) : 0;
  const size_t rw_off = L.x_bytes + L.y_bytes;
  const size_t v_off = rw_off + L.rw_bytes;

  // A tile's rows (x, y, the row weights if any, the block's valid rows)
  // are copied by the copy engine: lane r of warp 0 sends the 16-byte
  // aligned interior of row r as one bulk copy that completes on the
  // stage's mbarrier (lane 0 first arms it with all of their bytes) and
  // copies the row's ragged head and tail byte by byte. Byte e of a row
  // lands at (its address & 15) + e, as stage_rows places it.
  const int n_rows = (kRw ? 3 : 2) + nsb;
  auto stage_tile = [&](long long n0, int buf) {
    if (warp != 0) return;
    const int cnt = (int)min((long long)tile, n - n0);
    unsigned char* st = smem + buf * L.stage;
    const unsigned char* src = nullptr;
    unsigned char* dst = st;
    int bytes = 0;
    if (lane == 0) {
      src = reinterpret_cast<const unsigned char*>(x + (row_t + n0) * p);
      bytes = cnt * p * 2;
    } else if (lane == 1) {
      src = reinterpret_cast<const unsigned char*>(y + row_t + n0);
      dst = st + L.x_bytes;
      bytes = cnt * 2;
    } else if (kRw && lane == 2) {
      src = reinterpret_cast<const unsigned char*>(rw + row_t + n0);
      dst = st + rw_off;
      bytes = cnt * 2;
    } else if (lane < n_rows) {
      const int sr = lane - (kRw ? 3 : 2);
      src = v_first + sr * v_stride + n0;
      dst = st + v_off + sr * L.v_row;
      bytes = cnt;
    }
    const uintptr_t lo = reinterpret_cast<uintptr_t>(src), hi = lo + bytes;
    const uintptr_t a = (lo + 15) & ~uintptr_t(15);
    const uintptr_t b = (hi & ~uintptr_t(15)) > a ? (hi & ~uintptr_t(15)) : a;
    dst += lo & 15;  // byte e of the row goes to dst[e]
    const unsigned total = __reduce_add_sync(0xffffffffu, (unsigned)(b - a));
    if (lane == 0) mbar_expect_tx(bars + buf, total);
    __syncwarp();
    if (b > a) bulk_copy(dst + (a - lo), reinterpret_cast<const void*>(a), (unsigned)(b - a),
                         bars + buf);
    for (uintptr_t e = lo; e < (b > a ? a : hi); ++e) dst[e - lo] = src[e - lo];
    for (uintptr_t e = b > a ? b : hi; e < hi; ++e) dst[e - lo] = src[e - lo];
  };

  // the fragment layout of mma.m16n8k16: lane = 4 g + tig. Row r of the
  // transposed tile holds firm pairs; a thread's A fragment of rows 16 mi..
  // is words (16 mi + g [+ 8], k0 / 2 + tig [+ 4]), which also are the B
  // fragments of columns 16 mi.. and 16 mi + 8.. (row stride = 4 banks
  // mod 32: no bank conflict).
  const int g = lane >> 2;
  const int tig = lane & 3;
  const uint32_t* frag_rows = rows + g * rs2 + tig;
  const uint32_t* frag_hi = rows_hi + g * rs2 + tig;
  const uint32_t* frag_lo = rows_lo + g * rs2 + tig;
  const uint32_t* mask_rows[SPW];
#pragma unroll
  for (int j = 0; j < SPW; ++j)
    mask_rows[j] = masks + min(w_lo + j, nsb - 1) * (tile >> 1) + tig;

  // one 16-firm step: each spec ANDs its firms' masks into the A fragment
  auto mma_step = [&](int k0, float (&part)[SPW][kTiles][4]) {
    const int w0 = k0 >> 1;
    uint32_t fa[MT][4], fh[kRw ? MT : 1][4], fl[kRw ? MT : 1][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int at = (16 * mi + (r & 1) * 8) * rs2 + w0 + (r >> 1) * 4;
        fa[mi][r] = frag_rows[at];
        if constexpr (kRw) {
          fh[mi][r] = frag_hi[at];
          fl[mi][r] = frag_lo[at];
        }
      }
    }
    // a slot past the warp's specs (an uneven last group) reads the masks
    // of the block's last spec into sums that are never read, so no branch
    // splits the step
    uint32_t m0[SPW], m1[SPW];
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      m0[j] = mask_rows[j][w0];      // firms k0 + 2 tig, +1: a0, a1
      m1[j] = mask_rows[j][w0 + 4];  // firms k0 + 8 + 2 tig, +1: a2, a3
    }
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const uint32_t(&src)[4] = kRw ? fh[kRw ? mi : 0] : fa[mi];
        const uint32_t a[4] = {src[0] & m0[j], src[1] & m0[j], src[2] & m1[j],
                               src[3] & m1[j]};
#pragma unroll
        for (int nj = 2 * mi; nj < NT; ++nj) {
          const int q = tc_tile_index(mi, nj, NT);
          const uint32_t b0 = fa[nj >> 1][nj & 1];
          const uint32_t b1 = fa[nj >> 1][2 + (nj & 1)];
          mma_bf16(part[j][q], a, b0, b1);
          if constexpr (kRw) {
            const uint32_t(&l)[4] = fl[kRw ? mi : 0];
            const uint32_t alo[4] = {l[0] & m0[j], l[1] & m0[j], l[2] & m1[j],
                                     l[3] & m1[j]};
            mma_bf16(part[j][q], alo, b0, b1);
          }
        }
      }
    }
  };

  stage_tile(0, 0);
  for (long long k = 0; k < n_tiles; ++k) {
    const long long n0 = k * tile;
    const int cnt = (int)min((long long)tile, n - n0);
    const int cnt16 = (cnt + 15) & ~15;
    const int buf = (int)(k & 1);
    mbar_wait(bars + buf, (unsigned)((k >> 1) & 1));
    __syncthreads();  // tile k staged; the previous tile's sums are done
    if (k + 1 < n_tiles) stage_tile(n0 + tile, buf ^ 1);

    const unsigned char* st = smem + buf * L.stage;
    const bf16* xr = reinterpret_cast<const bf16*>(st + x_mis);
    const bf16* yr = reinterpret_cast<const bf16*>(st + L.x_bytes + y_mis);
    const bf16* rwr = reinterpret_cast<const bf16*>(st + rw_off + rw_mis);
    const unsigned char* vr = st + v_off;
    // the build, one thread per firm pair: the transposed columns
    // [1 | x - c | y] (with row weights also the hi and lo parts of
    // w * a_i), the non-finite columns as bit masks and each spec's masks.
    // Firms cnt .. cnt16 - 1 read what the buffer holds and are zeroed
    // (`live`). Each group of loads comes before the stores that use it,
    // which the compiler may not move them past.
    for (int u = tid; u < (cnt16 >> 1); u += nthreads) {
      const int f = 2 * u;
      const uint32_t live = halves(f < cnt, f + 1 < cnt);
      const bf16* xf = xr + f * p;
      // every column of the class: columns p .. kMaxPc - 1 read what
      // follows in shared memory and land in row qe - 1 (written again
      // below) or in the padding rows past QE, whose products fall in
      // output entries that are never stored
      uint32_t xab[kMaxPc];  // column c of both firms, packed
      float cc[kMaxPc];
#pragma unroll
      for (int c = 0; c < kMaxPc; ++c) {
        xab[c] = (uint32_t)__bfloat16_as_ushort(xf[c]) |
                 ((uint32_t)__bfloat16_as_ushort(xf[p + c]) << 16);
        cc[c] = cen[c];
      }
      const uint32_t yab = (uint32_t)__bfloat16_as_ushort(yr[f]) |
                           ((uint32_t)__bfloat16_as_ushort(yr[f + 1]) << 16);
      float wa = 0.f, wb = 0.f;
      if (kRw) {
        wa = (live & 1u) ? __bfloat162float(rwr[f]) : 0.f;
        wb = (live >> 16) ? __bfloat162float(rwr[f + 1]) : 0.f;
      }
      auto put = [&](int i, uint32_t v) {
        rows[i * rs2 + u] = v;
        if (kRw) {
          const float pa = wa * lo_float(v), pb = wb * hi_float(v);  // exact in float
          const uint32_t h = pack_bf16(pa, pb);
          rows_hi[i * rs2 + u] = h;
          rows_lo[i * rs2 + u] = pack_bf16(pa - lo_float(h), pb - hi_float(h));
        }
      };
      unsigned bad_a = 0, bad_b = 0;
      put(0, 0x3F803F80u & live);  // bf16 1.0 twice
#pragma unroll
      for (int c = 0; c < kMaxPc; ++c) {
        const float xa = lo_float(xab[c]), xb = hi_float(xab[c]);
        const bool fa = isfinite(xa), fb = isfinite(xb);
        bad_a |= fa ? 0u : 1u << c;  // columns past p are in no spec's selection
        bad_b |= fb ? 0u : 1u << c;
        put(c + 1, pack_bf16(xa - cc[c], xb - cc[c]) & halves(fa, fb) & live);
      }
      const bool ya_ok = isfinite(lo_float(yab)), yb_ok = isfinite(hi_float(yab));
      put(qe - 1, yab & halves(ya_ok, yb_ok) & live);
      // each spec's masks, eight specs' loads at a time
#pragma unroll
      for (int s0 = 0; s0 < kMaxSb; s0 += 8) {
        uint32_t vab[8], sel[8];
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          if (s0 + d < kMaxSb) {
            const unsigned char* vs = vr + spec_voff[s0 + d] + f;
            vab[d] = (uint32_t)vs[0] | ((uint32_t)vs[1] << 8);
            sel[d] = spec_sel[s0 + d];
          }
        }
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          if (s0 + d < kMaxSb && s0 + d < nsb)
            masks[(s0 + d) * (tile >> 1) + u] =
                halves(ya_ok && (vab[d] & 0xFFu) != 0u && (bad_a & sel[d]) == 0u,
                       yb_ok && (vab[d] >> 8) != 0u && (bad_b & sel[d]) == 0u) & live;
        }
      }
    }
    __syncthreads();

    // the products, a fresh sum per tile
    float part[SPW][kTiles][4];
#pragma unroll
    for (int j = 0; j < SPW; ++j)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][q][e] = 0.f;
    const int nks = cnt16 >> 4;
#pragma unroll 2
    for (int ks = kg; ks < nks; ks += wk) mma_step(ks * 16, part);
#pragma unroll
    for (int j = 0; j < SPW; ++j)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[((j * kTiles + q) * 4 + e) * 32] += part[j][q][e];
  }

  // each spec's wk totals, added in kg order; entry (r, c) sits in tile
  // (r / 16, c / 8) at lane 4 (r % 8) + (c % 8) / 2, element
  // 2 ((r / 8) % 2) + c % 2
  __syncthreads();
  const float* runs = reinterpret_cast<const float*>(smem + L.run_off);
  const int qq = qe * qe;
  for (int idx = tid; idx < nsb * qq; idx += nthreads) {
    const int s = idx / qq;
    const int rem = idx - s * qq;
    const int r = rem / qe, c = rem - (rem / qe) * qe;
    if (r > c) continue;
    const int gs = s / spg, j = s - gs * spg;
    const int q = tc_tile_index(r >> 4, c >> 3, NT);
    const int e = ((r >> 3) & 1) * 2 + (c & 1);
    const int at = ((j * kTiles + q) * 4 + e) * 32 + (r & 7) * 4 + ((c >> 1) & 3);
    float sum = 0.f;
    for (int kk = 0; kk < wk; ++kk) sum += runs[(gs * wk + kk) * 32 * kRun + at];
    float* blk = out + ((size_t)(s_lo + s) * t_len + t) * qq;
    blk[r * qe + c] = sum;
    blk[c * qe + r] = sum;
  }
}

template <int MT, int NT, int SPW, bool kRw>
int launch_tc(const void* x, const void* y, const void* rw, const unsigned char* valid,
              const unsigned int* sel_bits, const void* center, void* out, int t_len,
              long long n, int p, int s_specs, cudaStream_t stream) {
  constexpr int kMp = 16 * MT;
  // spec groups of at most SPW, balanced; up to four a block (one warp
  // each), the rest over gridDim.y; fewer than four groups split each
  // tile's steps over wk warps a group
  const int groups0 = (s_specs + SPW - 1) / SPW;
  const int spg = (s_specs + groups0 - 1) / groups0;
  const int groups = (s_specs + spg - 1) / spg;
  int ws = std::min(groups, kTcThreads / 32);
  const int n_blocks_y = (groups + ws - 1) / ws;
  ws = (groups + n_blocks_y - 1) / n_blocks_y;
  const int wk = std::max(1, kTcThreads / 32 / ws);
  const int threads = 32 * ws * wk;
  const int nsb_max = std::min(ws * spg, s_specs);
  auto smem_for = [&](int tl) {
    return make_tc_layout(tl, p, nsb_max, kMp, kRw, ws * wk,
                          SPW * tc_tiles(MT, NT) * 4).total;
  };
  // a tile of two firms per thread, doubled while it stays within the
  // largest tile, halved (in multiples of 16) while it exceeds the budget
  int tile = 2 * threads;
  while (2 * tile <= kTcMaxTile) tile *= 2;
  while (tile > kMinTile && smem_for(tile) > kTcSmemBudget)
    tile = std::max(kMinTile, (tile / 2) & ~15);
  const size_t smem = smem_for(tile);
  if (smem > kSmemMax || n_blocks_y > 65535) return -1;
  cudaError_t err = cudaFuncSetAttribute(gram_tc_kernel<MT, NT, SPW, kRw>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)t_len, (unsigned)n_blocks_y);
  gram_tc_kernel<MT, NT, SPW, kRw><<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(rw), valid, sel_bits,
      static_cast<const __nv_bfloat16*>(center), static_cast<float*>(out), t_len, n, p,
      s_specs, tile, spg, ws, wk);
  return (int)cudaGetLastError();
}

// --- shared by the float64 kernel and the float and bf16 kernels past 32 ---
// --- columns ------------------------------------------------------------------

constexpr int kOneLaunchSpecs = 65536;  // the most specs one launch of either takes

// A spec's (QE x QE) block as 16-row strips of 8-column output tiles: strip
// mi keeps tiles nj = 2 mi .. nt - 1, those holding an entry on or above the
// diagonal. Strips mi and mt - 1 - mi together hold c = 2 (nt - mt + 1)
// tiles whatever mi, the middle strip of an odd mt c / 2; a chunk is cs
// tiles of one such pair (cs = c / 2 cut into the fewest equal parts of at
// most 8), the last chunk of a pair or of the middle strip maybe fewer,
// so the chunks of a spec are (near) equal. The kernels take the chunk
// width as a template argument JW >= cs: a slot past a chunk's tiles
// repeats its last tile into sums that are never stored, so no branch
// splits a step.
struct Strips {
  int mt, nt;  // strips of 16 rows, tiles of 8 columns
  int c;       // tiles of a strip pair
  int cs, q;   // tiles of a chunk, chunks of a pair
  int tps;     // chunks a spec: q a pair, and the middle strip's
};

__host__ __device__ inline Strips make_strips(int qe) {
  Strips g;
  g.mt = (qe + 15) / 16;
  g.nt = (qe + 7) / 8;
  g.c = 2 * (g.nt - g.mt + 1);
  const int h = g.c / 2, k = (h + 7) / 8;
  g.cs = (h + k - 1) / k;
  g.q = (g.c + g.cs - 1) / g.cs;
  g.tps = (g.mt / 2) * g.q + ((g.mt & 1) ? (h + g.cs - 1) / g.cs : 0);
  return g;
}



// Task u of a spec: tiles (mi_a, nj_a + j) for j < n_a, then
// (mi_b, nj_b + j - n_a) for n_a <= j < n_a + n_b.
struct Chunk {
  int mi_a, nj_a, n_a, mi_b, nj_b, n_b;
};

__device__ inline Chunk decode_chunk(const Strips& g, int u) {
  const int paired = (g.mt / 2) * g.q;
  int a, lo, hi, len_a;  // the pair's first strip, the chunk's tiles in the pair's list
  if (u < paired) {
    a = u / g.q;
    lo = (u - a * g.q) * g.cs;
    hi = min(g.c, lo + g.cs);
    len_a = g.nt - 2 * a;
  } else {  // the middle strip
    a = g.mt / 2;
    lo = (u - paired) * g.cs;
    hi = min(g.c / 2, lo + g.cs);
    len_a = g.c / 2;
  }
  Chunk k;
  k.mi_a = a;
  k.nj_a = 2 * a + lo;
  k.n_a = max(0, min(hi, len_a) - lo);
  k.mi_b = g.mt - 1 - a;
  k.nj_b = 2 * k.mi_b + max(lo, len_a) - len_a;
  k.n_b = max(0, hi - max(lo, len_a));
  return k;
}

// A block's warps: the first kProducerWarps stage and build the tiles into
// one of two built buffers, the rest (at most kConsumerWarps) sum the
// products of the other: the build of tile k + 1 overlaps the products of
// tile k. Named barriers hand a buffer over: kBarProd the producers' own,
// kBarFull + b buffer b built, kBarEmpty + b buffer b summed, kBarCons the
// consumers' own (id 0 is __syncthreads').
constexpr int kProducerWarps = 4;
constexpr int kConsumerWarps = 12;
constexpr int kBlockThreads = 32 * (kProducerWarps + kConsumerWarps);
constexpr int kBarProd = 1, kBarFull = 2, kBarEmpty = 4, kBarCons = 6;
constexpr size_t kGramSmemBudget = 220 * 1024;  // one block an SM

// A month's work: a task is taken by consumer warps; each spec has ups
// units of work (the float64 and bf16 kernels: its tps chunks, a task one
// chunk; the float32 kernel: its 8x8 tiles, a task 32 of them, one a lane),
// `unit` units a task, the tasks of a month in spec order. A block takes tpb
// consecutive tasks, splits blocks a month, the split index fastest.
struct BlockPlan {
  int tpb, splits, nsb, tile;
  size_t smem;
  double cost;
};

// The float64 and bf16 kernels' cost of a month: rounds of consumer warps
// (a DMMA task is latency-bound, so every warp of a round runs at once).
inline double warp_rounds(long long splits, long long tpb) {
  return (double)(splits * ((tpb + kConsumerWarps - 1) / kConsumerWarps));
}

// The plan: of the task counts a block whose running sums, staged tiles
// and built buffers fit `budget` with a tile of at least `min_tile` firms
// (the largest such tile) and whose valid rows fit warp 0's lanes, the one
// of the least cost(splits, tasks a block) a month, then the fewest splits
// (each stages and builds the month's tiles); else (a very wide union) the
// same in the most a block may take with any tile. smem_for(tile, tasks a
// block, specs a block) is the kernel's layout.
template <typename SmemFor, typename Cost>
BlockPlan plan_blocks(int s_specs, int ups, int unit, int min_tile, size_t budget,
                      SmemFor smem_for, Cost cost) {
  const long long tasks = ((long long)s_specs * ups + unit - 1) / unit;
  for (int pass = 0; pass < 2; ++pass) {
    const size_t cap = pass == 0 ? budget : kSmemMax;
    const int floor_tile = pass == 0 ? min_tile : kMinTile;
    BlockPlan best{0, 0, 0, 0, 0, 0.0};
    // each distinct tasks-a-block count once, the fewest splits first
    for (long long splits = 1; splits <= tasks;) {
      const long long tpb = (tasks + splits - 1) / splits;
      const long long sp = (tasks + tpb - 1) / tpb;
      const double c = cost(sp, tpb);
      // the most specs tpb * unit consecutive units touch
      const int nsb = (int)std::min<long long>((tpb * unit + ups - 2) / ups + 1, s_specs);
      if (nsb + 3 <= 32 && (best.tpb == 0 || c < best.cost)) {
        for (int tile = kTcMaxTile; tile >= floor_tile; tile /= 2) {
          const size_t bytes = smem_for(tile, (int)tpb, nsb);
          if (bytes <= cap) {
            best = {(int)tpb, (int)sp, nsb, tile, bytes, c};
            break;
          }
        }
      }
      if (tpb == 1) break;
      splits = (tasks + tpb - 2) / (tpb - 1);
    }
    if (best.tpb != 0) return best;
  }
  return {0, 0, 0, 0, 0, 0.0};
}

// A block's tasks and specs, as the kernels derive them from the plan:
// tasks [t0, t0 + ntask), specs [s_lo, s_lo + nsb).
struct BlockWork {
  int t0, ntask, s_lo, nsb;
};

__device__ inline BlockWork block_work(int split, int s_specs, int ups, int tpb, int unit) {
  const long long units = (long long)s_specs * ups;
  const long long tasks = (units + unit - 1) / unit;
  BlockWork w;
  w.t0 = split * tpb;
  const long long t1 = w.t0 + tpb < tasks ? w.t0 + tpb : tasks;
  const long long u1 = t1 * unit < units ? t1 * unit : units;  // the block's last unit + 1
  w.ntask = (int)(t1 - w.t0);
  w.s_lo = (int)((long long)w.t0 * unit / ups);
  w.nsb = (int)((u1 - 1) / ups) - w.s_lo + 1;
  return w;
}

// A raw row of the staged tiles as one lane of warp 0 holds it: its first
// byte at firm 0 of the month, its bytes a firm, and its offset in a stage
// (a lane past the block's rows holds bpf = 0 and copies nothing).
struct RawRow {
  const unsigned char* src;
  int bpf;
  unsigned dst;
};

// Stage firms n0 .. n0 + cnt - 1 of each lane's row into the stage at `st`
// by the copy engine (warp 0 only): the row's 16-byte-aligned interior as
// one bulk copy (1-D TMA) that completes on `bar` (lane 0 first arms it with
// the bytes of all of them), its ragged head and tail byte by byte. Byte e
// of a row lands at st + dst + (its source address & 15) + e, as stage_rows
// places it.
__device__ __forceinline__ void stage_bulk(const RawRow& row, long long n0, int cnt,
                                           unsigned char* st, uint64_t* bar, int lane) {
  const unsigned char* src = row.src + n0 * row.bpf;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src), hi = lo + (uintptr_t)cnt * row.bpf;
  const uintptr_t a = (lo + 15) & ~uintptr_t(15);
  const uintptr_t b = (hi & ~uintptr_t(15)) > a ? (hi & ~uintptr_t(15)) : a;
  unsigned char* dst = st + row.dst + (lo & 15);  // byte e of the row goes to dst[e]
  const unsigned total = __reduce_add_sync(0xffffffffu, (unsigned)(b - a));
  if (lane == 0) mbar_expect_tx(bar, total);
  __syncwarp();
  if (b > a)
    bulk_copy(dst + (a - lo), reinterpret_cast<const void*>(a), (unsigned)(b - a), bar);
  for (uintptr_t e = lo; e < (b > a ? a : hi); ++e) dst[e - lo] = src[e - lo];
  for (uintptr_t e = b > a ? b : hi; e < hi; ++e) dst[e - lo] = src[e - lo];
}

// d += a b on the FP64 tensor cores: a 16x8 row-major, b 8x8 column-major.
// Lane 4 g + t holds a = (A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]),
// b = (B[t][g], B[t+4][g]) and d = (D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]).
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4], double b0,
                                        double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// Four (two) 8x8 bf16 matrices from shared memory in the fragment layout
// of mma.m16n8k16: lanes 8 i .. 8 i + 7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}


// --- warp-specialized blocks, shared by the float64 and wide kernels -------

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A block's task table: a task's two runs of tiles and its spec.
constexpr int kTaskInts = 8;  // mi_a, nj_a, n_a, mi_b, nj_b, n_b, local spec, pad

// Each task's entry in the block's table (threads of the block in turn).
__device__ inline void fill_tasks(const Strips& G, const BlockWork& w, int* tasks, int tid,
                                  int nthreads) {
  for (int i = tid; i < w.ntask; i += nthreads) {
    const int q = w.t0 + i, spec = q / G.tps;
    const Chunk ch = decode_chunk(G, q - spec * G.tps);
    int* e = tasks + kTaskInts * i;
    e[0] = ch.mi_a;
    e[1] = ch.nj_a;
    e[2] = ch.n_a;
    e[3] = ch.mi_b;
    e[4] = ch.nj_b;
    e[5] = ch.n_b;
    e[6] = spec - w.s_lo;
  }
}


// Each spec of the block's selection words (y enters every spec's selection
// as column p) and the offset of its valid row in a stage.
template <typename Layout>
__device__ inline void fill_specs(const Layout& L, unsigned char* smem,
                                  const unsigned int* sel_bits, const unsigned char* v_first,
                                  long long v_stride, int s_lo, int nsb, int nw, int p, int tid,
                                  int nthreads) {
  unsigned* spec_sel = reinterpret_cast<unsigned*>(smem + L.sel_off);
  int* spec_voff = reinterpret_cast<int*>(smem + L.voff_off);
  const int nwb = L.nwb;
  for (int e = tid; e < nsb * nwb; e += nthreads) {
    const int sl = e / nwb, wd = e - sl * nwb;
    unsigned v = wd < nw ? sel_bits[(size_t)(s_lo + sl) * nw + wd] : 0u;
    if (wd == p / 32) v |= 1u << (p % 32);
    spec_sel[e] = v;
  }
  for (int sl = tid; sl < nsb; sl += nthreads)
    spec_voff[sl] = sl * (int)L.v_row + misalign(v_first + sl * v_stride);
}

// The raw row that lane r of warp 0 stages for each tile of month row_t / n:
// x, y, the row weights (kRw), then the block's valid rows (at most 29
// specs a block; a lane past them stages nothing).
template <typename In, bool kRw, typename Layout>
__device__ inline RawRow raw_row(const Layout& L, const In* x, const In* y, const In* rw,
                                 long long row_t, int p, const unsigned char* v_first,
                                 long long v_stride, int nsb, int lane) {
  const size_t rw_off = L.x_bytes + L.y_bytes;
  const size_t v_off = rw_off + L.rw_bytes;
  const int n_raw = kRw ? 3 : 2;
  constexpr int b = (int)sizeof(In);
  if (lane == 0) return {reinterpret_cast<const unsigned char*>(x + row_t * p), b * p, 0u};
  if (lane == 1) return {reinterpret_cast<const unsigned char*>(y + row_t), b, (unsigned)L.x_bytes};
  if (kRw && lane == 2)
    return {reinterpret_cast<const unsigned char*>(rw + row_t), b, (unsigned)rw_off};
  if (lane < n_raw + nsb) {
    const int sr = lane - n_raw;
    return {v_first + sr * v_stride, 1, (unsigned)(v_off + sr * L.v_row)};
  }
  return {nullptr, 0, 0u};
}

// The producers (warps 0 .. kProducerWarps - 1) of a block whose built
// rows are row-major in the operand type T (the float64 and the wide
// float32 kernels): stage each tile of month t by the copy engine into a
// ring of two stages and build it, once for every spec of the block, into
// built buffer k & 1, which the consumers free (kBarEmpty) before it is
// built again and take (kBarFull) once built. Column c (0 .. mp - 1) of
// firm f's augmented row [1 | x - c | y | 0 pad] lands at
// rows[f * L.qp + col(c)], spec s's weight of firm f at
// wts[s * wstride + f]; firms cnt .. cnt8 - 1 of a ragged tile get zero
// rows and weights. The block's prologue has filled the center, the spec
// tables (fill_specs) and the mbarriers.
template <typename T, bool kRw, typename Layout, typename Col>
__device__ inline void produce_tiles(const Layout& L, unsigned char* smem, const T* x,
                                     const T* y, const T* rw, const unsigned char* v_first,
                                     long long v_stride, int t, long long n, int p, int nsb,
                                     int tile, int mp, int wstride, Col col, int tid,
                                     int nthreads) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nprod = 32 * kProducerWarps;
  const int qp = L.qp, nwb = L.nwb;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // one a stage
  const T* cen = reinterpret_cast<const T*>(smem + L.cen_off);
  const unsigned* spec_sel = reinterpret_cast<const unsigned*>(smem + L.sel_off);
  const int* spec_voff = reinterpret_cast<const int*>(smem + L.voff_off);
  unsigned* badw = reinterpret_cast<unsigned*>(smem + L.bad_off);
  const long long n_tiles = (n + tile - 1) / tile;
  const long long row_t = (long long)t * n;
  // tiles start at multiples of 16 firms, so each source's misalignment
  // is the same for every tile of the month
  const int x_mis = misalign(x + row_t * p);
  const int y_mis = misalign(y + row_t);
  const int rw_mis = kRw ? misalign(rw + row_t) : 0;
  const size_t rw_off = L.x_bytes + L.y_bytes;
  const size_t v_off = rw_off + L.rw_bytes;
  const RawRow raw = raw_row<T, kRw>(L, x, y, rw, row_t, p, v_first, v_stride, nsb, lane);
  auto stage_tile = [&](long long n0, int buf) {
    if (warp == 0)
      stage_bulk(raw, n0, (int)min((long long)tile, n - n0), smem + buf * L.stage,
                 bars + buf, lane);
  };
  // a row of at most 16 columns past the intercept takes a half-warp
  // (two firms an iteration), a wider one a warp per 32 columns
  const int fpi = mp <= 16 ? 2 : 1;
  const int cw = 32 / fpi;
  const int nwr = (mp - 1 + cw - 1) / cw;  // words of columns 1 .. mp - 1
  const int h_lane = lane / cw, c_lane = lane - h_lane * cw;
  stage_tile(0, 0);
  // warp 0's byte copies of a ragged head or tail precede every
  // producer's reads: for tile 0 this barrier, for a later tile the one
  // that ends the build before it
  bar_sync(kBarProd, nprod);
  for (long long k = 0; k < n_tiles; ++k) {
    const long long n0 = k * tile;
    const int cnt = (int)min((long long)tile, n - n0);
    const int cnt8 = (cnt + 7) & ~7;
    const int b = (int)(k & 1);
    if (k >= 2) bar_sync(kBarEmpty + b, nthreads);  // the consumers are done with buffer b
    mbar_wait(bars + b, (unsigned)((k >> 1) & 1));
    // the other stage was last read by the build of tile k - 1, which
    // every producer finished
    if (k + 1 < n_tiles) stage_tile(n0 + tile, b ^ 1);
    const unsigned char* st = smem + b * L.stage;
    const T* xr = reinterpret_cast<const T*>(st + x_mis);
    const T* yr = reinterpret_cast<const T*>(st + L.x_bytes + y_mis);
    const T* rwr = reinterpret_cast<const T*>(st + rw_off + rw_mis);
    const unsigned char* vr = st + v_off;
    T* rows = reinterpret_cast<T*>(smem + L.rows_off + b * L.rows_bytes);
    T* wts = reinterpret_cast<T*>(smem + L.w_off + b * L.w_bytes);
    // phase 1: lane c of word wd writes column cw wd + c + 1 of the
    // augmented rows (x column cw wd + c, y as column p) of a warp's
    // firms, and one ballot a firm gives the word's non-finite bits;
    // branch-free, the firms independent of one another
    for (int wd = 0; wd < nwr; ++wd) {
      const int cc = cw * wd + c_lane;
      const bool is_x = cc < p, is_y = cc == p, in_row = cc + 1 < mp;
      const T cen_c = is_x ? cen[cc] : T(0);
      const int xo = is_x ? cc : 0;
      const int at = in_row ? col(cc + 1) : 0;
#pragma unroll 4
      for (int fg = warp; fg < cnt8 / fpi; fg += kProducerWarps) {
        const int f = fpi * fg + h_lane;
        const T xv = xr[f * p + xo], yv = yr[f];
        const T raw_v = is_y ? yv : xv;
        const bool keep = (is_x || is_y) && f < cnt;
        const bool bad = keep && !isfinite(raw_v);
        if (in_row) rows[f * qp + at] = keep && !bad ? (is_x ? raw_v - cen_c : raw_v) : T(0);
        const unsigned bits = __ballot_sync(0xffffffffu, bad);
        if (c_lane == 0 && wd < nwb)
          badw[f * nwb + wd] = fpi == 1 ? bits : (bits >> (16 * h_lane)) & 0xFFFFu;
      }
    }
    bar_sync(kBarProd, nprod);
    // phase 2, a thread a (spec, firm): the intercept column and each
    // weight, rw (or 1) where the valid byte is set and no selected
    // column, y included, is non-finite, else 0
    for (int f = tid; f < cnt8; f += nprod) rows[f * qp + col(0)] = f < cnt ? T(1) : T(0);
    for (int s = 0; s < nsb; ++s) {
      for (int f = tid; f < cnt8; f += nprod) {
        unsigned hit = 0u;
        for (int wd = 0; wd < nwb; ++wd) hit |= badw[f * nwb + wd] & spec_sel[s * nwb + wd];
        wts[s * wstride + f] =
            f < cnt && vr[spec_voff[s] + f] != 0 && hit == 0u ? (kRw ? rwr[f] : T(1)) : T(0);
      }
    }
    // every producer is done with the stage and the non-finite words
    bar_sync(kBarProd, nprod);
    bar_arrive(kBarFull + b, nthreads);  // buffer b is built
  }
}


// --- float64 on the FP64 tensor cores (DMMA) --------------------------------

// Byte offsets of one block's dynamic shared memory: two stages of raw
// tiles (x, y, the row weights when there are any, one valid row per spec
// of the block) and their mbarriers, the month's center, each spec's
// selection words (y as column p) and valid row offset, each firm's
// non-finite words, two built buffers (the row-major augmented rows and
// each (spec, firm) weight), the task table and each task's running sums
// (cs tiles of 4 doubles a lane, lane-interleaved).
struct DmmaLayout {
  int qp;   // row stride in doubles: 16 mt + 4, 4 mod 16 (no bank conflict)
  int nwb;  // words of a firm's non-finite bits: x columns 0 .. p - 1, y as p
  size_t x_bytes, y_bytes, rw_bytes, v_row, stage;
  size_t bar_off, cen_off, sel_off, voff_off, bad_off, rows_off, rows_bytes, w_off, w_bytes,
      task_off, run_off, total;
};

__host__ __device__ inline DmmaLayout make_dmma_layout(int tile, int p, int mt, int nsb,
                                                       bool has_rw, int ntask, int run_slots) {
  DmmaLayout L;
  L.qp = 16 * mt + 4;
  L.nwb = p / 32 + 1;
  L.x_bytes = up16((size_t)tile * p * 8 + 16);
  L.y_bytes = up16((size_t)tile * 8 + 16);
  L.rw_bytes = has_rw ? L.y_bytes : 0;
  L.v_row = up16((size_t)tile + 16);
  L.stage = L.x_bytes + L.y_bytes + L.rw_bytes + L.v_row * nsb;
  L.bar_off = 2 * L.stage;
  L.cen_off = L.bar_off + 16;
  L.sel_off = L.cen_off + up16((size_t)p * 8);
  L.voff_off = L.sel_off + up16((size_t)nsb * L.nwb * 4);
  L.bad_off = L.voff_off + up16((size_t)nsb * 4);
  L.rows_off = L.bad_off + up16((size_t)tile * L.nwb * 4);
  L.rows_bytes = (size_t)tile * L.qp * 8;
  L.w_off = L.rows_off + 2 * L.rows_bytes;
  L.w_bytes = up16((size_t)nsb * tile * 8);
  L.task_off = L.w_off + 2 * L.w_bytes;
  L.run_off = L.task_off + up16((size_t)ntask * kTaskInts * 4);
  L.total = L.run_off + (size_t)ntask * run_slots * 128 * 8;
  return L;
}

// JW tiles a chunk.
template <int JW, bool kRw>
__global__ void __launch_bounds__(kBlockThreads, 1)
gram_dmma_kernel(const double* __restrict__ x, const double* __restrict__ y,
                 const double* __restrict__ rw, const unsigned char* __restrict__ valid,
                 const unsigned int* __restrict__ sel_bits, const double* __restrict__ center,
                 double* __restrict__ out, int t_len, long long n, int p, int nw, int s_specs,
                 int tile, int splits, int tpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qe = p + 2;
  const Strips G = make_strips(qe);
  const int mp = 16 * G.mt;  // rows of the strips: QE padded
  const int t = blockIdx.x / splits;
  const BlockWork W = block_work(blockIdx.x - t * splits, s_specs, G.tps, tpb, 1);
  const int ntask = W.ntask, s_lo = W.s_lo, nsb = W.nsb;
  const int run_slots = G.cs;  // a task's running sums: its cs tiles
  const DmmaLayout L = make_dmma_layout(tile, p, G.mt, nsb, kRw, tpb, run_slots);
  const int qp = L.qp;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // one a stage
  double* cen = reinterpret_cast<double*>(smem + L.cen_off);
  int* tasks = reinterpret_cast<int*>(smem + L.task_off);
  double* run = reinterpret_cast<double*>(smem + L.run_off);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const unsigned char* v_first = valid + ((long long)s_lo * t_len + t) * n;
  const long long v_stride = (long long)t_len * n;
  for (int c = tid; c < p; c += nthreads) cen[c] = center[(size_t)t * p + c];
  fill_specs(L, smem, sel_bits, v_first, v_stride, s_lo, nsb, nw, p, tid, nthreads);
  fill_tasks(G, W, tasks, tid, nthreads);
  for (int i = tid; i < ntask * run_slots * 128; i += nthreads) run[i] = 0.0;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
  }
  __syncthreads();

  const long long n_tiles = (n + tile - 1) / tile;
  if (warp < kProducerWarps) {
    produce_tiles<double, kRw>(L, smem, x, y, rw, v_first, v_stride, t, n, p, nsb, tile, mp,
                               tile, [](int c) { return c; }, tid, nthreads);
    return;
  }

  // --- consumers: a warp's tasks one after another on each built buffer:
  // per 8 firms the A fragments of the task's (at most two)
  // strips, w o a, then one MMA a slot against its tile's unweighted rows,
  // into a fresh sum per tile that is added into the task's running sums ---
  const int cwarp = warp - kProducerWarps;
  const int ncw = (nthreads >> 5) - kProducerWarps;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  for (long long k = 0; k < n_tiles; ++k) {
    const int cnt = (int)min((long long)tile, n - k * tile);
    const int cnt8 = (cnt + 7) & ~7;
    const int b = (int)(k & 1);
    bar_sync(kBarFull + b, nthreads);
    const double* rows = reinterpret_cast<const double*>(smem + L.rows_off + b * L.rows_bytes);
    const double* wts = reinterpret_cast<const double*>(smem + L.w_off + b * L.w_bytes);
    for (int i = cwarp; i < ntask; i += ncw) {
      const int* e = tasks + kTaskInts * i;
      const int n_a = e[2], n_tot = n_a + e[5];
      int c8[JW];  // each slot's B column (a slot past the chunk repeats its last tile)
#pragma unroll
      for (int j = 0; j < JW; ++j) {
        const int jj = max(0, min(j, n_tot - 1));
        c8[j] = 8 * (jj < n_a ? e[1] + jj : e[4] + jj - n_a);
      }
      double part[JW][4];
#pragma unroll
      for (int j = 0; j < JW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[j][q] = 0.0;
      const double* wrow = wts + e[6] * tile + tq;
      const int ca = 16 * e[0], cb = 16 * e[3];
      for (int f0 = 0; f0 < cnt8; f0 += 8) {
        const double* ra = rows + (f0 + tq) * qp + gq;  // firm f0 + t, column g
        const double* rb = ra + 4 * qp;                 // firm f0 + t + 4
        const double w0 = wrow[f0], w1 = wrow[f0 + 4];
        const double fa[4] = {w0 * ra[ca], w0 * ra[ca + 8], w1 * rb[ca], w1 * rb[ca + 8]};
        double fb[4] = {fa[0], fa[1], fa[2], fa[3]};
        if (n_tot > n_a) {
          fb[0] = w0 * ra[cb];
          fb[1] = w0 * ra[cb + 8];
          fb[2] = w1 * rb[cb];
          fb[3] = w1 * rb[cb + 8];
        }
#pragma unroll
        for (int j = 0; j < JW; ++j) {
          const bool in_a = j < n_a;
          const double a[4] = {in_a ? fa[0] : fb[0], in_a ? fa[1] : fb[1],
                               in_a ? fa[2] : fb[2], in_a ? fa[3] : fb[3]};
          mma_f64(part[j], a, ra[c8[j]], rb[c8[j]]);
        }
      }
      double* rs = run + (size_t)i * run_slots * 128 + lane;
#pragma unroll
      for (int j = 0; j < JW; ++j)
        if (j < n_tot)
#pragma unroll
          for (int q = 0; q < 4; ++q) rs[(j * 4 + q) * 32] += part[j][q];
    }
    // buffer b may be rebuilt (the producers wait for it two tiles on)
    if (k + 2 < n_tiles) bar_arrive(kBarEmpty + b, nthreads);
  }

  // each task's entries on or above the diagonal, and their mirrors:
  // element q of a lane's sums is row 16 mi + g + 8 (q / 2), column
  // 8 nj + 2 t + q % 2
  for (int i = cwarp; i < ntask; i += ncw) {
    const int* e = tasks + kTaskInts * i;
    const int n_a = e[2], n_tot = n_a + e[5];
    double* blk = out + ((size_t)(s_lo + e[6]) * t_len + t) * qe * qe;
    const double* rs = run + (size_t)i * run_slots * 128 + lane;
    for (int j = 0; j < n_tot; ++j) {
      const int mi = j < n_a ? e[0] : e[3];
      const int nj = j < n_a ? e[1] + j : e[4] + j - n_a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * mi + gq + 8 * (q >> 1), c = 8 * nj + 2 * tq + (q & 1);
        const double v = rs[(j * 4 + q) * 32];
        if (r <= c && c < qe) {
          blk[r * qe + c] = v;
          blk[c * qe + r] = v;
        }
      }
    }
  }
}

template <int JW, bool kRw>
int launch_dmma(const void* x, const void* y, const void* rw, const unsigned char* valid,
                const unsigned int* sel_bits, const void* center, void* out, int t_len,
                long long n, int p, int nw, int s_specs, cudaStream_t stream) {
  const Strips G = make_strips(p + 2);
  const BlockPlan B = plan_blocks(s_specs, G.tps, 1, 32, kGramSmemBudget,
                                  [&](int tl, int ntask, int nsb) {
                                    return make_dmma_layout(tl, p, G.mt, nsb, kRw, ntask, G.cs)
                                        .total;
                                  },
                                  warp_rounds);
  if (B.tpb == 0 || (long long)B.splits * t_len > 0x7fffffffLL) return -1;
  cudaError_t err = cudaFuncSetAttribute(gram_dmma_kernel<JW, kRw>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)B.smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (kProducerWarps + std::min(B.tpb, kConsumerWarps));
  gram_dmma_kernel<JW, kRw><<<(unsigned)(B.splits * t_len), threads, B.smem, stream>>>(
      static_cast<const double*>(x), static_cast<const double*>(y),
      static_cast<const double*>(rw), valid, sel_bits, static_cast<const double*>(center),
      static_cast<double*>(out), t_len, n, p, nw, s_specs, B.tile, B.splits, B.tpb);
  return (int)cudaGetLastError();
}

template <bool kRw>
int launch_f64(const void* x, const void* y, const void* rw, const unsigned char* valid,
               const unsigned int* sel_bits, const void* center, void* out, int t_len,
               long long n, int p, int nw, int s_specs, cudaStream_t stream) {
  const int cs = make_strips(p + 2).cs;
  if (cs <= 2)
    return launch_dmma<2, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p, nw,
                               s_specs, stream);
  if (cs <= 4)
    return launch_dmma<4, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p, nw,
                               s_specs, stream);
  return launch_dmma<8, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p, nw, s_specs,
                             stream);
}


// --- bf16 operands past 32 columns: warp-specialized, as the float64 kernel -

// Byte offsets of one block's dynamic shared memory: two stages of raw
// tiles (as the float64 kernel's) and their mbarriers, the month's center
// in float, each spec's selection words (y as column p) and valid row
// offset, each firm's non-finite words, two built buffers (the transposed
// augmented rows: mp rows of `tile` bf16 firms, stride padded by 16 bytes;
// with row weights their hi and lo parts; a 16-bit mask per (spec, firm)),
// the task table and each task's running sums (cs tiles of 4 floats a
// lane, lane-interleaved).
struct WideLayout {
  int rstride;  // bytes of one transposed row
  int nwb;      // words of a firm's non-finite bits: x columns 0 .. p - 1, y as p
  size_t x_bytes, y_bytes, rw_bytes, v_row, stage;
  size_t bar_off, cen_off, sel_off, voff_off, bad_off, rows_off, rows_bytes, buf_bytes,
      hi_off, lo_off, mask_off, task_off, run_off, total;
};

__host__ __device__ inline WideLayout make_wide_layout(int tile, int p, int mp, int nsb,
                                                       bool has_rw, int ntask, int run_slots) {
  WideLayout L;
  L.rstride = tile * 2 + 16;
  L.nwb = p / 32 + 1;
  L.x_bytes = up16((size_t)tile * p * 2 + 16);
  L.y_bytes = up16((size_t)tile * 2 + 16);
  L.rw_bytes = has_rw ? L.y_bytes : 0;
  L.v_row = up16((size_t)tile + 16);
  L.stage = L.x_bytes + L.y_bytes + L.rw_bytes + L.v_row * nsb;
  L.bar_off = 2 * L.stage;
  L.cen_off = L.bar_off + 16;
  L.sel_off = L.cen_off + up16((size_t)p * sizeof(float));
  L.voff_off = L.sel_off + up16((size_t)nsb * L.nwb * 4);
  L.bad_off = L.voff_off + up16((size_t)nsb * 4);
  L.rows_off = L.bad_off + up16((size_t)tile * L.nwb * 4);
  // a built buffer: rows, hi, lo, masks (offsets within it)
  L.rows_bytes = (size_t)mp * L.rstride;
  L.hi_off = L.rows_bytes;
  L.lo_off = L.hi_off + (has_rw ? L.rows_bytes : 0);
  L.mask_off = L.lo_off + (has_rw ? L.rows_bytes : 0);
  L.buf_bytes = L.mask_off + up16((size_t)nsb * tile * 2);
  L.task_off = L.rows_off + 2 * L.buf_bytes;
  L.run_off = L.task_off + up16((size_t)ntask * kTaskInts * 4);
  L.total = L.run_off + (size_t)ntask * run_slots * 128 * 4;
  return L;
}

// JW tiles a chunk.
template <int JW, bool kRw>
__global__ void __launch_bounds__(kBlockThreads, 1)
gram_tc_wide_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                    const __nv_bfloat16* __restrict__ rw,
                    const unsigned char* __restrict__ valid,
                    const unsigned int* __restrict__ sel_bits,
                    const __nv_bfloat16* __restrict__ center, float* __restrict__ out,
                    int t_len, long long n, int p, int nw, int s_specs, int tile, int splits,
                    int tpb) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qe = p + 2;
  const Strips G = make_strips(qe);
  const int mp = 16 * G.mt;  // transposed rows: QE padded
  const int t = blockIdx.x / splits;
  const BlockWork W = block_work(blockIdx.x - t * splits, s_specs, G.tps, tpb, 1);
  const int ntask = W.ntask, s_lo = W.s_lo, nsb = W.nsb;
  const int run_slots = G.cs;  // a task's running sums: its cs tiles
  const WideLayout L = make_wide_layout(tile, p, mp, nsb, kRw, tpb, run_slots);
  const int nwb = L.nwb;
  const int rs2 = L.rstride / 4;  // row stride in firm pairs
  const int half = tile >> 1;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // one a stage
  float* cen = reinterpret_cast<float*>(smem + L.cen_off);
  unsigned* spec_sel = reinterpret_cast<unsigned*>(smem + L.sel_off);
  int* spec_voff = reinterpret_cast<int*>(smem + L.voff_off);
  unsigned* badw = reinterpret_cast<unsigned*>(smem + L.bad_off);
  int* tasks = reinterpret_cast<int*>(smem + L.task_off);
  float* run = reinterpret_cast<float*>(smem + L.run_off);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const unsigned char* v_first = valid + ((long long)s_lo * t_len + t) * n;
  const long long v_stride = (long long)t_len * n;
  for (int c = tid; c < p; c += nthreads) cen[c] = __bfloat162float(center[(size_t)t * p + c]);
  fill_specs(L, smem, sel_bits, v_first, v_stride, s_lo, nsb, nw, p, tid, nthreads);
  fill_tasks(G, W, tasks, tid, nthreads);
  for (int i = tid; i < ntask * run_slots * 128; i += nthreads) run[i] = 0.f;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
  }
  __syncthreads();

  const long long n_tiles = (n + tile - 1) / tile;
  if (warp < kProducerWarps) {
    // --- producers: stage each tile by the copy engine and build it ---
    const int nprod = 32 * kProducerWarps;
    const long long row_t = (long long)t * n;
    // tiles start at multiples of 16 firms, so each source's misalignment
    // is the same for every tile of the month
    const int x_mis = misalign(x + row_t * p);
    const int y_mis = misalign(y + row_t);
    const int rw_mis = kRw ? misalign(rw + row_t) : 0;
    const size_t rw_off = L.x_bytes + L.y_bytes;
    const size_t v_off = rw_off + L.rw_bytes;
    const RawRow raw = raw_row<bf16, kRw>(L, x, y, rw, row_t, p, v_first, v_stride, nsb, lane);
    auto stage_tile = [&](long long n0, int buf) {
      if (warp == 0)
        stage_bulk(raw, n0, (int)min((long long)tile, n - n0), smem + buf * L.stage,
                   bars + buf, lane);
    };
    const int nwr = (mp - 1 + 31) / 32;  // 32-column words covering rows 1 .. mp - 1
    stage_tile(0, 0);
    bar_sync(kBarProd, nprod);  // warp 0's byte copies precede the reads (as the float64 kernel's)
    for (long long k = 0; k < n_tiles; ++k) {
      const long long n0 = k * tile;
      const int cnt = (int)min((long long)tile, n - n0);
      const int cnt16 = (cnt + 15) & ~15;
      const int b = (int)(k & 1);
      if (k >= 2) bar_sync(kBarEmpty + b, nthreads);  // the consumers are done with buffer b
      mbar_wait(bars + b, (unsigned)((k >> 1) & 1));
      // the other stage was last read by the build of tile k - 1, which
      // every producer finished
      if (k + 1 < n_tiles) stage_tile(n0 + tile, b ^ 1);
      const unsigned char* st = smem + b * L.stage;
      const bf16* xr = reinterpret_cast<const bf16*>(st + x_mis);
      const bf16* yr = reinterpret_cast<const bf16*>(st + L.x_bytes + y_mis);
      const bf16* rwr = reinterpret_cast<const bf16*>(st + rw_off + rw_mis);
      const unsigned char* vr = st + v_off;
      unsigned char* bb = smem + L.rows_off + b * L.buf_bytes;
      // the transposed rows, a 32-bit word per firm pair (firm 2u low, 2u + 1 high)
      uint32_t* rows = reinterpret_cast<uint32_t*>(bb);
      uint32_t* rows_hi = reinterpret_cast<uint32_t*>(bb + L.hi_off);
      uint32_t* rows_lo = reinterpret_cast<uint32_t*>(bb + L.lo_off);
      uint32_t* masks = reinterpret_cast<uint32_t*>(bb + L.mask_off);  // (spec, pair)
      auto put = [&](int i, int u, uint32_t v, float wa, float wb) {
        rows[i * rs2 + u] = v;
        if (kRw) {
          const float pa = wa * lo_float(v), pb = wb * hi_float(v);  // exact in float
          const uint32_t h = pack_bf16(pa, pb);
          rows_hi[i * rs2 + u] = h;
          rows_lo[i * rs2 + u] = pack_bf16(pa - lo_float(h), pb - hi_float(h));
        }
      };
      auto row_weights = [&](int f, uint32_t live, float& wa, float& wb) {
        wa = (kRw && (live & 1u)) ? __bfloat162float(rwr[f]) : 0.f;
        wb = (kRw && (live >> 16)) ? __bfloat162float(rwr[f + 1]) : 0.f;
      };
      // phase 1: lane c of word wd writes transposed row 32 wd + c + 1 of
      // [1 | x - c | y | 0 pad] (x column 32 wd + c, y as column p; with
      // row weights also the hi and lo parts of w * a_i) for a warp's firm
      // pairs u (firms 2u, 2u + 1), and two ballots a pair give the word's
      // non-finite bits of each firm; branch-free, the pairs independent of
      // one another. Firms cnt .. cnt16 - 1 read what the buffer holds and
      // are zeroed (`live`).
      for (int wd = 0; wd < nwr; ++wd) {
        const int cc = 32 * wd + lane;
        const bool is_x = cc < p, is_y = cc == p, in_row = cc + 1 < mp;
        const float cen_c = is_x ? cen[cc] : 0.f;
        const int xo = is_x ? cc : 0;
#pragma unroll 4
        for (int u = warp; u < (cnt16 >> 1); u += kProducerWarps) {
          const int f = 2 * u;
          const uint32_t live = halves(f < cnt, f + 1 < cnt);
          float wa, wb;
          row_weights(f, live, wa, wb);
          const uint32_t yab = (uint32_t)__bfloat16_as_ushort(yr[f]) |
                               ((uint32_t)__bfloat16_as_ushort(yr[f + 1]) << 16);
          const uint32_t xab = (uint32_t)__bfloat16_as_ushort(xr[f * p + xo]) |
                               ((uint32_t)__bfloat16_as_ushort(xr[(f + 1) * p + xo]) << 16);
          const uint32_t rab = is_y ? yab : xab;
          const float va = lo_float(rab), vb = hi_float(rab);
          const bool fa = isfinite(va), fb = isfinite(vb);
          const uint32_t v = is_x ? pack_bf16(va - cen_c, vb - cen_c) : (is_y ? rab : 0u);
          if (in_row) put(cc + 1, u, v & halves(fa, fb) & live, wa, wb);
          const unsigned ba = __ballot_sync(0xffffffffu, (is_x || is_y) && !fa);
          const unsigned bb2 = __ballot_sync(0xffffffffu, (is_x || is_y) && !fb);
          if (lane == 0 && wd < nwb) {
            badw[f * nwb + wd] = ba;
            badw[(f + 1) * nwb + wd] = bb2;
          }
        }
      }
      bar_sync(kBarProd, nprod);
      // phase 2, a thread a firm pair: the intercept row and each (spec,
      // pair) mask, 0xFFFF for a firm whose valid byte is set and no
      // selected column, y included, is non-finite, else 0
      for (int u = tid; u < (cnt16 >> 1); u += nprod) {
        const int f = 2 * u;
        const uint32_t live = halves(f < cnt, f + 1 < cnt);
        float wa, wb;
        row_weights(f, live, wa, wb);
        put(0, u, 0x3F803F80u & live, wa, wb);  // bf16 1.0 twice
        for (int s = 0; s < nsb; ++s) {
          const unsigned char* vs = vr + spec_voff[s] + f;
          unsigned hit_a = 0u, hit_b = 0u;
          for (int wd = 0; wd < nwb; ++wd) {
            const unsigned sel = spec_sel[s * nwb + wd];
            hit_a |= badw[f * nwb + wd] & sel;
            hit_b |= badw[(f + 1) * nwb + wd] & sel;
          }
          masks[s * half + u] =
              halves(vs[0] != 0 && hit_a == 0u, vs[1] != 0 && hit_b == 0u) & live;
        }
      }
      // every producer is done with the stage and the non-finite words
      bar_sync(kBarProd, nprod);
      bar_arrive(kBarFull + b, nthreads);  // buffer b is built
    }
    return;
  }

  // --- consumers: a warp's tasks one after another on each built buffer:
  // per 16 firms the A fragments of the task's (at most two)
  // strips (ldmatrix.x4, the spec's masks ANDed in), then per slot the
  // tile's B fragment (ldmatrix.x2) and one MMA (two with row weights: hi
  // and lo), into a fresh sum per tile that is added into the task's
  // running sums ---
  const int cwarp = warp - kProducerWarps;
  const int ncw = (nthreads >> 5) - kProducerWarps;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // ldmatrix row addresses (in words, within a buffer): the A fragment of
  // strip mi is rows 16 mi + (lane & 15), firms + 8 (lane >> 4); a tile's
  // B fragment rows 8 nj + (lane & 7), firms + 8 ((lane >> 3) & 1)
  const int a_lane = (lane & 15) * rs2 + (lane >> 4) * 4;
  const int b_lane = (lane & 7) * rs2 + ((lane >> 3) & 1) * 4;
  for (long long k = 0; k < n_tiles; ++k) {
    const int cnt = (int)min((long long)tile, n - k * tile);
    const int cnt16 = (cnt + 15) & ~15;
    const int b = (int)(k & 1);
    bar_sync(kBarFull + b, nthreads);
    const unsigned char* bb = smem + L.rows_off + b * L.buf_bytes;
    const uint32_t* rows = reinterpret_cast<const uint32_t*>(bb);
    const uint32_t* a_rows = reinterpret_cast<const uint32_t*>(bb + (kRw ? L.hi_off : 0)) + a_lane;
    const uint32_t* alo_rows = reinterpret_cast<const uint32_t*>(bb + L.lo_off) + a_lane;
    const uint32_t* b_rows = rows + b_lane;
    const uint32_t* masks = reinterpret_cast<const uint32_t*>(bb + L.mask_off);
    for (int i = cwarp; i < ntask; i += ncw) {
      const int* e = tasks + kTaskInts * i;
      const int n_a = e[2], n_tot = n_a + e[5];
      int boff[JW];  // each slot's B rows (a slot past the chunk repeats its last tile)
#pragma unroll
      for (int j = 0; j < JW; ++j) {
        const int jj = max(0, min(j, n_tot - 1));
        boff[j] = 8 * (jj < n_a ? e[1] + jj : e[4] + jj - n_a) * rs2;
      }
      const uint32_t* mrow = masks + e[6] * half + tq;
      const int a_off = 16 * e[0] * rs2, b_off = 16 * e[3] * rs2;
      float part[JW][4];
#pragma unroll
      for (int j = 0; j < JW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
      for (int w0 = 0; w0 < (cnt16 >> 1); w0 += 8) {
        const uint32_t m0 = mrow[w0], m1 = mrow[w0 + 4];  // firms 2 w0 + 2t, + 8
        uint32_t fa[4], fb[4], la[4] = {0u, 0u, 0u, 0u}, lb[4] = {0u, 0u, 0u, 0u};
        ldsm_x4(fa, a_rows + a_off + w0);
        ldsm_x4(fb, a_rows + b_off + w0);
        if (kRw) {
          ldsm_x4(la, alo_rows + a_off + w0);
          ldsm_x4(lb, alo_rows + b_off + w0);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t m = r < 2 ? m0 : m1;
          fa[r] &= m;
          fb[r] &= m;
          la[r] &= m;
          lb[r] &= m;
        }
#pragma unroll
        for (int j = 0; j < JW; ++j) {
          const bool in_a = j < n_a;
          uint32_t b0, b1;
          ldsm_x2(b0, b1, b_rows + boff[j] + w0);
          const uint32_t a[4] = {in_a ? fa[0] : fb[0], in_a ? fa[1] : fb[1],
                                 in_a ? fa[2] : fb[2], in_a ? fa[3] : fb[3]};
          mma_bf16(part[j], a, b0, b1);
          if (kRw) {
            const uint32_t al[4] = {in_a ? la[0] : lb[0], in_a ? la[1] : lb[1],
                                    in_a ? la[2] : lb[2], in_a ? la[3] : lb[3]};
            mma_bf16(part[j], al, b0, b1);
          }
        }
      }
      float* rs = run + (size_t)i * run_slots * 128 + lane;
#pragma unroll
      for (int j = 0; j < JW; ++j)
        if (j < n_tot)
#pragma unroll
          for (int q = 0; q < 4; ++q) rs[(j * 4 + q) * 32] += part[j][q];
    }
    // buffer b may be rebuilt (the producers wait for it two tiles on)
    if (k + 2 < n_tiles) bar_arrive(kBarEmpty + b, nthreads);
  }

  // each task's entries on or above the diagonal, and their mirrors:
  // element q of a lane's sums is row 16 mi + g + 8 (q / 2), column
  // 8 nj + 2 t + q % 2
  for (int i = cwarp; i < ntask; i += ncw) {
    const int* e = tasks + kTaskInts * i;
    const int n_a = e[2], n_tot = n_a + e[5];
    float* blk = out + ((size_t)(s_lo + e[6]) * t_len + t) * qe * qe;
    const float* rs = run + (size_t)i * run_slots * 128 + lane;
    for (int j = 0; j < n_tot; ++j) {
      const int mi = j < n_a ? e[0] : e[3];
      const int nj = j < n_a ? e[1] + j : e[4] + j - n_a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * mi + gq + 8 * (q >> 1), c = 8 * nj + 2 * tq + (q & 1);
        const float v = rs[(j * 4 + q) * 32];
        if (r <= c && c < qe) {
          blk[r * qe + c] = v;
          blk[c * qe + r] = v;
        }
      }
    }
  }
}

template <int JW, bool kRw>
int launch_tc_wide(const void* x, const void* y, const void* rw, const unsigned char* valid,
                   const unsigned int* sel_bits, const void* center, void* out, int t_len,
                   long long n, int p, int nw, int s_specs, cudaStream_t stream) {
  const Strips G = make_strips(p + 2);
  const BlockPlan B = plan_blocks(s_specs, G.tps, 1, 128, kGramSmemBudget,
                                  [&](int tl, int ntask, int nsb) {
                                    return make_wide_layout(tl, p, 16 * G.mt, nsb, kRw, ntask,
                                                            G.cs)
                                        .total;
                                  },
                                  warp_rounds);
  if (B.tpb == 0 || (long long)B.splits * t_len > 0x7fffffffLL) return -1;
  cudaError_t err = cudaFuncSetAttribute(gram_tc_wide_kernel<JW, kRw>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)B.smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (kProducerWarps + std::min(B.tpb, kConsumerWarps));
  gram_tc_wide_kernel<JW, kRw><<<(unsigned)(B.splits * t_len), threads, B.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(rw), valid, sel_bits,
      static_cast<const __nv_bfloat16*>(center), static_cast<float*>(out), t_len, n, p, nw,
      s_specs, B.tile, B.splits, B.tpb);
  return (int)cudaGetLastError();
}

// The class of QE = P + 2: QE <= 8 one 16x8 tile (six specs a warp), <= 16
// two (three), <= 32 six (one), <= 34 nine (one); past P = 32 the wide
// kernel, which takes the whole spec batch.
template <bool kRw>
int launch_bf16(const void* x, const void* y, const void* rw, const unsigned char* valid,
                const unsigned int* sel_bits, const void* center, void* out, int t_len,
                long long n, int p, int nw, int s_specs, cudaStream_t stream) {
  if (p > kMaxP)  // chunks of at least 3 tiles there
    return make_strips(p + 2).cs <= 4
               ? launch_tc_wide<4, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p,
                                        nw, s_specs, stream)
               : launch_tc_wide<8, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p,
                                        nw, s_specs, stream);
  const int qe = p + 2;
  if (s_specs > 1 && (long long)s_specs * qe * (qe + 1) / 2 > kMaxEntries) return -1;
  if (p <= 6)
    return launch_tc<1, 1, 6, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p,
                                   s_specs, stream);
  if (p <= 14)
    return launch_tc<1, 2, 3, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p,
                                   s_specs, stream);
  if (p <= 30)
    return launch_tc<2, 4, 1, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p,
                                   s_specs, stream);
  return launch_tc<3, 5, 1, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p,
                                 s_specs, stream);
}


// --- float32 past 32 columns: warp-specialized, 8x8 register tiles ---------

// Byte offsets of one block's dynamic shared memory: two stages of raw
// tiles (as the float64 kernel's) and their mbarriers, the month's center,
// each spec's selection words (y as column p) and valid row offset, each
// firm's non-finite words, two built buffers (the augmented rows, each
// segment's two halves planar, and each (spec, firm) weight), each lane's
// tile of each task and the running sums of each of a task's kparts parts
// (64 floats a lane, lane-interleaved).
struct F32WideLayout {
  int nseg;     // 8-column segments of a row: QE padded to 8
  int qp;       // floats of a built row, 8 nseg
  int wstride;  // floats of a spec's weights, tile + 1: specs in distinct banks
  int nwb;      // words of a firm's non-finite bits: x columns 0 .. p - 1, y as p
  size_t x_bytes, y_bytes, rw_bytes, v_row, stage;
  size_t bar_off, cen_off, sel_off, voff_off, bad_off, rows_off, rows_bytes, w_off, w_bytes,
      task_off, run_off, total;
};

__host__ __device__ inline F32WideLayout make_f32_wide_layout(int tile, int p, int nsb,
                                                              bool has_rw, int ntask,
                                                              int kparts) {
  F32WideLayout L;
  L.nseg = (p + 2 + 7) / 8;
  L.qp = 8 * L.nseg;
  L.wstride = tile + 1;
  L.nwb = p / 32 + 1;
  L.x_bytes = up16((size_t)tile * p * 4 + 16);
  L.y_bytes = up16((size_t)tile * 4 + 16);
  L.rw_bytes = has_rw ? L.y_bytes : 0;
  L.v_row = up16((size_t)tile + 16);
  L.stage = L.x_bytes + L.y_bytes + L.rw_bytes + L.v_row * nsb;
  L.bar_off = 2 * L.stage;
  L.cen_off = L.bar_off + 16;
  L.sel_off = L.cen_off + up16((size_t)p * 4);
  L.voff_off = L.sel_off + up16((size_t)nsb * L.nwb * 4);
  L.bad_off = L.voff_off + up16((size_t)nsb * 4);
  L.rows_off = L.bad_off + up16((size_t)tile * L.nwb * 4);
  L.rows_bytes = (size_t)tile * L.qp * 4;
  L.w_off = L.rows_off + 2 * L.rows_bytes;
  L.w_bytes = up16((size_t)nsb * L.wstride * 4);
  L.task_off = L.w_off + 2 * L.w_bytes;
  L.run_off = L.task_off + up16((size_t)ntask * 32 * 4);
  L.total = L.run_off + (size_t)ntask * kparts * 64 * 32 * 4;
  return L;
}

constexpr int kF32MinTile = 64;  // the smallest firm tile the plan's first pass takes

template <bool kRw>
__global__ void __launch_bounds__(kBlockThreads, 1)
gram_f32_wide_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ rw, const unsigned char* __restrict__ valid,
                     const unsigned int* __restrict__ sel_bits, const float* __restrict__ center,
                     float* __restrict__ out, int t_len, long long n, int p, int nw, int s_specs,
                     int tile, int splits, int tpb, int kparts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qe = p + 2;
  const int nseg = (qe + 7) / 8;
  const int ntile = nseg * (nseg + 1) / 2;  // 8x8 tiles of a spec's upper triangle
  const int t = blockIdx.x / splits;
  const BlockWork W = block_work(blockIdx.x - t * splits, s_specs, ntile, tpb, 32);
  const int ntask = W.ntask, s_lo = W.s_lo, nsb = W.nsb;
  const F32WideLayout L = make_f32_wide_layout(tile, p, nsb, kRw, tpb, kparts);
  const int qp = L.qp;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // one a stage
  float* cen = reinterpret_cast<float*>(smem + L.cen_off);
  int* tasks = reinterpret_cast<int*>(smem + L.task_off);
  float* run = reinterpret_cast<float*>(smem + L.run_off);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const unsigned char* v_first = valid + ((long long)s_lo * t_len + t) * n;
  const long long v_stride = (long long)t_len * n;
  for (int c = tid; c < p; c += nthreads) cen[c] = center[(size_t)t * p + c];
  fill_specs(L, smem, sel_bits, v_first, v_stride, s_lo, nsb, nw, p, tid, nthreads);
  // lane l of task i sums tile u = 32 (t0 + i) + l of the month's (spec,
  // tile) list, the tiles of a spec row by row: (local spec << 16) |
  // (ti << 8) | tj, or -1 past the list
  const long long u0 = 32LL * W.t0, u_end = (long long)s_specs * ntile;
  for (int i = tid; i < ntask * 32; i += nthreads) {
    const long long u = u0 + i;
    int e = -1;
    if (u < u_end) {
      const int s = (int)(u / ntile);
      int r = (int)(u - (long long)s * ntile), ti = 0;
      while (r >= nseg - ti) {
        r -= nseg - ti;
        ++ti;
      }
      e = ((s - s_lo) << 16) | (ti << 8) | (ti + r);
    }
    tasks[i] = e;
  }
  for (int i = tid; i < ntask * kparts * 64 * 32; i += nthreads) run[i] = 0.f;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
  }
  __syncthreads();

  const long long n_tiles = (n + tile - 1) / tile;
  if (warp < kProducerWarps) {
    // column c of a row: segment c / 8's first half at 4 (c / 8), its
    // second half at 4 nseg + 4 (c / 8), so that the lanes of a warp that
    // load eight different segments' halves hit eight different bank groups
    produce_tiles<float, kRw>(
        L, smem, x, y, rw, v_first, v_stride, t, n, p, nsb, tile, qp, L.wstride,
        [nseg](int c) { return ((c >> 2) & 1) * 4 * nseg + (c >> 3) * 4 + (c & 3); }, tid,
        nthreads);
    return;
  }

  // --- consumers: a warp's units one after another on each built buffer,
  // unit u part h = u % kparts of task u / kparts (firms h cnt / kparts ..
  // (h + 1) cnt / kparts - 1 of each tile); a lane sums its 8x8 tile (rows
  // 8 ti.., columns 8 tj..) for its spec over the part's firms, the weight
  // applied as the row operand is formed: per firm four 16-byte loads, one
  // weight and 8 + 64 FP32 instructions, the lanes of a warp reading one
  // firm's row (broadcasts), into a fresh sum per staged tile that is added
  // into the unit's running sums ---
  const int cwarp = warp - kProducerWarps;
  const int ncw = (nthreads >> 5) - kProducerWarps;
  const int half = 4 * nseg;
  const int nunit = ntask * kparts;
  for (long long k = 0; k < n_tiles; ++k) {
    const int cnt = (int)min((long long)tile, n - k * tile);
    const int b = (int)(k & 1);
    bar_sync(kBarFull + b, nthreads);
    const float* rows = reinterpret_cast<const float*>(smem + L.rows_off + b * L.rows_bytes);
    const float* wts = reinterpret_cast<const float*>(smem + L.w_off + b * L.w_bytes);
    for (int u = cwarp; u < nunit; u += ncw) {
      const int i = u / kparts, h = u - i * kparts;
      const int f0 = cnt * h / kparts, f1 = cnt * (h + 1) / kparts;
      // a lane past the list sums spec 0's tile (0, 0), never stored
      const int e = max(tasks[i * 32 + lane], 0);
      const float* ra = rows + 4 * ((e >> 8) & 0xFF);
      const float* rb = rows + 4 * (e & 0xFF);
      const float* wr = wts + (e >> 16) * L.wstride;
      float part[64];
#pragma unroll
      for (int q = 0; q < 64; ++q) part[q] = 0.f;
#pragma unroll 2
      for (int f = f0; f < f1; ++f) {
        const float4 a0 = *reinterpret_cast<const float4*>(ra + f * qp);
        const float4 a1 = *reinterpret_cast<const float4*>(ra + f * qp + half);
        const float4 b0 = *reinterpret_cast<const float4*>(rb + f * qp);
        const float4 b1 = *reinterpret_cast<const float4*>(rb + f * qp + half);
        const float w = wr[f];
        const float a[8] = {w * a0.x, w * a0.y, w * a0.z, w * a0.w,
                            w * a1.x, w * a1.y, w * a1.z, w * a1.w};
        const float c[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int ii = 0; ii < 8; ++ii)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) part[8 * ii + jj] = fmaf(a[ii], c[jj], part[8 * ii + jj]);
      }
      float* rs = run + (size_t)u * 64 * 32 + lane;
#pragma unroll
      for (int q = 0; q < 64; ++q) rs[q * 32] += part[q];
    }
    // buffer b may be rebuilt (the producers wait for it two tiles on)
    if (k + 2 < n_tiles) bar_arrive(kBarEmpty + b, nthreads);
  }

  // each lane's entries on or above the diagonal, and their mirrors: the
  // task's parts added in part order, once every consumer is done
  if (kparts > 1) bar_sync(kBarCons, nthreads - 32 * kProducerWarps);
  for (int i = cwarp; i < ntask; i += ncw) {
    const int e = tasks[i * 32 + lane];
    if (e < 0) continue;
    const int r0 = 8 * ((e >> 8) & 0xFF), c0 = 8 * (e & 0xFF);
    float* blk = out + ((size_t)(s_lo + (e >> 16)) * t_len + t) * qe * qe;
    const float* rs = run + (size_t)i * kparts * 64 * 32 + lane;
    for (int ii = 0; ii < 8; ++ii) {
      for (int jj = 0; jj < 8; ++jj) {
        const int r = r0 + ii, c = c0 + jj;
        if (r <= c && c < qe) {
          float v = rs[(8 * ii + jj) * 32];
          for (int h = 1; h < kparts; ++h) v += rs[(h * 64 + 8 * ii + jj) * 32];
          blk[r * qe + c] = v;
          blk[c * qe + r] = v;
        }
      }
    }
  }
}

// The plan of the float32 kernel: the block plan (plan_blocks) for one and
// for two parts a task, whichever costs less. A consumer warp's unit is
// bound by the FP32 pipes of its SM sub-partition, so a block takes about
// ceil(units / 4) units' time (consumer warp w on sub-partition w % 4),
// a unit of kparts parts 1 / kparts of a task's; each block also stages and
// builds the month once (about half a task's time, as measured on an H100).
template <bool kRw>
BlockPlan plan_f32_wide(int s_specs, int p, int& kparts) {
  const int nseg = (p + 2 + 7) / 8;
  BlockPlan best{0, 0, 0, 0, 0, 0.0};
  for (int kp = 1; kp <= 2; ++kp) {
    const BlockPlan B = plan_blocks(
        s_specs, nseg * (nseg + 1) / 2, 32, kF32MinTile, kGramSmemBudget,
        [&](int tl, int ntask, int nsb) {
          return make_f32_wide_layout(tl, p, nsb, kRw, ntask, kp).total;
        },
        [&](long long splits, long long tpb) {
          return (double)splits * ((double)((tpb * kp + 3) / 4) / kp + 0.5);
        });
    if (B.tpb != 0 && (best.tpb == 0 || B.cost < best.cost)) {
      best = B;
      kparts = kp;
    }
  }
  return best;
}

template <bool kRw>
int launch_f32_wide(const void* x, const void* y, const void* rw, const unsigned char* valid,
                    const unsigned int* sel_bits, const void* center, void* out, int t_len,
                    long long n, int p, int nw, int s_specs, cudaStream_t stream) {
  int kparts = 1;
  const BlockPlan B = plan_f32_wide<kRw>(s_specs, p, kparts);
  if (B.tpb == 0 || (long long)B.splits * t_len > 0x7fffffffLL) return -1;
  cudaError_t err = cudaFuncSetAttribute(gram_f32_wide_kernel<kRw>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)B.smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (kProducerWarps + std::min(B.tpb * kparts, kConsumerWarps));
  gram_f32_wide_kernel<kRw><<<(unsigned)(B.splits * t_len), threads, B.smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(rw),
      valid, sel_bits, static_cast<const float*>(center), static_cast<float*>(out), t_len, n,
      p, nw, s_specs, B.tile, B.splits, B.tpb, kparts);
  return (int)cudaGetLastError();
}

// Up to 32 columns the register-tile kernel (at most 8192 block entries a
// launch), past them the warp-specialized one (the whole spec batch).
template <bool kRw>
int launch_f32(const void* x, const void* y, const void* rw, const unsigned char* valid,
               const unsigned int* sel_bits, const void* center, void* out, int t_len,
               long long n, int p, int nw, int s_specs, cudaStream_t stream) {
  if (p > kMaxP)
    return launch_f32_wide<kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p, nw,
                                s_specs, stream);
  return launch<float, float, kRw>(x, y, rw, valid, sel_bits, center, out, t_len, n, p,
                                   s_specs, stream);
}

// --- wide unions: the tile-pair kernel -----------------------------------------

constexpr int kTileCols = 64;   // augmented columns a tile
constexpr int kTileSpecs = 3;   // the most specs one block sums
constexpr int kTileFirms = 64;  // firms a staged chunk
constexpr int kTileVRow = 80;   // bytes of a staged valid row: the 16-byte chunks of 64 bytes

// A block's work: month t, tile pair (ti, tj), specs s0 .. s0 + nsb - 1;
// for each side (0: tile ti, the A operand; 1: tile tj, the B operand) its
// first augmented column and the x columns xa .. xa + xn - 1 it stages
// (augmented column a is x column a - 1).
struct TileBlock {
  int t, ti, tj, s0, nsb;
  int base[2], xa[2], xn[2];
};

// Block b takes spec group b % groups of pair (b / groups) % npairs of month
// b / (groups * npairs): the groups of a pair, then the pairs of a month,
// run together, so that they read the month's firms from L2.
__device__ inline TileBlock tile_block(const int* __restrict__ pairs, int npairs, int groups,
                                       int group, int s_specs, int p) {
  TileBlock B;
  const long long b = blockIdx.x;
  const long long rest = b / groups;
  const int k = (int)(rest % npairs);
  B.t = (int)(rest / npairs);
  B.s0 = (int)(b - rest * groups) * group;
  B.nsb = min(group, s_specs - B.s0);
  B.ti = pairs[2 * k];
  B.tj = pairs[2 * k + 1];
  const int nt = (p + 2 + kTileCols - 1) / kTileCols;
  if (B.ti < 0 || B.ti > B.tj || B.tj >= nt) __trap();  // a plan the kernel does not take
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    B.base[side] = kTileCols * (side == 0 ? B.ti : B.tj);
    B.xa[side] = max(B.base[side] - 1, 0);
    B.xn[side] = max(min(B.base[side] + kTileCols - 1, p) - B.xa[side], 0);
  }
  return B;
}

// A side's field (0 or 1) by a select, so the block's fields stay in
// registers (an array indexed by a runtime side would go to local memory).
__device__ __forceinline__ int of_side(const int (&v)[2], int side) {
  return side == 0 ? v[0] : v[1];
}

__device__ __forceinline__ const unsigned char* align16(const void* p) {
  return reinterpret_cast<const unsigned char*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The 16-byte-aligned chunks that hold a byte of the span [lo, lo + bytes),
// chunk c to dst + 16 c (value e of the span lands at dst + (lo & 15) + e),
// the chunks dealt over threads `at` .. in steps of `step`. A chunk may hold
// bytes on either side of its span (the row's other columns, the next
// firm's): an aligned 16-byte chunk that holds a byte of a tensor lies
// within the tensor's allocation, whose start and size are multiples of 16
// bytes or more.
__device__ __forceinline__ void stage_span(unsigned char* dst, const unsigned char* lo,
                                           size_t bytes, int at, int step) {
  const unsigned char* src = align16(lo) + 16 * at;
  for (dst += 16 * at; src < lo + bytes; src += 16 * step, dst += 16 * step)
    cp_async16(dst, src);
}

// Stage each spec's folded valid bytes of firms n0 .. n0 + cnt - 1 (one row
// of kTileVRow bytes a spec, at v_off of the stage).
__device__ inline void stage_valid_rows(unsigned char* st, size_t v_off, const TileBlock& B,
                                        const unsigned char* valid, int t_len, long long n,
                                        long long n0, int cnt, int tid, int nthreads) {
  constexpr int ch = kTileVRow / 16;
  for (int i = tid; i < B.nsb * ch; i += nthreads) {
    const int j = i / ch;
    stage_span(st + v_off + j * kTileVRow,
               valid + ((long long)(B.s0 + j) * t_len + B.t) * n + n0, (size_t)cnt, i - j * ch,
               ch);
  }
}

// The staging loop of both instances: three stages of raw chunks in a ring,
// chunk k + 2 in flight while chunk k is summed. stage(k) stages chunk k
// into its ring slot; chunk(k, cnt) sums it once every copy of it has landed
// and every thread is done with chunk k - 1 (one barrier a chunk, and any of
// its own).
template <typename Stage, typename Chunk>
__device__ inline void tile_walk(long long n, Stage stage, Chunk chunk) {
  const long long n_chunks = (n + kTileFirms - 1) / kTileFirms;
  stage(0);
  cp_async_commit();
  if (n_chunks > 1) stage(1);
  cp_async_commit();
  for (long long k = 0; k < n_chunks; ++k) {
    cp_async_wait_1();
    __syncthreads();  // chunk k staged; chunk k - 1 summed (its ring slot free)
    if (k + 2 < n_chunks) stage(k + 2);
    cp_async_commit();
    chunk(k, (int)min((long long)kTileFirms, n - k * kTileFirms));
  }
}

// Both sides' output rows and columns of a lane's sums and the spec they
// belong to: entry (r, c) is written, and its mirror, when it lies in the
// block and on or above the diagonal (a diagonal pair's lower entries are
// its upper entries' mirrors). Each entry of the block has one writer.
template <typename A>
__device__ __forceinline__ void tile_store(A* out, const TileBlock& B, int j, int t_len, int qe,
                                           int r, int c, A v) {
  if (j < B.nsb && r < qe && c < qe && (B.ti < B.tj || r <= c)) {
    A* blk = out + ((size_t)(B.s0 + j) * t_len + B.t) * qe * qe;
    blk[(size_t)r * qe + c] = v;
    blk[(size_t)c * qe + r] = v;
  }
}

// --- bf16: built rows on the tensor cores ---

// Byte offsets of one block's dynamic shared memory: three stages of raw
// chunks (a slot of the 16-byte chunks of each (side, firm) span of 64
// bf16, each span's misalignment, y, the row weights, one folded valid row a
// spec), both panels' centers in float, the built rows (firm-major, 72 bf16
// a row: nine 16-byte units, so the eight rows of an ldmatrix fall in eight
// bank groups) of side 0 and side 1 (with row weights side 0's hi and lo
// parts), then a 0xFFFF/0 half a (spec, firm). 76 KB without row weights:
// three blocks an SM.
struct TcTileLayout {
  size_t mis_off, y_off, rw_off, v_off, stage, cen_off, built_off, built_bytes, mask_off,
      total;
};
constexpr int kTcTileSlot = 144;    // bytes of a raw (side, firm) slot
constexpr int kTcTileStride = 72;   // bf16 of a built row

__host__ __device__ inline TcTileLayout make_tc_tile_layout(bool has_rw) {
  TcTileLayout L;
  L.mis_off = (size_t)2 * kTileFirms * kTcTileSlot;
  L.y_off = L.mis_off + 2 * kTileFirms;
  L.rw_off = L.y_off + up16(kTileFirms * 2 + 16);
  L.v_off = L.rw_off + (has_rw ? up16(kTileFirms * 2 + 16) : 0);
  L.stage = L.v_off + kTileSpecs * kTileVRow;
  L.cen_off = 3 * L.stage;
  L.built_off = L.cen_off + 2 * kTileCols * sizeof(float);
  L.built_bytes = (size_t)kTileFirms * kTcTileStride * 2;
  L.mask_off = L.built_off + (has_rw ? 3 : 2) * L.built_bytes;
  L.total = L.mask_off + kTileSpecs * kTileFirms * 2;
  return L;
}

// Stage firms n0 .. n0 + cnt - 1: a thread a (side, firm, chunk), the
// chunks of a span on consecutive threads (so a warp's copies are runs of
// each row), the span's first chunk noting its misalignment; then y, the
// row weights and the valid rows.
template <bool kRw>
__device__ inline void stage_tc_tiles(const TcTileLayout& L, unsigned char* st,
                                      const TileBlock& B, const __nv_bfloat16* x,
                                      const __nv_bfloat16* y, const __nv_bfloat16* rw,
                                      const unsigned char* valid, int t_len, long long n, int p,
                                      long long n0, int cnt, int tid, int nthreads) {
  const long long row0 = (long long)B.t * n + n0;
  constexpr int ch = kTcTileSlot / 16;
  for (int i = tid; i < 2 * kTileFirms * ch; i += nthreads) {
    const int sf = i / ch, c = i - sf * ch;  // (side, firm) sf = side * 64 + firm
    const int side = sf / kTileFirms, f = sf - side * kTileFirms;
    if (f >= cnt) continue;
    const unsigned char* lo =
        reinterpret_cast<const unsigned char*>(x + (row0 + f) * p + of_side(B.xa, side));
    if (c == 0) st[L.mis_off + sf] = (unsigned char)misalign(lo);
    const unsigned char* src = align16(lo) + 16 * c;
    if (src < lo + (size_t)of_side(B.xn, side) * 2)
      cp_async16(st + (size_t)sf * kTcTileSlot + 16 * c, src);
  }
  constexpr int ych = (kTileFirms * 2 + 16) / 16;
  for (int i = tid; i < (kRw ? 2 : 1) * ych; i += nthreads) {
    const bool is_y = i < ych;
    stage_span(st + (is_y ? L.y_off : L.rw_off),
               reinterpret_cast<const unsigned char*>((is_y ? y : rw) + row0), (size_t)cnt * 2,
               is_y ? i : i - ych, ych);
  }
  stage_valid_rows(st, L.v_off, B, valid, t_len, n, n0, cnt, tid, nthreads);
}

// The bf16 build of a staged chunk, all threads: a thread a (side, firm,
// 8-column group) forms the group's values in float (x - c rounded to bf16
// as the plain version rounds it) and writes them as one 16-byte row
// segment. A group of eight x columns (all but the first group of tile 0
// and the groups past x's last column) reads them as five aligned words
// shifted into place; the others take each column as it comes (1 for the
// intercept, y, 0 past QE). With row weights side 0 writes hi =
// bf16_rn(w a) and lo = bf16_rn(w a - hi), so hi + lo == w a exactly
// (gram_tc_kernel's split). Then a thread a (spec, firm pair) writes the
// pair's 0xFFFF/0 masks from the folded valid bytes. Firms cnt ..
// kTileFirms - 1 get zero rows and masks.
template <bool kRw>
__device__ inline void build_tc_tiles(const TcTileLayout& L, unsigned char* smem,
                                      const unsigned char* st, const TileBlock& B, int p,
                                      int cnt, int y_mis, int rw_mis,
                                      const int (&v_mis)[kTileSpecs], int tid, int nthreads) {
  using bf16 = __nv_bfloat16;
  constexpr int kGroups = kTileCols / 8;
  const float* cen = reinterpret_cast<const float*>(smem + L.cen_off);
  const bf16* yr = reinterpret_cast<const bf16*>(st + L.y_off + y_mis);
  const bf16* rwr = reinterpret_cast<const bf16*>(st + L.rw_off + rw_mis);
  unsigned char* built = smem + L.built_off;
  for (int i = tid; i < 2 * kTileFirms * kGroups; i += nthreads) {
    const int side = i / (kTileFirms * kGroups);
    const int r = i - side * kTileFirms * kGroups;
    const int f = r / kGroups, q = r - f * kGroups;
    const int base = of_side(B.base, side), xa = of_side(B.xa, side);
    const int a0 = base + 8 * q;  // the group's first augmented column
    const unsigned char* slot = st + (size_t)(side * kTileFirms + f) * kTcTileSlot;
    const int mis = st[L.mis_off + side * kTileFirms + f];
    const float* cg = cen + side * kTileCols + 8 * q;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (f < cnt && a0 >= 1 && a0 + 7 <= p) {
      const int pos = mis + 2 * (a0 - 1 - xa);  // byte of x column a0 - 1 in the slot
      const uint32_t* w = reinterpret_cast<const uint32_t*>(slot + (pos & ~3));
      const uint32_t u[5] = {w[0], w[1], w[2], w[3], w[4]};
      const float4 c0 = *reinterpret_cast<const float4*>(cg);
      const float4 c1 = *reinterpret_cast<const float4*>(cg + 4);
      const float cc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint32_t xp = __funnelshift_r(u[h], u[h + 1], (pos & 2) * 8);
        const float xa_v = lo_float(xp), xb_v = hi_float(xp);
        v[h] = pack_bf16(isfinite(xa_v) ? xa_v - cc[2 * h] : 0.f,
                         isfinite(xb_v) ? xb_v - cc[2 * h + 1] : 0.f);
      }
    } else if (f < cnt) {
      const bf16* xs = reinterpret_cast<const bf16*>(slot + mis);
      const float yv = __bfloat162float(yr[f]);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float pr[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int a = a0 + 2 * h + d;
          float val = 0.f;
          if (a == 0) {
            val = 1.f;
          } else if (a <= p) {
            const float xv = __bfloat162float(xs[a - 1 - xa]);
            val = isfinite(xv) ? xv - cg[2 * h + d] : 0.f;
          } else if (a == p + 1) {
            val = isfinite(yv) ? yv : 0.f;
          }
          pr[d] = val;
        }
        v[h] = pack_bf16(pr[0], pr[1]);
      }
    }
    const size_t at = ((size_t)f * kTcTileStride + 8 * q) * 2;
    if (kRw && side == 0) {
      const float w = f < cnt ? __bfloat162float(rwr[f]) : 0.f;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float pa = w * lo_float(v[h]), pb = w * hi_float(v[h]);  // exact in float
        hi[h] = pack_bf16(pa, pb);
        lo[h] = pack_bf16(pa - lo_float(hi[h]), pb - hi_float(hi[h]));
      }
      *reinterpret_cast<uint4*>(built + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(built + 2 * L.built_bytes + at) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      *reinterpret_cast<uint4*>(built + side * L.built_bytes + at) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L.mask_off);
  for (int i = tid; i < kTileSpecs * (kTileFirms / 2); i += nthreads) {
    const int j = i / (kTileFirms / 2), f = 2 * (i - j * (kTileFirms / 2));
    uint32_t m = 0u;
#pragma unroll
    for (int jj = 0; jj < kTileSpecs; ++jj) {
      if (jj == j && j < B.nsb) {
        const unsigned char* vr = st + L.v_off + j * kTileVRow + v_mis[jj];
        m = halves(f < cnt && vr[f] != 0, f + 1 < cnt && vr[f + 1] != 0);
      }
    }
    masks[i] = m;
  }
}

// Four 8x8 bf16 matrices from shared memory, transposed: lanes 8 i .. 8 i + 7
// give the addresses of matrix i's eight rows of 16 bytes, and lane 4 g + t
// receives rows 2 t and 2 t + 1 of column g. From firm-major rows (a firm's
// eight columns a row) that is the fragment of mma.m16n8k16 whose k index
// is the firm: A[column][firm] and B[firm][column].
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// bf16 operands: SG specs a block (a template argument: the running sums
// are registers), kRw row weights. Four warps; a chunk is built, then (a
// second barrier) summed.
template <int SG, bool kRw>
__global__ void __launch_bounds__(128, 3)
gram_tc_tiles_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                     const __nv_bfloat16* __restrict__ rw,
                     const unsigned char* __restrict__ valid,
                     const __nv_bfloat16* __restrict__ center, float* __restrict__ out,
                     int t_len, long long n, int p, int s_specs, const int* __restrict__ pairs,
                     int npairs, int groups, int group) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RS = kTcTileStride;
  const TcTileLayout L = make_tc_tile_layout(kRw);
  const TileBlock B = tile_block(pairs, npairs, groups, group, s_specs, p);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* cen = reinterpret_cast<float*>(smem + L.cen_off);
  for (int i = tid; i < 2 * kTileCols; i += nthreads) {
    const int side = i / kTileCols, a = of_side(B.base, side) + i - side * kTileCols;
    cen[i] = a >= 1 && a <= p ? __bfloat162float(center[(size_t)B.t * p + a - 1]) : 0.f;
  }
  // tiles start at multiples of 64 firms, so each row's misalignment is the
  // same for every chunk of the month
  const long long row_t = (long long)B.t * n;
  const int y_mis = misalign(y + row_t), rw_mis = kRw ? misalign(rw + row_t) : 0;
  int v_mis[kTileSpecs];
#pragma unroll
  for (int j = 0; j < kTileSpecs; ++j)
    v_mis[j] = misalign(valid + ((long long)(B.s0 + min(j, B.nsb - 1)) * t_len + B.t) * n);

  // warp (wr, wc) sums rows 32 wr .. of side 0 against columns 32 wc .. of
  // side 1; ldmatrix row addresses: A matrix i = lane / 8 is firms 8 (i / 2)
  // .., columns 8 (i % 2) ..; B matrix i firms 8 (i % 2) .., columns
  // 8 (i / 2) ..
  const int wr = warp >> 1, wc = warp & 1, gq = lane >> 2, tq = lane & 3;
  const bf16* built = reinterpret_cast<const bf16*>(smem + L.built_off);
  const size_t nb = L.built_bytes / 2;
  const bf16* a_rows =
      built + ((lane & 7) + ((lane >> 4) << 3)) * RS + 32 * wr + (((lane >> 3) & 1) << 3);
  const bf16* alo_rows = a_rows + 2 * nb;
  const bf16* b_rows =
      built + nb + ((lane & 7) + (((lane >> 3) & 1) << 3)) * RS + 32 * wc + ((lane >> 4) << 3);
  float run[SG][2][4][4];
#pragma unroll
  for (int j = 0; j < SG; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) run[j][mi][ni][q] = 0.f;

  const uint32_t* masks = reinterpret_cast<const uint32_t*>(smem + L.mask_off) + tq;
  tile_walk(
      n,
      [&](long long k) {
        stage_tc_tiles<kRw>(L, smem + (k % 3) * L.stage, B, x, y, rw, valid, t_len, n, p,
                            k * kTileFirms, (int)min((long long)kTileFirms, n - k * kTileFirms),
                            tid, nthreads);
      },
      [&](long long k, int cnt) {
        build_tc_tiles<kRw>(L, smem, smem + (k % 3) * L.stage, B, p, cnt, y_mis, rw_mis,
                            v_mis, tid, nthreads);
        __syncthreads();  // chunk k built
        // spec by spec: per 16 firms the A fragments of the warp's two
        // 16-row strips (the spec's masks ANDed in) and the B fragments of
        // its four 8-column tiles, one MMA a tile into a sum of the chunk
        // that starts at 0 (the tensor core's own sum never spans more than
        // 64 firms), then added into the running sums in float
#pragma unroll
        for (int j = 0; j < SG; ++j) {
          float part[2][4][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.f;
#pragma unroll 1
          for (int k0 = 0; k0 < cnt; k0 += 16) {
            const uint32_t m0 = masks[j * (kTileFirms / 2) + (k0 >> 1)];
            const uint32_t m1 = masks[j * (kTileFirms / 2) + (k0 >> 1) + 4];
            uint32_t fa[2][4], fl[2][4], fb[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              ldsm_x4_t(fa[mi], a_rows + k0 * RS + 16 * mi);
              if (kRw) ldsm_x4_t(fl[mi], alo_rows + k0 * RS + 16 * mi);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t r4[4];
              ldsm_x4_t(r4, b_rows + k0 * RS + 16 * h);
              fb[2 * h][0] = r4[0];
              fb[2 * h][1] = r4[1];
              fb[2 * h + 1][0] = r4[2];
              fb[2 * h + 1][1] = r4[3];
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const uint32_t a[4] = {fa[mi][0] & m0, fa[mi][1] & m0, fa[mi][2] & m1,
                                     fa[mi][3] & m1};
              const uint32_t al[4] = {fl[mi][0] & m0, fl[mi][1] & m0, fl[mi][2] & m1,
                                      fl[mi][3] & m1};
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                mma_bf16(part[mi][ni], a, fb[ni][0], fb[ni][1]);
                if (kRw) mma_bf16(part[mi][ni], al, fb[ni][0], fb[ni][1]);
              }
            }
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int q = 0; q < 4; ++q) run[j][mi][ni][q] += part[mi][ni][q];
        }
      });

  // element q of a lane's sums is row 16 mi + g + 8 (q / 2), column
  // 8 ni + 2 t + q % 2 of the warp's outputs
  const int qe = p + 2;
#pragma unroll
  for (int j = 0; j < SG; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tile_store(out, B, j, t_len, qe, B.base[0] + 32 * wr + 16 * mi + gq + 8 * (q >> 1),
                     B.base[1] + 32 * wc + 8 * ni + 2 * tq + (q & 1), run[j][mi][ni][q]);
}

// --- float64: fragments straight from the staged rows on DMMA ---

// Byte offsets of one block's dynamic shared memory: three stages of raw
// chunks, each a slot of 68 doubles a (side, firm) (the side's x columns
// from element 0, y at element 64; 68 is 4 mod 16, so the fragment loads
// are free of bank conflicts), the row weights, one folded valid row a spec.
struct DmmaTileLayout {
  size_t rw_off, v_off, stage, total;
};
constexpr int kDmmaTileSlot = 68;  // doubles of a (side, firm) slot
constexpr int kDmmaTileY = 64;     // y's element in a slot

__host__ __device__ inline DmmaTileLayout make_dmma_tile_layout(bool has_rw) {
  DmmaTileLayout L;
  L.rw_off = (size_t)2 * kTileFirms * kDmmaTileSlot * 8;
  L.v_off = L.rw_off + (has_rw ? kTileFirms * 8 : 0);
  L.stage = L.v_off + kTileSpecs * kTileVRow;
  L.total = 3 * L.stage;
  return L;
}

// Stage firms n0 .. n0 + cnt - 1 by 8-byte copies, every value at its
// place (a float64 is 8-byte aligned at any P): thread t copies x column
// xa + t % 64 of every fourth firm of each side (a warp's lanes on
// consecutive columns), and y into element 64 of each (side, firm) slot;
// then the row weights and the valid rows.
template <bool kRw>
__device__ inline void stage_dmma_tiles(const DmmaTileLayout& L, unsigned char* st,
                                        const TileBlock& B, const double* x, const double* y,
                                        const double* rw, const unsigned char* valid, int t_len,
                                        long long n, int p, long long n0, int cnt, int tid,
                                        int nthreads) {
  const long long row0 = (long long)B.t * n + n0;
  double* slots = reinterpret_cast<double*>(st);
  const int c = tid & (kTileCols - 1), fstep = nthreads / kTileCols;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    if (c >= B.xn[side]) continue;
    const double* src = x + row0 * p + B.xa[side] + c;
    for (int f = tid / kTileCols; f < cnt; f += fstep)
      cp_async8(slots + (side * kTileFirms + f) * kDmmaTileSlot + c, src + (long long)f * p);
  }
  for (int i = tid; i < 2 * kTileFirms; i += nthreads) {
    const int f = i & (kTileFirms - 1);
    if (f < cnt) cp_async8(slots + i * kDmmaTileSlot + kDmmaTileY, y + row0 + f);
  }
  if (kRw)
    for (int f = tid; f < cnt; f += nthreads) cp_async8(st + L.rw_off + 8 * f, rw + row0 + f);
  stage_valid_rows(st, L.v_off, B, valid, t_len, n, n0, cnt, tid, nthreads);
}

// float64 operands: SG specs a block, kRw row weights. Eight warps of
// 16 x 32 outputs; a lane forms its fragments straight from the staged
// rows (x - c, 0 where not finite; the intercept 1, y as staged, 0 past
// QE) and its weights from the valid bytes; three stages, one barrier a
// chunk.
template <int SG, bool kRw>
__global__ void __launch_bounds__(256, 1)
gram_dmma_tiles_kernel(const double* __restrict__ x, const double* __restrict__ y,
                       const double* __restrict__ rw, const unsigned char* __restrict__ valid,
                       const double* __restrict__ center, double* __restrict__ out, int t_len,
                       long long n, int p, int s_specs, const int* __restrict__ pairs,
                       int npairs, int groups, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RS = kDmmaTileSlot;
  const DmmaTileLayout L = make_dmma_tile_layout(kRw);
  const TileBlock B = tile_block(pairs, npairs, groups, group, s_specs, p);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 1, wc = warp & 1, gq = lane >> 2, tq = lane & 3;
  // the lane's six columns: A rows 16 wr + g and + 8 of side 0 (u = 0, 1),
  // B columns 32 wc + 8 ni + g of side 1 (u = 2 + ni): each its element of
  // a slot and its center, or a constant (the intercept 1, 0 past QE)
  int off[6];
  double cv[6], kv[6];
  bool konst[6];
#pragma unroll
  for (int u = 0; u < 6; ++u) {
    const int side = u < 2 ? 0 : 1;
    const int a = B.base[side] + (u < 2 ? 16 * wr + gq + 8 * u : 32 * wc + 8 * (u - 2) + gq);
    const bool is_x = a >= 1 && a <= p;
    off[u] = is_x ? a - 1 - B.xa[side] : kDmmaTileY;
    cv[u] = is_x ? center[(size_t)B.t * p + a - 1] : 0.0;
    konst[u] = a == 0 || a > p + 1;
    kv[u] = a == 0 ? 1.0 : 0.0;
  }
  const long long row_t = (long long)B.t * n;
  int v_at[SG];
#pragma unroll
  for (int j = 0; j < SG; ++j)
    v_at[j] = (int)L.v_off + j * kTileVRow +
              misalign(valid + ((long long)(B.s0 + min(j, B.nsb - 1)) * t_len + B.t) * n);
  double run[SG][4][4];
#pragma unroll
  for (int j = 0; j < SG; ++j)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) run[j][ni][q] = 0.0;

  tile_walk(
      n,
      [&](long long k) {
        stage_dmma_tiles<kRw>(L, smem + (k % 3) * L.stage, B, x, y, rw, valid, t_len, n, p,
                              k * kTileFirms,
                              (int)min((long long)kTileFirms, n - k * kTileFirms), tid, nthreads);
      },
      [&](long long k, int cnt) {
        const unsigned char* st = smem + (k % 3) * L.stage;
        const double* s0 = reinterpret_cast<const double*>(st);
        const double* s1 = s0 + kTileFirms * RS;
        const double* rwr = reinterpret_cast<const double*>(st + L.rw_off);
        auto value = [&](const double* slots, int f, int u) {
          const double v = slots[f * RS + off[u]];
          return konst[u] ? kv[u] : (isfinite(v) ? v - cv[u] : 0.0);
        };
        auto weight = [&](int j, int f) {
          const bool ok = f < cnt && j < B.nsb && st[v_at[j] + f] != 0;
          return ok ? (kRw ? rwr[f] : 1.0) : 0.0;
        };
        // per 8 firms: the A fragment (w o a, the weight applied as each
        // spec forms it) against the B fragments of four 8-column tiles,
        // straight into the running sums (DMMA is IEEE double)
#pragma unroll 1
        for (int k0 = 0; k0 < cnt; k0 += 8) {
          const int fa = k0 + tq, fb = fa + 4;
          const double a0 = value(s0, fa, 0), a1 = value(s0, fa, 1);
          const double a2 = value(s0, fb, 0), a3 = value(s0, fb, 1);
          double bf[4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            bf[ni][0] = value(s1, fa, 2 + ni);
            bf[ni][1] = value(s1, fb, 2 + ni);
          }
#pragma unroll
          for (int j = 0; j < SG; ++j) {
            const double w0 = weight(j, fa), w1 = weight(j, fb);
            const double a[4] = {w0 * a0, w0 * a1, w1 * a2, w1 * a3};
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_f64(run[j][ni], a, bf[ni][0], bf[ni][1]);
          }
        }
      });

  // element q of a lane's sums is row g + 8 (q / 2), column 8 ni + 2 t +
  // q % 2 of the warp's outputs
  const int qe = p + 2;
#pragma unroll
  for (int j = 0; j < SG; ++j)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tile_store(out, B, j, t_len, qe, B.base[0] + 16 * wr + gq + 8 * (q >> 1),
                   B.base[1] + 32 * wc + 8 * ni + 2 * tq + (q & 1), run[j][ni][q]);
}

// --- float32: built rows on the CUDA cores, warp-specialized ---

// Byte offsets of one block's dynamic shared memory: two stages of raw
// chunks, each a slot of 68 floats a (side, firm) (the side's x columns from
// element 0, y at element 64; 272 bytes, a multiple of 16), the row weights,
// one folded valid row a spec; both tiles' centers; then two built buffers,
// each the built rows of side 0 and of side 1 (times the row weights),
// firm-major, 64 floats a firm and a 65th row of zeros, each spec's list of
// the chunk's firms it takes (padded to a multiple of 4 by the zero row)
// and the lists' lengths. 136 KB with row weights: one block an SM.
struct F32TileLayout {
  size_t rw_off, v_off, stage, cen_off, built_off, b_off, list_off, count_off, built_bytes,
      total;
};
constexpr int kF32TileSlot = 68;        // floats of a (side, firm) slot
constexpr int kF32TileY = 64;           // y's element in a slot
constexpr int kF32TileList = 68;        // ints of a spec's list: 64 firms, padded to 4
constexpr int kF32TileConsumers = 256;  // 8 row groups x 4 column groups of 4, 8 warps
constexpr int kF32TileProducers = 128;
constexpr int kF32TileThreads = kF32TileConsumers + kF32TileProducers;

__host__ __device__ inline F32TileLayout make_f32_tile_layout(bool has_rw) {
  F32TileLayout L;
  L.rw_off = (size_t)2 * kTileFirms * kF32TileSlot * 4;
  L.v_off = L.rw_off + (has_rw ? kTileFirms * 4 : 0);
  L.stage = L.v_off + kTileSpecs * kTileVRow;
  L.cen_off = 2 * L.stage;
  L.built_off = L.cen_off + 2 * kTileCols * sizeof(float);
  L.b_off = (size_t)(kTileFirms + 1) * kTileCols * sizeof(float);  // side 1's rows
  L.list_off = 2 * L.b_off;
  L.count_off = L.list_off + (size_t)kTileSpecs * kF32TileList * sizeof(int);
  L.built_bytes = L.count_off + 4 * sizeof(int);
  L.total = L.built_off + 2 * L.built_bytes;
  return L;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

// Stage firms n0 .. n0 + cnt - 1 by 4-byte copies, every value at its place
// (a float32 is 4-byte aligned at any P): thread t copies x column
// xa + t % 64 of every (nthreads / 64)-th firm of each side (a warp's lanes
// on consecutive columns), and y into element 64 of each (side, firm) slot;
// then the row weights and the valid rows.
template <bool kRw>
__device__ inline void stage_f32_tiles(const F32TileLayout& L, unsigned char* st,
                                       const TileBlock& B, const float* x, const float* y,
                                       const float* rw, const unsigned char* valid, int t_len,
                                       long long n, int p, long long n0, int cnt, int tid,
                                       int nthreads) {
  const long long row0 = (long long)B.t * n + n0;
  float* slots = reinterpret_cast<float*>(st);
  const int c = tid & (kTileCols - 1), fstep = nthreads / kTileCols;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    if (c >= B.xn[side]) continue;
    const float* src = x + row0 * p + B.xa[side] + c;
    for (int f = tid / kTileCols; f < cnt; f += fstep)
      cp_async4(slots + (side * kTileFirms + f) * kF32TileSlot + c, src + (long long)f * p);
  }
  for (int i = tid; i < 2 * kTileFirms; i += nthreads) {
    const int f = i & (kTileFirms - 1);
    if (f < cnt) cp_async4(slots + i * kF32TileSlot + kF32TileY, y + row0 + f);
  }
  if (kRw)
    for (int f = tid; f < cnt; f += nthreads) cp_async4(st + L.rw_off + 4 * f, rw + row0 + f);
  stage_valid_rows(st, L.v_off, B, valid, t_len, n, n0, cnt, tid, nthreads);
}

// The float32 build of a staged chunk by the NT producer threads: a thread
// a (side, firm, 4-column group) forms the group's values once (x - c, 0
// where not finite; the intercept 1; y, 0 where not finite; 0 past QE and
// for firms cnt ..) and writes them as one 16-byte row segment, side 0's as
// they are and side 1's times the firm's row weight (w * a rounded in
// float32, as the plain version's weighted row). A thread's column group is
// the same for all its items (tid % 16), and past tile 0 a group of x
// columns is one aligned 16-byte load of the slot. Then producer warp j
// lists the firms spec j of the block takes (its folded valid byte set, and
// with row weights a nonzero weight), in firm order, by two ballots, as
// the byte offsets of their built rows, and pads the list to a multiple of
// 4 with the zero row (firm 64).
template <int SG, bool kRw, int NT>
__device__ inline void build_f32_tiles(const F32TileLayout& L, unsigned char* built,
                                       const float* cen, const unsigned char* st,
                                       const TileBlock& B, int p, int cnt,
                                       const int (&v_at)[SG], int tid) {
  const int q = tid & 15;
  const float* slots = reinterpret_cast<const float*>(st);
  const float* rwr = reinterpret_cast<const float*>(st + L.rw_off);
  float* a_rows = reinterpret_cast<float*>(built);
  float* b_rows = reinterpret_cast<float*>(built + L.b_off);
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int a0 = of_side(B.base, side) + 4 * q;  // the group's first augmented column
    const int at = a0 - 1 - of_side(B.xa, side);   // its x column's element in a slot
    const bool whole = a0 >= 1 && a0 + 3 <= p && (at & 3) == 0;
    const float4 c4 = *reinterpret_cast<const float4*>(cen + side * kTileCols + 4 * q);
    const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int m = 0; m < kTileFirms * 16 / NT; ++m) {
      const int f = (tid >> 4) + (NT / 16) * m;
      const float* slot = slots + (side * kTileFirms + f) * kF32TileSlot;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (f < cnt && whole) {
        const float4 x4 = *reinterpret_cast<const float4*>(slot + at);
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = isfinite(xs[e]) ? xs[e] - cc[e] : 0.f;
      } else if (f < cnt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = a0 + e;
          if (a == 0) {
            v[e] = 1.f;
          } else if (a <= p) {
            const float xv = slot[at + e];
            v[e] = isfinite(xv) ? xv - cc[e] : 0.f;
          } else if (a == p + 1) {
            const float yv = slot[kF32TileY];
            v[e] = isfinite(yv) ? yv : 0.f;
          }
        }
      }
      const size_t row = (size_t)f * kTileCols + 4 * q;
      if (side == 0) {
        *reinterpret_cast<float4*>(a_rows + row) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        const float w = kRw ? (f < cnt ? rwr[f] : 0.f) : 1.f;
        *reinterpret_cast<float4*>(b_rows + row) =
            make_float4(w * v[0], w * v[1], w * v[2], w * v[3]);
      }
    }
  }
  const int j = tid >> 5, lane = tid & 31;
  if (j < SG) {
    int* list = reinterpret_cast<int*>(built + L.list_off) + j * kF32TileList;
    int vj = v_at[0];  // v_at[j] by selects: a register array indexed at run time spills
#pragma unroll
    for (int jj = 1; jj < SG; ++jj) vj = jj == j ? v_at[jj] : vj;
    auto takes = [&](int f) {
      return f < cnt && j < B.nsb && st[vj + f] != 0 && (!kRw || rwr[f] != 0.f);
    };
    const bool lo = takes(lane), hi = takes(lane + 32);
    const unsigned b_lo = __ballot_sync(0xffffffffu, lo), b_hi = __ballot_sync(0xffffffffu, hi);
    const unsigned below = (1u << lane) - 1u;
    const int n_lo = __popc(b_lo), total = n_lo + __popc(b_hi);
    constexpr int kRow = kTileCols * sizeof(float);
    if (lo) list[__popc(b_lo & below)] = lane * kRow;
    if (hi) list[n_lo + __popc(b_hi & below)] = (lane + 32) * kRow;
    if (lane < 3 && total + lane < ((total + 3) & ~3)) list[total + lane] = kTileFirms * kRow;
    if (lane == 0) reinterpret_cast<int*>(built + L.count_off)[j] = total;
  }
}

// float32 operands: SG specs a block, kRw row weights. Warp-specialized:
// four producer warps stage chunk k + 2 into a ring of two raw stages and
// build chunk k into one of two built buffers (named barriers: kBarFull + b
// buffer b built, kBarEmpty + b buffer b summed, kBarProd the producers'
// own), while eight consumer warps sum the other buffer. Consumer warp w
// sums rows 32 (w % 2) .. + 31 of side 0 against columns 16 (w / 2) .. + 15
// of side 1, a lane a 4 x 4 tile of them (rows 32 (w % 2) + 4 (lane % 8) ..,
// columns 16 (w / 2) + 4 (lane / 8) ..). Spec by spec, it walks the spec's
// list of the chunk's firms four at a time: one 16-byte load of the four
// rows' offsets (broadcast), and per firm one 16-byte load of each side (a warp
// reads 8 distinct side-0 and 4 distinct side-1 addresses: one wavefront
// each) and 16 FMAs. A (spec, firm) of weight 0 is not in the list: the
// products follow the rows the data weights, with no branch in the loop.
// Each chunk's sums of a spec start at 0 and are added into its running
// sums (a two-level sum: the chunk's own sum spans 64 firms). A consumer
// warp whose rows or columns all lie past QE (the last tile's padding)
// sums nothing.
template <int SG, bool kRw>
__global__ void __launch_bounds__(kF32TileThreads, 1)
gram_f32_tiles_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ rw, const unsigned char* __restrict__ valid,
                      const float* __restrict__ center, float* __restrict__ out, int t_len,
                      long long n, int p, int s_specs, const int* __restrict__ pairs,
                      int npairs, int groups, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NP = kF32TileProducers;
  const F32TileLayout L = make_f32_tile_layout(kRw);
  const TileBlock B = tile_block(pairs, npairs, groups, group, s_specs, p);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  float* cen = reinterpret_cast<float*>(smem + L.cen_off);
  for (int i = tid; i < 2 * kTileCols; i += nthreads) {
    const int side = i / kTileCols, a = of_side(B.base, side) + i - side * kTileCols;
    cen[i] = a >= 1 && a <= p ? center[(size_t)B.t * p + a - 1] : 0.f;
  }
  // the zero row (firm 64) of each side of both buffers, which pads the lists
  for (int i = tid; i < 4 * kTileCols; i += nthreads) {
    const int u = i / kTileCols;  // buffer u / 2, side u % 2
    reinterpret_cast<float*>(smem + L.built_off + (u >> 1) * L.built_bytes +
                             (u & 1) * L.b_off)[kTileFirms * kTileCols + i % kTileCols] = 0.f;
  }
  __syncthreads();  // the centers and the zero rows, before any build
  const long long n_chunks = (n + kTileFirms - 1) / kTileFirms;
  auto count = [&](long long k) { return (int)min((long long)kTileFirms, n - k * kTileFirms); };

  if (tid >= kF32TileConsumers) {
    // producers
    const int ptid = tid - kF32TileConsumers;
    int v_at[SG];
#pragma unroll
    for (int j = 0; j < SG; ++j)
      v_at[j] = (int)L.v_off + j * kTileVRow +
                misalign(valid + ((long long)(B.s0 + min(j, B.nsb - 1)) * t_len + B.t) * n);
    for (long long k = 0; k < 2 && k < n_chunks; ++k) {
      stage_f32_tiles<kRw>(L, smem + k * L.stage, B, x, y, rw, valid, t_len, n, p,
                           k * kTileFirms, count(k), ptid, NP);
      cp_async_commit();
    }
    if (n_chunks < 2) cp_async_commit();
    for (long long k = 0; k < n_chunks; ++k) {
      const int b = (int)(k & 1);
      unsigned char* st = smem + b * L.stage;
      cp_async_wait_1();
      bar_sync(kBarProd, NP);  // chunk k staged, every producer's copies
      if (k >= 2) bar_sync(kBarEmpty + b, nthreads);  // the consumers are done with buffer b
      build_f32_tiles<SG, kRw, NP>(L, smem + L.built_off + b * L.built_bytes, cen, st, B, p,
                                   count(k), v_at, ptid);
      bar_sync(kBarProd, NP);  // stage b read, buffer b written
      bar_arrive(kBarFull + b, nthreads);  // buffer b is built
      if (k + 2 < n_chunks)
        stage_f32_tiles<kRw>(L, st, B, x, y, rw, valid, t_len, n, p, (k + 2) * kTileFirms,
                             count(k + 2), ptid, NP);
      cp_async_commit();
    }
    return;
  }

  // consumers
  const int lane = tid & 31, warp = tid >> 5;
  const int qe = p + 2;
  const int r4 = 32 * (warp & 1) + 4 * (lane & 7), c4 = 16 * (warp >> 1) + 4 * (lane >> 3);
  const bool live =
      B.base[0] + 32 * (warp & 1) < qe && B.base[1] + 16 * (warp >> 1) < qe;
  float run[SG][4][4];
#pragma unroll
  for (int j = 0; j < SG; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) run[j][i][k] = 0.f;
  for (long long k = 0; k < n_chunks; ++k) {
    const int b = (int)(k & 1);
    bar_sync(kBarFull + b, nthreads);
    if (live) {
      const unsigned char* built = smem + L.built_off + b * L.built_bytes;
      const unsigned char* a_rows = built + 4 * r4;
      const unsigned char* b_rows = built + L.b_off + 4 * c4;
      const int* counts = reinterpret_cast<const int*>(built + L.count_off);
#pragma unroll
      for (int j = 0; j < SG; ++j) {
        const int4* list =
            reinterpret_cast<const int4*>(built + L.list_off) + j * (kF32TileList / 4);
        const int quads = (counts[j] + 3) >> 2;
        float part[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) part[i][kk] = 0.f;
        // the next quad's offsets are read a quad ahead (a list has 17
        // quads' room: the read past the last quad is never used)
        int4 next = list[0];
#pragma unroll 2
        for (int g = 0; g < quads; ++g) {
          const int4 ix = next;
          next = list[g + 1];
          const int fs[4] = {ix.x, ix.y, ix.z, ix.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 a4 = *reinterpret_cast<const float4*>(a_rows + fs[u]);
            const float4 b4 = *reinterpret_cast<const float4*>(b_rows + fs[u]);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) part[i][kk] = fmaf(a[i], bv[kk], part[i][kk]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) run[j][i][kk] += part[i][kk];
      }
    }
    if (k + 2 < n_chunks) bar_arrive(kBarEmpty + b, nthreads);  // buffer b is summed
  }

#pragma unroll
  for (int j = 0; j < SG; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        tile_store(out, B, j, t_len, qe, B.base[0] + r4 + i, B.base[1] + c4 + k, run[j][i][k]);
}

template <typename T, typename Acc, typename Kernel>
int launch_tiles_with(Kernel kernel, size_t smem, int threads, const void* x, const void* y,
                      const void* rw, const unsigned char* valid, const void* center, void* out,
                      int t_len, long long n, int p, int s_specs, const int* pairs, int npairs,
                      int groups, int group, cudaStream_t stream) {
  const long long blocks = (long long)t_len * npairs * groups;
  if (blocks > 0x7fffffffLL || smem > kSmemMax) return -1;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(rw), valid,
      static_cast<const T*>(center), static_cast<Acc*>(out), t_len, n, p, s_specs, pairs,
      npairs, groups, group);
  return (int)cudaGetLastError();
}

// The instance of SG >= group specs a block (a short group leaves slots
// empty). float64 has no one-spec instance: one built as the two- and
// three-spec ones never finished on an H100 at any N (not understood), so a
// one-spec group runs on the two-spec instance. float32's one-spec instance
// finishes (a card test runs it in a child process under a time limit): it
// shares tile_block, stage_valid_rows and tile_store with the float64
// instance but not tile_walk, the fragments formed from the staged rows or
// the DMMAs, so the float64 hang lies in what the two do not share.
template <typename T, bool kRw>
int launch_tiles(int group, const void* x, const void* y, const void* rw,
                 const unsigned char* valid, const void* center, void* out, int t_len,
                 long long n, int p, int s_specs, const int* pairs, int npairs, int groups,
                 cudaStream_t stream) {
  auto go = [&](auto kernel, size_t smem, int threads) {
    using Acc = typename std::conditional<sizeof(T) == 2, float, T>::type;
    return launch_tiles_with<T, Acc>(kernel, smem, threads, x, y, rw, valid, center, out,
                                     t_len, n, p, s_specs, pairs, npairs, groups, group, stream);
  };
  if constexpr (sizeof(T) == 2) {
    const size_t smem = make_tc_tile_layout(kRw).total;
    if (group == 1) return go(gram_tc_tiles_kernel<1, kRw>, smem, 128);
    if (group == 2) return go(gram_tc_tiles_kernel<2, kRw>, smem, 128);
    return go(gram_tc_tiles_kernel<3, kRw>, smem, 128);
  } else if constexpr (sizeof(T) == 4) {
    const size_t smem = make_f32_tile_layout(kRw).total;
    if (group == 1) return go(gram_f32_tiles_kernel<1, kRw>, smem, kF32TileThreads);
    if (group == 2) return go(gram_f32_tiles_kernel<2, kRw>, smem, kF32TileThreads);
    return go(gram_f32_tiles_kernel<3, kRw>, smem, kF32TileThreads);
  } else {
    const size_t smem = make_dmma_tile_layout(kRw).total;
    if (group <= 2) return go(gram_dmma_tiles_kernel<2, kRw>, smem, 256);
    return go(gram_dmma_tiles_kernel<3, kRw>, smem, 256);
  }
}

// --- the tile-pair kernel's validity pre-pass --------------------------------

// Replaces the validity part of the Pallas kernel's body (_gram_kernel:
// `bad`, the selected columns' non-finite count, and `w`), which a block of
// the tile-pair kernel cannot form: each sees only its pair's columns. One warp a
// firm-month reads the firm's row once, 32 columns a step (coalesced), and
// one ballot a step gives the step's non-finite bits; lane l then ORs them
// into spec l's hits under its selection word (specs past 32 take another
// pass over the row). out[s, t, n] = valid[s, t, n] and finite(y[t, n]) and
// no selected column of x[t, n, :] non-finite. It reads x once and writes
// one byte a (spec, firm-month): the bytes bound it.
__device__ __forceinline__ bool finite_of(float v) { return isfinite(v); }
__device__ __forceinline__ bool finite_of(double v) { return isfinite(v); }
__device__ __forceinline__ bool finite_of(__nv_bfloat16 v) {
  return isfinite(__bfloat162float(v));
}

constexpr int kFoldThreads = 256;

template <typename In>
__global__ void __launch_bounds__(kFoldThreads)
gram_fold_kernel(const In* __restrict__ x, const In* __restrict__ y,
                 const unsigned char* __restrict__ valid,
                 const unsigned int* __restrict__ sel_bits, unsigned char* __restrict__ out,
                 long long rows, int p, int nw, int s_specs) {
  const long long row = (long long)blockIdx.x * (kFoldThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: one row a warp
  const int lane = threadIdx.x & 31;
  const In* xr = x + row * p;
  const bool y_ok = finite_of(y[row]);
  for (int s0 = 0; s0 < s_specs; s0 += 32) {
    const int s = s0 + lane;
    const unsigned* sel = sel_bits + (size_t)(s < s_specs ? s : 0) * nw;
    unsigned hit = 0u;
    for (int wd = 0; wd < nw; ++wd) {
      const int c = 32 * wd + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, c < p && !finite_of(xr[c]));
      hit |= bits & __ldg(sel + wd);
    }
    if (s < s_specs) {
      const size_t at = (size_t)s * rows + row;
      out[at] = (valid[at] != 0 && y_ok && hit == 0u) ? 1 : 0;
    }
  }
}

template <typename In>
int launch_fold(const void* x, const void* y, const unsigned char* valid,
                const unsigned int* sel_bits, unsigned char* out, long long rows, int p,
                int nw, int s_specs, cudaStream_t stream) {
  const long long blocks = (rows + kFoldThreads / 32 - 1) / (kFoldThreads / 32);
  if (blocks > 0x7fffffffLL) return -1;
  gram_fold_kernel<In><<<(unsigned)blocks, kFoldThreads, 0, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(y), valid, sel_bits, out, rows, p, nw,
      s_specs);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile-pair kernel's validity pre-pass: out (S, T, N) uint8 = valid (S, T,
// N) uint8 and finite(y) and no column the spec selects (sel_bits, as for
// gram_contract) non-finite in x (T, N, P); x and y in the operand type of
// dtype_code (0 float, 1 double, 2 bf16). Returns 0, a cudaError_t, or -1
// for arguments the kernel does not take.
extern "C" int gram_fold(int dtype_code, const void* x, const void* y, const void* valid,
                         const void* sel_bits, void* out, int t_len, long long n, int p,
                         int s_specs, void* stream) {
  if (t_len <= 0 || n <= 0 || p < 0 || s_specs <= 0) return -1;
  const int nw = p > 32 ? (p + 31) / 32 : 1;
  const long long rows = (long long)t_len * n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const unsigned int* b = static_cast<const unsigned int*>(sel_bits);
  unsigned char* o = static_cast<unsigned char*>(out);
  if (dtype_code == 0) return launch_fold<float>(x, y, v, b, o, rows, p, nw, s_specs, st);
  if (dtype_code == 1) return launch_fold<double>(x, y, v, b, o, rows, p, nw, s_specs, st);
  if (dtype_code == 2)
    return launch_fold<__nv_bfloat16>(x, y, v, b, o, rows, p, nw, s_specs, st);
  return -1;
}

// dtype_code: 0 float, 1 double, 2 bf16 operands with float sums. x (T, N,
// P), y (T, N), center (T, P) and rw (T, N; null for no row weights) in the
// operand type, out (S, T, P+2, P+2) in float for codes 0 and 2, double for
// 1; valid (S, T, N) uint8; sel_bits (S, max(1, ceil(P / 32))) uint32, bit
// c % 32 of word c / 32 set when spec s selects column c. Codes 0 and 2 up
// to P = 32: S * (P+2)(P+3)/2 <= 8192 (the wrapper cuts a larger batch);
// code 1 at any P, and codes 0 and 2 past P = 32: S <= 65,536, the whole
// batch in one launch. Returns 0 on success, the cudaError_t of the launch
// otherwise, or -1 for arguments the kernel does not take (also a P whose
// smallest firm tile exceeds shared memory: past 424 columns in float64,
// 848 in float, 1,367 in bf16 at S = 9; the wrapper sends a wider union to
// gram_tiles first).
extern "C" int gram_contract(int dtype_code, const void* x, const void* y,
                             const void* rw, const void* valid,
                             const void* sel_bits, const void* center,
                             void* out, int t_len, long long n, int p,
                             int s_specs, void* stream) {
  if (t_len <= 0 || n <= 0 || p < 0 || s_specs <= 0) return -1;
  const int nw = p > 32 ? (p + 31) / 32 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const unsigned int* b = static_cast<const unsigned int*>(sel_bits);
  if ((dtype_code == 1 || p > kMaxP) && s_specs > kOneLaunchSpecs) return -1;
  if (dtype_code == 0)
    return rw != nullptr
               ? launch_f32<true>(x, y, rw, v, b, center, out, t_len, n, p, nw, s_specs, s)
               : launch_f32<false>(x, y, rw, v, b, center, out, t_len, n, p, nw, s_specs, s);
  if (dtype_code == 1)
    return rw != nullptr
               ? launch_f64<true>(x, y, rw, v, b, center, out, t_len, n, p, nw, s_specs, s)
               : launch_f64<false>(x, y, rw, v, b, center, out, t_len, n, p, nw, s_specs, s);
  if (dtype_code == 2)
    return rw != nullptr
               ? launch_bf16<true>(x, y, rw, v, b, center, out, t_len, n, p, nw, s_specs, s)
               : launch_bf16<false>(x, y, rw, v, b, center, out, t_len, n, p, nw, s_specs, s);
  return -1;
}

// The tile-pair kernel (every operand type past its crossover width,
// specgrid/grams.py::gram_tile_plan): x (T, N, P), y (T, N), center (T, P)
// and rw (T, N; null for no row weights) in the operand type of dtype_code
// (0 float, 1 double, 2 bf16); valid (S, T, N) uint8, the folded mask of
// gram_fold; out (S, T, P+2, P+2), double for code 1 and float for codes 0
// and 2, zeroed;
// pairs the plan's npairs tile pairs (I, J), I <= J, of cols = 64 augmented
// columns each, int32 on the device; group the specs a block sums (1 to 3).
// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take
// (another tile width, a pair count that is not every pair's, a group out
// of range); a pair outside the block's tiles traps.
extern "C" int gram_tiles(int dtype_code, const void* x, const void* y, const void* rw,
                          const void* valid, const void* center, void* out, int t_len,
                          long long n, int p, int s_specs, const void* pairs, int npairs,
                          int cols, int group, void* stream) {
  if (t_len <= 0 || n <= 0 || p < 0 || s_specs <= 0) return -1;
  if (cols != kTileCols || group < 1 || group > kTileSpecs) return -1;
  const int nt = (p + 2 + kTileCols - 1) / kTileCols;
  if (npairs != nt * (nt + 1) / 2) return -1;
  const int groups = (s_specs + group - 1) / group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const int* pr = static_cast<const int*>(pairs);
  if (dtype_code == 0)
    return rw != nullptr
               ? launch_tiles<float, true>(group, x, y, rw, v, center, out, t_len, n, p, s_specs,
                                           pr, npairs, groups, s)
               : launch_tiles<float, false>(group, x, y, rw, v, center, out, t_len, n, p,
                                            s_specs, pr, npairs, groups, s);
  if (dtype_code == 1)
    return rw != nullptr
               ? launch_tiles<double, true>(group, x, y, rw, v, center, out, t_len, n, p,
                                            s_specs, pr, npairs, groups, s)
               : launch_tiles<double, false>(group, x, y, rw, v, center, out, t_len, n, p,
                                             s_specs, pr, npairs, groups, s);
  if (dtype_code == 2)
    return rw != nullptr
               ? launch_tiles<__nv_bfloat16, true>(group, x, y, rw, v, center, out, t_len, n, p,
                                                   s_specs, pr, npairs, groups, s)
               : launch_tiles<__nv_bfloat16, false>(group, x, y, rw, v, center, out, t_len, n,
                                                    p, s_specs, pr, npairs, groups, s);
  return -1;
}

extern "C" const char* gram_error_string(int code) {
  if (code == -1) return "invalid arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
