// Eigenvalue clip of a batch of 65- to 256-dimensional states for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's state_core.make_feasible_bloch
// calls jnp.linalg.eigh, which XLA batches on the TPU. On the card,
// torch.linalg.eigh loops cuSOLVER's one-matrix syevd over a batch of
// matrices larger than 32 x 32: ~2.1 ms a 256 x 256 matrix at any batch,
// and an error check that reads the card back. This kernel computes the
// whole clip for every matrix of a complex64 batch in one launch:
//
//   A = V diag(lambda) V^H                       (eigendecomposition)
//   w = max(lambda, 1e-15), w = w / sum(w)       (floor, unit trace)
//   out = V diag(w) V^H
//
// Algorithm. psd_project.cu's two-sided cyclic Jacobi in float32, with its
// numerics: the unitary rotations of Golub and Van Loan's sym.schur2 on
// |a_pq| with the phase e = a_pq / |a_pq|, applied in Rutishauser's form
// (r = s / (1 + c)); the pivot entries set to their exact values; the
// parallel round-robin ordering (kernels._jacobi_rounds: pair 0 of round r
// is (r, m - 1), pair k is (r + k, r - k) mod m - 1). At d = 256 the
// sweeps' ~2,000 rotations of every entry leave V orthonormal and A
// diagonal to some 30 eps, where cuSOLVER holds a few; a first-order
// refinement against the input (the note at the refinement below gives it)
// brings the clip back to cuSOLVER's accuracy or better. A matrix stops at
// the first sweep that begins with its off-diagonal Frobenius norm at most
// eps_f32 ||A||_F (stopping a sweep earlier, at sqrt(eps_f32) ||A||_F,
// leaves a residue whose second-order error shows for eigenvalues within
// it of 0, where the clip bends: PERF.md), and kMaxSweeps caps the sweeps
// (no input of the tests or of the benchmark's cells reaches it). The input's lower
// triangle is read and mirrored, the diagonal's imaginary part dropped, as
// torch.linalg.eigh (UPLO='L') reads it. An odd d is padded with a zero row
// and column, whose pairs never rotate and whose eigenvalue is left out.
//
// Design. A 256 x 256 complex64 matrix is 512 KB and its eigenvectors
// another 512 KB, more than one block's 227 KB of shared memory, so one
// matrix is spread over a thread-block cluster of c = kCluster blocks and
// stays in the cluster's shared memory through the sweeps. Each block
// holds whole columns of A and of V: those of its
// share of the round's pairs, slots k0 .. k0 + np - 1, at the slots' top
// and bottom positions. Applying a round (A <- J^H A J, V <- V J) to a
// column needs only that column, its pair's rotation and the rows'
// rotations: with every rotation of the round in every block, a block
// applies the round to its own columns, for each of its column pairs b and
// each row pair a the 2 x 2 block J_a^H X J_b (the pivot block set
// exactly), and V's two columns. Between rounds the round-robin moves each
// column one position along the cycle top[1] -> bottom[0] -> ... ->
// bottom[h - 1] -> top[h - 1] -> ... -> top[1] (top[0] holds column m - 1
// throughout), so a block sends at most two columns a round to its
// neighbours (bottom[k0 + np - 1] to the right, top[k0] to the left). A
// column keeps its buffer while it stays in a block: a block's positions
// form one or two rings in cycle order, each with one buffer more than
// positions; the column at ring position j in round r lives in buffer
// base + (j - r) mod (len + 1), and the spare buffer of round r is where
// the ring's entering column of round r + 1 lands, written there by the
// neighbour as it applies round r. After applying a round a block computes
// the next round's rotations of its pairs that keep their columns, and of
// the neighbours' pairs that its leaving columns enter (from the leaving
// column and A's diagonal, which every block keeps), and writes them into
// every block (two tables, by the round's parity): a round has one cluster
// barrier, and no block waits for a column to arrive before it rotates.
// The refinement then works on V and A in global memory (`out` and `work`)
// and each block builds U's columns of its positions; it computes its rows
// of out = U U^H from every block's U, staged through its shared memory.
//
// What bounds it. The least work of the clip, whatever algorithm computes
// it, is ~17.3 d^3 real flops a matrix (Householder tridiagonalisation
// 16/3 d^3, the eigenvectors' back-transformation 8 d^3, the recomposition
// 4 d^3): 291 MFLOP at d = 256, 5.5 GFLOP for a chunk of 19, 0.08 ms at the
// card's 67 TFLOP/s FP32 peak; the 10 MB in and out take 3 us. Jacobi does
// more: each sweep applies d - 1 rounds of rotations to every entry of A
// (twice: rows and columns) and of V, ~30 d^3 flops a sweep, 8-9 sweeps at
// d = 256. A block's round is bound by its shared memory's bandwidth (each
// entry of its columns of A and V read and written once a round) and by
// the latency of the round's rotations and cluster barrier; with c = 5, 19
// matrices take 95 of the card's 132 SMs in one wave (6 would need 114 in
// clusters that a GPC holds fewer of). PERF.md gives the times.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kMinDim = 65;   // kernels.PSD_MAX_DIM + 1: up to 64, psd_project's one block holds a matrix
constexpr int kMaxDim = 256;  // kernels.CLIP_MAX_DIM
constexpr int kMaxPairs = kMaxDim / 2;
constexpr int kCluster = 5;  // blocks per matrix, each on an SM of its own (6 to 8 ran slower)
constexpr int kMaxLocal = (kMaxPairs + kCluster - 1) / kCluster;  // pairs of one block
constexpr int kMaxSweeps = 40;   // kernels.PSD_MAX_SWEEPS
constexpr float kFloor = 1e-15f;  // kernels.CLIP_FLOOR: make_feasible_bloch's
constexpr int kThreads = 512;
// after the sweeps a thread takes positions or rows ti + 8 u (u < 8) and rows or columns tj + 64 v (v < 4)
constexpr int kRowThreads = 8, kRowTile = 8, kColTile = 4;

struct Pair {       // a local pair's two columns, p < q, this round
  int src_p, src_q;  // offsets of their buffers in this block's shared memory
  float2* out_p;     // where a column that leaves goes (a neighbour's spare
  float2* out_q;     // buffer); null: its rotated entries stay in its buffer
};

__device__ __forceinline__ float2 conj2(float2 a) { return make_float2(a.x, -a.y); }

// Rows p and q of J^H X, in Rutishauser's form (r = s / (1 + c), c = 1 - s r),
// g = (s, r, e): (x, y) <- (x - s (r x + e y), y + s (conj(e) x - r y)).
__device__ __forceinline__ void rotate_rows(float4 g, float2& x, float2& y) {
  const float s = g.x, r = g.y;
  const float2 ey = make_float2(g.z * y.x - g.w * y.y, g.z * y.y + g.w * y.x);
  const float2 ex = make_float2(g.z * x.x + g.w * x.y, g.z * x.y - g.w * x.x);
  const float2 nx = make_float2(x.x - s * (r * x.x + ey.x), x.y - s * (r * x.y + ey.y));
  const float2 ny = make_float2(y.x + s * (ex.x - r * y.x), y.y + s * (ex.y - r * y.y));
  x = nx;
  y = ny;
}

// Columns p and q of X J: (x, y) <- (x - s (r x + conj(e) y), y + s (e x - r y)).
__device__ __forceinline__ void rotate_cols(float4 g, float2& x, float2& y) {
  const float s = g.x, r = g.y;
  const float2 ey = make_float2(g.z * y.x + g.w * y.y, g.z * y.y - g.w * y.x);
  const float2 ex = make_float2(g.z * x.x - g.w * x.y, g.z * x.y + g.w * x.x);
  const float2 nx = make_float2(x.x - s * (r * x.x + ey.x), x.y - s * (r * x.y + ey.y));
  const float2 ny = make_float2(y.x + s * (ex.x - r * y.x), y.y + s * (ex.y - r * y.y));
  x = nx;
  y = ny;
}

// The 2 x 2 block x = (x00, x10, x01, x11) of A in the rows of slot a's
// pair and the columns of slot b's, to J_a^H X J_b; the pivot block (a ==
// b) is set exactly, diag(a_pp - t |a_pq|, a_qq + t |a_pq|) with tx =
// t |a_pq|. Without a branch: a warp's lanes take different a.
__device__ __forceinline__ void rotate_block(bool pivot, float4 ga, float4 gb, float tx,
                                             float2 (&x)[4]) {
  const float app = x[0].x, aqq = x[3].x;
  rotate_rows(ga, x[0], x[1]);
  rotate_rows(ga, x[2], x[3]);
  rotate_cols(gb, x[0], x[2]);
  rotate_cols(gb, x[1], x[3]);
  x[0] = pivot ? make_float2(app - tx, 0.f) : x[0];
  x[1] = pivot ? make_float2(0.f, 0.f) : x[1];
  x[2] = pivot ? make_float2(0.f, 0.f) : x[2];
  x[3] = pivot ? make_float2(aqq + tx, 0.f) : x[3];
}

// The block's sum of v, returned to every thread.
__device__ float block_sum(float v, float* partial, float* total) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += partial[w];
    *total = s;
  }
  __syncthreads();
  return *total;
}

// The pairs of cluster block `rank` (of c) among h, and the first of them.
__host__ __device__ __forceinline__ int pairs_of(int rank, int c, int h) {
  return h / c + (rank < h % c ? 1 : 0);
}
__device__ __forceinline__ int first_pair(int rank, int c, int h) {
  return rank * (h / c) + min(rank, h % c);
}

// A block's rings: (base buffer, positions) of ring 0 and ring 1 (len 0:
// none). Block 0 holds top[0] in buffer 0 and one ring, top[np - 1] ..
// top[1], bottom[0] .. bottom[np - 1]; the last block one ring, bottom[0] ..
// bottom[np - 1], top[np - 1] .. top[0]; a middle block two, bottom[0] ..
// bottom[np - 1] and top[np - 1] .. top[0]. Each lists its positions in
// the order its columns move, entry first.
struct Rings {
  int base[2], len[2];
};

__device__ __forceinline__ Rings rings_of(int rank, int c, int np) {
  Rings g;
  g.base[1] = g.len[1] = 0;
  if (rank == 0) {
    g.base[0] = 1;
    g.len[0] = 2 * np - 1;
  } else if (rank == c - 1) {
    g.base[0] = 0;
    g.len[0] = 2 * np;
  } else {
    g.base[0] = 0;
    g.len[0] = np;
    g.base[1] = np + 1;
    g.len[1] = np;
  }
  return g;
}

// (ring, position in it) of local slot kl's top (side 0) or bottom (side
// 1) position; ring -1 is block 0's fixed top[0].
__device__ __forceinline__ int2 locate(int kl, int side, int rank, int c, int np) {
  if (side == 1) return make_int2(0, rank == 0 ? np - 1 + kl : kl);
  if (rank == 0) return kl == 0 ? make_int2(-1, 0) : make_int2(0, np - 1 - kl);
  if (rank == c - 1) return make_int2(0, 2 * np - 1 - kl);
  return make_int2(1, np - 1 - kl);
}

// The buffer of ring position j when the ring's phase is ph = r mod (len + 1).
__device__ __forceinline__ int ring_buffer(int base, int len, int j, int ph) {
  const int k = j - ph;
  return base + (k >= 0 ? k : k + len + 1);
}

__global__ void __launch_bounds__(kThreads, 1)
psd_clip_kernel(const float2* __restrict__ in, float2* __restrict__ out, float2* __restrict__ work,
                int* __restrict__ sweeps_out, int d) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int c = kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int mat = blockIdx.x / c;
  const int tid = threadIdx.x;
  const int m = d + (d & 1), h = m / 2, ld = 2 * m;  // a buffer: A's column, then V's
  const int np = pairs_of(rank, c, h), k0 = first_pair(rank, c, h);
  const Rings rings = rings_of(rank, c, np);

  extern __shared__ __align__(16) float2 S[];  // V's rows move two at a time
  __shared__ float4 rot[2][kMaxPairs];      // rotations (s, r, e) by slot, of even and odd rounds
  __shared__ float2 rot_aux[2][kMaxPairs];  // and (t |a_pq|, their pair p | q << 16)
  __shared__ Pair pairs[kMaxLocal];
  __shared__ float diag[kMaxDim];  // A's diagonal, in every block
  __shared__ float part_fro[kCluster], part_off[kCluster];
  __shared__ float lam[kMaxDim], sqrt_w[kMaxDim];  // eigenvalues and sqrt(w), by column
  __shared__ float partial[kThreads / 32];
  __shared__ float total;

  // the neighbours' rings that this block's leaving columns enter: the right
  // one's ring 0 (base 0), the left one's ring 0 (block 0) or 1
  const Rings right_rings = rings_of(rank + 1, c, pairs_of(rank + 1, c, h));
  const Rings left_rings = rings_of(rank - 1, c, pairs_of(rank - 1, c, h));
  const int2 right = make_int2(right_rings.base[0], right_rings.len[0]);
  const int2 left = make_int2(left_rings.base[rank == 1 ? 0 : 1], left_rings.len[rank == 1 ? 0 : 1]);
  int ph[2] = {0, 0};   // the rings' phases, r mod (len + 1)
  int nph[2] = {0, 0};  // the neighbours' entering rings' phases: right, left
  auto buffer_of = [&](int kl, int side) {
    const int2 rj = locate(kl, side, rank, c, np);
    return rj.x < 0 ? 0 : ring_buffer(rings.base[rj.x], rings.len[rj.x], rj.y, ph[rj.x]);
  };
  // the column at local slot kl's top (side 0) or bottom (side 1) position
  // in a round rr mod m - 1: pair 0 is (rr, m - 1), pair k (rr + k, rr - k)
  // mod m - 1
  auto column_of = [&](int kl, int side, int rr) {
    const int k = k0 + kl, n = m - 1;
    if (side == 0) return k == 0 ? n : rr + k - (rr + k >= n ? n : 0);
    return rr - k + (rr - k < 0 ? n : 0);
  };
  // this block's cluster sum of v, written to slot `rank` of every block's `part`
  auto publish = [&](float v, float* part) {
    v = block_sum(v, partial, &total);
    if (tid == 0)
      for (int s = 0; s < c; ++s) *cluster.map_shared_rank(part + rank, s) = v;
  };
  auto gathered = [&](const float* part) {
    float s = 0.f;
    for (int k = 0; k < c; ++k) s += part[k];
    return s;
  };
  // the rotation of slot k's pair of columns p < q in round r (parity par)
  // from a_pq and the diagonal, into every block's tables
  auto rotate_pair = [&](int k, int p, int q, float2 x, int par) {
    float4 g = make_float4(0.f, 0.f, 1.f, 0.f);
    float tx = 0.f;
    const float xx = x.x * x.x + x.y * x.y;
    // rsqrtf's and __fdividef's few ulps leave J unitary to first order,
    // which the refinement takes; below FLT_MIN, a_pq is left as it is
    if (xx >= FLT_MIN) {
      const float inv = rsqrtf(xx);
      const float tau = (diag[q] - diag[p]) * (0.5f * inv);
      const float t = copysignf(__fdividef(1.f, fabsf(tau) + sqrtf(fmaf(tau, tau, 1.f))), tau);
      const float cs = rsqrtf(fmaf(t, t, 1.f));
      const float sn = t * cs;
      g = make_float4(sn, __fdividef(sn, 1.f + cs), x.x * inv, x.y * inv);
      tx = t * xx * inv;
    }
    const float2 aux = make_float2(tx, __int_as_float(p | (q << 16)));
    for (int b = 0; b < c; ++b) {
      *cluster.map_shared_rank(&rot[par][k], b) = g;
      *cluster.map_shared_rank(&rot_aux[par][k], b) = aux;
    }
  };
  // local slot kl's columns in round r (this block's rings at its phase)
  // into `pairs`, and, unless a neighbour's column enters it, its rotation.
  // A column that leaves goes also to the spare buffer of the neighbour's
  // ring it enters: bottom[k0 + np - 1] to the right, top[k0] to the left.
  auto next_pair = [&](int kl, int r, int rr) {
    const int bt = buffer_of(kl, 0), bb = buffer_of(kl, 1);
    const int ct = column_of(kl, 0, rr), cb = column_of(kl, 1, rr);
    float2* out_top = nullptr;
    float2* out_bottom = nullptr;
    if (kl == np - 1 && rank < c - 1)
      out_bottom = cluster.map_shared_rank(S + (right.x + right.y - nph[0]) * ld, rank + 1);
    if (kl == 0 && rank > 0)
      out_top = cluster.map_shared_rank(S + (left.x + left.y - nph[1]) * ld, rank - 1);
    const bool top_first = ct < cb;
    const int bp = top_first ? bt : bb, bq = top_first ? bb : bt;
    const int p = top_first ? ct : cb, q = top_first ? cb : ct;
    Pair pr;
    pr.src_p = bp * ld;
    pr.src_q = bq * ld;
    pr.out_p = top_first ? out_top : out_bottom;
    pr.out_q = top_first ? out_bottom : out_top;
    pairs[kl] = pr;
    const bool entered = r > 0 && ((kl == np - 1 && rank < c - 1) || (kl == 0 && rank > 0));
    if (!entered) rotate_pair(k0 + kl, p, q, S[bq * ld + p], r & 1);
  };
  // the rotation in round r of the neighbour's slot k that the column of
  // buffer xb (index x), leaving this block, enters; y is its partner there
  auto entering_pair = [&](int k, int xb, int x, int y, int r) {
    const int p = min(x, y), q = max(x, y);
    const float2 a = S[xb * ld + y];  // A[y, x]
    rotate_pair(k, p, q, x == q ? a : conj2(a), r & 1);
  };

  // Load: the columns of round 0's positions, top[k] = k (top[0] = m - 1)
  // and bottom[k] = m - 1 - k (bottom[0] = 0); A from the lower triangle,
  // mirrored; V = I; A by columns into `work`, its diagonal into every block.
  const float2* src = in + static_cast<size_t>(mat) * d * d;
  float2* a0_cols = work + static_cast<size_t>(mat) * 3 * d * d;  // A0 by columns, for the refinement
  float fro = 0.f, off = 0.f;
  for (int e = tid; e < 2 * np * m; e += kThreads) {
    const int t = e / m, i = e - t * m;
    const int side = t < np ? 0 : 1, kl = t - side * np;
    const int j = column_of(kl, side, 0), buf = buffer_of(kl, side);
    float2 v = make_float2(0.f, 0.f);
    if (i < d && j < d) {
      v = i >= j ? src[i * d + j] : conj2(src[j * d + i]);
      if (i == j) v.y = 0.f;
      a0_cols[j * d + i] = v;
    }
    const float v2 = v.x * v.x + v.y * v.y;
    fro += v2;
    if (i != j) off += v2;
    else
      for (int b = 0; b < c; ++b) *cluster.map_shared_rank(diag + j, b) = v.x;
    S[buf * ld + i] = v;
    S[buf * ld + m + i] = make_float2(i == j ? 1.f : 0.f, 0.f);
  }
  publish(fro, part_fro);
  publish(off, part_off);
  cluster.sync();  // every block has started, and every diagonal entry is in every block
  const float limit = FLT_EPSILON * FLT_EPSILON * gathered(part_fro);
  if (tid < np) next_pair(tid, 0, 0);
  cluster.sync();  // round 0's rotations are in every block

  // A thread's share of a round: row pairs a and a + ha of A's blocks and
  // rows 2 k and 2 k + 1 of V, for every a_groups-th (v_groups-th) local pair
  const int ha = (h + 1) / 2, hm = m / 2;
  const int a_lane = tid % ha, a_group = tid / ha, a_groups = kThreads / ha;
  const int v_lane = tid % hm, v_group = (kThreads - 1 - tid) / hm, v_groups = kThreads / hm;
  int sweep = 0;
  for (int r = 0, rr = 0;; ++r, rr = rr + 1 == m - 1 ? 0 : rr + 1) {  // round, round of the sweep
    const int par = r & 1;
    if (rr == 0) {
      if (sweep == kMaxSweeps || gathered(part_off) <= limit) break;
      ++sweep;
    }
    // A's 2 x 2 blocks: rows of pairs a1 and a2, columns of local pairs b
    // and b + a_groups, their loads issued together
    if (a_group < a_groups) {
      const int a1 = a_lane, a2 = min(a_lane + ha, h - 1);
      const bool two = a_lane + ha < h;
      const float4 g1 = rot[par][a1], g2 = rot[par][a2];
      const float2 x1 = rot_aux[par][a1], x2 = rot_aux[par][a2];
      const int pq1 = __float_as_int(x1.y), pq2 = __float_as_int(x2.y);
      const int rows[4] = {pq1 & 0xffff, pq1 >> 16, pq2 & 0xffff, pq2 >> 16};
      for (int b0 = a_group; b0 < np; b0 += 2 * a_groups) {
        const int bs[2] = {b0, min(b0 + a_groups, np - 1)};
        Pair pr[2];
        float4 gb[2];
        float2 x[2][2][4];  // [b][a]: x00, x10, x01, x11, rows p, q of columns p_b, q_b
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          pr[n] = pairs[bs[n]];
          gb[n] = rot[par][k0 + bs[n]];
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            x[n][w][0] = S[pr[n].src_p + rows[2 * w]];
            x[n][w][1] = S[pr[n].src_p + rows[2 * w + 1]];
            x[n][w][2] = S[pr[n].src_q + rows[2 * w]];
            x[n][w][3] = S[pr[n].src_q + rows[2 * w + 1]];
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          rotate_block(a1 == k0 + bs[n], g1, gb[n], x1.x, x[n][0]);
          rotate_block(a2 == k0 + bs[n], g2, gb[n], x2.x, x[n][1]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (n == 1 && b0 + a_groups >= np) break;
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            if (w == 1 && !two) break;
            const int rp = rows[2 * w], rq = rows[2 * w + 1];
            S[pr[n].src_p + rp] = x[n][w][0];
            S[pr[n].src_p + rq] = x[n][w][1];
            S[pr[n].src_q + rp] = x[n][w][2];
            S[pr[n].src_q + rq] = x[n][w][3];
            if (pr[n].out_p != nullptr) {
              pr[n].out_p[rp] = x[n][w][0];
              pr[n].out_p[rq] = x[n][w][1];
            }
            if (pr[n].out_q != nullptr) {
              pr[n].out_q[rp] = x[n][w][2];
              pr[n].out_q[rq] = x[n][w][3];
            }
          }
        }
      }
    }
    // V's rows 2 k and 2 k + 1 of local pairs b and b + v_groups' two
    // columns, two entries a load
    if (v_group < v_groups) {
      const int k = m + 2 * v_lane;
      for (int b0 = v_group; b0 < np; b0 += 2 * v_groups) {
        const int bs[2] = {b0, min(b0 + v_groups, np - 1)};
        Pair pr[2];
        float4 g[2], x[2], y[2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          pr[n] = pairs[bs[n]];
          g[n] = rot[par][k0 + bs[n]];
          x[n] = *reinterpret_cast<const float4*>(S + pr[n].src_p + k);
          y[n] = *reinterpret_cast<const float4*>(S + pr[n].src_q + k);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float2 x0 = make_float2(x[n].x, x[n].y), x1 = make_float2(x[n].z, x[n].w);
          float2 y0 = make_float2(y[n].x, y[n].y), y1 = make_float2(y[n].z, y[n].w);
          rotate_cols(g[n], x0, y0);
          rotate_cols(g[n], x1, y1);
          x[n] = make_float4(x0.x, x0.y, x1.x, x1.y);
          y[n] = make_float4(y0.x, y0.y, y1.x, y1.y);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (n == 1 && b0 + v_groups >= np) break;
          *reinterpret_cast<float4*>(S + pr[n].src_p + k) = x[n];
          *reinterpret_cast<float4*>(S + pr[n].src_q + k) = y[n];
          if (pr[n].out_p != nullptr) *reinterpret_cast<float4*>(pr[n].out_p + k) = x[n];
          if (pr[n].out_q != nullptr) *reinterpret_cast<float4*>(pr[n].out_q + k) = y[n];
        }
      }
    }
    if (tid < h) {  // the diagonal's pivots, in every block alike
      const float2 aux = rot_aux[par][tid];
      const int pq = __float_as_int(aux.y);
      diag[pq & 0xffff] -= aux.x;
      diag[pq >> 16] += aux.x;
    }
    __syncthreads();  // this block's columns are applied

    // The rotations of round r + 1 that this block computes: those of its
    // pairs that keep their columns, and those of the neighbours' pairs that
    // its leaving columns enter. Every block thus publishes them before the
    // round's one cluster barrier, and none waits for a column to arrive.
    if (rr + 1 == m - 1) {  // the off-diagonal norm at the next sweep's start
      float o = 0.f;
      for (int e = tid; e < 2 * np * m; e += kThreads) {
        const int t = e / m, i = e - t * m;
        const int side = t < np ? 0 : 1, kl = t - side * np;
        if (i != column_of(kl, side, rr)) {
          const float2 v = S[buffer_of(kl, side) * ld + i];
          o += v.x * v.x + v.y * v.y;
        }
      }
      publish(o, part_off);
    }
    const int rr1 = rr + 1 == m - 1 ? 0 : rr + 1;
    // (in warp 1, beside warp 0's pairs)
    if (tid == 32 && rank < c - 1)  // bottom[k0 + np - 1] enters the right neighbour's slot k0 + np
      entering_pair(k0 + np, buffer_of(np - 1, 1), column_of(np - 1, 1, rr),
                    column_of(np, 0, rr1), r + 1);
    if (tid == 33 && rank > 0)  // top[k0] enters the left neighbour's slot k0 - 1
      entering_pair(k0 - 1, buffer_of(0, 0), column_of(0, 0, rr), column_of(-1, 1, rr1), r + 1);
    for (int w = 0; w < 2; ++w) {
      ph[w] = ph[w] == rings.len[w] ? 0 : ph[w] + 1;
      nph[w] = nph[w] == (w ? left.y : right.y) ? 0 : nph[w] + 1;
    }
    if (tid < np) next_pair(tid, r + 1, rr1);
    cluster.sync();  // round r + 1's rotations are in every block, and its entering columns
  }
  if (sweeps_out != nullptr && rank == 0 && tid == 0) sweeps_out[mat] = sweep;
  // (whole sweeps bring every column back to its round-0 position)

  // The sweeps leave V orthonormal and A diagonal only to the rounding of
  // ~2,000 rotations of every entry, some 30 eps, where cuSOLVER's eigh
  // holds a few eps. A first-order refinement with the input A0 restores
  // that, at the cost of five products of d x d matrices: with
  // E = V^H V - I and B = V^H A0 V (sums in float64), the orthonormal
  // V (I - E / 2) has eigenvalues lambda_j = B_jj / (1 + E_jj) and
  // off-diagonal residue R = B - (E Lambda + Lambda E) / 2, and the clip is,
  // to first order in E and R (the matrix function's divided differences,
  // which stay bounded between close eigenvalues),
  //   out = U U^H,  U = V (sqrt(W) + K - E sqrt(W) / 2),
  //   K_jt = G_jt R_jt / (sqrt(w_j) + sqrt(w_t)),
  //   G_jt = (w_j - w_t) / (lambda_j - lambda_t)  (1 / sum between two positives),
  // with w = max(lambda, 1e-15) / sum. Until U is built, `out` holds V by
  // rows and `work` A0, V and E by columns, so that a warp's reads of a row
  // of the left factor in the products below are contiguous.
  //
  // A thread takes this block's positions t = ti + 8 u and the rows
  // j (or i, k) = tj + 64 v of their columns.
  float2* v_rows = out + static_cast<size_t>(mat) * d * d;
  float2* v_cols = a0_cols + static_cast<size_t>(d) * d;
  float2* e_cols = v_cols + static_cast<size_t>(d) * d;
  for (int e = tid; e < 2 * np * m; e += kThreads) {
    const int t = e / m, i = e - t * m;
    const int side = t < np ? 0 : 1, buf = buffer_of(t - side * np, side), j = column_of(t - side * np, side, 0);
    if (i < d && j < d) {
      const float2 x = S[buf * ld + m + i];
      v_rows[i * d + j] = x;
      v_cols[j * d + i] = x;
    }
  }
  __threadfence();
  cluster.sync();  // all of V is in `out` and `work`

  const int ti = tid % kRowThreads, tj = tid / kRowThreads;
  constexpr int kSpan = kThreads / kRowThreads;
  int own_buf[kRowTile], own_col[kRowTile];  // -1: no position, or the padded column
#pragma unroll
  for (int u = 0; u < kRowTile; ++u) {
    const int t = ti + kRowThreads * u;
    own_buf[u] = 0;
    own_col[u] = -1;
    if (t < 2 * np) {
      const int side = t < np ? 0 : 1;
      own_buf[u] = buffer_of(t - side * np, side);
      const int j = column_of(t - side * np, side, 0);
      if (j < d) own_col[u] = j;
    }
  }
  // E's, A0 V's and B's columns of this block's positions, kQuarter
  // positions of a thread at a time: E into `work`, A0 V into the A halves
  // of buffers t, then B over it
  constexpr int kQuarter = 2;
  for (int q0 = 0; q0 < kRowTile; q0 += kQuarter) {
    double e_re[kQuarter][kColTile], e_im[kQuarter][kColTile];
    double a_re[kQuarter][kColTile], a_im[kQuarter][kColTile];
#pragma unroll
    for (int u = 0; u < kQuarter; ++u)
#pragma unroll
      for (int v = 0; v < kColTile; ++v) e_re[u][v] = e_im[u][v] = a_re[u][v] = a_im[u][v] = 0.0;
#pragma unroll 2
    for (int k = 0; k < d; ++k) {
      float2 vo[kQuarter], vg[kColTile], a0[kColTile];
#pragma unroll
      for (int u = 0; u < kQuarter; ++u) vo[u] = S[own_buf[q0 + u] * ld + m + k];
#pragma unroll
      for (int v = 0; v < kColTile; ++v) {
        const int i = min(tj + kSpan * v, d - 1);
        vg[v] = v_rows[k * d + i];   // V[k, i]
        a0[v] = a0_cols[k * d + i];  // A0[i, k]
      }
#pragma unroll
      for (int u = 0; u < kQuarter; ++u)
#pragma unroll
        for (int v = 0; v < kColTile; ++v) {
          const double xr = vo[u].x, xi = vo[u].y;
          e_re[u][v] += vg[v].x * xr + vg[v].y * xi;  // conj(V[k, i]) V[k, t]
          e_im[u][v] += vg[v].x * xi - vg[v].y * xr;
          a_re[u][v] += a0[v].x * xr - a0[v].y * xi;  // A0[i, k] V[k, t]
          a_im[u][v] += a0[v].x * xi + a0[v].y * xr;
        }
    }
#pragma unroll
    for (int u = 0; u < kQuarter; ++u) {
      const int t = ti + kRowThreads * (q0 + u), col = own_col[q0 + u];
      if (col < 0) continue;
#pragma unroll
      for (int v = 0; v < kColTile; ++v) {
        const int i = tj + kSpan * v;
        if (i >= d) continue;
        e_cols[col * d + i] = make_float2(static_cast<float>(e_re[u][v] - (i == col ? 1.0 : 0.0)),
                                          static_cast<float>(e_im[u][v]));
        S[t * ld + i] = make_float2(static_cast<float>(a_re[u][v]), static_cast<float>(a_im[u][v]));
      }
    }
  }
  __syncthreads();  // this block's columns of E and A0 V are in place
  for (int q0 = 0; q0 < kRowTile; q0 += kQuarter) {
    double b_re[kQuarter][kColTile], b_im[kQuarter][kColTile];
#pragma unroll
    for (int u = 0; u < kQuarter; ++u)
#pragma unroll
      for (int v = 0; v < kColTile; ++v) b_re[u][v] = b_im[u][v] = 0.0;
#pragma unroll 2
    for (int k = 0; k < d; ++k) {
      float2 ax[kQuarter], vg[kColTile];
#pragma unroll
      for (int u = 0; u < kQuarter; ++u) ax[u] = S[min(ti + kRowThreads * (q0 + u), 2 * np - 1) * ld + k];
#pragma unroll
      for (int v = 0; v < kColTile; ++v) vg[v] = v_rows[k * d + min(tj + kSpan * v, d - 1)];
#pragma unroll
      for (int u = 0; u < kQuarter; ++u)
#pragma unroll
        for (int v = 0; v < kColTile; ++v) {  // conj(V[k, j]) (A0 V)[k, t]
          const double xr = ax[u].x, xi = ax[u].y;
          b_re[u][v] += vg[v].x * xr + vg[v].y * xi;
          b_im[u][v] += vg[v].x * xi - vg[v].y * xr;
        }
    }
    __syncthreads();  // these positions' columns of A0 V are read
#pragma unroll
    for (int u = 0; u < kQuarter; ++u) {
      const int t = ti + kRowThreads * (q0 + u);
      if (own_col[q0 + u] < 0) continue;
#pragma unroll
      for (int v = 0; v < kColTile; ++v) {
        const int j = tj + kSpan * v;
        if (j < d) S[t * ld + j] = make_float2(static_cast<float>(b_re[u][v]), static_cast<float>(b_im[u][v]));
      }
    }
  }
  __syncthreads();  // this block's columns of B are in place
  if (tid < 2 * np) {  // lambda of each position's column, into every block
    const int side = tid < np ? 0 : 1, col = column_of(tid - side * np, side, 0);
    if (col < d) {
      const float l = S[tid * ld + col].x / (1.f + e_cols[col * d + col].x);
      for (int b = 0; b < c; ++b) *cluster.map_shared_rank(lam + col, b) = l;
    }
  }
  cluster.sync();  // every eigenvalue is in every block
  const float wsum = block_sum(tid < d ? fmaxf(lam[tid], kFloor) : 0.f, partial, &total);
  if (tid < d) sqrt_w[tid] = sqrtf(fmaxf(lam[tid], kFloor) / wsum);
  __syncthreads();
  // C = K - E sqrt(W) / 2 over B, in the A halves of buffers t
#pragma unroll
  for (int u = 0; u < kRowTile; ++u) {
    const int t = ti + kRowThreads * u, col = own_col[u];
    if (col < 0) continue;
    const float lt = lam[col], st = sqrt_w[col];
#pragma unroll
    for (int v = 0; v < kColTile; ++v) {
      const int j = tj + kSpan * v;
      if (j >= d) continue;
      const float2 e = e_cols[col * d + j];
      float2 cc = make_float2(-0.5f * e.x * st, -0.5f * e.y * st);
      if (j != col) {
        const float lj = lam[j];
        const bool pj = lj > kFloor, pt = lt > kFloor;
        const float g = pj && pt ? 1.f / wsum
                        : !pj && !pt ? 0.f
                                     : (fmaxf(lj, kFloor) - fmaxf(lt, kFloor)) / ((lj - lt) * wsum);
        const float f = g / (sqrt_w[j] + st), hs = 0.5f * (lj + lt);
        const float2 b = S[t * ld + j];
        cc.x += f * (b.x - hs * e.x);
        cc.y += f * (b.y - hs * e.y);
      }
      S[t * ld + j] = cc;
    }
  }
  __syncthreads();
  // U = V sqrt(W) + V C, into the A halves of buffers t (a padded
  // column's and row's U is 0)
  float acc_re[kRowTile][kColTile], acc_im[kRowTile][kColTile];
#pragma unroll
  for (int u = 0; u < kRowTile; ++u)
#pragma unroll
    for (int v = 0; v < kColTile; ++v) acc_re[u][v] = acc_im[u][v] = 0.f;
  for (int j = 0; j < d; ++j) {
    float2 cj[kRowTile], vg[kColTile];
#pragma unroll
    for (int u = 0; u < kRowTile; ++u) cj[u] = S[min(ti + kRowThreads * u, 2 * np - 1) * ld + j];
#pragma unroll
    for (int v = 0; v < kColTile; ++v) vg[v] = v_cols[j * d + min(tj + kSpan * v, d - 1)];
#pragma unroll
    for (int u = 0; u < kRowTile; ++u)
#pragma unroll
      for (int v = 0; v < kColTile; ++v) {  // V[k, j] C[j, t]
        acc_re[u][v] += vg[v].x * cj[u].x - vg[v].y * cj[u].y;
        acc_im[u][v] += vg[v].x * cj[u].y + vg[v].y * cj[u].x;
      }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kRowTile; ++u) {
    const int t = ti + kRowThreads * u, col = own_col[u];
    if (t >= 2 * np) continue;
    const float st = col >= 0 ? sqrt_w[col] : 0.f;
#pragma unroll
    for (int v = 0; v < kColTile; ++v) {
      const int k = tj + kSpan * v;
      if (k >= m) continue;
      float2 x = make_float2(0.f, 0.f);
      if (col >= 0 && k < d) {
        x = S[own_buf[u] * ld + m + k];
        x = make_float2(x.x * st + acc_re[u][v], x.y * st + acc_im[u][v]);
      }
      S[t * ld + k] = x;
    }
  }
  cluster.sync();  // every block's U is in place, and `out` and `work` are no longer read

  // this block's rows of out = U U^H, from each block's U in turn (another
  // block's staged into the V halves of this block's buffers)
  const int rows = (d + c - 1) / c, r0 = rank * rows, r1 = min(d, r0 + rows);
#pragma unroll
  for (int u = 0; u < kRowTile; ++u)
#pragma unroll
    for (int v = 0; v < kColTile; ++v) acc_re[u][v] = acc_im[u][v] = 0.f;
  for (int s = 0; s < c; ++s) {
    const int ncols = 2 * pairs_of(s, c, h);
    int off = 0;
    if (s != rank) {
      const float2* R = cluster.map_shared_rank(S, s);
      for (int e = tid; e < ncols * m; e += kThreads) {
        const int j = e / m, i = e - j * m;
        S[j * ld + m + i] = R[j * ld + i];
      }
      __syncthreads();
      off = m;
    }
    for (int j = 0; j < ncols; ++j) {
      const float2* U = S + j * ld + off;
      float2 ui[kRowTile], uk[kColTile];
#pragma unroll
      for (int u = 0; u < kRowTile; ++u) ui[u] = U[min(r0 + ti + kRowThreads * u, m - 1)];
#pragma unroll
      for (int v = 0; v < kColTile; ++v) uk[v] = U[min(tj + kSpan * v, m - 1)];
#pragma unroll
      for (int u = 0; u < kRowTile; ++u)
#pragma unroll
        for (int v = 0; v < kColTile; ++v) {
          acc_re[u][v] += ui[u].x * uk[v].x + ui[u].y * uk[v].y;
          acc_im[u][v] += ui[u].y * uk[v].x - ui[u].x * uk[v].y;
        }
    }
    __syncthreads();
  }
  float2* dst = out + static_cast<size_t>(mat) * d * d;
#pragma unroll
  for (int u = 0; u < kRowTile; ++u) {
    const int i = r0 + ti + kRowThreads * u;
#pragma unroll
    for (int v = 0; v < kColTile; ++v) {
      const int k = tj + kSpan * v;
      if (i < r1 && k < d) dst[i * d + k] = make_float2(acc_re[u][v], acc_im[u][v]);
    }
  }
  cluster.sync();  // no block leaves while another reads its U
}

size_t clip_smem(int d) {
  const int m = d + (d & 1), np = (m / 2 + kCluster - 1) / kCluster;
  return sizeof(float2) * static_cast<size_t>(2 * np + 2) * 2 * m;
}

bool clip_args_ok(int B, int d) {
  return B >= 1 && d >= kMinDim && d <= kMaxDim;
}

}  // namespace

extern "C" {

const char* psd_clip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in, out: B contiguous d x d complex64 matrices on the device (in's lower
// triangle is read), 65 <= d <= 256; work: 3 B such matrices of scratch;
// sweeps: B ints, the sweeps each matrix ran, or null. Returns the launch's error, then cudaGetLastError().
int psd_clip_c64(const void* in, void* out, void* work, int* sweeps, int B, int d, void* stream) {
  if (!clip_args_ok(B, d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = clip_smem(d);
  cudaError_t err = cudaFuncSetAttribute(psd_clip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, psd_clip_kernel, static_cast<const float2*>(in),
                           static_cast<float2*>(out), static_cast<float2*>(work), sweeps, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
