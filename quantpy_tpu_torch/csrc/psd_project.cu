// PSD projection of a batch of Hermitian matrices for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's process_core._eigh_psd_mat calls
// jnp.linalg.eigh, which XLA batches on the TPU. On the card,
// torch.linalg.eigh loops cuSOLVER's one-matrix syevd over a batch of
// matrices larger than 32 x 32: tens of launches per matrix, and an error
// check that reads the card back. This kernel computes the whole of
// _eigh_psd_mat for every matrix of a complex64 batch in one launch:
//
//   A = V diag(lambda) V^H        (eigendecomposition)
//   out = V diag(max(lambda, 1e-12)) V^H
//
// Algorithm. Two-sided cyclic Jacobi for complex Hermitian matrices in
// float32. For a pivot pair (p, q) with a_pq = |a_pq| e the unitary
// J = [[c, s e], [-s conj(e), c]] (c, s the real symmetric rotation of
// Golub and Van Loan's sym.schur2 for [[a_pp, |a_pq|], [|a_pq|, a_qq]])
// zeroes a_pq; A <- J^H A J and V <- V J, applied in Rutishauser's form
// (r = s / (1 + c), each entry changed by a correction, kernels.py's
// _jacobi_round says why: with c itself, which rounds to 1 for small s, V
// drifted from unitary by 1e-5 at d = 64 and the projection was ten times
// less accurate than cuSOLVER's). The pivot entries
// are set to their exact values (a_pq = 0, a_pp - t |a_pq|, a_qq + t |a_pq|);
// every other off-diagonal entry is a combination of off-diagonal entries,
// so the off-diagonal norm falls quadratically to zero without a rounding
// floor. A matrix stops at the first sweep that begins with its
// off-diagonal Frobenius norm at most eps_f32 ||A||_F, which bounds each
// eigenvalue's error by eps ||A||_F (Weyl), the accuracy of cuSOLVER's
// float32 syevd; kMaxSweeps caps the sweeps, and no input of the tests or of
// the benchmark's cells reaches it (PERF.md). The input's lower triangle is
// read and mirrored, and the diagonal's imaginary part dropped, as
// torch.linalg.eigh (UPLO='L') reads it: Dykstra's iterates are Hermitian
// only up to rounding. The working matrix is kept exactly Hermitian.
//
// Design. One block of 512 threads per matrix; A and V (float2) live in
// shared memory, m (2 m + 1) 8 bytes = 66,048 at d = m = 64: the whole
// problem stays on chip from load to store. V's rows are padded to m + 1
// entries, so that a warp reading one of its columns hits every bank once.
// A's are not: a round's blocks sit at the rows and columns of its pairs,
// which spread a warp over the banks by themselves (with padded rows the
// kernel took 1.19 ms at (64, 64, 64), against 0.65). An odd d is padded to
// m = d + 1 with a zero row and column, whose pairs never rotate. Sweeps run
// the parallel round-robin ordering: m / 2 disjoint pairs per round, m - 1
// rounds per sweep, every pair once; the rounds' pairs are tabled in shared
// memory and each thread's share of a round is fixed in registers before
// the sweeps, so a round does no integer division.
//
// The warps split by matrix. Warps 0-7 rotate A: in a round, m / 2 of their
// threads compute the rotations and set the pivot blocks; after a barrier
// of the eight warps each thread applies the rotations to its off-diagonal
// 2 x 2 blocks, J_a^H X J_b, one block per unordered pair (a, b) written
// with its conjugate transpose; then the barrier again. They publish each
// round's rotations in one of two slots in shared memory, and warps 8-15
// apply them to V's row pairs a round behind, so that A's and V's updates
// of a round overlap. Named barriers hand the slots over: a slot's "full"
// barrier completes when the rotating warps arrive and V's wait, its
// "empty" one when V's warps arrive and the rotating warps wait to refill
// it. Recomposition, after a barrier of all 512 threads, reads V from
// shared memory and writes each output entry once, coalesced.
//
// What bounds it. With S sweeps the least work per d x d matrix is
// S (d - 1) rounds of 20 d^2 flops (each rotation applied to the Hermitian
// half of A and to V, ~10 flops per complex entry) and 8 d^3 flops for the
// product: at d = 64 and 8 sweeps 43.4 MFLOP, so 2.8 GFLOP for the 64
// matrices of a Dykstra step, 0.04 ms at the card's 67 TFLOP/s FP32 peak;
// the 2.1 MB in and out take 0.6 us. One block per matrix fills 64 of the
// card's 132 SMs, and there each round is bound by the SM's shared-memory
// accesses (every entry of A's half and of V loaded and stored once a round,
// with the rotations' parameters) and by the latency of the rotations, which
// the round's updates wait for: splitting the warps 10 / 6 or 12 / 4, or
// running 768 or 1,024 threads, was slower (PERF.md gives the times).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kMaxDim = 64;
constexpr int kMaxSweeps = 40;      // kernels.PSD_MAX_SWEEPS
constexpr float kFloor = 1e-12f;    // process_core._CP_EPS
constexpr int kThreads = 512;
constexpr int kGroup = 256;  // the rotating warps 0-7; V's are warps 8-15
constexpr int kBarA = 1, kBarFull = 2, kBarEmpty = 4;  // barrier ids; full and empty: + slot

__device__ __forceinline__ float2 conj2(float2 a) { return make_float2(a.x, -a.y); }

// Named barriers: wait for `count` threads to reach barrier `id` (sync), or
// count this thread as arrived without waiting (arrive).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
// The rotating group's sum of v, returned to each of its threads.
__device__ float group_sum(float v, float* partial, float* total) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  bar_sync(kBarA, kGroup);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kGroup / 32; ++w) s += partial[w];
    *total = s;
  }
  bar_sync(kBarA, kGroup);
  return *total;
}

// Rows p and q of J^H X, in Rutishauser's form (r = s / (1 + c), c = 1 - s r):
// (x, y) <- (x - s (r x + e y), y + s (conj(e) x - r y)).
__device__ __forceinline__ void rotate_rows(float s, float r, float2 e, float2& x, float2& y) {
  const float2 ey = make_float2(e.x * y.x - e.y * y.y, e.x * y.y + e.y * y.x);
  const float2 ex = make_float2(e.x * x.x + e.y * x.y, e.x * x.y - e.y * x.x);
  const float2 nx = make_float2(x.x - s * (r * x.x + ey.x), x.y - s * (r * x.y + ey.y));
  const float2 ny = make_float2(y.x + s * (ex.x - r * y.x), y.y + s * (ex.y - r * y.y));
  x = nx;
  y = ny;
}

// Columns p and q of X J: (x, y) <- (x - s (r x + conj(e) y), y + s (e x - r y)).
__device__ __forceinline__ void rotate_cols(float s, float r, float2 e, float2& x, float2& y) {
  const float2 ey = make_float2(e.x * y.x + e.y * y.y, e.x * y.y - e.y * y.x);
  const float2 ex = make_float2(e.x * x.x - e.y * x.y, e.x * x.y + e.y * x.x);
  const float2 nx = make_float2(x.x - s * (r * x.x + ey.x), x.y - s * (r * x.y + ey.y));
  const float2 ny = make_float2(y.x + s * (ex.x - r * y.x), y.y + s * (ex.y - r * y.y));
  x = nx;
  y = ny;
}

// The block's sum of v, returned to every thread (blockDim.x a multiple of 32).
__device__ float block_sum(float v, float* partial, float* total) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += partial[w];
    *total = s;
  }
  __syncthreads();
  return *total;
}

__global__ void __launch_bounds__(kThreads)
psd_project_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                   int* __restrict__ sweeps_out, int d) {
  // each rotating thread's share of a round's off-diagonal blocks, and each
  // of V's threads' share of its row pairs
  constexpr int kVThreads = kThreads - kGroup;
  constexpr int kBlockTasks = ((kMaxDim / 2) * (kMaxDim / 4) + kGroup - 1) / kGroup;
  constexpr int kRowTasks = (kMaxDim * (kMaxDim / 2) + kVThreads - 1) / kVThreads;
  extern __shared__ float2 smem[];
  __shared__ unsigned short pairs[(kMaxDim - 1) * (kMaxDim / 2)];
  __shared__ float4 rot[2][kMaxDim / 2];  // two rounds' rotations: (s, r, e)
  __shared__ int rot_pq[2][kMaxDim / 2];  // and their pairs, p | q << 8; -1: stop
  __shared__ float lam[kMaxDim];
  __shared__ float partial[kThreads / 32];
  __shared__ float total;

  const int tid = threadIdx.x;
  const int m = d + (d & 1);
  const int h = m / 2;
  const int lda = m;
  const int ldv = m + 1;
  float2* __restrict__ A = smem;
  float2* __restrict__ V = smem + m * lda;
  const float2* src = in + static_cast<size_t>(blockIdx.x) * d * d;
  float2* dst = out + static_cast<size_t>(blockIdx.x) * d * d;

  // the rounds' pairs, p | q << 8: pair 0 of round r is (r, m - 1), pair
  // k > 0 is ((r + k) mod (m - 1), (r - k) mod (m - 1)), ordered
  for (int e = tid; e < (m - 1) * h; e += kThreads) {
    const int r = e / h, k = e - r * h;
    int p = r, q = m - 1;
    if (k > 0) {
      const int u = (r + k) % (m - 1), w = (r - k + m - 1) % (m - 1);
      p = min(u, w);
      q = max(u, w);
    }
    pairs[e] = static_cast<unsigned short>(p | (q << 8));
  }
  // off-diagonal blocks: pair a with pair (a + o) mod h for o = 1 .. h / 2
  // (at o = h / 2 with h even, only a < h / 2: each unordered pair once)
  int block_task[kBlockTasks];
#pragma unroll
  for (int i = 0; i < kBlockTasks; ++i) {
    const int e = tid + i * kGroup;
    block_task[i] = -1;
    if (tid < kGroup && e < h * (h / 2)) {
      const int o = e / h + 1, a = e - (o - 1) * h;
      if (!(2 * o == h && a >= o)) block_task[i] = a | (((a + o) % h) << 8);
    }
  }
  // V's rows k < d of pair a's two columns
  int row_task[kRowTasks];
#pragma unroll
  for (int i = 0; i < kRowTasks; ++i) {
    const int e = tid - kGroup + i * kVThreads;
    row_task[i] = -1;
    if (tid >= kGroup && e < d * h) {
      const int a = e / d;
      row_task[i] = a | ((e - a * d) << 8);
    }
  }

  // A from the lower triangle of the input, mirrored; V = I
  float fro = 0.f;
  for (int e = tid; e < m * m; e += kThreads) {
    const int i = e / m, j = e - i * m;
    float2 v = make_float2(0.f, 0.f);
    if (i < d && j < d) {
      v = i >= j ? src[i * d + j] : conj2(src[j * d + i]);
      if (i == j) v.y = 0.f;
    }
    fro += v.x * v.x + v.y * v.y;
    A[i * lda + j] = v;
    V[i * ldv + j] = make_float2(i == j ? 1.f : 0.f, 0.f);
  }
  const float limit = FLT_EPSILON * FLT_EPSILON * block_sum(fro, partial, &total);

  // Warps 0-7 rotate A and publish each round's rotations in one of two
  // slots; warps 8-15 apply them to V a round behind. A slot is refilled
  // only after V's warps have arrived at its empty barrier.
  int sweep = 0;
  if (tid < kGroup) {
    int n = 0;  // rounds published
    for (; sweep < kMaxSweeps; ++sweep) {
      float off = 0.f;
      for (int e = tid; e < m * m; e += kGroup) {
        const int i = e / m, j = e - i * m;
        if (i != j) {
          const float2 v = A[i * lda + j];
          off += v.x * v.x + v.y * v.y;
        }
      }
      if (group_sum(off, partial, &total) <= limit) break;

      for (int r = 0; r < m - 1; ++r, ++n) {
        const int slot = n & 1;
        if (n >= 2) bar_sync(kBarEmpty + slot, kThreads);
        if (tid < h) {
          const int pq = pairs[r * h + tid];
          const int p = pq & 255, q = pq >> 8;
          float sn = 0.f, rn = 0.f;
          float2 e = make_float2(1.f, 0.f);
          const float2 x = A[p * lda + q];
          const float absx = hypotf(x.x, x.y);
          if (absx > 0.f) {
            const float app = A[p * lda + p].x, aqq = A[q * lda + q].x;
            const float tau = (aqq - app) / (2.f * absx);
            const float t = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
            const float c = 1.f / sqrtf(1.f + t * t);
            sn = t * c;
            rn = sn / (1.f + c);
            e = make_float2(x.x / absx, x.y / absx);
            A[p * lda + p] = make_float2(app - t * absx, 0.f);
            A[q * lda + q] = make_float2(aqq + t * absx, 0.f);
            A[p * lda + q] = make_float2(0.f, 0.f);
            A[q * lda + p] = make_float2(0.f, 0.f);
          }
          rot[slot][tid] = make_float4(sn, rn, e.x, e.y);
          rot_pq[slot][tid] = pq;
        }
        bar_sync(kBarA, kGroup);
        bar_arrive(kBarFull + slot, kThreads);
#pragma unroll
        for (int i = 0; i < kBlockTasks; ++i) {
          if (block_task[i] < 0) continue;
          const int a = block_task[i] & 255, b = block_task[i] >> 8;
          const int pqa = rot_pq[slot][a], pqb = rot_pq[slot][b];
          const int pa = pqa & 255, qa = pqa >> 8, pb = pqb & 255, qb = pqb >> 8;
          float2 x00 = A[pa * lda + pb], x01 = A[pa * lda + qb];
          float2 x10 = A[qa * lda + pb], x11 = A[qa * lda + qb];
          const float4 ga = rot[slot][a], gb = rot[slot][b];
          rotate_rows(ga.x, ga.y, make_float2(ga.z, ga.w), x00, x10);
          rotate_rows(ga.x, ga.y, make_float2(ga.z, ga.w), x01, x11);
          rotate_cols(gb.x, gb.y, make_float2(gb.z, gb.w), x00, x01);
          rotate_cols(gb.x, gb.y, make_float2(gb.z, gb.w), x10, x11);
          A[pa * lda + pb] = x00;
          A[pa * lda + qb] = x01;
          A[qa * lda + pb] = x10;
          A[qa * lda + qb] = x11;
          A[pb * lda + pa] = conj2(x00);
          A[qb * lda + pa] = conj2(x01);
          A[pb * lda + qa] = conj2(x10);
          A[qb * lda + qa] = conj2(x11);
        }
        bar_sync(kBarA, kGroup);
      }
    }
    // the stop, in the next slot; then take V's arrival for the last round
    const int slot = n & 1;
    if (n >= 2) bar_sync(kBarEmpty + slot, kThreads);
    if (tid == 0) rot_pq[slot][0] = -1;
    bar_arrive(kBarFull + slot, kThreads);
    if (n >= 1) bar_sync(kBarEmpty + (slot ^ 1), kThreads);
  } else {
    for (int n = 0;; ++n) {
      const int slot = n & 1;
      bar_sync(kBarFull + slot, kThreads);
      if (rot_pq[slot][0] < 0) break;
#pragma unroll
      for (int i = 0; i < kRowTasks; ++i) {
        if (row_task[i] < 0) continue;
        const int a = row_task[i] & 255, k = row_task[i] >> 8;
        const int pq = rot_pq[slot][a], p = pq & 255, q = pq >> 8;
        float2 x = V[k * ldv + p], y = V[k * ldv + q];
        const float4 g = rot[slot][a];
        rotate_cols(g.x, g.y, make_float2(g.z, g.w), x, y);
        V[k * ldv + p] = x;
        V[k * ldv + q] = y;
      }
      bar_arrive(kBarEmpty + slot, kThreads);
    }
  }
  __syncthreads();

  if (sweeps_out != nullptr && tid == 0) sweeps_out[blockIdx.x] = sweep;
  for (int k = tid; k < d; k += kThreads) lam[k] = fmaxf(A[k * lda + k].x, kFloor);
  __syncthreads();
  // out = (V diag(lam)) V^H
  for (int e = tid; e < d * d; e += kThreads) {
    const int i = e / d, j = e - i * d;
    float re = 0.f, im = 0.f;
    for (int k = 0; k < d; ++k) {
      const float2 u = V[i * ldv + k], v = V[j * ldv + k];
      const float ur = u.x * lam[k], ui = u.y * lam[k];
      re += ur * v.x + ui * v.y;
      im += ui * v.x - ur * v.y;
    }
    dst[e] = make_float2(re, im);
  }
}

}  // namespace

extern "C" {

const char* psd_project_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in, out: B contiguous d x d complex64 matrices on the device (in's lower
// triangle is read); sweeps: B ints, the sweeps each matrix ran, or null.
// Returns cudaGetLastError() after the launch.
int psd_project_c64(const void* in, void* out, int* sweeps, int B, int d, void* stream) {
  if (B < 1 || d < 1 || d > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const int m = d + (d & 1);
  const size_t smem = sizeof(float2) * static_cast<size_t>(m) * (2 * m + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        psd_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  psd_project_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), static_cast<float2*>(out), sweeps, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
