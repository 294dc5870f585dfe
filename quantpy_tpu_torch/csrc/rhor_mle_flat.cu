// Flat-matrix RrhoR maximum-likelihood iteration for Hopper (sm_90a).
//
// Replaces quantpy_tpu/ops/kernels.py::rhor_mle_pallas_flat (body
// _rhor_kernel_flat): the same fixed point as rhor_mle.cu, but the loop state
// is the transposed density matrix t = (t_re, t_im) instead of the bloch
// vector, so the Pauli transfer matrix (PTM) is applied only at entry and at
// exit. The TPU kernel iterates t through G = [G_re | G_im] (K, 2D), with
// G_x = w2 PTM_x^T / d, K POVM rows, D = 4^n and d = 2^n.
//
// The fold. t is Hermitian, and so is every POVM row of G as a d x d matrix
// (G_re[k] symmetric, G_im[k] antisymmetric), so half of G's 2D columns
// repeat the other half. The kernel keeps t as its D real entries
// F[a d + e] = t_re[a, e] for a <= e and t_im[e, a] for a > e, and G as H
// (K, D), the same fold of each row. With w = 1 on the diagonal and 2 off
// it, per iteration and resample:
//
//   p   = (H o w) F               (K x D matvec, operand hw_t (D, K))
//   tr  = sum_a F[a (d + 1)]      (the diagonal, d terms)
//   c   = f tr / max(p, 1e-10)
//   R_f = d H^T c                 (D x K matvec, operand h_d (K, D))
//   S   = R t                     (complex d x d product, R and t unfolded)
//   F   = fold(S R)               (Re (S R)[a, e] for a <= e,
//                                  -Im (S R)[a, e] for a > e: d real terms)
//   F  /= max(tr F, 1e-10)
//
// and F = b0 entry at entry, b = F exit / d at exit (kernels.py::
// _flat_fold_operands; _rhor_mle_flat_folded states the same in PyTorch).
// The two POVM products are then the shapes of rhor_mle.cu's, 2 K D
// multiply-adds in all instead of the 4 K D of the unfolded [G_re | G_im],
// and the sandwich is 4 d^3 + 2 d^3 instead of 8 d^3.
//
// What bounds it on this card. At the flagship size (n = 4: K = 1296,
// D = 256, d = 16) one resample-iteration is 2 K D + 6 d^3 = 688,128 MACs,
// the least the function needs: 1.353 TFLOP for a 16,384-resample call of 60
// iterations, 20.2 ms at the card's 67 TFLOP/s FP32 peak; its 120 MB of
// inputs and outputs take 0.04 ms, so it is compute-bound. The operands (1.33
// MB each in f32) are the same for every resample and stay in the 50 MB L2.
// As for rhor_mle.cu, what holds the kernel back is not the FMA rate but the
// load instructions that feed the two POVM stages (operand values streamed
// from L2, state rows from shared memory), which take nearly all the time.
// On an H100 80GB HBM3 at 700 W a 16,384-resample call of 60 iterations takes
// about 64 ms in f32 (0.31 of the bound; 114 registers, no spills) and 168
// ms in f64 (PERF.md).
//
// What the design does about it. The POVM stages are rhor_mle.cu's
// register-tiled stages with w2^T and w2 replaced by hw_t and h_d and the
// bloch vector by F: a block of 256 threads owns a tile of BT resamples (BT =
// 32 bytes / sizeof(T): 8 in f32, 4 in f64); in p a thread owns kGroupsP
// POVM rows, in R_f a quad of components read as one 16-byte vector over a
// slice of the K rows (split-K, partial sums reduced once through the R and
// S buffers, dead in that stage); operand values are loaded kAhead steps
// before their use (a ring in registers). Each broadcast state-row load feeds
// 6 or 4 BT multiply-adds. The tile's state (F: D rows; c: K rows; R, S and
// t: 2D rows each, re and im; K + 7 D rows of BT values) lives in shared
// memory, stored resample-minor so that one 32-byte load fetches a row for
// the whole tile. R and t are written unfolded (re symmetric, im
// antisymmetric and zero on the diagonal) where their fold is computed, so
// the sandwich reads plain d x d rows. Arithmetic is plain FP32/FP64 FMA on
// the CUDA cores: no tensor cores and no TF32. Two blocks fit on an SM, so a
// thread has 128 registers; to stay under them the d-length loops are kept
// rolled and each stage reads the thread index anew (thread_index). When
// the state does not fit in shared memory (n >= 5), the caller passes a
// global scratch buffer of gridDim.x tiles instead and the same code runs
// through generic pointers. The ragged tail of the batch is masked: its rows
// read the last resample's inputs and are never stored.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupsP = 6;   // hw_t rows per thread in p = (H o w) F
constexpr int kAhead = 4;     // operand loads in flight per row (f32; f64 half)
constexpr int kMaxSplit = 4;  // K slices of R_f = d H^T c (4 D rows of partials)

template <typename T>
struct TileOf;
template <>
struct TileOf<float> {
  static constexpr int value = 8;
};
template <>
struct TileOf<double> {
  static constexpr int value = 4;
};

// One row of the tile: the BT values of one index, one per resample.
template <typename T, int BT>
struct alignas(16) Row {
  T v[BT];
};

template <typename T, int BT>
__device__ __forceinline__ Row<T, BT> load_row(const T* p) {
  return *reinterpret_cast<const Row<T, BT>*>(p);
}

template <typename T, int BT>
__device__ __forceinline__ void store_row(T* p, const Row<T, BT>& r) {
  *reinterpret_cast<Row<T, BT>*>(p) = r;
}

// Four consecutive values of h_d, read through the read-only path in one
// 16-byte vector (f32) or two (f64); `p` is aligned to the vector.
template <typename T>
struct Quad {
  T v[4];
};

template <typename T>
__device__ __forceinline__ Quad<T> load_quad(const T* p) {
  Quad<T> r;
  if constexpr (sizeof(T) == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = a.x, r.v[1] = a.y, r.v[2] = a.z, r.v[3] = a.w;
  } else {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 c = __ldg(reinterpret_cast<const double2*>(p) + 1);
    r.v[0] = a.x, r.v[1] = a.y, r.v[2] = c.x, r.v[3] = c.y;
  }
  return r;
}

// The thread's index, read anew where a stage starts: nothing derived from it
// is then computed once and held in registers through the other stages
// (with one index for the whole kernel, ptxas kept such values live through
// the POVM stages and spilled at the 128-register cap).
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// The trace for each resample of the tile: the d diagonal rows of F.
template <typename T, int BT>
__device__ __forceinline__ void trace_rows(const T* f, int d, T (&tr)[BT]) {
#pragma unroll
  for (int t = 0; t < BT; ++t) tr[t] = T(0);
#pragma unroll 1
  for (int a = 0; a < d; ++a) {
    const Row<T, BT> r = load_row<T, BT>(f + a * (d + 1) * BT);
#pragma unroll
    for (int t = 0; t < BT; ++t) tr[t] += r.v[t];
  }
}

// Writes the folded entry v of index i = a d + e into the Hermitian pair
// (re, im): re[a, e] = re[e, a] = v for a <= e (and im[a, a] = 0 on the
// diagonal), im[e, a] = -im[a, e] = v for a > e.
template <typename T, int BT>
__device__ __forceinline__ void store_unfolded(T* re, T* im, int i, int d,
                                               const Row<T, BT>& v) {
  const int a = i / d, e = i % d;
  const int mirror = e * d + a;
  if (a <= e) {
    store_row<T, BT>(re + i * BT, v);
    if (a < e) {
      store_row<T, BT>(re + mirror * BT, v);
    } else {
      store_row<T, BT>(im + i * BT, Row<T, BT>{});
    }
  } else {
    Row<T, BT> neg;
#pragma unroll
    for (int t = 0; t < BT; ++t) neg.v[t] = -v.v[t];
    store_row<T, BT>(im + mirror * BT, v);
    store_row<T, BT>(im + i * BT, neg);
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads, 2)
rhor_mle_flat_kernel(const T* __restrict__ freq,      // (B, K)
                     const T* __restrict__ bloch0,    // (B, D)
                     const T* __restrict__ hw_t,      // (D, K) (H o w)^T
                     const T* __restrict__ h_d,       // (K, D) d H
                     const T* __restrict__ entry,     // (D, D) F = b0 entry
                     const T* __restrict__ exit_map,  // (D, D) b = F exit / d
                     T* __restrict__ out,             // (B, D)
                     T* __restrict__ scratch,         // null, or gridDim.x tiles
                     int B, int K, int D, int d, int n_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t tile_len = static_cast<size_t>(BT) * (K + 7 * static_cast<size_t>(D));
  T* ws = scratch != nullptr ? scratch + blockIdx.x * tile_len
                             : reinterpret_cast<T*>(smem_raw);
  const size_t rows_d = static_cast<size_t>(D) * BT;
  T* f = ws;                                       // (D, BT) folded state F
  T* c = f + rows_d;                               // (K, BT) f tr / max(p, eps)
  T* r_re = c + static_cast<size_t>(K) * BT;       // (D, BT) R, unfolded
  T* r_im = r_re + rows_d;
  T* s_re = r_im + rows_d;                         // bloch0 at entry, then S
  T* s_im = s_re + rows_d;
  T* t_re = s_im + rows_d;                         // t, unfolded from F
  T* t_im = t_re + rows_d;

  const int tid = threadIdx.x;
  const T eps = T(1e-10);
  const int n_tiles = (B + BT - 1) / BT;
  constexpr int A = sizeof(T) == 4 ? kAhead : (kAhead + 1) / 2;
  // R_f = d H^T c: n_groups quads of components (D = 4^n), each summed over
  // `split` slices of K; with split > 1 (then D <= kThreads) the partial
  // sums go to r_re..s_im
  const int n_groups = D / 4;
  const int split = n_groups >= kThreads ? 1 : min(kMaxSplit, kThreads / n_groups);
  const int slice = (K + split - 1) / split;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b0 = tile * BT;
    const T* f_tile = freq + static_cast<size_t>(b0) * K;  // read at 32-bit offsets
    for (int idx = tid; idx < D * BT; idx += kThreads) {
      const int t = idx / D, j = idx % D;
      const int row = min(b0 + t, B - 1);
      s_re[j * BT + t] = bloch0[static_cast<size_t>(row) * D + j];
    }
    __syncthreads();

    // entry: F = b0 entry, and t unfolded from it; folded index i
    for (int i = tid; i < D; i += kThreads) {
      T acc[BT] = {};
#pragma unroll 4
      for (int j = 0; j < D; ++j) {
        const T w = __ldg(entry + static_cast<size_t>(j) * D + i);
        const Row<T, BT> x = load_row<T, BT>(s_re + j * BT);
#pragma unroll
        for (int t = 0; t < BT; ++t) acc[t] += w * x.v[t];
      }
      Row<T, BT> o;
#pragma unroll
      for (int t = 0; t < BT; ++t) o.v[t] = acc[t];
      store_row<T, BT>(f + i * BT, o);
      store_unfolded<T, BT>(t_re, t_im, i, d, o);
    }
    __syncthreads();

    for (int it = 0; it < n_iter; ++it) {
      // p = (H o w) F and c = f tr / max(p, eps); thread owns POVM rows
      // k = base + g kThreads + tid, g < kGroupsP (rows past K are never
      // stored; a warp whose rows all lie past K skips them)
      for (int base = 0; base < K; base += kGroupsP * kThreads) {
        const int tid = thread_index();
        bool live[kGroupsP];
#pragma unroll
        for (int g = 0; g < kGroupsP; ++g) live[g] = base + g * kThreads + tid < K;
        const T* wk = hw_t + base + tid;
        T acc[kGroupsP][BT] = {};
        // ring of the operand values of the next A components: each is
        // loaded A steps before its use; loads past D are clamped to its
        // last component and never used
        T w[A][kGroupsP];
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int g = 0; g < kGroupsP; ++g)
            if (live[g])
              w[a][g] = __ldg(wk + static_cast<size_t>(min(a, D - 1)) * K + g * kThreads);
        for (int j0 = 0; j0 < D; j0 += A) {
#pragma unroll
          for (int a = 0; a < A; ++a) {
            const int j = j0 + a;
            if (j < D) {
              const Row<T, BT> x = load_row<T, BT>(f + j * BT);
#pragma unroll
              for (int g = 0; g < kGroupsP; ++g) {
                if (live[g]) {
#pragma unroll
                  for (int t = 0; t < BT; ++t) acc[g][t] += w[a][g] * x.v[t];
                }
              }
            }
            const T* wn = wk + static_cast<size_t>(min(j + A, D - 1)) * K;
#pragma unroll
            for (int g = 0; g < kGroupsP; ++g)
              if (live[g]) w[a][g] = __ldg(wn + g * kThreads);
          }
        }
        T tr[BT];
        trace_rows<T, BT>(f, d, tr);
#pragma unroll
        for (int g = 0; g < kGroupsP; ++g) {
          const int k = base + g * kThreads + tid;
          if (k < K) {
            Row<T, BT> cr;
#pragma unroll
            for (int t = 0; t < BT; ++t) {
              const T p = acc[g][t] < eps ? eps : acc[g][t];
              cr.v[t] = __ldg(f_tile + min(t, B - 1 - b0) * K + k) * tr[t] / p;
            }
            store_row<T, BT>(c + static_cast<size_t>(k) * BT, cr);
          }
        }
      }
      __syncthreads();

      // R_f = d H^T c; slot (slice s, group g) owns the quad of folded
      // components 4 g .. 4 g + 3 over rows [s slice, (s+1) slice) and
      // writes R unfolded, or its partial sums when split > 1
      for (int slot = thread_index(); slot < n_groups * split; slot += kThreads) {
        const int g = slot % n_groups, s = slot / n_groups;
        T acc[4][BT] = {};
        const int k_begin = s * slice, k_end = min(K, k_begin + slice);
        if (k_begin < k_end) {
          // the same ring over the rows of the slice; loads past its end
          // are clamped to its last row and never used
          const T* wg = h_d + 4 * g;
          Quad<T> w[A];
#pragma unroll
          for (int a = 0; a < A; ++a)
            w[a] = load_quad(wg + static_cast<size_t>(min(k_begin + a, k_end - 1)) * D);
          for (int k0 = k_begin; k0 < k_end; k0 += A) {
#pragma unroll
            for (int a = 0; a < A; ++a) {
              const int k = k0 + a;
              if (k < k_end) {
                const Row<T, BT> x = load_row<T, BT>(c + static_cast<size_t>(k) * BT);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                  for (int t = 0; t < BT; ++t) acc[i][t] += w[a].v[i] * x.v[t];
              }
              w[a] = load_quad(wg + static_cast<size_t>(min(k + A, k_end - 1)) * D);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Row<T, BT> o;
#pragma unroll
          for (int t = 0; t < BT; ++t) o.v[t] = acc[i][t];
          if (split > 1) {
            store_row<T, BT>(r_re + (static_cast<size_t>(s) * D + 4 * g + i) * BT, o);
          } else {
            store_unfolded<T, BT>(r_re, r_im, 4 * g + i, d, o);
          }
        }
      }
      __syncthreads();
      if (split > 1) {
        const int tid = thread_index();
        // every thread reads its partial sums before any thread writes R
        Row<T, BT> o = {};
        if (tid < D) {
          o = load_row<T, BT>(r_re + tid * BT);
          for (int s = 1; s < split; ++s) {
            const Row<T, BT> x = load_row<T, BT>(r_re + (static_cast<size_t>(s) * D + tid) * BT);
#pragma unroll
            for (int t = 0; t < BT; ++t) o.v[t] += x.v[t];
          }
        }
        __syncthreads();
        if (tid < D) store_unfolded<T, BT>(r_re, r_im, tid, d, o);
        __syncthreads();
      }

      // S = R t (complex, d x d, row-major over the vec index); entry (a, e)
      for (int idx = thread_index(); idx < D; idx += kThreads) {
        const int a = idx / d, e = idx % d;
        T accr[BT] = {}, acci[BT] = {};
#pragma unroll 1
        for (int m = 0; m < d; ++m) {
          const Row<T, BT> lr = load_row<T, BT>(r_re + (a * d + m) * BT);
          const Row<T, BT> li = load_row<T, BT>(r_im + (a * d + m) * BT);
          const Row<T, BT> hr = load_row<T, BT>(t_re + (m * d + e) * BT);
          const Row<T, BT> hi = load_row<T, BT>(t_im + (m * d + e) * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            accr[t] += lr.v[t] * hr.v[t] - li.v[t] * hi.v[t];
            acci[t] += lr.v[t] * hi.v[t] + li.v[t] * hr.v[t];
          }
        }
        Row<T, BT> o0, o1;
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          o0.v[t] = accr[t];
          o1.v[t] = acci[t];
        }
        store_row<T, BT>(s_re + idx * BT, o0);
        store_row<T, BT>(s_im + idx * BT, o1);
      }
      __syncthreads();

      // F = fold(S R): for a <= e, Re (S R)[a, e] = sum_m S_re R_re - S_im R_im;
      // for a > e, -Im (S R)[a, e] = -sum_m S_re R_im + S_im R_re
      for (int idx = thread_index(); idx < D; idx += kThreads) {
        const int a = idx / d, e = idx % d;
        const bool upper = a <= e;
        const T* h1 = upper ? r_re : r_im;
        const T* h2 = upper ? r_im : r_re;
        T acc1[BT] = {}, acc2[BT] = {};
#pragma unroll 1
        for (int m = 0; m < d; ++m) {
          const Row<T, BT> lr = load_row<T, BT>(s_re + (a * d + m) * BT);
          const Row<T, BT> li = load_row<T, BT>(s_im + (a * d + m) * BT);
          const Row<T, BT> x1 = load_row<T, BT>(h1 + (m * d + e) * BT);
          const Row<T, BT> x2 = load_row<T, BT>(h2 + (m * d + e) * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            acc1[t] += lr.v[t] * x1.v[t];
            acc2[t] += li.v[t] * x2.v[t];
          }
        }
        Row<T, BT> o;
#pragma unroll
        for (int t = 0; t < BT; ++t) o.v[t] = upper ? acc1[t] - acc2[t] : -(acc1[t] + acc2[t]);
        store_row<T, BT>(f + idx * BT, o);
      }
      __syncthreads();

      // F /= max(tr F, eps), and t unfolded from it: every thread reads the
      // diagonal before any thread rescales it
      T inv[BT];
      trace_rows<T, BT>(f, d, inv);
#pragma unroll
      for (int t = 0; t < BT; ++t) inv[t] = T(1) / (inv[t] < eps ? eps : inv[t]);
      __syncthreads();
      for (int i = thread_index(); i < D; i += kThreads) {
        Row<T, BT> o = load_row<T, BT>(f + i * BT);
#pragma unroll
        for (int t = 0; t < BT; ++t) o.v[t] *= inv[t];
        store_row<T, BT>(f + i * BT, o);
        store_unfolded<T, BT>(t_re, t_im, i, d, o);
      }
      __syncthreads();
    }

    // exit: b = F exit / d; bloch component j
    for (int j = tid; j < D; j += kThreads) {
      T acc[BT] = {};
#pragma unroll 4
      for (int i = 0; i < D; ++i) {
        const T w = __ldg(exit_map + static_cast<size_t>(i) * D + j);
        const Row<T, BT> x = load_row<T, BT>(f + i * BT);
#pragma unroll
        for (int t = 0; t < BT; ++t) acc[t] += w * x.v[t];
      }
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        if (b0 + t < B) out[static_cast<size_t>(b0 + t) * D + j] = acc[t] / T(d);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* freq, const T* bloch0, const T* hw_t, const T* h_d,
           const T* entry, const T* exit_map, T* out, T* scratch, int B, int K,
           int D, int d, int n_iter, int grid, void* stream) {
  constexpr int BT = TileOf<T>::value;
  const size_t smem =
      scratch != nullptr
          ? 0
          : sizeof(T) * BT * (static_cast<size_t>(K) + 7 * static_cast<size_t>(D));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rhor_mle_flat_kernel<T, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rhor_mle_flat_kernel<T, BT>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          freq, bloch0, hw_t, h_d, entry, exit_map, out, scratch, B, K, D, d,
          n_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Resamples per block for f32 (is_double = 0) or f64 (is_double = 1).
int rhor_mle_flat_tile(int is_double) {
  return is_double ? TileOf<double>::value : TileOf<float>::value;
}

// Largest dynamic shared memory a block may opt into on `device`, in bytes
// (negative: a CUDA error code).
int rhor_mle_flat_smem_limit(int device) {
  int value = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? value : -static_cast<int>(err);
}

const char* rhor_mle_flat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Every pointer is a device pointer; hw_t, h_d, entry and exit_map are the
// operands of kernels.py::_flat_fold_operands, h_d 16-byte aligned; `scratch`
// is null when the tile state fits in shared memory. Returns
// cudaGetLastError() after the launch.
int rhor_mle_flat_f32(const float* freq, const float* bloch0, const float* hw_t,
                      const float* h_d, const float* entry,
                      const float* exit_map, float* out, float* scratch, int B,
                      int K, int D, int d, int n_iter, int grid, void* stream) {
  return launch<float>(freq, bloch0, hw_t, h_d, entry, exit_map, out, scratch,
                       B, K, D, d, n_iter, grid, stream);
}

int rhor_mle_flat_f64(const double* freq, const double* bloch0,
                      const double* hw_t, const double* h_d,
                      const double* entry, const double* exit_map, double* out,
                      double* scratch, int B, int K, int D, int d, int n_iter,
                      int grid, void* stream) {
  return launch<double>(freq, bloch0, hw_t, h_d, entry, exit_map, out, scratch,
                        B, K, D, d, n_iter, grid, stream);
}

}  // extern "C"
