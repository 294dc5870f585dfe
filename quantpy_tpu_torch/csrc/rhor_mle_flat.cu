// Flat-matrix RrhoR maximum-likelihood iteration for Hopper (sm_90a).
//
// Replaces quantpy_tpu/ops/kernels.py::rhor_mle_pallas_flat (body
// _rhor_kernel_flat): the same fixed point as rhor_mle.cu, but the loop state
// is the transposed density-matrix pair t = (t_re, t_im) instead of the bloch
// vector, so the Pauli transfer matrix (PTM) is applied only at entry and at
// exit. With K POVM rows, D = 4^n, d = 2^n, G = [G_re | G_im] (K, 2D) where
// G_x = w2 PTM_x^T / d, per iteration and resample:
//
//   p  = G [t_re; t_im]           (K x 2D matvec)
//   tr = sum_a t_re[a (d + 1)]    (the diagonal, d terms)
//   c  = f tr / max(p, 1e-10)
//   [R_re; R_im] = d G^T c        (2D x K matvec)
//   S = R t, U = S R              (two complex d x d products)
//   t = U / max(tr U_re, 1e-10)
//
// and at exit b = (PTM_re^T t_re + PTM_im^T t_im) / d. The TPU kernel gets tr
// from an extra trace-mask row of G (with f zero there); here it is a d-term
// diagonal sum, so no mask row exists and nothing can leak into R.
//
// What bounds it on this card. At the flagship size (n = 4: K = 1296,
// D = 256, d = 16) one resample-iteration is 4 K D = 1,327,104 MACs for the
// two POVM products and 8 d^3 = 32,768 for the sandwich: 1.26x the MACs of
// rhor_mle.cu (2 K D + 6 D^2), not fewer. G and G^T (2.65 MB each in f32) are
// the same for every resample and stay resident in L2. Each value of G read
// from L2 feeds BT multiply-adds, and so does each shared-memory row load (two
// 16-byte broadcasts in f32). On an H100 80GB HBM3 at 700 W a 16,384-resample
// call of 60 iterations takes about 205 ms in f32 (13 TFLOP/s, a fifth of the
// FP32 peak), and the two POVM stages bind it through the rate of
// shared-memory loads, not L2: doubling BT (half the L2 reads per FMA) was no
// faster, while two output rows per thread (half the shared-memory loads per
// FMA, the same FMAs and L2 reads) was 26% faster.
//
// What the design does about it. As in rhor_mle.cu: one block of 256 threads
// owns a tile of BT resamples (BT = 32 bytes / sizeof(T): 8 in f32, 4 in f64)
// and runs all iterations in a loop. The tile's state (t, R, S: 2D rows each;
// c: K rows; K + 6 D rows of BT values) lives in shared memory, stored
// resample-minor so that one 32-byte load fetches a row for the whole tile
// and every thread keeps BT accumulators in registers. Each stage gives every
// thread whole output rows, reads G or G^T coalesced and ends at
// __syncthreads(); the traces are summed by every thread from the diagonal
// rows (d broadcast loads), which costs no barrier. Arithmetic is plain
// FP32/FP64 FMA on the CUDA cores: no tensor cores and no TF32. When the
// state does not fit in shared memory (n >= 5), the caller passes a global
// scratch buffer of gridDim.x tiles instead and the same code runs through
// generic pointers. The ragged tail of the batch is masked: its rows read the
// last resample's inputs and are never stored.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

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

// tr(X) for each resample of the tile: the d diagonal rows of X's real part.
template <typename T, int BT>
__device__ __forceinline__ void trace_rows(const T* x, int d, T (&tr)[BT]) {
#pragma unroll
  for (int t = 0; t < BT; ++t) tr[t] = T(0);
  for (int a = 0; a < d; ++a) {
    const Row<T, BT> r = load_row<T, BT>(x + a * (d + 1) * BT);
#pragma unroll
    for (int t = 0; t < BT; ++t) tr[t] += r.v[t];
  }
}

// Y = L H for complex d x d matrices (row-major over the vec index), one
// output entry (a, e) per idx; L, H, Y are (re, im) pairs of D-row blocks.
template <typename T, int BT>
__device__ __forceinline__ void complex_product(const T* lre, const T* lim,
                                                const T* hre, const T* him,
                                                T* yre, T* yim, int D, int d) {
  for (int idx = threadIdx.x; idx < D; idx += kThreads) {
    const int a = idx / d, e = idx % d;
    T accr[BT] = {}, acci[BT] = {};
    for (int m = 0; m < d; ++m) {
      const Row<T, BT> lr = load_row<T, BT>(lre + (a * d + m) * BT);
      const Row<T, BT> li = load_row<T, BT>(lim + (a * d + m) * BT);
      const Row<T, BT> hr = load_row<T, BT>(hre + (m * d + e) * BT);
      const Row<T, BT> hi = load_row<T, BT>(him + (m * d + e) * BT);
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
    store_row<T, BT>(yre + idx * BT, o0);
    store_row<T, BT>(yim + idx * BT, o1);
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
rhor_mle_flat_kernel(const T* __restrict__ freq,      // (B, K)
                     const T* __restrict__ bloch0,    // (B, D)
                     const T* __restrict__ g,         // (K, 2D) [G_re | G_im]
                     const T* __restrict__ gt,        // (2D, K) G^T
                     const T* __restrict__ ptm_re,    // (D, D)
                     const T* __restrict__ ptm_im,    // (D, D)
                     const T* __restrict__ ptm_re_t,  // (D, D)
                     const T* __restrict__ ptm_im_t,  // (D, D)
                     T* __restrict__ out,             // (B, D)
                     T* __restrict__ scratch,         // null, or gridDim.x tiles
                     int B, int K, int D, int d, int n_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t tile_len = static_cast<size_t>(BT) * (K + 6 * static_cast<size_t>(D));
  T* ws = scratch != nullptr ? scratch + blockIdx.x * tile_len
                             : reinterpret_cast<T*>(smem_raw);
  const size_t rows_d = static_cast<size_t>(D) * BT;
  const int D2 = 2 * D;
  T* t_re = ws;                  // (2D, BT) the state: t_re rows, then t_im
  T* t_im = t_re + rows_d;
  T* r_re = t_im + rows_d;       // (2D, BT) R
  T* r_im = r_re + rows_d;
  T* s_re = r_im + rows_d;       // (2D, BT) bloch0 at entry, then S
  T* s_im = s_re + rows_d;
  T* c = s_im + rows_d;          // (K, BT) f tr / max(p, eps)

  const T eps = T(1e-10);
  const int tid = threadIdx.x;
  const int n_tiles = (B + BT - 1) / BT;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b0 = tile * BT;
    for (int idx = tid; idx < D * BT; idx += kThreads) {
      const int t = idx / D, j = idx % D;
      const int row = min(b0 + t, B - 1);
      s_re[j * BT + t] = bloch0[static_cast<size_t>(row) * D + j];
    }
    __syncthreads();

    // entry: t = (PTM_re b0, PTM_im b0); vec index i
    for (int i = tid; i < D; i += kThreads) {
      T xr[BT] = {}, xi[BT] = {};
#pragma unroll 2
      for (int j = 0; j < D; ++j) {
        const T pr = __ldg(ptm_re_t + static_cast<size_t>(j) * D + i);
        const T pi = __ldg(ptm_im_t + static_cast<size_t>(j) * D + i);
        const Row<T, BT> x = load_row<T, BT>(s_re + j * BT);
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          xr[t] += pr * x.v[t];
          xi[t] += pi * x.v[t];
        }
      }
      Row<T, BT> o0, o1;
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        o0.v[t] = xr[t];
        o1.v[t] = xi[t];
      }
      store_row<T, BT>(t_re + i * BT, o0);
      store_row<T, BT>(t_im + i * BT, o1);
    }
    __syncthreads();

    for (int it = 0; it < n_iter; ++it) {
      // p = G t and c = f tr / max(p, eps); thread owns POVM rows k
      T tr[BT];
      trace_rows<T, BT>(t_re, d, tr);
      for (int k = tid; k < K; k += kThreads) {
        T acc[BT] = {};
#pragma unroll 4
        for (int i = 0; i < D2; ++i) {
          const T w = __ldg(gt + static_cast<size_t>(i) * K + k);
          const Row<T, BT> x = load_row<T, BT>(t_re + i * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) acc[t] += w * x.v[t];
        }
        Row<T, BT> cr;
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          const int row = min(b0 + t, B - 1);
          const T p = acc[t] < eps ? eps : acc[t];
          cr.v[t] = __ldg(freq + static_cast<size_t>(row) * K + k) * tr[t] / p;
        }
        store_row<T, BT>(c + static_cast<size_t>(k) * BT, cr);
      }
      __syncthreads();

      // [R_re; R_im] = d G^T c; thread owns rows i of the stacked pair
      for (int i = tid; i < D2; i += kThreads) {
        T acc[BT] = {};
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const T w = __ldg(g + static_cast<size_t>(k) * D2 + i);
          const Row<T, BT> x = load_row<T, BT>(c + static_cast<size_t>(k) * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) acc[t] += w * x.v[t];
        }
        Row<T, BT> rr;
#pragma unroll
        for (int t = 0; t < BT; ++t) rr.v[t] = T(d) * acc[t];
        store_row<T, BT>(r_re + i * BT, rr);
      }
      __syncthreads();

      // S = R t, then U = S R into t
      complex_product<T, BT>(r_re, r_im, t_re, t_im, s_re, s_im, D, d);
      __syncthreads();
      complex_product<T, BT>(s_re, s_im, r_re, r_im, t_re, t_im, D, d);
      __syncthreads();

      // t = U / max(tr U_re, eps): every thread reads the diagonal before
      // any thread rescales it
      T inv[BT];
      trace_rows<T, BT>(t_re, d, inv);
#pragma unroll
      for (int t = 0; t < BT; ++t) inv[t] = T(1) / (inv[t] < eps ? eps : inv[t]);
      __syncthreads();
      for (int i = tid; i < D2; i += kThreads) {
        Row<T, BT> o = load_row<T, BT>(t_re + i * BT);
#pragma unroll
        for (int t = 0; t < BT; ++t) o.v[t] *= inv[t];
        store_row<T, BT>(t_re + i * BT, o);
      }
      __syncthreads();
    }

    // exit: b = (PTM_re^T t_re + PTM_im^T t_im) / d; bloch component j
    for (int j = tid; j < D; j += kThreads) {
      T acc[BT] = {};
#pragma unroll 2
      for (int i = 0; i < D; ++i) {
        const T pr = __ldg(ptm_re + static_cast<size_t>(i) * D + j);
        const T pi = __ldg(ptm_im + static_cast<size_t>(i) * D + j);
        const Row<T, BT> xr = load_row<T, BT>(t_re + i * BT);
        const Row<T, BT> xi = load_row<T, BT>(t_im + i * BT);
#pragma unroll
        for (int t = 0; t < BT; ++t) acc[t] += pr * xr.v[t] + pi * xi.v[t];
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
int launch(const T* freq, const T* bloch0, const T* g, const T* gt,
           const T* ptm_re, const T* ptm_im, const T* ptm_re_t,
           const T* ptm_im_t, T* out, T* scratch, int B, int K, int D, int d,
           int n_iter, int grid, void* stream) {
  constexpr int BT = TileOf<T>::value;
  const size_t smem =
      scratch != nullptr
          ? 0
          : sizeof(T) * BT * (static_cast<size_t>(K) + 6 * static_cast<size_t>(D));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rhor_mle_flat_kernel<T, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rhor_mle_flat_kernel<T, BT>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          freq, bloch0, g, gt, ptm_re, ptm_im, ptm_re_t, ptm_im_t, out, scratch,
          B, K, D, d, n_iter);
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

// Every pointer is a device pointer; `scratch` is null when the tile state
// fits in shared memory. Returns cudaGetLastError() after the launch.
int rhor_mle_flat_f32(const float* freq, const float* bloch0, const float* g,
                      const float* gt, const float* ptm_re, const float* ptm_im,
                      const float* ptm_re_t, const float* ptm_im_t, float* out,
                      float* scratch, int B, int K, int D, int d, int n_iter,
                      int grid, void* stream) {
  return launch<float>(freq, bloch0, g, gt, ptm_re, ptm_im, ptm_re_t, ptm_im_t,
                       out, scratch, B, K, D, d, n_iter, grid, stream);
}

int rhor_mle_flat_f64(const double* freq, const double* bloch0, const double* g,
                      const double* gt, const double* ptm_re,
                      const double* ptm_im, const double* ptm_re_t,
                      const double* ptm_im_t, double* out, double* scratch,
                      int B, int K, int D, int d, int n_iter, int grid,
                      void* stream) {
  return launch<double>(freq, bloch0, g, gt, ptm_re, ptm_im, ptm_re_t,
                        ptm_im_t, out, scratch, B, K, D, d, n_iter, grid,
                        stream);
}

}  // extern "C"
