// Row-sweep parse commit (matcher._parse_rows_xla) as three CUDA kernels,
// called from JAX through the XLA FFI as "zzflate_parse_rows".
//
// step (B, npad) int32 in [1, 258], npad = rows_per * row; starts (B,).
// The walk next[q] = q + step[q] from each chunk's start is cut into rows
// of `row` positions, one thread per row:
//   exit_sweep   P1: exit[p] = first landing at/after p's row end when
//                walking from p, by one reverse pass over the row held in
//                shared memory (flat-absolute positions out);
//   entry_chain  P2: one thread per chunk follows exit[] across its rows
//                from the start (the exit of row r lands in row r + 1,
//                because row > 258);
//   mark_walk    P3: every row walks forward from its entry, marking the
//                committed positions.
// Results: mark (B, npad) uint8 (1 = committed), plus exit (B, npad) and
// entries (B, rows_per) as scratch. Identical to the XLA sweeps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I<jax.ffi.include_dir()> parse_rows.cu
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kRows = 32;      // rows (threads that sweep) per block
constexpr int kThreads = 128;  // threads that stage rows through shared

// Shared layout [j][t]: column t is one row, so the rows' threads touch
// consecutive 16-bit words at every step.
__device__ void load_steps(const int32_t* step, uint16_t* st, int64_t lane0,
                           int nrows, int row) {
  const int32_t* src = step + lane0 * row;
  for (int i = threadIdx.x; i < nrows * row; i += blockDim.x) {
    int t = i / row;
    int j = i - t * row;
    st[j * kRows + t] = static_cast<uint16_t>(src[i]);
  }
}

__global__ void exit_sweep(const int32_t* step, int32_t* exit_, int row,
                           int lanes) {
  extern __shared__ uint16_t smem[];
  uint16_t* st = smem;
  uint16_t* ex = smem + row * kRows;
  int64_t lane0 = static_cast<int64_t>(blockIdx.x) * kRows;
  int nrows = min(kRows, static_cast<int>(lanes - lane0));
  load_steps(step, st, lane0, nrows, row);
  __syncthreads();
  int t = threadIdx.x;
  if (t < nrows) {
    for (int j = row - 1; j >= 0; --j) {
      int land = j + st[j * kRows + t];
      ex[j * kRows + t] =
          static_cast<uint16_t>(land >= row ? land : ex[land * kRows + t]);
    }
  }
  __syncthreads();
  int32_t* dst = exit_ + lane0 * row;
  for (int i = threadIdx.x; i < nrows * row; i += blockDim.x) {
    int r = i / row;
    int j = i - r * row;
    dst[i] = static_cast<int32_t>((lane0 + r) * row) + ex[j * kRows + r];
  }
}

__global__ void entry_chain(const int32_t* exit_, const int32_t* starts,
                            int32_t* entries, int row, int rows_per,
                            int npad, int bch) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= bch) return;
  const int32_t sink = bch * npad;
  int s = starts[b];
  int r0 = s / row;
  int32_t e = b * npad + s;
  for (int r = 0; r < rows_per; ++r) {
    int32_t cur = r >= r0 ? e : sink;
    entries[b * rows_per + r] = cur;
    if (r >= r0) e = exit_[cur];
  }
}

__global__ void mark_walk(const int32_t* step, const int32_t* entries,
                          uint8_t* mark, int row, int lanes, int nflat) {
  extern __shared__ uint16_t smem[];
  uint16_t* st = smem;
  uint8_t* mk = reinterpret_cast<uint8_t*>(smem + row * kRows);
  int64_t lane0 = static_cast<int64_t>(blockIdx.x) * kRows;
  int nrows = min(kRows, static_cast<int>(lanes - lane0));
  load_steps(step, st, lane0, nrows, row);
  for (int i = threadIdx.x; i < row * kRows; i += blockDim.x) mk[i] = 0;
  __syncthreads();
  int t = threadIdx.x;
  if (t < nrows) {
    int32_t pos = entries[lane0 + t];
    if (pos < nflat) {
      int j = static_cast<int>(pos - (lane0 + t) * row);
      while (j < row) {
        mk[j * kRows + t] = 1;
        j += st[j * kRows + t];
      }
    }
  }
  __syncthreads();
  uint8_t* dst = mark + lane0 * row;
  for (int i = threadIdx.x; i < nrows * row; i += blockDim.x) {
    int r = i / row;
    int j = i - r * row;
    dst[i] = mk[j * kRows + r];
  }
}

ffi::Error ParseRowsImpl(cudaStream_t stream, int32_t device,
                         ffi::Buffer<ffi::S32> step,
                         ffi::Buffer<ffi::S32> starts,
                         ffi::ResultBuffer<ffi::U8> mark,
                         ffi::ResultBuffer<ffi::S32> exit_,
                         ffi::ResultBuffer<ffi::S32> entries, int64_t row) {
  auto dims = step.dimensions();
  if (dims.size() != 2 || row <= 258 || dims[1] % row) {
    return ffi::Error::InvalidArgument(
        "parse_rows: step must be (B, npad) with npad a multiple of row > 258");
  }
  const int bch = static_cast<int>(dims[0]);
  const int npad = static_cast<int>(dims[1]);
  const int r = static_cast<int>(row);
  const int rows_per = npad / r;
  const int lanes = bch * rows_per;
  const int blocks = (lanes + kRows - 1) / kRows;
  const size_t smem_exit = 2 * sizeof(uint16_t) * r * kRows;
  const size_t smem_mark = (sizeof(uint16_t) + 1) * r * kRows;
  // With several cards in one process, XLA calls this from each card's
  // own thread, whose current device need not be that card. The shared
  // memory attributes are per device and the launches must go to the
  // device that owns `stream`, so select it first.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  cudaFuncSetAttribute(exit_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_exit));
  cudaFuncSetAttribute(mark_walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_mark));
  exit_sweep<<<blocks, kThreads, smem_exit, stream>>>(
      step.typed_data(), exit_->typed_data(), r, lanes);
  entry_chain<<<(bch + 31) / 32, 32, 0, stream>>>(
      exit_->typed_data(), starts.typed_data(), entries->typed_data(), r,
      rows_per, npad, bch);
  mark_walk<<<blocks, kThreads, smem_mark, stream>>>(
      step.typed_data(), entries->typed_data(), mark->typed_data(), r, lanes,
      bch * npad);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ZzParseRows, ParseRowsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Ctx<ffi::DeviceOrdinal>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int64_t>("row"));
