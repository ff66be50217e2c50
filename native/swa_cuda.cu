// swa_cuda: Smith-Waterman affine-gap database scoring for Hopper (sm_90a),
// called from JAX through the XLA FFI (seqalign/ops/swa_cuda.py).
//
// Decomposition: one thread per database record (inter-sequence, as in the
// reference's AVX2 kernel, src/alignment.c:47-187). Records are length-
// sorted on the host and dealt in groups of 32, one group per warp, so the
// lanes of a warp walk records of similar length. A group is stored
// position-major and lane-minor, db[(row_off[g] + j) * 32 + lane], the
// layout of native_io.pack_batch, so each position is one coalesced 32-byte
// read per warp.
//
// The query is cut into strips of R rows (R a compile-time constant). A
// thread keeps a strip's row state (Gg, E) in registers and walks every
// position of its record; the last row's (Gg, F) at each position is handed
// to the next strip through `bnd`, a global array with the database's own
// layout. There is therefore no query-length cap. Each warp stages its
// strip of the query profile in shared memory.
//
// Records longer than the host's cut (swa_cuda.LONG_RECORD) would make one
// thread's serial walk the whole kernel's critical path, so they go to a
// second kernel, sw_long_kernel: one warp per record, the lanes splitting
// the query's rows (R rows each) and sweeping the record as a wavefront,
// lane l at position t - l on step t, each lane's bottom row handed to the
// next lane by a shuffle. Longer queries take several passes, the last
// lane's bottom row handed to the next pass through `lbnd`. Both kernels
// write one output: long records first, then the groups' lanes. The long
// kernel runs on a second stream beside the group kernel, joined back
// before the call returns.
//
// Recurrence (the G-form, exact for go <= ge <= 0; see swa_cuda.py):
//   E  = max(E_left + ge, Gg_left)          one __viaddmax_s32
//   F  = max(F_up + ge, Gg_up)              one __viaddmax_s32
//   H' = Gg_diag + P'[i, c]                 P' = table - go
//   G  = max(H', E, F, 0)                   one __vimax3_s32_relu
//   Gg = G + go
// and the score is max(0, max H') over the record's real cells: positions
// past a record's end and profile rows past the query's end (P' = -2^29)
// never reach it. All arithmetic is int32.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <unordered_map>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kLanes = 32;          // records per group (one warp)
constexpr int kWarps = 4;           // warps per block
constexpr int32_t kNeg = -(1 << 29);
constexpr unsigned kFull = 0xffffffffu;

template <int R>
__global__ void __launch_bounds__(kWarps * kLanes)
sw_score_kernel(const int32_t* __restrict__ prof,   // (nstrips, 32, R)
                const int8_t* __restrict__ db,      // (rows, 32)
                const int32_t* __restrict__ row_off,  // (ngroups + 1,)
                const int32_t* __restrict__ lens,   // (ngroups * 32,)
                int32_t* __restrict__ out,          // (ngroups * 32,)
                int2* __restrict__ bnd,             // (rows * 32,) or unused
                int ngroups, int nstrips, int32_t go, int32_t ge) {
  // Stride R + 1: lanes reading row k for different residues c hit
  // different banks.
  __shared__ int32_t sprof[kWarps][32 * (R + 1)];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= ngroups) return;  // whole warp leaves together

  const int64_t r0 = row_off[g];
  const int L = row_off[g + 1] - static_cast<int>(r0);
  const int len = lens[static_cast<int64_t>(g) * kLanes + lane];
  const int8_t* d = db + r0 * kLanes + lane;
  int2* b = bnd + r0 * kLanes + lane;
  int32_t* sp = sprof[warp];

  int32_t best = 0;
  for (int s = 0; s < nstrips; ++s) {
    __syncwarp();
    const int32_t* ps = prof + static_cast<int64_t>(s) * 32 * R;
    for (int t = lane; t < 32 * R; t += kLanes) {
      sp[(t / R) * (R + 1) + t % R] = ps[t];
    }
    __syncwarp();
    const bool first = s == 0;
    const bool last = s == nstrips - 1;

    int32_t gg[R], e[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      gg[k] = go;
      e[k] = kNeg;
    }
    int32_t diag_top = go;  // Gg of the row above the strip at j - 1
    for (int j = 0; j < L; ++j) {
      const int c = d[static_cast<int64_t>(j) * kLanes];
      const int32_t* pc = sp + c * (R + 1);
      int32_t above = go, f = kNeg;
      if (!first) {
        const int2 v = b[static_cast<int64_t>(j) * kLanes];
        above = v.x;
        f = v.y;
      }
      int32_t diag = diag_top;
      diag_top = above;
      int32_t cb = kNeg;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int32_t h = diag + pc[k];
        diag = gg[k];
        e[k] = __viaddmax_s32(e[k], ge, gg[k]);
        f = __viaddmax_s32(f, ge, above);
        gg[k] = __vimax3_s32_relu(h, e[k], f) + go;
        above = gg[k];
        cb = max(cb, h);
      }
      if (j < len) best = max(best, cb);
      if (!last) b[static_cast<int64_t>(j) * kLanes] = make_int2(above, f);
    }
  }
  out[static_cast<int64_t>(g) * kLanes + lane] = best;
}

// One warp per long record; lane l owns rows [l * R, l * R + R) of each
// pass of 32 * R query rows. The same G-form, rearranged so that F's
// serial chain down the rows is one instruction per row:
//   X  = max(H', E, 0) + go
//   Gg = max(F + go, X)          (= G + go)
//   F' = max(F + ge, X)          (F of the next row: F + go <= F + ge)
// A lane receives the (Gg, F') of the row above its first row; pass
// boundaries store the same pair.
template <int R>
__global__ void __launch_bounds__(kLanes)
sw_long_kernel(const int32_t* __restrict__ prof,  // (npasses, 32 * R, 32)
               const int8_t* __restrict__ db,     // records, back to back
               const int32_t* __restrict__ off,   // (nlong + 1,)
               int32_t* __restrict__ out,         // (nlong,)
               int2* __restrict__ bnd,            // (db size,) or unused
               int npasses, int32_t go, int32_t ge) {
  // Row-major with stride 33: row k of lane l at (l * R + k) * 33 + c.
  __shared__ int32_t sprof[kLanes * R * 33];
  const int lane = threadIdx.x;
  const int r = blockIdx.x;
  const int32_t o = off[r];
  const int L = off[r + 1] - o;
  const int8_t* d = db + o;
  int2* b = bnd + o;
  const int32_t* pl = sprof + lane * R * 33;

  int32_t best = 0;
  for (int s = 0; s < npasses && L > 0; ++s) {
    __syncwarp();
    const int32_t* ps = prof + static_cast<int64_t>(s) * kLanes * R * 32;
    for (int t = lane; t < kLanes * R * 32; t += kLanes) {
      sprof[(t >> 5) * 33 + (t & 31)] = ps[t];
    }
    __syncwarp();
    const bool first = s == 0;
    const bool last = s == npasses - 1;

    int32_t gg[R], e[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      gg[k] = go;
      e[k] = kNeg;
    }
    int32_t diag_top = go, bot_g = go, bot_f = go;
    int cur = d[0];  // the residue of the lane's next position
    for (int t = 0; t < L + kLanes - 1; ++t) {
      int32_t above = __shfl_up_sync(kFull, bot_g, 1);
      int32_t f = __shfl_up_sync(kFull, bot_f, 1);
      const int j = t - lane;
      if (lane == 0) {
        above = go;  // row -1 of the matrix: G = 0
        f = go;
        if (!first && j < L) {
          const int2 v = b[j];
          above = v.x;
          f = v.y;
        }
      }
      if (j >= 0 && j < L) {
        const int32_t* pc = pl + cur;
        if (j + 1 < L) cur = d[j + 1];  // prefetch for the next step
        int32_t diag = diag_top;
        diag_top = above;
        int32_t cb = kNeg;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int32_t h = diag + pc[k * 33];
          diag = gg[k];
          e[k] = __viaddmax_s32(e[k], ge, gg[k]);
          const int32_t x = __vimax_s32_relu(h, e[k]) + go;
          gg[k] = __viaddmax_s32(f, go, x);
          f = __viaddmax_s32(f, ge, x);
          cb = max(cb, h);
        }
        best = max(best, cb);
        bot_g = gg[R - 1];
        bot_f = f;
        if (lane == kLanes - 1 && !last) b[j] = make_int2(bot_g, bot_f);
      }
    }
  }
  for (int m = kLanes / 2; m > 0; m >>= 1) {
    best = max(best, __shfl_xor_sync(kFull, best, m));
  }
  if (lane == 0) out[r] = best;
}

template <int R>
cudaError_t launch(cudaStream_t stream, const int32_t* prof, const int8_t* db,
                   const int32_t* row_off, const int32_t* lens, int32_t* out,
                   int2* bnd, int ngroups, int nstrips, int32_t go,
                   int32_t ge) {
  const int blocks = (ngroups + kWarps - 1) / kWarps;
  sw_score_kernel<R><<<blocks, kWarps * kLanes, 0, stream>>>(
      prof, db, row_off, lens, out, bnd, ngroups, nstrips, go, ge);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_long(cudaStream_t stream, const int32_t* prof,
                        const int8_t* db, const int32_t* off, int32_t* out,
                        int2* bnd, int nlong, int npasses, int32_t go,
                        int32_t ge) {
  sw_long_kernel<R><<<nlong, kLanes, 0, stream>>>(prof, db, off, out, bnd,
                                                  npasses, go, ge);
  return cudaGetLastError();
}

// One side stream per device, with the events that fork it from and join
// it to XLA's stream. Created at first use and kept for the process.
struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr;
  cudaEvent_t join = nullptr;
};

std::mutex side_mu;  // held while a call forks and joins its side stream
std::unordered_map<int, SideStream> sides;

cudaError_t side_stream(SideStream** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  SideStream& s = sides[dev];
  if (s.join == nullptr) {
    SideStream made;
    if ((err = cudaStreamCreateWithFlags(&made.stream,
                                         cudaStreamNonBlocking)) ||
        (err = cudaEventCreateWithFlags(&made.fork,
                                        cudaEventDisableTiming)) ||
        (err = cudaEventCreateWithFlags(&made.join,
                                        cudaEventDisableTiming))) {
      return err;
    }
    s = made;
  }
  *out = &s;
  return cudaSuccess;
}

ffi::Error SwScoreImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> prof,
                       ffi::Buffer<ffi::S32> lprof, ffi::Buffer<ffi::S8> db,
                       ffi::Buffer<ffi::S32> row_off,
                       ffi::Buffer<ffi::S32> lens, ffi::Buffer<ffi::S8> ldb,
                       ffi::Buffer<ffi::S32> loff,
                       ffi::ResultBuffer<ffi::S32> out,
                       ffi::ResultBuffer<ffi::S32> bnd,
                       ffi::ResultBuffer<ffi::S32> lbnd, int32_t go,
                       int32_t ge) {
  const auto pd = prof.dimensions();
  const auto ld = lprof.dimensions();
  if (pd.size() != 3 || pd[1] != 32) {
    return ffi::Error::InvalidArgument("profile must be (nstrips, 32, R)");
  }
  if (ld.size() != 3 || ld[1] % kLanes != 0 || ld[2] != 32) {
    return ffi::Error::InvalidArgument(
        "long profile must be (npasses, 32 * R, 32)");
  }
  const int nstrips = static_cast<int>(pd[0]);
  const int rows = static_cast<int>(pd[2]);
  const int npasses = static_cast<int>(ld[0]);
  const int lrows = static_cast<int>(ld[1]) / kLanes;
  const int ngroups = static_cast<int>(row_off.element_count()) - 1;
  const int nlong = static_cast<int>(loff.element_count()) - 1;
  if (ngroups < 0 || nlong < 0 ||
      lens.element_count() != size_t(ngroups) * kLanes ||
      out->element_count() != size_t(nlong) + lens.element_count()) {
    return ffi::Error::InvalidArgument("group table shapes disagree");
  }
  if (nstrips > 1 && bnd->element_count() < 2 * db.element_count()) {
    return ffi::Error::InvalidArgument("boundary scratch too small");
  }
  if (npasses > 1 && lbnd->element_count() < 2 * ldb.element_count()) {
    return ffi::Error::InvalidArgument("long boundary scratch too small");
  }
  if (lrows < 1 || lrows > 8) {
    return ffi::Error::InvalidArgument("unsupported long pass height");
  }
  cudaError_t err = cudaSuccess;
  std::lock_guard<std::mutex> lock(side_mu);
  SideStream* side = nullptr;
  cudaStream_t lstream = stream;
  if (nlong > 0 && ngroups > 0) {
    if ((err = side_stream(&side)) ||
        (err = cudaEventRecord(side->fork, stream)) ||
        (err = cudaStreamWaitEvent(side->stream, side->fork, 0))) {
      return ffi::Error::Internal(cudaGetErrorString(err));
    }
    lstream = side->stream;
  }
  if (nlong > 0) {
    int2* lp = reinterpret_cast<int2*>(lbnd->typed_data());
#define SW_LONG(RR)                                                         \
  case RR:                                                                  \
    err = launch_long<RR>(lstream, lprof.typed_data(), ldb.typed_data(),    \
                          loff.typed_data(), out->typed_data(), lp, nlong,  \
                          npasses, go, ge);                                 \
    break;
    switch (lrows) {
      SW_LONG(1)
      SW_LONG(2)
      SW_LONG(3)
      SW_LONG(4)
      SW_LONG(5)
      SW_LONG(6)
      SW_LONG(7)
      SW_LONG(8)
      default:
        return ffi::Error::InvalidArgument("unsupported long pass height");
    }
#undef SW_LONG
    if (err != cudaSuccess) {
      return ffi::Error::Internal(cudaGetErrorString(err));
    }
  }
  if (ngroups == 0) return ffi::Error::Success();
  int2* bp = reinterpret_cast<int2*>(bnd->typed_data());
  int32_t* gout = out->typed_data() + nlong;
#define SW_CASE(RR)                                                         \
  case RR:                                                                  \
    err = launch<RR>(stream, prof.typed_data(), db.typed_data(),            \
                     row_off.typed_data(), lens.typed_data(), gout, bp,     \
                     ngroups, nstrips, go, ge);                             \
    break;
  switch (rows) {
    SW_CASE(4)
    SW_CASE(8)
    SW_CASE(12)
    SW_CASE(16)
    SW_CASE(20)
    SW_CASE(24)
    SW_CASE(28)
    SW_CASE(32)
    SW_CASE(48)
    default:
      return ffi::Error::InvalidArgument("unsupported strip height");
  }
#undef SW_CASE
  if (side != nullptr && err == cudaSuccess) {
    if ((err = cudaEventRecord(side->join, side->stream)) == cudaSuccess) {
      err = cudaStreamWaitEvent(stream, side->join, 0);
    }
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SwScore, SwScoreImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // prof
                                  .Arg<ffi::Buffer<ffi::S32>>()  // lprof
                                  .Arg<ffi::Buffer<ffi::S8>>()   // db
                                  .Arg<ffi::Buffer<ffi::S32>>()  // row_off
                                  .Arg<ffi::Buffer<ffi::S32>>()  // lens
                                  .Arg<ffi::Buffer<ffi::S8>>()   // ldb
                                  .Arg<ffi::Buffer<ffi::S32>>()  // loff
                                  .Ret<ffi::Buffer<ffi::S32>>()  // out
                                  .Ret<ffi::Buffer<ffi::S32>>()  // bnd
                                  .Ret<ffi::Buffer<ffi::S32>>()  // lbnd
                                  .Attr<int32_t>("go")
                                  .Attr<int32_t>("ge"));
