// Host-side helpers of the port's data pipeline (a copy of the JAX
// package's native/mxnet_tpu_native.cc).
//
// The reference's C++ IO stack in two pieces: dmlc RecordIO framing
// (reference: 3rdparty/dmlc-core/include/dmlc/recordio.h,
// src/recordio.cc) and the image pipeline's uint8 HWC -> normalized float
// CHW conversion (reference: src/io/image_aug_default.cc,
// iter_image_recordio_2.cc). This is g++ host code, not a device kernel:
// mxnet_tpu_torch/native/__init__.py builds it at first use with
// g++ -O3 -fopenmp (retried without -fopenmp) into build/torch_kernels/.
//
// ABI: plain extern "C", called through ctypes.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {
constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLengthMask = (1u << 29) - 1;
inline uint32_t load_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
}  // namespace

extern "C" {

// Scan a whole .rec buffer and emit logical-record (start, payload_size)
// pairs; multi-part records (cflag 1/2/3) collapse into one logical record
// whose size is the sum of part payloads. Returns the record count, or
// -1 on a corrupt magic, -2 when out capacity is exhausted.
int64_t mxtpu_recordio_index(const uint8_t* buf, int64_t n,
                             int64_t* starts, int64_t* sizes,
                             int64_t max_records) {
  int64_t pos = 0, count = 0;
  int64_t cur_start = -1, cur_size = 0;
  while (pos + 8 <= n) {
    if (load_u32(buf + pos) != kMagic) return -1;
    const uint32_t lrec = load_u32(buf + pos + 4);
    const uint32_t cflag = (lrec >> 29) & 7u;
    const uint32_t length = lrec & kLengthMask;
    const int64_t payload = pos + 8;
    if (payload + length > n) break;  // truncated tail: stop cleanly
    const int64_t padded = (length + 3u) & ~3llu;
    if (cflag == 0 || cflag == 1) {   // start of a logical record
      cur_start = pos;
      cur_size = length;
    } else {
      cur_size += length;
    }
    if (cflag == 0 || cflag == 3) {   // end of a logical record
      if (count == max_records) return -2;
      starts[count] = cur_start;
      sizes[count] = cur_size;
      ++count;
    }
    pos = payload + padded;
  }
  return count;
}

// Fused uint8 HWC -> float32 CHW normalize: dst[c][h][w] =
// (src[h][w][c]/255 - mean[c]) / std[c]. One pass, no numpy temporaries
// (reference pipeline: image_aug_default.cc TensorRGB conversion).
void mxtpu_img_to_chw_norm(const uint8_t* src, int64_t h, int64_t w,
                           int64_t c, const float* mean, const float* stdv,
                           float* dst) {
  const int64_t plane = h * w;
  for (int64_t ch = 0; ch < c; ++ch) {
    const float m = mean ? mean[ch] : 0.0f;
    const float inv = 1.0f / (stdv ? stdv[ch] : 1.0f);
    float* out = dst + ch * plane;
    const uint8_t* in = src + ch;
    for (int64_t i = 0; i < plane; ++i) {
      out[i] = ((in[i * c] * (1.0f / 255.0f)) - m) * inv;
    }
  }
}

// Batch variant, OpenMP across images (reference: the decode thread pool of
// ImageRecordIOParser2). src is B contiguous HWC uint8 images.
void mxtpu_batch_to_chw_norm(const uint8_t* src, int64_t b, int64_t h,
                             int64_t w, int64_t c, const float* mean,
                             const float* stdv, float* dst) {
  const int64_t in_stride = h * w * c;
  const int64_t out_stride = c * h * w;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < b; ++i) {
    mxtpu_img_to_chw_norm(src + i * in_stride, h, w, c, mean, stdv,
                          dst + i * out_stride);
  }
}

int mxtpu_version() { return 1; }

}  // extern "C"
