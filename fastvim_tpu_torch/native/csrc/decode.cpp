// Native JPEG decode fused with the augment pipeline: PIL's decode is a
// single-core bottleneck of the host loader, so libjpeg-turbo decode +
// crop/flip/resize/normalize run here in one threaded native call per
// batch, with the GIL released. The decode library: this file alone,
// linked with -ljpeg (libjpeg-turbo's jpeg_skip_scanlines and
// jpeg_crop_scanline are needed).
//
// Uses libjpeg's DCT scaling (scale_num/8) to decode at the smallest
// power-of-two fraction whose short side still covers the requested
// output, cutting IDCT + colorspace work up to 64× for large sources —
// the same trick DALI/tf.image use; the reference's torch pipeline
// (imagenet_classification/datasets_supervised.py) decodes full-size.

#include <csetjmp>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

#include "common.h"

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jb, 1);
}

void silent_output(j_common_ptr) {}

}  // namespace

extern "C" {

// JPEG dims without decoding. Returns 0 on success.
int fastvim_jpeg_dims(const uint8_t* data, int64_t len, int* H, int* W) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.output_message = silent_output;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *W = static_cast<int>(cinfo.image_width);
  *H = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

namespace {

// Crop-aware decode + augment for one image (the DALI-style
// decode_and_crop): read only the header, choose the crop window in
// ORIGINAL coordinates (so augmentation statistics are independent of the
// decode path), then decode only the DCT-scaled scanline/iMCU region the
// crop needs (jpeg_skip_scanlines/jpeg_crop_scanline, libjpeg-turbo
// partial decode) and resize straight out of it.
bool decode_augment_one(const uint8_t* data, size_t len, float* dst,
                        int size, uint64_t seed, int training,
                        const float* mean, const float* std_,
                        float scale_lo, float scale_hi) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.output_message = silent_output;
  std::vector<uint8_t> rgb;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  const int W0 = static_cast<int>(cinfo.image_width);
  const int H0 = static_cast<int>(cinfo.image_height);

  fastvim::Rng rng(seed);
  bool flip = false;
  fastvim::Rect r =
      fastvim::choose_crop(rng, H0, W0, training, scale_lo, scale_hi, &flip);

  // smallest num/8 DCT scale whose scaled crop still covers `size` px
  int num = 8;
  while (num > 1 && r.h * (num - 1) / 8 >= size &&
         r.w * (num - 1) / 8 >= size)
    --num;
  cinfo.scale_num = static_cast<unsigned>(num);
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  const int Ws = static_cast<int>(cinfo.output_width);
  const int Hs = static_cast<int>(cinfo.output_height);
  // crop rect in scaled coords (clamped)
  fastvim::Rect rs;
  rs.x = std::min(r.x * num / 8, Ws - 1);
  rs.y = std::min(r.y * num / 8, Hs - 1);
  rs.w = std::max(1, std::min((r.w * num + 7) / 8, Ws - rs.x));
  rs.h = std::max(1, std::min((r.h * num + 7) / 8, Hs - rs.y));

  // horizontal iMCU-aligned crop: turbo adjusts xoff/width outward
  JDIMENSION xoff = static_cast<JDIMENSION>(rs.x);
  JDIMENSION xw = static_cast<JDIMENSION>(rs.w);
  jpeg_crop_scanline(&cinfo, &xoff, &xw);
  const int C = cinfo.output_components;  // 3
  if (rs.y > 0)
    jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(rs.y));
  rgb.resize(static_cast<size_t>(rs.h) * xw * C);
  int row = 0;
  while (row < rs.h &&
         cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW rp = rgb.data() + static_cast<size_t>(row) * xw * C;
    row += static_cast<int>(jpeg_read_scanlines(&cinfo, &rp, 1));
  }
  jpeg_abort_decompress(&cinfo);  // skip the remaining scanlines
  jpeg_destroy_decompress(&cinfo);

  // the decoded buffer starts at (xoff, rs.y): express the crop rect
  // relative to it for the resizer
  fastvim::Rect rl = {rs.x - static_cast<int>(xoff), 0, rs.w, row};
  fastvim::resize_crop_normalize(rgb.data(), row, static_cast<int>(xw), C,
                                 rl, flip, dst, size, mean, std_);
  return true;
}

}  // namespace

// Fused batch decode+augment: `data` holds B JPEG byte streams back to
// back; `offsets` (B+1 entries) delimits them. dst: (B, size, size, 3)
// float32, RRC(scale_lo..hi)+flip at train / center-crop at eval, then
// normalize — identical post-decode math to fastvim_augment_batch.
// Failed decodes zero-fill their slot and set fail[i]=1 (caller retries
// or drops, matching the Python loader's failure tolerance). Returns the
// number of failures.
int fastvim_decode_augment_batch(const uint8_t* data, const int64_t* offsets,
                                 int B, float* dst, int size, uint64_t seed,
                                 int training, const float* mean,
                                 const float* std_, float scale_lo,
                                 float scale_hi, uint8_t* fail,
                                 int num_threads) {
  std::atomic<int> failures(0);
  const size_t out_stride = static_cast<size_t>(size) * size * 3;
  fastvim::parallel_for(B, num_threads, [&](int i) {
    const uint8_t* p = data + offsets[i];
    const size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    if (!decode_augment_one(p, len, dst + i * out_stride, size,
                            seed * 1000003ULL + i, training, mean, std_,
                            scale_lo, scale_hi)) {
      std::memset(dst + i * out_stride, 0, out_stride * sizeof(float));
      if (fail) fail[i] = 1;
      failures.fetch_add(1);
    } else if (fail) {
      fail[i] = 0;
    }
  });
  return failures.load();
}

}  // extern "C"
