// Host image library of the port: JPEG codec (libjpeg) + cv2-parity warp.
//
// A copy of fhpe_tpu/ops/cpp/imagedec.cpp (the reference's host data
// path, lib/dataset/JointsDataset.py:120-172: cv2.imread +
// cv2.warpAffine) with one addition, fhpe_jpeg_encode, which writes what
// cv2.imwrite(path, img) writes for a .jpg (quality 95, baseline, islow
// DCT, 4:2:0, no optimized Huffman tables, no restart markers).  The port
// has no cv2: the synthetic datasets write their JPEGs through it.
//
// The decode and encode use the system libjpeg-turbo with its defaults
// (islow DCT, fancy upsampling), the settings OpenCV's bundled
// libjpeg-turbo uses, so decode output is bit-identical to cv2.imread
// (tests/test_torch_image.py).  Where the machine has no jpeglib.h, the
// build defines FHPE_NO_LIBJPEG and takes the codec entries from
// jpeg_nvjpeg.cpp (nvJPEG, the same C signatures) instead; the warp is
// the same in both builds.
//
// The warp replicates OpenCV 5's float warpAffine engine (INTER_LINEAR +
// BORDER_CONSTANT(0)): double-precision 2x3 inversion, float32 row base
// (m1*y + m2, no fma), single-rounded fma for the per-pixel x term
// (fmaf(m0, x, base)), float32 bilinear interpolation, round half-to-even.
// Equal to cv2 5.0 up to +-1 at an exact .5 tie (cv2's own
// SIMD-body/scalar-tail inconsistency at ties).  Requires
// -ffp-contract=off so gcc cannot fuse the row-base mul+add.
//
// The warp additionally supports reading the source as horizontally
// flipped (flip_src) — taps read src[y][w-1-x] — which is value-equal to
// materializing `img[:, ::-1]` first (the reference's flip,
// JointsDataset.py:161-165) while skipping the full-image copy.
//
// C ABI for ctypes.  Built at first use by fhpe_tpu_torch/ops/native_image.py.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cfenv>
#include <cmath>
#include <limits>
#include <utility>
#include <vector>

#ifndef FHPE_NO_LIBJPEG
#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------- JPEG ---

struct JErr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
    JErr* e = reinterpret_cast<JErr*>(cinfo->err);
    longjmp(e->jb, 1);
}

void jerr_silent(j_common_ptr, int) {}

}  // namespace

extern "C" {

// Peek JPEG dimensions + channels without full decode.  Returns 0 on
// success, nonzero on parse failure.
int fhpe_jpeg_dims(const uint8_t* buf, int64_t len,
                   int* w, int* h, int* channels) {
    jpeg_decompress_struct cinfo;
    JErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    jerr.pub.emit_message = jerr_silent;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    *w = static_cast<int>(cinfo.image_width);
    *h = static_cast<int>(cinfo.image_height);
    *channels = cinfo.num_components;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode a JPEG into caller-allocated out[h*w*3], BGR (bgr!=0) or RGB
// order, using libjpeg defaults (islow DCT, fancy upsampling) — the
// OpenCV imread settings.  Returns 0 on success.
int fhpe_jpeg_decode(const uint8_t* buf, int64_t len,
                     uint8_t* out, int64_t out_cap, int bgr) {
    jpeg_decompress_struct cinfo;
    JErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    jerr.pub.emit_message = jerr_silent;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    // libjpeg-turbo extended colorspaces give BGR directly (what OpenCV
    // uses); works for grayscale and YCbCr sources alike.
    cinfo.out_color_space = bgr ? JCS_EXT_BGR : JCS_EXT_RGB;
    jpeg_start_decompress(&cinfo);
    const int64_t stride =
        static_cast<int64_t>(cinfo.output_width) * cinfo.output_components;
    if (cinfo.output_components != 3 ||
        stride * cinfo.output_height > out_cap) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return 3;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + stride * cinfo.output_scanline;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Encode h x w x ch uint8 (ch 3: BGR if bgr != 0, else RGB; ch 1:
// grayscale) as a baseline JPEG of the given quality, with cv2.imwrite's
// settings: jpeg_set_defaults (islow DCT, 4:2:0, standard Huffman
// tables), jpeg_set_quality(quality, force_baseline=TRUE).  Writes the
// stream's length to *out_len; copies it to out when it fits out_cap.
// Returns 0 on success, 4 if out_cap is too small, 5 for a bad ch.
int fhpe_jpeg_encode(const uint8_t* src, int h, int w, int ch, int bgr,
                     int quality, uint8_t* out, int64_t out_cap,
                     int64_t* out_len) {
    if (ch != 1 && ch != 3) return 5;
    jpeg_compress_struct cinfo;
    JErr jerr;
    unsigned char* mem = nullptr;
    unsigned long mem_len = 0;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    jerr.pub.emit_message = jerr_silent;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_compress(&cinfo);
        std::free(mem);
        return 1;
    }
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &mem, &mem_len);
    cinfo.image_width = static_cast<JDIMENSION>(w);
    cinfo.image_height = static_cast<JDIMENSION>(h);
    cinfo.input_components = ch;
    cinfo.in_color_space =
        ch == 3 ? (bgr ? JCS_EXT_BGR : JCS_EXT_RGB) : JCS_GRAYSCALE;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    const int64_t stride = static_cast<int64_t>(w) * ch;
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = const_cast<uint8_t*>(src + stride * cinfo.next_scanline);
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    *out_len = static_cast<int64_t>(mem_len);
    const int rc = static_cast<int64_t>(mem_len) > out_cap ? 4 : 0;
    if (rc == 0) std::memcpy(out, mem, mem_len);
    std::free(mem);
    return rc;
}

}  // extern "C"
#endif  // FHPE_NO_LIBJPEG

extern "C" {

// cv2.warpAffine(src, M, (dw, dh), flags=INTER_LINEAR,
//                borderMode=BORDER_CONSTANT, borderValue=0) — cv2-5 float
// engine parity (see file header for the reverse-engineered arithmetic).
// src: sh x sw x ch uint8 (ch in 1..4), dst: dh x dw x ch.
// M: 2x3 double mapping src->dst (inverted internally, like cv2) unless
// inverse_map != 0.  flip_src != 0 reads the source mirrored about the
// vertical axis (value-equal to warping a materialized img[:, ::-1]).
void fhpe_warp_affine_u8(const uint8_t* src, int sh, int sw, int ch,
                         uint8_t* dst, int dh, int dw,
                         const double* M0, int inverse_map, int flip_src) {
    double M[6];
    std::memcpy(M, M0, sizeof(M));
    if (!inverse_map) {  // cv2 warpAffine's in-place 2x3 inversion (double)
        double D = M[0] * M[4] - M[1] * M[3];
        D = D != 0 ? 1.0 / D : 0.0;
        double A11 = M[4] * D, A22 = M[0] * D;
        M[0] = A11;
        M[1] *= -D;
        M[3] *= -D;
        M[4] = A22;
        double b1 = -M[0] * M[2] - M[1] * M[5];
        double b2 = -M[3] * M[2] - M[4] * M[5];
        M[2] = b1;
        M[5] = b2;
    }
    const float m0 = static_cast<float>(M[0]), m1 = static_cast<float>(M[1]),
                m2 = static_cast<float>(M[2]), m3 = static_cast<float>(M[3]),
                m4 = static_cast<float>(M[4]), m5 = static_cast<float>(M[5]);

    const int64_t sstride = static_cast<int64_t>(sw) * ch;
    for (int y = 0; y < dh; y++) {
        // float32 row base, separate mul+add (-ffp-contract=off keeps it so)
        const float bx = m1 * static_cast<float>(y) + m2;
        const float by = m4 * static_cast<float>(y) + m5;
        uint8_t* drow = dst + static_cast<int64_t>(y) * dw * ch;
        for (int x = 0; x < dw; x++) {
            const float xf = static_cast<float>(x);
            const float sx = std::fmaf(m0, xf, bx);
            const float sy = std::fmaf(m3, xf, by);
            uint8_t* d = drow + static_cast<int64_t>(x) * ch;
            // whole 2x2 support outside (or non-finite coords): border 0
            if (!(sx > -2.0f && sx < static_cast<float>(sw) + 1.0f &&
                  sy > -2.0f && sy < static_cast<float>(sh) + 1.0f)) {
                for (int c = 0; c < ch; c++) d[c] = 0;
                continue;
            }
            const int ix = static_cast<int>(std::floor(sx));
            const int iy = static_cast<int>(std::floor(sy));
            const float fx = sx - static_cast<float>(ix);
            const float fy = sy - static_cast<float>(iy);
            const float gx = 1.0f - fx, gy = 1.0f - fy;

            if (static_cast<unsigned>(ix) < static_cast<unsigned>(sw - 1) &&
                static_cast<unsigned>(iy) < static_cast<unsigned>(sh - 1)) {
                const int rx0 = flip_src ? sw - 1 - ix : ix;
                const int rx1 = flip_src ? sw - 2 - ix : ix + 1;
                const uint8_t* s0 = src + iy * sstride;
                const uint8_t* s1 = s0 + sstride;
                for (int c = 0; c < ch; c++) {
                    const float t0 = static_cast<float>(s0[rx0 * ch + c]) * gx +
                                     static_cast<float>(s0[rx1 * ch + c]) * fx;
                    const float t1 = static_cast<float>(s1[rx0 * ch + c]) * gx +
                                     static_cast<float>(s1[rx1 * ch + c]) * fx;
                    const float v = t0 * gy + t1 * fy;
                    d[c] = static_cast<uint8_t>(std::lrintf(v));  // half-even
                }
            } else {
                // partial overlap: per-tap zero border (cv2 BORDER_CONSTANT)
                const int xs[2] = {ix, ix + 1}, ys[2] = {iy, iy + 1};
                const float wx[2] = {gx, fx}, wy[2] = {gy, fy};
                for (int c = 0; c < ch; c++) {
                    float v = 0.0f;
                    for (int ky = 0; ky < 2; ky++) {
                        float t = 0.0f;
                        for (int kx = 0; kx < 2; kx++) {
                            const int tx = xs[kx], ty = ys[ky];
                            float p = 0.0f;
                            if (static_cast<unsigned>(tx) <
                                    static_cast<unsigned>(sw) &&
                                static_cast<unsigned>(ty) <
                                    static_cast<unsigned>(sh)) {
                                const int rx = flip_src ? sw - 1 - tx : tx;
                                p = static_cast<float>(
                                    src[ty * sstride + rx * ch + c]);
                            }
                            t += p * wx[kx];
                        }
                        v += t * wy[ky];
                    }
                    const long r = std::lrintf(v);
                    d[c] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
                }
            }
        }
    }
}


// cv2.resize(src, (dw, dh), interpolation=INTER_LINEAR) on uint8, ch in
// 1..4: OpenCV's fixed-point linear resize (imgproc/src/resize.cpp), the
// tables of hal::resize and the arithmetic of its uchar specialisations.
//   * equal sizes: a copy (cv::resize's own shortcut);
//   * both scales exactly 2 (an exact halving): INTER_AREA's fast path,
//     (a + b + c + d + 2) >> 2 over each 2x2 block;
//   * otherwise the source coordinate (d + 0.5) * scale - 0.5 in double,
//     rounded to float, floored; its fraction as 11-bit coefficients
//     (1 - f and f times 2048, each rounded half to even); x clamped to
//     the image with a zero fraction (one tap at the right edge), y's rows
//     clamped but its fraction kept; the horizontal pass in int, the
//     vertical one as ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16)
//     then + 2 >> 2, i.e. the 22-bit shift of the two passes done in
//     16-bit halves as OpenCV's VResizeLinear<uchar, int, short> does.
void fhpe_resize_linear_u8(const uint8_t* src, int sh, int sw, int ch,
                           uint8_t* dst, int dh, int dw) {
    const int64_t srow = static_cast<int64_t>(sw) * ch;
    const int64_t drow = static_cast<int64_t>(dw) * ch;
    if (sh == dh && sw == dw) {
        std::memcpy(dst, src, static_cast<size_t>(sh) * srow);
        return;
    }
    const double scale_x = 1.0 / (static_cast<double>(dw) / sw);
    const double scale_y = 1.0 / (static_cast<double>(dh) / sh);
    const double eps = std::numeric_limits<double>::epsilon();
    if (std::fabs(scale_x - 2.0) < eps && std::fabs(scale_y - 2.0) < eps) {
        for (int y = 0; y < dh; y++) {
            const uint8_t* s0 = src + 2 * y * srow;
            const uint8_t* s1 = s0 + srow;
            uint8_t* d = dst + y * drow;
            for (int x = 0; x < dw; x++)
                for (int c = 0; c < ch; c++) {
                    const int i = 2 * x * ch + c;
                    d[x * ch + c] = static_cast<uint8_t>(
                        (s0[i] + s0[i + ch] + s1[i] + s1[i + ch] + 2) >> 2);
                }
        }
        return;
    }
    constexpr float kOne = 2048.0f;           // INTER_RESIZE_COEF_SCALE
    std::vector<int> xofs(dw);
    std::vector<int> xa0(dw), xa1(dw);
    std::vector<char> xone(dw);               // one tap: sx at the right edge
    for (int x = 0; x < dw; x++) {
        float fx = static_cast<float>((x + 0.5) * scale_x - 0.5);
        int sx = static_cast<int>(std::floor(fx));
        fx -= static_cast<float>(sx);
        if (sx < 0) fx = 0.0f, sx = 0;
        xone[x] = sx + 1 >= sw;
        if (sx >= sw - 1) fx = 0.0f, sx = sw - 1;
        xofs[x] = sx;
        xa0[x] = static_cast<short>(std::lrintf((1.0f - fx) * kOne));
        xa1[x] = static_cast<short>(std::lrintf(fx * kOne));
    }
    std::vector<int> r0(drow), r1(drow);
    auto hpass = [&](const uint8_t* s, int* out) {
        for (int x = 0; x < dw; x++) {
            const uint8_t* p = s + static_cast<int64_t>(xofs[x]) * ch;
            for (int c = 0; c < ch; c++)
                out[x * ch + c] = xone[x]
                    ? p[c] * 2048
                    : p[c] * xa0[x] + p[c + ch] * xa1[x];
        }
    };
    int have0 = -1, have1 = -1;             // rows r0, r1 hold
    for (int y = 0; y < dh; y++) {
        float fy = static_cast<float>((y + 0.5) * scale_y - 0.5);
        const int sy = static_cast<int>(std::floor(fy));
        fy -= static_cast<float>(sy);
        const int b0 = static_cast<short>(std::lrintf((1.0f - fy) * kOne));
        const int b1 = static_cast<short>(std::lrintf(fy * kOne));
        const int y0 = sy < 0 ? 0 : (sy < sh ? sy : sh - 1);
        const int y1 = sy + 1 < 0 ? 0 : (sy + 1 < sh ? sy + 1 : sh - 1);
        if (y0 == have1) {            // upscaling reads each row twice
            std::swap(r0, r1);
            std::swap(have0, have1);
        }
        if (y0 != have0) hpass(src + y0 * srow, r0.data()), have0 = y0;
        if (y1 != have1) hpass(src + y1 * srow, r1.data()), have1 = y1;
        uint8_t* d = dst + y * drow;
        for (int64_t i = 0; i < drow; i++) {
            const int v = (((b0 * (r0[i] >> 4)) >> 16) +
                           ((b1 * (r1[i] >> 4)) >> 16) + 2) >> 2;
            d[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}

}  // extern "C"
