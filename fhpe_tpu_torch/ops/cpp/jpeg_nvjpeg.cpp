// JPEG codec entries on nvJPEG, for machines without libjpeg headers.
//
// The same C signatures as the libjpeg section of imagedec.cpp
// (fhpe_jpeg_dims, fhpe_jpeg_decode, fhpe_jpeg_encode); the build compiles
// imagedec.cpp with FHPE_NO_LIBJPEG beside this file and links the CUDA
// toolkit's libnvjpeg and libcudart.  Images stay host uint8 HWC in BGR or
// RGB order on both sides of the call: each call copies its pixels to the
// card, decodes or encodes there, and copies the result back.
//
// Nothing holds nvJPEG to libjpeg's islow IDCT or its fancy upsampling, so
// a decode here is not bit-equal to cv2.imread; the difference is measured
// by fhpe_tpu_torch/tools/jpeg_route.py.  The encoder uses cv2.imwrite's
// settings as far as nvJPEG has them: baseline DCT, 4:2:0, standard
// Huffman tables, the given quality.
//
// Thread safety: one nvjpegHandle_t for the process (thread-safe by the
// library's contract); decoder and encoder states, a stream and a device
// buffer per context, and a context is leased to one call at a time from
// a free list, so the loader's worker threads run calls concurrently.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Ctx {
    nvjpegJpegState_t dec = nullptr;
    nvjpegEncoderState_t enc = nullptr;
    nvjpegEncoderParams_t params = nullptr;
    cudaStream_t stream = nullptr;
    uint8_t* buf = nullptr;
    size_t cap = 0;
};

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;
std::vector<Ctx*> g_free;

nvjpegHandle_t handle() {
    std::lock_guard<std::mutex> lock(g_mu);
    if (g_handle == nullptr &&
        nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS) {
        g_handle = nullptr;
    }
    return g_handle;
}

Ctx* acquire() {
    nvjpegHandle_t h = handle();
    if (h == nullptr) return nullptr;
    {
        std::lock_guard<std::mutex> lock(g_mu);
        if (!g_free.empty()) {
            Ctx* c = g_free.back();
            g_free.pop_back();
            return c;
        }
    }
    Ctx* c = new Ctx();
    if (cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking) !=
            cudaSuccess ||
        nvjpegJpegStateCreate(h, &c->dec) != NVJPEG_STATUS_SUCCESS) {
        return nullptr;   // a context that failed to set up is not reused
    }
    return c;
}

void release(Ctx* c) {
    std::lock_guard<std::mutex> lock(g_mu);
    g_free.push_back(c);
}

struct Lease {
    Ctx* c;
    Lease() : c(acquire()) {}
    ~Lease() {
        if (c != nullptr) release(c);
    }
};

bool reserve(Ctx* c, size_t n) {
    if (c->cap >= n) return true;
    if (c->buf != nullptr) cudaFree(c->buf);
    c->buf = nullptr;
    c->cap = 0;
    if (cudaMalloc(&c->buf, n) != cudaSuccess) return false;
    c->cap = n;
    return true;
}

bool encoder(nvjpegHandle_t h, Ctx* c) {
    if (c->enc != nullptr) return true;
    if (nvjpegEncoderStateCreate(h, &c->enc, c->stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsCreate(h, &c->params, c->stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsSetEncoding(c->params,
                                       NVJPEG_ENCODING_BASELINE_DCT,
                                       c->stream) != NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsSetSamplingFactors(c->params, NVJPEG_CSS_420,
                                              c->stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsSetOptimizedHuffman(c->params, 0, c->stream) !=
            NVJPEG_STATUS_SUCCESS) {
        c->enc = nullptr;
        return false;
    }
    return true;
}

}  // namespace

extern "C" {

// Dimensions and component count from the stream's header.  Returns 0 on
// success, 1 if nvJPEG cannot start, 2 on a parse failure.
int fhpe_jpeg_dims(const uint8_t* buf, int64_t len,
                   int* w, int* h, int* channels) {
    nvjpegHandle_t hd = handle();
    if (hd == nullptr) return 1;
    int nc = 0;
    nvjpegChromaSubsampling_t ss;
    int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
    if (nvjpegGetImageInfo(hd, buf, static_cast<size_t>(len), &nc, &ss, ws,
                           hs) != NVJPEG_STATUS_SUCCESS) {
        return 2;
    }
    *w = ws[0];
    *h = hs[0];
    *channels = nc;
    return 0;
}

// Decode into caller-allocated out[h*w*3], BGR (bgr != 0) or RGB order;
// a grayscale stream is decoded as Y and replicated, as libjpeg's
// conversion does.  Returns 0 on success, 1 if nvJPEG cannot start, 2 on
// a parse failure, 3 if out_cap is too small or the stream has neither 1
// nor 3 components, 4 if device memory fails, 5 if the decode fails, 6 if
// the copy back fails.
int fhpe_jpeg_decode(const uint8_t* buf, int64_t len,
                     uint8_t* out, int64_t out_cap, int bgr) {
    Lease lease;
    Ctx* c = lease.c;
    if (c == nullptr) return 1;
    nvjpegHandle_t hd = handle();
    int nc = 0;
    nvjpegChromaSubsampling_t ss;
    int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
    if (nvjpegGetImageInfo(hd, buf, static_cast<size_t>(len), &nc, &ss, ws,
                           hs) != NVJPEG_STATUS_SUCCESS) {
        return 2;
    }
    const int64_t w = ws[0], h = hs[0];
    const int64_t n = w * h * 3;
    if ((nc != 1 && nc != 3) || n > out_cap) return 3;
    const int64_t plane = nc == 1 ? w * h : n;
    if (!reserve(c, static_cast<size_t>(plane))) return 4;
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = c->buf;
    img.pitch[0] = static_cast<size_t>(nc == 1 ? w : 3 * w);
    const nvjpegOutputFormat_t fmt =
        nc == 1 ? NVJPEG_OUTPUT_Y
                : (bgr ? NVJPEG_OUTPUT_BGRI : NVJPEG_OUTPUT_RGBI);
    if (nvjpegDecode(hd, c->dec, buf, static_cast<size_t>(len), fmt, &img,
                     c->stream) != NVJPEG_STATUS_SUCCESS) {
        cudaStreamSynchronize(c->stream);
        return 5;
    }
    if (cudaMemcpyAsync(out, c->buf, static_cast<size_t>(plane),
                        cudaMemcpyDeviceToHost, c->stream) != cudaSuccess ||
        cudaStreamSynchronize(c->stream) != cudaSuccess) {
        return 6;
    }
    if (nc == 1) {   // Y -> three equal channels, back to front in place
        for (int64_t i = w * h - 1; i >= 0; i--) {
            const uint8_t v = out[i];
            out[3 * i] = v;
            out[3 * i + 1] = v;
            out[3 * i + 2] = v;
        }
    }
    return 0;
}

// Encode h x w x 3 uint8 (BGR if bgr != 0, else RGB) as a baseline JPEG of
// the given quality.  Writes the stream's length to *out_len and copies it
// to out when it fits out_cap.  Returns 0 on success, 1 if nvJPEG cannot
// start, 4 if out_cap is too small, 5 for ch != 3, 6 if a copy or device
// allocation fails, 7 if the encode fails.
int fhpe_jpeg_encode(const uint8_t* src, int h, int w, int ch, int bgr,
                     int quality, uint8_t* out, int64_t out_cap,
                     int64_t* out_len) {
    if (ch != 3) return 5;
    Lease lease;
    Ctx* c = lease.c;
    if (c == nullptr) return 1;
    nvjpegHandle_t hd = handle();
    if (!encoder(hd, c)) return 1;
    const size_t n = static_cast<size_t>(h) * w * 3;
    if (!reserve(c, n) ||
        cudaMemcpyAsync(c->buf, src, n, cudaMemcpyHostToDevice,
                        c->stream) != cudaSuccess) {
        return 6;
    }
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = c->buf;
    img.pitch[0] = static_cast<size_t>(w) * 3;
    size_t length = 0;
    if (nvjpegEncoderParamsSetQuality(c->params, quality, c->stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncodeImage(hd, c->enc, c->params, &img,
                          bgr ? NVJPEG_INPUT_BGRI : NVJPEG_INPUT_RGBI, w, h,
                          c->stream) != NVJPEG_STATUS_SUCCESS ||
        nvjpegEncodeRetrieveBitstream(hd, c->enc, nullptr, &length,
                                      c->stream) != NVJPEG_STATUS_SUCCESS) {
        cudaStreamSynchronize(c->stream);
        return 7;
    }
    if (cudaStreamSynchronize(c->stream) != cudaSuccess) return 6;
    *out_len = static_cast<int64_t>(length);
    if (static_cast<int64_t>(length) > out_cap) return 4;
    if (nvjpegEncodeRetrieveBitstream(hd, c->enc, out, &length, c->stream) !=
        NVJPEG_STATUS_SUCCESS) {
        cudaStreamSynchronize(c->stream);
        return 7;
    }
    if (cudaStreamSynchronize(c->stream) != cudaSuccess) return 6;
    *out_len = static_cast<int64_t>(length);
    return 0;
}

}  // extern "C"
