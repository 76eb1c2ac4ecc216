// Host-side native components of the port's serving path (the same C ABI as
// the JAX package's copy, so both bindings read alike):
//   * FramePipe - lock-free SPSC ring buffer of fixed-size frames between a
//     device-drain thread and a streaming backend, with no Python object per
//     frame; a push into a full ring drops the frame and counts it.
//   * rgb_to_i420 - RGB -> I420 (YUV420 planar, BT.601 full range).
//   * laplacian_var - a frame's sharpness: the variance of the 4-neighbour
//     Laplacian of its gray image over the interior pixels.
//
// Plain C interface; built with g++ at first use by
// inferix_tpu_torch/_build.py:load_host_library and bound with ctypes
// (inferix_tpu_torch/native/__init__.py).
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// FramePipe: single-producer single-consumer ring of fixed-size frames
// ---------------------------------------------------------------------------

struct FramePipe {
    uint8_t* data;
    size_t frame_bytes;
    size_t capacity;           // number of frame slots
    std::atomic<uint64_t> head;  // next write index
    std::atomic<uint64_t> tail;  // next read index
    std::atomic<uint64_t> dropped;
};

FramePipe* fp_create(size_t capacity, size_t frame_bytes) {
    auto* p = new FramePipe();
    p->data = static_cast<uint8_t*>(std::malloc(capacity * frame_bytes));
    if (!p->data) { delete p; return nullptr; }
    p->frame_bytes = frame_bytes;
    p->capacity = capacity;
    p->head.store(0);
    p->tail.store(0);
    p->dropped.store(0);
    return p;
}

void fp_destroy(FramePipe* p) {
    if (!p) return;
    std::free(p->data);
    delete p;
}

// push one frame; returns 1 on success, 0 if full (frame dropped + counted)
int fp_push(FramePipe* p, const uint8_t* frame) {
    uint64_t head = p->head.load(std::memory_order_relaxed);
    uint64_t tail = p->tail.load(std::memory_order_acquire);
    if (head - tail >= p->capacity) {
        p->dropped.fetch_add(1, std::memory_order_relaxed);
        return 0;
    }
    std::memcpy(p->data + (head % p->capacity) * p->frame_bytes, frame,
                p->frame_bytes);
    p->head.store(head + 1, std::memory_order_release);
    return 1;
}

// pop one frame into out; returns 1 on success, 0 if empty
int fp_pop(FramePipe* p, uint8_t* out) {
    uint64_t tail = p->tail.load(std::memory_order_relaxed);
    uint64_t head = p->head.load(std::memory_order_acquire);
    if (tail >= head) return 0;
    std::memcpy(out, p->data + (tail % p->capacity) * p->frame_bytes,
                p->frame_bytes);
    p->tail.store(tail + 1, std::memory_order_release);
    return 1;
}

size_t fp_size(FramePipe* p) {
    return static_cast<size_t>(p->head.load() - p->tail.load());
}

uint64_t fp_dropped(FramePipe* p) { return p->dropped.load(); }

// ---------------------------------------------------------------------------
// RGB -> I420 (BT.601 full range)
// ---------------------------------------------------------------------------

void rgb_to_i420(const uint8_t* rgb, int w, int h, uint8_t* y_out,
                 uint8_t* u_out, uint8_t* v_out) {
    for (int j = 0; j < h; ++j) {
        for (int i = 0; i < w; ++i) {
            const uint8_t* px = rgb + (j * w + i) * 3;
            int r = px[0], g = px[1], b = px[2];
            int y = (77 * r + 150 * g + 29 * b) >> 8;
            y_out[j * w + i] = static_cast<uint8_t>(y < 0 ? 0 : (y > 255 ? 255 : y));
        }
    }
    int cw = w / 2, ch = h / 2;
    for (int j = 0; j < ch; ++j) {
        for (int i = 0; i < cw; ++i) {
            // average the 2x2 block
            int r = 0, g = 0, b = 0;
            for (int dj = 0; dj < 2; ++dj)
                for (int di = 0; di < 2; ++di) {
                    const uint8_t* px = rgb + ((2 * j + dj) * w + 2 * i + di) * 3;
                    r += px[0]; g += px[1]; b += px[2];
                }
            r >>= 2; g >>= 2; b >>= 2;
            int u = ((-43 * r - 85 * g + 128 * b) >> 8) + 128;
            int v = ((128 * r - 107 * g - 21 * b) >> 8) + 128;
            u_out[j * cw + i] = static_cast<uint8_t>(u < 0 ? 0 : (u > 255 ? 255 : u));
            v_out[j * cw + i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}

// ---------------------------------------------------------------------------
// Laplacian variance (sharpness) over a grayscale-converted RGB frame
// ---------------------------------------------------------------------------

double laplacian_var(const uint8_t* rgb, int w, int h) {
    // grayscale
    double* gray = static_cast<double*>(std::malloc(sizeof(double) * w * h));
    if (!gray) return 0.0;
    for (int j = 0; j < h; ++j)
        for (int i = 0; i < w; ++i) {
            const uint8_t* px = rgb + (j * w + i) * 3;
            gray[j * w + i] = 0.299 * px[0] + 0.587 * px[1] + 0.114 * px[2];
        }
    // laplacian (4-neighbor) on interior
    double sum = 0.0, sumsq = 0.0;
    long n = 0;
    for (int j = 1; j < h - 1; ++j)
        for (int i = 1; i < w - 1; ++i) {
            double lap = gray[(j - 1) * w + i] + gray[(j + 1) * w + i]
                       + gray[j * w + i - 1] + gray[j * w + i + 1]
                       - 4.0 * gray[j * w + i];
            sum += lap;
            sumsq += lap * lap;
            ++n;
        }
    std::free(gray);
    if (n == 0) return 0.0;
    double mean = sum / n;
    return sumsq / n - mean * mean;
}

}  // extern "C"
