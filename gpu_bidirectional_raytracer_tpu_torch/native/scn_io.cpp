// Native runtime: fast .scn scene parsing and PPM image encoding.
//
// The PyTorch port's copy of the JAX package's native/scn_io.cpp (the two
// packages share no files). It handles the host-side IO that Python string
// processing makes slow for bulk workloads (hundreds of scenes, large frame
// dumps); the render itself runs in PyTorch and the CUDA kernels.
//
// Exposed as a plain C ABI for ctypes; no pybind11 dependency.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- .scn parse
//
// Grammar (display_func.c:112-175):
//   camera ox oy oz tx ty tz
//   size N
//   sphere rad px py pz er eg eb cr cg cb mat   (N times)
// '#' comments and blank lines tolerated (superset of the reference).
//
// Returns 0 on success; negative error codes otherwise. On success:
//   cam_out[6], *count_out = N, and *spheres_out = malloc'd array of
//   N*11 floats laid out [rad, p(3), e(3), c(3), mat] per sphere.
//   Caller frees with scn_free().

static const char* skip_ws_comments(const char* p, const char* end) {
    while (p < end) {
        if (*p == '#') {
            while (p < end && *p != '\n') ++p;
        } else if (std::isspace((unsigned char)*p)) {
            ++p;
        } else {
            break;
        }
    }
    return p;
}

static bool read_token(const char** pp, const char* end, std::string* tok) {
    const char* p = skip_ws_comments(*pp, end);
    const char* start = p;
    while (p < end && !std::isspace((unsigned char)*p) && *p != '#') ++p;
    if (p == start) return false;
    tok->assign(start, p - start);
    *pp = p;
    return true;
}

static bool read_float(const char** pp, const char* end, float* out) {
    std::string tok;
    if (!read_token(pp, end, &tok)) return false;
    char* q = nullptr;
    *out = std::strtof(tok.c_str(), &q);
    return q && *q == '\0';
}

int scn_parse(const char* text, int64_t len, float cam_out[6],
              float** spheres_out, int64_t* count_out) {
    const char* p = text;
    const char* end = text + len;
    std::string tok;

    if (!read_token(&p, end, &tok) || tok != "camera") return -1;
    for (int i = 0; i < 6; ++i)
        if (!read_float(&p, end, &cam_out[i])) return -2;

    if (!read_token(&p, end, &tok) || tok != "size") return -3;
    float fcount;
    if (!read_float(&p, end, &fcount)) return -4;
    if (fcount != (float)(int64_t)fcount) return -4;  // must be integral
    int64_t n = (int64_t)fcount;
    if (n <= 0 || n > (int64_t)1e8) return -5;

    float* spheres = (float*)std::malloc(sizeof(float) * 11 * n);
    if (!spheres) return -6;
    for (int64_t i = 0; i < n; ++i) {
        if (!read_token(&p, end, &tok) || tok != "sphere") {
            std::free(spheres);
            return -7;
        }
        for (int k = 0; k < 11; ++k) {
            if (!read_float(&p, end, &spheres[i * 11 + k])) {
                std::free(spheres);
                return -8;
            }
        }
        float fmat = spheres[i * 11 + 10];
        int mat = (int)fmat;
        if (fmat != (float)mat || mat < 0 || mat > 3) {
            std::free(spheres);
            return -9;
        }
    }
    *spheres_out = spheres;
    *count_out = n;
    return 0;
}

void scn_free(float* ptr) { std::free(ptr); }

// ---------------------------------------------------------------- PPM encode
//
// P3 writer matching SavePPM's layout (smallpt_cpu.c:251-258): rows emitted
// from the top of the image (buffer row height-1) down, "r g b " triplets.
// img: uint8 [h, w, 3] with row 0 at the BOTTOM. Returns bytes written or
// negative errno.

int64_t ppm_write_p3(const char* path, const uint8_t* img, int64_t w,
                     int64_t h) {
    FILE* f = std::fopen(path, "w");
    if (!f) return -1;
    std::string buf;
    buf.reserve((size_t)(w * h * 12 + 64));
    char head[64];
    std::snprintf(head, sizeof head, "P3\n%lld %lld\n255\n", (long long)w,
                  (long long)h);
    buf += head;
    char tmp[16];
    for (int64_t y = h - 1; y >= 0; --y) {
        const uint8_t* row = img + y * w * 3;
        for (int64_t x = 0; x < w; ++x) {
            std::snprintf(tmp, sizeof tmp, "%d %d %d ", row[x * 3],
                          row[x * 3 + 1], row[x * 3 + 2]);
            buf += tmp;
        }
        buf += '\n';
    }
    size_t written = std::fwrite(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    return (int64_t)written;
}

// Binary P6 for bulk dumps (3x smaller, ~20x faster to parse back).
int64_t ppm_write_p6(const char* path, const uint8_t* img, int64_t w,
                     int64_t h) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fprintf(f, "P6\n%lld %lld\n255\n", (long long)w, (long long)h);
    int64_t total = 0;
    for (int64_t y = h - 1; y >= 0; --y)
        total += (int64_t)std::fwrite(img + y * w * 3, 1, (size_t)(w * 3), f);
    std::fclose(f);
    return total;
}

}  // extern "C"
