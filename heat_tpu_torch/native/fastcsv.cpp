// Native chunked CSV parser of heat_tpu_torch (heat_tpu native/fastcsv.cpp).
//
// The reference's CSV path is a pure-Python byte-offset chunked parse
// (reference heat/core/io.py:710-860: each rank seeks to its byte range,
// snaps to line boundaries, splits and floats the fields in Python). This
// is the native equivalent: the same byte-range convention — a line belongs
// to the range its first byte falls in — parsed with strtod across a thread
// pool, writing straight into a caller-provided row-major double buffer.
//
// Exported C API (ctypes-friendly, no C++ types across the boundary):
//   fastcsv_scan(path, start, end, sep, &rows, &cols) -> 0 on success
//     Count data rows whose first byte lies in [start, end) and the column
//     count of the first such row. If start > 0 the range first skips to
//     the byte after the first '\n' at/after start (chunk convention).
//   fastcsv_parse(path, start, end, sep, out, rows, cols, threads) -> rows
//     Parse the same range into out[rows*cols] (row-major). Fields that
//     fail to parse become NaN (numpy.genfromtxt semantics); short rows
//     are NaN-padded, long rows truncated. Returns rows written, or -1.
//   fastcsv_parse_alloc(path, start, end, sep, threads, &rows, &cols,
//                       &data) -> 0 on success (-1 io, -3 ragged)
//     Single-read variant: reads the file once, scans and parses from the
//     same buffer, returning a malloc'd rows*cols array the caller frees
//     with fastcsv_free.
//
// Build (heat_tpu_torch/native/__init__.py, at first use):
//   g++ -O3 -shared -fPIC -pthread fastcsv.cpp -o heat_tpu_torch/_build/libfastcsv-<hash>.so

#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Mapped {
    char* data = nullptr;
    long size = 0;
    FILE* f = nullptr;
    bool ok() const { return data != nullptr; }
};

// Plain read (not mmap): works on every filesystem the tests use and the
// buffer is touched exactly once per pass anyway.
Mapped read_file(const char* path) {
    Mapped m;
    m.f = std::fopen(path, "rb");
    if (!m.f) return m;
    std::fseek(m.f, 0, SEEK_END);
    m.size = std::ftell(m.f);
    std::fseek(m.f, 0, SEEK_SET);
    // +1: NUL terminator so strtod on the last field of a file without a
    // trailing newline can never read past the buffer
    m.data = static_cast<char*>(std::malloc(m.size + 1));
    if (m.data && m.size > 0 &&
        std::fread(m.data, 1, m.size, m.f) != static_cast<size_t>(m.size)) {
        std::free(m.data);
        m.data = nullptr;
    }
    if (m.data) m.data[m.size] = '\0';
    return m;
}

void release(Mapped& m) {
    if (m.data) std::free(m.data);
    if (m.f) std::fclose(m.f);
}

// Snap a chunk start to the line-ownership convention.
long snap_start(const char* d, long size, long start) {
    if (start <= 0) return 0;
    long p = start;
    while (p < size && d[p - 1] != '\n') ++p;  // byte after the first newline
    return p;
}

bool blank_line(const char* b, const char* e) {
    for (const char* p = b; p < e; ++p)
        if (!std::isspace(static_cast<unsigned char>(*p))) return false;
    return true;
}

// Count columns: separators outside the line's content don't matter; a
// trailing separator is trailing content per genfromtxt (empty field).
long count_cols(const char* b, const char* e, char sep) {
    long c = 1;
    for (const char* p = b; p < e; ++p)
        if (*p == sep) ++c;
    return c;
}

void parse_line(const char* b, const char* e, char sep, double* out, long cols) {
    const char* p = b;
    for (long c = 0; c < cols; ++c) {
        const char* fe = p;
        while (fe < e && *fe != sep) ++fe;
        if (p >= e) {
            out[c] = NAN;  // short row: NaN-pad
            continue;
        }
        char* endp = nullptr;
        errno = 0;
        double v = std::strtod(p, &endp);
        // conversion must happen AND stay inside the field: strtod skips
        // leading whitespace, so an empty/whitespace field (tab-separated
        // files!) would otherwise steal the next field's digits
        bool ok = endp != p && endp <= fe;
        for (const char* q = endp; ok && q < fe; ++q)
            ok = std::isspace(static_cast<unsigned char>(*q));
        out[c] = ok ? v : NAN;
        p = fe < e ? fe + 1 : e;
    }
}

struct Range {
    long begin, end;  // byte range, start-snapped
    long rows = 0;    // rows counted in pass 1
};

// Threaded parse of [begin, end) into out[rows*cols]; returns rows written
// or a negative error. Assumes begin is already start-snapped.
long parse_ranges(const Mapped& m, long begin, long end, char sep,
                  double* out, long rows, long cols, int threads) {
    if (threads < 1) threads = 1;
    long span = end - begin;
    if (span <= 0) return 0;
    if (threads > 1 && span / threads < (1 << 16))
        threads = static_cast<int>(span / (1 << 16)) > 0
                      ? static_cast<int>(span / (1 << 16))
                      : 1;

    // carve sub-ranges on line boundaries (same snap convention)
    std::vector<Range> ranges(threads);
    for (int t = 0; t < threads; ++t) {
        long s = begin + span * t / threads;
        long e = begin + span * (t + 1) / threads;
        ranges[t].begin = t == 0 ? begin : snap_start(m.data, m.size, s);
        ranges[t].end = t == threads - 1 ? end : snap_start(m.data, m.size, e);
        if (ranges[t].begin > ranges[t].end) ranges[t].begin = ranges[t].end;
    }

    // pass 1 (parallel): rows per sub-range
    {
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
            pool.emplace_back([&, t] {
                long p = ranges[t].begin, r = 0;
                while (p < ranges[t].end) {
                    long q = p;
                    while (q < m.size && m.data[q] != '\n') ++q;
                    if (!blank_line(m.data + p, m.data + q)) ++r;
                    p = q + 1;
                }
                ranges[t].rows = r;
            });
        for (auto& th : pool) th.join();
    }

    // prefix offsets, clamp to the caller's buffer
    std::vector<long> offset(threads + 1, 0);
    for (int t = 0; t < threads; ++t) offset[t + 1] = offset[t] + ranges[t].rows;
    if (offset[threads] > rows) return -2;  // refuse to overflow

    // pass 2 (parallel): parse into the right slice
    {
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
            pool.emplace_back([&, t] {
                long p = ranges[t].begin;
                long r = offset[t];
                while (p < ranges[t].end) {
                    long q = p;
                    while (q < m.size && m.data[q] != '\n') ++q;
                    if (!blank_line(m.data + p, m.data + q)) {
                        parse_line(m.data + p, m.data + q, sep,
                                   out + r * cols, cols);
                        ++r;
                    }
                    p = q + 1;
                }
            });
        for (auto& th : pool) th.join();
    }
    return offset[threads];
}

// Scan rows/cols in [p, end); returns 0 or -3 (ragged).
int scan_range(const Mapped& m, long p, long end, char sep,
               long* out_rows, long* out_cols) {
    long rows = 0, cols = 0;
    while (p < end) {
        long q = p;
        while (q < m.size && m.data[q] != '\n') ++q;
        if (!blank_line(m.data + p, m.data + q)) {
            long c = count_cols(m.data + p, m.data + q, sep);
            if (rows == 0) {
                cols = c;
            } else if (c != cols) {
                return -3;  // ragged: numpy.genfromtxt raises, so must we
            }
            ++rows;
        }
        p = q + 1;
    }
    *out_rows = rows;
    *out_cols = cols;
    return 0;
}

}  // namespace

extern "C" {

int fastcsv_scan(const char* path, long start, long end, char sep,
                 long* out_rows, long* out_cols) {
    Mapped m = read_file(path);
    if (!m.ok()) return -1;
    if (end < 0 || end > m.size) end = m.size;
    int rc = scan_range(m, snap_start(m.data, m.size, start), end, sep,
                        out_rows, out_cols);
    release(m);
    return rc;
}

long fastcsv_parse(const char* path, long start, long end, char sep,
                   double* out, long rows, long cols, int threads) {
    Mapped m = read_file(path);
    if (!m.ok()) return -1;
    if (end < 0 || end > m.size) end = m.size;
    long begin = snap_start(m.data, m.size, start);
    long total = parse_ranges(m, begin, end, sep, out, rows, cols, threads);
    release(m);
    return total;
}

int fastcsv_parse_alloc(const char* path, long start, long end, char sep,
                        int threads, long* out_rows, long* out_cols,
                        double** out_data) {
    Mapped m = read_file(path);
    if (!m.ok()) return -1;
    if (end < 0 || end > m.size) end = m.size;
    long begin = snap_start(m.data, m.size, start);
    long rows = 0, cols = 0;
    int rc = scan_range(m, begin, end, sep, &rows, &cols);
    if (rc != 0) {
        release(m);
        return rc;
    }
    double* out = static_cast<double*>(
        std::malloc(sizeof(double) * (rows > 0 ? rows * cols : 1)));
    if (!out) {
        release(m);
        return -1;
    }
    long total = parse_ranges(m, begin, end, sep, out, rows, cols, threads);
    release(m);
    if (total != rows) {
        std::free(out);
        return -2;
    }
    *out_rows = rows;
    *out_cols = cols;
    *out_data = out;
    return 0;
}

void fastcsv_free(double* data) { std::free(data); }

}  // extern "C"
