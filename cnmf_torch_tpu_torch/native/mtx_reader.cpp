// MatrixMarket coordinate-body parser of the port's 10x .mtx reader.
//
// Own copy of the JAX package's cnmf_torch_tpu/native/mtx_reader.cpp, the
// same parser byte for byte below this comment. The body parse is the
// cold-start hot spot of multi-hundred-MB coordinate files, so it runs
// here as a two-phase multi-threaded pass over the raw buffer:
//
//   phase 1: split the buffer at line boundaries into per-thread chunks and
//            count entry lines per chunk (comments/blank lines skipped);
//   phase 2: exclusive prefix sums give each chunk its output offset, then
//            all chunks parse concurrently straight into the caller's
//            arrays — no locks, no allocations, deterministic order.
//
// Contract: buf[0..len) is the body (entries only, comments allowed), each
// entry "row col [value]" 1-indexed, one per line. Returns the number of
// entries parsed, or -(byte offset + 1) of the first malformed entry.
// pattern==1 means no value column (implicit 1.0). n_threads<=0 selects
// hardware concurrency.

#include <algorithm>
#include <atomic>
#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Chunk {
    const char* begin;
    const char* end;
    long long n_entries = 0;   // phase-1 count
    long long offset = 0;      // phase-2 output offset
    long long bad_at = -1;     // byte offset of first malformed entry
};

inline bool is_entry_line(const char* p, const char* line_end) {
    while (p < line_end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p < line_end && *p != '%';
}

void count_chunk(Chunk& ch) {
    const char* p = ch.begin;
    long long n = 0;
    while (p < ch.end) {
        const char* nl = (const char*)memchr(p, '\n', ch.end - p);
        const char* line_end = nl ? nl : ch.end;
        if (is_entry_line(p, line_end)) ++n;
        p = nl ? nl + 1 : ch.end;
    }
    ch.n_entries = n;
}

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

void parse_chunk(const char* buf, Chunk& ch, int32_t* rows, int32_t* cols,
                 double* vals, int pattern) {
    // std::from_chars: locale-free, ~3x strtod throughput (the float parse
    // dominates the whole load for real-valued matrices)
    const char* p = ch.begin;
    long long i = ch.offset;
    while (p < ch.end) {
        const char* nl = (const char*)memchr(p, '\n', ch.end - p);
        const char* line_end = nl ? nl : ch.end;
        if (is_entry_line(p, line_end)) {
            long long r = 0, c = 0;
            p = skip_ws(p, line_end);
            auto res = std::from_chars(p, line_end, r);
            // reject indices outside [1, INT32_MAX]: a silent int32 wrap
            // would deposit the value at a bogus in-bounds coordinate
            if (res.ec != std::errc() || r < 1 || r > INT32_MAX) {
                ch.bad_at = p - buf; return;
            }
            p = skip_ws(res.ptr, line_end);
            res = std::from_chars(p, line_end, c);
            if (res.ec != std::errc() || c < 1 || c > INT32_MAX) {
                ch.bad_at = p - buf; return;
            }
            p = res.ptr;
            double v = 1.0;
            if (!pattern) {
                p = skip_ws(p, line_end);
                // from_chars rejects a leading '+' that strtod accepts;
                // MatrixMarket writers never emit it, but tolerate it
                if (p < line_end && *p == '+') ++p;
                auto fres = std::from_chars(p, line_end, v);
                if (fres.ec != std::errc()) { ch.bad_at = p - buf; return; }
            }
            rows[i] = (int32_t)(r - 1);
            cols[i] = (int32_t)(c - 1);
            vals[i] = v;
            ++i;
        }
        p = nl ? nl + 1 : ch.end;
    }
}

}  // namespace

extern "C" {

long long mtx_parse_body(const char* buf, long long len, int32_t* rows,
                         int32_t* cols, double* vals, long long max_entries,
                         int pattern, int n_threads) {
    if (len <= 0) return 0;
    unsigned hw = std::thread::hardware_concurrency();
    int T = n_threads > 0 ? n_threads : (hw ? (int)hw : 4);
    // small bodies: threading overhead dominates
    if (len < (1 << 20)) T = 1;
    T = (int)std::max<long long>(1, std::min<long long>(T, len / 4096 + 1));

    // split at line boundaries
    std::vector<Chunk> chunks;
    chunks.reserve(T);
    const char* pos = buf;
    const char* end = buf + len;
    long long target = len / T;
    for (int t = 0; t < T && pos < end; ++t) {
        const char* stop = (t == T - 1) ? end
                                        : std::min(end, pos + target);
        if (stop < end) {
            const char* nl = (const char*)memchr(stop, '\n', end - stop);
            stop = nl ? nl + 1 : end;
        }
        chunks.push_back({pos, stop});
        pos = stop;
    }

    // phase 1: count
    {
        std::vector<std::thread> ts;
        for (auto& ch : chunks)
            ts.emplace_back(count_chunk, std::ref(ch));
        for (auto& th : ts) th.join();
    }
    long long total = 0;
    for (auto& ch : chunks) {
        ch.offset = total;
        total += ch.n_entries;
    }
    // distinct sentinel beyond any valid -(byte offset + 1)
    if (total > max_entries) return -(len + 2);

    // phase 2: parse into place
    {
        std::vector<std::thread> ts;
        for (auto& ch : chunks)
            ts.emplace_back(parse_chunk, buf, std::ref(ch), rows, cols, vals,
                            pattern);
        for (auto& th : ts) th.join();
    }
    for (auto& ch : chunks)
        if (ch.bad_at >= 0) return -(ch.bad_at + 1);
    return total;
}

}  // extern "C"
