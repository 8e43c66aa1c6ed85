// Native point ingest: bulk CSV/TSV + GeoJSON point parsing (a copy of the
// point parsers of spatialflink_tpu/native/ingest.cpp, same C signatures,
// FNV-1a 64 id hashes and reject rules).
//
// The reference parses one tuple at a time in a JVM deserializer
// (spatialStreams/Deserialization.java:288-330 CSV schema parse, :167-207
// GeoJSON trajectory parse); here the host must keep a card fed, so the
// line -> arrays conversion is a single C++ pass producing the
// structure-of-arrays a PointBatch wraps.
//
// Contract (shared with streams/bulk.py):
// - Input is a '\0'-terminated buffer of '\n'-separated records.
// - Outputs are preallocated arrays of capacity >= number of lines.
// - Object ids are returned as FNV-1a 64 hashes plus (start, len) spans into
//   the input buffer; Python interns one representative string per unique
//   hash (collisions at 64-bit are negligible for stream cardinalities).
// - Records the parser cannot handle exactly (ISO timestamps, non-point
//   GeoJSON, malformed lines) are NOT errors: their line indices go to
//   `rejects` and Python re-parses just those with the full-fidelity parser.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (see native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint64_t fnv1a(const char* s, long n) {
    uint64_t h = 1469598103934665603ULL;
    for (long i = 0; i < n; i++) {
        h ^= (unsigned char)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

inline const char* rskip_ws(const char* begin, const char* p) {
    while (p > begin && (p[-1] == ' ' || p[-1] == '\t' || p[-1] == '\r')) p--;
    return p;
}

// Parse an integer timestamp field. Digits-only, mirroring
// formats.parse_timestamp (which passes `s.isdigit()` strings through as
// ints and sends everything else — ISO dates, signs, floats — down the
// strptime path); any other shape is rejected to Python.
inline bool parse_int_field(const char* s, const char* end, int64_t* out) {
    if (s >= end) return false;
    for (const char* p = s; p < end; p++)
        if (*p < '0' || *p > '9') return false;
    *out = (int64_t)strtoll(s, nullptr, 10);
    return true;
}

inline bool parse_double_field(const char* s, const char* end, double* out) {
    char* stop = nullptr;
    double v = strtod(s, &stop);
    if (stop == s) return false;
    const char* rest = skip_ws(stop, end);
    if (rest != end) return false;
    *out = v;
    return true;
}

struct Span {
    const char* start;
    const char* end;
};

// Trim whitespace and one layer of double quotes (parse_csv strips '"').
inline Span trim_field(const char* s, const char* e) {
    s = skip_ws(s, e);
    e = rskip_ws(s, e);
    if (e - s >= 2 && *s == '"' && e[-1] == '"') {
        s++;
        e--;
    }
    return {s, e};
}

}  // namespace

extern "C" {

// Returns number of accepted records. Lines that need the Python parser are
// appended to rejects (their 0-based line index); blank lines are skipped
// entirely. Schema indices: oi (objID), ti (timestamp), xi, yi; oi/ti may be
// -1 (absent). Capacity of all output arrays must be >= the line count.
long sf_parse_points_csv(const char* buf, long len, char delim,
                         int oi, int ti, int xi, int yi,
                         double* xs, double* ys, int64_t* ts,
                         uint64_t* oid_hash, int64_t* oid_start,
                         int32_t* oid_len,
                         int64_t* rejects, long* n_rejects) {
    long count = 0;
    long nrej = 0;
    long line_idx = -1;
    const char* end = buf + len;
    const char* p = buf;
    int max_field = xi > yi ? xi : yi;
    if (oi > max_field) max_field = oi;
    if (ti > max_field) max_field = ti;

    while (p < end) {
        line_idx++;
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        const char* ls = p;
        p = line_end + 1;

        // skip blank lines without consuming a record slot
        {
            const char* t = skip_ws(ls, line_end);
            if (t == rskip_ws(t, line_end)) {
                line_idx--;
                continue;
            }
        }

        // split into fields up to the max index we need
        Span fields[64];
        int nf = 0;
        const char* fs = ls;
        const char* q = ls;
        bool overflow = false;
        while (q <= line_end && nf <= max_field) {
            if (q == line_end || *q == delim) {
                if (nf >= 64) {
                    overflow = true;
                    break;
                }
                fields[nf++] = trim_field(fs, q);
                fs = q + 1;
            }
            q++;
        }
        if (overflow || nf <= max_field) {
            rejects[nrej++] = line_idx;
            continue;
        }

        double x, y;
        if (!parse_double_field(fields[xi].start, fields[xi].end, &x) ||
            !parse_double_field(fields[yi].start, fields[yi].end, &y)) {
            rejects[nrej++] = line_idx;
            continue;
        }
        int64_t t = 0;
        if (ti >= 0 &&
            !parse_int_field(fields[ti].start, fields[ti].end, &t)) {
            rejects[nrej++] = line_idx;  // ISO date etc. -> Python
            continue;
        }
        if (oi >= 0) {
            // Normalize the id exactly like the Python parser: remove every
            // '"' (parse_csv does line.replace('"', '')), then trim
            // whitespace. The hash is over the normalized bytes; the Python
            // side applies the same normalization when materializing the
            // span. Oversized ids take the Python path.
            const Span& f = fields[oi];
            char tmp[256];
            long m = 0;
            bool toolong = false;
            for (const char* q2 = f.start; q2 < f.end; q2++) {
                if (*q2 == '"') continue;
                if (m >= (long)sizeof(tmp)) {
                    toolong = true;
                    break;
                }
                tmp[m++] = *q2;
            }
            if (toolong) {
                rejects[nrej++] = line_idx;
                continue;
            }
            long b = 0;
            while (b < m && (tmp[b] == ' ' || tmp[b] == '\t' || tmp[b] == '\r'))
                b++;
            while (m > b &&
                   (tmp[m - 1] == ' ' || tmp[m - 1] == '\t' || tmp[m - 1] == '\r'))
                m--;
            oid_hash[count] = fnv1a(tmp + b, m - b);
            oid_start[count] = f.start - buf;
            oid_len[count] = (int32_t)(f.end - f.start);
        } else {
            oid_hash[count] = fnv1a(nullptr, 0);
            oid_start[count] = 0;
            oid_len[count] = 0;
        }
        xs[count] = x;
        ys[count] = y;
        ts[count] = t;
        count++;
    }
    *n_rejects = nrej;
    return count;
}

namespace {

// One past the matching close of the JSON object/array starting at p
// (which must point at '{' or '['), quote-aware; nullptr if unbalanced.
inline const char* match_close(const char* p, const char* end) {
    char open = *p;
    char close = (open == '{') ? '}' : ']';
    int depth = 0;
    bool instr = false;
    for (const char* q = p; q < end; q++) {
        char c = *q;
        if (instr) {
            if (c == '\\')
                q++;
            else if (c == '"')
                instr = false;
        } else if (c == '"') {
            instr = true;
        } else if (c == open) {
            depth++;
        } else if (c == close) {
            if (--depth == 0) return q + 1;
        }
    }
    return nullptr;
}

// Find `"key"` within [s, end) and return a pointer to its value (first
// non-ws char after the colon). Flat scan — callers narrow [s, end) to the
// owning JSON object first; a miss sends the line to Python.
inline const char* find_key(const char* s, const char* end, const char* key,
                            long key_len) {
    const char* p = s;
    while (p + key_len + 2 <= end) {
        const char* hit =
            (const char*)memchr(p, '"', end - p - key_len - 1);
        if (!hit) return nullptr;
        if (memcmp(hit + 1, key, key_len) == 0 && hit[key_len + 1] == '"') {
            const char* after = skip_ws(hit + key_len + 2, end);
            if (after < end && *after == ':') return skip_ws(after + 1, end);
        }
        p = hit + 1;
    }
    return nullptr;
}

// Kafka-envelope unwrap ({"...": ..., "value": {...}}) followed by
// geometry-object narrowing for one GeoJSON record line [ls, le):
// *rs/*re get the record region (the properties scope), *cs/*ce the
// coordinates scope ("geometry" object when present, else the record).
// Returns false -> reject the line to Python. Shared by the point and
// geometry parsers.
inline bool narrow_geojson_record(const char* ls, const char* le,
                                  const char** rs_out, const char** re_out,
                                  const char** cs_out, const char** ce_out) {
    const char* rs = ls;
    const char* re = le;
    {
        const char* v = find_key(rs, re, "value", 5);
        if (v && *v == '{') {
            const char* ve = match_close(v, re);
            if (!ve) return false;
            rs = v;
            re = ve;
        }
    }
    const char* cs = rs;
    const char* ce = re;
    {
        const char* gkey = find_key(rs, re, "geometry", 8);
        if (gkey) {
            if (*gkey != '{') return false;
            ce = match_close(gkey, re);
            if (!ce) return false;
            cs = gkey;
        }
    }
    *rs_out = rs;
    *re_out = re;
    *cs_out = cs;
    *ce_out = ce;
    return true;
}

// properties[oid_key] / properties[ts_key] from the record region [rs, re).
// Mirrors formats.parse_geojson: absent/null properties -> empty id / ts 0;
// escaped strings, bool ids and non-integer timestamps are not representable
// here. Returns false -> send the line to Python. Shared by the GeoJSON
// point and geometry parsers.
inline bool parse_props_oid_ts(const char* buf, const char* rs, const char* re,
                               const char* oid_key, long oid_key_len,
                               const char* ts_key, long ts_key_len,
                               uint64_t* oh_out, int64_t* os_out,
                               int32_t* ol_out, int64_t* ts_out) {
    const char* ps = nullptr;
    const char* pe = nullptr;
    {
        const char* pkey = find_key(rs, re, "properties", 10);
        if (pkey && *pkey == '{') {
            pe = match_close(pkey, re);
            if (!pe) return false;
            ps = pkey;
        }
    }
    uint64_t oh = fnv1a(nullptr, 0);
    int64_t os = 0;
    int32_t ol = 0;
    if (oid_key_len && ps) {
        const char* v = find_key(ps, pe, oid_key, oid_key_len);
        if (v) {
            const char* vs;
            const char* ve;
            if (*v == '"') {
                vs = v + 1;
                ve = (const char*)memchr(vs, '"', pe - vs);
                // escapes need real JSON decoding -> Python
                if (!ve || memchr(vs, '\\', ve - vs)) return false;
            } else {  // bare number / literal: up to , } ]
                vs = v;
                ve = v;
                while (ve < pe && *ve != ',' && *ve != '}' && *ve != ']') ve++;
                ve = rskip_ws(vs, ve);
                long n_tok = ve - vs;
                if (n_tok == 4 && memcmp(vs, "null", 4) == 0) {
                    vs = ve;  // bare JSON null => empty id
                } else if ((n_tok == 4 && memcmp(vs, "true", 4) == 0) ||
                           (n_tok == 5 && memcmp(vs, "false", 5) == 0)) {
                    return false;  // str(True) capitalizes -> Python
                }
            }
            oh = fnv1a(vs, ve - vs);
            os = vs - buf;
            ol = (int32_t)(ve - vs);
        }
    }
    int64_t t = 0;
    if (ts_key_len && ps) {
        const char* v = find_key(ps, pe, ts_key, ts_key_len);
        if (v) {
            const char* vs = v;
            const char* ve;
            if (*v == '"') {  // quoted: integer ok, ISO date -> Python
                vs = v + 1;
                ve = (const char*)memchr(vs, '"', pe - vs);
            } else {
                ve = v;
                while (ve < pe && *ve != ',' && *ve != '}') ve++;
                ve = rskip_ws(vs, ve);
            }
            if (!ve || !parse_int_field(vs, ve, &t)) return false;
        }
    }
    *oh_out = oh;
    *os_out = os;
    *ol_out = ol;
    *ts_out = t;
    return true;
}

}  // namespace

// GeoJSON fast path: extracts Point coordinates plus the oID / timestamp
// properties (reference: Deserialization.java:167-207 pulls
// properties[oID] / properties[timestamp]). Non-Point geometries, quoted
// non-integer timestamps and anything surprising goes to `rejects`.
long sf_parse_points_geojson(const char* buf, long len,
                             const char* oid_key, const char* ts_key,
                             double* xs, double* ys, int64_t* ts,
                             uint64_t* oid_hash, int64_t* oid_start,
                             int32_t* oid_len,
                             int64_t* rejects, long* n_rejects) {
    long count = 0;
    long nrej = 0;
    long line_idx = -1;
    long oid_key_len = oid_key ? (long)strlen(oid_key) : 0;
    long ts_key_len = ts_key ? (long)strlen(ts_key) : 0;
    const char* end = buf + len;
    const char* p = buf;

    while (p < end) {
        line_idx++;
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        const char* ls = p;
        p = line_end + 1;

        {
            const char* t = skip_ws(ls, line_end);
            if (t == rskip_ws(t, line_end)) {
                line_idx--;
                continue;
            }
        }

        // envelope unwrap ("value" object, so envelope-level keys like the
        // broker "timestamp" are never picked up) + geometry narrowing
        // (bare-geometry records are scanned whole; "geometry": null etc.
        // goes to Python) — shared helper with the geometry parser
        const char* rs;
        const char* re;
        const char* cs;
        const char* ce;
        if (!narrow_geojson_record(ls, line_end, &rs, &re, &cs, &ce)) {
            rejects[nrej++] = line_idx;
            continue;
        }
        const char* c = find_key(cs, ce, "coordinates", 11);
        if (!c || *c != '[') {
            rejects[nrej++] = line_idx;
            continue;
        }
        const char* q = skip_ws(c + 1, ce);
        if (q < ce && *q == '[') {  // nested => not a Point
            rejects[nrej++] = line_idx;
            continue;
        }
        char* stop = nullptr;
        double x = strtod(q, &stop);
        if (stop == q) {
            rejects[nrej++] = line_idx;
            continue;
        }
        q = skip_ws(stop, ce);
        if (q >= ce || *q != ',') {
            rejects[nrej++] = line_idx;
            continue;
        }
        double y = strtod(q + 1, &stop);
        if (stop == q + 1) {
            rejects[nrej++] = line_idx;
            continue;
        }

        // oID / timestamp from the "properties" object (shared helper with
        // the geometry parser below)
        uint64_t oh;
        int64_t os, t;
        int32_t ol;
        if (!parse_props_oid_ts(buf, rs, re, oid_key, oid_key_len,
                                ts_key, ts_key_len, &oh, &os, &ol, &t)) {
            rejects[nrej++] = line_idx;
            continue;
        }

        xs[count] = x;
        ys[count] = y;
        ts[count] = t;
        oid_hash[count] = oh;
        oid_start[count] = os;
        oid_len[count] = ol;
        count++;
    }
    *n_rejects = nrej;
    return count;
}

}  // extern "C"
