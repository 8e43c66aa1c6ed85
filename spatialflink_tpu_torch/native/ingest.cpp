// Native ingest: bulk CSV/TSV + GeoJSON point parsing and bulk WKT + GeoJSON
// polygon/linestring parsing (a copy of spatialflink_tpu/native/ingest.cpp:
// same C signatures, FNV-1a 64 id hashes and reject rules).
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

// ------------------------------------------------------------------------- //
// Bulk WKT geometry parsing: POLYGON / LINESTRING lines with optional
// "oid<delim>ts<delim>" prefix fields -> flattened ring/vertex arrays.
//
// The reference parses one tuple at a time (spatialStreams/
// Deserialization.java:516-628 WKTToSpatialPolygon/LineString and the
// convertCoordinates family :1367-1565); here one C++ pass over a block
// emits the structure the EdgeGeomBatch assembler vectorizes over.
// MULTI*/GEOMETRYCOLLECTION/POINT lines reject to the Python parser (full
// fidelity), exactly like the point parsers' reject contract.

namespace {

inline bool is_word(char c) {
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') || c == '_';
}

// Find the first boundary-respecting occurrence of kw in [s, e).
inline const char* find_kw(const char* s, const char* e, const char* kw,
                           long kwlen) {
    for (const char* p = s; p + kwlen <= e; p++) {
        if ((p == s || !is_word(p[-1])) && memcmp(p, kw, kwlen) == 0 &&
            (p + kwlen == e || !is_word(p[kwlen])))
            return p;
    }
    return nullptr;
}

}  // namespace

extern "C" {

// Returns number of accepted records; per-record arrays sized >= line count,
// ring arrays >= count('('), vertex arrays >= count(',') + count('(') + 2.
// bbox is (cap, 4) row-major [minx, miny, maxx, maxy].
long sf_parse_wkt_geoms(const char* buf, long len, char delim,
                        int64_t* ts, uint64_t* oid_hash, int64_t* oid_start,
                        int32_t* oid_len, int8_t* is_poly,
                        int64_t* ring_off, int32_t* ring_cnt, double* bbox,
                        int64_t* ring_voff, int32_t* ring_size,
                        double* vx, double* vy,
                        int64_t* rejects, long* n_rejects) {
    long count = 0, nrej = 0, line_idx = -1;
    long n_rings = 0, n_verts = 0;
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

        const char* kp = find_kw(ls, line_end, "POLYGON", 7);
        const char* kl = find_kw(ls, line_end, "LINESTRING", 10);
        const char* kw = kp && (!kl || kp < kl) ? kp : kl;
        bool poly = (kw == kp && kp != nullptr);
        long kwlen = poly ? 7 : 10;
        if (!kw) {  // POINT / MULTI* / GEOMETRYCOLLECTION / junk -> Python
            rejects[nrej++] = line_idx;
            continue;
        }
        // the keyword must not sit inside an outer structure's parens
        // (a POLYGON inside a GEOMETRYCOLLECTION body): prefix paren
        // balance must be zero, like formats.parse_wkt's guard
        long bal = 0;
        for (const char* q = ls; q < kw; q++) {
            if (*q == '(') bal++;
            else if (*q == ')') bal--;
        }
        if (bal != 0) {
            rejects[nrej++] = line_idx;
            continue;
        }

        // prefix fields before the keyword: [oid][delim][ts][delim]
        uint64_t oh = fnv1a(nullptr, 0);
        int64_t osp = 0;
        int32_t oln = 0;
        int64_t tval = 0;
        {
            const char* pe = rskip_ws(ls, kw);
            // drop one trailing delimiter separating the fields from the
            // geometry, then split what remains
            if (pe > ls && pe[-1] == delim) pe--;
            if (pe > ls) {
                Span fields[8];
                int nf = 0;
                const char* fs = ls;
                bool overflow = false;
                for (const char* q = ls; q <= pe; q++) {
                    if (q == pe || *q == delim) {
                        if (nf >= 8) { overflow = true; break; }
                        Span f = trim_field(fs, q);
                        // drop empty fields ANYWHERE, like the Python WKT
                        // branch's `if f.strip()` filter — keeping an
                        // interior empty would shift the timestamp slot
                        if (f.start != f.end)
                            fields[nf++] = f;
                        fs = q + 1;
                    }
                }
                if (overflow) {
                    rejects[nrej++] = line_idx;
                    continue;
                }
                if (nf >= 1 && fields[0].start != fields[0].end) {
                    // normalize like the Python WKT branch: strip quotes
                    char tmp[256];
                    long m = 0;
                    bool toolong = false;
                    for (const char* q2 = fields[0].start;
                         q2 < fields[0].end; q2++) {
                        if (*q2 == '"') continue;
                        if (m >= (long)sizeof(tmp)) { toolong = true; break; }
                        tmp[m++] = *q2;
                    }
                    if (toolong) {
                        rejects[nrej++] = line_idx;
                        continue;
                    }
                    oh = fnv1a(tmp, m);
                    osp = fields[0].start - buf;
                    oln = (int32_t)(fields[0].end - fields[0].start);
                }
                if (nf >= 2 && fields[1].start != fields[1].end &&
                    !parse_int_field(fields[1].start, fields[1].end, &tval)) {
                    rejects[nrej++] = line_idx;  // date-formatted ts -> Python
                    continue;
                }
            }
        }

        // geometry body
        const char* q = skip_ws(kw + kwlen, line_end);
        if (q >= line_end || *q != '(') {
            rejects[nrej++] = line_idx;
            continue;
        }
        q++;
        long rstart = n_rings, vstart_total = n_verts;
        bool bad = false;
        double minx = 0, miny = 0, maxx = 0, maxy = 0;
        bool first_v = true;
        int rings_here = 0;

        auto parse_ring = [&](const char*& q, const char* term) -> bool {
            // vertices "x y" separated by ','; stops at the char in `term`
            long vstart = n_verts;
            while (true) {
                q = skip_ws(q, line_end);
                char* stop = nullptr;
                double x = strtod(q, &stop);
                if (stop == q) return false;
                q = skip_ws(stop, line_end);
                double y = strtod(q, &stop);
                if (stop == q) return false;
                q = skip_ws(stop, line_end);
                vx[n_verts] = x;
                vy[n_verts] = y;
                n_verts++;
                if (first_v) {
                    minx = maxx = x;
                    miny = maxy = y;
                    first_v = false;
                } else {
                    if (x < minx) minx = x;
                    if (x > maxx) maxx = x;
                    if (y < miny) miny = y;
                    if (y > maxy) maxy = y;
                }
                if (q < line_end && *q == ',') {
                    q++;
                    continue;
                }
                if (q < line_end && *q == *term) {
                    ring_voff[n_rings] = vstart;
                    ring_size[n_rings] = (int32_t)(n_verts - vstart);
                    n_rings++;
                    rings_here++;
                    return true;
                }
                return false;  // z coordinate / junk -> Python
            }
        };

        if (poly) {
            while (true) {
                q = skip_ws(q, line_end);
                if (q >= line_end || *q != '(') { bad = true; break; }
                q++;
                if (!parse_ring(q, ")")) { bad = true; break; }
                q++;  // consume ')'
                q = skip_ws(q, line_end);
                if (q < line_end && *q == ',') { q++; continue; }
                if (q < line_end && *q == ')') { q++; break; }
                bad = true;
                break;
            }
            if (!bad) {
                // every raw ring needs >= 3 vertices (Polygon.create drops
                // smaller ones / raises; let Python own that semantics)
                for (long r = rstart; r < n_rings; r++)
                    if (ring_size[r] < 3) { bad = true; break; }
            }
        } else {
            if (!parse_ring(q, ")")) bad = true;
            else {
                q++;  // consume ')'
                if (ring_size[n_rings - 1] < 2) bad = true;
            }
        }
        if (!bad) {
            q = skip_ws(q, line_end);
            if (q != rskip_ws(ls, line_end)) bad = true;  // trailing junk
        }
        if (bad) {
            n_rings = rstart;  // roll back this line's ring/vertex output
            n_verts = vstart_total;
            rejects[nrej++] = line_idx;
            continue;
        }

        ts[count] = tval;
        oid_hash[count] = oh;
        oid_start[count] = osp;
        oid_len[count] = oln;
        is_poly[count] = poly ? 1 : 0;
        ring_off[count] = rstart;
        ring_cnt[count] = rings_here;
        bbox[count * 4 + 0] = minx;
        bbox[count * 4 + 1] = miny;
        bbox[count * 4 + 2] = maxx;
        bbox[count * 4 + 3] = maxy;
        count++;
    }
    *n_rejects = nrej;
    return count;
}

}  // extern "C" (wkt geometry parser)

// ------------------------------------------------------------------------- //
// Bulk GeoJSON geometry parsing: Polygon / LineString features -> the same
// flattened ring/vertex layout as sf_parse_wkt_geoms.
//
// The block form of the reference's per-tuple GeoJSON polygon/
// linestring deserializers (spatialStreams/Deserialization.java:236-334
// GeoJSONToSpatialPolygon/LineString; properties[oID]/properties[timestamp]
// extraction as in :167-207). Point / Multi* / GeometryCollection features,
// escaped strings and date-formatted timestamps reject to the Python parser
// (full fidelity), exactly like the point parser's reject contract.

extern "C" {

// Output contract identical to sf_parse_wkt_geoms; ring arrays must be
// sized >= count('['), vertex arrays >= count('[') + 2.
long sf_parse_geojson_geoms(const char* buf, long len,
                            const char* oid_key, const char* ts_key,
                            int64_t* ts, uint64_t* oid_hash,
                            int64_t* oid_start, int32_t* oid_len,
                            int8_t* is_poly,
                            int64_t* ring_off, int32_t* ring_cnt, double* bbox,
                            int64_t* ring_voff, int32_t* ring_size,
                            double* vx, double* vy,
                            int64_t* rejects, long* n_rejects) {
    long count = 0, nrej = 0, line_idx = -1;
    long n_rings = 0, n_verts = 0;
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
            const char* t0 = skip_ws(ls, line_end);
            if (t0 == rskip_ws(t0, line_end)) {
                line_idx--;
                continue;
            }
        }

        // envelope unwrap + geometry-object narrowing (shared helper with
        // the point parser)
        const char* rs;
        const char* re;
        const char* cs;
        const char* ce;
        if (!narrow_geojson_record(ls, line_end, &rs, &re, &cs, &ce)) {
            rejects[nrej++] = line_idx;
            continue;
        }
        // geometry type must be exactly Polygon or LineString
        bool poly;
        {
            const char* tv = find_key(cs, ce, "type", 4);
            if (!tv || *tv != '"') { rejects[nrej++] = line_idx; continue; }
            const char* tvs = tv + 1;
            const char* tve = (const char*)memchr(tvs, '"', ce - tvs);
            if (!tve) { rejects[nrej++] = line_idx; continue; }
            long tn = tve - tvs;
            if (tn == 7 && memcmp(tvs, "Polygon", 7) == 0)
                poly = true;
            else if (tn == 10 && memcmp(tvs, "LineString", 10) == 0)
                poly = false;
            else { rejects[nrej++] = line_idx; continue; }
        }
        const char* c = find_key(cs, ce, "coordinates", 11);
        if (!c || *c != '[') { rejects[nrej++] = line_idx; continue; }
        const char* cend = match_close(c, ce);
        if (!cend) { rejects[nrej++] = line_idx; continue; }

        uint64_t oh;
        int64_t os_v, tval;
        int32_t ol_v;
        if (!parse_props_oid_ts(buf, rs, re, oid_key, oid_key_len,
                                ts_key, ts_key_len,
                                &oh, &os_v, &ol_v, &tval)) {
            rejects[nrej++] = line_idx;
            continue;
        }

        // walk the coordinate nest: Polygon [[[x,y],..],..] (points at
        // depth 3, each depth-2 '[' opens a ring); LineString [[x,y],..]
        // (points at depth 2, the depth-1 '[' IS the single ring). A
        // trailing z in a point array is skipped; deeper nesting is
        // malformed for these types and rejects.
        const int pt_depth = poly ? 3 : 2;
        const int ring_depth = poly ? 2 : 1;
        long rec_rings = 0;
        const long saved_rings = n_rings, saved_verts = n_verts;
        double minx = 1e308, miny = 1e308, maxx = -1e308, maxy = -1e308;
        bool bad = false;
        int depth = 0;
        const char* q = c;
        while (q < cend) {
            char ch = *q;
            if (ch == '[') {
                depth++;
                if (depth > pt_depth) { bad = true; break; }
                if (depth == ring_depth) {
                    ring_voff[n_rings] = n_verts;
                    ring_size[n_rings] = 0;
                    n_rings++;
                    rec_rings++;
                }
                if (depth == pt_depth) {
                    const char* s2 = skip_ws(q + 1, cend);
                    char* stop = nullptr;
                    double x = strtod(s2, &stop);
                    if (stop == s2) { bad = true; break; }
                    s2 = skip_ws(stop, cend);
                    if (s2 >= cend || *s2 != ',') { bad = true; break; }
                    double y = strtod(s2 + 1, &stop);
                    if (stop == s2 + 1) { bad = true; break; }
                    const char* pc =
                        (const char*)memchr(stop, ']', cend - stop);
                    if (!pc) { bad = true; break; }
                    vx[n_verts] = x;
                    vy[n_verts] = y;
                    ring_size[n_rings - 1]++;
                    n_verts++;
                    if (x < minx) minx = x;
                    if (x > maxx) maxx = x;
                    if (y < miny) miny = y;
                    if (y > maxy) maxy = y;
                    depth--;
                    q = pc + 1;
                    continue;
                }
                q++;
            } else if (ch == ']') {
                depth--;
                q++;
                if (depth == 0) break;
            } else {
                q++;
            }
        }
        // empty / degenerate (sub-2-vertex ring) shapes -> Python, which
        // owns the full error story
        bool tiny = (rec_rings == 0 || n_verts == saved_verts);
        for (long r = saved_rings; !tiny && r < n_rings; r++)
            if (ring_size[r] < 2) tiny = true;
        if (bad || tiny) {
            n_rings = saved_rings;
            n_verts = saved_verts;
            rejects[nrej++] = line_idx;
            continue;
        }
        ts[count] = tval;
        oid_hash[count] = oh;
        oid_start[count] = os_v;
        oid_len[count] = ol_v;
        is_poly[count] = poly ? 1 : 0;
        ring_off[count] = saved_rings;
        ring_cnt[count] = (int32_t)rec_rings;
        bbox[count * 4 + 0] = minx;
        bbox[count * 4 + 1] = miny;
        bbox[count * 4 + 2] = maxx;
        bbox[count * 4 + 3] = maxy;
        count++;
    }
    *n_rejects = nrej;
    return count;
}

}  // extern "C" (geojson geometry parser)
