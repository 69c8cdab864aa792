// The relay front's scan of a SyncRequest body (protobuf fields 1-6, see
// sync/protocol.py) into the packed columns the engine inserts.
//
// It accepts only the canonical shape that every client encoder writes:
// each field-1 entry is an EncryptedCrdtMessage whose only fields are a
// 46-byte ASCII timestamp (field 1) and length-delimited content (field
// 2), each once and in that order; fields 2-5 are length-delimited; no
// scope clause (field 6) and no unknown field. Anything else is declined
// (-1), never an error: the caller then decodes the body with the Python
// decoder, which owns the error surface. Varints longer than 5 bytes are
// declined too, so no value here can overflow.
//
// Built by utils/native_loader with g++ (no library linked) and called
// through ctypes, which releases the GIL for the call.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kTsLen = 46;
constexpr int64_t kMaxCaps = 64;  // protocol._MAX_CAPABILITIES
constexpr uint64_t kTsKey = (1 << 3) | 2;       // EncryptedCrdtMessage.timestamp
constexpr uint64_t kContentKey = (2 << 3) | 2;  // EncryptedCrdtMessage.content

bool read_varint(const uint8_t* p, int64_t end, int64_t& pos, uint64_t& out) {
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i) {
        if (pos >= end) return false;
        const uint8_t b = p[pos++];
        v |= uint64_t(b & 0x7F) << (7 * i);
        if (!(b & 0x80)) {
            out = v;
            return true;
        }
    }
    return false;
}

// A length-delimited value at `pos`: sets [start, stop) and moves past it.
bool read_span(const uint8_t* p, int64_t end, int64_t& pos, int64_t& start, int64_t& stop) {
    uint64_t n;
    if (!read_varint(p, end, pos, n) || n > uint64_t(end - pos)) return false;
    start = pos;
    stop = pos + int64_t(n);
    pos = stop;
    return true;
}

bool all_distinct(const uint8_t* ts, int64_t n) {
    // Clients send their rows in timestamp order: strictly increasing rows
    // are distinct with one pass; any other order is sorted.
    bool increasing = true;
    for (int64_t i = 1; i < n && increasing; ++i)
        increasing = std::memcmp(ts + (i - 1) * kTsLen, ts + i * kTsLen, kTsLen) < 0;
    if (increasing) return true;
    std::vector<int64_t> ix(n);
    for (int64_t i = 0; i < n; ++i) ix[i] = i;
    std::sort(ix.begin(), ix.end(), [ts](int64_t a, int64_t b) {
        return std::memcmp(ts + a * kTsLen, ts + b * kTsLen, kTsLen) < 0;
    });
    for (int64_t i = 1; i < n; ++i)
        if (std::memcmp(ts + ix[i - 1] * kTsLen, ts + ix[i] * kTsLen, kTsLen) == 0) return false;
    return true;
}

}  // namespace

extern "C" {

// Scan `body` (`len` bytes). Writes row i's timestamp to ts_out[46 i ..],
// its content to content_out (packed in order; room for `len` bytes) and
// its length to lens_out[i]; `cap_rows` bounds the rows. `spans` gets
// [userId off, len, nodeId off, len, merkleTree off, len, capability
// count, then (off, len) of each capability]: 7 + 2 * 64 slots; an absent
// field is (0, 0) and the last occurrence of a repeated one wins, as in
// the Python decoder. `distinct` gets 1 when no two timestamps are equal.
// Returns the row count, or -1 when the body is not canonical.
int64_t ws_scan_sync_request(const uint8_t* body, int64_t len, int64_t cap_rows,
                             uint8_t* ts_out, uint8_t* content_out, int32_t* lens_out,
                             int64_t* spans, int32_t* distinct) {
    std::memset(spans, 0, sizeof(int64_t) * (7 + 2 * kMaxCaps));
    int64_t pos = 0, n = 0, content_off = 0, caps = 0;
    while (pos < len) {
        uint64_t key;
        int64_t start, stop;
        if (!read_varint(body, len, pos, key) || (key & 7) != 2) return -1;
        if (!read_span(body, len, pos, start, stop)) return -1;
        const uint64_t field = key >> 3;
        if (field == 1) {
            int64_t q = start, ts0, ts1, c0, c1;
            uint64_t k;
            if (!read_varint(body, stop, q, k) || k != kTsKey) return -1;
            if (!read_span(body, stop, q, ts0, ts1) || ts1 - ts0 != kTsLen) return -1;
            for (int64_t i = ts0; i < ts1; ++i)
                if (body[i] & 0x80) return -1;
            if (!read_varint(body, stop, q, k) || k != kContentKey) return -1;
            if (!read_span(body, stop, q, c0, c1) || c1 != stop) return -1;
            if (n >= cap_rows) return -1;
            std::memcpy(ts_out + n * kTsLen, body + ts0, kTsLen);
            std::memcpy(content_out + content_off, body + c0, size_t(c1 - c0));
            lens_out[n++] = int32_t(c1 - c0);
            content_off += c1 - c0;
        } else if (field >= 2 && field <= 4) {
            spans[2 * (field - 2)] = start;
            spans[2 * (field - 2) + 1] = stop - start;
        } else if (field == 5) {
            if (caps >= kMaxCaps) return -1;
            spans[7 + 2 * caps] = start;
            spans[8 + 2 * caps] = stop - start;
            spans[6] = ++caps;
        } else {
            return -1;
        }
    }
    *distinct = all_distinct(ts_out, n) ? 1 : 0;
    return n;
}

}  // extern "C"
