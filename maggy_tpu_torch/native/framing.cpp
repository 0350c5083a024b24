// Control-plane wire codec: SHA-256, HMAC-SHA256, and frame scanning.
//
// The port's copy of maggy_tpu/native/framing.cpp, unchanged below this
// header. The driver-side server authenticates and reassembles every
// runner's frames; this codec verifies HMACs and scans length-prefixed
// frames out of connection buffers in one pass, exported with a plain C ABI
// for ctypes. It also holds the slice-by-8 crc32c and the whole-buffer
// TFRecord scanner of train/tfrecord.py. Host code: nothing here runs on the
// card.
//
// Wire layout: 4-byte big-endian length || 32-byte HMAC || payload (JSON in
// the port, msgpack in the JAX package; the codec never reads the payload).
//
// SHA-256 per FIPS 180-4; implementation written from the spec.

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

struct Sha256 {
  uint32_t h[8];
  uint64_t total = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  Sha256() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof(h));
  }

  void block(const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* data, size_t len) {
    total += len;
    if (buflen) {
      size_t need = 64 - buflen;
      size_t take = len < need ? len : need;
      memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      len -= take;
      if (buflen == 64) { block(buf); buflen = 0; }
    }
    while (len >= 64) { block(data); data += 64; len -= 64; }
    if (len) { memcpy(buf, data, len); buflen = len; }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

void sha256(const uint8_t* data, size_t len, uint8_t out[32]) {
  Sha256 s;
  s.update(data, len);
  s.final(out);
}

void hmac_sha256_impl(const uint8_t* key, size_t keylen, const uint8_t* msg,
                      size_t msglen, uint8_t out[32]) {
  uint8_t k[64] = {0};
  if (keylen > 64) {
    sha256(key, keylen, k);  // hash long keys down
  } else {
    memcpy(k, key, keylen);
  }
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; i++) {
    ipad[i] = k[i] ^ 0x36;
    opad[i] = k[i] ^ 0x5c;
  }
  uint8_t inner[32];
  Sha256 si;
  si.update(ipad, 64);
  si.update(msg, msglen);
  si.final(inner);
  Sha256 so;
  so.update(opad, 64);
  so.update(inner, 32);
  so.final(out);
}

}  // namespace

extern "C" {

// HMAC-SHA256 of msg under key; writes 32 bytes to out.
void maggy_hmac_sha256(const uint8_t* key, size_t keylen, const uint8_t* msg,
                       size_t msglen, uint8_t* out) {
  hmac_sha256_impl(key, keylen, msg, msglen, out);
}

// Constant-time digest comparison (timing-safe like hmac.compare_digest).
int maggy_digest_eq(const uint8_t* a, const uint8_t* b, size_t len) {
  uint8_t acc = 0;
  for (size_t i = 0; i < len; i++) acc |= a[i] ^ b[i];
  return acc == 0;
}

// Scan one frame out of a reassembly buffer.
//   buffer layout: [4-byte BE length][32-byte HMAC][payload]
// Returns:  >0  = total frame size consumed (payload verified; payload
//                 starts at offset 36, length = return - 36)
//            0  = incomplete (need more bytes)
//           -1  = oversized frame (protocol violation; drop connection)
//           -2  = HMAC mismatch (drop connection)
long maggy_frame_scan(const uint8_t* buf, size_t buflen, const uint8_t* key,
                      size_t keylen, size_t max_frame) {
  const size_t header = 4 + 32;
  if (buflen < header) return 0;
  size_t len = (size_t(buf[0]) << 24) | (size_t(buf[1]) << 16) |
               (size_t(buf[2]) << 8) | size_t(buf[3]);
  if (len > max_frame) return -1;
  if (buflen < header + len) return 0;
  uint8_t mac[32];
  hmac_sha256_impl(key, keylen, buf + header, len, mac);
  if (!maggy_digest_eq(mac, buf + 4, 32)) return -2;
  return long(header + len);
}

// ---------------------------------------------------------------- crc32c
// Castagnoli CRC (iSCSI/TFRecord polynomial), slice-by-8 tables: the data
// plane's hot loop for .tfrecord ingestion — pure-Python crc32c runs at
// ~1 MB/s, this at ~GB/s.

namespace {
uint32_t crc_tab[8][256];
// ctypes releases the GIL, so concurrent first calls from runner threads
// race a hand-rolled init flag (UB on weakly-ordered CPUs); call_once
// publishes the table stores with the required fence.
std::once_flag crc_once;

void crc_init() {
  for (int n = 0; n < 256; n++) {
    uint32_t c = uint32_t(n);
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
    crc_tab[0][n] = c;
  }
  for (int n = 0; n < 256; n++) {
    uint32_t c = crc_tab[0][n];
    for (int t = 1; t < 8; t++) {
      c = crc_tab[0][c & 0xFF] ^ (c >> 8);
      crc_tab[t][n] = c;
    }
  }
}

inline uint32_t crc32c_impl(const uint8_t* p, size_t len, uint32_t crc0) {
  std::call_once(crc_once, crc_init);
  uint32_t crc = crc0 ^ 0xFFFFFFFFu;
  while (len >= 8) {
    crc ^= uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
           (uint32_t(p[3]) << 24);
    uint32_t hi = uint32_t(p[4]) | (uint32_t(p[5]) << 8) |
                  (uint32_t(p[6]) << 16) | (uint32_t(p[7]) << 24);
    crc = crc_tab[7][crc & 0xFF] ^ crc_tab[6][(crc >> 8) & 0xFF] ^
          crc_tab[5][(crc >> 16) & 0xFF] ^ crc_tab[4][crc >> 24] ^
          crc_tab[3][hi & 0xFF] ^ crc_tab[2][(hi >> 8) & 0xFF] ^
          crc_tab[1][(hi >> 16) & 0xFF] ^ crc_tab[0][hi >> 24];
    p += 8;
    len -= 8;
  }
  while (len--) crc = crc_tab[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

inline uint32_t masked_crc(const uint8_t* p, size_t len) {
  uint32_t crc = crc32c_impl(p, len, 0);
  return uint32_t(((crc >> 15) | (crc << 17)) + 0xA282EAD8u);
}

inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
}  // namespace

uint32_t maggy_crc32c(const uint8_t* data, size_t len) {
  return crc32c_impl(data, len, 0);
}

// Scan a whole TFRecord buffer:
//   record layout: [8-byte LE length][4-byte masked crc32c(length bytes)]
//                  [payload][4-byte masked crc32c(payload)]
// Fills offs[i]/lens[i] with each payload's offset and length.
// Returns record count (>= 0), or:
//   -1 = truncated record, -2 = crc mismatch, -3 = more than max_records.
long maggy_tfrecord_scan(const uint8_t* buf, size_t buflen, int64_t* offs,
                         int64_t* lens, long max_records, int verify) {
  size_t pos = 0;
  long count = 0;
  while (pos < buflen) {
    if (buflen - pos < 12) return -1;
    uint64_t len = 0;
    for (int i = 7; i >= 0; i--) len = (len << 8) | buf[pos + i];
    if (verify && load_le32(buf + pos + 8) != masked_crc(buf + pos, 8))
      return -2;
    // Untrusted length: compare without forming 12+len+4 (which can wrap
    // for a corrupt length near UINT64_MAX and defeat the bounds check).
    if (len > buflen - pos - 12 || buflen - pos - 12 - len < 4) return -1;
    const uint8_t* payload = buf + pos + 12;
    if (verify && load_le32(payload + len) != masked_crc(payload, len))
      return -2;
    if (count >= max_records) return -3;
    offs[count] = int64_t(pos + 12);
    lens[count] = int64_t(len);
    count++;
    pos += 12 + len + 4;
  }
  return count;
}

}  // extern "C"
