// Fast TFRecord scanner: walks a tfrecord file, validates the masked
// CRC32-C framing, and returns an index of (payload offset, length)
// pairs.
//
// The port's own copy of the JAX package's native/tfrecord_index.cc.
// pivp_tpu_torch/data/native.py builds it with g++ at first use into
// pivp_tpu_torch/_build/ (-msse4.2 on x86-64 for the hardware CRC32-C)
// and binds it with ctypes; data/tfrecord.read_records scans every
// shard of the ETL through it. The pure-Python scanner there is its
// plain version, which the tests hold it against.
//
// Record framing (TFRecord):
//   uint64 length | uint32 masked_crc(length) | data | uint32 masked_crc(data)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

uint32_t crc_table[256];
bool table_init = false;

void init_table() {
  if (table_init) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    crc_table[i] = crc;
  }
  table_init = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
#if defined(__SSE4_2__)
  uint64_t crc = 0xFFFFFFFFu;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t chunk;
    memcpy(&chunk, data + i, 8);
    crc = _mm_crc32_u64(crc, chunk);
  }
  for (; i < n; ++i) crc = _mm_crc32_u8((uint32_t)crc, data[i]);
  return (uint32_t)crc ^ 0xFFFFFFFFu;
#else
  init_table();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
#endif
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // namespace

extern "C" {

// Scans `path`; on success fills *offsets/*lengths (malloc'd, caller
// frees via tfr_free) with payload byte ranges and returns the record
// count. Returns -1 on IO error, -2 on CRC/framing corruption.
long long tfr_index(const char* path, int verify_crc,
                    unsigned long long** offsets,
                    unsigned long long** lengths) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<unsigned long long> offs, lens;
  std::vector<uint8_t> buf;
  uint8_t header[12];
  unsigned long long pos = 0;
  while (true) {
    size_t got = fread(header, 1, 12, f);
    if (got == 0) break;
    if (got < 12) { fclose(f); return -2; }
    uint64_t len;
    uint32_t len_crc;
    memcpy(&len, header, 8);
    memcpy(&len_crc, header + 8, 4);
    if (verify_crc && masked_crc(header, 8) != len_crc) {
      fclose(f);
      return -2;
    }
    pos += 12;
    offs.push_back(pos);
    lens.push_back(len);
    if (verify_crc) {
      buf.resize(len);
      if (fread(buf.data(), 1, len, f) != len) { fclose(f); return -2; }
      uint32_t data_crc;
      if (fread(&data_crc, 1, 4, f) != 4) { fclose(f); return -2; }
      if (masked_crc(buf.data(), len) != data_crc) {
        fclose(f);
        return -2;
      }
    } else {
      if (fseek(f, (long)(len + 4), SEEK_CUR) != 0) {
        fclose(f);
        return -2;
      }
    }
    pos += len + 4;
  }
  fclose(f);
  size_t n = offs.size();
  *offsets = (unsigned long long*)malloc(n * sizeof(unsigned long long));
  *lengths = (unsigned long long*)malloc(n * sizeof(unsigned long long));
  memcpy(*offsets, offs.data(), n * sizeof(unsigned long long));
  memcpy(*lengths, lens.data(), n * sizeof(unsigned long long));
  return (long long)n;
}

void tfr_free(unsigned long long* p) { free(p); }

// Standalone CRC32-C for tests.
unsigned int tfr_crc32c(const unsigned char* data, unsigned long long n) {
  return crc32c(data, n);
}

}  // extern "C"
