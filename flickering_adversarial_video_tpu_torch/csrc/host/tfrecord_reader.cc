// Native TFRecord reader: the port's host input pipeline.
//
// The port's own copy of the JAX package's native/tfrecord_reader.cc, cut to
// the record reads (tfr_open, tfr_close, tfr_next, tfr_read_batch,
// tfr_read_batch_packed).  It parses the TFRecord framing ({u64 len, u32
// masked crc32c, bytes, u32 masked crc32c}) and the tf.train.Example wire
// format of the uint8 schema ('train/label' int64, 'train/video' raw uint8
// bytes) into caller-provided buffers: one copy per record, and in the packed
// read the space-to-depth relayout happens inside that copy.
//
// Unlike the reference, a batch read does not end quietly on a bad record:
// it stops there and keeps the error code, which tfr_error() returns, so the
// Python side can raise.
//
// Thread-safety: one Reader per file handle; use one handle per thread.
// Built with the host's g++ at first use (data/native_reader.py), bound with
// ctypes.  Not carried over: tfr_batch_view, the TPU's batch-in-lanes layout.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// ---- crc32c (Castagnoli), slice-by-1 table; for the optional checks ----

struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      t[i] = c;
    }
  }
};

const CrcTable kCrc;  // built when the library loads: no lazy init to race on

uint32_t MaskedCrc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) crc = (crc >> 8) ^ kCrc.t[(crc ^ data[i]) & 0xFF];
  crc ^= 0xFFFFFFFFu;
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---- minimal protobuf wire parsing ----

struct Slice {
  const uint8_t* p;
  size_t n;
};

bool ReadVarint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

bool SkipField(const uint8_t*& p, const uint8_t* end, uint32_t wire_type) {
  uint64_t tmp;
  switch (wire_type) {
    case 0:
      return ReadVarint(p, end, &tmp);
    case 1:
      if (end - p < 8) return false;
      p += 8;
      return true;
    case 2:
      if (!ReadVarint(p, end, &tmp) || static_cast<uint64_t>(end - p) < tmp) return false;
      p += tmp;
      return true;
    case 5:
      if (end - p < 4) return false;
      p += 4;
      return true;
    default:
      return false;
  }
}

// A length-delimited payload at p: its slice, with p moved past it.
bool ReadDelimited(const uint8_t*& p, const uint8_t* end, Slice* out) {
  uint64_t len;
  if (!ReadVarint(p, end, &len) || static_cast<uint64_t>(end - p) < len) return false;
  *out = {p, static_cast<size_t>(len)};
  p += len;
  return true;
}

struct ParsedExample {
  Slice video = {nullptr, 0};
  int64_t label = -1;
  bool has_video = false;
  bool has_label = false;
};

// Feature { bytes_list = 1 | float_list = 2 | int64_list = 3 }
bool ParseFeature(const uint8_t* p, const uint8_t* end, ParsedExample* out, bool is_video) {
  while (p < end) {
    uint64_t tag;
    if (!ReadVarint(p, end, &tag)) return false;
    uint32_t field = tag >> 3, wt = tag & 7;
    if (field == 1 && wt == 2 && is_video) {  // BytesList
      Slice list;
      if (!ReadDelimited(p, end, &list)) return false;
      const uint8_t* bl = list.p;
      const uint8_t* bl_end = list.p + list.n;
      while (bl < bl_end) {
        uint64_t t2;
        if (!ReadVarint(bl, bl_end, &t2)) return false;
        if ((t2 >> 3) == 1 && (t2 & 7) == 2) {
          if (!ReadDelimited(bl, bl_end, &out->video)) return false;
          out->has_video = true;
        } else if (!SkipField(bl, bl_end, t2 & 7)) {
          return false;
        }
      }
    } else if (field == 3 && wt == 2 && !is_video) {  // Int64List
      Slice list;
      if (!ReadDelimited(p, end, &list)) return false;
      const uint8_t* il = list.p;
      const uint8_t* il_end = list.p + list.n;
      while (il < il_end) {
        uint64_t t2;
        if (!ReadVarint(il, il_end, &t2)) return false;
        if ((t2 >> 3) == 1 && (t2 & 7) == 2) {  // packed payload: its first value
          Slice packed;
          if (!ReadDelimited(il, il_end, &packed)) return false;
          const uint8_t* vp = packed.p;
          uint64_t v;
          if (ReadVarint(vp, packed.p + packed.n, &v)) {
            out->label = static_cast<int64_t>(v);
            out->has_label = true;
          }
        } else if ((t2 >> 3) == 1 && (t2 & 7) == 0) {  // unpacked varint
          uint64_t v;
          if (!ReadVarint(il, il_end, &v)) return false;
          out->label = static_cast<int64_t>(v);
          out->has_label = true;
        } else if (!SkipField(il, il_end, t2 & 7)) {
          return false;
        }
      }
    } else if (!SkipField(p, end, wt)) {
      return false;
    }
  }
  return true;
}

// Example { Features features = 1 }, Features { map<string, Feature> = 1 }
bool ParseExample(const uint8_t* data, size_t n, const char* label_key, const char* video_key,
                  ParsedExample* out) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  const size_t label_key_len = strlen(label_key);
  const size_t video_key_len = strlen(video_key);
  while (p < end) {
    uint64_t tag;
    if (!ReadVarint(p, end, &tag)) return false;
    if ((tag >> 3) != 1 || (tag & 7) != 2) {
      if (!SkipField(p, end, tag & 7)) return false;
      continue;
    }
    Slice features;
    if (!ReadDelimited(p, end, &features)) return false;
    const uint8_t* fp = features.p;
    const uint8_t* fend = features.p + features.n;
    while (fp < fend) {
      uint64_t t2;
      if (!ReadVarint(fp, fend, &t2)) return false;
      if ((t2 >> 3) != 1 || (t2 & 7) != 2) {
        if (!SkipField(fp, fend, t2 & 7)) return false;
        continue;
      }
      Slice entry;
      if (!ReadDelimited(fp, fend, &entry)) return false;
      const uint8_t* ep = entry.p;
      const uint8_t* eend = entry.p + entry.n;
      Slice key = {nullptr, 0};
      Slice value = {nullptr, 0};
      while (ep < eend) {
        uint64_t t3;
        if (!ReadVarint(ep, eend, &t3)) return false;
        if ((t3 >> 3) == 1 && (t3 & 7) == 2) {
          if (!ReadDelimited(ep, eend, &key)) return false;
        } else if ((t3 >> 3) == 2 && (t3 & 7) == 2) {
          if (!ReadDelimited(ep, eend, &value)) return false;
        } else if (!SkipField(ep, eend, t3 & 7)) {
          return false;
        }
      }
      if (!key.p || !value.p) continue;
      if (key.n == video_key_len && memcmp(key.p, video_key, video_key_len) == 0) {
        if (!ParseFeature(value.p, value.p + value.n, out, true)) return false;
      } else if (key.n == label_key_len && memcmp(key.p, label_key, label_key_len) == 0) {
        if (!ParseFeature(value.p, value.p + value.n, out, false)) return false;
      }
    }
  }
  return out->has_video && out->has_label;
}

struct Reader {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
  bool verify_crc = false;
  long err = 0;  // the first error a batch read stopped at (tfr_error)
};

// Space-to-depth pack of one clip during the copy out of the record buffer.
// src: [T, H, W, C] uint8 (contiguous); dst: [T/2, H/2, W/2, 8C] with the
// channel order (parity_t, parity_h, parity_w, c): data/packing.pack_video_np.
inline void Store6(uint8_t* dst, const uint8_t* src) {
  // a 6-byte atom as one u32 and one u16 store
  uint32_t a;
  uint16_t b;
  memcpy(&a, src, 4);
  memcpy(&b, src + 4, 2);
  memcpy(dst, &a, 4);
  memcpy(dst + 4, &b, 2);
}

void PackClip(const uint8_t* src, uint8_t* dst, long T, long H, long W, long C) {
  const long W2 = W / 2, H2 = H / 2, T2 = T / 2;
  const long atom = 2 * C;             // (parity_w, c) stays contiguous
  const long out_ch = 8 * C;           // packed channel count
  const long src_row = W * C;          // one (t, h) row
  const long src_plane = H * src_row;  // one t slice
  if (C == 3) {
    // one pass per output row, the four source rows interleaved: sequential
    // writes, four sequential reads
    for (long tt = 0; tt < T2; ++tt) {
      for (long hh = 0; hh < H2; ++hh) {
        const uint8_t* s00 = src + (2 * tt) * src_plane + (2 * hh) * src_row;
        const uint8_t* s01 = s00 + src_row;
        const uint8_t* s10 = s00 + src_plane;
        const uint8_t* s11 = s10 + src_row;
        uint8_t* o = dst + ((tt * H2 + hh) * W2) * out_ch;
        for (long ww = 0; ww < W2; ++ww) {
          const long si = ww * atom;
          Store6(o, s00 + si);
          Store6(o + 6, s01 + si);
          Store6(o + 12, s10 + si);
          Store6(o + 18, s11 + si);
          o += out_ch;
        }
      }
    }
    return;
  }
  for (long tt = 0; tt < T2; ++tt) {
    for (long hh = 0; hh < H2; ++hh) {
      uint8_t* orow = dst + ((tt * H2 + hh) * W2) * out_ch;
      for (long pt = 0; pt < 2; ++pt) {
        for (long ph = 0; ph < 2; ++ph) {
          const uint8_t* irow = src + (2 * tt + pt) * src_plane + (2 * hh + ph) * src_row;
          uint8_t* obase = orow + (pt * 2 + ph) * atom;
          for (long ww = 0; ww < W2; ++ww) memcpy(obase + ww * out_ch, irow + ww * atom, atom);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

void* tfr_open(const char* path, int verify_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Reader* r = new Reader();
  r->f = f;
  r->verify_crc = verify_crc != 0;
  return r;
}

void tfr_close(void* handle) {
  if (!handle) return;
  Reader* r = static_cast<Reader*>(handle);
  if (r->f) fclose(r->f);
  delete r;
}

// The error a batch read stopped at: 0 none, -1 truncated record, -2 crc
// mismatch (with verify_crc), -3 not a uint8-schema Example.
long tfr_error(void* handle) { return static_cast<Reader*>(handle)->err; }

// Read the next record's parsed (video bytes, label).
// Returns 1 ok, 0 end of file, or a negative error code (tfr_error's).
// The video bytes are owned by the reader and valid until the next call.
long tfr_next(void* handle, const uint8_t** video_out, long* video_len_out,
              long long* label_out) {
  Reader* r = static_cast<Reader*>(handle);
  uint8_t header[12];
  if (fread(header, 1, 12, r->f) != 12) return 0;
  uint64_t len;
  memcpy(&len, header, 8);
  if (r->verify_crc) {
    uint32_t expect;
    memcpy(&expect, header + 8, 4);
    if (MaskedCrc32c(header, 8) != expect) return -2;
  }
  r->buf.resize(len);
  if (fread(r->buf.data(), 1, len, r->f) != len) return -1;
  uint8_t footer[4];
  if (fread(footer, 1, 4, r->f) != 4) return -1;
  if (r->verify_crc) {
    uint32_t expect;
    memcpy(&expect, footer, 4);
    if (MaskedCrc32c(r->buf.data(), len) != expect) return -2;
  }
  ParsedExample ex;
  if (!ParseExample(r->buf.data(), len, "train/label", "train/video", &ex)) return -3;
  *video_out = ex.video.p;
  *video_len_out = static_cast<long>(ex.video.n);
  *label_out = ex.label;
  return 1;
}

// Read up to `count` records into dst (count * record_bytes) and labels_out,
// each record's trailing record_bytes (the last-N-frames convention); clips
// shorter than that are skipped (the reference writer's skip-short rule).
// Returns the number filled: fewer than `count` at the end of the file, or
// at an error, which tfr_error() then returns.
long tfr_read_batch(void* handle, uint8_t* dst, long record_bytes, long long* labels_out,
                    long count) {
  Reader* r = static_cast<Reader*>(handle);
  const uint8_t* video;
  long vlen;
  long long label;
  long filled = 0;
  while (filled < count) {
    long rc = tfr_next(handle, &video, &vlen, &label);
    if (rc < 0) r->err = rc;
    if (rc <= 0) break;
    if (vlen < record_bytes) continue;
    memcpy(dst + filled * record_bytes, video + (vlen - record_bytes), record_bytes);
    labels_out[filled] = label;
    ++filled;
  }
  return filled;
}

// tfr_read_batch with the space-to-depth pack in the copy: dst is
// count * frames*height*width*channels bytes, [n, T/2, H/2, W/2, 8C].
long tfr_read_batch_packed(void* handle, uint8_t* dst, long frames, long height, long width,
                           long channels, long long* labels_out, long count) {
  Reader* r = static_cast<Reader*>(handle);
  const long record_bytes = frames * height * width * channels;
  const uint8_t* video;
  long vlen;
  long long label;
  long filled = 0;
  while (filled < count) {
    long rc = tfr_next(handle, &video, &vlen, &label);
    if (rc < 0) r->err = rc;
    if (rc <= 0) break;
    if (vlen < record_bytes) continue;
    PackClip(video + (vlen - record_bytes), dst + filled * record_bytes, frames, height, width,
             channels);
    labels_out[filled] = label;
    ++filled;
  }
  return filled;
}

}  // extern "C"
