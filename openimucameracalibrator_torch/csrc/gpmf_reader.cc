// GPMF/MP4 telemetry reader: extracts GoPro sensor streams (ACCL, GYRO,
// CORI, GRAV, GPS5, ...) and video frame timestamps directly from an MP4.
//
// Native-code replacement for the reference's py_gpmf_parser dependency
// (reference python/run_gopro_calibration.py:10,198-206 — telemetry
// extraction stage), built from the published GPMF container spec:
//   * MP4 side: walk ISO-BMFF boxes to the 'gpmd'-format track, recover
//     per-sample file offsets (stsc/stco/stsz) and timing (stts/mdhd);
//     the 'vide' track's stts yields frame timestamps.
//   * GPMF side: big-endian KLV (fourcc, type, struct-size, repeat);
//     type 0 nests; numeric leaves are scaled by the stream's SCAL.
//
// Exposed as a tiny C ABI consumed via ctypes (core/gpmf.py).

#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

struct Stream {
  std::vector<double> times;   // one per sample (payload-interpolated)
  std::vector<double> values;  // channels-major per sample
  int channels = 0;
};

// Per-stream device-clock state: GoPro streams carry STMP (us since boot,
// HERO7+) or TICK (ms, older models) per payload and TSMP (cumulative
// sample count). When present, intra-stream timing uses the device clock
// anchored at the first payload's MP4 time — robust against container
// jitter (gpmf-parser's approach); otherwise fall back to MP4 stts times.
struct TimeState {
  bool has_first = false;
  double first_dev_t = 0.0;  // device clock of first payload (s)
  double first_mp4_t = 0.0;  // MP4 time of first payload (s)
  bool has_prev = false;
  double prev_base = 0.0;  // previous payload's start on the output axis
  double prev_dur = 0.0;   // previous payload's duration (s)
  bool has_prev_tsmp = false;
  uint64_t prev_tsmp = 0;
  uint64_t dropped = 0;  // cumulative samples lost per TSMP accounting
};

struct Reader {
  std::map<std::string, Stream> streams;
  std::map<std::string, TimeState> tstate;
  std::vector<double> frame_times;
  std::string error;
};

struct Buf {
  const uint8_t* p;
  size_t n;
};

uint16_t be16(const uint8_t* p) { return (uint16_t(p[0]) << 8) | p[1]; }
uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}
uint64_t be64(const uint8_t* p) {
  return (uint64_t(be32(p)) << 32) | be32(p + 4);
}

// ---------------------------------------------------------------------------
// GPMF payload parsing
// ---------------------------------------------------------------------------

int type_size(char t) {
  switch (t) {
    case 'b': case 'B': case 'c': return 1;
    case 's': case 'S': return 2;
    case 'l': case 'L': case 'f': case 'F': case 'q': return 4;
    case 'd': case 'j': case 'J': case 'Q': return 8;
    default: return 0;
  }
}

double read_scalar(const uint8_t* p, char t) {
  switch (t) {
    case 'b': return double(int8_t(p[0]));
    case 'B': return double(p[0]);
    case 's': return double(int16_t(be16(p)));
    case 'S': return double(be16(p));
    case 'l': return double(int32_t(be32(p)));
    case 'L': return double(be32(p));
    case 'f': {
      uint32_t u = be32(p);
      float f;
      std::memcpy(&f, &u, 4);
      return double(f);
    }
    case 'd': {
      uint64_t u = be64(p);
      double d;
      std::memcpy(&d, &u, 8);
      return d;
    }
    case 'j': return double(int64_t(be64(p)));
    case 'J': return double(be64(p));
    case 'q': return double(int32_t(be32(p))) / 65536.0;  // Q15.16
    case 'Q': return double(int64_t(be64(p))) / 4294967296.0;  // Q31.32
    default: return 0.0;
  }
}

struct Klv {
  char key[5];
  char type;
  uint8_t ssize;
  uint16_t repeat;
  const uint8_t* data;
  size_t data_len;
  size_t total;  // bytes incl. 8-byte header, 4-aligned
};

bool read_klv(Buf b, size_t off, Klv* k) {
  if (off + 8 > b.n) return false;
  std::memcpy(k->key, b.p + off, 4);
  k->key[4] = 0;
  k->type = char(b.p[off + 4]);
  k->ssize = b.p[off + 5];
  k->repeat = be16(b.p + off + 6);
  k->data = b.p + off + 8;
  k->data_len = size_t(k->ssize) * k->repeat;
  size_t padded = (k->data_len + 3) & ~size_t(3);
  if (off + 8 + padded > b.n) return false;
  k->total = 8 + padded;
  return true;
}

// One STRM container: find SCAL + timing metadata (STMP/TICK/TSMP) and
// the sensor leaf (the last non-metadata numeric leaf, per GPMF
// convention), append scaled samples.
void parse_strm(Reader* r, Buf strm, double t0, double dur) {
  std::vector<double> scal;
  Klv sensor{};
  bool have_sensor = false;
  double stmp = -1.0;    // us since device boot (HERO7+), type 'J'
  double tick = -1.0;    // ms tick (older models), type 'L'
  double tsmp = -1.0;    // cumulative sample count incl. this payload
  static const char* kMeta[] = {"STNM", "SIUN", "UNIT", "SCAL", "TSMP",
                                "TIMO", "STMP", "TMPC", "ORIN", "ORIO",
                                "MTRX", "TYPE", "TICK", "TOCK", "DVNM"};
  size_t off = 0;
  Klv k;
  while (off < strm.n && read_klv(strm, off, &k)) {
    int ts = type_size(k.type);
    if (std::strcmp(k.key, "SCAL") == 0) {
      if (ts > 0) {
        size_t cnt = k.data_len / ts;
        scal.clear();
        for (size_t i = 0; i < cnt; ++i)
          scal.push_back(read_scalar(k.data + i * ts, k.type));
      }
    } else if (std::strcmp(k.key, "STMP") == 0 && ts > 0 && k.repeat > 0) {
      stmp = read_scalar(k.data, k.type);
    } else if (std::strcmp(k.key, "TICK") == 0 && ts > 0 && k.repeat > 0) {
      tick = read_scalar(k.data, k.type);
    } else if (std::strcmp(k.key, "TSMP") == 0 && ts > 0 && k.repeat > 0) {
      tsmp = read_scalar(k.data, k.type);
    } else {
      bool meta = false;
      for (const char* m : kMeta)
        if (std::strcmp(k.key, m) == 0) { meta = true; break; }
      if (!meta && ts > 0 && k.repeat > 0 && k.ssize >= ts) {
        sensor = k;
        have_sensor = true;
      }
    }
    off += k.total;
  }
  if (!have_sensor) return;

  int ts = type_size(sensor.type);
  int channels = sensor.ssize / ts;
  if (channels <= 0) return;
  Stream& s = r->streams[sensor.key];
  if (s.channels == 0) s.channels = channels;
  if (s.channels != channels) return;  // inconsistent stream; skip payload
  int n = sensor.repeat;

  // Payload start: device clock (STMP/TICK) anchored at the first
  // STMP/TICK-bearing payload's MP4 time when available, else the MP4
  // sample time. A stream must never MIX the two clocks: once anchored,
  // a payload that happens to lack STMP/TICK continues the device-clock
  // axis from the previous payload's end (prev_base + prev_dur) instead
  // of jumping back to raw MP4 stts time, which would make the stream's
  // time axis non-monotonic when the clocks have drifted apart.
  TimeState& st = r->tstate[sensor.key];
  double base = t0;
  if (stmp >= 0.0 || tick >= 0.0) {
    double dev_t = stmp >= 0.0 ? stmp * 1e-6 : tick * 1e-3;
    if (!st.has_first) {
      // First anchor. Any earlier anchorless payloads used MP4 times;
      // anchoring at THIS payload's MP4 time keeps the axis continuous.
      st.has_first = true;
      st.first_dev_t = dev_t;
      st.first_mp4_t = t0;
    }
    base = st.first_mp4_t + (dev_t - st.first_dev_t);
  } else if (st.has_first && st.has_prev) {
    base = st.prev_base + st.prev_dur;
  }
  st.has_prev = true;
  st.prev_base = base;
  st.prev_dur = dur;
  // TSMP sample accounting: repeat should equal tsmp_now - tsmp_prev;
  // a larger delta means the camera dropped samples between payloads
  // (tracked; timing stays anchored to STMP/MP4, so later samples are
  // not skewed by the gap).
  if (tsmp >= 0.0) {
    uint64_t now = uint64_t(tsmp);
    if (st.has_prev_tsmp && now > st.prev_tsmp) {
      uint64_t delivered = now - st.prev_tsmp;
      if (delivered > uint64_t(n)) st.dropped += delivered - uint64_t(n);
    }
    st.prev_tsmp = now;
    st.has_prev_tsmp = true;
  }

  for (int i = 0; i < n; ++i) {
    s.times.push_back(base + dur * (double(i) / double(n)));
    for (int c = 0; c < channels; ++c) {
      double v = read_scalar(sensor.data + size_t(i) * sensor.ssize + c * ts,
                             sensor.type);
      double d = scal.empty() ? 1.0
                 : (scal.size() == size_t(channels) ? scal[c] : scal[0]);
      s.values.push_back(d != 0.0 ? v / d : v);
    }
  }
}

// One payload (one 'gpmd' MP4 sample): DEVC -> STRM*.
void parse_payload(Reader* r, Buf payload, double t0, double dur) {
  size_t off = 0;
  Klv devc;
  while (off < payload.n && read_klv(payload, off, &devc)) {
    if (std::strcmp(devc.key, "DEVC") == 0 && devc.type == 0) {
      Buf inner{devc.data, devc.data_len};
      size_t ioff = 0;
      Klv k;
      while (ioff < inner.n && read_klv(inner, ioff, &k)) {
        if (std::strcmp(k.key, "STRM") == 0 && k.type == 0)
          parse_strm(r, Buf{k.data, k.data_len}, t0, dur);
        ioff += k.total;
      }
    }
    off += devc.total;
  }
}

// ---------------------------------------------------------------------------
// MP4 (ISO-BMFF) parsing
// ---------------------------------------------------------------------------

struct Box {
  char type[5];
  size_t payload_off;  // file offset of payload
  size_t payload_len;
  size_t total;
};

bool read_box(const std::vector<uint8_t>& f, size_t off, Box* b) {
  if (off + 8 > f.size()) return false;
  uint64_t size = be32(f.data() + off);
  std::memcpy(b->type, f.data() + off + 4, 4);
  b->type[4] = 0;
  size_t hdr = 8;
  if (size == 1) {
    if (off + 16 > f.size()) return false;
    size = be64(f.data() + off + 8);
    hdr = 16;
  } else if (size == 0) {
    size = f.size() - off;
  }
  if (size < hdr || off + size > f.size()) return false;
  b->payload_off = off + hdr;
  b->payload_len = size_t(size) - hdr;
  b->total = size_t(size);
  return true;
}

// Find first child box of given type inside [off, off+len).
bool find_child(const std::vector<uint8_t>& f, size_t off, size_t len,
                const char* type, Box* out) {
  size_t end = off + len;
  while (off < end) {
    Box b;
    if (!read_box(f, off, &b)) return false;
    if (std::strcmp(b.type, type) == 0) {
      *out = b;
      return true;
    }
    off += b.total;
  }
  return false;
}

struct Track {
  std::string handler;
  std::string sample_format;
  uint32_t timescale = 0;
  std::vector<std::pair<uint32_t, uint32_t>> stts;  // (count, delta)
  std::vector<uint32_t> sizes;                      // per sample
  uint32_t const_size = 0;
  uint32_t n_samples = 0;
  std::vector<uint64_t> chunk_offsets;
  std::vector<std::array<uint32_t, 3>> stsc;  // first_chunk, spc, desc
};

bool parse_track(const std::vector<uint8_t>& f, const Box& trak, Track* t) {
  Box mdia, hdlr, mdhd, minf, stbl, b;
  if (!find_child(f, trak.payload_off, trak.payload_len, "mdia", &mdia))
    return false;
  if (find_child(f, mdia.payload_off, mdia.payload_len, "hdlr", &hdlr) &&
      hdlr.payload_len >= 12)
    t->handler.assign(reinterpret_cast<const char*>(f.data() + hdlr.payload_off + 8), 4);
  if (find_child(f, mdia.payload_off, mdia.payload_len, "mdhd", &mdhd)) {
    const uint8_t* p = f.data() + mdhd.payload_off;
    int v = p[0];
    t->timescale = be32(p + (v == 1 ? 20 : 12));
  }
  if (!find_child(f, mdia.payload_off, mdia.payload_len, "minf", &minf))
    return false;
  if (!find_child(f, minf.payload_off, minf.payload_len, "stbl", &stbl))
    return false;
  if (find_child(f, stbl.payload_off, stbl.payload_len, "stsd", &b) &&
      b.payload_len >= 16) {
    // version/flags(4) entry_count(4) entry_size(4) format(4)
    t->sample_format.assign(
        reinterpret_cast<const char*>(f.data() + b.payload_off + 12), 4);
  }
  if (find_child(f, stbl.payload_off, stbl.payload_len, "stts", &b)) {
    const uint8_t* p = f.data() + b.payload_off;
    uint32_t n = be32(p + 4);
    for (uint32_t i = 0; i < n && 8 + 8 * i + 8 <= b.payload_len; ++i)
      t->stts.emplace_back(be32(p + 8 + 8 * i), be32(p + 12 + 8 * i));
  }
  if (find_child(f, stbl.payload_off, stbl.payload_len, "stsz", &b)) {
    const uint8_t* p = f.data() + b.payload_off;
    t->const_size = be32(p + 4);
    t->n_samples = be32(p + 8);
    if (t->const_size == 0)
      for (uint32_t i = 0; i < t->n_samples && 12 + 4 * i + 4 <= b.payload_len; ++i)
        t->sizes.push_back(be32(p + 12 + 4 * i));
  }
  if (find_child(f, stbl.payload_off, stbl.payload_len, "stsc", &b)) {
    const uint8_t* p = f.data() + b.payload_off;
    uint32_t n = be32(p + 4);
    for (uint32_t i = 0; i < n && 8 + 12 * i + 12 <= b.payload_len; ++i)
      t->stsc.push_back({be32(p + 8 + 12 * i), be32(p + 12 + 12 * i),
                         be32(p + 16 + 12 * i)});
  }
  if (find_child(f, stbl.payload_off, stbl.payload_len, "stco", &b)) {
    const uint8_t* p = f.data() + b.payload_off;
    uint32_t n = be32(p + 4);
    for (uint32_t i = 0; i < n && 8 + 4 * i + 4 <= b.payload_len; ++i)
      t->chunk_offsets.push_back(be32(p + 8 + 4 * i));
  } else if (find_child(f, stbl.payload_off, stbl.payload_len, "co64", &b)) {
    const uint8_t* p = f.data() + b.payload_off;
    uint32_t n = be32(p + 4);
    for (uint32_t i = 0; i < n && 8 + 8 * i + 8 <= b.payload_len; ++i)
      t->chunk_offsets.push_back(be64(p + 8 + 8 * i));
  }
  return true;
}

uint32_t sample_size(const Track& t, uint32_t i) {
  return t.const_size ? t.const_size : (i < t.sizes.size() ? t.sizes[i] : 0);
}

// (file offset, start time s, duration s) per sample.
void sample_table(const Track& t,
                  std::vector<std::array<uint64_t, 1>>* offsets,
                  std::vector<double>* starts, std::vector<double>* durs) {
  // expand stsc: samples per chunk
  uint32_t n = t.n_samples;
  std::vector<uint64_t> off(n, 0);
  uint32_t si = 0;
  for (size_t ci = 0; ci < t.chunk_offsets.size() && si < n; ++ci) {
    uint32_t spc = 1;
    for (const auto& e : t.stsc)
      if (e[0] <= ci + 1) spc = e[1];
    uint64_t o = t.chunk_offsets[ci];
    for (uint32_t k = 0; k < spc && si < n; ++k) {
      off[si] = o;
      o += sample_size(t, si);
      ++si;
    }
  }
  double ts = t.timescale ? double(t.timescale) : 1.0;
  std::vector<double> st(n, 0.0), du(n, 0.0);
  double cur = 0.0;
  uint32_t idx = 0;
  for (const auto& e : t.stts) {
    for (uint32_t k = 0; k < e.first && idx < n; ++k, ++idx) {
      st[idx] = cur / ts;
      du[idx] = double(e.second) / ts;
      cur += e.second;
    }
  }
  offsets->resize(n);
  for (uint32_t i = 0; i < n; ++i) (*offsets)[i] = {off[i]};
  *starts = std::move(st);
  *durs = std::move(du);
}

}  // namespace

extern "C" {

void* gpmf_open(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  std::fseek(fp, 0, SEEK_END);
  long sz = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::vector<uint8_t> file(static_cast<size_t>(sz));
  if (sz > 0 && std::fread(file.data(), 1, size_t(sz), fp) != size_t(sz)) {
    std::fclose(fp);
    return nullptr;
  }
  std::fclose(fp);

  auto* r = new Reader();
  Box moov;
  if (!find_child(file, 0, file.size(), "moov", &moov)) {
    r->error = "no moov box";
    return r;
  }
  size_t off = moov.payload_off;
  size_t end = moov.payload_off + moov.payload_len;
  while (off < end) {
    Box b;
    if (!read_box(file, off, &b)) break;
    if (std::strcmp(b.type, "trak") == 0) {
      Track t;
      if (parse_track(file, b, &t)) {
        if (t.sample_format == "gpmd") {
          std::vector<std::array<uint64_t, 1>> offs;
          std::vector<double> starts, durs;
          sample_table(t, &offs, &starts, &durs);
          for (size_t i = 0; i < offs.size(); ++i) {
            uint64_t o = offs[i][0];
            uint32_t len = sample_size(t, uint32_t(i));
            if (o + len <= file.size())
              parse_payload(r, Buf{file.data() + o, len}, starts[i], durs[i]);
          }
        } else if (t.handler == "vide") {
          std::vector<std::array<uint64_t, 1>> offs;
          std::vector<double> starts, durs;
          sample_table(t, &offs, &starts, &durs);
          r->frame_times = starts;
        }
      }
    }
    off += b.total;
  }
  return r;
}

const char* gpmf_error(void* h) {
  auto* r = static_cast<Reader*>(h);
  return r->error.c_str();
}

// Comma-joined stream fourccs; caller provides buffer.
int gpmf_stream_names(void* h, char* buf, int buflen) {
  auto* r = static_cast<Reader*>(h);
  std::string s;
  for (const auto& kv : r->streams) {
    if (!s.empty()) s += ",";
    s += kv.first;
  }
  if (int(s.size()) + 1 > buflen) return -1;
  std::memcpy(buf, s.c_str(), s.size() + 1);
  return int(s.size());
}

// n_samples and channels of a stream; -1 if absent.
int gpmf_stream_shape(void* h, const char* fourcc, int* n, int* channels) {
  auto* r = static_cast<Reader*>(h);
  auto it = r->streams.find(fourcc);
  if (it == r->streams.end()) return -1;
  *n = int(it->second.times.size());
  *channels = it->second.channels;
  return 0;
}

int gpmf_stream_read(void* h, const char* fourcc, double* times, double* values) {
  auto* r = static_cast<Reader*>(h);
  auto it = r->streams.find(fourcc);
  if (it == r->streams.end()) return -1;
  const Stream& s = it->second;
  std::memcpy(times, s.times.data(), s.times.size() * sizeof(double));
  std::memcpy(values, s.values.data(), s.values.size() * sizeof(double));
  return 0;
}

int gpmf_num_frames(void* h) {
  return int(static_cast<Reader*>(h)->frame_times.size());
}

int gpmf_frame_times(void* h, double* times) {
  auto* r = static_cast<Reader*>(h);
  std::memcpy(times, r->frame_times.data(),
              r->frame_times.size() * sizeof(double));
  return 0;
}

// Cumulative dropped-sample count per TSMP accounting (0 when the
// stream carries no TSMP or nothing was lost).
long long gpmf_stream_dropped(void* h, const char* fourcc) {
  auto* r = static_cast<Reader*>(h);
  auto it = r->tstate.find(fourcc);
  return it == r->tstate.end() ? 0 : (long long)it->second.dropped;
}

void gpmf_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"
