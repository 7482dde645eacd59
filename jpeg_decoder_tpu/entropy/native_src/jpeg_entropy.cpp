// Native host entropy decoder for jpeg_decoder_tpu.
//
// Host equivalent of the reference's sequential Huffman stage
// (jpeg.cpp:300-446), redesigned:
//   * O(1) decode: peek 16 bits -> flat 2^16 LUT -> (symbol, length), instead
//     of the reference's per-bit linear scan (jpeg.cpp:300-320).
//   * Restart-segment parallelism: each RSTn segment is byte-aligned with DC
//     predictors reset (jpeg.cpp:419-425), so segments decode independently
//     across std::thread workers.
//   * Emits scan-order natural-layout int32 blocks — the same coefficient
//     plane the Python and device backends emit (swappable stage boundary).
//
// Exposed as a C ABI for ctypes.  No Python.h dependency; the GIL is
// released for the whole call.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libjpeg_entropy.so jpeg_entropy.cpp

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <atomic>
#include <algorithm>
#include <memory>
#include <cmath>

namespace {

// LUT entry: (symbol << 5) | code_length, 0 = invalid prefix.
using LutEntry = int16_t;

constexpr int kLutBits = 16;
constexpr int kMaxComps = 4;

struct CompSpec {
  int h, v;          // sampling factors
  const LutEntry* dc_lut;
  const int32_t* ac_lut;  // combined-value LUT (huffman.build_ac_lut32)
};

// Natural-order index of the i-th zigzag coefficient (T.81 Figure A.6).
constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct BitReader {
  const uint8_t* data;  // caller guarantees >= 256 readable bytes past end
  int64_t pos;          // absolute bit position
  int64_t end;          // end bit position; loops bound overrun to one block

  // 64-bit big-endian window with the bit at `pos` in the MSB: one
  // unaligned load + bswap serves both the 16-bit LUT probe and the
  // value bits of the same symbol (<= 16 + 11 bits consumed per call).
  inline uint64_t window() const {
    uint64_t w;
    std::memcpy(&w, data + (pos >> 3), 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    w = __builtin_bswap64(w);
#endif
    return w << (pos & 7);
  }
  inline uint32_t peek16() const { return uint32_t(window() >> 48); }
  inline uint32_t getbits(int n) {  // n in [1, 16]
    uint32_t v = uint32_t(window() >> (64 - n));
    pos += n;
    return v;
  }
};

// JPEG sign extension, reference semantics (jpeg.cpp:340-343).
inline int32_t extend(uint32_t value, int size) {
  if (size != 0 && value < (1u << (size - 1)))
    return int32_t(value) - ((1 << size) - 1);
  return int32_t(value);
}

// Two-level LUT probes (ABI 21): native.py appends a 4096-entry first
// level after the 2^16 table — codes (or fast combined-value AC
// entries) resolvable from 12 bits hit the 8/16 KB L1-resident table;
// 0 falls back to the full probe.  The per-symbol probe chain is
// serially dependent (the next index needs this symbol's length), so
// the load latency IS the walk's critical path; L1 vs L2 measured the
// difference between ~185 and ~250+ MP/s single-core skeleton walks.
inline LutEntry probe16(const LutEntry* lut, uint64_t w) {
  LutEntry t = lut[65536 + int(w >> 52)];
  if (__builtin_expect(!t, 0)) t = lut[w >> 48];
  return t;
}
inline LutEntry probe16_idx(const LutEntry* lut, uint32_t idx16) {
  LutEntry t = lut[65536 + (idx16 >> 4)];
  if (__builtin_expect(!t, 0)) t = lut[idx16];
  return t;
}
inline int32_t probe_ac32(const int32_t* lut, uint64_t w) {
  int32_t e = lut[65536 + int(w >> 52)];
  if (__builtin_expect(!e, 0)) e = lut[w >> 48];
  return e;
}

// Decode one 8x8 block into out[64] (natural order, pre-zeroed).
// Returns 0 on success, nonzero error code otherwise.
// Parity: decodeMCUComponent (jpeg.cpp:322-403).
// AC symbol decode via the combined-value int32 LUT
// (huffman.build_ac_lut32): one probe yields (value, run, total_bits) with
// the coefficient already sign-extended from the same 16-bit window.
// Errors: 3 invalid prefix, 4 run overflow, 5 invalid size.
inline int decode_block(BitReader& br, const LutEntry* dc_lut,
                        const int32_t* ac_lut, int32_t* out,
                        int32_t& pred, int max_dc = 11, int max_ac = 10) {
  // The 64-bit window is kept in a register and shifted as bits are
  // consumed; it is reloaded only when fewer than 17 + max_ac valid bits
  // remain (the max one symbol consumes: 16-bit code + max_ac value
  // bits; 27 for 8-bit frames, 31 for precision-12 frames where T.81
  // B.2.2 allows DC sizes to 15 and AC sizes to 14), so a typical block
  // does ~2 loads instead of one per symbol.
  const int refill = 17 + max_ac;
  uint64_t w = br.window();
  int avail = 64 - int(br.pos & 7);
  LutEntry t = probe16(dc_lut, w);
  int len = t & 31;
  if (len == 0) return 1;  // invalid DC code
  int size = t >> 5;
  if (size > max_dc) return 2;  // invalid DC size (jpeg.cpp:330-334)
  int32_t diff =
      size ? extend(uint32_t((w << len) >> (64 - size)), size) : 0;
  br.pos += len + size;
  w <<= len + size;
  avail -= len + size;
  pred += diff;
  out[0] = pred;

  int i = 1;
  while (i < 64) {
    if (avail < refill) {
      w = br.window();
      avail = 64 - int(br.pos & 7);
    }
    int32_t e = probe_ac32(ac_lut, w);
    if (e == 0) return 3;  // invalid AC prefix
    if (__builtin_expect(e & 32, 0)) {  // slow: len+size > 16 or size > 10
      int sym = (e >> 13) & 0xFF;
      len = e & 31;
      int run = (sym == 0xF0) ? 16 : (sym >> 4);
      int csize = sym & 0x0F;
      if (i + run > 64 || (csize != 0 && i + run >= 64)) return 4;
      i += run;
      if (csize) {
        if (csize > max_ac) return 5;  // jpeg.cpp:381-384
        out[kZigzag[i]] =
            extend(uint32_t((w << len) >> (64 - csize)), csize);
        ++i;
      }
      br.pos += len + csize;
      w <<= len + csize;
      avail -= len + csize;
      continue;
    }
    const int bits = e & 31;
    br.pos += bits;
    w <<= bits;
    avail -= bits;
    const int32_t val = e >> 13;
    const int run = (e >> 7) & 63;
    if (val == 0) {
      if (run == 63) break;  // EOB
      i += run;              // ZRL
      if (i > 64) return 4;
      continue;
    }
    i += run;
    if (i > 63) return 4;
    out[kZigzag[i]] = val;
    ++i;
  }
  return 0;
}

// decode_block variant that also records a natural-order nonzero mask for
// the AC coefficients (bit i set <=> out[i] != 0, i >= 1).  Stored AC
// values are never zero (JPEG sign extension cannot produce 0 for size>0),
// so the mask enumerates exactly the sparse-wire entries — the emitter
// iterates set bits (~9/block on the corpus) instead of scanning all 64.
inline int decode_block_mask(BitReader& br, const LutEntry* dc_lut,
                             const int32_t* ac_lut, int32_t* out,
                             int32_t& pred, uint64_t& mask) {
  uint64_t w = br.window();
  int avail = 64 - int(br.pos & 7);
  LutEntry t = probe16(dc_lut, w);
  int len = t & 31;
  if (len == 0) return 1;
  int size = t >> 5;
  if (size > 11) return 2;
  int32_t diff =
      size ? extend(uint32_t((w << len) >> (64 - size)), size) : 0;
  br.pos += len + size;
  w <<= len + size;
  avail -= len + size;
  pred += diff;
  out[0] = pred;
  mask = 0;

  int i = 1;
  while (i < 64) {
    if (avail < 27) {
      w = br.window();
      avail = 64 - int(br.pos & 7);
    }
    int32_t e = probe_ac32(ac_lut, w);
    if (e == 0) return 3;
    if (__builtin_expect(e & 32, 0)) {  // slow path, see decode_block
      int sym = (e >> 13) & 0xFF;
      len = e & 31;
      int run = (sym == 0xF0) ? 16 : (sym >> 4);
      int csize = sym & 0x0F;
      if (i + run > 64 || (csize != 0 && i + run >= 64)) return 4;
      i += run;
      if (csize) {
        if (csize > 10) return 5;
        int nat = kZigzag[i];
        out[nat] = extend(uint32_t((w << len) >> (64 - csize)), csize);
        mask |= uint64_t(1) << nat;
        ++i;
      }
      br.pos += len + csize;
      w <<= len + csize;
      avail -= len + csize;
      continue;
    }
    const int bits = e & 31;
    br.pos += bits;
    w <<= bits;
    avail -= bits;
    const int32_t val = e >> 13;
    const int run = (e >> 7) & 63;
    if (val == 0) {
      if (run == 63) break;  // EOB
      i += run;              // ZRL
      if (i > 64) return 4;
      continue;
    }
    i += run;
    if (i > 63) return 4;
    const int nat = kZigzag[i];
    out[nat] = val;
    mask |= uint64_t(1) << nat;
    ++i;
  }
  return 0;
}

// Position-only block decode: advance the bit reader over one 8x8 block
// without storing any coefficient.  Same symbol semantics and error codes
// as decode_block; this is the per-block body of the skeleton scan (hybrid
// device decode: the host locates TRUE MCU start bits, the device extracts
// coefficients from them with zero speculation overhead).
// Greedy symbol-pairing simulator: mirrors the paired emission kernel
// (ops/entropy_flat.decode_emit2), which decodes two symbols per step
// whenever symbol A's bits fit in 16 (B's probe window stays valid) and
// the pair fits the 32-bit window.  Counting is per MCU with a flush at
// the boundary — an upper bound on the kernel's per-lane step count
// (the kernel also pairs across MCU boundaries, which only saves).
// Simulates the paired emission kernel's greedy two-symbols-per-step
// packing (ops/entropy_flat.decode_emit2) so lane boundaries balance by
// PAIRED steps and T2 is exact.
//
// Dominance argument (ADVICE r4 — why per-MCU flush() totals bound the
// kernel's continuous step count): both walks apply the SAME greedy
// rule to the SAME symbol sequence; the only difference is that the
// skeleton flushes at MCU boundaries (lane boundaries can land on any
// MCU).  Greedy pairing is local: whether (s_i, s_{i+1}) pair depends
// only on their own bit widths, never on earlier pairing.  A flush can
// therefore only BREAK one would-be pair at the boundary — turning one
// 2-symbol step into two 1-symbol steps — and never enables a pairing
// the continuous walk lacks; by induction over boundaries, sum of
// per-MCU flushed steps >= continuous steps for every lane interval.
// Hence T2 (max lane sum of flushed steps) >= the kernel's true trip
// count, and the kernel's n_done < nblocks fallback would catch any
// violation if a future pairing rule broke this locality.  Keep the
// rule LOCAL (a function of the two candidate symbols only) or re-prove
// this bound; tools/emit_pair_ab.py cross-checks counts empirically.
struct PairSim {
  int pending = -1;   // held symbol A's total bits; -1 = none
  int32_t steps = 0;
  inline void feed(int total) {
    if (pending < 0) {
      pending = total;
      return;
    }
    ++steps;
    if (pending <= 16 && pending + total <= 32)
      pending = -1;     // (A, B) paired into one step
    else
      pending = total;  // A emitted alone; B becomes the new A
  }
  inline int32_t flush() {
    int32_t s = steps + (pending >= 0 ? 1 : 0);
    pending = -1;
    steps = 0;
    return s;
  }
};

inline int skip_block(BitReader& br, const LutEntry* dc_lut,
                      const int32_t* ac_lut, int32_t& nsym,
                      PairSim* ps = nullptr, int max_dc = 11,
                      int max_ac = 10) {
  const int refill = 17 + max_ac;  // 27 for 8-bit, 31 for precision 12
  uint64_t w = br.window();
  int avail = 64 - int(br.pos & 7);
  LutEntry t = probe16(dc_lut, w);
  int len = t & 31;
  if (len == 0) return 1;
  int size = t >> 5;
  if (size > max_dc) return 2;
  br.pos += len + size;
  w <<= len + size;
  avail -= len + size;
  ++nsym;
  if (ps) ps->feed(len + size);

  int i = 1;
  while (i < 64) {
    if (avail < refill) {
      w = br.window();
      avail = 64 - int(br.pos & 7);
    }
    int32_t e = probe_ac32(ac_lut, w);
    if (e == 0) return 3;
    ++nsym;
    if (__builtin_expect(e & 32, 0)) {  // slow path, see decode_block
      int sym = (e >> 13) & 0xFF;
      len = e & 31;
      int run = (sym == 0xF0) ? 16 : (sym >> 4);
      int csize = sym & 0x0F;
      if (i + run > 64 || (csize != 0 && i + run >= 64)) return 4;
      i += run;
      if (csize) {
        if (csize > max_ac) return 5;
        ++i;
      }
      br.pos += len + csize;
      w <<= len + csize;
      avail -= len + csize;
      if (ps) ps->feed(len + csize);
      continue;
    }
    const int bits = e & 31;
    br.pos += bits;
    w <<= bits;
    avail -= bits;
    if (ps) ps->feed(bits);
    const int32_t val = e >> 13;
    const int run = (e >> 7) & 63;
    if (val == 0) {
      if (run == 63) break;  // EOB
      i += run;              // ZRL
      if (i > 64) return 4;
      continue;
    }
    i += run;
    if (i > 63) return 4;
    ++i;
  }
  return 0;
}

// Run per-segment bodies over a worker pool: seg_fn(s) returns 0 or an
// error code; the first failure wins and is returned as (s << 8) | rc.
// Restart segments share no decoder state (DC predictors / arithmetic
// statistics reset at RSTn, jpeg.cpp:419-425 / T.81 F.1.4.1.1), so every
// scan type threads the same way.
template <typename F>
static int64_t run_segments(int32_t n_segments, int32_t n_threads,
                            F&& seg_fn) {
  if (n_threads <= 1 || n_segments <= 1) {
    for (int s = 0; s < n_segments; ++s) {
      int rc = seg_fn(s);
      if (rc) return (int64_t(s) << 8) | rc;
    }
    return 0;
  }
  std::atomic<int64_t> err{0};
  std::atomic<int> next{0};
  int nt = std::min<int>(n_threads, n_segments);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&]() {
      for (;;) {
        int s = next.fetch_add(1);
        if (s >= n_segments || err.load()) return;
        int rc = seg_fn(s);
        if (rc) {
          int64_t e = (int64_t(s) << 8) | rc;
          int64_t zero = 0;
          err.compare_exchange_strong(zero, e);
          return;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  return err.load();
}

struct ScanJob {
  const uint8_t* data;
  const int64_t* seg_offsets;  // n_segments + 1 entries, bytes
  int n_segments;
  int n_comps;
  CompSpec comps[kMaxComps];
  int blocks_per_mcu;
  // Per within-MCU block: component index.
  int block_comp[kMaxComps * 16];
  int64_t n_mcus;
  int64_t restart_interval;  // MCUs per segment (0 => single segment)
  int32_t* out;              // (n_mcus * blocks_per_mcu, 64), pre-zeroed
  int max_dc = 11;           // 15 for precision-12 frames (T.81 B.2.2)
  int max_ac = 10;           // 14 for precision-12 frames
};

int decode_segment(const ScanJob& job, int seg) {
  BitReader br{job.data, job.seg_offsets[seg] * 8, job.seg_offsets[seg + 1] * 8};
  int32_t preds[kMaxComps] = {0, 0, 0, 0};
  int64_t mcu0 = job.restart_interval ? job.restart_interval * seg : 0;
  int64_t mcu1 = job.restart_interval
                     ? std::min(job.n_mcus, mcu0 + job.restart_interval)
                     : job.n_mcus;
  for (int64_t m = mcu0; m < mcu1; ++m) {
    int32_t* base = job.out + m * job.blocks_per_mcu * 64;
    for (int k = 0; k < job.blocks_per_mcu; ++k) {
      int ci = job.block_comp[k];
      const CompSpec& c = job.comps[ci];
      int rc = decode_block(br, c.dc_lut, c.ac_lut, base + k * 64,
                            preds[ci], job.max_dc, job.max_ac);
      if (rc) return rc;
      if (br.pos > br.end) return 6;  // truncated segment
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Speculative self-synchronizing parallel decode for DRI=0 streams.
//
// Huffman streams self-synchronize: a decoder started at an arbitrary byte
// boundary (assuming "start of MCU" phase) converges to the true symbol
// stream within a few MCUs with overwhelming probability.  We exploit this
// to parallelize the single entropy-coded segment of images WITHOUT restart
// markers (which the RSTn path cannot shard):
//
//   phase 1 (parallel): split the stream into chunks; each worker decodes
//     speculatively from its chunk's first byte, recording the bit offset of
//     every speculative MCU start (DC stored as raw diffs, no predictor).
//   phase 2 (parallel): each worker continues from its chunk-end state into
//     the next chunk until its MCU-start offset coincides with one recorded
//     by that chunk's own pass (synchronization), storing the overflow MCUs.
//   phase 3 (sequential, cheap): splice — chunk 0 is exact from bit 0; for
//     each chunk the true entry offset must be one of its recorded starts
//     (guaranteed by the sync), so its records from there on are the true
//     decode.  Any gap (failed sync / errored speculation) is filled by
//     plain sequential decode, so correctness never depends on the
//     speculation succeeding.  Finally DC diffs are prefix-summed into
//     predictors (jpeg.cpp:344-345 semantics).
//
// This is the decode-domain analogue of the subsequence-parallel scheme in
// the GPU JPEG literature, applied to host threads here and structured so
// the same trace/splice representation drives the device lane-parallel
// variant (ops/entropy_spec.py).
// ---------------------------------------------------------------------------

struct SpecChunk {
  std::vector<int64_t> starts;   // bit offset of each speculative MCU start
  std::vector<int32_t> blocks;   // starts.size() * bpm * 64 coefficients
  std::vector<int64_t> ovf_starts;   // phase-2 overflow MCU starts
  std::vector<int32_t> ovf_blocks;
  int64_t sync_bit = -1;         // where phase 2 synchronized (-1 = none)
  bool ok = true;                // speculative pass hit a decode error?
  int64_t end_bit = 0;           // bit position after the last own-chunk MCU
};

// Decode one MCU (bpm blocks) with DC emitted as raw diff. Returns 0 or err.
static int decode_mcu_diff(const ScanJob& job, BitReader& br, int32_t* out) {
  int32_t zero_pred;
  for (int k = 0; k < job.blocks_per_mcu; ++k) {
    int ci = job.block_comp[k];
    const CompSpec& c = job.comps[ci];
    zero_pred = 0;
    std::memset(out + k * 64, 0, 64 * sizeof(int32_t));
    int rc = decode_block(br, c.dc_lut, c.ac_lut, out + k * 64, zero_pred);
    if (rc) return rc;
    if (br.pos > br.end) return 6;  // ran past the stream end
  }
  return 0;
}


// ---------------------------------------------------------------------------
// T.81 Annex D/F arithmetic (QM) entropy decode — native mirror of
// entropy/arith.py (sequential SOF9 scans).  Statistics reset at restart
// segments (F.1.4.1.1), so segments stay the parallel unit, exactly like
// the Huffman paths above.
// ---------------------------------------------------------------------------

struct QmRow { uint16_t qe; uint8_t nmps, nlps, sw; };
// T.81 Table D.3 (row 113 = fixed ~0.5 bin, self-transitioning).
constexpr QmRow kQm[114] = {
    {0x5A1D,1,1,1}, {0x2586,2,14,0}, {0x1114,3,16,0}, {0x080B,4,18,0},
    {0x03D8,5,20,0}, {0x01DA,6,23,0}, {0x00E5,7,25,0}, {0x006F,8,28,0},
    {0x0036,9,30,0}, {0x001A,10,33,0}, {0x000D,11,35,0}, {0x0006,12,9,0},
    {0x0003,13,10,0}, {0x0001,13,12,0}, {0x5A7F,15,15,1}, {0x3F25,16,36,0},
    {0x2CF2,17,38,0}, {0x207C,18,39,0}, {0x17B9,19,40,0}, {0x1182,20,42,0},
    {0x0CEF,21,43,0}, {0x09A1,22,45,0}, {0x072F,23,46,0}, {0x055C,24,48,0},
    {0x0406,25,49,0}, {0x0303,26,51,0}, {0x0240,27,52,0}, {0x01B1,28,54,0},
    {0x0144,29,56,0}, {0x00F5,30,57,0}, {0x00B7,31,59,0}, {0x008A,32,60,0},
    {0x0068,33,62,0}, {0x004E,34,63,0}, {0x003B,35,32,0}, {0x002C,9,33,0},
    {0x5AE1,37,37,1}, {0x484C,38,64,0}, {0x3A0D,39,65,0}, {0x2EF1,40,67,0},
    {0x261F,41,68,0}, {0x1F33,42,69,0}, {0x19A8,43,70,0}, {0x1518,44,72,0},
    {0x1177,45,73,0}, {0x0E74,46,74,0}, {0x0BFB,47,75,0}, {0x09F8,48,77,0},
    {0x0861,49,78,0}, {0x0706,50,79,0}, {0x05CD,51,48,0}, {0x04DE,52,50,0},
    {0x040F,53,50,0}, {0x0363,54,51,0}, {0x02D4,55,52,0}, {0x025C,56,53,0},
    {0x01F8,57,54,0}, {0x01A4,58,55,0}, {0x0160,59,56,0}, {0x0125,60,57,0},
    {0x00F6,61,58,0}, {0x00CB,62,59,0}, {0x00AB,63,61,0}, {0x008F,32,61,0},
    {0x5B12,65,65,1}, {0x4D04,66,80,0}, {0x412C,67,81,0}, {0x37D8,68,82,0},
    {0x2FE8,69,83,0}, {0x293C,70,84,0}, {0x2379,71,86,0}, {0x1EDF,72,87,0},
    {0x1AA9,73,87,0}, {0x174E,74,72,0}, {0x1424,75,72,0}, {0x119C,76,74,0},
    {0x0F6B,77,74,0}, {0x0D51,78,75,0}, {0x0BB6,79,77,0}, {0x0A40,48,77,0},
    {0x5832,81,80,1}, {0x4D1C,82,88,0}, {0x438E,83,89,0}, {0x3BDD,84,90,0},
    {0x34EE,85,91,0}, {0x2EAE,86,92,0}, {0x299A,87,93,0}, {0x2516,71,86,0},
    {0x5570,89,88,1}, {0x4CA9,90,95,0}, {0x44D9,91,96,0}, {0x3E22,92,97,0},
    {0x3824,93,99,0}, {0x32B4,94,99,0}, {0x2E17,86,93,0}, {0x56A8,96,95,1},
    {0x4F46,97,101,0}, {0x47E5,98,102,0}, {0x41CF,99,103,0}, {0x3C3D,100,104,0},
    {0x375E,93,99,0}, {0x5231,102,105,0}, {0x4C0F,103,106,0}, {0x4639,104,107,0},
    {0x415E,99,103,0}, {0x5627,106,105,1}, {0x50E7,107,108,0}, {0x4B85,103,109,0},
    {0x5597,109,110,0}, {0x504F,107,111,0}, {0x5A10,111,110,1}, {0x5522,109,112,0},
    {0x59EB,111,112,1}, {0x5A1D,113,113,0},
};

// Packed per-context state: (qe << 16) | (nmps << 9) | (nlps << 2) |
// (sw << 1), with the running MPS in bit 0.  Built once from kQm.
struct QmPackedTable {
  uint32_t v[114];
  QmPackedTable() {
    for (int i = 0; i < 114; ++i)
      v[i] = (uint32_t(kQm[i].qe) << 16) | (uint32_t(kQm[i].nmps) << 9) |
             (uint32_t(kQm[i].nlps) << 2) | (uint32_t(kQm[i].sw) << 1);
  }
  uint32_t operator[](uint32_t i) const { return v[i]; }
};
static const QmPackedTable kQmPacked;

struct QmDecoder {
  const uint8_t* data;
  int64_t byte_pos, end;
  uint32_t a, c;
  uint64_t buf;   // MSB-first bit reservoir
  int nbuf;       // valid bits in buf

  inline void refill() {
    // Bulk path: one unaligned 8-byte load + bswap tops the reservoir up
    // in a single step.  It must stop 8 bytes short of the SEGMENT end:
    // bits past `end` are spec-mandated zero fill (T.81 F.2.2.5's
    // marker-detection rule degenerates to zeros on the unstuffed
    // buffer), and for a middle restart segment the bytes after `end`
    // are the NEXT segment's data — the clamped per-byte loop below
    // supplies the zeros there.
    if (__builtin_expect(byte_pos + 8 <= end, 1)) {
      uint64_t w;
      std::memcpy(&w, data + byte_pos, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
      w = __builtin_bswap64(w);
#endif
      int nb = (64 - nbuf) >> 3;
      // nb == 8 only when the reservoir is empty; guard the UB shift.
      buf = (nb == 8) ? w : ((buf << (nb * 8)) | (w >> (64 - nb * 8)));
      byte_pos += nb;
      nbuf += nb * 8;
      return;
    }
    while (nbuf <= 56) {
      uint64_t b = (byte_pos < end) ? data[byte_pos] : 0;
      ++byte_pos;
      buf = (buf << 8) | b;
      nbuf += 8;
    }
  }
  void init(const uint8_t* d, int64_t start, int64_t end_) {
    data = d;
    byte_pos = start;
    end = end_;
    buf = 0;
    nbuf = 0;
    a = 0x10000;
    refill();
    c = uint32_t(buf >> (nbuf - 16)) & 0xFFFF;
    nbuf -= 16;
  }
  // Take n bits (<= 15: one renorm shift) from the reservoir,
  // MSB-first.  EAGER refill: the reservoir is topped up AFTER the
  // bits are extracted, so the (independent) memory load overlaps the
  // consumer's serial a/c chain instead of stalling it; the invariant
  // nbuf >= 25 holds on entry (init leaves 48; every take restores).
  inline uint32_t take(int n) {
    uint32_t v = uint32_t(buf >> (nbuf - n)) & ((1u << n) - 1);
    nbuf -= n;
    if (__builtin_expect(nbuf < 25, 0)) refill();
    return v;
  }
  inline int decode(uint32_t* stats, int i) {
    // Packed-context decode: one 32-bit load yields qe + both
    // transition indices + the switch flag + MPS — the critical
    // dependency chain is load -> shift -> sub -> compare, vs the
    // two CHAINED loads (state byte, then kQm row) of the byte form.
    uint32_t e = stats[i];
    uint32_t qe = e >> 16;
    int mps = int(e & 1);
    uint32_t amq = a - qe;
    // Fast path: MPS without renormalization — kept as the ONE
    // data-dependent branch (it predicts well for steady skewed
    // contexts; a fully branchless variant measured ~20% slower, the
    // full cmov/renorm chain every decision costs more than the
    // residual mispredicts).
    if (__builtin_expect(c < amq && amq >= 0x8000, 1)) {
      a = amq;
      return mps;
    }
    // Renormalizing path, branchless: decision bit, conditional
    // exchange (D.2.3), statistics transition and renorm shift reduce
    // to conditional moves (renorm decisions are near-maximally
    // unpredictable by construction).
    bool lps_side = c >= amq;
    uint32_t av = lps_side ? qe : amq;
    c -= lps_side ? amq : 0;
    bool exch = amq < qe;
    int is_lps = int(lps_side ^ exch);
    int new_mps = mps ^ (is_lps & int((e >> 1) & 1));
    uint32_t next = is_lps ? ((e >> 2) & 0x7F) : ((e >> 9) & 0x7F);
    stats[i] = kQmPacked[next] | uint32_t(new_mps);
    // av < 0x8000 always here (amq < 0x8000 on the MPS side; qe <=
    // 0x5A1D on the LPS side), so the renorm shift is unconditional.
    int n = __builtin_clz(av) - 16;
    c = (c << n) | take(n);
    a = av << n;
    return mps ^ is_lps;
  }
};

struct ArithState {
  uint32_t dc_stats[4][64];
  uint32_t ac_stats[4][256];
  uint32_t fixed;
  int32_t last_dc[kMaxComps];
  int dc_ctx[kMaxComps];

  void reset() {
    const uint32_t s0 = kQmPacked[0];
    for (auto& tbl : dc_stats)
      for (auto& x : tbl) x = s0;
    for (auto& tbl : ac_stats)
      for (auto& x : tbl) x = s0;
    fixed = kQmPacked[113];  // FIXED_BIN
    std::memset(last_dc, 0, sizeof(last_dc));
    std::memset(dc_ctx, 0, sizeof(dc_ctx));
  }
};

// One DC diff (F.1.4.1, figures F.19-F.24); writes the accumulated DC.
static int arith_decode_dc(QmDecoder& qd, ArithState& st, int tbl, int ci,
                           int lparam, int uparam, int32_t* out_dc) {
  uint32_t* stats = st.dc_stats[tbl];
  int base = st.dc_ctx[ci];
  if (!qd.decode(stats, base)) {
    st.dc_ctx[ci] = 0;
    *out_dc = st.last_dc[ci];
    return 0;
  }
  int sign = qd.decode(stats, base + 1);
  int stx = base + 2 + sign;
  int m = qd.decode(stats, stx);
  if (m) {
    stx = 20;  // X1 (Table F.4)
    while (qd.decode(stats, stx)) {
      m <<= 1;
      if (m == 0x8000) return 7;
      ++stx;
    }
  }
  // Conditioning category for the NEXT block (F.1.4.4.1.2).
  if (m < ((1 << lparam) >> 1)) st.dc_ctx[ci] = 0;
  else if (m > ((1 << uparam) >> 1)) st.dc_ctx[ci] = 12 + sign * 4;
  else st.dc_ctx[ci] = 4 + sign * 4;
  int v = m;
  stx += 14;  // M bins (Table F.4)
  while ((m >>= 1)) {
    if (qd.decode(stats, stx)) v |= m;
  }
  v += 1;
  if (sign) v = -v;
  st.last_dc[ci] += v;
  *out_dc = st.last_dc[ci];
  return 0;
}

// AC coefficients k in [ss, se] into a natural-order block, values
// scaled by 2^al (sequential scans pass (1, 63, 0); progressive first
// scans their spectral band, T.81 G.3.3).
static int arith_decode_ac(QmDecoder& qd, ArithState& st, int tbl, int kx,
                           int32_t* blk, int ss = 1, int se = 63,
                           int al = 0) {
  uint32_t* stats = st.ac_stats[tbl];
  int k = ss;
  while (k <= se) {
    int stx = 3 * (k - 1);
    if (qd.decode(stats, stx)) return 0;  // EOB
    while (!qd.decode(stats, stx + 1)) {
      ++k;
      stx += 3;
      if (k > se) return 8;
    }
    int sign = qd.decode(&st.fixed, 0);
    stx += 2;
    int m = qd.decode(stats, stx);
    if (m) {
      if (qd.decode(stats, stx)) {
        m = 2;
        stx = (k <= kx) ? 189 : 217;
        while (qd.decode(stats, stx)) {
          m <<= 1;
          if (m == 0x8000) return 9;
          ++stx;
        }
      }
    }
    int v = m;
    stx += 14;
    while ((m >>= 1)) {
      if (qd.decode(stats, stx)) v |= m;
    }
    v += 1;
    if (sign) v = -v;
    blk[kZigzag[k]] = v << al;
    ++k;
  }
  return 0;
}

// Progressive AC refinement (T.81 G.3.4) — mirror of
// entropy/arith.py _ac_refine_scan_arith's inner loop.
static int arith_ac_refine_block(QmDecoder& qd, ArithState& st, int tbl,
                                 int32_t* blk, int ss, int se, int al) {
  uint32_t* stats = st.ac_stats[tbl];
  const int32_t p1 = int32_t(1) << al;
  const int32_t m1 = -(int32_t(1) << al);
  int kex = se;
  while (kex > 0 && blk[kZigzag[kex]] == 0) --kex;
  int k = ss;
  while (k <= se) {
    int stx = 3 * (k - 1);
    if (k > kex) {
      if (qd.decode(stats, stx)) return 0;  // EOB
    }
    for (;;) {
      int32_t coef = blk[kZigzag[k]];
      if (coef) {
        if (qd.decode(stats, stx + 2))
          blk[kZigzag[k]] = coef < 0 ? coef + m1 : coef + p1;
        break;
      }
      if (qd.decode(stats, stx + 1)) {
        blk[kZigzag[k]] = qd.decode(&st.fixed, 0) ? m1 : p1;
        break;
      }
      stx += 3;
      ++k;
      if (k > se) return 10;
    }
    ++k;
  }
  return 0;
}

}  // namespace

extern "C" {

// Speculative parallel decode of a DRI=0 interleaved baseline scan.
// data must be padded with >= 256 zero bytes (see BitReader); data_len\n// excludes the padding.
// out: (n_mcus * bpm, 64) int32, DC already predictor-accumulated.
// Returns 0 on success, -5 if the splice needed a full-sequential fallback
// and THAT failed (i.e. the stream is malformed), else error codes as
// jd_decode_scan.
int64_t jd_decode_scan_speculative(const uint8_t* data, int64_t data_len,
                                   int32_t n_comps,
                                   const int32_t* h, const int32_t* v,
                                   const int16_t* const* dc_luts,
                                   const int32_t* const* ac_luts,
                                   int64_t n_mcus,
                                   int32_t* out, int32_t n_threads,
                                   int32_t n_chunks) {
  if (n_comps < 1 || n_comps > kMaxComps) return -1;
  ScanJob job{};
  job.data = data;
  job.n_comps = n_comps;
  job.n_mcus = n_mcus;
  int bpm = 0;
  for (int ci = 0; ci < n_comps; ++ci) {
    job.comps[ci] = CompSpec{int(h[ci]), int(v[ci]), dc_luts[ci], ac_luts[ci]};
    for (int b = 0; b < h[ci] * v[ci]; ++b) {
      if (bpm >= kMaxComps * 16) return -2;
      job.block_comp[bpm++] = ci;
    }
  }
  job.blocks_per_mcu = bpm;
  const int64_t end_bit_total = data_len * 8;

  if (n_chunks < 1) n_chunks = 1;
  if (int64_t(n_chunks) > std::max<int64_t>(1, data_len / 4096))
    n_chunks = int32_t(std::max<int64_t>(1, data_len / 4096));
  const int64_t chunk_bytes = (data_len + n_chunks - 1) / n_chunks;

  std::vector<SpecChunk> chunks(n_chunks);
  auto chunk_start_bit = [&](int i) { return int64_t(i) * chunk_bytes * 8; };
  auto chunk_end_bit = [&](int i) {
    return std::min<int64_t>(int64_t(i + 1) * chunk_bytes, data_len) * 8;
  };

  // Phase 1: speculative decode of each chunk.
  auto phase1 = [&](int i) {
    SpecChunk& ch = chunks[i];
    BitReader br{data, chunk_start_bit(i), end_bit_total};
    std::vector<int32_t> mcu(bpm * 64);
    int64_t limit = chunk_end_bit(i);
    // Bound memory on adversarial data: a valid speculative trace has about
    // n_mcus / n_chunks records; allow 4x slack, then bail to the
    // sequential-fallback path.
    size_t cap = size_t(4 * (n_mcus / n_chunks) + 64);
    while (br.pos < limit && ch.starts.size() < cap) {
      int64_t at = br.pos;
      if (decode_mcu_diff(job, br, mcu.data())) { ch.ok = false; break; }
      ch.starts.push_back(at);
      ch.blocks.insert(ch.blocks.end(), mcu.begin(), mcu.end());
    }
    ch.end_bit = br.pos;
  };

  // Phase 2: continue into the next chunk until synchronization.
  auto phase2 = [&](int i) {
    if (i + 1 >= n_chunks) return;
    SpecChunk& ch = chunks[i];
    const SpecChunk& nx = chunks[i + 1];
    if (!ch.ok || nx.starts.empty()) return;
    BitReader br{data, ch.end_bit, end_bit_total};
    std::vector<int32_t> mcu(bpm * 64);
    int64_t limit = chunk_end_bit(i + 1);
    while (br.pos < limit) {
      if (std::binary_search(nx.starts.begin(), nx.starts.end(), br.pos)) {
        ch.sync_bit = br.pos;
        return;
      }
      int64_t at = br.pos;
      if (decode_mcu_diff(job, br, mcu.data())) return;
      ch.ovf_starts.push_back(at);
      ch.ovf_blocks.insert(ch.ovf_blocks.end(), mcu.begin(), mcu.end());
    }
  };

  {
    std::atomic<int> next{0};
    int nt = std::max(1, std::min<int>(n_threads, n_chunks));
    std::vector<std::thread> workers;
    for (int t = 0; t < nt; ++t)
      workers.emplace_back([&]() {
        for (;;) {
          int i = next.fetch_add(1);
          if (i >= n_chunks) return;
          phase1(i);
        }
      });
    for (auto& w : workers) w.join();
    next.store(0);
    workers.clear();
    for (int t = 0; t < nt; ++t)
      workers.emplace_back([&]() {
        for (;;) {
          int i = next.fetch_add(1);
          if (i >= n_chunks) return;
          phase2(i);
        }
      });
    for (auto& w : workers) w.join();
  }

  // Phase 3: sequential splice with sequential-decode fallback for gaps.
  int64_t bit = 0;       // true decode position (always an MCU start)
  int64_t mcu_idx = 0;
  const int64_t mcu_words = int64_t(bpm) * 64;
  BitReader seq{data, 0, end_bit_total};
  std::vector<int32_t> tmp(mcu_words);
  int chunk_i = 0;
  while (mcu_idx < n_mcus) {
    // Advance chunk_i to the chunk containing `bit`.
    while (chunk_i + 1 < n_chunks && bit >= chunk_start_bit(chunk_i + 1))
      ++chunk_i;
    SpecChunk& ch = chunks[chunk_i];
    auto it = std::lower_bound(ch.starts.begin(), ch.starts.end(), bit);
    if (it != ch.starts.end() && *it == bit) {
      // True decode coincides with the speculative trace: bulk-copy MCUs.
      size_t j = size_t(it - ch.starts.begin());
      size_t n_take = ch.starts.size() - j;
      n_take = std::min<size_t>(n_take, size_t(n_mcus - mcu_idx));
      std::memcpy(out + mcu_idx * mcu_words,
                  ch.blocks.data() + j * mcu_words,
                  n_take * mcu_words * sizeof(int32_t));
      mcu_idx += int64_t(n_take);
      if (mcu_idx >= n_mcus) break;
      if (j + n_take == ch.starts.size()) {
        // Consumed the chunk's own records; append its overflow records.
        size_t n_ovf = std::min<size_t>(ch.ovf_starts.size(),
                                        size_t(n_mcus - mcu_idx));
        if (n_ovf) {
          std::memcpy(out + mcu_idx * mcu_words,
                      ch.ovf_blocks.data(),
                      n_ovf * mcu_words * sizeof(int32_t));
          mcu_idx += int64_t(n_ovf);
        }
        if (mcu_idx >= n_mcus) break;
        if (ch.sync_bit >= 0 && n_ovf == ch.ovf_starts.size()) {
          bit = ch.sync_bit;
          continue;
        }
        // No sync: fall through to sequential decode from the position
        // after the last emitted MCU.
        bit = n_ovf ? -1 : ch.end_bit;
        if (bit < 0) {
          // Recompute: end of overflow decode.
          BitReader br{data, ch.ovf_starts.back(), end_bit_total};
          if (decode_mcu_diff(job, br, tmp.data())) return -5;
          bit = br.pos;
          // The MCU was already emitted above; do not emit twice.
        }
      } else {
        return -6;  // internal: partial take must exhaust records
      }
    } else {
      // Gap: decode one MCU sequentially (correctness fallback).
      seq.pos = bit;
      if (decode_mcu_diff(job, seq, tmp.data())) return -5;
      std::memcpy(out + mcu_idx * mcu_words, tmp.data(),
                  mcu_words * sizeof(int32_t));
      ++mcu_idx;
      bit = seq.pos;
    }
  }

  // DC predictor accumulation (prefix sum of diffs per component).
  {
    int32_t preds[kMaxComps] = {0, 0, 0, 0};
    for (int64_t m = 0; m < n_mcus; ++m) {
      int32_t* base = out + m * mcu_words;
      for (int k = 0; k < bpm; ++k) {
        int ci = job.block_comp[k];
        preds[ci] += base[k * 64];
        base[k * 64] = preds[ci];
      }
    }
  }
  return 0;
}

// Skeleton scan of a DRI=0 interleaved baseline scan: decode every Huffman
// symbol but store nothing, recording the absolute start BIT of every
// `stride`-th MCU into out_bits (ceil(n_mcus / stride) entries).  This is
// the host half of the hybrid device decode: positions are exact (full
// symbol-length decode), so device lanes extract coefficients from TRUE
// MCU starts — no speculative overflow windows, no chunk-skew idling, no
// splice.  The position scan is inherently serial (each symbol's start
// depends on the previous symbol's length) but does no coefficient stores,
// so it runs well above the full host decode rate; batches of images
// thread at the Python layer.
// Returns 0 on success, else the decode_block error code of the failing
// MCU (the caller falls back to the speculative or host path).
// out_syms (nullable): per-MCU Huffman symbol (probe) counts — the exact
// per-lane trip counts the emission device kernel needs for
// symbol-balanced lane splitting (ops.entropy_spec prepare, "emit" path).
int64_t jd_skeleton_scan(const uint8_t* data, int64_t data_len,
                         int32_t n_comps,
                         const int32_t* h, const int32_t* v,
                         const int16_t* const* dc_luts,
                         const int32_t* const* ac_luts,
                         int64_t n_mcus, int64_t stride,
                         int64_t* out_bits, int32_t* out_syms,
                         int32_t* out_pairs, int32_t precision) {
  if (n_comps < 1 || n_comps > kMaxComps || stride < 1) return -1;
  const int max_dc = precision > 8 ? 15 : 11;
  const int max_ac = precision > 8 ? 14 : 10;
  int bpm = 0;
  int block_comp[kMaxComps * 16];
  for (int ci = 0; ci < n_comps; ++ci)
    for (int b = 0; b < h[ci] * v[ci]; ++b) {
      if (bpm >= kMaxComps * 16) return -2;
      block_comp[bpm++] = ci;
    }
  BitReader br{data, 0, data_len * 8};
  int64_t lane = 0;
  PairSim psim;
  PairSim* ps = out_pairs ? &psim : nullptr;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (m % stride == 0) out_bits[lane++] = br.pos;
    int32_t nsym = 0;
    for (int k = 0; k < bpm; ++k) {
      int ci = block_comp[k];
      int rc = skip_block(br, dc_luts[ci], ac_luts[ci], nsym, ps,
                          max_dc, max_ac);
      if (rc) return rc;
      // Overrun check PER BLOCK (ADVICE r3): one block consumes at most
      // 64 symbols x 27 bits ~ 216 bytes, within the 256-byte zero pad;
      // a per-MCU check would let a dense-symbol truncated stream walk
      // up to 10 blocks (~2 KB) past the pad in one MCU.
      if (br.pos > data_len * 8 + 64) return 6;  // ran past the stream
    }
    if (out_syms) out_syms[m] = nsym;
    if (out_pairs) out_pairs[m] = psim.flush();
  }
  return 0;
}

// Decode a full interleaved baseline scan.
//
// data:          unstuffed entropy bytes, padded with >= 256 trailing zeros
// seg_offsets:   (n_segments + 1) byte offsets into data
// n_comps:       number of frame components (interleaved scan order)
// h, v:          per-component sampling factors
// dc_lut, ac_lut: per-component flat 2^16 int16 LUTs ((sym<<5)|len)
// mcus:          total MCU count; restart_interval: MCUs per segment (0=all)
// out:           (total_blocks, 64) int32, caller-zeroed
// n_threads:     worker threads for segment parallelism (<=1 => serial)
//
// Returns 0 on success; else (segment_index << 8) | error_code of the first
// failing segment.
int64_t jd_decode_scan(const uint8_t* data,
                       const int64_t* seg_offsets, int32_t n_segments,
                       int32_t n_comps,
                       const int32_t* h, const int32_t* v,
                       const int16_t* const* dc_luts,
                       const int32_t* const* ac_luts,
                       int64_t n_mcus, int64_t restart_interval,
                       int32_t* out, int32_t n_threads,
                       int32_t precision) {
  if (n_comps < 1 || n_comps > kMaxComps) return -1;
  ScanJob job;
  job.data = data;
  job.seg_offsets = seg_offsets;
  job.n_segments = n_segments;
  job.n_comps = n_comps;
  job.n_mcus = n_mcus;
  job.restart_interval = restart_interval;
  job.out = out;
  if (precision > 8) {  // T.81 B.2.2 extended size categories
    job.max_dc = 15;
    job.max_ac = 14;
  }
  int bpm = 0;
  for (int ci = 0; ci < n_comps; ++ci) {
    job.comps[ci] = CompSpec{int(h[ci]), int(v[ci]), dc_luts[ci], ac_luts[ci]};
    for (int b = 0; b < h[ci] * v[ci]; ++b) {
      if (bpm >= kMaxComps * 16) return -2;
      job.block_comp[bpm++] = ci;
    }
  }
  job.blocks_per_mcu = bpm;

  std::atomic<int64_t> err{0};
  if (n_threads <= 1 || n_segments <= 1) {
    for (int s = 0; s < n_segments; ++s) {
      int rc = decode_segment(job, s);
      if (rc) return (int64_t(s) << 8) | rc;
    }
    return 0;
  }

  std::atomic<int> next{0};
  int nt = std::min<int>(n_threads, n_segments);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&]() {
      for (;;) {
        int s = next.fetch_add(1);
        if (s >= job.n_segments || err.load()) return;
        int rc = decode_segment(job, s);
        if (rc) {
          int64_t e = (int64_t(s) << 8) | rc;
          int64_t zero = 0;
          err.compare_exchange_strong(zero, e);
          return;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  return err.load();
}

// Resilient (best-effort) scan decode for streams whose restart-segment
// count disagrees with DRI, or whose segments contain corrupt entropy data.
// Native mirror of entropy/python_ref.py decode_scan_resilient (libjpeg-
// style policy, vs the reference's exit(1) at the first error): marker
// positions are ground truth — segment s covers MCUs [s*DRI, (s+1)*DRI);
// surplus segments are ignored, missing segments leave their MCUs zero,
// and a decode error inside a segment zero-fills the partial MCU and
// resynchronizes at the next restart marker.  Segment-threaded like
// jd_decode_scan (a corrupt stream costs the same as a clean one, not a
// fallback to the oracle-grade Python path).
//
// data must carry a LARGE zero tail (>= 16384 bytes): garbage speculation
// near a segment end may overrun by up to one MCU before the per-MCU
// bound check fires (the Python reader clamps reads to zeros; the pad
// makes the C++ reader see the same zeros).
// out: (n_mcus * bpm, 64) int32, caller-zeroed.
// seg_err: per-segment first error code (0 = clean), caller-zeroed.
// Returns 0 (resilient decode never fails), or -1/-2 on bad parameters.
int64_t jd_decode_scan_resilient(const uint8_t* data,
                                 const int64_t* seg_offsets,
                                 int32_t n_segments, int32_t n_comps,
                                 const int32_t* h, const int32_t* v,
                                 const int16_t* const* dc_luts,
                                 const int32_t* const* ac_luts,
                                 int64_t n_mcus, int64_t restart_interval,
                                 int32_t* out, uint8_t* seg_err,
                                 int32_t n_threads, int32_t precision) {
  if (n_comps < 1 || n_comps > kMaxComps) return -1;
  ScanJob job;
  job.data = data;
  job.seg_offsets = seg_offsets;
  job.n_segments = n_segments;
  job.n_comps = n_comps;
  job.n_mcus = n_mcus;
  job.restart_interval = restart_interval;
  job.out = out;
  int bpm = 0;
  for (int ci = 0; ci < n_comps; ++ci) {
    job.comps[ci] = CompSpec{int(h[ci]), int(v[ci]), dc_luts[ci], ac_luts[ci]};
    for (int b = 0; b < h[ci] * v[ci]; ++b) {
      if (bpm >= kMaxComps * 16) return -2;
      job.block_comp[bpm++] = ci;
    }
  }
  job.blocks_per_mcu = bpm;
  if (precision > 8) {
    job.max_dc = 15;
    job.max_ac = 14;
  }
  const int64_t ri = restart_interval ? restart_interval : n_mcus;
  const int64_t mcu_words = int64_t(bpm) * 64;

  run_segments(n_segments, n_threads, [&](int s) -> int {
    const int64_t first = int64_t(s) * ri;
    if (first >= n_mcus) return 0;  // surplus segment: ignored
    const int64_t seg_mcus = std::min<int64_t>(ri, n_mcus - first);
    const int64_t end_bits = seg_offsets[s + 1] * 8;
    BitReader br{data, seg_offsets[s] * 8, end_bits};
    int32_t preds[kMaxComps] = {0, 0, 0, 0};
    for (int64_t m = first; m < first + seg_mcus; ++m) {
      if (br.pos > end_bits) break;  // segment bits exhausted: rest zero
      int32_t* base = out + m * mcu_words;
      for (int k = 0; k < bpm; ++k) {
        int ci = job.block_comp[k];
        const CompSpec& c = job.comps[ci];
        int rc = decode_block(br, c.dc_lut, c.ac_lut, base + k * 64,
                              preds[ci], job.max_dc, job.max_ac);
        if (rc) {
          std::memset(base, 0, size_t(mcu_words) * sizeof(int32_t));
          seg_err[s] = uint8_t(rc);
          return 0;  // resync at the next restart marker
        }
      }
    }
    return 0;
  });
  return 0;
}

// Packed-wire-format decode: emits int16 DC plane + int8 AC plane + sparse
// escape list for |AC| > 127, ready for PCIe shipping (see
// models/batch.py pack_blocks for the format rationale).  Segment-parallel
// like jd_decode_scan; escape sublists are appended under a mutex (order is
// irrelevant — they feed a scatter).
//
// Returns 0 ok; -3 if the escape capacity was exceeded (caller retries with
// a larger buffer); else (segment << 8) | error_code.
int64_t jd_decode_scan_packed(const uint8_t* data,
                              const int64_t* seg_offsets, int32_t n_segments,
                              int32_t n_comps,
                              const int32_t* h, const int32_t* v,
                              const int16_t* const* dc_luts,
                              const int32_t* const* ac_luts,
                              int64_t n_mcus, int64_t restart_interval,
                              int16_t* dc_out, int8_t* ac_out,
                              int32_t* esc_idx, int16_t* esc_val,
                              int64_t esc_cap, int64_t* esc_count,
                              int32_t n_threads) {
  if (n_comps < 1 || n_comps > kMaxComps) return -1;
  ScanJob job;
  job.data = data;
  job.seg_offsets = seg_offsets;
  job.n_segments = n_segments;
  job.n_comps = n_comps;
  job.n_mcus = n_mcus;
  job.restart_interval = restart_interval;
  job.out = nullptr;
  int bpm = 0;
  for (int ci = 0; ci < n_comps; ++ci) {
    job.comps[ci] = CompSpec{int(h[ci]), int(v[ci]), dc_luts[ci], ac_luts[ci]};
    for (int b = 0; b < h[ci] * v[ci]; ++b) {
      if (bpm >= kMaxComps * 16) return -2;
      job.block_comp[bpm++] = ci;
    }
  }
  job.blocks_per_mcu = bpm;

  std::atomic<int64_t> err{0};
  std::atomic<int64_t> esc_pos{0};

  auto run_seg = [&](int seg) -> int {
    BitReader br{job.data, job.seg_offsets[seg] * 8,
                 job.seg_offsets[seg + 1] * 8};
    int32_t preds[kMaxComps] = {0, 0, 0, 0};
    int64_t mcu0 = job.restart_interval ? job.restart_interval * seg : 0;
    int64_t mcu1 = job.restart_interval
                       ? std::min(job.n_mcus, mcu0 + job.restart_interval)
                       : job.n_mcus;
    std::vector<std::pair<int32_t, int16_t>> local_esc;
    int32_t tmp[64];
    for (int64_t m = mcu0; m < mcu1; ++m) {
      for (int k = 0; k < job.blocks_per_mcu; ++k) {
        int ci = job.block_comp[k];
        const CompSpec& c = job.comps[ci];
        std::memset(tmp, 0, sizeof(tmp));
        int rc = decode_block(br, c.dc_lut, c.ac_lut, tmp, preds[ci]);
        if (rc) return rc;
        if (br.pos > br.end) return 6;  // truncated segment
        int64_t bi = m * job.blocks_per_mcu + k;
        dc_out[bi] = int16_t(tmp[0]);
        int8_t* ac = ac_out + bi * 64;
        ac[0] = 0;
        for (int i = 1; i < 64; ++i) {
          int32_t val = tmp[i];
          if (val < -128 || val > 127) {
            local_esc.emplace_back(int32_t(bi * 64 + i), int16_t(val));
            ac[i] = int8_t(val < -128 ? -128 : 127);
          } else {
            ac[i] = int8_t(val);
          }
        }
      }
    }
    if (!local_esc.empty()) {
      int64_t base = esc_pos.fetch_add(int64_t(local_esc.size()));
      if (base + int64_t(local_esc.size()) > esc_cap) return 64;  // overflow
      for (size_t i = 0; i < local_esc.size(); ++i) {
        esc_idx[base + i] = local_esc[i].first;
        esc_val[base + i] = local_esc[i].second;
      }
    }
    return 0;
  };

  if (n_threads <= 1 || n_segments <= 1) {
    for (int s = 0; s < n_segments; ++s) {
      int rc = run_seg(s);
      if (rc == 64) return -3;
      if (rc) return (int64_t(s) << 8) | rc;
    }
    *esc_count = esc_pos.load();
    return 0;
  }

  std::atomic<int> next{0};
  int nt = std::min<int>(n_threads, n_segments);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&]() {
      for (;;) {
        int s = next.fetch_add(1);
        if (s >= job.n_segments || err.load()) return;
        int rc = run_seg(s);
        if (rc) {
          int64_t e = (rc == 64) ? -3 : ((int64_t(s) << 8) | rc);
          int64_t zero = 0;
          err.compare_exchange_strong(zero, e);
          return;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  if (err.load()) return err.load();
  *esc_count = esc_pos.load();
  return 0;
}

// Sparse-wire-format decode: emits int16 DC plane + a (gap uint8, val int8)
// stream over the flat (n_blocks * 64) AC array + escape list for
// |AC| > 127 (see models/batch.py sparsify_ac for the format and its
// device-side reconstruction).  ~3.4x fewer H2D bytes than the dense
// packed format on the reference corpus; emitting straight from the
// run-length decode loop also skips the dense AC plane write entirely.
//
// Segment-parallel: each worker encodes its segment with gaps relative to
// the segment's flat base; a cheap final splice fixes the one boundary gap
// per segment (inserting (255, 0) extenders as needed).
//
// Returns 0 ok; -3 if sparse_cap or esc_cap was exceeded (caller retries
// with larger buffers); else (segment << 8) | error_code.
int64_t jd_decode_scan_sparse(const uint8_t* data,
                              const int64_t* seg_offsets, int32_t n_segments,
                              int32_t n_comps,
                              const int32_t* h, const int32_t* v,
                              const int16_t* const* dc_luts,
                              const int32_t* const* ac_luts,
                              int64_t n_mcus, int64_t restart_interval,
                              int16_t* dc_out,
                              uint8_t* gap_out, int8_t* val_out,
                              int64_t sparse_cap, int64_t* sparse_count,
                              int32_t* esc_idx, int16_t* esc_val,
                              int64_t esc_cap, int64_t* esc_count,
                              int32_t n_threads) {
  if (n_comps < 1 || n_comps > kMaxComps) return -1;
  ScanJob job;
  job.data = data;
  job.seg_offsets = seg_offsets;
  job.n_segments = n_segments;
  job.n_comps = n_comps;
  job.n_mcus = n_mcus;
  job.restart_interval = restart_interval;
  job.out = nullptr;
  int bpm = 0;
  for (int ci = 0; ci < n_comps; ++ci) {
    job.comps[ci] = CompSpec{int(h[ci]), int(v[ci]), dc_luts[ci], ac_luts[ci]};
    for (int b = 0; b < h[ci] * v[ci]; ++b) {
      if (bpm >= kMaxComps * 16) return -2;
      job.block_comp[bpm++] = ci;
    }
  }
  job.blocks_per_mcu = bpm;

  struct SegSparse {
    std::unique_ptr<uint8_t[]> gaps;  // uninitialized worst-case buffers
    std::unique_ptr<int8_t[]> vals;
    size_t n = 0;
    size_t first_chain = 0;  // entries encoding the first nonzero's gap
    int64_t first_abs = -1, last_abs = -1;
    std::vector<int32_t> eidx;
    std::vector<int16_t> eval;
  };
  std::vector<SegSparse> segs(std::max(1, int(n_segments)));
  std::atomic<int64_t> err{0};

  auto run_seg = [&](int seg) -> int {
    SegSparse& out = segs[seg];
    BitReader br{job.data, job.seg_offsets[seg] * 8,
                 job.seg_offsets[seg + 1] * 8};
    int32_t preds[kMaxComps] = {0, 0, 0, 0};
    int64_t mcu0 = job.restart_interval ? job.restart_interval * seg : 0;
    int64_t mcu1 = job.restart_interval
                       ? std::min(job.n_mcus, mcu0 + job.restart_interval)
                       : job.n_mcus;
    const int64_t base = mcu0 * job.blocks_per_mcu * 64;
    int64_t prev = base - 1;
    // Start near the observed density (~9 nonzeros/block) and grow 2x on
    // demand — the worst case (64 B/block) would be 2x the dense plane
    // this format exists to avoid shipping.
    const int64_t n_blocks_seg = (mcu1 - mcu0) * job.blocks_per_mcu;
    size_t cap = size_t(n_blocks_seg) * 16 + 256;
    out.gaps.reset(new uint8_t[cap]);
    out.vals.reset(new int8_t[cap]);
    uint8_t* gp = out.gaps.get();
    int8_t* vp = out.vals.get();
    auto ensure = [&](size_t extra) {
      size_t used = size_t(gp - out.gaps.get());
      if (used + extra <= cap) return;
      size_t ncap = std::max(cap * 2, used + extra + 256);
      uint8_t* ng = new uint8_t[ncap];
      int8_t* nv = new int8_t[ncap];
      std::memcpy(ng, out.gaps.get(), used);
      std::memcpy(nv, out.vals.get(), used);
      out.gaps.reset(ng);
      out.vals.reset(nv);
      gp = ng + used;
      vp = nv + used;
      cap = ncap;
    };
    int32_t tmp[64];
    for (int64_t m = mcu0; m < mcu1; ++m) {
      for (int k = 0; k < job.blocks_per_mcu; ++k) {
        int ci = job.block_comp[k];
        const CompSpec& c = job.comps[ci];
        uint64_t mask;
        int rc = decode_block_mask(br, c.dc_lut, c.ac_lut, tmp, preds[ci],
                                   mask);
        if (rc) return rc;
        if (br.pos > br.end) return 6;  // truncated segment
        const int64_t bi = m * job.blocks_per_mcu + k;
        dc_out[bi] = int16_t(tmp[0]);
        const int64_t babs = bi * 64;
        while (mask) {
          const int i = __builtin_ctzll(mask);
          mask &= mask - 1;
          const int32_t val = tmp[i];
          const int64_t abs_i = babs + i;
          int64_t g = abs_i - prev;
          ensure(size_t(g / 255) + 2);
          while (g > 255) {
            *gp++ = 255;
            *vp++ = 0;
            g -= 255;
          }
          *gp++ = uint8_t(g);
          if (__builtin_expect(val < -128 || val > 127, 0)) {
            out.eidx.push_back(int32_t(abs_i));
            out.eval.push_back(int16_t(val));
            *vp++ = int8_t(val < -128 ? -128 : 127);
          } else {
            *vp++ = int8_t(val);
          }
          if (out.first_abs < 0) {
            out.first_abs = abs_i;
            out.first_chain = size_t(gp - out.gaps.get());
          }
          prev = abs_i;
        }
      }
    }
    out.n = size_t(gp - out.gaps.get());
    out.last_abs = (prev >= base) ? prev : -1;
    return 0;
  };

  if (n_threads <= 1 || n_segments <= 1) {
    for (int s = 0; s < n_segments; ++s) {
      int rc = run_seg(s);
      if (rc) return (int64_t(s) << 8) | rc;
    }
  } else {
    std::atomic<int> next{0};
    int nt = std::min<int>(n_threads, n_segments);
    std::vector<std::thread> workers;
    workers.reserve(nt);
    for (int t = 0; t < nt; ++t) {
      workers.emplace_back([&]() {
        for (;;) {
          int s = next.fetch_add(1);
          if (s >= job.n_segments || err.load()) return;
          int rc = run_seg(s);
          if (rc) {
            int64_t e = (int64_t(s) << 8) | rc;
            int64_t zero = 0;
            err.compare_exchange_strong(zero, e);
            return;
          }
        }
      });
    }
    for (auto& w : workers) w.join();
    if (err.load()) return err.load();
  }

  // Splice: fix each segment's first gap for the true previous-nonzero
  // position, then bulk-copy.  Escapes concatenate in any order.
  int64_t sp = 0, ep = 0;
  int64_t prev_abs = -1;
  for (int s = 0; s < std::max(1, int(n_segments)); ++s) {
    SegSparse& sg = segs[s];
    const int64_t base =
        (job.restart_interval ? job.restart_interval * s : 0) *
        job.blocks_per_mcu * 64;
    if (sg.n != 0) {
      // Re-encode the whole first-gap chain against the true previous
      // nonzero (the segment encoded it assuming prev = base - 1, and a
      // chain with extenders cannot be fixed by adjusting one entry —
      // the canonical encoding is (g-1)/255 extenders then the residual).
      int64_t g0 = sg.first_abs - prev_abs;
      size_t n_ext = size_t((g0 - 1) / 255);
      int64_t n_here = int64_t(n_ext) + 1 + int64_t(sg.n - sg.first_chain);
      if (sp + n_here > sparse_cap) return -3;
      for (size_t i = 0; i < n_ext; ++i) {
        gap_out[sp] = 255;
        val_out[sp] = 0;
        ++sp;
      }
      gap_out[sp] = uint8_t(g0 - int64_t(n_ext) * 255);
      val_out[sp] = sg.vals[sg.first_chain - 1];
      ++sp;
      std::memcpy(gap_out + sp, sg.gaps.get() + sg.first_chain,
                  sg.n - sg.first_chain);
      std::memcpy(val_out + sp, sg.vals.get() + sg.first_chain,
                  sg.n - sg.first_chain);
      sp += int64_t(sg.n - sg.first_chain);
      prev_abs = sg.last_abs;
    }
    if (!sg.eidx.empty()) {
      if (ep + int64_t(sg.eidx.size()) > esc_cap) return -3;
      std::memcpy(esc_idx + ep, sg.eidx.data(),
                  sg.eidx.size() * sizeof(int32_t));
      std::memcpy(esc_val + ep, sg.eval.data(),
                  sg.eval.size() * sizeof(int16_t));
      ep += int64_t(sg.eidx.size());
    }
  }
  *sparse_count = sp;
  *esc_count = ep;
  return 0;
}

// Nibble-wire-format decode ("v2"): one uint8 entry per nonzero,
// (gap<<4)|val-code, plus an int8 overflow stream for |val| > 7 and the
// usual escape list for |val| > 127 (see models/batch.py nibbleize_ac for
// the code assignments and device-side reconstruction).  ~1.5x fewer
// wire bytes than the (gap u8, val i8) sparse format on the corpus.
//
// Returns 0 ok; -3 on entry/ov/esc capacity overflow (caller retries);
// else (segment << 8) | error_code.
int64_t jd_decode_scan_nibble(const uint8_t* data,
                              const int64_t* seg_offsets, int32_t n_segments,
                              int32_t n_comps,
                              const int32_t* h, const int32_t* v,
                              const int16_t* const* dc_luts,
                              const int32_t* const* ac_luts,
                              int64_t n_mcus, int64_t restart_interval,
                              int16_t* dc_out,
                              uint8_t* entry_out, int64_t entry_cap,
                              int64_t* entry_count,
                              int8_t* ov_out, int64_t ov_cap,
                              int64_t* ov_count,
                              int32_t* esc_idx, int16_t* esc_val,
                              int64_t esc_cap, int64_t* esc_count,
                              int32_t n_threads) {
  if (n_comps < 1 || n_comps > kMaxComps) return -1;
  ScanJob job;
  job.data = data;
  job.seg_offsets = seg_offsets;
  job.n_segments = n_segments;
  job.n_comps = n_comps;
  job.n_mcus = n_mcus;
  job.restart_interval = restart_interval;
  job.out = nullptr;
  int bpm = 0;
  for (int ci = 0; ci < n_comps; ++ci) {
    job.comps[ci] = CompSpec{int(h[ci]), int(v[ci]), dc_luts[ci], ac_luts[ci]};
    for (int b = 0; b < h[ci] * v[ci]; ++b) {
      if (bpm >= kMaxComps * 16) return -2;
      job.block_comp[bpm++] = ci;
    }
  }
  job.blocks_per_mcu = bpm;

  struct SegNib {
    std::unique_ptr<uint8_t[]> entries;  // uninitialized worst-case buffer
    size_t n = 0;
    size_t first_chain = 0;  // entries encoding the first nonzero's gap
    int64_t first_abs = -1, last_abs = -1;
    std::vector<int8_t> ov;
    std::vector<int32_t> eidx;
    std::vector<int16_t> eval;
  };
  std::vector<SegNib> segs(std::max(1, int(n_segments)));
  std::atomic<int64_t> err{0};

  auto run_seg = [&](int seg) -> int {
    SegNib& out = segs[seg];
    BitReader br{job.data, job.seg_offsets[seg] * 8,
                 job.seg_offsets[seg + 1] * 8};
    int32_t preds[kMaxComps] = {0, 0, 0, 0};
    int64_t mcu0 = job.restart_interval ? job.restart_interval * seg : 0;
    int64_t mcu1 = job.restart_interval
                       ? std::min(job.n_mcus, mcu0 + job.restart_interval)
                       : job.n_mcus;
    const int64_t base = mcu0 * job.blocks_per_mcu * 64;
    int64_t prev = base - 1;
    // Start near the observed density and grow 2x on demand.
    const int64_t n_blocks_seg = (mcu1 - mcu0) * job.blocks_per_mcu;
    size_t cap = size_t(n_blocks_seg) * 16 + 256;
    out.entries.reset(new uint8_t[cap]);
    uint8_t* ep = out.entries.get();
    auto ensure = [&](size_t extra) {
      size_t used = size_t(ep - out.entries.get());
      if (used + extra <= cap) return;
      size_t ncap = std::max(cap * 2, used + extra + 256);
      uint8_t* ne = new uint8_t[ncap];
      std::memcpy(ne, out.entries.get(), used);
      out.entries.reset(ne);
      ep = ne + used;
      cap = ncap;
    };
    int32_t tmp[64];
    bool first = true;
    for (int64_t m = mcu0; m < mcu1; ++m) {
      for (int k = 0; k < job.blocks_per_mcu; ++k) {
        int ci = job.block_comp[k];
        const CompSpec& c = job.comps[ci];
        uint64_t mask;
        int rc = decode_block_mask(br, c.dc_lut, c.ac_lut, tmp, preds[ci],
                                   mask);
        if (rc) return rc;
        if (br.pos > br.end) return 6;  // truncated segment
        const int64_t bi = m * job.blocks_per_mcu + k;
        dc_out[bi] = int16_t(tmp[0]);
        const int64_t babs = bi * 64;
        while (mask) {
          const int i = __builtin_ctzll(mask);
          mask &= mask - 1;
          const int32_t val = tmp[i];
          const int64_t abs_i = babs + i;
          int64_t g = abs_i - prev;
          ensure(size_t(g / 240) + 3);
          while (g > 255) {
            *ep++ = 0xF0;  // chain extender: advance 240
            g -= 240;
          }
          if (g > 15) {
            *ep++ = uint8_t((g >> 4) << 4);  // scaled extender: g_hi * 16
            g &= 15;
          }
          uint8_t vcn;
          if (val >= -7 && val <= 7) {
            vcn = uint8_t(val & 15);
          } else {
            vcn = 8;
            out.ov.push_back(
                int8_t(val < -128 ? -128 : (val > 127 ? 127 : val)));
            if (__builtin_expect(val < -128 || val > 127, 0)) {
              out.eidx.push_back(int32_t(abs_i));
              out.eval.push_back(int16_t(val));
            }
          }
          *ep++ = uint8_t((g << 4) | vcn);
          if (first) {
            first = false;
            out.first_abs = abs_i;
            out.first_chain = size_t(ep - out.entries.get());
          }
          prev = abs_i;
        }
      }
    }
    out.n = size_t(ep - out.entries.get());
    out.last_abs = (prev >= base) ? prev : -1;
    return 0;
  };

  if (n_threads <= 1 || n_segments <= 1) {
    for (int s = 0; s < n_segments; ++s) {
      int rc = run_seg(s);
      if (rc) return (int64_t(s) << 8) | rc;
    }
  } else {
    std::atomic<int> next{0};
    int nt = std::min<int>(n_threads, n_segments);
    std::vector<std::thread> workers;
    workers.reserve(nt);
    for (int t = 0; t < nt; ++t) {
      workers.emplace_back([&]() {
        for (;;) {
          int s = next.fetch_add(1);
          if (s >= job.n_segments || err.load()) return;
          int rc = run_seg(s);
          if (rc) {
            int64_t e = (int64_t(s) << 8) | rc;
            int64_t zero = 0;
            err.compare_exchange_strong(zero, e);
            return;
          }
        }
      });
    }
    for (auto& w : workers) w.join();
    if (err.load()) return err.load();
  }

  // Splice: re-encode each segment's first gap chain against the true
  // previous nonzero, copy the rest; ov/escapes concatenate in order.
  int64_t sp = 0, op = 0, ep_ = 0;
  int64_t prev_abs = -1;
  for (int s = 0; s < std::max(1, int(n_segments)); ++s) {
    SegNib& sg = segs[s];
    if (sg.n != 0) {
      int64_t g = sg.first_abs - prev_abs;
      const uint8_t vcn = sg.entries[sg.first_chain - 1] & 15;
      // Worst case chain length for g: g/240 + 2.
      if (sp + int64_t(g / 240 + 2) + int64_t(sg.n - sg.first_chain) >
          entry_cap)
        return -3;
      while (g > 255) {
        entry_out[sp++] = 0xF0;
        g -= 240;
      }
      if (g > 15) {
        entry_out[sp++] = uint8_t((g >> 4) << 4);
        g &= 15;
      }
      entry_out[sp++] = uint8_t((g << 4) | vcn);
      std::memcpy(entry_out + sp, sg.entries.get() + sg.first_chain,
                  sg.n - sg.first_chain);
      sp += int64_t(sg.n - sg.first_chain);
      prev_abs = sg.last_abs;
    }
    if (!sg.ov.empty()) {
      if (op + int64_t(sg.ov.size()) > ov_cap) return -3;
      std::memcpy(ov_out + op, sg.ov.data(), sg.ov.size());
      op += int64_t(sg.ov.size());
    }
    if (!sg.eidx.empty()) {
      if (ep_ + int64_t(sg.eidx.size()) > esc_cap) return -3;
      std::memcpy(esc_idx + ep_, sg.eidx.data(),
                  sg.eidx.size() * sizeof(int32_t));
      std::memcpy(esc_val + ep_, sg.eval.data(),
                  sg.eval.size() * sizeof(int16_t));
      ep_ += int64_t(sg.eidx.size());
    }
  }
  *entry_count = sp;
  *ov_count = op;
  *esc_count = ep_;
  return 0;
}

// Slot-wire-format decode: per block, the first `cap` AC nonzeros fill
// (position uint8, value int8) slot arrays; the tail spills to an
// overflow list and |val| > 127 additionally to the escape list (see
// models/batch.py slotify_ac).  Device reconstruction is a scatter-free
// one-hot compare-and-sum — this format trades ~3x the wire bytes of the
// nibble format for ~10x cheaper device unpack.
//
// pos_out/val_out are (n_blocks * cap), caller-zeroed.
// Returns 0 ok; -3 on overflow/escape capacity (caller retries); else
// (segment << 8) | error_code.
int64_t jd_decode_scan_slots(const uint8_t* data,
                             const int64_t* seg_offsets, int32_t n_segments,
                             int32_t n_comps,
                             const int32_t* h, const int32_t* v,
                             const int16_t* const* dc_luts,
                             const int32_t* const* ac_luts,
                             int64_t n_mcus, int64_t restart_interval,
                             int16_t* dc_out,
                             uint8_t* pos_out, int8_t* val_out,
                             int32_t cap,
                             int32_t* ov_idx, int16_t* ov_val,
                             int64_t ov_cap, int64_t* ov_count,
                             int32_t* esc_idx, int16_t* esc_val,
                             int64_t esc_cap, int64_t* esc_count,
                             int32_t n_threads) {
  if (n_comps < 1 || n_comps > kMaxComps) return -1;
  if (cap < 1 || cap > 63) return -1;
  ScanJob job;
  job.data = data;
  job.seg_offsets = seg_offsets;
  job.n_segments = n_segments;
  job.n_comps = n_comps;
  job.n_mcus = n_mcus;
  job.restart_interval = restart_interval;
  job.out = nullptr;
  int bpm = 0;
  for (int ci = 0; ci < n_comps; ++ci) {
    job.comps[ci] = CompSpec{int(h[ci]), int(v[ci]), dc_luts[ci], ac_luts[ci]};
    for (int b = 0; b < h[ci] * v[ci]; ++b) {
      if (bpm >= kMaxComps * 16) return -2;
      job.block_comp[bpm++] = ci;
    }
  }
  job.blocks_per_mcu = bpm;

  struct SegSlots {
    std::vector<int32_t> oidx;
    std::vector<int16_t> oval;
    std::vector<int32_t> eidx;
    std::vector<int16_t> eval;
  };
  std::vector<SegSlots> segs(std::max(1, int(n_segments)));
  std::atomic<int64_t> err{0};

  auto run_seg = [&](int seg) -> int {
    SegSlots& out = segs[seg];
    BitReader br{job.data, job.seg_offsets[seg] * 8,
                 job.seg_offsets[seg + 1] * 8};
    int32_t preds[kMaxComps] = {0, 0, 0, 0};
    int64_t mcu0 = job.restart_interval ? job.restart_interval * seg : 0;
    int64_t mcu1 = job.restart_interval
                       ? std::min(job.n_mcus, mcu0 + job.restart_interval)
                       : job.n_mcus;
    int32_t tmp[64];
    for (int64_t m = mcu0; m < mcu1; ++m) {
      for (int k = 0; k < job.blocks_per_mcu; ++k) {
        int ci = job.block_comp[k];
        const CompSpec& c = job.comps[ci];
        uint64_t mask;
        int rc = decode_block_mask(br, c.dc_lut, c.ac_lut, tmp, preds[ci],
                                   mask);
        if (rc) return rc;
        if (br.pos > br.end) return 6;  // truncated segment
        const int64_t bi = m * job.blocks_per_mcu + k;
        dc_out[bi] = int16_t(tmp[0]);
        uint8_t* ps = pos_out + bi * cap;
        int8_t* vs = val_out + bi * cap;
        int slot = 0;
        while (mask) {
          const int i = __builtin_ctzll(mask);
          mask &= mask - 1;
          const int32_t val = tmp[i];
          const int8_t clipped =
              int8_t(val < -128 ? -128 : (val > 127 ? 127 : val));
          if (slot < cap) {
            ps[slot] = uint8_t(i);
            vs[slot] = clipped;
            ++slot;
          } else {
            out.oidx.push_back(int32_t(bi * 64 + i));
            out.oval.push_back(int16_t(clipped));
          }
          if (__builtin_expect(val < -128 || val > 127, 0)) {
            out.eidx.push_back(int32_t(bi * 64 + i));
            out.eval.push_back(int16_t(val));
          }
        }
      }
    }
    return 0;
  };

  if (n_threads <= 1 || n_segments <= 1) {
    for (int s = 0; s < n_segments; ++s) {
      int rc = run_seg(s);
      if (rc) return (int64_t(s) << 8) | rc;
    }
  } else {
    std::atomic<int> next{0};
    int nt = std::min<int>(n_threads, n_segments);
    std::vector<std::thread> workers;
    workers.reserve(nt);
    for (int t = 0; t < nt; ++t) {
      workers.emplace_back([&]() {
        for (;;) {
          int s = next.fetch_add(1);
          if (s >= job.n_segments || err.load()) return;
          int rc = run_seg(s);
          if (rc) {
            int64_t e = (int64_t(s) << 8) | rc;
            int64_t zero = 0;
            err.compare_exchange_strong(zero, e);
            return;
          }
        }
      });
    }
    for (auto& w : workers) w.join();
    if (err.load()) return err.load();
  }

  int64_t op = 0, ep = 0;
  for (auto& sg : segs) {
    if (!sg.oidx.empty()) {
      if (op + int64_t(sg.oidx.size()) > ov_cap) return -3;
      std::memcpy(ov_idx + op, sg.oidx.data(),
                  sg.oidx.size() * sizeof(int32_t));
      std::memcpy(ov_val + op, sg.oval.data(),
                  sg.oval.size() * sizeof(int16_t));
      op += int64_t(sg.oidx.size());
    }
    if (!sg.eidx.empty()) {
      if (ep + int64_t(sg.eidx.size()) > esc_cap) return -3;
      std::memcpy(esc_idx + ep, sg.eidx.data(),
                  sg.eidx.size() * sizeof(int32_t));
      std::memcpy(esc_val + ep, sg.eval.data(),
                  sg.eval.size() * sizeof(int16_t));
      ep += int64_t(sg.eidx.size());
    }
  }
  *ov_count = op;
  *esc_count = ep;
  return 0;
}

// ---------------------------------------------------------------------------
// Progressive scans (ITU-T T.81 Annex G.2) — native fast path.
//
// Same semantics as entropy/progressive.py (the correctness-grade Python
// implementation, cross-tested bit-exactly): DC first/refinement scans
// (interleaved or single-component), AC first/refinement scans with EOB
// runs and in-band correction bits, restart intervals in every scan type.
// Planes are caller-owned (rows, cols, 64) int32 natural-order arrays.
// ---------------------------------------------------------------------------

// Decode DC scan.  interleaved: blocks cycle through scan components with
// their sampling factors over the (mcus_x, mcus_y) grid; otherwise a single
// component's unpadded (rows x cols) block grid, one block per MCU.
// plane stride: plane_cols[c] * 64 per block row.
int64_t jd_prog_dc_scan(const uint8_t* data, const int64_t* seg_offsets,
                        int32_t n_segments, int32_t first, int32_t al,
                        int32_t interleaved, int32_t n_scan_comps,
                        const int32_t* comp_h, const int32_t* comp_v,
                        int32_t* const* planes, const int32_t* plane_cols,
                        const int16_t* const* dc_luts,
                        int64_t mcus_x, int64_t mcus_y,
                        int64_t sc_rows, int64_t sc_cols,
                        int64_t restart_interval, int32_t n_threads) {
  if (n_scan_comps < 1 || n_scan_comps > kMaxComps) return -1;
  const int64_t n_mcus = interleaved ? mcus_x * mcus_y : sc_rows * sc_cols;
  if (!restart_interval && n_segments != 1) return -4;
  const int64_t ri = restart_interval ? restart_interval : n_mcus;
  if (int64_t(n_segments) * ri < n_mcus) return -4;  // missing segments
  return run_segments(n_segments, n_threads, [&](int s) -> int {
    const int64_t seg_first = int64_t(s) * ri;
    if (seg_first >= n_mcus) return 0;  // surplus segment: nothing to do
    const int64_t seg_mcus = std::min<int64_t>(ri, n_mcus - seg_first);
    BitReader br{data, seg_offsets[s] * 8, seg_offsets[s + 1] * 8};
    int32_t preds[kMaxComps] = {0, 0, 0, 0};
    for (int64_t t = 0; t < seg_mcus; ++t) {
      const int64_t mcu = seg_first + t;
      if (interleaved) {
        int64_t my = mcu / mcus_x, mx = mcu % mcus_x;
        for (int c = 0; c < n_scan_comps; ++c) {
          for (int vv = 0; vv < comp_v[c]; ++vv) {
            for (int hh = 0; hh < comp_h[c]; ++hh) {
              int64_t row = my * comp_v[c] + vv, col = mx * comp_h[c] + hh;
              int32_t* blk = planes[c] + (row * plane_cols[c] + col) * 64;
              if (first) {
                LutEntry e = probe16_idx(dc_luts[c], br.peek16());
                int len = e & 31;
                if (!len) return 1;
                br.pos += len;
                int size = e >> 5;
                if (size > 11) return 2;
                int32_t diff =
                    size ? extend(br.getbits(size), size) : 0;
                preds[c] += diff;
                blk[0] = preds[c] << al;
              } else {
                if (br.getbits(1)) blk[0] |= (1 << al);
              }
            }
          }
        }
      } else {
        int64_t row = mcu / sc_cols, col = mcu % sc_cols;
        int32_t* blk = planes[0] + (row * plane_cols[0] + col) * 64;
        if (first) {
          LutEntry e = probe16_idx(dc_luts[0], br.peek16());
          int len = e & 31;
          if (!len) return 1;
          br.pos += len;
          int size = e >> 5;
          if (size > 11) return 2;
          int32_t diff = size ? extend(br.getbits(size), size) : 0;
          preds[0] += diff;
          blk[0] = preds[0] << al;
        } else {
          if (br.getbits(1)) blk[0] |= (1 << al);
        }
      }
      if (br.pos > br.end) return 6;  // truncated scan
    }
    return 0;
  });
}

// AC scans: always single-component over the unpadded (rows x cols) grid.
int64_t jd_prog_ac_scan(const uint8_t* data, const int64_t* seg_offsets,
                        int32_t n_segments, int32_t first,
                        int32_t ss, int32_t se, int32_t al,
                        int32_t* plane, int32_t plane_cols,
                        const int16_t* ac_lut,
                        int64_t rows, int64_t cols,
                        int64_t restart_interval, int32_t n_threads) {
  const int64_t n_mcus = rows * cols;
  const int32_t p1 = 1 << al;
  if (!restart_interval && n_segments != 1) return -4;
  const int64_t ri = restart_interval ? restart_interval : n_mcus;
  if (int64_t(n_segments) * ri < n_mcus) return -4;  // missing segments
  return run_segments(n_segments, n_threads, [&](int s) -> int {
    const int64_t seg_first = int64_t(s) * ri;
    if (seg_first >= n_mcus) return 0;  // surplus segment: nothing to do
    const int64_t seg_mcus = std::min<int64_t>(ri, n_mcus - seg_first);
    BitReader br{data, seg_offsets[s] * 8, seg_offsets[s + 1] * 8};
    // Register-resident bit window (see decode_block): refill when fewer
    // than 31 valid bits remain (max per step: 16-bit code + 14 EOB-run
    // or value bits).  Refinement correction bits come from the same
    // window one bit at a time.
    uint64_t w = br.window();
    int avail = 64 - int(br.pos & 7);
    auto need = [&](int n) {
      if (avail < n) {
        w = br.window();
        avail = 64 - int(br.pos & 7);
      }
    };
    auto take = [&](int n) -> uint32_t {
      uint32_t v = uint32_t(w >> (64 - n));
      w <<= n;
      avail -= n;
      br.pos += n;
      return v;
    };
    int64_t eobrun = 0;
    for (int64_t t = 0; t < seg_mcus; ++t) {
      const int64_t mcu = seg_first + t;
      int64_t row = mcu / cols, col = mcu % cols;
      int32_t* blk = plane + (row * int64_t(plane_cols) + col) * 64;
      if (first) {
        if (eobrun > 0) {
          --eobrun;
          continue;
        }
        int k = ss;
        while (k <= se) {
          need(31);
          LutEntry e = probe16(ac_lut, w);
          int len = e & 31;
          if (!len) return 3;
          int sym = e >> 5;
          int r = sym >> 4, sz = sym & 0x0F;
          if (sz == 0) {
            if (r < 15) {
              take(len);
              eobrun = (int64_t(1) << r) - 1;
              if (r) eobrun += take(r);
              break;
            }
            take(len);
            k += 16;  // ZRL
          } else {
            k += r;
            if (k > se) return 4;
            uint64_t wv = w << len;
            blk[kZigzag[k]] =
                extend(uint32_t(wv >> (64 - sz)), sz) << al;
            take(len + sz);
            ++k;
          }
        }
      } else {
        // Refinement (G.2.3).
        int k = ss;
        if (eobrun == 0) {
          while (k <= se) {
            need(31);
            LutEntry e = probe16(ac_lut, w);
            int len = e & 31;
            if (!len) return 3;
            take(len);
            int sym = e >> 5;
            int r = sym >> 4, sz = sym & 0x0F;
            int32_t newval = 0;
            if (sz == 0) {
              if (r < 15) {
                eobrun = int64_t(1) << r;
                if (r) eobrun += take(r);
                break;
              }
              // r == 15: ZRL — skip 16 zero-history coefficients
            } else {
              if (sz != 1) return 5;
              need(1);
              newval = take(1) ? p1 : -p1;
            }
            while (k <= se) {
              int32_t& nz = blk[kZigzag[k]];
              if (nz != 0) {
                need(1);
                if (take(1) && (nz & p1) == 0)
                  nz += (nz > 0) ? p1 : -p1;
              } else {
                if (r == 0) break;
                --r;
              }
              ++k;
            }
            if (newval && k <= se) blk[kZigzag[k]] = newval;
            ++k;
          }
        }
        if (eobrun > 0) {
          while (k <= se) {
            int32_t& nz = blk[kZigzag[k]];
            if (nz != 0) {
              need(1);
              if (take(1) && (nz & p1) == 0)
                nz += (nz > 0) ? p1 : -p1;
            }
            ++k;
          }
          --eobrun;
        }
      }
      if (br.pos > br.end) return 6;  // truncated scan
    }
    return 0;
  });
}

// Entropy-region byte unstuffer (reference: JPEGFile::readImageData,
// file.hpp:59-104).  Single memchr-driven pass over the entropy-coded
// region:
//   FF 00    -> keep FF, drop 00 (byte stuffing)
//   FF FF    -> drop the first FF (fill byte), re-inspect the next
//   FF D0-D7 -> drop both, record a restart-segment boundary (offset in
//               the clean stream)
//   FF other -> terminator (next marker); also a lone FF at region end
//
// out must have capacity >= len.  Returns the offset in `data` of the
// terminating FF; -1 if no terminator exists; -3 if seg_cap is exceeded.
int64_t jd_unstuff(const uint8_t* data, int64_t len,
                   uint8_t* out, int64_t* out_len,
                   int64_t* seg_offsets, int64_t seg_cap, int64_t* n_segs) {
  int64_t p = 0, o = 0, ns = 0;
  for (;;) {
    const void* hit = std::memchr(data + p, 0xFF, size_t(len - p));
    if (hit == nullptr) return -1;  // no terminating marker
    const int64_t ff = int64_t(static_cast<const uint8_t*>(hit) - data);
    std::memcpy(out + o, data + p, size_t(ff - p));
    o += ff - p;
    if (ff + 1 >= len) {  // trailing lone FF: treat as terminator
      *out_len = o;
      *n_segs = ns;
      return ff;
    }
    const uint8_t nx = data[ff + 1];
    if (nx == 0x00) {
      out[o++] = 0xFF;
      p = ff + 2;
    } else if (nx == 0xFF) {
      p = ff + 1;  // drop fill byte, re-inspect
    } else if (nx >= 0xD0 && nx <= 0xD7) {
      if (ns >= seg_cap) return -3;
      seg_offsets[ns++] = o;
      p = ff + 2;
    } else {
      *out_len = o;
      *n_segs = ns;
      return ff;
    }
  }
}

// Version/capability probe for the ctypes wrapper.

// Sequential arithmetic (SOF9) interleaved scan -> scan-order natural-order
// (n_mcus * bpm, 64) int32 blocks, segment-parallel (mirror of
// jd_decode_scan for the QM coder; entropy/arith.py decode_scan_baseline).
// dc_tid/ac_tid: per-component conditioning-table ids (0..3);
// dc_l/dc_u (per table id, 4 entries): DAC L/U; ac_kx (4): DAC Kx.
int64_t jd_decode_scan_arith(const uint8_t* data,
                             const int64_t* seg_offsets, int32_t n_segments,
                             int32_t n_comps,
                             const int32_t* h, const int32_t* v,
                             const int32_t* dc_tid, const int32_t* ac_tid,
                             const int32_t* dc_l, const int32_t* dc_u,
                             const int32_t* ac_kx,
                             int64_t n_mcus, int64_t restart_interval,
                             int32_t* out, int32_t n_threads) {
  if (n_comps < 1 || n_comps > kMaxComps) return -1;
  int block_comp[kMaxComps * 16];
  int bpm = 0;
  for (int ci = 0; ci < n_comps; ++ci) {
    for (int b = 0; b < h[ci] * v[ci]; ++b) {
      if (bpm >= kMaxComps * 16) return -2;
      block_comp[bpm++] = ci;
    }
  }
  const int64_t ri = restart_interval ? restart_interval : n_mcus;

  auto decode_seg = [&](int s) -> int {
    int64_t first = int64_t(s) * ri;
    if (first >= n_mcus) return 0;
    int64_t seg_mcus = std::min<int64_t>(ri, n_mcus - first);
    QmDecoder qd;
    qd.init(data, seg_offsets[s], seg_offsets[s + 1]);
    ArithState st;
    st.reset();
    for (int64_t m = first; m < first + seg_mcus; ++m) {
      int32_t* base = out + m * int64_t(bpm) * 64;
      for (int k = 0; k < bpm; ++k) {
        int ci = block_comp[k];
        int32_t* blk = base + int64_t(k) * 64;
        std::memset(blk, 0, 64 * sizeof(int32_t));
        int rc = arith_decode_dc(qd, st, dc_tid[ci], ci,
                                 dc_l[dc_tid[ci]], dc_u[dc_tid[ci]],
                                 blk);
        if (rc) return rc;
        rc = arith_decode_ac(qd, st, ac_tid[ci], ac_kx[ac_tid[ci]], blk);
        if (rc) return rc;
      }
    }
    return 0;
  };

  if (n_threads <= 1 || n_segments <= 1) {
    for (int s = 0; s < n_segments; ++s) {
      int rc = decode_seg(s);
      if (rc) return (int64_t(s) << 8) | rc;
    }
    return 0;
  }
  std::atomic<int64_t> err{0};
  std::atomic<int> next{0};
  int nt = std::min<int>(n_threads, n_segments);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&]() {
      for (;;) {
        int s = next.fetch_add(1);
        if (s >= n_segments || err.load()) return;
        int rc = decode_seg(s);
        if (rc) {
          int64_t e = (int64_t(s) << 8) | rc;
          int64_t zero = 0;
          err.compare_exchange_strong(zero, e);
          return;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  return err.load();
}


// Progressive arithmetic DC scan (T.81 G.3.2): first pass is the
// sequential DC procedure scaled by 2^al; refinement is one fixed-bin
// decision per block setting bit al.  Mirror of entropy/arith.py
// _dc_scan_arith; statistics reset per restart segment (F.1.4.1.1).
int64_t jd_prog_dc_scan_arith(const uint8_t* data,
                              const int64_t* seg_offsets,
                              int32_t n_segments, int32_t first, int32_t al,
                              int32_t interleaved, int32_t n_scan_comps,
                              const int32_t* comp_h, const int32_t* comp_v,
                              int32_t* const* planes,
                              const int32_t* plane_cols,
                              const int32_t* dc_tid,
                              const int32_t* dc_l, const int32_t* dc_u,
                              int64_t mcus_x, int64_t mcus_y,
                              int64_t sc_rows, int64_t sc_cols,
                              int64_t restart_interval, int32_t n_threads) {
  if (n_scan_comps < 1 || n_scan_comps > kMaxComps) return -1;
  const int64_t n_mcus = interleaved ? mcus_x * mcus_y : sc_rows * sc_cols;
  if (!restart_interval && n_segments != 1) return -4;
  const int64_t ri = restart_interval ? restart_interval : n_mcus;
  if (int64_t(n_segments) * ri < n_mcus) return -4;  // missing segments
  return run_segments(n_segments, n_threads, [&](int s) -> int {
    const int64_t seg_first = int64_t(s) * ri;
    if (seg_first >= n_mcus) return 0;  // surplus segment: nothing to do
    const int64_t seg_mcus = std::min<int64_t>(ri, n_mcus - seg_first);
    QmDecoder qd;
    qd.init(data, seg_offsets[s], seg_offsets[s + 1]);
    ArithState st;
    st.reset();
    for (int64_t t = 0; t < seg_mcus; ++t) {
      const int64_t mcu = seg_first + t;
      if (interleaved) {
        int64_t my = mcu / mcus_x, mx = mcu % mcus_x;
        for (int c = 0; c < n_scan_comps; ++c) {
          for (int vv = 0; vv < comp_v[c]; ++vv) {
            for (int hh = 0; hh < comp_h[c]; ++hh) {
              int64_t row = my * comp_v[c] + vv, col = mx * comp_h[c] + hh;
              int32_t* blk = planes[c] + (row * plane_cols[c] + col) * 64;
              if (first) {
                int32_t dcv;
                int rc = arith_decode_dc(qd, st, dc_tid[c], c,
                                         dc_l[dc_tid[c]], dc_u[dc_tid[c]],
                                         &dcv);
                if (rc) return rc;
                blk[0] = dcv << al;
              } else {
                if (qd.decode(&st.fixed, 0)) blk[0] |= (int32_t(1) << al);
              }
            }
          }
        }
      } else {
        int64_t row = mcu / sc_cols, col = mcu % sc_cols;
        int32_t* blk = planes[0] + (row * plane_cols[0] + col) * 64;
        if (first) {
          int32_t dcv;
          int rc = arith_decode_dc(qd, st, dc_tid[0], 0,
                                   dc_l[dc_tid[0]], dc_u[dc_tid[0]], &dcv);
          if (rc) return rc;
          blk[0] = dcv << al;
        } else {
          if (qd.decode(&st.fixed, 0)) blk[0] |= (int32_t(1) << al);
        }
      }
    }
    return 0;
  });
}

// Progressive arithmetic AC scan (G.3.3 first pass / G.3.4 refinement)
// over a single component's unpadded block grid.  Mirror of
// entropy/arith.py _ac_first_scan_arith / _ac_refine_scan_arith.
int64_t jd_prog_ac_scan_arith(const uint8_t* data,
                              const int64_t* seg_offsets,
                              int32_t n_segments, int32_t ss, int32_t se,
                              int32_t ah, int32_t al,
                              int32_t* plane, int32_t plane_cols_,
                              int32_t ac_tid, int32_t kx,
                              int64_t rows, int64_t cols,
                              int64_t restart_interval, int32_t n_threads) {
  const int64_t n_units = rows * cols;
  if (!restart_interval && n_segments != 1) return -4;
  const int64_t ri = restart_interval ? restart_interval : n_units;
  if (int64_t(n_segments) * ri < n_units) return -4;  // missing segments
  return run_segments(n_segments, n_threads, [&](int s) -> int {
    const int64_t seg_first = int64_t(s) * ri;
    if (seg_first >= n_units) return 0;  // surplus segment: nothing to do
    const int64_t seg_units = std::min<int64_t>(ri, n_units - seg_first);
    QmDecoder qd;
    qd.init(data, seg_offsets[s], seg_offsets[s + 1]);
    ArithState st;
    st.reset();
    for (int64_t t = 0; t < seg_units; ++t) {
      const int64_t unit = seg_first + t;
      int64_t row = unit / cols, col = unit % cols;
      int32_t* blk = plane + (row * int64_t(plane_cols_) + col) * 64;
      int rc = ah == 0
                   ? arith_decode_ac(qd, st, ac_tid, kx, blk, ss, se, al)
                   : arith_ac_refine_block(qd, st, ac_tid, blk, ss, se, al);
      if (rc) return rc;
    }
    return 0;
  });
}

// ---------------------------------------------------------------------------
// Progressive skeleton scans (position-only): the host half of the
// DEVICE-lane progressive decode (ops/entropy_prog).  Walks one DRI=0
// progressive scan decoding every symbol but storing no coefficients,
// recording at every stride-th MCU the lane state a device kernel needs
// to decode from that point: bit position, plus DC predictors (DC first)
// or the pending EOB run (AC scans).
//
// AC refinement bit consumption depends on which band coefficients are
// nonzero, NOT on their values — the caller maintains a per-block uint64
// BAND-POSITION bitmap (bit k set <=> coefficient at zigzag index k is
// nonzero), updated by the AC-first and AC-refine walks, so the skeleton
// never touches the (large, cache-hostile) coefficient planes.
// ---------------------------------------------------------------------------

// DC-first skeleton.  block_comp order = scan component order.
// out_bits: (ceil(n_mcus / stride),) absolute start bit of each lane.
// out_preds: (n_lanes, n_scan_comps) predictors entering each lane.
int64_t jd_prog_skeleton_dc(const uint8_t* data, int64_t start_byte,
                            int64_t data_len, int32_t n_scan_comps,
                            const int32_t* comp_h, const int32_t* comp_v,
                            const int16_t* const* dc_luts,
                            int32_t interleaved, int64_t n_mcus,
                            int64_t stride, int64_t* out_bits,
                            int32_t* out_preds) {
  if (n_scan_comps < 1 || n_scan_comps > kMaxComps || stride < 1) return -1;
  int bpm = 0;
  int block_comp[kMaxComps * 16];
  if (interleaved) {
    for (int c = 0; c < n_scan_comps; ++c)
      for (int b = 0; b < comp_h[c] * comp_v[c]; ++b) {
        if (bpm >= kMaxComps * 16) return -2;
        block_comp[bpm++] = c;
      }
  } else {
    block_comp[bpm++] = 0;
  }
  BitReader br{data, start_byte * 8, data_len * 8};
  int32_t preds[kMaxComps] = {0, 0, 0, 0};
  int64_t lane = 0;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (m % stride == 0) {
      out_bits[lane] = br.pos;
      for (int c = 0; c < n_scan_comps; ++c)
        out_preds[lane * n_scan_comps + c] = preds[c];
      ++lane;
    }
    for (int k = 0; k < bpm; ++k) {
      int c = block_comp[k];
      LutEntry e = probe16_idx(dc_luts[c], br.peek16());
      int len = e & 31;
      if (!len) return 1;
      br.pos += len;
      int size = e >> 5;
      if (size > 11) return 2;
      if (size) preds[c] += extend(br.getbits(size), size);
    }
    if (br.pos > br.end + 64) return 6;
  }
  return 0;
}

// AC skeleton (first pass or refinement).  nzmap: (n_blocks,) uint64
// band-position bitmap, persisted by the caller across the component's
// scan chain.  out_bits/out_eobrun: (ceil(n_blocks / stride),) lane
// states (absolute start bit, pending EOB run entering the lane).
//
// out_syms (optional, (n_blocks,)): for FIRST-pass scans the per-block
// Huffman symbol count (exact trip counts for the emission AC-first
// kernel); for REFINEMENT scans the per-block EVENT count of the
// emission refine kernel (ops/entropy_prog.decode_ac_refine_emit) under
// its merged chunk rule — each symbol costs one event that also
// distributes up to (32 - symbol_bits) correction bits, each further
// 32-bit correction chunk costs one event, and an EOB-run-covered block
// costs ceil(n_corrections / 32) events (zero-correction covered blocks
// are skipped for free on device).  Run with stride == 1 these arrays
// let the host pick event-BALANCED lane boundaries.
int64_t jd_prog_skeleton_ac(const uint8_t* data, int64_t start_byte,
                            int64_t data_len, int32_t first,
                            int32_t ss, int32_t se, const int16_t* ac_lut,
                            uint64_t* nzmap, int64_t n_blocks,
                            int64_t stride, int64_t* out_bits,
                            int32_t* out_eobrun, int32_t* out_syms) {
  if (stride < 1 || ss < 1 || se > 63 || ss > se) return -1;
  BitReader br{data, start_byte * 8, data_len * 8};
  int64_t eobrun = 0;
  int64_t lane = 0;
  // Register bit window (see jd_prog_ac_scan): refill under 31 valid
  // bits; one symbol consumes <= 16 code + 14 run/value bits.
  uint64_t w = br.window();
  int avail = 64 - int(br.pos & 7);
  auto need = [&](int n) {
    if (avail < n) {
      w = br.window();
      avail = 64 - int(br.pos & 7);
    }
  };
  auto take = [&](int n) -> uint32_t {
    uint32_t v = uint32_t(w >> (64 - n));
    w <<= n;
    avail -= n;
    br.pos += n;
    return v;
  };
  for (int64_t b = 0; b < n_blocks; ++b) {
    if (b % stride == 0) {
      out_bits[lane] = br.pos;
      out_eobrun[lane] = int32_t(std::min<int64_t>(eobrun, INT32_MAX));
      ++lane;
    }
    uint64_t map = nzmap[b];
    if (first) {
      if (eobrun > 0) {
        --eobrun;
        if (out_syms) out_syms[b] = 0;
        continue;
      }
      int32_t nsym = 0;
      int k = ss;
      while (k <= se) {
        need(31);
        LutEntry e = probe16(ac_lut, w);
        int len = e & 31;
        if (!len) return 3;
        ++nsym;
        int sym = e >> 5;
        int r = sym >> 4, sz = sym & 0x0F;
        if (sz == 0) {
          if (r < 15) {
            take(len);
            eobrun = (int64_t(1) << r) - 1;
            if (r) eobrun += take(r);
            break;
          }
          take(len);
          k += 16;  // ZRL
        } else {
          k += r;
          if (k > se) return 4;
          map |= uint64_t(1) << k;
          take(len + sz);
          ++k;
        }
      }
      if (out_syms) out_syms[b] = nsym;
    } else {
      // Refinement: correction-bit consumption depends only on WHICH
      // band positions are set in ``map`` — so instead of the per-
      // position walk, corrections are counted with popcount over the
      // masked bitmap and skipped in bulk (refine streams are mostly
      // correction bits; the per-bit loop was the host walk's hot spot).
      int k = ss;
      const uint64_t bandm =
          (se >= 63 ? ~0ull : ((1ull << (se + 1)) - 1))
          & ~((1ull << ss) - 1ull);
      auto bulk_skip = [&](int nc) {
        while (nc > 0) {
          need(31);
          int t = nc < 31 ? nc : 31;
          take(t);
          nc -= t;
        }
      };
      // Emission-kernel event accounting with greedy SYMBOL PAIRING
      // (mirror of decode_ac_refine_emit's packing): a phase = one
      // symbol plus its correction bits.  A phase whose opener event
      // fully fits (no continuation chunks), completes its zero-run
      // inside the band (next symbol follows in the same block) and
      // consumed <= 16 bits OPENS the event for the next phase; the
      // next phase JOINS when its symbol bits still fit the 32-bit
      // window, with correction cap 32 - used - sym_bits.  Pairing
      // never crosses blocks or survives continuation chunks — the
      // rule is local to two adjacent phases (see PairSim's dominance
      // note; here the count is exact, not a bound, because the kernel
      // executes the same automaton).
      int32_t ev = 0;
      auto extra = [](int nc, int cap0) -> int32_t {
        return nc <= cap0 ? 0 : (nc - cap0 + 31) / 32;
      };
      bool open = false;
      int used = 0;
      auto phase_ev = [&](int sym_b, int nc, bool completes_run) {
        if (open && used + sym_b <= 32) {
          ev += extra(nc, 32 - used - sym_b);
          open = false;
        } else {
          int extras = extra(nc, 32 - sym_b);
          ev += 1 + extras;
          open = (extras == 0) && completes_run && (sym_b + nc <= 16);
          used = sym_b + nc;
        }
      };
      int pend_bits = 0;  // symbol bits of an EOB opened THIS block
      bool entered_eob = eobrun > 0;
      if (eobrun == 0) {
        while (k <= se) {
          need(31);
          LutEntry e = probe16(ac_lut, w);
          int len = e & 31;
          if (!len) return 3;
          take(len);
          int sym = e >> 5;
          int r = sym >> 4, sz = sym & 0x0F;
          bool newval = false;
          if (sz == 0) {
            if (r < 15) {
              eobrun = int64_t(1) << r;
              if (r) eobrun += take(r);
              pend_bits = len + r;
              break;
            }
            // ZRL: 16 zero-history skips, no value
            pend_bits = len;
          } else {
            if (sz != 1) return 5;
            need(1);
            take(1);
            newval = true;
            pend_bits = len + 1;
          }
          // Zero-run to the (r+1)-th zero-history position >= k (the
          // newval site); corrections = set bits crossed on the way.
          const uint64_t tail = map & bandm & ~((1ull << k) - 1ull);
          uint64_t zeros = ~map & bandm & ~((1ull << k) - 1ull);
          int stop = -1;
          for (int j = 0; j < r + 1 && zeros; ++j) {
            stop = __builtin_ctzll(zeros);
            zeros &= zeros - 1;
            if (j < r) stop = -1;
          }
          int nc;
          if (stop < 0) {
            nc = __builtin_popcountll(tail);  // run passes band end
            bulk_skip(nc);
            phase_ev(pend_bits, nc, false);
            k = se + 1;
          } else {
            nc = __builtin_popcountll(tail & ((1ull << stop) - 1ull));
            bulk_skip(nc);
            phase_ev(pend_bits, nc, stop + 1 <= se);
            if (newval) map |= 1ull << stop;
            k = stop + 1;
          }
        }
      }
      if (eobrun > 0) {
        int nc = (k > 63) ? 0
                          : __builtin_popcountll(
                                map & bandm & ~((1ull << k) - 1ull));
        bulk_skip(nc);
        --eobrun;
        if (entered_eob)
          ev += (nc + 31) / 32;  // covered block: pure correction chunks
        else
          phase_ev(pend_bits, nc, false);  // EOB decoded this block
      }
      if (out_syms) out_syms[b] = ev;
    }
    nzmap[b] = map;
    if (br.pos > br.end + 64) return 6;
  }
  return 0;
}

// Emit-lane prep for ONE image (VERDICT r4 item 4): per-segment
// skeleton walks (threaded), pair-balanced lane boundaries with
// segment starts forced, and exact per-lane trip maxima — the whole
// host half of prepare_hybrid_batch_emit minus the pool fill, in one
// call (the Python version paid one ctypes call PER SEGMENT plus
// python bounds loops; restart corpora have 50+ segments/image).
//
// scratch_*: caller-provided (n_mcus,) work arrays (kept so repeated
// calls allocate nothing).  out_m_lo/out_nm/out_starts are sized by
// the caller to at least max_chunks + n_segments + 1 lanes.  Returns
// 0 on success (out_L lanes written) or the skeleton error code.
int64_t jd_emit_prep(const uint8_t* data, int64_t data_len,
                     const int64_t* seg_offsets, int32_t n_segments,
                     int32_t n_comps, const int32_t* h, const int32_t* v,
                     const int16_t* const* dc_luts,
                     const int32_t* const* ac_luts,
                     int64_t n_mcus, int64_t restart_interval,
                     int32_t precision, int32_t max_chunks,
                     int32_t cap_factor, int32_t target_steps,
                     int64_t* scratch_bits, int32_t* scratch_syms,
                     int32_t* scratch_pairs,
                     int64_t* out_m_lo, int32_t* out_nm,
                     int32_t* out_starts,
                     int64_t* out_T_sym, int64_t* out_T_pair,
                     int32_t* out_L, int32_t n_threads) {
  (void)data_len;  // per-segment lengths come from seg_offsets
  if (n_comps < 1 || n_comps > kMaxComps || n_segments < 1) return -1;
  const int64_t per_seg = restart_interval ? restart_interval : n_mcus;
  if (int64_t(n_segments) * per_seg < n_mcus) return -4;
  // Per-segment position-only walks (independent: DC reset + byte
  // alignment at RSTn, jpeg.cpp:419-425).
  int64_t rc = run_segments(n_segments, n_threads, [&](int sg) -> int {
    const int64_t m0 = int64_t(sg) * per_seg;
    if (m0 >= n_mcus) return 0;
    const int64_t m1 = std::min<int64_t>(n_mcus, m0 + per_seg);
    const int64_t lo = seg_offsets[sg], hi = seg_offsets[sg + 1];
    int64_t r = jd_skeleton_scan(
        data + lo, hi - lo, n_comps, h, v, dc_luts, ac_luts, m1 - m0, 1,
        scratch_bits + m0, scratch_syms + m0, scratch_pairs + m0,
        precision);
    if (r) return int(r & 0xFF) ? int(r & 0xFF) : 1;
    for (int64_t m = m0; m < m1; ++m) scratch_bits[m] += lo * 8;
    return 0;
  });
  if (rc) return rc;

  // Cumulative sym/pair counts (int64) with cum[0] = 0.
  std::vector<int64_t> cums(n_mcus + 1), cump(n_mcus + 1);
  cums[0] = cump[0] = 0;
  for (int64_t m = 0; m < n_mcus; ++m) {
    cums[m + 1] = cums[m] + scratch_syms[m];
    cump[m + 1] = cump[m] + scratch_pairs[m];
  }
  const int64_t total = std::max<int64_t>(1, cump[n_mcus]);
  int64_t c_goal = (total + std::max(64, target_steps) - 1)
                   / std::max(64, target_steps);
  c_goal = std::max<int64_t>(
      1, std::min<int64_t>(std::min<int64_t>(max_chunks, n_mcus), c_goal));

  // Pair-balanced boundaries, segment starts forced (a lane never
  // decodes across the byte-alignment gap); cap_nm bounds lane MCU
  // counts (mirror of the Python image_bounds).
  int32_t L_out = 0;
  int64_t T_sym = 0, T_pair = 0;
  auto push = [&](int64_t lo_m, int64_t hi_m) {
    out_m_lo[L_out] = lo_m;
    out_nm[L_out] = int32_t(hi_m - lo_m);
    out_starts[L_out] =
        int32_t(scratch_bits[std::min(lo_m, n_mcus - 1)]);
    T_sym = std::max(T_sym, cums[hi_m] - cums[lo_m]);
    T_pair = std::max(T_pair, cump[hi_m] - cump[lo_m]);
    ++L_out;
  };
  for (int sg = 0; sg < n_segments; ++sg) {
    const int64_t a = std::min<int64_t>(int64_t(sg) * per_seg, n_mcus);
    const int64_t bseg =
        std::min<int64_t>(int64_t(sg + 1) * per_seg, n_mcus);
    if (bseg <= a) break;
    const int64_t cs = cump[bseg] - cump[a];
    int64_t L = int64_t(llround(double(c_goal) * double(cs)
                                / double(total)));
    if (L < 1) L = 1;
    L = std::min<int64_t>(L, bseg - a);
    const int64_t cap_nm = std::max<int64_t>(
        1, ((bseg - a) * cap_factor + L - 1) / L);
    int64_t lo_m = a;
    for (int64_t i = 0; i < L; ++i) {
      int64_t want;
      if (i < L - 1) {
        const double tgt =
            double(cump[a])
            + double(cump[bseg] - cump[a]) * double(i + 1) / double(L);
        // searchsorted-left over cump[a..bseg]
        int64_t loi = a, hii = bseg;
        while (loi < hii) {
          int64_t mid = (loi + hii) / 2;
          if (double(cump[mid]) < tgt) loi = mid + 1; else hii = mid;
        }
        want = loi;
      } else {
        want = bseg;
      }
      int64_t hi_m = std::min<int64_t>(
          std::min<int64_t>(std::max(want, lo_m), lo_m + cap_nm), bseg);
      hi_m = std::max(hi_m, bseg - (L - 1 - i) * cap_nm);
      if (hi_m > lo_m) {
        push(lo_m, hi_m);
        lo_m = hi_m;
      }
    }
    if (lo_m != bseg) push(lo_m, bseg);
  }
  *out_T_sym = T_sym;
  *out_T_pair = T_pair;
  *out_L = L_out;
  return 0;
}

int32_t jd_abi_version() { return 22; }

}  // extern "C"
