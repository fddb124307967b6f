// Minimal LASzip (.laz) codec — native replacement for the reference's
// lazrs/laspy LAZ path (las_dataset.py:36-41 reads .laz via laspy's
// LazBackend chain; this image has neither laspy nor lazrs, and the NFI
// distribution ships LAZ).
//
// Scope: compressor type 2 (POINTWISE_CHUNKED) with version-2 items
//   POINT10 v2, GPSTIME11 v2, RGB12 v2, BYTE v2
// i.e. LAS point formats 0-3 (+ extra bytes), the airborne-LiDAR formats.
// Both directions are implemented (decompress for ingestion, compress for
// export and test fixtures).
//
// Implementation notes: the entropy coder is the Amir-Said FastAC variant
// used by LASzip (arithmetic{enc,dec} with DM_/BM_ LengthShift 15/13,
// AC__MinLength renormalization), the predictors mirror
// las{read,write}item_compressed_v2 (streaming median-of-5 x/y deltas with
// 16 return-context slots, per-level z heights, changed-values flag symbol,
// multi-sequence gpstime with 32-bit-diff multipliers). Written from the
// LASzip format description; round-trip correctness is test-asserted
// (tests/test_data.py); conformance against reference laszip archives
// should be re-validated in an environment that has laspy+lazrs.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;
typedef int8_t I8;
typedef int16_t I16;
typedef int32_t I32;
typedef int64_t I64;

namespace laz {

// ---------------------------------------------------------------------------
// FastAC arithmetic coder (as in LASzip: arithmeticencoder/decoder.cpp)
// ---------------------------------------------------------------------------

static const U32 AC_MinLength = 0x01000000u;
static const U32 AC_MaxLength = 0xFFFFFFFFu;

static const int DM_LengthShift = 15;
static const U32 DM_MaxCount = 1u << DM_LengthShift;
static const int BM_LengthShift = 13;
static const U32 BM_MaxCount = 1u << BM_LengthShift;

struct ArithmeticModel {
    std::vector<U32> distribution, symbol_count, decoder_table;
    U32 symbols = 0, total_count = 0, update_cycle = 0, symbols_until_update = 0;
    U32 last_symbol = 0, table_size = 0, table_shift = 0;
    bool compress = false;

    void init(U32 n, bool for_compress) {
        symbols = n;
        compress = for_compress;
        last_symbol = n - 1;
        if (!for_compress && symbols > 16) {
            U32 table_bits = 3;
            while (symbols > (1u << (table_bits + 2))) ++table_bits;
            table_size = 1u << table_bits;
            table_shift = DM_LengthShift - table_bits;
            decoder_table.assign(table_size + 2, 0);
        } else {
            table_size = table_shift = 0;
            decoder_table.clear();
        }
        distribution.assign(symbols, 0);
        symbol_count.assign(symbols, 1);
        total_count = 0;
        update_cycle = symbols;
        update();
        symbols_until_update = update_cycle = (symbols + 6) >> 1;
    }

    void update() {
        if ((total_count += update_cycle) > DM_MaxCount) {
            total_count = 0;
            for (U32 n = 0; n < symbols; n++) {
                symbol_count[n] = (symbol_count[n] + 1) >> 1;
                total_count += symbol_count[n];
            }
        }
        U32 sum = 0, s = 0;
        U32 scale = 0x80000000u / total_count;
        if (compress || (table_size == 0)) {
            for (U32 k = 0; k < symbols; k++) {
                distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
                sum += symbol_count[k];
            }
        } else {
            for (U32 k = 0; k < symbols; k++) {
                distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
                sum += symbol_count[k];
                U32 w = distribution[k] >> table_shift;
                while (s < w) decoder_table[++s] = k - 1;
            }
            decoder_table[0] = 0;
            while (s <= table_size) decoder_table[++s] = symbols - 1;
        }
        update_cycle = (5 * update_cycle) >> 2;
        U32 max_cycle = (symbols + 6) << 3;
        if (update_cycle > max_cycle) update_cycle = max_cycle;
        symbols_until_update = update_cycle;
    }
};

struct ArithmeticBitModel {
    U32 bit_0_prob, bit_0_count, bit_count, update_cycle, bits_until_update;

    void init() {
        bit_0_count = 1;
        bit_count = 2;
        bit_0_prob = 1u << (BM_LengthShift - 1);
        update_cycle = bits_until_update = 4;
    }

    void update() {
        if ((bit_count += update_cycle) > BM_MaxCount) {
            bit_count = (bit_count + 1) >> 1;
            bit_0_count = (bit_0_count + 1) >> 1;
            if (bit_0_count == bit_count) ++bit_count;
        }
        U32 scale = 0x80000000u / bit_count;
        bit_0_prob = (bit_0_count * scale) >> (31 - BM_LengthShift);
        update_cycle = (5 * update_cycle) >> 2;
        if (update_cycle > 64) update_cycle = 64;
        bits_until_update = update_cycle;
    }
};

struct Decoder {
    const U8* in;
    const U8* in_end;
    U32 value = 0, length = 0;

    U8 getByte() { return (in < in_end) ? *in++ : 0; }

    void init() {
        length = AC_MaxLength;
        value = ((U32)getByte() << 24) | ((U32)getByte() << 16)
              | ((U32)getByte() << 8) | (U32)getByte();
    }

    void renorm() {
        do { value = (value << 8) | getByte(); }
        while ((length <<= 8) < AC_MinLength);
    }

    U32 decodeBit(ArithmeticBitModel& m) {
        U32 x = m.bit_0_prob * (length >> BM_LengthShift);
        U32 sym = (value >= x);
        if (sym == 0) {
            length = x;
            ++m.bit_0_count;
        } else {
            value -= x;
            length -= x;
        }
        if (length < AC_MinLength) renorm();
        if (--m.bits_until_update == 0) m.update();
        return sym;
    }

    U32 decodeSymbol(ArithmeticModel& m) {
        U32 n, sym, x, y = length;
        if (!m.decoder_table.empty()) {
            length >>= DM_LengthShift;
            U32 dv = value / length;
            U32 t = dv >> m.table_shift;
            sym = m.decoder_table[t];
            n = m.decoder_table[t + 1] + 1;
            while (n > sym + 1) {
                U32 k = (sym + n) >> 1;
                if (m.distribution[k] > dv) n = k; else sym = k;
            }
            x = m.distribution[sym] * length;
            if (sym != m.last_symbol) y = m.distribution[sym + 1] * length;
        } else {
            x = sym = 0;
            length >>= DM_LengthShift;
            U32 k = (n = m.symbols) >> 1;
            do {
                U32 z = length * m.distribution[k];
                if (z > value) { n = k; y = z; }
                else { sym = k; x = z; }
            } while ((k = (sym + n) >> 1) != sym);
        }
        value -= x;
        length = y - x;
        if (length < AC_MinLength) renorm();
        ++m.symbol_count[sym];
        if (--m.symbols_until_update == 0) m.update();
        return sym;
    }

    U32 readBits(U32 bits) {
        if (bits > 19) {
            U32 lo = readShort();
            U32 hi = readBits(bits - 16);
            return (hi << 16) | lo;
        }
        U32 sym = value / (length >>= bits);
        value -= length * sym;
        if (length < AC_MinLength) renorm();
        return sym;
    }

    U8 readByte() {
        U32 sym = value / (length >>= 8);
        value -= length * sym;
        if (length < AC_MinLength) renorm();
        return (U8)sym;
    }

    U16 readShort() {
        U32 sym = value / (length >>= 16);
        value -= length * sym;
        if (length < AC_MinLength) renorm();
        return (U16)sym;
    }

    U32 readInt() {
        U32 lo = readShort();
        U32 hi = readShort();
        return ((U32)hi << 16) | lo;
    }
};

struct Encoder {
    std::vector<U8> out;
    U32 base = 0, length = AC_MaxLength;

    void init() {
        out.clear();
        base = 0;
        length = AC_MaxLength;
    }

    void propagate_carry() {
        // increment backwards over 0xFF bytes
        for (size_t i = out.size(); i-- > 0;) {
            if (out[i] == 0xFFu) out[i] = 0;
            else { ++out[i]; break; }
        }
    }

    void renorm() {
        do {
            out.push_back((U8)(base >> 24));
            base <<= 8;
        } while ((length <<= 8) < AC_MinLength);
    }

    void encodeBit(ArithmeticBitModel& m, U32 bit) {
        U32 x = m.bit_0_prob * (length >> BM_LengthShift);
        if (bit == 0) {
            length = x;
            ++m.bit_0_count;
        } else {
            U32 init_base = base;
            base += x;
            length -= x;
            if (init_base > base) propagate_carry();
        }
        if (length < AC_MinLength) renorm();
        if (--m.bits_until_update == 0) m.update();
    }

    void encodeSymbol(ArithmeticModel& m, U32 sym) {
        U32 x, init_base = base;
        if (sym == m.last_symbol) {
            x = m.distribution[sym] * (length >> DM_LengthShift);
            base += x;
            length -= x;
        } else {
            x = m.distribution[sym] * (length >>= DM_LengthShift);
            base += x;
            length = m.distribution[sym + 1] * length - x;
        }
        if (init_base > base) propagate_carry();
        if (length < AC_MinLength) renorm();
        ++m.symbol_count[sym];
        if (--m.symbols_until_update == 0) m.update();
    }

    void writeBits(U32 bits, U32 sym) {
        if (bits > 19) {
            writeShort((U16)(sym & 0xFFFFu));
            writeBits(bits - 16, sym >> 16);
            return;
        }
        U32 init_base = base;
        base += sym * (length >>= bits);
        if (init_base > base) propagate_carry();
        if (length < AC_MinLength) renorm();
    }

    void writeByte(U8 sym) {
        U32 init_base = base;
        base += (U32)sym * (length >>= 8);
        if (init_base > base) propagate_carry();
        if (length < AC_MinLength) renorm();
    }

    void writeShort(U16 sym) {
        U32 init_base = base;
        base += (U32)sym * (length >>= 16);
        if (init_base > base) propagate_carry();
        if (length < AC_MinLength) renorm();
    }

    void writeInt(U32 sym) {
        writeShort((U16)(sym & 0xFFFFu));
        writeShort((U16)(sym >> 16));
    }

    void done() {
        // LASzip ArithmeticEncoder::done(): the decoder may read a few
        // bytes past this chunk's output — chunk boundaries are recovered
        // from the chunk table, not from the decoder's consumed position
        U32 init_base = base;
        if (length > 2 * AC_MinLength) {
            base += AC_MinLength;
            length = AC_MinLength >> 1;
        } else {
            base += AC_MinLength >> 1;
            length = AC_MinLength >> 9;
        }
        if (init_base > base) propagate_carry();
        renorm();
    }
};

// ---------------------------------------------------------------------------
// IntegerCompressor (LASzip integercompressor.cpp) for bits=32
// ---------------------------------------------------------------------------

struct IntegerDecompressor {
    Decoder* dec = nullptr;
    U32 contexts = 0, bits_high = 8;
    U32 k = 0;
    std::vector<ArithmeticModel> mBits;      // [contexts], 33 symbols
    ArithmeticBitModel mCorrector0;
    std::vector<ArithmeticModel> mCorrector; // [32], 1<<min(k,8) symbols

    void init(Decoder* d, U32 n_contexts) {
        dec = d;
        contexts = n_contexts;
        mBits.resize(contexts);
        for (U32 c = 0; c < contexts; c++) mBits[c].init(33, false);
        mCorrector0.init();
        mCorrector.resize(33);
        for (U32 kk = 1; kk <= 32; kk++)
            mCorrector[kk].init(kk <= bits_high ? (1u << kk)
                                                : (1u << bits_high), false);
    }

    I32 readCorrector(ArithmeticModel& bits_model) {
        I32 c;
        k = dec->decodeSymbol(bits_model);
        if (k) {
            if (k < 32) {
                if (k <= bits_high) {
                    c = (I32)dec->decodeSymbol(mCorrector[k]);
                } else {
                    U32 k1 = k - bits_high;
                    c = (I32)dec->decodeSymbol(mCorrector[k]);
                    U32 c1 = dec->readBits(k1);
                    c = (I32)(((U32)c << k1) | c1);
                }
                if (c >= (1 << (k - 1))) c += 1;
                else c -= ((1 << k) - 1);
            } else {
                c = INT32_MIN;  // corr_min for full 32-bit range
            }
        } else {
            c = (I32)dec->decodeBit(mCorrector0);
        }
        return c;
    }

    I32 decompress(I32 pred, U32 context) {
        // bits=32: corr_range wraps mod 2^32 naturally
        return (I32)((U32)pred + (U32)readCorrector(mBits[context]));
    }
};

struct IntegerCompressor {
    Encoder* enc = nullptr;
    U32 contexts = 0, bits_high = 8;
    U32 k = 0;
    std::vector<ArithmeticModel> mBits;
    ArithmeticBitModel mCorrector0;
    std::vector<ArithmeticModel> mCorrector;

    void init(Encoder* e, U32 n_contexts) {
        enc = e;
        contexts = n_contexts;
        mBits.resize(contexts);
        for (U32 c = 0; c < contexts; c++) mBits[c].init(33, true);
        mCorrector0.init();
        mCorrector.resize(33);
        for (U32 kk = 1; kk <= 32; kk++)
            mCorrector[kk].init(kk <= bits_high ? (1u << kk)
                                                : (1u << bits_high), true);
    }

    void writeCorrector(I32 c, ArithmeticModel& bits_model) {
        // tightest interval [-(2^k - 1), 2^k] containing c
        k = 0;
        U32 c1 = (U32)(c <= 0 ? -(I64)c : (I64)c - 1);
        while (c1) { c1 >>= 1; ++k; }
        enc->encodeSymbol(bits_model, k);
        if (k) {
            if (k < 32) {
                if (c >= 0) c -= 1;                  // [2^(k-1), 2^k - 1]
                else c += ((1 << k) - 1);            // [0, 2^(k-1) - 1]
                if (k <= bits_high) {
                    enc->encodeSymbol(mCorrector[k], (U32)c);
                } else {
                    U32 k1 = k - bits_high;
                    U32 clow = (U32)c & ((1u << k1) - 1);
                    enc->encodeSymbol(mCorrector[k], ((U32)c) >> k1);
                    enc->writeBits(k1, clow);
                }
            }
        } else {
            enc->encodeBit(mCorrector0, (U32)c);
        }
    }

    void compress(I32 pred, I32 real, U32 context) {
        I32 corr = (I32)((U32)real - (U32)pred);  // wrap mod 2^32
        writeCorrector(corr, mBits[context]);
    }
};

// ---------------------------------------------------------------------------
// StreamingMedian5 (laszip common_v2.hpp)
// ---------------------------------------------------------------------------

struct StreamingMedian5 {
    I32 values[5];
    bool high;

    void init() {
        values[0] = values[1] = values[2] = values[3] = values[4] = 0;
        high = true;
    }

    void add(I32 v) {
        if (high) {
            if (v < values[2]) {
                values[4] = values[3];
                values[3] = values[2];
                if (v < values[0]) {
                    values[2] = values[1]; values[1] = values[0]; values[0] = v;
                } else if (v < values[1]) {
                    values[2] = values[1]; values[1] = v;
                } else {
                    values[2] = v;
                }
            } else {
                if (v < values[3]) { values[4] = values[3]; values[3] = v; }
                else values[4] = v;
                high = false;
            }
        } else {
            if (values[2] < v) {
                values[0] = values[1];
                values[1] = values[2];
                if (values[4] < v) {
                    values[2] = values[3]; values[3] = values[4]; values[4] = v;
                } else if (values[3] < v) {
                    values[2] = values[3]; values[3] = v;
                } else {
                    values[2] = v;
                }
            } else {
                if (values[1] < v) { values[0] = values[1]; values[1] = v; }
                else values[0] = v;
                high = true;
            }
        }
    }

    I32 get() const { return values[2]; }
};

// number_return_map / number_return_level (laszip common_v2.hpp)
static const U8 number_return_map[8][8] = {
    {15, 14, 13, 12, 11, 10, 9, 8},
    {14, 0, 1, 3, 6, 10, 10, 9},
    {13, 1, 2, 4, 7, 11, 11, 10},
    {12, 3, 4, 5, 8, 12, 12, 11},
    {11, 6, 7, 8, 9, 13, 13, 12},
    {10, 10, 11, 12, 13, 14, 14, 13},
    {9, 10, 11, 12, 13, 14, 15, 14},
    {8, 9, 10, 11, 12, 13, 14, 15}};
static const U8 number_return_level[8][8] = {
    {0, 1, 2, 3, 4, 5, 6, 7},
    {1, 0, 1, 2, 3, 4, 5, 6},
    {2, 1, 0, 1, 2, 3, 4, 5},
    {3, 2, 1, 0, 1, 2, 3, 4},
    {4, 3, 2, 1, 0, 1, 2, 3},
    {5, 4, 3, 2, 1, 0, 1, 2},
    {6, 5, 4, 3, 2, 1, 0, 1},
    {7, 6, 5, 4, 3, 2, 1, 0}};

static inline U8 u8_fold(I32 n) { return (U8)(n & 0xFF); }

// raw POINT10 record layout (20 bytes, little-endian)
#pragma pack(push, 1)
struct Point10 {
    I32 x, y, z;
    U16 intensity;
    U8 flags;           // return_num:3 | num_returns:3 | scan_dir:1 | edge:1
    U8 classification;
    I8 scan_angle_rank;
    U8 user_data;
    U16 point_source_ID;
};
#pragma pack(pop)

// ---------------------------------------------------------------------------
// POINT10 v2 item codec (lasreaditemcompressed_v2.cpp POINT10)
// ---------------------------------------------------------------------------

struct Point10v2Decompressor {
    Decoder* dec;
    Point10 last;
    U16 last_intensity[16];
    StreamingMedian5 last_x_diff_median5[16], last_y_diff_median5[16];
    I32 last_height[8];
    ArithmeticModel m_changed_values;
    IntegerDecompressor ic_intensity;
    ArithmeticModel m_scan_angle_rank[2];
    IntegerDecompressor ic_point_source_ID;
    ArithmeticModel* m_bit_byte[256];
    ArithmeticModel* m_classification[256];
    ArithmeticModel* m_user_data[256];
    IntegerDecompressor ic_dx, ic_dy, ic_z;

    void init(Decoder* d, const U8* first_item) {
        dec = d;
        std::memcpy(&last, first_item, 20);
        for (int i = 0; i < 16; i++) {
            last_x_diff_median5[i].init();
            last_y_diff_median5[i].init();
            last_intensity[i] = 0;
        }
        for (int i = 0; i < 8; i++) last_height[i] = 0;
        m_changed_values.init(64, false);
        ic_intensity.init(dec, 4);
        m_scan_angle_rank[0].init(256, false);
        m_scan_angle_rank[1].init(256, false);
        ic_point_source_ID.init(dec, 1);
        for (int i = 0; i < 256; i++) {
            m_bit_byte[i] = m_classification[i] = m_user_data[i] = nullptr;
        }
        ic_dx.init(dec, 2);
        ic_dy.init(dec, 22);
        ic_z.init(dec, 20);
        // the raw first point seeds the intensity context 0 like laszip
        last_intensity[0] = last.intensity;
        last.intensity = last.intensity;  // keep raw
    }

    ~Point10v2Decompressor() {
        for (int i = 0; i < 256; i++) {
            delete m_bit_byte[i];
            delete m_classification[i];
            delete m_user_data[i];
        }
    }

    void read(U8* item) {
        U32 r, n, m, l, k_bits;
        I32 median, diff;

        U32 changed_values = dec->decodeSymbol(m_changed_values);
        if (changed_values) {
            if (changed_values & 32) {
                U8 b = last.flags;
                if (!m_bit_byte[b]) {
                    m_bit_byte[b] = new ArithmeticModel();
                    m_bit_byte[b]->init(256, false);
                }
                last.flags = (U8)dec->decodeSymbol(*m_bit_byte[b]);
            }
        }
        r = last.flags & 7u;
        n = (last.flags >> 3) & 7u;
        m = number_return_map[n][r];
        l = number_return_level[n][r];
        if (changed_values) {
            if (changed_values & 16) {
                U32 ctx = (m < 3 ? m : 3u);
                last.intensity = (U16)ic_intensity.decompress(
                    last_intensity[m], ctx);
                last_intensity[m] = last.intensity;
            } else {
                last.intensity = last_intensity[m];
            }
            if (changed_values & 8) {
                U8 c = last.classification;
                if (!m_classification[c]) {
                    m_classification[c] = new ArithmeticModel();
                    m_classification[c]->init(256, false);
                }
                last.classification =
                    (U8)dec->decodeSymbol(*m_classification[c]);
            }
            if (changed_values & 4) {
                U32 f = (last.flags >> 6) & 1u;  // scan_direction_flag
                I32 val = (I32)dec->decodeSymbol(m_scan_angle_rank[f]);
                last.scan_angle_rank =
                    (I8)u8_fold(val + (U8)last.scan_angle_rank);
            }
            if (changed_values & 2) {
                U8 u = last.user_data;
                if (!m_user_data[u]) {
                    m_user_data[u] = new ArithmeticModel();
                    m_user_data[u]->init(256, false);
                }
                last.user_data = (U8)dec->decodeSymbol(*m_user_data[u]);
            }
            if (changed_values & 1) {
                last.point_source_ID = (U16)ic_point_source_ID.decompress(
                    last.point_source_ID, 0);
            }
        } else {
            last.intensity = last_intensity[m];
        }

        // x
        median = last_x_diff_median5[m].get();
        diff = ic_dx.decompress(median, n == 1);
        last.x += diff;
        last_x_diff_median5[m].add(diff);

        // y
        median = last_y_diff_median5[m].get();
        k_bits = ic_dx.k;
        diff = ic_dy.decompress(
            median, (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20u));
        last.y += diff;
        last_y_diff_median5[m].add(diff);

        // z
        k_bits = (ic_dx.k + ic_dy.k) / 2;
        last.z = ic_z.decompress(
            last_height[l], (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18u));
        last_height[l] = last.z;

        std::memcpy(item, &last, 20);
    }
};

struct Point10v2Compressor {
    Encoder* enc;
    Point10 last;
    U16 last_intensity[16];
    StreamingMedian5 last_x_diff_median5[16], last_y_diff_median5[16];
    I32 last_height[8];
    ArithmeticModel m_changed_values;
    IntegerCompressor ic_intensity;
    ArithmeticModel m_scan_angle_rank[2];
    IntegerCompressor ic_point_source_ID;
    ArithmeticModel* m_bit_byte[256];
    ArithmeticModel* m_classification[256];
    ArithmeticModel* m_user_data[256];
    IntegerCompressor ic_dx, ic_dy, ic_z;

    void init(Encoder* e, const U8* first_item) {
        enc = e;
        std::memcpy(&last, first_item, 20);
        for (int i = 0; i < 16; i++) {
            last_x_diff_median5[i].init();
            last_y_diff_median5[i].init();
            last_intensity[i] = 0;
        }
        for (int i = 0; i < 8; i++) last_height[i] = 0;
        m_changed_values.init(64, true);
        ic_intensity.init(enc, 4);
        m_scan_angle_rank[0].init(256, true);
        m_scan_angle_rank[1].init(256, true);
        ic_point_source_ID.init(enc, 1);
        for (int i = 0; i < 256; i++) {
            m_bit_byte[i] = m_classification[i] = m_user_data[i] = nullptr;
        }
        ic_dx.init(enc, 2);
        ic_dy.init(enc, 22);
        ic_z.init(enc, 20);
        last_intensity[0] = last.intensity;
    }

    ~Point10v2Compressor() {
        for (int i = 0; i < 256; i++) {
            delete m_bit_byte[i];
            delete m_classification[i];
            delete m_user_data[i];
        }
    }

    void write(const U8* item) {
        Point10 cur;
        std::memcpy(&cur, item, 20);
        U32 r = cur.flags & 7u;
        U32 n = (cur.flags >> 3) & 7u;
        U32 m = number_return_map[n][r];
        U32 l = number_return_level[n][r];

        U32 changed_values =
            (((U32)(last.flags != cur.flags)) << 5) |
            (((U32)(last_intensity[m] != cur.intensity)) << 4) |
            (((U32)(last.classification != cur.classification)) << 3) |
            (((U32)(last.scan_angle_rank != cur.scan_angle_rank)) << 2) |
            (((U32)(last.user_data != cur.user_data)) << 1) |
            ((U32)(last.point_source_ID != cur.point_source_ID));
        // NOTE: the flags/returns must be updated BEFORE m is used for the
        // intensity context on the decode side — mirror that order here by
        // computing m from cur (the decoder recomputes r/n/m/l after
        // decoding the new flags byte).
        enc->encodeSymbol(m_changed_values, changed_values);
        if (changed_values) {
            if (changed_values & 32) {
                U8 b = last.flags;
                if (!m_bit_byte[b]) {
                    m_bit_byte[b] = new ArithmeticModel();
                    m_bit_byte[b]->init(256, true);
                }
                enc->encodeSymbol(*m_bit_byte[b], cur.flags);
            }
            if (changed_values & 16) {
                U32 ctx = (m < 3 ? m : 3u);
                ic_intensity.compress(last_intensity[m], cur.intensity, ctx);
                last_intensity[m] = cur.intensity;
            }
            if (changed_values & 8) {
                U8 c = last.classification;
                if (!m_classification[c]) {
                    m_classification[c] = new ArithmeticModel();
                    m_classification[c]->init(256, true);
                }
                enc->encodeSymbol(*m_classification[c], cur.classification);
            }
            if (changed_values & 4) {
                U32 f = (cur.flags >> 6) & 1u;
                // encode the difference modulo 256 (decoder folds back)
                U32 val = (U8)(cur.scan_angle_rank - last.scan_angle_rank);
                enc->encodeSymbol(m_scan_angle_rank[f], val);
            }
            if (changed_values & 2) {
                U8 u = last.user_data;
                if (!m_user_data[u]) {
                    m_user_data[u] = new ArithmeticModel();
                    m_user_data[u]->init(256, true);
                }
                enc->encodeSymbol(*m_user_data[u], cur.user_data);
            }
            if (changed_values & 1) {
                ic_point_source_ID.compress(last.point_source_ID,
                                            cur.point_source_ID, 0);
            }
        }

        I32 median, diff;
        // x — laszip passes (pred=median, real=diff): the corrector is
        // diff - median
        median = last_x_diff_median5[m].get();
        diff = (I32)((U32)cur.x - (U32)last.x);
        ic_dx.compress(median, diff, n == 1);
        last_x_diff_median5[m].add(diff);
        last.x = cur.x;

        // y
        median = last_y_diff_median5[m].get();
        diff = (I32)((U32)cur.y - (U32)last.y);
        U32 k_bits = ic_dx.k;
        ic_dy.compress(median, diff,
                       (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20u));
        last_y_diff_median5[m].add(diff);
        last.y = cur.y;

        // z
        k_bits = (ic_dx.k + ic_dy.k) / 2;
        ic_z.compress(last_height[l], cur.z,
                      (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18u));
        last_height[l] = cur.z;
        last.z = cur.z;

        last.flags = cur.flags;
        last.intensity = cur.intensity;
        last.classification = cur.classification;
        last.scan_angle_rank = cur.scan_angle_rank;
        last.user_data = cur.user_data;
        last.point_source_ID = cur.point_source_ID;
    }
};

// ---------------------------------------------------------------------------
// GPSTIME11 v2 item codec
// ---------------------------------------------------------------------------

static const I32 GPSTIME_MULTI = 500;
static const I32 GPSTIME_MULTI_MINUS = -10;
static const I32 GPSTIME_MULTI_UNCHANGED =
    (GPSTIME_MULTI - GPSTIME_MULTI_MINUS + 1);
static const I32 GPSTIME_MULTI_CODE_FULL =
    (GPSTIME_MULTI - GPSTIME_MULTI_MINUS + 2);
static const I32 GPSTIME_MULTI_TOTAL =
    (GPSTIME_MULTI - GPSTIME_MULTI_MINUS + 6);

union U64I64F64 {
    U64 u64;
    I64 i64;
    double f64;
};

struct GpsTime11v2Decompressor {
    Decoder* dec;
    U32 last = 0, next = 0;
    U64I64F64 last_gpstime[4];
    I32 last_gpstime_diff[4];
    I32 multi_extreme_counter[4];
    ArithmeticModel m_gpstime_multi, m_gpstime_0diff;
    IntegerDecompressor ic_gpstime;

    void init(Decoder* d, const U8* first_item) {
        dec = d;
        last = next = 0;
        for (int i = 0; i < 4; i++) {
            last_gpstime[i].u64 = 0;
            last_gpstime_diff[i] = 0;
            multi_extreme_counter[i] = 0;
        }
        std::memcpy(&last_gpstime[0].u64, first_item, 8);
        m_gpstime_multi.init(GPSTIME_MULTI_TOTAL, false);
        m_gpstime_0diff.init(6, false);
        ic_gpstime.init(dec, 9);
    }

    void read(U8* item) {
        I32 multi;
        if (last_gpstime_diff[last] == 0) {
            multi = (I32)dec->decodeSymbol(m_gpstime_0diff);
            if (multi == 1) {  // the difference fits in 32 bits
                last_gpstime_diff[last] = ic_gpstime.decompress(0, 0);
                last_gpstime[last].i64 += last_gpstime_diff[last];
                multi_extreme_counter[last] = 0;
            } else if (multi == 2) {  // the difference is huge
                next = (next + 1) & 3;
                last_gpstime[next].u64 = (U64)(I64)ic_gpstime.decompress(
                    (I32)(last_gpstime[last].u64 >> 32), 8);
                last_gpstime[next].u64 <<= 32;
                last_gpstime[next].u64 |= dec->readInt();
                last = next;
                last_gpstime_diff[last] = 0;
                multi_extreme_counter[last] = 0;
            } else if (multi > 2) {  // switch to another sequence
                last = (last + multi - 2) & 3;
                read(item);
                return;
            }
        } else {
            multi = (I32)dec->decodeSymbol(m_gpstime_multi);
            if (multi == 1) {
                last_gpstime[last].i64 += ic_gpstime.decompress(
                    last_gpstime_diff[last], 1);
                multi_extreme_counter[last] = 0;
            } else if (multi < GPSTIME_MULTI_UNCHANGED) {
                I32 gpstime_diff;
                if (multi == 0) {
                    gpstime_diff = ic_gpstime.decompress(0, 7);
                    multi_extreme_counter[last]++;
                    if (multi_extreme_counter[last] > 3) {
                        last_gpstime_diff[last] = gpstime_diff;
                        multi_extreme_counter[last] = 0;
                    }
                } else if (multi < GPSTIME_MULTI) {
                    if (multi < 10)
                        gpstime_diff = ic_gpstime.decompress(
                            multi * last_gpstime_diff[last], 2);
                    else
                        gpstime_diff = ic_gpstime.decompress(
                            multi * last_gpstime_diff[last], 3);
                } else if (multi == GPSTIME_MULTI) {
                    gpstime_diff = ic_gpstime.decompress(
                        GPSTIME_MULTI * last_gpstime_diff[last], 4);
                    multi_extreme_counter[last]++;
                    if (multi_extreme_counter[last] > 3) {
                        last_gpstime_diff[last] = gpstime_diff;
                        multi_extreme_counter[last] = 0;
                    }
                } else {
                    multi = GPSTIME_MULTI - multi;  // negative multiplier
                    if (multi > GPSTIME_MULTI_MINUS) {
                        gpstime_diff = ic_gpstime.decompress(
                            multi * last_gpstime_diff[last], 5);
                    } else {
                        gpstime_diff = ic_gpstime.decompress(
                            GPSTIME_MULTI_MINUS * last_gpstime_diff[last], 6);
                        multi_extreme_counter[last]++;
                        if (multi_extreme_counter[last] > 3) {
                            last_gpstime_diff[last] = gpstime_diff;
                            multi_extreme_counter[last] = 0;
                        }
                    }
                }
                last_gpstime[last].i64 += gpstime_diff;
            } else if (multi == GPSTIME_MULTI_CODE_FULL) {
                next = (next + 1) & 3;
                last_gpstime[next].u64 = (U64)(I64)ic_gpstime.decompress(
                    (I32)(last_gpstime[last].u64 >> 32), 8);
                last_gpstime[next].u64 <<= 32;
                last_gpstime[next].u64 |= dec->readInt();
                last = next;
                last_gpstime_diff[last] = 0;
                multi_extreme_counter[last] = 0;
            } else if (multi >= GPSTIME_MULTI_CODE_FULL) {
                last = (last + multi - GPSTIME_MULTI_CODE_FULL) & 3;
                read(item);
                return;
            }
        }
        std::memcpy(item, &last_gpstime[last].u64, 8);
    }
};

struct GpsTime11v2Compressor {
    Encoder* enc;
    U32 last = 0, next = 0;
    U64I64F64 last_gpstime[4];
    I32 last_gpstime_diff[4];
    I32 multi_extreme_counter[4];
    ArithmeticModel m_gpstime_multi, m_gpstime_0diff;
    IntegerCompressor ic_gpstime;

    void init(Encoder* e, const U8* first_item) {
        enc = e;
        last = next = 0;
        for (int i = 0; i < 4; i++) {
            last_gpstime[i].u64 = 0;
            last_gpstime_diff[i] = 0;
            multi_extreme_counter[i] = 0;
        }
        std::memcpy(&last_gpstime[0].u64, first_item, 8);
        m_gpstime_multi.init(GPSTIME_MULTI_TOTAL, true);
        m_gpstime_0diff.init(6, true);
        ic_gpstime.init(enc, 9);
    }

    void write(const U8* item) {
        U64I64F64 cur;
        std::memcpy(&cur.u64, item, 8);

        if (last_gpstime_diff[last] == 0) {
            if (cur.i64 == last_gpstime[last].i64) {
                enc->encodeSymbol(m_gpstime_0diff, 0);  // unchanged
                return;
            }
            // calculate the difference between the two doubles as an integer
            I64 curr_gpstime_diff_64 = cur.i64 - last_gpstime[last].i64;
            I32 curr_gpstime_diff = (I32)curr_gpstime_diff_64;
            if (curr_gpstime_diff_64 == (I64)curr_gpstime_diff) {
                enc->encodeSymbol(m_gpstime_0diff, 1);  // fits in 32 bits
                ic_gpstime.compress(0, curr_gpstime_diff, 0);
                last_gpstime_diff[last] = curr_gpstime_diff;
                multi_extreme_counter[last] = 0;
                last_gpstime[last].i64 = cur.i64;
            } else {
                // look for a previous sequence that matches
                for (U32 i = 1; i < 4; i++) {
                    I64 other_diff = cur.i64 - last_gpstime[(last + i) & 3].i64;
                    if (other_diff == (I64)(I32)other_diff) {
                        enc->encodeSymbol(m_gpstime_0diff, i + 2);
                        last = (last + i) & 3;
                        write(item);
                        return;
                    }
                }
                enc->encodeSymbol(m_gpstime_0diff, 2);  // full
                ic_gpstime.compress((I32)(last_gpstime[last].u64 >> 32),
                                    (I32)(cur.u64 >> 32), 8);
                enc->writeInt((U32)(cur.u64 & 0xFFFFFFFFu));
                next = (next + 1) & 3;
                last = next;
                last_gpstime_diff[last] = 0;
                multi_extreme_counter[last] = 0;
                last_gpstime[last].i64 = cur.i64;
            }
        } else {
            if (cur.i64 == last_gpstime[last].i64) {
                // unchanged: symbol meaning multiplier "unchanged"
                enc->encodeSymbol(m_gpstime_multi, GPSTIME_MULTI_UNCHANGED);
                return;
            }
            I64 curr_gpstime_diff_64 = cur.i64 - last_gpstime[last].i64;
            I32 curr_gpstime_diff = (I32)curr_gpstime_diff_64;
            if (curr_gpstime_diff_64 == (I64)curr_gpstime_diff) {
                // compute multiplier between current and last difference
                double multi_f = (double)curr_gpstime_diff /
                                 (double)last_gpstime_diff[last];
                I32 multi = (I32)(multi_f < 0 ? multi_f - 0.5 : multi_f + 0.5);
                if (multi == 1) {
                    enc->encodeSymbol(m_gpstime_multi, 1);
                    ic_gpstime.compress(last_gpstime_diff[last],
                                        curr_gpstime_diff, 1);
                    multi_extreme_counter[last] = 0;
                } else if (multi > 0) {
                    if (multi < GPSTIME_MULTI) {
                        enc->encodeSymbol(m_gpstime_multi, multi);
                        if (multi < 10)
                            ic_gpstime.compress(
                                multi * last_gpstime_diff[last],
                                curr_gpstime_diff, 2);
                        else
                            ic_gpstime.compress(
                                multi * last_gpstime_diff[last],
                                curr_gpstime_diff, 3);
                    } else {
                        enc->encodeSymbol(m_gpstime_multi, GPSTIME_MULTI);
                        ic_gpstime.compress(
                            GPSTIME_MULTI * last_gpstime_diff[last],
                            curr_gpstime_diff, 4);
                        multi_extreme_counter[last]++;
                        if (multi_extreme_counter[last] > 3) {
                            last_gpstime_diff[last] = curr_gpstime_diff;
                            multi_extreme_counter[last] = 0;
                        }
                    }
                } else if (multi < 0) {
                    if (multi > GPSTIME_MULTI_MINUS) {
                        enc->encodeSymbol(m_gpstime_multi,
                                          GPSTIME_MULTI - multi);
                        ic_gpstime.compress(
                            multi * last_gpstime_diff[last],
                            curr_gpstime_diff, 5);
                    } else {
                        enc->encodeSymbol(
                            m_gpstime_multi,
                            GPSTIME_MULTI - GPSTIME_MULTI_MINUS);
                        ic_gpstime.compress(
                            GPSTIME_MULTI_MINUS * last_gpstime_diff[last],
                            curr_gpstime_diff, 6);
                        multi_extreme_counter[last]++;
                        if (multi_extreme_counter[last] > 3) {
                            last_gpstime_diff[last] = curr_gpstime_diff;
                            multi_extreme_counter[last] = 0;
                        }
                    }
                } else {  // multi == 0
                    enc->encodeSymbol(m_gpstime_multi, 0);
                    ic_gpstime.compress(0, curr_gpstime_diff, 7);
                    multi_extreme_counter[last]++;
                    if (multi_extreme_counter[last] > 3) {
                        last_gpstime_diff[last] = curr_gpstime_diff;
                        multi_extreme_counter[last] = 0;
                    }
                }
                last_gpstime[last].i64 = cur.i64;
            } else {
                // the difference is huge: look for matching sequence first
                for (U32 i = 1; i < 4; i++) {
                    I64 other_diff = cur.i64 - last_gpstime[(last + i) & 3].i64;
                    if (other_diff == (I64)(I32)other_diff) {
                        enc->encodeSymbol(m_gpstime_multi,
                                          GPSTIME_MULTI_CODE_FULL + i);
                        last = (last + i) & 3;
                        write(item);
                        return;
                    }
                }
                enc->encodeSymbol(m_gpstime_multi, GPSTIME_MULTI_CODE_FULL);
                ic_gpstime.compress((I32)(last_gpstime[last].u64 >> 32),
                                    (I32)(cur.u64 >> 32), 8);
                enc->writeInt((U32)(cur.u64 & 0xFFFFFFFFu));
                next = (next + 1) & 3;
                last = next;
                last_gpstime_diff[last] = 0;
                multi_extreme_counter[last] = 0;
                last_gpstime[last].i64 = cur.i64;
            }
        }
    }
};

// ---------------------------------------------------------------------------
// RGB12 v2 item codec
// ---------------------------------------------------------------------------

struct Rgb12v2Decompressor {
    Decoder* dec;
    U16 last[3];
    ArithmeticModel m_byte_used, m_rgb_diff_0, m_rgb_diff_1, m_rgb_diff_2,
        m_rgb_diff_3, m_rgb_diff_4, m_rgb_diff_5;

    void init(Decoder* d, const U8* first_item) {
        dec = d;
        std::memcpy(last, first_item, 6);
        m_byte_used.init(128, false);
        m_rgb_diff_0.init(256, false);
        m_rgb_diff_1.init(256, false);
        m_rgb_diff_2.init(256, false);
        m_rgb_diff_3.init(256, false);
        m_rgb_diff_4.init(256, false);
        m_rgb_diff_5.init(256, false);
    }

    void read(U8* item) {
        U8 corr;
        I32 diff = 0;
        U32 sym = dec->decodeSymbol(m_byte_used);
        U16 rgb[3];
        if (sym & 1) {
            corr = (U8)dec->decodeSymbol(m_rgb_diff_0);
            rgb[0] = (U16)u8_fold(corr + (last[0] & 255));
        } else {
            rgb[0] = last[0] & 0xFF;
        }
        if (sym & 2) {
            corr = (U8)dec->decodeSymbol(m_rgb_diff_1);
            rgb[0] |= ((U16)u8_fold(corr + (last[0] >> 8))) << 8;
        } else {
            rgb[0] |= last[0] & 0xFF00;
        }
        if (sym & 64) {
            diff = (rgb[0] & 0x00FF) - (last[0] & 0x00FF);
            if (sym & 4) {
                corr = (U8)dec->decodeSymbol(m_rgb_diff_2);
                rgb[1] = (U16)u8_fold(
                    corr + clamp8(diff + (last[1] & 255)));
            } else {
                rgb[1] = last[1] & 0xFF;
            }
            if (sym & 16) {
                corr = (U8)dec->decodeSymbol(m_rgb_diff_4);
                diff = (diff + ((rgb[1] & 0x00FF) - (last[1] & 0x00FF))) / 2;
                rgb[2] = (U16)u8_fold(corr + clamp8(diff + (last[2] & 255)));
            } else {
                rgb[2] = last[2] & 0xFF;
            }
            diff = (rgb[0] >> 8) - (last[0] >> 8);
            if (sym & 8) {
                corr = (U8)dec->decodeSymbol(m_rgb_diff_3);
                rgb[1] |= ((U16)u8_fold(
                              corr + clamp8(diff + (last[1] >> 8)))) << 8;
            } else {
                rgb[1] |= last[1] & 0xFF00;
            }
            if (sym & 32) {
                corr = (U8)dec->decodeSymbol(m_rgb_diff_5);
                diff = (diff + ((rgb[1] >> 8) - (last[1] >> 8))) / 2;
                rgb[2] |= ((U16)u8_fold(
                              corr + clamp8(diff + (last[2] >> 8)))) << 8;
            } else {
                rgb[2] |= last[2] & 0xFF00;
            }
        } else {
            rgb[1] = rgb[0];
            rgb[2] = rgb[0];
        }
        std::memcpy(last, rgb, 6);
        std::memcpy(item, rgb, 6);
    }

    static I32 clamp8(I32 v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
};

struct Rgb12v2Compressor {
    Encoder* enc;
    U16 last[3];
    ArithmeticModel m_byte_used, m_rgb_diff_0, m_rgb_diff_1, m_rgb_diff_2,
        m_rgb_diff_3, m_rgb_diff_4, m_rgb_diff_5;

    void init(Encoder* e, const U8* first_item) {
        enc = e;
        std::memcpy(last, first_item, 6);
        m_byte_used.init(128, true);
        m_rgb_diff_0.init(256, true);
        m_rgb_diff_1.init(256, true);
        m_rgb_diff_2.init(256, true);
        m_rgb_diff_3.init(256, true);
        m_rgb_diff_4.init(256, true);
        m_rgb_diff_5.init(256, true);
    }

    void write(const U8* item) {
        U16 rgb[3];
        std::memcpy(rgb, item, 6);
        I32 diff_l = 0, diff_h = 0;
        U32 sym = (((last[0] & 0x00FF) != (rgb[0] & 0x00FF)) << 0) |
                  (((last[0] & 0xFF00) != (rgb[0] & 0xFF00)) << 1) |
                  (((last[1] & 0x00FF) != (rgb[1] & 0x00FF)) << 2) |
                  (((last[1] & 0xFF00) != (rgb[1] & 0xFF00)) << 3) |
                  (((last[2] & 0x00FF) != (rgb[2] & 0x00FF)) << 4) |
                  (((last[2] & 0xFF00) != (rgb[2] & 0xFF00)) << 5) |
                  ((((rgb[0] & 0x00FF) != (rgb[1] & 0x00FF)) ||
                    ((rgb[0] & 0x00FF) != (rgb[2] & 0x00FF)) ||
                    ((rgb[0] & 0xFF00) != (rgb[1] & 0xFF00)) ||
                    ((rgb[0] & 0xFF00) != (rgb[2] & 0xFF00))) << 6);
        enc->encodeSymbol(m_byte_used, sym);
        if (sym & 1) {
            diff_l = (rgb[0] & 255) - (last[0] & 255);
            enc->encodeSymbol(m_rgb_diff_0, (U8)diff_l);
        }
        if (sym & 2) {
            diff_h = (rgb[0] >> 8) - (last[0] >> 8);
            enc->encodeSymbol(m_rgb_diff_1, (U8)diff_h);
        }
        if (sym & 64) {
            if (sym & 4) {
                I32 corr = (rgb[1] & 255) -
                    Rgb12v2Decompressor::clamp8(diff_l + (last[1] & 255));
                enc->encodeSymbol(m_rgb_diff_2, (U8)corr);
            }
            if (sym & 16) {
                diff_l = (diff_l + (rgb[1] & 255) - (last[1] & 255)) / 2;
                I32 corr = (rgb[2] & 255) -
                    Rgb12v2Decompressor::clamp8(diff_l + (last[2] & 255));
                enc->encodeSymbol(m_rgb_diff_4, (U8)corr);
            }
            if (sym & 8) {
                I32 corr = (rgb[1] >> 8) -
                    Rgb12v2Decompressor::clamp8(diff_h + (last[1] >> 8));
                enc->encodeSymbol(m_rgb_diff_3, (U8)corr);
            }
            if (sym & 32) {
                diff_h = (diff_h + (rgb[1] >> 8) - (last[1] >> 8)) / 2;
                I32 corr = (rgb[2] >> 8) -
                    Rgb12v2Decompressor::clamp8(diff_h + (last[2] >> 8));
                enc->encodeSymbol(m_rgb_diff_5, (U8)corr);
            }
        }
        std::memcpy(last, rgb, 6);
    }
};

// ---------------------------------------------------------------------------
// BYTE v2 item codec (extra bytes; one 256-symbol model per byte)
// ---------------------------------------------------------------------------

struct Byte2Decompressor {
    Decoder* dec;
    U32 number = 0;
    std::vector<U8> last;
    std::vector<ArithmeticModel> m_byte;

    void init(Decoder* d, const U8* first_item, U32 n) {
        dec = d;
        number = n;
        last.assign(first_item, first_item + n);
        m_byte.resize(n);
        for (U32 i = 0; i < n; i++) m_byte[i].init(256, false);
    }

    void read(U8* item) {
        for (U32 i = 0; i < number; i++) {
            I32 val = (I32)dec->decodeSymbol(m_byte[i]);
            item[i] = u8_fold(val + last[i]);
        }
        std::memcpy(last.data(), item, number);
    }
};

struct Byte2Compressor {
    Encoder* enc;
    U32 number = 0;
    std::vector<U8> last;
    std::vector<ArithmeticModel> m_byte;

    void init(Encoder* e, const U8* first_item, U32 n) {
        enc = e;
        number = n;
        last.assign(first_item, first_item + n);
        m_byte.resize(n);
        for (U32 i = 0; i < n; i++) m_byte[i].init(256, true);
    }

    void write(const U8* item) {
        for (U32 i = 0; i < number; i++) {
            U32 diff = (U8)(item[i] - last[i]);
            enc->encodeSymbol(m_byte[i], diff);
        }
        std::memcpy(last.data(), item, number);
    }
};

// ===========================================================================
// LASzip v3 layered codecs (compressor 3, LAS 1.4 point formats 6-8):
// POINT14 / RGB14 / RGBNIR14 / BYTE14, both directions.
//
// Structure mirrors las{read,write}itemcompressed_v3: each item splits its
// fields into LAYERS, each layer carrying its own arithmetic-coded stream,
// and every codec keeps FOUR contexts selected by the scanner channel (the
// POINT14 codec decides the context; RGB/NIR/BYTE follow it). A context that
// has never been used is seeded from the previous context's last item.
//
// CONFORMANCE CAVEATS (same class as the v2 header note — no laspy/lazrs or
// third-party LAS 1.4 archive exists in this image to validate against):
//   * chunk framing: we write [U32 point-count][layer sizes, item-major]
//     [raw first records, item-major][layer payloads, item-major] per chunk;
//     real LASzip interleaves these around its outstream bookkeeping and the
//     exact order must be re-checked against a reference archive.
//   * the 16x16 context maps number_return_map_6ctx / number_return_level_8ctx
//     are RECONSTRUCTED from the published v2 8x8 maps (fold {6,7,8,9+} ->
//     {3,4,4,5}, saturate n,r>7; level = min(|n-r|,7)) — self-consistent
//     encode/decode and the Python oracle (tests/laz_oracle.py) use the same
//     derivation, so cross-validation covers coding slips but not table
//     transcription drift vs real LASzip.
//   * WAVEPACKET14 (formats 9/10) is not implemented; those items raise.
// ===========================================================================

typedef double F64;

#pragma pack(push, 1)
struct Point14 {
    I32 x, y, z;
    U16 intensity;
    U8 returns;     // return_number:4 | number_of_returns:4
    U8 flags;       // classification_flags:4 | scanner_channel:2 | scan_dir:1 | edge:1
    U8 classification;
    U8 user_data;
    I16 scan_angle;
    U16 point_source_ID;
    F64 gps_time;
};
#pragma pack(pop)
static_assert(sizeof(Point14) == 30, "Point14 layout");

// v3 context maps (see conformance caveat above)
struct V3Maps {
    U8 map6[16][16];
    U8 lvl8[16][16];
    V3Maps() {
        static const U8 fold[16] = {0, 1, 2, 3, 4, 5, 3, 4,
                                    4, 5, 5, 5, 5, 5, 5, 5};
        for (int n = 0; n < 16; n++)
            for (int r = 0; r < 16; r++) {
                int nn = n < 8 ? n : 7, rr = r < 8 ? r : 7;
                map6[n][r] = fold[number_return_map[nn][rr]];
                int d = n > r ? n - r : r - n;
                lvl8[n][r] = (U8)(d > 7 ? 7 : d);
            }
    }
};
static const V3Maps v3maps;

// per-scanner-channel POINT14 state (templated over coder direction so the
// encoder and decoder share one definition; IC = Integer(De)compressor,
// for_compress picks the model tables)
template <typename IC>
struct P14Ctx {
    bool unused = true;
    Point14 last;
    bool last_gps_change = false;
    U16 last_intensity[8];
    StreamingMedian5 last_x_diff_median5[12], last_y_diff_median5[12];
    I32 last_z[8];
    ArithmeticModel m_changed_values[8];       // 128 symbols, ctx = lpr
    ArithmeticModel m_scanner_channel;         // 3 symbols
    ArithmeticModel m_number_of_returns[16];   // 16 symbols, ctx = last n
    ArithmeticModel m_return_number[16];       // 16 symbols, ctx = last r
    ArithmeticModel m_return_number_gps_same;  // 13 symbols
    IC ic_dx, ic_dy, ic_z;
    ArithmeticModel m_classification[64];      // 256 symbols
    ArithmeticModel m_flags[64];               // 64 symbols
    ArithmeticModel m_user_data[64];           // 256 symbols
    IC ic_intensity, ic_scan_angle, ic_point_source;
    // gps time (the v2 sequence tracker, per context)
    U32 gps_last = 0, gps_next = 0;
    U64I64F64 last_gpstime[4];
    I32 last_gpstime_diff[4];
    I32 multi_extreme_counter[4];
    ArithmeticModel m_gpstime_multi, m_gpstime_0diff;
    IC ic_gpstime;

    template <typename CoderXY, typename CoderZ, typename CoderI,
              typename CoderSA, typename CoderPS, typename CoderG>
    void seed(const Point14& item, bool gps_change, bool for_compress,
              CoderXY* c_xy, CoderZ* c_z, CoderI* c_int, CoderSA* c_sa,
              CoderPS* c_ps, CoderG* c_gps) {
        unused = false;
        last = item;
        last_gps_change = gps_change;
        for (int i = 0; i < 8; i++) last_intensity[i] = item.intensity;
        for (int i = 0; i < 12; i++) {
            last_x_diff_median5[i].init();
            last_y_diff_median5[i].init();
        }
        for (int i = 0; i < 8; i++) last_z[i] = item.z;
        for (int i = 0; i < 8; i++)
            m_changed_values[i].init(128, for_compress);
        m_scanner_channel.init(3, for_compress);
        for (int i = 0; i < 16; i++) {
            m_number_of_returns[i].init(16, for_compress);
            m_return_number[i].init(16, for_compress);
        }
        m_return_number_gps_same.init(13, for_compress);
        ic_dx.init(c_xy, 2);
        ic_dy.init(c_xy, 22);
        ic_z.init(c_z, 20);
        for (int i = 0; i < 64; i++) {
            m_classification[i].init(256, for_compress);
            m_flags[i].init(64, for_compress);
            m_user_data[i].init(256, for_compress);
        }
        ic_intensity.init(c_int, 4);
        ic_scan_angle.init(c_sa, 2);
        ic_point_source.init(c_ps, 1);
        gps_last = gps_next = 0;
        for (int i = 0; i < 4; i++) {
            last_gpstime[i].u64 = 0;
            last_gpstime_diff[i] = 0;
            multi_extreme_counter[i] = 0;
        }
        last_gpstime[0].f64 = item.gps_time;
        m_gpstime_multi.init(GPSTIME_MULTI_TOTAL, for_compress);
        m_gpstime_0diff.init(6, for_compress);
        ic_gpstime.init(c_gps, 9);
    }
};

struct Point14v3Decompressor {
    // layer decoders, in stream order
    Decoder d_cxy, d_z, d_cls, d_flags, d_int, d_sa, d_ud, d_ps, d_gps;
    bool has_z = false, has_cls = false, has_flags = false, has_int = false,
         has_sa = false, has_ud = false, has_ps = false, has_gps = false;
    P14Ctx<IntegerDecompressor> ctx[4];
    U32 cc = 0;

    static const int N_LAYERS = 9;

    void seed_ctx(U32 c, const Point14& item, bool gps_change) {
        ctx[c].seed(item, gps_change, false, &d_cxy, &d_z, &d_int, &d_sa,
                    &d_ps, &d_gps);
    }

    void chunk_init(const U8* first_item) {
        Point14 p;
        std::memcpy(&p, first_item, 30);
        for (int i = 0; i < 4; i++) ctx[i].unused = true;
        cc = (p.flags >> 4) & 3;
        seed_ctx(cc, p, false);
    }

    void read_gps(P14Ctx<IntegerDecompressor>& c) {
        U32& last = c.gps_last;
        U32& next = c.gps_next;
        I32 multi;
        if (c.last_gpstime_diff[last] == 0) {
            multi = (I32)d_gps.decodeSymbol(c.m_gpstime_0diff);
            if (multi == 1) {
                c.last_gpstime_diff[last] = c.ic_gpstime.decompress(0, 0);
                c.last_gpstime[last].i64 += c.last_gpstime_diff[last];
                c.multi_extreme_counter[last] = 0;
            } else if (multi == 2) {
                next = (next + 1) & 3;
                c.last_gpstime[next].u64 = (U64)(I64)c.ic_gpstime.decompress(
                    (I32)(c.last_gpstime[last].u64 >> 32), 8);
                c.last_gpstime[next].u64 <<= 32;
                c.last_gpstime[next].u64 |= d_gps.readInt();
                last = next;
                c.last_gpstime_diff[last] = 0;
                c.multi_extreme_counter[last] = 0;
            } else if (multi > 2) {
                last = (last + multi - 2) & 3;
                read_gps(c);
                return;
            }
        } else {
            multi = (I32)d_gps.decodeSymbol(c.m_gpstime_multi);
            if (multi == 1) {
                c.last_gpstime[last].i64 += c.ic_gpstime.decompress(
                    c.last_gpstime_diff[last], 1);
                c.multi_extreme_counter[last] = 0;
            } else if (multi < GPSTIME_MULTI_UNCHANGED) {
                I32 gpstime_diff;
                if (multi == 0) {
                    gpstime_diff = c.ic_gpstime.decompress(0, 7);
                    c.multi_extreme_counter[last]++;
                    if (c.multi_extreme_counter[last] > 3) {
                        c.last_gpstime_diff[last] = gpstime_diff;
                        c.multi_extreme_counter[last] = 0;
                    }
                } else if (multi < GPSTIME_MULTI) {
                    gpstime_diff = c.ic_gpstime.decompress(
                        multi * c.last_gpstime_diff[last], multi < 10 ? 2 : 3);
                } else if (multi == GPSTIME_MULTI) {
                    gpstime_diff = c.ic_gpstime.decompress(
                        GPSTIME_MULTI * c.last_gpstime_diff[last], 4);
                    c.multi_extreme_counter[last]++;
                    if (c.multi_extreme_counter[last] > 3) {
                        c.last_gpstime_diff[last] = gpstime_diff;
                        c.multi_extreme_counter[last] = 0;
                    }
                } else {
                    multi = GPSTIME_MULTI - multi;
                    if (multi > GPSTIME_MULTI_MINUS) {
                        gpstime_diff = c.ic_gpstime.decompress(
                            multi * c.last_gpstime_diff[last], 5);
                    } else {
                        gpstime_diff = c.ic_gpstime.decompress(
                            GPSTIME_MULTI_MINUS * c.last_gpstime_diff[last],
                            6);
                        c.multi_extreme_counter[last]++;
                        if (c.multi_extreme_counter[last] > 3) {
                            c.last_gpstime_diff[last] = gpstime_diff;
                            c.multi_extreme_counter[last] = 0;
                        }
                    }
                }
                c.last_gpstime[last].i64 += gpstime_diff;
            } else if (multi == GPSTIME_MULTI_CODE_FULL) {
                next = (next + 1) & 3;
                c.last_gpstime[next].u64 = (U64)(I64)c.ic_gpstime.decompress(
                    (I32)(c.last_gpstime[last].u64 >> 32), 8);
                c.last_gpstime[next].u64 <<= 32;
                c.last_gpstime[next].u64 |= d_gps.readInt();
                last = next;
                c.last_gpstime_diff[last] = 0;
                c.multi_extreme_counter[last] = 0;
            } else if (multi >= GPSTIME_MULTI_CODE_FULL) {
                last = (last + multi - GPSTIME_MULTI_CODE_FULL) & 3;
                read_gps(c);
                return;
            }
        }
    }

    void read(U8* item, U32& context_out) {
        P14Ctx<IntegerDecompressor>* c = &ctx[cc];
        U32 lr = c->last.returns & 0xF, ln = c->last.returns >> 4;
        U32 lpr = (lr == 1 ? 1u : 0u) + (lr >= ln ? 2u : 0u)
                + (c->last_gps_change ? 4u : 0u);
        U32 changed = d_cxy.decodeSymbol(c->m_changed_values[lpr]);

        if (changed & (1u << 6)) {  // scanner channel changed
            U32 diff = d_cxy.decodeSymbol(c->m_scanner_channel);
            U32 sc = (cc + diff + 1) & 3;
            if (ctx[sc].unused)
                seed_ctx(sc, ctx[cc].last, ctx[cc].last_gps_change);
            cc = sc;
            c = &ctx[cc];
            c->last.flags = (U8)((c->last.flags & 0xCF) | (sc << 4));
            lr = c->last.returns & 0xF;
            ln = c->last.returns >> 4;
        }

        const bool ps_change = changed & (1u << 5);
        const bool gps_change = changed & (1u << 4);
        const bool sa_change = changed & (1u << 3);

        U32 n = (changed & (1u << 2))
                    ? d_cxy.decodeSymbol(c->m_number_of_returns[ln]) : ln;
        U32 r;
        switch (changed & 3u) {
        case 0: r = lr; break;
        case 1: r = (lr + 1) & 15; break;
        case 2: r = (lr + 15) & 15; break;
        default:
            if (gps_change) {
                r = d_cxy.decodeSymbol(c->m_return_number[lr]);
            } else {
                U32 sym = d_cxy.decodeSymbol(c->m_return_number_gps_same);
                r = (lr + sym + 2) & 15;
            }
            break;
        }
        c->last.returns = (U8)(r | (n << 4));

        const U32 m = v3maps.map6[n][r];
        const U32 l = v3maps.lvl8[n][r];
        const U32 cpr = (r == 1 ? 2u : 0u) + (r >= n ? 1u : 0u);
        const U32 gbit = gps_change ? 1u : 0u;

        I32 median = c->last_x_diff_median5[(m << 1) | gbit].get();
        I32 diff = c->ic_dx.decompress(median, n == 1);
        c->last.x += diff;
        c->last_x_diff_median5[(m << 1) | gbit].add(diff);

        median = c->last_y_diff_median5[(m << 1) | gbit].get();
        U32 kb = c->ic_dx.k;
        diff = c->ic_dy.decompress(
            median, (n == 1) + (kb < 20 ? (kb & ~1u) : 20u));
        c->last.y += diff;
        c->last_y_diff_median5[(m << 1) | gbit].add(diff);

        if (has_z) {
            kb = (c->ic_dx.k + c->ic_dy.k) / 2;
            c->last.z = c->ic_z.decompress(
                c->last_z[l], (n == 1) + (kb < 18 ? (kb & ~1u) : 18u));
            c->last_z[l] = c->last.z;
        }
        if (has_cls) {
            U32 ccc = ((c->last.classification & 0x1F) << 1)
                    | (cpr == 3 ? 1u : 0u);
            c->last.classification =
                (U8)d_cls.decodeSymbol(c->m_classification[ccc]);
        }
        if (has_flags) {
            U32 lf = (U32)(((c->last.flags >> 7) & 1) << 5)
                   | (U32)(((c->last.flags >> 6) & 1) << 4)
                   | (U32)(c->last.flags & 0xF);
            U32 f = d_flags.decodeSymbol(c->m_flags[lf]);
            c->last.flags = (U8)((((f >> 5) & 1) << 7) | (((f >> 4) & 1) << 6)
                                 | (cc << 4) | (f & 0xF));
        }
        if (has_int) {
            U16 inten = (U16)c->ic_intensity.decompress(
                c->last_intensity[(cpr << 1) | gbit], cpr);
            c->last_intensity[(cpr << 1) | gbit] = inten;
            c->last.intensity = inten;
        }
        if (has_sa && sa_change) {
            c->last.scan_angle = (I16)c->ic_scan_angle.decompress(
                c->last.scan_angle, gbit);
        }
        if (has_ud) {
            c->last.user_data = (U8)d_ud.decodeSymbol(
                c->m_user_data[c->last.user_data / 4]);
        }
        if (has_ps && ps_change) {
            c->last.point_source_ID = (U16)c->ic_point_source.decompress(
                c->last.point_source_ID, 0);
        }
        if (has_gps && gps_change) {
            read_gps(*c);
            c->last.gps_time = c->last_gpstime[c->gps_last].f64;
        }
        c->last_gps_change = gps_change;
        std::memcpy(item, &c->last, 30);
        context_out = cc;
    }
};

struct Point14v3Compressor {
    Encoder e_cxy, e_z, e_cls, e_flags, e_int, e_sa, e_ud, e_ps, e_gps;
    P14Ctx<IntegerCompressor> ctx[4];
    U32 cc = 0;

    void seed_ctx(U32 c, const Point14& item, bool gps_change) {
        ctx[c].seed(item, gps_change, true, &e_cxy, &e_z, &e_int, &e_sa,
                    &e_ps, &e_gps);
    }

    void chunk_init(const U8* first_item) {
        Point14 p;
        std::memcpy(&p, first_item, 30);
        for (int i = 0; i < 4; i++) ctx[i].unused = true;
        cc = (p.flags >> 4) & 3;
        seed_ctx(cc, p, false);
        for (Encoder* e : {&e_cxy, &e_z, &e_cls, &e_flags, &e_int, &e_sa,
                           &e_ud, &e_ps, &e_gps})
            e->init();
    }

    void write_gps(P14Ctx<IntegerCompressor>& c, F64 gps) {
        U32& last = c.gps_last;
        U32& next = c.gps_next;
        U64I64F64 cur;
        cur.f64 = gps;
        if (c.last_gpstime_diff[last] == 0) {
            if (cur.i64 == c.last_gpstime[last].i64) {
                e_gps.encodeSymbol(c.m_gpstime_0diff, 0);
                return;
            }
            I64 d64 = cur.i64 - c.last_gpstime[last].i64;
            I32 d32 = (I32)d64;
            if (d64 == (I64)d32) {
                e_gps.encodeSymbol(c.m_gpstime_0diff, 1);
                c.ic_gpstime.compress(0, d32, 0);
                c.last_gpstime_diff[last] = d32;
                c.multi_extreme_counter[last] = 0;
                c.last_gpstime[last].i64 = cur.i64;
            } else {
                for (U32 i = 1; i < 4; i++) {
                    I64 od = cur.i64 - c.last_gpstime[(last + i) & 3].i64;
                    if (od == (I64)(I32)od) {
                        e_gps.encodeSymbol(c.m_gpstime_0diff, i + 2);
                        last = (last + i) & 3;
                        write_gps(c, gps);
                        return;
                    }
                }
                e_gps.encodeSymbol(c.m_gpstime_0diff, 2);
                c.ic_gpstime.compress((I32)(c.last_gpstime[last].u64 >> 32),
                                      (I32)(cur.u64 >> 32), 8);
                e_gps.writeInt((U32)(cur.u64 & 0xFFFFFFFFu));
                next = (next + 1) & 3;
                last = next;
                c.last_gpstime_diff[last] = 0;
                c.multi_extreme_counter[last] = 0;
                c.last_gpstime[last].i64 = cur.i64;
            }
        } else {
            if (cur.i64 == c.last_gpstime[last].i64) {
                e_gps.encodeSymbol(c.m_gpstime_multi, GPSTIME_MULTI_UNCHANGED);
                return;
            }
            I64 d64 = cur.i64 - c.last_gpstime[last].i64;
            I32 d32 = (I32)d64;
            if (d64 == (I64)d32) {
                double mf = (double)d32 / (double)c.last_gpstime_diff[last];
                I32 multi = (I32)(mf < 0 ? mf - 0.5 : mf + 0.5);
                if (multi == 1) {
                    e_gps.encodeSymbol(c.m_gpstime_multi, 1);
                    c.ic_gpstime.compress(c.last_gpstime_diff[last], d32, 1);
                    c.multi_extreme_counter[last] = 0;
                } else if (multi > 0) {
                    if (multi < GPSTIME_MULTI) {
                        e_gps.encodeSymbol(c.m_gpstime_multi, multi);
                        c.ic_gpstime.compress(
                            multi * c.last_gpstime_diff[last], d32,
                            multi < 10 ? 2 : 3);
                    } else {
                        e_gps.encodeSymbol(c.m_gpstime_multi, GPSTIME_MULTI);
                        c.ic_gpstime.compress(
                            GPSTIME_MULTI * c.last_gpstime_diff[last], d32, 4);
                        c.multi_extreme_counter[last]++;
                        if (c.multi_extreme_counter[last] > 3) {
                            c.last_gpstime_diff[last] = d32;
                            c.multi_extreme_counter[last] = 0;
                        }
                    }
                } else if (multi < 0) {
                    if (multi > GPSTIME_MULTI_MINUS) {
                        e_gps.encodeSymbol(c.m_gpstime_multi,
                                           GPSTIME_MULTI - multi);
                        c.ic_gpstime.compress(
                            multi * c.last_gpstime_diff[last], d32, 5);
                    } else {
                        e_gps.encodeSymbol(
                            c.m_gpstime_multi,
                            GPSTIME_MULTI - GPSTIME_MULTI_MINUS);
                        c.ic_gpstime.compress(
                            GPSTIME_MULTI_MINUS * c.last_gpstime_diff[last],
                            d32, 6);
                        c.multi_extreme_counter[last]++;
                        if (c.multi_extreme_counter[last] > 3) {
                            c.last_gpstime_diff[last] = d32;
                            c.multi_extreme_counter[last] = 0;
                        }
                    }
                } else {
                    e_gps.encodeSymbol(c.m_gpstime_multi, 0);
                    c.ic_gpstime.compress(0, d32, 7);
                    c.multi_extreme_counter[last]++;
                    if (c.multi_extreme_counter[last] > 3) {
                        c.last_gpstime_diff[last] = d32;
                        c.multi_extreme_counter[last] = 0;
                    }
                }
                c.last_gpstime[last].i64 = cur.i64;
            } else {
                for (U32 i = 1; i < 4; i++) {
                    I64 od = cur.i64 - c.last_gpstime[(last + i) & 3].i64;
                    if (od == (I64)(I32)od) {
                        e_gps.encodeSymbol(c.m_gpstime_multi,
                                           GPSTIME_MULTI_CODE_FULL + i);
                        last = (last + i) & 3;
                        write_gps(c, gps);
                        return;
                    }
                }
                e_gps.encodeSymbol(c.m_gpstime_multi, GPSTIME_MULTI_CODE_FULL);
                c.ic_gpstime.compress((I32)(c.last_gpstime[last].u64 >> 32),
                                      (I32)(cur.u64 >> 32), 8);
                e_gps.writeInt((U32)(cur.u64 & 0xFFFFFFFFu));
                next = (next + 1) & 3;
                last = next;
                c.last_gpstime_diff[last] = 0;
                c.multi_extreme_counter[last] = 0;
                c.last_gpstime[last].i64 = cur.i64;
            }
        }
    }

    void write(const U8* item, U32& context_out) {
        Point14 cur;
        std::memcpy(&cur, item, 30);
        P14Ctx<IntegerCompressor>* c = &ctx[cc];
        U32 lr = c->last.returns & 0xF, ln = c->last.returns >> 4;
        const U32 lpr = (lr == 1 ? 1u : 0u) + (lr >= ln ? 2u : 0u)
                      + (c->last_gps_change ? 4u : 0u);

        const U32 sc = (cur.flags >> 4) & 3;
        // comparisons run against the last item of the TARGET context (the
        // seed if it has never been used) — mirrors the v3 reader exactly
        const Point14& ref = (sc != cc && !ctx[sc].unused)
                                 ? ctx[sc].last : c->last;
        U64I64F64 cur_g, ref_g;
        cur_g.f64 = cur.gps_time;
        ref_g.f64 = ref.gps_time;

        U32 changed = 0;
        if (sc != cc) changed |= 1u << 6;
        if (cur.point_source_ID != ref.point_source_ID) changed |= 1u << 5;
        if (cur_g.i64 != ref_g.i64) changed |= 1u << 4;
        if (cur.scan_angle != ref.scan_angle) changed |= 1u << 3;
        U32 rn = cur.returns & 0xF, nr = cur.returns >> 4;
        U32 rlr = ref.returns & 0xF, rln = ref.returns >> 4;
        if (nr != rln) changed |= 1u << 2;
        U32 rdiff;
        if (rn == rlr) rdiff = 0;
        else if (rn == ((rlr + 1) & 15)) rdiff = 1;
        else if (rn == ((rlr + 15) & 15)) rdiff = 2;
        else rdiff = 3;
        changed |= rdiff;

        e_cxy.encodeSymbol(c->m_changed_values[lpr], changed);

        if (sc != cc) {
            e_cxy.encodeSymbol(c->m_scanner_channel, (sc - cc - 1) & 3);
            if (ctx[sc].unused)
                seed_ctx(sc, ctx[cc].last, ctx[cc].last_gps_change);
            cc = sc;
            c = &ctx[cc];
            c->last.flags = (U8)((c->last.flags & 0xCF) | (sc << 4));
        }
        const bool gps_change = changed & (1u << 4);

        if (changed & (1u << 2))
            e_cxy.encodeSymbol(c->m_number_of_returns[rln], nr);
        if (rdiff == 3) {
            if (gps_change) {
                e_cxy.encodeSymbol(c->m_return_number[rlr], rn);
            } else {
                e_cxy.encodeSymbol(c->m_return_number_gps_same,
                                   (rn - rlr - 2) & 15);
            }
        }
        c->last.returns = cur.returns;

        const U32 m = v3maps.map6[nr][rn];
        const U32 l = v3maps.lvl8[nr][rn];
        const U32 cpr = (rn == 1 ? 2u : 0u) + (rn >= nr ? 1u : 0u);
        const U32 gbit = gps_change ? 1u : 0u;

        I32 median = c->last_x_diff_median5[(m << 1) | gbit].get();
        I32 diff = cur.x - c->last.x;
        c->ic_dx.compress(median, diff, nr == 1);
        c->last_x_diff_median5[(m << 1) | gbit].add(diff);
        c->last.x = cur.x;

        median = c->last_y_diff_median5[(m << 1) | gbit].get();
        U32 kb = c->ic_dx.k;
        diff = cur.y - c->last.y;
        c->ic_dy.compress(median, diff,
                          (nr == 1) + (kb < 20 ? (kb & ~1u) : 20u));
        c->last_y_diff_median5[(m << 1) | gbit].add(diff);
        c->last.y = cur.y;

        kb = (c->ic_dx.k + c->ic_dy.k) / 2;
        c->ic_z.compress(c->last_z[l], cur.z,
                         (nr == 1) + (kb < 18 ? (kb & ~1u) : 18u));
        c->last_z[l] = cur.z;
        c->last.z = cur.z;

        {
            U32 ccc = ((c->last.classification & 0x1F) << 1)
                    | (cpr == 3 ? 1u : 0u);
            e_cls.encodeSymbol(c->m_classification[ccc], cur.classification);
            c->last.classification = cur.classification;
        }
        {
            U32 lf = (U32)(((c->last.flags >> 7) & 1) << 5)
                   | (U32)(((c->last.flags >> 6) & 1) << 4)
                   | (U32)(c->last.flags & 0xF);
            U32 f = (U32)(((cur.flags >> 7) & 1) << 5)
                  | (U32)(((cur.flags >> 6) & 1) << 4)
                  | (U32)(cur.flags & 0xF);
            e_flags.encodeSymbol(c->m_flags[lf], f);
            c->last.flags = cur.flags;
        }
        {
            c->ic_intensity.compress(c->last_intensity[(cpr << 1) | gbit],
                                     cur.intensity, cpr);
            c->last_intensity[(cpr << 1) | gbit] = cur.intensity;
            c->last.intensity = cur.intensity;
        }
        if (changed & (1u << 3)) {
            c->ic_scan_angle.compress(c->last.scan_angle, cur.scan_angle,
                                      gbit);
            c->last.scan_angle = cur.scan_angle;
        }
        {
            e_ud.encodeSymbol(c->m_user_data[c->last.user_data / 4],
                              cur.user_data);
            c->last.user_data = cur.user_data;
        }
        if (changed & (1u << 5)) {
            c->ic_point_source.compress(c->last.point_source_ID,
                                        cur.point_source_ID, 0);
            c->last.point_source_ID = cur.point_source_ID;
        }
        if (gps_change) {
            write_gps(*c, cur.gps_time);
            c->last.gps_time = cur.gps_time;
        }
        c->last_gps_change = gps_change;
        context_out = cc;
    }
};

// RGB14 v3: the RGB12 v2 predictor with four scanner-channel contexts and
// its own layer. RGBNIR14 adds a second (NIR) layer.
struct Rgb14Ctx {
    bool unused = true;
    U16 last[3];
    ArithmeticModel m_byte_used, m_diff[6];

    void seed(const U8* rgb, bool for_compress) {
        unused = false;
        std::memcpy(last, rgb, 6);
        m_byte_used.init(128, for_compress);
        for (int i = 0; i < 6; i++) m_diff[i].init(256, for_compress);
    }
};

static I32 clamp8i(I32 v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

struct Rgb14v3Decompressor {
    Decoder d;
    Rgb14Ctx ctx[4];
    U32 cc = 0;

    void chunk_init(const U8* first, U32 context) {
        for (int i = 0; i < 4; i++) ctx[i].unused = true;
        cc = context;
        ctx[cc].seed(first, false);
    }

    void read(U8* item, U32 context) {
        Rgb14Ctx* c = &ctx[cc];
        if (cc != context) {
            U16 prev_last[3];
            std::memcpy(prev_last, c->last, 6);
            cc = context;
            c = &ctx[cc];
            if (c->unused) c->seed((const U8*)prev_last, false);
        }
        U32 sym = d.decodeSymbol(c->m_byte_used);
        U16 rgb[3];
        I32 diff;
        U8 corr;
        if (sym & 1) {
            corr = (U8)d.decodeSymbol(c->m_diff[0]);
            rgb[0] = (U16)u8_fold(corr + (c->last[0] & 255));
        } else rgb[0] = c->last[0] & 0xFF;
        if (sym & 2) {
            corr = (U8)d.decodeSymbol(c->m_diff[1]);
            rgb[0] |= ((U16)u8_fold(corr + (c->last[0] >> 8))) << 8;
        } else rgb[0] |= c->last[0] & 0xFF00;
        if (sym & 64) {
            diff = (rgb[0] & 0xFF) - (c->last[0] & 0xFF);
            if (sym & 4) {
                corr = (U8)d.decodeSymbol(c->m_diff[2]);
                rgb[1] = (U16)u8_fold(corr + clamp8i(diff + (c->last[1] & 255)));
            } else rgb[1] = c->last[1] & 0xFF;
            if (sym & 16) {
                corr = (U8)d.decodeSymbol(c->m_diff[4]);
                diff = (diff + ((rgb[1] & 0xFF) - (c->last[1] & 0xFF))) / 2;
                rgb[2] = (U16)u8_fold(corr + clamp8i(diff + (c->last[2] & 255)));
            } else rgb[2] = c->last[2] & 0xFF;
            diff = (rgb[0] >> 8) - (c->last[0] >> 8);
            if (sym & 8) {
                corr = (U8)d.decodeSymbol(c->m_diff[3]);
                rgb[1] |= ((U16)u8_fold(corr + clamp8i(diff + (c->last[1] >> 8)))) << 8;
            } else rgb[1] |= c->last[1] & 0xFF00;
            if (sym & 32) {
                corr = (U8)d.decodeSymbol(c->m_diff[5]);
                diff = (diff + ((rgb[1] >> 8) - (c->last[1] >> 8))) / 2;
                rgb[2] |= ((U16)u8_fold(corr + clamp8i(diff + (c->last[2] >> 8)))) << 8;
            } else rgb[2] |= c->last[2] & 0xFF00;
        } else {
            rgb[1] = rgb[0];
            rgb[2] = rgb[0];
        }
        std::memcpy(c->last, rgb, 6);
        std::memcpy(item, rgb, 6);
    }
};

struct Rgb14v3Compressor {
    Encoder e;
    Rgb14Ctx ctx[4];
    U32 cc = 0;

    void chunk_init(const U8* first, U32 context) {
        for (int i = 0; i < 4; i++) ctx[i].unused = true;
        cc = context;
        ctx[cc].seed(first, true);
        e.init();
    }

    void write(const U8* item, U32 context) {
        Rgb14Ctx* c = &ctx[cc];
        if (cc != context) {
            U16 prev_last[3];
            std::memcpy(prev_last, c->last, 6);
            cc = context;
            c = &ctx[cc];
            if (c->unused) c->seed((const U8*)prev_last, true);
        }
        U16 rgb[3];
        std::memcpy(rgb, item, 6);
        I32 diff_l = 0, diff_h = 0;
        U32 sym = (U32)((c->last[0] & 0x00FF) != (rgb[0] & 0x00FF))
                | ((U32)((c->last[0] & 0xFF00) != (rgb[0] & 0xFF00)) << 1)
                | ((U32)((c->last[1] & 0x00FF) != (rgb[1] & 0x00FF)) << 2)
                | ((U32)((c->last[1] & 0xFF00) != (rgb[1] & 0xFF00)) << 3)
                | ((U32)((c->last[2] & 0x00FF) != (rgb[2] & 0x00FF)) << 4)
                | ((U32)((c->last[2] & 0xFF00) != (rgb[2] & 0xFF00)) << 5)
                | ((U32)(((rgb[0] & 0x00FF) != (rgb[1] & 0x00FF)) ||
                         ((rgb[0] & 0x00FF) != (rgb[2] & 0x00FF)) ||
                         ((rgb[0] & 0xFF00) != (rgb[1] & 0xFF00)) ||
                         ((rgb[0] & 0xFF00) != (rgb[2] & 0xFF00))) << 6);
        e.encodeSymbol(c->m_byte_used, sym);
        if (sym & 1) {
            diff_l = (rgb[0] & 255) - (c->last[0] & 255);
            e.encodeSymbol(c->m_diff[0], (U8)diff_l);
        }
        if (sym & 2) {
            diff_h = (rgb[0] >> 8) - (c->last[0] >> 8);
            e.encodeSymbol(c->m_diff[1], (U8)diff_h);
        }
        if (sym & 64) {
            if (sym & 4) {
                I32 corr = (rgb[1] & 255)
                         - clamp8i(diff_l + (c->last[1] & 255));
                e.encodeSymbol(c->m_diff[2], (U8)corr);
            }
            if (sym & 16) {
                diff_l = (diff_l + (rgb[1] & 255) - (c->last[1] & 255)) / 2;
                I32 corr = (rgb[2] & 255)
                         - clamp8i(diff_l + (c->last[2] & 255));
                e.encodeSymbol(c->m_diff[4], (U8)corr);
            }
            if (sym & 8) {
                I32 corr = (rgb[1] >> 8)
                         - clamp8i(diff_h + (c->last[1] >> 8));
                e.encodeSymbol(c->m_diff[3], (U8)corr);
            }
            if (sym & 32) {
                diff_h = (diff_h + (rgb[1] >> 8) - (c->last[1] >> 8)) / 2;
                I32 corr = (rgb[2] >> 8)
                         - clamp8i(diff_h + (c->last[2] >> 8));
                e.encodeSymbol(c->m_diff[5], (U8)corr);
            }
        }
        std::memcpy(c->last, rgb, 6);
    }
};

// NIR channel of RGBNIR14 (its own layer; predictor = one RGB channel pair)
struct Nir14Ctx {
    bool unused = true;
    U16 last = 0;
    ArithmeticModel m_used, m_diff0, m_diff1;

    void seed(U16 nir, bool for_compress) {
        unused = false;
        last = nir;
        m_used.init(4, for_compress);
        m_diff0.init(256, for_compress);
        m_diff1.init(256, for_compress);
    }
};

struct Nir14v3Decompressor {
    Decoder d;
    Nir14Ctx ctx[4];
    U32 cc = 0;

    void chunk_init(U16 first, U32 context) {
        for (int i = 0; i < 4; i++) ctx[i].unused = true;
        cc = context;
        ctx[cc].seed(first, false);
    }

    U16 read(U32 context) {
        Nir14Ctx* c = &ctx[cc];
        if (cc != context) {
            U16 prev = c->last;
            cc = context;
            c = &ctx[cc];
            if (c->unused) c->seed(prev, false);
        }
        U32 sym = d.decodeSymbol(c->m_used);
        U16 nir;
        if (sym & 1) {
            U8 corr = (U8)d.decodeSymbol(c->m_diff0);
            nir = (U16)u8_fold(corr + (c->last & 255));
        } else nir = c->last & 0xFF;
        if (sym & 2) {
            U8 corr = (U8)d.decodeSymbol(c->m_diff1);
            nir |= ((U16)u8_fold(corr + (c->last >> 8))) << 8;
        } else nir |= c->last & 0xFF00;
        c->last = nir;
        return nir;
    }
};

struct Nir14v3Compressor {
    Encoder e;
    Nir14Ctx ctx[4];
    U32 cc = 0;

    void chunk_init(U16 first, U32 context) {
        for (int i = 0; i < 4; i++) ctx[i].unused = true;
        cc = context;
        ctx[cc].seed(first, true);
        e.init();
    }

    void write(U16 nir, U32 context) {
        Nir14Ctx* c = &ctx[cc];
        if (cc != context) {
            U16 prev = c->last;
            cc = context;
            c = &ctx[cc];
            if (c->unused) c->seed(prev, true);
        }
        U32 sym = (U32)((c->last & 0x00FF) != (nir & 0x00FF))
                | ((U32)((c->last & 0xFF00) != (nir & 0xFF00)) << 1);
        e.encodeSymbol(c->m_used, sym);
        if (sym & 1)
            e.encodeSymbol(c->m_diff0, (U8)((nir & 255) - (c->last & 255)));
        if (sym & 2)
            e.encodeSymbol(c->m_diff1, (U8)((nir >> 8) - (c->last >> 8)));
        c->last = nir;
    }
};

// BYTE14 v3: one layer (and one 256-symbol model set) PER extra byte,
// per scanner-channel context.
struct Byte14Ctx {
    bool unused = true;
    std::vector<U8> last;
    std::vector<ArithmeticModel> m_byte;

    void seed(const U8* bytes, U32 n, bool for_compress) {
        unused = false;
        last.assign(bytes, bytes + n);
        m_byte.resize(n);
        for (U32 i = 0; i < n; i++) m_byte[i].init(256, for_compress);
    }
};

struct Byte14v3Decompressor {
    std::vector<Decoder> d;  // one per byte
    U32 number = 0;
    Byte14Ctx ctx[4];
    U32 cc = 0;

    void chunk_init(const U8* first, U32 n, U32 context) {
        number = n;
        d.resize(n);
        for (int i = 0; i < 4; i++) ctx[i].unused = true;
        cc = context;
        ctx[cc].seed(first, n, false);
    }

    void read(U8* item, U32 context) {
        Byte14Ctx* c = &ctx[cc];
        if (cc != context) {
            std::vector<U8> prev = c->last;
            cc = context;
            c = &ctx[cc];
            if (c->unused) c->seed(prev.data(), number, false);
        }
        for (U32 i = 0; i < number; i++) {
            I32 val = (I32)d[i].decodeSymbol(c->m_byte[i]);
            item[i] = u8_fold(val + c->last[i]);
        }
        std::memcpy(c->last.data(), item, number);
    }
};

struct Byte14v3Compressor {
    std::vector<Encoder> e;
    U32 number = 0;
    Byte14Ctx ctx[4];
    U32 cc = 0;

    void chunk_init(const U8* first, U32 n, U32 context) {
        number = n;
        e.resize(n);
        for (U32 i = 0; i < n; i++) e[i].init();
        for (int i = 0; i < 4; i++) ctx[i].unused = true;
        cc = context;
        ctx[cc].seed(first, n, true);
    }

    void write(const U8* item, U32 context) {
        Byte14Ctx* c = &ctx[cc];
        if (cc != context) {
            std::vector<U8> prev = c->last;
            cc = context;
            c = &ctx[cc];
            if (c->unused) c->seed(prev.data(), number, true);
        }
        for (U32 i = 0; i < number; i++)
            e[i].encodeSymbol(c->m_byte[i], (U8)(item[i] - c->last[i]));
        std::memcpy(c->last.data(), item, number);
    }
};

// ---------------------------------------------------------------------------
// Chunked stream codecs over an item schema
// ---------------------------------------------------------------------------

// item type ids (LASzip laszip.hpp)
enum ItemType : U16 {
    ITEM_BYTE = 0,
    ITEM_POINT10 = 6,
    ITEM_GPSTIME11 = 7,
    ITEM_RGB12 = 8,
    ITEM_POINT14 = 10,
    ITEM_RGB14 = 11,
    ITEM_RGBNIR14 = 12,
    ITEM_WAVEPACKET14 = 13,
    ITEM_BYTE14 = 14,
};

struct Schema {
    // parallel arrays: type, size (BYTE items carry their byte count)
    std::vector<U16> types;
    std::vector<U16> sizes;

    U32 record_size() const {
        U32 s = 0;
        for (U16 z : sizes) s += z;
        return s;
    }
};

// ---------------------------------------------------------------------------
// Layered (compressor 3) chunk drivers — LAS 1.4 point formats 6-8.
// Chunk framing (see the v3 header note for the conformance caveat):
//   [U32 count] [layer sizes U32 x n_layers(item), item-major]
//   [raw first records, item-major] [layer payloads, item-major]
// ---------------------------------------------------------------------------

static int v3_layer_count(U16 type, U16 size) {
    switch (type) {
    case 10: return 9;            // POINT14
    case 11: return 1;            // RGB14
    case 12: return 2;            // RGBNIR14 (rgb + nir)
    case 14: return (int)size;    // BYTE14: one layer per byte
    default: return -1;           // WAVEPACKET14 and unknowns unsupported
    }
}

static int64_t laz_decompress_layered(const U8* in, int64_t in_len,
                                      const Schema& schema, int64_t n_points,
                                      U8* out) {
    const U32 rec = schema.record_size();
    if (schema.types.empty() || schema.types[0] != 10)
        return -3;  // POINT14 must lead (it drives the context)
    if (in_len < 8) return -1;
    const U8* p = in + 8;          // skip chunk-table offset
    const U8* p_end = in + in_len;

    int64_t done = 0;
    while (done < n_points) {
        if (p + 4 > p_end) return -2;
        U32 count;
        std::memcpy(&count, p, 4);
        p += 4;
        if (count == 0 || (int64_t)count > n_points - done) return -2;

        // layer sizes, item-major
        std::vector<std::vector<U32>> lsz(schema.types.size());
        for (size_t i = 0; i < schema.types.size(); i++) {
            int nl = v3_layer_count(schema.types[i], schema.sizes[i]);
            if (nl < 0) return -3;
            lsz[i].resize(nl);
            if (p + 4 * nl > p_end) return -2;
            std::memcpy(lsz[i].data(), p, 4 * (size_t)nl);
            p += 4 * (size_t)nl;
        }
        // raw first records, item-major
        if (p + rec > p_end) return -2;
        std::memcpy(out + done * rec, p, rec);
        const U8* raw = p;
        p += rec;

        // wire each codec's layer decoders to their payload ranges
        Point14v3Decompressor pt;
        Rgb14v3Decompressor rgb;
        Nir14v3Decompressor nir;
        std::vector<Byte14v3Decompressor> xbytes;
        bool has_rgb = false, has_nir = false;

        const U8* item0 = raw;
        for (size_t i = 0; i < schema.types.size(); i++) {
            const std::vector<U32>& sz = lsz[i];
            switch (schema.types[i]) {
            case 10: {
                Decoder* ds[9] = {&pt.d_cxy, &pt.d_z, &pt.d_cls, &pt.d_flags,
                                  &pt.d_int, &pt.d_sa, &pt.d_ud, &pt.d_ps,
                                  &pt.d_gps};
                bool* flags[9] = {nullptr, &pt.has_z, &pt.has_cls,
                                  &pt.has_flags, &pt.has_int, &pt.has_sa,
                                  &pt.has_ud, &pt.has_ps, &pt.has_gps};
                for (int li = 0; li < 9; li++) {
                    if (p + sz[li] > p_end) return -2;
                    ds[li]->in = p;
                    ds[li]->in_end = p + sz[li];
                    p += sz[li];
                    if (sz[li]) ds[li]->init();
                    if (flags[li]) *flags[li] = sz[li] > 0;
                }
                pt.chunk_init(item0);
                break;
            }
            case 11: case 12: {
                if (p + sz[0] > p_end) return -2;
                rgb.d.in = p;
                rgb.d.in_end = p + sz[0];
                p += sz[0];
                if (sz[0]) rgb.d.init();
                rgb.chunk_init(item0, pt.cc);
                has_rgb = true;
                if (schema.types[i] == 12) {
                    if (p + sz[1] > p_end) return -2;
                    nir.d.in = p;
                    nir.d.in_end = p + sz[1];
                    p += sz[1];
                    if (sz[1]) nir.d.init();
                    U16 first_nir;
                    std::memcpy(&first_nir, item0 + 6, 2);
                    nir.chunk_init(first_nir, pt.cc);
                    has_nir = true;
                }
                break;
            }
            case 14: {
                Byte14v3Decompressor b;
                b.number = schema.sizes[i];
                b.d.resize(b.number);
                for (U32 li = 0; li < b.number; li++) {
                    if (p + sz[li] > p_end) return -2;
                    b.d[li].in = p;
                    b.d[li].in_end = p + sz[li];
                    p += sz[li];
                    if (sz[li]) b.d[li].init();
                }
                b.chunk_init(item0, b.number, pt.cc);
                xbytes.push_back(std::move(b));
                break;
            }
            default:
                return -3;
            }
            item0 += schema.sizes[i];
        }

        for (U32 j = 1; j < count; j++) {
            U8* item = out + (done + j) * rec;
            U32 cctx = pt.cc;
            size_t bi = 0;
            for (size_t i = 0; i < schema.types.size(); i++) {
                switch (schema.types[i]) {
                case 10: pt.read(item, cctx); break;
                case 11: rgb.read(item, cctx); break;
                case 12: {
                    rgb.read(item, cctx);
                    U16 v = nir.read(cctx);
                    std::memcpy(item + 6, &v, 2);
                    break;
                }
                case 14: xbytes[bi++].read(item, cctx); break;
                }
                item += schema.sizes[i];
            }
        }
        (void)has_rgb; (void)has_nir;
        done += count;
    }
    return 0;
}

static int64_t laz_compress_layered(const U8* in, int64_t n_points,
                                    const Schema& schema, int64_t chunk_size,
                                    U8* out, int64_t out_cap) {
    const U32 rec = schema.record_size();
    if (schema.types.empty() || schema.types[0] != 10) return -3;
    for (size_t i = 0; i < schema.types.size(); i++)
        if (v3_layer_count(schema.types[i], schema.sizes[i]) < 0) return -3;

    std::vector<U8> blob;
    blob.resize(8, 0);  // chunk-table offset placeholder
    std::vector<U32> chunk_bytes;

    int64_t done = 0;
    while (done < n_points) {
        int64_t this_chunk = n_points - done;
        if (chunk_size > 0 && this_chunk > chunk_size) this_chunk = chunk_size;
        size_t chunk_begin = blob.size();

        Point14v3Compressor pt;
        Rgb14v3Compressor rgb;
        Nir14v3Compressor nir;
        std::vector<Byte14v3Compressor> xbytes;

        const U8* item0 = in + done * rec;
        const U8* it = item0;
        for (size_t i = 0; i < schema.types.size(); i++) {
            switch (schema.types[i]) {
            case 10: pt.chunk_init(it); break;
            case 11: rgb.chunk_init(it, pt.cc); break;
            case 12: {
                rgb.chunk_init(it, pt.cc);
                U16 first_nir;
                std::memcpy(&first_nir, it + 6, 2);
                nir.chunk_init(first_nir, pt.cc);
                break;
            }
            case 14: {
                Byte14v3Compressor b;
                b.chunk_init(it, schema.sizes[i], pt.cc);
                xbytes.push_back(std::move(b));
                break;
            }
            }
            it += schema.sizes[i];
        }

        for (int64_t j = 1; j < this_chunk; j++) {
            const U8* item = in + (done + j) * rec;
            U32 cctx = pt.cc;
            size_t bi = 0;
            for (size_t i = 0; i < schema.types.size(); i++) {
                switch (schema.types[i]) {
                case 10: pt.write(item, cctx); break;
                case 11: rgb.write(item, cctx); break;
                case 12: {
                    rgb.write(item, cctx);
                    U16 v;
                    std::memcpy(&v, item + 6, 2);
                    nir.write(v, cctx);
                    break;
                }
                case 14: xbytes[bi++].write(item, cctx); break;
                }
                item += schema.sizes[i];
            }
        }

        // finalize all layer encoders and assemble the chunk
        std::vector<std::vector<U8>*> layers;
        size_t bfin = 0;
        for (size_t i = 0; i < schema.types.size(); i++) {
            switch (schema.types[i]) {
            case 10: {
                Encoder* es[9] = {&pt.e_cxy, &pt.e_z, &pt.e_cls, &pt.e_flags,
                                  &pt.e_int, &pt.e_sa, &pt.e_ud, &pt.e_ps,
                                  &pt.e_gps};
                for (Encoder* e : es) {
                    e->done();
                    layers.push_back(&e->out);
                }
                break;
            }
            case 11:
                rgb.e.done();
                layers.push_back(&rgb.e.out);
                break;
            case 12:
                rgb.e.done();
                layers.push_back(&rgb.e.out);
                nir.e.done();
                layers.push_back(&nir.e.out);
                break;
            case 14: {
                Byte14v3Compressor& b = xbytes[bfin++];
                for (Encoder& e : b.e) {
                    e.done();
                    layers.push_back(&e.out);
                }
                break;
            }
            }
        }

        U32 count = (U32)this_chunk;
        blob.insert(blob.end(), (U8*)&count, (U8*)&count + 4);
        for (auto* l : layers) {
            U32 n = (U32)l->size();
            blob.insert(blob.end(), (U8*)&n, (U8*)&n + 4);
        }
        blob.insert(blob.end(), item0, item0 + rec);
        for (auto* l : layers)
            blob.insert(blob.end(), l->begin(), l->end());

        chunk_bytes.push_back((U32)(blob.size() - chunk_begin));
        done += this_chunk;
    }

    // chunk table (same layout as the v2 writer's)
    U64 table_off = blob.size();
    std::memcpy(blob.data(), &table_off, 8);
    U32 version = 0;
    U32 n_chunks = (U32)chunk_bytes.size();
    blob.insert(blob.end(), (U8*)&version, (U8*)&version + 4);
    blob.insert(blob.end(), (U8*)&n_chunks, (U8*)&n_chunks + 4);
    {
        Encoder tenc;
        tenc.init();
        IntegerCompressor tic;
        tic.init(&tenc, 2);
        for (U32 i = 0; i < n_chunks; i++)
            tic.compress(i ? (I32)chunk_bytes[i - 1] : 0,
                         (I32)chunk_bytes[i], 1);
        tenc.done();
        blob.insert(blob.end(), tenc.out.begin(), tenc.out.end());
    }

    if ((int64_t)blob.size() > out_cap) return -4;
    std::memcpy(out, blob.data(), blob.size());
    return (int64_t)blob.size();
}

}  // namespace laz

using namespace laz;

extern "C" {

// Decompress a LAZ point blob (compressor 2, pointwise chunked, v2 items).
//
// in:  compressed bytes beginning at the LAS "offset to point data", i.e.
//      starting with the i64 chunk-table offset (ABSOLUTE file offset;
//      point_data_offset converts it to a blob-relative position)
// schema: item (type, size) pairs; n_items entries
// out: n_points * record_size bytes of raw little-endian point records
// Returns 0 on success, negative error code otherwise.
//
// Chunk boundaries: the arithmetic decoder reads a few bytes past each
// chunk's payload (4-byte lookahead), so multi-chunk streams are
// repositioned from the chunk table (u32 version 0, u32 n_chunks, then
// chunk byte counts compressed with IntegerCompressor(32,2) ctx 1) — the
// same recovery real LASzip readers perform.
int64_t laz_decompress(const uint8_t* in, int64_t in_len,
                       const uint16_t* item_types, const uint16_t* item_sizes,
                       int64_t n_items, int64_t n_points, int64_t chunk_size,
                       int64_t point_data_offset, uint8_t* out) {
    if (n_points == 0) return 0;
    Schema schema;
    bool layered = false;
    for (int64_t i = 0; i < n_items; i++) {
        schema.types.push_back(item_types[i]);
        schema.sizes.push_back(item_sizes[i]);
        if (item_types[i] >= 10) layered = true;
    }
    if (layered)  // compressor 3: LAS 1.4 v3 items, self-delimiting chunks
        return laz_decompress_layered(in, in_len, schema, n_points, out);
    const U32 rec = schema.record_size();
    if (in_len < 8) return -1;
    const U8* p = in + 8;
    const U8* p_end = in + in_len;

    // chunk starts from the chunk table (needed when n_points > chunk_size)
    std::vector<const U8*> chunk_start;
    if (chunk_size > 0 && n_points > chunk_size) {
        I64 table_abs;
        std::memcpy(&table_abs, in, 8);
        I64 table_rel = table_abs - point_data_offset;
        if (table_rel < 8 || table_rel + 8 > in_len) return -5;
        const U8* t = in + table_rel;
        U32 version, n_chunks;
        std::memcpy(&version, t, 4);
        std::memcpy(&n_chunks, t + 4, 4);
        if (version != 0) return -5;
        Decoder tdec;
        tdec.in = t + 8;
        tdec.in_end = p_end;
        tdec.init();
        IntegerDecompressor tic;
        tic.init(&tdec, 2);
        const U8* pos = in + 8;
        I32 prev = 0;
        for (U32 i = 0; i < n_chunks; i++) {
            chunk_start.push_back(pos);
            I32 bytes = tic.decompress(prev, 1);
            prev = bytes;
            pos += bytes;
        }
    }

    int64_t done = 0;
    size_t ci = 0;
    while (done < n_points) {
        int64_t this_chunk = n_points - done;
        if (chunk_size > 0 && this_chunk > chunk_size) this_chunk = chunk_size;
        if (!chunk_start.empty()) {
            if (ci >= chunk_start.size()) return -6;
            p = chunk_start[ci++];
        }

        // first point of the chunk is raw
        if (p + rec > p_end) return -2;
        std::memcpy(out + done * rec, p, rec);
        p += rec;

        Decoder dec;
        dec.in = p;
        dec.in_end = p_end;
        dec.init();

        // per-item codecs seeded with the raw first record
        Point10v2Decompressor* d_pt = nullptr;
        GpsTime11v2Decompressor* d_gps = nullptr;
        Rgb12v2Decompressor* d_rgb = nullptr;
        std::vector<Byte2Decompressor*> d_bytes;
        {
            const U8* item = out + done * rec;
            for (size_t i = 0; i < schema.types.size(); i++) {
                switch (schema.types[i]) {
                case ITEM_POINT10:
                    d_pt = new Point10v2Decompressor();
                    d_pt->init(&dec, item);
                    break;
                case ITEM_GPSTIME11:
                    d_gps = new GpsTime11v2Decompressor();
                    d_gps->init(&dec, item);
                    break;
                case ITEM_RGB12:
                    d_rgb = new Rgb12v2Decompressor();
                    d_rgb->init(&dec, item);
                    break;
                case ITEM_BYTE: {
                    Byte2Decompressor* b = new Byte2Decompressor();
                    b->init(&dec, item, schema.sizes[i]);
                    d_bytes.push_back(b);
                    break;
                }
                default:
                    delete d_pt; delete d_gps; delete d_rgb;
                    for (auto* b : d_bytes) delete b;
                    return -3;  // unsupported item
                }
                item += schema.sizes[i];
            }
        }

        for (int64_t j = 1; j < this_chunk; j++) {
            U8* item = out + (done + j) * rec;
            size_t bi = 0;
            for (size_t i = 0; i < schema.types.size(); i++) {
                switch (schema.types[i]) {
                case ITEM_POINT10: d_pt->read(item); break;
                case ITEM_GPSTIME11: d_gps->read(item); break;
                case ITEM_RGB12: d_rgb->read(item); break;
                case ITEM_BYTE: d_bytes[bi++]->read(item); break;
                }
                item += schema.sizes[i];
            }
        }
        delete d_pt;
        delete d_gps;
        delete d_rgb;
        for (auto* b : d_bytes) delete b;

        // decoder consumed bytes up to dec.in; continue there
        p = dec.in;
        done += this_chunk;
    }
    return 0;
}

// Compress raw point records into a LAZ point blob (chunk-table offset +
// chunks; a minimal chunk table is appended). out_cap must be generous
// (records + header slack); returns the number of bytes written, or a
// negative error code.
int64_t laz_compress(const uint8_t* in, int64_t n_points,
                     const uint16_t* item_types, const uint16_t* item_sizes,
                     int64_t n_items, int64_t chunk_size, uint8_t* out,
                     int64_t out_cap) {
    Schema schema;
    bool layered = false;
    for (int64_t i = 0; i < n_items; i++) {
        schema.types.push_back(item_types[i]);
        schema.sizes.push_back(item_sizes[i]);
        if (item_types[i] >= 10) layered = true;
    }
    if (layered)
        return laz_compress_layered(in, n_points, schema, chunk_size, out,
                                    out_cap);
    const U32 rec = schema.record_size();

    std::vector<U8> blob;
    blob.resize(8, 0);  // chunk table offset placeholder
    std::vector<U32> chunk_bytes;

    int64_t done = 0;
    while (done < n_points) {
        int64_t this_chunk = n_points - done;
        if (chunk_size > 0 && this_chunk > chunk_size) this_chunk = chunk_size;
        size_t chunk_start = blob.size();

        // raw first record
        blob.insert(blob.end(), in + done * rec, in + (done + 1) * rec);

        Encoder enc;
        enc.init();
        Point10v2Compressor* c_pt = nullptr;
        GpsTime11v2Compressor* c_gps = nullptr;
        Rgb12v2Compressor* c_rgb = nullptr;
        std::vector<Byte2Compressor*> c_bytes;
        {
            const U8* item = in + done * rec;
            for (size_t i = 0; i < schema.types.size(); i++) {
                switch (schema.types[i]) {
                case ITEM_POINT10:
                    c_pt = new Point10v2Compressor();
                    c_pt->init(&enc, item);
                    break;
                case ITEM_GPSTIME11:
                    c_gps = new GpsTime11v2Compressor();
                    c_gps->init(&enc, item);
                    break;
                case ITEM_RGB12:
                    c_rgb = new Rgb12v2Compressor();
                    c_rgb->init(&enc, item);
                    break;
                case ITEM_BYTE: {
                    Byte2Compressor* b = new Byte2Compressor();
                    b->init(&enc, item, schema.sizes[i]);
                    c_bytes.push_back(b);
                    break;
                }
                default:
                    delete c_pt; delete c_gps; delete c_rgb;
                    for (auto* b : c_bytes) delete b;
                    return -3;
                }
                item += schema.sizes[i];
            }
        }
        for (int64_t j = 1; j < this_chunk; j++) {
            const U8* item = in + (done + j) * rec;
            size_t bi = 0;
            for (size_t i = 0; i < schema.types.size(); i++) {
                switch (schema.types[i]) {
                case ITEM_POINT10: c_pt->write(item); break;
                case ITEM_GPSTIME11: c_gps->write(item); break;
                case ITEM_RGB12: c_rgb->write(item); break;
                case ITEM_BYTE: c_bytes[bi++]->write(item); break;
                }
                item += schema.sizes[i];
            }
        }
        enc.done();
        delete c_pt;
        delete c_gps;
        delete c_rgb;
        for (auto* b : c_bytes) delete b;

        blob.insert(blob.end(), enc.out.begin(), enc.out.end());
        chunk_bytes.push_back((U32)(blob.size() - chunk_start));
        done += this_chunk;
    }

    // chunk table, LASzip layout: u32 version(0), u32 number_chunks, then
    // the chunk byte-counts compressed with IntegerCompressor(32, 2)
    // context 1, each predicted by its predecessor. (Our own reader decodes
    // sequentially and skips the table; it is written for conformance with
    // random-access LASzip readers.)
    U64 table_off = blob.size();  // relative; caller patches to absolute
    std::memcpy(blob.data(), &table_off, 8);
    U32 version = 0;
    U32 n_chunks = (U32)chunk_bytes.size();
    blob.insert(blob.end(), (U8*)&version, (U8*)&version + 4);
    blob.insert(blob.end(), (U8*)&n_chunks, (U8*)&n_chunks + 4);
    {
        Encoder tenc;
        tenc.init();
        IntegerCompressor tic;
        tic.init(&tenc, 2);
        for (U32 i = 0; i < n_chunks; i++)
            tic.compress(i ? (I32)chunk_bytes[i - 1] : 0,
                         (I32)chunk_bytes[i], 1);
        tenc.done();
        blob.insert(blob.end(), tenc.out.begin(), tenc.out.end());
    }

    if ((int64_t)blob.size() > out_cap) return -4;
    std::memcpy(out, blob.data(), blob.size());
    return (int64_t)blob.size();
}

}  // extern "C"
