// Runs K7 and K8 (csrc/cross_attention.cu's Int4Halves instantiations) on
// the CPU through common.cuh's emulation.
//
//   cross_int4_harness B H T Tq S masks eager schedule in out
//   cross_int4_harness splits B H T Tq
//   cross_int4_harness decode in out
//
// `in` holds q (bf16 [B, H, Tq, 64]), then k4 and v4 (int8 [B, H, T, 32]
// each), then lengths (int32 [B]); `masks` is 0 (no lengths) or 1 (with
// lengths). `out` receives the f32 [B, H, Tq, 64] output. `S` is the split
// over T (0: the launcher's own choice). The kernel runs twice: with copies
// landing at their wait (`eager` 0) or at once (1), `schedule` an
// emu::Schedule and the clusters in launch order; then with the other copy
// timing, the next schedule and the clusters in reverse. A copy from a k4
// or v4 row the kernel need not read (past a row's length) aborts. Prints
// the launcher's return code, the split and whether the two outputs are
// equal bit for bit. The second form prints the launcher's split for B*H
// rows of T positions and Tq queries. The third lays 8 rows of K and of V
// (`in`: int8 [8, 32] each) out in shared memory as the copy wave does and
// writes what the codec decodes of each row, channel by channel, to `out`
// (f32 K [8, 64], then V [8, 64]).
#include "cross_attention.cu"

#include <fstream>
#include <iterator>

namespace {

std::vector<char> read_all(const char* path) {
    std::ifstream in(path, std::ios::binary);
    return std::vector<char>((std::istreambuf_iterator<char>(in)), {});
}

int decode(const char* in, const char* out) {
    constexpr int kRows = 8;
    const std::vector<char> bytes = read_all(in);
    if (bytes.size() != 2 * kRows * 32) {
        fprintf(stderr, "input size\n");
        return 2;
    }
    alignas(16) unsigned char kv[kRows * Int4Halves::kRow];
    for (int r = 0; r < kRows; ++r)
        for (int p = 0; p < Int4Halves::kPieces; ++p)
            std::memcpy(kv + Int4Halves::piece_at(r, p),
                        bytes.data() + (p < 2 ? 0 : kRows * 32) + r * 32 + (p & 1) * 16, 16);
    std::vector<float> f(2 * kRows * 64, NAN);
    for (int r = 0; r < kRows; ++r) {
        for (int u = 0; u < Int4Halves::kKUnits; ++u) {
            float kf[Int4Halves::kKVals];
            Int4Halves::k_unit(kv, r, u, kf);
            for (int i = 0; i < Int4Halves::kKVals; ++i)
                f[r * 64 + Int4Halves::k_channel(u, i)] = kf[i];
        }
        for (int g = 0; g < 8; ++g) {
            float vf[8];
            Int4Halves::v_group(kv, r, g, vf);
            for (int i = 0; i < 8; ++i) f[(kRows + r) * 64 + Int4Halves::v_channel(g, i)] = vf[i];
        }
    }
    std::ofstream(out, std::ios::binary)
        .write(reinterpret_cast<const char*>(f.data()), f.size() * 4);
    return 0;
}

}  // namespace

int main(int argc, char** argv) {
    if (argc == 6 && std::strcmp(argv[1], "splits") == 0) {
        printf("%d\n", splits_for<Int4Halves>(atoi(argv[2]) * atoi(argv[3]), atoi(argv[4]),
                                              atoi(argv[5])));
        return 0;
    }
    if (argc == 4 && std::strcmp(argv[1], "decode") == 0) return decode(argv[2], argv[3]);
    if (argc != 11) {
        fprintf(stderr, "usage: cross_int4_harness B H T Tq S masks eager schedule in out\n");
        return 2;
    }
    const int B = atoi(argv[1]), H = atoi(argv[2]), T = atoi(argv[3]), Tq = atoi(argv[4]);
    const int S = atoi(argv[5]) ? atoi(argv[5]) : splits_for<Int4Halves>(B * H, T, Tq);
    const int masks = atoi(argv[6]), eager = atoi(argv[7]), schedule = atoi(argv[8]);
    const std::vector<char> bytes = read_all(argv[9]);
    const size_t q_bytes = size_t(B) * H * Tq * 128, kv_bytes = size_t(B) * H * T * 32;
    if (bytes.size() != q_bytes + 2 * kv_bytes + size_t(B) * 4) {
        fprintf(stderr, "input size\n");
        return 2;
    }
    // separate 16-byte aligned buffers; of k4 and v4 only the rows the
    // kernel must read are registered as device memory: the first n of each
    // (b, h), n = min(len, T), or T without lengths or where len <= 0
    std::vector<uint4> qb(q_bytes / 16), kb(kv_bytes / 16), vb(kv_bytes / 16),
        lb((B * 4 + 15) / 16);
    std::memcpy(qb.data(), bytes.data(), q_bytes);
    std::memcpy(kb.data(), bytes.data() + q_bytes, kv_bytes);
    std::memcpy(vb.data(), bytes.data() + q_bytes + kv_bytes, kv_bytes);
    std::memcpy(lb.data(), bytes.data() + q_bytes + 2 * kv_bytes, B * 4);
    const int* len = reinterpret_cast<const int*>(lb.data());
    for (int b = 0; b < B; ++b) {
        const int n = masks == 0 || len[b] <= 0 ? T : std::min(len[b], T);
        for (int h = 0; h < H; ++h)
            for (const auto* base : {kb.data(), vb.data()})
                emu::add_global(reinterpret_cast<const char*>(base) +
                                    (size_t(b) * H + h) * T * 32, size_t(n) * 32);
    }
    std::vector<float> out[2];
    int rc = 0;
    for (int run = 0; run < 2; ++run) {
        emu::eager_copies = (eager != 0) != (run == 1);
        emu::schedule = static_cast<emu::Schedule>((schedule + run) % 3);
        emu::reverse_ctas = run == 1;
        out[run].assign(size_t(B) * H * Tq * 64, NAN);
        rc |= launch<Int4Halves>(qb.data(), kb.data(), vb.data(), masks ? lb.data() : nullptr,
                                 nullptr, out[run].data(), B, H, T, Tq, 0.125f, S, nullptr);
    }
    std::ofstream(argv[10], std::ios::binary)
        .write(reinterpret_cast<const char*>(out[0].data()), out[0].size() * 4);
    const bool same = std::memcmp(out[0].data(), out[1].data(), out[0].size() * 4) == 0;
    printf("rc=%d splits=%d identical=%d\n", rc, S, int(same));
    return rc;
}
