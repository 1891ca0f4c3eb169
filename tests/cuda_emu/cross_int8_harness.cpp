// Runs K4, K5, K6 and K5's window form (csrc/cross_attention.cu's Int8Packed
// instantiations) on the CPU through common.cuh's emulation.
//
//   cross_int8_harness B H T Tq S masks eager schedule in out
//   cross_int8_harness splits B H T Tq
//
// `in` holds q (bf16 [B, H, Tq, 64]), then kvp (int8 [B, H, T, 128]), then
// lengths (int32 [B]) and active (uint8 [B]); `masks` is 0 (no lengths: K4,
// or K6 at Tq > 1), 1 (with lengths) or 2 (lengths and active: K5, or its
// window form at Tq > 1). `out` receives the f32 [B, H, Tq, 64] output.
// `S` is the split over T (0: the launcher's own choice). The kernel runs
// twice: with copies landing at their wait (`eager` 0) or at once (1),
// `schedule` an emu::Schedule and the clusters in launch order; then with
// the other copy timing, the next schedule and the clusters in reverse. A
// copy from a K|V row the kernel need not read (past a row's length, or of
// an inactive row) aborts. Prints the launcher's return code, the split
// and whether the two outputs are equal bit for bit. The second form
// prints the launcher's split for B*H rows of T positions and Tq queries.
#include "cross_attention.cu"

#include <fstream>
#include <iterator>

int main(int argc, char** argv) {
    if (argc == 6 && std::strcmp(argv[1], "splits") == 0) {
        printf("%d\n", splits_for<Int8Packed>(atoi(argv[2]) * atoi(argv[3]), atoi(argv[4]),
                                              atoi(argv[5])));
        return 0;
    }
    if (argc != 11) {
        fprintf(stderr, "usage: cross_int8_harness B H T Tq S masks eager schedule in out\n");
        return 2;
    }
    const int B = atoi(argv[1]), H = atoi(argv[2]), T = atoi(argv[3]), Tq = atoi(argv[4]);
    const int S = atoi(argv[5]) ? atoi(argv[5]) : splits_for<Int8Packed>(B * H, T, Tq);
    const int masks = atoi(argv[6]), eager = atoi(argv[7]), schedule = atoi(argv[8]);
    std::ifstream in(argv[9], std::ios::binary);
    const std::vector<char> bytes((std::istreambuf_iterator<char>(in)), {});
    const size_t q_bytes = size_t(B) * H * Tq * 128, kv_bytes = size_t(B) * H * T * 128;
    if (bytes.size() != q_bytes + kv_bytes + size_t(B) * 5) {
        fprintf(stderr, "input size\n");
        return 2;
    }
    // separate 16-byte aligned buffers; of kvp only the rows the kernel must
    // read are registered as device memory: the first n of each (b, h) of an
    // active row, n = min(len, T), or T without lengths or where len <= 0
    std::vector<uint4> qb(q_bytes / 16), kvb(kv_bytes / 16), lb((B * 4 + 15) / 16),
        ab((B + 15) / 16);
    std::memcpy(qb.data(), bytes.data(), q_bytes);
    std::memcpy(kvb.data(), bytes.data() + q_bytes, kv_bytes);
    std::memcpy(lb.data(), bytes.data() + q_bytes + kv_bytes, B * 4);
    std::memcpy(ab.data(), bytes.data() + q_bytes + kv_bytes + B * 4, B);
    const int* len = reinterpret_cast<const int*>(lb.data());
    const uint8_t* act = reinterpret_cast<const uint8_t*>(ab.data());
    for (int b = 0; b < B; ++b) {
        const int n = masks == 0 || len[b] <= 0 ? T : std::min(len[b], T);
        if (masks < 2 || act[b])
            for (int h = 0; h < H; ++h)
                emu::add_global(reinterpret_cast<const char*>(kvb.data()) +
                                    (size_t(b) * H + h) * T * 128, size_t(n) * 128);
    }
    std::vector<float> out[2];
    int rc = 0;
    for (int run = 0; run < 2; ++run) {
        emu::eager_copies = (eager != 0) != (run == 1);
        emu::schedule = static_cast<emu::Schedule>((schedule + run) % 3);
        emu::reverse_ctas = run == 1;
        out[run].assign(size_t(B) * H * Tq * 64, NAN);
        rc |= launch<Int8Packed>(qb.data(), kvb.data(), nullptr, masks ? lb.data() : nullptr,
                                 masks == 2 ? ab.data() : nullptr, out[run].data(), B, H, T, Tq,
                                 0.125f, S, nullptr);
    }
    std::ofstream(argv[10], std::ios::binary)
        .write(reinterpret_cast<const char*>(out[0].data()), out[0].size() * 4);
    const bool same = std::memcmp(out[0].data(), out[1].data(), out[0].size() * 4) == 0;
    printf("rc=%d splits=%d identical=%d\n", rc, S, int(same));
    return rc;
}
