// Runs K2 (csrc/int8_matmul.cu) on the CPU through common.cuh's emulation.
//
//   k2_harness M K N splits eager schedule in out
//
// `in` holds x (bf16 [M, K]), then w8 (int8 [K, N]), then s (bf16 [N]);
// `out` receives the bf16 [M, N] output. `splits` is the split over K (0:
// the launcher's own choice); `eager` 1 lands every cp.async copy at once,
// 0 at its wait_group; `schedule` is an emu::Schedule. The kernel runs
// twice, its clusters first in launch order, then in reverse. Prints the
// launcher's return code, the split, the ldmatrix bank conflicts and
// whether the two outputs are equal bit for bit.
#include "int8_matmul.cu"

#include <fstream>
#include <iterator>

int main(int argc, char** argv) {
    if (argc != 9) {
        fprintf(stderr, "usage: k2_harness M K N splits eager schedule in out\n");
        return 2;
    }
    const int M = atoi(argv[1]), K = atoi(argv[2]), N = atoi(argv[3]);
    const int splits = atoi(argv[4]) ? atoi(argv[4]) : splits_for(M, K, N);
    emu::eager_copies = atoi(argv[5]) != 0;
    emu::schedule = static_cast<emu::Schedule>(atoi(argv[6]));
    std::ifstream in(argv[7], std::ios::binary);
    const std::vector<char> bytes((std::istreambuf_iterator<char>(in)), {});
    const size_t x_bytes = size_t(M) * K * 2, w_bytes = size_t(K) * N;
    if (bytes.size() != x_bytes + w_bytes + size_t(N) * 2) {
        fprintf(stderr, "input size\n");
        return 2;
    }
    // separate 16-byte aligned buffers, x and w8 registered as device memory
    std::vector<uint4> xb((x_bytes + 15) / 16), wb((w_bytes + 15) / 16), sb((N * 2 + 15) / 16);
    std::memcpy(xb.data(), bytes.data(), x_bytes);
    std::memcpy(wb.data(), bytes.data() + x_bytes, w_bytes);
    std::memcpy(sb.data(), bytes.data() + x_bytes + w_bytes, N * 2);
    emu::add_global(xb.data(), x_bytes);
    emu::add_global(wb.data(), w_bytes);
    std::vector<uint16_t> out[2];
    int rc = 0;
    for (int run = 0; run < 2; ++run) {
        emu::reverse_ctas = run == 1;
        out[run].assign(size_t(M) * N, 0xffff);
        rc |= launch(xb.data(), wb.data(), sb.data(), out[run].data(), M, K, N, splits, nullptr);
    }
    std::ofstream(argv[8], std::ios::binary)
        .write(reinterpret_cast<const char*>(out[0].data()), out[0].size() * 2);
    printf("rc=%d splits=%d bank_conflicts=%ld ldmatrix=%ld identical=%d\n", rc, splits,
           emu::bank_conflicts, emu::ldmatrix_calls, int(out[0] == out[1]));
    return rc;
}
